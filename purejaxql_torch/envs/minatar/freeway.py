"""Freeway-MinAtar, batched over E envs.

Port of purejaxql_tpu/envs/minatar/freeway.py: a chicken in column 4
crosses 8 lanes of traffic (rows 1-8) from the bottom row to the top with 3
actions [noop, up, down] and a ``player_speed``-step cooldown after each
move. Reaching the top scores +1, sends the chicken back to the bottom and
gives every lane a new speed and direction; a car in column 4 on the
chicken's row, before or after the cars move, sends it back too. Each lane's
car moves one column (wrapping) when its timer runs out, and the timer
restarts at the lane's |speed|. The episode ends only on the time limit
(2500 steps). Observations (E, 10, 10, 7) float32, channels [chicken, car,
speed 1 .. speed 5], the speed channels marking the cell behind each car.
The step follows freeway.py:73-125.

The step's randomness comes in ``FreewayDraws``: the new lane speeds (1-5)
and directions (+-1) that a score would take. A reset draws the car
columns as well (``start_state``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from purejaxql_torch.envs import spaces
from purejaxql_torch.envs.base import Environment

LANES = 8


@dataclass
class FreewayState:
    pos: torch.Tensor  # (E,) int32: the chicken's row
    car_x: torch.Tensor  # (E, 8) int32
    car_timer: torch.Tensor  # (E, 8) int32: steps until the car moves
    car_speed: torch.Tensor  # (E, 8) int32, signed: sign = direction, |.| = interval
    move_timer: torch.Tensor  # (E,) int32
    terminal: torch.Tensor  # (E,) bool, always False
    time: torch.Tensor  # (E,) int32


@dataclass(frozen=True)
class FreewayParams:
    player_speed: int = 3
    max_steps_in_episode: int = 2500


@dataclass
class FreewayDraws:
    speeds: torch.Tensor  # (E, 8) int32 in 1..5
    dirs: torch.Tensor  # (E, 8) int32, +1 or -1


def draw_cars(generator: torch.Generator, num_envs: int) -> FreewayDraws:
    """Uniform lane speeds in 1..5 and directions +-1 (freeway.py:38-48)."""
    dev = generator.device
    speeds = torch.randint(1, 6, (num_envs, LANES), generator=generator, device=dev)
    right = torch.rand((num_envs, LANES), generator=generator, device=dev) < 0.5
    return FreewayDraws(speeds=speeds.to(torch.int32), dirs=torch.where(right, 1, -1).to(torch.int32))


def start_state(car_x: torch.Tensor, cars: FreewayDraws) -> FreewayState:
    """The start of an episode with the cars at ``car_x`` (E, 8) and the
    lanes' speeds and directions ``cars`` (freeway.py:60-71)."""
    n, dev = car_x.shape[0], car_x.device
    zero = torch.zeros(n, dtype=torch.int32, device=dev)
    return FreewayState(
        pos=zero + 9, car_x=car_x.to(torch.int32), car_timer=cars.speeds,
        car_speed=cars.speeds * cars.dirs, move_timer=zero.clone(),
        terminal=torch.zeros(n, dtype=torch.bool, device=dev), time=zero.clone(),
    )


def _wrap(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x < 0, 9, torch.where(x > 9, 0, x)).to(torch.int32)


class MinFreeway(Environment):
    @property
    def default_params(self) -> FreewayParams:
        return FreewayParams()

    @property
    def name(self) -> str:
        return "Freeway-MinAtar"

    def reset_env(self, generator, num_envs, params):
        dev = generator.device
        car_x = torch.randint(0, 10, (num_envs, LANES), generator=generator, device=dev)
        state = start_state(car_x, draw_cars(generator, num_envs))
        return self.get_obs(state), state

    def step_draws(self, generator, num_envs):
        return draw_cars(generator, num_envs)

    def step_env(self, state, action, params, draws):
        action = action.to(torch.int32)
        moved = (state.move_timer == 0) & (action != 0)
        step = torch.where(moved, torch.where(action == 1, -1, 1), 0)
        pos = (state.pos + step.to(torch.int32)).clamp(0, 9)
        move_timer = torch.where(
            moved, params.player_speed, (state.move_timer - 1).clamp(min=0)
        ).to(torch.int32)

        # reaching the top scores and draws new lane speeds
        scored = pos == 0
        reward = scored.to(torch.float32)
        car_timer = torch.where(scored[:, None], draws.speeds, state.car_timer)
        car_speed = torch.where(scored[:, None], draws.speeds * draws.dirs, state.car_speed)
        pos = torch.where(scored, 9, pos).to(torch.int32)

        # the cars move on their lane timers; a car in column 4 on the
        # chicken's row, before or after the move, sends it back
        on_row = torch.arange(1, LANES + 1, device=pos.device) == pos[:, None]
        hit_before = ((state.car_x == 4) & on_row).any(1)
        do_move = car_timer <= 0
        new_x = _wrap(state.car_x + torch.where(car_speed > 0, 1, -1).to(torch.int32))
        car_x = torch.where(do_move, new_x, state.car_x)
        car_timer = torch.where(do_move, car_speed.abs(), car_timer - 1)
        hit_after = ((car_x == 4) & on_row).any(1)
        pos = torch.where(hit_before | hit_after, 9, pos).to(torch.int32)

        new_state = FreewayState(
            pos=pos,
            car_x=car_x,
            car_timer=car_timer,
            car_speed=car_speed,
            move_timer=move_timer,
            terminal=torch.zeros_like(scored),
            time=state.time + 1,
        )
        done = self.is_terminal(new_state, params)
        return self.get_obs(new_state), new_state, reward, done, {}

    def get_obs(self, state: FreewayState) -> torch.Tensor:
        n, dev = state.pos.shape[0], state.pos.device
        cols = torch.arange(10, device=dev)
        obs = torch.zeros(n, 10, 10, 7, dtype=torch.float32, device=dev)
        obs[:, :, 4, 0] = (cols == state.pos[:, None]).to(torch.float32)
        obs[:, 1:9, :, 1] = (cols == state.car_x[..., None]).to(torch.float32)
        # the cell behind each car, on the channel of its |speed|
        back_x = _wrap(state.car_x + torch.where(state.car_speed > 0, -1, 1).to(torch.int32))
        behind = cols == back_x[..., None]  # (E, 8, 10)
        for s in range(1, 6):
            obs[:, 1:9, :, 1 + s] = (behind & (state.car_speed.abs() == s)[..., None]).to(torch.float32)
        return obs

    def is_terminal(self, state: FreewayState, params: FreewayParams) -> torch.Tensor:
        return state.time >= params.max_steps_in_episode

    def observation_space(self, params) -> spaces.Box:
        return spaces.Box(0.0, 1.0, (10, 10, 7))

    def action_space(self, params=None) -> spaces.Discrete:
        return spaces.Discrete(3)
