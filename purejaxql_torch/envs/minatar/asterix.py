"""Asterix-MinAtar, batched over E envs.

Port of purejaxql_tpu/envs/minatar/asterix.py: the player moves on a 10x10
grid with 5 actions [noop, left, up, right, down], rows 1-8 each hold one
entity slot (exists, x, moving right, is gold). An entity spawns in a free
slot every ``spawn_speed`` steps, moves one column every ``move_speed``
steps and leaves at the edge; touching gold scores +1, touching an enemy
ends the episode. Every ``ramp_interval`` steps the spawn and move cadences
speed up in turn. Observations (E, 10, 10, 4) float32, channels [player,
enemy, trail, gold]. The step applies the rules in the order of
asterix.py:79-196: spawn, player move, collide, entity move, collide, ramp.

The step's randomness comes in ``AsterixDraws``: a score per slot (the
spawn takes the free slot with the highest score, the first on ties, a
Gumbel-max choice over the free slots), the new entity's direction and
whether it is gold. The reset is deterministic.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from purejaxql_torch.envs import spaces
from purejaxql_torch.envs.base import Environment

SLOTS = 8


@dataclass
class AsterixState:
    player_x: torch.Tensor  # (E,) int32
    player_y: torch.Tensor
    e_exists: torch.Tensor  # (E, 8) bool
    e_x: torch.Tensor  # (E, 8) int32
    e_lr: torch.Tensor  # (E, 8) bool: True = moving right
    e_gold: torch.Tensor  # (E, 8) bool
    spawn_speed: torch.Tensor  # (E,) int32
    spawn_timer: torch.Tensor
    move_speed: torch.Tensor
    move_timer: torch.Tensor
    ramp_timer: torch.Tensor
    ramp_index: torch.Tensor
    terminal: torch.Tensor  # (E,) bool
    time: torch.Tensor  # (E,) int32


@dataclass(frozen=True)
class AsterixParams:
    ramp_interval: int = 100
    init_spawn_speed: int = 10
    init_move_interval: int = 5
    ramping: bool = True
    max_steps_in_episode: int = 1000


@dataclass
class AsterixDraws:
    gumbel: torch.Tensor  # (E, 8) float32: the slot scores
    lr: torch.Tensor  # (E,) bool: the spawned entity moves right
    gold: torch.Tensor  # (E,) bool: the spawned entity is gold


def start_state(num_envs: int, params: AsterixParams, device) -> AsterixState:
    """The start of an episode (asterix.py:60-77)."""
    full = lambda v: torch.full((num_envs,), v, dtype=torch.int32, device=device)  # noqa: E731
    no = torch.zeros(num_envs, SLOTS, dtype=torch.bool, device=device)
    return AsterixState(
        player_x=full(5), player_y=full(5), e_exists=no, e_x=no.to(torch.int32),
        e_lr=no.clone(), e_gold=no.clone(),
        spawn_speed=full(params.init_spawn_speed), spawn_timer=full(params.init_spawn_speed),
        move_speed=full(params.init_move_interval), move_timer=full(params.init_move_interval),
        ramp_timer=full(params.ramp_interval), ramp_index=full(0),
        terminal=torch.zeros(num_envs, dtype=torch.bool, device=device), time=full(0),
    )


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32)


class MinAsterix(Environment):
    @property
    def default_params(self) -> AsterixParams:
        return AsterixParams()

    @property
    def name(self) -> str:
        return "Asterix-MinAtar"

    def reset_env(self, generator, num_envs, params):
        state = start_state(num_envs, params, generator.device)
        return self.get_obs(state), state

    def step_draws(self, generator, num_envs):
        dev = generator.device
        u = torch.rand((num_envs, SLOTS + 2), generator=generator, device=dev)
        return AsterixDraws(gumbel=u[:, :SLOTS], lr=u[:, SLOTS] < 0.5, gold=u[:, SLOTS + 1] < 1.0 / 3.0)

    def step_env(self, state, action, params, draws):
        action = action.to(torch.int32)
        dev = action.device
        slots = torch.arange(SLOTS, device=dev)

        # spawn into the free slot with the highest score
        do_spawn = state.spawn_timer == 0
        free = ~state.e_exists
        slot = torch.where(free, draws.gumbel, -1.0).argmax(1)
        spawn_now = do_spawn & free.any(1)
        take = (slots == slot[:, None]) & spawn_now[:, None]
        e_exists = state.e_exists | take
        e_x = torch.where(take, _i32(torch.where(draws.lr, 0, 9))[:, None], state.e_x)
        e_lr = torch.where(take, draws.lr[:, None], state.e_lr)
        e_gold = torch.where(take, draws.gold[:, None], state.e_gold)
        spawn_timer = torch.where(do_spawn, state.spawn_speed, state.spawn_timer - 1)

        # player move
        dx = _i32(action == 3) - _i32(action == 1)
        dy = _i32(action == 4) - _i32(action == 2)
        px = (state.player_x + dx).clamp(0, 9)
        py = (state.player_y + dy).clamp(1, 8)

        rows = slots + 1
        reward = torch.zeros(action.shape[0], dtype=torch.float32, device=dev)
        terminal = state.terminal

        def collide(e_exists, e_x, reward, terminal):
            hit = e_exists & (e_x == px[:, None]) & (rows == py[:, None])
            reward = reward + (hit & e_gold).sum(1).to(torch.float32)
            terminal = terminal | (hit & ~e_gold).any(1)
            return e_exists & ~hit, reward, terminal

        e_exists, reward, terminal = collide(e_exists, e_x, reward, terminal)

        # entity move
        do_move = (state.move_timer == 0)[:, None]
        moved_x = e_x + _i32(torch.where(e_lr, 1, -1))
        off = (moved_x < 0) | (moved_x > 9)
        e_x = torch.where(do_move & e_exists, moved_x, e_x)
        e_exists = e_exists & ~(do_move & off)
        e_x = e_x.clamp(0, 9)
        move_timer = torch.where(do_move[:, 0], state.move_speed, state.move_timer - 1)

        e_exists, reward, terminal = collide(e_exists, e_x, reward, terminal)

        # ramping, from the cadences the step started with
        can_ramp = ((state.spawn_speed > 1) | (state.move_speed > 1)) & params.ramping
        do_ramp = can_ramp & (state.ramp_timer <= 0)
        ramp_move = do_ramp & (state.ramp_index % 2 == 1) & (state.move_speed > 1)
        ramp_spawn = do_ramp & (state.ramp_index % 2 == 0) & (state.spawn_speed > 1)
        new_state = AsterixState(
            player_x=px,
            player_y=py,
            e_exists=e_exists,
            e_x=e_x,
            e_lr=e_lr,
            e_gold=e_gold,
            spawn_speed=state.spawn_speed - _i32(ramp_spawn),
            spawn_timer=spawn_timer,
            move_speed=state.move_speed - _i32(ramp_move),
            move_timer=move_timer,
            ramp_timer=torch.where(
                do_ramp, params.ramp_interval, state.ramp_timer - _i32(can_ramp)
            ).to(torch.int32),
            ramp_index=state.ramp_index + _i32(do_ramp),
            terminal=terminal,
            time=state.time + 1,
        )
        done = self.is_terminal(new_state, params)
        return self.get_obs(new_state), new_state, reward, done, {}

    def get_obs(self, state: AsterixState) -> torch.Tensor:
        n, dev = state.player_x.shape[0], state.player_x.device
        cols = torch.arange(10, device=dev)
        obs = torch.zeros(n, 10, 10, 4, dtype=torch.float32, device=dev)
        player = (cols[:, None] == state.player_y[:, None, None]) & (cols == state.player_x[:, None, None])
        obs[..., 0] = player.to(torch.float32)

        def on_rows(x, mask):  # (E, 8) columns -> the (E, 8, 10) one-hots of rows 1-8
            return ((cols == x[..., None]) & mask[..., None]).to(torch.float32)

        trail_x = (state.e_x + _i32(torch.where(state.e_lr, -1, 1))).clamp(0, 9)
        obs[:, 1:9, :, 1] = on_rows(state.e_x, state.e_exists & ~state.e_gold)
        obs[:, 1:9, :, 2] = on_rows(trail_x, state.e_exists)
        obs[:, 1:9, :, 3] = on_rows(state.e_x, state.e_exists & state.e_gold)
        return obs.clamp(max=1.0)

    def is_terminal(self, state: AsterixState, params: AsterixParams) -> torch.Tensor:
        return state.terminal | (state.time >= params.max_steps_in_episode)

    def observation_space(self, params) -> spaces.Box:
        return spaces.Box(0.0, 1.0, (10, 10, 4))

    def action_space(self, params=None) -> spaces.Discrete:
        return spaces.Discrete(5)
