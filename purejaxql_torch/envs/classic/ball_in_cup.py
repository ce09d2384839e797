"""BallInCup-v0: swing a tethered ball into a moving cup, batched over E
envs.

Port of purejaxql_tpu/envs/classic/ball_in_cup.py. The action accelerates
the cup (damped, confined to a box whose walls stop it); the ball flies
under gravity on a string of string_len from the cup. A step is 4 substeps
of semi-implicit Euler (ball_in_cup.py:59), each ending with the taut-string
constraint (:111-116): past full length the ball is put back on the circle,
and if it separates from the cup its radial relative velocity is removed.
The reward is 1 while the ball sits slowly in the cup's mouth, plus shaping
x clip((ball_z - cup_z) / string_len, 0, 1); 500 steps an episode.
Observations (8): cup xz, cup velocity, (ball - cup) / string_len, the
ball's velocity relative to the cup.

A reset's randomness comes in as an argument (``start_state``, fed by
``draw_start``): the ball hangs at an angle ~ U[-0.4, 0.4) with a velocity
of 0.1 x a standard normal pair (ball_in_cup.py:76-80). The step draws
nothing.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from purejaxql_torch.envs import spaces
from purejaxql_torch.envs.base import Environment
from purejaxql_torch.envs.classic.reacher import uniform


@dataclass
class BallInCupState:
    cup: torch.Tensor  # (E, 2) x, z
    cup_vel: torch.Tensor  # (E, 2)
    ball: torch.Tensor  # (E, 2)
    ball_vel: torch.Tensor  # (E, 2)
    time: torch.Tensor  # int32


@dataclass(frozen=True)
class BallInCupParams:
    gravity: float = 9.8
    string_len: float = 0.3
    cup_accel: float = 20.0
    cup_damping: float = 4.0
    box: float = 0.6  # cup confined to [-box, box]^2
    mouth_half_w: float = 0.05  # catch window half-width
    mouth_depth: float = 0.06  # how far below the rim counts as "in"
    catch_speed: float = 1.5  # max relative speed that still catches
    shaping: float = 0.05
    dt: float = 0.01
    substeps: int = 4
    max_steps_in_episode: int = 500


def draw_start(generator: torch.Generator, num_envs: int) -> torch.Tensor:
    """(E, 3) reset draws [angle ~ U[-0.4, 0.4), two standard normals]."""
    ang = uniform(generator, (num_envs, 1), -0.4, 0.4)
    return torch.cat([ang, torch.randn((num_envs, 2), generator=generator, device=generator.device)], 1)


def start_state(draws: torch.Tensor, params: BallInCupParams) -> BallInCupState:
    """The state after a reset from its (E, 3) draws."""
    n, dev = draws.shape[0], draws.device
    ang = draws[:, 0]
    zeros = torch.zeros(n, 2, device=dev)
    return BallInCupState(
        cup=zeros, cup_vel=zeros, ball=params.string_len * torch.stack([torch.sin(ang), -torch.cos(ang)], -1),
        ball_vel=0.1 * draws[:, 1:], time=torch.zeros(n, dtype=torch.int32, device=dev),
    )


def substep(cup, cup_vel, ball, ball_vel, accel, gravity, p):
    """One substep (ball_in_cup.py:92-117): the damped cup in its box, the
    ballistic ball under ``gravity`` (the (2,) vector [0, -g]), then the
    taut-string constraint."""
    dt = p.dt
    cup_vel = cup_vel + dt * (p.cup_accel * accel - p.cup_damping * cup_vel)
    cup = cup + dt * cup_vel
    hit = (cup < -p.box) | (cup > p.box)
    cup = torch.clamp(cup, -p.box, p.box)
    cup_vel = torch.where(hit, 0.0, cup_vel)
    ball_vel = ball_vel + dt * gravity
    ball = ball + dt * ball_vel
    rel = ball - cup
    dist = torch.sqrt((rel**2).sum(-1) + 1e-12)
    taut = (dist >= p.string_len)[:, None]
    u = rel / dist[:, None]
    ball = torch.where(taut, cup + u * p.string_len, ball)
    v_rad = ((ball_vel - cup_vel) * u).sum(-1, keepdim=True)
    ball_vel = torch.where(taut & (v_rad > 0), ball_vel - v_rad * u, ball_vel)
    return cup, cup_vel, ball, ball_vel


class BallInCup(Environment):
    @property
    def default_params(self) -> BallInCupParams:
        return BallInCupParams()

    @property
    def name(self) -> str:
        return "BallInCup-v0"

    def reset_env(self, generator, num_envs, params):
        state = start_state(draw_start(generator, num_envs), params)
        return self.get_obs(state, params), state

    def step_env(self, state, action, params, draws):
        p = params
        accel = torch.clamp(action.float(), -1.0, 1.0)
        cup, cup_vel, ball, ball_vel = state.cup, state.cup_vel, state.ball, state.ball_vel
        # made on the device, not copied from the host every step
        gravity = torch.stack([torch.zeros((), device=cup.device), torch.full((), -p.gravity, device=cup.device)])
        for _ in range(p.substeps):
            cup, cup_vel, ball, ball_vel = substep(cup, cup_vel, ball, ball_vel, accel, gravity, p)
        rel, rel_vel = ball - cup, ball_vel - cup_vel
        slow = (rel_vel**2).sum(-1) < p.catch_speed**2
        caught = (rel[:, 0].abs() < p.mouth_half_w) & (rel[:, 1] < 0.0) & (rel[:, 1] > -p.mouth_depth) & slow
        height = (ball[:, 1] - cup[:, 1]) / p.string_len
        reward = caught.float() + p.shaping * torch.clamp(height, 0.0, 1.0)
        new_state = BallInCupState(cup=cup, cup_vel=cup_vel, ball=ball, ball_vel=ball_vel, time=state.time + 1)
        done = new_state.time >= p.max_steps_in_episode
        return self.get_obs(new_state, p), new_state, reward, done, {}

    def get_obs(self, state: BallInCupState, params) -> torch.Tensor:
        return torch.cat([state.cup, state.cup_vel, (state.ball - state.cup) / params.string_len,
                          state.ball_vel - state.cup_vel], -1)

    def observation_space(self, params) -> spaces.Box:
        return spaces.Box(-np.inf, np.inf, (8,), np.float32)

    def action_space(self, params=None) -> spaces.Box:
        return spaces.Box(-1.0, 1.0, (2,), np.float32)
