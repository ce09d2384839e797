"""PointMass-v0: a force-actuated 2-D point mass driven to the origin,
batched over E envs.

Port of purejaxql_tpu/envs/classic/point_mass.py: velocity = damping x
velocity + gear x clip(force, -1, 1) x dt, the position clipped to the
arena, and a wall that is hit zeroes that velocity component (the walls
stick). The reward is a linear proximity bonus inside reward_radius minus
0.01 |force|^2; episodes last 250 steps. Observations: position, velocity.

A reset's randomness comes in as an argument (``start_state``, fed by
``draw_start``): the position ~ U[-0.8, 0.8)^2 (point_mass.py:46). The step
draws nothing.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from purejaxql_torch.envs import spaces
from purejaxql_torch.envs.base import Environment
from purejaxql_torch.envs.classic.reacher import uniform


@dataclass
class PointMassState:
    pos: torch.Tensor  # (E, 2)
    vel: torch.Tensor  # (E, 2)
    time: torch.Tensor  # int32


@dataclass(frozen=True)
class PointMassParams:
    dt: float = 0.05
    gear: float = 2.0
    damping: float = 0.95
    arena: float = 1.0  # |pos| per axis is clipped to this
    reward_radius: float = 0.5
    max_steps_in_episode: int = 250


def draw_start(generator: torch.Generator, num_envs: int) -> torch.Tensor:
    """(E, 2) reset draws: the position, U[-0.8, 0.8)."""
    return uniform(generator, (num_envs, 2), -0.8, 0.8)


def start_state(pos: torch.Tensor) -> PointMassState:
    return PointMassState(pos=pos, vel=torch.zeros_like(pos),
                          time=torch.zeros(pos.shape[0], dtype=torch.int32, device=pos.device))


def norm2(v: torch.Tensor) -> torch.Tensor:
    """The Euclidean norm over the last axis of 2, as jnp.linalg.norm."""
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])


class PointMass(Environment):
    @property
    def default_params(self) -> PointMassParams:
        return PointMassParams()

    @property
    def name(self) -> str:
        return "PointMass-v0"

    def reset_env(self, generator, num_envs, params):
        state = start_state(draw_start(generator, num_envs))
        return self.get_obs(state), state

    def step_env(self, state, action, params, draws):
        p = params
        force = torch.clamp(action, -1.0, 1.0)
        vel = state.vel * p.damping + force * p.gear * p.dt
        pos = torch.clamp(state.pos + vel * p.dt, -p.arena, p.arena)
        # walls are sticky: hitting an edge zeroes that velocity component
        vel = torch.where(pos.abs() >= p.arena, 0.0, vel)
        new_state = PointMassState(pos=pos, vel=vel, time=state.time + 1)
        reward = torch.clamp_min(1.0 - norm2(pos) / p.reward_radius, 0.0) - 0.01 * (force * force).sum(-1)
        done = new_state.time >= p.max_steps_in_episode
        return self.get_obs(new_state), new_state, reward, done, {}

    def get_obs(self, state: PointMassState, params=None) -> torch.Tensor:
        return torch.cat([state.pos, state.vel], -1)

    def observation_space(self, params) -> spaces.Box:
        return spaces.Box(-np.inf, np.inf, (4,), np.float32)

    def action_space(self, params=None) -> spaces.Box:
        return spaces.Box(-1.0, 1.0, (2,), np.float32)
