"""MountainCarContinuous-v0: the classic continuous hill climb, batched over
E envs.

Port of purejaxql_tpu/envs/classic/mountain_car_continuous.py: velocity +=
power x clip(a, -1, 1) - 0.0025 cos(3 position), clipped to +-max_speed;
position += velocity, clipped to the track, the velocity zeroed at the left
wall; +100 on reaching goal_position, minus 0.1 force^2 every step. The
episode ends at the goal or after 999 steps. Observations: position,
velocity.

A reset's randomness comes in as an argument (``start_state``, fed by
``draw_start``): position ~ U[-0.6, -0.4). The step draws nothing.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from purejaxql_torch.envs import spaces
from purejaxql_torch.envs.base import Environment
from purejaxql_torch.envs.classic.reacher import uniform


@dataclass
class MCCState:
    position: torch.Tensor
    velocity: torch.Tensor
    time: torch.Tensor  # int32


@dataclass(frozen=True)
class MCCParams:
    min_position: float = -1.2
    max_position: float = 0.6
    max_speed: float = 0.07
    goal_position: float = 0.45
    power: float = 0.0015
    max_steps_in_episode: int = 999


def draw_start(generator: torch.Generator, num_envs: int) -> torch.Tensor:
    """(E,) reset draws: the position, U[-0.6, -0.4)."""
    return uniform(generator, (num_envs,), -0.6, -0.4)


def start_state(position: torch.Tensor) -> MCCState:
    n, dev = position.shape[0], position.device
    return MCCState(position=position, velocity=torch.zeros(n, device=dev),
                    time=torch.zeros(n, dtype=torch.int32, device=dev))


class MountainCarContinuous(Environment):
    @property
    def default_params(self) -> MCCParams:
        return MCCParams()

    @property
    def name(self) -> str:
        return "MountainCarContinuous-v0"

    def reset_env(self, generator, num_envs, params):
        state = start_state(draw_start(generator, num_envs))
        return self.get_obs(state), state

    def step_env(self, state, action, params, draws):
        p = params
        force = torch.clamp(action[:, 0], -1.0, 1.0)
        velocity = state.velocity + force * p.power - 0.0025 * torch.cos(3.0 * state.position)
        velocity = torch.clamp(velocity, -p.max_speed, p.max_speed)
        position = torch.clamp(state.position + velocity, p.min_position, p.max_position)
        velocity = torch.where((position <= p.min_position) & (velocity < 0), 0.0, velocity)
        reward = torch.where(position >= p.goal_position, 100.0, 0.0) - 0.1 * force**2
        new_state = MCCState(position=position, velocity=velocity, time=state.time + 1)
        done = (position >= p.goal_position) | (new_state.time >= p.max_steps_in_episode)
        return self.get_obs(new_state), new_state, reward, done, {}

    def get_obs(self, state: MCCState) -> torch.Tensor:
        return torch.stack([state.position, state.velocity], -1)

    def observation_space(self, params) -> spaces.Box:
        low = np.array([params.min_position, -params.max_speed], np.float32)
        high = np.array([params.max_position, params.max_speed], np.float32)
        return spaces.Box(low, high, (2,), np.float32)

    def action_space(self, params=None) -> spaces.Box:
        return spaces.Box(-1.0, 1.0, (1,), np.float32)
