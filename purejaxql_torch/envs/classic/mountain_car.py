"""MountainCar-v0: the discrete Moore car, batched over E envs.

Port of purejaxql_tpu/envs/classic/mountain_car.py: velocity += (action - 1)
force - gravity cos(3 position), clipped to +-max_speed; position +=
velocity, clipped to the track, the velocity zeroed at the left wall while
it points into it. The reward is -1 every step; the episode ends with the
car at goal_position moving at goal_velocity or more, or after 200 steps.
Observations: position, velocity.

A reset's randomness comes in as an argument (``start_state``, fed by
``draw_start``): position ~ U[-0.6, -0.4) (mountain_car.py:45). The step
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
class MountainCarState:
    position: torch.Tensor
    velocity: torch.Tensor
    time: torch.Tensor  # int32


@dataclass(frozen=True)
class MountainCarParams:
    min_position: float = -1.2
    max_position: float = 0.6
    max_speed: float = 0.07
    goal_position: float = 0.5
    goal_velocity: float = 0.0
    force: float = 0.001
    gravity: float = 0.0025
    max_steps_in_episode: int = 200


def draw_start(generator: torch.Generator, num_envs: int) -> torch.Tensor:
    """(E,) reset draws: the position, U[-0.6, -0.4)."""
    return uniform(generator, (num_envs,), -0.6, -0.4)


def start_state(position: torch.Tensor) -> MountainCarState:
    n, dev = position.shape[0], position.device
    return MountainCarState(position=position, velocity=torch.zeros(n, device=dev),
                            time=torch.zeros(n, dtype=torch.int32, device=dev))


class MountainCar(Environment):
    """MountainCar-v0 with 3 discrete actions (left / none / right)."""

    @property
    def default_params(self) -> MountainCarParams:
        return MountainCarParams()

    @property
    def name(self) -> str:
        return "MountainCar-v0"

    def reset_env(self, generator, num_envs, params):
        state = start_state(draw_start(generator, num_envs))
        return self.get_obs(state), state

    def step_env(self, state, action, params, draws):
        p = params
        velocity = state.velocity + (action - 1) * p.force + torch.cos(3 * state.position) * (-p.gravity)
        velocity = torch.clamp(velocity, -p.max_speed, p.max_speed)
        position = torch.clamp(state.position + velocity, p.min_position, p.max_position)
        # a product, as JAX's (mountain_car.py:58): a zeroed negative velocity is -0.0
        velocity = velocity * (1 - ((position == p.min_position) & (velocity < 0)).float())
        new_state = MountainCarState(position=position, velocity=velocity, time=state.time + 1)
        done = self.is_terminal(new_state, p)
        return self.get_obs(new_state), new_state, torch.full_like(position, -1.0), done, {}

    def get_obs(self, state: MountainCarState, params=None) -> torch.Tensor:
        return torch.stack([state.position, state.velocity], -1)

    def is_terminal(self, state: MountainCarState, params: MountainCarParams) -> torch.Tensor:
        solved = (state.position >= params.goal_position) & (state.velocity >= params.goal_velocity)
        return solved | (state.time >= params.max_steps_in_episode)

    def observation_space(self, params) -> spaces.Box:
        low = np.array([params.min_position, -params.max_speed], np.float32)
        high = np.array([params.max_position, params.max_speed], np.float32)
        return spaces.Box(low, high, (2,), np.float32)

    def action_space(self, params=None) -> spaces.Discrete:
        return spaces.Discrete(3)
