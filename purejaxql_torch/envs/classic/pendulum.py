"""Pendulum-v1 (continuous torque control), batched over E envs as (E,)
tensors.

Port of purejaxql_tpu/envs/classic/pendulum.py: the torque is clipped to
[-2, 2], the cost angle^2 + 0.1 theta_dot^2 + 0.001 u^2 is taken on the
incoming state (the angle normalized to [-pi, pi) with a floor-mod,
pendulum.py:100-101), theta_dot is integrated and clipped to +-8, then
theta; the episode ends at the 200-step limit. Observations are
[cos theta, sin theta, theta_dot]. The arithmetic follows the JAX code
operation for operation.

A reset's randomness comes in as an argument (``start_state``, fed by
``draw_start``), as the other envs take their draws: theta ~ U[-pi, pi),
theta_dot ~ U[-1, 1). The step draws nothing.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from purejaxql_torch.envs import spaces
from purejaxql_torch.envs.base import Environment


@dataclass
class PendulumState:
    theta: torch.Tensor
    theta_dot: torch.Tensor
    last_u: torch.Tensor
    time: torch.Tensor  # int32


@dataclass(frozen=True)
class PendulumParams:
    max_speed: float = 8.0
    max_torque: float = 2.0
    dt: float = 0.05
    g: float = 10.0
    m: float = 1.0
    l: float = 1.0  # noqa: E741 (the JAX env's name)
    max_steps_in_episode: int = 200


def draw_start(generator: torch.Generator, num_envs: int) -> torch.Tensor:
    """(E, 2) reset draws [theta, theta_dot], U[-pi, pi) x U[-1, 1)
    (pendulum.py:52-53)."""
    dev = generator.device
    high = torch.tensor([math.pi, 1.0], device=dev)
    return torch.rand((num_envs, 2), generator=generator, device=dev) * (2 * high) - high


def start_state(init: torch.Tensor) -> PendulumState:
    """The state after a reset from its (E, 2) draws [theta, theta_dot]."""
    n = init.shape[0]
    return PendulumState(
        theta=init[:, 0],
        theta_dot=init[:, 1],
        last_u=torch.zeros(n, device=init.device),
        time=torch.zeros(n, dtype=torch.int32, device=init.device),
    )


def angle_normalize(x: torch.Tensor) -> torch.Tensor:
    """((x + pi) mod 2 pi) - pi, the mod taking the divisor's sign as jnp's %."""
    return torch.remainder(x + math.pi, 2 * math.pi) - math.pi


class Pendulum(Environment):
    """Pendulum-v1: 1-D continuous torque in [-2, 2]."""

    @property
    def default_params(self) -> PendulumParams:
        return PendulumParams()

    @property
    def name(self) -> str:
        return "Pendulum-v1"

    def reset_env(self, generator, num_envs, params):
        state = start_state(draw_start(generator, num_envs))
        return self.get_obs(state), state

    def step_env(self, state, action, params, draws):
        p = params
        u = torch.clamp(action.reshape(-1), -p.max_torque, p.max_torque)
        angle = angle_normalize(state.theta)
        cost = angle**2 + 0.1 * state.theta_dot**2 + 0.001 * u**2
        newthdot = state.theta_dot + (
            3 * p.g / (2 * p.l) * torch.sin(state.theta) + 3.0 / (p.m * p.l**2) * u
        ) * p.dt
        newthdot = torch.clamp(newthdot, -p.max_speed, p.max_speed)
        new_state = PendulumState(
            theta=state.theta + newthdot * p.dt,
            theta_dot=newthdot,
            last_u=u,
            time=state.time + 1,
        )
        done = new_state.time >= p.max_steps_in_episode
        return self.get_obs(new_state), new_state, -cost, done, {}

    def get_obs(self, state: PendulumState) -> torch.Tensor:
        return torch.stack([torch.cos(state.theta), torch.sin(state.theta), state.theta_dot], -1)

    def observation_space(self, params) -> spaces.Box:
        high = np.array([1.0, 1.0, params.max_speed], np.float32)
        return spaces.Box(-high, high, (3,), np.float32)

    def action_space(self, params=None) -> spaces.Box:
        p = params if params is not None else self.default_params
        return spaces.Box(-p.max_torque, p.max_torque, (1,), np.float32)
