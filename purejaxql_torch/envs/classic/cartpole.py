"""CartPole-v1, batched over E envs as (E,) tensors.

Port of purejaxql_tpu/envs/classic/cartpole.py: Euler integration of the
Barto-Sutton-Anderson pole, done when |x| > 2.4, |theta| > 12 degrees or
the 500-step limit is reached, reset draws U(-0.05, 0.05)^4. The reward is
1 unless the *incoming* state was already terminal (cartpole.py:72,100).
The arithmetic follows the JAX code operation for operation.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from purejaxql_torch.envs import spaces
from purejaxql_torch.envs.base import Environment


@dataclass
class CartPoleState:
    x: torch.Tensor
    x_dot: torch.Tensor
    theta: torch.Tensor
    theta_dot: torch.Tensor
    time: torch.Tensor  # int32


@dataclass(frozen=True)
class CartPoleParams:
    gravity: float = 9.8
    masscart: float = 1.0
    masspole: float = 0.1
    total_mass: float = 1.1
    length: float = 0.5
    polemass_length: float = 0.05
    force_mag: float = 10.0
    tau: float = 0.02
    theta_threshold_radians: float = 12 * 2 * math.pi / 360
    x_threshold: float = 2.4
    max_steps_in_episode: int = 500


class CartPole(Environment):
    """CartPole-v1 with 2 discrete actions (push left / push right)."""

    @property
    def default_params(self) -> CartPoleParams:
        return CartPoleParams()

    @property
    def name(self) -> str:
        return "CartPole-v1"

    def reset_env(self, generator, num_envs, params):
        init = (
            torch.rand((num_envs, 4), generator=generator, device=generator.device)
            * 0.1
            - 0.05
        )
        state = CartPoleState(
            x=init[:, 0],
            x_dot=init[:, 1],
            theta=init[:, 2],
            theta_dot=init[:, 3],
            time=torch.zeros(num_envs, dtype=torch.int32, device=init.device),
        )
        return self.get_obs(state), state

    def step_env(self, state, action, params, draws):
        p = params
        prev_done = self.is_terminal(state, p)

        force = p.force_mag * action - p.force_mag * (1 - action)
        costheta = torch.cos(state.theta)
        sintheta = torch.sin(state.theta)

        temp = (
            force + p.polemass_length * state.theta_dot**2 * sintheta
        ) / p.total_mass
        thetaacc = (p.gravity * sintheta - costheta * temp) / (
            p.length * (4.0 / 3.0 - p.masspole * costheta**2 / p.total_mass)
        )
        xacc = temp - p.polemass_length * thetaacc * costheta / p.total_mass

        new_state = CartPoleState(
            x=state.x + p.tau * state.x_dot,
            x_dot=state.x_dot + p.tau * xacc,
            theta=state.theta + p.tau * state.theta_dot,
            theta_dot=state.theta_dot + p.tau * thetaacc,
            time=state.time + 1,
        )
        done = self.is_terminal(new_state, p)
        reward = 1.0 - prev_done.float()
        return self.get_obs(new_state), new_state, reward, done, {}

    def get_obs(self, state: CartPoleState) -> torch.Tensor:
        return torch.stack([state.x, state.x_dot, state.theta, state.theta_dot], -1)

    def is_terminal(self, state: CartPoleState, params: CartPoleParams) -> torch.Tensor:
        out_of_bounds = (state.x.abs() > params.x_threshold) | (
            state.theta.abs() > params.theta_threshold_radians
        )
        return out_of_bounds | (state.time >= params.max_steps_in_episode)

    def observation_space(self, params) -> spaces.Box:
        high = np.array(
            [
                params.x_threshold * 2,
                np.finfo(np.float32).max,
                params.theta_threshold_radians * 2,
                np.finfo(np.float32).max,
            ],
            np.float32,
        )
        return spaces.Box(-high, high, (4,), np.float32)

    def action_space(self, params=None) -> spaces.Discrete:
        return spaces.Discrete(2)
