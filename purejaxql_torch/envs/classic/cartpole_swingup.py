"""CartPoleSwingUp and its three other tasks (dm-suite cartpole), batched
over E envs.

Port of purejaxql_tpu/envs/classic/cartpole_swingup.py: CartPole-v1's
rigid-body dynamics with a continuous force of force_mag x clip(a, -1, 1),
the cart clipped to the track (its velocity zeroed at the edge), no early
termination, 500 steps. Task ``swingup`` (CartPoleSwingUp-v0) and
``swingup_sparse`` start hanging down (theta = pi), ``balance`` and
``balance_sparse`` upright (cartpole_swingup.py:75). The dense reward is
(1 + cos theta) / 2 x (0.5 + 0.5 (1 - |x| / x_threshold)); the sparse one 1
while cos theta > 0.995 and |x| < x_threshold / 2. Observations (5): x,
x_dot, cos theta, sin theta, theta_dot.

A reset's randomness comes in as an argument (``start_state``, fed by
``draw_start``): x ~ U[-0.1, 0.1) and the angle's offset ~ U[-0.1, 0.1)
(cartpole_swingup.py:73-79). The step draws nothing.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from purejaxql_torch.envs import spaces
from purejaxql_torch.envs.base import Environment
from purejaxql_torch.envs.classic.reacher import uniform


@dataclass
class SwingUpState:
    x: torch.Tensor
    x_dot: torch.Tensor
    theta: torch.Tensor  # 0 = upright, pi = hanging down
    theta_dot: torch.Tensor
    time: torch.Tensor  # int32


@dataclass(frozen=True)
class SwingUpParams:
    gravity: float = 9.8
    masscart: float = 1.0
    masspole: float = 0.1
    total_mass: float = 1.1
    length: float = 0.5
    polemass_length: float = 0.05
    force_mag: float = 10.0
    tau: float = 0.02
    x_threshold: float = 2.4
    max_steps_in_episode: int = 500


_TASKS = ("swingup", "swingup_sparse", "balance", "balance_sparse")


def draw_start(generator: torch.Generator, num_envs: int) -> torch.Tensor:
    """(E, 2) reset draws [x, angle offset], both U[-0.1, 0.1)."""
    return uniform(generator, (num_envs, 2), -0.1, 0.1)


class CartPoleSwingUp(Environment):
    def __init__(self, task: str = "swingup"):
        assert task in _TASKS, f"task must be one of {_TASKS}"
        self.task = task

    @property
    def default_params(self) -> SwingUpParams:
        return SwingUpParams()

    @property
    def name(self) -> str:
        return {
            "swingup": "CartPoleSwingUp-v0",
            "swingup_sparse": "CartPoleSwingUpSparse-v0",
            "balance": "CartpoleBalance-v0",
            "balance_sparse": "CartpoleBalanceSparse-v0",
        }[self.task]

    def start_state(self, draws: torch.Tensor) -> SwingUpState:
        """The state after a reset from its (E, 2) draws: the balance tasks
        start upright, the swing-up tasks hanging down."""
        n, dev = draws.shape[0], draws.device
        theta0 = 0.0 if self.task.startswith("balance") else math.pi
        zero = torch.zeros(n, device=dev)
        return SwingUpState(
            x=draws[:, 0], x_dot=zero, theta=theta0 + draws[:, 1], theta_dot=zero,
            time=torch.zeros(n, dtype=torch.int32, device=dev),
        )

    def reset_env(self, generator, num_envs, params):
        state = self.start_state(draw_start(generator, num_envs))
        return self.get_obs(state), state

    def step_env(self, state, action, params, draws):
        p = params
        force = p.force_mag * torch.clamp(action[:, 0], -1.0, 1.0)
        costheta, sintheta = torch.cos(state.theta), torch.sin(state.theta)
        temp = (force + p.polemass_length * state.theta_dot**2 * sintheta) / p.total_mass
        thetaacc = (p.gravity * sintheta - costheta * temp) / (
            p.length * (4.0 / 3.0 - p.masspole * costheta**2 / p.total_mass)
        )
        xacc = temp - p.polemass_length * thetaacc * costheta / p.total_mass
        x = torch.clamp(state.x + p.tau * state.x_dot, -p.x_threshold, p.x_threshold)
        x_dot = state.x_dot + p.tau * xacc
        x_dot = torch.where(x.abs() >= p.x_threshold, 0.0, x_dot)
        theta = state.theta + p.tau * state.theta_dot
        theta_dot = state.theta_dot + p.tau * thetaacc
        new_state = SwingUpState(x=x, x_dot=x_dot, theta=theta, theta_dot=theta_dot, time=state.time + 1)
        if self.task.endswith("sparse"):
            reward = ((torch.cos(theta) > 0.995) & (x.abs() < 0.5 * p.x_threshold)).float()
        else:
            upright = (1.0 + torch.cos(theta)) / 2.0
            centered = 1.0 - x.abs() / p.x_threshold
            reward = upright * (0.5 + 0.5 * centered)
        done = new_state.time >= p.max_steps_in_episode
        return self.get_obs(new_state), new_state, reward, done, {}

    def get_obs(self, state: SwingUpState) -> torch.Tensor:
        return torch.stack(
            [state.x, state.x_dot, torch.cos(state.theta), torch.sin(state.theta), state.theta_dot], -1
        )

    def observation_space(self, params) -> spaces.Box:
        big = np.finfo(np.float32).max
        high = np.array([params.x_threshold, big, 1.0, 1.0, big], np.float32)
        return spaces.Box(-high, high, (5,), np.float32)

    def action_space(self, params=None) -> spaces.Box:
        return spaces.Box(-1.0, 1.0, (1,), np.float32)
