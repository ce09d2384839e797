"""Acrobot-v1: the two-link underactuated pendulum swing-up, batched over E
envs.

Port of purejaxql_tpu/envs/classic/acrobot.py (the Gym/gymnax dynamics):
one RK4 step of dt 0.2 of Sutton's two-link equations of motion, torque in
{-1, 0, +1} plus a uniform noise of +-torque_noise_max, the angles wrapped
to [-pi, pi) and the velocities clipped to +-4 pi and +-9 pi. The reward is
-1 every step until the tip rises above the bar (-cos q1 - cos(q1 + q2) >
1), which ends the episode, as do 500 steps. Observations: cos, sin of both
angles, both velocities.

A reset's randomness comes in as an argument (``start_state``, fed by
``draw_start``): the four state values ~ U[-0.1, 0.1). The step draws its
torque noise even at the default torque_noise_max of 0 (acrobot.py:70-73):
``step_draws`` gives U[0, 1) per env, scaled in ``step_env`` as JAX's
``uniform`` scales its bits.

``_rk4_step`` and ``_wrap`` serve AcrobotSwingup too (acrobot_swingup.py).
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
class AcrobotState:
    joint_angle1: torch.Tensor
    joint_angle2: torch.Tensor
    velocity_1: torch.Tensor
    velocity_2: torch.Tensor
    time: torch.Tensor  # int32


@dataclass(frozen=True)
class AcrobotParams:
    dt: float = 0.2
    link_length_1: float = 1.0
    link_length_2: float = 1.0
    link_mass_1: float = 1.0
    link_mass_2: float = 1.0
    link_com_pos_1: float = 0.5
    link_com_pos_2: float = 0.5
    link_moi: float = 1.0
    max_vel_1: float = 4 * math.pi
    max_vel_2: float = 9 * math.pi
    torque_noise_max: float = 0.0
    max_steps_in_episode: int = 500


def draw_start(generator: torch.Generator, num_envs: int) -> torch.Tensor:
    """(E, 4) reset draws: both angles and velocities, U[-0.1, 0.1)."""
    return uniform(generator, (num_envs, 4), -0.1, 0.1)


def start_state(draws: torch.Tensor) -> AcrobotState:
    """The state after a reset from its (E, 4) draws."""
    return AcrobotState(
        joint_angle1=draws[:, 0], joint_angle2=draws[:, 1], velocity_1=draws[:, 2], velocity_2=draws[:, 3],
        time=torch.zeros(draws.shape[0], dtype=torch.int32, device=draws.device),
    )


def _dsdt(s, p):
    """The time derivative of (theta1, theta2, dtheta1, dtheta2, torque)
    (acrobot.py:137-168), each (E,)."""
    m1, m2 = p.link_mass_1, p.link_mass_2
    l1 = p.link_length_1
    lc1, lc2 = p.link_com_pos_1, p.link_com_pos_2
    i1, i2 = p.link_moi, p.link_moi
    g = 9.8
    theta1, theta2, dtheta1, dtheta2, a = s
    d1 = m1 * lc1**2 + m2 * (l1**2 + lc2**2 + 2 * l1 * lc2 * torch.cos(theta2)) + i1 + i2
    d2 = m2 * (lc2**2 + l1 * lc2 * torch.cos(theta2)) + i2
    phi2 = m2 * lc2 * g * torch.cos(theta1 + theta2 - math.pi / 2.0)
    phi1 = (
        -m2 * l1 * lc2 * dtheta2**2 * torch.sin(theta2)
        - 2 * m2 * l1 * lc2 * dtheta2 * dtheta1 * torch.sin(theta2)
        + (m1 * lc1 + m2 * l1) * g * torch.cos(theta1 - math.pi / 2)
        + phi2
    )
    ddtheta2 = (a + d2 / d1 * phi1 - m2 * l1 * lc2 * dtheta1**2 * torch.sin(theta2) - phi2) / (
        m2 * lc2**2 + i2 - d2**2 / d1
    )
    ddtheta1 = -(d2 * ddtheta2 + phi1) / d1
    return dtheta1, dtheta2, ddtheta1, ddtheta2, torch.zeros_like(a)


def _rk4_step(s, p):
    """One RK4 step of dt of the five (E,) values (acrobot.py:171-177)."""
    dt = p.dt

    def ahead(h, k):
        return tuple(x + h * kx for x, kx in zip(s, k))

    k1 = _dsdt(s, p)
    k2 = _dsdt(ahead(dt / 2, k1), p)
    k3 = _dsdt(ahead(dt / 2, k2), p)
    k4 = _dsdt(ahead(dt, k3), p)
    return tuple(x + dt / 6.0 * (a + 2 * b + 2 * c + d) for x, a, b, c, d in zip(s, k1, k2, k3, k4))


def _wrap(x: torch.Tensor, low: float, high: float) -> torch.Tensor:
    """x into [low, high): torch's ``%`` takes the divisor's sign, as
    ``jnp.remainder`` does (acrobot.py:180-182)."""
    diff = high - low
    return ((x - low) % diff) + low


def integrate(state: AcrobotState, torque: torch.Tensor, p) -> AcrobotState:
    """The state one RK4 step on under ``torque`` (E,), its angles wrapped
    and its velocities clipped (acrobot.py:75-97)."""
    ns = _rk4_step((state.joint_angle1, state.joint_angle2, state.velocity_1, state.velocity_2, torque), p)
    return AcrobotState(
        joint_angle1=_wrap(ns[0], -math.pi, math.pi),
        joint_angle2=_wrap(ns[1], -math.pi, math.pi),
        velocity_1=torch.clamp(ns[2], -p.max_vel_1, p.max_vel_1),
        velocity_2=torch.clamp(ns[3], -p.max_vel_2, p.max_vel_2),
        time=state.time + 1,
    )


def get_obs(state: AcrobotState) -> torch.Tensor:
    return torch.stack([
        torch.cos(state.joint_angle1), torch.sin(state.joint_angle1),
        torch.cos(state.joint_angle2), torch.sin(state.joint_angle2),
        state.velocity_1, state.velocity_2,
    ], -1)


def observation_space(params) -> spaces.Box:
    high = np.array([1.0, 1.0, 1.0, 1.0, params.max_vel_1, params.max_vel_2], np.float32)
    return spaces.Box(-high, high, (6,), np.float32)


class Acrobot(Environment):
    """Acrobot-v1 with 3 discrete torque actions."""

    @property
    def default_params(self) -> AcrobotParams:
        return AcrobotParams()

    @property
    def name(self) -> str:
        return "Acrobot-v1"

    def reset_env(self, generator, num_envs, params):
        state = start_state(draw_start(generator, num_envs))
        return get_obs(state), state

    def step_draws(self, generator, num_envs):
        """(E,) U[0, 1): the torque noise's draws."""
        return torch.rand(num_envs, generator=generator, device=generator.device)

    def step_env(self, state, action, params, draws):
        p = params
        lo, hi = -p.torque_noise_max, p.torque_noise_max
        noise = torch.clamp_min(draws * (hi - lo) + lo, lo)
        torque = (action - 1).float() + noise
        new_state = integrate(state, torque, p)
        done = self.is_terminal(new_state, p)
        solved = -torch.cos(new_state.joint_angle1) - torch.cos(new_state.joint_angle2 + new_state.joint_angle1) > 1.0
        reward = solved.float() - 1.0
        return get_obs(new_state), new_state, reward, done, {}

    def get_obs(self, state: AcrobotState, params=None) -> torch.Tensor:
        return get_obs(state)

    def is_terminal(self, state: AcrobotState, params: AcrobotParams) -> torch.Tensor:
        solved = -torch.cos(state.joint_angle1) - torch.cos(state.joint_angle2 + state.joint_angle1) > 1.0
        return solved | (state.time >= params.max_steps_in_episode)

    def observation_space(self, params) -> spaces.Box:
        return observation_space(params)

    def action_space(self, params=None) -> spaces.Discrete:
        return spaces.Discrete(3)
