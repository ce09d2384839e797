"""Reacher-v0 and its sparse tasks: a 2-joint planar arm reaching a random
target, batched over E envs.

Port of purejaxql_tpu/envs/classic/reacher.py: decoupled joint dynamics
(damped velocity plus gear x torque x dt, clipped to +-max_speed, then the
angles), the fingertip at l1 (cos t0, sin t0) + l2 (cos(t0 + t1), sin(t0 +
t1)), episode length 150. Task ``dense`` (Reacher-v0) pays -distance - 0.01
|torque|^2; ``easy`` and ``hard`` pay 1 while the fingertip is within 0.20 or
0.06 of the target. The distance is taken from the new angles to the target.
Observations (10): cos, sin of both angles, the velocities over max_speed,
the target, the fingertip minus the target.

A reset's randomness comes in as an argument (``start_state``, fed by
``draw_start``): both angles ~ U[-pi, pi), the target's radius ~ U[0.2,
l1 + l2 - 0.05) and its angle ~ U[-pi, pi) (reacher.py:76-84). The step
draws nothing.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from purejaxql_torch.envs import spaces
from purejaxql_torch.envs.base import Environment


@dataclass
class ReacherState:
    theta: torch.Tensor  # (E, 2) joint angles
    theta_dot: torch.Tensor  # (E, 2)
    target: torch.Tensor  # (E, 2) xy
    time: torch.Tensor  # (E,) int32


@dataclass(frozen=True)
class ReacherParams:
    dt: float = 0.05
    gear: float = 4.0
    damping: float = 0.9
    max_speed: float = 8.0
    l1: float = 0.6
    l2: float = 0.4
    max_steps_in_episode: int = 150


_TARGET_RADIUS = {"easy": 0.20, "hard": 0.06}


def uniform(generator: torch.Generator, shape, low, high) -> torch.Tensor:
    """U[low, high) draws on the generator's device, as low + (high - low) u."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u * (high - low) + low


def draw_start(generator: torch.Generator, num_envs: int, params: ReacherParams) -> torch.Tensor:
    """(E, 4) reset draws [theta0, theta1, radius, angle] (reacher.py:76-84)."""
    theta = uniform(generator, (num_envs, 2), -math.pi, math.pi)
    radius = uniform(generator, (num_envs, 1), 0.2, params.l1 + params.l2 - 0.05)
    angle = uniform(generator, (num_envs, 1), -math.pi, math.pi)
    return torch.cat([theta, radius, angle], 1)


def start_state(draws: torch.Tensor) -> ReacherState:
    """The state after a reset from its (E, 4) draws."""
    n, dev = draws.shape[0], draws.device
    radius, angle = draws[:, 2:3], draws[:, 3:4]
    return ReacherState(
        theta=draws[:, :2],
        theta_dot=torch.zeros(n, 2, device=dev),
        target=radius * torch.cat([torch.cos(angle), torch.sin(angle)], 1),
        time=torch.zeros(n, dtype=torch.int32, device=dev),
    )


def fingertip(theta: torch.Tensor, p) -> torch.Tensor:
    """(E, 2) fingertip of a 2-link arm of lengths l1, l2 at angles (E, 2)."""
    t0, t1 = theta[:, 0], theta[:, 1]
    x = p.l1 * torch.cos(t0) + p.l2 * torch.cos(t0 + t1)
    y = p.l1 * torch.sin(t0) + p.l2 * torch.sin(t0 + t1)
    return torch.stack([x, y], -1)


def norm2(v: torch.Tensor) -> torch.Tensor:
    """The Euclidean norm over the last axis, sqrt of the sum of squares."""
    return torch.sqrt((v * v).sum(-1))


def arm_dynamics(theta, theta_dot, action, p):
    """(torque, new theta, new theta_dot) of the damped torque-driven arm
    (reacher.py:93-98, pusher.py:101-106)."""
    torque = torch.clamp(action.reshape(-1, 2), -1.0, 1.0)
    new_dot = theta_dot * p.damping + torque * p.gear * p.dt
    new_dot = torch.clamp(new_dot, -p.max_speed, p.max_speed)
    return torque, theta + new_dot * p.dt, new_dot


class Reacher(Environment):
    def __init__(self, task: str = "dense"):
        assert task in ("dense", "easy", "hard"), task
        self.task = task

    @property
    def default_params(self) -> ReacherParams:
        return ReacherParams()

    @property
    def name(self) -> str:
        return {"dense": "Reacher-v0", "easy": "ReacherEasy-v0", "hard": "ReacherHard-v0"}[self.task]

    def reset_env(self, generator, num_envs, params):
        state = start_state(draw_start(generator, num_envs, params))
        return self.get_obs(state, params), state

    def step_env(self, state, action, params, draws):
        torque, theta, theta_dot = arm_dynamics(state.theta, state.theta_dot, action, params)
        new_state = ReacherState(theta=theta, theta_dot=theta_dot, target=state.target, time=state.time + 1)
        dist = norm2(fingertip(theta, params) - state.target)
        if self.task == "dense":
            reward = -dist - 0.01 * torch.square(torque).sum(-1)
        else:
            reward = (dist < _TARGET_RADIUS[self.task]).float()
        done = new_state.time >= params.max_steps_in_episode
        return self.get_obs(new_state, params), new_state, reward, done, {}

    def get_obs(self, state: ReacherState, params) -> torch.Tensor:
        tip = fingertip(state.theta, params)
        return torch.cat([
            torch.cos(state.theta), torch.sin(state.theta), state.theta_dot / params.max_speed,
            state.target, tip - state.target,
        ], -1)

    def observation_space(self, params) -> spaces.Box:
        return spaces.Box(-2.0, 2.0, (10,), np.float32)

    def action_space(self, params=None) -> spaces.Box:
        return spaces.Box(-1.0, 1.0, (2,), np.float32)
