"""Pusher-v0: a 2-joint planar arm pushing a puck onto a goal pad, batched
over E envs.

Port of purejaxql_tpu/envs/classic/pusher.py: Reacher's arm (reacher.py
``arm_dynamics``) and a free puck. While the fingertip's disk overlaps the
puck's (contact_radius), the puck is pushed out along the contact normal and
takes the fingertip's approach speed along it; then it slides, keeping
puck_friction of its velocity a step (pusher.py:108-123). The reward is
-|puck - goal| - 0.5 |tip - puck| + 10 in the goal - 0.01 |torque|^2, and the
episode ends when the puck reaches the goal (pusher.py:146) or after 150
steps. Observations (18): cos, sin of both angles, the velocities over
max_speed, the fingertip, the puck, its velocity, the goal, puck - goal,
tip - puck.

A reset's randomness comes in as an argument (``start_state``, fed by
``draw_start``): both angles ~ U[-pi, pi), the puck in an annulus of radii
[0.3, reach - 0.25) at a uniform angle, the goal 0.25-0.5 from it in a
uniform direction, pulled within reach - 0.1 of the shoulder
(pusher.py:73-99). The step draws nothing.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from purejaxql_torch.envs import spaces
from purejaxql_torch.envs.base import Environment
from purejaxql_torch.envs.classic.reacher import arm_dynamics, fingertip, norm2, uniform


@dataclass
class PusherState:
    theta: torch.Tensor  # (E, 2) joint angles
    theta_dot: torch.Tensor  # (E, 2)
    puck: torch.Tensor  # (E, 2) xy
    puck_vel: torch.Tensor  # (E, 2)
    goal: torch.Tensor  # (E, 2) xy
    time: torch.Tensor  # int32


@dataclass(frozen=True)
class PusherParams:
    dt: float = 0.05
    gear: float = 4.0
    damping: float = 0.9
    max_speed: float = 8.0
    l1: float = 0.6
    l2: float = 0.4
    contact_radius: float = 0.2  # fingertip disk + puck disk
    puck_friction: float = 0.85  # per-step velocity retention
    goal_radius: float = 0.1
    max_steps_in_episode: int = 150


def draw_start(generator: torch.Generator, num_envs: int, params: PusherParams) -> torch.Tensor:
    """(E, 6) reset draws [theta0, theta1, puck radius, puck angle, goal
    offset, goal direction]."""
    reach = params.l1 + params.l2
    n = (num_envs, 1)
    return torch.cat([
        uniform(generator, (num_envs, 2), -math.pi, math.pi),
        uniform(generator, n, 0.3, reach - 0.25), uniform(generator, n, -math.pi, math.pi),
        uniform(generator, n, 0.25, 0.5), uniform(generator, n, -math.pi, math.pi),
    ], 1)


def _polar(radius: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    return radius * torch.cat([torch.cos(angle), torch.sin(angle)], 1)


def start_state(draws: torch.Tensor, params: PusherParams) -> PusherState:
    """The state after a reset from its (E, 6) draws."""
    n, dev = draws.shape[0], draws.device
    reach = params.l1 + params.l2
    puck = _polar(draws[:, 2:3], draws[:, 3:4])
    goal = puck + _polar(draws[:, 4:5], draws[:, 5:6])
    goal = goal * torch.clamp_max((reach - 0.1) / norm2(goal), 1.0)[:, None]
    zeros = torch.zeros(n, 2, device=dev)
    return PusherState(theta=draws[:, :2], theta_dot=zeros, puck=puck, puck_vel=zeros, goal=goal,
                       time=torch.zeros(n, dtype=torch.int32, device=dev))


class Pusher(Environment):
    @property
    def default_params(self) -> PusherParams:
        return PusherParams()

    @property
    def name(self) -> str:
        return "Pusher-v0"

    def reset_env(self, generator, num_envs, params):
        state = start_state(draw_start(generator, num_envs, params), params)
        return self.get_obs(state, params), state

    def step_env(self, state, action, params, draws):
        p = params
        torque, theta, theta_dot = arm_dynamics(state.theta, state.theta_dot, action, p)
        tip_old = fingertip(state.theta, p)
        tip = fingertip(theta, p)
        tip_vel = (tip - tip_old) / p.dt
        # disk contact: de-penetrate along the normal, transfer the approach speed
        delta = state.puck - tip
        dist = norm2(delta) + 1e-8
        normal = delta / dist[:, None]
        overlap = torch.clamp_min(p.contact_radius - dist, 0.0)
        touching = (overlap > 0.0).float()
        approach = torch.clamp_min((tip_vel * normal).sum(-1), 0.0)
        puck_vel = state.puck_vel + (touching * approach)[:, None] * normal
        puck = state.puck + overlap[:, None] * normal + puck_vel * p.dt
        puck_vel = puck_vel * p.puck_friction
        new_state = PusherState(theta=theta, theta_dot=theta_dot, puck=puck, puck_vel=puck_vel, goal=state.goal,
                                time=state.time + 1)
        d_goal = norm2(puck - state.goal)
        d_tip = norm2(tip - puck)
        in_goal = d_goal < p.goal_radius
        reward = -d_goal - 0.5 * d_tip + 10.0 * in_goal.float() - 0.01 * torch.square(torque).sum(-1)
        done = in_goal | (new_state.time >= p.max_steps_in_episode)
        return self.get_obs(new_state, p), new_state, reward, done, {}

    def get_obs(self, state: PusherState, params) -> torch.Tensor:
        tip = fingertip(state.theta, params)
        return torch.cat([
            torch.cos(state.theta), torch.sin(state.theta), state.theta_dot / params.max_speed, tip,
            state.puck, state.puck_vel, state.goal, state.puck - state.goal, tip - state.puck,
        ], -1)

    def observation_space(self, params) -> spaces.Box:
        return spaces.Box(-8.0, 8.0, (18,), np.float32)

    def action_space(self, params=None) -> spaces.Box:
        return spaces.Box(-1.0, 1.0, (2,), np.float32)
