"""FingerSpin / FingerTurnEasy / FingerTurnHard: a 2-link torque-actuated
finger spins or turns a free hinge, batched over E envs.

Port of purejaxql_tpu/envs/classic/finger.py. The finger hangs from the
origin (gravity, joint damping, diagonal inertias, joint stops at +-2 rad);
the spinner is a free hinge whose rim the fingertip engages through a
penalty contact: a normal spring push-out and a tangential friction that
moves momentum into the spinner, whose reaction arm is the contact's
distance from the hinge. A step is 8 substeps of dt 0.004 (a Python loop
where JAX scans, finger.py:166-175). Task ``spin`` pays clip(-spin_vel /
10, 0, 1), the turn tasks a Gaussian of the rim's angle error to the target
(width 0.6 easy, 0.15 hard), each minus 0.01 |a|^2; 1,000-step episodes.
Observations (13): sin, cos and velocity / 10 of both joints, sin, cos and
velocity / 10 of the spinner, sin, cos of the target, the fingertip.

A reset's randomness comes in as an argument (``start_state``, fed by
``draw_start``): the joints ~ U[-0.3, 0.3)^2, the target ~ U[-pi, pi) (0
for spin, which draws it all the same) and the spinner ~ U[-pi, pi)
(finger.py:89-104). The step draws nothing.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch

from purejaxql_torch.envs import spaces
from purejaxql_torch.envs.base import Environment
from purejaxql_torch.envs.classic.point_mass import norm2
from purejaxql_torch.envs.classic.reacher import uniform


@dataclass
class FingerState:
    q: torch.Tensor  # (E, 2) joint angles
    qd: torch.Tensor  # (E, 2) joint velocities
    spin: torch.Tensor  # spinner hinge angle
    spin_vel: torch.Tensor
    target: torch.Tensor  # target rim angle (turn tasks; 0 for spin)
    time: torch.Tensor  # int32


@dataclass(frozen=True)
class FingerParams:
    link1: float = 0.17
    link2: float = 0.16
    m1: float = 0.35
    m2: float = 0.25
    gravity: float = 9.8
    joint_damp: float = 0.08
    torque: float = 1.2
    # spinner: hinge at (cx, cy), rim radius r
    cx: float = 0.18
    cy: float = -0.18
    radius: float = 0.10
    spin_inertia: float = 0.0035
    spin_damp: float = 0.002
    contact_k: float = 120.0
    friction: float = 2.0
    dt: float = 0.004
    substeps: int = 8
    max_steps_in_episode: int = 1000


_NAMES = {"spin": "FingerSpin-v0", "turn_easy": "FingerTurnEasy-v0", "turn_hard": "FingerTurnHard-v0"}


def draw_start(generator: torch.Generator, num_envs: int) -> torch.Tensor:
    """(E, 4) reset draws [q0, q1, target, spin]."""
    return torch.cat([uniform(generator, (num_envs, 2), -0.3, 0.3),
                      uniform(generator, (num_envs, 2), -math.pi, math.pi)], 1)


def tip(q: torch.Tensor, p) -> torch.Tensor:
    """(E, 2) fingertip of the chain hanging from the origin, q from
    straight down."""
    a1 = q[:, 0]
    a2 = q[:, 0] + q[:, 1]
    return torch.stack([p.link1 * torch.sin(a1) + p.link2 * torch.sin(a2),
                        -p.link1 * torch.cos(a1) - p.link2 * torch.cos(a2)], -1)


def substep(s: FingerState, action: torch.Tensor, p) -> FingerState:
    """One semi-implicit Euler substep (finger.py:122-164)."""
    tau = p.torque * action
    # gravity torques for the hanging 2-link chain (point masses at tips)
    a1 = s.q[:, 0]
    a2 = s.q[:, 0] + s.q[:, 1]
    g = p.gravity
    g1 = -(p.m1 + p.m2) * g * p.link1 * torch.sin(a1) - p.m2 * g * p.link2 * torch.sin(a2)
    g2 = -p.m2 * g * p.link2 * torch.sin(a2)

    # fingertip / spinner rim contact
    rel = tip(s.q, p) - torch.tensor([p.cx, p.cy], device=s.q.device)
    dist = norm2(rel) + 1e-8
    pen = torch.clamp_min(p.radius - dist, 0.0)
    n = rel / dist[:, None]
    # tip velocity through the chain's Jacobian
    j11 = p.link1 * torch.cos(a1) + p.link2 * torch.cos(a2)
    j12 = p.link2 * torch.cos(a2)
    j21 = p.link1 * torch.sin(a1) + p.link2 * torch.sin(a2)
    j22 = p.link2 * torch.sin(a2)
    qd0, qd1 = s.qd[:, 0], s.qd[:, 1]
    v_tip = torch.stack([j11 * qd0 + j12 * qd1, j21 * qd0 + j22 * qd1], -1)
    # the rim's material velocity at the contact, at distance `dist`
    t_dir = torch.stack([-n[:, 1], n[:, 0]], -1)
    v_rim = (s.spin_vel * dist)[:, None] * t_dir
    dv = v_tip - v_rim
    v_rel_t = dv[:, 0] * t_dir[:, 0] + dv[:, 1] * t_dir[:, 1]
    touching = (pen > 0).float()
    f_n = (p.contact_k * pen)[:, None] * n
    f_t = (-p.friction * v_rel_t)[:, None] * t_dir * touching[:, None]
    f = f_n + f_t
    tau_contact0 = j11 * f[:, 0] + j21 * f[:, 1]
    tau_contact1 = j12 * f[:, 0] + j22 * f[:, 1]
    spin_acc = (p.friction * v_rel_t * touching * dist - p.spin_damp * s.spin_vel) / p.spin_inertia

    # inertias about each joint (diagonal approximation)
    i1 = (p.m1 + p.m2) * p.link1**2 + p.m2 * p.link2**2
    i2 = p.m2 * p.link2**2
    qdd = torch.stack([(tau[:, 0] + g1 + tau_contact0 - p.joint_damp * qd0) / i1,
                       (tau[:, 1] + g2 + tau_contact1 - p.joint_damp * qd1) / i2], -1)
    qd = torch.clamp(s.qd + qdd * p.dt, -25.0, 25.0)
    q = torch.clamp(s.q + qd * p.dt, -2.0, 2.0)
    qd = torch.where(q.abs() >= 2.0, 0.0, qd)  # joint stops
    spin_vel = s.spin_vel + spin_acc * p.dt
    spin = s.spin + spin_vel * p.dt
    return replace(s, q=q, qd=qd, spin=spin, spin_vel=spin_vel)


class Finger(Environment):
    TASKS = tuple(_NAMES)

    def __init__(self, task: str = "spin"):
        assert task in self.TASKS, task
        self.task = task

    @property
    def default_params(self) -> FingerParams:
        return FingerParams()

    @property
    def name(self) -> str:
        return _NAMES[self.task]

    def start_state(self, draws: torch.Tensor) -> FingerState:
        n, dev = draws.shape[0], draws.device
        target = torch.zeros(n, device=dev) if self.task == "spin" else draws[:, 2]
        return FingerState(q=draws[:, :2], qd=torch.zeros(n, 2, device=dev), spin=draws[:, 3],
                           spin_vel=torch.zeros(n, device=dev), target=target,
                           time=torch.zeros(n, dtype=torch.int32, device=dev))

    def reset_env(self, generator, num_envs, params):
        state = self.start_state(draw_start(generator, num_envs))
        return self.get_obs(state, params), state

    def step_env(self, state, action, params, draws):
        p = params
        action = torch.clamp(action, -1.0, 1.0)
        s = state
        for _ in range(p.substeps):
            s = substep(s, action, p)
        s = replace(s, time=state.time + 1)
        if self.task == "spin":
            # a dense ramp saturating at -10 rad/s (finger.py:178-186)
            reward = torch.clamp(-s.spin_vel / 10.0, 0.0, 1.0)
        else:
            tol = 0.6 if self.task == "turn_easy" else 0.15
            err = torch.atan2(torch.sin(s.spin - s.target), torch.cos(s.spin - s.target))
            reward = torch.exp(-(err**2) / (2 * tol**2))
        reward = reward - 0.01 * (action**2).sum(-1)
        done = s.time >= p.max_steps_in_episode
        return self.get_obs(s, p), s, reward, done, {}

    def get_obs(self, state: FingerState, params=None) -> torch.Tensor:
        p = params or self.default_params
        s = state
        return torch.cat([
            torch.sin(s.q), torch.cos(s.q), s.qd / 10.0,
            torch.stack([torch.sin(s.spin), torch.cos(s.spin), s.spin_vel / 10.0,
                         torch.sin(s.target), torch.cos(s.target)], -1),
            tip(s.q, p),
        ], -1)

    def observation_space(self, params) -> spaces.Box:
        return spaces.Box(-np.inf, np.inf, (13,), np.float32)

    def action_space(self, params=None) -> spaces.Box:
        return spaces.Box(-1.0, 1.0, (2,), np.float32)
