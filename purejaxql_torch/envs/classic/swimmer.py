"""SwimmerSwimmer6-v0: the 6-link low-Reynolds planar swimmer, batched over
E envs.

Port of purejaxql_tpu/envs/classic/swimmer.py. Resistive-force theory: each
link feels anisotropic viscous drag, inertia is negligible, and the chain's
rigid motion (vx, vy, omega) is what makes the net drag force and torque
vanish given the commanded joint rates: a 3 x 3 linear solve (``body_solve``,
swimmer.py:60-124), here one batched (E, 3, 3) ``torch.linalg.solve_ex`` (no
host check of its info, so no sync). A step is 2 substeps of the midpoint
rule over dt 0.03; the joint angles are clipped to +-1.7 and a rate pushing
past a limit is zeroed. The reward ramps from 1 inside the target radius to
0 over reward_margin; 500-step episodes. Observations (10): the target in
the nose frame, the 5 joint angles, the nose-frame body velocity, the body
rate.

A reset's randomness comes in as an argument (``start_state``, fed by
``draw_start``): the target's distance ~ U[0.4, 0.8) and angle ~ U[-pi, pi),
the joint angles ~ U[-0.3, 0.3)^5 (swimmer.py:133-140). The step draws
nothing.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from purejaxql_torch.envs import spaces
from purejaxql_torch.envs.base import Environment
from purejaxql_torch.envs.classic.point_mass import norm2
from purejaxql_torch.envs.classic.reacher import uniform

N_LINKS = 6
N_JOINTS = N_LINKS - 1


@dataclass
class SwimmerState:
    nose: torch.Tensor  # (E, 2) head endpoint position
    theta: torch.Tensor  # (E,) absolute angle of the first link
    phi: torch.Tensor  # (E, 5) joint angles
    body_vel: torch.Tensor  # (E, 3) last solved (vx, vy, omega), world frame
    target: torch.Tensor  # (E, 2)
    time: torch.Tensor  # int32


@dataclass(frozen=True)
class SwimmerParams:
    dt: float = 0.03
    n_substeps: int = 2
    link_length: float = 0.1
    drag_tangent: float = 1.0
    drag_normal: float = 10.0
    joint_rate: float = 4.0  # rad/s at |action| = 1
    joint_limit: float = 1.7
    target_radius: float = 0.1
    reward_margin: float = 1.2
    max_steps_in_episode: int = 500


def draw_start(generator: torch.Generator, num_envs: int) -> torch.Tensor:
    """(E, 7) reset draws [distance, angle, phi x 5]."""
    return torch.cat([uniform(generator, (num_envs, 1), 0.4, 0.8),
                      uniform(generator, (num_envs, 1), -math.pi, math.pi),
                      uniform(generator, (num_envs, N_JOINTS), -0.3, 0.3)], 1)


def start_state(draws: torch.Tensor) -> SwimmerState:
    n, dev = draws.shape[0], draws.device
    dist, ang = draws[:, 0:1], draws[:, 1:2]
    return SwimmerState(
        nose=torch.zeros(n, 2, device=dev), theta=torch.zeros(n, device=dev), phi=draws[:, 2:],
        body_vel=torch.zeros(n, 3, device=dev), target=dist * torch.cat([torch.cos(ang), torch.sin(ang)], 1),
        time=torch.zeros(n, dtype=torch.int32, device=dev),
    )


def _shifted_cumsum(x: torch.Tensor) -> torch.Tensor:
    """cat([0], cumsum(x)[:-1]) over the links axis (1) of (E, 6, ...)."""
    return torch.cat([torch.zeros_like(x[:, :1]), torch.cumsum(x, 1)[:, :-1]], 1)


def body_solve(theta, phi, phidot, p):
    """(E, 3) (vx, vy, omega) from the quasi-static force and torque balance
    M z = b of the chain (swimmer.py:60-124): link i's center moves at v +
    omega A_i + B_i and feels the drag -D_i of that, D_i = l (c_t t t^T + c_n
    n n^T)."""
    l = p.link_length
    zero = torch.zeros_like(theta[:, None])
    alpha = theta[:, None] + torch.cat([zero, torch.cumsum(phi, 1)], 1)  # (E, 6)
    g = torch.cat([zero, torch.cumsum(phidot, 1)], 1)  # (E, 6)
    t_hat = torch.stack([torch.cos(alpha), torch.sin(alpha)], -1)  # (E, 6, 2)
    n_hat = torch.stack([-torch.sin(alpha), torch.cos(alpha)], -1)
    r = _shifted_cumsum(l * t_hat) + 0.5 * l * t_hat
    A = _shifted_cumsum(l * n_hat) + 0.5 * l * n_hat
    B = _shifted_cumsum(l * n_hat * g[..., None]) + 0.5 * l * n_hat * g[..., None]
    D = l * (p.drag_tangent * t_hat[..., :, None] * t_hat[..., None, :]
             + p.drag_normal * n_hat[..., :, None] * n_hat[..., None, :])  # (E, 6, 2, 2)
    DA = (D * A[..., None, :]).sum(-1)  # (E, 6, 2)
    DB = (D * B[..., None, :]).sum(-1)
    r_perp = torch.stack([-r[..., 1], r[..., 0]], -1)
    c_rot = p.drag_normal * l**3 / 12.0
    D_sum, DA_sum = D.sum(1), DA.sum(1)  # (E, 2, 2), (E, 2)
    row2 = (r_perp[..., None] * D).sum(2).sum(1)  # (E, 2): sum_i r_perp_i^T D_i
    m22 = (r_perp * DA).sum(-1).sum(1) + N_LINKS * c_rot
    M = torch.cat([torch.cat([D_sum, DA_sum[..., None]], 2), torch.cat([row2, m22[:, None]], 1)[:, None]], 1)
    b = torch.cat([-DB.sum(1), (-(r_perp * DB).sum(-1).sum(1) - c_rot * g.sum(1))[:, None]], 1)
    z, _ = torch.linalg.solve_ex(M, b[..., None])
    return z[..., 0]


class Swimmer(Environment):
    @property
    def default_params(self) -> SwimmerParams:
        return SwimmerParams()

    @property
    def name(self) -> str:
        return "SwimmerSwimmer6-v0"

    def reset_env(self, generator, num_envs, params):
        state = start_state(draw_start(generator, num_envs))
        return self.get_obs(state), state

    def step_env(self, state, action, params, draws):
        p = params
        rate = torch.clamp(action, -1.0, 1.0) * p.joint_rate
        h = p.dt / p.n_substeps
        nose, theta, phi = state.nose, state.theta, state.phi
        for _ in range(p.n_substeps):
            # joint limits: zero the commanded rate where it pushes past
            at_limit = ((phi >= p.joint_limit) & (rate > 0)) | ((phi <= -p.joint_limit) & (rate < 0))
            phidot = torch.where(at_limit, 0.0, rate)
            # the midpoint rule (swimmer.py:171-179)
            z1 = body_solve(theta, phi, phidot, p)
            z = body_solve(theta + 0.5 * h * z1[:, 2], phi + 0.5 * h * phidot, phidot, p)
            nose = nose + z[:, :2] * h
            theta = theta + z[:, 2] * h
            phi = torch.clamp(phi + phidot * h, -p.joint_limit, p.joint_limit)
        new_state = SwimmerState(nose=nose, theta=theta, phi=phi, body_vel=z, target=state.target,
                                 time=state.time + 1)
        dist = norm2(nose - state.target)
        # dense: 1 inside the target, ramping to 0 over reward_margin
        reward = torch.clamp(1.0 - (dist - p.target_radius) / p.reward_margin, 0.0, 1.0)
        done = new_state.time >= p.max_steps_in_episode
        return self.get_obs(new_state), new_state, reward, done, {}

    def get_obs(self, state: SwimmerState, params=None) -> torch.Tensor:
        # world vectors into the nose (first-link) frame
        c, s = torch.cos(state.theta), torch.sin(state.theta)

        def rotate(v):
            return torch.stack([c * v[:, 0] + s * v[:, 1], -s * v[:, 0] + c * v[:, 1]], -1)

        return torch.cat([rotate(state.target - state.nose), state.phi, rotate(state.body_vel[:, :2]),
                          state.body_vel[:, 2:]], -1)

    def observation_space(self, params) -> spaces.Box:
        return spaces.Box(-np.inf, np.inf, (2 + N_JOINTS + 3,), np.float32)

    def action_space(self, params=None) -> spaces.Box:
        return spaces.Box(-1.0, 1.0, (N_JOINTS,), np.float32)
