"""FishSwim-v0: a tail-propelled planar swimmer steering to a random
target, batched over E envs.

Port of purejaxql_tpu/envs/classic/fish.py: a rigid body with heading under
anisotropic water drag carries a rate-limited tail servo, whose lateral
sweep pushes against the water (forward thrust and yaw), and two pectoral
fins add forward thrust, their difference a yaw moment. A step is 8
substeps of dt 0.005 (a Python loop where JAX scans, fish.py:147-155), the
position clipped to the arena. The reward is exp(-distance / 0.5), plus 1
inside the target radius, minus 0.01 |a|^2; 1,000-step episodes.
Observations (12): the target and the velocity in the body frame, the body
rate, sin, cos and velocity / 10 of the tail, the position over the arena,
cos, sin of the heading.

A reset's randomness comes in as an argument (``start_state``, fed by
``draw_start``): the position ~ U[-0.5, 0.5)^2, the heading ~ U[-pi, pi),
the target ~ U[-0.8 arena, 0.8 arena)^2 (fish.py:71-77). The step draws
nothing.
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
class FishState:
    x: torch.Tensor
    y: torch.Tensor
    heading: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    omega: torch.Tensor
    tail: torch.Tensor  # tail joint angle (body frame)
    tail_vel: torch.Tensor
    target: torch.Tensor  # (E, 2)
    time: torch.Tensor  # int32


@dataclass(frozen=True)
class FishParams:
    mass: float = 1.0
    inertia: float = 0.05
    body_len: float = 0.4
    tail_len: float = 0.25
    drag_par: float = 0.3  # drag along the body axis
    drag_perp: float = 6.0  # drag across it (anisotropy drives thrust)
    drag_rot: float = 0.08
    tail_drag: float = 4.0
    tail_rate: float = 14.0
    max_tail: float = 1.0
    fin_force: float = 0.3
    arena: float = 2.0
    target_radius: float = 0.12
    dt: float = 0.005
    substeps: int = 8
    max_steps_in_episode: int = 1000


def draw_start(generator: torch.Generator, num_envs: int, params: FishParams) -> torch.Tensor:
    """(E, 5) reset draws [x, y, heading, target x, target y]."""
    return torch.cat([uniform(generator, (num_envs, 2), -0.5, 0.5),
                      uniform(generator, (num_envs, 1), -math.pi, math.pi),
                      uniform(generator, (num_envs, 2), -0.8 * params.arena, 0.8 * params.arena)], 1)


def start_state(draws: torch.Tensor) -> FishState:
    n, dev = draws.shape[0], draws.device
    zero = torch.zeros(n, device=dev)
    return FishState(x=draws[:, 0], y=draws[:, 1], heading=draws[:, 2], vx=zero, vy=zero, omega=zero, tail=zero,
                     tail_vel=zero, target=draws[:, 3:], time=torch.zeros(n, dtype=torch.int32, device=dev))


def substep(s: FishState, action: torch.Tensor, p) -> FishState:
    """One semi-implicit Euler substep (fish.py:88-142)."""
    ch, sh = torch.cos(s.heading), torch.sin(s.heading)

    # tail servo toward the commanded angle (rate-limited)
    tail_cmd = p.max_tail * action[:, 0]
    tail_vel = torch.clamp((tail_cmd - s.tail) * p.tail_rate, -p.tail_rate, p.tail_rate)
    tail = s.tail + tail_vel * p.dt

    # the tail's midpoint sweeps with the body plus the joint
    tail_ang = s.heading + math.pi + tail
    td0, td1 = torch.cos(tail_ang), torch.sin(tail_ang)
    tn0, tn1 = -td1, td0
    arm = 0.5 * p.tail_len
    sweep = (s.omega + tail_vel) * arm
    vt0, vt1 = s.vx + sweep * tn0, s.vy + sweep * tn1
    # resistive force normal to the tail segment, at its midpoint behind the body's center
    vn = vt0 * tn0 + vt1 * tn1
    ft = -p.tail_drag * vn
    ft0, ft1 = ft * tn0, ft * tn1
    half = 0.5 * p.body_len
    r0, r1 = half * -ch + arm * td0, half * -sh + arm * td1
    tau_tail = r0 * ft1 - r1 * ft0

    # pectoral fins: small forward thrust per side, their difference yaw
    fl = p.fin_force * torch.clamp_min(action[:, 1], 0.0)
    fr = p.fin_force * torch.clamp_min(action[:, 2], 0.0)
    fins = fl + fr
    tau_fins = 0.15 * p.body_len * (fr - fl)

    # anisotropic body drag
    v_par = s.vx * ch + s.vy * sh
    v_perp = s.vx * -sh + s.vy * ch
    dpar, dperp = p.drag_par * v_par, p.drag_perp * v_perp
    fd0, fd1 = -(dpar * ch + dperp * -sh), -(dpar * sh + dperp * ch)

    f0, f1 = ft0 + fins * ch + fd0, ft1 + fins * sh + fd1
    tau = tau_tail + tau_fins - p.drag_rot * s.omega

    vx = s.vx + f0 / p.mass * p.dt
    vy = s.vy + f1 / p.mass * p.dt
    omega = s.omega + tau / p.inertia * p.dt
    x = torch.clamp(s.x + vx * p.dt, -p.arena, p.arena)
    y = torch.clamp(s.y + vy * p.dt, -p.arena, p.arena)
    heading = s.heading + omega * p.dt
    return replace(s, x=x, y=y, heading=heading, vx=vx, vy=vy, omega=omega, tail=tail, tail_vel=tail_vel)


class Fish(Environment):
    @property
    def default_params(self) -> FishParams:
        return FishParams()

    @property
    def name(self) -> str:
        return "FishSwim-v0"

    def reset_env(self, generator, num_envs, params):
        state = start_state(draw_start(generator, num_envs, params))
        return self.get_obs(state, params), state

    def step_env(self, state, action, params, draws):
        p = params
        action = torch.clamp(action, -1.0, 1.0)
        s = state
        for _ in range(p.substeps):
            s = substep(s, action, p)
        s = replace(s, time=state.time + 1)
        dist = norm2(torch.stack([s.x, s.y], -1) - s.target)
        reward = torch.exp(-dist / 0.5) + torch.where(dist < p.target_radius, 1.0, 0.0) - 0.01 * (action**2).sum(-1)
        done = s.time >= p.max_steps_in_episode
        return self.get_obs(s, p), s, reward, done, {}

    def get_obs(self, state: FishState, params=None) -> torch.Tensor:
        p = params or self.default_params
        s = state
        ch, sh = torch.cos(s.heading), torch.sin(s.heading)
        # the target in the body frame (what the fish "sees")
        dx = s.target[:, 0] - s.x
        dy = s.target[:, 1] - s.y
        return torch.stack([
            ch * dx + sh * dy, -sh * dx + ch * dy, ch * s.vx + sh * s.vy, -sh * s.vx + ch * s.vy, s.omega,
            torch.sin(s.tail), torch.cos(s.tail), s.tail_vel / 10.0, s.x / p.arena, s.y / p.arena, ch, sh,
        ], -1)

    def observation_space(self, params) -> spaces.Box:
        return spaces.Box(-np.inf, np.inf, (12,), np.float32)

    def action_space(self, params=None) -> spaces.Box:
        return spaces.Box(-1.0, 1.0, (3,), np.float32)
