"""CheetahRun-v0: a planar quadruped gallop, a pitching rigid body on four
SLIP legs, batched over E envs.

Port of purejaxql_tpu/envs/classic/cheetah.py. The torso has a COM, a pitch
and an inertia; two legs hang from the fore hip and two from the hind hip,
each leg force acts at its hip, so a fore/hind imbalance pitches the body.
Each leg is the Walker's SLIP leg over a (E, 4) legs axis: in flight it
slews toward a[0:4] x 0.6 rad, in stance its spring pushes along the
foot-to-hip vector with a[4:8]'s positive half extending its rest length;
touchdown and liftoff are gated on the leg's own hip (cheetah.py:129-190). A
step is 16 substeps of semi-implicit Euler at dt 0.0025, unrolled in
Python, a few dozen small ops each. The reward is 0.6 clip(vx, -2, 8) + 0.5
- 0.05 |a|^2 - 0.05 omega^2, 1 less when the body falls: below min_height
or pitched past max_pitch, which ends the episode, as do 1,000 steps.
Observations (26): z, vx, vz, sin, cos of the pitch, omega, then per leg
sin, cos of its angle, the stance flag, the spring's compression and the
foot's offset clipped to +-1.5 (each a block of 4).

A reset's randomness comes in as an argument (``start_state``, fed by
hopper.py's ``draw_start``): z = 0.95 + U[0, 0.1), vx ~ U[-0.1, 0.1); the
legs start split at 0.15, 0.05, -0.05, -0.15 rad. The step draws nothing.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from purejaxql_torch.envs import spaces
from purejaxql_torch.envs.base import Environment
from purejaxql_torch.envs.classic.hopper import draw_start


@dataclass
class CheetahState:
    x: torch.Tensor
    z: torch.Tensor
    vx: torch.Tensor
    vz: torch.Tensor
    pitch: torch.Tensor
    omega: torch.Tensor
    leg_angle: torch.Tensor  # (E, 4) from vertical, + forward
    foot_x: torch.Tensor  # (E, 4) planted foot positions
    leg_rest: torch.Tensor  # (E, 4) spring rest length set at touchdown
    stance: torch.Tensor  # (E, 4) bool phase flags
    time: torch.Tensor  # int32


@dataclass(frozen=True)
class CheetahParams:
    mass: float = 1.0
    inertia: float = 0.15
    body_half: float = 0.35  # hip lever arm fore/aft of the COM
    gravity: float = 9.8
    leg_length: float = 0.9
    spring_k: float = 250.0
    thrust_ext: float = 0.15
    damping: float = 6.0
    angle_rate: float = 7.0
    max_angle: float = 0.6
    dt: float = 0.0025
    substeps: int = 16
    min_height: float = 0.3
    max_pitch: float = 1.0
    max_steps_in_episode: int = 1000


# the hip lever of each leg: legs 0, 1 on the fore hip, 2, 3 on the hind
_HIP = (1.0, 1.0, -1.0, -1.0)
_START_ANGLES = (0.15, 0.05, -0.05, -0.15)


def hips(s: CheetahState, p):
    """Hip anchor positions and velocities (E, 4) from the rigid body, and
    the levers (4,) and cos, sin of the pitch (E, 1) (cheetah.py:114-123)."""
    h = torch.tensor(_HIP, device=s.x.device) * p.body_half
    c, sn = torch.cos(s.pitch)[:, None], torch.sin(s.pitch)[:, None]
    hx = s.x[:, None] + h * c
    hz = s.z[:, None] + h * sn
    # hip velocity = COM velocity + omega x r
    omega = s.omega[:, None]
    vhx = s.vx[:, None] - omega * h * sn
    vhz = s.vz[:, None] + omega * h * c
    return hx, hz, vhx, vhz, h, c, sn


def substep(s: CheetahState, target_angle, thrust, p) -> CheetahState:
    """One substep (cheetah.py:125-190)."""
    angle_err = target_angle - s.leg_angle
    rate = p.angle_rate * p.dt
    leg_angle = torch.where(
        s.stance, s.leg_angle, s.leg_angle + torch.clamp(p.angle_rate * angle_err * p.dt, -rate, rate)
    )
    hx, hz, vhx, vhz, h, c, sn = hips(s, p)

    # stance legs: spring force along each (foot -> hip) leg vector, at the hip
    lx = hx - s.foot_x
    lz = hz
    length = torch.sqrt(lx**2 + lz**2) + 1e-8
    ux, uz = lx / length, lz / length
    rest = s.leg_rest + p.thrust_ext * thrust
    compression = torch.clamp_min(rest - length, 0.0)
    vr = vhx * ux + vhz * uz
    f = torch.clamp_min(p.spring_k * compression - p.damping * vr, 0.0)
    f = torch.where(s.stance, f, 0.0)
    fx, fz = f * ux, f * uz
    ax = fx.sum(-1) / p.mass
    az = fz.sum(-1) / p.mass - p.gravity
    # torque about the COM: r x F with r = (h cos, h sin)
    tau = (h * c * fz - h * sn * fx).sum(-1)
    alpha = tau / p.inertia

    vx = s.vx + ax * p.dt
    vz = s.vz + az * p.dt
    omega = s.omega + alpha * p.dt
    x = s.x + vx * p.dt
    z = s.z + vz * p.dt
    pitch = s.pitch + omega * p.dt

    # per-leg phase transitions, gated on the leg's own hip height
    cos_a = torch.cos(leg_angle)
    reach = torch.clamp_max(hz / torch.clamp_min(cos_a, 0.5), p.leg_length)
    touchdown = ~s.stance & (vhz < 0.0) & (hz <= p.leg_length * cos_a)
    foot_x = torch.where(touchdown, hx + reach * torch.sin(leg_angle), s.foot_x)
    leg_rest = torch.where(touchdown, reach, s.leg_rest)
    liftoff = s.stance & (length >= rest) & (vr > 0.0)
    stance = touchdown | (s.stance & ~liftoff)
    leg_angle = torch.where(liftoff, 0.0, leg_angle)
    return CheetahState(x=x, z=z, vx=vx, vz=vz, pitch=pitch, omega=omega, leg_angle=leg_angle, foot_x=foot_x,
                        leg_rest=leg_rest, stance=stance, time=s.time)


class Cheetah(Environment):
    """One quadruped model, one reward task ("run")."""

    def __init__(self, task: str = "run"):
        assert task in ("run",), task
        self.task = task

    @property
    def default_params(self) -> CheetahParams:
        return CheetahParams()

    @property
    def name(self) -> str:
        return "CheetahRun-v0"

    @staticmethod
    def start_state(draws: torch.Tensor, params) -> CheetahState:
        n, dev = draws.shape[0], draws.device
        zero = torch.zeros(n, device=dev)
        return CheetahState(
            x=zero, z=params.leg_length + 0.05 + draws[:, 0], vx=draws[:, 1], vz=zero, pitch=zero, omega=zero,
            leg_angle=torch.tensor(_START_ANGLES, device=dev).expand(n, 4).clone(),
            foot_x=torch.zeros(n, 4, device=dev), leg_rest=torch.full((n, 4), params.leg_length, device=dev),
            stance=torch.zeros(n, 4, dtype=torch.bool, device=dev), time=torch.zeros(n, dtype=torch.int32, device=dev),
        )

    def reset_env(self, generator, num_envs, params):
        state = self.start_state(draw_start(generator, num_envs), params)
        return self.get_obs(state, params), state

    def step_env(self, state, action, params, draws):
        p = params
        action = torch.clamp(action, -1.0, 1.0)
        target_angle = p.max_angle * action[:, :4]
        thrust = torch.clamp_min(action[:, 4:], 0.0)
        s = state
        for _ in range(p.substeps):
            s = substep(s, target_angle, thrust, p)
        s = replace(s, time=state.time + 1)
        fell = (s.z < p.min_height) | (s.pitch.abs() > p.max_pitch)
        ctrl_cost = 0.05 * (action**2).sum(-1)
        reward = 0.6 * torch.clamp(s.vx, -2.0, 8.0) + 0.5 - ctrl_cost - 0.05 * s.omega**2
        reward = torch.where(fell, reward - 1.0, reward)
        return self.get_obs(s, p), s, reward, self.is_terminal(s, p), {}

    def get_obs(self, state: CheetahState, params=None) -> torch.Tensor:
        p = params or self.default_params
        s = state
        hx, hz, *_ = hips(s, p)
        lx = hx - s.foot_x
        length = torch.sqrt(lx**2 + hz**2) + 1e-8
        return torch.cat([
            torch.stack([s.z, s.vx, s.vz, torch.sin(s.pitch), torch.cos(s.pitch), s.omega], -1),
            torch.sin(s.leg_angle), torch.cos(s.leg_angle), s.stance.float(),
            torch.clamp_min(s.leg_rest - length, 0.0), torch.clamp(lx, -1.5, 1.5),
        ], -1)

    def is_terminal(self, state: CheetahState, params) -> torch.Tensor:
        return ((state.z < params.min_height) | (state.pitch.abs() > params.max_pitch)
                | (state.time >= params.max_steps_in_episode))

    def observation_space(self, params) -> spaces.Box:
        return spaces.Box(-np.inf, np.inf, (26,), np.float32)

    def action_space(self, params=None) -> spaces.Box:
        return spaces.Box(-1.0, 1.0, (8,), np.float32)
