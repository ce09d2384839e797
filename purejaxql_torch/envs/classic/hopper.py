"""Hopper-v0 / HopperStand-v0: planar SLIP (spring-loaded inverted pendulum)
locomotion, batched over E envs.

Port of purejaxql_tpu/envs/classic/hopper.py. A point-mass body rides a
massless springy leg: in flight the action aims the leg (a[0] x 0.5 rad,
slewed at angle_rate), in stance the spring pushes along the foot-to-body
vector and a[1]'s positive half extends its rest length. A step is 16
substeps of semi-implicit Euler at dt 0.0025 (hopper.py:60, :164).
Touchdown (falling, the body within reach of the aimed leg) plants the foot
at the reachable length, so contact starts uncompressed; liftoff (the leg
past its rest length, moving outward) swings the leg back under the body
(:144-152). Task ``hop`` pays 1.5 clip(vx, -2, 3) + 0.5 - 0.05 |a|^2,
``stand`` clip(z, 0, 1) - 0.3 |vx| + 0.5 - 0.05 |a|^2, both -1 more when the
body sinks below min_height, which ends the episode (as do 1,000 steps).

``slip_substep`` is written over a legs axis (E, L) so that the two-legged
Walker (walker.py) shares it: the legs' forces are summed, which for one leg
is the JAX Hopper's own arithmetic.

A reset's randomness comes in as an argument (``start_state``, fed by
``draw_start``): z = 1.05 + U[0, 0.1), vx ~ U[-0.1, 0.1). The step draws
nothing.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from purejaxql_torch.envs import spaces
from purejaxql_torch.envs.base import Environment
from purejaxql_torch.envs.classic.reacher import uniform


@dataclass
class HopperState:
    x: torch.Tensor
    z: torch.Tensor
    vx: torch.Tensor
    vz: torch.Tensor
    leg_angle: torch.Tensor  # from vertical, + forward (flight-controlled)
    foot_x: torch.Tensor  # planted foot position (stance)
    leg_rest: torch.Tensor  # spring rest length set at touchdown (<= L0)
    stance: torch.Tensor  # bool phase flag
    time: torch.Tensor  # int32


@dataclass(frozen=True)
class SLIPParams:
    """The SLIP model's parameters, the Hopper's and the Walker's alike."""

    mass: float = 1.0
    gravity: float = 9.8
    leg_length: float = 1.0
    spring_k: float = 250.0
    thrust_ext: float = 0.15
    damping: float = 6.0
    angle_rate: float = 6.0
    max_angle: float = 0.5
    dt: float = 0.0025
    substeps: int = 16
    min_height: float = 0.35
    max_steps_in_episode: int = 1000


def draw_start(generator: torch.Generator, num_envs: int) -> torch.Tensor:
    """(E, 2) reset draws [height offset ~ U[0, 0.1), vx ~ U[-0.1, 0.1)]."""
    return torch.stack([uniform(generator, (num_envs,), 0.0, 0.1),
                        uniform(generator, (num_envs,), -0.1, 0.1)], -1)


def slip_substep(x, z, vx, vz, leg_angle, foot_x, leg_rest, stance, target_angle, thrust, p):
    """One semi-implicit Euler substep of the body (E,) on L springy legs
    (E, L) (hopper.py:96-158, walker.py:117-170). Returns the new (x, z, vx,
    vz, leg_angle, foot_x, leg_rest, stance)."""
    # flight: steer each swing leg toward its commanded touchdown angle
    rate = p.angle_rate * p.dt
    angle_err = target_angle - leg_angle
    leg_angle = torch.where(
        stance, leg_angle, leg_angle + torch.clamp(p.angle_rate * angle_err * p.dt, -rate, rate)
    )
    # stance: spring force along each (foot -> body) leg vector; thrust
    # extends the rest length
    lx = x[:, None] - foot_x
    lz = z[:, None]
    length = torch.sqrt(lx**2 + lz**2) + 1e-8
    ux, uz = lx / length, lz / length
    rest = leg_rest + p.thrust_ext * thrust
    compression = torch.clamp_min(rest - length, 0.0)
    vr = vx[:, None] * ux + vz[:, None] * uz
    f = torch.clamp_min(p.spring_k * compression - p.damping * vr, 0.0)
    f = torch.where(stance, f, 0.0)
    ax = (f * ux).sum(-1) / p.mass
    az = (f * uz).sum(-1) / p.mass - p.gravity
    vx = vx + ax * p.dt
    vz = vz + az * p.dt
    x = x + vx * p.dt
    z = z + vz * p.dt
    # phase transitions: the leg retracts to the reachable length at
    # touchdown; liftoff once past the rest length moving outward
    cos_a = torch.cos(leg_angle)
    reach = torch.clamp_max(z[:, None] / torch.clamp_min(cos_a, 0.5), p.leg_length)
    touchdown = ~stance & (vz[:, None] < 0.0) & (z[:, None] <= p.leg_length * cos_a)
    foot_x = torch.where(touchdown, x[:, None] + reach * torch.sin(leg_angle), foot_x)
    leg_rest = torch.where(touchdown, reach, leg_rest)
    liftoff = stance & (length >= rest) & (vr > 0.0)
    stance = touchdown | (stance & ~liftoff)
    leg_angle = torch.where(liftoff, 0.0, leg_angle)
    return x, z, vx, vz, leg_angle, foot_x, leg_rest, stance


def slip_reward(task: str, z, vx, action, p):
    """The SLIP tasks' reward from the stepped body and the clipped action
    (hopper.py:171-184, walker.py:178-192), and whether the body fell."""
    fell = z < p.min_height
    ctrl_cost = 0.05 * (action**2).sum(-1)
    if task == "stand":
        reward = torch.clamp(z / p.leg_length, 0.0, 1.0) - 0.3 * vx.abs() + 0.5 - ctrl_cost
    elif task == "run":
        reward = 0.75 * torch.clamp(vx, -2.0, 6.0) + 0.5 - ctrl_cost
    else:
        reward = 1.5 * torch.clamp(vx, -2.0, 3.0) + 0.5 - ctrl_cost
    return torch.where(fell, reward - 1.0, reward), fell


def leg_features(x, z, leg_angle, foot_x, leg_rest, stance):
    """Per leg (E, L): sin, cos of its angle, the stance flag, the spring's
    compression and the foot's offset clipped to +-1.5."""
    lx = x[:, None] - foot_x
    length = torch.sqrt(lx**2 + z[:, None] ** 2) + 1e-8
    return (torch.sin(leg_angle), torch.cos(leg_angle), stance.float(),
            torch.clamp_min(leg_rest - length, 0.0), torch.clamp(lx, -1.5, 1.5))


class Hopper(Environment):
    """One SLIP model, two reward tasks: ``hop`` (Hopper-v0) and ``stand``
    (HopperStand-v0)."""

    def __init__(self, task: str = "hop"):
        assert task in ("hop", "stand"), task
        self.task = task

    @property
    def default_params(self) -> SLIPParams:
        return SLIPParams()

    @property
    def name(self) -> str:
        return "Hopper-v0" if self.task == "hop" else "HopperStand-v0"

    @staticmethod
    def start_state(draws: torch.Tensor, params) -> HopperState:
        n, dev = draws.shape[0], draws.device
        zero = torch.zeros(n, device=dev)
        return HopperState(
            x=zero, z=params.leg_length + 0.05 + draws[:, 0], vx=draws[:, 1], vz=zero, leg_angle=zero,
            foot_x=zero, leg_rest=torch.full((n,), params.leg_length, device=dev),
            stance=torch.zeros(n, dtype=torch.bool, device=dev), time=torch.zeros(n, dtype=torch.int32, device=dev),
        )

    def reset_env(self, generator, num_envs, params):
        state = self.start_state(draw_start(generator, num_envs), params)
        return self.get_obs(state), state

    def step_env(self, state, action, params, draws):
        p = params
        action = torch.clamp(action, -1.0, 1.0)
        target_angle = (p.max_angle * action[:, 0])[:, None]
        thrust = torch.clamp_min(action[:, 1], 0.0)[:, None]
        s = state
        x, z, vx, vz = s.x, s.z, s.vx, s.vz
        legs = (s.leg_angle[:, None], s.foot_x[:, None], s.leg_rest[:, None], s.stance[:, None])
        for _ in range(p.substeps):
            x, z, vx, vz, *legs = slip_substep(x, z, vx, vz, *legs, target_angle, thrust, p)
        leg_angle, foot_x, leg_rest, stance = (t[:, 0] for t in legs)
        new_state = HopperState(x=x, z=z, vx=vx, vz=vz, leg_angle=leg_angle, foot_x=foot_x, leg_rest=leg_rest,
                                stance=stance, time=s.time + 1)
        reward, fell = slip_reward(self.task, z, vx, action, p)
        done = fell | (new_state.time >= p.max_steps_in_episode)
        return self.get_obs(new_state), new_state, reward, done, {}

    def get_obs(self, state: HopperState, params=None) -> torch.Tensor:
        s = state
        legs = leg_features(s.x, s.z, s.leg_angle[:, None], s.foot_x[:, None], s.leg_rest[:, None],
                            s.stance[:, None])
        return torch.cat([torch.stack([s.z, s.vx, s.vz], -1), *legs], -1)

    def observation_space(self, params) -> spaces.Box:
        return spaces.Box(-np.inf, np.inf, (8,), np.float32)

    def action_space(self, params=None) -> spaces.Box:
        return spaces.Box(-1.0, 1.0, (2,), np.float32)
