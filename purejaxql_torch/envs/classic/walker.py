"""Walker-v0 and its tasks: planar two-leg SLIP locomotion, batched over E
envs.

Port of purejaxql_tpu/envs/classic/walker.py: the Hopper's spring-leg model
(hopper.py ``slip_substep``) on two legs of one point-mass body, each leg
with its own phase, summed forces, 16 substeps a step (walker.py:64,
:117-170). Actions (4): touchdown angles of both legs, then their stance
thrusts. Task ``walk`` (Walker-v0, WalkerWalk) pays 1.5 clip(vx, -2, 3) +
0.5 - 0.05 |a|^2, ``run`` 0.75 clip(vx, -2, 6) + 0.5 - 0.05 |a|^2, ``stand``
the Hopper's stand reward; -1 more and the episode's end when the body
sinks below min_height. Observations (13): z, vx, vz, then sin and cos of
both legs' angles, both stance flags, both compressions, both foot offsets
(the JAX env's (5, 2) per-leg block flattened).

A reset's randomness comes in as an argument (``start_state``, fed by
``draw_start``), the Hopper's draws; the legs start split at +-0.1 rad.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from purejaxql_torch.envs import spaces
from purejaxql_torch.envs.base import Environment
from purejaxql_torch.envs.classic.hopper import SLIPParams, draw_start, leg_features, slip_reward, slip_substep


@dataclass
class WalkerState:
    x: torch.Tensor
    z: torch.Tensor
    vx: torch.Tensor
    vz: torch.Tensor
    leg_angle: torch.Tensor  # (E, 2) from vertical, + forward
    foot_x: torch.Tensor  # (E, 2) planted foot positions
    leg_rest: torch.Tensor  # (E, 2) spring rest length set at touchdown
    stance: torch.Tensor  # (E, 2) bool phase flags
    time: torch.Tensor  # int32


class Walker(Environment):
    """One two-leg SLIP model, three reward tasks: ``walk`` (Walker-v0),
    ``stand`` (WalkerStand-v0) and ``run`` (WalkerRun-v0)."""

    def __init__(self, task: str = "walk"):
        assert task in ("walk", "stand", "run"), task
        self.task = task

    @property
    def default_params(self) -> SLIPParams:
        return SLIPParams()

    @property
    def name(self) -> str:
        return {"walk": "Walker-v0", "stand": "WalkerStand-v0", "run": "WalkerRun-v0"}[self.task]

    @staticmethod
    def start_state(draws: torch.Tensor, params) -> WalkerState:
        n, dev = draws.shape[0], draws.device
        zero = torch.zeros(n, device=dev)
        return WalkerState(
            x=zero, z=params.leg_length + 0.05 + draws[:, 0], vx=draws[:, 1], vz=zero,
            leg_angle=torch.stack([torch.full((n,), 0.1, device=dev), torch.full((n,), -0.1, device=dev)], -1),
            foot_x=torch.zeros(n, 2, device=dev), leg_rest=torch.full((n, 2), params.leg_length, device=dev),
            stance=torch.zeros(n, 2, dtype=torch.bool, device=dev),
            time=torch.zeros(n, dtype=torch.int32, device=dev),
        )

    def reset_env(self, generator, num_envs, params):
        state = self.start_state(draw_start(generator, num_envs), params)
        return self.get_obs(state), state

    def step_env(self, state, action, params, draws):
        p = params
        action = torch.clamp(action, -1.0, 1.0)
        target_angle = p.max_angle * action[:, :2]
        thrust = torch.clamp_min(action[:, 2:], 0.0)
        s = state
        x, z, vx, vz = s.x, s.z, s.vx, s.vz
        legs = (s.leg_angle, s.foot_x, s.leg_rest, s.stance)
        for _ in range(p.substeps):
            x, z, vx, vz, *legs = slip_substep(x, z, vx, vz, *legs, target_angle, thrust, p)
        new_state = WalkerState(x, z, vx, vz, *legs, time=s.time + 1)
        reward, fell = slip_reward(self.task, z, vx, action, p)
        done = fell | (new_state.time >= p.max_steps_in_episode)
        return self.get_obs(new_state), new_state, reward, done, {}

    def get_obs(self, state: WalkerState, params=None) -> torch.Tensor:
        s = state
        legs = leg_features(s.x, s.z, s.leg_angle, s.foot_x, s.leg_rest, s.stance)
        return torch.cat([torch.stack([s.z, s.vx, s.vz], -1), *legs], -1)

    def observation_space(self, params) -> spaces.Box:
        return spaces.Box(-np.inf, np.inf, (13,), np.float32)

    def action_space(self, params=None) -> spaces.Box:
        return spaces.Box(-1.0, 1.0, (4,), np.float32)
