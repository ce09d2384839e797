"""Contact-rich 2-D manipulation, batched over E envs: six envs behind the
playground's manipulation names.

Port of purejaxql_tpu/envs/classic/manipulation2d.py. Each step is a
handful of branchless ops (clamps and selects for the contacts), episodes
last 150 steps (HandOver's 200) and every action box is [-1, 1]:

- ``PickPlace`` (PickPlace-v0, PandaPickCubeCartesian): a velocity-controlled
  gripper grasps a block (a[2] > 0 near it latches, a[2] < -0.5 lets go) and
  carries it to an elevated target; a free block falls to the floor;
- ``PegInsert`` (PegInsert-v0, AlohaSinglePegInsertion): a peg must align
  over a narrow slot to descend past the table; the slot's walls clamp a peg
  inside it, and the motion the constraints remove is charged as contact
  force; the last observation is the episode's elapsed share;
- ``BlockRotate`` (BlockRotate-v0, LeapCubeReorient, LeapCubeRotateZAxis):
  two fingers turn a block through a friction cone set by the squeeze;
  ``reorient`` brings it to a target angle, ``spin`` keeps it turning;
- ``PandaPickCube`` (with ``orientation``: PandaPickCubeOrientation): the
  pick under acceleration control, walls absorbing the gripper's momentum;
  the orientation variant turns the held block's yaw with a wrist channel;
- ``PushCube`` (PandaRobotiqPushCube): a pusher disc shoves a cube over a
  high-friction plane to a target;
- ``HandOver`` (AlohaHandOver): two arms whose workspaces overlap only near
  the midline pass a block from the left table edge to a right target.

The JAX envs' step info ``{"discount": 1 - done}`` is dropped: no trainer
reads it, and the port's envs return ``{}`` as the other classic envs do.

A reset's randomness comes in as an argument (each env's ``start_state``,
fed by its ``draw_start``), in the JAX reset's ranges. The steps draw
nothing.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from purejaxql_torch.envs import spaces
from purejaxql_torch.envs.base import Environment, device_constant
from purejaxql_torch.envs.classic.point_mass import norm2
from purejaxql_torch.envs.classic.reacher import uniform


def _done(time: torch.Tensor, params) -> torch.Tensor:
    return time >= params.max_steps_in_episode


def _ctrl(a: torch.Tensor) -> torch.Tensor:
    return 0.01 * (a**2).sum(-1)


def _fall(block, block_vel, params):
    """A free block's step under gravity onto the floor (manipulation2d.py:
    113-121): the new block and its velocity, zero once on the floor."""
    fall_vel = block_vel + device_constant((0.0, -params.gravity), block.device) * params.dt
    free_block = block + fall_vel * params.dt
    on_floor = free_block[:, 1] <= params.block_half
    free_block = torch.stack([free_block[:, 0], torch.clamp_min(free_block[:, 1], params.block_half)], -1)
    return free_block, torch.where(on_floor[:, None], 0.0, fall_vel)


def _grasp(holding, block, grip, grip_cmd, params):
    """The grasp latch: closing (> 0) near the block holds it, a deliberate
    open (< -0.5) drops it (manipulation2d.py:103-110)."""
    near = norm2(block - grip) < params.grasp_radius
    return torch.where(grip_cmd < -0.5, 0.0, torch.maximum(holding, (near & (grip_cmd > 0.0)) * 1.0))


def _wrap(angle: torch.Tensor) -> torch.Tensor:
    return torch.arctan2(torch.sin(angle), torch.cos(angle))


# ------------------------------------------------------------------------------
# PickPlace
# ------------------------------------------------------------------------------


@dataclass
class PickPlaceState:
    grip: torch.Tensor  # (E, 2) gripper xz
    block: torch.Tensor  # (E, 2) block xz
    block_vel: torch.Tensor  # (E, 2)
    holding: torch.Tensor  # (E,) float 0/1
    target: torch.Tensor  # (E, 2) xz (elevated)
    time: torch.Tensor  # int32


@dataclass(frozen=True)
class PickPlaceParams:
    dt: float = 0.05
    speed: float = 1.2  # gripper velocity gain
    gravity: float = 2.5
    grasp_radius: float = 0.08
    block_half: float = 0.03  # rest height
    target_radius: float = 0.08
    max_steps_in_episode: int = 150


def _pick_draws(generator, num_envs):
    """(E, 4) [block x, target x, target z, gripper x] (manipulation2d.py:78-94)."""
    n = (num_envs,)
    return torch.stack([uniform(generator, n, -0.7, 0.7), uniform(generator, n, -0.7, 0.7),
                        uniform(generator, n, 0.35, 0.8), uniform(generator, n, -0.7, 0.7)], -1)


class PickPlace(Environment):
    """Pick a block off the floor and hold it at an elevated target under
    velocity (Cartesian) control (manipulation2d.py:62-170)."""

    def __init__(self, name: str | None = None):
        self._name = name

    @property
    def default_params(self) -> PickPlaceParams:
        return PickPlaceParams()

    @property
    def name(self) -> str:
        return self._name or "PickPlace-v0"

    @staticmethod
    def draw_start(generator, num_envs, params=None) -> torch.Tensor:
        return _pick_draws(generator, num_envs)

    @staticmethod
    def start_state(draws: torch.Tensor, params: PickPlaceParams) -> PickPlaceState:
        n, dev = draws.shape[0], draws.device
        zeros = torch.zeros(n, device=dev)
        return PickPlaceState(
            grip=torch.stack([draws[:, 3], torch.full((n,), 0.6, device=dev)], -1),
            block=torch.stack([draws[:, 0], torch.full((n,), params.block_half, device=dev)], -1),
            block_vel=torch.zeros(n, 2, device=dev), holding=zeros, target=draws[:, 1:3],
            time=torch.zeros(n, dtype=torch.int32, device=dev),
        )

    def reset_env(self, generator, num_envs, params):
        state = self.start_state(self.draw_start(generator, num_envs, params), params)
        return self.get_obs(state, params), state

    def step_env(self, state, action, params, draws):
        p = params
        a = torch.clamp(action, -1.0, 1.0)
        dev = a.device
        grip_vel = a[:, :2] * p.speed
        lo, hi = device_constant((-1.0, 0.0), dev), device_constant((1.0, 1.0), dev)
        grip = torch.clamp(state.grip + grip_vel * p.dt, lo, hi)
        holding = _grasp(state.holding, state.block, grip, a[:, 2], p)
        # a held block rides the gripper; a free block falls to the floor
        free_block, free_vel = _fall(state.block, state.block_vel, p)
        held = (holding > 0.5)[:, None]
        block = torch.where(held, grip, free_block)
        block_vel = torch.where(held, grip_vel, free_vel)
        reach_dist = norm2(block - grip)
        place_dist = norm2(block - state.target)
        in_target = place_dist < p.target_radius
        reward = -0.5 * reach_dist * (1.0 - holding) + 0.25 * holding - place_dist + 1.0 * in_target - _ctrl(a)
        new = PickPlaceState(grip=grip, block=block, block_vel=block_vel, holding=holding, target=state.target,
                             time=state.time + 1)
        return self.get_obs(new, p), new, reward, _done(new.time, p), {}

    def get_obs(self, state: PickPlaceState, params) -> torch.Tensor:
        s = state
        return torch.cat([s.grip, s.block, s.block_vel, s.holding[:, None], s.target, s.target - s.block], -1)

    def observation_space(self, params=None) -> spaces.Box:
        return spaces.Box(-np.inf, np.inf, (11,), np.float32)

    def action_space(self, params=None) -> spaces.Box:
        return spaces.Box(-1.0, 1.0, (3,), np.float32)


# ------------------------------------------------------------------------------
# PegInsert
# ------------------------------------------------------------------------------


@dataclass
class PegInsertState:
    peg: torch.Tensor  # (E, 2) peg-tip xz
    vel: torch.Tensor  # (E, 2)
    slot_x: torch.Tensor  # (E,)
    time: torch.Tensor  # int32


@dataclass(frozen=True)
class PegInsertParams:
    dt: float = 0.05
    speed: float = 1.2
    table_z: float = 0.4  # table surface height
    slot_half: float = 0.035  # slot channel half-width
    peg_half: float = 0.02  # peg half-width
    slot_depth: float = 0.25
    max_steps_in_episode: int = 150


class PegInsert(Environment):
    """A velocity-controlled peg into a narrow slot; the table and the slot's
    walls are unilateral clamps (manipulation2d.py:196-301)."""

    def __init__(self, name: str | None = None):
        self._name = name

    @property
    def default_params(self) -> PegInsertParams:
        return PegInsertParams()

    @property
    def name(self) -> str:
        return self._name or "PegInsert-v0"

    @staticmethod
    def draw_start(generator, num_envs, params: PegInsertParams) -> torch.Tensor:
        """(E, 3) [peg x, peg z, slot x] (manipulation2d.py:212-223)."""
        n = (num_envs,)
        return torch.stack([uniform(generator, n, -0.8, 0.8), uniform(generator, n, params.table_z + 0.2, 0.9),
                            uniform(generator, n, -0.5, 0.5)], -1)

    @staticmethod
    def start_state(draws: torch.Tensor, params: PegInsertParams) -> PegInsertState:
        n, dev = draws.shape[0], draws.device
        return PegInsertState(peg=draws[:, :2], vel=torch.zeros(n, 2, device=dev), slot_x=draws[:, 2],
                              time=torch.zeros(n, dtype=torch.int32, device=dev))

    def reset_env(self, generator, num_envs, params):
        state = self.start_state(self.draw_start(generator, num_envs, params), params)
        return self.get_obs(state, params), state

    def step_env(self, state, action, params, draws):
        p = params
        a = torch.clamp(action, -1.0, 1.0)
        vel = a * p.speed
        want = state.peg + vel * p.dt
        slot_x = state.slot_x
        clearance = p.slot_half - p.peg_half
        cur_inside = state.peg[:, 1] < p.table_z - 1e-6
        # a peg already in the channel is laterally clamped by the walls
        x = torch.where(cur_inside, torch.clamp(want[:, 0], slot_x - clearance, slot_x + clearance), want[:, 0])
        x = torch.clamp(x, -1.0, 1.0)
        # a peg above the surface descends past it only when aligned over the
        # slot at its resolved x; the slot has a bottom
        aligned = torch.abs(x - slot_x) < clearance
        z = torch.where((want[:, 1] < p.table_z) & ~aligned & ~cur_inside, p.table_z, want[:, 1])
        z = torch.clamp_min(z, p.table_z - p.slot_depth)
        peg = torch.stack([x, torch.clamp(z, 0.0, 1.0)], -1)
        # contact force = the motion the constraints removed
        contact = norm2(want - peg)
        approach = norm2(torch.stack([peg[:, 0] - slot_x, peg[:, 1] - p.table_z], -1))
        depth = torch.clamp_min(p.table_z - peg[:, 1], 0.0)
        inserted = depth >= p.slot_depth - 1e-3
        reward = -approach + 4.0 * depth + 2.0 * inserted - 1.0 * contact - _ctrl(a)
        new = PegInsertState(peg=peg, vel=vel, slot_x=slot_x, time=state.time + 1)
        return self.get_obs(new, p), new, reward, _done(new.time, p), {}

    def get_obs(self, state: PegInsertState, params) -> torch.Tensor:
        s, p = state, params
        z = s.peg[:, 1]
        return torch.stack([
            s.peg[:, 0], z, s.vel[:, 0], s.vel[:, 1], s.slot_x - s.peg[:, 0], z - p.table_z,
            torch.clamp_min(p.table_z - z, 0.0),
            # int32 time over the int limit, a float32 true division in JAX
            s.time.float() / p.max_steps_in_episode,
        ], -1)

    def observation_space(self, params=None) -> spaces.Box:
        return spaces.Box(-np.inf, np.inf, (8,), np.float32)

    def action_space(self, params=None) -> spaces.Box:
        return spaces.Box(-1.0, 1.0, (2,), np.float32)


# ------------------------------------------------------------------------------
# BlockRotate
# ------------------------------------------------------------------------------


@dataclass
class BlockRotateState:
    theta: torch.Tensor  # (E,) block angle
    omega: torch.Tensor  # (E,) angular velocity
    target: torch.Tensor  # (E,) target angle
    time: torch.Tensor  # int32


@dataclass(frozen=True)
class BlockRotateParams:
    dt: float = 0.05
    friction_mu: float = 1.0  # friction cone: |tau| <= mu squeeze
    torque_gain: float = 2.0
    damping: float = 0.3
    droop: float = 1.0  # gravity bias torque toward theta = 0
    max_steps_in_episode: int = 150


class BlockRotate(Environment):
    """Two opposed fingers turn a block through a friction cone set by the
    squeeze: a command past the cone slips (manipulation2d.py:326-446).
    ``reorient`` holds the block at a target angle, ``spin`` keeps it
    turning forward (no target in its obs)."""

    TASKS = ("reorient", "spin")

    def __init__(self, task: str = "reorient", name: str | None = None):
        assert task in self.TASKS, task
        self.task = task
        self._name = name

    @property
    def default_params(self) -> BlockRotateParams:
        return BlockRotateParams()

    @property
    def name(self) -> str:
        return self._name or ("BlockRotate-v0" if self.task == "reorient" else "LeapCubeRotateZAxis")

    @staticmethod
    def draw_start(generator, num_envs, params=None) -> torch.Tensor:
        """(E, 2) [theta, target], each ~ U[-pi, pi) (manipulation2d.py:356-366)."""
        return uniform(generator, (num_envs, 2), -math.pi, math.pi)

    @staticmethod
    def start_state(draws: torch.Tensor, params=None) -> BlockRotateState:
        n, dev = draws.shape[0], draws.device
        return BlockRotateState(theta=draws[:, 0], omega=torch.zeros(n, device=dev), target=draws[:, 1],
                                time=torch.zeros(n, dtype=torch.int32, device=dev))

    def reset_env(self, generator, num_envs, params):
        state = self.start_state(self.draw_start(generator, num_envs, params), params)
        return self.get_obs(state, params), state

    def step_env(self, state, action, params, draws):
        p = params
        a = torch.clamp(action, -1.0, 1.0)
        squeeze = 0.5 * (a[:, 2] + 1.0)  # [0, 1]
        commanded = (a[:, 0] - a[:, 1]) * 0.5 * p.torque_gain
        cone = p.friction_mu * squeeze
        tau = torch.minimum(torch.maximum(commanded, -cone), cone)  # slip = the clipped excess
        slip = torch.abs(commanded) - torch.abs(tau)
        omega = state.omega + (tau - p.damping * state.omega - p.droop * torch.sin(state.theta)) * p.dt
        theta = _wrap(state.theta + omega * p.dt)
        cost = 0.05 * squeeze
        finger = 0.01 * (a[:, 0] ** 2 + a[:, 1] ** 2)
        if self.task == "spin":
            # sustained positive rotation, saturating at 3 rad/s
            reward = torch.clamp(omega / 3.0, -1.0, 1.0) - cost - 0.02 * slip - finger
        else:
            err = torch.abs(_wrap(theta - state.target))
            settled = (err < 0.1) & (torch.abs(omega) < 0.5)
            reward = -err + 1.0 * settled - cost - 0.02 * slip - finger
        new = BlockRotateState(theta=theta, omega=omega, target=state.target, time=state.time + 1)
        return self.get_obs(new, p), new, reward, _done(new.time, p), {}

    def get_obs(self, state: BlockRotateState, params) -> torch.Tensor:
        s = state
        obs = [torch.cos(s.theta), torch.sin(s.theta), s.omega]
        if self.task != "spin":
            obs += [torch.cos(s.target), torch.sin(s.target), _wrap(s.theta - s.target)]
        return torch.stack(obs, -1)

    def observation_space(self, params=None) -> spaces.Box:
        return spaces.Box(-np.inf, np.inf, (3 if self.task == "spin" else 6,), np.float32)

    def action_space(self, params=None) -> spaces.Box:
        return spaces.Box(-1.0, 1.0, (3,), np.float32)


# ------------------------------------------------------------------------------
# PandaPickCube, PandaPickCubeOrientation: second-order (force) control
# ------------------------------------------------------------------------------


@dataclass
class PandaPickState:
    grip: torch.Tensor  # (E, 2) gripper xz
    grip_vel: torch.Tensor  # (E, 2)
    block: torch.Tensor  # (E, 2) block xz
    block_vel: torch.Tensor  # (E, 2)
    yaw: torch.Tensor  # (E,) block yaw (orientation variant; 0 otherwise)
    target_yaw: torch.Tensor  # (E,)
    holding: torch.Tensor  # (E,) float 0/1
    target: torch.Tensor  # (E, 2)
    time: torch.Tensor  # int32


@dataclass(frozen=True)
class PandaPickParams:
    dt: float = 0.05
    accel: float = 4.0  # commanded acceleration gain
    vel_damp: float = 2.0  # arm joint damping
    wrist_rate: float = 2.5  # wrist yaw rate (orientation variant)
    gravity: float = 2.5
    grasp_radius: float = 0.08
    block_half: float = 0.03
    target_radius: float = 0.08
    yaw_tol: float = 0.25
    max_steps_in_episode: int = 150


class PandaPickCube(Environment):
    """The pick under acceleration control: momentum matters, walls absorb
    it; ``orientation`` adds the held block's yaw, turned by a wrist channel
    (the action's third of four) and scored against a target yaw
    (manipulation2d.py:480-640)."""

    def __init__(self, orientation: bool = False, name: str | None = None):
        self.orientation = orientation
        self._name = name

    @property
    def default_params(self) -> PandaPickParams:
        return PandaPickParams()

    @property
    def name(self) -> str:
        return self._name or ("PandaPickCubeOrientation" if self.orientation else "PandaPickCube")

    def draw_start(self, generator, num_envs, params=None) -> torch.Tensor:
        """(E, 5) [block x, target x, target z, gripper x, target yaw], the
        target yaw ~ U[-pi, pi) with ``orientation``, else 0
        (manipulation2d.py:507-529)."""
        yaw = (uniform(generator, (num_envs,), -math.pi, math.pi) if self.orientation
               else torch.zeros(num_envs, device=generator.device))
        return torch.cat([_pick_draws(generator, num_envs), yaw[:, None]], -1)

    @staticmethod
    def start_state(draws: torch.Tensor, params: PandaPickParams) -> PandaPickState:
        n, dev = draws.shape[0], draws.device
        zeros, zeros2 = torch.zeros(n, device=dev), torch.zeros(n, 2, device=dev)
        return PandaPickState(
            grip=torch.stack([draws[:, 3], torch.full((n,), 0.6, device=dev)], -1), grip_vel=zeros2,
            block=torch.stack([draws[:, 0], torch.full((n,), params.block_half, device=dev)], -1),
            block_vel=zeros2, yaw=zeros, target_yaw=draws[:, 4], holding=zeros, target=draws[:, 1:3],
            time=torch.zeros(n, dtype=torch.int32, device=dev),
        )

    def reset_env(self, generator, num_envs, params):
        state = self.start_state(self.draw_start(generator, num_envs, params), params)
        return self.get_obs(state, params), state

    def step_env(self, state, action, params, draws):
        p = params
        a = torch.clamp(action, -1.0, 1.0)
        dev = a.device
        # second-order arm: commanded acceleration against viscous damping
        grip_vel = state.grip_vel + (a[:, :2] * p.accel - p.vel_damp * state.grip_vel) * p.dt
        grip = state.grip + grip_vel * p.dt
        lo, hi = device_constant((-1.0, 0.0), dev), device_constant((1.0, 1.0), dev)
        hit = (grip < lo) | (grip > hi)
        grip = torch.clamp(grip, lo, hi)
        grip_vel = torch.where(hit, 0.0, grip_vel)  # walls absorb momentum
        holding = _grasp(state.holding, state.block, grip, a[:, -1], p)
        free_block, free_vel = _fall(state.block, state.block_vel, p)
        held = (holding > 0.5)[:, None]
        block = torch.where(held, grip, free_block)
        block_vel = torch.where(held, grip_vel, free_vel)
        # the wrist turns the block's yaw only while it is held
        wrist = a[:, 2] if self.orientation else 0.0
        yaw = _wrap(state.yaw + wrist * p.wrist_rate * p.dt * holding)
        reach_dist = norm2(block - grip)
        place_dist = norm2(block - state.target)
        yaw_err = torch.abs(_wrap(yaw - state.target_yaw))
        in_target = place_dist < p.target_radius
        reward = -0.5 * reach_dist * (1.0 - holding) + 0.25 * holding - place_dist
        if self.orientation:
            in_target = in_target & (yaw_err < p.yaw_tol)
            reward = reward - 0.3 * yaw_err
        # settle bonus: momentum control rewards arriving slow
        reward = reward + 1.0 * in_target - 0.1 * norm2(block_vel) * in_target - _ctrl(a)
        new = PandaPickState(grip=grip, grip_vel=grip_vel, block=block, block_vel=block_vel, yaw=yaw,
                             target_yaw=state.target_yaw, holding=holding, target=state.target, time=state.time + 1)
        return self.get_obs(new, p), new, reward, _done(new.time, p), {}

    def get_obs(self, state: PandaPickState, params) -> torch.Tensor:
        s = state
        obs = [s.grip, s.grip_vel, s.block, s.block_vel, s.holding[:, None], s.target, s.target - s.block]
        if self.orientation:
            obs.append(torch.stack([torch.cos(s.yaw), torch.sin(s.yaw), torch.cos(s.target_yaw),
                                    torch.sin(s.target_yaw)], -1))
        return torch.cat(obs, -1)

    def observation_space(self, params=None) -> spaces.Box:
        return spaces.Box(-np.inf, np.inf, (17 if self.orientation else 13,), np.float32)

    def action_space(self, params=None) -> spaces.Box:
        return spaces.Box(-1.0, 1.0, (4 if self.orientation else 3,), np.float32)


# ------------------------------------------------------------------------------
# PushCube (PandaRobotiqPushCube): top-down planar pushing
# ------------------------------------------------------------------------------


@dataclass
class PushCubeState:
    pusher: torch.Tensor  # (E, 2) xy
    cube: torch.Tensor  # (E, 2) xy
    cube_vel: torch.Tensor  # (E, 2)
    target: torch.Tensor  # (E, 2)
    time: torch.Tensor  # int32


@dataclass(frozen=True)
class PushCubeParams:
    dt: float = 0.05
    speed: float = 1.2
    pusher_r: float = 0.05
    cube_half: float = 0.04
    # quasi-static pushing: the cube stops almost as soon as contact ends
    friction: float = 20.0
    target_radius: float = 0.07
    max_steps_in_episode: int = 150


class PushCube(Environment):
    """A velocity-controlled pusher disc shoves a cube (a disc of radius
    cube_half) to a target: the cube is pushed out along the contact normal
    and takes the pusher's closing speed, and ground friction decays its
    slide (manipulation2d.py:671-786)."""

    def __init__(self, name: str | None = None):
        self._name = name

    @property
    def default_params(self) -> PushCubeParams:
        return PushCubeParams()

    @property
    def name(self) -> str:
        return self._name or "PandaRobotiqPushCube"

    @staticmethod
    def draw_start(generator, num_envs, params=None) -> torch.Tensor:
        """(E, 6) [pusher xy ~ U[-0.8, 0.8), cube xy ~ U[-0.5, 0.5), target
        direction ~ U[0, 2 pi), target distance ~ U[0.3, 0.6)]
        (manipulation2d.py:692-710)."""
        n = (num_envs,)
        return torch.cat([uniform(generator, (num_envs, 2), -0.8, 0.8), uniform(generator, (num_envs, 2), -0.5, 0.5),
                          torch.stack([uniform(generator, n, 0.0, 2 * math.pi), uniform(generator, n, 0.3, 0.6)], -1)],
                         -1)

    @staticmethod
    def start_state(draws: torch.Tensor, params=None) -> PushCubeState:
        n, dev = draws.shape[0], draws.device
        cube, ang, r = draws[:, 2:4], draws[:, 4], draws[:, 5]
        # the target 0.3-0.6 from the cube, so that an episode needs a push
        target = torch.clamp(cube + r[:, None] * torch.stack([torch.cos(ang), torch.sin(ang)], -1), -0.85, 0.85)
        return PushCubeState(pusher=draws[:, :2], cube=cube, cube_vel=torch.zeros(n, 2, device=dev), target=target,
                             time=torch.zeros(n, dtype=torch.int32, device=dev))

    def reset_env(self, generator, num_envs, params):
        state = self.start_state(self.draw_start(generator, num_envs, params), params)
        return self.get_obs(state, params), state

    def step_env(self, state, action, params, draws):
        p = params
        a = torch.clamp(action, -1.0, 1.0)
        vel = a * p.speed
        pusher = torch.clamp(state.pusher + vel * p.dt, -1.0, 1.0)
        # contact: de-penetrate the cube along the normal; it takes the
        # pusher's closing velocity along the normal (a plastic push)
        rel = state.cube - pusher
        dist = norm2(rel) + 1e-8
        overlap = torch.clamp_min(p.pusher_r + p.cube_half - dist, 0.0)
        n = rel / dist[:, None]
        cube = state.cube + n * overlap[:, None]
        v_close = torch.clamp_min(vel[:, 0] * n[:, 0] + vel[:, 1] * n[:, 1], 0.0)
        cube_vel = torch.where((overlap > 0.0)[:, None], state.cube_vel + n * v_close[:, None], state.cube_vel)
        # ground friction: exponential slide decay, exp(-friction dt) in float32 as JAX
        cube_vel = cube_vel * float(np.exp(np.float32(-p.friction * p.dt)))
        cube = torch.clamp(cube + cube_vel * p.dt, -1.0, 1.0)
        d_ct = norm2(cube - state.target)
        d_pc = norm2(pusher - cube)
        in_target = d_ct < p.target_radius
        # progress: the cube's velocity toward the target, which rewards
        # pushing from behind the cube
        to_tgt = (state.target - cube) / (d_ct + 1e-8)[:, None]
        progress = cube_vel[:, 0] * to_tgt[:, 0] + cube_vel[:, 1] * to_tgt[:, 1]
        reward = -d_ct - 0.2 * d_pc + 2.0 * progress + 1.0 * in_target - _ctrl(a)
        new = PushCubeState(pusher=pusher, cube=cube, cube_vel=cube_vel, target=state.target, time=state.time + 1)
        return self.get_obs(new, p), new, reward, _done(new.time, p), {}

    def get_obs(self, state: PushCubeState, params) -> torch.Tensor:
        s = state
        return torch.cat([s.pusher, s.cube, s.cube_vel, s.target, s.target - s.cube, s.cube - s.pusher], -1)

    def observation_space(self, params=None) -> spaces.Box:
        return spaces.Box(-np.inf, np.inf, (12,), np.float32)

    def action_space(self, params=None) -> spaces.Box:
        return spaces.Box(-1.0, 1.0, (2,), np.float32)


# ------------------------------------------------------------------------------
# HandOver (AlohaHandOver): bimanual transfer
# ------------------------------------------------------------------------------


@dataclass
class HandOverState:
    lgrip: torch.Tensor  # (E, 2) left gripper xz
    rgrip: torch.Tensor  # (E, 2) right gripper xz
    block: torch.Tensor  # (E, 2)
    block_vel: torch.Tensor  # (E, 2)
    holder: torch.Tensor  # (E,) float: 0 free, 1 the left hand, 2 the right
    target: torch.Tensor  # (E, 2) right-side elevated target
    time: torch.Tensor  # int32


@dataclass(frozen=True)
class HandOverParams:
    dt: float = 0.05
    speed: float = 1.2
    gravity: float = 2.5
    grasp_radius: float = 0.08
    block_half: float = 0.03
    target_radius: float = 0.08
    reach_overlap: float = 0.15  # the arms overlap only near the midline
    max_steps_in_episode: int = 200


class HandOver(Environment):
    """The block starts on the left table edge and the target sits on the
    right, and each arm crosses the midline only by reach_overlap: the left
    arm picks, the right takes it over (grasping while the left holds moves
    possession) and places it. Action (6): left vx, vz, grip, right vx, vz,
    grip (manipulation2d.py:816-966)."""

    def __init__(self, name: str | None = None):
        self._name = name

    @property
    def default_params(self) -> HandOverParams:
        return HandOverParams()

    @property
    def name(self) -> str:
        return self._name or "AlohaHandOver"

    @staticmethod
    def draw_start(generator, num_envs, params=None) -> torch.Tensor:
        """(E, 5) [block x, target x, target z, left x, right x]
        (manipulation2d.py:836-853)."""
        n = (num_envs,)
        return torch.stack([uniform(generator, n, -0.8, -0.4), uniform(generator, n, 0.4, 0.8),
                            uniform(generator, n, 0.35, 0.8), uniform(generator, n, -0.8, -0.2),
                            uniform(generator, n, 0.2, 0.8)], -1)

    @staticmethod
    def start_state(draws: torch.Tensor, params: HandOverParams) -> HandOverState:
        n, dev = draws.shape[0], draws.device
        high = torch.full((n,), 0.6, device=dev)
        return HandOverState(
            lgrip=torch.stack([draws[:, 3], high], -1), rgrip=torch.stack([draws[:, 4], high], -1),
            block=torch.stack([draws[:, 0], torch.full((n,), params.block_half, device=dev)], -1),
            block_vel=torch.zeros(n, 2, device=dev), holder=torch.zeros(n, device=dev), target=draws[:, 1:3],
            time=torch.zeros(n, dtype=torch.int32, device=dev),
        )

    def reset_env(self, generator, num_envs, params):
        state = self.start_state(self.draw_start(generator, num_envs, params), params)
        return self.get_obs(state, params), state

    def step_env(self, state, action, params, draws):
        p = params
        a = torch.clamp(action, -1.0, 1.0)
        dev = a.device
        la, ra = a[:, :3], a[:, 3:]
        # each arm's workspace overlaps the other's only about the midline
        lgrip = torch.clamp(state.lgrip + la[:, :2] * p.speed * p.dt, device_constant((-1.0, 0.0), dev),
                            device_constant((p.reach_overlap, 1.0), dev))
        rgrip = torch.clamp(state.rgrip + ra[:, :2] * p.speed * p.dt,
                            device_constant((-p.reach_overlap, 0.0), dev), device_constant((1.0, 1.0), dev))
        near_l = norm2(state.block - lgrip) < p.grasp_radius
        near_r = norm2(state.block - rgrip) < p.grasp_radius
        close_l, release_l = la[:, 2] > 0.0, la[:, 2] < -0.5
        close_r, release_r = ra[:, 2] > 0.0, ra[:, 2] < -0.5
        # in this order (manipulation2d.py:876-893): the holder's release
        # frees the block; the other hand closing near it takes it over; a
        # free block goes to the hand that closes on it, the left on a tie
        holder = state.holder
        holder = torch.where((holder == 1.0) & release_l, 0.0, holder)
        holder = torch.where((holder == 2.0) & release_r, 0.0, holder)
        holder = torch.where((holder == 1.0) & near_r & close_r, 2.0, holder)
        holder = torch.where((holder == 0.0) & near_l & close_l, 1.0, holder)
        holder = torch.where((holder == 0.0) & near_r & close_r & ~(near_l & close_l), 2.0, holder)
        right = (holder == 2.0)[:, None]
        carrier = torch.where(right, rgrip, lgrip)
        carrier_vel = torch.where(right, ra[:, :2] * p.speed, la[:, :2] * p.speed)
        free_block, free_vel = _fall(state.block, state.block_vel, p)
        held = (holder > 0.5)[:, None]
        block = torch.where(held, carrier, free_block)
        block_vel = torch.where(held, carrier_vel, free_vel)
        place_dist = norm2(block - state.target)
        in_target = place_dist < p.target_radius
        # staged shaping: approach, left hold, right hold, place
        reward = (-0.3 * norm2(block - lgrip) * (holder == 0.0) + 0.2 * (holder == 1.0) + 0.5 * (holder == 2.0)
                  - 0.5 * place_dist + 1.5 * in_target - _ctrl(a))
        new = HandOverState(lgrip=lgrip, rgrip=rgrip, block=block, block_vel=block_vel, holder=holder,
                            target=state.target, time=state.time + 1)
        return self.get_obs(new, p), new, reward, _done(new.time, p), {}

    def get_obs(self, state: HandOverState, params) -> torch.Tensor:
        s = state
        flags = torch.stack([(s.holder == 1.0).float(), (s.holder == 2.0).float()], -1)
        return torch.cat([s.lgrip, s.rgrip, s.block, s.block_vel, flags, s.target, s.target - s.block,
                          s.block - s.lgrip, s.block - s.rgrip], -1)

    def observation_space(self, params=None) -> spaces.Box:
        return spaces.Box(-np.inf, np.inf, (18,), np.float32)

    def action_space(self, params=None) -> spaces.Box:
        return spaces.Box(-1.0, 1.0, (6,), np.float32)
