"""3D legged locomotion on springy legs, batched over E envs: the Quadruped
(Go1, Spot, Barkour) and the Biped3D (G1, H1, Berkeley, T1, Apollo, Op3 and
the dm-suite humanoid).

Port of purejaxql_tpu/envs/classic/locomotion3d.py. The body is a point mass
with yaw and pitch; each leg is a massless spring from a body-frame hip
socket to a planted foot, and the whole leg model is one pass over a legs
axis (E, L). In flight a leg slews toward its commanded sagittal and lateral
touchdown angles; in stance it pushes along the foot-to-hip line with
k compression - b v_radial, its rest length extended by the action's
positive thrust, and a friction-capped tangential anchor holds the foot
(locomotion3d.py:210-326). Leg forces act at the hips: their sum moves the
body, their moments turn its yaw and pitch; the biped's torso is an inverted
pendulum with a hip-torque action that acts only while a leg stands. Rough
tasks lift the feet and touchdown points onto an analytic height field. A
step is 16 substeps of semi-implicit Euler at dt 0.002, unrolled in Python.

Tasks: ``joystick``, ``joystick_rough`` and ``inplace`` track a body-frame
(vx, vy, yaw rate) command drawn at reset; ``getup`` starts low, pitched and
unplanted; ``handstand`` and ``footstand`` hold a pitch of -1.1 or 1.1;
``stand``, ``walk`` and ``run`` are the dm-suite humanoid's. Rewards as
locomotion3d.py:355-396; the tracking, walk and run tasks lose 1 and end
when the body sinks below min_height_frac of the leg or pitches past
max_pitch, getup, handstand and footstand only at max_steps_in_episode.

Observations (11 + 5 L): the height over the ground in leg lengths, the
body-frame velocity, vz, sin and cos of the pitch, the pitch and yaw rates,
the command, then the per-leg block field-major (locomotion3d.py:436-447):
sin of each leg's sagittal angle, then each cos, each lateral angle, each
stance flag, each spring load.

A reset's randomness comes in as an argument (``start_state``, fed by
``draw_start``): the standing tasks start planted at 0.95 leg + U[0, 0.05)
with a pitch in U[-0.05, 0.05), getup at 0.35 leg with a pitch in
U[-0.6, 0.6); the command is drawn for the tracking tasks. The step draws
nothing.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from purejaxql_torch.envs import spaces
from purejaxql_torch.envs.base import Environment, device_constant
from purejaxql_torch.envs.classic.reacher import uniform


@dataclass
class Loco3DState:
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    vz: torch.Tensor
    yaw: torch.Tensor
    yaw_rate: torch.Tensor
    pitch: torch.Tensor
    pitch_rate: torch.Tensor
    sag: torch.Tensor  # (E, L) sagittal leg angle from body-vertical, + forward
    lat: torch.Tensor  # (E, L) lateral leg angle, + left
    foot_x: torch.Tensor  # (E, L) planted foot world x
    foot_y: torch.Tensor  # (E, L) planted foot world y
    leg_rest: torch.Tensor  # (E, L) spring rest length fixed at touchdown
    stance: torch.Tensor  # (E, L) bool phase flags
    command: torch.Tensor  # (E, 3) body-frame vx, vy, yaw rate targets
    time: torch.Tensor  # int32


@dataclass(frozen=True)
class Loco3DParams:
    mass: float = 12.0
    gravity: float = 9.8
    leg_length: float = 0.35
    spring_k: float = 3500.0
    thrust_ext: float = 0.12
    damping: float = 60.0
    angle_rate: float = 8.0
    max_sag: float = 0.55
    max_lat: float = 0.35
    inertia_yaw: float = 0.25
    inertia_pitch: float = 0.35
    yaw_damp: float = 1.0
    pitch_damp: float = 1.2
    # biped torso pendulum: m g l gravity destabilization, hip torque gain
    pitch_grav: float = 0.0
    pitch_act: float = 0.0
    # joystick command envelope (body-frame m/s, rad/s)
    cmd_vx: float = 1.0
    cmd_vy: float = 0.5
    cmd_yaw: float = 1.0
    terrain_amp: float = 0.0
    dt: float = 0.002
    substeps: int = 16
    min_height_frac: float = 0.45
    max_pitch: float = 1.2
    max_steps_in_episode: int = 1000


COMMAND_TASKS = ("joystick", "joystick_rough")


def ground(p: Loco3DParams, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The analytic terrain height at (x, y) (locomotion3d.py:107-112)."""
    return p.terrain_amp * (torch.sin(0.9 * x) * torch.cos(1.1 * y) + 0.5 * torch.sin(2.1 * x + 1.3 * y))


def above_ground(p: Loco3DParams, z: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """z over the terrain at (x, y); on flat terrain, whose amplitude 0 makes
    the height 0 wherever x and y are finite, z itself."""
    return z if p.terrain_amp == 0.0 else z - ground(p, x, y)


def draw_start(generator: torch.Generator, num_envs: int, task: str, params: Loco3DParams) -> torch.Tensor:
    """(E, 5) reset draws [height offset, pitch, command vx, vy, yaw rate]
    (locomotion3d.py:137-180): getup's height offset and the command of the
    tasks without one are 0."""
    n = (num_envs,)
    zero = torch.zeros(n, device=generator.device)
    if task == "getup":
        head = [zero, uniform(generator, n, -0.6, 0.6)]
    else:
        head = [uniform(generator, n, 0.0, 0.05), uniform(generator, n, -0.05, 0.05)]
    if task in COMMAND_TASKS or task == "inplace":
        yaw = uniform(generator, n, -params.cmd_yaw, params.cmd_yaw)
    if task in COMMAND_TASKS:
        command = [uniform(generator, n, -0.3 * params.cmd_vx, params.cmd_vx),
                   uniform(generator, n, -params.cmd_vy, params.cmd_vy), yaw]
    elif task == "inplace":
        command = [zero, zero, yaw]
    else:
        command = [zero, zero, zero]
    return torch.stack(head + command, -1)


class _Legged3D(Environment):
    """Shared reset, step and obs; the subclasses fix the hip sockets and the
    action's decoding."""

    n_legs = 4
    TASKS: tuple = ()

    def __init__(self, task: str = "joystick", robot: str = "go1", name: str | None = None):
        assert task in self.TASKS, task
        self.task = task
        self.robot = robot
        self._name = name

    @property
    def name(self) -> str:
        return self._name or f"{type(self).__name__}-{self.robot}-{self.task}"

    def hips(self, p: Loco3DParams, device):
        """The body-frame hip offsets (hx, hy), each (L,)."""
        raise NotImplementedError

    def decode(self, action: torch.Tensor):
        """(sagittal, lateral, thrust commands (E, L), pitch command (E,) or
        0.0) of a clipped action."""
        raise NotImplementedError

    # -- reset ------------------------------------------------------------

    def start_state(self, draws: torch.Tensor, params: Loco3DParams) -> Loco3DState:
        """The state after a reset from its (E, 5) draws (locomotion3d.py:169-208)."""
        p, L = params, self.n_legs
        n, dev = draws.shape[0], draws.device
        standing = self.task != "getup"
        if standing:
            z = p.leg_length * 0.95 + draws[:, 0]
        else:
            z = torch.full((n,), 0.35 * p.leg_length, device=dev)
        pitch = draws[:, 1]
        hx, hy = self.hips(p, dev)
        zeros, legs = torch.zeros(n, device=dev), torch.zeros(n, L, device=dev)
        if standing:
            sag, foot_x, foot_y = legs, hx * torch.cos(pitch)[:, None], hy.repeat(n, 1)
        else:
            # alternate sagittal splay, so that symmetric policies still break
            # symmetry at the first touchdown
            splay = torch.tensor([0.08 if k % 2 == 0 else -0.08 for k in range(L)], device=dev)
            sag, foot_x, foot_y = splay.repeat(n, 1), legs, legs
        return Loco3DState(
            x=zeros, y=zeros, z=z, vx=zeros, vy=zeros, vz=zeros, yaw=zeros, yaw_rate=zeros, pitch=pitch,
            pitch_rate=zeros, sag=sag, lat=legs, foot_x=foot_x, foot_y=foot_y,
            leg_rest=torch.full((n, L), p.leg_length, device=dev),
            stance=torch.full((n, L), standing, dtype=torch.bool, device=dev), command=draws[:, 2:5],
            time=torch.zeros(n, dtype=torch.int32, device=dev),
        )

    def reset_env(self, generator, num_envs, params):
        state = self.start_state(draw_start(generator, num_envs, self.task, params), params)
        return self.get_obs(state, params), state

    # -- step -------------------------------------------------------------

    def substep(self, s: Loco3DState, sag_cmd, lat_cmd, ext, pitch_act, hx, hy, p) -> Loco3DState:
        """One semi-implicit Euler substep (locomotion3d.py:210-326): the legs
        over the last axis, their forces and moments summed over it. ``ext``
        is the thrust's extension of the rest lengths, ``pitch_act`` the hip
        torque (pitch_act times the pitch command), both fixed for a step."""
        cy, sy = torch.cos(s.yaw)[:, None], torch.sin(s.yaw)[:, None]
        cp, sp = torch.cos(s.pitch), torch.sin(s.pitch)

        # swing legs servo toward commanded touchdown angles (rate-limited)
        lim = p.angle_rate * p.dt
        sag = torch.where(s.stance, s.sag, s.sag + torch.clamp(sag_cmd - s.sag, -lim, lim))
        lat = torch.where(s.stance, s.lat, s.lat + torch.clamp(lat_cmd - s.lat, -lim, lim))

        # hip sockets in world coordinates (pitch tilts the fore/aft axis)
        r_fwd = hx * cp[:, None]
        r_up = hx * sp[:, None]
        hip_x = s.x[:, None] + r_fwd * cy - hy * sy
        hip_y = s.y[:, None] + r_fwd * sy + hy * cy
        hip_z = s.z[:, None] + r_up

        # stance spring force along each (foot -> hip) 3-vector
        lx = hip_x - s.foot_x
        ly = hip_y - s.foot_y
        lz = above_ground(p, hip_z, s.foot_x, s.foot_y)
        length = torch.sqrt(lx * lx + ly * ly + lz * lz) + 1e-8
        ux, uy, uz = lx / length, ly / length, lz / length
        rest = s.leg_rest + ext
        compression = torch.clamp_min(rest - length, 0.0)
        vx0, vy0 = s.vx[:, None], s.vy[:, None]
        vr = vx0 * ux + vy0 * uy + s.vz[:, None] * uz
        f = torch.clamp_min(p.spring_k * compression - p.damping * vr, 0.0)
        f = torch.where(s.stance, f, 0.0)
        fx, fy, fz = f * ux, f * uy, f * uz

        # the planted foot's tangential anchor, capped at mu times the axial load
        at_x = -0.15 * p.spring_k * lx - p.damping * vx0
        at_y = -0.15 * p.spring_k * ly - p.damping * vy0
        at_mag = torch.sqrt(at_x * at_x + at_y * at_y) + 1e-8
        cone = torch.clamp_max(0.8 * f / at_mag, 1.0)
        fx = fx + torch.where(s.stance, at_x * cone, 0.0)
        fy = fy + torch.where(s.stance, at_y * cone, 0.0)

        ax = fx.sum(-1) / p.mass
        ay = fy.sum(-1) / p.mass
        az = fz.sum(-1) / p.mass - p.gravity

        # moments of the hip forces about the COM
        rx = hip_x - s.x[:, None]
        ry = hip_y - s.y[:, None]
        tau_yaw = (rx * fy - ry * fx).sum(-1) - p.yaw_damp * s.yaw_rate
        f_fwd = fx * cy + fy * sy
        any_st = s.stance.any(-1)
        tau_pitch = (
            (fz * r_fwd - f_fwd * r_up).sum(-1)
            + p.pitch_grav * sp
            + pitch_act * any_st
            - p.pitch_damp * s.pitch_rate
        )

        vx = s.vx + ax * p.dt
        vy = s.vy + ay * p.dt
        vz = s.vz + az * p.dt
        x = s.x + vx * p.dt
        y = s.y + vy * p.dt
        z = s.z + vz * p.dt
        yaw_rate = s.yaw_rate + tau_yaw / p.inertia_yaw * p.dt
        yaw = s.yaw + yaw_rate * p.dt
        pitch_rate = s.pitch_rate + tau_pitch / p.inertia_pitch * p.dt
        pitch = torch.clamp(s.pitch + pitch_rate * p.dt, -1.5, 1.5)

        # phase transitions at the pre-step hips, each swing leg's prospective
        # foot point rotated to the world frame
        ca = torch.cos(sag) * torch.cos(lat)
        step_f = torch.sin(sag)
        step_l = torch.sin(lat)
        dir_x = step_f * cy - step_l * sy
        dir_y = step_f * sy + step_l * cy
        clearance = hip_z
        if p.terrain_amp != 0.0:
            clearance = hip_z - ground(p, hip_x + p.leg_length * dir_x, hip_y + p.leg_length * dir_y)
        reach = torch.clamp_max(clearance / torch.clamp_min(ca, 0.5), p.leg_length)
        touchdown = ~s.stance & (vz < 0.0)[:, None] & (clearance <= p.leg_length * ca)
        foot_x = torch.where(touchdown, hip_x + reach * dir_x, s.foot_x)
        foot_y = torch.where(touchdown, hip_y + reach * dir_y, s.foot_y)
        leg_rest = torch.where(touchdown, reach, s.leg_rest)
        liftoff = s.stance & (length >= rest) & (vr > 0.0)
        stance = touchdown | (s.stance & ~liftoff)
        sag = torch.where(liftoff, 0.0, sag)
        lat = torch.where(liftoff, 0.0, lat)
        return replace(s, x=x, y=y, z=z, vx=vx, vy=vy, vz=vz, yaw=yaw, yaw_rate=yaw_rate, pitch=pitch,
                       pitch_rate=pitch_rate, sag=sag, lat=lat, foot_x=foot_x, foot_y=foot_y, leg_rest=leg_rest,
                       stance=stance)

    def step_env(self, state, action, params, draws):
        p = params
        action = torch.clamp(action, -1.0, 1.0)
        sag_cmd, lat_cmd, thrust, pitch_cmd = self.decode(action)
        ext = p.thrust_ext * torch.clamp_min(thrust, 0.0)
        pitch_act = p.pitch_act * pitch_cmd
        hx, hy = self.hips(p, action.device)
        s = state
        for _ in range(p.substeps):
            s = self.substep(s, sag_cmd, lat_cmd, ext, pitch_act, hx, hy, p)
        s = replace(s, time=state.time + 1)
        reward = self.reward(s, action, p)
        done = self.is_terminal(s, p)
        return self.get_obs(s, p), s, reward, done, {}

    # -- reward, termination, observation -------------------------------------

    @staticmethod
    def body_vel(s: Loco3DState):
        cy, sy = torch.cos(s.yaw), torch.sin(s.yaw)
        return cy * s.vx + sy * s.vy, -sy * s.vx + cy * s.vy

    def fell(self, s: Loco3DState, p: Loco3DParams):
        return above_ground(p, s.z, s.x, s.y) < p.min_height_frac * p.leg_length

    def reward(self, s: Loco3DState, action, p: Loco3DParams) -> torch.Tensor:
        """locomotion3d.py:355-396."""
        ctrl = 0.05 * torch.mean(action**2, -1)
        stand_z = p.leg_length * 0.95
        vbx, vby = self.body_vel(s)
        if self.task in COMMAND_TASKS or self.task == "inplace":
            cmd = s.command
            track = torch.exp(-((vbx - cmd[:, 0]) ** 2 + (vby - cmd[:, 1]) ** 2) / 0.25)
            turn = torch.exp(-((s.yaw_rate - cmd[:, 2]) ** 2) / 0.25)
            upright = torch.cos(s.pitch)
            r = 1.5 * track + 0.5 * turn + 0.3 * upright - ctrl - 0.1 * torch.abs(s.vz)
            return torch.where(self.fell(s, p), r - 1.0, r)
        if self.task == "getup":
            return 1.5 * torch.clamp(s.z / stand_z, 0.0, 1.0) + 0.5 * torch.cos(s.pitch) - ctrl
        if self.task in ("handstand", "footstand"):
            target = -1.1 if self.task == "handstand" else 1.1
            posture = torch.exp(-((s.pitch - target) ** 2) / 0.3)
            still = torch.exp(-(vbx**2 + vby**2))
            return 2.0 * posture + 0.5 * still + 0.3 * torch.clamp(s.z / stand_z, 0.0, 1.0) - ctrl
        if self.task == "stand":
            return (torch.clamp(s.z / stand_z, 0.0, 1.0) + 0.5 * torch.cos(s.pitch)
                    - 0.3 * (torch.abs(vbx) + torch.abs(vby)) - ctrl)
        # walk, run: a forward-speed target with an upright bonus
        target = 1.0 if self.task == "walk" else 4.0
        speed = torch.clamp(vbx, -1.0, target) / target
        r = speed + 0.5 * torch.cos(s.pitch) + 0.3 - ctrl
        return torch.where(self.fell(s, p), r - 1.0, r)

    def is_terminal(self, s: Loco3DState, p: Loco3DParams) -> torch.Tensor:
        out_of_time = s.time >= p.max_steps_in_episode
        if self.task in ("getup", "handstand", "footstand"):
            return out_of_time
        return self.fell(s, p) | (torch.abs(s.pitch) > p.max_pitch) | out_of_time

    def get_obs(self, state: Loco3DState, params=None) -> torch.Tensor:
        p = params or self.default_params
        s = state
        vbx, vby = self.body_vel(s)
        base = torch.stack([above_ground(p, s.z, s.x, s.y) / p.leg_length, vbx, vby, s.vz, torch.sin(s.pitch),
                            torch.cos(s.pitch), s.pitch_rate, s.yaw_rate], -1)
        # the per-leg block: geometry, contact state and the current spring
        # load, gated on stance as the force is
        hx, hy = self.hips(p, s.x.device)
        cy, sy = torch.cos(s.yaw)[:, None], torch.sin(s.yaw)[:, None]
        cp, sp = torch.cos(s.pitch)[:, None], torch.sin(s.pitch)[:, None]
        hip_x = s.x[:, None] + hx * cp * cy - hy * sy
        hip_y = s.y[:, None] + hx * cp * sy + hy * cy
        hip_z = s.z[:, None] + hx * sp
        length = torch.sqrt((hip_x - s.foot_x) ** 2 + (hip_y - s.foot_y) ** 2
                            + above_ground(p, hip_z, s.foot_x, s.foot_y) ** 2) + 1e-8
        load = s.stance * torch.clamp_min(s.leg_rest - length, 0.0) / p.leg_length
        return torch.cat([base, s.command, torch.sin(s.sag), torch.cos(s.sag), s.lat, s.stance.float(), load], -1)

    def observation_space(self, params) -> spaces.Box:
        return spaces.Box(-np.inf, np.inf, (11 + 5 * self.n_legs,), np.float32)


class Quadruped(_Legged3D):
    """Four hip sockets at the body's corners, a 12-wide action (each leg's
    sagittal angle x 0.55, lateral angle x 0.35, thrust), the presets
    go1, spot and barkour (locomotion3d.py:455-510)."""

    n_legs = 4
    TASKS = ("joystick", "joystick_rough", "getup", "handstand", "footstand", "walk", "run", "stand", "inplace")
    PRESETS = {
        "go1": dict(mass=12.0, leg_length=0.35, spring_k=3500.0, cmd_vx=1.2, damping=60.0),
        "spot": dict(mass=32.0, leg_length=0.5, spring_k=9000.0, cmd_vx=1.5, damping=160.0, inertia_yaw=1.2,
                     inertia_pitch=1.6),
        "barkour": dict(mass=9.0, leg_length=0.3, spring_k=2800.0, cmd_vx=2.0, damping=45.0, inertia_yaw=0.15,
                        inertia_pitch=0.2),
    }

    def __init__(self, task: str = "joystick", robot: str = "go1", name: str | None = None):
        super().__init__(task, robot, name)

    @property
    def default_params(self) -> Loco3DParams:
        kw = dict(self.PRESETS[self.robot])
        if self.task == "joystick_rough":
            kw["terrain_amp"] = 0.04
        if self.task == "getup":
            kw["max_steps_in_episode"] = 500
        return Loco3DParams(**kw)

    def hips(self, p, device):
        d = 0.55 * p.leg_length
        w = 0.35 * p.leg_length
        return device_constant((d, d, -d, -d), device), device_constant((w, -w, w, -w), device)

    def decode(self, action):
        return 0.55 * action[:, 0:4], 0.35 * action[:, 4:8], action[:, 8:12], 0.0

    def action_space(self, params=None) -> spaces.Box:
        return spaces.Box(-1.0, 1.0, (12,), np.float32)


class Biped3D(_Legged3D):
    """Two laterally offset hips under a torso that is an inverted pendulum,
    a 7-wide action (each leg's sagittal angle x 0.55, lateral angle x
    0.35, thrust, then the torso's pitch torque), seven robot presets
    (locomotion3d.py:513-579)."""

    n_legs = 2
    TASKS = ("joystick", "joystick_rough", "inplace", "stand", "walk", "run")
    PRESETS = {
        "g1": dict(mass=35.0, leg_length=0.6, spring_k=11000.0, cmd_vx=1.2, damping=220.0),
        "h1": dict(mass=47.0, leg_length=0.85, spring_k=16000.0, cmd_vx=1.5, damping=340.0, inertia_pitch=2.4,
                   inertia_yaw=1.4),
        "berkeley": dict(mass=24.0, leg_length=0.5, spring_k=8000.0, cmd_vx=1.0, damping=160.0),
        "t1": dict(mass=30.0, leg_length=0.55, spring_k=9500.0, cmd_vx=1.2, damping=190.0),
        "apollo": dict(mass=70.0, leg_length=0.9, spring_k=24000.0, cmd_vx=1.2, damping=520.0, inertia_pitch=4.0,
                       inertia_yaw=2.2),
        "op3": dict(mass=3.2, leg_length=0.22, spring_k=900.0, cmd_vx=0.4, damping=14.0, inertia_pitch=0.04,
                    inertia_yaw=0.03),
        "humanoid": dict(mass=40.0, leg_length=0.7, spring_k=13000.0, cmd_vx=1.5, damping=260.0, inertia_pitch=2.0),
    }

    def __init__(self, task: str = "joystick", robot: str = "g1", name: str | None = None):
        super().__init__(task, robot, name)

    @property
    def default_params(self) -> Loco3DParams:
        kw = dict(self.PRESETS[self.robot])
        m, leg = kw["mass"], kw["leg_length"]
        # the torso pendulum: a destabilizing gravity moment ~ m g l_torso,
        # and hip actuation strong enough to dominate it
        kw.setdefault("inertia_pitch", 1.2)
        kw.setdefault("inertia_yaw", 0.8)
        kw["pitch_grav"] = 0.35 * m * 9.8 * 0.3 * leg
        kw["pitch_act"] = 0.9 * m * 9.8 * 0.3 * leg
        kw["pitch_damp"] = 0.15 * m * leg
        kw["max_pitch"] = 1.0
        if self.task == "joystick_rough":
            kw["terrain_amp"] = 0.03
        return Loco3DParams(**kw)

    def hips(self, p, device):
        w = 0.18 * p.leg_length
        return device_constant((0.0, 0.0), device), device_constant((w, -w), device)

    def decode(self, action):
        return 0.55 * action[:, 0:2], 0.35 * action[:, 2:4], action[:, 4:6], action[:, 6]

    def action_space(self, params=None) -> spaces.Box:
        return spaces.Box(-1.0, 1.0, (7,), np.float32)
