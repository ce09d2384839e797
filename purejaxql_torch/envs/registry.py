"""Env registry: `make(env_name, **env_kwargs) -> (env, env_params)`.

Port of purejaxql_tpu/envs/registry.py: every name it registers, each with
the same constructor, task, robot and name; its fallback to installed
packages (purejaxql_tpu/envs/external.py) is not ported. Keyword args
matching fields of the env's params dataclass override the defaults
(gymnax-style ENV_KWARGS); the rest go to the env constructor.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Dict, Tuple

from purejaxql_torch.envs.base import Environment
from purejaxql_torch.envs.classic.acrobot import Acrobot
from purejaxql_torch.envs.classic.acrobot_swingup import AcrobotSwingup
from purejaxql_torch.envs.classic.ball_in_cup import BallInCup
from purejaxql_torch.envs.classic.cartpole import CartPole
from purejaxql_torch.envs.classic.cartpole_swingup import CartPoleSwingUp
from purejaxql_torch.envs.classic.catch import Catch
from purejaxql_torch.envs.classic.cheetah import Cheetah
from purejaxql_torch.envs.classic.deep_sea import DeepSea
from purejaxql_torch.envs.classic.finger import Finger
from purejaxql_torch.envs.classic.fish import Fish
from purejaxql_torch.envs.classic.hopper import Hopper
from purejaxql_torch.envs.classic.locomotion3d import Biped3D, Quadruped
from purejaxql_torch.envs.classic.manipulation2d import (
    BlockRotate,
    HandOver,
    PandaPickCube,
    PegInsert,
    PickPlace,
    PushCube,
)
from purejaxql_torch.envs.classic.memory_chain import MemoryChain
from purejaxql_torch.envs.classic.mountain_car import MountainCar
from purejaxql_torch.envs.classic.mountain_car_continuous import MountainCarContinuous
from purejaxql_torch.envs.classic.pendulum import Pendulum
from purejaxql_torch.envs.classic.point_mass import PointMass
from purejaxql_torch.envs.classic.pusher import Pusher
from purejaxql_torch.envs.classic.reacher import Reacher
from purejaxql_torch.envs.classic.swimmer import Swimmer
from purejaxql_torch.envs.classic.walker import Walker
from purejaxql_torch.envs.gridworld.forager import Forager
from purejaxql_torch.envs.minatar.asterix import MinAsterix
from purejaxql_torch.envs.minatar.breakout import MinBreakout
from purejaxql_torch.envs.minatar.freeway import MinFreeway
from purejaxql_torch.envs.minatar.seaquest import MinSeaquest
from purejaxql_torch.envs.minatar.space_invaders import MinSpaceInvaders

_REGISTRY: Dict[str, Callable[..., Environment]] = {
    "CartPole-v1": CartPole,
    "Acrobot-v1": Acrobot,
    "MountainCar-v0": MountainCar,
    "Catch-bsuite": Catch,
    "DeepSea-bsuite": DeepSea,
    "MemoryChain-bsuite": MemoryChain,
    "Pendulum-v1": Pendulum,
    "Asterix-MinAtar": MinAsterix,
    "Breakout-MinAtar": MinBreakout,
    "Freeway-MinAtar": MinFreeway,
    "Seaquest-MinAtar": MinSeaquest,
    "SpaceInvaders-MinAtar": MinSpaceInvaders,
    "Forager-v0": Forager,
    # the reference's name for the craftax workload resolves to Forager, as in
    # purejaxql_tpu/envs/registry.py:231-236
    "Craftax-Symbolic-v1": Forager,
    # the continuous-control envs and their task variants, under every name
    # purejaxql_tpu/envs/registry.py gives them (its "-v0" names and the
    # playground dm-suite names, :52-66, :170-200)
    "Reacher-v0": Reacher,
    "ReacherEasy-v0": partial(Reacher, task="easy"),
    "ReacherHard-v0": partial(Reacher, task="hard"),
    "ReacherEasy": partial(Reacher, task="easy"),
    "ReacherHard": partial(Reacher, task="hard"),
    "MountainCarContinuous-v0": MountainCarContinuous,
    "CartPoleSwingUp-v0": CartPoleSwingUp,
    "CartPoleSwingUpSparse-v0": partial(CartPoleSwingUp, task="swingup_sparse"),
    "CartpoleBalance-v0": partial(CartPoleSwingUp, task="balance"),
    "CartpoleBalanceSparse-v0": partial(CartPoleSwingUp, task="balance_sparse"),
    "CartpoleBalance": partial(CartPoleSwingUp, task="balance"),
    "CartpoleBalanceSparse": partial(CartPoleSwingUp, task="balance_sparse"),
    "CartpoleSwingup": CartPoleSwingUp,
    "CartpoleSwingupSparse": partial(CartPoleSwingUp, task="swingup_sparse"),
    "Hopper-v0": Hopper,
    "HopperStand-v0": partial(Hopper, task="stand"),
    "HopperHop": partial(Hopper, task="hop"),
    "HopperHop-v0": partial(Hopper, task="hop"),
    "HopperStand": partial(Hopper, task="stand"),
    "Walker-v0": Walker,
    "WalkerStand-v0": partial(Walker, task="stand"),
    "WalkerRun-v0": partial(Walker, task="run"),
    "WalkerWalk": partial(Walker, task="walk"),
    "WalkerWalk-v0": partial(Walker, task="walk"),
    "WalkerStand": partial(Walker, task="stand"),
    "WalkerRun": partial(Walker, task="run"),
    "Pusher-v0": Pusher,
    "BallInCup-v0": BallInCup,
    "BallInCup": BallInCup,
    "PendulumSwingup": Pendulum,
    "PendulumSwingup-v0": Pendulum,
    # the rest of the dm-suite domains, each under its "-v0" name and its
    # playground name (purejaxql_tpu/envs/registry.py:79-87, 174-211)
    "AcrobotSwingup-v0": AcrobotSwingup,
    "AcrobotSwingupSparse-v0": partial(AcrobotSwingup, sparse=True),
    "AcrobotSwingup": AcrobotSwingup,
    "AcrobotSwingupSparse": partial(AcrobotSwingup, sparse=True),
    "PointMass-v0": PointMass,
    "PointMass": PointMass,
    "SwimmerSwimmer6-v0": Swimmer,
    "SwimmerSwimmer6": Swimmer,
    "CheetahRun-v0": Cheetah,
    "CheetahRun": Cheetah,
    "FingerSpin": partial(Finger, task="spin"),
    "FingerTurnEasy": partial(Finger, task="turn_easy"),
    "FingerTurnHard": partial(Finger, task="turn_hard"),
    "FingerSpin-v0": partial(Finger, task="spin"),
    "FingerTurnEasy-v0": partial(Finger, task="turn_easy"),
    "FingerTurnHard-v0": partial(Finger, task="turn_hard"),
    "FishSwim": Fish,
    "FishSwim-v0": Fish,
    # the manipulation block (purejaxql_tpu/envs/registry.py:91-123)
    "PickPlace-v0": PickPlace,
    "PegInsert-v0": PegInsert,
    "BlockRotate-v0": BlockRotate,
    "PandaPickCubeCartesian": partial(PickPlace, name="PandaPickCubeCartesian"),
    "PandaPickCube": PandaPickCube,
    "PandaPickCubeOrientation": partial(PandaPickCube, orientation=True),
    "PandaRobotiqPushCube": PushCube,
    "AlohaHandOver": HandOver,
    "AlohaSinglePegInsertion": partial(PegInsert, name="AlohaSinglePegInsertion"),
    "LeapCubeReorient": partial(BlockRotate, task="reorient", name="LeapCubeReorient"),
    "LeapCubeRotateZAxis": partial(BlockRotate, task="spin"),
}

# the locomotion block (purejaxql_tpu/envs/registry.py:125-169): each name a
# (robot preset, task) pair on the shared 3D SLIP model, named after itself
_LOCOMOTION = {
    "Go1JoystickFlatTerrain": (Quadruped, "joystick", "go1"),
    "Go1JoystickRoughTerrain": (Quadruped, "joystick_rough", "go1"),
    "Go1Getup": (Quadruped, "getup", "go1"),
    "Go1Handstand": (Quadruped, "handstand", "go1"),
    "Go1Footstand": (Quadruped, "footstand", "go1"),
    "SpotFlatTerrainJoystick": (Quadruped, "joystick", "spot"),
    "SpotGetup": (Quadruped, "getup", "spot"),
    "SpotJoystickGaitTracking": (Quadruped, "inplace", "spot"),
    "BarkourJoystick": (Quadruped, "joystick", "barkour"),
    "G1JoystickFlatTerrain": (Biped3D, "joystick", "g1"),
    "G1JoystickRoughTerrain": (Biped3D, "joystick_rough", "g1"),
    "BerkeleyHumanoidJoystickFlatTerrain": (Biped3D, "joystick", "berkeley"),
    "BerkeleyHumanoidJoystickRoughTerrain": (Biped3D, "joystick_rough", "berkeley"),
    "T1JoystickFlatTerrain": (Biped3D, "joystick", "t1"),
    "T1JoystickRoughTerrain": (Biped3D, "joystick_rough", "t1"),
    "ApolloJoystickFlatTerrain": (Biped3D, "joystick", "apollo"),
    "Op3Joystick": (Biped3D, "joystick", "op3"),
    "H1InplaceGaitTracking": (Biped3D, "inplace", "h1"),
    "H1JoystickGaitTracking": (Biped3D, "joystick", "h1"),
    # the dm-suite humanoid rows
    "HumanoidStand": (Biped3D, "stand", "humanoid"),
    "HumanoidWalk": (Biped3D, "walk", "humanoid"),
    "HumanoidRun": (Biped3D, "run", "humanoid"),
}
_REGISTRY.update({name: partial(cls, task=task, robot=robot, name=name)
                  for name, (cls, task, robot) in _LOCOMOTION.items()})


def make(env_name: str, **env_kwargs) -> Tuple[Environment, object]:
    if env_name not in _REGISTRY:
        raise ValueError(
            f"Unknown env '{env_name}' (not ported yet). Registered: {sorted(_REGISTRY)}"
        )
    ctor = _REGISTRY[env_name]
    param_fields = {f.name for f in dataclasses.fields(ctor().default_params)}
    param_kwargs = {k: v for k, v in env_kwargs.items() if k in param_fields}
    ctor_kwargs = {k: v for k, v in env_kwargs.items() if k not in param_fields}
    env = ctor(**ctor_kwargs)
    params = env.default_params
    if param_kwargs:
        params = dataclasses.replace(params, **param_kwargs)
    return env, params
