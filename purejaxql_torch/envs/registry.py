"""Env registry: `make(env_name, **env_kwargs) -> (env, env_params)`.

Port of purejaxql_tpu/envs/registry.py for the envs this package has so far.
Keyword args matching fields of the env's params dataclass override the
defaults (gymnax-style ENV_KWARGS); the rest go to the env constructor.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

from purejaxql_torch.envs.base import Environment
from purejaxql_torch.envs.classic.cartpole import CartPole
from purejaxql_torch.envs.classic.memory_chain import MemoryChain
from purejaxql_torch.envs.classic.pendulum import Pendulum
from purejaxql_torch.envs.gridworld.forager import Forager
from purejaxql_torch.envs.minatar.asterix import MinAsterix
from purejaxql_torch.envs.minatar.breakout import MinBreakout
from purejaxql_torch.envs.minatar.freeway import MinFreeway
from purejaxql_torch.envs.minatar.seaquest import MinSeaquest
from purejaxql_torch.envs.minatar.space_invaders import MinSpaceInvaders

_REGISTRY: Dict[str, Callable[..., Environment]] = {
    "CartPole-v1": CartPole,
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
}


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
