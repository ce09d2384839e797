"""Multi-agent environments (jaxmarl-style protocol), batched.

Port of purejaxql_tpu/envs/marl/__init__.py: the four in-tree envs under
their names and the reference-style aliases (``__init__.py:13-23``). The JAX
package falls through to an installed jaxmarl for other names; the port has
no such fall-through, and an unknown name raises.
"""

from purejaxql_torch.envs.marl.base import CTRolloutManager, MARLLogWrapper, MultiAgentEnv
from purejaxql_torch.envs.marl.hanabi import MiniHanabi
from purejaxql_torch.envs.marl.kitchen import Kitchen
from purejaxql_torch.envs.marl.skirmish import Skirmish
from purejaxql_torch.envs.marl.spread import Spread

_MARL_REGISTRY = {
    "Spread-v0": Spread,
    "simple_spread": Spread,
    "Skirmish-v0": Skirmish,
    "Kitchen-v0": Kitchen,
    "MiniHanabi-v0": MiniHanabi,
    # compatibility aliases for reference-style configs
    "HeuristicEnemySMAX": Skirmish,
    "overcooked": Kitchen,
    "hanabi": MiniHanabi,
}


def make_marl(name: str, **kwargs) -> MultiAgentEnv:
    if name not in _MARL_REGISTRY:
        raise ValueError(f"Unknown MARL env '{name}'. Registered: {sorted(_MARL_REGISTRY)}")
    return _MARL_REGISTRY[name](**kwargs)


__all__ = ["CTRolloutManager", "MARLLogWrapper", "MultiAgentEnv", "make_marl"]
