"""Model factory: choose the Q-network from the config and the obs shape.

Port of purejaxql_tpu/models/factory.py for the MLP family; the CNN and the
craftax BatchRenorm variants come with later slices and raise here.
"""

from __future__ import annotations

from typing import Optional

import torch

from purejaxql_torch.models.qnet import QNetwork


def make_q_network(
    config, action_dim: int, obs_shape, generator: Optional[torch.Generator] = None
) -> QNetwork:
    arch = config.get("ARCH") or ("cnn" if len(obs_shape) >= 3 else "mlp")
    if arch != "mlp":
        raise NotImplementedError(f"ARCH '{arch}' is not ported yet")
    if config.get("BF16_COMPUTE", False):
        raise NotImplementedError("BF16_COMPUTE is not ported yet")
    if config.get("INPUT_NORM_TYPE", "batch_norm") != "batch_norm":
        raise NotImplementedError("INPUT_NORM_TYPE other than batch_norm is not ported yet")
    return QNetwork(
        obs_dim=int(obs_shape[0]),
        action_dim=action_dim,
        hidden_size=config.get("HIDDEN_SIZE", 128),
        num_layers=config.get("NUM_LAYERS", 2),
        norm_type=config["NORM_TYPE"],
        norm_input=config.get("NORM_INPUT", False),
        generator=generator,
    )
