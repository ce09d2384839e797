"""Model factory: choose the Q-network from the config and the obs shape.

Port of purejaxql_tpu/models/factory.py for the MLP family and the MinAtar
CNN (ARCH ``cnn``, or an observation of rank 3 or more). The Nature trunk,
BatchRenorm and BF16_COMPUTE come with later slices and raise here.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from purejaxql_torch.models.cnn import CNNQNetwork
from purejaxql_torch.models.qnet import QNetwork


def make_q_network(
    config, action_dim: int, obs_shape, generator: Optional[torch.Generator] = None
) -> nn.Module:
    arch = config.get("ARCH") or ("cnn" if len(obs_shape) >= 3 else "mlp")
    if config.get("BF16_COMPUTE", False):
        raise NotImplementedError("BF16_COMPUTE is not ported yet")
    if config.get("INPUT_NORM_TYPE", "batch_norm") != "batch_norm":
        raise NotImplementedError("INPUT_NORM_TYPE other than batch_norm is not ported yet")
    if arch == "mlp":
        return QNetwork(
            obs_dim=int(obs_shape[0]),
            action_dim=action_dim,
            hidden_size=config.get("HIDDEN_SIZE", 128),
            num_layers=config.get("NUM_LAYERS", 2),
            norm_type=config["NORM_TYPE"],
            norm_input=config.get("NORM_INPUT", False),
            generator=generator,
        )
    if arch == "cnn":
        return CNNQNetwork(
            obs_shape=tuple(obs_shape),
            action_dim=action_dim,
            hidden_size=config.get("HIDDEN_SIZE", 128),
            norm_type=config["NORM_TYPE"],
            norm_input=config.get("NORM_INPUT", False),
            trunk=config.get("CNN_TRUNK", "minatar"),
            input_scale=config.get("INPUT_SCALE", 255.0),
            generator=generator,
        )
    raise ValueError(f"Unknown ARCH '{arch}'")
