"""Model factory: choose the Q-network from the config and the obs shape.

Port of purejaxql_tpu/models/factory.py for the MLP family, with the JAX
package's per-family norms (``resolve_norms``: BatchRenorm for the craftax
family), the MinAtar CNN (ARCH ``cnn``, or an observation of rank 3 or more)
and the GRU recurrent network (``make_rnn_q_network``). BF16_COMPUTE
(factory.py:43) gives the MLP and the MinAtar CNN a bfloat16 trunk over
float32 master parameters; the recurrent network takes a dueling head. The
Nature trunk, a BatchRenorm trunk in bfloat16, the recurrent network in
bfloat16 and LSTM cells come with later slices and raise here.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from purejaxql_torch.models.cnn import CNNQNetwork
from purejaxql_torch.models.qnet import QNetwork
from purejaxql_torch.models.rnn import RNNQNetwork


def resolve_norms(config):
    """(norm_type, input_norm_type) with the JAX package's per-family
    mapping (purejaxql_tpu/models/factory.py:14-35): the craftax family uses
    BatchRenorm wherever the gymnax family uses BatchNorm, for the input norm
    and for NORM_TYPE "batch_norm"; an explicit INPUT_NORM_TYPE wins. Craftax
    is told by ALG_NAME or ENV_NAME."""
    family = str(config.get("ALG_NAME", ""))
    env_name = str(config.get("ENV_NAME", "")).lower()
    is_craftax = "craftax" in family or "craftax" in env_name
    norm_type = config["NORM_TYPE"]
    if is_craftax and norm_type == "batch_norm":
        norm_type = "batch_renorm"
    input_norm_type = config.get(
        "INPUT_NORM_TYPE", "batch_renorm" if is_craftax else "batch_norm"
    )
    return norm_type, input_norm_type


def make_q_network(
    config, action_dim: int, obs_shape, generator: Optional[torch.Generator] = None
) -> nn.Module:
    arch = config.get("ARCH") or ("cnn" if len(obs_shape) >= 3 else "mlp")
    dtype = torch.bfloat16 if config.get("BF16_COMPUTE", False) else torch.float32
    if arch == "mlp":
        norm_type, input_norm_type = resolve_norms(config)
        return QNetwork(
            obs_dim=int(obs_shape[0]),
            action_dim=action_dim,
            hidden_size=config.get("HIDDEN_SIZE", 128),
            num_layers=config.get("NUM_LAYERS", 2),
            norm_type=norm_type,
            norm_input=config.get("NORM_INPUT", False),
            input_norm_type=input_norm_type,
            generator=generator,
            dtype=dtype,
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
            dtype=dtype,
        )
    raise ValueError(f"Unknown ARCH '{arch}'")


def check_rnn_q_network(config, obs_shape) -> None:
    """Raise for the recurrent variants that are not ported yet."""
    norm_type, input_norm_type = resolve_norms(config)
    unported = {
        "RNN_CELL": config.get("RNN_CELL", "gru") != "gru",
        "NORM_TYPE": norm_type != "layer_norm",
        "INPUT_NORM_TYPE": input_norm_type != "batch_norm",
        "BF16_COMPUTE": config.get("BF16_COMPUTE", False),
    }
    for key, asked in unported.items():
        if asked:
            raise NotImplementedError(
                f"{key}={config.get(key)!r} is not ported yet: the recurrent network "
                "has GRU cells, a layer_norm trunk and a BatchNorm input norm"
            )
    if len(obs_shape) != 1:
        raise NotImplementedError(
            f"the recurrent network takes flat observations, got shape {tuple(obs_shape)}"
        )


def make_rnn_q_network(
    config, action_dim: int, obs_shape, generator: Optional[torch.Generator] = None
) -> RNNQNetwork:
    """The recurrent trainers' network (pqn_rnn.py:87-100, pqn_vdn.py:93-104):
    GRU cells on a layer_norm trunk over flat observations, the last action
    as an input where ADD_LAST_ACTION says so, a dueling head where DUELING
    does."""
    check_rnn_q_network(config, obs_shape)
    return RNNQNetwork(
        obs_dim=int(obs_shape[0]),
        action_dim=action_dim,
        hidden_size=config.get("HIDDEN_SIZE", 128),
        num_layers=config.get("NUM_LAYERS", 2),
        num_rnn_layers=config.get("NUM_RNN_LAYERS", 1),
        norm_input=config.get("NORM_INPUT", False),
        add_last_action=config.get("ADD_LAST_ACTION", False),
        dueling=config.get("DUELING", False),
        generator=generator,
    )
