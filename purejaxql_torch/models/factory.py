"""Model factory: choose the Q-network from the config and the obs shape.

Port of purejaxql_tpu/models/factory.py for the MLP family, with the JAX
package's per-family norms (``resolve_norms``: BatchRenorm for the craftax
family), the CNNs (ARCH ``cnn``, or an observation of rank 3 or more: the
MinAtar trunk, or with CNN_TRUNK ``nature`` the Nature-DQN trunk,
factory.py:66) and the recurrent network (``make_rnn_q_network``: GRU or LSTM cells, a
BatchNorm or BatchRenorm input norm, a dueling head). BF16_COMPUTE
(factory.py:43) gives the MLP and both CNN trunks a bfloat16 trunk over
float32 master parameters, whatever their norm; the recurrent network
ignores it, as the JAX package's does, and the recurrent trainers' FAST_BPTT
forward takes it (``ops/fast_rnn.py``). Every NORM_TYPE builds: the CNN
takes it as written (factory.py:63), the MLP and the recurrent network
through ``resolve_norms``.

``seeds=S`` > 1 (NUM_SEEDS) gives the network (the FF, the recurrent and
the VDN trainers') S lanes with stacked
parameters, the layout of ``jax.vmap(network.init)``'s (models/stacked.py),
lane i drawn from ``generator[i]``, a sequence of S generators, as the
single network is drawn from it.
"""

from __future__ import annotations


import torch
from torch import nn

from purejaxql_torch.models.cnn import CNNQNetwork
from purejaxql_torch.models.qnet import QNetwork, share_statistics
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
    config, action_dim: int, obs_shape, generator=None, seeds: int = 1, group=None
) -> nn.Module:
    """The FF trainer's network: the MLP ``QNetwork`` or the CNN of ARCH and
    the obs shape; with a process ``group`` every BatchNorm and BatchRenorm
    takes its train-mode statistics over it (``share_statistics``, the JAX
    factory's ``norm_axis_name``, factory.py:41-65)."""
    return share_statistics(_make_q_network(config, action_dim, obs_shape, generator, seeds), group)


def _make_q_network(config, action_dim: int, obs_shape, generator, seeds: int) -> nn.Module:
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
            seeds=seeds,
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
            seeds=seeds,
        )
    raise ValueError(f"Unknown ARCH '{arch}'")


def check_rnn_q_network(obs_shape) -> None:
    """Raise for an observation the recurrent network does not take: it
    takes flat observations (the recurrent trainers flatten images, ARCH
    mlp)."""
    if len(obs_shape) != 1:
        raise NotImplementedError(
            f"the recurrent network takes flat observations, got shape {tuple(obs_shape)}"
        )


def make_rnn_q_network(
    config,
    action_dim: int,
    obs_shape,
    generator=None,
    norms=None,
    hidden_size: int = 128,
    seeds: int = 1,
    group=None,
) -> RNNQNetwork:
    """The recurrent trainers' network (pqn_rnn.py:87-100, pqn_vdn.py:93-104):
    RNN_CELL's cells over flat observations, the trunk and input norms of
    ``norms`` (default ``resolve_norms(config)``, the recurrent trainer's;
    the VDN trainer passes NORM_TYPE as written and a BatchNorm input), the
    last action as an input where ADD_LAST_ACTION says so,
    a dueling head where DUELING does; HIDDEN_SIZE defaults to
    ``hidden_size`` (the recurrent trainer's 128, pqn_rnn.py:90); with a
    process ``group``, the norms' statistics over it (``share_statistics``)."""
    norms = norms if norms is not None else resolve_norms(config)
    check_rnn_q_network(obs_shape)
    return share_statistics(RNNQNetwork(
        obs_dim=int(obs_shape[0]),
        action_dim=action_dim,
        hidden_size=config.get("HIDDEN_SIZE", hidden_size),
        num_layers=config.get("NUM_LAYERS", 2),
        num_rnn_layers=config.get("NUM_RNN_LAYERS", 1),
        cell_type=config.get("RNN_CELL", "gru"),
        norm_input=config.get("NORM_INPUT", False),
        norm_type=norms[0],
        input_norm_type=norms[1],
        add_last_action=config.get("ADD_LAST_ACTION", False),
        dueling=config.get("DUELING", False),
        generator=generator,
        seeds=seeds,
    ), group)
