"""Checkpointing in the JAX package's safetensors wire format, and the weight
crossing between flax and torch layouts.

Port of purejaxql_tpu/core/checkpoint.py (``save_params``, ``load_params``,
``save_run``, ``save_state``, ``load_state``). Files hold the flax params
tree flattened with ``sep=","`` (``Dense_0,kernel``, ``LayerNorm_0,scale``,
...), so a file written by one package loads in the other.

Full-state resume (``save_state`` / ``load_state``) writes JAX's key
layout: ``params/<flat>``, ``batch_stats/<flat>``, ``opt_state/{i}`` (the
leaves of optax's ``chain(clip_by_global_norm, radam(lr))`` state in its
flatten order: RAdam's count, every ``mu``, every ``nu``, the params tree's
leaves in sorted key order and flax layout, and where the learning rate is a
schedule, the schedule's count) and ``counters/{step, timesteps, n_updates,
grad_steps}``, 0-d int32 as the JAX train state's.

Names: a torch parameter ``CNN_0.Conv_0.weight`` is the flax leaf
``params/CNN_0/Conv_0/kernel``; nested modules map level for level.

Layouts: flax's ``scale`` of a ``LayerNorm_i``, ``BatchNorm_i`` or
``BatchRenorm_i`` is torch's ``weight``, whatever its rank; any other weight is told apart by its rank: a
flax ``Dense.kernel`` is (in, out) and a torch ``Linear.weight`` is
(out, in); a rank-3 kernel is a member-stacked Dense, (M, in, out) in flax
and (M, out, in) here, the leading axis moved as a batch axis (flax's
vmapped critic ensemble, models/actor_critic.py, and the NUM_SEEDS networks'
seed-stacked Dense, models/stacked.py); a flax ``Conv.kernel`` is HWIO and a
torch conv weight is OIHW, and a seed-stacked one (rank 5) keeps its seed
axis in front. Batch statistics live in a separate
flax collection (``batch_stats``: ``mean``, ``var``, and a BatchRenorm's
``r_max``, ``d_max`` and int32 ``steps`` as well) and in the modules' buffers
here, under the same leaf names; stacked ones keep their member axis in
both. So the trees of a seed-stacked network are those of
``jax.vmap(network.init)``, a leading seed axis on every leaf, and
``save_run`` writes them one file a seed, as the JAX package does; a seeded
critic ensemble's (S * M, ...) member axis (``lane_members`` M) is split
into (S, M, ...) first, so seed s's file holds its own M critics.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch
from safetensors.torch import load_file, save_file

from purejaxql_torch.core.config import save_config


def _flatten(tree: Mapping, prefix: str = "", sep: str = ",") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{sep}{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, key, sep))
        else:
            out[key] = v
    return out


def _unflatten(flat: Mapping[str, Any], sep: str = ",") -> Dict:
    tree: Dict = {}
    for key, v in flat.items():
        node = tree
        *heads, last = key.split(sep)
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = v
    return tree


def _tensor(v) -> torch.Tensor:
    if torch.is_tensor(v):
        return v.detach().cpu().contiguous()
    # np.array, not np.ascontiguousarray, which makes a 0-d leaf (a
    # BatchRenorm's r_max, d_max, steps) shape (1,)
    return torch.from_numpy(np.array(v, order="C"))


def save_params(params: Mapping, filename: str) -> None:
    """Write a flax-layout params tree (tensors or arrays) to safetensors."""
    save_file({k: _tensor(v) for k, v in _flatten(params).items()}, filename)


def load_params(filename: str) -> Dict:
    """Read a safetensors params file into a nested dict of CPU tensors."""
    return _unflatten(load_file(filename))


def _is_norm(module: str) -> bool:
    return module.rsplit(".", 1)[-1].startswith(("LayerNorm_", "BatchNorm_", "BatchRenorm_"))


def _to_flax_leaf(module: str, leaf: str, a: np.ndarray):
    """(flax leaf name, array in flax layout) of a torch parameter of the
    (dotted) module name."""
    if leaf != "weight":
        return leaf, a
    if a.ndim == 1 or _is_norm(module):
        return "scale", a
    if a.ndim in (2, 3):  # Linear (out, in) -> Dense (in, out), per member if stacked
        return "kernel", np.ascontiguousarray(np.swapaxes(a, -1, -2))
    if a.ndim == 4:  # conv OIHW -> HWIO
        return "kernel", np.ascontiguousarray(a.transpose(2, 3, 1, 0))
    if a.ndim == 5:  # seed-stacked conv (S, O, I, H, W) -> (S, H, W, I, O)
        return "kernel", np.ascontiguousarray(a.transpose(0, 3, 4, 2, 1))
    raise ValueError(f"no flax layout for a rank-{a.ndim} weight")


def _from_flax_leaf(leaf: str, t: torch.Tensor):
    """(torch leaf name, tensor in torch layout) of a flax leaf."""
    if leaf == "scale":
        return "weight", t
    if leaf != "kernel":
        return leaf, t
    if t.dim() in (2, 3):  # Dense (in, out) -> Linear (out, in), per member if stacked
        return "weight", t.transpose(-1, -2).contiguous()
    if t.dim() == 4:  # conv HWIO -> OIHW
        return "weight", t.permute(3, 2, 0, 1).contiguous()
    if t.dim() == 5:  # seed-stacked conv (S, H, W, I, O) -> (S, O, I, H, W)
        return "weight", t.permute(0, 4, 3, 1, 2).contiguous()
    raise ValueError(f"no torch layout for a rank-{t.dim()} kernel")


def params_to_flax(module: torch.nn.Module) -> Dict[str, Dict]:
    """The module's weights as flax variables ``{"params", "batch_stats"}``
    of numpy arrays in flax names and layouts (nested as the modules are)."""
    params: Dict[str, Any] = {}
    batch_stats: Dict[str, Any] = {}
    for name, p in module.named_parameters():
        mod, leaf = name.rsplit(".", 1)
        flax_leaf, a = _to_flax_leaf(mod, leaf, p.detach().cpu().numpy())
        params[f"{mod}.{flax_leaf}"] = a
    for name, b in module.named_buffers():
        batch_stats[name] = b.detach().cpu().numpy()
    return {
        "params": _unflatten(params, sep="."),
        "batch_stats": _unflatten(batch_stats, sep="."),
    }


def params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A (partial) torch state_dict from flax variables
    ``{"params": ..., "batch_stats": ...}`` or from a bare params tree.
    Load it with ``module.load_state_dict(sd, strict=False)`` for a bare
    params tree (the batch statistics then stay as they are)."""
    if "params" in tree and isinstance(tree["params"], Mapping):
        params, batch_stats = tree["params"], tree.get("batch_stats") or {}
    else:
        params, batch_stats = tree, {}
    sd: Dict[str, torch.Tensor] = {}
    for key, v in _flatten(params, sep=".").items():
        mod, leaf = key.rsplit(".", 1)
        name, t = _from_flax_leaf(leaf, torch.from_numpy(np.array(v)))
        sd[f"{mod}.{name}"] = t
    for key, v in _flatten(batch_stats, sep=".").items():
        sd[key] = torch.from_numpy(np.array(v))
    return sd


def save_run(
    modules: Union[torch.nn.Module, Mapping[str, torch.nn.Module]],
    config: Dict[str, Any],
    save_dir: str,
    run_name: str,
    extra: Optional[Mapping[str, Any]] = None,
) -> str:
    """Save the params (flax wire format) and a config snapshot in the JAX
    package's layout (purejaxql_tpu/core/checkpoint.py:37-61):
    ``<run_name>_config.yaml`` and, for one seed, ``<run_name>.safetensors``;
    with NUM_SEEDS > 1 (a seed-stacked network) one
    ``<run_name>_vmap{i}.safetensors`` a seed, its leading seed axis
    stripped. A dict of modules (the actor-critic family's ``{"actor": ...,
    "critic": ...}``) is saved as one tree with a top level per module, as
    purejaxql_tpu/cli.py saves it; ``extra`` adds subtrees of tensors beside
    them (the actor-critic family's ``norm_stats``, one seed's)."""
    os.makedirs(save_dir, exist_ok=True)
    save_config(config, os.path.join(save_dir, f"{run_name}_config.yaml"))
    seeds = config.get("NUM_SEEDS", 1)

    def tree(module):
        params = params_to_flax(module)["params"]
        members = getattr(module, "lane_members", None)
        if seeds == 1 or not members:
            return params
        return _unflatten({k: v.reshape(seeds, members, *v.shape[1:]) for k, v in _flatten(params).items()})

    if isinstance(modules, torch.nn.Module):
        params = tree(modules)
    else:
        params = {name: tree(m) for name, m in modules.items()}
    params.update(extra or {})
    if seeds == 1:
        save_params(params, os.path.join(save_dir, f"{run_name}.safetensors"))
        return save_dir
    flat = _flatten(params)
    for i in range(seeds):
        save_params(_unflatten({k: v[i] for k, v in flat.items()}),
                    os.path.join(save_dir, f"{run_name}_vmap{i}.safetensors"))
    return save_dir


def _stack_seed_trees(trees) -> Dict:
    """S per-seed trees (the ``_vmap{i}`` files) as one tree of a seeded
    actor-critic run: the actor's and the statistics' leaves stacked on a
    new seed axis, the critics' members concatenated seed-major (S * M)."""
    flats = [_flatten(t) for t in trees]
    return _unflatten({
        k: (torch.cat if k.startswith("critic,") else torch.stack)(
            [torch.as_tensor(np.asarray(f[k])) for f in flats])
        for k in flats[0]
    })


def load_ac_params(tree, actor: torch.nn.Module, critics: torch.nn.Module, norm_state=None):
    """Carry an actor-critic run's saved tree (``{"actor", "critic"}`` and,
    from a NORMALIZE_OBS run, ``"norm_stats": {"mean", "var"}``, in either
    package's files) into the port: the weights into ``actor`` and the critic
    ensemble (their batch statistics stay as they are), and the observation
    statistics into ``norm_state``, an ``envs/wrappers.py``
    ``NormalizeVecObsState`` (its count kept: the file holds none). Returns
    that state, a new one; ``norm_state`` unchanged where the tree holds no
    statistics or none is given. A weight the tree lacks, or one the
    network lacks, raises KeyError. A list of S trees, a NUM_SEEDS run's
    per-seed files in seed order, loads into seeded networks (``seeds=S``),
    seed s's tree into lane s and its statistics into row s."""
    if isinstance(tree, (list, tuple)):
        tree = _stack_seed_trees(tree)
    for name, module in (("actor", actor), ("critic", critics)):
        missing, unexpected = module.load_state_dict(params_from_flax(tree[name]), strict=False)
        buffers = {k for k, _ in module.named_buffers()}
        wrong = sorted(set(missing) - buffers) + sorted(unexpected)
        if wrong:
            raise KeyError(f"{name}: the saved tree and the network differ in {wrong}")
    stats = tree.get("norm_stats")
    if stats is None or norm_state is None:
        return norm_state
    as_f32 = lambda v: torch.as_tensor(np.asarray(v), dtype=torch.float32, device=norm_state.mean.device)  # noqa: E731
    return dataclasses.replace(norm_state, mean=as_f32(stats["mean"]), var=as_f32(stats["var"]))


# -- full-state resume (purejaxql_tpu/core/checkpoint.py:63-135) -------------

_COUNTERS = ("step", "timesteps", "n_updates", "grad_steps")


def _opt_order(module: torch.nn.Module):
    """(module name, torch leaf, flax leaf) of each parameter in parameter
    order, and the parameter indices in the order optax flattens a moment
    tree: the params tree's leaves by sorted keys, level by level."""
    names = []
    for name, p in module.named_parameters():
        mod, leaf = name.rsplit(".", 1)
        names.append((mod, leaf, _to_flax_leaf(mod, leaf, np.empty(p.shape, np.float32))[0]))
    order = sorted(range(len(names)), key=lambda i: (*names[i][0].split("."), names[i][2]))
    return order, names


def save_state(train_state, filename: str) -> None:
    """Persist a ``PQNTrainState`` (params, batch statistics, optimizer
    state, counters) to one safetensors file in the JAX package's layout, so
    that its ``load_state`` reads it."""
    os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
    network, optimizer = train_state.network, train_state.optimizer
    variables = params_to_flax(network)
    tensors = {f"params/{k}": v for k, v in _flatten(variables["params"]).items()}
    tensors.update({f"batch_stats/{k}": v for k, v in _flatten(variables["batch_stats"]).items()})
    state = optimizer.state_dict()
    count = np.asarray(state["count"], np.int32)
    order, names = _opt_order(network)
    leaves = [count]
    for moments in (state["mu"], state["nu"]):
        for i in order:
            mod, leaf, _ = names[i]
            leaves.append(_to_flax_leaf(mod, leaf, moments[i].detach().cpu().numpy())[1])
    if callable(optimizer.learning_rate):  # optax's scale_by_schedule keeps a count of its own
        leaves.append(count)
    tensors.update({f"opt_state/{i}": v for i, v in enumerate(leaves)})
    tensors.update({f"counters/{k}": np.asarray(getattr(train_state, k), np.int32) for k in _COUNTERS})
    save_file({k: _tensor(v) for k, v in tensors.items()}, filename)


def load_state(train_state, filename: str):
    """Restore a state written by ``save_state`` (in either package) into a
    template ``PQNTrainState`` of the same network and optimizer config, in
    place: its weights and batch statistics, the optimizer's count and
    moments, and the counters. Returns the template. A weight or moment that
    the file and the network do not share raises KeyError."""
    tensors = load_file(filename)

    def section(prefix):
        return _unflatten({k[len(prefix):]: v for k, v in tensors.items() if k.startswith(prefix)})

    network, optimizer = train_state.network, train_state.optimizer
    missing, unexpected = network.load_state_dict(
        params_from_flax({"params": section("params/"), "batch_stats": section("batch_stats/")}), strict=False
    )
    buffers = {k for k, _ in network.named_buffers()}
    wrong = sorted(set(missing) - buffers) + sorted(unexpected)
    if wrong:
        raise KeyError(f"the saved state and the network differ in {wrong}")

    order, names = _opt_order(network)
    n = len(order)
    n_leaves = sum(k.startswith("opt_state/") for k in tensors)
    if n_leaves != 1 + 2 * n + callable(optimizer.learning_rate):
        raise KeyError(f"{n_leaves} optimizer leaves in {filename} for {n} parameters")
    moments = ([None] * n, [None] * n)
    for m, moment in enumerate(moments):
        for j, i in enumerate(order):
            moment[i] = _from_flax_leaf(names[i][2], tensors[f"opt_state/{1 + m * n + j}"])[1]
    optimizer.load_state_dict({"count": int(tensors["opt_state/0"]), "mu": moments[0], "nu": moments[1]})
    for k in _COUNTERS[1:]:
        setattr(train_state, k, int(tensors[f"counters/{k}"]))
    return train_state
