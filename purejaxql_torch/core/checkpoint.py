"""Checkpointing in the JAX package's safetensors wire format, and the weight
crossing between flax and torch layouts.

Port of purejaxql_tpu/core/checkpoint.py (``save_params``, ``load_params``,
``save_run``). Files hold the flax params tree flattened with ``sep=","``
(``Dense_0,kernel``, ``LayerNorm_0,scale``, ...), so a file written by one
package loads in the other. Full-state resume (``save_state`` /
``load_state``) is not ported yet.

Names: a torch parameter ``CNN_0.Conv_0.weight`` is the flax leaf
``params/CNN_0/Conv_0/kernel``; nested modules map level for level.

Layouts: flax's ``scale`` of a ``LayerNorm_i`` or ``BatchNorm_i`` is torch's
``weight``, whatever its rank; any other weight is told apart by its rank: a
flax ``Dense.kernel`` is (in, out) and a torch ``Linear.weight`` is
(out, in); a rank-3 kernel is a member-stacked Dense, (M, in, out) in flax
and (M, out, in) here, the leading axis moved as a batch axis (flax's
vmapped critic ensemble, models/actor_critic.py); a flax ``Conv.kernel`` is
HWIO and a torch conv weight is OIHW. Batch statistics live in a separate
flax collection (``batch_stats``: ``mean``, ``var``) and in the modules'
buffers here; stacked ones keep their member axis in both.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Union

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


def save_params(params: Mapping, filename: str) -> None:
    """Write a flax-layout params tree (tensors or arrays) to safetensors."""
    def _tensor(v):
        if torch.is_tensor(v):
            return v.detach().cpu().contiguous()
        return torch.from_numpy(np.ascontiguousarray(v))

    save_file({k: _tensor(v) for k, v in _flatten(params).items()}, filename)


def load_params(filename: str) -> Dict:
    """Read a safetensors params file into a nested dict of CPU tensors."""
    return _unflatten(load_file(filename))


def _is_norm(module: str) -> bool:
    return module.rsplit(".", 1)[-1].startswith(("LayerNorm_", "BatchNorm_"))


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
) -> str:
    """Save the params (flax wire format) and a config snapshot, in the JAX
    package's single-seed layout: ``<run_name>.safetensors`` and
    ``<run_name>_config.yaml``. A dict of modules (the actor-critic family's
    ``{"actor": ..., "critic": ...}``) is saved as one tree with a top level
    per module, as purejaxql_tpu/cli.py saves it."""
    os.makedirs(save_dir, exist_ok=True)
    save_config(config, os.path.join(save_dir, f"{run_name}_config.yaml"))
    if isinstance(modules, torch.nn.Module):
        params = params_to_flax(modules)["params"]
    else:
        params = {name: params_to_flax(m)["params"] for name, m in modules.items()}
    save_params(params, os.path.join(save_dir, f"{run_name}.safetensors"))
    return save_dir
