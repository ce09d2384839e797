"""Checkpointing in the JAX package's safetensors wire format, and the weight
crossing between flax and torch layouts.

Port of purejaxql_tpu/core/checkpoint.py (``save_params``, ``load_params``,
``save_run``). Files hold the flax params tree flattened with ``sep=","``
(``Dense_0,kernel``, ``LayerNorm_0,scale``, ...), so a file written by one
package loads in the other. Full-state resume (``save_state`` /
``load_state``) is not ported yet.

Layouts: a flax ``Dense.kernel`` is (in, out) and a torch ``Linear.weight``
is (out, in); flax's ``scale`` is torch's ``weight``; batch statistics live
in a separate flax collection (``batch_stats``: ``mean``, ``var``) and in
the modules' buffers here.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping

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


def params_to_flax(module: torch.nn.Module) -> Dict[str, Dict]:
    """The module's weights as flax variables ``{"params", "batch_stats"}``
    of numpy arrays in flax names and layouts."""
    params: Dict[str, Dict] = {}
    batch_stats: Dict[str, Dict] = {}
    for name, p in module.named_parameters():
        mod, leaf = name.rsplit(".", 1)
        a = p.detach().cpu().numpy()
        if mod.startswith("Dense_") and leaf == "weight":
            params.setdefault(mod, {})["kernel"] = np.ascontiguousarray(a.T)
        else:
            flax_leaf = "scale" if leaf == "weight" else leaf
            params.setdefault(mod, {})[flax_leaf] = a
    for name, b in module.named_buffers():
        mod, leaf = name.rsplit(".", 1)
        batch_stats.setdefault(mod, {})[leaf] = b.detach().cpu().numpy()
    return {"params": params, "batch_stats": batch_stats}


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
    for mod, leaves in params.items():
        for leaf, v in leaves.items():
            t = torch.from_numpy(np.array(v))
            if leaf == "kernel":
                sd[f"{mod}.weight"] = t.T.contiguous()
            elif leaf == "scale":
                sd[f"{mod}.weight"] = t
            else:
                sd[f"{mod}.{leaf}"] = t
    for mod, leaves in batch_stats.items():
        for leaf, v in leaves.items():
            sd[f"{mod}.{leaf}"] = torch.from_numpy(np.array(v))
    return sd


def save_run(
    module: torch.nn.Module, config: Dict[str, Any], save_dir: str, run_name: str
) -> str:
    """Save the params (flax wire format) and a config snapshot, in the JAX
    package's single-seed layout: ``<run_name>.safetensors`` and
    ``<run_name>_config.yaml``."""
    os.makedirs(save_dir, exist_ok=True)
    save_config(config, os.path.join(save_dir, f"{run_name}_config.yaml"))
    save_params(
        params_to_flax(module)["params"],
        os.path.join(save_dir, f"{run_name}.safetensors"),
    )
    return save_dir
