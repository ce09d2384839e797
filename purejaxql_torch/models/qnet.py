"""Normalization-aware MLP Q-network.

Port of purejaxql_tpu/models/qnet.py: Dense -> norm -> relu stacks with a
NORM_TYPE switch (layer_norm | batch_norm | batch_renorm | none), and an
input norm (``input_norm_type``: BatchNorm, or BatchRenorm for the craftax
family) that is always instantiated and called, as a dummy when
norm_input=False, so the parameter tree is identical across configs and the
dummy's statistics move in train mode as flax's do.

Flax conventions are kept so that weights cross between the packages
unchanged (core/checkpoint.py):

- submodules carry flax's auto-names, counted per class in call order
  (``BatchNorm_0`` or ``BatchRenorm_0`` for the input norm, ``Dense_0``,
  ``LayerNorm_0``, ...);
- Dense kernels start lecun-normal (truncated at two standard deviations)
  with zero biases, not torch's kaiming-uniform;
- LayerNorm uses eps 1e-6 and BatchNorm eps 1e-5, both with the variance
  E[x^2] - E[x]^2;
- BatchNorm in train mode normalizes with the batch statistics and updates
  its running statistics as new = 0.99 * old + 0.01 * batch with the biased
  variance, even when its output is unused (the dummy input norm).

``frozen_statistics(network)`` runs train-mode forwards whose statistics
updates are discarded, as flax's ``mutable=["batch_stats"]`` with the
update thrown away: FAST_TARGETS' bootstrap forward (purejaxql_tpu/algo/
pqn.py:473-481).

With ``dtype=torch.bfloat16`` (BF16_COMPUTE, qnet.py:56-95) the input norm
runs in float32 and the trunk casts once to bfloat16: each Dense computes in
bfloat16 from the float32 master parameters (``Dense``), each LayerNorm or
BatchNorm computes its statistics and its normalize in float32 and returns
bfloat16, as flax's norms with ``dtype=bfloat16`` do (a bfloat16 input less
a float32 mean promotes to float32), and the Q-values come back in float32.
A BatchRenorm trunk norm has no dtype in JAX (qnet.py:79-88): it computes
its batch statistics in bfloat16 and returns float32
(``models/batch_renorm.py``), and the next Dense casts its input back to
bfloat16. For float32 every cast is the identity.

With ``seeds=S`` > 1 (NUM_SEEDS) every layer takes its stacked form
(``Layers``, models/stacked.py), lane i drawn from ``generator[i]`` as the
single network is from that generator, and ``forward`` takes and gives
seed-major rows (S * N, ...), lane s's N rows the s-th block: what
``jax.vmap`` of the single network computes, each lane with its own
parameters and batch statistics (a BatchRenorm's ``steps`` too), in float32
or in bfloat16 as above. For one seed the network is the single one, module
for module.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from purejaxql_torch.models.batch_renorm import BatchRenorm

# flax's lecun_normal: variance_scaling(1, "fan_in", "truncated_normal"),
# whose std is corrected for the truncation at +-2 std
_TRUNC_STD_CORRECTION = 0.87962566103423978


def _stats(x: torch.Tensor, dim: int):
    mean = x.mean(dim, keepdim=True)
    var = torch.clamp((x * x).mean(dim, keepdim=True) - mean * mean, min=0.0)
    return mean, var


def batch_moments(x: torch.Tensor, dims, group=None):
    """A batch norm's mean and variance E[x^2] - E[x]^2 (clamped at 0) over
    ``dims``, kept for broadcasting. With a process group (``group``, set on
    the module by ``share_statistics``) the local mean and E[x^2] are
    all-reduce-meaned over it in one collective before the variance is
    formed, so they are the global batch's (flax's ``axis_name``,
    qnet.py:35-84); ``None`` is ``_stats`` as it is."""
    if group is None:
        return _stats(x, dims)
    from purejaxql_torch.parallel.mesh import pmean_moments

    mean, mean2 = pmean_moments(x.mean(dims, keepdim=True), (x * x).mean(dims, keepdim=True), group)
    return mean, torch.clamp(mean2 - mean * mean, min=0.0)


def _normalize(x, mean, var, eps, scale, bias):
    # flax order: (x - mean) * (rsqrt(var + eps) * scale) + bias
    return (x - mean) * (torch.rsqrt(var + eps) * scale) + bias


def variance_scaling_(
    weight: torch.Tensor, fan_in: int, scale: float, generator: Optional[torch.Generator]
) -> None:
    """flax ``variance_scaling(scale, "fan_in", "truncated_normal")`` in
    place: lecun_normal is scale 1, he_normal scale 2."""
    std = math.sqrt(scale / fan_in) / _TRUNC_STD_CORRECTION
    with torch.no_grad():
        nn.init.trunc_normal_(weight, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)


class Dense(nn.Linear):
    """flax ``Dense(dtype=x.dtype)`` over float32 parameters: for an input of
    another dtype the weight and the bias are cast to it, the product is
    rounded to it and then the bias added, two roundings as flax's dot and
    add; for a float32 input ``nn.Linear`` as it is."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        return F.linear(x, self.weight.to(x.dtype)) + self.bias.to(x.dtype)


def dense(
    in_features: int,
    out_features: int,
    generator: Optional[torch.Generator],
    scale: float = 1.0,
) -> Dense:
    """A ``Dense`` initialised as flax's (lecun-normal, or
    ``variance_scaling(scale)``), drawing only from ``generator`` (torch's
    own init is skipped, so the global RNG is not touched)."""
    layer = torch.nn.utils.skip_init(Dense, in_features, out_features)
    variance_scaling_(layer.weight, in_features, scale, generator)
    with torch.no_grad():
        layer.bias.zero_()
    return layer


class LayerNorm(nn.Module):
    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x, train: bool = False):
        # statistics and normalize in float32, the result in x's dtype; no
        # batch statistics, so train mode changes nothing
        h = x.float()
        mean, var = _stats(h, -1)
        return _normalize(h, mean, var, self.eps, self.weight, self.bias).to(x.dtype)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm``: statistics over every axis but the last (the
    batch and, for an image, its pixels), one per feature."""

    def __init__(self, features: int, momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.frozen = False
        self.group = None

    def forward(self, x, train: bool):
        h = x.float()
        if train:
            mean, var = batch_moments(h, tuple(range(h.dim() - 1)), self.group)
            if not self.frozen:
                with torch.no_grad():
                    m = self.momentum
                    self.mean.copy_(m * self.mean + (1 - m) * mean.reshape(-1))
                    self.var.copy_(m * self.var + (1 - m) * var.reshape(-1))
        else:
            mean, var = self.mean, self.var
        return _normalize(h, mean, var, self.eps, self.weight, self.bias).to(x.dtype)


@contextlib.contextmanager
def frozen_statistics(network: nn.Module):
    """Train-mode forwards of ``network`` inside leave every BatchNorm's and
    BatchRenorm's buffers (a BatchRenorm's ``steps`` too), stacked ones
    included, as they were: every module with a ``frozen`` flag."""
    norms = [m for m in network.modules() if hasattr(m, "frozen")]
    for m in norms:
        m.frozen = True
    try:
        yield network
    finally:
        for m in norms:
            m.frozen = False


def share_statistics(network: nn.Module, group) -> nn.Module:
    """Take every BatchNorm's and BatchRenorm's train-mode statistics of
    ``network`` (stacked ones included: every module with a ``frozen``
    flag) over the process group ``group`` (``None``: the local batch), as
    the JAX modules' ``norm_axis_name`` does. Returns ``network``."""
    for m in network.modules():
        if hasattr(m, "frozen"):
            m.group = group
    return network


_NORMS = {"batch_norm": "BatchNorm", "batch_renorm": "BatchRenorm"}


def add_named(parent: nn.Module, counts: dict, kind: str, child: nn.Module) -> str:
    """Register ``child`` on ``parent`` under flax's auto-name for its class
    ``kind``, ``<kind>_<i>`` with i counted per class in ``counts`` in call
    order, and return the name."""
    name = f"{kind}_{counts.get(kind, 0)}"
    counts[kind] = counts.get(kind, 0) + 1
    parent.add_module(name, child)
    return name


class Layers:
    """The layers of a network with ``seeds`` lanes, drawn from
    ``generator`` (one seed) or lane i from ``generator[i]``: for one seed
    this module's own (``dense``, ``LayerNorm``, ``BatchNorm``,
    ``BatchRenorm``), else the stacked ones of models/stacked.py."""

    def __init__(self, generator, seeds: int = 1):
        self.generator, self.seeds = generator, seeds
        if seeds > 1:
            if len(generator) != seeds:
                raise ValueError(f"{seeds} lanes need {seeds} generators, got {len(generator)}")
            from purejaxql_torch.models import stacked  # it imports this module

            self.stacked = stacked

    def dense(self, in_f: int, out_f: int, scale: float = 1.0) -> nn.Module:
        if self.seeds == 1:
            return dense(in_f, out_f, self.generator, scale)
        return self.stacked.lane_dense(in_f, out_f, self.generator, scale)

    def layer_norm(self, features: int) -> nn.Module:
        return LayerNorm(features) if self.seeds == 1 else self.stacked.StackedLayerNorm(self.seeds, features)

    def norm(self, kind: str, features: int) -> nn.Module:
        """The BatchNorm or BatchRenorm of ``kind`` ("batch_norm" or
        "batch_renorm"), stacked with seeds."""
        if self.seeds > 1:
            cls = self.stacked.StackedBatchRenorm if kind == "batch_renorm" else self.stacked.StackedBatchNorm
            return cls(self.seeds, features)
        return BatchRenorm(features) if kind == "batch_renorm" else BatchNorm(features)

    def trunk_norm(self, norm_type: str, features: int):
        """(flax class name, module) of a trunk's NORM_TYPE: LayerNorm,
        BatchNorm or BatchRenorm, stacked with seeds; None for any other
        value, no norm, as the JAX modules' normalizers give (cnn.py:22-46,
        rnn.py:96-109). Each module is called as ``norm(x, train)``."""
        if norm_type == "layer_norm":
            return "LayerNorm", self.layer_norm(features)
        if norm_type in _NORMS:
            return _NORMS[norm_type], self.norm(norm_type, features)
        return None


class QNetwork(nn.Module):
    def __init__(
        self,
        obs_dim: int,
        action_dim: int,
        hidden_size: int = 128,
        num_layers: int = 2,
        norm_type: str = "layer_norm",
        norm_input: bool = False,
        input_norm_type: str = "batch_norm",
        generator=None,
        dtype: torch.dtype = torch.float32,
        seeds: int = 1,
    ):
        super().__init__()
        if norm_type not in ("layer_norm", "batch_norm", "batch_renorm", "none"):
            raise ValueError(f"unsupported NORM_TYPE '{norm_type}'")
        if input_norm_type not in _NORMS:
            raise ValueError(f"unsupported INPUT_NORM_TYPE '{input_norm_type}'")
        self.action_dim = action_dim
        self.num_layers = num_layers
        self.norm_type = norm_type
        self.norm_input = norm_input
        self.dtype = dtype
        self.seeds = seeds
        layers = Layers(generator, seeds)
        counts = {}

        def add(kind, module):
            return add_named(self, counts, kind, module)

        self.input_norm = add(_NORMS[input_norm_type], layers.norm(input_norm_type, obs_dim))
        self.layers = []
        width = obs_dim
        for _ in range(num_layers):
            dense_name = add("Dense", layers.dense(width, hidden_size))
            norm = layers.trunk_norm(norm_type, hidden_size)
            self.layers.append((dense_name, norm and add(*norm)))
            width = hidden_size
        self.head = add("Dense", layers.dense(width, action_dim))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if self.seeds > 1:
            # seed-major rows (S * N, F): each lane's (S, N, F)
            return self._forward(x.reshape(self.seeds, -1, x.shape[-1]), train).reshape(-1, self.action_dim)
        return self._forward(x, train)

    def _forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        normed = getattr(self, self.input_norm)(x, train)
        if self.norm_input:
            x = normed
        for dense_name, norm_name in self.layers:
            # a BatchRenorm hands on float32: each Dense casts its input
            # (flax's Dense(dtype) promotes it)
            x = getattr(self, dense_name)(x.to(self.dtype))
            if norm_name is not None:
                x = getattr(self, norm_name)(x, train)
            x = torch.relu(x)
        return getattr(self, self.head)(x.to(self.dtype)).float()
