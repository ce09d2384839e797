"""Normalization-aware MLP Q-network.

Port of purejaxql_tpu/models/qnet.py: Dense -> norm -> relu stacks with a
NORM_TYPE switch (layer_norm | batch_norm | none), and a BatchNorm over the
input that is always instantiated, as a dummy when norm_input=False, so the
parameter tree is identical across configs.

Flax conventions are kept so that weights cross between the packages
unchanged (core/checkpoint.py):

- submodules carry flax's auto-names (``BatchNorm_0``, ``Dense_0``,
  ``LayerNorm_0``, ...);
- Dense kernels start lecun-normal (truncated at two standard deviations)
  with zero biases, not torch's kaiming-uniform;
- LayerNorm uses eps 1e-6 and BatchNorm eps 1e-5, both with the variance
  E[x^2] - E[x]^2;
- BatchNorm in train mode normalizes with the batch statistics and updates
  its running statistics as new = 0.99 * old + 0.01 * batch with the biased
  variance, even when its output is unused (the dummy input norm).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

# flax's lecun_normal: variance_scaling(1, "fan_in", "truncated_normal"),
# whose std is corrected for the truncation at +-2 std
_TRUNC_STD_CORRECTION = 0.87962566103423978


def _stats(x: torch.Tensor, dim: int):
    mean = x.mean(dim, keepdim=True)
    var = torch.clamp((x * x).mean(dim, keepdim=True) - mean * mean, min=0.0)
    return mean, var


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


def dense(
    in_features: int,
    out_features: int,
    generator: Optional[torch.Generator],
    scale: float = 1.0,
) -> nn.Linear:
    """An ``nn.Linear`` initialised as flax's ``Dense`` (lecun-normal, or
    ``variance_scaling(scale)``), drawing only from ``generator`` (torch's
    own init is skipped, so the global RNG is not touched)."""
    layer = torch.nn.utils.skip_init(nn.Linear, in_features, out_features)
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

    def forward(self, x):
        mean, var = _stats(x, -1)
        return _normalize(x, mean, var, self.eps, self.weight, self.bias)


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

    def forward(self, x, train: bool):
        if train:
            mean, var = _stats(x, tuple(range(x.dim() - 1)))
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean.reshape(-1))
                self.var.copy_(m * self.var + (1 - m) * var.reshape(-1))
        else:
            mean, var = self.mean, self.var
        return _normalize(x, mean, var, self.eps, self.weight, self.bias)


class QNetwork(nn.Module):
    def __init__(
        self,
        obs_dim: int,
        action_dim: int,
        hidden_size: int = 128,
        num_layers: int = 2,
        norm_type: str = "layer_norm",
        norm_input: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if norm_type not in ("layer_norm", "batch_norm", "none"):
            raise ValueError(f"unsupported NORM_TYPE '{norm_type}'")
        self.action_dim = action_dim
        self.num_layers = num_layers
        self.norm_type = norm_type
        self.norm_input = norm_input
        self.BatchNorm_0 = BatchNorm(obs_dim)
        width = obs_dim
        for i in range(num_layers):
            self.add_module(f"Dense_{i}", dense(width, hidden_size, generator))
            if norm_type == "layer_norm":
                self.add_module(f"LayerNorm_{i}", LayerNorm(hidden_size))
            elif norm_type == "batch_norm":
                self.add_module(f"BatchNorm_{i + 1}", BatchNorm(hidden_size))
            width = hidden_size
        self.add_module(f"Dense_{num_layers}", dense(width, action_dim, generator))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        normed = self.BatchNorm_0(x, train)
        if self.norm_input:
            x = normed
        for i in range(self.num_layers):
            x = getattr(self, f"Dense_{i}")(x)
            if self.norm_type == "layer_norm":
                x = getattr(self, f"LayerNorm_{i}")(x)
            elif self.norm_type == "batch_norm":
                x = getattr(self, f"BatchNorm_{i + 1}")(x, train)
            x = torch.relu(x)
        return getattr(self, f"Dense_{self.num_layers}")(x)
