"""Stacked layers: S copies of a layer whose parameters carry a leading axis,
applied to all S in one pass, and the per-lane draws that fill them.

The counterpart of ``jax.vmap`` over a flax module's ``init`` and ``apply``:
the parameters keep the layout of JAX's vmapped params (a Dense kernel
(S, in, out) in flax terms is (S, out, in) here, a LayerNorm scale (S, F)),
so they cross between the packages as the single ones do
(core/checkpoint.py). A stacked layer takes its input as (..., S, N, F),
the lane axis third from last: lane s's rows meet only lane s's parameters,
and a BatchNorm takes each lane's statistics over that lane's rows alone.

Two users:

- the critic ensemble's members (models/actor_critic.py), drawn together;
- the NUM_SEEDS > 1 networks (``seeds=S`` in models/qnet.py, models/cnn.py
  and models/rnn.py), one lane a seed. Lane i is drawn from its own
  generator with the single layer's initialiser (``lane_dense``,
  ``lane_orthogonal``), and the stacked network builds its layers in the
  single network's order, so each generator sees the draws of a
  single-seed network: lane i equals the network drawn from generator i,
  bit for bit.

Dtypes follow the single layers' (models/qnet.py): a stacked Dense on a
bfloat16 input (BF16_COMPUTE) casts its float32 weights and bias to
bfloat16 and rounds the product before the bias is added, as flax's
``Dense(dtype=bfloat16)`` under ``jax.vmap``; the norms compute their
statistics and their normalize in float32 and return the input's dtype.
For float32 every cast is the identity.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from purejaxql_torch.models.batch_renorm import renorm_train
from purejaxql_torch.models.qnet import _normalize, _stats, batch_moments, variance_scaling_


def lane_matmul(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x (..., S, N, K) times w (S, K, M), lane by lane: (..., S, N, M), one
    batched product. With ``dtype`` bfloat16 the operands are rounded to
    bfloat16 and multiplied in float32, a float32 result (the lane form of
    ``ops/fast_rnn.py:_mp_matmul``: bfloat16 operands, float32
    accumulation)."""
    if dtype != torch.float32:
        x, w = x.to(dtype).float(), w.to(dtype).float()
    xs = x.movedim(-3, 0)
    y = torch.bmm(xs.reshape(xs.shape[0], -1, xs.shape[-1]), w)
    return y.reshape(*xs.shape[:-1], w.shape[-1]).movedim(0, -3)


def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``F.linear`` for a single (out, in) weight; for a stacked (S, out, in)
    one (bias (S, out)) on x (..., S, N, in), one batched product. On an
    input of another dtype than the weight's (bfloat16) the weight and the
    bias are cast to it and the product is rounded before the bias is added,
    as ``models/qnet.py:Dense``."""
    if weight.dim() == 2:
        return F.linear(x, weight, bias)
    xs = x.movedim(-3, 0)
    flat = xs.reshape(xs.shape[0], -1, xs.shape[-1])
    if x.dtype != weight.dtype:
        y = torch.bmm(flat, weight.to(x.dtype).transpose(1, 2))
        if bias is not None:
            y = y + bias.to(x.dtype)[:, None, :]
    else:
        wt = weight.transpose(1, 2)
        y = torch.bmm(flat, wt) if bias is None else torch.baddbmm(bias[:, None, :], flat, wt)
    return y.reshape(*xs.shape[:-1], y.shape[-1]).movedim(0, -3)


class StackedDense(nn.Module):
    """M dense layers applied to (..., M, N, in) in one batched matmul:
    weight (M, out, in), bias (M, out), left for the caller to draw."""

    def __init__(self, members: int, in_f: int, out_f: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(members, out_f, in_f))
        self.bias = nn.Parameter(torch.zeros(members, out_f)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias)


class StackedLayerNorm(nn.Module):
    """``LayerNorm`` (eps 1e-6) with a scale and bias per member, (M, F)."""

    def __init__(self, members, features, eps=1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(members, features))
        self.bias = nn.Parameter(torch.zeros(members, features))

    def forward(self, x, train: bool = False):
        h = x.float()
        mean, var = _stats(h, -1)
        return _normalize(h, mean, var, self.eps, self.weight[:, None], self.bias[:, None]).to(x.dtype)


class StackedBatchNorm(nn.Module):
    """``BatchNorm`` per member on (..., M, N, F): each member's statistics
    over its rows (and the leading axes); parameters and running statistics
    (M, F). Honours ``models/qnet.py:frozen_statistics`` as BatchNorm does."""

    def __init__(self, members, features, momentum=0.99, eps=1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(members, features))
        self.bias = nn.Parameter(torch.zeros(members, features))
        self.register_buffer("mean", torch.zeros(members, features))
        self.register_buffer("var", torch.ones(members, features))
        self.frozen = False
        self.group = None

    def forward(self, x, train: bool):
        h = x.float()
        if train:
            mean, var = batch_moments(h, _lane_axes(h), self.group)
            if not self.frozen:
                with torch.no_grad():
                    m = self.momentum
                    self.mean.copy_(m * self.mean + (1 - m) * mean.reshape(self.mean.shape))
                    self.var.copy_(m * self.var + (1 - m) * var.reshape(self.var.shape))
        else:
            mean, var = self.mean[:, None], self.var[:, None]
        return _normalize(h, mean, var, self.eps, self.weight[:, None], self.bias[:, None]).to(x.dtype)


def _lane_axes(x: torch.Tensor):
    """Every axis of x (..., S, N, F) but the lane axis and the features."""
    return tuple(d for d in range(x.dim() - 1) if d != x.dim() - 3)


class StackedBatchRenorm(nn.Module):
    """``models/batch_renorm.py:BatchRenorm`` per lane on (..., S, N, F), as
    a vmapped flax ``BatchRenorm``: each lane's batch statistics over its
    rows (and the leading axes), and a running mean and var (S, F), an
    r_max, d_max and ``steps`` counter (S,) a lane, so each lane leaves its
    warm-up on its own count. Honours ``models/qnet.py:frozen_statistics``
    as BatchRenorm does (``steps`` too)."""

    def __init__(self, members, features, momentum=0.999, eps=0.001, r_max=3.0, d_max=5.0, warmup_steps=1000):
        super().__init__()
        self.momentum, self.eps, self.warmup_steps = momentum, eps, warmup_steps
        self.weight = nn.Parameter(torch.ones(members, features))
        self.bias = nn.Parameter(torch.zeros(members, features))
        self.register_buffer("mean", torch.zeros(members, features))
        self.register_buffer("var", torch.ones(members, features))
        self.register_buffer("r_max", torch.full((members,), r_max, dtype=torch.float32))
        self.register_buffer("d_max", torch.full((members,), d_max, dtype=torch.float32))
        self.register_buffer("steps", torch.zeros(members, dtype=torch.int32))
        self.frozen = False
        self.group = None

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if not train:
            mean, var = self.mean[:, None], self.var[:, None]
        else:
            mean, var, new_mean, new_var = renorm_train(x, self.mean, self.var, self.r_max, self.d_max, self.steps,
                                                        self.eps, self.momentum, self.warmup_steps, lanes=True,
                                                        group=self.group)
            if not self.frozen:
                with torch.no_grad():
                    self.mean.copy_(new_mean)
                    self.var.copy_(new_var)
                    self.steps.add_(1)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight[:, None]) + self.bias[:, None]


def lane_dense(
    in_f: int, out_f: int, generators: Sequence[torch.Generator], scale: float = 1.0, bias: bool = True
) -> StackedDense:
    """A ``StackedDense`` with lane i drawn as ``models/qnet.py:dense``
    draws from ``generators[i]``: flax's ``variance_scaling(scale, "fan_in",
    "truncated_normal")`` (lecun-normal at scale 1), zero biases."""
    layer = StackedDense(len(generators), in_f, out_f, bias)
    for w, g in zip(layer.weight, generators):
        variance_scaling_(w, in_f, scale, g)
    return layer


def lane_orthogonal(features: int, bias: bool, generators: Sequence[torch.Generator]) -> StackedDense:
    """A square ``StackedDense`` with lane i drawn as the recurrent cells'
    orthogonal init (models/rnn.py:_orthogonal_linear) from
    ``generators[i]``, zero biases."""
    layer = StackedDense(len(generators), features, features, bias)
    with torch.no_grad():
        for w, g in zip(layer.weight, generators):
            nn.init.orthogonal_(w, generator=g)
    return layer
