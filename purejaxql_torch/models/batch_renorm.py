"""Batch Renormalization (Ioffe, arXiv 1702.03275).

Port of purejaxql_tpu/models/batch_renorm.py, the normalizer the craftax
family uses where the gymnax family uses BatchNorm. In train mode the batch
statistics are corrected toward the running ones by clipped factors

    r = clip(sigma_batch / sigma_run, 1 / r_max, r_max)       (no gradient)
    d = clip((mu_batch - mu_run) / sigma_run, -d_max, d_max)  (no gradient)

once ``steps`` reaches ``warmup_steps``; before that it normalizes as
BatchNorm does while the running statistics build up. The state lives in the
buffers ``mean``, ``var``, ``r_max``, ``d_max`` and ``steps``, the leaf names
of the flax ``batch_stats`` collection, so weights cross between the
packages (core/checkpoint.py).

The arithmetic follows the JAX module's: the fast variance E[x^2] - E[x]^2
clamped at 0, the d-shift by sqrt(var) with no epsilon, the warm-up as a
float blend, and flax's ``_normalize`` order, (x - mean) * (rsqrt(var + eps)
* scale) + bias. Train mode updates the buffers in place, unless the module
is ``frozen`` (``models/qnet.py:frozen_statistics``): then it normalizes as
in train mode and leaves the buffers, ``steps`` included, as they were.

The module has no dtype (batch_renorm.py:31-129). On a bfloat16 input (a
trunk under BF16_COMPUTE) it computes as jnp does: the batch mean and E[x^2]
are float32 sums rounded to bfloat16, the variance, sqrt(var + eps) and the
(1 - momentum) * mean of the running update are rounded to bfloat16, each
Python constant first rounded to bfloat16 (a weak-typed scalar takes the
array's dtype); everything that meets the float32 running statistics, the
normalize included, is float32, so the module returns float32. The running
statistics stay float32.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def renorm_train(x, ra_mean, ra_var, r_max, d_max, steps, eps: float, momentum: float, warmup_steps: int,
                 lanes: bool = False, group=None):
    """One train-mode step of BatchRenorm on x, without its scale and bias:
    the (mean, var) x is normalized by, and the running (mean, var) after
    this step (detached). The batch statistics are over every axis but the
    features and are corrected toward the running ones by r and d (clipped,
    without gradient) once ``steps`` reaches ``warmup_steps``, as a float
    blend. With ``lanes``, x is (..., S, N, F) and the state has a leading
    seed axis, (S, F) and (S,): each lane's statistics over its own rows and
    the leading axes, against its own state, as under ``jax.vmap``. With a
    process ``group`` the batch mean and E[x^2] are all-reduce-meaned over
    it (one collective) before the variance is formed (batch_renorm.py:
    79-81)."""
    axes = tuple(d for d in range(x.dim() - 1) if not (lanes and d == x.dim() - 3))
    if x.dtype == torch.float32:
        const = lambda v: v  # noqa: E731
        batch_mean = x.mean(axes, keepdim=lanes)
        mean2 = (x * x).mean(axes, keepdim=lanes)
    else:  # jnp.mean: a float32 sum over the rows, divided, rounded to x's dtype
        const = lambda v: torch.tensor(v, dtype=x.dtype, device=x.device)  # noqa: E731
        n = x.numel() // math.prod(x.shape[d] for d in range(x.dim()) if d not in axes)
        batch_mean = (x.float().sum(axes, keepdim=lanes) / n).to(x.dtype)
        mean2 = ((x * x).float().sum(axes, keepdim=lanes) / n).to(x.dtype)
    if group is not None:
        from purejaxql_torch.parallel.mesh import pmean_moments

        batch_mean, mean2 = pmean_moments(batch_mean, mean2, group)
    batch_var = torch.clamp(mean2 - batch_mean * batch_mean, min=0.0)
    shape = batch_mean.shape  # (F,), or (1, ..., S, 1, F) with lanes
    per_lane = (lambda v: v.reshape(*shape[:-1], 1)) if lanes else (lambda v: v)  # noqa: E731
    with torch.no_grad():
        ra_std = torch.sqrt(ra_var.reshape(shape) + eps)
        r = torch.minimum(torch.maximum(torch.sqrt(batch_var + const(eps)) / ra_std, 1.0 / per_lane(r_max)),
                          per_lane(r_max))
        d = torch.minimum(torch.maximum((batch_mean - ra_mean.reshape(shape)) / ra_std, -per_lane(d_max)),
                          per_lane(d_max))
        warmed_up = (per_lane(steps) >= warmup_steps).float()
        new_mean = momentum * ra_mean + const(1 - momentum) * batch_mean.reshape(ra_mean.shape)
        new_var = momentum * ra_var + const(1 - momentum) * batch_var.reshape(ra_var.shape)
    # normalizing by (var / r^2, mean - d * std / r) applies x * r + d
    tmp_var = batch_var / (r ** 2)
    tmp_mean = batch_mean - d * torch.sqrt(batch_var) / r
    var = warmed_up * tmp_var + (1.0 - warmed_up) * batch_var
    mean = warmed_up * tmp_mean + (1.0 - warmed_up) * batch_mean
    return mean, var, new_mean, new_var


class BatchRenorm(nn.Module):
    def __init__(
        self,
        features: int,
        momentum: float = 0.999,
        eps: float = 0.001,
        r_max: float = 3.0,
        d_max: float = 5.0,
        warmup_steps: int = 1000,
    ):
        super().__init__()
        self.momentum, self.eps, self.warmup_steps = momentum, eps, warmup_steps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.register_buffer("r_max", torch.tensor(r_max, dtype=torch.float32))
        self.register_buffer("d_max", torch.tensor(d_max, dtype=torch.float32))
        self.register_buffer("steps", torch.zeros((), dtype=torch.int32))
        self.frozen = False
        self.group = None

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if not train:
            mean, var = self.mean, self.var
        else:
            mean, var, new_mean, new_var = renorm_train(x, self.mean, self.var, self.r_max, self.d_max, self.steps,
                                                        self.eps, self.momentum, self.warmup_steps,
                                                        group=self.group)
            if not self.frozen:
                with torch.no_grad():
                    self.mean.copy_(new_mean)
                    self.var.copy_(new_var)
                    self.steps.add_(1)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
