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
"""

from __future__ import annotations

import torch
from torch import nn


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

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if not train:
            mean, var = self.mean, self.var
        else:
            axes = tuple(range(x.dim() - 1))
            batch_mean = x.mean(axes)
            batch_var = torch.clamp((x * x).mean(axes) - batch_mean * batch_mean, min=0.0)
            with torch.no_grad():
                std = torch.sqrt(batch_var + self.eps)
                ra_std = torch.sqrt(self.var + self.eps)
                r = torch.minimum(torch.maximum(std / ra_std, 1.0 / self.r_max), self.r_max)
                d = torch.minimum(torch.maximum((batch_mean - self.mean) / ra_std, -self.d_max), self.d_max)
                warmed_up = (self.steps >= self.warmup_steps).float()
            # normalizing by (var / r^2, mean - d * std / r) applies x * r + d
            tmp_var = batch_var / (r ** 2)
            tmp_mean = batch_mean - d * torch.sqrt(batch_var) / r
            var = warmed_up * tmp_var + (1.0 - warmed_up) * batch_var
            mean = warmed_up * tmp_mean + (1.0 - warmed_up) * batch_mean
            if not self.frozen:
                self._update(batch_mean, batch_var)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias

    @torch.no_grad()
    def _update(self, batch_mean: torch.Tensor, batch_var: torch.Tensor) -> None:
        m = self.momentum
        self.mean.copy_(m * self.mean + (1 - m) * batch_mean)
        self.var.copy_(m * self.var + (1 - m) * batch_var)
        self.steps.add_(1)
