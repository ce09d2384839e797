"""Optimizer: global-norm clip followed by RAdam, the PQN default.

Written to optax's formulas (``optax.chain(clip_by_global_norm(max_norm),
radam(lr))``), not ``torch.optim.RAdam``, which places eps differently:

- clip: ``g * max_norm / ||g||`` when ``||g|| >= max_norm``;
- RAdam: b1 0.9, b2 0.999, eps 1e-8 added to ``sqrt(nu_hat)``, eps_root 0,
  rectification threshold 5.0 on rho;
- the learning-rate schedule is read at the count *before* the increment,
  as ``optax.scale_by_schedule`` does.

With ``seeds=S`` > 1 every parameter's leading axis holds S seed-major
blocks (the NUM_SEEDS networks, models/stacked.py: one lane a seed, or the
critic ensemble's M members a seed) and the clip takes each seed's own
global norm, as optax's ``clip_by_global_norm`` under ``jax.vmap`` does;
RAdam's moments are elementwise and its count is shared by every lane, so
nothing else changes. One seed runs the single-seed update as it is.

With a process ``group`` (the sharded trainers, parallel/spmd.py) each step
all-reduce-means the gradients over it before the clip, so every rank
takes the global batch's step and the replicas stay in lockstep.

The step count is a host integer, so every scalar of the update (bias
corrections, rho, the rectifier, the step size) is computed on the host in
float32 with optax's order of operations; only the per-element work runs on
the device, with no host sync.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Union

import numpy as np
import torch


def _f32_pow(base: float, count: int) -> np.float32:
    # float32 base raised in float64 and rounded once: what XLA's float32
    # pow gives for the bias corrections, to the last bit in practice
    return np.float32(np.float64(np.float32(base)) ** count)


class ClipRAdam:
    """``clip_by_global_norm`` -> ``radam`` over a fixed list of tensors."""

    def __init__(
        self,
        params: Sequence[torch.Tensor],
        max_grad_norm: float,
        learning_rate: Union[float, Callable[[int], float]],
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        threshold: float = 5.0,
        seeds: int = 1,
        group=None,
    ):
        self.params: List[torch.Tensor] = list(params)
        self.seeds = seeds
        self.group = group
        self.max_grad_norm = float(max_grad_norm)
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps, self.threshold = b1, b2, eps, threshold
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def state_dict(self) -> dict:
        """The optimizer's state: its step ``count`` and the first and
        second moments ``mu`` and ``nu``, one tensor a parameter in the
        order of ``params``."""
        return {"count": self.count, "mu": list(self.mu), "nu": list(self.nu)}

    def load_state_dict(self, state: dict) -> None:
        """Restore a ``state_dict``: the moments are copied into tensors on
        the parameters' devices and dtypes."""
        if not len(state["mu"]) == len(state["nu"]) == len(self.params):
            raise ValueError(f"{len(state['mu'])} moments for {len(self.params)} parameters")
        self.count = int(state["count"])
        self.mu = [torch.as_tensor(m).to(p).clone() for m, p in zip(state["mu"], self.params)]
        self.nu = [torch.as_tensor(v).to(p).clone() for v, p in zip(state["nu"], self.params)]

    def _lr(self, count: int) -> float:
        lr = self.learning_rate
        return lr(count) if callable(lr) else lr

    @torch.no_grad()
    def clip(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        if self.seeds > 1:
            # each seed's norm over all its leaves' elements: (S,)
            S = self.seeds
            g_norm = torch.linalg.vector_norm(torch.cat([g.reshape(S, -1) for g in grads], 1), dim=1)
        else:
            g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        factor = torch.where(
            g_norm < self.max_grad_norm,
            torch.ones_like(g_norm),
            self.max_grad_norm / g_norm,
        )
        if self.seeds > 1:
            return [(g.reshape(self.seeds, -1) * factor[:, None]).reshape(g.shape) for g in grads]
        return torch._foreach_mul(grads, factor)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        """Apply one update from ``grads`` (one tensor per parameter). With a
        process ``group`` the gradients are first all-reduce-meaned over it
        in place, one collective (pqn.py:547-548: pmean, then clip)."""
        b1, b2 = self.b1, self.b2
        if self.group is not None:
            from purejaxql_torch.parallel.mesh import pmean_

            pmean_(grads, self.group)
        grads = self.clip(grads)

        # moments: (1 - b) * g**order + b * m
        mu = torch._foreach_mul(grads, 1.0 - b1)
        torch._foreach_add_(mu, torch._foreach_mul(self.mu, b1))
        nu = torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2)
        torch._foreach_add_(nu, torch._foreach_mul(self.nu, b2))
        self.mu, self.nu = mu, nu

        step_size = np.float32(-1.0) * np.float32(self._lr(self.count))
        self.count += 1
        count = self.count
        one = np.float32(1.0)
        b2t = _f32_pow(b2, count)
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        ro = np.float32(ro_inf) - (np.float32(2 * count) * b2t) / (one - b2t)
        mu_hat = torch._foreach_div(mu, float(one - _f32_pow(b1, count)))
        nu_hat = torch._foreach_div(nu, float(one - b2t))
        if ro >= self.threshold:
            num = (ro - np.float32(4.0)) * (ro - np.float32(2.0)) * np.float32(ro_inf)
            den = np.float32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro
            r = np.sqrt(num / den)
            updates = torch._foreach_mul(mu_hat, float(r))
            denom = torch._foreach_sqrt(nu_hat)
            torch._foreach_add_(denom, self.eps)
            torch._foreach_div_(updates, denom)
        else:
            updates = mu_hat
        torch._foreach_mul_(updates, float(step_size))
        torch._foreach_add_(self.params, updates)


def make_optimizer(params, max_grad_norm: float, learning_rate, seeds: int = 1, group=None) -> ClipRAdam:
    return ClipRAdam(params, max_grad_norm, learning_rate, seeds=seeds, group=group)
