"""Deterministic actor, Q-critic and critic ensemble for continuous-control
PQN.

Port of purejaxql_tpu/models/actor_critic.py, with flax's conventions kept
so that weights cross between the packages unchanged (core/checkpoint.py):

- flax's auto-names (``BatchNorm_0`` for the input norm, ``Dense_i``,
  ``LayerNorm_i`` or ``BatchNorm_{i+1}``), LayerNorm eps 1e-6, BatchNorm eps
  1e-5 with momentum 0.99 (models/qnet.py);
- NORM_TYPE layer_norm or batch_norm gives the trunk its norms; any other
  value (none, batch_renorm, ...) gives no trunk norm, no module and no
  leaf, as JAX's ``_normalizer`` does (actor_critic.py:19-26);
- the input BatchNorm is always built and, in train mode, updates its
  running statistics though its output is unused (actor_critic.py:43-50,78-85:
  the JAX trainer never sets norm_input, so the port has no such option);
- Dense kernels start orthogonal, scaled by ``init_scale``, with zero biases;
- the actor's head is tanh(.) * action_scale + action_bias; the critic reads
  concat(obs, action), always uses relu, and squeezes its scalar head.

``CriticEnsemble`` is NUM_CRITICS independently initialized critics whose
parameters carry a leading member axis, as flax's vmapped init gives them
(``Dense_i.weight (M, out, in)``, ``LayerNorm_i.weight (M, H)``,
``BatchNorm_0`` params and statistics ``(M, F)``). It applies all members in
one pass, each dense layer one batched matmul over the member axis
(models/stacked.py).

With ``seeds=S`` > 1 (NUM_SEEDS) the actor holds S lanes with stacked
parameters (``Dense_i.weight (S, out, in)``) and the ensemble M * S members,
seed-major (seed s's M critics the s-th block), what ``jax.vmap`` over
seeds of the single networks holds; lane i is drawn from ``generator[i]``
as the single networks are drawn from that generator (the actor, then the
critics). Both take seed-major rows (S * N, ...): the actor gives (S * N,
action_dim), the ensemble (M, S * N), each row valued by its own seed's M
critics only.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from purejaxql_torch.models.qnet import Layers
from purejaxql_torch.models.stacked import StackedBatchNorm, StackedDense, StackedLayerNorm


def _orthogonal_lanes_(weight: torch.Tensor, scale: float, generator) -> None:
    """``orthogonal_`` for one generator, or for a list of S generators on a
    weight whose leading axis holds S seed-major blocks: block s from
    generator s."""
    if not isinstance(generator, (list, tuple)):
        orthogonal_(weight, scale, generator)
        return
    with torch.no_grad():
        for block, g in zip(weight.chunk(len(generator)), generator):
            orthogonal_(block, scale, g)


def orthogonal_(weight: torch.Tensor, scale: float, generator: Optional[torch.Generator]) -> None:
    """flax ``orthogonal(scale)`` in place for a torch-layout (out, in)
    weight, or for each member of a stacked (M, out, in) one: the (in, out)
    kernel has orthonormal columns when in >= out, else orthonormal rows."""
    out_f, in_f = weight.shape[-2:]
    rows, cols = max(in_f, out_f), min(in_f, out_f)
    with torch.no_grad():
        for w in weight.reshape(-1, out_f, in_f):
            a = torch.randn(rows, cols, generator=generator)
            q, r = torch.linalg.qr(a)
            q = q * torch.sign(torch.diagonal(r))
            w.copy_(scale * (q if in_f < out_f else q.T))


def _activation(name: str):
    if name not in ("relu", "tanh"):
        raise ValueError(f"unsupported ACTIVATION '{name}'")
    return torch.relu if name == "relu" else torch.tanh


class _MLP(nn.Module):
    """The input BatchNorm and the Dense -> norm -> activation stack with a
    linear head: the trunk the actor and the critic share; with ``seeds`` >
    1 every layer stacked, lane i drawn from ``generator[i]``, on (S, N, .)."""

    def __init__(self, in_dim, out_dim, hidden_sizes, activation, norm_type, init_scale, generator, seeds=1):
        super().__init__()
        self.hidden_sizes = tuple(hidden_sizes)
        self.norm_type = norm_type
        self.act = _activation(activation)
        self.seeds = seeds
        layers = Layers(generator, seeds)
        self.BatchNorm_0 = layers.norm("batch_norm", in_dim)
        width = in_dim
        for i, hs in enumerate(self.hidden_sizes + (out_dim,)):
            if seeds == 1:
                layer = torch.nn.utils.skip_init(nn.Linear, width, hs)
                with torch.no_grad():
                    layer.bias.zero_()
            else:
                layer = StackedDense(seeds, width, hs)
            _orthogonal_lanes_(layer.weight, init_scale, generator)
            self.add_module(f"Dense_{i}", layer)
            if i < len(self.hidden_sizes):
                if norm_type == "layer_norm":
                    self.add_module(f"LayerNorm_{i}", layers.layer_norm(hs))
                elif norm_type == "batch_norm":
                    self.add_module(f"BatchNorm_{i + 1}", layers.norm("batch_norm", hs))
            width = hs

    def trunk(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if self.seeds > 1:  # seed-major rows: each lane's (S, N, F)
            return self._trunk(x.unflatten(0, (self.seeds, -1)), train).flatten(0, 1)
        return self._trunk(x, train)

    def _trunk(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        self.BatchNorm_0(x, train)
        for i in range(len(self.hidden_sizes)):
            x = getattr(self, f"Dense_{i}")(x)
            if self.norm_type == "layer_norm":
                x = getattr(self, f"LayerNorm_{i}")(x)
            elif self.norm_type == "batch_norm":
                x = getattr(self, f"BatchNorm_{i + 1}")(x, train)
            x = self.act(x)
        return getattr(self, f"Dense_{len(self.hidden_sizes)}")(x)


class Actor(_MLP):
    def __init__(
        self,
        obs_dim: int,
        action_dim: int,
        action_scale: float,
        action_bias: float,
        hidden_sizes: Sequence[int],
        activation: str = "relu",
        norm_type: str = "layer_norm",
        init_scale: float = 1.0,
        generator=None,
        seeds: int = 1,
    ):
        super().__init__(obs_dim, action_dim, hidden_sizes, activation, norm_type, init_scale, generator, seeds)
        self.action_scale, self.action_bias = float(action_scale), float(action_bias)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return torch.tanh(self.trunk(x, train)) * self.action_scale + self.action_bias


class Critic(_MLP):
    def __init__(
        self,
        obs_dim: int,
        action_dim: int,
        hidden_sizes: Sequence[int],
        norm_type: str = "layer_norm",
        init_scale: float = 1.0,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(obs_dim + action_dim, 1, hidden_sizes, "relu", norm_type, init_scale, generator)

    def forward(self, obs: torch.Tensor, action: torch.Tensor, train: bool) -> torch.Tensor:
        return self.trunk(torch.cat([obs, action], -1), train).squeeze(-1)


class CriticEnsemble(nn.Module):
    """NUM_CRITICS critics with member-stacked parameters (flax's vmapped
    ``Critic`` tree), applied in one pass: ``forward`` takes (N, obs_dim)
    and (N, action_dim) and gives (M, N) values. With ``seeds`` > 1, M
    critics a seed (``lane_members``), seed s's the s-th block of the
    member axis: ``forward`` takes seed-major rows (S * N, .) and gives (M,
    S * N), each seed's rows through its own critics."""

    def __init__(
        self,
        num_critics: int,
        obs_dim: int,
        action_dim: int,
        hidden_sizes: Sequence[int],
        norm_type: str = "layer_norm",
        init_scale: float = 1.0,
        generator=None,
        seeds: int = 1,
    ):
        super().__init__()
        self.num_critics = num_critics
        self.seeds = seeds
        self.lane_members = num_critics if seeds > 1 else None
        M = num_critics * seeds
        self.hidden_sizes = tuple(hidden_sizes)
        self.norm_type = norm_type
        width = obs_dim + action_dim
        self.BatchNorm_0 = StackedBatchNorm(M, width)
        for i, hs in enumerate(self.hidden_sizes + (1,)):
            layer = StackedDense(M, width, hs)
            _orthogonal_lanes_(layer.weight, init_scale, generator)
            self.add_module(f"Dense_{i}", layer)
            if i < len(self.hidden_sizes):
                if norm_type == "layer_norm":
                    self.add_module(f"LayerNorm_{i}", StackedLayerNorm(M, hs))
                elif norm_type == "batch_norm":
                    self.add_module(f"BatchNorm_{i + 1}", StackedBatchNorm(M, hs))
            width = hs

    def forward(self, obs: torch.Tensor, action: torch.Tensor, train: bool) -> torch.Tensor:
        x = torch.cat([obs, action], -1)
        M, S = self.num_critics, self.seeds
        if S == 1:
            x = x.expand(M, *x.shape)
        else:  # each seed's rows to each of its M critics: (S * M, N, F)
            x = x.unflatten(0, (S, -1))[:, None].expand(S, M, -1, -1).flatten(0, 1)
        q = self._members(x, train)
        if S == 1:
            return q
        return q.unflatten(0, (S, M)).transpose(0, 1).flatten(1, 2)

    def _members(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        self.BatchNorm_0(x, train)
        for i in range(len(self.hidden_sizes)):
            x = getattr(self, f"Dense_{i}")(x)
            if self.norm_type == "layer_norm":
                x = getattr(self, f"LayerNorm_{i}")(x)
            elif self.norm_type == "batch_norm":
                x = getattr(self, f"BatchNorm_{i + 1}")(x, train)
            x = torch.relu(x)
        return getattr(self, f"Dense_{len(self.hidden_sizes)}")(x).squeeze(-1)
