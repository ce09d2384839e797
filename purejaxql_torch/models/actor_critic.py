"""Deterministic actor, Q-critic and critic ensemble for continuous-control
PQN.

Port of purejaxql_tpu/models/actor_critic.py, with flax's conventions kept
so that weights cross between the packages unchanged (core/checkpoint.py):

- flax's auto-names (``BatchNorm_0`` for the input norm, ``Dense_i``,
  ``LayerNorm_i`` or ``BatchNorm_{i+1}``), LayerNorm eps 1e-6, BatchNorm eps
  1e-5 with momentum 0.99 (models/qnet.py);
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
one pass, each dense layer one batched matmul over the member axis.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from purejaxql_torch.models.qnet import BatchNorm, LayerNorm, _normalize, _stats


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
    linear head: the trunk the actor and the critic share."""

    def __init__(self, in_dim, out_dim, hidden_sizes, activation, norm_type, init_scale, generator):
        super().__init__()
        if norm_type not in ("layer_norm", "batch_norm", "none"):
            raise ValueError(f"unsupported NORM_TYPE '{norm_type}'")
        self.hidden_sizes = tuple(hidden_sizes)
        self.norm_type = norm_type
        self.act = _activation(activation)
        self.BatchNorm_0 = BatchNorm(in_dim)
        width = in_dim
        for i, hs in enumerate(self.hidden_sizes + (out_dim,)):
            layer = torch.nn.utils.skip_init(nn.Linear, width, hs)
            orthogonal_(layer.weight, init_scale, generator)
            with torch.no_grad():
                layer.bias.zero_()
            self.add_module(f"Dense_{i}", layer)
            if i < len(self.hidden_sizes):
                if norm_type == "layer_norm":
                    self.add_module(f"LayerNorm_{i}", LayerNorm(hs))
                elif norm_type == "batch_norm":
                    self.add_module(f"BatchNorm_{i + 1}", BatchNorm(hs))
            width = hs

    def trunk(self, x: torch.Tensor, train: bool) -> torch.Tensor:
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
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(obs_dim, action_dim, hidden_sizes, activation, norm_type, init_scale, generator)
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


class StackedDense(nn.Module):
    """M dense layers applied to (M, N, in) in one batched matmul; each
    member's weight drawn orthogonal on its own."""

    def __init__(self, members, in_f, out_f, init_scale, generator):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(members, out_f, in_f))
        self.bias = nn.Parameter(torch.zeros(members, out_f))
        orthogonal_(self.weight, init_scale, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.baddbmm(self.bias[:, None, :], x, self.weight.transpose(1, 2))


class StackedLayerNorm(nn.Module):
    """``LayerNorm`` (eps 1e-6) with a scale and bias per member, (M, F)."""

    def __init__(self, members, features, eps=1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(members, features))
        self.bias = nn.Parameter(torch.zeros(members, features))

    def forward(self, x):
        mean, var = _stats(x, -1)
        return _normalize(x, mean, var, self.eps, self.weight[:, None], self.bias[:, None])


class StackedBatchNorm(nn.Module):
    """``BatchNorm`` per member on (M, N, F): statistics over N; parameters
    and running statistics (M, F)."""

    def __init__(self, members, features, momentum=0.99, eps=1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(members, features))
        self.bias = nn.Parameter(torch.zeros(members, features))
        self.register_buffer("mean", torch.zeros(members, features))
        self.register_buffer("var", torch.ones(members, features))

    def forward(self, x, train: bool):
        if train:
            mean, var = _stats(x, 1)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean[:, 0])
                self.var.copy_(m * self.var + (1 - m) * var[:, 0])
        else:
            mean, var = self.mean[:, None], self.var[:, None]
        return _normalize(x, mean, var, self.eps, self.weight[:, None], self.bias[:, None])


class CriticEnsemble(nn.Module):
    """NUM_CRITICS critics with member-stacked parameters (flax's vmapped
    ``Critic`` tree), applied in one pass: ``forward`` takes (N, obs_dim)
    and (N, action_dim) and gives (M, N) values."""

    def __init__(
        self,
        num_critics: int,
        obs_dim: int,
        action_dim: int,
        hidden_sizes: Sequence[int],
        norm_type: str = "layer_norm",
        init_scale: float = 1.0,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if norm_type not in ("layer_norm", "batch_norm", "none"):
            raise ValueError(f"unsupported NORM_TYPE '{norm_type}'")
        M = self.num_critics = num_critics
        self.hidden_sizes = tuple(hidden_sizes)
        self.norm_type = norm_type
        width = obs_dim + action_dim
        self.BatchNorm_0 = StackedBatchNorm(M, width)
        for i, hs in enumerate(self.hidden_sizes + (1,)):
            self.add_module(f"Dense_{i}", StackedDense(M, width, hs, init_scale, generator))
            if i < len(self.hidden_sizes):
                if norm_type == "layer_norm":
                    self.add_module(f"LayerNorm_{i}", StackedLayerNorm(M, hs))
                elif norm_type == "batch_norm":
                    self.add_module(f"BatchNorm_{i + 1}", StackedBatchNorm(M, hs))
            width = hs

    def forward(self, obs: torch.Tensor, action: torch.Tensor, train: bool) -> torch.Tensor:
        x = torch.cat([obs, action], -1)
        x = x.expand(self.num_critics, *x.shape)
        self.BatchNorm_0(x, train)
        for i in range(len(self.hidden_sizes)):
            x = getattr(self, f"Dense_{i}")(x)
            if self.norm_type == "layer_norm":
                x = getattr(self, f"LayerNorm_{i}")(x)
            elif self.norm_type == "batch_norm":
                x = getattr(self, f"BatchNorm_{i + 1}")(x, train)
            x = torch.relu(x)
        return getattr(self, f"Dense_{len(self.hidden_sizes)}")(x).squeeze(-1)
