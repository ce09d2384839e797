"""Recurrent Q-network: a dense trunk, time-scanned GRU or LSTM layers with
reset-on-done, and the Q head.

Port of purejaxql_tpu/models/rnn.py (``ScannedRNN``, ``RNNQNetwork``) for
GRU and LSTM cells on a trunk of any NORM_TYPE the JAX module takes
(rnn.py:96-109): layer_norm, batch_norm, batch_renorm, and none for any
other value. flax conventions are kept so that weights cross between the
packages unchanged (core/checkpoint.py):

- the GRU cell is flax's ``GRUCell``, not ``torch.nn.GRU``: r and z take no
  hidden bias (``hr``, ``hz`` have none), and n = tanh(W_in x + b_in +
  r * (W_hn h + b_hn)); h' = (1 - z) * n + z * h;
- the LSTM cell is flax's ``OptimizedLSTMCell``: input kernels ``ii``,
  ``if``, ``ig``, ``io`` without bias, hidden kernels ``hi``, ``hf``,
  ``hg``, ``ho`` with one; gates i, f, g, o; c' = f * c + i * g,
  h' = o * tanh(c'); its carry is the pair (c, h);
- input kernels start lecun-normal, recurrent kernels orthogonal, biases
  zero; the carry starts at zero;
- ``ScannedRNN`` zeroes the carry wherever ``resets[t]`` is set, *before*
  the cell (rnn.py:50-55); the trainer passes the incoming done flag;
- the input norm, BatchNorm or (``input_norm_type="batch_renorm"``, the
  craftax family) BatchRenorm, is always built, and in train mode updates
  its running statistics even when NORM_INPUT=False (rnn.py:110-128);
- submodules carry flax's names, counted per class in construction order:
  the input norm ``BatchNorm_0`` or ``BatchRenorm_0``, built before the
  trunk's norms (rnn.py:114-128 against the lambdas at :96-109), so a
  batch_norm trunk over a BatchNorm input has ``BatchNorm_1..`` and a
  batch_renorm one over a BatchNorm input ``BatchRenorm_0..``; ``Dense_i``,
  ``LayerNorm_i``, ``ScannedRNN_l.GRUCell_0.{ir,iz,in,hr,hz,hn}``
  or ``ScannedRNN_l.OptimizedLSTMCell_0.{ii,if,ig,io,hi,hf,hg,ho}`` and the
  head ``Dense_<num_layers>``; a dueling head (rnn.py:146-151) is the value
  ``Dense_<num_layers>`` (one output) and the advantage
  ``Dense_<num_layers + 1>``, q = value + adv - mean(adv).

A BatchNorm or BatchRenorm trunk takes its statistics in train mode over
all T x B rows of the window (each lane's own with seeds), in eval mode
(the rollout's length-1 steps) reads its running statistics. The network
has no compute dtype: it ignores BF16_COMPUTE, as the JAX module does.

With ``seeds=S`` > 1 (NUM_SEEDS) every layer takes its stacked form
(models/stacked.py), lane i drawn from ``generator[i]`` as the single
network is from that generator, and ``forward`` takes and gives seed-major
rows: x (T, S * B, F), done and last_action (T, S * B), carries (S * B, H),
Q-values (T, S * B, A); inside, the lanes run as (T, S, B, .), what
``jax.vmap`` of the single network computes (a BatchRenorm input norm with
each lane's statistics and ``steps``). For one seed the network is the
single one.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from purejaxql_torch.models.qnet import Layers, add_named, variance_scaling_
from purejaxql_torch.models.stacked import lane_dense, lane_orthogonal, linear

LSTM_GATES = ("i", "f", "g", "o")


def _orthogonal_linear(
    features: int, bias: bool, generator: Optional[torch.Generator]
) -> nn.Linear:
    """A square ``nn.Linear`` with flax's ``orthogonal()`` recurrent init
    (the transpose of an orthogonal matrix is orthogonal) and a zero bias."""
    layer = torch.nn.utils.skip_init(nn.Linear, features, features, bias=bias)
    with torch.no_grad():
        nn.init.orthogonal_(layer.weight, generator=generator)
        if bias:
            layer.bias.zero_()
    return layer


def _recurrent(features: int, bias: bool, generator, seeds: int) -> nn.Module:
    """``_orthogonal_linear``, or with seeds its stacked form, lane i drawn
    from ``generator[i]``."""
    if seeds == 1:
        return _orthogonal_linear(features, bias, generator)
    return lane_orthogonal(features, bias, generator)


def _input_kernel(in_features: int, hidden_size: int, generator, seeds: int) -> nn.Module:
    """An LSTM gate's input kernel: lecun-normal, no bias (stacked with
    seeds)."""
    if seeds > 1:
        return lane_dense(in_features, hidden_size, generator, bias=False)
    layer = torch.nn.utils.skip_init(nn.Linear, in_features, hidden_size, bias=False)
    variance_scaling_(layer.weight, in_features, 1.0, generator)
    return layer


class GRUCell(nn.Module):
    """flax ``linen.GRUCell`` over (B, F) inputs and a (B, H) carry (with
    seeds, (S, B, F) and (S, B, H))."""

    def __init__(self, in_features: int, hidden_size: int, generator=None, seeds: int = 1):
        super().__init__()
        layers = Layers(generator, seeds)
        for gate in ("ir", "iz", "in"):
            self.add_module(gate, layers.dense(in_features, hidden_size))
        self.hr = _recurrent(hidden_size, False, generator, seeds)
        self.hz = _recurrent(hidden_size, False, generator, seeds)
        self.hn = _recurrent(hidden_size, True, generator, seeds)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        r = torch.sigmoid(self.ir(x) + self.hr(h))
        z = torch.sigmoid(self.iz(x) + self.hz(h))
        n = torch.tanh(getattr(self, "in")(x) + r * self.hn(h))
        return (1.0 - z) * n + z * h


class OptimizedLSTMCell(nn.Module):
    """flax ``linen.OptimizedLSTMCell`` over (B, F) inputs and a (c, h)
    carry of two (B, H) (with seeds, (S, B, .)). As flax does, the four
    gates' kernels are concatenated into one product for the input and one
    for the hidden state."""

    def __init__(self, in_features: int, hidden_size: int, generator=None, seeds: int = 1):
        super().__init__()
        for gate in LSTM_GATES:
            self.add_module(f"i{gate}", _input_kernel(in_features, hidden_size, generator, seeds))
        for gate in LSTM_GATES:
            self.add_module(f"h{gate}", _recurrent(hidden_size, True, generator, seeds))

    def forward(self, carry: Tuple[torch.Tensor, torch.Tensor], x: torch.Tensor):
        c, h = carry
        w_i = torch.cat([getattr(self, f"i{g}").weight for g in LSTM_GATES], -2)
        w_h = torch.cat([getattr(self, f"h{g}").weight for g in LSTM_GATES], -2)
        b_h = torch.cat([getattr(self, f"h{g}").bias for g in LSTM_GATES], -1)
        i, f, g, o = (linear(h, w_h, b_h) + linear(x, w_i)).chunk(4, -1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return c, torch.sigmoid(o) * torch.tanh(c)


class ScannedRNN(nn.Module):
    """One GRU or LSTM layer over the leading time axis, the carry (h, or
    the LSTM's (c, h)) zeroed wherever ``resets[t]`` is set."""

    def __init__(self, in_features: int, hidden_size: int, generator=None,
                 cell_type: str = "gru", seeds: int = 1):
        super().__init__()
        self.cell_type = cell_type
        if cell_type == "lstm":
            self.OptimizedLSTMCell_0 = OptimizedLSTMCell(in_features, hidden_size, generator, seeds)
        else:  # any other cell type is a GRU, as in rnn.py:57-60
            self.GRUCell_0 = GRUCell(in_features, hidden_size, generator, seeds)

    def forward(self, carry, x: torch.Tensor, resets: torch.Tensor):
        """carry (B, H) or (c, h), x (T, B, F), resets (T, B) -> (carry at
        T, ys (T, B, H)); with seeds B is (S, B)."""
        ys = []
        for t in range(x.shape[0]):
            reset = resets[t][..., None]
            if self.cell_type == "lstm":
                carry = self.OptimizedLSTMCell_0(
                    tuple(torch.where(reset, torch.zeros_like(v), v) for v in carry), x[t]
                )
                ys.append(carry[1])
            else:
                carry = self.GRUCell_0(torch.where(reset, torch.zeros_like(carry), carry), x[t])
                ys.append(carry)
        return carry, torch.stack(ys)


def map_carry(fn, hidden) -> list:
    """``fn`` over each layer's carry: (B, H), or an LSTM layer's (c, h)."""
    return [tuple(fn(v) for v in h) if isinstance(h, (tuple, list)) else fn(h) for h in hidden]


class RNNQNetwork(nn.Module):
    """Dense trunk -> (optional one-hot last action) -> GRU or LSTM stack ->
    Q head.

    ``forward(hidden, x, done, last_action, train)`` with time-major x
    (T, B, F), done and last_action (T, B), and ``hidden`` a list of per-layer
    carries, (B, H) for GRU and a (c, h) pair for LSTM; returns (new hidden
    list, q_vals (T, B, A)).
    """

    def __init__(
        self,
        obs_dim: int,
        action_dim: int,
        hidden_size: int = 512,
        num_layers: int = 2,
        num_rnn_layers: int = 1,
        cell_type: str = "gru",
        norm_input: bool = False,
        norm_type: str = "layer_norm",
        input_norm_type: str = "batch_norm",
        add_last_action: bool = False,
        dueling: bool = False,
        generator=None,
        seeds: int = 1,
    ):
        super().__init__()
        self.seeds = seeds
        self.action_dim = action_dim
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_rnn_layers = num_rnn_layers
        self.cell_type = cell_type
        self.norm_input = norm_input
        self.input_norm_type = input_norm_type
        self.add_last_action = add_last_action
        self.dueling = dueling
        self.norm_type = norm_type
        layers = Layers(generator, seeds)
        norm = layers.norm(input_norm_type, obs_dim)
        if input_norm_type == "batch_renorm":
            self.BatchRenorm_0 = norm
        else:
            self.BatchNorm_0 = norm
        counts = {"BatchRenorm" if input_norm_type == "batch_renorm" else "BatchNorm": 1}  # the input norm's
        self.norms = []
        width = obs_dim
        for i in range(num_layers):
            self.add_module(f"Dense_{i}", layers.dense(width, hidden_size))
            norm = layers.trunk_norm(norm_type, hidden_size)
            self.norms.append(norm and add_named(self, counts, *norm))
            width = hidden_size
        if add_last_action:
            width += action_dim
        for layer in range(num_rnn_layers):
            self.add_module(f"ScannedRNN_{layer}", ScannedRNN(width, hidden_size, generator, cell_type, seeds))
            width = hidden_size
        if dueling:
            self.add_module(f"Dense_{num_layers}", layers.dense(width, 1))
            self.add_module(f"Dense_{num_layers + 1}", layers.dense(width, action_dim))
        else:
            self.add_module(f"Dense_{num_layers}", layers.dense(width, action_dim))

    def initialize_carry(self, batch_size: int, device=None) -> list:
        """One zero carry a layer: (B, H), or a (c, h) pair for LSTM."""
        zeros = lambda: torch.zeros(batch_size, self.hidden_size, device=device)  # noqa: E731
        return [(zeros(), zeros()) if self.cell_type == "lstm" else zeros() for _ in range(self.num_rnn_layers)]

    def forward(
        self,
        hidden: Sequence,
        x: torch.Tensor,
        done: torch.Tensor,
        last_action: torch.Tensor,
        train: bool,
    ) -> Tuple[list, torch.Tensor]:
        if self.seeds == 1:
            return self._forward(hidden, x, done, last_action, train)
        lanes = lambda t, dim: t.unflatten(dim, (self.seeds, -1))  # noqa: E731
        new_hidden, q_vals = self._forward(
            map_carry(lambda h: lanes(h, 0), hidden), lanes(x, 1), lanes(done, 1), lanes(last_action, 1), train
        )
        return map_carry(lambda h: h.flatten(0, 1), new_hidden), q_vals.flatten(1, 2)

    def _forward(self, hidden, x, done, last_action, train):
        normed = self.input_norm(x, train)
        if self.norm_input:
            x = normed
        for i, norm in enumerate(self.norms):
            x = getattr(self, f"Dense_{i}")(x)
            if norm is not None:
                x = getattr(self, norm)(x, train)
            x = torch.relu(x)
        if self.add_last_action:
            one_hot = nn.functional.one_hot(last_action.long(), self.action_dim)
            x = torch.cat([x, one_hot.to(x.dtype)], -1)
        resets = done.bool()
        new_hidden = []
        for layer in range(self.num_rnn_layers):
            h, x = getattr(self, f"ScannedRNN_{layer}")(hidden[layer], x, resets)
            new_hidden.append(h)
        return new_hidden, self.head(x)

    def input_norm(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        """The input BatchNorm or BatchRenorm (``input_norm_type``)."""
        if self.input_norm_type == "batch_renorm":
            return self.BatchRenorm_0(x, train)
        return self.BatchNorm_0(x, train)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """The Q head: one Dense, or the dueling value + adv - mean(adv)."""
        if not self.dueling:
            return getattr(self, f"Dense_{self.num_layers}")(x)
        value = getattr(self, f"Dense_{self.num_layers}")(x)
        adv = getattr(self, f"Dense_{self.num_layers + 1}")(x)
        return value + adv - adv.mean(-1, keepdim=True)
