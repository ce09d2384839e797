"""Recurrent Q-network: a dense trunk, time-scanned GRU layers with
reset-on-done, and the Q head.

Port of purejaxql_tpu/models/rnn.py (``ScannedRNN``, ``RNNQNetwork``) for
GRU cells. flax conventions are kept so that weights cross between the
packages unchanged (core/checkpoint.py):

- the cell is flax's ``GRUCell``, not ``torch.nn.GRU``: r and z take no
  hidden bias (``hr``, ``hz`` have none), and n = tanh(W_in x + b_in +
  r * (W_hn h + b_hn)); h' = (1 - z) * n + z * h;
- input kernels start lecun-normal, recurrent kernels orthogonal, biases
  zero; the carry starts at zero;
- ``ScannedRNN`` zeroes the carry wherever ``resets[t]`` is set, *before*
  the cell (rnn.py:50-55); the trainer passes the incoming done flag;
- the input BatchNorm is always built, and in train mode updates its
  running statistics even when NORM_INPUT=False (rnn.py:121-128);
- submodules carry flax's names: ``BatchNorm_0``, ``Dense_i``,
  ``LayerNorm_i``, ``ScannedRNN_l.GRUCell_0.{ir,iz,in,hr,hz,hn}`` and the
  head ``Dense_<num_layers>``; a dueling head (rnn.py:146-151) is the value
  ``Dense_<num_layers>`` (one output) and the advantage
  ``Dense_<num_layers + 1>``, q = value + adv - mean(adv).

LSTM cells, other trunk norms and a BatchRenorm input norm come with later
slices; the factory raises for them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from purejaxql_torch.models.qnet import BatchNorm, LayerNorm, dense


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


class GRUCell(nn.Module):
    """flax ``linen.GRUCell`` over (B, F) inputs and a (B, H) carry."""

    def __init__(self, in_features: int, hidden_size: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        for gate in ("ir", "iz", "in"):
            self.add_module(gate, dense(in_features, hidden_size, generator))
        self.hr = _orthogonal_linear(hidden_size, False, generator)
        self.hz = _orthogonal_linear(hidden_size, False, generator)
        self.hn = _orthogonal_linear(hidden_size, True, generator)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        r = torch.sigmoid(self.ir(x) + self.hr(h))
        z = torch.sigmoid(self.iz(x) + self.hz(h))
        n = torch.tanh(getattr(self, "in")(x) + r * self.hn(h))
        return (1.0 - z) * n + z * h


class ScannedRNN(nn.Module):
    """One GRU layer over the leading time axis, the carry zeroed wherever
    ``resets[t]`` is set."""

    def __init__(self, in_features: int, hidden_size: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.GRUCell_0 = GRUCell(in_features, hidden_size, generator)

    def forward(
        self, h: torch.Tensor, x: torch.Tensor, resets: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """h (B, H), x (T, B, F), resets (T, B) -> (h_T, ys (T, B, H))."""
        ys = []
        for t in range(x.shape[0]):
            h = torch.where(resets[t][:, None], torch.zeros_like(h), h)
            h = self.GRUCell_0(h, x[t])
            ys.append(h)
        return h, torch.stack(ys)


class RNNQNetwork(nn.Module):
    """Dense trunk -> (optional one-hot last action) -> GRU stack -> Q head.

    ``forward(hidden, x, done, last_action, train)`` with time-major x
    (T, B, F), done and last_action (T, B), and ``hidden`` a list of per-layer
    (B, H) carries; returns (new hidden list, q_vals (T, B, A)).
    """

    def __init__(
        self,
        obs_dim: int,
        action_dim: int,
        hidden_size: int = 512,
        num_layers: int = 2,
        num_rnn_layers: int = 1,
        norm_input: bool = False,
        add_last_action: bool = False,
        dueling: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.action_dim = action_dim
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_rnn_layers = num_rnn_layers
        self.norm_input = norm_input
        self.add_last_action = add_last_action
        self.dueling = dueling
        self.BatchNorm_0 = BatchNorm(obs_dim)
        width = obs_dim
        for i in range(num_layers):
            self.add_module(f"Dense_{i}", dense(width, hidden_size, generator))
            self.add_module(f"LayerNorm_{i}", LayerNorm(hidden_size))
            width = hidden_size
        if add_last_action:
            width += action_dim
        for layer in range(num_rnn_layers):
            self.add_module(f"ScannedRNN_{layer}", ScannedRNN(width, hidden_size, generator))
            width = hidden_size
        if dueling:
            self.add_module(f"Dense_{num_layers}", dense(width, 1, generator))
            self.add_module(f"Dense_{num_layers + 1}", dense(width, action_dim, generator))
        else:
            self.add_module(f"Dense_{num_layers}", dense(width, action_dim, generator))

    def initialize_carry(self, batch_size: int, device=None) -> List[torch.Tensor]:
        return [
            torch.zeros(batch_size, self.hidden_size, device=device)
            for _ in range(self.num_rnn_layers)
        ]

    def forward(
        self,
        hidden: Sequence[torch.Tensor],
        x: torch.Tensor,
        done: torch.Tensor,
        last_action: torch.Tensor,
        train: bool,
    ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        normed = self.BatchNorm_0(x, train)
        if self.norm_input:
            x = normed
        for i in range(self.num_layers):
            x = getattr(self, f"LayerNorm_{i}")(getattr(self, f"Dense_{i}")(x))
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

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """The Q head: one Dense, or the dueling value + adv - mean(adv)."""
        if not self.dueling:
            return getattr(self, f"Dense_{self.num_layers}")(x)
        value = getattr(self, f"Dense_{self.num_layers}")(x)
        adv = getattr(self, f"Dense_{self.num_layers + 1}")(x)
        return value + adv - adv.mean(-1, keepdim=True)
