"""The recurrent trainer's BPTT forward with hoisted input projections
(FAST_BPTT), and the GRU time scan through the CUDA kernels (PALLAS_BPTT).

Port of the GRU half of purejaxql_tpu/ops/fast_rnn.py. It recomputes the
train-mode forward of ``models/rnn.py:RNNQNetwork`` (layer_norm trunk, GRU
stack) straight from the network's parameters, restructured so that:

- the three input projections of a GRU layer are one (T*B, F) x (F, 3H)
  product over the whole window (``torch.matmul``, as the JAX package leaves
  it to XLA), and the head is one product too;
- the recurrence keeps only the per-step (B, H) x (H, 3H) product and the
  gate math: a Python loop over T in ``gru_layer_scan``, or one launch of
  ``csrc/gru_scan_fwd.cu`` forward and one of ``csrc/gru_scan_bwd.cu``
  backward in ``gru_layer_scan_kernel`` (``ops/gru_scan.py:GRUScan``);
- the input BatchNorm's running statistics are updated with flax's rule and
  returned, as the JAX function returns ``new_batch_stats``.

The functions take ``params`` and ``batch_stats`` as flat dicts in the
network's own names and layouts (``dict(network.named_parameters())`` and
``dict(network.named_buffers())``: ``Dense_0.weight`` is (out, in)).
Float32 only; the LSTM and BatchRenorm branches and BF16_COMPUTE come with a
later slice (``models/factory.py:check_rnn_q_network`` refuses them).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import torch

from purejaxql_torch.ops.gru_scan import GRUScan


def _layer_norm(x, scale, bias, eps=1e-6):
    mean = x.mean(-1, keepdim=True)
    var = torch.square(x - mean).mean(-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    return y * scale + bias


def _moments(x):
    axes = tuple(range(x.dim() - 1))
    mean = x.mean(axes)
    return mean, torch.square(x - mean).mean(axes)


def _batch_stats_update(x, ra_mean, ra_var, momentum=0.99):
    """flax nn.BatchNorm's running-average update (train mode): statistics
    over every axis but the last, biased variance, EMA with ``momentum``."""
    mean, var = _moments(x)
    return momentum * ra_mean + (1 - momentum) * mean, momentum * ra_var + (1 - momentum) * var


def _batch_norm_train(x, scale, bias, eps=1e-5):
    mean, var = _moments(x)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def _cell(params: Mapping[str, torch.Tensor], layer: int) -> Dict[str, torch.Tensor]:
    prefix = f"ScannedRNN_{layer}.GRUCell_0."
    return {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}


def gru_weights(cell: Mapping[str, torch.Tensor]):
    """(w_i (F, 3H), b_i (3H,), w_h (H, 3H), b_hn (H,)) of a GRU cell's
    params (``ir.weight``, ..., ``hn.bias``), gates in the order r, z, n and
    kernels in the (in, out) layout of fast_rnn.py:180-192."""
    w_i = torch.cat([cell[f"{g}.weight"].t() for g in ("ir", "iz", "in")], 1)
    b_i = torch.cat([cell[f"{g}.bias"] for g in ("ir", "iz", "in")])
    w_h = torch.cat([cell[f"{g}.weight"].t() for g in ("hr", "hz", "hn")], 1)
    return w_i, b_i, w_h, cell["hn.bias"]


def gru_layer_scan(x_seq, resets, h0, cell):
    """One GRU layer over time with the input projections hoisted
    (fast_rnn.py:171-212). x_seq (T, B, F), resets (T, B) bool, h0 (B, H);
    returns (h_T, y_seq (T, B, H))."""
    w_i, b_i, w_h, b_hn = gru_weights(cell)
    H = w_h.shape[0]
    xi_seq = torch.matmul(x_seq, w_i) + b_i
    h, ys = h0, []
    for t in range(x_seq.shape[0]):
        xi = xi_seq[t]
        h = torch.where(resets[t][:, None], torch.zeros_like(h), h)
        hh = h @ w_h
        r = torch.sigmoid(xi[:, :H] + hh[:, :H])
        z = torch.sigmoid(xi[:, H:2 * H] + hh[:, H:2 * H])
        n = torch.tanh(xi[:, 2 * H:] + r * (hh[:, 2 * H:] + b_hn))
        h = (1.0 - z) * n + z * h
        ys.append(h)
    return h, torch.stack(ys)


def gru_layer_scan_kernel(x_seq, resets, h0, cell):
    """Same contract as ``gru_layer_scan``, with the time recurrence, forward
    and backward, in the CUDA kernels (counterpart of
    ``gru_layer_scan_pallas``, fast_rnn.py:346-368). On CPU tensors the
    kernels' plain twins run."""
    w_i, b_i, w_h, b_hn = gru_weights(cell)
    xi_seq = (torch.matmul(x_seq, w_i) + b_i).contiguous()
    keep = (1.0 - resets.to(torch.float32))[..., None].contiguous()
    return GRUScan.apply(xi_seq, keep, h0.contiguous(), w_h.contiguous(), b_hn.contiguous())


def supports_fast_bptt(config) -> bool:
    """The families the JAX package's fast path covers (fast_rnn.py:371-387):
    a GRU or LSTM stack on a layer_norm trunk with a BatchNorm or BatchRenorm
    input norm and no dueling head; PALLAS_BPTT also needs GRU. The port
    builds GRU on BatchNorm only, and its factory raises for the rest."""
    from purejaxql_torch.models.factory import resolve_norms

    norm_type, input_norm_type = resolve_norms(config)
    cell = config.get("RNN_CELL", "gru")
    if config.get("PALLAS_BPTT", False) and cell != "gru":
        return False
    return (
        cell in ("gru", "lstm")
        and norm_type == "layer_norm"
        and input_norm_type in ("batch_norm", "batch_renorm")
        and not config.get("DUELING", False)
    )


def fast_rnn_train_forward(
    params: Mapping[str, torch.Tensor],
    batch_stats: Mapping[str, torch.Tensor],
    hidden: Sequence[torch.Tensor],
    x: torch.Tensor,
    done: torch.Tensor,
    last_action: torch.Tensor,
    *,
    num_layers: int,
    num_rnn_layers: int,
    action_dim: int,
    add_last_action: bool,
    norm_input: bool,
    pallas: bool = False,
) -> Tuple[List[torch.Tensor], torch.Tensor, Dict[str, torch.Tensor]]:
    """Train-mode forward of ``RNNQNetwork`` (fast_rnn.py:390-469, the GRU
    branch with the BatchNorm input norm, in float32). Returns (new_hidden,
    q_vals (T, B, A), new_batch_stats), the statistics detached.

    x (T, B, F) obs, done (T, B), last_action (T, B) int, hidden a list of
    per-layer (B, H) carries; ``pallas`` runs each GRU layer's recurrence
    through the CUDA kernels (``gru_layer_scan_kernel``).
    """
    with torch.no_grad():
        new_mean, new_var = _batch_stats_update(
            x, batch_stats["BatchNorm_0.mean"], batch_stats["BatchNorm_0.var"]
        )
    if norm_input:
        x = _batch_norm_train(x, params["BatchNorm_0.weight"], params["BatchNorm_0.bias"])
    new_batch_stats = {"BatchNorm_0.mean": new_mean, "BatchNorm_0.var": new_var}

    for i in range(num_layers):
        x = torch.matmul(x, params[f"Dense_{i}.weight"].t()) + params[f"Dense_{i}.bias"]
        x = _layer_norm(x, params[f"LayerNorm_{i}.weight"], params[f"LayerNorm_{i}.bias"])
        x = torch.relu(x)

    if add_last_action:
        one_hot = torch.nn.functional.one_hot(last_action.long(), action_dim).to(x.dtype)
        x = torch.cat([x, one_hot], -1)

    resets = done.bool()
    scan = gru_layer_scan_kernel if pallas else gru_layer_scan
    new_hidden = []
    for layer in range(num_rnn_layers):
        h_T, x = scan(x, resets, hidden[layer], _cell(params, layer))
        new_hidden.append(h_T)

    head_w, head_b = params[f"Dense_{num_layers}.weight"], params[f"Dense_{num_layers}.bias"]
    q_vals = torch.matmul(x, head_w.t()) + head_b
    return new_hidden, q_vals, new_batch_stats
