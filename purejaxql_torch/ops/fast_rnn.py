"""The recurrent trainers' BPTT forward with hoisted input projections
(FAST_BPTT), and the GRU time scan through the CUDA kernels (PALLAS_BPTT).

Port of purejaxql_tpu/ops/fast_rnn.py. It recomputes the train-mode forward
of ``models/rnn.py:RNNQNetwork`` (layer_norm trunk, GRU or LSTM stack)
straight from the network's parameters, restructured so that:

- the input projections of a layer (three gates for GRU, four for LSTM) are
  one (T*B, F) x (F, 3H or 4H) product over the whole window (as the JAX
  package leaves it to XLA), and the head is one product too;
- the recurrence keeps only the per-step (B, H) x (H, 3H or 4H) product and
  the gate math: a Python loop over T in ``gru_layer_scan`` and
  ``lstm_layer_scan`` (a ``lax.scan`` in the JAX package, no Pallas kernel),
  or for GRU one launch of ``csrc/gru_scan_fwd.cu`` forward and one of
  ``csrc/gru_scan_bwd.cu`` backward in ``gru_layer_scan_kernel``
  (``ops/gru_scan.py:GRUScan``);
- the input norm's running statistics are updated and returned, as the JAX
  function returns ``new_batch_stats``: BatchNorm's with flax's rule,
  BatchRenorm's (the craftax family's) with its own (``_batch_renorm_train``).

``compute_dtype=torch.bfloat16`` (BF16_COMPUTE) takes the trunk's, the
projections' and the head's products with bfloat16 operands and float32
accumulation and result (``_mp_matmul``); gates, norms and the carries stay
float32. The GRU kernels' recurrence and their input projection stay float32,
as in the JAX package (fast_rnn.py:438, 346-368).

The functions take ``params`` and ``batch_stats`` as flat dicts in the
network's own names and layouts (``dict(network.named_parameters())`` and
``dict(network.named_buffers())``: ``Dense_0.weight`` is (out, in)).

With ``seeds=S`` > 1 (the NUM_SEEDS network, models/stacked.py) every
parameter and statistic carries a leading seed axis and the rows are
seed-major, x (T, S * B, F): the forward runs on (T, S, B, .), each product
one batched matmul over the seeds (``_mp_matmul``), each input-norm
statistic per seed (a BatchRenorm's ``steps`` too), and each GRU layer's
scan one launch of each kernel for all seeds (``gru_layer_scan_kernel``);
``compute_dtype`` as for one seed.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import torch

from purejaxql_torch.models.batch_renorm import renorm_train
from purejaxql_torch.models.qnet import batch_moments
from purejaxql_torch.models.rnn import LSTM_GATES, map_carry
from purejaxql_torch.models.stacked import lane_matmul
from purejaxql_torch.ops.gru_scan import GRUScan


def _layer_norm(x, scale, bias, eps=1e-6):
    mean = x.mean(-1, keepdim=True)
    var = torch.square(x - mean).mean(-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    return y * scale + bias


def _moments(x, lanes=False, group=None):
    """The mean and biased variance over every axis but the last; with
    ``lanes``, x (T, S, B, F), also but the seed axis, kept for
    broadcasting. With a process ``group`` the mean and E[x^2] are
    all-reduce-meaned over it (one collective) and the variance is
    E[x^2] - E[x]^2 clamped at 0, the global batch's."""
    axes = tuple(d for d in range(x.dim() - 1) if not (lanes and d == x.dim() - 3))
    if group is not None:
        mean, var = batch_moments(x, axes, group)
        return (mean, var) if lanes else (mean.reshape(-1), var.reshape(-1))
    mean = x.mean(axes, keepdim=lanes)
    return mean, torch.square(x - mean).mean(axes, keepdim=lanes)


def _batch_stats_update(mean, var, ra_mean, ra_var, momentum=0.99):
    """flax nn.BatchNorm's running-average update (train mode) from the
    batch's ``_moments``: EMA with ``momentum``."""
    mean, var = mean.detach(), var.detach()
    return (momentum * ra_mean + (1 - momentum) * mean.reshape(ra_mean.shape),
            momentum * ra_var + (1 - momentum) * var.reshape(ra_var.shape))


def _batch_norm_train(x, mean, var, scale, bias, eps=1e-5):
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def _mp_matmul(a, b, dtype=torch.float32):
    """a (..., K) @ b (K, N) (fast_rnn.py:50-62); for a stacked b (S, K, N),
    a (..., S, B, K), lane by lane in one batched product. For
    float32 the plain product. For bfloat16 the operands are rounded to bfloat16 and multiplied
    in float32: a product of two bfloat16 numbers is exact in float32, so
    this is the JAX package's bfloat16-operand product with float32
    accumulation and a float32 result (``preferred_element_type``), whose
    gradients come back through the casts rounded to bfloat16 as there."""
    if b.dim() == 3:
        return lane_matmul(a, b, dtype)
    if dtype == torch.float32:
        return torch.matmul(a, b)
    return torch.matmul(a.to(dtype).float(), b.to(dtype).float())


def _batch_renorm_train(x, scale, bias, stats, lanes=False, group=None):
    """Train-mode BatchRenorm and its new statistics (fast_rnn.py:84-123),
    the arithmetic of ``models/batch_renorm.py``: the fast variance
    E[x^2] - E[x]^2 clamped at 0, r and d clipped by r_max and d_max and
    without gradient, the correction blended in once ``steps`` reaches 1,000,
    the d-shift by sqrt(var) without epsilon. ``stats`` holds ``mean``,
    ``var``, ``r_max``, ``d_max`` and ``steps``; the returned ones are
    detached, ``steps`` one more. With ``lanes``, x (T, S, B, F) and each
    statistic with a leading seed axis: each lane's own (``jax.vmap``). With
    a process ``group``, the global batch's statistics (``renorm_train``)."""
    eps = 1e-3
    mean, var, new_mean, new_var = renorm_train(x, stats["mean"], stats["var"], stats["r_max"], stats["d_max"],
                                                stats["steps"], eps, 0.999, 1000, lanes, group)
    new_stats = {"mean": new_mean, "var": new_var, "r_max": stats["r_max"], "d_max": stats["d_max"],
                 "steps": stats["steps"] + 1}
    return (x - mean) * (torch.rsqrt(var + eps) * scale) + bias, new_stats


def _cell(params: Mapping[str, torch.Tensor], layer: int, cell_type: str) -> Dict[str, torch.Tensor]:
    prefix = f"ScannedRNN_{layer}.{'OptimizedLSTMCell_0' if cell_type == 'lstm' else 'GRUCell_0'}."
    return {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}


def gru_weights(cell: Mapping[str, torch.Tensor]):
    """(w_i (F, 3H), b_i (3H,), w_h (H, 3H), b_hn (H,)) of a GRU cell's
    params (``ir.weight``, ..., ``hn.bias``), gates in the order r, z, n and
    kernels in the (in, out) layout of fast_rnn.py:180-192 (with a leading
    seed axis where the cell is stacked)."""
    w_i = torch.cat([cell[f"{g}.weight"].mT for g in ("ir", "iz", "in")], -1)
    b_i = torch.cat([cell[f"{g}.bias"] for g in ("ir", "iz", "in")], -1)
    w_h = torch.cat([cell[f"{g}.weight"].mT for g in ("hr", "hz", "hn")], -1)
    return w_i, b_i, w_h, cell["hn.bias"]


def gru_layer_scan(x_seq, resets, h0, cell, compute_dtype=torch.float32):
    """One GRU layer over time with the input projections hoisted
    (fast_rnn.py:171-212). x_seq (T, B, F), resets (T, B) bool, h0 (B, H);
    returns (h_T, y_seq (T, B, H)); with seeds B is (S, B)."""
    w_i, b_i, w_h, b_hn = gru_weights(cell)
    H = w_h.shape[-2]
    xi_seq = _mp_matmul(x_seq, w_i, compute_dtype) + b_i
    h, ys = h0, []
    for t in range(x_seq.shape[0]):
        xi = xi_seq[t]
        h = torch.where(resets[t][..., None], torch.zeros_like(h), h)
        hh = _mp_matmul(h, w_h, compute_dtype)
        r = torch.sigmoid(xi[..., :H] + hh[..., :H])
        z = torch.sigmoid(xi[..., H:2 * H] + hh[..., H:2 * H])
        n = torch.tanh(xi[..., 2 * H:] + r * (hh[..., 2 * H:] + b_hn))
        h = (1.0 - z) * n + z * h
        ys.append(h)
    return h, torch.stack(ys)


def lstm_weights(cell: Mapping[str, torch.Tensor]):
    """(w_i (F, 4H), w_h (H, 4H), b_h (4H,)) of an LSTM cell's params
    (``ii.weight``, ..., ``ho.bias``), gates in the order i, f, g, o and
    kernels in the (in, out) layout of fast_rnn.py:137-149 (with a leading
    seed axis where the cell is stacked)."""
    w_i = torch.cat([cell[f"i{g}.weight"].mT for g in LSTM_GATES], -1)
    w_h = torch.cat([cell[f"h{g}.weight"].mT for g in LSTM_GATES], -1)
    b_h = torch.cat([cell[f"h{g}.bias"] for g in LSTM_GATES], -1)
    return w_i, w_h, b_h


def lstm_layer_scan(x_seq, resets, carry0, cell, compute_dtype=torch.float32):
    """One LSTM layer over time with the input projections hoisted
    (fast_rnn.py:126-168): one window-wide (T*B, F) x (F, 4H) product, then
    per step the carry zeroed where ``resets`` is set, one (B, H) x (H, 4H)
    product and the gate math. x_seq (T, B, F), resets (T, B), carry0 the
    pair (c, h) of (B, H); returns ((c_T, h_T), y_seq (T, B, H)); with
    seeds B is (S, B)."""
    w_i, w_h, b_h = lstm_weights(cell)
    xi_seq = _mp_matmul(x_seq, w_i, compute_dtype)
    keep = (1.0 - resets.to(torch.float32))[..., None]
    (c, h), ys = carry0, []
    for t in range(x_seq.shape[0]):
        c, h = c * keep[t], h * keep[t]
        i, f, g, o = (xi_seq[t] + (_mp_matmul(h, w_h, compute_dtype) + b_h)).chunk(4, -1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys.append(h)
    return (c, h), torch.stack(ys)


def gru_layer_scan_kernel(x_seq, resets, h0, cell):
    """Same contract as ``gru_layer_scan``, with the time recurrence, forward
    and backward, in the CUDA kernels (counterpart of
    ``gru_layer_scan_pallas``, fast_rnn.py:346-368). On CPU tensors the
    kernels' plain twins run. With seeds the kernels take the seed-major
    rows (T, S * B, .) and the stacked W_h (S, H, 3H) and b_hn (S, H): one
    launch of each for all seeds."""
    w_i, b_i, w_h, b_hn = gru_weights(cell)
    T, H = x_seq.shape[0], w_h.shape[-2]
    xi_seq = (_mp_matmul(x_seq, w_i) + b_i).reshape(T, -1, 3 * H).contiguous()
    keep = (1.0 - resets.to(torch.float32)).reshape(T, -1, 1).contiguous()
    h_T, y = GRUScan.apply(xi_seq, keep, h0.reshape(-1, H).contiguous(), w_h.contiguous(),
                           b_hn.reshape(*w_h.shape[:-2], H).contiguous())
    return h_T.reshape(h0.shape), y.reshape(*x_seq.shape[:-1], H)


def supports_fast_bptt(config) -> bool:
    """The families the JAX package's fast path covers (fast_rnn.py:371-387):
    a GRU or LSTM stack on a layer_norm trunk with a BatchNorm or BatchRenorm
    input norm and no dueling head; PALLAS_BPTT also needs GRU."""
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
    hidden: Sequence,
    x: torch.Tensor,
    done: torch.Tensor,
    last_action: torch.Tensor,
    *,
    num_layers: int,
    num_rnn_layers: int,
    action_dim: int,
    add_last_action: bool,
    norm_input: bool,
    cell_type: str = "gru",
    input_norm_type: str = "batch_norm",
    pallas: bool = False,
    compute_dtype: torch.dtype = torch.float32,
    seeds: int = 1,
    group=None,
) -> Tuple[list, torch.Tensor, Dict[str, torch.Tensor]]:
    """Train-mode forward of ``RNNQNetwork`` (fast_rnn.py:390-469). Returns
    (new_hidden, q_vals (T, B, A), new_batch_stats), the statistics detached
    and keyed by buffer name.

    x (T, B, F) obs, done (T, B), last_action (T, B) int, hidden a list of
    per-layer carries ((B, H), or (c, h) for ``cell_type="lstm"``);
    ``pallas`` runs each GRU layer's recurrence through the CUDA kernels
    (``gru_layer_scan_kernel``); ``compute_dtype`` as the module says. With
    ``seeds`` > 1 the params are stacked and every row axis B holds S * B
    seed-major rows, in and out. With a process ``group`` the input norm's
    statistics are the global batch's (``_moments``, ``renorm_train``),
    where the JAX function keeps them shard-local (fast_rnn.py:65-123).
    """
    lanes = seeds > 1
    if lanes:
        # the rows as (T, S, B, .) and the carries as (S, B, H); a stacked
        # vector parameter (S, F) broadcast over each lane's rows
        x, done, last_action = (t.unflatten(1, (seeds, -1)) for t in (x, done, last_action))
        hidden = map_carry(lambda h: h.unflatten(0, (seeds, -1)), hidden)
        params = {k: v[:, None] if v.dim() == 2 else v for k, v in params.items()}
    if input_norm_type == "batch_renorm":
        y, new_stats = _batch_renorm_train(
            x, params["BatchRenorm_0.weight"], params["BatchRenorm_0.bias"],
            {k: batch_stats[f"BatchRenorm_0.{k}"] for k in ("mean", "var", "r_max", "d_max", "steps")}, lanes,
            group,
        )
        if norm_input:
            x = y
        new_batch_stats = {f"BatchRenorm_0.{k}": v for k, v in new_stats.items()}
    else:
        mean, var = _moments(x, lanes, group)
        with torch.no_grad():
            new_mean, new_var = _batch_stats_update(
                mean, var, batch_stats["BatchNorm_0.mean"], batch_stats["BatchNorm_0.var"]
            )
        if norm_input:
            x = _batch_norm_train(x, mean, var, params["BatchNorm_0.weight"], params["BatchNorm_0.bias"])
        new_batch_stats = {"BatchNorm_0.mean": new_mean, "BatchNorm_0.var": new_var}

    for i in range(num_layers):
        x = _mp_matmul(x, params[f"Dense_{i}.weight"].mT, compute_dtype) + params[f"Dense_{i}.bias"]
        x = _layer_norm(x, params[f"LayerNorm_{i}.weight"], params[f"LayerNorm_{i}.bias"])
        x = torch.relu(x)

    if add_last_action:
        one_hot = torch.nn.functional.one_hot(last_action.long(), action_dim).to(x.dtype)
        x = torch.cat([x, one_hot], -1)

    resets = done.bool()
    new_hidden = []
    for layer in range(num_rnn_layers):
        cell = _cell(params, layer, cell_type)
        if cell_type == "lstm":
            carry_T, x = lstm_layer_scan(x, resets, hidden[layer], cell, compute_dtype)
        elif pallas:
            carry_T, x = gru_layer_scan_kernel(x, resets, hidden[layer], cell)
        else:
            carry_T, x = gru_layer_scan(x, resets, hidden[layer], cell, compute_dtype)
        new_hidden.append(carry_T)

    head_w, head_b = params[f"Dense_{num_layers}.weight"], params[f"Dense_{num_layers}.bias"]
    q_vals = _mp_matmul(x, head_w.mT, compute_dtype) + head_b
    if lanes:
        return map_carry(lambda h: h.flatten(0, 1), new_hidden), q_vals.flatten(1, 2), new_batch_stats
    return new_hidden, q_vals, new_batch_stats
