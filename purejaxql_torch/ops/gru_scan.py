"""The GRU time scan: two hand-written CUDA kernels (forward and backward),
their plain twins, and the ``torch.autograd.Function`` that joins them.

Counterpart of ``_gru_core`` in purejaxql_tpu/ops/fast_rnn.py:288-343, the
``jax.custom_vjp`` over the Pallas kernels ``_gru_fwd_kernel`` and
``_gru_bwd_kernel``. The kernels are ``csrc/gru_scan_fwd.cu`` and
``csrc/gru_scan_bwd.cu``; ``gru_scan_fwd_plain`` and ``gru_scan_bwd_plain``
repeat their arithmetic step for step in PyTorch.

Shapes (float32): xi (T, B, 3H) the hoisted input projections [r | z | n],
keep (T, B, 1) the 0/1 mask 1 - reset, h0 (B, H), w_h (H, 3H) =
[W_hr | W_hz | W_hn] in the (in, out) layout, b_hn (H,).

``gru_scan_fwd`` and ``gru_scan_bwd`` take the plain twin only for CPU
tensors. For CUDA tensors they launch the kernel or raise; nothing falls
back. Each counts its launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from purejaxql_torch.ops import build


def gru_scan_fwd_plain(xi, keep, h0, w_h, b_hn):
    """Returns (y, r, z, n, c), each (T, B, H): the new hidden state and the
    gate residuals of every step (fast_rnn.py:224-245)."""
    H = h0.shape[-1]
    steps = []
    h = h0
    for t in range(xi.shape[0]):
        h = h * keep[t]
        hh = h @ w_h
        x = xi[t]
        r = torch.sigmoid(x[:, :H] + hh[:, :H])
        z = torch.sigmoid(x[:, H:2 * H] + hh[:, H:2 * H])
        c = hh[:, 2 * H:] + b_hn
        n = torch.tanh(x[:, 2 * H:] + r * c)
        h = (1.0 - z) * n + z * h
        steps.append((h, r, z, n, c))
    return tuple(torch.stack(s) for s in zip(*steps))


def gru_scan_bwd_plain(keep, hprev, w_h, r, z, n, c, g_y, g_hT):
    """Returns (dxi (T, B, 3H), dh0 (B, H), dw_h (H, 3H), db_hn (H,)) from
    the forward residuals and the cotangents g_y (T, B, H) and g_hT (B, H)
    (fast_rnn.py:248-285)."""
    T = keep.shape[0]
    dxi = g_y.new_empty(T, g_y.shape[1], 3 * g_y.shape[2])
    dw_h = torch.zeros_like(w_h)
    db_hn = w_h.new_zeros(w_h.shape[0])
    g = g_hT
    for t in range(T - 1, -1, -1):
        g = g + g_y[t]
        hbar = hprev[t] * keep[t]
        dn = g * (1.0 - z[t])
        dz = g * (hbar - n[t])
        da_n = dn * (1.0 - n[t] * n[t])
        dr = da_n * c[t]
        dc = da_n * r[t]
        da_r = dr * r[t] * (1.0 - r[t])
        da_z = dz * z[t] * (1.0 - z[t])
        da_cat = torch.cat([da_r, da_z, dc], -1)
        dxi[t] = torch.cat([da_r, da_z, da_n], -1)
        dhbar = g * z[t] + da_cat @ w_h.T
        dw_h += hbar.T @ da_cat
        db_hn += dc.sum(0)
        g = dhbar * keep[t]
    return dxi, g, dw_h, db_hn


def _check(name: str, dev: torch.device, **tensors) -> None:
    for label, (x, shape) in tensors.items():
        if x.device != dev or x.dtype != torch.float32:
            raise ValueError(f"{name}: {label} must be float32 on {dev}, got {x.dtype} on {x.device}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous {shape}, got {tuple(x.shape)}")


def _function(name: str, n_pointers: int):
    lib = build.load(name)
    fn = getattr(lib, f"{name}_f32")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * n_pointers + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return lib, fn


def _shapes(xi_or_hprev: torch.Tensor, h0_like: torch.Tensor):
    if xi_or_hprev.dim() != 3 or h0_like.dim() != 2:
        raise ValueError(
            f"gru_scan: expected (T, B, .) and (B, H), got {tuple(xi_or_hprev.shape)} "
            f"and {tuple(h0_like.shape)}"
        )
    T = xi_or_hprev.shape[0]
    B, H = h0_like.shape
    return T, B, H


def gru_scan_fwd(xi, keep, h0, w_h, b_hn):
    """``gru_scan_fwd_plain`` for CPU tensors, the CUDA kernel
    (csrc/gru_scan_fwd.cu) for CUDA tensors."""
    if xi.device.type == "cpu":
        return gru_scan_fwd_plain(xi, keep, h0, w_h, b_hn)
    if xi.device.type != "cuda":
        raise ValueError(f"gru_scan_fwd: unsupported device {xi.device}")
    T, B, H = _shapes(xi, h0)
    _check(
        "gru_scan_fwd", xi.device, xi=(xi, (T, B, 3 * H)), keep=(keep, (T, B, 1)),
        h0=(h0, (B, H)), w_h=(w_h, (H, 3 * H)), b_hn=(b_hn, (H,)),
    )
    outs = [xi.new_empty(T, B, H) for _ in range(5)]
    lib, fn = _function("gru_scan_fwd", 10)
    with torch.cuda.device(xi.device):
        err = fn(
            xi.data_ptr(), keep.data_ptr(), h0.data_ptr(), w_h.data_ptr(), b_hn.data_ptr(),
            *(o.data_ptr() for o in outs), T, B, H, torch.cuda.current_stream().cuda_stream,
        )
    build.check_launch(lib, err, "gru_scan_fwd")
    gru_scan_fwd.launches += 1
    return tuple(outs)


gru_scan_fwd.launches = 0


def gru_scan_bwd(keep, hprev, w_h, r, z, n, c, g_y, g_hT):
    """``gru_scan_bwd_plain`` for CPU tensors, the CUDA kernels
    (csrc/gru_scan_bwd.cu: the reverse scan, then the weight-gradient
    reduction) for CUDA tensors. The wrapper gives the kernel a transposed
    copy of W_h, (3H, H), a layout copy, so that its reads are coalesced."""
    if hprev.device.type == "cpu":
        return gru_scan_bwd_plain(keep, hprev, w_h, r, z, n, c, g_y, g_hT)
    if hprev.device.type != "cuda":
        raise ValueError(f"gru_scan_bwd: unsupported device {hprev.device}")
    T, B, H = _shapes(hprev, g_hT)
    seq = (T, B, H)
    _check(
        "gru_scan_bwd", hprev.device, keep=(keep, (T, B, 1)), hprev=(hprev, seq),
        w_h=(w_h, (H, 3 * H)), r=(r, seq), z=(z, seq), n=(n, seq), c=(c, seq),
        g_y=(g_y, seq), g_hT=(g_hT, (B, H)),
    )
    w_ht = w_h.t().contiguous()
    dxi = hprev.new_empty(T, B, 3 * H)
    dh0 = hprev.new_empty(B, H)
    dc = hprev.new_empty(T, B, H)
    dwb = hprev.new_empty(H + 1, 3 * H)
    lib, fn = _function("gru_scan_bwd", 13)
    with torch.cuda.device(hprev.device):
        err = fn(
            keep.data_ptr(), hprev.data_ptr(), w_ht.data_ptr(), r.data_ptr(), z.data_ptr(),
            n.data_ptr(), c.data_ptr(), g_y.data_ptr(), g_hT.data_ptr(), dxi.data_ptr(),
            dh0.data_ptr(), dc.data_ptr(), dwb.data_ptr(), T, B, H,
            torch.cuda.current_stream().cuda_stream,
        )
    build.check_launch(lib, err, "gru_scan_bwd")
    gru_scan_bwd.launches += 1
    return dxi, dh0, dwb[:H], dwb[H, 2 * H:]


gru_scan_bwd.launches = 0


class GRUScan(torch.autograd.Function):
    """``(h_T, y_seq) = GRUScan.apply(xi, keep, h0, w_h, b_hn)``: the GRU
    recurrence over T through ``gru_scan_fwd``, differentiated through
    ``gru_scan_bwd`` (``_gru_core``, fast_rnn.py:288-343). It saves
    keep, hprev, w_h, r, z, n and c as ``_gru_core_fwd`` does. A cotangent
    that autograd leaves undefined (the trainer's loss never reads h_T) is
    taken as zeros."""

    @staticmethod
    def forward(ctx, xi, keep, h0, w_h, b_hn) -> Tuple[torch.Tensor, torch.Tensor]:
        ctx.set_materialize_grads(False)
        y, r, z, n, c = gru_scan_fwd(xi, keep, h0, w_h, b_hn)
        hprev = torch.cat([h0[None], y[:-1]], 0)
        ctx.save_for_backward(keep, hprev, w_h, r, z, n, c)
        return y[-1].clone(), y

    @staticmethod
    def backward(ctx, g_hT: Optional[torch.Tensor], g_y: Optional[torch.Tensor]):
        keep, hprev, w_h, r, z, n, c = ctx.saved_tensors
        g_hT = torch.zeros_like(hprev[0]) if g_hT is None else g_hT.contiguous()
        g_y = torch.zeros_like(hprev) if g_y is None else g_y.contiguous()
        dxi, dh0, dw_h, db_hn = gru_scan_bwd(keep, hprev, w_h, r, z, n, c, g_y, g_hT)
        return dxi, None, dh0, dw_h, db_hn
