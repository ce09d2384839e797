"""The GRU time scan: two hand-written CUDA kernels (forward and backward),
their plain twins, the launch plan they share, and the
``torch.autograd.Function`` that joins them.

Counterpart of ``_gru_core`` in purejaxql_tpu/ops/fast_rnn.py:288-343, the
``jax.custom_vjp`` over the Pallas kernels ``_gru_fwd_kernel`` and
``_gru_bwd_kernel``. The kernels are ``csrc/gru_scan_fwd.cu`` and
``csrc/gru_scan_bwd.cu``; ``gru_scan_fwd_plain`` and ``gru_scan_bwd_plain``
repeat their arithmetic step for step in PyTorch.

Shapes (float32): xi (T, B, 3H) the hoisted input projections [r | z | n],
keep (T, B, 1) the 0/1 mask 1 - reset, h0 (B, H), w_h (H, 3H) =
[W_hr | W_hz | W_hn] in the (in, out) layout, b_hn (H,).

Both kernels run as thread-block clusters: ``scan_plan`` splits the H hidden
units over the C CTAs of a cluster and the B rows over clusters of R rows.
Each CTA keeps the 3U columns of W_h that belong to its U units on chip for
the whole scan (in registers where H <= 256, else in shared memory), and
the CTAs exchange each step's vectors through distributed shared memory:
the forward's h', the backward's parts of the carry. The backward reads
W_h as it is (no transposed copy) and is one launch while B <= R; with
several clusters a second, small launch adds their dW_h and db_hn partials
in cluster order.

``gru_scan_fwd`` and ``gru_scan_bwd`` take the plain twin only for CPU
tensors. For CUDA tensors they launch the kernel or raise; nothing falls
back. Each counts its launches in ``.launches`` (one a call).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

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


# shared memory a CTA may use on Hopper (227 KB of the SM's 256 KB)
SMEM_LIMIT = 232_448
CLUSTER_SIZES = (1, 2, 4, 8, 16)
# a unit's dot products run on 16 lanes, 2 units to a warp
# (csrc/gru_cluster.cuh kLanes, kUnitsPerWarp)
LANES = 16
UNITS_PER_WARP = 32 // LANES
# the plan's cluster gives a CTA at most this many units: on an H100 at
# (T 132, B 2, H 256) C 16 (16 units) ran both kernels faster than C 8 and
# C 4 (scripts/time_gru_scan.py, PERF.md section 6)
PLAN_UNITS = 16
# where H <= 256 and a CTA's 3 U columns are at most REG_COLUMNS, the slice
# sits in registers: in the forward a lane's 48 floats of its unit's rows
# (csrc/gru_scan_fwd.cu kRegQuads), in the backward W_h[k, the CTA's
# columns] and dW_h[k, those], one input unit k a thread (csrc/gru_scan_bwd.cu
# kRegColumns)
REG_COLUMNS = 48
# the resident kernels take at most 512 threads
RESIDENT_UNITS = 512 // 32 * UNITS_PER_WARP


class ScanPlan(NamedTuple):
    """How both scan kernels split one call (``scan_plan``)."""

    cluster: int  # C, CTAs in a cluster (cudaLaunchAttributeClusterDimension)
    units: int  # hidden units a CTA owns (the last CTA may own fewer)
    rows: int  # R, batch rows a cluster takes (a template of the kernels)
    clusters: int  # ceil(B / R)
    threads: int  # per CTA: a warp per 2 owned units, at most 1024 (>= H)
    resident: bool  # W_h's slice held on chip for the whole scan
    fwd_bytes: int  # dynamic shared memory a forward CTA takes
    bwd_bytes: int  # the same for the backward
    registers: bool  # the slice (and the backward's dW_h) in registers instead

    @property
    def smem_bytes(self) -> int:
        return max(self.fwd_bytes, self.bwd_bytes)


def _in_registers(H: int, units: int) -> bool:
    return H <= 256 and 3 * units <= REG_COLUMNS


def _pad(n: int) -> int:
    """n rounded up to a row the unit's lanes read 4 floats at a time."""
    return -(-n // (4 * LANES)) * (4 * LANES)


def _plan_bytes(H: int, cluster: int, units: int, rows: int, resident: bool) -> Tuple[int, int]:
    # both: an 8-byte mbarrier a slot of the exchange, two slots, padded to 16
    # forward: the slice unless it sits in registers, one zero-padded row of
    # H + 4 floats per (unit, gate), and the double-buffered reset carry
    # hbar (2, R, pad(H))
    in_smem = resident and not _in_registers(H, units)
    fwd = 16 + 4 * ((units * 3 * (_pad(H) + 4) if in_smem else 0) + 2 * rows * _pad(H))
    # backward: the slice, a row of W_h[k, the CTA's columns] per input unit
    # k (3 units padded to 4, then 4 apart in banks) unless it sits in
    # registers, the carry's parts in two slots (2, C, R, units), and da_cat
    # of the CTA's columns (R, 3 units padded to 4)
    cols = -(-3 * units // 4) * 4
    bwd = 16 + 4 * ((H * (cols + 4) if in_smem else 0) + -(-2 * cluster * rows * units // 4) * 4 + rows * cols)
    return fwd, bwd


@functools.lru_cache(maxsize=None)
def scan_plan(B: int, H: int, cluster: Optional[int] = None) -> ScanPlan:
    """The launch plan of the GRU scan kernels for B rows of H units.

    C is the smallest cluster in which every CTA owns at most 16 units (8
    warps), 16 at most, and none owns none (H 130: C 8, 17 units a CTA and
    11 in the last); ``cluster`` overrides it (for timing). R is the
    power of two >= min(B, 8), halved until the CTA's shared memory fits in
    227 KB with the slice resident: in registers where H <= 256 and 3 U <=
    48, else in shared memory. Where no R fits, or a CTA owns more than 32
    units (more than 512 threads), the slice is read from L2 every step
    instead. Raises if even that does not fit."""
    if B < 1 or H < 1:
        raise ValueError(f"scan_plan: B and H must be positive, got {B}, {H}")
    if cluster is None:
        # sizes that leave no CTA without units (the last one may own fewer)
        fits = [c for c in CLUSTER_SIZES if (c - 1) * -(-H // c) < H]
        cluster = next((c for c in fits if -(-H // c) <= PLAN_UNITS), fits[-1])
    elif cluster not in CLUSTER_SIZES:
        raise ValueError(f"scan_plan: cluster must be one of {CLUSTER_SIZES}, got {cluster}")
    units = -(-H // cluster)
    if (cluster - 1) * units >= H:
        raise ValueError(f"scan_plan: a cluster of {cluster} leaves a CTA without units at H {H}")
    top = 1 << (min(B, 8) - 1).bit_length()
    for resident in (units <= RESIDENT_UNITS, False):
        rows = top
        while rows > 1 and max(_plan_bytes(H, cluster, units, rows, resident)) > SMEM_LIMIT:
            rows //= 2
        fwd, bwd = _plan_bytes(H, cluster, units, rows, resident)
        if max(fwd, bwd) <= SMEM_LIMIT:
            return ScanPlan(
                cluster=cluster, units=units, rows=rows, clusters=-(-B // rows),
                threads=32 * min(-(-units // UNITS_PER_WARP), 32), resident=resident,
                fwd_bytes=fwd, bwd_bytes=bwd,
                registers=resident and _in_registers(H, units),
            )
    raise ValueError(f"scan_plan: H {H} does not fit a CTA's shared memory even with one row")


def _check(name: str, dev: torch.device, **tensors) -> None:
    for label, (x, shape) in tensors.items():
        if x.device != dev or x.dtype != torch.float32:
            raise ValueError(f"{name}: {label} must be float32 on {dev}, got {x.dtype} on {x.device}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous {shape}, got {tuple(x.shape)}")


@functools.lru_cache(maxsize=None)
def _function(name: str, n_pointers: int, n_ints: int):
    lib = build.load(name)
    fn = getattr(lib, f"{name}_f32")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * n_pointers + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
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
    plan = scan_plan(B, H)
    lib, fn = _function("gru_scan_fwd", 10, 10)
    with torch.cuda.device(xi.device):
        err = fn(
            xi.data_ptr(), keep.data_ptr(), h0.data_ptr(), w_h.data_ptr(), b_hn.data_ptr(),
            *(o.data_ptr() for o in outs), T, B, H, plan.cluster, plan.units, plan.rows,
            plan.threads, int(plan.resident), int(plan.registers), plan.fwd_bytes,
            torch.cuda.current_stream().cuda_stream,
        )
    build.check_launch(lib, err, "gru_scan_fwd")
    gru_scan_fwd.launches += 1
    return tuple(outs)


gru_scan_fwd.launches = 0


def gru_scan_bwd(keep, hprev, w_h, r, z, n, c, g_y, g_hT):
    """``gru_scan_bwd_plain`` for CPU tensors, the CUDA kernel
    (csrc/gru_scan_bwd.cu) for CUDA tensors: one launch that runs the
    reverse scan over W_h as it is (no transposed copy, no scratch) and sums
    dW_h and db_hn on chip. With several clusters (B > R) each writes its
    partial sums to scratch and a second launch adds them in cluster
    order."""
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
    plan = scan_plan(B, H)
    dxi = hprev.new_empty(T, B, 3 * H)
    dh0 = hprev.new_empty(B, H)
    dw_h = hprev.new_empty(H, 3 * H)
    db_hn = hprev.new_empty(H)
    parts = plan.clusters > 1
    dw_part = hprev.new_empty(plan.clusters, H, 3 * H) if parts else None
    db_part = hprev.new_empty(plan.clusters, H) if parts else None
    lib, fn = _function("gru_scan_bwd", 15, 10)
    with torch.cuda.device(hprev.device):
        err = fn(
            keep.data_ptr(), hprev.data_ptr(), w_h.data_ptr(), r.data_ptr(), z.data_ptr(),
            n.data_ptr(), c.data_ptr(), g_y.data_ptr(), g_hT.data_ptr(), dxi.data_ptr(),
            dh0.data_ptr(), dw_h.data_ptr(), db_hn.data_ptr(),
            dw_part.data_ptr() if parts else None, db_part.data_ptr() if parts else None,
            T, B, H, plan.cluster, plan.units, plan.rows, plan.threads, int(plan.resident),
            int(plan.registers), plan.bwd_bytes, torch.cuda.current_stream().cuda_stream,
        )
    build.check_launch(lib, err, "gru_scan_bwd")
    gru_scan_bwd.launches += 1
    return dxi, dh0, dw_h, db_hn


gru_scan_bwd.launches = 0


def active_clusters(name: str, plan: ScanPlan) -> int:
    """How many clusters of ``plan`` the card places at once for the kernel
    ``name`` ("gru_scan_fwd" or "gru_scan_bwd"), through
    ``<name>_active_clusters`` (cudaOccupancyMaxActiveClusters). More
    clusters than this run in more than one wave. Raises if the query
    fails."""
    lib = build.load(name)
    fn = getattr(lib, f"{name}_active_clusters")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 6
    smem = plan.fwd_bytes if name == "gru_scan_fwd" else plan.bwd_bytes
    active = fn(plan.cluster, plan.rows, plan.threads, int(plan.resident), int(plan.registers), smem)
    if active < 0:
        build.check_launch(lib, -active, name)
    return active


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
