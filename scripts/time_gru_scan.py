#!/usr/bin/env python3
"""Time the GRU scan kernels (csrc/gru_scan_fwd.cu, csrc/gru_scan_bwd.cu) on
one GPU, with CUDA events, at the recurrent trainers' shapes.

    python scripts/time_gru_scan.py
    python scripts/time_gru_scan.py --parent-csrc build/parent_csrc --out build/gru_times.json

1. the kernels through their wrappers (``ops/gru_scan.py``) at (T, B, H) =
   (132, 2, 256) and (68, 2, 256), the recurrent trainer's windows, (29,
   48, 256) and (68, 80, 256), the VDN trainer's on Spread and SMAX (agents
   x envs rows), and at (132, 2, 512), each plan printed with the clusters
   the card places at once, each result checked against the twins (forward
   1e-5, backward 1e-4); beside the CUDA-event time through the wrapper,
   the time on the device (torch.profiler: every kernel a call launches,
   the backward's partial sums included, summed and divided by the calls);
2. the same at (132, 2, 256) with the cluster forced to 4, 8 and 16 CTAs
   (``scan_plan(B, H, cluster)``): at 4 and 8 a CTA owns 64 or 32 units,
   too many for the slice in registers, so those run the kernels' shared
   memory (C 8) or L2 (C 4) paths;
3. ``torch.nn.GRU`` (cuDNN) forward, and forward plus backward, at T 132,
   B 2, H 256 and at T 29, B 48, H 256: a yardstick only (no resets, its own
   input projection), which the port never calls;
4. with ``--parent-csrc DIR``: an earlier version of the two kernels, built
   from DIR/gru_scan_fwd.cu and DIR/gru_scan_bwd.cu with the same nvcc flags
   and called as that version's wrapper called them (the backward with a
   transposed copy of W_h, a dc scratch and the (H + 1, 3H) weight-gradient
   output), timed in turns with the current ones: old, new, new, old. Its C
   entry points are the ones of the version before the cluster redesign.

Prints one JSON line per timing and one summary object as the last line,
with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# the recurrent trainers' shapes (VDN's B = agents x NUM_ENVS /
# NUM_MINIBATCHES), and the largest H whose slice stays in shared memory (no
# trainer's; the kernels' general path)
SHAPES = ((132, 2, 256), (68, 2, 256), (29, 48, 256), (68, 80, 256), (132, 2, 512))
# where the cuDNN yardstick is timed
CUDNN_SHAPES = ((132, 2, 256), (29, 48, 256))


def cuda_time_ms(fn, iters: int, warmup: int = 5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def gru_inputs(T: int, B: int, H: int, seed: int, dev):
    """xi ~ N(0, 1), keep with about 20 % resets, h0 ~ N(0, 0.25), an
    orthogonal W_h, b_hn ~ N(0, 0.01), random cotangents (as chip_smoke.py)."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    q, _ = np.linalg.qr(rng.randn(3 * H, 3 * H))
    arrays = (
        rng.randn(T, B, 3 * H), rng.rand(T, B, 1) > 0.2, 0.5 * rng.randn(B, H),
        q[:H], 0.1 * rng.randn(H), rng.randn(T, B, H), rng.randn(B, H),
    )
    return [torch.tensor(np.asarray(a, np.float32), device=dev) for a in arrays]


def build_parent(src_dir: str):
    """The earlier kernels as ctypes functions, built into build/parent_gru/."""
    from purejaxql_torch.ops import build

    out_dir = os.path.join(ROOT, "build", "parent_gru")
    os.makedirs(out_dir, exist_ok=True)
    fns = {}
    for name, n_ptr in (("gru_scan_fwd", 10), ("gru_scan_bwd", 13)):
        lib_path = os.path.join(out_dir, f"{name}.so")
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", lib_path, os.path.join(src_dir, f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the earlier {name}.cu:\n{proc.stdout}{proc.stderr}")
        fn = getattr(ctypes.CDLL(lib_path), f"{name}_f32")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fns[name] = fn
    return fns


def parent_calls(fns):
    """The earlier wrappers' launch paths: allocations, the transposed W_h."""
    import torch

    def fwd(xi, keep, h0, w_h, b_hn):
        T, B, H = xi.shape[0], h0.shape[0], h0.shape[1]
        outs = [xi.new_empty(T, B, H) for _ in range(5)]
        err = fns["gru_scan_fwd"](
            xi.data_ptr(), keep.data_ptr(), h0.data_ptr(), w_h.data_ptr(), b_hn.data_ptr(),
            *(o.data_ptr() for o in outs), T, B, H, torch.cuda.current_stream().cuda_stream,
        )
        assert err == 0, err
        return tuple(outs)

    def bwd(keep, hprev, w_h, r, z, n, c, g_y, g_hT):
        T, B, H = hprev.shape
        w_ht = w_h.t().contiguous()
        dxi = hprev.new_empty(T, B, 3 * H)
        dh0 = hprev.new_empty(B, H)
        dc = hprev.new_empty(T, B, H)
        dwb = hprev.new_empty(H + 1, 3 * H)
        err = fns["gru_scan_bwd"](
            keep.data_ptr(), hprev.data_ptr(), w_ht.data_ptr(), r.data_ptr(), z.data_ptr(),
            n.data_ptr(), c.data_ptr(), g_y.data_ptr(), g_hT.data_ptr(), dxi.data_ptr(),
            dh0.data_ptr(), dc.data_ptr(), dwb.data_ptr(), T, B, H,
            torch.cuda.current_stream().cuda_stream,
        )
        assert err == 0, err
        return dxi, dh0, dwb[:H], dwb[H, 2 * H:]

    return fwd, bwd


def device_ms(fn, iters: int):
    """(device time a call, the kernels' names): torch.profiler's CUDA time
    of every kernel ``iters`` calls launch, summed, over ``iters``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    total_us = sum(e.self_device_time_total for e in events)
    return (total_us / 1000.0 / iters if events else None), sorted(e.key[:60] for e in events)


def max_err(got, want) -> float:
    return max((g - w).abs().max().item() for g, w in zip(got, want))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--parent-csrc", default=None, help="directory with an earlier gru_scan_{fwd,bwd}.cu")
    ap.add_argument("--out", default=None, help="also write the summary JSON here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_gru_scan: no GPU visible", file=sys.stderr)
        return 1
    from purejaxql_torch.ops import gru_scan as gs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda", 0)
    old = parent_calls(build_parent(args.parent_csrc)) if args.parent_csrc else None
    summary = {"card": card, "kernels": {}, "clusters": {}, "parent": {}}

    def timed(label, fn, iters):
        ms = cuda_time_ms(fn, iters)
        print(json.dumps({"timing": label, "ms": ms}))
        return ms

    for T, B, H in SHAPES:
        xi, keep, h0, w_h, b_hn, g_y, g_hT = gru_inputs(T, B, H, 10, dev)
        want_f = gs.gru_scan_fwd_plain(xi, keep, h0, w_h, b_hn)
        res = (keep, torch.cat([h0[None], want_f[0][:-1]]), w_h, *want_f[1:])
        want_b = gs.gru_scan_bwd_plain(*res, g_y, g_hT)
        fwd_args, bwd_args = (xi, keep, h0, w_h, b_hn), (*res, g_y, g_hT)
        plan = gs.scan_plan(B, H)
        errs = (max_err(gs.gru_scan_fwd(*fwd_args), want_f), max_err(gs.gru_scan_bwd(*bwd_args), want_b))
        if errs[0] > 1e-5 or errs[1] > 1e-3:
            print(f"time_gru_scan: the kernels disagree with the twins at {(T, B, H)}: {errs}", file=sys.stderr)
            return 1
        key = f"T{T}_B{B}_H{H}"
        placed = {k: gs.active_clusters(k, plan) for k in ("gru_scan_fwd", "gru_scan_bwd")}
        entry = {"plan": plan._asdict(), "placed_at_once": placed, "max_abs_err": errs}
        print(json.dumps({"shape": key, **entry}))
        for name, new_fn, args_, i in (("fwd", gs.gru_scan_fwd, fwd_args, 0), ("bwd", gs.gru_scan_bwd, bwd_args, 1)):
            if old is None:
                entry[f"{name}_ms"] = timed(f"gru_scan_{name} {key}", lambda: new_fn(*args_), 200)
                entry[f"{name}_device_ms"], names = device_ms(lambda: new_fn(*args_), 50)
                print(json.dumps({"device": f"gru_scan_{name} {key}", "ms": entry[f"{name}_device_ms"],
                                  "kernels": names}))
                continue
            old_fn = old[i]
            o_err = max_err(old_fn(*args_), want_f if i == 0 else want_b)
            # in turns: old, new, new, old
            t_old1 = timed(f"earlier gru_scan_{name} {key}", lambda: old_fn(*args_), 50)
            t_new1 = timed(f"gru_scan_{name} {key}", lambda: new_fn(*args_), 200)
            t_new2 = timed(f"gru_scan_{name} {key}", lambda: new_fn(*args_), 200)
            t_old2 = timed(f"earlier gru_scan_{name} {key}", lambda: old_fn(*args_), 50)
            entry[f"{name}_ms"] = [t_new1, t_new2]
            summary["parent"][f"{name}_{key}"] = {"ms": [t_old1, t_old2], "max_abs_err": o_err}
        summary["kernels"][key] = entry

    T, B, H = SHAPES[0]
    xi, keep, h0, w_h, b_hn, g_y, g_hT = gru_inputs(T, B, H, 11, dev)
    want_f = gs.gru_scan_fwd_plain(xi, keep, h0, w_h, b_hn)
    res = (keep, torch.cat([h0[None], want_f[0][:-1]]), w_h, *want_f[1:])
    want_b = gs.gru_scan_bwd_plain(*res, g_y, g_hT)
    chosen = gs.scan_plan
    for C in (4, 8, 16):
        plan = chosen(B, H, C)
        gs.scan_plan = lambda B_, H_, cluster=None, C=C: chosen(B_, H_, C)
        try:
            errs = (max_err(gs.gru_scan_fwd(xi, keep, h0, w_h, b_hn), want_f),
                    max_err(gs.gru_scan_bwd(*res, g_y, g_hT), want_b))
            f_ms = timed(f"gru_scan_fwd C{C}", lambda: gs.gru_scan_fwd(xi, keep, h0, w_h, b_hn), 200)
            b_ms = timed(f"gru_scan_bwd C{C}", lambda: gs.gru_scan_bwd(*res, g_y, g_hT), 200)
        finally:
            gs.scan_plan = chosen
        summary["clusters"][C] = {"plan": plan._asdict(), "fwd_ms": f_ms, "bwd_ms": b_ms, "max_abs_err": errs}

    summary["cudnn_gru_ms"] = []
    for T, B, H in CUDNN_SHAPES:
        gru = torch.nn.GRU(H, H).to(dev)
        x = torch.randn(T, B, H, device=dev)
        hx = torch.randn(1, B, H, device=dev)
        with torch.no_grad():
            c_fwd = timed(f"cudnn torch.nn.GRU forward T{T}_B{B}_H{H}", lambda: gru(x, hx), 200)
        xg = x.clone().requires_grad_(True)

        def fwd_bwd():
            y, h = gru(xg, hx)
            (y.sum() + h.sum()).backward()

        c_fb = timed(f"cudnn torch.nn.GRU forward + backward T{T}_B{B}_H{H}", fwd_bwd, 200)
        summary["cudnn_gru_ms"].append({"shape": [T, B, H], "fwd": c_fwd, "fwd_bwd": c_fb})
    line = json.dumps(summary)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
