#!/usr/bin/env python3
"""The GRU scan kernels with a seed axis (NUM_SEEDS) on one GPU: checks and
times at the seeded trainers' shapes.

    python scripts/time_gru_seeds.py
    python scripts/time_gru_seeds.py --parent-csrc build/parent_csrc --out build/gru_seeds.json

1. at (T, S, B, H) = (132, 4, 2, 256) and (68, 4, 2, 256), the seeded
   MemoryChain and RNN CartPole windows (4 seeds, B 2 rows each), and (29,
   2, 48, 256), two seeds of several clusters (the partial-sum pass per
   seed): one launch of each kernel for all S seeds against the seeded
   twins (forward 1e-5, backward 1e-4), lane s against the unseeded launch
   on seed s's rows and weights (bit for bit), and their times: one seeded
   launch against S unseeded ones, each on the device (torch.profiler: every
   kernel a call launches, summed, over the calls) and through the wrapper
   (CUDA events), the plain twin's, the bound (S times one seed's bytes and
   operations, chip_smoke.py's formulas), and S calls of ``torch.nn.GRU``
   (cuDNN, one W_h a call) forward and forward + backward at (T, B, H) as a
   yardstick;
2. with ``--parent-csrc DIR``: the kernels as DIR holds them (the version
   before the seed axis; DIR holds gru_scan_fwd.cu, gru_scan_bwd.cu and their
   headers), built with the same nvcc flags and called as that version's
   wrapper called them, held against the current kernels with one seed bit
   for bit at chip_smoke.py's GRU shapes, and timed in turns with them at
   the trainers' shapes: old, new, new, old.

Prints one JSON line per result and one summary object as the last line,
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
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from time_gru_scan import cuda_time_ms, device_ms, gru_inputs  # noqa: E402

SEEDED = ((132, 4, 2, 256), (68, 4, 2, 256), (29, 2, 48, 256))
# chip_smoke.py's GRU_SHAPES (one seed), where the parent is held to the bit
PARENT_SHAPES = ((132, 2, 256), (68, 2, 256), (29, 48, 256), (68, 80, 256), (32, 16, 128), (20, 40, 256),
                 (9, 2, 512))
PARENT_TIMED = ((132, 2, 256), (29, 48, 256))
PEAK_BYTES_PER_S, PEAK_F32_FLOP_PER_S = 3.35e12, 67e12


def bound_ms(kernel: str, T: int, B: int, H: int):
    """chip_smoke.py's gru_fwd_bound_ms / gru_bwd_bound_ms for one seed."""
    if kernel == "fwd":
        nbytes = 4 * (T * B * 3 * H + T * B + B * H + 3 * H * H + H + 5 * T * B * H)
        flops = T * (2 * B * H * 3 * H + 30 * B * H)
    else:
        nbytes = 4 * (T * B + 6 * T * B * H + B * H + 3 * H * H + T * B * 3 * H + B * H + 3 * H * H + H)
        flops = T * (2 * 2 * B * H * 3 * H + 20 * B * H)
    t_b, t_o = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOP_PER_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def seeded_inputs(T, S, B, H, dev):
    """S seeds' inputs (each as time_gru_scan.py's), seed-major."""
    import torch

    lanes = [gru_inputs(T, B, H, 20 + s, dev) for s in range(S)]
    dims = (1, 1, 0, None, None, 1, 0)
    return [torch.stack(xs) if d is None else torch.cat(xs, d) for d, xs in zip(dims, zip(*lanes))]


def build_parent(src_dir: str):
    """The earlier kernels' C entry points (no seed argument), built into
    build/parent_gru_seeds/."""
    from purejaxql_torch.ops import build

    out_dir = os.path.join(ROOT, "build", "parent_gru_seeds")
    os.makedirs(out_dir, exist_ok=True)
    fns = {}
    for name, n_ptr in (("gru_scan_fwd", 10), ("gru_scan_bwd", 15)):
        lib_path = os.path.join(out_dir, f"{name}.so")
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", src_dir, "-o", lib_path, os.path.join(src_dir, f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the earlier {name}.cu:\n{proc.stdout}{proc.stderr}")
        fn = getattr(ctypes.CDLL(lib_path), f"{name}_f32")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        fns[name] = fn
    return fns


def parent_calls(fns):
    """The earlier wrappers' launch paths, on the same plan."""
    import torch

    from purejaxql_torch.ops import gru_scan as gs

    def fwd(xi, keep, h0, w_h, b_hn):
        T, (B, H) = xi.shape[0], h0.shape
        plan = gs.scan_plan(B, H)
        outs = [xi.new_empty(T, B, H) for _ in range(5)]
        err = fns["gru_scan_fwd"](
            xi.data_ptr(), keep.data_ptr(), h0.data_ptr(), w_h.data_ptr(), b_hn.data_ptr(),
            *(o.data_ptr() for o in outs), T, B, H, plan.cluster, plan.units, plan.rows, plan.threads,
            int(plan.resident), int(plan.registers), plan.fwd_bytes, torch.cuda.current_stream().cuda_stream,
        )
        assert err == 0, err
        return tuple(outs)

    def bwd(keep, hprev, w_h, r, z, n, c, g_y, g_hT):
        T, B, H = hprev.shape
        plan = gs.scan_plan(B, H)
        outs = [hprev.new_empty(T, B, 3 * H), hprev.new_empty(B, H), hprev.new_empty(H, 3 * H), hprev.new_empty(H)]
        parts = [hprev.new_empty(plan.clusters, H, 3 * H), hprev.new_empty(plan.clusters, H)]
        err = fns["gru_scan_bwd"](
            *(x.data_ptr() for x in (keep, hprev, w_h, r, z, n, c, g_y, g_hT, *outs, *parts)),
            T, B, H, plan.cluster, plan.units, plan.rows, plan.threads, int(plan.resident),
            int(plan.registers), plan.bwd_bytes, torch.cuda.current_stream().cuda_stream,
        )
        assert err == 0, err
        return tuple(outs)

    return fwd, bwd


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--parent-csrc", default=None, help="directory with the earlier gru_scan_{fwd,bwd}.cu")
    ap.add_argument("--out", default=None, help="also write the summary JSON here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_gru_seeds: no GPU visible", file=sys.stderr)
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
    summary = {"card": card, "seeded": {}, "parent": {}}
    failed = []

    def max_err(got, want):
        return max((g - w).abs().max().item() for g, w in zip(got, want))

    for T, S, B, H in SEEDED:
        xi, keep, h0, w_h, b_hn, g_y, g_hT = seeded_inputs(T, S, B, H, dev)
        want_f = gs.gru_scan_fwd_plain(xi, keep, h0, w_h, b_hn)
        res = (keep, torch.cat([h0[None], want_f[0][:-1]]), w_h, *want_f[1:])
        want_b = gs.gru_scan_bwd_plain(*res, g_y, g_hT)
        fwd_args, bwd_args = (xi, keep, h0, w_h, b_hn), (*res, g_y, g_hT)
        got_f, got_b = gs.gru_scan_fwd(*fwd_args), gs.gru_scan_bwd(*bwd_args)
        f_err = max_err(got_f, want_f)
        b_rel = max(((g - w).abs() / (1e-4 + 1e-4 * w.abs())).max().item() for g, w in zip(got_b, want_b))
        # lane s against the unseeded launch on its own rows and weights
        lane_args = []
        same = True
        for s in range(S):
            rows = slice(s * B, (s + 1) * B)
            lf = (*(x[:, rows].contiguous() for x in (xi, keep)), h0[rows].contiguous(), w_h[s], b_hn[s])
            lb = (keep[:, rows].contiguous(), res[1][:, rows].contiguous(), w_h[s],
                  *(x[:, rows].contiguous() for x in (*res[3:], g_y)), g_hT[rows].contiguous())
            lane_args.append((lf, lb))
            one_f, one_b = gs.gru_scan_fwd(*lf), gs.gru_scan_bwd(*lb)
            same &= all(torch.equal(a[:, rows], b) for a, b in zip(got_f, one_f))
            same &= torch.equal(got_b[0][:, rows], one_b[0]) and torch.equal(got_b[1][rows], one_b[1])
            same &= torch.equal(got_b[2][s], one_b[2]) and torch.equal(got_b[3][s], one_b[3])
        key = f"T{T}_S{S}_B{B}_H{H}"
        plan = gs.scan_plan(B, H)
        entry = {"plan": plan._asdict(), "clusters_per_launch": S * plan.clusters,
                 "placed_at_once": {k: gs.active_clusters(k, plan) for k in ("gru_scan_fwd", "gru_scan_bwd")},
                 "fwd_max_abs_err": f_err, "bwd_rel_err": b_rel, "lanes_bit_equal": bool(same)}
        if f_err > 1e-5 or b_rel > 1.0 or not same:
            failed.append(key)
        for name, fn, a, lanes in (("fwd", gs.gru_scan_fwd, fwd_args, [x[0] for x in lane_args]),
                                   ("bwd", gs.gru_scan_bwd, bwd_args, [x[1] for x in lane_args])):
            plain = gs.gru_scan_fwd_plain if name == "fwd" else gs.gru_scan_bwd_plain

            def unseeded():
                for la in lanes:
                    fn(*la)

            b_ms, b_by = bound_ms(name, T, B, H)
            entry[name] = {
                "device_ms": device_ms(lambda: fn(*a), 50)[0],
                "device_ms_s_unseeded": device_ms(unseeded, 50)[0],
                "ms": cuda_time_ms(lambda: fn(*a), 200),
                "ms_s_unseeded": cuda_time_ms(unseeded, 100),
                "plain_ms": cuda_time_ms(lambda: plain(*a), 3, warmup=1),
                "bound_ms": S * b_ms, "bound_by": b_by,
            }
        gru = torch.nn.GRU(H, H).to(dev)
        x = torch.randn(T, B, H, device=dev)
        hx = torch.randn(1, B, H, device=dev)
        with torch.no_grad():
            c_fwd = cuda_time_ms(lambda: [gru(x, hx) for _ in range(S)], 50)
        xg = x.clone().requires_grad_(True)

        def fwd_bwd():
            for _ in range(S):
                y, h = gru(xg, hx)
                (y.sum() + h.sum()).backward()

        entry["cudnn_gru_s_calls_ms"] = {"fwd": c_fwd, "fwd_bwd": cuda_time_ms(fwd_bwd, 50)}
        print(json.dumps({"seeded": key, **entry}))
        summary["seeded"][key] = entry

    if args.parent_csrc:
        old_fwd, old_bwd = parent_calls(build_parent(args.parent_csrc))
        for T, B, H in PARENT_SHAPES:
            xi, keep, h0, w_h, b_hn, g_y, g_hT = gru_inputs(T, B, H, 30, dev)
            new_f, old_f = gs.gru_scan_fwd(xi, keep, h0, w_h, b_hn), old_fwd(xi, keep, h0, w_h, b_hn)
            res = (keep, torch.cat([h0[None], new_f[0][:-1]]), w_h, *new_f[1:])
            new_b, old_b = gs.gru_scan_bwd(*res, g_y, g_hT), old_bwd(*res, g_y, g_hT)
            equal = all(torch.equal(a, b) for a, b in zip((*new_f, *new_b), (*old_f, *old_b)))
            key = f"T{T}_B{B}_H{H}"
            entry = {"one_seed_bit_equal_to_parent": equal}
            if not equal:
                failed.append(f"parent {key}")
            if (T, B, H) in PARENT_TIMED:
                for name, new, old, a in (("fwd", gs.gru_scan_fwd, old_fwd, (xi, keep, h0, w_h, b_hn)),
                                          ("bwd", gs.gru_scan_bwd, old_bwd, (*res, g_y, g_hT))):
                    t = [cuda_time_ms(lambda: f(*a), 200) for f in (old, new, new, old)]
                    entry[name] = {"parent_ms": [t[0], t[3]], "ms": [t[1], t[2]]}
            print(json.dumps({"parent": key, **entry}))
            summary["parent"][key] = entry

    summary["failed"] = failed
    line = json.dumps(summary)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    if failed:
        print(f"time_gru_seeds: FAIL at {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
