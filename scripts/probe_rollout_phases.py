#!/usr/bin/env python3
"""Clock-probe the phases of a step of the MinAtar rollout kernels on the
cluster CNN (csrc/<game>_rollout.cu of the five games, time_rollouts.py's
GAMES), or of the CartPole cluster rollout (csrc/cartpole_rollout.cu), on
one GPU.

    python scripts/probe_rollout_phases.py [--out FILE]
    python scripts/probe_rollout_phases.py --cartpole [--out FILE]

The kernels in the tree carry no probe. This script copies
purejaxql_torch/csrc/ to build/probe/, inserts clock64() marks at the
phase boundaries of csrc/minatar_cluster.cuh and of each game's step loop
(raising if a source no longer has the line a mark goes after), builds each
patched kernel with the same nvcc flags, and runs it at the trainers' (T 32,
B 128, H 128) with its plan, its outputs held against the twin. Thread 0 of
the first CTA (an env's CTA) adds the cycles from one mark to the next into
shared memory, so each phase's count is what that thread waits for it,
barriers included ("rules": from the CNN's end to the step's last barrier,
every phase and barrier of the game's rules). With ``--cartpole`` the
same for the CartPole kernel (CARTPOLE_PHASES; thread 0 is env 0's warp)
at time_rollouts.py's CARTPOLE_SHAPES, each under its plan and with the
cluster forced to 8 CTAs. Prints the cycles a step of each phase, the
patched and the tree's kernel's ms (CUDA events), and a summary object as
the last line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

PHASES = (
    "step start", "planes and words", "cell masks", "conv, LN1 and send", "wait for the conv slices",
    "partial sums", "chunk sums and send", "wait for the partial sums", "LN2 and head", "rules",
    "barrier after the rules",
)
PROBE_DEFS = """
__device__ unsigned long long g_probe[16];
static __shared__ long long probe_acc[16];
static __shared__ long long probe_last;
#define PROBE_ON (threadIdx.x == 0 && blockIdx.x == 0)
#define PROBE(i) do { if (PROBE_ON) { const long long now_ = clock64(); probe_acc[i] += now_ - probe_last; probe_last = now_; } } while (0)
#define PROBE_INIT() do { if (PROBE_ON) { for (int i_ = 0; i_ < 16; ++i_) probe_acc[i_] = 0; probe_last = clock64(); } } while (0)
#define PROBE_FLUSH(T) do { if (PROBE_ON) { for (int i_ = 0; i_ < 15; ++i_) g_probe[i_] = probe_acc[i_]; g_probe[15] = (T); } } while (0)
"""
# (the line a mark goes after, the mark)
HEADER_MARKS = (
    ("namespace minatar_cluster {\n", PROBE_DEFS),
    ("    cell_masks<kCh>(m);\n", "    PROBE(2);\n"),
    ("    st_async4(cluster_addr(dst, r), y, cluster_addr(smem_addr(&m.bars[slot]), r));\n", "    PROBE(3);\n"),
    ("  wait_slot(m.bars, slot, parity);\n", "  PROBE(4);\n"),
    ("red[(ch * KC + eh * KE + g) * QH + uq] = acc[g];\n  }\n  __syncthreads();\n", "  PROBE(5);\n"),
    ("    st_async4(cluster_addr(dst, g), s, cluster_addr(smem_addr(&m.bars[2 + slot]), g));\n  }\n", "  PROBE(6);\n"),
    ("  wait_slot(m.bars, 2 + slot, parity);\n", "  PROBE(7);\n"),
    ("    if (lane == 0) m.q[warp] = q + m.head_b[warp];\n  }\n  __syncthreads();\n", "  PROBE(8);\n"),
)
GAME_MARKS = (
    ("  load_and_arm<kChannels>(m, wts, p);\n", "  PROBE_INIT();\n"),
    ("    const long tb = (long)t * B + b;\n", "    PROBE(0);\n"),
    ("      __syncthreads();\n    }\n", "    PROBE(1);\n"),
)
# the step's rules end at its last barrier: mark 9 before it, 10 after
RULES_END = "      }\n    }\n    __syncthreads();\n  }\n\n  if (p.live) {\n    build_planes(m.planes, final_obs"
READ_FN = """
extern "C" int probe_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, minatar_cluster::g_probe, 16 * sizeof(unsigned long long));
}
"""


CARTPOLE_PHASES = (
    "step start", "the chunk's draws", "obs and layer 1", "barrier after layer 1", "layer-2 slice",
    "barrier and send", "wait for the blocks", "LN2 and head", "argmax, physics and writes",
)
CARTPOLE_MARKS = (
    ("using namespace dsmem;\n", PROBE_DEFS),
    ("  cluster_start();\n", "  PROBE_INIT();\n"),
    ("    const int slot = t & 1;\n", "    PROBE(0);\n"),
    ("          d.reset[3] = use_prng ? reset_draw(r.y) : 0.0f;\n        }\n      }\n    }\n", "    PROBE(1);\n"),
    ("      layer1<NU>(w, st, y, H, lane);\n    }\n", "    PROBE(2);\n"),
    ("    __syncthreads();\n    // layer 2: this CTA's units to every CTA (a bulk copy each)\n", "    PROBE(3);\n"),
    ("    layer2_slice<RES, G>(w, w2s, Hs, h1, stage_t, H, U, u0);\n", "    PROBE(4);\n"),
    ("    if (dst < C) copy_to(dst, recv_t + rank * blk, stage_t, 4u * blk, &bars[slot]);\n", "    PROBE(5);\n"),
    ("    wait_slot(bars, slot, parity);\n", "    PROBE(6);\n"),
    ("      ln_head<NU>(w, hw, hb, recv_t + g * U, at, y, H, A, lane, q);\n", "      PROBE(7);\n"),
    ("      time = done ? 0 : ntime;\n    }\n", "    PROBE(8);\n"),
    ("  if (writer && lane == 0) sti_out[b] = time;\n", "  PROBE_FLUSH(T);\n"),
)
CARTPOLE_READ_FN = """
extern "C" int probe_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_probe, 16 * sizeof(unsigned long long));
}
"""


def insert_after(text: str, anchor: str, mark: str, where: str) -> str:
    if text.count(anchor) != 1:
        raise RuntimeError(f"{where}: the probe's anchor {anchor!r} is not there exactly once")
    return text.replace(anchor, anchor + mark)


def patched_sources(out_dir: str) -> None:
    """csrc/ with the marks, into out_dir."""
    src_dir = os.path.join(ROOT, "purejaxql_torch", "csrc")
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.copytree(src_dir, out_dir)
    path = os.path.join(out_dir, "minatar_cluster.cuh")
    text = open(path).read()
    for anchor, mark in HEADER_MARKS:
        text = insert_after(text, anchor, mark, path)
    open(path, "w").write(text)
    import time_rollouts as tr

    for name in tr.GAMES:
        path = os.path.join(out_dir, f"{name}.cu")
        text = open(path).read()
        for anchor, mark in GAME_MARKS:
            text = insert_after(text, anchor, mark, path)
        if text.count(RULES_END) != 1:
            raise RuntimeError(f"{path}: the end of the step's rules is not where the probe expects it")
        text = text.replace(RULES_END, RULES_END.replace(
            "    }\n    __syncthreads();\n  }\n", "    }\n    PROBE(9);\n    __syncthreads();\n    PROBE(10);\n  }\n"))
        text = text.replace("  finish_launch();\n", "  PROBE_FLUSH(T);\n  finish_launch();\n")
        open(path, "w").write(text + READ_FN)


def probe_cartpole(out_dir: str, dev):
    """The CartPole kernel with CARTPOLE_MARKS, built from a copy of csrc/
    in out_dir and run at each of time_rollouts.py's CARTPOLE_SHAPES under
    its plan and at C 8, its outputs held against the twin. Returns the
    summary's kernels entry."""
    import torch
    import time_rollouts as tr

    from purejaxql_torch.ops import build
    from purejaxql_torch.ops import cartpole_rollout as cr

    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "purejaxql_torch", "csrc"), out_dir)
    path = os.path.join(out_dir, "cartpole_rollout.cu")
    text = open(path).read()
    for anchor, mark in CARTPOLE_MARKS:
        text = insert_after(text, anchor, mark, path)
    open(path, "w").write(text + CARTPOLE_READ_FN)
    lib_path = os.path.join(out_dir, "cartpole_rollout.so")
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", out_dir, "-o", lib_path, path]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the probed cartpole_rollout.cu:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(lib_path)
    fn = lib.cartpole_rollout_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 20 + [ctypes.c_int] * 4 + [
        ctypes.c_uint64, ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    kernels = {}
    for T, B, H in tr.CARTPOLE_SHAPES:
        weights, stf0, sti0 = tr.cartpole_inputs(B, H, dev)
        want = cr.cartpole_rollout_plain(3, 0.1, weights, stf0, sti0, T)
        for plan in (cr.cartpole_plan(B, H), cr.cartpole_plan(B, H, 8)):
            f32, i32 = dict(dtype=torch.float32, device=dev), dict(dtype=torch.int32, device=dev)
            outs = (
                torch.empty((T, B, 4), **f32), torch.empty((T, B), **i32), torch.empty((T, B), **f32),
                torch.empty((T, B), **i32), torch.empty((T, B, 2), **f32), torch.empty((B, 4), **f32),
                torch.empty((4, B), **f32), torch.empty((1, B), **i32),
            )

            def probed(plan=plan, outs=outs, weights=weights, stf0=stf0, sti0=sti0):
                err = fn(*(x.data_ptr() for x in (*weights, stf0, sti0, *outs)), T, B, H, 2, 3, 0.1, 1, 500,
                         *plan.ints, torch.cuda.current_stream().cuda_stream)
                assert err == 0, err
                return outs

            err = tr.cartpole_err(probed(), want)
            probed_ms = tr.cuda_time_ms(probed, 100)
            probed()
            torch.cuda.synchronize()
            counts = (ctypes.c_ulonglong * 16)()
            read = lib.probe_read
            read.restype = ctypes.c_int
            assert read(counts) == 0
            per_step = {phase: counts[i] / counts[15] for i, phase in enumerate(CARTPOLE_PHASES)}
            entry = {"cycles_a_step": per_step, "total": sum(per_step.values()), "probed_ms": probed_ms,
                     "max_abs_err": err, "plan": plan._asdict()}
            label = f"cartpole_rollout_B{B}_C{plan.cluster}"
            print(json.dumps({label: entry}))
            kernels[label] = entry
    return kernels


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=None, help="also write the summary JSON here")
    ap.add_argument("--cartpole", action="store_true", help="probe the CartPole kernel instead")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("probe_rollout_phases: no GPU visible", file=sys.stderr)
        return 1
    import time_rollouts as tr

    from purejaxql_torch.ops import build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    probe_dir = os.path.join(ROOT, "build", "probe")
    dev = torch.device("cuda", 0)
    if args.cartpole:
        summary = {"card": card, "kernels": probe_cartpole(probe_dir, dev)}
        write_summary(summary, args.out)
        return 0
    patched_sources(probe_dir)
    T, B, H = tr.MINATAR_SHAPE
    summary = {"card": card, "shape": dict(zip("TBH", tr.MINATAR_SHAPE)), "kernels": {}}
    for name, (_, game, channels, _, game_ints) in tr.GAMES.items():
        lib_path = os.path.join(probe_dir, f"{name}.so")
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", probe_dir, "-o", lib_path, os.path.join(probe_dir, f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the probed {name}.cu:\n{proc.stdout}{proc.stderr}")
        lib = ctypes.CDLL(lib_path)
        fn = getattr(lib, f"{name}_f32")
        fn.restype = ctypes.c_int
        n_states = tr.STATES.get(name, 1)
        fn.argtypes = [ctypes.c_void_p] * (16 + 2 * n_states) + [ctypes.c_int] * 4 + [ctypes.c_uint64, ctypes.c_float, ctypes.c_int] + [
            ctypes.c_int
        ] * (len(game_ints) + 2) + [ctypes.c_void_p]
        module = tr.game_module(name)
        plan = getattr(module, f"{game}_plan")(B, H)
        weights, states = tr.minatar_inputs(name, B, H, dev)
        f32, i32 = dict(dtype=torch.float32, device=dev), dict(dtype=torch.int32, device=dev)
        A = weights[8].shape[0]
        outs = (
            torch.empty((T, B, 10, 10, channels), **f32), torch.empty((T, B), **i32), torch.empty((T, B), **f32),
            torch.empty((T, B), **i32), torch.empty((T, B, A), **f32), torch.empty((B, 10, 10, channels), **f32),
            *(torch.empty_like(x) for x in states),
        )

        def probed():
            err = fn(*(x.data_ptr() for x in (*weights, *states, *outs)), T, B, H, A, 3, 0.1, 1, *game_ints,
                     *plan.ints, torch.cuda.current_stream().cuda_stream)
            assert err == 0, err
            return outs

        q_err = tr.minatar_err(name, probed(), getattr(module, f"{name}_plain")(3, 0.1, weights, *states, T))
        probed_ms = tr.cuda_time_ms(probed, 100)
        tree_ms = tr.cuda_time_ms(lambda: getattr(module, name)(3, 0.1, weights, *states, T), 100)
        probed()
        torch.cuda.synchronize()
        counts = (ctypes.c_ulonglong * 16)()
        read = lib.probe_read
        read.restype = ctypes.c_int
        assert read(counts) == 0
        per_step = {phase: counts[i] / counts[15] for i, phase in enumerate(PHASES)}
        entry = {"cycles_a_step": per_step, "total": sum(per_step.values()), "probed_ms": probed_ms,
                 "tree_ms": tree_ms, "max_abs_err": q_err, "plan": plan._asdict()}
        print(json.dumps({name: entry}))
        summary["kernels"][name] = entry
    write_summary(summary, args.out)
    return 0


def write_summary(summary, out) -> None:
    """The summary as the last line, and into ``out`` where given."""
    line = json.dumps(summary)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    sys.exit(main())
