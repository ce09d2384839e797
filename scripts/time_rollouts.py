#!/usr/bin/env python3
"""Time the Freeway and Pendulum rollout kernels (csrc/freeway_rollout.cu,
csrc/pendulum_ac_rollout.cu) on one GPU, with CUDA events, at the trainers'
shapes.

    python scripts/time_rollouts.py
    python scripts/time_rollouts.py --parent-csrc build/parent_csrc --out build/rollout_times.json

1. each kernel through its wrapper at its trainer's shape, Freeway at
   (T 32, B 128, H 128) and Pendulum at (T 32, B 64, H 256), its plan
   printed and its outputs held against the twin first (Freeway: every
   output but Q equal, Q within 1e-4; Pendulum: done and time equal, every
   float within 1e-4);
2. the same with the cluster forced to 4, 8 and 16 CTAs
   (``freeway_plan(B, H, cluster)``, ``pendulum_plan(B, H, cluster)``);
3. with ``--parent-csrc DIR``: the kernels of an earlier version, built
   from DIR/freeway_rollout.cu (with DIR's headers) and
   DIR/pendulum_ac_rollout.cu with the same nvcc flags and called through
   that version's C entry points (one block per env, no plan), each held
   against the twin and timed in turns with the current one: old, new,
   new, old.

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

FREEWAY_SHAPE = (32, 128, 128)  # T, B, H: pqn_minatar's NUM_STEPS, NUM_ENVS, HIDDEN_SIZE
PENDULUM_SHAPE = (32, 64, 256)  # pqn_pendulum's NUM_STEPS, NUM_ENVS, hidden sizes
CLUSTERS = (4, 8, 16)


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


def freeway_inputs(B: int, H: int, dev):
    """Seeded CNN weights and the states after 40 steps of random play
    through the twin from a reset."""
    import torch

    from purejaxql_torch.envs import make as make_env
    from purejaxql_torch.models.cnn import CNNQNetwork
    from purejaxql_torch.ops import freeway_rollout as fr
    from purejaxql_torch.ops.minatar_rollout import minatar_weights

    net = CNNQNetwork((10, 10, 7), 3, hidden_size=H, generator=torch.Generator().manual_seed(B)).to(dev)
    weights = minatar_weights(net)
    env, params = make_env("Freeway-MinAtar")
    _, state = env.reset(torch.Generator(device=dev).manual_seed(0), B, params)
    st = fr.freeway_rollout_plain(3, 1.0, weights, fr.state_matrix_from_freeway(state), 40)[6]
    return weights, st


def pendulum_inputs(B: int, H: int, dev):
    """Weights of a seeded actor and two-critic ensemble, and states with
    theta in [-pi, pi), theta_dot in [-8, 8], times in [0, 200)."""
    import numpy as np
    import torch

    from purejaxql_torch.models.actor_critic import Actor, CriticEnsemble
    from purejaxql_torch.ops.pendulum_rollout import pendulum_ac_weights

    gen = torch.Generator().manual_seed(B)
    actor = Actor(3, 1, 2.0, 0.0, [H, H], generator=gen).to(dev)
    critics = CriticEnsemble(2, 3, 1, [H, H], generator=gen).to(dev)
    r = np.random.RandomState(B)
    stf = np.stack([r.uniform(-np.pi, np.pi, B), r.uniform(-8, 8, B), np.zeros(B)]).astype(np.float32)
    sti = r.randint(0, 200, (1, B)).astype(np.int32)
    aw, cw = pendulum_ac_weights(actor, critics)
    return aw, cw, torch.tensor(stf, device=dev), torch.tensor(sti, device=dev)


def freeway_err(got, want) -> float:
    """max |Q error|, or raises where any other output differs."""
    import torch

    for i, (g, w) in enumerate(zip(got, want)):
        if i != 4 and not torch.equal(g, w):
            raise AssertionError(f"freeway output {i} differs from the twin")
    return (got[4] - want[4]).abs().max().item()


def pendulum_err(got, want) -> float:
    """max |float error|, or raises where done or time differs."""
    import torch

    if not (torch.equal(got[5], want[5]) and torch.equal(got[8], want[8])):
        raise AssertionError("pendulum done or time differs from the twin")
    return max((g - w).abs().max().item() for i, (g, w) in enumerate(zip(got, want)) if i not in (5, 8))


def build_parent(src_dir: str):
    """The earlier kernels' C entry points as ctypes functions, built into
    build/parent_rollouts/."""
    from purejaxql_torch.ops import build

    out_dir = os.path.join(ROOT, "build", "parent_rollouts")
    os.makedirs(out_dir, exist_ok=True)
    fns = {}
    for name, argtypes in (
        ("freeway_rollout", [ctypes.c_void_p] * 18 + [ctypes.c_int] * 4
         + [ctypes.c_uint64, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
        ("pendulum_ac_rollout", [ctypes.c_void_p] * 12 + [ctypes.c_int] * 3
         + [ctypes.c_uint64, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
    ):
        lib_path = os.path.join(out_dir, f"{name}.so")
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", src_dir, "-o", lib_path, os.path.join(src_dir, f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the earlier {name}.cu:\n{proc.stdout}{proc.stderr}")
        fn = getattr(ctypes.CDLL(lib_path), f"{name}_f32")
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        fns[name] = fn
    return fns


def parent_calls(fns):
    """The earlier wrappers' launch paths: the same outputs, allocated the
    same way, without a plan."""
    import torch

    def freeway(seed, eps, weights, st0, T):
        B, H, A, dev = st0.shape[1], weights[4].shape[0], weights[8].shape[0], st0.device
        f32, i32 = dict(dtype=torch.float32, device=dev), dict(dtype=torch.int32, device=dev)
        outs = (
            torch.empty((T, B, 10, 10, 7), **f32), torch.empty((T, B), **i32), torch.empty((T, B), **f32),
            torch.empty((T, B), **i32), torch.empty((T, B, A), **f32), torch.empty((B, 10, 10, 7), **f32),
            torch.empty((32, B), **i32),
        )
        err = fns["freeway_rollout"](
            *(x.data_ptr() for x in (*weights, st0, *outs)), T, B, H, A, seed, eps, 1, 2500, 3,
            torch.cuda.current_stream().cuda_stream,
        )
        assert err == 0, err
        return outs

    def pendulum(seed, noise, aw, cw, stf0, sti0, T):
        B, H, dev = stf0.shape[1], aw[0].shape[0], stf0.device
        f32 = dict(dtype=torch.float32, device=dev)
        outs = (
            torch.empty((T, B, 3), **f32), torch.empty((T, B, 1), **f32), torch.empty((T, B, 1), **f32),
            torch.empty((T, B), **f32), torch.empty((T, B), **f32), torch.empty((T, B), **f32),
            torch.empty((B, 3), **f32), torch.empty((3, B), **f32), torch.empty((1, B), dtype=torch.int32, device=dev),
        )
        ptrs = (ctypes.c_void_p * 30)(*(w.data_ptr() for w in (*aw, *cw)))
        err = fns["pendulum_ac_rollout"](
            ctypes.addressof(ptrs), stf0.data_ptr(), sti0.data_ptr(), *(x.data_ptr() for x in outs), T, B, H,
            seed, noise, 1, 200, 1, torch.cuda.current_stream().cuda_stream,
        )
        assert err == 0, err
        return outs

    return freeway, pendulum


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--parent-csrc", default=None,
                    help="directory with an earlier freeway_rollout.cu, its headers and pendulum_ac_rollout.cu")
    ap.add_argument("--out", default=None, help="also write the summary JSON here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_rollouts: no GPU visible", file=sys.stderr)
        return 1
    from purejaxql_torch.ops import freeway_rollout as fr
    from purejaxql_torch.ops import pendulum_rollout as pr

    torch.backends.cuda.matmul.allow_tf32 = False
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

    T, B, H = FREEWAY_SHAPE
    fw, fst = freeway_inputs(B, H, dev)
    f_want = fr.freeway_rollout_plain(3, 0.1, fw, fst, T)
    P, PB, PH = PENDULUM_SHAPE
    aw, cw, stf, sti = pendulum_inputs(PB, PH, dev)
    p_want = pr.pendulum_rollout_plain(3, 0.5, aw, cw, stf, sti, P)
    cases = (
        ("freeway_rollout", fr, "freeway_plan", FREEWAY_SHAPE, lambda: fr.freeway_rollout(3, 0.1, fw, fst, T),
         lambda out: freeway_err(out, f_want),
         (lambda: old[0](3, 0.1, fw, fst, T)) if old else None),
        ("pendulum_ac_rollout", pr, "pendulum_plan", PENDULUM_SHAPE,
         lambda: pr.pendulum_ac_rollout(3, 0.5, aw, cw, stf, sti, P), lambda out: pendulum_err(out, p_want),
         (lambda: old[1](3, 0.5, aw, cw, stf, sti, P)) if old else None),
    )
    for name, module, plan_name, shape, new_fn, err_of, old_fn in cases:
        b, h = shape[1:]
        plan = getattr(module, plan_name)(b, h)
        entry = {"shape": dict(zip("TBH", shape)), "plan": plan._asdict(), "max_abs_err": err_of(new_fn())}
        if old_fn is None:
            entry["ms"] = timed(name, new_fn, 200)
        else:
            o_err = err_of(old_fn())
            # in turns: old, new, new, old
            t_old1 = timed(f"earlier {name}", old_fn, 30)
            t_new1 = timed(name, new_fn, 200)
            t_new2 = timed(name, new_fn, 200)
            t_old2 = timed(f"earlier {name}", old_fn, 30)
            entry["ms"] = [t_new1, t_new2]
            summary["parent"][name] = {"ms": [t_old1, t_old2], "max_abs_err": o_err}
        summary["kernels"][name] = entry

        chosen = getattr(module, plan_name)
        summary["clusters"][name] = {}
        for C in CLUSTERS:
            forced = chosen(b, h, C)
            setattr(module, plan_name, lambda B_, H_, C=C: chosen(B_, H_, C))
            try:
                err = err_of(new_fn())
                ms = timed(f"{name} C{C}", new_fn, 200)
            finally:
                setattr(module, plan_name, chosen)
            summary["clusters"][name][C] = {"plan": forced._asdict(), "ms": ms, "max_abs_err": err}
    line = json.dumps(summary)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
