#!/usr/bin/env python3
"""Time the rollout kernels on the cluster CNN, the Pendulum cluster
rollout and the CartPole cluster rollout (csrc/freeway_rollout.cu,
csrc/asterix_rollout.cu, csrc/seaquest_rollout.cu,
csrc/breakout_rollout.cu, csrc/space_invaders_rollout.cu,
csrc/pendulum_ac_rollout.cu, csrc/cartpole_rollout.cu) on one GPU, with
CUDA events, at the trainers' shapes.

    python scripts/time_rollouts.py
    python scripts/time_rollouts.py --parent-csrc build/parent_csrc --out build/rollout_times.json

1. each kernel through its wrapper at its trainer's shape, the five
   MinAtar games at (T 32, B 128, H 128), Pendulum at (T 32, B 64, H 256)
   and CartPole at (T 64, B 32, H 256), the trainer's rollout, and (T 64,
   B 128, H 256), its eval chunks; its plan printed and its outputs held
   against the twin first (the MinAtar games: every output but Q equal, Q
   within 1e-4; Pendulum: done and time equal, every float within 1e-4;
   CartPole: actions, rewards, dones and time equal, obs and state within
   1e-5, Q within 1e-4);
2. the same with the cluster forced to 4, 8 and 16 CTAs (``<game>_plan(B,
   H, cluster)``, ``pendulum_plan(B, H, cluster)``, ``cartpole_plan(B, H,
   cluster)``), with the clusters the card places at once
   (cudaOccupancyMaxActiveClusters) for the MinAtar games and CartPole;
3. with ``--parent-csrc DIR``: the MinAtar and CartPole kernels of the
   earlier version, built from DIR/<name>.cu with DIR's headers and the
   same nvcc flags and called through that version's C entry points (the
   MinAtar kernels, each on the cluster CNN, with the current plan; the
   earlier CartPole kernel, one block an env, takes none), each held
   against the twin and against the current kernel's outputs (equal bit
   for bit, or the largest Q gap), and timed in turns with the current
   one: old, new, new, old.

Prints one JSON line per timing and one summary object as the last line,
with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

MINATAR_SHAPE = (32, 128, 128)  # T, B, H: pqn_minatar's NUM_STEPS, NUM_ENVS, HIDDEN_SIZE
PENDULUM_SHAPE = (32, 64, 256)  # pqn_pendulum's NUM_STEPS, NUM_ENVS, hidden sizes
# pqn_cartpole's NUM_STEPS, HIDDEN_SIZE and NUM_ENVS, then TEST_NUM_ENVS (the
# eval chunks of NUM_STEPS)
CARTPOLE_SHAPES = ((64, 32, 256), (64, 128, 256))
CLUSTERS = (4, 8, 16)
# per game: the env, the wrapper's module name, channels, actions and the
# game's int arguments after use_prng
GAMES = {
    "freeway_rollout": ("Freeway-MinAtar", "freeway", 7, 3, (2500, 3)),
    "asterix_rollout": ("Asterix-MinAtar", "asterix", 4, 5, (1000,)),
    "seaquest_rollout": ("Seaquest-MinAtar", "seaquest", 10, 6, (1000,)),
    "breakout_rollout": ("Breakout-MinAtar", "breakout", 4, 3, (1000,)),
    "space_invaders_rollout": ("SpaceInvaders-MinAtar", "space_invaders", 6, 4, (1000,)),
}
# the state inputs of each game's kernel (and as many state outputs)
STATES = {"breakout_rollout": 2, "space_invaders_rollout": 4}


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


def game_module(name: str):
    import importlib

    return importlib.import_module(f"purejaxql_torch.ops.{name}")


def minatar_inputs(name: str, B: int, H: int, dev):
    """Seeded CNN weights and the state matrices after 40 steps of random
    play through the twin from a reset."""
    import torch

    from purejaxql_torch.envs import make as make_env
    from purejaxql_torch.models.cnn import CNNQNetwork
    from purejaxql_torch.ops.minatar_rollout import minatar_weights

    env_name, game, channels, actions = GAMES[name][:4]
    module = game_module(name)
    net = CNNQNetwork((10, 10, channels), actions, hidden_size=H, generator=torch.Generator().manual_seed(B)).to(dev)
    weights = minatar_weights(net)
    env, params = make_env(env_name)
    _, state = env.reset(torch.Generator(device=dev).manual_seed(0), B, params)
    states = getattr(module, f"state_matrix_from_{game}")(state)
    states = states if isinstance(states, tuple) else (states,)
    return weights, getattr(module, f"{name}_plain")(3, 1.0, weights, *states, 40)[6:]


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


def minatar_err(name: str, got, want) -> float:
    """max |Q error|, or raises where any other output differs."""
    import torch

    for i, (g, w) in enumerate(zip(got, want)):
        if i != 4 and not torch.equal(g, w):
            raise AssertionError(f"{name} output {i} differs from the twin")
    return (got[4] - want[4]).abs().max().item()


def pendulum_err(got, want) -> float:
    """max |float error|, or raises where done or time differs."""
    import torch

    if not (torch.equal(got[5], want[5]) and torch.equal(got[8], want[8])):
        raise AssertionError("pendulum done or time differs from the twin")
    return max((g - w).abs().max().item() for i, (g, w) in enumerate(zip(got, want)) if i not in (5, 8))


@functools.lru_cache(maxsize=None)
def parent_smem_bytes(src_dir: str, name: str, channels: int, H: int, C: int) -> int:
    """The shared bytes a CTA of the earlier kernel `name` takes: the earlier
    minatar_cluster.cuh's `smem_floats` expression, evaluated with its
    constants and that kernel's own kGameInts."""
    header = open(os.path.join(src_dir, "minatar_cluster.cuh")).read()
    expr = re.search(r"inline int smem_floats\(int kCh, int H, int C, int game_ints\) \{\s*return (.*?);", header, re.S)
    source = open(os.path.join(src_dir, f"{name}.cu")).read()
    game_ints = int(re.search(r"constexpr int kGameInts = (\d+);", source).group(1))
    names = dict(
        kFlat=1024, kCells=100, kFeatures=16, kMaxActions=8, kCh=channels, H=H, C=C, game_ints=game_ints,
        round4=lambda n: (n + 3) // 4 * 4, chunks_of=lambda h, c: 256 // (h // 4 * (2 if c > 1 else 1)),
    )
    return 4 * eval("(" + expr.group(1).replace("/", "//") + ")", {}, names)


def build_parent(src_dir: str):
    """The earlier MinAtar kernels' C entry points as ctypes functions, built
    into build/parent_rollouts/."""
    from purejaxql_torch.ops import build

    out_dir = os.path.join(ROOT, "build", "parent_rollouts")
    os.makedirs(out_dir, exist_ok=True)
    fns = {}
    for name, (*_, game_ints) in GAMES.items():
        lib_path = os.path.join(out_dir, f"{name}.so")
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", src_dir, "-o", lib_path, os.path.join(src_dir, f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the earlier {name}.cu:\n{proc.stdout}{proc.stderr}")
        fn = getattr(ctypes.CDLL(lib_path), f"{name}_f32")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * (16 + 2 * STATES.get(name, 1)) + [ctypes.c_int] * 4 + [ctypes.c_uint64, ctypes.c_float, ctypes.c_int] + [
            ctypes.c_int
        ] * (len(game_ints) + 2) + [ctypes.c_void_p]
        fns[name] = fn
    return fns


def parent_call(fns, name: str, src_dir: str):
    """The earlier wrapper's launch path for `name`: the same outputs,
    allocated the same way, with the current plan's cluster and the earlier
    kernel's own shared bytes (``parent_smem_bytes``)."""
    import torch

    _, game, channels, _, game_ints = GAMES[name]
    module = game_module(name)

    def call(seed, eps, weights, states, T):
        B, H, A, dev = states[0].shape[-1], weights[4].shape[0], weights[8].shape[0], states[0].device
        f32, i32 = dict(dtype=torch.float32, device=dev), dict(dtype=torch.int32, device=dev)
        outs = (
            torch.empty((T, B, 10, 10, channels), **f32), torch.empty((T, B), **i32), torch.empty((T, B), **f32),
            torch.empty((T, B), **i32), torch.empty((T, B, A), **f32), torch.empty((B, 10, 10, channels), **f32),
            *(torch.empty_like(x) for x in states),
        )
        C = getattr(module, f"{game}_plan")(B, H).cluster
        err = fns[name](
            *(x.data_ptr() for x in (*weights, *states, *outs)), T, B, H, A, seed, eps, 1, *game_ints, C,
            parent_smem_bytes(src_dir, name, channels, H, C), torch.cuda.current_stream().cuda_stream,
        )
        assert err == 0, err
        return outs

    return call


def cartpole_inputs(B: int, H: int, dev):
    """Weights of a seeded 2-layer QNetwork and states drawn as a reset
    draws them (U(-0.05, 0.05), time 0)."""
    import torch

    from purejaxql_torch.models.qnet import QNetwork
    from purejaxql_torch.ops.cartpole_rollout import cartpole_weights

    gen = torch.Generator().manual_seed(B)
    net = QNetwork(4, 2, hidden_size=H, num_layers=2, generator=gen).to(dev)
    stf = (torch.rand(4, B, generator=gen) * 0.1 - 0.05).to(dev).contiguous()
    return cartpole_weights(net), stf, torch.zeros(1, B, dtype=torch.int32, device=dev)


def cartpole_err(got, want) -> float:
    """max |float error| (obs and state within 1e-5, Q within 1e-4), or
    raises where an action, reward, done or time differs."""
    import torch

    for i in (1, 2, 3, 7):
        if not torch.equal(got[i], want[i]):
            raise AssertionError(f"cartpole output {i} differs from the twin")
    errs = [(got[i] - want[i]).abs().max().item() for i in (0, 4, 5, 6)]
    if max(errs[0], *errs[2:]) > 1e-5 or errs[1] > 1e-4:
        raise AssertionError(f"cartpole outputs off the twin by {errs}")
    return max(errs)


def build_parent_cartpole(src_dir: str):
    """The earlier CartPole kernel's launch path (one block of H threads an
    env; its C entry point takes the 20 pointers in the wrapper's order,
    T, B, H, A, the seed, eps, use_prng, max_steps and the stream), built
    into build/parent_rollouts/, as a call with the wrapper's arguments."""
    import torch

    from purejaxql_torch.ops import build

    out_dir = os.path.join(ROOT, "build", "parent_rollouts")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, "cartpole_rollout.so")
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", src_dir, "-o", lib_path,
           os.path.join(src_dir, "cartpole_rollout.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the earlier cartpole_rollout.cu:\n{proc.stdout}{proc.stderr}")
    fn = ctypes.CDLL(lib_path).cartpole_rollout_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 20 + [ctypes.c_int] * 4 + [
        ctypes.c_uint64, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]

    def call(seed, eps, weights, stf0, sti0, T):
        B, H, A, dev = stf0.shape[1], weights[0].shape[0], weights[8].shape[0], stf0.device
        f32, i32 = dict(dtype=torch.float32, device=dev), dict(dtype=torch.int32, device=dev)
        outs = (
            torch.empty((T, B, 4), **f32), torch.empty((T, B), **i32), torch.empty((T, B), **f32),
            torch.empty((T, B), **i32), torch.empty((T, B, A), **f32), torch.empty((B, 4), **f32),
            torch.empty((4, B), **f32), torch.empty((1, B), **i32),
        )
        err = fn(*(x.data_ptr() for x in (*weights, stf0, sti0, *outs)), T, B, H, A, seed, eps, 1, 500,
                 torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
        return outs

    return call


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--parent-csrc", default=None,
                    help="directory with the earlier MinAtar rollout sources and their headers")
    ap.add_argument("--out", default=None, help="also write the summary JSON here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_rollouts: no GPU visible", file=sys.stderr)
        return 1
    from purejaxql_torch.ops import cartpole_rollout as cr
    from purejaxql_torch.ops import minatar_rollout
    from purejaxql_torch.ops import pendulum_rollout as pr

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda", 0)
    old = build_parent(args.parent_csrc) if args.parent_csrc else None
    old_cartpole = build_parent_cartpole(args.parent_csrc) if args.parent_csrc else None
    summary = {"card": card, "kernels": {}, "clusters": {}, "parent": {}}

    def timed(label, fn, iters):
        ms = cuda_time_ms(fn, iters)
        print(json.dumps({"timing": label, "ms": ms}))
        return ms

    cases = []
    T, B, H = MINATAR_SHAPE
    for name, (_, game, *_) in GAMES.items():
        module = game_module(name)
        weights, states = minatar_inputs(name, B, H, dev)
        want = getattr(module, f"{name}_plain")(3, 0.1, weights, *states, T)
        kernel = getattr(module, name)
        cases.append((
            name, name, module, f"{game}_plan", MINATAR_SHAPE,
            lambda kernel=kernel, weights=weights, states=states: kernel(3, 0.1, weights, *states, T),
            lambda out, name=name, want=want: minatar_err(name, out, want),
            (lambda call=parent_call(old, name, args.parent_csrc), weights=weights, states=states: call(3, 0.1, weights, states, T))
            if old else None,
        ))
    P, PB, PH = PENDULUM_SHAPE
    aw, cw, stf, sti = pendulum_inputs(PB, PH, dev)
    p_want = pr.pendulum_rollout_plain(3, 0.5, aw, cw, stf, sti, P)
    cases.append((
        "pendulum_ac_rollout", "pendulum_ac_rollout", pr, "pendulum_plan", PENDULUM_SHAPE,
        lambda: pr.pendulum_ac_rollout(3, 0.5, aw, cw, stf, sti, P), lambda out: pendulum_err(out, p_want), None,
    ))
    for shape in CARTPOLE_SHAPES:
        CT, CB, CH = shape
        weights, stf0, sti0 = cartpole_inputs(CB, CH, dev)
        c_want = cr.cartpole_rollout_plain(3, 0.1, weights, stf0, sti0, CT)
        cases.append((
            f"cartpole_rollout_B{CB}", "cartpole_rollout", cr, "cartpole_plan", shape,
            lambda weights=weights, stf0=stf0, sti0=sti0, CT=CT: cr.cartpole_rollout(3, 0.1, weights, stf0, sti0, CT),
            lambda out, c_want=c_want: cartpole_err(out, c_want),
            (lambda weights=weights, stf0=stf0, sti0=sti0, CT=CT: old_cartpole(3, 0.1, weights, stf0, sti0, CT))
            if old_cartpole else None,
        ))
    for label, name, module, plan_name, shape, new_fn, err_of, old_fn in cases:
        b, h = shape[1:]
        plan = getattr(module, plan_name)(b, h)
        entry = {"shape": dict(zip("TBH", shape)), "plan": plan._asdict(), "max_abs_err": err_of(new_fn())}
        if old_fn is None:
            entry["ms"] = timed(name, new_fn, 200)
        else:
            old_out, new_out = old_fn(), new_fn()
            o_err = err_of(old_out)
            # the earlier kernel's outputs against the current one's: every
            # output bit for bit, or else how far the Q-values are apart
            same = all(torch.equal(x, y) for x, y in zip(old_out, new_out))
            q_gap = (old_out[4] - new_out[4]).abs().max().item()
            # in turns: old, new, new, old
            t_old1 = timed(f"earlier {label}", old_fn, 100)
            t_new1 = timed(label, new_fn, 200)
            t_new2 = timed(label, new_fn, 200)
            t_old2 = timed(f"earlier {label}", old_fn, 100)
            entry["ms"] = [t_new1, t_new2]
            summary["parent"][label] = {"ms": [t_old1, t_old2], "max_abs_err": o_err, "outputs_equal": same,
                                        "max_q_gap": q_gap}
        summary["kernels"][label] = entry

        chosen = getattr(module, plan_name)
        summary["clusters"][label] = {}
        for C in CLUSTERS:
            forced = chosen(b, h, C)
            setattr(module, plan_name, lambda B_, H_, C=C: chosen(B_, H_, C))
            try:
                err = err_of(new_fn())
                ms = timed(f"{label} C{C}", new_fn, 200)
            finally:
                setattr(module, plan_name, chosen)
            cell = {"plan": forced._asdict(), "ms": ms, "max_abs_err": err}
            if name in GAMES:
                cell["active_clusters"] = minatar_rollout.active_clusters(name, forced)
            elif name == "cartpole_rollout":
                cell["active_clusters"] = cr.active_clusters(forced, h)
            summary["clusters"][label][C] = cell
    line = json.dumps(summary)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
