#!/usr/bin/env python3
"""Learning with the network configurations of the JAX modules beyond the
YAMLs' defaults, on one GPU.

    python scripts/network_learning_bar.py                  # every run below, one after another
    python scripts/network_learning_bar.py --jobs 7         # the same, 7 runs at once on the card
    python scripts/network_learning_bar.py --runs spread_lstm --steps 100000

Each run trains through the CLI's entry point (``cli.single_run``) on the
card:

- ``spread_lstm``: ``pqn_vdn_spread`` with RNN_CELL=lstm at
  tests/test_pqn_vdn.py::test_vdn_learns_spread's settings (400k env steps,
  64 envs, H 128, no eval), held to its bar: the mean team return of the
  last tenth of updates above the first tenth's + 3.0;
- ``breakout_bn``: ``pqn_minatar`` on Breakout-MinAtar with a batch_norm
  CNN trunk for 500k env steps (unfused: the epsilon-greedy kernel a
  rollout step);
- ``rnn_cartpole_bn``: ``pqn_rnn_cartpole`` with NORM_TYPE=batch_norm for
  200k env steps (the module path);
- ``pong_nature_bf16``: ``pqn_host_minatar`` on Pong-EH with the Nature
  trunk in bfloat16 (BF16_COMPUTE) at scripts/host_learning_bar.py's
  settings and its sync bar's length, 1.2M env steps;

each of the last three beside its ``_lr0`` run (LR=0: the network keeps
its initial weights) without a bar: the pair says whether the learned run
separates from the unlearned one. --steps replaces every run's length.

It prints one JSON line per run: the means of the first and last tenths of
the per-update training returns, the bar where there is one and whether it
was met, env-steps/s, wall, and the card's name and power limit. With
--jobs the runs go to that many processes at once (each its own CUDA
context on the one card; the host's cores shared, so each run's wall is
longer than alone). It exits non-zero if a run with a bar misses it or a
run fails, and where no GPU is visible.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

LR0 = ["LR=0.0"]
HOST = ["ENV_NAME=Pong-EH", "CNN_TRUNK=nature", "SCORE_GAME=Pong-v5", "BF16_COMPUTE=True", "NUM_ENVS=64",
        "NUM_STEPS=32", "NUM_MINIBATCHES=8", "NUM_EPOCHS=2", "LR=0.0003", "TEST_ENVS=8", "EPS_DECAY=0.25"]
# run name: (alg, overrides, env steps, the bar in words, the bar on (first
# tenth, last tenth) of the training returns, or None)
RUNS = {
    "spread_lstm": ("pqn_vdn_spread", ["RNN_CELL=lstm", "NUM_ENVS=64", "HIDDEN_SIZE=128",
                                       "TEST_DURING_TRAINING=False"], 400_000, "last tenth > first tenth + 3.0",
                    lambda first, last: last > first + 3.0),
    "breakout_bn": ("pqn_minatar", ["ENV_NAME=Breakout-MinAtar", "NORM_TYPE=batch_norm"], 500_000, None, None),
    "breakout_bn_lr0": ("pqn_minatar", ["ENV_NAME=Breakout-MinAtar", "NORM_TYPE=batch_norm", *LR0], 500_000,
                        None, None),
    "rnn_cartpole_bn": ("pqn_rnn_cartpole", ["NORM_TYPE=batch_norm"], 200_000, None, None),
    "rnn_cartpole_bn_lr0": ("pqn_rnn_cartpole", ["NORM_TYPE=batch_norm", *LR0], 200_000, None, None),
    "pong_nature_bf16": ("pqn_host_minatar", HOST, 1_200_000, None, None),
    "pong_nature_bf16_lr0": ("pqn_host_minatar", [*HOST, *LR0], 1_200_000, None, None),
}


def run_one(name: str, steps, card: str) -> bool:
    """Train ``name`` and print its JSON line; False if it has a bar and
    missed it."""
    import numpy as np
    import torch

    from purejaxql_torch import cli
    from purejaxql_torch.core.config import compose

    alg, overrides, default_steps, bar_text, bar = RUNS[name]
    steps = steps or default_steps
    config = compose(alg=alg, overrides=[f"TOTAL_TIMESTEPS={steps}", f"TOTAL_TIMESTEPS_DECAY={steps}", "SAVE_PATH=null",
                                         *overrides])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = cli.single_run(config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    env_steps = out["runner_state"][0].timesteps
    returns = np.asarray(out["metrics"]["returned_episode_returns"].cpu())
    tenth = max(1, len(returns) // 10)
    first, last = float(returns[:tenth].mean()), float(returns[-tenth:].mean())
    met = None if bar is None else bool(bar(first, last))
    print(json.dumps({
        "run": name, "alg": alg, "overrides": overrides, "env_steps": env_steps, "updates": len(returns),
        "first_tenth_train_mean": first, "last_tenth_train_mean": last, "bar": bar_text, "met": met,
        "wall_s": wall, "env_steps_per_s": env_steps / wall, "exploration_kernel": config.get("EXPLORATION_KERNEL"),
        "card": card,
    }), flush=True)
    return met is not False


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", nargs="+", default=list(RUNS), choices=sorted(RUNS))
    ap.add_argument("--steps", type=int, default=None, help="every run's env steps (default: each run's own)")
    ap.add_argument("--jobs", type=int, default=1, help="runs at once, each in a process of its own")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    failed = []
    if args.jobs <= 1:
        failed = [name for name in args.runs if not run_one(name, args.steps, card)]
    else:
        pending, running = list(args.runs), {}
        while pending or running:
            while pending and len(running) < args.jobs:
                name = pending.pop(0)
                cmd = [sys.executable, os.path.abspath(__file__), "--runs", name]
                if args.steps:
                    cmd += ["--steps", str(args.steps)]
                running[name] = subprocess.Popen(cmd)
            time.sleep(1.0)
            for name, proc in list(running.items()):
                if proc.poll() is not None:
                    del running[name]
                    if proc.returncode != 0:
                        failed.append(name)
    if failed:
        print(f"network_learning_bar: FAIL: {failed} missed the bar or failed", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
