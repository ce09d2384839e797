#!/usr/bin/env python3
"""Learning of the actor-critic trainer beyond Pendulum, on one GPU.

    python scripts/ac_learning_bar.py                          # SwingUp, the bar
    python scripts/ac_learning_bar.py --runs swingup hopper hopper_lr0 pusher pusher_lr0
    python scripts/ac_learning_bar.py --runs hopper --steps 2000000
    python scripts/ac_learning_bar.py --runs pendulum reacher --seeds 0 1 2 3 --report   # gates over seeds

Each run trains through the trainer's entry point (algo/pqn_ac.py
``make_train``) on the card at its YAML's widths:

- ``swingup``: ``pqn_dm_suite`` (CartPoleSwingUp-v0) for 1M env steps with
  NUM_ENVS=64 and TEST_NUM_ENVS=32, held to the bar of
  tests/test_continuous_envs.py::test_ac_learns_swingup: the mean of the last
  5 greedy evals above 100 (hanging scores about 0-30, upright about 500).
  That test reads the last 5 rows of the per-update metric, which repeat
  the latest eval; that mean is printed beside it;
- ``hopper``, ``pusher``: ``pqn_locomotion`` (Hopper-v0) and
  ``pqn_manipulation`` (Pusher-v0) for 1M env steps at the YAML's 256 envs;
  ``hopper_lr0``, ``pusher_lr0``: the same with LR_START=LR_END=0, so the
  networks keep their initial weights. These have no bar: the pair says
  whether the learned run separates from the unlearned one;
- ``pendulum``: ``pqn_pendulum`` for 400k env steps, on the GPU through the
  fused Pendulum kernel by the cuda policy, held to
  tests/test_pqn_ac.py::test_ac_learns_pendulum's bar for one run: the best
  greedy eval above -500; ``reacher``: ``pqn_reacher`` for 400k env steps,
  held to tests/test_pqn_ac.py::test_ac_learns_reacher's: the best greedy
  eval above -70. One seed learns past them in about half of the runs, so
  chip_smoke.py holds the best over several seeds to them: Pendulum's seeds
  past 0 run by this script with --report, Reacher's 4 seeds as one program
  (NUM_SEEDS=4).

--steps replaces every run's length. It prints one JSON line per run and
seed: the greedy eval returns at every eval, the mean of the last 5, the
best, the bar where there is one and whether it was met, env-steps/s, wall
and the card's name and power limit. It exits non-zero if a run with a bar
misses it, unless --report is given.
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

LR0 = ["LR_START=0.0", "LR_END=0.0"]
# run name: (alg, overrides, env steps, bar, the statistic the bar holds:
# the mean of the last 5 evals or the best eval)
RUNS = {
    "swingup": ("pqn_dm_suite", ["NUM_ENVS=64", "TEST_NUM_ENVS=32"], 1_000_000, 100.0, "last5"),
    "hopper": ("pqn_locomotion", [], 1_000_000, None, None),
    "hopper_lr0": ("pqn_locomotion", LR0, 1_000_000, None, None),
    "pusher": ("pqn_manipulation", [], 1_000_000, None, None),
    "pusher_lr0": ("pqn_manipulation", LR0, 1_000_000, None, None),
    "pendulum": ("pqn_pendulum", [], 400_000, -500.0, "best"),
    "reacher": ("pqn_reacher", [], 400_000, -70.0, "best"),
}


def main() -> int:
    import torch

    from purejaxql_torch.algo import pqn_ac
    from purejaxql_torch.core.config import compose

    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", nargs="+", default=["swingup"], choices=sorted(RUNS))
    ap.add_argument("--steps", type=int, default=None, help="every run's env steps (default: each run's own)")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--report", action="store_true",
                    help="exit 0 whether or not a run meets its bar (a gate over seeds reads the lines)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    missed = []
    for run, seed in ((r, s) for r in args.runs for s in args.seeds):
        alg, overrides, steps, bar, statistic = RUNS[run]
        config = compose(alg=alg, overrides=[f"TOTAL_TIMESTEPS={args.steps or steps}", f"SEED={seed}", *overrides])
        train = pqn_ac.make_train(config)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        env_steps = out["runner_state"][0]["actor"].timesteps
        m = {k: v.cpu().numpy() for k, v in out["metrics"].items()}
        interval = max(1, int(len(m["env_step"]) * config["TEST_INTERVAL"]))
        evals = m["test/returned_episode_returns"][interval - 1 :: interval]
        last5 = float(evals[-5:].mean())
        last5_rows = float(m["test/returned_episode_returns"][-5:].mean())
        best = float(m["test/returned_episode_returns"].max())
        met = None if bar is None else (last5 if statistic == "last5" else best) > bar
        if met is False:
            missed.append(f"{run}:{seed}")
        print(json.dumps({
            "run": run, "seed": seed, "alg": alg, "env": config["ENV_NAME"], "overrides": overrides,
            "fused": bool(config.get("FUSED_ROLLOUT", False)), "env_steps": env_steps,
            "evals": [round(float(v), 3) for v in evals], "last5_eval_mean": last5, "last5_rows_mean": last5_rows,
            "best_eval": best, "bar": bar, "bar_on": statistic, "met": met, "wall_s": wall,
            "env_steps_per_s": env_steps / wall, "card": card,
        }), flush=True)
    if missed and not args.report:
        print(f"ac_learning_bar: FAIL: {missed} missed the bar", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
