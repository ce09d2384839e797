#!/usr/bin/env python3
"""Learning on the classic envs and the shared simulators, on one GPU.

    python scripts/classic_learning_bar.py                     # every run below
    python scripts/classic_learning_bar.py --runs acrobot catch
    python scripts/classic_learning_bar.py --runs cheetah cheetah_lr0 --steps 2000000
    python scripts/classic_learning_bar.py --runs peg_insert go1 go1_lr0

Each run trains through its trainer's entry point (algo/pqn.py or
algo/pqn_ac.py ``make_train``) on the card at its YAML's widths:

- ``acrobot``: ``pqn_cartpole`` on Acrobot-v1 for 300k env steps, held to
  tests/test_pqn_train.py::test_acrobot_learns's bar: the mean of the last 5
  rows of the per-update greedy test return above -160 (random play about
  -490);
- ``catch``: ``pqn_cartpole`` on Catch-bsuite for 200k env steps with
  NUM_ENVS=32, TEST_NUM_ENVS=32 and EPS_FINISH=0.01, held to
  tests/test_pqn_train.py::test_catch_learns_to_perfect's: the mean of the
  last 3 rows above 0.95 (random play about -0.2);
- ``pointmass``, ``cheetah``: ``pqn_dm_suite`` on PointMass-v0 and
  CheetahRun-v0 for 1M env steps; ``pointmass_lr0``, ``cheetah_lr0``: the
  same with LR_START=LR_END=0, so the networks keep their initial weights.
  These have no bar (the JAX package holds these envs to none): the pair
  says whether the learned run separates from the unlearned one;
- ``peg_insert``: ``pqn_manipulation`` on PegInsert-v0 for 1.2M env steps at
  tests/test_manipulation2d.py::test_ac_learns_peg_insertion's settings
  (NUM_ENVS 64, NUM_STEPS 32, 4 minibatches x 2 epochs, H [64, 64], no
  eval), held to its bar, which reads the training returns: the mean of the
  last tenth of the per-update returned_episode_returns above the first
  tenth's + 100;
- ``go1``, ``humanoid_walk``: ``pqn_locomotion`` on Go1JoystickFlatTerrain
  and HumanoidWalk for 1M env steps, each beside its ``_lr0`` run, without
  a bar, as PointMass and CheetahRun.

On the card the cuda policy gives the FF runs the epsilon-greedy kernel
(one launch a rollout step); every run takes its Q(lambda) targets from
the returns kernel, once an update. --steps replaces every run's length.
It prints one JSON line per run: the greedy eval returns at every eval, the
statistic its bar holds (for peg_insert the first and last tenths' means of
the training returns), the best eval, the bar where there is one and
whether it was met, env-steps/s, wall and the card's name and power limit.
It exits non-zero if a run with a bar misses it, and where no GPU is
visible.
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
PEG_INSERT = ["ENV_NAME=PegInsert-v0", "NUM_ENVS=64", "NUM_STEPS=32", "NUM_MINIBATCHES=4", "NUM_EPOCHS=2",
              "ACTOR_HIDDEN_SIZES=[64,64]", "CRITIC_HIDDEN_SIZES=[64,64]", "TEST_DURING_TRAINING=False"]
# run name: (alg, overrides, env steps, bar, rows of the per-update test
# return the bar's mean reads; None: the last tenth of the training returns
# over the first tenth, the bar the margin)
RUNS = {
    "acrobot": ("pqn_cartpole", ["ENV_NAME=Acrobot-v1"], 300_000, -160.0, 5),
    "catch": ("pqn_cartpole", ["ENV_NAME=Catch-bsuite", "NUM_ENVS=32", "TEST_NUM_ENVS=32", "EPS_FINISH=0.01"],
              200_000, 0.95, 3),
    "pointmass": ("pqn_dm_suite", ["ENV_NAME=PointMass-v0"], 1_000_000, None, 5),
    "pointmass_lr0": ("pqn_dm_suite", ["ENV_NAME=PointMass-v0", *LR0], 1_000_000, None, 5),
    "cheetah": ("pqn_dm_suite", ["ENV_NAME=CheetahRun-v0"], 1_000_000, None, 5),
    "cheetah_lr0": ("pqn_dm_suite", ["ENV_NAME=CheetahRun-v0", *LR0], 1_000_000, None, 5),
    "peg_insert": ("pqn_manipulation", PEG_INSERT, 1_200_000, 100.0, None),
    "go1": ("pqn_locomotion", ["ENV_NAME=Go1JoystickFlatTerrain"], 1_000_000, None, 5),
    "go1_lr0": ("pqn_locomotion", ["ENV_NAME=Go1JoystickFlatTerrain", *LR0], 1_000_000, None, 5),
    "humanoid_walk": ("pqn_locomotion", ["ENV_NAME=HumanoidWalk"], 1_000_000, None, 5),
    "humanoid_walk_lr0": ("pqn_locomotion", ["ENV_NAME=HumanoidWalk", *LR0], 1_000_000, None, 5),
}


def main() -> int:
    import torch

    from purejaxql_torch.algo import pqn, pqn_ac
    from purejaxql_torch.core.config import compose

    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", nargs="+", default=list(RUNS), choices=sorted(RUNS))
    ap.add_argument("--steps", type=int, default=None, help="every run's env steps (default: each run's own)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    missed = []
    for run in args.runs:
        alg, overrides, steps, bar, rows = RUNS[run]
        steps = args.steps or steps
        config = compose(alg=alg, overrides=[f"TOTAL_TIMESTEPS={steps}", f"TOTAL_TIMESTEPS_DECAY={steps}", *overrides])
        trainer = pqn_ac if config["ALG_NAME"] == "pqn_ac" else pqn
        train = trainer.make_train(config)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        state = out["runner_state"][0]
        env_steps = (state["actor"] if isinstance(state, dict) else state).timesteps
        m = {k: v.cpu().numpy() for k, v in out["metrics"].items()}
        train_returns = m["returned_episode_returns"]
        row = {"run": run, "alg": alg, "env": config["ENV_NAME"], "overrides": overrides, "env_steps": env_steps}
        if rows is None:
            tenth = len(train_returns) // 10
            first, last = float(train_returns[:tenth].mean()), float(train_returns[-tenth:].mean())
            stat = last - first
            row.update(first_tenth_train_mean=first, last_tenth_train_mean=last)
        else:
            tests = m["test/returned_episode_returns"]
            interval = max(1, int(len(tests) * config["TEST_INTERVAL"]))
            stat = float(tests[-rows:].mean())
            row.update({"evals": [round(float(v), 3) for v in tests[interval - 1 :: interval]],
                        f"last{rows}_rows_mean": stat, "best_eval": float(tests.max())})
        met = None if bar is None else stat > bar
        if met is False:
            missed.append(run)
        print(json.dumps({
            **row, "last_train_return": float(train_returns[-1]), "bar": bar, "met": met, "wall_s": wall,
            "env_steps_per_s": env_steps / wall, "exploration_kernel": config.get("EXPLORATION_KERNEL"),
            "card": card,
        }), flush=True)
    if missed:
        print(f"classic_learning_bar: FAIL: {missed} missed the bar", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
