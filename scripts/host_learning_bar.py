#!/usr/bin/env python3
"""Learning of the host-env trainer (pqn_host) at the JAX package's slow
bars, on one GPU.

    python scripts/host_learning_bar.py                      # every run below
    python scripts/host_learning_bar.py --runs pong_ram_sync
    python scripts/host_learning_bar.py --runs breakout_ram --steps 1000000

Each run trains ``pqn_host_minatar`` through the trainer's entry points
(algo/pqn_host.py ``make_train``, or with ASYNC_ENVS ``make_train_async``)
on the card, the C++ pool on the host, at the JAX tests' settings (64 + 8
test envs x 32 steps, 8 minibatches x 2 epochs, H 128, LR 3e-4, EPS_DECAY
0.25, TOTAL_TIMESTEPS_DECAY the run's length):

- ``pong_ram_async``: tests/test_pong_plugin.py:188-216, the lag-1 trainer
  on PongRam-EH for 2.4M env steps: the last tenth's mean training return
  above -5 (random play -21);
- ``breakout_ram``: tests/test_breakout_plugin.py:126-157, the synchronous
  trainer on BreakoutRam-EH for 3M: the last tenth's mean training return
  above max(1.4 x the first tenth's, 13) (a do-nothing policy scores 0);
- ``pong_ram_sync``: tests/test_pong_plugin.py:124-155, the synchronous
  trainer on PongRam-EH for 1.2M: the last tenth above -5 and its greedy
  (TEST_ENVS) return above -8. chip_smoke.py holds the cheaper host gate
  of tests/test_pqn_host.py:36-55 on host CartPole instead.

The tenths are the JAX tests' slices, ``rets[: n // 10]`` and
``rets[-n // 10:]``. --steps replaces every run's length. It prints one JSON
line per run: the first and last tenths' returns (training and greedy), the
bar and whether it was met, env-steps/s, wall and the card's name and power
limit. It exits non-zero if a run misses its bar.
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

SETTINGS = ["NUM_ENVS=64", "NUM_STEPS=32", "NUM_MINIBATCHES=8", "NUM_EPOCHS=2", "LR=0.0003", "HIDDEN_SIZE=128",
            "TEST_ENVS=8", "EPS_DECAY=0.25"]
# run name: (env, ASYNC_ENVS, env steps, the bar in words, the bar on (last
# tenth, first tenth, last tenth greedy))
RUNS = {
    "pong_ram_async": ("PongRam-EH", True, 2_400_000, "last tenth > -5", lambda late, early, test: late > -5.0),
    "breakout_ram": ("BreakoutRam-EH", False, 3_000_000, "last tenth > max(1.4 x first tenth, 13)",
                     lambda late, early, test: late > max(1.4 * early, 13.0)),
    "pong_ram_sync": ("PongRam-EH", False, 1_200_000, "last tenth > -5 and its greedy return > -8",
                      lambda late, early, test: late > -5.0 and test > -8.0),
}


def main() -> int:
    import numpy as np
    import torch

    from purejaxql_torch.algo import pqn_host
    from purejaxql_torch.core.config import compose

    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", nargs="+", default=["pong_ram_sync", "pong_ram_async", "breakout_ram"], choices=sorted(RUNS))
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
        env_name, asynchronous, steps, bar_text, bar = RUNS[run]
        steps = args.steps or steps
        config = compose(alg="pqn_host_minatar", overrides=[
            f"ENV_NAME={env_name}", f"TOTAL_TIMESTEPS={steps}", f"TOTAL_TIMESTEPS_DECAY={steps}", *SETTINGS,
            f"ASYNC_ENVS={asynchronous}",
        ])
        train = (pqn_host.make_train_async if asynchronous else pqn_host.make_train)(config)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        env_steps = out["runner_state"][0].timesteps
        m = {k: v.cpu().numpy() for k, v in out["metrics"].items()}
        rets, test = m["returned_episode_returns"], m["test/returned_episode_returns"]
        n = len(rets)
        early, late, test_late = (float(np.nanmean(x)) for x in (rets[: n // 10], rets[-n // 10:], test[-n // 10:]))
        met = bool(bar(late, early, test_late))
        if not met:
            missed.append(run)
        print(json.dumps({
            "run": run, "env": env_name, "async": asynchronous, "env_steps": env_steps, "updates": n,
            "first_tenth_return": early, "last_tenth_return": late, "last_tenth_test_return": test_late,
            "bar": bar_text, "met": met, "wall_s": wall, "env_steps_per_s": env_steps / wall,
            "policy": {"EXPLORATION_KERNEL": config.get("EXPLORATION_KERNEL")}, "card": card,
        }), flush=True)
    if missed:
        print(f"host_learning_bar: FAIL: {missed} missed the bar", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
