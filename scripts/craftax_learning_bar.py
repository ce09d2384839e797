#!/usr/bin/env python3
"""Whether learned and non-learning Craftax runs separate, on one GPU: where
a learning bar for chip_smoke.py's Craftax phase could sit.

    python scripts/craftax_learning_bar.py                    # learned and LR=0, seeds 0 and 1
    python scripts/craftax_learning_bar.py --runs learned:2 lr0:2 random:0
    python scripts/craftax_learning_bar.py --steps 8388608 --runs learned:1
    python scripts/craftax_learning_bar.py --steps 8388608 --program strict fast --runs learned:0 learned:1
    python scripts/craftax_learning_bar.py --alg pqn_rnn_craftax --steps 8388608 --runs learned:0 lr0:0

Each run trains --alg at full width for chip_smoke.py's CRAFTAX_STEPS env
steps (or --steps), through the cuda policy (the epsilon-greedy kernel):
``pqn_craftax`` (the default: Forager, H 1024 x 4 with an input BatchRenorm,
1024 envs x 1 step, resets at ratio 16, 1-step TD) or ``pqn_rnn_craftax``
(Forager, an LSTM H 512 after one dense layer with the last action as input,
an input BatchRenorm, 1024 envs x 128 steps, resets at ratio 16, Q(lambda)
over the window, done-masked info metrics), in each program of --program
(default fast):

- ``fast``: the YAML as the cuda policy completes it: the reset bank
  (RESET_BANK=256), and for pqn_craftax FAST_TARGETS and SKIP_NOOP_PERMUTE,
  for pqn_rnn_craftax FAST_BPTT;
- ``strict``: PARITY=strict with EXPLORATION_KERNEL=pallas: optimistic
  resets, and for pqn_craftax the concat 1-step TD and a permuted
  minibatch, for pqn_rnn_craftax the module path;

each run of --runs in every program in turn, the run as one of:

- ``learned:<seed>``: the YAML's config;
- ``lr0:<seed>``: LR=0, so the network keeps its initial weights (the
  BatchRenorm statistics still move);
- ``random:<seed>``: epsilon held at 1, uniform random actions.

and prints one JSON line per run with chip_smoke.py's ``craftax_bar_metric``
(the done-masked returned_episode_returns over the last 10 % of updates that
ended an episode), the run's env-steps/s and the card's name and power
limit.
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

KINDS = {"learned": [], "lr0": ["LR=0"], "random": ["EPS_START=1.0", "EPS_FINISH=1.0"]}
PROGRAMS = {"fast": [], "strict": ["PARITY=strict", "EXPLORATION_KERNEL=pallas"]}


def main() -> int:
    import torch

    from chip_smoke import CRAFTAX_STEPS, craftax_bar_metric
    from purejaxql_torch.algo import pqn, pqn_rnn
    from purejaxql_torch.core.config import compose

    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", nargs="+", default=["learned:0", "learned:1", "lr0:0", "lr0:1"],
                    help="kind:seed, kind one of " + ", ".join(KINDS))
    ap.add_argument("--alg", default="pqn_craftax", choices=["pqn_craftax", "pqn_rnn_craftax"])
    ap.add_argument("--steps", type=int, default=CRAFTAX_STEPS)
    ap.add_argument("--program", nargs="+", default=["fast"], choices=sorted(PROGRAMS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    for run, program in ((r, p) for r in args.runs for p in args.program):
        kind, seed = run.split(":")
        config = compose(alg=args.alg, overrides=[
            f"TOTAL_TIMESTEPS={args.steps}", f"TOTAL_TIMESTEPS_DECAY={args.steps}", f"SEED={seed}", *KINDS[kind],
            *PROGRAMS[program],
        ])
        train = (pqn_rnn if args.alg == "pqn_rnn_craftax" else pqn).make_train(config)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        metrics = {k: v.cpu().numpy() for k, v in out["metrics"].items()}
        value, n_ended = craftax_bar_metric(metrics)
        tail = len(metrics["td_loss"]) // 10
        print(json.dumps({
            "alg": args.alg, "program": program, "run": run, "bar_metric": value, "updates_with_an_end": n_ended,
            "achievement_count_last_10pct": float(metrics["achievement_count"][-tail:].mean()),
            "returned_episode_lengths_last_10pct": float(
                metrics["returned_episode_lengths"][-tail:][metrics["returned_episode"][-tail:] > 0].mean()
            ),
            "env_steps": out["runner_state"][0].timesteps, "wall_s": wall,
            "env_steps_per_s": out["runner_state"][0].timesteps / wall, "card": card,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
