"""Hyperparameter sweeps (port of purejaxql_tpu/utils/sweep.py).

Where wandb is importable, its bayes sweep runs over the space; otherwise a
random search over the same space runs locally and reports the best
trial. The search draws from ``random.Random(SEED)`` as the JAX package's
does, so both packages pick the same trials. Each trial is one call of the
port's own ``train()``, its NUM_SEEDS seeds as one program.
"""

from __future__ import annotations

import copy
import json
import random
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np

DEFAULT_SPACE: Dict[str, List[Any]] = {
    "LR": [0.001, 0.0005, 0.0001, 0.00005],
}


def _objective(config) -> float:
    """Train and return the mean of the last twentieth of the updates'
    returned_episode_returns over the seeds."""
    from purejaxql_torch.cli import _select_make_train

    outs = _select_make_train(config)(config)()
    rets = np.atleast_2d(outs["metrics"]["returned_episode_returns"].cpu().numpy())
    return float(rets[:, -max(1, rets.shape[1] // 20):].mean())


def run_sweep(config: Dict[str, Any], count: Optional[int] = None) -> Dict[str, Any]:
    space = config.get("SWEEP_SPACE", DEFAULT_SPACE)
    count = count or int(config.get("SWEEP_COUNT", 8))

    try:
        import wandb  # optional
    except ImportError:
        wandb = None
    if wandb is not None:
        return _wandb_sweep(config, space, count, wandb)

    rng = random.Random(config.get("SEED", 0))
    best, best_score = None, -float("inf")
    for i in range(count):
        trial = copy.deepcopy(config)
        picks = {k: rng.choice(v) for k, v in space.items()}
        trial.update(picks)
        t0 = time.time()
        score = _objective(trial)
        print(
            json.dumps({"trial": i, "picks": picks, "score": score, "seconds": round(time.time() - t0, 1)}),
            file=sys.stderr,
        )
        if score > best_score:
            best, best_score = picks, score
    print(json.dumps({"best": best, "score": best_score}))
    return {"best": best, "score": best_score}


def _wandb_sweep(config, space, count, wandb):
    sweep_config = {
        "name": f"{config.get('ALG_NAME', 'pqn')}_{config['ENV_NAME']}",
        "method": "bayes",
        "metric": {"name": "returned_episode_returns", "goal": "maximize"},
        "parameters": {k: {"values": v} for k, v in space.items()},
    }

    def agent_fn():
        wandb.init(project=config.get("PROJECT", ""))
        trial = copy.deepcopy(config)
        trial.update(dict(wandb.config))
        wandb.log({"returned_episode_returns": _objective(trial)})

    sweep_id = wandb.sweep(sweep_config, entity=config.get("ENTITY", ""), project=config.get("PROJECT", ""))
    wandb.agent(sweep_id, agent_fn, count=count)
    return {"sweep_id": sweep_id}
