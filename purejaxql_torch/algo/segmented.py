"""Segmented training: one long run as a few calls of ``train``, the
runner_state carried from one to the next (port of
purejaxql_tpu/algo/segmented.py).

The metrics reach the host once a segment, and the full state can be
checkpointed at segment boundaries (``on_segment``). Every segment
continues the run (``train(runner_state=...)``): the schedules keep
the full-horizon decay and follow the carried counters, and the draws come
from the generators carried in the runner_state, so the segmented run is
bit-identical to one ``train`` of the whole length on the same device.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from purejaxql_torch.algo import pqn


def train_segmented(
    config: Dict[str, Any],
    num_segments: int,
    seed: Optional[int] = None,
    num_seeds: Optional[int] = None,
    logger=None,
    on_segment: Optional[Callable[[int, Any, Dict], None]] = None,
    make_train: Callable = pqn.make_train,
):
    """Train ``config`` in ``num_segments`` calls of one ``train``.

    Returns {"runner_state", "metrics"}, each metric (NUM_SEEDS,
    NUM_UPDATES): the segments' concatenated along the update axis, the
    seed axis first as the JAX package's vmapped segments give it. Each
    segment's metrics go to ``logger.log_history`` unless LOG_VIA_CALLBACK
    has logged them as they came.
    """
    config = dict(config)
    total = int(float(config["TOTAL_TIMESTEPS"]))
    config["TOTAL_TIMESTEPS_DECAY"] = int(float(config.get("TOTAL_TIMESTEPS_DECAY", total)))
    assert total % num_segments == 0, "num_segments must divide TOTAL_TIMESTEPS"
    if num_seeds is not None:
        config["NUM_SEEDS"] = num_seeds
    seeds = config.get("NUM_SEEDS", 1)
    # the full-horizon decay is kept, so that the schedules span the whole run
    seg_config = {**config, "TOTAL_TIMESTEPS": total // num_segments}

    train = make_train(seg_config, logger=logger)
    runner_state = None
    all_metrics = []
    for seg in range(num_segments):
        outs = train(seed, runner_state=runner_state)
        runner_state = outs["runner_state"]
        device = next(runner_state[0].network.parameters()).device
        if device.type == "cuda":
            torch.cuda.synchronize(device)  # segment boundaries are real sync points
        metrics = outs["metrics"]
        all_metrics.append({k: v[None] if seeds == 1 else v for k, v in metrics.items()})
        if on_segment is not None:
            on_segment(seg, runner_state, metrics)
        if logger is not None and not config.get("LOG_VIA_CALLBACK", False):
            logger.log_history(metrics)

    metrics = {k: torch.cat([m[k] for m in all_metrics], 1) for k in all_metrics[0]} if all_metrics[0] else {}
    return {"runner_state": runner_state, "metrics": metrics}
