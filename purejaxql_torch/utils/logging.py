"""Metric sinks (port of purejaxql_tpu/utils/logging.py): console
(throttled), JSONL file, in-memory (for tests) and wandb where the package
is importable. The trainer returns stacked metrics and
``MetricLogger.log_history`` replays them through the sinks after the run;
with LOG_VIA_CALLBACK the trainers hand each update's metrics, one seed at
a time, to ``MetricLogger.make_callback()`` as they go (the JAX package's
``jax.debug.callback``). With WANDB_LOG_ALL_SEEDS each row is repeated under
``rng{i}/<key>``, ``i`` the seed's lane index (the JAX package tags rows with
the seed key's first word).
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch


class Sink:
    def log(self, metrics: Dict[str, Any], step: int) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class ConsoleSink(Sink):
    def __init__(self, interval_s: float = 2.0, keys: Optional[List[str]] = None):
        self.interval_s = interval_s
        self.keys = keys
        self._last = 0.0

    def log(self, metrics, step):
        now = time.time()
        if now - self._last < self.interval_s:
            return
        self._last = now
        parts = []
        for k in self.keys or sorted(metrics):
            v = metrics.get(k)
            if isinstance(v, (int, np.integer)):
                parts.append(f"{k}={v}")
            elif isinstance(v, (float, np.floating)):
                parts.append(f"{k}={v:.4g}")
        print(f"[step {step}] " + " ".join(parts), file=sys.stderr)


class JsonlSink(Sink):
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")

    def log(self, metrics, step):
        row = {"step": int(step)}
        for k, v in metrics.items():
            if isinstance(v, (np.integer, np.floating, np.bool_)):
                row[k] = v.item()
            elif isinstance(v, (int, float, str, bool)):
                row[k] = v
        self._f.write(json.dumps(row) + "\n")

    def close(self):
        self._f.close()


class MemorySink(Sink):
    def __init__(self):
        self.rows: List[Dict[str, Any]] = []

    def log(self, metrics, step):
        self.rows.append({"step": int(step), **metrics})


class WandbSink(Sink):
    def __init__(self, **init_kwargs):
        import wandb  # optional dependency

        self._wandb = wandb
        if wandb.run is None:
            wandb.init(**init_kwargs)

    def log(self, metrics, step):
        self._wandb.log(metrics, step=step)


class MetricLogger:
    """Fan-out logger over a list of sinks. ``make_callback()`` returns the
    ``callback(metrics, seed_id)`` the trainers call under LOG_VIA_CALLBACK."""

    def __init__(self, sinks: Optional[List[Sink]] = None, log_all_seeds: bool = False):
        self.sinks = sinks if sinks is not None else []
        self.log_all_seeds = log_all_seeds

    def log(self, metrics: Dict[str, Any], step: int) -> None:
        for sink in self.sinks:
            sink.log(metrics, step)

    def make_callback(self, step_key: str = "update_steps"):
        def callback(metrics, seed_id):
            metrics = {k: np.asarray(v).item() if np.ndim(v) == 0 else np.asarray(v) for k, v in metrics.items()}
            if self.log_all_seeds:
                metrics = {**metrics, **{f"rng{int(seed_id)}/{k}": v for k, v in metrics.items()}}
            self.log(metrics, int(metrics.get(step_key, 0)))

        return callback

    def log_history(self, metrics: Dict[str, Any], step_key: str = "update_steps") -> None:
        """Replay stacked metrics (tensors of shape (num_updates,), or
        (num_seeds, num_updates) with seeds: one seed after another, as
        purejaxql_tpu/utils/logging.py:117-131 does) through the sinks, one
        row per update. One device-to-host copy per key."""
        arrs = {
            k: v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
            for k, v in metrics.items()
        }
        arrs = {k: v for k, v in arrs.items() if v.ndim >= 1}
        if not arrs:
            return
        if next(iter(arrs.values())).ndim >= 2:  # a leading seed axis
            for s in range(next(iter(arrs.values())).shape[0]):
                self.log_history({k: v[s] for k, v in arrs.items()}, step_key)
            return
        for i in range(next(iter(arrs.values())).shape[0]):
            row = {k: v[i] for k, v in arrs.items()}
            self.log(row, int(row.get(step_key, i)))

    def close(self):
        for sink in self.sinks:
            sink.close()


def make_logger(config: Dict[str, Any]) -> MetricLogger:
    """The sinks the config asks for. In a process group only rank 0 owns
    them (logging.py:143-151: the metrics are the same on every rank, so
    rank 0's rows are the run's), unless LOG_ALL_PROCESSES."""
    from purejaxql_torch.parallel.mesh import is_main_process

    if not config.get("LOG_ALL_PROCESSES", False) and not is_main_process():
        return MetricLogger([])
    sinks: List[Sink] = []
    mode = str(config.get("LOG_MODE", config.get("WANDB_MODE", "disabled")))
    if config.get("LOG_CONSOLE", False):
        sinks.append(ConsoleSink())
    if config.get("LOG_JSONL"):
        sinks.append(JsonlSink(config["LOG_JSONL"]))
    if mode == "online":
        try:
            sinks.append(WandbSink(entity=config.get("ENTITY", ""), project=config.get("PROJECT", ""), config=config))
        except ImportError:
            print("wandb not available; skipping wandb sink", file=sys.stderr)
    return MetricLogger(sinks, log_all_seeds=config.get("WANDB_LOG_ALL_SEEDS", False))
