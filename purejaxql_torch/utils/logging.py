"""Metric sinks (port of purejaxql_tpu/utils/logging.py): console
(throttled) and JSONL file. The trainer returns stacked metrics
and ``MetricLogger.log_history`` replays them through the sinks after the
run. The wandb sink is not ported yet.
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


class MetricLogger:
    """Fan-out logger over a list of sinks."""

    def __init__(self, sinks: Optional[List[Sink]] = None):
        self.sinks = sinks if sinks is not None else []

    def log(self, metrics: Dict[str, Any], step: int) -> None:
        for sink in self.sinks:
            sink.log(metrics, step)

    def log_history(self, metrics: Dict[str, Any], step_key: str = "update_steps") -> None:
        """Replay stacked metrics (tensors of shape (num_updates,)) through
        the sinks, one row per update. One device-to-host copy per key."""
        arrs = {
            k: v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
            for k, v in metrics.items()
        }
        arrs = {k: v for k, v in arrs.items() if v.ndim >= 1}
        if not arrs:
            return
        for i in range(next(iter(arrs.values())).shape[0]):
            row = {k: v[i] for k, v in arrs.items()}
            self.log(row, int(row.get(step_key, i)))

    def close(self):
        for sink in self.sinks:
            sink.close()


def make_logger(config: Dict[str, Any]) -> MetricLogger:
    sinks: List[Sink] = []
    if config.get("LOG_CONSOLE", False):
        sinks.append(ConsoleSink())
    if config.get("LOG_JSONL"):
        sinks.append(JsonlSink(config["LOG_JSONL"]))
    if str(config.get("LOG_MODE", "disabled")) == "online":
        print("the wandb sink is not ported yet; logging to the other sinks", file=sys.stderr)
    return MetricLogger(sinks)
