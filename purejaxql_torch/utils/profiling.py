"""Profiling and throughput accounting (port of
purejaxql_tpu/utils/profiling.py).

- ``trace(logdir)``: a context manager around ``torch.profiler`` that
  writes a Chrome trace (``<logdir>/trace.json``);
- ``force``: wait for the device work behind a tree of tensors;
- ``time_fn``: wall time of a function, best and mean of ``iters`` calls
  after ``warmup``, each forced;
- ``Throughput``: env-steps/s between marks;
- ``stage_timings``: each stage of a ``PQNStages`` bundle timed on its own.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block: ``with trace("/tmp/prof"): run()``. The CUDA
    activity is traced where a GPU is visible."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _leaves(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif hasattr(tree, "__dataclass_fields__"):
        for name in tree.__dataclass_fields__:
            yield from _leaves(getattr(tree, name))


def force(tree) -> None:
    """Wait until every CUDA device that holds a tensor of ``tree`` has
    finished its queued work."""
    for device in {t.device for t in _leaves(tree) if t.device.type == "cuda"}:
        torch.cuda.synchronize(device)


def time_fn(fn: Callable, *args, warmup: int = 1, iters: int = 3) -> Dict[str, float]:
    """Time fn(*args): {"best_s", "mean_s"} over ``iters`` calls after
    ``warmup`` calls, each forced."""
    for _ in range(warmup):
        force(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        force(fn(*args))
        times.append(time.perf_counter() - t0)
    return {"best_s": min(times), "mean_s": sum(times) / len(times)}


class Throughput:
    """Env-steps/s accounting between marks (host clock)."""

    def __init__(self):
        self.t0 = time.time()
        self.last_t = self.t0
        self.last_steps = 0
        self.total_steps = 0

    def mark(self, total_env_steps: int) -> Dict[str, float]:
        now = time.time()
        dt = max(now - self.last_t, 1e-9)
        out = {
            "sps": (total_env_steps - self.last_steps) / dt,
            "walltime": now - self.t0,
            "env_steps": total_env_steps,
        }
        self.last_t = now
        self.last_steps = total_env_steps
        self.total_steps = total_env_steps
        return out


def stage_timings(stages, seed: Optional[int] = None, warmup: int = 1, iters: int = 3) -> Dict[str, float]:
    """Each stage of ``stages`` (algo/stages.py) timed on its own, best of
    ``iters`` after ``warmup``, its device work waited for before the clock
    starts and stops: rollout, targets, learn, and evaluate where the config
    has TEST_DURING_TRAINING. ``learn`` steps the agent it times, so every
    call after the first learns from a changed network. Seconds a stage."""
    from purejaxql_torch.algo.exploration import draw_seed

    host_gen = torch.Generator().manual_seed(stages.config.get("SEED", 0) if seed is None else seed)
    ts = stages.init_agent(host_gen)
    gen = torch.Generator(device=stages.device).manual_seed(draw_seed(host_gen))
    obs, env_state = stages.reset(gen)
    force(obs)

    def best(fn, *args):
        return time_fn(fn, *args, warmup=warmup, iters=iters)["best_s"]

    out = {"rollout_s": best(stages.rollout, ts, obs, env_state, gen, host_gen)}
    _, _, transitions, _ = stages.rollout(ts, obs, env_state, gen, host_gen)
    out["targets_s"] = best(stages.compute_targets, ts, transitions)
    targets = stages.compute_targets(ts, transitions)
    out["learn_s"] = best(stages.learn, ts, transitions, targets, gen)
    if stages.config.get("TEST_DURING_TRAINING", False):
        out["evaluate_s"] = best(stages.evaluate, ts, gen)
    return out
