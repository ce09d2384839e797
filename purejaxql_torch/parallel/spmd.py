"""Sharded training over the (seed, env) mesh: envs shard along "env",
learner replicas stay in lockstep through all-reduce-meaned gradients.

Port of purejaxql_tpu/parallel/spmd.py on ``torch.distributed``. The JAX
package runs the same fused trainer under ``jax.shard_map``; here every
rank is one process running the same trainer (``make_train(...,
group=...)`` of algo/pqn.py, pqn_rnn.py, pqn_vdn.py or pqn_ac.py) on its
NUM_ENVS / k envs, with the collectives where the algorithm needs them:

- one all-reduce a minibatch step: the flat gradient buffer (core/optim.py;
  the actor-critic family's two, one an optimizer);
- one a train-mode batch norm: its batch mean and E[x^2] in one buffer
  (models/qnet.py:batch_moments, models/batch_renorm.py, ops/fast_rnn.py),
  and one in its backward, the transpose of the mean;
- one an update: the metrics (algo/metrics.py:group_mean_metrics);
- one an eval: the masked sums and the count (``episode_mean_metrics``,
  the actor-critic ``greedy_eval``).

Rollouts, the lambda targets, the kernels and the minibatch shuffles are
rank-local: nothing else communicates.

Semantics (spmd.py:21-28): a k-shard run is another sample of the same
algorithm. Each rank's streams are Philox generators derived from (seed,
rank) after the shared network is built (algo/seeds.py:run_generators),
its shuffles permute its own rows, and a reset pool or
bank, or the actor-critic normalizers, are per shard. Learner updates use
the global batch through the gradient mean, so every rank's parameters and
batch statistics stay bit-equal without any broadcast.

The rank's device is ``DEVICE`` from the config or ``device`` where given,
else its card (``local_device``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

from purejaxql_torch.algo import pqn
from purejaxql_torch.algo.segmented import train_segmented
from purejaxql_torch.parallel.mesh import fold_seed, gather_rows, local_device


def local_config(config: Dict[str, Any], n_shards: int) -> Dict[str, Any]:
    """One rank's config of a run sharded ``n_shards`` ways (spmd.py:55-71):
    NUM_ENVS and TEST_NUM_ENVS (at least 1) divided, TOTAL_TIMESTEPS and
    TOTAL_TIMESTEPS_DECAY divided so the update count stays the global
    run's, TIMESTEP_SCALE so the counters count global env steps, one seed
    a rank."""
    assert config["NUM_ENVS"] % n_shards == 0, f"NUM_ENVS={config['NUM_ENVS']} not divisible by {n_shards} shards"
    total = int(float(config["TOTAL_TIMESTEPS"]))
    local = dict(config)
    local["NUM_ENVS"] = config["NUM_ENVS"] // n_shards
    if config.get("TEST_NUM_ENVS") is not None:
        local["TEST_NUM_ENVS"] = max(config["TEST_NUM_ENVS"] // n_shards, 1)
    local["TOTAL_TIMESTEPS"] = total // n_shards
    local["TOTAL_TIMESTEPS_DECAY"] = int(float(config.get("TOTAL_TIMESTEPS_DECAY", total))) // n_shards
    local["TIMESTEP_SCALE"] = n_shards
    local["NUM_SEEDS"] = 1
    return local


def _device(config: Dict[str, Any], device):
    if device is not None:
        return device
    if config.get("DEVICE") is not None or not torch.cuda.is_available():
        return config.get("DEVICE")
    return local_device()


def make_train_spmd(
    config: Dict[str, Any],
    mesh,
    axis_name: str = "env",
    logger=None,
    make_train: Callable = pqn.make_train,
    device=None,
) -> Callable[..., Dict[str, Any]]:
    """Build ``train(seed=None) -> {"train_state", "metrics",
    "runner_state"}`` sharded over ``mesh[axis_name]`` (spmd.py:42-89).
    NUM_ENVS and TEST_NUM_ENVS in ``config`` are global and NUM_ENVS must
    divide by the axis size. ``train_state`` and ``metrics`` are the same on
    every rank; ``runner_state`` is the rank's own (its env shard and
    generators)."""
    group = mesh.get_group(axis_name)
    local = local_config(config, dist.get_world_size(group))
    train = make_train(local, device=_device(config, device), logger=logger, group=group)

    def fn(seed: Optional[int] = None) -> Dict[str, Any]:
        out = train(seed)
        return {"train_state": out["runner_state"][0], "metrics": out["metrics"], "runner_state": out["runner_state"]}

    return fn


def named_state(train_state) -> Dict[str, torch.Tensor]:
    """The parameters and buffers of a train state (the actor-critic
    family's dict of them prefixed ``actor.`` and ``critic.``)."""
    if isinstance(train_state, dict):
        return {f"{k}.{n}": t for k, s in train_state.items() for n, t in s.network.state_dict().items()}
    return dict(train_state.network.state_dict())


def make_train_spmd_seeds(
    config: Dict[str, Any],
    mesh,
    seed_axis: str = "seed",
    env_axis: str = "env",
    logger=None,
    make_train: Callable = pqn.make_train,
    device=None,
) -> Callable[..., Dict[str, Any]]:
    """Two axes (spmd.py:146-201): independent seeds along ``seed_axis``,
    envs sharded along ``env_axis`` as ``make_train_spmd``. Seed row i
    trains from the seed ``fold_seed(SEED, i)`` (its network and, folded
    again by the env rank, its streams); no collective crosses the seed
    axis during training. Returns ``{"train_state", "state_dict",
    "metrics"}``: the rank's own train state, and every parameter and
    buffer and every metric with a leading per-seed axis, gathered over the
    seed axis's group once at the end (the same on every rank)."""
    env_group, seed_group = mesh.get_group(env_axis), mesh.get_group(seed_axis)
    local = local_config(config, dist.get_world_size(env_group))
    train = make_train(local, device=_device(config, device), logger=logger, group=env_group)
    row = dist.get_rank(seed_group)

    def fn(seed: Optional[int] = None) -> Dict[str, Any]:
        out = train(fold_seed(config["SEED"] if seed is None else seed, row))
        train_state = out["runner_state"][0]
        state = named_state(train_state)
        dev = next(iter(state.values())).device
        return {
            "train_state": train_state,
            "state_dict": {k: gather_rows(v.detach(), seed_group) for k, v in state.items()},
            "metrics": {k: gather_rows(v.to(dev), seed_group) for k, v in out["metrics"].items()},
        }

    return fn


def make_train_spmd_resumable(
    config: Dict[str, Any],
    mesh,
    axis_name: str = "env",
    logger=None,
    make_train: Callable = pqn.make_train,
    device=None,
) -> Callable[..., Dict[str, Any]]:
    """Like ``make_train_spmd``, continuing a run (spmd.py:204-275): call
    ``fn(seed)`` for the first segment and ``fn(seed, runner_state)`` for
    the next, each rank carrying its own runner_state (its env shard and
    generators; the train state is the same on every rank). For the
    trainers that continue a run: FF (``algo/pqn.py``) and recurrent
    (``algo/pqn_rnn.py``). Returns ``{"runner_state", "metrics"}``."""
    group = mesh.get_group(axis_name)
    local = local_config(config, dist.get_world_size(group))
    train = make_train(local, device=_device(config, device), logger=logger, group=group)

    def fn(seed: Optional[int] = None, runner_state=None) -> Dict[str, Any]:
        out = train(seed, runner_state=runner_state)
        return {"runner_state": out["runner_state"], "metrics": out["metrics"]}

    return fn


def train_segmented_spmd(
    config: Dict[str, Any],
    mesh,
    num_segments: int,
    seed: Optional[int] = None,
    axis_name: str = "env",
    logger=None,
    make_train: Callable = pqn.make_train,
    on_segment: Optional[Callable] = None,
    device=None,
):
    """Sharded segmented training (spmd.py:278-326): ``algo/segmented.py:
    train_segmented`` over rank trainers of ``mesh[axis_name]``, the full
    horizon's decay kept, each rank's runner_state carried from one segment
    to the next. Bit-identical to one ``make_train_spmd_resumable`` run of
    the whole length (the same generators and counters, no atomics)."""
    group = mesh.get_group(axis_name)
    n_shards = dist.get_world_size(group)
    dev = _device(config, device)

    def rank_make_train(seg_config, logger=None):
        return make_train(local_config(seg_config, n_shards), device=dev, logger=logger, group=group)

    return train_segmented(config, num_segments, seed=seed, logger=logger, on_segment=on_segment,
                           make_train=rank_make_train)
