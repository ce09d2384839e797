"""Metric helpers for the in-loop evaluators (port of
purejaxql_tpu/algo/metrics.py), the step-order episode sums that the FF
and actor-critic trainers replay their fused rollouts' (reward, done)
streams with, the sharded trainers' mean of an update's metrics over the
process group, and the LOG_VIA_CALLBACK hook of the FF, recurrent, VDN and
actor-critic trainers."""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch


def episode_mean_metrics(infos: Dict[str, torch.Tensor], seeds: int = 1, group=None) -> Dict[str, torch.Tensor]:
    """Mean of each info leaf over the steps where `returned_episode` is set
    (NaN where no episode finished): the reference's
    ``nanmean(where(returned_episode, x, nan))``; with seeds, (T, S * E)
    leaves of seed-major envs, each seed's mean, (S,). With a process
    ``group`` (metrics.py:22-47), the done-weighted global mean: the masked
    sums and the count summed over the group in one all-reduce, NaN where no
    episode ended on any rank, the same on every rank."""
    mask = infos["returned_episode"]
    nan = torch.tensor(float("nan"), device=mask.device)
    if group is not None:
        from purejaxql_torch.parallel.mesh import psum_

        maskf = mask.float()
        sums = torch.stack([maskf.sum()] + [(v.float() * maskf).sum() for v in infos.values()])
        psum_([sums], group)
        count = sums[0]
        return {k: torch.where(count > 0, s / count.clamp(min=1.0), nan) for k, s in zip(infos, sums[1:])}
    if seeds == 1:
        return {k: torch.where(mask, v.float(), nan).nanmean() for k, v in infos.items()}
    lanes = lambda x: x.unflatten(1, (seeds, -1)).transpose(0, 1).reshape(seeds, -1)  # noqa: E731
    return {k: lanes(torch.where(mask, v.float(), nan)).nanmean(1) for k, v in infos.items()}


def apply_eval_subsample(config: Dict[str, Any]) -> Dict[str, Any]:
    """EVAL_SUBSAMPLE=k runs the in-loop eval with TEST_NUM_ENVS/k envs at
    unchanged cadence and horizon. Mutates and returns `config`."""
    sub = int(config.get("EVAL_SUBSAMPLE", 1))
    if sub > 1 and "TEST_NUM_ENVS" in config:
        config["TEST_NUM_ENVS"] = max(config["TEST_NUM_ENVS"] // sub, 1)
    return config


def test_interval_updates(config: Dict[str, Any]) -> int:
    """Number of updates between in-loop evals: int(NUM_UPDATES *
    TEST_INTERVAL), clamped to >= 1."""
    return max(1, int(config["NUM_UPDATES"] * config["TEST_INTERVAL"]))


def running_episode_sums(rew, done, ep_return0, ep_length0):
    """Each env's running episode return and length after every step of a
    (T, E) reward / done (0/1 float) stream, and the carry after the last
    step, zeroed where an episode ended. Summed in step order, exact for
    float rewards: the carries of the JAX trainers' fused replays
    (pqn.py:371-397 and pqn_ac.py:323-336) and fused evals' ``_ep``
    (pqn.py:721-731, pqn_ac.py:652-662)."""
    ep_r, ep_l = ep_return0, ep_length0
    rets, lens = [], []
    for r, dn in zip(rew, done):
        ner, nel = ep_r + r, ep_l + 1
        keep = 1.0 - dn
        rets.append(ner)
        lens.append(nel)
        ep_r, ep_l = ner * keep, nel * keep.to(nel.dtype)
    return torch.stack(rets), torch.stack(lens), ep_r, ep_l


def eval_episode_metrics(rew: torch.Tensor, done: torch.Tensor, group=None) -> Dict[str, torch.Tensor]:
    """A fused greedy eval's metrics from its (T, E) reward and 0/1 done
    streams (pqn.py:721-736, pqn_ac.py:652-669): every episode's return and
    length from a zero start, averaged over the steps that end one (over
    every rank of a process ``group``)."""
    zero = torch.zeros(rew.shape[1], device=rew.device)
    ner, nel, _, _ = running_episode_sums(rew, done, zero, zero)
    return episode_mean_metrics({
        "returned_episode_returns": ner,
        "returned_episode_lengths": nel,
        "returned_episode": done.bool(),
    }, group=group)


def group_mean_metrics(metrics: Dict[str, Any], group) -> Dict[str, Any]:
    """An update's metrics with each tensor meaned over the process
    ``group`` in one all-reduce (pqn.py:612-613: a mean of the shards'
    means, not a weighted one); the host counters as they are. ``None``
    returns ``metrics`` unchanged."""
    if group is None:
        return metrics
    from purejaxql_torch.parallel.mesh import pmean_

    keys = [k for k, v in metrics.items() if torch.is_tensor(v)]
    values = [metrics[k].float().clone() for k in keys]
    pmean_(values, group)
    return {**metrics, **dict(zip(keys, values))}


def metric_callback(config: Dict[str, Any], logger) -> Optional[Callable]:
    """The trainers' LOG_VIA_CALLBACK hook: the logger's callback where the
    config turns the option on and a logger is given, else None."""
    if logger is None or not config.get("LOG_VIA_CALLBACK", False):
        return None
    return logger.make_callback()


def emit_metric_rows(callback: Callable, metrics: Dict[str, Any], seeds: int = 1,
                     last_seed_first: bool = False) -> None:
    """Hand one update's metrics to ``callback(row, seed)`` once a seed, in
    the order the JAX package's vmapped ``jax.debug.callback`` calls its host
    function: seed 0 first where the call sits in a ``lax.cond`` (the FF
    trainer's LOG_INTERVAL test), the last seed first where it does not (the
    recurrent, VDN and actor-critic trainers), as measured on the CPU. With
    seeds, seed s gets the s-th value of each (S,) tensor. One device-to-host
    copy for all the tensors."""
    keys = [k for k, v in metrics.items() if torch.is_tensor(v)]
    flat = [metrics[k].detach().reshape(-1) for k in keys]
    host = torch.cat([v.double() for v in flat]).cpu() if flat else None
    values, start = {}, 0
    for k, v in zip(keys, flat):
        values[k] = host[start:start + v.numel()].to(v.dtype).numpy()
        start += v.numel()
    for s in (reversed(range(seeds)) if last_seed_first else range(seeds)):
        row = {k: (values[k][s] if values[k].size > 1 else values[k][0]) if k in values else v
               for k, v in metrics.items()}
        callback(row, s)
