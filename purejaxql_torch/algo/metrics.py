"""Metric helpers for the in-loop evaluators (port of
purejaxql_tpu/algo/metrics.py, single device), and the step-order episode
sums that the FF and actor-critic trainers replay their fused rollouts'
(reward, done) streams with."""

from __future__ import annotations

from typing import Any, Dict

import torch


def episode_mean_metrics(infos: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Mean of each info leaf over the steps where `returned_episode` is set
    (NaN where no episode finished): the reference's
    ``nanmean(where(returned_episode, x, nan))``."""
    mask = infos["returned_episode"]
    nan = torch.tensor(float("nan"), device=mask.device)
    return {k: torch.where(mask, v.float(), nan).nanmean() for k, v in infos.items()}


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


def eval_episode_metrics(rew: torch.Tensor, done: torch.Tensor) -> Dict[str, torch.Tensor]:
    """A fused greedy eval's metrics from its (T, E) reward and 0/1 done
    streams (pqn.py:721-736, pqn_ac.py:652-669): every episode's return and
    length from a zero start, averaged over the steps that end one."""
    zero = torch.zeros(rew.shape[1], device=rew.device)
    ner, nel, _, _ = running_episode_sums(rew, done, zero, zero)
    return episode_mean_metrics({
        "returned_episode_returns": ner,
        "returned_episode_lengths": nel,
        "returned_episode": done.bool(),
    })
