"""Metric helpers for the in-loop evaluators (port of
purejaxql_tpu/algo/metrics.py, single device)."""

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
