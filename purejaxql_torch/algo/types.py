"""Transition records of a rollout (port of purejaxql_tpu/algo/types.py):
each field is stacked over time, (T, E, ...)."""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class Transition:
    obs: torch.Tensor
    action: torch.Tensor  # int64
    reward: torch.Tensor
    done: torch.Tensor  # bool
    next_obs: torch.Tensor
    q_val: torch.Tensor
