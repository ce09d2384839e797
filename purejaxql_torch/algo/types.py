"""Transition records of a rollout (port of purejaxql_tpu/algo/types.py):
each field is stacked over time, (T, E, ...)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch


@dataclass
class Transition:
    obs: torch.Tensor
    action: torch.Tensor  # int64
    reward: torch.Tensor
    done: torch.Tensor  # bool
    next_obs: torch.Tensor
    q_val: torch.Tensor


@dataclass
class RNNTransition:
    """A recurrent rollout step (purejaxql_tpu/algo/types.py:21): the obs the
    step acted on, with the *incoming* hidden state, done flag and previous
    action that the network read at that step."""

    obs: torch.Tensor
    action: torch.Tensor  # int64
    reward: torch.Tensor
    done: torch.Tensor  # bool
    last_hs: Tuple[torch.Tensor, ...]  # one (T, E, H) per recurrent layer
    last_done: torch.Tensor  # bool
    last_action: torch.Tensor  # int64
    q_val: torch.Tensor
