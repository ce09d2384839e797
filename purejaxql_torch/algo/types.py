"""Transition records of a rollout (port of purejaxql_tpu/algo/types.py):
each field is stacked over time, (T, E, ...); the multi-agent record puts
the agent axis after time, (T, A, E, ...)."""

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
    last_hs: Tuple  # per recurrent layer a (T, E, H), or for LSTM a (c, h) pair of them
    last_done: torch.Tensor  # bool
    last_action: torch.Tensor  # int64
    q_val: torch.Tensor


@dataclass
class MARLTransition:
    """A multi-agent recurrent rollout step (purejaxql_tpu/algo/types.py:
    36-47): the agent axis leads on obs, action, avail and the hidden state,
    the team's reward and done are (1, E)."""

    obs: torch.Tensor  # (A, E, D)
    action: torch.Tensor  # (A, E) int64
    reward: torch.Tensor  # (1, E)
    done: torch.Tensor  # (1, E) float 0/1
    last_hs: Tuple[torch.Tensor, ...]  # one (A, E, H) per recurrent layer
    last_done: torch.Tensor  # (A, E) float 0/1
    last_action: torch.Tensor  # (A, E) int64, kept as the JAX record keeps it
    avail_actions: torch.Tensor  # (A, E, n) float 0/1
    q_val: torch.Tensor  # (A, E, n)
