"""Epsilon-greedy exploration (port of `eps_greedy_batch` in
purejaxql_tpu/algo/exploration.py): per env, a uniform coin below eps picks
a uniform random action, else the greedy one (first index wins ties)."""

from __future__ import annotations

from typing import Union

import torch


def eps_greedy_batch(
    generator: torch.Generator, q_vals: torch.Tensor, eps: Union[float, torch.Tensor]
) -> torch.Tensor:
    """q_vals (E, A), eps a scalar or (E,) -> actions (E,) int64, drawn from
    ``generator`` (on q_vals' device)."""
    n_envs, n_actions = q_vals.shape
    greedy = q_vals.argmax(-1)
    coin = torch.rand(n_envs, generator=generator, device=q_vals.device) < eps
    random_actions = torch.randint(
        0, n_actions, (n_envs,), generator=generator, device=q_vals.device
    )
    return torch.where(coin, random_actions, greedy)
