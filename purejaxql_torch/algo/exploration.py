"""Exploration (port of purejaxql_tpu/algo/exploration.py):

- ``eps_greedy_batch``: per env, a uniform coin below eps picks a uniform
  random action, else the greedy one (first index wins ties);
- ``gaussian_noise_ladder`` (exploration.py:62-85): additive Gaussian noise
  for a deterministic continuous policy, env i of E at std
  i / (E - 1) * noise_std, so some envs always exploit and others always
  explore.
"""

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


def gaussian_noise_ladder(
    generator: torch.Generator,
    actions: torch.Tensor,
    noise_std: float,
    low: float,
    high: float,
    scale: float = 1.0,
    linspace: bool = True,
) -> torch.Tensor:
    """actions (E, D) plus N(0, std_i^2) noise times ``scale`` (the action
    half-range, so noise_std is in normalized action units), clipped to
    [low, high]. With ``linspace`` the stds run linspace(0, noise_std, E)
    over the envs, else every env has noise_std."""
    n_envs = actions.shape[0]
    if linspace:
        stds = torch.linspace(0.0, noise_std, n_envs, device=actions.device)[:, None]
    else:
        stds = torch.full((n_envs, 1), noise_std, device=actions.device)
    noise = torch.randn(actions.shape, generator=generator, device=actions.device) * stds * scale
    return torch.clamp(actions + noise, low, high)
