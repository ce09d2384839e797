"""Exploration (port of purejaxql_tpu/algo/exploration.py):

- ``eps_greedy_batch``: per env, a uniform coin below eps picks a uniform
  random action, else the greedy one (first index wins ties);
- ``make_eps_greedy``: the unfused rollout's epsilon-greedy as the config's
  EXPLORATION_KERNEL picks it, the hand-written kernel (``ops/eps_greedy.py``)
  or ``eps_greedy_batch``;
- ``greedy_legal_actions`` and ``masked_eps_greedy``: the VDN trainer's
  greedy action and epsilon-greedy over legal actions only
  (purejaxql_tpu/algo/pqn_vdn.py:41-66);
- ``gaussian_noise_ladder`` (exploration.py:62-85): additive Gaussian noise
  for a deterministic continuous policy, env i of E at std
  i / (E - 1) * noise_std, so some envs always exploit and others always
  explore (with seeds, each seed's E envs a ladder of their own).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Union

import torch

from purejaxql_torch.ops.eps_greedy import eps_greedy


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


def greedy_legal_actions(q_vals: torch.Tensor, avail: torch.Tensor) -> torch.Tensor:
    """``argmax(q - (1 - avail) * 1e10)`` over the last axis (pqn_vdn.py:
    41-43): the first NaN wins, as in ``jnp.argmax``, then the first of equal
    values."""
    return torch.argmax(q_vals - (1 - avail) * 1e10, -1)


def masked_eps_greedy(
    generator: torch.Generator, q_vals: torch.Tensor, eps: float, avail: torch.Tensor
) -> torch.Tensor:
    """q_vals and avail (..., n) -> actions (...) int64: per row, a uniform
    coin below eps picks an action uniform over the legal ones (avail 1),
    else ``greedy_legal_actions`` (pqn_vdn.py:46-65). The random action is
    the k-th legal one for k = floor(u * n_legal), u uniform in [0, 1). Every
    row needs a legal action."""
    greedy = greedy_legal_actions(q_vals, avail)
    u = torch.rand(greedy.shape, generator=generator, device=q_vals.device)
    n_legal = avail.sum(-1)
    k = torch.minimum(torch.floor(u * n_legal), n_legal - 1)
    random_actions = (avail.cumsum(-1) <= k[..., None]).sum(-1)
    coin = torch.rand(greedy.shape, generator=generator, device=q_vals.device) < eps
    return torch.where(coin, random_actions, greedy)


def draw_seed(generator: torch.Generator) -> int:
    """A kernel seed from a host generator (no device sync)."""
    return int(torch.randint(0, 2**62, (1,), generator=generator))


def make_eps_greedy(
    config: Dict[str, Any], generator: torch.Generator, seed_generator: torch.Generator
) -> Callable[[torch.Tensor, float], torch.Tensor]:
    """The unfused rollout's ``(q_vals, eps) -> actions``. EXPLORATION_KERNEL
    "pallas", the JAX package's spelling of its opt-in kernel
    (purejaxql_tpu/ops/pallas_explore.py:9, docs/PARITY.md:77), picks the
    hand-written kernel, seeded from the host ``seed_generator`` each call;
    unset, ``eps_greedy_batch`` draws from ``generator``. Either way the
    random stream is not the JAX package's (ROADMAP.md, "held against")."""
    kind = config.get("EXPLORATION_KERNEL")
    if kind == "pallas":
        return lambda q_vals, eps: eps_greedy(draw_seed(seed_generator), q_vals, eps)
    if kind in (None, False, ""):
        return lambda q_vals, eps: eps_greedy_batch(generator, q_vals, eps)
    raise ValueError(f"EXPLORATION_KERNEL={kind!r}: expected 'pallas' or unset")


def gaussian_noise_ladder(
    generator: torch.Generator,
    actions: torch.Tensor,
    noise_std: float,
    low: float,
    high: float,
    scale: float = 1.0,
    linspace: bool = True,
    seeds: int = 1,
) -> torch.Tensor:
    """actions (E, D) plus N(0, std_i^2) noise times ``scale`` (the action
    half-range, so noise_std is in normalized action units), clipped to
    [low, high]. With ``linspace`` the stds run linspace(0, noise_std, E)
    over the envs, else every env has noise_std. With ``seeds`` > 1 the
    rows are S seed-major blocks of E envs, and each block has the E-long
    ladder of its own, as each vmapped lane does."""
    n_envs = actions.shape[0]
    if linspace:
        ladder = torch.linspace(0.0, noise_std, n_envs // seeds, device=actions.device)
        stds = ladder.repeat(seeds)[:, None]
    else:
        stds = torch.full((n_envs, 1), noise_std, device=actions.device)
    noise = torch.randn(actions.shape, generator=generator, device=actions.device) * stds * scale
    return torch.clamp(actions + noise, low, high)
