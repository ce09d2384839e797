"""Fused SpaceInvaders-MinAtar rollout: the hand-written CUDA kernel and its
plain twin.

Counterpart of the SpaceInvaders part of purejaxql_tpu/ops/pallas_rollout.py
(`space_invaders_rollout_pallas`, `_make_si_kernel`, `_si_planes`,
`state_matrix_from_space_invaders`, `space_invaders_from_state_matrix`).
One call runs T env steps for B envs: the 6 observation planes, the MinAtar
CNN forward, greedy argmax (first index wins ties), the epsilon coin and a
uniform random action, the SpaceInvaders rules and the deterministic reset.

The kernel is ``csrc/space_invaders_rollout.cu``. ``space_invaders_rollout_plain``
runs the env's own batched step (envs/minatar/space_invaders.py); the env
draws nothing, so the kernel's Philox words 0-1 (``ops/philox.py``) give
only the coin and the random action. ``use_prng=False`` is the TPU kernel's
deterministic mode: the coin is 1 and the random action 0. Kernel and twin
take only max_steps of the env params: the march interval after a reset
(12, pallas_rollout.py:1473-1474), the cannon's cooldown and the aliens'
shot interval are the default params', as in the TPU kernel (the trainer
refuses ENV_KWARGS for this game's fused rollout). ``space_invaders_rollout`` takes the twin only for CPU tensors;
for CUDA tensors it launches the kernel or raises.

The state is env-minor as on the TPU: a (16, B) int32 matrix, rows [pos,
alien_dir, enemy_move_interval, alien_move_timer, alien_shot_timer,
ramp_index, shot_timer, terminal, time], then 7 rows of zeros, and three
(10, 10, B) int32 maps: aliens, friendly bullets and enemy bullets.
"""

from __future__ import annotations

from typing import Sequence

import torch

from purejaxql_torch.envs.base import NO_DRAWS
from purejaxql_torch.envs.minatar.space_invaders import (
    MinSpaceInvaders,
    SpaceInvadersParams,
    SpaceInvadersState,
    start_state,
)
from purejaxql_torch.ops import minatar_rollout
from purejaxql_torch.ops.philox import step_words, unit24

ROWS = 16
_SCALARS = ("pos", "alien_dir", "enemy_move_interval", "alien_move_timer", "alien_shot_timer",
            "ramp_index", "shot_timer", "terminal", "time")
_MAPS = ("alien_map", "f_bullet_map", "e_bullet_map")
_ENV = MinSpaceInvaders()


@torch.no_grad()
def space_invaders_rollout_plain(
    seed: int,
    eps: float,
    weights: Sequence[torch.Tensor],
    st0: torch.Tensor,
    alien0: torch.Tensor,
    fmap0: torch.Tensor,
    emap0: torch.Tensor,
    num_steps: int,
    use_prng: bool = True,
    max_steps: int = 1000,
):
    """Plain PyTorch rollout. Returns (obs (T,B,10,10,6), act (T,B) int32,
    rew (T,B), done (T,B) int32, q (T,B,A), final_obs (B,10,10,6),
    st (16,B) int32, alien, fmap, emap (10,10,B) int32)."""
    T, B, A, dev = num_steps, st0.shape[1], weights[8].shape[0], st0.device
    params = SpaceInvadersParams(max_steps_in_episode=max_steps)
    if use_prng:
        w = step_words(seed, T, B, 2, dev)
        u, rand_act = unit24(w[..., 0]), (w[..., 1] >> 8) % A
    else:
        u = torch.ones(T, B, device=dev)
        rand_act = torch.zeros(T, B, dtype=torch.int64, device=dev)
    start = start_state(B, params, dev)
    *outs, state = minatar_rollout.rollout_plain(
        _ENV, params, weights, space_invaders_from_state_matrix(st0, alien0, fmap0, emap0),
        eps, u, rand_act, [NO_DRAWS] * T, lambda t: start,
    )
    return (*outs, *state_matrix_from_space_invaders(state))


def space_invaders_rollout(
    seed: int,
    eps: float,
    weights: Sequence[torch.Tensor],
    st0: torch.Tensor,
    alien0: torch.Tensor,
    fmap0: torch.Tensor,
    emap0: torch.Tensor,
    num_steps: int,
    use_prng: bool = True,
    max_steps: int = 1000,
):
    """``space_invaders_rollout_plain`` for CPU tensors, the CUDA kernel for
    CUDA tensors. Same arguments and outputs; ``seed`` is an int in
    [0, 2**64)."""
    maps = (alien0, fmap0, emap0)
    if st0.device.type == "cpu":
        return space_invaders_rollout_plain(seed, eps, weights, st0, *maps, num_steps, use_prng, max_steps)
    if st0.device.type != "cuda":
        raise ValueError(f"space_invaders_rollout: unsupported device {st0.device}")
    out = minatar_rollout.launch(
        "space_invaders_rollout", 6, seed, eps, weights,
        [((ROWS,), st0)] + [((10, 10), x) for x in maps], num_steps, use_prng, (max_steps,),
    )
    space_invaders_rollout.launches += 1
    return out


space_invaders_rollout.launches = 0


def state_matrix_from_space_invaders(state: SpaceInvadersState):
    """SpaceInvadersState of (B,) tensors and (B, 10, 10) maps -> the
    kernel's (16, B) int32 matrix and (10, 10, B) int32 alien, friendly
    bullet and enemy bullet maps."""
    B = state.pos.shape[0]
    st = torch.stack([getattr(state, k).to(torch.int32) for k in _SCALARS])
    pad = torch.zeros(ROWS - len(_SCALARS), B, dtype=torch.int32, device=state.pos.device)
    maps = (getattr(state, k).to(torch.int32).permute(1, 2, 0).contiguous() for k in _MAPS)
    return (torch.cat([st, pad]).contiguous(), *maps)


def space_invaders_from_state_matrix(st, alien, fmap, emap) -> SpaceInvadersState:
    """Inverse of ``state_matrix_from_space_invaders``."""
    fields = dict(zip(_SCALARS, st[: len(_SCALARS)]))
    fields["terminal"] = fields["terminal"].bool()
    maps = dict(zip(_MAPS, (x.permute(2, 0, 1) for x in (alien, fmap, emap))))
    return SpaceInvadersState(**fields, **maps)
