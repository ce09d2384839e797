"""Fused Asterix-MinAtar rollout: the hand-written CUDA kernel and its plain
twin.

Counterpart of the Asterix part of purejaxql_tpu/ops/pallas_rollout.py
(`asterix_rollout_pallas`, `_make_asterix_kernel`,
`state_matrix_from_asterix`, `asterix_from_state_matrix`). One call runs T
env steps for B envs: the 4 observation planes, the MinAtar CNN forward,
greedy argmax (first index wins ties), the epsilon coin and a uniform random
action, the Asterix rules (spawn, player move, collide, entity move,
collide, ramp) and the deterministic reset.

The kernel is ``csrc/asterix_rollout.cu``. ``asterix_rollout_plain`` runs
the env's own batched step (envs/minatar/asterix.py) with the kernel's
Philox words 0-11 (``ops/philox.py``): the coin, the random action, a score
per slot (the spawn takes the free slot with the highest, the first on
ties), the direction (bit 8 of word 10) and gold (word 11 below 1/3).
``use_prng=False`` is the TPU kernel's deterministic mode
(pallas_rollout.py:783-790): the coin is 1, the random action 0, each
slot's score its index, so the highest free slot wins, and the spawned
entity moves left and is an enemy. Kernel and twin take only max_steps of
the env params: the cadences are the default params', as in the TPU
kernel (the trainer refuses ENV_KWARGS for this game's fused rollout).
``asterix_rollout`` takes the twin only for CPU tensors; for CUDA tensors it
launches the kernel or raises.

The state is env-minor as on the TPU: a (48, B) int32 matrix, rows 0-9
[player_x, player_y, spawn_speed, spawn_timer, move_speed, move_timer,
ramp_timer, ramp_index, time, terminal], then 8 rows each of e_exists, e_x,
e_lr, e_gold, then 6 rows of zeros.
"""

from __future__ import annotations

from typing import Sequence

import torch

from purejaxql_torch.envs.minatar.asterix import (
    SLOTS,
    AsterixDraws,
    AsterixParams,
    AsterixState,
    MinAsterix,
    start_state,
)
from purejaxql_torch.ops import minatar_rollout
from purejaxql_torch.ops.philox import step_words, unit24

ROWS = 48
_SCALARS = ("player_x", "player_y", "spawn_speed", "spawn_timer", "move_speed", "move_timer",
            "ramp_timer", "ramp_index", "time", "terminal")
_SLOT_FIELDS = ("e_exists", "e_x", "e_lr", "e_gold")
_ENV = MinAsterix()


def _draws(seed: int, T: int, B: int, A: int, use_prng: bool, dev):
    """The coin u and random action (T, B) and the step draws of each step."""
    if not use_prng:
        slots = torch.arange(SLOTS, dtype=torch.float32, device=dev).expand(B, SLOTS)
        no = torch.zeros(B, dtype=torch.bool, device=dev)
        ones = torch.ones(T, B, device=dev)
        return ones, torch.zeros(T, B, dtype=torch.int64, device=dev), [AsterixDraws(slots, no, no)] * T
    w = step_words(seed, T, B, 12, dev)
    gumbel, lr = unit24(w[..., 2:10]), ((w[..., 10] >> 8) & 1) == 1
    gold = unit24(w[..., 11]) < torch.tensor(1.0 / 3.0, dtype=torch.float32)
    draws = [AsterixDraws(gumbel[t], lr[t], gold[t]) for t in range(T)]
    return unit24(w[..., 0]), (w[..., 1] >> 8) % A, draws


@torch.no_grad()
def asterix_rollout_plain(
    seed: int,
    eps: float,
    weights: Sequence[torch.Tensor],
    st0: torch.Tensor,
    num_steps: int,
    use_prng: bool = True,
    max_steps: int = 1000,
):
    """Plain PyTorch rollout. Returns (obs (T,B,10,10,4), act (T,B) int32,
    rew (T,B), done (T,B) int32, q (T,B,A), final_obs (B,10,10,4),
    st (48,B) int32)."""
    B, A, dev = st0.shape[1], weights[8].shape[0], st0.device
    params = AsterixParams(max_steps_in_episode=max_steps)
    u, rand_act, draws = _draws(seed, num_steps, B, A, use_prng, dev)
    start = start_state(B, params, dev)
    *outs, state = minatar_rollout.rollout_plain(
        _ENV, params, weights, asterix_from_state_matrix(st0), eps, u, rand_act, draws,
        lambda t: start,
    )
    return (*outs, state_matrix_from_asterix(state))


def asterix_rollout(
    seed: int,
    eps: float,
    weights: Sequence[torch.Tensor],
    st0: torch.Tensor,
    num_steps: int,
    use_prng: bool = True,
    max_steps: int = 1000,
):
    """``asterix_rollout_plain`` for CPU tensors, the CUDA kernel for CUDA
    tensors. Same arguments and outputs; ``seed`` is an int in [0, 2**64)."""
    if st0.device.type == "cpu":
        return asterix_rollout_plain(seed, eps, weights, st0, num_steps, use_prng, max_steps)
    if st0.device.type != "cuda":
        raise ValueError(f"asterix_rollout: unsupported device {st0.device}")
    out = minatar_rollout.launch(
        "asterix_rollout", 4, seed, eps, weights, [((ROWS,), st0)], num_steps, use_prng, (max_steps,)
    )
    asterix_rollout.launches += 1
    return out


asterix_rollout.launches = 0


def state_matrix_from_asterix(state: AsterixState) -> torch.Tensor:
    """AsterixState of (B,) and (B, 8) tensors -> the kernel's (48, B) int32
    state matrix."""
    rows = [getattr(state, k).to(torch.int32)[None] for k in _SCALARS]
    rows += [getattr(state, k).to(torch.int32).T for k in _SLOT_FIELDS]
    B = state.player_x.shape[0]
    pad = torch.zeros(ROWS - 10 - 4 * SLOTS, B, dtype=torch.int32, device=state.player_x.device)
    return torch.cat(rows + [pad]).contiguous()


def asterix_from_state_matrix(st: torch.Tensor) -> AsterixState:
    """Inverse of ``state_matrix_from_asterix``."""
    fields = dict(zip(_SCALARS, st[:10]))
    fields["terminal"] = fields["terminal"].bool()
    for i, k in enumerate(_SLOT_FIELDS):
        block = st[10 + SLOTS * i : 10 + SLOTS * (i + 1)].T
        fields[k] = block if k == "e_x" else block.bool()
    return AsterixState(**fields)
