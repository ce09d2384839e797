"""Fused Freeway-MinAtar rollout: the hand-written CUDA kernel and its plain
twin.

Counterpart of the Freeway part of purejaxql_tpu/ops/pallas_rollout.py
(`freeway_rollout_pallas`, `_make_freeway_kernel`, `_freeway_planes`,
`state_matrix_from_freeway`, `freeway_from_state_matrix`). One call runs T
env steps for B envs: the 7 observation planes, the MinAtar CNN forward,
greedy argmax (first index wins ties), the epsilon coin and a uniform random
action, the Freeway rules and the reset on the time limit.

The kernel is ``csrc/freeway_rollout.cu``. ``freeway_rollout_plain`` runs
the env's own batched step (envs/minatar/freeway.py) with the kernel's
Philox words 0-25 (``ops/philox.py``): the coin, the random action, the
lane speeds a score would draw (1 + word mod 5), their directions (bit 8:
+1, else -1) and each car's column after a reset (word mod 10). As the TPU
kernel does (pallas_rollout.py:1144-1157), a reset takes the step's speed
and direction draws and only the columns from words of their own; the
env's ``reset_env`` draws all three. ``use_prng=False`` is the TPU kernel's
deterministic mode: the coin is 1, the random action 0, speeds 3,
directions +1 and reset columns 0. ``freeway_rollout`` takes the twin only
for CPU tensors; for CUDA tensors it launches the kernel or raises.

The state is env-minor as on the TPU: a (32, B) int32 matrix, rows
[pos, move_timer, time], then 8 rows each of car_x, car_timer and the signed
car_speed, then 5 rows of zeros.
"""

from __future__ import annotations

from typing import Sequence

import torch

from purejaxql_torch.envs.minatar.freeway import (
    LANES,
    FreewayDraws,
    FreewayParams,
    FreewayState,
    MinFreeway,
    start_state,
)
from purejaxql_torch.ops import minatar_rollout
from purejaxql_torch.ops.philox import step_words, unit24

ROWS = 32
_SCALARS = ("pos", "move_timer", "time")
_LANE_FIELDS = ("car_x", "car_timer", "car_speed")
_ENV = MinFreeway()


def _draws(seed: int, T: int, B: int, A: int, use_prng: bool, dev):
    """The coin u and random action (T, B), each step's car draws and the
    (T, B, 8) car columns of a reset at each step."""
    if not use_prng:
        three = torch.full((B, LANES), 3, dtype=torch.int32, device=dev)
        cars = FreewayDraws(three, torch.ones_like(three))
        ones, zeros = torch.ones(T, B, device=dev), torch.zeros(T, B, dtype=torch.int64, device=dev)
        return ones, zeros, [cars] * T, torch.zeros(T, B, LANES, dtype=torch.int32, device=dev)
    w = step_words(seed, T, B, 26, dev)
    top = w >> 8
    speeds = (top[..., 2:10] % 5 + 1).to(torch.int32)
    dirs = torch.where((top[..., 10:18] & 1) == 1, 1, -1).to(torch.int32)
    cars = [FreewayDraws(speeds[t], dirs[t]) for t in range(T)]
    return unit24(w[..., 0]), top[..., 1] % A, cars, (top[..., 18:26] % 10).to(torch.int32)


@torch.no_grad()
def freeway_rollout_plain(
    seed: int,
    eps: float,
    weights: Sequence[torch.Tensor],
    st0: torch.Tensor,
    num_steps: int,
    use_prng: bool = True,
    max_steps: int = 2500,
    player_speed: int = 3,
):
    """Plain PyTorch rollout. Returns (obs (T,B,10,10,7), act (T,B) int32,
    rew (T,B), done (T,B) int32, q (T,B,A), final_obs (B,10,10,7),
    st (32,B) int32)."""
    B, A, dev = st0.shape[1], weights[8].shape[0], st0.device
    params = FreewayParams(player_speed=player_speed, max_steps_in_episode=max_steps)
    u, rand_act, cars, reset_x = _draws(seed, num_steps, B, A, use_prng, dev)
    *outs, state = minatar_rollout.rollout_plain(
        _ENV, params, weights, freeway_from_state_matrix(st0), eps, u, rand_act, cars,
        lambda t: start_state(reset_x[t], cars[t]),
    )
    return (*outs, state_matrix_from_freeway(state))


def freeway_rollout(
    seed: int,
    eps: float,
    weights: Sequence[torch.Tensor],
    st0: torch.Tensor,
    num_steps: int,
    use_prng: bool = True,
    max_steps: int = 2500,
    player_speed: int = 3,
):
    """``freeway_rollout_plain`` for CPU tensors, the CUDA kernel for CUDA
    tensors. Same arguments and outputs; ``seed`` is an int in [0, 2**64)."""
    if st0.device.type == "cpu":
        return freeway_rollout_plain(
            seed, eps, weights, st0, num_steps, use_prng, max_steps, player_speed
        )
    if st0.device.type != "cuda":
        raise ValueError(f"freeway_rollout: unsupported device {st0.device}")
    out = minatar_rollout.launch(
        "freeway_rollout", 7, seed, eps, weights, [((ROWS,), st0)], num_steps, use_prng,
        (max_steps, player_speed),
    )
    freeway_rollout.launches += 1
    return out


freeway_rollout.launches = 0


def state_matrix_from_freeway(state: FreewayState) -> torch.Tensor:
    """FreewayState of (B,) and (B, 8) tensors -> the kernel's (32, B) int32
    state matrix."""
    rows = [getattr(state, k).to(torch.int32)[None] for k in _SCALARS]
    rows += [getattr(state, k).to(torch.int32).T for k in _LANE_FIELDS]
    B = state.pos.shape[0]
    pad = torch.zeros(ROWS - 3 - 3 * LANES, B, dtype=torch.int32, device=state.pos.device)
    return torch.cat(rows + [pad]).contiguous()


def freeway_from_state_matrix(st: torch.Tensor) -> FreewayState:
    """Inverse of ``state_matrix_from_freeway``; ``terminal`` is False, as
    Freeway's always is."""
    fields = dict(zip(_SCALARS, st[:3]))
    for i, k in enumerate(_LANE_FIELDS):
        fields[k] = st[3 + LANES * i : 3 + LANES * (i + 1)].T
    return FreewayState(terminal=torch.zeros_like(fields["pos"], dtype=torch.bool), **fields)
