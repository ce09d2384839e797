"""Fused Seaquest-MinAtar rollout: the hand-written CUDA kernel and its plain
twin.

Counterpart of the Seaquest part of purejaxql_tpu/ops/pallas_rollout.py
(`seaquest_rollout_pallas`, `_make_seaquest_kernel`,
`state_matrix_from_seaquest`, `seaquest_from_state_matrix`). One call runs T
env steps for B envs: the 10 observation planes, the MinAtar CNN forward,
greedy argmax (first index wins ties), the epsilon coin and a uniform random
action, the Seaquest rules (player and shot, bullets, lane moves, the enemy
shot, hits, spawns, collisions, oxygen and surfacing) and the deterministic
reset.

The kernel is ``csrc/seaquest_rollout.cu``, on the cluster CNN of
``csrc/minatar_cluster.cuh`` (the plan: ``seaquest_plan``, one cluster of C
CTAs per C envs, each CTA holding 1 / C of the dense weight in shared
memory for the whole launch). ``seaquest_rollout_plain`` runs
the env's own batched step (envs/minatar/seaquest.py) with the kernel's
Philox words 0-28 (``ops/philox.py``): the coin, the random action, a score
per slot of each of the five pools, the lane, the direction and whether an
enemy spawn is a sub. A spawn takes the free slot of the highest score, the
first on ties (`_first_free`, pallas_rollout.py:1619).
``use_prng=False`` is the TPU kernel's deterministic mode
(pallas_rollout.py:1751-1762): the coin is 1, the random action 0, each
slot's score minus its index, the lane 4, the spawn from the right edge and
a fish. Kernel and twin take only max_steps of the env params: the other six
are the default params', built in as in the TPU kernel (the trainer refuses
any other ENV_KWARGS for this game's fused rollout). ``seaquest_rollout``
takes the twin only for CPU tensors; for CUDA tensors it launches the kernel
or raises.

The state is env-minor as on the TPU: a (128, B) int32 matrix, rows 0-11
[sub_x, sub_y, sub_or, oxygen, divers, shot_timer, spawn_timer,
diver_spawn_timer, move_interval, surfaced, terminal, time], then per pool
one row per slot of each field: fish (exists, x, y, dir, timer) x 8 from
row 12, subs (exists, x, y, dir, timer, shot timer) x 4 from 52, friendly
bullets (exists, x, y, dir) x 4 from 76, enemy bullets x 4 from 92, divers
(exists, x, y, dir, timer) x 4 from 108 (pallas_rollout.py:1609-1616).
"""

from __future__ import annotations

from typing import Sequence

import torch

from purejaxql_torch.envs.minatar.seaquest import (
    N_DIVERS,
    N_EBULLETS,
    N_FBULLETS,
    N_FISH,
    N_SUBS,
    MinSeaquest,
    SeaquestDraws,
    SeaquestParams,
    SeaquestState,
    start_state,
)
from purejaxql_torch.ops import minatar_rollout
from purejaxql_torch.ops.philox import step_words, unit24

ROWS = 128
WORDS = 29
CHANNELS = 10
# the ints the kernel keeps in each env's CTA: the 128 state rows, 32 Philox
# words and the 28 cells its planes read (csrc/seaquest_rollout.cu kGameInts)
GAME_INTS = 188
_SCALARS = ("sub_x", "sub_y", "sub_or", "oxygen", "divers", "shot_timer", "spawn_timer",
            "diver_spawn_timer", "move_interval", "surfaced", "terminal", "time")
# each pool's slot count and fields, in the order of the state matrix
_POOLS = (
    (N_FISH, ("f_exists", "f_x", "f_y", "f_dir", "f_timer")),
    (N_SUBS, ("s_exists", "s_x", "s_y", "s_dir", "s_timer", "s_shot_timer")),
    (N_FBULLETS, ("fb_exists", "fb_x", "fb_y", "fb_dir")),
    (N_EBULLETS, ("eb_exists", "eb_x", "eb_y", "eb_dir")),
    (N_DIVERS, ("d_exists", "d_x", "d_y", "d_dir", "d_timer")),
)
_BOOLS = ("surfaced", "terminal", "f_exists", "s_exists", "fb_exists", "eb_exists", "d_exists")
_ENV = MinSeaquest()


def _draws(seed: int, T: int, B: int, A: int, use_prng: bool, dev):
    """The coin u and random action (T, B) and the step draws of each step."""
    if not use_prng:
        score = -torch.arange(N_FISH, dtype=torch.float32, device=dev).expand(B, N_FISH)
        four = score[:, :4]
        lane = torch.full((B,), 4, dtype=torch.int32, device=dev)
        no = torch.zeros(B, dtype=torch.bool, device=dev)
        draws = SeaquestDraws(fb=four, eb=four, fish=score, sub=four, diver=four, lane=lane, lr=no, is_sub=no)
        return torch.ones(T, B, device=dev), torch.zeros(T, B, dtype=torch.int64, device=dev), [draws] * T
    w = step_words(seed, T, B, WORDS, dev)
    scores = unit24(w[..., 2:26])
    lane = ((w[..., 26] >> 8) % 8 + 1).to(torch.int32)
    lr = ((w[..., 27] >> 8) & 1) == 1
    is_sub = unit24(w[..., 28]) < torch.tensor(1.0 / 3.0, dtype=torch.float32)
    draws = [
        SeaquestDraws(
            fb=scores[t, :, 0:4], eb=scores[t, :, 4:8], fish=scores[t, :, 8:16], sub=scores[t, :, 16:20],
            diver=scores[t, :, 20:24], lane=lane[t], lr=lr[t], is_sub=is_sub[t],
        )
        for t in range(T)
    ]
    return unit24(w[..., 0]), (w[..., 1] >> 8) % A, draws


@torch.no_grad()
def seaquest_rollout_plain(
    seed: int,
    eps: float,
    weights: Sequence[torch.Tensor],
    st0: torch.Tensor,
    num_steps: int,
    use_prng: bool = True,
    max_steps: int = 1000,
):
    """Plain PyTorch rollout. Returns (obs (T,B,10,10,10), act (T,B) int32,
    rew (T,B), done (T,B) int32, q (T,B,A), final_obs (B,10,10,10),
    st (128,B) int32)."""
    B, A, dev = st0.shape[1], weights[8].shape[0], st0.device
    params = SeaquestParams(max_steps_in_episode=max_steps)
    u, rand_act, draws = _draws(seed, num_steps, B, A, use_prng, dev)
    start = start_state(B, params, dev)
    *outs, state = minatar_rollout.rollout_plain(
        _ENV, params, weights, seaquest_from_state_matrix(st0), eps, u, rand_act, draws,
        lambda t: start,
    )
    return (*outs, state_matrix_from_seaquest(state))


def seaquest_rollout(
    seed: int,
    eps: float,
    weights: Sequence[torch.Tensor],
    st0: torch.Tensor,
    num_steps: int,
    use_prng: bool = True,
    max_steps: int = 1000,
):
    """``seaquest_rollout_plain`` for CPU tensors, the CUDA kernel for CUDA
    tensors. Same arguments and outputs; ``seed`` is an int in [0, 2**64)."""
    if st0.device.type == "cpu":
        return seaquest_rollout_plain(seed, eps, weights, st0, num_steps, use_prng, max_steps)
    if st0.device.type != "cuda":
        raise ValueError(f"seaquest_rollout: unsupported device {st0.device}")
    out = minatar_rollout.launch(
        "seaquest_rollout", CHANNELS, seed, eps, weights, [((ROWS,), st0)], num_steps, use_prng, (max_steps,),
        plan=seaquest_plan,
    )
    seaquest_rollout.launches += 1
    return out


seaquest_rollout.launches = 0


def seaquest_plan(B: int, H: int, cluster=None) -> minatar_rollout.ClusterPlan:
    """The kernel's launch plan for B envs of H units
    (``minatar_rollout.cluster_plan`` at Seaquest's 10 channels and its
    GAME_INTS)."""
    return minatar_rollout.cluster_plan(B, H, CHANNELS, GAME_INTS, cluster)


def state_matrix_from_seaquest(state: SeaquestState) -> torch.Tensor:
    """SeaquestState of (B,) and (B, n) tensors -> the kernel's (128, B)
    int32 state matrix."""
    rows = [getattr(state, k).to(torch.int32)[None] for k in _SCALARS]
    rows += [getattr(state, k).to(torch.int32).T for _, fields in _POOLS for k in fields]
    return torch.cat(rows).contiguous()


def seaquest_from_state_matrix(st: torch.Tensor) -> SeaquestState:
    """Inverse of ``state_matrix_from_seaquest``."""
    fields = dict(zip(_SCALARS, st[: len(_SCALARS)]))
    row = len(_SCALARS)
    for n, names in _POOLS:
        for k in names:
            fields[k] = st[row : row + n].T
            row += n
    for k in _BOOLS:
        fields[k] = fields[k].bool()
    return SeaquestState(**fields)
