"""Fused Breakout-MinAtar rollout: the hand-written CUDA kernel and its plain
twin.

Counterpart of the Breakout part of purejaxql_tpu/ops/pallas_rollout.py
(`breakout_rollout_pallas`, `state_matrix_from_breakout`,
`breakout_from_state_matrix`). One call runs T env steps for B envs: the 4
observation planes from the state, the MinAtar CNN forward, greedy argmax
(first index wins ties), the epsilon coin and a uniform random action, the
Breakout dynamics, and auto-reset with the ball's side drawn per env.

The kernel is ``csrc/breakout_rollout.cu``, on the cluster CNN of
``csrc/minatar_cluster.cuh`` (the plan: ``breakout_plan``, one cluster of C
CTAs per C envs, each CTA holding 1 / C of the dense weight in shared
memory for the whole launch). ``breakout_rollout_plain`` is
the same function in PyTorch: the TPU kernel's CNN formulas
(``ops/minatar_rollout.py``), the env's step rules (envs/minatar/breakout.py)
and the kernel's Philox4x32-10 words 0-2 (``ops/philox.py``), so kernel and
twin agree with the PRNG on as well as off. ``use_prng=False`` is the TPU
kernel's deterministic mode (pallas_rollout.py:248-251): the coin is 1, the
random action 0 and the reset side 0. ``breakout_rollout`` takes the twin
only for CPU tensors; for CUDA tensors it launches the kernel or raises.

The state is env-minor as on the TPU: an (8, B) int32 matrix with the rows
[ball_y, ball_x, ball_dir, pos, strike, last_y, last_x, time] and a
(10, 10, B) int32 brick map.
"""

from __future__ import annotations

from typing import Sequence

import torch

from purejaxql_torch.envs.base import NO_DRAWS
from purejaxql_torch.envs.minatar.breakout import (
    BreakoutParams,
    BreakoutState,
    MinBreakout,
    start_state,
)
from purejaxql_torch.ops import minatar_rollout
from purejaxql_torch.ops.philox import step_words, unit24

ROWS = 8
CHANNELS = 4
# the ints the kernel keeps in each env's CTA: the 8 state rows and 3 of its
# own (12 with padding), 4 Philox words and the 100-cell brick map
# (csrc/breakout_rollout.cu kGameInts)
GAME_INTS = 116
_ROWS = ("ball_y", "ball_x", "ball_dir", "pos", "strike", "last_y", "last_x", "time")
_ENV = MinBreakout()


@torch.no_grad()
def breakout_rollout_plain(
    seed: int,
    eps: float,
    weights: Sequence[torch.Tensor],
    st0: torch.Tensor,
    brick0: torch.Tensor,
    num_steps: int,
    use_prng: bool = True,
    max_steps: int = 1000,
):
    """Plain PyTorch rollout. Returns (obs (T,B,10,10,4), act (T,B) int32,
    rew (T,B), done (T,B) int32, q (T,B,A), final_obs (B,10,10,4),
    st (8,B) int32, brick (10,10,B) int32)."""
    T, B, A, dev = num_steps, st0.shape[1], weights[8].shape[0], st0.device
    if use_prng:
        w = step_words(seed, T, B, 3, dev)
        u, rand_act, side = unit24(w[..., 0]), (w[..., 1] >> 8) % A, ((w[..., 2] >> 8) & 1).to(torch.int32)
    else:
        u = torch.ones(T, B, device=dev)
        rand_act = torch.zeros(T, B, dtype=torch.int64, device=dev)
        side = torch.zeros(T, B, dtype=torch.int32, device=dev)
    # a missed ball ends the episode, so no env carries terminal on
    *outs, state = minatar_rollout.rollout_plain(
        _ENV, BreakoutParams(max_steps_in_episode=max_steps), weights,
        breakout_from_state_matrix(st0, brick0), eps, u, rand_act, [NO_DRAWS] * T,
        lambda t: start_state(side[t]),
    )
    return (*outs, *state_matrix_from_breakout(state))


def breakout_rollout(
    seed: int,
    eps: float,
    weights: Sequence[torch.Tensor],
    st0: torch.Tensor,
    brick0: torch.Tensor,
    num_steps: int,
    use_prng: bool = True,
    max_steps: int = 1000,
):
    """``breakout_rollout_plain`` for CPU tensors, the CUDA kernel for CUDA
    tensors. Same arguments and outputs; ``seed`` is an int in [0, 2**64)."""
    if st0.device.type == "cpu":
        return breakout_rollout_plain(
            seed, eps, weights, st0, brick0, num_steps, use_prng, max_steps
        )
    if st0.device.type != "cuda":
        raise ValueError(f"breakout_rollout: unsupported device {st0.device}")
    out = minatar_rollout.launch(
        "breakout_rollout", CHANNELS, seed, eps, weights, [((ROWS,), st0), ((10, 10), brick0)],
        num_steps, use_prng, (max_steps,), plan=breakout_plan,
    )
    breakout_rollout.launches += 1
    return out


breakout_rollout.launches = 0


def breakout_plan(B: int, H: int, cluster=None) -> minatar_rollout.ClusterPlan:
    """The kernel's launch plan for B envs of H units
    (``minatar_rollout.cluster_plan`` at Breakout's 4 channels and its
    GAME_INTS)."""
    return minatar_rollout.cluster_plan(B, H, CHANNELS, GAME_INTS, cluster)


def state_matrix_from_breakout(bstate: BreakoutState):
    """BreakoutState of (B,) tensors and a (B, 10, 10) brick map -> the
    kernel's (8, B) int32 state matrix and (10, 10, B) int32 brick map."""
    st = torch.stack([getattr(bstate, k).to(torch.int32) for k in _ROWS])
    return st.contiguous(), bstate.brick_map.to(torch.int32).permute(1, 2, 0).contiguous()


def breakout_from_state_matrix(st: torch.Tensor, brick: torch.Tensor) -> BreakoutState:
    """Inverse of ``state_matrix_from_breakout``; ``terminal`` is False, as
    the state after a step with auto-reset always is."""
    rows = dict(zip(_ROWS, st))
    rows["strike"] = rows["strike"].bool()
    return BreakoutState(
        brick_map=brick.permute(2, 0, 1), terminal=torch.zeros_like(rows["strike"]), **rows
    )
