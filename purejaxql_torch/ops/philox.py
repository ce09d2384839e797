"""Philox4x32-10 (Salmon et al., SC'11) in int64 torch arithmetic.

The counter-based generator every fused rollout kernel runs
(``csrc/philox.cuh``), here for their plain twins: each (step, env, draw
group) is a counter, the kernel's 64-bit seed the key, so a twin draws the
same bits as its kernel without sharing any state with it.

Word layout. The random words of step t for env b are numbered w = 0, 1,
...; word w is lane w % 4 of the call with counter (t, b, w // 4, 0). So a
game that needs n words makes ceil(n / 4) calls, k = 0, 1, ..., and every
game reads its words in this order:

- CartPole: 0 coin, 1 random action, 2-5 the four reset values;
- Breakout: 0 coin, 1 random action, 2 reset side;
- Asterix: 0 coin, 1 random action, 2-9 the Gumbel score of each slot,
  10 spawn direction, 11 gold;
- Freeway: 0 coin, 1 random action, 2-9 lane speeds, 10-17 lane
  directions, 18-25 reset x of each car;
- SpaceInvaders: 0 coin, 1 random action;
- Seaquest (29 words in 8 calls, the TPU kernel's draw order,
  pallas_rollout.py:1734-1750): 0 coin, 1 random action, 2-5 the
  friendly-bullet slot scores, 6-9 the enemy-bullet slot scores, 10-17 the
  fish slot scores, 18-21 the enemy-sub slot scores, 22-25 the diver slot
  scores, 26 the lane ((w >> 8) % 8 + 1), 27 the direction ((w >> 8) & 1:
  from the left, moving right), 28 is_sub (unit24 < 1/3);
- Pendulum AC: 0 and 1 the Box-Muller pair of the exploration noise
  (u1 = ((w0 >> 8) + 1) / 2^24 in (0, 1], u2 = (w1 >> 8) / 2^24), 2 the
  reset theta, 3 the reset theta_dot: one call, counter (t, b, 0, 0).

A word is used through its top 24 bits (``w >> 8``), as the TPU kernels use
their hardware PRNG's words.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

MASK = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit halves of a * b for a < 2**32 and b int64 in
    [0, 2**32), with every partial product below 2**63."""
    p_lo = a * (b & 0xFFFF)
    p_hi = a * (b >> 16)
    mid = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (mid >> 32), mid & MASK


def philox4x32_10(counter: Sequence[torch.Tensor], key: Tuple[int, int]):
    """Philox4x32-10 on int64 tensors holding uint32 words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for i in range(10):
        if i:
            k0, k1 = (k0 + _PHILOX_W[0]) & MASK, (k1 + _PHILOX_W[1]) & MASK
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def seed_key(seed: int) -> Tuple[int, int]:
    """The Philox key of a 64-bit seed: its low and high 32-bit words."""
    return seed & MASK, (seed >> 32) & MASK


def step_env_counters(num_steps: int, batch: int, device):
    """(t, env) int64 grids of shape (T, B): the first two counter words of
    the draws at step t for env b."""
    t = torch.arange(num_steps, dtype=torch.int64, device=device)[:, None]
    env = torch.arange(batch, dtype=torch.int64, device=device)[None, :]
    return torch.broadcast_tensors(t, env)


def step_words(seed: int, num_steps: int, batch: int, num_words: int, device) -> torch.Tensor:
    """Words 0 .. num_words - 1 of every step and env, as a (T, B, n) int64
    tensor of uint32 values, in the layout of the module docstring."""
    t, env = step_env_counters(num_steps, batch, device)
    zero = torch.zeros_like(t)
    key = seed_key(seed)
    calls = [philox4x32_10((t, env, zero + k, zero), key) for k in range(-(-num_words // 4))]
    return torch.stack([w for call in calls for w in call], -1)[..., :num_words]


def unit24(word: torch.Tensor) -> torch.Tensor:
    """A word's top 24 bits as a float32 in [0, 1), in steps of 2**-24."""
    return (word >> 8).to(torch.float32) * (1.0 / (1 << 24))
