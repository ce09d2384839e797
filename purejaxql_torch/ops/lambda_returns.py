"""Q(lambda) returns: the hand-written CUDA kernel, in its two forms, and
their plain twins.

Counterpart of purejaxql_tpu/ops/pallas_returns.py (`lambda_returns_pallas`)
and, for the closure form, of the XLA scan of
purejaxql_tpu/algo/returns.py:67-99. The kernel is ``csrc/lambda_returns.cu``
(one template, a C entry point a form); ``lambda_returns_plain`` is the
gymnax form in plain PyTorch (returns.py:26-64), which the FF and AC
trainers use, and ``lambda_returns_closure_plain`` the closure form, which
the recurrent trainer computes inside its loss. ``lambda_plan`` is the
kernel's launch plan.

``lambda_returns`` and ``lambda_returns_closure`` take their plain twins
only for CPU tensors. For CUDA tensors they launch the kernel or raise;
nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from purejaxql_torch.ops import build

THREADS = 160  # csrc/lambda_returns.cu kThreads: the chain warp and four loader warps
MAX_TILE = 32  # envs a block: one lane of the chain warp each
CHUNK = 16  # csrc/lambda_returns.cu kChunk: steps a shared-memory slot holds
MAX_STAGES = 4  # slots in the ring: 64 steps in flight


class LambdaPlan(NamedTuple):
    """How the kernel splits a launch (``lambda_plan``)."""

    tile: int  # envs a block, a power of two: env e0 + c for c < tile, the last block masked
    blocks: int  # ceil(E / tile)
    threads: int  # a block
    chunk: int  # steps a slot (CHUNK): chunk k covers steps [max(0, T - (k + 1) chunk), T - k chunk)
    stages: int  # slots in the ring, for chunks 1, 2, ... (chunk 0 is loaded straight to registers)
    smem_bytes: int  # dynamic shared memory a block

    @property
    def ints(self) -> Tuple[int, int, int]:
        """What the C entry points take after gamma * lam."""
        return self.tile, self.stages, self.smem_bytes


def lambda_smem_bytes(tile: int, stages: int) -> int:
    """csrc/lambda_returns.cu `smem_bytes`: a full and an empty mbarrier a
    slot, then each slot's chunk of rewards, dones and max_qs."""
    return 16 * stages + 12 * stages * CHUNK * tile


@functools.lru_cache(maxsize=None)
def lambda_plan(T: int, E: int) -> LambdaPlan:
    """The kernel's launch plan for T steps of E envs: a tile of the
    smallest power of two >= E envs, at most 32, a block; chunks of 16
    steps (the earliest one shorter where 16 does not divide T), and a ring
    of as many slots as there are chunks after the first, at most 4."""
    if T < 1 or E < 1:
        raise ValueError(f"lambda_plan: T and E must be positive, got {T}, {E}")
    tile = min(MAX_TILE, 1 << (E - 1).bit_length())
    stages = min(-(-T // CHUNK) - 1, MAX_STAGES)  # chunk 0 goes straight to registers
    return LambdaPlan(
        tile=tile, blocks=-(-E // tile), threads=THREADS, chunk=CHUNK, stages=stages,
        smem_bytes=lambda_smem_bytes(tile, stages),
    )


def lambda_returns_plain(
    last_q: torch.Tensor,
    rewards: torch.Tensor,
    dones: torch.Tensor,
    max_qs: torch.Tensor,
    gamma: float,
    lam: float,
) -> torch.Tensor:
    """Lambda returns, gymnax form.

    Args:
      last_q: (E,) max_a Q(s_T, a), the bootstrap from the post-rollout obs.
      rewards, dones: (T, E) rollout rewards and done flags.
      max_qs: (T, E) max_a Q(s_t, a) recorded during the rollout.
      gamma, lam: discount and lambda.

    Returns:
      (T, E) lambda-return targets.
    """
    dones = dones.to(rewards.dtype)
    out = torch.empty_like(rewards)
    next_q = last_q * (1.0 - dones[-1])
    lam_ret = rewards[-1] + gamma * next_q
    out[-1] = lam_ret
    for t in range(rewards.shape[0] - 2, -1, -1):
        reward, done = rewards[t], dones[t]
        target_bootstrap = reward + gamma * (1 - done) * next_q
        delta = lam_ret - next_q
        lam_ret = target_bootstrap + gamma * lam * delta
        lam_ret = (1 - done) * lam_ret + done * reward
        out[t] = lam_ret
        next_q = max_qs[t]
    return out


def lambda_returns_closure_plain(
    last_q: torch.Tensor,
    rewards: torch.Tensor,
    dones: torch.Tensor,
    max_qs: torch.Tensor,
    gamma: float,
    lam: float,
) -> torch.Tensor:
    """Lambda returns, closure form (atari/rnn scripts).

    The T-1 return is r[-1] + gamma*(1-d[-1])*last_q, and the carry's
    next_q is seeded with max_qs[-1], the recorded Q at the final step, not
    the masked bootstrap. Shapes as ``lambda_returns_plain``: last_q (E,),
    the rest (T, E); dones as 0/1 floats or bools.
    """
    dones = dones.to(rewards.dtype)
    not_done = 1.0 - dones
    out = torch.empty_like(rewards)
    lam_ret = rewards[-1] + gamma * not_done[-1] * last_q
    out[-1] = lam_ret
    next_q = max_qs[-1]
    for t in range(rewards.shape[0] - 2, -1, -1):
        reward = rewards[t]
        target_bootstrap = reward + gamma * not_done[t] * next_q
        delta = lam_ret - next_q
        lam_ret = target_bootstrap + gamma * lam * delta
        lam_ret = not_done[t] * lam_ret + dones[t] * reward
        out[t] = lam_ret
        next_q = max_qs[t]
    return out


@functools.lru_cache(maxsize=None)
def _entry(symbol: str):
    """(library, C entry point) of csrc/lambda_returns.cu, built and typed once."""
    lib = build.load("lambda_returns")
    fn = getattr(lib, symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    return lib, fn


def _launch(name: str, symbol: str, last_q, rewards, dones, max_qs, gamma: float, lam: float) -> torch.Tensor:
    """Check the operands (float32, contiguous, on the card of `rewards`) and
    launch the kernel's `symbol` entry point on the current stream."""
    if rewards.dim() != 2 or rewards.shape[0] < 1 or rewards.shape[1] < 1:
        raise ValueError(f"{name}: rewards must be (T, E) with T, E >= 1, got {tuple(rewards.shape)}")
    T, E = rewards.shape
    device = rewards.device
    for arg, x, shape in (
        ("last_q", last_q, (E,)),
        ("rewards", rewards, (T, E)),
        ("dones", dones, (T, E)),
        ("max_qs", max_qs, (T, E)),
    ):
        if x.device != device or x.dtype != torch.float32:
            raise ValueError(f"{name}: {arg} must be float32 on {device}")
        if x.shape != shape or not x.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous {shape}, got {tuple(x.shape)}")
    out = torch.empty_like(rewards)
    lib, fn = _entry(symbol)
    args = (
        last_q.data_ptr(), rewards.data_ptr(), dones.data_ptr(), max_qs.data_ptr(), out.data_ptr(),
        T, E, gamma, gamma * lam, *lambda_plan(T, E).ints,
    )
    if device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    build.check_launch(lib, err, "lambda_returns")
    return out


def lambda_returns(
    last_q: torch.Tensor,
    rewards: torch.Tensor,
    dones: torch.Tensor,
    max_qs: torch.Tensor,
    gamma: float,
    lam: float,
) -> torch.Tensor:
    """``lambda_returns_plain`` for CPU tensors, the CUDA kernel's gymnax
    form for CUDA tensors (all float32 and contiguous: dones as 0/1
    floats)."""
    if rewards.device.type == "cpu":
        return lambda_returns_plain(last_q, rewards, dones, max_qs, gamma, lam)
    if rewards.device.type != "cuda":
        raise ValueError(f"lambda_returns: unsupported device {rewards.device}")
    out = _launch("lambda_returns", "lambda_returns_f32", last_q, rewards, dones, max_qs, gamma, lam)
    lambda_returns.launches += 1
    return out


def lambda_returns_closure(
    last_q: torch.Tensor,
    rewards: torch.Tensor,
    dones: torch.Tensor,
    max_qs: torch.Tensor,
    gamma: float,
    lam: float,
) -> torch.Tensor:
    """``lambda_returns_closure_plain`` for CPU tensors, the CUDA kernel's
    closure form for CUDA tensors (float32 and contiguous; dones as bools
    or 0/1 floats, cast here once)."""
    if rewards.device.type == "cpu":
        return lambda_returns_closure_plain(last_q, rewards, dones, max_qs, gamma, lam)
    if rewards.device.type != "cuda":
        raise ValueError(f"lambda_returns_closure: unsupported device {rewards.device}")
    if dones.dtype == torch.bool:
        dones = dones.to(torch.float32)
    out = _launch(
        "lambda_returns_closure", "lambda_returns_closure_f32", last_q, rewards, dones, max_qs, gamma, lam
    )
    lambda_returns_closure.launches += 1
    return out


lambda_returns.launches = 0
lambda_returns_closure.launches = 0
