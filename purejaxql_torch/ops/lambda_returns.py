"""Q(lambda) returns: the hand-written CUDA kernel and its plain twin.

Counterpart of purejaxql_tpu/ops/pallas_returns.py (`lambda_returns_pallas`).
The kernel is ``csrc/lambda_returns.cu``; ``lambda_returns_plain`` is the
same function in plain PyTorch, the gymnax form of
purejaxql_tpu/algo/returns.py:46-64.

``lambda_returns`` takes the plain version only for CPU tensors. For CUDA
tensors it launches the kernel or raises; nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from purejaxql_torch.ops import build


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


def _function():
    lib = build.load("lambda_returns")
    fn = lib.lambda_returns_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
    ]
    return lib, fn


def lambda_returns(
    last_q: torch.Tensor,
    rewards: torch.Tensor,
    dones: torch.Tensor,
    max_qs: torch.Tensor,
    gamma: float,
    lam: float,
) -> torch.Tensor:
    """``lambda_returns_plain`` for CPU tensors, the CUDA kernel for CUDA
    tensors (all float32 and contiguous: dones as 0/1 floats)."""
    if rewards.device.type == "cpu":
        return lambda_returns_plain(last_q, rewards, dones, max_qs, gamma, lam)
    if rewards.device.type != "cuda":
        raise ValueError(f"lambda_returns: unsupported device {rewards.device}")
    if rewards.dim() != 2 or rewards.shape[0] < 1:
        raise ValueError(f"lambda_returns: rewards must be (T, E), got {tuple(rewards.shape)}")
    T, E = rewards.shape
    for name, x, shape in (
        ("last_q", last_q, (E,)),
        ("rewards", rewards, (T, E)),
        ("dones", dones, (T, E)),
        ("max_qs", max_qs, (T, E)),
    ):
        if x.device != rewards.device or x.dtype != torch.float32:
            raise ValueError(f"lambda_returns: {name} must be float32 on {rewards.device}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"lambda_returns: {name} must be contiguous {shape}, got {tuple(x.shape)}")
    out = torch.empty_like(rewards)
    lib, fn = _function()
    with torch.cuda.device(rewards.device):
        err = fn(
            last_q.data_ptr(), rewards.data_ptr(), dones.data_ptr(),
            max_qs.data_ptr(), out.data_ptr(), T, E, gamma, gamma * lam,
            torch.cuda.current_stream().cuda_stream,
        )
    build.check_launch(lib, err, "lambda_returns")
    lambda_returns.launches += 1
    return out


lambda_returns.launches = 0
