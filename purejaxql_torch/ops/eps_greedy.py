"""Epsilon-greedy action selection: the hand-written CUDA kernel and its
plain twin.

Counterpart of purejaxql_tpu/ops/pallas_explore.py (`eps_greedy_pallas`,
`_eps_greedy_kernel`). Per env of an (E, A) Q-matrix: the greedy action
(argmax, the first index on ties, a NaN counted as the maximum), replaced by
a uniform random action when a coin falls below eps. The two random words of
env e are those of one Philox4x32-10 call, counter (0, e, 0, 0), keyed by
the 64-bit ``seed`` (``ops/philox.py``): word 0 the coin, u = (w0 >> 8) /
2**24, word 1 the random action, (w1 >> 8) % A, as the TPU kernel uses its
hardware PRNG's two words.

The kernel is ``csrc/eps_greedy.cu``; ``eps_greedy_plain`` is the same
function in plain PyTorch. ``eps_greedy`` takes the twin only for CPU
tensors; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from purejaxql_torch.ops import build
from purejaxql_torch.ops.philox import philox4x32_10, seed_key, unit24


def eps_greedy_words(seed: int, num_envs: int, device):
    """Words 0 and 1 of env e's Philox call, counter (0, e, 0, 0): (E,)
    int64 tensors of uint32 values."""
    env = torch.arange(num_envs, dtype=torch.int64, device=device)
    zero = torch.zeros_like(env)
    w0, w1, _, _ = philox4x32_10((zero, env, zero, zero), seed_key(seed))
    return w0, w1


def eps_greedy_plain(seed: int, q_vals: torch.Tensor, eps: float) -> torch.Tensor:
    """q_vals (E, A) float32, eps a float, seed an int in [0, 2**64) ->
    actions (E,) int64."""
    n_envs, n_actions = q_vals.shape
    w0, w1 = eps_greedy_words(seed, n_envs, q_vals.device)
    coin = unit24(w0) < torch.tensor(eps, dtype=torch.float32)
    random_actions = (w1 >> 8) % n_actions
    return torch.where(coin, random_actions, q_vals.argmax(-1))


def _function():
    lib = build.load("eps_greedy")
    fn = lib.eps_greedy_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_uint64, ctypes.c_void_p]
    return lib, fn


def eps_greedy(seed: int, q_vals: torch.Tensor, eps: float) -> torch.Tensor:
    """``eps_greedy_plain`` for a CPU tensor, the CUDA kernel for a CUDA one
    (a contiguous (E, A) float32 matrix). Same arguments and output."""
    if q_vals.device.type == "cpu":
        return eps_greedy_plain(seed, q_vals, eps)
    if q_vals.device.type != "cuda":
        raise ValueError(f"eps_greedy: unsupported device {q_vals.device}")
    if q_vals.dim() != 2 or q_vals.shape[1] < 1 or q_vals.dtype != torch.float32 or not q_vals.is_contiguous():
        raise ValueError(
            f"eps_greedy: q_vals must be a contiguous (E, A) float32 matrix, got "
            f"{q_vals.dtype} {tuple(q_vals.shape)}"
        )
    if not 0 <= seed < 2**64:
        raise ValueError(f"eps_greedy: seed {seed} is not in [0, 2**64)")
    E, A = q_vals.shape
    out = torch.empty(E, dtype=torch.int64, device=q_vals.device)
    lib, fn = _function()
    with torch.cuda.device(q_vals.device):
        err = fn(q_vals.data_ptr(), out.data_ptr(), E, A, float(eps), seed,
                 torch.cuda.current_stream().cuda_stream)
    build.check_launch(lib, err, "eps_greedy")
    eps_greedy.launches += 1
    return out


eps_greedy.launches = 0
