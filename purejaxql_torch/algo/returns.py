"""Q(lambda) lambda-return computation (port of
purejaxql_tpu/algo/returns.py):

R_t = r_t + gamma * (1 - d_t) * [ (1 - lambda) * max_a Q(s_{t+1}, a)
                                   + lambda * R_{t+1} ]

computed right-to-left with episode cuts on done, in two bootstrap
conventions:

- the gymnax form (returns.py:27-64), which the FF trainer uses: its plain
  PyTorch function lives beside its CUDA kernel in ops/lambda_returns.py,
  and the trainer calls the kernel's wrapper,
  ``ops.lambda_returns.lambda_returns``;
- the closure form (returns.py:67-99), which the recurrent trainer computes
  inside its loss, as the JAX package does in an XLA scan: plain PyTorch,
  a loop over T.
"""

from __future__ import annotations

import torch

from purejaxql_torch.ops.lambda_returns import lambda_returns_plain as lambda_returns

__all__ = ["lambda_returns", "lambda_returns_closure"]


def lambda_returns_closure(
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
    the masked bootstrap. Shapes as ``lambda_returns``: last_q (E,), the
    rest (T, E); dones as 0/1 floats or bools.
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
