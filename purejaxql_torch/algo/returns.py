"""Q(lambda) lambda-return computation (port of
purejaxql_tpu/algo/returns.py):

R_t = r_t + gamma * (1 - d_t) * [ (1 - lambda) * max_a Q(s_{t+1}, a)
                                   + lambda * R_{t+1} ]

computed right-to-left with episode cuts on done, in two bootstrap
conventions:

- the gymnax form (returns.py:27-64), which the FF and AC trainers use;
- the closure form (returns.py:67-99), which the recurrent trainer computes
  inside its loss, as the JAX package does in an XLA scan.

Both plain PyTorch functions live beside the CUDA kernel that serves both
forms, in ops/lambda_returns.py, and are re-exported here under their
names; the trainers call the kernel's wrappers,
``ops.lambda_returns.lambda_returns`` and
``ops.lambda_returns.lambda_returns_closure``.
"""

from __future__ import annotations

from purejaxql_torch.ops.lambda_returns import lambda_returns_closure_plain as lambda_returns_closure
from purejaxql_torch.ops.lambda_returns import lambda_returns_plain as lambda_returns

__all__ = ["lambda_returns", "lambda_returns_closure"]
