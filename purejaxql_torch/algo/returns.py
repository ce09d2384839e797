"""Q(lambda) lambda-return computation, gymnax form (port of
purejaxql_tpu/algo/returns.py:27-64):

R_t = r_t + gamma * (1 - d_t) * [ (1 - lambda) * max_a Q(s_{t+1}, a)
                                   + lambda * R_{t+1} ]

computed right-to-left with episode cuts on done. The plain PyTorch
function lives beside its CUDA kernel in ops/lambda_returns.py; the trainer
calls the kernel's wrapper, ``ops.lambda_returns.lambda_returns``.
"""

from purejaxql_torch.ops.lambda_returns import lambda_returns_plain as lambda_returns

__all__ = ["lambda_returns"]
