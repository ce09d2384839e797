"""purejaxql-torch: the PyTorch/CUDA port of purejaxql_tpu for one NVIDIA H100.

The JAX package beside this one is the reference each part is held
against. This package imports nothing from it: it keeps its own copies of
the configs it needs, and module names follow the JAX package so a reader
finds each counterpart at the same path.

Entry points run on ``cuda`` unless the caller asks for the CPU
(``make_train(config, device="cpu")``, ``DEVICE=cpu`` on the CLI). The hot
loops (the fused game rollouts, the Q(lambda) returns, the GRU time scan and
its backward) are hand-written CUDA kernels under ``csrc/``, each with a plain
PyTorch twin that runs only for CPU tensors. ``make_train`` is the FF
trainer's; the recurrent trainer's is ``algo.pqn_rnn.make_train``.

Quick start:

    from purejaxql_torch import compose, make_train

    config = compose(alg="pqn_cartpole")
    outs = make_train(config)()
"""

__version__ = "0.1.0"

from purejaxql_torch.core.config import compose
from purejaxql_torch.algo.pqn import make_train

__all__ = ["compose", "make_train", "__version__"]
