"""Train state for online Q-learning: the network (params and batch-norm
statistics), the optimizer state and the progress counters.

Port of purejaxql_tpu/core/train_state.py. The counters are host integers:
they drive the epsilon and LR schedules and the eval cadence, so keeping
them off the device keeps host syncs out of the update loop.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch
from torch import nn

from purejaxql_torch.core.optim import ClipRAdam


@dataclass
class PQNTrainState:
    network: nn.Module
    optimizer: ClipRAdam
    timesteps: int = 0
    n_updates: int = 0
    grad_steps: int = 0

    @property
    def step(self) -> int:
        """Optimizer steps taken (optax's TrainState.step)."""
        return self.optimizer.count

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.network.named_parameters())

    @property
    def batch_stats(self) -> Dict[str, torch.Tensor]:
        return dict(self.network.named_buffers())
