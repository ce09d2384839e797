"""Minimal space types (gymnax-style): the trainer reads a Discrete space's
``n`` and a Box's ``shape``. Port of purejaxql_tpu/envs/spaces.py."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


class Space:
    pass


class Discrete(Space):
    def __init__(self, n: int, dtype=torch.int64):
        self.n = int(n)
        self.shape = ()
        self.dtype = dtype

    def __repr__(self):
        return f"Discrete({self.n})"


class Box(Space):
    def __init__(self, low, high, shape: Sequence[int], dtype=np.float32):
        self.low = low
        self.high = high
        self.shape = tuple(shape)
        self.dtype = dtype

    def __repr__(self):
        return f"Box(shape={self.shape})"
