"""The MinAtar convolutional Q-network.

Port of purejaxql_tpu/models/cnn.py (``MinAtarCNN``, ``CNNQNetwork``) for
the MinAtar trunk with LayerNorm in float32. Flax conventions are kept so
that weights cross between the packages unchanged (core/checkpoint.py):

- modules carry flax's auto-names: ``BatchNorm_0``, ``CNN_0`` holding
  ``Conv_0``, ``LayerNorm_0``, ``Dense_0``, ``LayerNorm_1``, and the head
  ``Dense_0``;
- inputs and activations are channels-last (NHWC), as in flax; the conv
  weight is stored OIHW, as torch's;
- the LayerNorm after the conv normalises over the channels of each pixel;
- the flatten before the dense layer is in flax's (i, j, f) order;
- the conv and the trunk's dense layer start he-normal (truncated,
  variance 2 / fan_in), the head lecun-normal, all biases zero, drawn from
  the given generator only.

The 3x3 VALID conv is a sum over its 9 taps of shifted slices times the
tap's (C, O) weights, written as one matmul over the gathered patches
(im2col): it runs in full float32 on the GPU, where a float32 cuDNN
convolution would default to TF32.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from purejaxql_torch.models.qnet import BatchNorm, LayerNorm, dense, variance_scaling_

KERNEL = 3
CONV_FEATURES = 16
HE = 2.0  # flax he_normal: variance_scaling(2, "fan_in", "truncated_normal")


def conv_patches(x: torch.Tensor, k: int = KERNEL) -> torch.Tensor:
    """(B, H, W, C) -> (B, H-k+1, W-k+1, k*k*C): the VALID patches in the
    (di, dj, c) order of a flax HWIO kernel reshaped to (k*k*C, O)."""
    h, w = x.shape[1] - k + 1, x.shape[2] - k + 1
    return torch.cat(
        [x[:, di : di + h, dj : dj + w, :] for di in range(k) for dj in range(k)], -1
    )


def conv_weight_matrix(weight: torch.Tensor) -> torch.Tensor:
    """OIHW conv weight -> (k*k*C, O), rows in the (di, dj, c) order."""
    o = weight.shape[0]
    return weight.permute(2, 3, 1, 0).reshape(-1, o)


class Conv(nn.Module):
    """flax ``nn.Conv`` with a k x k kernel, stride 1, VALID padding, on
    NHWC input; the weight is OIHW."""

    def __init__(self, in_channels: int, features: int, generator: Optional[torch.Generator], k: int = KERNEL):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_channels, k, k))
        self.bias = nn.Parameter(torch.zeros(features))
        variance_scaling_(self.weight, k * k * in_channels, HE, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.shape[-1]
        return conv_patches(x, k) @ conv_weight_matrix(self.weight) + self.bias


class MinAtarCNN(nn.Module):
    """One 3x3 VALID conv (16 channels) and a Dense(hidden) trunk, each with
    LayerNorm and relu (cnn.py:50-78)."""

    def __init__(self, obs_shape, hidden_size: int, generator: Optional[torch.Generator]):
        super().__init__()
        rows, cols, channels = obs_shape
        flat = (rows - KERNEL + 1) * (cols - KERNEL + 1) * CONV_FEATURES
        self.Conv_0 = Conv(channels, CONV_FEATURES, generator)
        self.LayerNorm_0 = LayerNorm(CONV_FEATURES)
        self.Dense_0 = dense(flat, hidden_size, generator, scale=HE)
        self.LayerNorm_1 = LayerNorm(hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.LayerNorm_0(self.Conv_0(x)))
        x = x.reshape(x.shape[0], -1)  # (i, j, f), as flax flattens NHWC
        return torch.relu(self.LayerNorm_1(self.Dense_0(x)))


class CNNQNetwork(nn.Module):
    """Q-head over the MinAtar trunk with the input-norm convention of
    cnn.py:111-159: a BatchNorm over the input when norm_input, else a dummy
    BatchNorm (its statistics still move in train mode) and x / input_scale."""

    def __init__(
        self,
        obs_shape,
        action_dim: int,
        hidden_size: int = 128,
        norm_type: str = "layer_norm",
        norm_input: bool = False,
        trunk: str = "minatar",
        input_scale: float = 255.0,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if trunk != "minatar":
            raise NotImplementedError(f"CNN_TRUNK '{trunk}' is not ported yet")
        if norm_type != "layer_norm":
            raise NotImplementedError(f"NORM_TYPE '{norm_type}' in the CNN trunk is not ported yet")
        self.action_dim = action_dim
        self.norm_type = norm_type
        self.norm_input = norm_input
        self.hidden_size = hidden_size
        self.input_scale = input_scale
        self.BatchNorm_0 = BatchNorm(obs_shape[-1])
        self.CNN_0 = MinAtarCNN(obs_shape, hidden_size, generator)
        self.Dense_0 = dense(hidden_size, action_dim, generator)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        normed = self.BatchNorm_0(x, train)
        x = normed if self.norm_input else x / self.input_scale
        return self.Dense_0(self.CNN_0(x))
