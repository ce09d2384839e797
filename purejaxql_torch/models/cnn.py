"""The convolutional Q-networks: the MinAtar CNN and the Nature-DQN CNN.

Port of purejaxql_tpu/models/cnn.py (``MinAtarCNN``, ``NatureCNN``,
``CNNQNetwork``) with LayerNorm trunks. Flax conventions are kept so that
weights cross between the packages unchanged (core/checkpoint.py):

- modules carry flax's auto-names: ``BatchNorm_0``, ``CNN_0`` holding
  ``Conv_0``, ``LayerNorm_0``, ``Dense_0``, ``LayerNorm_1`` (MinAtar) or
  ``Conv_0..2``, ``LayerNorm_0..3``, ``Dense_0`` (Nature), and the head
  ``Dense_0``;
- inputs and activations are channels-last (NHWC), as in flax; the conv
  weight is stored OIHW, as torch's;
- the LayerNorm after the conv normalises over the channels of each pixel;
- the flatten before the dense layer is in flax's (i, j, f) order;
- the conv and the trunk's dense layer start he-normal (truncated,
  variance 2 / fan_in), the head lecun-normal, all biases zero, drawn from
  the given generator only.

A k x k VALID conv of stride s is a sum over its k * k taps of strided
slices times the tap's (C, O) weights, written as one matmul over the
gathered patches (im2col): it runs in full float32 on the GPU, where a
float32 cuDNN convolution would default to TF32.

The Nature trunk (``trunk="nature"``, cnn.py:81-108, 143-149: the
reference's pqn_atari.py CNN) has three VALID convs, 32 x 8x8 stride 4,
64 x 4x4 stride 2 and 64 x 3x3 stride 1, each with a LayerNorm over the
channels and relu, the NHWC flatten (7 x 7 x 64 = 3,136 on 84x84 frames),
Dense(512), LayerNorm and relu. Its output sizes are XLA's for a VALID
window, max(0, (n - k) // s + 1): on frames it cannot fit (10x10 MinAtar
planes) the dense layer has no inputs and its init divides by a zero
fan-in, as flax's does. It runs in float32 and for one seed; BF16_COMPUTE
and a batch-stats trunk norm on it raise.

With ``dtype=torch.bfloat16`` (BF16_COMPUTE, cnn.py:26-40, 124-159) the input
norm and the / input_scale run in float32, the trunk casts once to bfloat16,
the conv and the dense layers compute in bfloat16 from the float32 master
parameters, the LayerNorms in float32 returning bfloat16 (``models/qnet.py``),
and the Q-values come back in float32.

With ``seeds=S`` > 1 (NUM_SEEDS) the network holds S lanes with stacked
parameters (models/stacked.py; the conv weight (S, O, I, H, W)), lane i
drawn from ``generator[i]`` as the single network is, and ``forward`` takes
seed-major rows (S * N, H, W, C); the conv is the same patches product,
one batched matmul for all lanes, in float32 or bfloat16 as above. For one
seed the network is the single one.
"""

from __future__ import annotations


import torch
from torch import nn

from purejaxql_torch.models.qnet import LayerNorm, Layers, dense, variance_scaling_

KERNEL = 3
CONV_FEATURES = 16
HE = 2.0  # flax he_normal: variance_scaling(2, "fan_in", "truncated_normal")


# the Nature trunk's convs, (features, kernel, stride) (cnn.py:93), and its dense width
NATURE_CONVS = ((32, 8, 4), (64, 4, 2), (64, 3, 1))
NATURE_HIDDEN = 512


def conv_out(n: int, k: int, stride: int = 1) -> int:
    """A VALID window's output size along an axis of n, as XLA's."""
    return max(0, (n - k) // stride + 1)


def conv_patches(x: torch.Tensor, k: int = KERNEL, stride: int = 1) -> torch.Tensor:
    """(B, H, W, C) -> (B, h, w, k*k*C), h and w ``conv_out``: the VALID
    patches of stride ``stride`` in the (di, dj, c) order of a flax HWIO
    kernel reshaped to (k*k*C, O)."""
    h, w = conv_out(x.shape[1], k, stride), conv_out(x.shape[2], k, stride)
    return torch.cat(
        [x[:, di : di + stride * (h - 1) + 1 : stride, dj : dj + stride * (w - 1) + 1 : stride, :]
         for di in range(k) for dj in range(k)], -1
    )


def conv_weight_matrix(weight: torch.Tensor) -> torch.Tensor:
    """OIHW conv weight -> (k*k*C, O), rows in the (di, dj, c) order; a
    stacked (S, O, I, H, W) one -> (S, k*k*C, O)."""
    lead = weight.dim() - 4
    o = weight.shape[-4]
    return weight.permute(*range(lead), lead + 2, lead + 3, lead + 1, lead).reshape(*weight.shape[:lead], -1, o)


class Conv(nn.Module):
    """flax ``nn.Conv`` with a k x k kernel, VALID padding and the given
    stride, on NHWC input; the weight is OIHW. With ``seeds`` > 1 (stride
    1 only), S lanes on (S, N, H, W, C), lane i drawn from
    ``generator[i]``."""

    def __init__(self, in_channels: int, features: int, generator, k: int = KERNEL, seeds: int = 1,
                 stride: int = 1):
        super().__init__()
        self.stride = stride
        lanes = () if seeds == 1 else (seeds,)
        self.weight = nn.Parameter(torch.empty(*lanes, features, in_channels, k, k))
        self.bias = nn.Parameter(torch.zeros(*lanes, features))
        for w, g in [(self.weight, generator)] if seeds == 1 else zip(self.weight, generator):
            variance_scaling_(w, k * k * in_channels, HE, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.shape[-1]
        if self.weight.dim() == 4:
            return conv_patches(x, k, self.stride) @ conv_weight_matrix(self.weight).to(x.dtype) + self.bias.to(x.dtype)
        patches = conv_patches(x.flatten(0, 1), k)  # (S * N, h, w, k*k*C)
        lanes = patches.reshape(x.shape[0], -1, patches.shape[-1])
        # the product, then the bias added, as for one seed (two roundings in bfloat16)
        y = torch.bmm(lanes, conv_weight_matrix(self.weight).to(x.dtype)) + self.bias.to(x.dtype)[:, None]
        return y.reshape(*x.shape[:2], *patches.shape[1:3], -1)


class MinAtarCNN(nn.Module):
    """One 3x3 VALID conv (16 channels) and a Dense(hidden) trunk, each with
    LayerNorm and relu (cnn.py:50-78)."""

    def __init__(self, obs_shape, hidden_size: int, generator, seeds: int = 1):
        super().__init__()
        rows, cols, channels = obs_shape
        flat = (rows - KERNEL + 1) * (cols - KERNEL + 1) * CONV_FEATURES
        layers = Layers(generator, seeds)
        self.seeds = seeds
        self.Conv_0 = Conv(channels, CONV_FEATURES, generator, seeds=seeds)
        self.LayerNorm_0 = layers.layer_norm(CONV_FEATURES)
        self.Dense_0 = layers.dense(flat, hidden_size, scale=HE)
        self.LayerNorm_1 = layers.layer_norm(hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, C) -> (N, hidden), or with seeds (S, N, H, W, C) ->
        (S, N, hidden)."""
        x = self.Conv_0(x)
        if self.seeds > 1:  # each lane's pixels as its rows
            x = torch.relu(self.LayerNorm_0(x.reshape(self.seeds, -1, x.shape[-1]))).reshape(x.shape)
        else:
            x = torch.relu(self.LayerNorm_0(x))
        x = x.reshape(*x.shape[:-3], -1)  # (i, j, f), as flax flattens NHWC
        return torch.relu(self.LayerNorm_1(self.Dense_0(x)))


class NatureCNN(nn.Module):
    """The Nature-DQN trunk (cnn.py:81-108): three VALID convs, each with
    LayerNorm over the channels and relu, then Dense(512), LayerNorm and
    relu, on float32 NHWC input."""

    def __init__(self, obs_shape, generator):
        super().__init__()
        rows, cols, channels = obs_shape
        for i, (features, k, stride) in enumerate(NATURE_CONVS):
            setattr(self, f"Conv_{i}", Conv(channels, features, generator, k=k, stride=stride))
            setattr(self, f"LayerNorm_{i}", LayerNorm(features))
            rows, cols, channels = conv_out(rows, k, stride), conv_out(cols, k, stride), features
        self.Dense_0 = dense(rows * cols * channels, NATURE_HIDDEN, generator, scale=HE)
        self.LayerNorm_3 = LayerNorm(NATURE_HIDDEN)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, C) -> (N, 512)."""
        for i in range(len(NATURE_CONVS)):
            x = torch.relu(getattr(self, f"LayerNorm_{i}")(getattr(self, f"Conv_{i}")(x)))
        x = x.reshape(x.shape[0], -1)  # (i, j, f), as flax flattens NHWC
        return torch.relu(self.LayerNorm_3(self.Dense_0(x)))


class CNNQNetwork(nn.Module):
    """Q-head over the MinAtar or the Nature trunk with the input-norm
    convention of cnn.py:111-159: a BatchNorm over the input when norm_input,
    else a dummy BatchNorm (its statistics still move in train mode) and x /
    input_scale."""

    def __init__(
        self,
        obs_shape,
        action_dim: int,
        hidden_size: int = 128,
        norm_type: str = "layer_norm",
        norm_input: bool = False,
        trunk: str = "minatar",
        input_scale: float = 255.0,
        generator=None,
        dtype: torch.dtype = torch.float32,
        seeds: int = 1,
    ):
        super().__init__()
        # any other CNN_TRUNK is the MinAtar trunk, as in cnn.py:143-157
        if trunk == "nature" and (dtype != torch.float32 or seeds > 1):
            raise NotImplementedError("CNN_TRUNK 'nature' runs in float32 for one seed: BF16_COMPUTE and "
                                      "NUM_SEEDS > 1 on it are not ported yet")
        if norm_type != "layer_norm":
            raise NotImplementedError(f"NORM_TYPE '{norm_type}' in the CNN trunk is not ported yet")
        self.action_dim = action_dim
        self.norm_type = norm_type
        self.norm_input = norm_input
        self.hidden_size = hidden_size = NATURE_HIDDEN if trunk == "nature" else hidden_size
        self.input_scale = input_scale
        self.dtype = dtype
        self.seeds = seeds
        layers = Layers(generator, seeds)
        self.BatchNorm_0 = layers.norm("batch_norm", obs_shape[-1])
        if trunk == "nature":
            self.CNN_0 = NatureCNN(obs_shape, generator)
        else:
            self.CNN_0 = MinAtarCNN(obs_shape, hidden_size, generator, seeds)
        self.Dense_0 = layers.dense(hidden_size, action_dim)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if self.seeds > 1:
            # seed-major rows: each lane's (S, N, H, W, C), its pixels the
            # input norm's rows
            x = x.reshape(self.seeds, -1, *x.shape[1:])
            normed = self.BatchNorm_0(x.reshape(self.seeds, -1, x.shape[-1]), train).reshape(x.shape)
        else:
            normed = self.BatchNorm_0(x, train)
        x = normed if self.norm_input else x / self.input_scale
        q = self.Dense_0(self.CNN_0(x.to(self.dtype))).float()
        return q.reshape(-1, self.action_dim)
