"""The convolutional Q-networks: the MinAtar CNN and the Nature-DQN CNN.

Port of purejaxql_tpu/models/cnn.py (``MinAtarCNN``, ``NatureCNN``,
``CNNQNetwork``; both trunks are ``ConvTrunk`` here) with every trunk norm
the JAX module takes (``_make_normalizer``, cnn.py:22-46): NORM_TYPE
layer_norm, batch_norm, batch_renorm, and none for any other value, taken as
written (no craftax mapping, factory.py:63). Flax conventions are kept so
that weights cross between the packages unchanged (core/checkpoint.py):

- modules carry flax's auto-names: ``BatchNorm_0``, ``CNN_0`` holding
  ``Conv_0``, ``LayerNorm_0``, ``Dense_0``, ``LayerNorm_1`` (MinAtar) or
  ``Conv_0..2``, ``LayerNorm_0..3``, ``Dense_0`` (Nature), and the head
  ``Dense_0``; a batch_norm trunk has ``CNN_0.BatchNorm_i`` and a
  batch_renorm one ``CNN_0.BatchRenorm_i`` where the LayerNorms stand
  (their running statistics in the ``batch_stats`` tree), none has no
  norm;
- inputs and activations are channels-last (NHWC), as in flax; the conv
  weight is stored OIHW, as torch's;
- the LayerNorm after a conv normalises over the channels of each pixel; a
  BatchNorm or BatchRenorm there takes per-channel statistics over the
  N x H' x W' pixels of the batch (after the dense layer over the N rows);
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
fan-in, as flax's does. It takes every norm, dtype and seed count the
MinAtar trunk takes.

With ``dtype=torch.bfloat16`` (BF16_COMPUTE, cnn.py:26-40, 124-159) the input
norm and the / input_scale run in float32, the trunk casts once to bfloat16,
the conv and the dense layers compute in bfloat16 from the float32 master
parameters, the LayerNorms and BatchNorms in float32 returning bfloat16
(``models/qnet.py``; flax's ``BatchNorm(dtype=bfloat16)`` takes its
statistics in float32), a BatchRenorm, which has no dtype, its statistics in
bfloat16 returning float32 (``models/batch_renorm.py``), which the next conv
or dense layer casts back, and the Q-values come back in float32.

With ``seeds=S`` > 1 (NUM_SEEDS) the network holds S lanes with stacked
parameters (models/stacked.py; the conv weight (S, O, I, H, W)), lane i
drawn from ``generator[i]`` as the single network is, and ``forward`` takes
seed-major rows (S * N, H, W, C); the conv is the same patches product at
its stride, one batched matmul for all lanes, in float32 or bfloat16 as
above, and each lane's batch statistics are over its own pixels or rows, as
under ``jax.vmap``. For one seed the network is the single one.
"""

from __future__ import annotations


import torch
from torch import nn

from purejaxql_torch.models.qnet import Layers, add_named, variance_scaling_

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
    stride, on NHWC input; the weight is OIHW. With ``seeds`` > 1, S lanes
    on (S, N, H, W, C), lane i drawn from ``generator[i]``."""

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
        patches = conv_patches(x.flatten(0, 1), k, self.stride)  # (S * N, h, w, k*k*C)
        lanes = patches.reshape(x.shape[0], -1, patches.shape[-1])
        # the product, then the bias added, as for one seed (two roundings in bfloat16)
        y = torch.bmm(lanes, conv_weight_matrix(self.weight).to(x.dtype)) + self.bias.to(x.dtype)[:, None]
        return y.reshape(*x.shape[:2], *patches.shape[1:3], -1)


class ConvTrunk(nn.Module):
    """VALID convs, each followed by the trunk norm and relu, the NHWC
    flatten, then a dense layer with the norm and relu (cnn.py:50-108): the
    MinAtar trunk (one 3x3 conv of 16 channels, Dense(hidden)) or the
    Nature trunk (``NATURE_CONVS``, Dense(512)). The norms carry flax's
    names in call order, ``<Kind>_0`` after the first conv up to the one
    after the dense layer; with NORM_TYPE none (or any other value) there
    are none. Every conv and the dense layer compute in ``dtype``, casting
    their input to it (a BatchRenorm hands on float32, as in JAX)."""

    def __init__(self, obs_shape, convs, hidden_size: int, generator, norm_type: str = "layer_norm",
                 dtype: torch.dtype = torch.float32, seeds: int = 1):
        super().__init__()
        rows, cols, channels = obs_shape
        layers = Layers(generator, seeds)
        self.seeds, self.dtype = seeds, dtype
        self.convs = len(convs)
        self.norms, counts = [], {}

        def add_norm(features):
            norm = layers.trunk_norm(norm_type, features)
            self.norms.append(norm and add_named(self, counts, *norm))

        for i, (features, k, stride) in enumerate(convs):
            setattr(self, f"Conv_{i}", Conv(channels, features, generator, k=k, seeds=seeds, stride=stride))
            add_norm(features)
            rows, cols, channels = conv_out(rows, k, stride), conv_out(cols, k, stride), features
        self.Dense_0 = layers.dense(rows * cols * channels, hidden_size, scale=HE)
        add_norm(hidden_size)

    def _norm(self, i: int, x: torch.Tensor, train: bool) -> torch.Tensor:
        """Norm i and relu; with seeds each lane's pixels (or rows) as its
        rows, the lane axis first."""
        if self.norms[i] is not None:
            norm = getattr(self, self.norms[i])
            if self.seeds > 1:
                x = norm(x.reshape(self.seeds, -1, x.shape[-1]), train).reshape(x.shape)
            else:
                x = norm(x, train)
        return torch.relu(x)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        """(N, H, W, C) -> (N, hidden), or with seeds (S, N, H, W, C) ->
        (S, N, hidden)."""
        for i in range(self.convs):
            x = self._norm(i, getattr(self, f"Conv_{i}")(x.to(self.dtype)), train)
        x = x.reshape(*x.shape[:-3], -1)  # (i, j, f), as flax flattens NHWC
        return self._norm(self.convs, self.Dense_0(x.to(self.dtype)), train)


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
        self.action_dim = action_dim
        self.norm_type = norm_type
        self.norm_input = norm_input
        # any other CNN_TRUNK is the MinAtar trunk, as in cnn.py:143-157
        nature = trunk == "nature"
        self.hidden_size = hidden_size = NATURE_HIDDEN if nature else hidden_size
        self.input_scale = input_scale
        self.dtype = dtype
        self.seeds = seeds
        layers = Layers(generator, seeds)
        self.BatchNorm_0 = layers.norm("batch_norm", obs_shape[-1])
        convs = NATURE_CONVS if nature else ((CONV_FEATURES, KERNEL, 1),)
        self.CNN_0 = ConvTrunk(obs_shape, convs, hidden_size, generator, norm_type, dtype, seeds)
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
        q = self.Dense_0(self.CNN_0(x.to(self.dtype), train).to(self.dtype)).float()
        return q.reshape(-1, self.action_dim)
