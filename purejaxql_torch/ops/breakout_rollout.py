"""Fused Breakout-MinAtar rollout: the hand-written CUDA kernel and its plain
twin.

Counterpart of the Breakout part of purejaxql_tpu/ops/pallas_rollout.py
(`breakout_rollout_pallas`, `_pack_cnn_params`, `state_matrix_from_breakout`,
`breakout_from_state_matrix`). One call runs T env steps for B envs: the 4
observation planes from the state, the MinAtar CNN forward, greedy argmax
(first index wins ties), the epsilon coin and a uniform random action, the
Breakout dynamics, and auto-reset with the ball's side drawn per env.

The kernel is ``csrc/breakout_rollout.cu``. ``breakout_rollout_plain`` is
the same function in PyTorch: the TPU kernel's CNN formulas (two-pass
LayerNorm, eps 1e-6), the env's step rules (envs/minatar/breakout.py) and
the kernel's Philox4x32-10 stream (``ops/philox.py``), so kernel and twin
agree with the PRNG on as well as off. ``use_prng=False`` is the TPU
kernel's deterministic mode (pallas_rollout.py:248-251): the coin is 1, the
random action 0 and the reset side 0. ``breakout_rollout`` takes the twin
only for CPU tensors; for CUDA tensors it launches the kernel or raises.

The state is env-minor as on the TPU: an (8, B) int32 matrix with the rows
[ball_y, ball_x, ball_dir, pos, strike, last_y, last_x, time] and a
(10, 10, B) int32 brick map.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from purejaxql_torch.envs.base import select_state
from purejaxql_torch.envs.minatar.breakout import (
    BreakoutParams,
    BreakoutState,
    MinBreakout,
    start_state,
)
from purejaxql_torch.models.cnn import conv_patches, conv_weight_matrix
from purejaxql_torch.ops import build
from purejaxql_torch.ops.cartpole_rollout import layer_norm_relu
from purejaxql_torch.ops.philox import philox4x32_10, seed_key, step_env_counters

MAX_ACTIONS = 8
CONV_TAPS, CONV_FEATURES, FLAT = 36, 16, 1024  # 3x3x4 taps, 16 maps of 8x8
_ROWS = ("ball_y", "ball_x", "ball_dir", "pos", "strike", "last_y", "last_x", "time")
_ENV = MinBreakout()


def _draws(seed: int, num_steps: int, batch: int, num_actions: int, device):
    """The coin u, the random action and the reset side, each (T, B), from
    one Philox call per step and env: counter (t, env, 0, 0), key = the
    seed's two 32-bit words."""
    t, env = step_env_counters(num_steps, batch, device)
    zero = torch.zeros_like(t)
    r = philox4x32_10((t, env, zero, zero), seed_key(seed))
    u = (r[0] >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return u, (r[1] >> 8) % num_actions, ((r[2] >> 8) & 1).to(torch.int32)


def cnn_forward_plain(planes: torch.Tensor, weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """Q-values (B, A) of (B, 10, 10, C) observation planes, with the
    kernel's weights and the TPU kernel's formulas."""
    cw, cb, l1s, l1b, dw, db, l2s, l2b, hw, hb = weights
    h1 = layer_norm_relu(conv_patches(planes) @ cw + cb, l1s, l1b)
    h2 = layer_norm_relu(h1.reshape(h1.shape[0], -1) @ dw.T + db, l2s, l2b)
    return h2 @ hw.T + hb


@torch.no_grad()
def breakout_rollout_plain(
    seed: int,
    eps: float,
    weights: Sequence[torch.Tensor],
    st0: torch.Tensor,
    brick0: torch.Tensor,
    num_steps: int,
    use_prng: bool = True,
    max_steps: int = 1000,
):
    """Plain PyTorch rollout. Returns (obs (T,B,10,10,4), act (T,B) int32,
    rew (T,B), done (T,B) int32, q (T,B,A), final_obs (B,10,10,4),
    st (8,B) int32, brick (10,10,B) int32)."""
    B, A, dev = st0.shape[1], weights[8].shape[0], st0.device
    params = BreakoutParams(max_steps_in_episode=max_steps)
    state = breakout_from_state_matrix(st0, brick0)
    if use_prng:
        u_all, rand_all, side_all = _draws(seed, num_steps, B, A, dev)
    else:
        u_all = torch.ones(num_steps, B, device=dev)
        rand_all = torch.zeros(num_steps, B, dtype=torch.int64, device=dev)
        side_all = torch.zeros(num_steps, B, dtype=torch.int32, device=dev)
    obs, acts, rews, dones, qs = [], [], [], [], []
    for t in range(num_steps):
        planes = _ENV.get_obs(state)
        q = cnn_forward_plain(planes, weights)
        act = torch.where(u_all[t] < eps, rand_all[t], q.argmax(-1))
        _, stepped, rew, done, _ = _ENV.step_env(state, act, params)
        # a missed ball ends the episode, so no env carries terminal on
        state = select_state(done, start_state(side_all[t]), stepped)
        obs.append(planes)
        qs.append(q)
        acts.append(act.to(torch.int32))
        rews.append(rew)
        dones.append(done.to(torch.int32))
    st, brick = state_matrix_from_breakout(state)
    return (
        torch.stack(obs), torch.stack(acts), torch.stack(rews), torch.stack(dones),
        torch.stack(qs), _ENV.get_obs(state), st, brick,
    )


def _function():
    lib = build.load("breakout_rollout")
    fn = lib.breakout_rollout_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 20 + [ctypes.c_int] * 4 + [
        ctypes.c_uint64, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    return lib, fn


def _check(weights, st0, brick0) -> Tuple[int, int, int]:
    if len(weights) != 10:
        raise ValueError("breakout_rollout: expected the 10 tensors of breakout_weights")
    dev = st0.device
    H, A, B = weights[4].shape[0], weights[8].shape[0], st0.shape[-1]
    if H % 32 or not 32 <= H <= 256:
        raise ValueError(f"breakout_rollout: hidden size {H} must be a multiple of 32 in [32, 256]")
    if not 1 <= A <= MAX_ACTIONS:
        raise ValueError(f"breakout_rollout: {A} actions, the kernel takes 1..{MAX_ACTIONS}")
    f = CONV_FEATURES
    shapes = [(CONV_TAPS, f), (f,), (f,), (f,), (H, FLAT), (H,), (H,), (H,), (A, H), (A,)]
    named = list(zip(range(10), weights, shapes, [torch.float32] * 10))
    named += [("st0", st0, (8, B), torch.int32), ("brick0", brick0, (10, 10, B), torch.int32)]
    for name, x, shape, dtype in named:
        if x.device != dev or x.dtype != dtype:
            raise ValueError(f"breakout_rollout: input {name} must be {dtype} on {dev}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"breakout_rollout: input {name} must be contiguous {shape}, got {tuple(x.shape)}")
    if weights[4].data_ptr() % 16:
        raise ValueError("breakout_rollout: the dense weight must be 16-byte aligned (float4 loads)")
    return H, A, B


def breakout_rollout(
    seed: int,
    eps: float,
    weights: Sequence[torch.Tensor],
    st0: torch.Tensor,
    brick0: torch.Tensor,
    num_steps: int,
    use_prng: bool = True,
    max_steps: int = 1000,
):
    """``breakout_rollout_plain`` for CPU tensors, the CUDA kernel for CUDA
    tensors. Same arguments and outputs; ``seed`` is an int in [0, 2**64)."""
    if st0.device.type == "cpu":
        return breakout_rollout_plain(
            seed, eps, weights, st0, brick0, num_steps, use_prng, max_steps
        )
    if st0.device.type != "cuda":
        raise ValueError(f"breakout_rollout: unsupported device {st0.device}")
    H, A, B = _check(weights, st0, brick0)
    T = num_steps
    if T < 1:
        raise ValueError("breakout_rollout: num_steps must be >= 1")
    f32 = dict(dtype=torch.float32, device=st0.device)
    i32 = dict(dtype=torch.int32, device=st0.device)
    obs = torch.empty((T, B, 10, 10, 4), **f32)
    act = torch.empty((T, B), **i32)
    rew = torch.empty((T, B), **f32)
    done = torch.empty((T, B), **i32)
    q = torch.empty((T, B, A), **f32)
    final_obs = torch.empty((B, 10, 10, 4), **f32)
    st = torch.empty((8, B), **i32)
    brick = torch.empty((10, 10, B), **i32)
    lib, fn = _function()
    ptrs = [w.data_ptr() for w in weights] + [
        x.data_ptr() for x in (st0, brick0, obs, act, rew, done, q, final_obs, st, brick)
    ]
    with torch.cuda.device(st0.device):
        err = fn(
            *ptrs, T, B, H, A, seed, eps, int(use_prng), max_steps,
            torch.cuda.current_stream().cuda_stream,
        )
    build.check_launch(lib, err, "breakout_rollout")
    breakout_rollout.launches += 1
    return obs, act, rew, done, q, final_obs, st, brick


breakout_rollout.launches = 0


def breakout_weights(network) -> Tuple[torch.Tensor, ...]:
    """The rollout's 10 weight tensors from a layer_norm CNNQNetwork with
    norm_input=False (models/cnn.py), detached: the conv weight as a
    (36, 16) matrix with rows in the (di, dj, c) tap order and 1/INPUT_SCALE
    folded in (as _pack_cnn_params does), conv bias, LayerNorm scale and
    bias, the dense weight (H, 1024), its bias, LayerNorm scale and bias,
    and the unpadded head (A, H), (A,). The kernel reads the conv output in
    flax's (i, j, f) flatten order, so the dense weight's columns need no
    reorder (the TPU kernel's (f, i, j) merge needs one,
    pallas_rollout.py:127)."""
    if network.norm_type != "layer_norm" or network.norm_input:
        raise ValueError("the fused Breakout rollout needs a layer_norm CNNQNetwork with norm_input=False")
    cnn = network.CNN_0
    cw = conv_weight_matrix(cnn.Conv_0.weight.detach()) / network.input_scale
    mods = (cnn.LayerNorm_0, cnn.Dense_0, cnn.LayerNorm_1, network.Dense_0)
    return (cw.contiguous(), cnn.Conv_0.bias.detach()) + tuple(
        p.detach() for m in mods for p in (m.weight, m.bias)
    )


def state_matrix_from_breakout(bstate: BreakoutState):
    """BreakoutState of (B,) tensors and a (B, 10, 10) brick map -> the
    kernel's (8, B) int32 state matrix and (10, 10, B) int32 brick map."""
    st = torch.stack([getattr(bstate, k).to(torch.int32) for k in _ROWS])
    return st.contiguous(), bstate.brick_map.to(torch.int32).permute(1, 2, 0).contiguous()


def breakout_from_state_matrix(st: torch.Tensor, brick: torch.Tensor) -> BreakoutState:
    """Inverse of ``state_matrix_from_breakout``; ``terminal`` is False, as
    the state after a step with auto-reset always is."""
    rows = dict(zip(_ROWS, st))
    rows["strike"] = rows["strike"].bool()
    return BreakoutState(
        brick_map=brick.permute(2, 0, 1), terminal=torch.zeros_like(rows["strike"]), **rows
    )
