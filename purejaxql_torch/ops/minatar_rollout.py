"""What every fused MinAtar rollout shares: the CNN's weight layout, its
plain forward, the plain rollout loop and the kernel launch.

Counterpart of purejaxql_tpu/ops/pallas_rollout.py `_pack_cnn_params`,
`_cnn_forward` and `_call_game_kernel`. Each of the five games' modules
(``ops/breakout_rollout.py``, ``ops/asterix_rollout.py``,
``ops/freeway_rollout.py``, ``ops/space_invaders_rollout.py``,
``ops/seaquest_rollout.py``) adds its state matrices, its random draws and
its kernel, ``csrc/<game>_rollout.cu``, whose CNN is
``csrc/minatar_cnn.cuh``.

Every game's kernel has one C entry point of the same shape:
``<game>_rollout_f32(10 weight pointers, the state inputs, obs, act, rew,
done, q, final_obs, the state outputs, T, B, H, A, seed, eps, use_prng,
the game's int parameters, stream)``, returning the launch's cudaError_t.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Sequence, Tuple

import torch

from purejaxql_torch.envs.base import select_state
from purejaxql_torch.models.cnn import conv_patches, conv_weight_matrix
from purejaxql_torch.ops import build
from purejaxql_torch.ops.cartpole_rollout import layer_norm_relu

MAX_ACTIONS = 8
CONV_FEATURES, FLAT = 16, 1024  # 16 maps of 8x8


def minatar_weights(network) -> Tuple[torch.Tensor, ...]:
    """The rollout kernels' 10 weight tensors from a layer_norm CNNQNetwork
    with norm_input=False (models/cnn.py) of any channel count C, detached:
    the conv weight as a (9 C, 16) matrix with rows in the (di, dj, c) tap
    order and 1/INPUT_SCALE folded in (as _pack_cnn_params does), conv bias,
    LayerNorm scale and bias, the dense weight (H, 1024), its bias, LayerNorm
    scale and bias, and the unpadded head (A, H), (A,). The kernels read the
    conv output in flax's (i, j, f) flatten order, so the dense weight's
    columns need no reorder (the TPU kernel's (f, i, j) merge needs one,
    pallas_rollout.py:127)."""
    if network.norm_type != "layer_norm" or network.norm_input:
        raise ValueError("the fused MinAtar rollouts need a layer_norm CNNQNetwork with norm_input=False")
    cnn = network.CNN_0
    cw = conv_weight_matrix(cnn.Conv_0.weight.detach()) / network.input_scale
    mods = (cnn.LayerNorm_0, cnn.Dense_0, cnn.LayerNorm_1, network.Dense_0)
    return (cw.contiguous(), cnn.Conv_0.bias.detach()) + tuple(
        p.detach() for m in mods for p in (m.weight, m.bias)
    )


def cnn_forward_plain(planes: torch.Tensor, weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """Q-values (B, A) of (B, 10, 10, C) observation planes, with the
    kernels' weights and the TPU kernel's formulas."""
    cw, cb, l1s, l1b, dw, db, l2s, l2b, hw, hb = weights
    h1 = layer_norm_relu(conv_patches(planes) @ cw + cb, l1s, l1b)
    h2 = layer_norm_relu(h1.reshape(h1.shape[0], -1) @ dw.T + db, l2s, l2b)
    return h2 @ hw.T + hb


def rollout_plain(env, params, weights, state, eps, u, rand_act, draws, starts: Callable):
    """The plain rollout every game's twin runs: T steps of the env's own
    batched step, each from its planes through ``cnn_forward_plain``, the
    epsilon coin ``u`` (T, B) against ``eps`` with the random actions
    ``rand_act`` (T, B), the step's draws ``draws[t]``, and auto-reset to
    ``starts(t)``, the start state the kernel resets to at step t. Returns
    (obs (T,B,10,10,C), act (T,B) int32, rew (T,B), done (T,B) int32,
    q (T,B,A), final_obs, final state)."""
    obs, acts, rews, dones, qs = [], [], [], [], []
    for t in range(u.shape[0]):
        planes = env.get_obs(state)
        q = cnn_forward_plain(planes, weights)
        act = torch.where(u[t] < eps, rand_act[t], q.argmax(-1))
        _, stepped, rew, done, _ = env.step_env(state, act, params, draws[t])
        state = select_state(done, starts(t), stepped)
        obs.append(planes)
        qs.append(q)
        acts.append(act.to(torch.int32))
        rews.append(rew)
        dones.append(done.to(torch.int32))
    return (
        torch.stack(obs), torch.stack(acts), torch.stack(rews), torch.stack(dones),
        torch.stack(qs), env.get_obs(state), state,
    )


def _check(name: str, weights, channels: int, state_ins) -> Tuple[int, int, int]:
    """Validate the weights and the (shape, tensor) state inputs; returns
    (H, A, B)."""
    if len(weights) != 10:
        raise ValueError(f"{name}: expected the 10 tensors of minatar_weights")
    dev = state_ins[0][1].device
    H, A, B = weights[4].shape[0], weights[8].shape[0], state_ins[0][1].shape[-1]
    if H % 32 or not 32 <= H <= 256:
        raise ValueError(f"{name}: hidden size {H} must be a multiple of 32 in [32, 256]")
    if not 1 <= A <= MAX_ACTIONS:
        raise ValueError(f"{name}: {A} actions, the kernel takes 1..{MAX_ACTIONS}")
    f = CONV_FEATURES
    shapes = [(9 * channels, f), (f,), (f,), (f,), (H, FLAT), (H,), (H,), (H,), (A, H), (A,)]
    named = [(i, w, s, torch.float32) for i, (w, s) in enumerate(zip(weights, shapes))]
    named += [(f"state {i}", x, (*shape, B), torch.int32) for i, (shape, x) in enumerate(state_ins)]
    for label, x, shape, dtype in named:
        if x.device != dev or x.dtype != dtype:
            raise ValueError(f"{name}: input {label} must be {dtype} on {dev}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name}: input {label} must be contiguous {shape}, got {tuple(x.shape)}")
    if weights[4].data_ptr() % 16:
        raise ValueError(f"{name}: the dense weight must be 16-byte aligned (float4 loads)")
    return H, A, B


def launch(name: str, channels: int, seed: int, eps: float, weights, state_ins, num_steps: int,
           use_prng: bool, game_ints: Sequence[int]):
    """Launch ``csrc/<name>.cu`` on CUDA tensors. ``state_ins`` is a list of
    (shape without B, int32 tensor (*shape, B)); the state outputs have the
    same shapes. Returns (obs (T,B,10,10,C), act (T,B) int32, rew (T,B),
    done (T,B) int32, q (T,B,A), final_obs (B,10,10,C), *state outputs)."""
    if num_steps < 1:
        raise ValueError(f"{name}: num_steps must be >= 1")
    H, A, B = _check(name, weights, channels, state_ins)
    T, dev = num_steps, weights[0].device
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    outs = (
        torch.empty((T, B, 10, 10, channels), **f32), torch.empty((T, B), **i32),
        torch.empty((T, B), **f32), torch.empty((T, B), **i32), torch.empty((T, B, A), **f32),
        torch.empty((B, 10, 10, channels), **f32),
    )
    state_outs = tuple(torch.empty((*shape, B), **i32) for shape, _ in state_ins)
    lib = build.load(name)
    fn = getattr(lib, f"{name}_f32")
    fn.restype = ctypes.c_int
    n_ptrs = 10 + 2 * len(state_ins) + len(outs)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 4 + [
        ctypes.c_uint64, ctypes.c_float, ctypes.c_int,
    ] + [ctypes.c_int] * len(game_ints) + [ctypes.c_void_p]
    ptrs = [x.data_ptr() for x in (*weights, *(x for _, x in state_ins), *outs, *state_outs)]
    with torch.cuda.device(dev):
        err = fn(
            *ptrs, T, B, H, A, seed, eps, int(use_prng), *game_ints,
            torch.cuda.current_stream().cuda_stream,
        )
    build.check_launch(lib, err, name)
    return (*outs, *state_outs)
