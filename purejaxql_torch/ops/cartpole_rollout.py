"""Fused CartPole rollout: the hand-written CUDA kernel and its plain twin.

Counterpart of the CartPole part of purejaxql_tpu/ops/pallas_rollout.py
(`cartpole_rollout_pallas`, `state_matrix_from_cartpole`,
`cartpole_from_state_matrix`). One call runs T env steps: the Q forward of
the 2-layer LayerNorm MLP, greedy argmax (first index wins ties), the
epsilon coin and a uniform random action, the Euler physics, done on
|x| > 2.4, |theta| > 12 degrees or t >= max_steps, the reward masked by the
incoming state, and auto-reset to U(-0.05, 0.05)^4.

The kernel is ``csrc/cartpole_rollout.cu``. ``cartpole_rollout_plain`` is
the same function in PyTorch, including its Philox4x32-10 random stream
(``ops/philox.py``), so the two agree with the PRNG on as well as off. ``cartpole_rollout`` takes
the plain version only for CPU tensors; for CUDA tensors it launches the
kernel or raises.

Weights are passed in torch layout, as returned by ``cartpole_weights``:
(W1 (H,4), b1, ln1 scale, ln1 bias, W2 (H,H), b2, ln2 scale, ln2 bias,
head W (A,H), head b). The head is not padded: the 8-row head with a -1e9
bias of the TPU kernel is a sublane artefact.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from purejaxql_torch.envs.classic.cartpole import CartPoleState
from purejaxql_torch.ops import build
from purejaxql_torch.ops.philox import philox4x32_10, seed_key, step_env_counters

# CartPole-v1 constants (envs/classic/cartpole.py CartPoleParams)
G, POLEMASS_L, TOTAL_M = 9.8, 0.05, 1.1
LENGTH, MASSPOLE, FORCE, TAU = 0.5, 0.1, 10.0, 0.02
X_THR = 2.4
TH_THR = 12 * 2 * 3.141592653589793 / 360
MAX_ACTIONS = 8


def _draws(seed: int, num_steps: int, batch: int, num_actions: int, device):
    """The coin u, the random action (both (T, B)) and the 4 reset values
    ((T, 4, B)) of every step and env: Philox counter (t, env, group, 0),
    key = the seed's two 32-bit words."""
    t, env = step_env_counters(num_steps, batch, device)
    key = seed_key(seed)
    zero = torch.zeros_like(t)
    r0 = philox4x32_10((t, env, zero, zero), key)
    r1 = philox4x32_10((t, env, zero + 1, zero), key)
    u = (r0[0] >> 8).to(torch.float32) * (1.0 / (1 << 24))
    rand_act = (r0[1] >> 8) % num_actions
    reset = torch.stack([r0[2], r0[3], r1[0], r1[1]], 1)
    reset = (reset >> 8).to(torch.float32) * (0.1 / (1 << 24)) - 0.05
    return u, rand_act, reset


def layer_norm_relu(h, scale, bias):
    # two-pass LayerNorm, eps 1e-6: the formula of the TPU kernel
    mu = h.mean(-1, keepdim=True)
    d = h - mu
    var = (d * d).mean(-1, keepdim=True)
    return torch.relu(d * torch.rsqrt(var + 1e-6) * scale + bias)


@torch.no_grad()
def cartpole_rollout_plain(
    seed: int,
    eps: float,
    weights: Sequence[torch.Tensor],
    stf0: torch.Tensor,
    sti0: torch.Tensor,
    num_steps: int,
    use_prng: bool = True,
    max_steps: int = 500,
):
    """Plain PyTorch rollout. Returns (obs (T,B,4), act (T,B) int32,
    rew (T,B), done (T,B) int32, q (T,B,A), final_obs (B,4),
    stf (4,B), sti (1,B) int32)."""
    w1, b1, l1s, l1b, w2, b2, l2s, l2b, hw, hb = weights
    B, A = stf0.shape[1], hw.shape[0]
    dev = stf0.device
    x, x_dot, theta, theta_dot = stf0.clone()
    time = sti0[0].clone()
    if use_prng:
        u_all, rand_all, reset_all = _draws(seed, num_steps, B, A, dev)
    else:
        u_all = torch.ones(num_steps, B, device=dev)
        rand_all = torch.zeros(num_steps, B, dtype=torch.int64, device=dev)
        reset_all = torch.zeros(num_steps, 4, B, device=dev)
    obs, acts, rews, dones, qs = [], [], [], [], []
    for t in range(num_steps):
        s = torch.stack([x, x_dot, theta, theta_dot], -1)
        obs.append(s)
        h1 = layer_norm_relu(s @ w1.T + b1, l1s, l1b)
        h2 = layer_norm_relu(h1 @ w2.T + b2, l2s, l2b)
        q = h2 @ hw.T + hb
        qs.append(q)
        greedy = q.argmax(-1)
        act = torch.where(u_all[t] < eps, rand_all[t], greedy)
        a_f = act.to(torch.float32)

        # physics (cartpole.py step_env, Euler), in the TPU kernel's order
        force = FORCE * a_f - FORCE * (1.0 - a_f)
        costh = torch.cos(theta)
        sinth = torch.sin(theta)
        temp = (force + POLEMASS_L * theta_dot * theta_dot * sinth) / TOTAL_M
        thacc = (G * sinth - costh * temp) / (
            LENGTH * (4.0 / 3.0 - MASSPOLE * costh * costh / TOTAL_M)
        )
        xacc = temp - POLEMASS_L * thacc * costh / TOTAL_M
        nx = x + TAU * x_dot
        nx_dot = x_dot + TAU * xacc
        nth = theta + TAU * theta_dot
        nth_dot = theta_dot + TAU * thacc
        ntime = time + 1

        done = (nx.abs() > X_THR) | (nth.abs() > TH_THR) | (ntime >= max_steps)
        prev_done = (x.abs() > X_THR) | (theta.abs() > TH_THR) | (time >= max_steps)
        rews.append(1.0 - prev_done.to(torch.float32))
        acts.append(act.to(torch.int32))
        dones.append(done.to(torch.int32))

        x, x_dot, theta, theta_dot = (
            torch.where(done, r, v)
            for r, v in zip(reset_all[t], (nx, nx_dot, nth, nth_dot))
        )
        time = torch.where(done, torch.zeros_like(ntime), ntime)
    stf = torch.stack([x, x_dot, theta, theta_dot])
    return (
        torch.stack(obs), torch.stack(acts), torch.stack(rews),
        torch.stack(dones), torch.stack(qs), stf.T.contiguous(), stf,
        time[None].to(torch.int32),
    )


def _function():
    lib = build.load("cartpole_rollout")
    fn = lib.cartpole_rollout_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 20 + [ctypes.c_int] * 4 + [
        ctypes.c_uint64, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    return lib, fn


def _check(weights, stf0, sti0) -> Tuple[int, int, int]:
    if len(weights) != 10:
        raise ValueError("cartpole_rollout: expected the 10 tensors of cartpole_weights")
    dev = stf0.device
    H, A, B = weights[0].shape[0], weights[8].shape[0], stf0.shape[-1]
    if H % 32 or not 32 <= H <= 1024:
        raise ValueError(f"cartpole_rollout: hidden size {H} must be a multiple of 32 in [32, 1024]")
    if not 1 <= A <= min(MAX_ACTIONS, H // 32):
        raise ValueError(f"cartpole_rollout: {A} actions, the kernel takes 1..{min(MAX_ACTIONS, H // 32)}")
    shapes = [(H, 4), (H,), (H,), (H,), (H, H), (H,), (H,), (H,), (A, H), (A,)]
    named = list(zip(range(10), weights, shapes, [torch.float32] * 10))
    named += [("stf0", stf0, (4, B), torch.float32), ("sti0", sti0, (1, B), torch.int32)]
    for name, x, shape, dtype in named:
        if x.device != dev or x.dtype != dtype:
            raise ValueError(f"cartpole_rollout: input {name} must be {dtype} on {dev}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"cartpole_rollout: input {name} must be contiguous {shape}, got {tuple(x.shape)}")
    return H, A, B


def cartpole_rollout(
    seed: int,
    eps: float,
    weights: Sequence[torch.Tensor],
    stf0: torch.Tensor,
    sti0: torch.Tensor,
    num_steps: int,
    use_prng: bool = True,
    max_steps: int = 500,
):
    """``cartpole_rollout_plain`` for CPU tensors, the CUDA kernel for CUDA
    tensors. Same arguments and outputs; ``seed`` is an int in [0, 2**64)."""
    if stf0.device.type == "cpu":
        return cartpole_rollout_plain(
            seed, eps, weights, stf0, sti0, num_steps, use_prng, max_steps
        )
    if stf0.device.type != "cuda":
        raise ValueError(f"cartpole_rollout: unsupported device {stf0.device}")
    H, A, B = _check(weights, stf0, sti0)
    T = num_steps
    if T < 1:
        raise ValueError("cartpole_rollout: num_steps must be >= 1")
    f32 = dict(dtype=torch.float32, device=stf0.device)
    i32 = dict(dtype=torch.int32, device=stf0.device)
    obs = torch.empty((T, B, 4), **f32)
    act = torch.empty((T, B), **i32)
    rew = torch.empty((T, B), **f32)
    done = torch.empty((T, B), **i32)
    q = torch.empty((T, B, A), **f32)
    final_obs = torch.empty((B, 4), **f32)
    stf = torch.empty((4, B), **f32)
    sti = torch.empty((1, B), **i32)
    lib, fn = _function()
    ptrs = [w.data_ptr() for w in weights] + [
        x.data_ptr() for x in (stf0, sti0, obs, act, rew, done, q, final_obs, stf, sti)
    ]
    with torch.cuda.device(stf0.device):
        err = fn(
            *ptrs, T, B, H, A, seed, eps, int(use_prng), max_steps,
            torch.cuda.current_stream().cuda_stream,
        )
    build.check_launch(lib, err, "cartpole_rollout")
    cartpole_rollout.launches += 1
    return obs, act, rew, done, q, final_obs, stf, sti


cartpole_rollout.launches = 0


def cartpole_weights(network) -> Tuple[torch.Tensor, ...]:
    """The rollout's 10 weight tensors from a 2-layer LayerNorm QNetwork
    (models/qnet.py), detached and in torch layout."""
    if network.num_layers != 2 or network.norm_type != "layer_norm" or network.norm_input:
        raise ValueError("the fused CartPole rollout needs a 2-layer layer_norm QNetwork with norm_input=False")
    mods = (
        network.Dense_0, network.LayerNorm_0, network.Dense_1,
        network.LayerNorm_1, network.Dense_2,
    )
    return tuple(
        p.detach() for m in mods for p in (m.weight, m.bias)
    )


def state_matrix_from_cartpole(cstate: CartPoleState):
    """CartPoleState of (B,) tensors -> ((4, B) float32, (1, B) int32)."""
    st = torch.stack([cstate.x, cstate.x_dot, cstate.theta, cstate.theta_dot])
    return st.to(torch.float32).contiguous(), cstate.time.to(torch.int32)[None].contiguous()


def cartpole_from_state_matrix(stf: torch.Tensor, sti: torch.Tensor) -> CartPoleState:
    return CartPoleState(x=stf[0], x_dot=stf[1], theta=stf[2], theta_dot=stf[3], time=sti[0])
