"""Fused Pendulum actor-critic rollout: the hand-written CUDA kernel and its
plain twin.

Counterpart of the Pendulum part of purejaxql_tpu/ops/pallas_rollout.py
(`pendulum_ac_rollout_pallas`, `state_matrix_from_pendulum`,
`pendulum_from_state_matrix`). One call runs T env steps for B envs, each
step:

1. the actor: greedy = 2 tanh(head(MLP(obs))), the MLP two Dense -> two-pass
   LayerNorm (eps 1e-6) -> relu layers, obs = [cos theta, sin theta,
   theta_dot];
2. the noise ladder: z ~ N(0, 1) by Box-Muller, std = b * noise / max(B-1, 1)
   for env b when ``linspace_noise``, else noise, and the explored action
   u = clip(greedy + 2 z std, -2, 2);
3. the value 0.5 (critic0 + critic1) at (obs, u), each critic the same MLP
   over the 4 inputs;
4. the Pendulum-v1 physics with the TPU kernel's built-in constants (the
   angle normalized with floor, the cost on the incoming state, theta_dot
   clipped to +-8), done at ``max_steps``, and auto-reset to theta =
   (2 r - 1) pi, theta_dot = 2 r' - 1, last_u = 0, time 0.

Randomness: one Philox4x32-10 call per step and env, counter (t, env, 0, 0)
(``ops/philox.py``): words 0 and 1 feed Box-Muller (u1 = ((w0 >> 8) + 1) /
2^24 in (0, 1], u2 = (w1 >> 8) / 2^24), words 2 and 3 are the reset draws
r and r'. ``use_prng=False`` is the TPU kernel's deterministic mode: z = 0
and resets to zeros.

The kernel is ``csrc/pendulum_ac_rollout.cu``; ``pendulum_rollout_plain`` is
the same function in PyTorch, in the kernel's formulas (the floor-mod angle,
the stds as b * (noise / (B - 1))), which the env (envs/classic/pendulum.py)
and the unfused trainer write as the JAX env and trainer do.
``pendulum_ac_rollout`` takes the twin only for CPU tensors; for CUDA tensors
it launches the kernel or raises.

Weights in torch layout, as ``pendulum_ac_weights`` returns them: the
actor's 10 tensors (W1 (H,3), b1, LN1 scale, LN1 bias, W2 (H,H), b2, LN2
scale, LN2 bias, head W (1,H), head b (1,)) and the same 10 for each of the
two critics, with W1 (H,4). The state is env-minor as on the TPU: stf (3, B)
float32 [theta, theta_dot, last_u] and sti (1, B) int32 time.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from purejaxql_torch.envs.classic.pendulum import PendulumState
from purejaxql_torch.ops import build
from purejaxql_torch.ops.cartpole_rollout import layer_norm_relu
from purejaxql_torch.ops.philox import step_words, unit24

# Pendulum-v1 constants, built into the kernel as into the TPU kernel
# (pallas_rollout.py:2127-2130; envs/classic/pendulum.py PendulumParams)
MAX_SPEED, MAX_TORQUE, DT, G, M, L = 8.0, 2.0, 0.05, 10.0, 1.0, 1.0
TWO_PI = 2.0 * math.pi


def _mlp2(x: torch.Tensor, w: Sequence[torch.Tensor]) -> torch.Tensor:
    w1, b1, l1s, l1b, w2, b2, l2s, l2b, hw, hb = w
    h = layer_norm_relu(x @ w1.T + b1, l1s, l1b)
    h = layer_norm_relu(h @ w2.T + b2, l2s, l2b)
    return (h @ hw.T + hb).squeeze(-1)


def _draws(seed: int, num_steps: int, batch: int, device):
    """z ~ N(0, 1) and the two reset values, each (T, B), from the words of
    Philox counter (t, env, 0, 0)."""
    w = step_words(seed, num_steps, batch, 4, device)
    u1 = ((w[..., 0] >> 8) + 1).to(torch.float32) * (1.0 / (1 << 24))
    u2 = unit24(w[..., 1])
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(TWO_PI * u2)
    return z, (unit24(w[..., 2]) * 2.0 - 1.0) * math.pi, unit24(w[..., 3]) * 2.0 - 1.0


def noise_stds(noise_std: float, batch: int, linspace_noise: bool, device) -> torch.Tensor:
    """Each env's std, (B,), as the kernel computes it: lane * (noise /
    max(B - 1, 1)) in float32, or noise for every env."""
    noise = np.float32(noise_std)
    if not linspace_noise:
        return torch.full((batch,), float(noise), device=device)
    step = float(noise / np.float32(max(batch - 1, 1)))
    return torch.arange(batch, device=device).to(torch.float32) * step


@torch.no_grad()
def pendulum_rollout_plain(
    seed: int,
    noise_std: float,
    actor_w: Sequence[torch.Tensor],
    critic_w: Sequence[torch.Tensor],
    stf0: torch.Tensor,
    sti0: torch.Tensor,
    num_steps: int,
    use_prng: bool = True,
    max_steps: int = 200,
    linspace_noise: bool = True,
):
    """Plain PyTorch rollout. Returns (obs (T,B,3), u (T,B,1), greedy
    (T,B,1), value (T,B), reward (T,B), done (T,B) float32, final_obs (B,3),
    stf (3,B), sti (1,B) int32)."""
    T, B, dev = num_steps, stf0.shape[1], stf0.device
    theta, theta_dot, last_u = stf0.clone()
    time = sti0[0].clone()
    if use_prng:
        z_all, rth_all, rthd_all = _draws(seed, T, B, dev)
    else:
        z_all = rth_all = rthd_all = torch.zeros(T, B, device=dev)
    stds = noise_stds(noise_std, B, linspace_noise, dev)
    c0, c1 = critic_w[:10], critic_w[10:]
    outs = []
    for t in range(T):
        obs = torch.stack([torch.cos(theta), torch.sin(theta), theta_dot], -1)
        greedy = torch.tanh(_mlp2(obs, actor_w)) * MAX_TORQUE
        u = torch.clamp(greedy + z_all[t] * stds * MAX_TORQUE, -MAX_TORQUE, MAX_TORQUE)
        cx = torch.cat([obs, u[:, None]], -1)
        value = 0.5 * (_mlp2(cx, c0) + _mlp2(cx, c1))

        # physics in the TPU kernel's order (pallas_rollout.py:2226-2241)
        shifted = theta + math.pi
        angle = shifted - TWO_PI * torch.floor(shifted / TWO_PI) - math.pi
        cost = angle * angle + 0.1 * theta_dot * theta_dot + 0.001 * u * u
        newthdot = theta_dot + (3.0 * G / (2.0 * L) * torch.sin(theta) + 3.0 / (M * L * L) * u) * DT
        newthdot = torch.clamp(newthdot, -MAX_SPEED, MAX_SPEED)
        newth = theta + newthdot * DT
        ntime = time + 1
        done = ntime >= max_steps
        outs.append((obs, u, greedy, value, -cost, done.to(torch.float32)))

        theta = torch.where(done, rth_all[t], newth)
        theta_dot = torch.where(done, rthd_all[t], newthdot)
        last_u = torch.where(done, 0.0, u)
        time = torch.where(done, 0, ntime).to(torch.int32)
    obs, u, greedy, value, rew, done = (torch.stack(x) for x in zip(*outs))
    final_obs = torch.stack([torch.cos(theta), torch.sin(theta), theta_dot], -1)
    stf = torch.stack([theta, theta_dot, last_u])
    return obs, u[..., None], greedy[..., None], value, rew, done, final_obs, stf, time[None]


def _check(actor_w, critic_w, stf0, sti0) -> Tuple[int, int]:
    if len(actor_w) != 10 or len(critic_w) != 20:
        raise ValueError(
            "pendulum_ac_rollout: expected the actor's 10 tensors and the two critics' 20 "
            "(pendulum_ac_weights): 2 hidden layers, NUM_CRITICS=2"
        )
    dev, H, B = stf0.device, actor_w[0].shape[0], stf0.shape[-1]
    if H % 32 or not 32 <= H <= 1024:
        raise ValueError(f"pendulum_ac_rollout: hidden size {H} must be a multiple of 32 in [32, 1024]")

    def mlp_shapes(n_in):
        return [(H, n_in), (H,), (H,), (H,), (H, H), (H,), (H,), (H,), (1, H), (1,)]

    shapes = mlp_shapes(3) + mlp_shapes(4) * 2
    named = [(i, w, s, torch.float32) for i, (w, s) in enumerate(zip((*actor_w, *critic_w), shapes))]
    named += [("stf0", stf0, (3, B), torch.float32), ("sti0", sti0, (1, B), torch.int32)]
    for label, x, shape, dtype in named:
        if x.device != dev or x.dtype != dtype:
            raise ValueError(f"pendulum_ac_rollout: input {label} must be {dtype} on {dev}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(
                f"pendulum_ac_rollout: input {label} must be contiguous {shape} (an action dim of 1 "
                f"and one hidden size), got {tuple(x.shape)}"
            )
    if any(w.data_ptr() % 16 for w in (actor_w[4], critic_w[4], critic_w[14])):
        raise ValueError("pendulum_ac_rollout: the H x H weights must be 16-byte aligned (float4 loads)")
    return H, B


def pendulum_ac_rollout(
    seed: int,
    noise_std: float,
    actor_w: Sequence[torch.Tensor],
    critic_w: Sequence[torch.Tensor],
    stf0: torch.Tensor,
    sti0: torch.Tensor,
    num_steps: int,
    use_prng: bool = True,
    max_steps: int = 200,
    linspace_noise: bool = True,
):
    """``pendulum_rollout_plain`` for CPU tensors, the CUDA kernel for CUDA
    tensors. Same arguments and outputs; ``seed`` is an int in [0, 2**64)."""
    if stf0.device.type == "cpu":
        return pendulum_rollout_plain(
            seed, noise_std, actor_w, critic_w, stf0, sti0, num_steps, use_prng, max_steps,
            linspace_noise,
        )
    if stf0.device.type != "cuda":
        raise ValueError(f"pendulum_ac_rollout: unsupported device {stf0.device}")
    if num_steps < 1:
        raise ValueError("pendulum_ac_rollout: num_steps must be >= 1")
    H, B = _check(actor_w, critic_w, stf0, sti0)
    T = num_steps
    f32 = dict(dtype=torch.float32, device=stf0.device)
    outs = (
        torch.empty((T, B, 3), **f32), torch.empty((T, B, 1), **f32), torch.empty((T, B, 1), **f32),
        torch.empty((T, B), **f32), torch.empty((T, B), **f32), torch.empty((T, B), **f32),
        torch.empty((B, 3), **f32), torch.empty((3, B), **f32),
        torch.empty((1, B), dtype=torch.int32, device=stf0.device),
    )
    lib = build.load("pendulum_ac_rollout")
    fn = lib.pendulum_ac_rollout_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 3 + [
        ctypes.c_uint64, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    weight_ptrs = (ctypes.c_void_p * 30)(*(w.data_ptr() for w in (*actor_w, *critic_w)))
    with torch.cuda.device(stf0.device):
        err = fn(
            ctypes.addressof(weight_ptrs), stf0.data_ptr(), sti0.data_ptr(),
            *(x.data_ptr() for x in outs), T, B, H, seed, noise_std, int(use_prng), max_steps,
            int(linspace_noise), torch.cuda.current_stream().cuda_stream,
        )
    build.check_launch(lib, err, "pendulum_ac_rollout")
    pendulum_ac_rollout.launches += 1
    return outs


pendulum_ac_rollout.launches = 0


def pendulum_ac_weights(actor, critics) -> Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]]:
    """The kernel's weights from an ``Actor`` and a two-member
    ``CriticEnsemble`` (models/actor_critic.py) with 2 layer_norm hidden
    layers: the actor's 10 tensors and the critics' 20 (member
    0 then member 1), detached views in torch layout."""
    for net in (actor, critics):
        if len(net.hidden_sizes) != 2 or net.norm_type != "layer_norm":
            raise ValueError("the fused Pendulum rollout needs 2 layer_norm hidden layers")
    if critics.num_critics != 2:
        raise ValueError("the fused Pendulum rollout needs NUM_CRITICS=2")
    names = ("Dense_0", "LayerNorm_0", "Dense_1", "LayerNorm_1", "Dense_2")
    mods = [getattr(actor, n) for n in names]
    actor_w = tuple(p.detach() for m in mods for p in (m.weight, m.bias))
    stacked = [getattr(critics, n) for n in names]
    critic_w = tuple(p.detach()[i] for i in range(2) for m in stacked for p in (m.weight, m.bias))
    return actor_w, critic_w


def state_matrix_from_pendulum(pstate: PendulumState):
    """PendulumState of (B,) tensors -> ((3, B) float32, (1, B) int32)."""
    st = torch.stack([pstate.theta, pstate.theta_dot, pstate.last_u])
    return st.to(torch.float32).contiguous(), pstate.time.to(torch.int32)[None].contiguous()


def pendulum_from_state_matrix(stf: torch.Tensor, sti: torch.Tensor) -> PendulumState:
    return PendulumState(theta=stf[0], theta_dot=stf[1], last_u=stf[2], time=sti[0])
