"""Fused CartPole rollout: the hand-written CUDA kernel and its plain twin.

Counterpart of the CartPole part of purejaxql_tpu/ops/pallas_rollout.py
(`cartpole_rollout_pallas`, `state_matrix_from_cartpole`,
`cartpole_from_state_matrix`). One call runs T env steps: the Q forward of
the 2-layer LayerNorm MLP, greedy argmax (first index wins ties), the
epsilon coin and a uniform random action, the Euler physics, done on
|x| > 2.4, |theta| > 12 degrees or t >= max_steps, the reward masked by the
incoming state, and auto-reset to U(-0.05, 0.05)^4.

The kernel is ``csrc/cartpole_rollout.cu``, a thread-block cluster per
group of envs with each CTA holding its rows of W2 in shared memory for the
whole rollout (the plan: ``cartpole_plan``). ``cartpole_rollout_plain`` is
the same function in PyTorch, including its Philox4x32-10 random stream
(``ops/philox.py``), so the two agree with the PRNG on as well as off.
Both take the greedy action by torch.argmax's rule: a NaN Q-value counts as
the maximum (the first NaN wins) and the first index wins ties.
``cartpole_rollout`` takes the plain version only for CPU tensors; for CUDA
tensors it launches the kernel or raises.

Weights are passed in torch layout, as returned by ``cartpole_weights``:
(W1 (H,4), b1, ln1 scale, ln1 bias, W2 (H,H), b2, ln2 scale, ln2 bias,
head W (A,H), head b). The head is not padded: the 8-row head with a -1e9
bias of the TPU kernel is a sublane artefact.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

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

# shared memory a CTA may use on Hopper (227 KB of the SM's 256 KB)
SMEM_LIMIT = 232_448
CLUSTER_SIZES = (1, 2, 4, 8, 16)
THREADS = 256  # a CTA: 8 warps, a warp an env of the cluster's group
MAX_GROUP = THREADS // 32
SMS = 132  # an H100 SXM's SMs: the plan puts a launch's CTAs in one wave on them
# the most layer-2 units (rows of W2) a CTA owns in the plan, and the fewest
# CTAs a cluster: on an H100 at (T 64, H 256) C 4, 8 and 16 ran 0.2257,
# 0.2242 and 0.2490 ms at B 32 and 0.3709, 0.4199 and 0.6417 at B 128
# (scripts/time_rollouts.py, PERF.md section 6)
PLAN_UNITS = 64
MIN_CLUSTER = 4
RESIDENT_MAX_H = 512  # the largest H whose W2 slice the plan holds in shared memory
STEP_CHUNK = 64  # csrc/cartpole_rollout.cu kChunk: the steps whose random words a CTA draws at once


class CartPolePlan(NamedTuple):
    """How the kernel splits a launch (``cartpole_plan``)."""

    cluster: int  # C CTAs a cluster
    group: int  # G envs a cluster (a warp an env): 1, 2, 4 or 8
    clusters: int  # ceil(B / G); the last group's envs past B are computed, not written
    units: int  # U = H / C: the layer-2 units (rows of W2) a CTA owns
    resident: bool  # the W2 slice held in shared memory for the whole launch
    threads: int  # a CTA
    smem_bytes: int  # dynamic shared memory a CTA

    @property
    def ints(self) -> Tuple[int, int, int, int]:
        """What the C entry point takes before the stream."""
        return self.cluster, self.group, int(self.resident), self.smem_bytes


def _split(U: int, H: int) -> int:
    """Threads a row of the layer-2 slice takes (csrc/cartpole_rollout.cu
    split_of)."""
    ks = 1
    while ks < 32 and 2 * ks * U <= THREADS and 8 * ks <= H:
        ks *= 2
    return ks


def cartpole_smem_bytes(H: int, C: int, G: int, resident: bool) -> int:
    """csrc/cartpole_rollout.cu `smem_floats` in bytes: two mbarriers, the
    W2 slice (U rows of H floats, padded where fewer than 8 threads share a
    row) where resident, layer-1 activations (G, H), two staging blocks of
    G x U (padded to 4 floats), two slots of C received blocks, a gather
    table (H ints), the random words of STEP_CHUNK steps for G envs (6
    each), and the head (room for MAX_ACTIONS rows and biases)."""
    U = H // C
    ks = _split(U, H)
    stride = H + (0 if ks >= 8 else 4 * ks)
    blk = -(-G * U // 4) * 4
    return 4 * (
        4 + (U * stride if resident else 0) + G * H + 2 * blk * (1 + C) + H + 6 * STEP_CHUNK * G
        + MAX_ACTIONS * (H + 1)
    )


@functools.lru_cache(maxsize=None)
def cartpole_plan(B: int, H: int, cluster: Optional[int] = None) -> CartPolePlan:
    """The kernel's launch plan for B envs of H units (H a multiple of 32 in
    [32, 1024]).

    C is the smallest power of two, at least MIN_CLUSTER, at which a CTA
    owns at most PLAN_UNITS layer-2 units (``cluster`` overrides it, for
    timing). G, a power of two (a template of the kernel), is the smallest
    that puts the clusters in one wave on the card's SMs (one CTA an SM),
    else 8. The W2 slice is held in shared memory for H <= 512 and read
    from L2 every step above, as a resident slice there would halve G and
    break the wave; G is halved until the CTA fits in 227 KB."""
    if B < 1 or H % 32 or not 32 <= H <= 1024:
        raise ValueError(f"cartpole_plan: B must be positive and H a multiple of 32 in [32, 1024], got {B}, {H}")
    C = max(MIN_CLUSTER, 1 << (-(-H // PLAN_UNITS) - 1).bit_length()) if cluster is None else cluster
    if C not in CLUSTER_SIZES or H // C > THREADS:
        raise ValueError(f"cartpole_plan: cluster {C} at H {H}: must be one of {CLUSTER_SIZES}, H / C <= {THREADS}")
    group = next((g for g in (1, 2, 4, 8) if -(-B // g) * C <= SMS), MAX_GROUP)
    for resident in (True, False) if H <= RESIDENT_MAX_H else (False,):
        G = group
        while G > 1 and cartpole_smem_bytes(H, C, G, resident) > SMEM_LIMIT:
            G //= 2
        smem = cartpole_smem_bytes(H, C, G, resident)
        if smem <= SMEM_LIMIT:
            return CartPolePlan(
                cluster=C, group=G, clusters=-(-B // G), units=H // C, resident=resident, threads=THREADS,
                smem_bytes=smem,
            )
    raise ValueError(f"cartpole_plan: H {H} does not fit a CTA's shared memory at C {C}")


def active_clusters(plan: CartPolePlan, H: int) -> int:
    """How many clusters of ``plan`` the card places at once
    (cudaOccupancyMaxActiveClusters). Raises if the query fails."""
    lib = build.load("cartpole_rollout")
    fn = lib.cartpole_rollout_active_clusters
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 5
    active = fn(H, *plan.ints)
    if active < 0:
        build.check_launch(lib, -active, "cartpole_rollout")
    return active


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
        ctypes.c_uint64, ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
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
    if any(w.data_ptr() % 16 for w in (weights[0], weights[4])):
        raise ValueError("cartpole_rollout: W1 and W2 must be 16-byte aligned (float4 loads)")
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
            *ptrs, T, B, H, A, seed, eps, int(use_prng), max_steps, *cartpole_plan(B, H).ints,
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
