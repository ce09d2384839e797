#!/usr/bin/env python3
"""Drive the PyTorch port (purejaxql_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, one GPU

Phases, each ending the run with a non-zero exit if it fails:

1. identify the card (nvidia-smi name and power limit, torch/CUDA/nvcc);
2. build the CUDA kernels under purejaxql_torch/csrc/ (one nvcc each, in
   parallel) into build/purejaxql_torch/;
3. hold each kernel against its plain PyTorch twin on the card, at the
   trainers' shapes: the lambda returns in both forms (gymnax and closure,
   at the trainers' shapes, short, ragged and long ones, each also with
   NaN and infinities in max_qs and rewards), the CartPole cluster rollout (PRNG off
   and on, at the trainer's two shapes and at ragged shapes that force
   resets, each with its plan, register counts and the clusters the card
   places at once; a Q-row with a NaN), the Breakout,
   Asterix, Freeway, SpaceInvaders and Seaquest rollouts (PRNG off and on;
   Seaquest also at a shape that forces resets; the five kernels on the
   cluster CNN also at a ragged shape, each with its plans, register counts
   and the clusters the card places at once, and with a NaN in every
   Q-row; Seaquest also through its cash-ins), the GRU
   scan's forward and backward cluster kernels at seven shapes (VDN's
   Spread and SMAX windows among them), each with its launch plan and the
   kernels' register and spill counts (and autograd through them), and the
   Pendulum actor-critic cluster rollout (PRNG off and on, at the trainer's
   shape, at one that forces resets and at a ragged one whose W2 slices are
   read from L2, each with its plan and register counts), and the
   epsilon-greedy kernel (bit for bit, at
   the Craftax trainer's shape and two others, at eps 0, 0.3 and 1, with a
   tied and a NaN row, and on edge rows: signed zeros, NaN payloads,
   infinities);
4. check the kernels' random streams by their statistics (Seaquest: the
   coin, and one step of 8192 envs that fire, are shot at and spawn;
   epsilon-greedy: P(random), a uniform histogram at eps 1);
5. train pqn_cartpole at full width (H 256, 32 envs x 64 steps, 16
   minibatches x 4 epochs, greedy eval 128 envs x 500 steps) for 200k env
   steps through the CLI's entry point, with the launch counters zeroed just
   before and read just after, and check that it learned;
6. train pqn_minatar at full width (the MinAtar CNN, 128 envs x 32 steps,
   32 minibatches x 2 epochs, greedy eval 128 envs x up to max_steps) the
   same way: Breakout-MinAtar for 500k env steps and Asterix-MinAtar (the
   YAML's default game, no ENV_NAME) for 500k, each checked for learning,
   then Freeway-MinAtar and SpaceInvaders-MinAtar for 16 updates each, and
   Seaquest-MinAtar for 500k, its launches within the range its eval allows
   and checked against its gate;
6d. train pqn_rnn_memory_chain at its full config (GRU H 256, 32 envs x 128
   steps, window 4, 16 minibatches x 4 epochs, 1e5 env steps, greedy eval
   128 envs x 64 steps) through the GRU scan kernels and the closure form
   of the returns kernel (one launch of each a grad step) and check that it
   remembers; the FF trainer on the same config must not; then
   pqn_rnn_cartpole at full width for 16 updates;
6e. train pqn_pendulum at full width (actor and two critics H 256, 64 envs x
   32 steps, 8 minibatches x 4 epochs, greedy eval 64 envs x 200 steps every
   10 % of the run) for 400k env steps through the Pendulum kernel and check
   that its best greedy eval beats -500;
6f. train pqn_craftax at full width (Forager, H 1024 x 4 with an input
   BatchRenorm, 1024 envs x 1 step, resets at ratio 16, 1-step TD) for 2^21
   env steps, the YAML unchanged, so the cuda policy gives it the fast
   program: RESET_BANK=256 (the reset bank, refreshed every 16 steps),
   FAST_TARGETS and SKIP_NOOP_PERMUTE. Every action of the training rollout
   from the epsilon-greedy kernel (one launch an update), no other kernel,
   the bank's refresh bursts counted (one every 16 updates), finite
   metrics, episodes ending, the saved flax tree, env-steps/s and the
   done-masked returns of its last 10 % printed (no learning bar: at this
   length learned and LR=0 runs do not separate, PERF.md section 7); then
   the strict program (PARITY=strict with the epsilon-greedy kernel:
   optimistic resets, concat 1-step TD, a permuted minibatch) for 2^19
   steps; then pqn_craftax with BF16_COMPUTE for 2^18 steps, its trunk's
   activations bfloat16 (forward hooks) and its parameters float32, and
   its bfloat16 forward held within BF16_BOUND of the float32 forward on the
   same weights at H 1024 x 4 and batch 1024; then Breakout-MinAtar with
   BF16_COMPUTE for 16 updates through the fused Breakout kernel (which
   reads the float32 master weights);
6g. train pqn_vdn_spread at full width (3 agents, one GRU network H 256
   shared by all, 128 envs x 25 steps, window 4, 8 minibatches x 2 epochs,
   greedy eval 128 envs x 25 steps every 5 % of the run) for the YAML's 1e6
   env steps through the GRU scan kernels and the closure form of the
   returns kernel, one launch of each a grad step at VDN's shapes (T 29,
   rows 48; targets (28, 16)), and check that it learned (the JAX package's
   bar: the last tenth of updates' mean team return above the first
   tenth's by more than 3); then pqn_vdn_smax (Skirmish 2s3z, 5 agents,
   rows 80), pqn_vdn_kitchen and pqn_vdn_hanabi at full width for 8
   updates each through the same kernels;
7. time each kernel and its twin with CUDA events at the trainers' shapes
   (the GRU scan and the closure returns also at VDN's), and torch.nn.GRU
   (cuDNN) beside the GRU scan as a yardstick;
8. print the kernel table as one JSON line;
9. print {"ok": true, "device": {...}} as the last line.

It exits non-zero, printing no result, where no GPU is visible or where the
port's package is not beside it. What it builds and writes goes under build/.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

# the card's published peaks used for the bounds (H100 SXM data sheet)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

TRAIN_STEPS = 200_000
BREAKOUT_STEPS = 500_000
ASTERIX_STEPS = 500_000
SEAQUEST_STEPS = 500_000
SHORT_STEPS = 16 * 32 * 128  # 16 updates of Freeway and of SpaceInvaders
MEMORY_STEPS = 100_000  # pqn_rnn_memory_chain.yaml's TOTAL_TIMESTEPS: 24 updates
VDN_SPREAD_STEPS = 1_000_000  # pqn_vdn_spread.yaml's TOTAL_TIMESTEPS: 312 updates
# tests/test_pqn_vdn.py::test_vdn_learns_spread: the last tenth of updates'
# mean returned_episode_returns above the first tenth's by more than this
VDN_SPREAD_GATE = 3.0
# the other VDN configs, 8 updates each at full width
VDN_SHORT = ("pqn_vdn_smax", "pqn_vdn_kitchen", "pqn_vdn_hanabi")
VDN_SHORT_UPDATES = 8
RNN_CARTPOLE_STEPS = 16 * 64 * 32  # 16 updates of pqn_rnn_cartpole
PENDULUM_STEPS = 400_000  # tests/test_pqn_ac.py::test_ac_learns_pendulum's length
# the best greedy eval return the Pendulum run must beat (the same test's
# gate; random play is about -1300)
PENDULUM_GATE = -500.0
# the Pendulum kernel at the trainer's shape (T, B, H, max_steps), at one
# that forces resets, and at ragged groups with the W2 slices read from L2
PENDULUM_SHAPES = ((32, 64, 256, 200), (40, 16, 64, 10), (12, 100, 1024, 5))
# the CartPole kernel at ragged groups that force resets (T, B, H,
# max_steps): a lone env, warps past the last env, W2 slices in shared
# memory and read from L2
CARTPOLE_RAGGED = ((24, 1, 64, 5), (24, 37, 256, 5), (24, 130, 512, 5), (24, 37, 1024, 5))
# the MinAtar kernels on the cluster CNN at ragged clusters (T, B, H,
# max_steps); the trainer's shape is phases 3c-3d's
CLUSTER_RAGGED = (24, 37, 256, 9)
# the last-3 mean greedy eval return on MemoryChain: above MEMORY_GATE for the
# recurrent trainer, below FF_GATE for the feedforward one
# (tests/test_pqn_rnn.py::test_rnn_solves_memory_task_ff_does_not)
MEMORY_GATE, FF_GATE = 0.8, 0.5
# the GRU scan at the trainers' shapes (T = MEMORY_WINDOW + NUM_STEPS, B =
# NUM_ENVS / NUM_MINIBATCHES, H; VDN's B = agents x NUM_ENVS /
# NUM_MINIBATCHES: Spread 3 x 16, SMAX 5 x 16), then at shapes of several
# clusters and at the largest H whose W_h slice stays in shared memory (a
# cluster of 16)
GRU_SHAPES = ((132, 2, 256), (68, 2, 256), (29, 48, 256), (68, 80, 256), (32, 16, 128), (20, 40, 256),
              (9, 2, 512))
# VDN's windows, timed beside the recurrent trainer's
GRU_VDN_TIMED = ((29, 48, 256), (68, 80, 256))
# the mean of the last 10 training returns the Asterix run must beat:
# tests/test_torch_asterix.py::test_asterix_learns
ASTERIX_GATE = 0.8
# the same for Seaquest: tests/test_torch_seaquest.py::test_seaquest_learns
SEAQUEST_GATE = 0.2
# pqn_craftax's run: 2,048 updates of 1024 envs x 1 step (the YAML's 1e9 cut
# to this length). It has no learning bar: on an H100, one of four learned
# seeds of this length ends above random play, three end with the LR=0 runs
# (scripts/craftax_learning_bar.py, PERF.md sections 2 and 7)
CRAFTAX_STEPS = 2**21
# the strict Craftax program (PARITY=strict) and the bfloat16 one, shorter
CRAFTAX_STRICT_STEPS = 2**19
CRAFTAX_BF16_STEPS = 2**18
# the bfloat16 forward against the float32 one on the same weights: the
# largest |difference| over the Q-values at most this share of the largest
# |Q| (bfloat16 keeps 8 significant bits; 0.7 % measured on the CPU at H 1024
# x 4 from the init, tests/test_torch_bf16.py)
BF16_BOUND = 0.03
# this script's wall on an NVIDIA H100 80GB HBM3 at 700 W, the build and
# the VDN phase included (PERF.md section 2)
RECORDED_WALL_S = 515.5
# the epsilon-greedy kernel at the Craftax trainer's shape (E, A) and two others
EPS_GREEDY_SHAPES = ((1024, 34), (1000, 34), (512, 6))
KERNELS = (
    "lambda_returns", "cartpole_rollout", "breakout_rollout", "asterix_rollout",
    "freeway_rollout", "space_invaders_rollout", "seaquest_rollout", "gru_scan_fwd",
    "gru_scan_bwd", "pendulum_ac_rollout", "eps_greedy", "lambda_returns_closure",
)
# the sources under csrc/ (a kernel's own name but for the closure form of
# the returns, which csrc/lambda_returns.cu also serves)
SOURCES = tuple(k for k in KERNELS if k != "lambda_returns_closure")
# the returns kernel, both forms: the trainers' shapes (T, E) (CartPole (64,
# 32), MinAtar (32, 128), Pendulum (32, 64); the recurrent trainer's windows,
# MemoryChain (131, 2) and RNN CartPole (67, 2); VDN's targets, Spread (28,
# 16) and Skirmish / SMAX (67, 16)), short and ragged ones, many blocks
# through the ring, a long T of few envs
LAMBDA_SHAPES = ((64, 32), (32, 128), (32, 64), (131, 2), (67, 2), (28, 16), (67, 16), (127, 2), (63, 2),
                 (1, 7), (2, 33), (64, 200), (300, 4096), (1024, 3))
# where both forms are timed
LAMBDA_TIMED = ((64, 32), (32, 128), (131, 2), (67, 2), (28, 16), (67, 16), (127, 2), (63, 2))
# the Breakout run and check as recorded on an H100 with the kernel's first
# CNN, one block an env (PERF.md): the last-10 mean return, the last greedy
# eval, the resets with the PRNG off. The cluster CNN sums the dense layer in
# another order, so the Q-values' last bits and with them the run may
# differ: the line is informational, the learning gate is the check
BREAKOUT_RECORD = (8.29, 9.00, 531)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_abs_err(got, want) -> float:
    """The largest |got - want|, a NaN against a NaN and an infinity
    against the same infinity counting 0, any other NaN or infinity inf."""
    import torch

    same = (got == want) | (got.isnan() & want.isnan())
    diff = torch.where(same, torch.zeros_like(got), (got - want).abs())
    return diff.nan_to_num(nan=float("inf"), posinf=float("inf")).max().item()


def lambda_bound_ms(T: int, E: int):
    nbytes = 4 * (E + 3 * T * E) + 4 * T * E
    return _bound(nbytes, 10 * T * E)


def rollout_bound_ms(T: int, B: int, H: int, A: int):
    weights = 4 * (4 * H + 6 * H + H * H + A * H + A)
    nbytes = weights + 4 * 5 * B + 4 * T * B * (4 + 3 + A) + 4 * 9 * B
    # per env step: two dense layers and the head (2 flops per MAC, plus
    # biases), two LayerNorms with relu (~8 per unit), physics (~40)
    per_step = 2 * 4 * H + 2 * H * H + 2 * A * H + 2 * H + A + 16 * H + 40
    return _bound(nbytes, T * B * per_step)


def minatar_bound_ms(T: int, B: int, H: int, A: int, C: int, state_ints: int, game_ops: int):
    """A MinAtar rollout kernel's bound: C observation channels (9 C conv
    taps), ``state_ints`` int32 of game state per env (read and written),
    about ``game_ops`` operations of game rules per env step."""
    taps, flat, obs = 9 * C, 1024, 100 * C
    weights = 4 * (taps * 16 + 3 * 16 + H * flat + 3 * H + A * H + A)
    state = 4 * state_ints * B
    nbytes = weights + 2 * state + 4 * T * B * (obs + 3 + A) + 4 * B * obs
    # per env step: the conv (2 flops per MAC plus bias), the dense layer and
    # the head, two LayerNorms with relu (~8 per unit), the game
    per_step = (2 * taps + 1) * flat + 8 * flat + (2 * flat + 1) * H + 8 * H + (2 * H + 1) * A + game_ops
    return _bound(nbytes, T * B * per_step)


def gru_fwd_bound_ms(T: int, B: int, H: int):
    """Reads xi, keep, h0, W_h, b_hn once and writes y, r, z, n, c; per step
    the (B, H) x (H, 3H) product and ~30 operations of gate math per unit."""
    nbytes = 4 * (T * B * 3 * H + T * B + B * H + 3 * H * H + H + 5 * T * B * H)
    return _bound(nbytes, T * (2 * B * H * 3 * H + 30 * B * H))


def gru_bwd_bound_ms(T: int, B: int, H: int):
    """Reads keep, hprev, r, z, n, c, g_y, g_hT and W_h once and writes dxi,
    dh0, dW_h and db_hn; per step the carry's (B, 3H) x (3H, H) product, the
    dW_h term (the same size) and ~20 operations per unit."""
    nbytes = 4 * (T * B + 6 * T * B * H + B * H + 3 * H * H + T * B * 3 * H + B * H + 3 * H * H + H)
    return _bound(nbytes, T * (2 * 2 * B * H * 3 * H + 20 * B * H))


def pendulum_bound_ms(T: int, B: int, H: int):
    """Reads the three MLPs' weights and the (3, B), (1, B) state once and
    writes obs, u, greedy, value, reward, done, the final obs and state; per
    env step the actor (3 -> H -> H -> 1) and two critics (4 -> H -> H -> 1),
    2 flops per MAC plus biases, two LayerNorms with relu a network (~8 per
    unit), and ~100 operations of noise, Philox and physics."""
    weights = 4 * (3 * (7 * H + H * H + 1) + 3 * H + 2 * 4 * H)
    nbytes = weights + 2 * 4 * 4 * B + 4 * T * B * 8 + 4 * 3 * B
    mlp = lambda n_in: 2 * n_in * H + 2 * H * H + 2 * H + 3 * H + 1 + 16 * H  # noqa: E731
    return _bound(nbytes, T * B * (mlp(3) + 2 * mlp(4) + 100))


def eps_greedy_bound_ms(E: int, A: int):
    """Reads the (E, A) float32 Q-matrix once and writes E int64 actions; one
    compare an element and ~100 integer operations of Philox a row."""
    return _bound(4 * E * A + 8 * E, E * A + 100 * E)


def eps_edge_rows(A: int):
    """Q-rows of every kind the argmax rule decides: -0.0 against +0.0 (each
    order), NaNs of different payloads and signs (the first wins), a NaN
    after an +inf, all -inf, all NaN, and +inf tied with itself."""
    import numpy as np

    nan = lambda bits: np.array([bits], np.uint32).view(np.float32)[0]  # noqa: E731
    payloads = [nan(0x7FC00000), nan(0x7F800001), nan(0xFFC00000), nan(0x7FFFFFFF)]
    rows = []
    base = -np.ones(A, np.float32)
    for order in ((0.0, -0.0), (-0.0, 0.0)):
        r = base.copy()
        r[[A // 3, A - 1]] = order
        rows.append(r)
    for i, p in enumerate(payloads):
        r = base.copy()
        r[(A // 2 + i) % A] = p
        r[(A // 2 + i + 1) % A] = payloads[(i + 1) % 4]
        rows.append(r)
    r = base.copy()
    r[0], r[A - 1] = np.inf, payloads[2]
    rows.append(r)
    rows.append(np.full(A, -np.inf, np.float32))
    rows.append(np.full(A, payloads[1], np.float32))
    r = base.copy()
    r[[A - 1, A // 2]] = np.inf
    rows.append(r)
    return np.stack(rows)


def kernel_resources(log_text: str):
    """{mangled kernel name: (registers, spill store bytes)} from nvcc's
    -Xptxas -v output."""
    import re

    out, name = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            out[name] = [None, int(m.group(1))]
        m = re.search(r"Used (\d+) registers", line)
        if m and name in out:
            out[name][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def named_instance(resources, key: str):
    """(registers, spill bytes) of the kernel whose mangled name holds key."""
    hits = [v for k, v in resources.items() if key in k]
    return hits[0] if hits else (None, None)


def gru_instance(resources, kernel: str, *template_args: int):
    """(registers, spill bytes) of one template instance of a GRU scan kernel:
    R, then the bools (slice in shared memory, slice in registers)."""
    key = f"{kernel}ILi{template_args[0]}E" + "".join(f"Lb{int(a)}E" for a in template_args[1:]) + "E"
    return named_instance(resources, key)


def craftax_bar_metric(metrics):
    """The metric a Craftax learning bar would read: the mean of the done-masked
    returned_episode_returns over the last 10 % of updates, counting only the
    updates in which an episode ended (a done-masked mean is 0 where none
    did), and that count."""
    n = len(metrics["returned_episode_returns"])
    returns = metrics["returned_episode_returns"][n - n // 10:]
    ended = metrics["returned_episode"][n - n // 10:] > 0
    return float(returns[ended].mean()), int(ended.sum())


def pendulum_inputs(B: int, H: int, seed: int, dev):
    """The kernel's weights from a seeded actor and two-critic ensemble, and
    states with theta in [-pi, pi), theta_dot in [-8, 8] and times in [0, 200)."""
    import numpy as np
    import torch

    from purejaxql_torch.models.actor_critic import Actor, CriticEnsemble
    from purejaxql_torch.ops.pendulum_rollout import pendulum_ac_weights

    gen = torch.Generator().manual_seed(seed)
    actor = Actor(3, 1, 2.0, 0.0, [H, H], generator=gen).to(dev)
    critics = CriticEnsemble(2, 3, 1, [H, H], generator=gen).to(dev)
    r = np.random.RandomState(seed)
    stf = np.stack([r.uniform(-np.pi, np.pi, B), r.uniform(-8, 8, B), np.zeros(B)]).astype(np.float32)
    sti = r.randint(0, 200, (1, B)).astype(np.int32)
    return pendulum_ac_weights(actor, critics), torch.tensor(stf, device=dev), torch.tensor(sti, device=dev)


def gru_inputs(T: int, B: int, H: int, seed: int, dev):
    """The GRU scan's inputs from numpy: xi ~ N(0, 1), keep with about 20 %
    resets, h0 ~ N(0, 0.25), an orthogonal W_h (the init's scale), b_hn ~
    N(0, 0.01), and random cotangents g_y, g_hT."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    q, _ = np.linalg.qr(rng.randn(3 * H, 3 * H))
    arrays = (
        rng.randn(T, B, 3 * H), rng.rand(T, B, 1) > 0.2, 0.5 * rng.randn(B, H),
        q[:H], 0.1 * rng.randn(H), rng.randn(T, B, H), rng.randn(B, H),
    )
    return [torch.tensor(np.asarray(a, np.float32), device=dev) for a in arrays]


# per game: (channels, state ints per env, game operations per env step):
# Breakout's (8, B) matrix and brick map, Asterix's (48, B), Freeway's
# (32, B), SpaceInvaders' (16, B) and three maps, Seaquest's (128, B);
# SpaceInvaders' rules touch every cell a few times, the others' a few slots
# or lanes. Seaquest's, counted from csrc/seaquest_rollout.cu: its 1,000
# plane cells written once and its 28 pool entities added onto them with a
# clamp (~1,100), the rules over the five pools (hits 12 x 4 pairs ~400,
# moves, shots, spawns, collisions ~500): about 2,000
GAME_SHAPES = {
    "breakout_rollout": (4, 8 + 100, 50),
    "asterix_rollout": (4, 48, 100),
    "freeway_rollout": (7, 32, 100),
    "space_invaders_rollout": (6, 16 + 300, 1000),
    "seaquest_rollout": (10, 128, 2000),
}


def train(cli, compose, alg: str, steps: int, save_path: str, counters, extra=(),
          policy=("FUSED_ROLLOUT", "EVAL_EARLY_EXIT")):
    """One full-width run through the CLI's entry point, with every launch
    counter zeroed just before it and read just after it; the flags in
    ``policy`` must have been turned on by the config's cuda policy (a flag
    name for True, or a (flag, value) pair). Returns (outputs, seconds,
    launches by kernel)."""
    import torch

    jsonl = os.path.join(save_path, "train.jsonl")
    if os.path.exists(jsonl):
        os.remove(jsonl)
    config = compose(
        alg=alg,
        overrides=[
            f"TOTAL_TIMESTEPS={steps}", f"TOTAL_TIMESTEPS_DECAY={steps}",
            f"SAVE_PATH={save_path}", f"LOG_JSONL={jsonl}", *extra,
        ],
    )
    expected = [flag if isinstance(flag, tuple) else (flag, True) for flag in policy]
    check(all(config.get(k) == v and type(config.get(k)) is type(v) for k, v in expected),
          f"{alg}: the cuda policy did not turn on {policy}")
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = cli.single_run(config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return outs, wall, {name: fn.launches for name, fn in counters.items()}


def check_run(name, outs, wall, launches, n_updates, steps_per_update, rollout, gate):
    """The checks every training run shares: one lambda-returns launch per
    update, the game's rollout kernel more than once per update (the eval
    chunks) and no other rollout kernel, the env-step count, finite metrics
    and, where ``gate`` is given, learning. Returns (mean of the last 10
    returned_episode_returns, last greedy eval return)."""
    import numpy as np

    train_state = outs["runner_state"][0]
    m = {k: v.cpu().numpy() for k, v in outs["metrics"].items()}
    last10 = float(m["returned_episode_returns"][-10:].mean())
    last_eval = float(m["test/returned_episode_returns"][-1])
    print(
        f"train {name}: {train_state.timesteps} env steps in {wall:.2f} s wall "
        f"({train_state.timesteps / wall:.0f} env-steps/s, eval included); launches {launches}; "
        f"mean of last 10 returned_episode_returns {last10:.2f}; "
        f"last greedy eval return {last_eval:.2f}"
    )
    check(all(p.device.type == "cuda" for p in train_state.network.parameters()), f"{name}: a parameter is not on cuda")
    check(launches["lambda_returns"] == n_updates,
          f"{name}: lambda_returns launched {launches['lambda_returns']} times, expected {n_updates}")
    check(launches[rollout] > n_updates, f"{name}: {rollout} launched {launches[rollout]} times: no eval chunks")
    others = {k: v for k, v in launches.items() if k not in ("lambda_returns", rollout) and v}
    check(not others, f"{name}: another game's kernel launched: {others}")
    check(train_state.timesteps == n_updates * steps_per_update, f"{name}: wrong env-step count")
    check(all(np.isfinite(m[k]).all() for k in ("td_loss", "qvals", "returned_episode_returns")),
          f"{name}: non-finite metrics")
    check(np.isfinite(last_eval), f"{name}: the last greedy eval finished no episode")
    if gate is not None:
        check(last10 > gate, f"{name} did not learn: mean of last 10 returned_episode_returns {last10} <= {gate}")
    return last10, last_eval


def asterix_states(B: int, seed: int):
    """Asterix states that meet every rule: half at an episode's start, half
    on random boards (entities in any slot, timers about to fire, ramps due
    at both parities, times near the limit), a quarter of those with enemies
    next to the player on its row and the rows above and below."""
    import numpy as np
    import torch

    from purejaxql_torch.envs.minatar.asterix import AsterixParams, AsterixState, start_state
    from purejaxql_torch.ops.asterix_rollout import state_matrix_from_asterix

    r = np.random.RandomState(seed)
    n = B - B // 2
    cols = {
        "player_x": r.randint(0, 10, n), "player_y": r.randint(1, 9, n),
        "e_exists": r.rand(n, 8) < 0.5, "e_x": r.randint(0, 10, (n, 8)),
        "e_lr": r.rand(n, 8) < 0.5, "e_gold": r.rand(n, 8) < 0.3,
        "spawn_speed": r.randint(1, 11, n), "spawn_timer": r.randint(0, 3, n),
        "move_speed": r.randint(1, 6, n), "move_timer": r.randint(0, 3, n),
        "ramp_timer": r.choice([0, 1, 50], n), "ramp_index": r.randint(0, 6, n),
        "terminal": np.zeros(n, bool), "time": r.randint(0, 1000, n),
    }
    q = n // 4
    cols["player_x"][:q], cols["player_y"][:q], cols["move_timer"][:q] = 5, 5, 0
    for slot in (3, 4, 5):
        cols["e_exists"][:q, slot], cols["e_gold"][:q, slot] = True, False
        cols["e_lr"][:q, slot] = np.arange(q) % 2 == 0
        cols["e_x"][:q, slot] = np.where(cols["e_lr"][:q, slot], 4, 6)
    rand = AsterixState(**{k: torch.tensor(v if v.dtype == bool else v.astype(np.int32)) for k, v in cols.items()})
    st = torch.cat([state_matrix_from_asterix(start_state(B // 2, AsterixParams(), "cpu")),
                    state_matrix_from_asterix(rand)], 1)
    return (st.contiguous(),)


def freeway_states(B: int, seed: int):
    """Freeway states that meet every rule: half at an episode's start, half
    on random roads (the chicken anywhere, cooldowns running, timers about
    to fire, both directions), a quarter of those 0-31 steps before the
    2500-step limit."""
    import numpy as np
    import torch

    from purejaxql_torch.envs.minatar.freeway import FreewayDraws, FreewayState, start_state
    from purejaxql_torch.ops.freeway_rollout import state_matrix_from_freeway

    r = np.random.RandomState(seed)
    h, n = B // 2, B - B // 2
    i32 = lambda a: torch.tensor(np.asarray(a, np.int32))  # noqa: E731
    starts = start_state(i32(r.randint(0, 10, (h, 8))), FreewayDraws(
        i32(r.randint(1, 6, (h, 8))), i32(r.choice([-1, 1], (h, 8)))))
    time = r.randint(0, 2400, n)
    time[: n // 4] = 2499 - np.arange(n // 4) % 32
    rand = FreewayState(
        pos=i32(r.randint(0, 10, n)), car_x=i32(r.randint(0, 10, (n, 8))),
        car_timer=i32(r.randint(0, 4, (n, 8))),
        car_speed=i32(r.randint(1, 6, (n, 8)) * r.choice([-1, 1], (n, 8))),
        move_timer=i32(r.randint(0, 4, n)), terminal=torch.zeros(n, dtype=torch.bool), time=i32(time),
    )
    st = torch.cat([state_matrix_from_freeway(starts), state_matrix_from_freeway(rand)], 1)
    return (st.contiguous(),)


def space_invaders_states(B: int, seed: int):
    """SpaceInvaders states that meet every rule: half at an episode's
    start, half on random boards (thinned waves anywhere, at the walls and on
    the bottom row, bullets in flight both ways, timers about to fire), a
    quarter of those with a row of enemy bullets over the cannon's row."""
    import numpy as np
    import torch

    from purejaxql_torch.envs.minatar.space_invaders import (
        SpaceInvadersParams,
        SpaceInvadersState,
        start_state,
    )
    from purejaxql_torch.ops.space_invaders_rollout import state_matrix_from_space_invaders

    r = np.random.RandomState(seed)
    n = B - B // 2
    alien = np.zeros((n, 10, 10), np.int32)
    for i in range(n):
        top, left = r.randint(0, 7), r.randint(0, 5)
        alien[i, top : top + 4, left : left + 6] = r.rand(4, 6) < 0.6
    ebul = (r.rand(n, 10, 10) < 0.05).astype(np.int32)
    ebul[: n // 4, 8, :] = 1
    i32 = lambda a: torch.tensor(np.asarray(a, np.int32))  # noqa: E731
    rand = SpaceInvadersState(
        pos=i32(r.randint(0, 10, n)), f_bullet_map=i32(r.rand(n, 10, 10) < 0.05), e_bullet_map=i32(ebul),
        alien_map=i32(alien), alien_dir=i32(r.choice([-1, 1], n)),
        enemy_move_interval=i32(r.randint(6, 13, n)), alien_move_timer=i32(r.randint(0, 3, n)),
        alien_shot_timer=i32(r.randint(0, 3, n)), ramp_index=i32(r.randint(0, 4, n)),
        shot_timer=i32(r.randint(0, 3, n)), terminal=torch.zeros(n, dtype=torch.bool),
        time=i32(r.randint(0, 1000, n)),
    )
    a = state_matrix_from_space_invaders(start_state(B // 2, SpaceInvadersParams(), "cpu"))
    b = state_matrix_from_space_invaders(rand)
    return tuple(torch.cat([x, y], -1).contiguous() for x, y in zip(a, b))


def seaquest_states(B: int, seed: int):
    """Seaquest states that meet every rule: half at an episode's start,
    half on random boards (the sub anywhere, either way round, oxygen from
    empty to full, 0-6 divers on board, every pool thinly filled with its
    timers about to fire, subs about to shoot, spawns and surfacing due,
    times near the limit)."""
    import numpy as np
    import torch

    from purejaxql_torch.envs.minatar.seaquest import SeaquestParams, SeaquestState, start_state
    from purejaxql_torch.ops.seaquest_rollout import state_matrix_from_seaquest

    r = np.random.RandomState(seed)
    n = B - B // 2
    cols = {
        "sub_x": r.randint(0, 10, n), "sub_y": r.choice([0, 0, 1, 2, 4, 8], n), "sub_or": r.randint(0, 2, n),
        "oxygen": r.choice([0, 1, 2, 57, 199, 200], n), "divers": r.randint(0, 7, n),
        "shot_timer": r.randint(0, 3, n), "spawn_timer": r.randint(0, 3, n),
        "diver_spawn_timer": r.randint(0, 3, n), "move_interval": r.randint(1, 6, n),
        "surfaced": r.rand(n) < 0.5, "terminal": np.zeros(n, bool), "time": r.randint(0, 1000, n),
    }
    for p, k in (("f", 8), ("s", 4), ("fb", 4), ("eb", 4), ("d", 4)):
        cols[f"{p}_exists"] = r.rand(n, k) < 0.4
        cols[f"{p}_x"] = r.randint(0, 10, (n, k))
        cols[f"{p}_y"] = r.randint(0, 9, (n, k)) if p in ("fb", "eb") else r.randint(1, 9, (n, k))
        cols[f"{p}_dir"] = r.choice([-1, 1], (n, k))
        if p in ("f", "s", "d"):
            cols[f"{p}_timer"] = r.randint(0, 3, (n, k))
    cols["s_shot_timer"] = r.randint(0, 4, (n, 4))
    rand = SeaquestState(**{k: torch.tensor(v if v.dtype == bool else v.astype(np.int32)) for k, v in cols.items()})
    st = torch.cat([state_matrix_from_seaquest(start_state(B // 2, SeaquestParams(), "cpu")),
                    state_matrix_from_seaquest(rand)], 1)
    return (st.contiguous(),)


def compare_minatar(name, kernel, plain, weights, states, T, use_prng, seed=77, eps=0.1, **kw):
    """One kernel call against its twin on the same inputs: every output
    equal but Q, within 1e-4. Returns (max |Q error|, resets, reward sum,
    non-greedy actions, rewards that are not whole: Seaquest's cash-ins)."""
    import torch

    got = kernel(seed, eps, weights, *states, T, use_prng=use_prng, **kw)
    want = plain(seed, eps, weights, *states, T, use_prng=use_prng, **kw)
    torch.cuda.synchronize()
    mism = (got[1] != want[1]).nonzero()
    if len(mism):
        t, b = mism[0].tolist()
        top2 = want[4][t, b].topk(2).values
        fail(
            f"{name} prng={use_prng}: action differs first at t={t} env={b}; "
            f"plain q-gap there {(top2[0] - top2[1]).item():.3g}, kernel q {got[4][t, b].tolist()} "
            f"plain q {want[4][t, b].tolist()}"
        )
    labels = ("obs", "act", "rew", "done", "q", "final_obs") + tuple(f"state{i}" for i in range(len(states)))
    for label, g, w in zip(labels, got, want):
        if label != "q":
            check(torch.equal(g, w), f"{name} prng={use_prng}: {label} differs")
    err = (got[4] - want[4]).abs().max().item()
    check(err <= 1e-4, f"{name} prng={use_prng}: q err {err} > 1e-4")
    n_done, rew = int(want[3].sum()), float(want[2].sum())
    n_random = int((want[1].long() != want[4].argmax(-1)).sum())
    return err, n_done, rew, n_random, int((want[2] != want[2].floor()).sum())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs one GPU")
    try:
        from purejaxql_torch import cli
        from purejaxql_torch.core.checkpoint import load_params
        from purejaxql_torch.core.config import compose
        from purejaxql_torch.envs import wrappers
        from purejaxql_torch.envs.classic.pendulum import PendulumParams
        from purejaxql_torch.envs.minatar.breakout import start_state
        from purejaxql_torch.models.cnn import CNNQNetwork
        from purejaxql_torch.models.qnet import QNetwork
        from purejaxql_torch.ops import asterix_rollout as ar
        from purejaxql_torch.ops import breakout_rollout as br
        from purejaxql_torch.ops import build
        from purejaxql_torch.ops import cartpole_rollout as cr
        from purejaxql_torch.ops import eps_greedy as eg
        from purejaxql_torch.ops import freeway_rollout as fr
        from purejaxql_torch.ops import gru_scan as gs
        from purejaxql_torch.ops import lambda_returns as lr
        from purejaxql_torch.ops import minatar_rollout
        from purejaxql_torch.ops import pendulum_rollout as pr
        from purejaxql_torch.ops import seaquest_rollout as sq
        from purejaxql_torch.ops import space_invaders_rollout as sr
        from purejaxql_torch.ops.minatar_rollout import minatar_weights
    except ImportError as e:
        fail(f"cannot import purejaxql_torch ({e}): run from the root of a checkout")
    import numpy as np

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = os.path.dirname(os.path.abspath(__file__))
    counters = {
        "lambda_returns": lr.lambda_returns,
        "lambda_returns_closure": lr.lambda_returns_closure,
        "cartpole_rollout": cr.cartpole_rollout,
        "breakout_rollout": br.breakout_rollout,
        "asterix_rollout": ar.asterix_rollout,
        "freeway_rollout": fr.freeway_rollout,
        "space_invaders_rollout": sr.space_invaders_rollout,
        "seaquest_rollout": sq.seaquest_rollout,
        "gru_scan_fwd": gs.gru_scan_fwd,
        "gru_scan_bwd": gs.gru_scan_bwd,
        "pendulum_ac_rollout": pr.pendulum_ac_rollout,
        "eps_greedy": eg.eps_greedy,
    }

    # ---- 1. the card -------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip()
    print(card)
    nvcc_version = subprocess.run(
        [build.nvcc_path(), "--version"], capture_output=True, text=True, timeout=60
    ).stdout.strip().splitlines()[-1]
    print(
        f"torch {torch.__version__} cuda {torch.version.cuda} nvcc: {nvcc_version} "
        f"device: {torch.cuda.get_device_name(0)} count: {torch.cuda.device_count()}"
    )

    # ---- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    try:
        per_source = build.build(SOURCES)
    except RuntimeError as e:
        fail(f"build failed: {e}")
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s wall, per source {json.dumps(per_source)}")
    for name in SOURCES:
        log = build.library_path(name).with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")

    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(0)
    errors = {}

    # ---- 3a. lambda returns, both forms, vs plain ------------------------------
    lam_inputs = {}
    lam_forms = {
        "lambda_returns": (lr.lambda_returns, lr.lambda_returns_plain),
        "lambda_returns_closure": (lr.lambda_returns_closure, lr.lambda_returns_closure_plain),
    }
    for T, E in LAMBDA_SHAPES:
        rew = rng.randn(T, E).astype(np.float32)
        done = (rng.rand(T, E) < 0.15).astype(np.float32)
        maxq = rng.randn(T, E).astype(np.float32)
        lastq = rng.randn(E).astype(np.float32)
        lam_inputs[(T, E)] = [torch.tensor(a, device=dev) for a in (lastq, rew, done, maxq)]
        # a NaN, +inf and -inf in a row of max_qs, +inf and -inf in one of rewards
        maxq[T // 2, : min(E, 3)] = [np.nan, np.inf, -np.inf][: min(E, 3)]
        rew[T // 3, -min(E, 2):] = [np.inf, -np.inf][: min(E, 2)]
        nonfinite = [torch.tensor(a, device=dev) for a in (lastq, rew, done, maxq)]
        for name, (kernel, plain) in lam_forms.items():
            err, err_nonfinite = (max_abs_err(kernel(*args, 0.99, 0.95), plain(*args, 0.99, 0.95))
                                  for args in (lam_inputs[(T, E)], nonfinite))
            print(f"{name} ({T},{E}): max|kernel - plain| = {err:.3g}, with NaN and inf rows "
                  f"{err_nonfinite:.3g} (tolerance 1e-5)")
            check(max(err, err_nonfinite) <= 1e-5,
                  f"{name} disagrees with its plain twin at ({T},{E}): {err}, with NaN and inf rows {err_nonfinite}")
            errors[name] = max(errors.get(name, 0.0), err, err_nonfinite)
    for T, E in LAMBDA_SHAPES:
        plan = lr.lambda_plan(T, E)
        print(f"lambda_plan({T}, {E}): tile {plan.tile}, {plan.blocks} blocks, chunk {plan.chunk}, "
              f"{plan.stages} stages, {plan.smem_bytes} B")

    # ---- 3b. CartPole rollout vs plain, PRNG off and on --------------------------
    H, A = 256, 2
    gen = torch.Generator().manual_seed(0)
    net = QNetwork(4, A, hidden_size=H, num_layers=2, generator=gen).to(dev)
    weights = cr.cartpole_weights(net)

    def reset_states(B, seed):
        g = torch.Generator().manual_seed(seed)
        stf = (torch.rand(4, B, generator=g) * 0.1 - 0.05).to(dev)
        return stf.contiguous(), torch.zeros(1, B, dtype=torch.int32, device=dev)

    names = ("obs", "act", "rew", "done", "q", "final_obs", "stf", "sti")
    roll_err = 0.0
    for B in (32, 128):
        stf0, sti0 = reset_states(B, B)
        for use_prng in (False, True):
            got = cr.cartpole_rollout(1234, 0.1, weights, stf0, sti0, 64, use_prng=use_prng)
            want = cr.cartpole_rollout_plain(1234, 0.1, weights, stf0, sti0, 64, use_prng=use_prng)
            torch.cuda.synchronize()
            g, w = dict(zip(names, got)), dict(zip(names, want))
            mism = (g["act"] != w["act"]).nonzero()
            if len(mism):
                t, b = mism[0].tolist()
                gap = (w["q"][t, b, 0] - w["q"][t, b, 1]).abs().item()
                fail(
                    f"rollout B={B} prng={use_prng}: action differs first at t={t} env={b}; "
                    f"plain q-gap there {gap:.3g}, kernel q {g['q'][t, b].tolist()} plain q {w['q'][t, b].tolist()}"
                )
            for k in ("rew", "done", "sti"):
                check(torch.equal(g[k], w[k]), f"rollout B={B} prng={use_prng}: {k} differs")
            errs = {k: (g[k] - w[k]).abs().max().item() for k in ("obs", "final_obs", "stf", "q")}
            print(f"cartpole_rollout B={B} T=64 prng={use_prng}: actions/rewards/dones equal, max|err| {errs}")
            for k in ("obs", "final_obs", "stf"):
                check(errs[k] <= 1e-5, f"rollout B={B} prng={use_prng}: {k} err {errs[k]} > 1e-5")
            check(errs["q"] <= 1e-4, f"rollout B={B} prng={use_prng}: q err {errs['q']} > 1e-4")
            if B == 32:
                roll_err = max(roll_err, max(errs.values()))
    # each plan (the trainer's two shapes and the ragged ones) with its
    # registers, spills and the clusters the card places at once; the ragged
    # shapes reset every env, PRNG off and on
    cp_resources = kernel_resources(build.library_path("cartpole_rollout").with_suffix(".log").read_text())
    for cT, cB, cH, c_max in ((64, 32, H, 500), (64, 128, H, 500), *CARTPOLE_RAGGED):
        plan = cr.cartpole_plan(cB, cH)
        # the template instance it launches: <resident, G, a lane's units (8 at H 256, else 0)>
        nu = 8 if plan.resident and cH == 256 else 0
        c_res = named_instance(cp_resources, f"cartpole_rollout_kernelILb{int(plan.resident)}ELi{plan.group}ELi{nu}E")
        placed = cr.active_clusters(plan, cH)
        print(f"cartpole_rollout (B, H) = {(cB, cH)}: plan C {plan.cluster}, G {plan.group}, {plan.clusters} "
              f"cluster(s), {plan.units} units a CTA, W2 slice resident {plan.resident}, shared bytes "
              f"{plan.smem_bytes}, {placed} clusters placed at once; registers / spill bytes {c_res[0]} / {c_res[1]}")
        check(c_res[0] is not None, f"cartpole_rollout: no register count for the plan at {(cB, cH)}")
        if c_max == 500:
            check(placed >= plan.clusters, f"cartpole_rollout: the card places {placed} of {plan.clusters} clusters")
            continue
        rnet = QNetwork(4, A, hidden_size=cH, num_layers=2, generator=torch.Generator().manual_seed(cB + cH)).to(dev)
        r = np.random.RandomState(cB)
        stf0 = r.uniform(-0.05, 0.05, (4, cB)).astype(np.float32)
        stf0[:, : cB // 4] *= 40  # some envs start near or past the bounds
        stf0 = torch.tensor(stf0, device=dev)
        sti0 = torch.tensor(r.randint(0, 3, (1, cB)).astype(np.int32), device=dev)
        for use_prng in (False, True):
            got = cr.cartpole_rollout(55, 0.2, cr.cartpole_weights(rnet), stf0, sti0, cT, use_prng=use_prng,
                                      max_steps=c_max)
            want = cr.cartpole_rollout_plain(55, 0.2, cr.cartpole_weights(rnet), stf0, sti0, cT,
                                             use_prng=use_prng, max_steps=c_max)
            torch.cuda.synchronize()
            g, w = dict(zip(names, got)), dict(zip(names, want))
            for k in ("act", "rew", "done", "sti"):
                check(torch.equal(g[k], w[k]), f"cartpole_rollout {(cT, cB, cH)} prng={use_prng}: {k} differs")
            errs = {k: (g[k] - w[k]).abs().max().item() for k in ("obs", "final_obs", "stf", "q")}
            n_done = int(w["done"].sum())
            print(f"cartpole_rollout T={cT} B={cB} H={cH} max_steps={c_max} prng={use_prng}: actions/rewards/"
                  f"dones/time equal ({n_done} resets), max|err| {errs}")
            check(max(errs[k] for k in ("obs", "final_obs", "stf")) <= 1e-5 and errs["q"] <= 1e-4,
                  f"cartpole_rollout {(cT, cB, cH)} prng={use_prng}: {errs} over 1e-5 / 1e-4")
            check(n_done >= 4 * cB, "cartpole_rollout: fewer resets than the time limit forces")
    # a head bias of [0, NaN]: every Q-row holds a NaN at index 1, which
    # torch.argmax and jnp.argmax take as the maximum
    stf0, sti0 = reset_states(37, 37)
    nan_weights = weights[:9] + (torch.tensor([0.0, float("nan")], device=dev),)
    got = cr.cartpole_rollout(9, 0.0, nan_weights, stf0, sti0, 8, use_prng=False)
    want = cr.cartpole_rollout_plain(9, 0.0, nan_weights, stf0, sti0, 8, use_prng=False)
    torch.cuda.synchronize()
    check(bool((got[1] == 1).all()) and all(torch.equal(got[i], want[i]) for i in (1, 2, 3, 7))
          and bool(got[4][..., 1].isnan().all()), "cartpole_rollout: a NaN Q-value did not take the greedy action")
    print("cartpole_rollout with a NaN in every Q-row at index 1: action 1 on every env and step, as the twin")
    errors["cartpole_rollout"] = roll_err

    # ---- 3c. Breakout rollout vs plain, PRNG off and on ------------------------
    BB, BT, BH, BA = 128, 32, 128, 3
    bnet = CNNQNetwork((10, 10, 4), BA, hidden_size=BH, generator=torch.Generator().manual_seed(1)).to(dev)
    bweights = minatar_weights(bnet)

    def breakout_states(B, seed):
        """Half the envs at an episode's start, half on random boards (any
        ball position above the paddle row, direction and time, thinned
        walls, strike latches, a quarter of them one brick from a respawn),
        so that the comparison meets every rule of the step."""
        r = np.random.RandomState(seed)
        st, brick = br.state_matrix_from_breakout(start_state(torch.tensor(r.randint(0, 2, B), dtype=torch.int32)))
        n = B - B // 2
        by, bx, d = r.randint(0, 9, n), r.randint(0, 10, n), r.randint(0, 4, n)
        ly = np.clip(by - np.array([-1, -1, 1, 1])[d], 0, 9)
        lx = np.clip(bx - np.array([-1, 1, 1, -1])[d], 0, 9)
        rows = [by, bx, d, r.randint(0, 10, n), r.randint(0, 2, n), ly, lx, r.randint(0, 1000, n)]
        st[:, B // 2:] = torch.tensor(np.stack(rows), dtype=torch.int32)
        walls = (r.rand(10, 10, n) < 0.6) & (np.arange(10) >= 1)[:, None, None] & (np.arange(10) <= 3)[:, None, None]
        walls[:, :, : n // 4] = False
        walls[2, 5, : n // 4] = True
        brick[:, :, B // 2:] = torch.tensor(walls, dtype=torch.int32)
        return st.to(dev).contiguous(), brick.to(dev).contiguous()

    st0, brick0 = breakout_states(BB, 3)
    q_err = 0.0
    breakout_resets = {}
    for use_prng in (False, True):
        err, n_done, n_rew, n_random, _ = compare_minatar(
            "breakout_rollout", br.breakout_rollout, br.breakout_rollout_plain, bweights, (st0, brick0), BT, use_prng
        )
        breakout_resets[use_prng] = n_done
        print(
            f"breakout_rollout B={BB} T={BT} prng={use_prng}: obs/actions/rewards/dones/state/bricks equal "
            f"({n_done} resets, {n_rew:.0f} bricks scored, {n_random} non-greedy actions), "
            f"max|q err| {err:.3g} (tolerance 1e-4)"
        )
        check(n_done > 0, "breakout_rollout: no env reset in the comparison")
        q_err = max(q_err, err)
    errors["breakout_rollout"] = q_err

    # ---- 3d. Asterix, Freeway, SpaceInvaders and Seaquest rollouts vs plain, PRNG off and on --
    games = {  # kernel, twin, states, channels, actions, what a reward is
        "asterix_rollout": (ar.asterix_rollout, ar.asterix_rollout_plain, asterix_states, 4, 5, "gold"),
        "freeway_rollout": (fr.freeway_rollout, fr.freeway_rollout_plain, freeway_states, 7, 3, "crossings"),
        "space_invaders_rollout": (
            sr.space_invaders_rollout, sr.space_invaders_rollout_plain, space_invaders_states, 6, 4, "kills",
        ),
        "seaquest_rollout": (sq.seaquest_rollout, sq.seaquest_rollout_plain, seaquest_states, 10, 6, "kills and cash-ins"),
    }
    game_inputs = {}
    for i, (name, (kernel, plain, make_states, gC, gA, scores)) in enumerate(games.items()):
        net = CNNQNetwork((10, 10, gC), gA, hidden_size=BH, generator=torch.Generator().manual_seed(2 + i)).to(dev)
        gweights = minatar_weights(net)
        gstates = tuple(x.to(dev) for x in make_states(BB, 3 + i))
        game_inputs[name] = (gweights, gstates)
        q_err = 0.0
        for use_prng in (False, True):
            err, n_done, rew, n_random, _ = compare_minatar(name, kernel, plain, gweights, gstates, BT, use_prng)
            print(
                f"{name} B={BB} T={BT} prng={use_prng}: obs/actions/rewards/dones/state equal "
                f"({n_done} resets, {rew:.0f} {scores}, {n_random} non-greedy actions), "
                f"max|q err| {err:.3g} (tolerance 1e-4)"
            )
            check(n_done > 0, f"{name}: no env reset in the comparison")
            check(rew > 0 or name == "freeway_rollout", f"{name}: nothing scored in the comparison")
            q_err = max(q_err, err)
        errors[name] = q_err
    # Seaquest at a small shape whose time limit resets every env four times
    sq_small = tuple(x.to(dev) for x in seaquest_states(16, 11))
    for use_prng in (False, True):
        err, n_done, rew, n_random, _ = compare_minatar(
            "seaquest_rollout", sq.seaquest_rollout, sq.seaquest_rollout_plain, game_inputs["seaquest_rollout"][0],
            sq_small, 40, use_prng, max_steps=9,
        )
        print(
            f"seaquest_rollout B=16 T=40 max_steps=9 prng={use_prng}: obs/actions/rewards/dones/state equal "
            f"({n_done} resets, {rew:.1f} reward, {n_random} non-greedy actions), max|q err| {err:.3g} "
            f"(tolerance 1e-4)"
        )
        check(n_done >= 4 * 16, "seaquest_rollout: fewer resets than the time limit forces")
        errors["seaquest_rollout"] = max(errors["seaquest_rollout"], err)
    # Seaquest's cash-ins: the trainer-shape states with six divers on board,
    # one row under the surface and not surfaced, oxygen 1-128; random actions
    # (eps 1) take about a sixth of the envs up, to a reward of kills +
    # oxygen * 0.1f
    cash = sq.seaquest_from_state_matrix(game_inputs["seaquest_rollout"][1][0].cpu())
    cash.divers[:], cash.sub_y[:] = 6, 1
    cash.oxygen[:] = torch.arange(BB) % 199 + 1  # mostly not a multiple of 10: a reward that is not whole
    cash.surfaced, cash.terminal = torch.zeros_like(cash.surfaced), torch.zeros_like(cash.terminal)
    err, n_done, rew, n_random, n_cash = compare_minatar(
        "seaquest_rollout", sq.seaquest_rollout, sq.seaquest_rollout_plain, game_inputs["seaquest_rollout"][0],
        (sq.state_matrix_from_seaquest(cash).to(dev),), 2, True, eps=1.0,
    )
    print(f"seaquest_rollout B={BB} T=2 six divers under the surface: obs/actions/rewards/dones/state equal "
          f"({n_cash} cash-ins, {rew:.1f} reward), max|q err| {err:.3g} (tolerance 1e-4)")
    check(n_cash > 0, "seaquest_rollout: no cash-in in the cash-in check")
    errors["seaquest_rollout"] = max(errors["seaquest_rollout"], err)

    # the kernels on the cluster CNN (all five MinAtar games): each plan with
    # its registers and spills and the clusters the card places at once, and
    # a ragged shape (clusters with CTAs past the last env, H 256) that
    # resets every env
    games["breakout_rollout"] = (br.breakout_rollout, br.breakout_rollout_plain, breakout_states, 4, BA, "bricks")
    game_inputs["breakout_rollout"] = (bweights, (st0, brick0))
    rT, rB, rH, r_max = CLUSTER_RAGGED
    for i, (name, plan_fn) in enumerate((
        ("asterix_rollout", ar.asterix_plan), ("freeway_rollout", fr.freeway_plan),
        ("seaquest_rollout", sq.seaquest_plan), ("breakout_rollout", br.breakout_plan),
        ("space_invaders_rollout", sr.space_invaders_plan),
    )):
        kernel, plain, make_states, gC, gA, _ = games[name]
        resources = kernel_resources(build.library_path(name).with_suffix(".log").read_text())
        for plan_shape in ((BB, BH), (rB, rH)):
            plan = plan_fn(*plan_shape)
            # the template instance it launches: <C>
            regs, spill = named_instance(resources, f"{name}_kernelILi{plan.cluster}E")
            print(f"{name} (B, H) = {plan_shape}: plan C {plan.cluster}, {plan.clusters} cluster(s), "
                  f"{plan.columns} dense columns a CTA (the weight on chip), {plan.chunks} chunks, {plan.threads} "
                  f"threads, shared bytes {plan.smem_bytes}, {minatar_rollout.active_clusters(name, plan)} "
                  f"clusters placed at once; registers / spill bytes {regs} / {spill}")
        rnet = CNNQNetwork((10, 10, gC), gA, hidden_size=rH, generator=torch.Generator().manual_seed(21 + i)).to(dev)
        r_states = tuple(x.to(dev) for x in make_states(rB, 21 + i))
        for use_prng in (False, True):
            err, n_done, rew, n_random, _ = compare_minatar(
                name, kernel, plain, minatar_weights(rnet), r_states, rT, use_prng, max_steps=r_max,
            )
            print(f"{name} B={rB} T={rT} H={rH} max_steps={r_max} prng={use_prng}: obs/actions/rewards/dones/"
                  f"state equal ({n_done} resets, {rew:.1f} reward, {n_random} non-greedy actions), max|q err| "
                  f"{err:.3g} (tolerance 1e-4)")
            check(n_done >= 2 * rB, f"{name}: fewer resets than the time limit forces")
            errors[name] = max(errors[name], err)
        # a NaN head bias on action 2 at eps 0: every Q-row holds a NaN there,
        # which torch.argmax and jnp.argmax take as the maximum
        nweights, nstates = game_inputs[name]
        bias = nweights[9].clone()
        bias[2] = float("nan")
        nweights = tuple(nweights[:9]) + (bias,)
        got = kernel(5, 0.0, nweights, *nstates, 4, use_prng=False)
        want = plain(5, 0.0, nweights, *nstates, 4, use_prng=False)
        torch.cuda.synchronize()
        check(bool((got[1] == 2).all()) and all(torch.equal(g, w) for i, (g, w) in enumerate(zip(got, want)) if i != 4)
              and bool(got[4][..., 2].isnan().all()), f"{name}: a NaN Q-value did not take the greedy action")
        print(f"{name} with a NaN in every Q-row at action 2: action 2 on every env and step, every output "
              f"but Q as the twin's")

    # ---- 3e. GRU scan kernels vs plain, and autograd through them ---------------
    # forward within 1e-5; backward within 1e-4 absolute and relative: the
    # kernels sum the products in another order than the twins' matmuls
    gru_resources = {
        name: kernel_resources(build.library_path(name).with_suffix(".log").read_text())
        for name in ("gru_scan_fwd", "gru_scan_bwd")
    }
    gru_inputs_by_shape = {}
    for i, shape in enumerate(GRU_SHAPES):
        xi, keep, h0, w_h, b_hn, g_y, g_hT = gru_inputs(*shape, 10 + i, dev)
        got = gs.gru_scan_fwd(xi, keep, h0, w_h, b_hn)
        want = gs.gru_scan_fwd_plain(xi, keep, h0, w_h, b_hn)
        torch.cuda.synchronize()
        f_err = max((g - w).abs().max().item() for g, w in zip(got, want))
        hprev = torch.cat([h0[None], want[0][:-1]])
        res = (keep, hprev, w_h, *want[1:])
        got = gs.gru_scan_bwd(*res, g_y, g_hT)
        want = gs.gru_scan_bwd_plain(*res, g_y, g_hT)
        torch.cuda.synchronize()
        b_err = max((g - w).abs().max().item() for g, w in zip(got, want))
        b_rel = max(((g - w).abs() / (1e-4 + 1e-4 * w.abs())).max().item() for g, w in zip(got, want))
        plan = gs.scan_plan(*shape[1:])
        # the template instance each kernel launches: <R, slice in shared memory, in registers>
        args = (plan.rows, plan.resident and not plan.registers, plan.registers)
        f_res = gru_instance(gru_resources["gru_scan_fwd"], "gru_scan_fwd_kernel", *args)
        b_res = gru_instance(gru_resources["gru_scan_bwd"], "gru_scan_bwd_kernel", *args)
        placed = [gs.active_clusters(k, plan) for k in ("gru_scan_fwd", "gru_scan_bwd")]
        print(
            f"gru_scan (T, B, H) = {shape}: plan C {plan.cluster}, U {plan.units}, R {plan.rows}, "
            f"{plan.clusters} cluster(s), placed at once fwd {placed[0]} bwd {placed[1]} "
            f"(waves {-(-plan.clusters // placed[0])} / {-(-plan.clusters // placed[1])}), "
            f"{plan.threads} threads, W_h resident {plan.resident}, "
            f"shared bytes fwd {plan.fwd_bytes} bwd {plan.bwd_bytes}, slice in registers {plan.registers}; "
            f"registers / spill bytes fwd {f_res[0]} / {f_res[1]}, bwd {b_res[0]} / {b_res[1]}; "
            f"forward max|err| {f_err:.3g} (tolerance 1e-5); backward max|err| {b_err:.3g}, "
            f"max |err| / (1e-4 + 1e-4 |plain|) {b_rel:.3g} (must be <= 1); resets {int((keep == 0).sum())}"
        )
        check(f_err <= 1e-5, f"gru_scan_fwd disagrees with its twin at {shape}: {f_err}")
        check(b_rel <= 1.0, f"gru_scan_bwd disagrees with its twin at {shape}: {b_err}")
        errors["gru_scan_fwd"] = max(errors.get("gru_scan_fwd", 0.0), f_err)
        errors["gru_scan_bwd"] = max(errors.get("gru_scan_bwd", 0.0), b_err)
        gru_inputs_by_shape[shape] = (xi, keep, h0, w_h, b_hn, g_y, g_hT, res)
    xi, keep, h0, w_h, b_hn = gru_inputs_by_shape[GRU_SHAPES[0]][:5]
    grads = []
    for use_kernel in (True, False):
        args = [a.clone().requires_grad_(i != 1) for i, a in enumerate((xi, keep, h0, w_h, b_hn))]
        h_T, y = gs.GRUScan.apply(*args) if use_kernel else (None, gs.gru_scan_fwd_plain(*args)[0])
        h_T = y[-1] if h_T is None else h_T
        (torch.sin(y).sum() + h_T.sum()).backward()
        grads.append([a.grad for i, a in enumerate(args) if i != 1])
    a_rel = max(((g - w).abs() / (1e-4 + 1e-4 * w.abs())).max().item() for g, w in zip(*grads))
    print(f"GRUScan autograd vs autograd through the plain loop (T 132, B 2, H 256): "
          f"max |err| / (1e-4 + 1e-4 |plain|) {a_rel:.3g} (must be <= 1)")
    check(a_rel <= 1.0, f"autograd through GRUScan disagrees with the plain loop: {a_rel}")

    # ---- 3f. the Pendulum actor-critic rollout vs plain, PRNG off and on --------
    # done and time equal; every float within 1e-4 (the MLPs sum in another
    # order than the twin's matmuls, and the pendulum carries the gap along)
    pend_names = ("obs", "u", "greedy", "value", "reward", "done", "final_obs", "stf", "sti")
    pend_inputs = {}
    pend_resources = kernel_resources(build.library_path("pendulum_ac_rollout").with_suffix(".log").read_text())
    for pT, pB, pH, p_max in PENDULUM_SHAPES:
        (aw, cw), stf, sti = pendulum_inputs(pB, pH, pB, dev)
        pend_inputs[(pT, pB, pH)] = (aw, cw, stf, sti)
        plan = pr.pendulum_plan(pB, pH)
        # the template instance it launches: <resident, G, a lane's units (8 at H 256, else 0)>
        nu = 8 if plan.resident and pH == 256 else 0
        p_res = named_instance(pend_resources, f"pendulum_ac_rollout_kernelILb{int(plan.resident)}ELi{plan.group}ELi{nu}E")
        print(f"pendulum_ac_rollout (B, H) = {(pB, pH)}: plan C {plan.cluster}, G {plan.group}, {plan.clusters} "
              f"cluster(s), {plan.units} units a CTA, W2 slices resident {plan.resident}, {plan.threads} threads, "
              f"shared bytes {plan.smem_bytes}; registers / spill bytes {p_res[0]} / {p_res[1]}")
        for use_prng in (False, True):
            got = pr.pendulum_ac_rollout(11, 0.8, aw, cw, stf, sti, pT, use_prng=use_prng, max_steps=p_max)
            want = pr.pendulum_rollout_plain(11, 0.8, aw, cw, stf, sti, pT, use_prng=use_prng, max_steps=p_max)
            torch.cuda.synchronize()
            for name, g, w in zip(pend_names, got, want):
                check(g.shape == w.shape and g.dtype == w.dtype, f"pendulum_ac_rollout: {name} shape or dtype")
            for name in ("done", "sti"):
                i = pend_names.index(name)
                check(torch.equal(got[i], want[i]), f"pendulum_ac_rollout T={pT} B={pB} prng={use_prng}: {name} differs")
            errs = {n: (g - w).abs().max().item() for n, g, w in zip(pend_names, got, want) if n not in ("done", "sti")}
            resets, clipped = int(want[5].sum()), (want[1].abs() == 2).float().mean().item()
            print(f"pendulum_ac_rollout T={pT} B={pB} H={pH} max_steps={p_max} prng={use_prng}: done/time equal "
                  f"({resets} resets, {100 * clipped:.1f} % of actions clipped), max|err| "
                  f"{ {k: float(f'{v:.3g}') for k, v in errs.items()} } (tolerance 1e-4)")
            check(resets > 0, "pendulum_ac_rollout: no env reset in the comparison")
            check(max(errs.values()) <= 1e-4, f"pendulum_ac_rollout disagrees with its twin: {errs}")
            errors["pendulum_ac_rollout"] = max(errors.get("pendulum_ac_rollout", 0.0), max(errs.values()))

    # ---- 3g. the epsilon-greedy kernel vs plain: bit for bit ----------------------
    def eps_q(E, A, seed):
        """Half-integer Q-values (ties in most rows), row 0 tied for the
        maximum at two indices, row 1 holding a NaN."""
        r = np.random.RandomState(seed)
        qv = (np.round(r.randn(E, A) * 2) / 2).astype(np.float32)
        qv[0, [A // 2, A - 1]] = 9.0
        qv[1, A - 1] = np.nan
        return torch.tensor(qv, device=dev)

    eps_inputs = {}
    for E, EA in EPS_GREEDY_SHAPES:
        qv = eps_inputs[(E, EA)] = eps_q(E, EA, E + EA)
        n_random = 0
        for eps in (0.0, 0.3, 1.0):
            for seed in (3, 2**62 + 5):
                got, want = eg.eps_greedy(seed, qv, eps), eg.eps_greedy_plain(seed, qv, eps)
                torch.cuda.synchronize()
                check(got.dtype == torch.int64 and torch.equal(got, want),
                      f"eps_greedy ({E}, {EA}) eps {eps} seed {seed}: kernel and twin differ")
                n_random += int((got != qv.argmax(-1)).sum())
        check(int(eg.eps_greedy(3, qv, 0.0)[0]) == EA // 2 and int(eg.eps_greedy(3, qv, 0.0)[1]) == EA - 1,
              "eps_greedy: the tie or the NaN row took the wrong greedy action")
        print(f"eps_greedy (E, A) = ({E}, {EA}): actions equal to the twin's at eps 0, 0.3, 1 and two seeds "
              f"({n_random} non-greedy), the tie row takes index {EA // 2}, the NaN row index {EA - 1}")
    # edge rows: -0.0 against +0.0, NaNs of four payloads (the first wins), a
    # NaN after +inf, all -inf, all NaN, +inf twice; at A 34 and 65 (three
    # elements a lane)
    for EA in (34, 65):
        edges = eps_edge_rows(EA)
        qv = torch.tensor(np.concatenate([edges, np.random.RandomState(EA).randn(64, EA).astype(np.float32)]),
                          device=dev)
        want_greedy = torch.tensor(edges).argmax(-1)
        for eps in (0.0, 0.3):
            got = eg.eps_greedy(17, qv, eps)
            torch.cuda.synchronize()
            check(torch.equal(got, eg.eps_greedy_plain(17, qv, eps)), f"eps_greedy edge rows A {EA} eps {eps}: differs")
        check(torch.equal(eg.eps_greedy(17, qv, 0.0)[: len(edges)].cpu(), want_greedy),
              f"eps_greedy edge rows A {EA}: not torch.argmax's choice on the CPU")
        print(f"eps_greedy edge rows at A {EA}: equal to the twin at eps 0 and 0.3, greedy "
              f"{want_greedy.tolist()} as torch.argmax on the CPU")
    errors["eps_greedy"] = 0.0

    # ---- 4. PRNG-on statistics -----------------------------------------------
    B, T = 128, 64
    stf0, sti0 = reset_states(B, 7)
    obs, act, rew, done, q, _, _, _ = cr.cartpole_rollout(99, 0.3, weights, stf0, sti0, T)
    p_random = (act.long() != q.argmax(-1)).float().mean().item()
    print(f"P(act != greedy) at eps 0.3, A=2: {p_random:.4f} (expect 0.15)")
    check(abs(p_random - 0.15) < 0.02, f"P(act != greedy) = {p_random}")
    obs1 = cr.cartpole_rollout(5, 0.0, weights, stf0, sti0, T, max_steps=1)[0]
    draws = obs1[1:]  # every step resets at max_steps=1
    lo, hi, mean = draws.min().item(), draws.max().item(), draws.mean().item()
    print(f"reset draws: min {lo:.5f} max {hi:.5f} mean {mean:.5f} std {draws.std().item():.5f} (U(-0.05,0.05): std 0.02887)")
    check(-0.05 <= lo and hi <= 0.05 and abs(mean) < 0.002, "reset draws out of U(-0.05, 0.05)")
    obs2 = cr.cartpole_rollout(6, 0.0, weights, stf0, sti0, T, max_steps=1)[0]
    act2 = cr.cartpole_rollout(100, 0.3, weights, stf0, sti0, T)[1]
    check(not torch.equal(obs1, obs2) and not torch.equal(act, act2), "different seeds gave the same stream")
    print("cartpole: different seeds give different streams")

    _, bact, _, _, bq, _, _, _ = br.breakout_rollout(99, 0.3, bweights, st0, brick0, BT)
    p_random = (bact.long() != bq.argmax(-1)).float().mean().item()
    print(f"P(act != greedy) at eps 0.3, A=3: {p_random:.4f} (expect 0.2)")
    check(abs(p_random - 0.2) < 0.02, f"breakout P(act != greedy) = {p_random}")
    bobs1 = br.breakout_rollout(5, 0.0, bweights, st0, brick0, BT, max_steps=1)[0]
    ball = bobs1[1:, :, :, :, 1]  # every step resets at max_steps=1: the ball at row 3
    check(bool((ball[:, :, 3, 0] + ball[:, :, 3, 9] == 1).all()), "a reset ball is not at (3, 0) or (3, 9)")
    at9 = ball[:, :, 3, 9].mean().item()
    print(f"reset side: ball starts at x = 9 in {at9:.4f} of {ball.shape[0] * ball.shape[1]} resets (expect 0.5)")
    check(abs(at9 - 0.5) < 0.03, f"breakout reset side share {at9}")
    bobs2 = br.breakout_rollout(6, 0.0, bweights, st0, brick0, BT, max_steps=1)[0]
    bact2 = br.breakout_rollout(100, 0.3, bweights, st0, brick0, BT)[1]
    check(not torch.equal(bobs1, bobs2) and not torch.equal(bact, bact2), "breakout: different seeds gave the same stream")
    print("breakout: different seeds give different streams")

    for name, expect in (("asterix_rollout", 0.24), ("freeway_rollout", 0.2), ("space_invaders_rollout", 0.225),
                         ("seaquest_rollout", 0.25)):
        kernel, gA = games[name][0], games[name][4]
        gweights, gstates = game_inputs[name]
        _, gact, _, _, gq, *_ = kernel(99, 0.3, gweights, *gstates, BT)
        p_random = (gact.long() != gq.argmax(-1)).float().mean().item()
        print(f"{name}: P(act != greedy) at eps 0.3, A={gA}: {p_random:.4f} (expect {expect})")
        check(abs(p_random - expect) < 0.02, f"{name} P(act != greedy) = {p_random}")
        gact2 = kernel(100, 0.3, gweights, *gstates, BT)[1]
        check(not torch.equal(gact, gact2), f"{name}: different seeds gave the same actions")

    # Asterix spawns: one step of 8192 envs, each with a random set of free
    # slots and its spawn timer at 0 (nothing moves, nothing collides)
    from purejaxql_torch.envs.minatar.asterix import AsterixState

    NB = 8192
    r = np.random.RandomState(5)
    exists = r.rand(NB, 8) < 0.5
    exists[np.arange(NB), r.randint(0, 8, NB)] = False  # at least one free slot
    i32 = lambda v: torch.full((NB,), v, dtype=torch.int32)  # noqa: E731
    spawn_state = AsterixState(
        player_x=i32(5), player_y=i32(5), e_exists=torch.tensor(exists),
        e_x=torch.full((NB, 8), 2, dtype=torch.int32), e_lr=torch.zeros(NB, 8, dtype=torch.bool),
        e_gold=torch.zeros(NB, 8, dtype=torch.bool), spawn_speed=i32(10), spawn_timer=i32(0),
        move_speed=i32(5), move_timer=i32(5), ramp_timer=i32(50), ramp_index=i32(0),
        terminal=torch.zeros(NB, dtype=torch.bool), time=i32(0),
    )
    spawn_st = ar.state_matrix_from_asterix(spawn_state).to(dev)
    aweights = game_inputs["asterix_rollout"][0]
    spawned = []
    for seed in (7, 8):
        after = ar.asterix_from_state_matrix(ar.asterix_rollout(seed, 0.0, aweights, spawn_st, 1)[6].cpu())
        new = after.e_exists & ~spawn_state.e_exists
        check(bool((new.sum(1) == 1).all()), "asterix: a spawn did not fill exactly one free slot")
        slot = new.int().argmax(1)
        spawned.append(slot)
    rows = torch.arange(NB)
    gold = after.e_gold[rows, slot].float().mean().item()
    right = after.e_lr[rows, slot]
    check(bool(torch.equal(after.e_x[rows, slot], torch.where(right, 0, 9).to(torch.int32))),
          "asterix: a spawn is not at the edge it walks from")
    free = torch.tensor(~exists).float()
    expect = (free / free.sum(1, keepdim=True)).sum(0)
    counts = torch.bincount(slot, minlength=8).float()
    dev_slot = ((counts - expect).abs() / expect).max().item()
    print(
        f"asterix spawns: gold {gold:.4f} (expect 1/3), walking right {right.float().mean().item():.4f} "
        f"(expect 0.5), per-slot count / uniform-over-free-slots expectation off by at most "
        f"{100 * dev_slot:.1f} % over {NB} spawns"
    )
    check(abs(gold - 1 / 3) < 0.02 and abs(right.float().mean().item() - 0.5) < 0.02, "asterix spawn shares")
    check(dev_slot < 0.1, f"asterix: spawned slots not uniform over the free slots ({dev_slot})")
    check(not torch.equal(spawned[0], spawned[1]), "asterix: different seeds gave the same spawns")

    # Freeway resets: one step of 8192 envs at max_steps=1, so every env
    # resets to new car columns and the step's lane speeds and directions
    fst0 = freeway_states(NB, 9)[0].to(dev)
    fweights = game_inputs["freeway_rollout"][0]
    resets = [fr.freeway_from_state_matrix(fr.freeway_rollout(seed, 0.0, fweights, fst0, 1, max_steps=1)[6].cpu())
              for seed in (7, 8)]
    cars = resets[0]
    x_share = torch.bincount(cars.car_x.flatten(), minlength=10).float() / cars.car_x.numel()
    speed = cars.car_speed.abs().flatten()
    s_share = torch.bincount(speed, minlength=6)[1:].float() / speed.numel()
    right = (cars.car_speed > 0).float().mean().item()
    print(
        f"freeway resets: car columns {[round(v, 4) for v in x_share.tolist()]} (expect 0.1 each), "
        f"speeds 1-5 {[round(v, 4) for v in s_share.tolist()]} (expect 0.2 each), "
        f"direction +1 {right:.4f} (expect 0.5), over {cars.car_x.numel()} cars"
    )
    check((x_share - 0.1).abs().max().item() < 0.01 and (s_share - 0.2).abs().max().item() < 0.01
          and abs(right - 0.5) < 0.01, "freeway reset draws")
    check(bool(torch.equal(cars.car_timer, cars.car_speed.abs())) and bool((cars.pos == 9).all()),
          "freeway: a reset's timers or chicken are wrong")
    check(not torch.equal(resets[0].car_x, resets[1].car_x), "freeway: different seeds gave the same resets")

    # Seaquest's draws: one step of 8192 envs with the sub on the surface and
    # its greedy action fire (the head's bias raised), each pool's free slots
    # at random, nothing moving (the lane timers held), every sub about to
    # shoot and both spawn timers due: in every env one friendly bullet, one
    # enemy bullet, one fish or sub and one diver appear, nothing collides
    from purejaxql_torch.envs.minatar.seaquest import SeaquestParams
    from purejaxql_torch.envs.minatar.seaquest import start_state as seaquest_start

    r = np.random.RandomState(6)
    rows = torch.arange(NB)

    def taken(n, one_taken=False):
        """A random set of occupied slots with at least one free (and, when
        asked, at least one occupied)."""
        occ = r.rand(NB, n) < 0.5
        free = r.randint(0, n, NB)
        occ[np.arange(NB), free] = False
        if one_taken:
            occ[np.arange(NB), (free + r.randint(1, n, NB)) % n] = True
        return torch.tensor(occ)

    i32n = lambda a: torch.tensor(np.asarray(a, np.int32))  # noqa: E731
    sq0 = seaquest_start(NB, SeaquestParams(), "cpu")
    sq0.f_exists, sq0.s_exists, sq0.d_exists = taken(8), taken(4, one_taken=True), taken(4)
    sq0.fb_exists, sq0.eb_exists = taken(4), taken(4)
    for pool, n in (("f", 8), ("s", 4), ("d", 4)):
        setattr(sq0, f"{pool}_x", i32n(r.randint(0, 10, (NB, n))))
        setattr(sq0, f"{pool}_y", i32n(r.randint(1, 9, (NB, n))))
        setattr(sq0, f"{pool}_dir", i32n(r.choice([-1, 1], (NB, n))))
        setattr(sq0, f"{pool}_timer", torch.full((NB, n), 100, dtype=torch.int32))
    sq0.s_shot_timer = torch.ones(NB, 4, dtype=torch.int32)
    sq0.fb_x, sq0.eb_x = torch.full((NB, 4), 5, dtype=torch.int32), torch.full((NB, 4), 5, dtype=torch.int32)
    sq0.eb_y = i32n(r.randint(1, 9, (NB, 4)))
    sq0.eb_dir, sq0.fb_dir = i32n(r.choice([-1, 1], (NB, 4))), i32n(r.choice([-1, 1], (NB, 4)))
    sq0.spawn_timer, sq0.diver_spawn_timer = torch.ones(NB, dtype=torch.int32), torch.ones(NB, dtype=torch.int32)
    sq_st0 = sq.state_matrix_from_seaquest(sq0).to(dev)
    qweights = list(game_inputs["seaquest_rollout"][0])
    qweights[9] = qweights[9].clone()
    qweights[9][5] += 1e3  # greedy: fire
    spawned = []
    for seed in (7, 8):
        out = sq.seaquest_rollout(seed, 0.0, qweights, sq_st0, 1)
        check(bool((out[1] == 5).all()) and not bool(out[3].any()), "seaquest: the draw step did not fire or ended")
        spawned.append(sq.seaquest_from_state_matrix(out[6].cpu()))
    after = spawned[0]
    new = {p: getattr(after, f"{p}_exists") & ~getattr(sq0, f"{p}_exists") for p in ("fb", "eb", "f", "s", "d")}
    for p, want_one in (("fb", 1), ("eb", 1), ("d", 1)):
        check(bool((new[p].sum(1) == want_one).all()), f"seaquest: not exactly one new {p} in every env")
    check(bool((new["f"].sum(1) + new["s"].sum(1) == 1).all()), "seaquest: not exactly one new fish or sub")
    shooter = (sq0.s_exists & (sq0.s_exists.cumsum(1) == 1)).int().argmax(1)
    eb_slot = new["eb"].int().argmax(1)
    check(bool(torch.equal(after.eb_x[rows, eb_slot], sq0.s_x[rows, shooter])
               and torch.equal(after.eb_y[rows, eb_slot], sq0.s_y[rows, shooter])),
          "seaquest: the enemy bullet is not where the first sub is")
    is_sub = new["s"].any(1)
    e_slot = torch.where(is_sub, new["s"].int().argmax(1), new["f"].int().argmax(1))
    e_x = torch.where(is_sub, after.s_x[rows, e_slot.clamp(max=3)], after.f_x[rows, e_slot])
    e_y = torch.where(is_sub, after.s_y[rows, e_slot.clamp(max=3)], after.f_y[rows, e_slot])
    d_slot = new["d"].int().argmax(1)
    check(bool(torch.equal(after.d_y[rows, d_slot], e_y) and torch.equal(after.d_x[rows, d_slot], e_x)),
          "seaquest: the diver's lane or edge is not the enemy's")
    lane_share = torch.bincount(e_y, minlength=9)[1:].float() / NB
    right = (e_x == 0).float().mean().item()
    sub_share = is_sub.float().mean().item()
    slot_dev = 0.0
    for p, picked, free, cond in (
        ("fb", new["fb"], ~sq0.fb_exists, None), ("eb", new["eb"], ~sq0.eb_exists, None),
        ("f", new["f"], ~sq0.f_exists, ~is_sub), ("s", new["s"], ~sq0.s_exists, is_sub),
        ("d", new["d"], ~sq0.d_exists, None),
    ):
        if cond is not None:
            picked, free = picked[cond], free[cond]
        freef = free.float()
        expect = (freef / freef.sum(1, keepdim=True)).sum(0)
        counts = picked.float().sum(0)
        slot_dev = max(slot_dev, ((counts - expect).abs() / expect.sqrt()).max().item())
    print(
        f"seaquest draws: lanes 1-8 {[round(v, 4) for v in lane_share.tolist()]} (expect 0.125 each), "
        f"from the left {right:.4f} (expect 0.5), a sub {sub_share:.4f} (expect 1/3); per-slot spawn count off "
        f"the uniform-over-free-slots expectation by at most {slot_dev:.2f} standard deviations over five pools "
        f"and {NB} envs"
    )
    check((lane_share - 0.125).abs().max().item() < 0.02 and abs(right - 0.5) < 0.02 and abs(sub_share - 1 / 3) < 0.02,
          "seaquest spawn shares")
    check(slot_dev < 5.0, f"seaquest: spawned slots not uniform over the free slots ({slot_dev} sd)")
    check(not torch.equal(spawned[0].f_exists, spawned[1].f_exists), "seaquest: different seeds gave the same spawns")

    # epsilon-greedy on the card: P(action != greedy) = eps (A - 1) / A within 4
    # standard deviations over 64 seeds of 1024 envs, every action's count at
    # eps 1 within 4 standard deviations of uniform, other seeds other actions
    qg = torch.zeros(1024, 34, device=dev)
    qg[:, 5] = 1.0
    for eps in (0.1, 0.5):
        acts = torch.cat([eg.eps_greedy(s, qg, eps) for s in range(64)])
        p, n = eps * 33 / 34, acts.numel()
        got = (acts != 5).float().mean().item()
        print(f"eps_greedy P(act != greedy) at eps {eps}: {got:.4f} (expect {p:.4f}, 4 sd {4 * (p * (1 - p) / n) ** 0.5:.4f})")
        check(abs(got - p) < 4 * (p * (1 - p) / n) ** 0.5, f"eps_greedy P(random) at eps {eps}: {got}")
    acts = torch.cat([eg.eps_greedy(s, qg, 1.0) for s in range(64)])
    counts = torch.bincount(acts, minlength=34).float()
    mean = acts.numel() / 34
    dev_sd = ((counts - mean).abs() / (mean * (1 - 1 / 34)) ** 0.5).max().item()
    print(f"eps_greedy at eps 1: 34 action counts off uniform by at most {dev_sd:.2f} standard deviations")
    check(dev_sd < 4, "eps_greedy: random actions are not uniform")
    check((eg.eps_greedy(1, qg, 1.0) != eg.eps_greedy(2, qg, 1.0)).float().mean().item() > 0.9,
          "eps_greedy: different seeds gave the same actions")

    # Pendulum noise and resets: z recovered from u - greedy where greedy is
    # far enough from the bounds that no draw within 6 std is clipped (an
    # unbiased selection), by its mean and variance; reset draws by their
    # range, mean and variance (every step resets at max_steps 1)
    aw, cw, stf, sti = pend_inputs[(32, 64, 256)]
    noise = 0.05
    o = pr.pendulum_ac_rollout(21, noise, aw, cw, stf, sti, 200, linspace_noise=False)
    far = o[2].abs() < 2 - 12 * noise
    z = ((o[1] - o[2]) / (2 * noise))[far]
    n_z = z.numel()
    print(f"pendulum noise: z mean {z.mean().item():.4f} variance {z.var().item():.4f} over {n_z} draws "
          f"(expect 0 and 1; bounds {4 / n_z ** 0.5:.4f}, {4 * (2 / n_z) ** 0.5:.4f})")
    check(n_z > 2000 and abs(z.mean().item()) < 4 / n_z ** 0.5 and abs(z.var().item() - 1) < 4 * (2 / n_z) ** 0.5,
          "pendulum noise is not N(0, 1)")
    lad = pr.pendulum_ac_rollout(21, noise, aw, cw, stf, sti, 1)
    z0 = ((o[1] - o[2]) / (2 * noise))[0, :, 0]
    zl = ((lad[1] - lad[2]) / (2 * noise))[0, :, 0]
    ladder_err = (zl - z0 * torch.arange(64, device=dev) / 63)[far[0, :, 0]].abs().max().item()
    print(f"pendulum ladder: env b's noise is z * b / 63 within {ladder_err:.3g}")
    check(ladder_err < 1e-3, "pendulum: the noise ladder does not scale env b by b / (B - 1)")
    robs = pr.pendulum_ac_rollout(22, 0.0, aw, cw, stf, sti, 200, max_steps=1)[0][1:]
    th, thd = torch.atan2(robs[..., 1], robs[..., 0]), robs[..., 2]
    print(f"pendulum resets: theta in [{th.min().item():.4f}, {th.max().item():.4f}] mean {th.mean().item():.4f} "
          f"var {th.var().item():.4f} (pi^2/3 = 3.2899); theta_dot in [{thd.min().item():.4f}, "
          f"{thd.max().item():.4f}] mean {thd.mean().item():.4f} var {thd.var().item():.4f} (1/3), over {thd.numel()}")
    check(thd.min() >= -1 and thd.max() < 1 and abs(thd.mean().item()) < 0.025 and abs(thd.var().item() - 1 / 3) < 0.02
          and abs(th.mean().item()) < 0.07 and abs(th.var().item() / 3.2899 - 1) < 0.04, "pendulum reset draws")
    other = pr.pendulum_ac_rollout(23, noise, aw, cw, stf, sti, 200, linspace_noise=False)
    robs2 = pr.pendulum_ac_rollout(24, 0.0, aw, cw, stf, sti, 200, max_steps=1)[0][1:]
    check(not torch.equal(other[1], o[1]) and not torch.equal(robs, robs2), "pendulum: different seeds gave the same stream")
    print("pendulum: different seeds give different streams")

    # ---- 5. train pqn_cartpole at full width through the kernels ---------------
    save_path = os.path.join(root, "build", "chip_smoke_models")
    outs, wall, launches_cp = train(cli, compose, "pqn_cartpole", TRAIN_STEPS, save_path, counters)
    cp_updates = TRAIN_STEPS // 64 // 32
    check_run("cartpole", outs, wall, launches_cp, cp_updates, 64 * 32, "cartpole_rollout", 100)
    saved = load_params(os.path.join(save_path, "CartPole-v1", "pqn_CartPole-v1_seed0.safetensors"))
    check(tuple(saved["Dense_1"]["kernel"].shape) == (256, 256), "saved params have the wrong shape")

    # ---- 6. train pqn_minatar on Breakout at full width through the kernels ----
    outs, wall, launches_bo = train(
        cli, compose, "pqn_minatar", BREAKOUT_STEPS, save_path, counters,
        extra=["ENV_NAME=Breakout-MinAtar"],
    )
    bo_updates = BREAKOUT_STEPS // 32 // 128
    bo_last10, bo_eval = check_run("breakout", outs, wall, launches_bo, bo_updates, 32 * 128, "breakout_rollout", 3)
    check(launches_bo["cartpole_rollout"] == 0, "the Breakout run launched the CartPole kernel")
    bo_rate = outs["runner_state"][0].timesteps / wall
    saved = load_params(os.path.join(save_path, "Breakout-MinAtar", "pqn_Breakout-MinAtar_seed0.safetensors"))
    check(tuple(saved["CNN_0"]["Conv_0"]["kernel"].shape) == (3, 3, 4, 16), "saved conv kernel has the wrong shape")
    check(tuple(saved["CNN_0"]["Dense_0"]["kernel"].shape) == (1024, 128), "saved dense kernel has the wrong shape")
    print(json.dumps({"breakout_run": {"env_steps_per_s": bo_rate, "wall_s": wall, "last10_return": bo_last10,
                                       "launches": launches_bo, "card": card}}))
    now = (round(bo_last10, 2), round(bo_eval, 2), breakout_resets[False])
    print(
        f"breakout on the cluster CNN: last-10 mean {now[0]}, last eval {now[1]}, "
        f"{now[2]} resets in the PRNG-off check; recorded with the one-block CNN {BREAKOUT_RECORD}: "
        f"{'equal' if now == BREAKOUT_RECORD else 'DIFFERENT'} (informational: the dense sum's order "
        f"changed; the gate is the check)"
    )

    # ---- 6b. train pqn_minatar on Asterix, the YAML's default game -------------
    outs, wall, launches_as = train(cli, compose, "pqn_minatar", ASTERIX_STEPS, save_path, counters)
    as_updates = ASTERIX_STEPS // 32 // 128
    as_last10, as_eval = check_run(
        "asterix", outs, wall, launches_as, as_updates, 32 * 128, "asterix_rollout", ASTERIX_GATE
    )
    as_rate = outs["runner_state"][0].timesteps / wall
    saved = load_params(os.path.join(save_path, "Asterix-MinAtar", "pqn_Asterix-MinAtar_seed0.safetensors"))
    check(tuple(saved["CNN_0"]["Conv_0"]["kernel"].shape) == (3, 3, 4, 16), "asterix: saved conv kernel has the wrong shape")
    print(json.dumps({"asterix_run": {"env_steps_per_s": as_rate, "wall_s": wall, "last10_return": as_last10,
                                      "last_eval_return": as_eval, "gate": ASTERIX_GATE,
                                      "launches": launches_as, "card": card}}))

    # ---- 6c. Freeway and SpaceInvaders, 16 updates each at full width ----------
    # (the eval chunks' share of such a run: scripts/profile_torch_train.py)
    short_launches = {}
    for env_name, rollout in (("Freeway-MinAtar", "freeway_rollout"), ("SpaceInvaders-MinAtar", "space_invaders_rollout")):
        outs, wall, launches = train(
            cli, compose, "pqn_minatar", SHORT_STEPS, save_path, counters, extra=[f"ENV_NAME={env_name}"],
        )
        check_run(env_name, outs, wall, launches, 16, 32 * 128, rollout, None)
        short_launches[rollout] = launches
        print(json.dumps({"short_run": {"env": env_name, "env_steps_per_s": outs["runner_state"][0].timesteps / wall,
                                        "wall_s": wall, "launches": launches, "card": card}}))
    # Freeway's eval: 17 evals (one before training, one after each update at
    # TEST_INTERVAL 0.05 of 16 updates) of 79 chunks of 32 steps; no episode
    # ends before the 2500-step limit, so early exit cuts none of them
    check(short_launches["freeway_rollout"]["freeway_rollout"] == 16 + 17 * 79,
          f"freeway: {short_launches['freeway_rollout']['freeway_rollout']} launches, expected {16 + 17 * 79}")

    # ---- 6c'. Seaquest at full width, 500k steps --------------------------------
    # launches: one a update, and per eval (one before training, one every 5 %
    # of the run) one a 32-step chunk until every env has ended an episode,
    # at most 1000 / 32 -> 32 chunks
    outs, wall, launches_sq = train(
        cli, compose, "pqn_minatar", SEAQUEST_STEPS, save_path, counters, extra=["ENV_NAME=Seaquest-MinAtar"],
    )
    sq_updates = SEAQUEST_STEPS // 32 // 128
    sq_evals = 1 + sq_updates // max(1, int(sq_updates * 0.05))
    sq_last10, sq_eval = check_run(
        "seaquest", outs, wall, launches_sq, sq_updates, 32 * 128, "seaquest_rollout", SEAQUEST_GATE
    )
    lo, hi = sq_updates + sq_evals, sq_updates + sq_evals * -(-1000 // 32)
    check(lo <= launches_sq["seaquest_rollout"] <= hi,
          f"seaquest: {launches_sq['seaquest_rollout']} rollout launches, outside [{lo}, {hi}]")
    saved = load_params(os.path.join(save_path, "Seaquest-MinAtar", "pqn_Seaquest-MinAtar_seed0.safetensors"))
    check(tuple(saved["CNN_0"]["Conv_0"]["kernel"].shape) == (3, 3, 10, 16),
          "seaquest: saved conv kernel has the wrong shape")
    check(tuple(saved["Dense_0"]["kernel"].shape) == (128, 6), "seaquest: saved head has the wrong shape")
    print(json.dumps({"seaquest_run": {"env_steps_per_s": outs["runner_state"][0].timesteps / wall, "wall_s": wall,
                                       "last10_return": sq_last10, "last_eval_return": sq_eval,
                                       "gate": SEAQUEST_GATE, "launches": launches_sq,
                                       "launch_range": [lo, hi], "card": card}}))

    # ---- 6d. the recurrent trainer on MemoryChain, the FF contrast, CartPole ----
    outs, wall, launches_mc = train(
        cli, compose, "pqn_rnn_memory_chain", MEMORY_STEPS, save_path, counters,
        extra=["TEST_NUM_STEPS=64"], policy=("FAST_BPTT", "PALLAS_BPTT"),
    )
    mc_updates = MEMORY_STEPS // 128 // 32
    mc_grad_steps = mc_updates * 4 * 16
    ts = outs["runner_state"][0]
    m = {k: v.cpu().numpy() for k, v in outs["metrics"].items()}
    mc_last3 = float(m["test/returned_episode_returns"][-3:].mean())
    print(
        f"train memory_chain (pqn_rnn, GRU): {ts.timesteps} env steps in {wall:.2f} s wall "
        f"({ts.timesteps / wall:.0f} env-steps/s, eval included); launches {launches_mc}; greedy eval "
        f"returns {[round(float(v), 3) for v in m['test/returned_episode_returns']]}; last-3 mean {mc_last3:.3f}"
    )
    check(ts.timesteps == mc_updates * 128 * 32, "memory_chain: wrong env-step count")
    check(all(p.device.type == "cuda" for p in ts.network.parameters()), "memory_chain: a parameter is not on cuda")
    for name in ("gru_scan_fwd", "gru_scan_bwd", "lambda_returns_closure"):
        check(launches_mc[name] == mc_grad_steps,
              f"memory_chain: {name} launched {launches_mc[name]} times, expected {mc_grad_steps}")
    others = {k: v for k, v in launches_mc.items()
              if not k.startswith("gru_scan") and k != "lambda_returns_closure" and v}
    check(not others, f"memory_chain: another kernel launched: {others}")
    check(all(np.isfinite(m[k]).all() for k in ("td_loss", "qvals")), "memory_chain: non-finite metrics")
    check(mc_last3 > MEMORY_GATE, f"the recurrent trainer did not remember: last-3 greedy return {mc_last3} <= {MEMORY_GATE}")
    saved = load_params(os.path.join(save_path, "MemoryChain-bsuite", "pqn_rnn_MemoryChain-bsuite_seed0.safetensors"))
    gru = saved["ScannedRNN_0"]["GRUCell_0"]
    check(tuple(gru["ir"]["kernel"].shape) == (258, 256) and tuple(gru["hn"]["kernel"].shape) == (256, 256)
          and "bias" not in gru["hr"], "memory_chain: saved GRU params have the wrong flax tree")
    mc_rate = ts.timesteps / wall
    print(json.dumps({"memory_chain_run": {"env_steps_per_s": mc_rate, "wall_s": wall, "last3_eval_return": mc_last3,
                                           "gate": MEMORY_GATE, "launches": launches_mc, "card": card}}))

    outs, wall, launches_ff = train(
        cli, compose, "pqn_rnn_memory_chain", MEMORY_STEPS, save_path, counters,
        extra=["TEST_NUM_STEPS=64", "ALG_NAME=pqn"], policy=(),
    )
    ff_returns = outs["metrics"]["test/returned_episode_returns"].cpu().numpy()
    ff_last3 = float(ff_returns[-3:].mean())
    print(
        f"train memory_chain (pqn, feedforward): {wall:.2f} s wall; launches {launches_ff}; "
        f"last-3 greedy eval return {ff_last3:.3f} (must stay below {FF_GATE})"
    )
    check(launches_ff["lambda_returns"] == mc_updates and launches_ff["gru_scan_fwd"] == 0
          and launches_ff["lambda_returns_closure"] == 0,
          f"memory_chain FF: unexpected launches {launches_ff}")
    check(ff_last3 < FF_GATE, f"the feedforward trainer remembered: last-3 greedy return {ff_last3} >= {FF_GATE}")
    print(json.dumps({"memory_chain_ff_run": {"env_steps_per_s": outs["runner_state"][0].timesteps / wall,
                                              "wall_s": wall, "last3_eval_return": ff_last3, "gate": FF_GATE,
                                              "card": card}}))

    outs, wall, launches_rc = train(
        cli, compose, "pqn_rnn_cartpole", RNN_CARTPOLE_STEPS, save_path, counters,
        policy=("FAST_BPTT", "PALLAS_BPTT"),
    )
    ts = outs["runner_state"][0]
    m = {k: v.cpu().numpy() for k, v in outs["metrics"].items()}
    print(
        f"train cartpole (pqn_rnn, GRU): {ts.timesteps} env steps in {wall:.2f} s wall "
        f"({ts.timesteps / wall:.0f} env-steps/s, eval included); launches {launches_rc}; "
        f"last greedy eval return {float(m['test/returned_episode_returns'][-1]):.2f}"
    )
    check(ts.timesteps == RNN_CARTPOLE_STEPS, "rnn cartpole: wrong env-step count")
    for name in ("gru_scan_fwd", "gru_scan_bwd", "lambda_returns_closure"):
        check(launches_rc[name] == 16 * 4 * 16, f"rnn cartpole: {name} launched {launches_rc[name]} times, expected 1024")
    check(launches_rc["lambda_returns"] == 0, f"rnn cartpole: the gymnax form launched: {launches_rc}")
    check(all(np.isfinite(v).all() for k, v in m.items() if not k.startswith("test/")) and
          np.isfinite(m["test/returned_episode_returns"]).all(), "rnn cartpole: non-finite metrics")
    print(json.dumps({"rnn_cartpole_run": {"env_steps_per_s": ts.timesteps / wall, "wall_s": wall,
                                           "launches": launches_rc, "card": card}}))

    # ---- 6e. the actor-critic trainer on Pendulum-v1 ------------------------------
    outs, wall, launches_pd = train(
        cli, compose, "pqn_pendulum", PENDULUM_STEPS, save_path, counters, policy=("FUSED_ROLLOUT",),
    )
    pcfg = compose(alg="pqn_pendulum")
    pd_updates = PENDULUM_STEPS // pcfg["NUM_STEPS"] // pcfg["NUM_ENVS"]
    n_evals = 1 + pd_updates // max(1, int(pd_updates * pcfg["TEST_INTERVAL"]))
    # an eval runs the episode limit (the trainer's TEST_NUM_STEPS default) in NUM_STEPS chunks
    eval_steps = pcfg.get("TEST_NUM_STEPS", PendulumParams().max_steps_in_episode)
    pd_launches = pd_updates + n_evals * -(-eval_steps // pcfg["NUM_STEPS"])
    ts = outs["runner_state"][0]
    m = {k: v.cpu().numpy() for k, v in outs["metrics"].items()}
    evals = m["test/returned_episode_returns"]
    pd_best = float(evals.max())
    print(
        f"train pendulum (pqn_ac): {ts['actor'].timesteps} env steps in {wall:.2f} s wall "
        f"({ts['actor'].timesteps / wall:.0f} env-steps/s, eval included); launches {launches_pd}; greedy eval "
        f"returns at each eval {[round(float(v), 1) for v in evals[:: max(1, int(pd_updates * 0.1))]]}; "
        f"best {pd_best:.2f}"
    )
    check(ts["actor"].timesteps == pd_updates * pcfg["NUM_STEPS"] * pcfg["NUM_ENVS"], "pendulum: wrong env-step count")
    check(all(p.device.type == "cuda" for s in ts.values() for p in s.network.parameters()),
          "pendulum: a parameter is not on cuda")
    check(launches_pd["lambda_returns"] == pd_updates,
          f"pendulum: lambda_returns launched {launches_pd['lambda_returns']} times, expected {pd_updates}")
    check(launches_pd["pendulum_ac_rollout"] == pd_launches,
          f"pendulum: its rollout kernel launched {launches_pd['pendulum_ac_rollout']} times, expected {pd_launches}")
    others = {k: v for k, v in launches_pd.items() if k not in ("lambda_returns", "pendulum_ac_rollout") and v}
    check(not others, f"pendulum: another kernel launched: {others}")
    check(all(np.isfinite(m[k]).all() for k in ("value_loss", "loss_actor", "returned_episode_returns")),
          "pendulum: non-finite metrics")
    check(pd_best > PENDULUM_GATE, f"the actor-critic trainer did not learn Pendulum: best greedy eval {pd_best} <= {PENDULUM_GATE}")
    saved = load_params(os.path.join(save_path, "Pendulum-v1", "pqn_ac_Pendulum-v1_seed0.safetensors"))
    check(tuple(saved["actor"]["Dense_0"]["kernel"].shape) == (3, 256)
          and tuple(saved["critic"]["Dense_1"]["kernel"].shape) == (2, 256, 256)
          and tuple(saved["critic"]["LayerNorm_0"]["scale"].shape) == (2, 256),
          "pendulum: saved params have the wrong flax tree")
    print(json.dumps({"pendulum_run": {"env_steps_per_s": ts["actor"].timesteps / wall, "wall_s": wall,
                                       "best_eval_return": pd_best, "gate": PENDULUM_GATE,
                                       "launches": launches_pd, "card": card}}))

    # ---- 6f. pqn_craftax at full width: the fast program, every action from eps_greedy ----
    ccfg = compose(alg="pqn_craftax")
    cx_updates = CRAFTAX_STEPS // ccfg["NUM_STEPS"] // ccfg["NUM_ENVS"]
    wrappers.BankedResetVecEnv.refreshes = 0
    outs, wall, launches_cx = train(
        cli, compose, "pqn_craftax", CRAFTAX_STEPS, save_path, counters,
        policy=(("EXPLORATION_KERNEL", "pallas"), "FAST_TARGETS", "SKIP_NOOP_PERMUTE", ("RESET_BANK", 256)),
    )
    bursts = wrappers.BankedResetVecEnv.refreshes
    ts = outs["runner_state"][0]
    m = {k: v.cpu().numpy() for k, v in outs["metrics"].items()}
    cx_metric, cx_ended = craftax_bar_metric(m)
    cx_rate = ts.timesteps / wall
    print(
        f"train craftax (pqn_craftax, Forager, the fast program): {ts.timesteps} env steps in {wall:.2f} s wall "
        f"({cx_rate:.0f} env-steps/s on {card}); launches {launches_cx}; refresh bursts {bursts}; done-masked "
        f"returned_episode_returns over the last 10 % ({cx_ended} updates with an episode end): {cx_metric:.4f} "
        f"(no bar); achievement_count there {float(m['achievement_count'][-cx_updates // 10:].mean()):.3f}"
    )
    check(isinstance(outs["runner_state"][1][1], wrappers.BankedResetState), "craftax: the training env is not banked")
    check(launches_cx["eps_greedy"] == cx_updates,
          f"craftax: eps_greedy launched {launches_cx['eps_greedy']} times, expected {cx_updates}")
    others = {k: v for k, v in launches_cx.items() if k != "eps_greedy" and v}
    check(not others, f"craftax: a returns or rollout kernel launched: {others}")
    check(bursts == -(-cx_updates // 16), f"craftax: {bursts} refresh bursts, expected {-(-cx_updates // 16)}")
    check(ts.timesteps == CRAFTAX_STEPS, "craftax: wrong env-step count")
    check(all(p.device.type == "cuda" for p in ts.network.parameters()), "craftax: a parameter is not on cuda")
    check(int(ts.network.BatchRenorm_0.steps) == cx_updates, "craftax: the input norm did not step once a grad step")
    check(all(np.isfinite(m[k]).all() for k in ("td_loss", "qvals")), "craftax: non-finite td_loss or qvals")
    check(cx_ended > 0 and np.isfinite(cx_metric), "craftax: no episode ended in the last 10 % of the run")
    saved = load_params(os.path.join(save_path, "Craftax-Symbolic-v1", "pqn_craftax_Craftax-Symbolic-v1_seed0.safetensors"))
    check(tuple(saved["Dense_0"]["kernel"].shape) == (2883, 1024) and tuple(saved["Dense_4"]["kernel"].shape) == (1024, 34)
          and tuple(saved["BatchRenorm_0"]["scale"].shape) == (2883,), "craftax: saved params have the wrong flax tree")
    print(json.dumps({"craftax_run": {"program": "fast", "env_steps_per_s": cx_rate, "wall_s": wall,
                                      "bar_metric": cx_metric, "updates_with_an_end": cx_ended,
                                      "refresh_bursts": bursts, "launches": launches_cx, "card": card}}))

    # the strict program: optimistic resets, concat 1-step TD, a permuted minibatch
    outs, wall, launches_cs = train(
        cli, compose, "pqn_craftax", CRAFTAX_STRICT_STEPS, save_path, counters,
        extra=["PARITY=strict", "EXPLORATION_KERNEL=pallas"], policy=(("EXPLORATION_KERNEL", "pallas"),),
    )
    ts = outs["runner_state"][0]
    cs_updates = CRAFTAX_STRICT_STEPS // ccfg["NUM_ENVS"]
    m = {k: v.cpu().numpy() for k, v in outs["metrics"].items()}
    print(f"train craftax (the strict program): {ts.timesteps} env steps in {wall:.2f} s wall "
          f"({ts.timesteps / wall:.0f} env-steps/s); launches {launches_cs}")
    check(isinstance(outs["runner_state"][1][1], wrappers.LogEnvState), "craftax strict: the training env is banked")
    check(launches_cs["eps_greedy"] == cs_updates and not {k: v for k, v in launches_cs.items() if k != "eps_greedy" and v},
          f"craftax strict: unexpected launches {launches_cs}")
    check(all(np.isfinite(m[k]).all() for k in ("td_loss", "qvals")), "craftax strict: non-finite td_loss or qvals")
    print(json.dumps({"craftax_run": {"program": "strict", "env_steps_per_s": ts.timesteps / wall, "wall_s": wall,
                                      "launches": launches_cs, "card": card}}))

    # the fast program in bfloat16
    outs, wall, launches_cb = train(
        cli, compose, "pqn_craftax", CRAFTAX_BF16_STEPS, save_path, counters, extra=["BF16_COMPUTE=True"],
        policy=(("EXPLORATION_KERNEL", "pallas"), "FAST_TARGETS", "SKIP_NOOP_PERMUTE", ("RESET_BANK", 256)),
    )
    ts = outs["runner_state"][0]
    net = ts.network
    m = {k: v.cpu().numpy() for k, v in outs["metrics"].items()}
    check(launches_cb["eps_greedy"] == CRAFTAX_BF16_STEPS // ccfg["NUM_ENVS"], f"craftax bf16: launches {launches_cb}")
    check(all(np.isfinite(m[k]).all() for k in ("td_loss", "qvals")), "craftax bf16: non-finite td_loss or qvals")
    seen = {}
    hooks = [mod.register_forward_hook(lambda mod_, i, o, name=name: seen.__setitem__(name, o.dtype))
             for name, mod in net.named_modules() if name.startswith(("Dense_", "LayerNorm_"))]
    obs = outs["runner_state"][1][0]
    with torch.no_grad():
        q_bf16 = net(obs, train=False)
    for h in hooks:
        h.remove()
    check(net.dtype == torch.bfloat16 and len(seen) == 9 and set(seen.values()) == {torch.bfloat16},
          f"craftax bf16: the trunk's activations are {seen}")
    check(q_bf16.dtype == torch.float32 and all(t.dtype in (torch.float32, torch.int32) for t in net.state_dict().values()),
          "craftax bf16: a parameter, buffer or the Q-values are not float32")
    f32_net = copy.deepcopy(net)
    f32_net.dtype = torch.float32
    with torch.no_grad():
        q_f32 = f32_net(obs, train=False)
    bf16_err = float((q_bf16 - q_f32).abs().max())
    bf16_scale = float(q_f32.abs().max())
    print(f"train craftax (BF16_COMPUTE): {ts.timesteps} env steps in {wall:.2f} s wall "
          f"({ts.timesteps / wall:.0f} env-steps/s); launches {launches_cb}; bfloat16 forward against float32 on the "
          f"same weights at batch {obs.shape[0]}: max |diff| {bf16_err:.5f}, mean "
          f"{float((q_bf16 - q_f32).abs().mean()):.5f}, max |Q| {bf16_scale:.4f}")
    check(bf16_err <= BF16_BOUND * bf16_scale, f"craftax bf16: forward off float32 by {bf16_err} > "
                                               f"{BF16_BOUND} x {bf16_scale}")
    print(json.dumps({"craftax_run": {"program": "fast, BF16_COMPUTE", "env_steps_per_s": ts.timesteps / wall,
                                      "wall_s": wall, "bf16_max_abs_err": bf16_err, "max_abs_q": bf16_scale,
                                      "launches": launches_cb, "card": card}}))

    # Breakout in bfloat16: the learn phase's trunk in bfloat16, the fused
    # kernel on the float32 master weights
    outs, wall, launches_bb = train(
        cli, compose, "pqn_minatar", SHORT_STEPS, save_path, counters,
        extra=["ENV_NAME=Breakout-MinAtar", "BF16_COMPUTE=True"],
    )
    check_run("breakout bf16", outs, wall, launches_bb, 16, 32 * 128, "breakout_rollout", None)
    check(outs["runner_state"][0].network.dtype == torch.bfloat16, "breakout bf16: the network is not bfloat16")
    print(json.dumps({"short_run": {"env": "Breakout-MinAtar", "BF16_COMPUTE": True,
                                    "env_steps_per_s": outs["runner_state"][0].timesteps / wall, "wall_s": wall,
                                    "launches": launches_bb, "card": card}}))

    # ---- 6g. the VDN trainer: Spread at full width, then SMAX, Kitchen, Hanabi ----
    # every grad step one launch of each GRU scan kernel and of the closure
    # returns, nothing else; the rollout and the eval run no kernel
    vdn_kernels = ("gru_scan_fwd", "gru_scan_bwd", "lambda_returns_closure")

    def check_vdn_launches(name, launches, grad_steps):
        for k in vdn_kernels:
            check(launches[k] == grad_steps, f"{name}: {k} launched {launches[k]} times, expected {grad_steps}")
        others = {k: v for k, v in launches.items() if k not in vdn_kernels and v}
        check(not others, f"{name}: another kernel launched: {others}")

    outs, wall, launches_vdn = train(
        cli, compose, "pqn_vdn_spread", VDN_SPREAD_STEPS, save_path, counters, policy=("FAST_BPTT", "PALLAS_BPTT"),
    )
    vcfg = compose(alg="pqn_vdn_spread")
    vdn_updates = VDN_SPREAD_STEPS // vcfg["NUM_STEPS"] // vcfg["NUM_ENVS"]
    vdn_grad_steps = vdn_updates * vcfg["NUM_EPOCHS"] * vcfg["NUM_MINIBATCHES"]
    ts = outs["runner_state"][0]
    m = {k: v.cpu().numpy() for k, v in outs["metrics"].items()}
    rets = m["returned_episode_returns"]
    tenth = max(1, len(rets) // 10)
    vdn_early, vdn_late = float(rets[:tenth].mean()), float(rets[-tenth:].mean())
    vdn_eval = float(m["test/returned_episode_returns"][-1])
    print(
        f"train spread (pqn_vdn, 3 agents, GRU): {ts.timesteps} env steps in {wall:.2f} s wall "
        f"({ts.timesteps / wall:.0f} env-steps/s, eval included); launches {launches_vdn}; mean team return of the "
        f"first tenth of updates {vdn_early:.3f}, of the last tenth {vdn_late:.3f} (must beat the first by "
        f"{VDN_SPREAD_GATE}); last greedy eval return {vdn_eval:.3f}"
    )
    check(ts.timesteps == vdn_updates * vcfg["NUM_STEPS"] * vcfg["NUM_ENVS"], "spread: wrong env-step count")
    check(all(p.device.type == "cuda" for p in ts.network.parameters()), "spread: a parameter is not on cuda")
    check_vdn_launches("spread", launches_vdn, vdn_grad_steps)
    check(all(np.isfinite(m[k]).all() for k in ("td_loss", "qvals", "returned_episode_returns")),
          "spread: non-finite metrics")
    check(np.isfinite(vdn_eval), "spread: the last greedy eval finished no episode")
    check(vdn_late > vdn_early + VDN_SPREAD_GATE,
          f"the VDN trainer did not learn Spread: last tenth {vdn_late} <= first tenth {vdn_early} + {VDN_SPREAD_GATE}")
    saved = load_params(os.path.join(save_path, "Spread-v0", "pqn_vdn_rnn_Spread-v0_seed0.safetensors"))
    check(tuple(saved["ScannedRNN_0"]["GRUCell_0"]["ir"]["kernel"].shape) == (256, 256)
          and tuple(saved["Dense_2"]["kernel"].shape) == (256, 5) and "Dense_3" not in saved,
          "spread: saved params have the wrong flax tree (no last action in, one head)")
    print(json.dumps({"vdn_spread_run": {"env_steps_per_s": ts.timesteps / wall, "wall_s": wall,
                                         "early_tenth_return": vdn_early, "late_tenth_return": vdn_late,
                                         "gate": VDN_SPREAD_GATE, "last_eval_return": vdn_eval,
                                         "launches": launches_vdn, "card": card}}))

    for alg in VDN_SHORT:
        acfg = compose(alg=alg)
        steps = VDN_SHORT_UPDATES * acfg["NUM_STEPS"] * acfg["NUM_ENVS"]
        outs, wall, launches_v = train(cli, compose, alg, steps, save_path, counters,
                                       policy=("FAST_BPTT", "PALLAS_BPTT"))
        ts = outs["runner_state"][0]
        m = {k: v.cpu().numpy() for k, v in outs["metrics"].items()}
        memory = outs["runner_state"][1]
        print(
            f"train {alg} ({memory.obs.shape[1]} agents, window {memory.obs.shape[0]}, obs {memory.obs.shape[-1]}): "
            f"{ts.timesteps} env steps in {wall:.2f} s wall ({ts.timesteps / wall:.0f} env-steps/s, eval "
            f"included); launches {launches_v}; td_loss {[round(float(v), 4) for v in m['td_loss']]}"
        )
        check(ts.timesteps == steps, f"{alg}: wrong env-step count")
        check_vdn_launches(alg, launches_v, VDN_SHORT_UPDATES * acfg["NUM_EPOCHS"] * acfg["NUM_MINIBATCHES"])
        check(all(np.isfinite(m[k]).all() for k in ("td_loss", "qvals", "returned_episode_returns")),
              f"{alg}: non-finite metrics")
        print(json.dumps({"vdn_short_run": {"alg": alg, "env_steps_per_s": ts.timesteps / wall, "wall_s": wall,
                                            "launches": launches_v, "card": card}}))

    # ---- 7. time the kernels at the trainers' shapes ---------------------------
    timings = {}
    for name, (kernel, plain) in lam_forms.items():
        for shape in LAMBDA_TIMED:
            args = lam_inputs[shape]
            # ms: through the wrapper, as the trainers call it
            k_ms = cuda_time_ms(lambda: kernel(*args, 0.99, 0.95), 200)
            p_ms = cuda_time_ms(lambda: plain(*args, 0.99, 0.95), 20)
            b_ms, b_by = lambda_bound_ms(*shape)
            timings[f"{name}_{shape[0]}x{shape[1]}"] = (k_ms, p_ms, b_ms, b_by)
            print(json.dumps({"timing": name, "shape": list(shape), "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                              "bound_by": b_by, "library_ms": None}))
    for B in (32, 128):
        stf0, sti0 = reset_states(B, 11)
        k_ms = cuda_time_ms(lambda: cr.cartpole_rollout(3, 0.1, weights, stf0, sti0, 64), 20)
        p_ms = cuda_time_ms(lambda: cr.cartpole_rollout_plain(3, 0.1, weights, stf0, sti0, 64), 3, warmup=1)
        b_ms, b_by = rollout_bound_ms(64, B, H, A)
        timings[f"cartpole_rollout_B{B}"] = (k_ms, p_ms, b_ms, b_by)
        print(json.dumps({"timing": "cartpole_rollout", "shape": {"T": 64, "B": B, "H": H}, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by}))
    for name in ("breakout_rollout", "asterix_rollout", "freeway_rollout", "space_invaders_rollout",
                 "seaquest_rollout"):
        kernel, plain, _, gC, gA, _ = games[name]
        gweights, gstates = game_inputs[name]
        k_ms = cuda_time_ms(lambda: kernel(3, 0.1, gweights, *gstates, BT), 50)
        p_ms = cuda_time_ms(lambda: plain(3, 0.1, gweights, *gstates, BT), 3, warmup=1)
        b_ms, b_by = minatar_bound_ms(BT, BB, BH, gA, *GAME_SHAPES[name])
        timings[name] = (k_ms, p_ms, b_ms, b_by)
        print(json.dumps({"timing": name, "shape": {"T": BT, "B": BB, "H": BH, "C": gC, "A": gA}, "ms": k_ms,
                          "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by}))

    for shape in GRU_SHAPES[:2] + GRU_VDN_TIMED:
        xi, keep, h0, w_h, b_hn, g_y, g_hT, res = gru_inputs_by_shape[shape]
        for name, kernel, plain, args, bound in (
            ("gru_scan_fwd", gs.gru_scan_fwd, gs.gru_scan_fwd_plain, (xi, keep, h0, w_h, b_hn), gru_fwd_bound_ms),
            ("gru_scan_bwd", gs.gru_scan_bwd, gs.gru_scan_bwd_plain, (*res, g_y, g_hT), gru_bwd_bound_ms),
        ):
            k_ms = cuda_time_ms(lambda: kernel(*args), 50)
            p_ms = cuda_time_ms(lambda: plain(*args), 3, warmup=1)
            b_ms, b_by = bound(*shape)
            timings[f"{name}_T{shape[0]}_B{shape[1]}"] = (k_ms, p_ms, b_ms, b_by)
            print(json.dumps({"timing": name, "shape": dict(zip("TBH", shape)), "ms": k_ms, "plain_ms": p_ms,
                              "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}))
    # a yardstick, not library_ms: cuDNN's GRU has no resets and does its own
    # input projection, and the port never calls it
    for T, B, H in (GRU_SHAPES[0], GRU_VDN_TIMED[0]):
        cudnn_gru = torch.nn.GRU(H, H).to(dev)
        x_seq = torch.randn(T, B, H, device=dev)
        h_init = torch.randn(1, B, H, device=dev)
        with torch.no_grad():
            c_fwd = cuda_time_ms(lambda: cudnn_gru(x_seq, h_init), 50)
        x_grad = x_seq.clone().requires_grad_(True)

        def cudnn_fwd_bwd():
            ys, h_last = cudnn_gru(x_grad, h_init)
            (ys.sum() + h_last.sum()).backward()

        c_fb = cuda_time_ms(cudnn_fwd_bwd, 50)
        print(json.dumps({"timing": "torch.nn.GRU (cuDNN)", "shape": {"T": T, "B": B, "H": H},
                          "cudnn_gru_ms": {"fwd": c_fwd, "fwd_bwd": c_fb}}))

    aw, cw, stf, sti = pend_inputs[(32, 64, 256)]
    k_ms = cuda_time_ms(lambda: pr.pendulum_ac_rollout(3, 0.5, aw, cw, stf, sti, 32), 50)
    p_ms = cuda_time_ms(lambda: pr.pendulum_rollout_plain(3, 0.5, aw, cw, stf, sti, 32), 3, warmup=1)
    b_ms, b_by = pendulum_bound_ms(32, 64, 256)
    timings["pendulum_ac_rollout"] = (k_ms, p_ms, b_ms, b_by)
    print(json.dumps({"timing": "pendulum_ac_rollout", "shape": {"T": 32, "B": 64, "H": 256}, "ms": k_ms,
                      "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}))

    qv = eps_inputs[EPS_GREEDY_SHAPES[0]]
    k_ms = cuda_time_ms(lambda: eg.eps_greedy(3, qv, 0.1), 200)
    p_ms = cuda_time_ms(lambda: eg.eps_greedy_plain(3, qv, 0.1), 20)
    a_ms = cuda_time_ms(lambda: torch.argmax(qv, -1), 200)
    b_ms, b_by = eps_greedy_bound_ms(*EPS_GREEDY_SHAPES[0])
    timings["eps_greedy"] = (k_ms, p_ms, b_ms, b_by)
    # torch.argmax computes only the greedy half, so it is no library time for the kernel
    print(json.dumps({"timing": "eps_greedy", "shape": dict(zip("EA", EPS_GREEDY_SHAPES[0])), "ms": k_ms,
                      "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "argmax_ms": a_ms, "library_ms": None}))

    # ---- 8. the kernel table -----------------------------------------------------
    # launches: each kernel's count from the run of its slice's path (the
    # lambda returns' from the Asterix run, their closure form's and the GRU
    # scan's from the newest slice that runs them, VDN on Spread, timed at
    # its shapes; the Pendulum rollout's from the Pendulum run, eps_greedy's
    # from Craftax)
    kernels = []
    for name, src, replaces, key, launches in (
        ("lambda_returns", "purejaxql_torch/csrc/lambda_returns.cu",
         "purejaxql_tpu/ops/pallas_returns.py:26", "lambda_returns_32x128", launches_as),
        ("cartpole_rollout", "purejaxql_torch/csrc/cartpole_rollout.cu",
         "purejaxql_tpu/ops/pallas_rollout.py:465", "cartpole_rollout_B32", launches_cp),
        ("breakout_rollout", "purejaxql_torch/csrc/breakout_rollout.cu",
         "purejaxql_tpu/ops/pallas_rollout.py:195", "breakout_rollout", launches_bo),
        ("asterix_rollout", "purejaxql_torch/csrc/asterix_rollout.cu",
         "purejaxql_tpu/ops/pallas_rollout.py:693", "asterix_rollout", launches_as),
        ("freeway_rollout", "purejaxql_torch/csrc/freeway_rollout.cu",
         "purejaxql_tpu/ops/pallas_rollout.py:1039", "freeway_rollout", short_launches["freeway_rollout"]),
        ("space_invaders_rollout", "purejaxql_torch/csrc/space_invaders_rollout.cu",
         "purejaxql_tpu/ops/pallas_rollout.py:1276", "space_invaders_rollout",
         short_launches["space_invaders_rollout"]),
        ("seaquest_rollout", "purejaxql_torch/csrc/seaquest_rollout.cu",
         "purejaxql_tpu/ops/pallas_rollout.py:1689", "seaquest_rollout", launches_sq),
        ("gru_scan_fwd", "purejaxql_torch/csrc/gru_scan_fwd.cu",
         "purejaxql_tpu/ops/fast_rnn.py:224", "gru_scan_fwd_T29_B48", launches_vdn),
        ("gru_scan_bwd", "purejaxql_torch/csrc/gru_scan_bwd.cu",
         "purejaxql_tpu/ops/fast_rnn.py:248", "gru_scan_bwd_T29_B48", launches_vdn),
        ("pendulum_ac_rollout", "purejaxql_torch/csrc/pendulum_ac_rollout.cu",
         "purejaxql_tpu/ops/pallas_rollout.py:2135", "pendulum_ac_rollout", launches_pd),
        ("eps_greedy", "purejaxql_torch/csrc/eps_greedy.cu",
         "purejaxql_tpu/ops/pallas_explore.py:26", "eps_greedy", launches_cx),
        ("lambda_returns_closure", "purejaxql_torch/csrc/lambda_returns.cu",
         "purejaxql_tpu/ops/pallas_returns.py:26", "lambda_returns_closure_28x16", launches_vdn),
    ):
        k_ms, p_ms, b_ms, b_by = timings[key]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errors[name], "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s wall in all, the build included "
          f"(recorded with the VDN phase: {RECORDED_WALL_S} s)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
