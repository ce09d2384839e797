#!/usr/bin/env python3
"""Drive the PyTorch port (purejaxql_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, one GPU

Phases, each ending the run with a non-zero exit if it fails:

1. identify the card (nvidia-smi name and power limit, torch/CUDA/nvcc);
2. build the CUDA kernels under purejaxql_torch/csrc/ (one nvcc each, in
   parallel) into build/purejaxql_torch/;
3. hold each kernel against its plain PyTorch twin on the card, at the
   trainers' shapes: lambda returns, the CartPole rollout, the Breakout,
   Asterix, Freeway, SpaceInvaders and Seaquest rollouts (PRNG off and on;
   Seaquest also at a shape that forces resets), the GRU
   scan's forward and backward kernels (and autograd through them), and the
   Pendulum actor-critic rollout (PRNG off and on, at the trainer's shape and
   at one that forces resets);
4. check the rollout kernels' random streams by their statistics (Seaquest:
   the coin, and one step of 8192 envs that fire, are shot at and spawn);
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
   128 envs x 64 steps) through the GRU scan kernels and check that it
   remembers; the FF trainer on the same config must not; then
   pqn_rnn_cartpole at full width for 16 updates;
6e. train pqn_pendulum at full width (actor and two critics H 256, 64 envs x
   32 steps, 8 minibatches x 4 epochs, greedy eval 64 envs x 200 steps every
   10 % of the run) for 400k env steps through the Pendulum kernel and check
   that its best greedy eval beats -500;
7. time each kernel and its twin with CUDA events at the trainers' shapes;
8. print the kernel table as one JSON line;
9. print {"ok": true, "device": {...}} as the last line.

It exits non-zero, printing no result, where no GPU is visible or where the
port's package is not beside it. What it builds and writes goes under build/.
"""

from __future__ import annotations

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
RNN_CARTPOLE_STEPS = 16 * 64 * 32  # 16 updates of pqn_rnn_cartpole
PENDULUM_STEPS = 400_000  # tests/test_pqn_ac.py::test_ac_learns_pendulum's length
# the best greedy eval return the Pendulum run must beat (the same test's
# gate; random play is about -1300)
PENDULUM_GATE = -500.0
# the Pendulum kernel at the trainer's shape (T, B, H, max_steps) and at one
# that forces resets
PENDULUM_SHAPES = ((32, 64, 256, 200), (40, 16, 64, 10))
# the last-3 mean greedy eval return on MemoryChain: above MEMORY_GATE for the
# recurrent trainer, below FF_GATE for the feedforward one
# (tests/test_pqn_rnn.py::test_rnn_solves_memory_task_ff_does_not)
MEMORY_GATE, FF_GATE = 0.8, 0.5
# the GRU scan at the trainers' shapes (T = MEMORY_WINDOW + NUM_STEPS, B =
# NUM_ENVS / NUM_MINIBATCHES, H) and one with more than one block
GRU_SHAPES = ((132, 2, 256), (68, 2, 256), (32, 16, 128))
# the mean of the last 10 training returns the Asterix run must beat:
# tests/test_torch_asterix.py::test_asterix_learns
ASTERIX_GATE = 0.8
# the same for Seaquest: tests/test_torch_seaquest.py::test_seaquest_learns
SEAQUEST_GATE = 0.2
KERNELS = (
    "lambda_returns", "cartpole_rollout", "breakout_rollout", "asterix_rollout",
    "freeway_rollout", "space_invaders_rollout", "seaquest_rollout", "gru_scan_fwd",
    "gru_scan_bwd", "pendulum_ac_rollout",
)
# the Breakout run and check as recorded on an H100 before its CNN moved into
# csrc/minatar_cnn.cuh (PERF.md): the last-10 mean return, the last greedy
# eval, the resets with the PRNG off
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
    ``policy`` must have been turned on by the config's cuda policy. Returns
    (outputs, seconds, launches by kernel)."""
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
    check(all(config.get(flag) is True for flag in policy),
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
    non-greedy actions)."""
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
    return err, n_done, rew, n_random


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs one GPU")
    try:
        from purejaxql_torch import cli
        from purejaxql_torch.core.checkpoint import load_params
        from purejaxql_torch.core.config import compose
        from purejaxql_torch.envs.classic.pendulum import PendulumParams
        from purejaxql_torch.envs.minatar.breakout import start_state
        from purejaxql_torch.models.cnn import CNNQNetwork
        from purejaxql_torch.models.qnet import QNetwork
        from purejaxql_torch.ops import asterix_rollout as ar
        from purejaxql_torch.ops import breakout_rollout as br
        from purejaxql_torch.ops import build
        from purejaxql_torch.ops import cartpole_rollout as cr
        from purejaxql_torch.ops import freeway_rollout as fr
        from purejaxql_torch.ops import gru_scan as gs
        from purejaxql_torch.ops import lambda_returns as lr
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
        "cartpole_rollout": cr.cartpole_rollout,
        "breakout_rollout": br.breakout_rollout,
        "asterix_rollout": ar.asterix_rollout,
        "freeway_rollout": fr.freeway_rollout,
        "space_invaders_rollout": sr.space_invaders_rollout,
        "seaquest_rollout": sq.seaquest_rollout,
        "gru_scan_fwd": gs.gru_scan_fwd,
        "gru_scan_bwd": gs.gru_scan_bwd,
        "pendulum_ac_rollout": pr.pendulum_ac_rollout,
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
        per_source = build.build(KERNELS)
    except RuntimeError as e:
        fail(f"build failed: {e}")
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s wall, per source {json.dumps(per_source)}")
    for name in KERNELS:
        log = build.library_path(name).with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")

    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(0)
    errors = {}

    # ---- 3a. lambda returns vs plain -----------------------------------------
    lam_inputs = {}
    for T, E in ((64, 32), (32, 128), (64, 200)):
        rew = torch.tensor(rng.randn(T, E).astype(np.float32), device=dev)
        done = torch.tensor((rng.rand(T, E) < 0.15).astype(np.float32), device=dev)
        maxq = torch.tensor(rng.randn(T, E).astype(np.float32), device=dev)
        lastq = torch.tensor(rng.randn(E).astype(np.float32), device=dev)
        got = lr.lambda_returns(lastq, rew, done, maxq, 0.99, 0.95)
        want = lr.lambda_returns_plain(lastq, rew, done, maxq, 0.99, 0.95)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        print(f"lambda_returns ({T},{E}): max|kernel - plain| = {err:.3g} (tolerance 1e-5)")
        check(err <= 1e-5, f"lambda_returns disagrees with its plain twin at ({T},{E}): {err}")
        errors["lambda_returns"] = max(errors.get("lambda_returns", 0.0), err)
        lam_inputs[(T, E)] = (lastq, rew, done, maxq)

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
        err, n_done, n_rew, n_random = compare_minatar(
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
            err, n_done, rew, n_random = compare_minatar(name, kernel, plain, gweights, gstates, BT, use_prng)
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
        err, n_done, rew, n_random = compare_minatar(
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

    # ---- 3e. GRU scan kernels vs plain, and autograd through them ---------------
    # forward within 1e-5; backward within 1e-4 absolute and relative: the
    # kernels sum the products in another order than the twins' matmuls
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
        print(
            f"gru_scan (T, B, H) = {shape} ({(shape[1] + 7) // 8} block(s)): forward max|err| {f_err:.3g} "
            f"(tolerance 1e-5); backward max|err| {b_err:.3g}, max |err| / (1e-4 + 1e-4 |plain|) "
            f"{b_rel:.3g} (must be <= 1); resets {int((keep == 0).sum())}"
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
    for pT, pB, pH, p_max in PENDULUM_SHAPES:
        (aw, cw), stf, sti = pendulum_inputs(pB, pH, pB, dev)
        pend_inputs[(pT, pB, pH)] = (aw, cw, stf, sti)
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
        f"breakout after the shared CNN header: last-10 mean {now[0]}, last eval {now[1]}, "
        f"{now[2]} resets in the PRNG-off check; recorded before the shared header {BREAKOUT_RECORD}: "
        f"{'equal' if now == BREAKOUT_RECORD else 'DIFFERENT'}"
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
    for name in ("gru_scan_fwd", "gru_scan_bwd"):
        check(launches_mc[name] == mc_grad_steps,
              f"memory_chain: {name} launched {launches_mc[name]} times, expected {mc_grad_steps}")
    others = {k: v for k, v in launches_mc.items() if not k.startswith("gru_scan") and v}
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
    check(launches_ff["lambda_returns"] == mc_updates and launches_ff["gru_scan_fwd"] == 0,
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
    for name in ("gru_scan_fwd", "gru_scan_bwd"):
        check(launches_rc[name] == 16 * 4 * 16, f"rnn cartpole: {name} launched {launches_rc[name]} times, expected 1024")
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

    # ---- 7. time the kernels at the trainers' shapes ---------------------------
    timings = {}
    for shape in ((64, 32), (32, 128)):
        lastq, rew, done, maxq = lam_inputs[shape]
        k_ms = cuda_time_ms(lambda: lr.lambda_returns(lastq, rew, done, maxq, 0.99, 0.95), 200)
        p_ms = cuda_time_ms(lambda: lr.lambda_returns_plain(lastq, rew, done, maxq, 0.99, 0.95), 20)
        b_ms, b_by = lambda_bound_ms(*shape)
        timings[f"lambda_returns_{shape[0]}x{shape[1]}"] = (k_ms, p_ms, b_ms, b_by)
        print(json.dumps({"timing": "lambda_returns", "shape": list(shape), "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by}))
    for B in (32, 128):
        stf0, sti0 = reset_states(B, 11)
        k_ms = cuda_time_ms(lambda: cr.cartpole_rollout(3, 0.1, weights, stf0, sti0, 64), 20)
        p_ms = cuda_time_ms(lambda: cr.cartpole_rollout_plain(3, 0.1, weights, stf0, sti0, 64), 3, warmup=1)
        b_ms, b_by = rollout_bound_ms(64, B, H, A)
        timings[f"cartpole_rollout_B{B}"] = (k_ms, p_ms, b_ms, b_by)
        print(json.dumps({"timing": "cartpole_rollout", "shape": {"T": 64, "B": B, "H": H}, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by}))
    game_inputs["breakout_rollout"] = (bweights, (st0, brick0))
    games["breakout_rollout"] = (br.breakout_rollout, br.breakout_rollout_plain, None, 4, BA, None)
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

    for shape in GRU_SHAPES[:2]:
        xi, keep, h0, w_h, b_hn, g_y, g_hT, res = gru_inputs_by_shape[shape]
        for name, kernel, plain, args, bound in (
            ("gru_scan_fwd", gs.gru_scan_fwd, gs.gru_scan_fwd_plain, (xi, keep, h0, w_h, b_hn), gru_fwd_bound_ms),
            ("gru_scan_bwd", gs.gru_scan_bwd, gs.gru_scan_bwd_plain, (*res, g_y, g_hT), gru_bwd_bound_ms),
        ):
            k_ms = cuda_time_ms(lambda: kernel(*args), 50)
            p_ms = cuda_time_ms(lambda: plain(*args), 3, warmup=1)
            b_ms, b_by = bound(*shape)
            timings[f"{name}_T{shape[0]}"] = (k_ms, p_ms, b_ms, b_by)
            print(json.dumps({"timing": name, "shape": dict(zip("TBH", shape)), "ms": k_ms, "plain_ms": p_ms,
                              "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}))

    aw, cw, stf, sti = pend_inputs[(32, 64, 256)]
    k_ms = cuda_time_ms(lambda: pr.pendulum_ac_rollout(3, 0.5, aw, cw, stf, sti, 32), 50)
    p_ms = cuda_time_ms(lambda: pr.pendulum_rollout_plain(3, 0.5, aw, cw, stf, sti, 32), 3, warmup=1)
    b_ms, b_by = pendulum_bound_ms(32, 64, 256)
    timings["pendulum_ac_rollout"] = (k_ms, p_ms, b_ms, b_by)
    print(json.dumps({"timing": "pendulum_ac_rollout", "shape": {"T": 32, "B": 64, "H": 256}, "ms": k_ms,
                      "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}))

    # ---- 8. the kernel table -----------------------------------------------------
    # launches: each kernel's count from the run of its slice's path (the
    # lambda returns' from the Asterix run, the GRU scan's from MemoryChain,
    # the Pendulum rollout's from the Pendulum run)
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
         "purejaxql_tpu/ops/fast_rnn.py:224", "gru_scan_fwd_T132", launches_mc),
        ("gru_scan_bwd", "purejaxql_torch/csrc/gru_scan_bwd.cu",
         "purejaxql_tpu/ops/fast_rnn.py:248", "gru_scan_bwd_T132", launches_mc),
        ("pendulum_ac_rollout", "purejaxql_torch/csrc/pendulum_ac_rollout.cu",
         "purejaxql_tpu/ops/pallas_rollout.py:2135", "pendulum_ac_rollout", launches_pd),
    ):
        k_ms, p_ms, b_ms, b_by = timings[key]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errors[name], "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s wall in all, the build included")
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
