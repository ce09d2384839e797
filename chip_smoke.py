#!/usr/bin/env python3
"""Drive the PyTorch port (purejaxql_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, one GPU

Phases, each ending the run with a non-zero exit if it fails:

1. identify the card (nvidia-smi name and power limit, torch/CUDA/nvcc);
2. build the CUDA kernels under purejaxql_torch/csrc/ (one nvcc each, in
   parallel) into build/purejaxql_torch/;
3. hold each kernel against its plain PyTorch twin on the card, at the
   trainers' shapes: lambda returns, the CartPole rollout, the Breakout
   rollout (PRNG off and on);
4. check the rollout kernels' random streams by their statistics;
5. train pqn_cartpole at full width (H 256, 32 envs x 64 steps, 16
   minibatches x 4 epochs, greedy eval 128 envs x 500 steps) for 200k env
   steps through the CLI's entry point, with the launch counters zeroed just
   before and read just after, and check that it learned;
6. train pqn_minatar on Breakout-MinAtar at full width (the MinAtar CNN,
   128 envs x 32 steps, 32 minibatches x 2 epochs, greedy eval 128 envs x
   up to 1000 steps) for 500k env steps the same way, and check that it
   learned;
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
KERNELS = ("lambda_returns", "cartpole_rollout", "breakout_rollout")


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


def breakout_bound_ms(T: int, B: int, H: int, A: int):
    taps, flat, obs = 36, 1024, 400
    weights = 4 * (taps * 16 + 3 * 16 + H * flat + 3 * H + A * H + A)
    state = 4 * (8 + 100) * B  # state matrix and brick map, in and out
    nbytes = weights + 2 * state + 4 * T * B * (obs + 3 + A) + 4 * B * obs
    # per env step: the conv (2 flops per MAC plus bias), the dense layer and
    # the head, two LayerNorms with relu (~8 per unit), the game (~50)
    per_step = (2 * taps + 1) * flat + 8 * flat + (2 * flat + 1) * H + 8 * H + (2 * H + 1) * A + 50
    return _bound(nbytes, T * B * per_step)


def train(cli, compose, alg: str, steps: int, save_path: str, counters, extra=()):
    """One full-width run through the CLI's entry point, with every launch
    counter zeroed just before it and read just after it. Returns (outputs,
    seconds, launches by kernel)."""
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
    check(config["FUSED_ROLLOUT"] and config["EVAL_EARLY_EXIT"],
          f"{alg}: the cuda policy did not turn on FUSED_ROLLOUT and EVAL_EARLY_EXIT")
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = cli.single_run(config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return outs, wall, {name: fn.launches for name, fn in counters.items()}


def check_run(name, outs, wall, launches, n_updates, steps_per_update, rollout, gate):
    """The checks both training runs share; returns the mean of the last 10
    returned_episode_returns."""
    import numpy as np

    train_state = outs["runner_state"][0]
    m = {k: v.cpu().numpy() for k, v in outs["metrics"].items()}
    last10 = float(m["returned_episode_returns"][-10:].mean())
    print(
        f"train {name}: {train_state.timesteps} env steps in {wall:.2f} s wall "
        f"({train_state.timesteps / wall:.0f} env-steps/s, eval included); launches {launches}; "
        f"mean of last 10 returned_episode_returns {last10:.2f}; "
        f"last greedy eval return {float(m['test/returned_episode_returns'][-1]):.2f}"
    )
    check(all(p.device.type == "cuda" for p in train_state.network.parameters()), f"{name}: a parameter is not on cuda")
    check(launches["lambda_returns"] == n_updates,
          f"{name}: lambda_returns launched {launches['lambda_returns']} times, expected {n_updates}")
    check(launches[rollout] > n_updates, f"{name}: {rollout} launched {launches[rollout]} times: no eval chunks")
    check(train_state.timesteps == n_updates * steps_per_update, f"{name}: wrong env-step count")
    check(all(np.isfinite(m[k]).all() for k in ("td_loss", "qvals", "returned_episode_returns")),
          f"{name}: non-finite metrics")
    check(last10 > gate, f"{name} did not learn: mean of last 10 returned_episode_returns {last10} <= {gate}")
    return last10


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs one GPU")
    try:
        from purejaxql_torch import cli
        from purejaxql_torch.core.checkpoint import load_params
        from purejaxql_torch.core.config import compose
        from purejaxql_torch.envs.minatar.breakout import start_state
        from purejaxql_torch.models.cnn import CNNQNetwork
        from purejaxql_torch.models.qnet import QNetwork
        from purejaxql_torch.ops import breakout_rollout as br
        from purejaxql_torch.ops import build
        from purejaxql_torch.ops import cartpole_rollout as cr
        from purejaxql_torch.ops import lambda_returns as lr
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
    bweights = br.breakout_weights(bnet)

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

    bnames = ("obs", "act", "rew", "done", "q", "final_obs", "st", "brick")
    st0, brick0 = breakout_states(BB, 3)
    q_err = 0.0
    for use_prng in (False, True):
        got = br.breakout_rollout(77, 0.1, bweights, st0, brick0, BT, use_prng=use_prng)
        want = br.breakout_rollout_plain(77, 0.1, bweights, st0, brick0, BT, use_prng=use_prng)
        torch.cuda.synchronize()
        g, w = dict(zip(bnames, got)), dict(zip(bnames, want))
        mism = (g["act"] != w["act"]).nonzero()
        if len(mism):
            t, b = mism[0].tolist()
            top2 = w["q"][t, b].topk(2).values
            fail(
                f"breakout_rollout prng={use_prng}: action differs first at t={t} env={b}; "
                f"plain q-gap there {(top2[0] - top2[1]).item():.3g}, kernel q {g['q'][t, b].tolist()} "
                f"plain q {w['q'][t, b].tolist()}"
            )
        for k in ("obs", "rew", "done", "final_obs", "st", "brick"):
            check(torch.equal(g[k], w[k]), f"breakout_rollout prng={use_prng}: {k} differs")
        err = (g["q"] - w["q"]).abs().max().item()
        n_done, n_rew = int(w["done"].sum()), int(w["rew"].sum())
        n_random = int((w["act"].long() != w["q"].argmax(-1)).sum())
        print(
            f"breakout_rollout B={BB} T={BT} prng={use_prng}: obs/actions/rewards/dones/state/bricks equal "
            f"({n_done} resets, {n_rew} bricks scored, {n_random} non-greedy actions), "
            f"max|q err| {err:.3g} (tolerance 1e-4)"
        )
        check(err <= 1e-4, f"breakout_rollout prng={use_prng}: q err {err} > 1e-4")
        check(n_done > 0, "breakout_rollout: no env reset in the comparison")
        q_err = max(q_err, err)
    errors["breakout_rollout"] = q_err

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
    bo_last10 = check_run("breakout", outs, wall, launches_bo, bo_updates, 32 * 128, "breakout_rollout", 3)
    check(launches_bo["cartpole_rollout"] == 0, "the Breakout run launched the CartPole kernel")
    bo_rate = outs["runner_state"][0].timesteps / wall
    saved = load_params(os.path.join(save_path, "Breakout-MinAtar", "pqn_Breakout-MinAtar_seed0.safetensors"))
    check(tuple(saved["CNN_0"]["Conv_0"]["kernel"].shape) == (3, 3, 4, 16), "saved conv kernel has the wrong shape")
    check(tuple(saved["CNN_0"]["Dense_0"]["kernel"].shape) == (1024, 128), "saved dense kernel has the wrong shape")
    print(json.dumps({"breakout_run": {"env_steps_per_s": bo_rate, "wall_s": wall, "last10_return": bo_last10,
                                       "launches": launches_bo, "card": card}}))

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
    k_ms = cuda_time_ms(lambda: br.breakout_rollout(3, 0.1, bweights, st0, brick0, BT), 50)
    p_ms = cuda_time_ms(lambda: br.breakout_rollout_plain(3, 0.1, bweights, st0, brick0, BT), 3, warmup=1)
    b_ms, b_by = breakout_bound_ms(BT, BB, BH, BA)
    timings["breakout_rollout"] = (k_ms, p_ms, b_ms, b_by)
    print(json.dumps({"timing": "breakout_rollout", "shape": {"T": BT, "B": BB, "H": BH}, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by}))

    # ---- 8. the kernel table -----------------------------------------------------
    # launches: each kernel's count from the run of its slice's path
    kernels = []
    for name, src, replaces, key, launches in (
        ("lambda_returns", "purejaxql_torch/csrc/lambda_returns.cu",
         "purejaxql_tpu/ops/pallas_returns.py:26", "lambda_returns_32x128", launches_bo),
        ("cartpole_rollout", "purejaxql_torch/csrc/cartpole_rollout.cu",
         "purejaxql_tpu/ops/pallas_rollout.py:465", "cartpole_rollout_B32", launches_cp),
        ("breakout_rollout", "purejaxql_torch/csrc/breakout_rollout.cu",
         "purejaxql_tpu/ops/pallas_rollout.py:195", "breakout_rollout", launches_bo),
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
