#!/usr/bin/env python3
"""Drive the PyTorch port (purejaxql_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, one GPU

Phases, each ending the run with a non-zero exit if it fails:

1. identify the card (nvidia-smi name and power limit, torch/CUDA/nvcc);
2. build the CUDA kernels under purejaxql_torch/csrc/ (one nvcc each, in
   parallel) into build/purejaxql_torch/;
3. hold each kernel against its plain PyTorch twin on the card, at the
   trainer's shapes;
4. check the rollout kernel's random stream by its statistics;
5. train pqn_cartpole at full width (H 256, 32 envs x 64 steps, 16
   minibatches x 4 epochs, greedy eval 128 envs x 500 steps) for 200k env
   steps through the CLI's entry point, with the launch counters zeroed just
   before and read just after, and check that it learned;
6. time each kernel and its twin with CUDA events at the trainer's shapes;
7. print the kernel table as one JSON line;
8. print {"ok": true, "device": {...}} as the last line.

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


def lambda_bound_ms(T: int, E: int):
    nbytes = 4 * (E + 3 * T * E) + 4 * T * E
    flops = 10 * T * E
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def rollout_bound_ms(T: int, B: int, H: int, A: int):
    weights = 4 * (4 * H + 6 * H + H * H + A * H + A)
    nbytes = weights + 4 * 5 * B + 4 * T * B * (4 + 3 + A) + 4 * 9 * B
    # per env step: two dense layers and the head (2 flops per MAC, plus
    # biases), two LayerNorms with relu (~8 per unit), physics (~40)
    per_step = 2 * 4 * H + 2 * H * H + 2 * A * H + 2 * H + A + 16 * H + 40
    flops = T * B * per_step
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs one GPU")
    try:
        from purejaxql_torch import cli
        from purejaxql_torch.core.config import compose
        from purejaxql_torch.models.qnet import QNetwork
        from purejaxql_torch.ops import build
        from purejaxql_torch.ops import cartpole_rollout as cr
        from purejaxql_torch.ops import lambda_returns as lr
    except ImportError as e:
        fail(f"cannot import purejaxql_torch ({e}): run from the root of a checkout")
    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = os.path.dirname(os.path.abspath(__file__))

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
        per_source = build.build(["lambda_returns", "cartpole_rollout"])
    except RuntimeError as e:
        fail(f"build failed: {e}")
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s wall, per source {json.dumps(per_source)}")
    for name in ("lambda_returns", "cartpole_rollout"):
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
    for T, E in ((64, 32), (64, 200)):
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
        errors.setdefault("lambda_returns", err)
        lam_inputs[(T, E)] = (lastq, rew, done, maxq)

    # ---- 3b. rollout vs plain, PRNG off and on --------------------------------
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
    print("different seeds give different streams")

    # ---- 5. train pqn_cartpole at full width through the kernels ---------------
    save_path = os.path.join(root, "build", "chip_smoke_models")
    jsonl = os.path.join(save_path, "train.jsonl")
    if os.path.exists(jsonl):
        os.remove(jsonl)
    config = compose(
        alg="pqn_cartpole",
        overrides=[
            f"TOTAL_TIMESTEPS={TRAIN_STEPS}", f"TOTAL_TIMESTEPS_DECAY={TRAIN_STEPS}",
            f"SAVE_PATH={save_path}", f"LOG_JSONL={jsonl}",
        ],
    )
    check(config["FUSED_ROLLOUT"] and config["EVAL_EARLY_EXIT"], "the cuda policy did not turn on FUSED_ROLLOUT")
    lr.lambda_returns.launches = 0
    cr.cartpole_rollout.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = cli.single_run(config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {
        "lambda_returns": lr.lambda_returns.launches,
        "cartpole_rollout": cr.cartpole_rollout.launches,
    }
    train_state = outs["runner_state"][0]
    m = {k: v.cpu().numpy() for k, v in outs["metrics"].items()}
    n_updates = TRAIN_STEPS // 64 // 32
    rets = m["returned_episode_returns"]
    last10 = float(rets[-10:].mean())
    steps_per_s = train_state.timesteps / wall
    print(
        f"train: {train_state.timesteps} env steps in {wall:.2f} s wall "
        f"({steps_per_s:.0f} env-steps/s, eval included); launches {launches}; "
        f"mean of last 10 returned_episode_returns {last10:.1f}; "
        f"last greedy eval return {float(m['test/returned_episode_returns'][-1]):.1f}"
    )
    check(all(p.device.type == "cuda" for p in train_state.network.parameters()), "a parameter is not on cuda")
    check(launches["lambda_returns"] == n_updates, f"lambda_returns launched {launches['lambda_returns']} times, expected {n_updates}")
    check(launches["cartpole_rollout"] > n_updates, f"cartpole_rollout launched {launches['cartpole_rollout']} times: no eval chunks")
    check(train_state.timesteps == n_updates * 64 * 32, "wrong env-step count")
    check(all(np.isfinite(m[k]).all() for k in ("td_loss", "qvals", "returned_episode_returns")), "non-finite metrics")
    check(last10 > 100, f"did not learn: mean of last 10 returned_episode_returns {last10}")
    from purejaxql_torch.core.checkpoint import load_params

    saved = load_params(os.path.join(save_path, "CartPole-v1", "pqn_CartPole-v1_seed0.safetensors"))
    check(tuple(saved["Dense_1"]["kernel"].shape) == (256, 256), "saved params have the wrong shape")

    # ---- 6. time the kernels at the trainer's shapes ---------------------------
    timings = {}
    lastq, rew, done, maxq = lam_inputs[(64, 32)]
    k_ms = cuda_time_ms(lambda: lr.lambda_returns(lastq, rew, done, maxq, 0.99, 0.95), 200)
    p_ms = cuda_time_ms(lambda: lr.lambda_returns_plain(lastq, rew, done, maxq, 0.99, 0.95), 20)
    b_ms, b_by = lambda_bound_ms(64, 32)
    timings["lambda_returns"] = (k_ms, p_ms, b_ms, b_by)
    print(json.dumps({"timing": "lambda_returns", "shape": [64, 32], "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by}))
    for B in (32, 128):
        stf0, sti0 = reset_states(B, 11)
        k_ms = cuda_time_ms(lambda: cr.cartpole_rollout(3, 0.1, weights, stf0, sti0, 64), 20)
        p_ms = cuda_time_ms(lambda: cr.cartpole_rollout_plain(3, 0.1, weights, stf0, sti0, 64), 3, warmup=1)
        b_ms, b_by = rollout_bound_ms(64, B, H, A)
        timings[f"cartpole_rollout_B{B}"] = (k_ms, p_ms, b_ms, b_by)
        print(json.dumps({"timing": "cartpole_rollout", "shape": {"T": 64, "B": B, "H": H}, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by}))

    # ---- 7. the kernel table -----------------------------------------------------
    kernels = []
    for name, route_src, replaces, key in (
        ("lambda_returns", "purejaxql_torch/csrc/lambda_returns.cu",
         "purejaxql_tpu/ops/pallas_returns.py:26", "lambda_returns"),
        ("cartpole_rollout", "purejaxql_torch/csrc/cartpole_rollout.cu",
         "purejaxql_tpu/ops/pallas_rollout.py:465", "cartpole_rollout_B32"),
    ):
        k_ms, p_ms, b_ms, b_by = timings[key]
        kernels.append({
            "name": name, "route": "cuda", "source": route_src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errors[name], "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })
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
