#!/usr/bin/env python3
"""Where the time of a full-width training run of the port goes, on one GPU.

    python scripts/profile_torch_train.py [--steps 200000] [--profile-updates 5]
    python scripts/profile_torch_train.py --alg pqn_minatar --steps 500000   # Asterix
    python scripts/profile_torch_train.py --alg pqn_minatar --env Breakout-MinAtar --steps 500000
    python scripts/profile_torch_train.py --alg pqn_minatar --env Freeway-MinAtar --steps 65536
    python scripts/profile_torch_train.py --alg pqn_minatar --env Seaquest-MinAtar --steps 500000
    python scripts/profile_torch_train.py --alg pqn_rnn_memory_chain --steps 100000 --set TEST_NUM_STEPS=64
    python scripts/profile_torch_train.py --alg pqn_rnn_memory_chain --steps 100000 \
        --set TEST_NUM_STEPS=64 --set ALG_NAME=pqn            # the FF trainer on the same config
    python scripts/profile_torch_train.py --alg pqn_pendulum --steps 400000    # actor-critic
    python scripts/profile_torch_train.py --alg pqn_locomotion --steps 1000000   # Hopper, unfused
    python scripts/profile_torch_train.py --alg pqn_manipulation --steps 1000000  # Pusher, unfused
    python scripts/profile_torch_train.py --alg pqn_craftax --steps 524288 --profile-updates 64
    python scripts/profile_torch_train.py --alg pqn_craftax --steps 524288 --profile-updates 64 \
        --set PARITY=strict --set EXPLORATION_KERNEL=pallas     # the strict Craftax program
    python scripts/profile_torch_train.py --alg pqn_craftax --steps 524288 --set BF16_COMPUTE=True
    python scripts/profile_torch_train.py --alg pqn_vdn_spread --steps 1000000   # VDN, 3 agents
    python scripts/profile_torch_train.py --alg pqn_rnn_craftax --steps 1048576 --profile-updates 2
    python scripts/profile_torch_train.py --alg pqn_craftax --steps 262144 --profile-updates 64 \
        --set NUM_SEEDS=4                                      # 4 seeds as one program (aggregate rate)
    python scripts/profile_torch_train.py --alg pqn_host_minatar --env Pong-EH --steps 131072 \
        --profile-updates 2 --set CNN_TRUNK=nature             # the host pool, sync
    python scripts/profile_torch_train.py --alg pqn_host_minatar --env Pong-EH --steps 131072 \
        --profile-updates 2 --set CNN_TRUNK=nature --set ASYNC_ENVS=True   # lag-1, no phases

Two measurements of the config at its YAML's widths (pqn_cartpole: H 256,
32 envs x 64 steps, 16 minibatches x 4 epochs, greedy eval 128 envs x 500
steps; pqn_minatar: the MinAtar CNN, 128 envs x 32 steps, 32 minibatches x
2 epochs, greedy eval 128 envs x up to 1000 steps; pqn_rnn_*: the GRU
network, FAST_BPTT and PALLAS_BPTT on, the window of MEMORY_WINDOW +
NUM_STEPS steps; pqn_pendulum: actor and two critics H 256, 64 envs x 32
steps, 8 minibatches x 4 epochs, greedy eval 64 envs x 200 steps every 10 %;
pqn_reacher, pqn_dm_suite, pqn_locomotion, pqn_manipulation: the same
trainer unfused on their envs, with the YAMLs' widths and normalizers;
pqn_craftax: Forager, H 1024 x 4 with an input BatchRenorm, 1024 envs x 1
step, resets at ratio 16, 1-step TD on one minibatch, no eval; by the cuda
policy the fast program: the reset bank, FAST_TARGETS, SKIP_NOOP_PERMUTE;
with PARITY=strict and EXPLORATION_KERNEL=pallas the strict one: optimistic
resets, the concat 1-step TD, a permuted minibatch; pqn_vdn_*: one GRU
network shared by the agents, FAST_BPTT and PALLAS_BPTT on;
pqn_rnn_craftax: Forager, an LSTM H 512 after one dense layer, 1024 envs x
128 steps, 4 x 4 grad steps of BPTT over the window, by the cuda policy
FAST_BPTT, the epsilon-greedy kernel and the reset bank; pqn_host_minatar:
the C++ host pool, 128 + 16 test envs x 32 steps, 32 minibatches x 2
epochs, by the cuda policy the epsilon-greedy kernel):

1. phase wall times over a whole run: each phase (fused rollout, Log replay,
   lambda targets, minibatch steps; for the recurrent trainer the rollouts,
   the minibatch steps and, inside them, the train-mode forward, the
   closure-form targets (the returns kernel's wrapper,
   ``ops.lambda_returns.lambda_returns_closure``, as the trainer calls it)
   and the GRU scan kernels; for the actor-critic
   trainer the fused rollout, the LogVec replay, the lambda targets, the
   critic step, the actor step and the eval's episode sums, and unfused
   (every env but Pendulum) the wrapped env's step split into training and
   eval calls by their batch, the raw env's ``step_env`` inside it (the
   Hopper's and Walker's 16 substeps) and the greedy eval; for pqn_craftax
   the env step of the reset wrapper (the bank's or the optimistic one) and,
   inside it, the Forager step, the worldgen (``reset_env``: the optimistic
   wrapper's 64 fresh worlds a step, the bank's 64 a refresh burst), the
   bank's refresh bursts and its serve (gather, unpack, scatter), the
   epsilon-greedy kernel and the 1-step-TD minibatch step, concat or
   FAST_TARGETS, in float32 or, with BF16_COMPUTE, in bfloat16; for the VDN
   trainer the random-policy prefill, the training rollouts, the greedy
   eval rollouts, the minibatch steps and, inside them, the train-mode
   forward, the VDN targets (the closure returns kernel) and the GRU scan
   kernels; for pqn_rnn_craftax also, inside the rollouts, the reset
   wrapper's env step, the Forager step, the worldgen, the bank's bursts
   and serve and the epsilon-greedy kernel, and inside the grad steps' forward
   the LSTM loop, ``ops.fast_rnn.lstm_layer_scan``; for pqn_host the
   rollouts, inside them the pool's ``step_into`` (host C++) and the
   epsilon-greedy kernel, and the learn updates, inside them the closure
   returns and the minibatch steps; with ASYNC_ENVS no phase is timed, as
   the rollouts run in a worker thread beside the learn phase) is wrapped with a device
   synchronize before and after, so the top-level phases add up to the
   run's wall time (the syncs cost a little overlap, which the total shows;
   the inner phases' syncs lengthen the minibatch steps they sit in); a
   rollout's calls are split into training and eval calls (those at
   EPS_TEST, or at noise 0 for the actor-critic trainer), and the eval's
   share of the wall is printed;
2. the device's busy share: torch.profiler over a short run without eval,
   summed kernel time over the wall time of the profiled run.

Every kernel is built before the first measurement (the build is printed
apart), so no phase pays a compile. Prints one JSON object.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ROLLOUTS = (
    "cartpole_rollout", "asterix_rollout", "breakout_rollout", "freeway_rollout",
    "space_invaders_rollout", "seaquest_rollout",
)


def main() -> int:
    import torch

    from purejaxql_torch.algo import exploration, pqn, pqn_ac, pqn_host, pqn_rnn, pqn_vdn
    from purejaxql_torch.envs.hostpool import HostEnvPool
    from purejaxql_torch.core.config import compose
    from purejaxql_torch.envs import wrappers
    from purejaxql_torch.envs.gridworld.forager import Forager
    from purejaxql_torch.ops import build, fast_rnn, gru_scan

    ap = argparse.ArgumentParser()
    ap.add_argument("--alg", default="pqn_cartpole")
    ap.add_argument("--env", default=None, help="ENV_NAME (default: the YAML's)")
    ap.add_argument("--steps", type=int, default=200_000)
    ap.add_argument("--profile-updates", type=int, default=5)
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="a config override, repeatable (e.g. ALG_NAME=pqn)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()

    t_build = time.perf_counter()
    built = build.build(sorted(p.stem for p in build.CSRC_DIR.glob("*.cu")))
    build_s = time.perf_counter() - t_build

    # ---- 1. phase wall times ------------------------------------------------
    env = ([f"ENV_NAME={args.env}"] if args.env else []) + args.set
    config = compose(
        alg=args.alg,
        overrides=[f"TOTAL_TIMESTEPS={args.steps}", f"TOTAL_TIMESTEPS_DECAY={args.steps}", *env],
    )
    # a rollout kernel serves training and the eval chunks; the eval's calls
    # are those at EPS_TEST, below every training epsilon (>= EPS_FINISH), or
    # for the actor-critic trainer at noise 0, below every training noise
    actor_critic = config["ALG_NAME"] in ("pqn_ac", "pqn_playground")
    host = config["ALG_NAME"] == "pqn_host"  # its eval envs ride in the training rollout
    eval_eps, floor = (0.0, config["NOISE_FINISH"]) if actor_critic else (config.get("EPS_TEST"), config["EPS_FINISH"])
    if not host and not eval_eps < floor:
        raise SystemExit("the eval's epsilon (noise) must be below the training one to tell their calls apart")
    totals = defaultdict(float)
    counts = defaultdict(int)

    vdn = str(config["ALG_NAME"]).startswith("pqn_vdn")
    prefill_len = config.get("MEMORY_WINDOW", 0) + config["NUM_STEPS"]

    def timed(name, fn, eps_arg=None):
        # wraps() copies a kernel wrapper's launch counter, which the wrapped
        # function then increments through its module's name for it
        @functools.wraps(fn)
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            if isinstance(eps_arg, tuple):  # ("batch", the action's argument index)
                key = f"{name}_{'train' if a[eps_arg[1]].shape[0] == config['NUM_ENVS'] else 'eval'}"
            elif eps_arg is not None:
                phase = "eval" if a[eps_arg] == eval_eps else "train"
                # the VDN prefill: MEMORY_WINDOW + NUM_STEPS steps at epsilon 1
                if vdn and phase == "train" and a[eps_arg + 1] == prefill_len != config["NUM_STEPS"]:
                    phase = "prefill"
                key = f"{name}_{phase}"
            else:
                key = name
            totals[key] += time.perf_counter() - t0
            counts[key] += 1
            return out

        return wrapper

    recurrent = str(config["ALG_NAME"]).startswith("pqn_rnn")
    trainer = pqn_rnn if recurrent else pqn_vdn if vdn else pqn_ac if actor_critic else pqn_host if host else pqn
    make_train = (pqn_host.make_train_async if host and config.get("ASYNC_ENVS", False) else trainer.make_train)
    if host:  # a worker thread overlaps the async trainer's phases: none timed
        patches = [] if config.get("ASYNC_ENVS", False) else [
            (pqn_host, "host_rollout", None), (HostEnvPool, "step_into", None), (exploration, "eps_greedy", None),
            (pqn_host, "learn_update", None), (pqn_host, "lambda_returns_closure", None),
            (pqn_host, "learn_minibatch", None)]
    elif config["ALG_NAME"] == "pqn_craftax":  # the wrapper's env step, and its parts inside it
        patches = [(wrappers.OptimisticResetVecEnv, "step", None), (wrappers.BankedResetVecEnv, "step", None),
                   (Forager, "step_env", None), (Forager, "reset_env", None),
                   (wrappers.BankedResetVecEnv, "refresh", None), (wrappers, "serve_resets", None),
                   (exploration, "eps_greedy", None), (pqn, "learn_minibatch_td", None),
                   (pqn, "learn_minibatch_fast_td", None)]
    elif actor_critic:  # (module, name, the noise's argument index)
        patches = [(pqn_ac, "fused_pendulum_rollout", 1), (pqn_ac, "eval_episode_metrics", None)]
        patches += [(pqn_ac, n, None) for n in ("log_vec_replay", "lambda_returns", "critic_step", "actor_step")]
        if not config.get("FUSED_ROLLOUT", False):  # the wrapped env's step and the raw env's, by batch
            _, raw_env, *_ = pqn_ac.build_ac_env(config)
            outer = (wrappers.NormalizeVecObservation if config.get("NORMALIZE_OBS") else
                     wrappers.NormalizeVecReward if config.get("NORMALIZE_REWARD") else wrappers.ClipAction)
            patches += [(outer, "step", ("batch", 3)), (type(raw_env), "step_env", ("batch", 2)),
                        (pqn_ac, "greedy_eval", None)]
            if config["NUM_ENVS"] == config.get("TEST_NUM_ENVS", config["NUM_ENVS"]):
                raise SystemExit("the training and eval batches must differ to tell their env steps apart")
    elif vdn:  # (module, name, the epsilon's argument index)
        patches = [(pqn_vdn, "vdn_rollout", 4), (pqn_vdn, "learn_minibatch", None),
                   (pqn_vdn, "rnn_train_q_values", None), (pqn_vdn, "vdn_targets", None),
                   (gru_scan, "gru_scan_fwd", None), (gru_scan, "gru_scan_bwd", None)]
    elif recurrent:  # (module, name, the epsilon's argument index)
        patches = [(pqn_rnn, "rnn_rollout", 5), (pqn_rnn, "learn_minibatch", None),
                   (pqn_rnn, "rnn_train_q_values", None), (pqn_rnn, "lambda_returns_closure", None),
                   (gru_scan, "gru_scan_fwd", None), (gru_scan, "gru_scan_bwd", None),
                   (fast_rnn, "lstm_layer_scan", None), (exploration, "eps_greedy", None)]
        if "Craftax" in config["ENV_NAME"]:  # the env step inside the rollouts, and its parts
            patches += [(wrappers.OptimisticResetVecEnv, "step", None), (wrappers.BankedResetVecEnv, "step", None),
                        (Forager, "step_env", None), (Forager, "reset_env", None),
                        (wrappers.BankedResetVecEnv, "refresh", None), (wrappers, "serve_resets", None)]
    else:
        patches = [(pqn, n, 1) for n in ROLLOUTS]
        patches += [(pqn, n, None) for n in ("log_replay", "lambda_returns", "learn_minibatch")]
    originals = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, eps_arg in patches:
        setattr(mod, name, timed(name, getattr(mod, name), eps_arg))
    train = make_train(config)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for mod, name, fn in originals:
        setattr(mod, name, fn)
    ts = out["runner_state"][0]
    ts = ts["actor"] if actor_critic else ts
    phases = {k: {"s": v, "calls": counts[k]} for k, v in totals.items()}
    inner = ("rnn_train_q_values", "lambda_returns_closure", "vdn_targets", "gru_scan_fwd", "gru_scan_bwd", "step_env",
             "reset_env", "refresh", "serve_resets", "lstm_layer_scan", "step_env_train", "step_env_eval", "step_eval")
    if recurrent:  # the epsilon-greedy kernel and the env step run inside the rollouts
        inner += ("eps_greedy", "step")
    if host:
        inner += ("step_into", "eps_greedy", "learn_minibatch")
    accounted = sum(v for k, v in totals.items() if k not in inner)

    # ---- 2. device busy share over a short run without eval -----------------
    n = args.profile_updates
    per_update = config["NUM_STEPS"] * config["NUM_ENVS"]
    pconfig = compose(
        alg=args.alg,
        overrides=[f"TOTAL_TIMESTEPS={n * per_update}", f"TOTAL_TIMESTEPS_DECAY={n * per_update}",
                   "TEST_DURING_TRAINING=False", *env],
    )
    ptrain = make_train(pconfig)
    ptrain()  # warm-up: kernel build and load, allocator
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        ptrain()
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t1
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    device_us = sum(e.self_device_time_total for e in events)
    launches = sum(e.count for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    result = {
        "card": card,
        "build": {"s": build_s, "sources_compiled": sorted(built)},
        "config": {"alg": args.alg, "env": config["ENV_NAME"], "set": args.set,
                   "policy": {k: config.get(k) for k in ("FUSED_ROLLOUT", "EXPLORATION_KERNEL", "FAST_TARGETS",
                                                         "SKIP_NOOP_PERMUTE", "RESET_BANK", "BF16_COMPUTE",
                                                         "FAST_BPTT", "PALLAS_BPTT", "ASYNC_ENVS",
                                                         "CNN_TRUNK")}},
        "run": {
            "env_steps": ts.timesteps, "wall_s": wall, "env_steps_per_s": ts.timesteps / wall,
            # NUM_SEEDS as one program: a seed's steps times the seeds, as the CLI prints it
            "seeds": config.get("NUM_SEEDS", 1),
            "aggregate_env_steps_per_s": config.get("NUM_SEEDS", 1) * ts.timesteps / wall,
            "phases_synced": phases, "unaccounted_s": wall - accounted,
            "eval_share_of_wall": sum(v for k, v in totals.items() if "eval" in k and k not in inner) / wall,
        },
        "profile": {
            "updates": n, "wall_s": pwall, "device_busy_s": device_us / 1e6,
            "device_busy_share": device_us / 1e6 / pwall,
            "device_ops_per_update": launches / n,
            "top_device_ops": [
                {"name": e.key[:60], "ms": e.self_device_time_total / 1e3, "count": e.count} for e in top
            ],
        },
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
