"""CLI entry point: hydra-style UX over the port's config system.

    python -m purejaxql_torch.cli +alg=pqn_cartpole [KEY=val ...]
    python -m purejaxql_torch.cli +alg=pqn_rnn_memory_chain [KEY=val ...]
    python -m purejaxql_torch.cli +alg=pqn_pendulum [KEY=val ...]
    python -m purejaxql_torch.cli +alg=pqn_locomotion [KEY=val ...]
    python -m purejaxql_torch.cli +alg=pqn_craftax [KEY=val ...]
    python -m purejaxql_torch.cli +alg=pqn_vdn_spread [KEY=val ...]
    python -m purejaxql_torch.cli +alg=pqn_host_minatar [ASYNC_ENVS=True] [KEY=val ...]

The trainer is picked by the config's ALG_NAME: ``pqn`` and ``pqn_craftax``
(algo/pqn.py), ``pqn_rnn*`` (algo/pqn_rnn.py), ``pqn_vdn*``
(algo/pqn_vdn.py: ``pqn_vdn_{spread,skirmish,smax,kitchen,hanabi}``) or
``pqn_ac`` / ``pqn_playground`` (algo/pqn_ac.py) or ``pqn_host``
(algo/pqn_host.py: the C++ host env pool, ``make_train``, or with
ASYNC_ENVS ``make_train_async``). Runs on the GPU unless
DEVICE=cpu is given. Prints
"Training took ...", writes ``<SAVE_PATH>/<ENV_NAME>/<run>.safetensors``
(flax wire format; the actor-critic family's as one tree ``{"actor": ...,
"critic": ...}``, with NORMALIZE_OBS also ``"norm_stats": {"mean", "var"}``,
the training run's observation statistics) and ``<run>_config.yaml``, and
replays the metrics into the LOG_JSONL file (none with COLLECT_METRICS=False,
whose run returns none).

NUM_SEEDS=S > 1 (every trainer) trains S seeds as one program
(algo/seeds.py), prints the aggregate rate of all S seeds, writes one
``<run>_vmap{i}.safetensors`` a seed (the actor-critic family's with seed
i's own ``norm_stats``) and logs each seed's rows in turn, as
purejaxql_tpu/cli.py does; FUSED_ROLLOUT and ``pqn_host`` with several seeds
are refused here, as there. LOG_VIA_CALLBACK=True (with LOG_INTERVAL) logs
each update's rows as the run goes, through the FF, recurrent, VDN and
actor-critic trainers' callbacks, and replays nothing after it.

    python -m purejaxql_torch.cli +alg=pqn_cartpole TRAINER=stepwise CHECKPOINT_EVERY=4 \
        [RESUME_FROM=<path>] [CHECKPOINT_PATH=<path>]
    python -m purejaxql_torch.cli +alg=pqn_cartpole HYP_TUNE=True SWEEP_COUNT=8

TRAINER=stepwise runs the host-loop trainer over the staged API
(algo/stages.py), saving the full state (core/checkpoint.py:save_state) to
CHECKPOINT_PATH (default ``<SAVE_PATH or .>/<ENV_NAME>_state.safetensors``)
every CHECKPOINT_EVERY updates and at the end; RESUME_FROM continues a saved
state (either package's) up to NUM_UPDATES. HYP_TUNE=True runs a sweep
(utils/sweep.py): wandb's where it is installed, else a local random search
over SWEEP_SPACE, SWEEP_COUNT trials.

    torchrun --nproc_per_node N -m purejaxql_torch.cli +alg=pqn_cartpole [KEY=val ...]

``main`` joins the process group first (parallel/mesh.py:init_distributed,
a no-op without torchrun's variables). In a group of N > 1 ranks the FF,
recurrent, VDN and actor-critic trainers train one run sharded N ways
(parallel/spmd.py:make_train_spmd: NUM_ENVS global, each rank on its card
``cuda:{LOCAL_RANK}`` unless DEVICE says otherwise, one seed); only rank 0
logs, saves and writes checkpoints.
"""

from __future__ import annotations

import os
import sys
import time


def _select_make_train(config):
    """The trainer of the config's family, as purejaxql_tpu/cli.py:20-40,
    57-66 picks it: ``pqn`` / ``pqn_craftax``, ``pqn_rnn*``, ``pqn_vdn*``,
    ``pqn_ac`` / ``pqn_playground`` or ``pqn_host`` (with ASYNC_ENVS the
    lag-1 trainer)."""
    name = str(config.get("ALG_NAME", "pqn"))
    if name in ("pqn", "pqn_craftax"):
        from purejaxql_torch.algo.pqn import make_train
        return make_train
    if name.startswith("pqn_rnn"):
        from purejaxql_torch.algo.pqn_rnn import make_train
        return make_train
    if name.startswith("pqn_vdn"):
        from purejaxql_torch.algo.pqn_vdn import make_train
        return make_train
    if name in ("pqn_ac", "pqn_playground"):
        from purejaxql_torch.algo.pqn_ac import make_train
        return make_train
    if name == "pqn_host":
        from purejaxql_torch.algo import pqn_host
        return pqn_host.make_train_async if config.get("ASYNC_ENVS", False) else pqn_host.make_train
    raise SystemExit(f"Unknown ALG_NAME '{name}' (expected pqn / pqn_rnn / pqn_vdn / pqn_ac / pqn_host)")


def single_run(config):
    import torch
    import torch.distributed as dist

    from purejaxql_torch.algo.seeds import SINGLE_SEED_FAMILIES
    from purejaxql_torch.core.checkpoint import save_run
    from purejaxql_torch.parallel.mesh import is_main_process
    from purejaxql_torch.utils.logging import make_logger

    logger = make_logger(config)
    if config.get("TRAINER", "fused") == "stepwise":
        return _stepwise_run(config, logger)
    make_train = _select_make_train(config)
    single_seed = SINGLE_SEED_FAMILIES.get(str(config.get("ALG_NAME")))
    if single_seed and config["NUM_SEEDS"] != 1:
        raise SystemExit(single_seed)
    if config.get("FUSED_ROLLOUT", False) and config["NUM_SEEDS"] != 1:
        raise SystemExit(
            "FUSED_ROLLOUT supports NUM_SEEDS=1 only (single-seed kernel); "
            "drop the flag or run one seed"
        )
    env_name = config["ENV_NAME"]
    if dist.is_initialized() and dist.get_world_size() > 1:
        # one run sharded over every rank (parallel/spmd.py), one seed a rank
        if config.get("ALG_NAME") == "pqn_host" or config["NUM_SEEDS"] != 1:
            raise SystemExit("a process group of several ranks trains the FF, recurrent, VDN and "
                             "actor-critic trainers with NUM_SEEDS=1")
        from purejaxql_torch.parallel.mesh import make_mesh
        from purejaxql_torch.parallel.spmd import make_train_spmd

        train = make_train_spmd(config, make_mesh(), make_train=make_train, logger=logger)
    elif config.get("ALG_NAME") == "pqn_host":
        # the host-env trainers take no logger, as the JAX package's
        # (purejaxql_tpu/cli.py:57-87)
        train = make_train(config)
    else:
        train = make_train(config, logger=logger)

    t0 = time.time()
    outs = train()
    # the actor-critic family keeps a dict of train states, its counters on
    # the actor (purejaxql_tpu/cli.py:95-100)
    train_state = outs["runner_state"][0]
    counter_state = train_state["actor"] if isinstance(train_state, dict) else train_state
    # the counters are host integers: wait for the device to finish the run
    # before the clock is read (the JAX CLI reads timesteps back from the
    # device), with or without metrics; a seed's steps times the seeds
    # (purejaxql_tpu/cli.py:103)
    total = counter_state.timesteps * config.get("NUM_SEEDS", 1)
    device = next(counter_state.network.parameters()).device
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    print(
        f"Training took {dt:.2f}s — {total} env steps "
        f"({total / dt:.0f} steps/s aggregate)."
    )
    # gated on the config, as purejaxql_tpu/cli.py:108-111: pqn_host returns
    # metrics under COLLECT_METRICS=False too
    if not config.get("LOG_VIA_CALLBACK", False) and config.get("COLLECT_METRICS", True):
        logger.log_history(outs["metrics"])
    logger.close()

    # one writer in a process group: the params are the same on every rank
    # (purejaxql_tpu/cli.py:114-116)
    if config.get("SAVE_PATH") and is_main_process():
        save_dir = os.path.join(config["SAVE_PATH"], env_name)
        run_name = f"{config.get('ALG_NAME', 'pqn')}_{env_name}_seed{config['SEED']}"
        extra = None
        if isinstance(train_state, dict):
            modules = {name: state.network for name, state in train_state.items()}
            # the actor-critic family keeps the observation statistics beside
            # the weights, so that a rollout replays the frozen normalization
            # (purejaxql_tpu/cli.py:124-137, read by its scripts/rollout.py)
            if config.get("NORMALIZE_OBS", False):
                env_state = outs["runner_state"][1][1]
                extra = {"norm_stats": {"mean": env_state.mean, "var": env_state.var}}
        else:
            modules = train_state.network
        save_run(modules, config, save_dir, run_name, extra=extra)
        print(f"Saved params to {save_dir}/")
    return outs


def _stepwise_run(config, logger):
    """The host-loop trainer (purejaxql_tpu/cli.py:143-206): CHECKPOINT_EVERY
    (updates), CHECKPOINT_PATH and RESUME_FROM (a state saved by an earlier
    stepwise run, of either package)."""
    import torch

    from purejaxql_torch.algo.exploration import draw_seed
    from purejaxql_torch.algo.stages import make_stages, train_stepwise
    from purejaxql_torch.core.checkpoint import load_state, save_state
    from purejaxql_torch.parallel.mesh import is_main_process

    ckpt_path = config.get("CHECKPOINT_PATH") or os.path.join(
        config.get("SAVE_PATH") or ".", f"{config['ENV_NAME']}_state.safetensors"
    )

    def on_update(update, metrics):
        logger.log(metrics, update)

    resume_from = config.get("RESUME_FROM")
    if resume_from:
        stages = make_stages(config)
        host_gen = torch.Generator().manual_seed(config["SEED"])
        train_state = load_state(stages.init_agent(host_gen), resume_from)
        print(
            f"Resumed from {resume_from} at {train_state.n_updates} updates / "
            f"{train_state.timesteps} env steps"
        )
        # continue with the restored counters driving the schedules, from a
        # fresh reset of the envs
        gen = torch.Generator(device=stages.device).manual_seed(draw_seed(host_gen))
        obs, env_state = stages.reset(gen)
        remaining = stages.config["NUM_UPDATES"] - train_state.n_updates
        for update in range(max(remaining, 0)):
            obs, env_state, transitions, _ = stages.rollout(train_state, obs, env_state, gen, host_gen)
            targets = stages.compute_targets(train_state, transitions)
            train_state, loss, _ = stages.learn(train_state, transitions, targets, gen)
            on_update(train_state.n_updates, {"td_loss": float(loss)})
            if config.get("CHECKPOINT_EVERY") and (update + 1) % config["CHECKPOINT_EVERY"] == 0 \
                    and is_main_process():
                save_state(train_state, ckpt_path)
    else:
        train_state, _ = train_stepwise(
            config, checkpoint_every=config.get("CHECKPOINT_EVERY"), checkpoint_path=ckpt_path,
            on_update=on_update,
        )
    # one writer in a process group (purejaxql_tpu/cli.py:186-203)
    if is_main_process():
        save_state(train_state, ckpt_path)
        print(f"State saved to {ckpt_path}")
    logger.close()
    return train_state


def main(argv=None):
    from purejaxql_torch.core.config import CONFIG_DIR, compose
    from purejaxql_torch.parallel.mesh import init_distributed

    # join the process group before anything runs (purejaxql_tpu/cli.py:
    # 219-224); a no-op without torchrun's variables
    init_distributed()

    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in ("-h", "--help"):
        print(__doc__)
        print("Available algorithm configs:")
        for f in sorted(os.listdir(os.path.join(CONFIG_DIR, "alg"))):
            print("  +alg=" + f.removesuffix(".yaml"))
        return 0

    config = compose(overrides=argv)
    if "ENV_NAME" not in config:
        raise SystemExit(
            "No algorithm selected: pass +alg=<name> "
            "(see python -m purejaxql_torch.cli --help)"
        )
    if config.get("HYP_TUNE"):
        from purejaxql_torch.utils.sweep import run_sweep

        run_sweep(config)
    else:
        single_run(config)
    return 0


if __name__ == "__main__":
    sys.exit(main())
