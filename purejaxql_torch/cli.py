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
are refused here, as there.
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

    from purejaxql_torch.algo.seeds import SINGLE_SEED_FAMILIES
    from purejaxql_torch.core.checkpoint import save_run
    from purejaxql_torch.utils.logging import make_logger

    if config.get("TRAINER", "fused") == "stepwise":
        raise SystemExit("TRAINER=stepwise is not ported yet")
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
    logger = make_logger(config)
    train = make_train(config)

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

    if config.get("SAVE_PATH"):
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


def main(argv=None):
    from purejaxql_torch.core.config import CONFIG_DIR, compose

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
        raise SystemExit("HYP_TUNE sweeps are not ported yet")
    single_run(config)
    return 0


if __name__ == "__main__":
    sys.exit(main())
