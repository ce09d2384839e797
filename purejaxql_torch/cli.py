"""CLI entry point: hydra-style UX over the port's config system.

    python -m purejaxql_torch.cli +alg=pqn_cartpole [KEY=val ...]
    python -m purejaxql_torch.cli +alg=pqn_rnn_memory_chain [KEY=val ...]
    python -m purejaxql_torch.cli +alg=pqn_pendulum [KEY=val ...]
    python -m purejaxql_torch.cli +alg=pqn_craftax [KEY=val ...]
    python -m purejaxql_torch.cli +alg=pqn_vdn_spread [KEY=val ...]

The trainer is picked by the config's ALG_NAME: ``pqn`` and ``pqn_craftax``
(algo/pqn.py), ``pqn_rnn*`` (algo/pqn_rnn.py), ``pqn_vdn*``
(algo/pqn_vdn.py: ``pqn_vdn_{spread,skirmish,smax,kitchen,hanabi}``) or
``pqn_ac`` / ``pqn_playground`` (algo/pqn_ac.py). Runs on the GPU unless
DEVICE=cpu is given. Prints
"Training took ...", writes ``<SAVE_PATH>/<ENV_NAME>/<run>.safetensors``
(flax wire format; the actor-critic family's as one tree ``{"actor": ...,
"critic": ...}``) and ``<run>_config.yaml``, and replays the metrics into the
LOG_JSONL file (none with COLLECT_METRICS=False, whose run returns none).
"""

from __future__ import annotations

import os
import sys
import time


def _select_make_train(config):
    """The trainer of the config's family, as purejaxql_tpu/cli.py:20-40
    picks it: ``pqn`` / ``pqn_craftax``, ``pqn_rnn*``, ``pqn_vdn*`` or
    ``pqn_ac`` / ``pqn_playground``; the host-env family (pqn_host) is not
    ported."""
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
    raise SystemExit(
        f"ALG_NAME '{name}' is not ported yet (ported: pqn, pqn_craftax, pqn_rnn, pqn_vdn, pqn_ac; still "
        "to port: pqn_host)"
    )


def single_run(config):
    import torch

    from purejaxql_torch.core.checkpoint import save_run
    from purejaxql_torch.utils.logging import make_logger

    if config.get("TRAINER", "fused") == "stepwise":
        raise SystemExit("TRAINER=stepwise is not ported yet")
    make_train = _select_make_train(config)
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
    # device), with or without metrics
    total = counter_state.timesteps
    device = next(counter_state.network.parameters()).device
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    print(
        f"Training took {dt:.2f}s — {total} env steps "
        f"({total / dt:.0f} steps/s aggregate)."
    )
    if outs["metrics"]:  # COLLECT_METRICS=False returns none (purejaxql_tpu/cli.py:108-111)
        logger.log_history(outs["metrics"])
    logger.close()

    if config.get("SAVE_PATH"):
        save_dir = os.path.join(config["SAVE_PATH"], env_name)
        run_name = f"{config.get('ALG_NAME', 'pqn')}_{env_name}_seed{config['SEED']}"
        if isinstance(train_state, dict):
            modules = {name: state.network for name, state in train_state.items()}
        else:
            modules = train_state.network
        save_run(modules, config, save_dir, run_name)
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
