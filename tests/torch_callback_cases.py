"""Shared case of the LOG_VIA_CALLBACK tests (tests/test_torch_segmented.py
for the FF and recurrent trainers, tests/test_torch_tooling.py for VDN and
actor-critic): each trainer's callback rows at NUM_SEEDS=2 against
log_history's rows of the same run and against the JAX trainer's callback
rows at the same config."""

import jax
import numpy as np

from purejaxql_torch.algo import pqn, pqn_ac, pqn_rnn, pqn_vdn
from purejaxql_torch.core.config import compose
from purejaxql_torch.utils.logging import MemorySink, MetricLogger
from purejaxql_tpu.algo import pqn as jpqn
from purejaxql_tpu.algo import pqn_ac as jpqn_ac
from purejaxql_tpu.algo import pqn_rnn as jpqn_rnn
from purejaxql_tpu.algo import pqn_vdn as jpqn_vdn
from purejaxql_tpu.core.config import compose as jcompose
from purejaxql_tpu.utils.logging import MemorySink as JMemorySink
from purejaxql_tpu.utils.logging import MetricLogger as JMetricLogger

_TINY = {
    "ff": ("pqn_cartpole", pqn, jpqn, ["TOTAL_TIMESTEPS=512", "TOTAL_TIMESTEPS_DECAY=512", "NUM_ENVS=8",
                                       "NUM_STEPS=16", "NUM_MINIBATCHES=2", "NUM_EPOCHS=1", "HIDDEN_SIZE=16"]),
    "rnn": ("pqn_rnn_cartpole", pqn_rnn, jpqn_rnn, ["TOTAL_TIMESTEPS=512", "TOTAL_TIMESTEPS_DECAY=512",
                                                    "NUM_ENVS=8", "NUM_STEPS=16", "NUM_MINIBATCHES=2",
                                                    "NUM_EPOCHS=1", "HIDDEN_SIZE=16"]),
    "vdn": ("pqn_vdn_spread", pqn_vdn, jpqn_vdn, ["TOTAL_TIMESTEPS=256", "NUM_ENVS=8", "NUM_STEPS=8",
                                                  "MEMORY_WINDOW=2", "NUM_MINIBATCHES=2", "NUM_EPOCHS=1",
                                                  "HIDDEN_SIZE=16"]),
    "ac": ("pqn_pendulum", pqn_ac, jpqn_ac, ["TOTAL_TIMESTEPS=2048", "NUM_ENVS=16", "NUM_STEPS=32",
                                             "NUM_MINIBATCHES=2", "NUM_EPOCHS=1", "ACTOR_HIDDEN_SIZES=[16,16]",
                                             "CRITIC_HIDDEN_SIZES=[16,16]"]),
}
N_UPDATES = 4


def _port_rows(module, alg, overrides, **kw):
    mem = MemorySink()
    config = compose(alg=alg, overrides=["DEVICE=cpu", "NUM_SEEDS=2", "TEST_DURING_TRAINING=False",
                                         "LOG_VIA_CALLBACK=True", *overrides, *[f"{k}={v}" for k, v in kw.items()]])
    outs = module.make_train(config, logger=MetricLogger([mem]))()
    return mem.rows, outs["metrics"]


def check_callback_rows(family):
    """NUM_SEEDS=2, 4 updates: with LOG_INTERVAL 1 and 2 the callback rows
    are the rows log_history makes of the run's metrics, those of every
    LOG_INTERVAL-th update, each update's seeds in the order the JAX
    trainer's vmapped callback calls them (the FF trainer's, inside a
    lax.cond, seed 0 first; the others' seed 1 first), its rows at the same
    config with the same keys; under COLLECT_METRICS=False the run returns
    no metrics and logs the same rows."""
    alg, module, jmodule, overrides = _TINY[family]
    jmem = JMemorySink()
    jlogger = JMetricLogger([jmem])
    seeds = []
    callback = jlogger.make_callback()
    jlogger.make_callback = lambda step_key="update_steps": lambda m, s: (seeds.append(int(s)), callback(m, s))
    jconfig = jcompose(alg=alg, overrides=["NUM_SEEDS=2", "TEST_DURING_TRAINING=False", "LOG_VIA_CALLBACK=True",
                                           *overrides])
    rngs = jax.random.split(jax.random.PRNGKey(0), 2)
    jax.jit(jax.vmap(jmodule.make_train(jconfig, logger=jlogger)))(rngs)
    jax.effects_barrier()
    lane = {int(k): i for i, k in enumerate(np.asarray(rngs[:, 0]))}
    order = (0, 1) if family == "ff" else (1, 0)
    assert [(r["update_steps"], lane[s]) for r, s in zip(jmem.rows, seeds)] == [
        (u, s) for u in range(1, N_UPDATES + 1) for s in order]

    for interval in (1, 2):
        rows, metrics = _port_rows(module, alg, overrides, LOG_INTERVAL=interval)
        replay = MemorySink()
        MetricLogger([replay]).log_history(metrics)  # seed 0's updates, then seed 1's
        want = [replay.rows[s * N_UPDATES + u - 1] for u in range(interval, N_UPDATES + 1, interval) for s in order]
        assert [r["update_steps"] for r in rows] == [r["update_steps"] for r in want]
        for got, exp in zip(rows, want):
            assert set(got) == set(exp) == set(jmem.rows[0]), family
            for k in exp:
                assert got[k] == exp[k] or (np.isnan(got[k]) and np.isnan(exp[k])), (family, k)
        if interval == 2:
            quiet, metrics = _port_rows(module, alg, overrides, LOG_INTERVAL=2, COLLECT_METRICS=False)
            assert metrics == {}
            assert len(quiet) == len(rows) and all(
                a.keys() == b.keys() and all(a[k] == b[k] or np.isnan(a[k]) for k in a) for a, b in zip(quiet, rows))
