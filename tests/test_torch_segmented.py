"""Segmented training (purejaxql_torch/algo/segmented.py) and the FF and
recurrent trainers' LOG_VIA_CALLBACK on the CPU: the segments continue one
run bit for bit (tests/test_segmented.py's config), and the callback rows
are log_history's rows, thinned to LOG_INTERVAL, with the JAX trainers'
keys in their seed order (tests/torch_callback_cases.py; the VDN and
actor-critic trainers' in tests/test_torch_tooling.py)."""

import jax
import pytest
import torch

from torch_callback_cases import check_callback_rows

from purejaxql_torch.algo import pqn, pqn_rnn
from purejaxql_torch.algo.segmented import train_segmented
from purejaxql_torch.core.config import compose
from purejaxql_torch.utils.logging import MemorySink, MetricLogger


def seg_config(alg="pqn_cartpole", **kw):
    """tests/test_segmented.py's seg_config, on the CPU."""
    return compose(alg=alg, overrides=[
        "DEVICE=cpu", "TOTAL_TIMESTEPS=16384", "TOTAL_TIMESTEPS_DECAY=16384", "NUM_ENVS=16", "NUM_STEPS=32",
        "NUM_MINIBATCHES=4", "NUM_EPOCHS=1", "HIDDEN_SIZE=32", "TEST_DURING_TRAINING=False",
        *[f"{k}={v}" for k, v in kw.items()],
    ])


def _assert_same_networks(a, b):
    for (name, x), y in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(x, y), name
    for (name, x), y in zip(a.named_buffers(), b.buffers()):
        assert torch.equal(x, y), name


def test_segmented_ff_bitwise_equals_monolith():
    """4 segments of 8 updates against one train of 32: the counters
    continue (32 grad steps a segment), the metrics (1, 32), and the params,
    optimizer moments, counters, last obs and metrics bit for bit."""
    config = seg_config()
    mono = pqn.make_train(config)()
    seen = []
    seg = train_segmented(config, num_segments=4,
                          on_segment=lambda s, rs, m: seen.append((rs[0].grad_steps, m["td_loss"].shape)))
    assert seen == [(32, (8,)), (64, (8,)), (96, (8,)), (128, (8,))]
    ts, mts = seg["runner_state"][0], mono["runner_state"][0]
    assert (ts.timesteps, ts.n_updates, ts.grad_steps, ts.step) == (
        mts.timesteps, mts.n_updates, mts.grad_steps, mts.step) == (16384, 32, 128, 128)
    _assert_same_networks(mts.network, ts.network)
    for x, y in zip(mts.optimizer.mu + mts.optimizer.nu, ts.optimizer.mu + ts.optimizer.nu):
        assert torch.equal(x, y)
    assert torch.equal(mono["runner_state"][1][0], seg["runner_state"][1][0])
    assert set(seg["metrics"]) == set(mono["metrics"])
    for k, v in seg["metrics"].items():
        assert v.shape == (1, 32) and torch.equal(v[0], mono["metrics"][k]), k
    with pytest.raises(AssertionError, match="divide"):
        train_segmented(config, num_segments=3)


def test_segmented_rnn_bitwise_equals_monolith():
    """pqn_rnn in 2 segments against one train: params, counters, the
    memory window and the last obs and hidden state bit for bit."""
    config = compose(alg="pqn_rnn_cartpole", overrides=[
        "DEVICE=cpu", "TOTAL_TIMESTEPS=2048", "TOTAL_TIMESTEPS_DECAY=2048", "NUM_ENVS=8", "NUM_STEPS=16",
        "NUM_MINIBATCHES=2", "NUM_EPOCHS=2", "HIDDEN_SIZE=32", "TEST_DURING_TRAINING=False",
    ])
    mono = pqn_rnn.make_train(config)()
    seg = train_segmented(config, num_segments=2, make_train=pqn_rnn.make_train)
    ts, mts = seg["runner_state"][0], mono["runner_state"][0]
    assert (ts.timesteps, ts.n_updates, ts.grad_steps) == (mts.timesteps, mts.n_updates, mts.grad_steps) == (
        2048, 16, 64)
    _assert_same_networks(mts.network, ts.network)
    assert torch.equal(mono["runner_state"][1].obs, seg["runner_state"][1].obs)
    (mh, mo, *_), (sh, so, *_) = mono["runner_state"][2], seg["runner_state"][2]
    assert torch.equal(mo, so) and all(torch.equal(x, y) for x, y in zip(jax.tree_util.tree_leaves(mh),
                                                                          jax.tree_util.tree_leaves(sh)))
    assert seg["metrics"]["td_loss"].shape == (1, 16)
    assert torch.equal(seg["metrics"]["td_loss"][0], mono["metrics"]["td_loss"])


def test_segmented_logs_each_segment():
    """The logger gets each segment's rows as it ends (log_history), or
    with LOG_VIA_CALLBACK each update's row from the trainer, not both."""
    for callback in (False, True):
        mem = MemorySink()
        train_segmented(seg_config(TOTAL_TIMESTEPS=2048, LOG_VIA_CALLBACK=callback), num_segments=2,
                        logger=MetricLogger([mem]))
        assert [r["update_steps"] for r in mem.rows] == [1, 2, 3, 4], callback


@pytest.mark.parametrize("family", ["ff", "rnn"])
def test_callback_rows_are_log_history_rows(family):
    """The FF and recurrent trainers' callback rows:
    tests/torch_callback_cases.py:check_callback_rows."""
    check_callback_rows(family)
