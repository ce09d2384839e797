"""The port's staged API (purejaxql_torch/algo/stages.py), its stepwise
trainer and CLI, and the full-state checkpoint (core/checkpoint.py:
save_state / load_state) against the JAX package's, on the CPU at the
tiny config of tests/test_stages.py."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file

from purejaxql_torch import cli
from purejaxql_torch.algo.stages import make_stages, train_stepwise
from purejaxql_torch.algo.types import Transition
from purejaxql_torch.core import checkpoint as tckpt
from purejaxql_torch.core.config import compose
from purejaxql_tpu.algo import stages as jstages
from purejaxql_tpu.algo.types import Transition as JTransition
from purejaxql_tpu.core import checkpoint as jckpt
from purejaxql_tpu.core.config import compose as jcompose

TINY = [
    "TOTAL_TIMESTEPS=8192", "TOTAL_TIMESTEPS_DECAY=8192", "NUM_ENVS=16", "NUM_STEPS=32",
    "NUM_MINIBATCHES=4", "NUM_EPOCHS=1", "HIDDEN_SIZE=32", "TEST_NUM_ENVS=8",
]


def stage_config(**kw):
    return compose(alg="pqn_cartpole", overrides=["DEVICE=cpu", *TINY, *[f"{k}={v}" for k, v in kw.items()]])


def jax_stage_config(**kw):
    return jcompose(alg="pqn_cartpole", overrides=[*TINY, *[f"{k}={v}" for k, v in kw.items()]])


def _host_gens(seed=0):
    host = torch.Generator().manual_seed(seed)
    return host, torch.Generator().manual_seed(seed + 1)


def test_stage_shapes_compose():
    """tests/test_stages.py::test_stage_shapes_compose on the port."""
    stages = make_stages(stage_config(), jit=False)
    host, gen = _host_gens()
    ts = stages.init_agent(host)
    obs, env_state = stages.reset(gen)
    assert obs.shape == (16, 4)
    obs2, env_state2, transitions, infos = stages.rollout(ts, obs, env_state, gen, host)
    assert transitions.obs.shape == (32, 16, 4) and infos["returned_episode_returns"].shape == (32, 16)
    targets = stages.compute_targets(ts, transitions)
    assert targets.shape == (32, 16)
    ts2, loss, qvals = stages.learn(ts, transitions, targets, gen)
    assert ts2.grad_steps == 4 and ts2.n_updates == 1 and ts2.timesteps == 512  # 1 epoch x 4 minibatches
    assert np.isfinite(float(loss)) and np.isfinite(float(qvals))
    metrics = stages.evaluate(ts2, gen)
    assert "returned_episode_returns" in metrics


def test_targets_and_learn_match_jax():
    """From the JAX agent's weights and the same transitions (numpy, seeded):
    compute_targets within 1e-5 of JAX's, and one learn call at 1 minibatch
    x 2 epochs (where the permutation cannot change the result) gives the
    params within 1e-5, the loss and Q-values too, and the same counters."""
    kw = {"NUM_MINIBATCHES": 1, "NUM_EPOCHS": 2}
    jst = jstages.make_stages(jax_stage_config(**kw))
    tst = make_stages(stage_config(**kw))
    jts = jst.init_agent(jax.random.PRNGKey(3))
    tts = tst.init_agent(torch.Generator().manual_seed(0))
    tts.network.load_state_dict(tckpt.params_from_flax(
        {"params": jax.device_get(jts.params), "batch_stats": jax.device_get(jts.batch_stats)}))

    rng = np.random.default_rng(0)
    T, E = 32, 16
    obs = rng.normal(0, 1, (T + 1, E, 4)).astype(np.float32)
    fields = dict(
        obs=obs[:-1], action=rng.integers(0, 2, (T, E)), reward=rng.uniform(0, 1, (T, E)).astype(np.float32),
        done=rng.uniform(0, 1, (T, E)) < 0.1, next_obs=obs[1:], q_val=rng.normal(0, 1, (T, E, 2)).astype(np.float32),
    )
    jtr = JTransition(**{k: jnp.asarray(v) for k, v in fields.items()})
    ttr = Transition(**{k: torch.as_tensor(v) for k, v in fields.items()})
    jtargets = jst.compute_targets(jts, jtr)
    ttargets = tst.compute_targets(tts, ttr)
    np.testing.assert_allclose(ttargets.numpy(), np.asarray(jtargets), atol=1e-5)

    jts2, jloss, jq = jst.learn(jts, jtr, jtargets, jax.random.PRNGKey(4))
    tts2, tloss, tq = tst.learn(tts, ttr, torch.as_tensor(np.array(jtargets)), torch.Generator().manual_seed(5))
    assert (tts2.grad_steps, tts2.n_updates, tts2.timesteps, tts2.step) == (
        int(jts2.grad_steps), int(jts2.n_updates), int(jts2.timesteps), int(jts2.step)) == (2, 1, 512, 2)
    np.testing.assert_allclose(float(tloss), float(jloss), atol=1e-5)
    np.testing.assert_allclose(float(tq), float(jq), atol=1e-5)
    got = tckpt._flatten(tckpt.params_to_flax(tts2.network)["params"])
    want = tckpt._flatten(jax.device_get(jts2.params))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-5, err_msg=k)


def test_train_stepwise_runs_and_checkpoints(tmp_path):
    """tests/test_stages.py::test_train_stepwise_runs_and_checkpoints on the
    port: a history row an update, the checkpoint written mid-run, and the
    full state (weights, moments, counters) round-tripping bit for bit."""
    ckpt = os.path.join(tmp_path, "state.safetensors")
    config = stage_config()
    ts, history = train_stepwise(config, checkpoint_every=4, checkpoint_path=ckpt)
    assert len(history) == 8192 // (16 * 32) and os.path.exists(ckpt)
    stages = make_stages(config)
    restored = tckpt.load_state(stages.init_agent(torch.Generator().manual_seed(1)), ckpt)
    assert (restored.grad_steps, restored.n_updates, restored.timesteps, restored.step) == (
        ts.grad_steps, ts.n_updates, ts.timesteps, ts.step) == (64, 16, 8192, 64)
    for (name, a), b in zip(restored.network.named_parameters(), ts.network.parameters()):
        assert torch.equal(a, b), name
    for a, b in zip(restored.optimizer.mu + restored.optimizer.nu, ts.optimizer.mu + ts.optimizer.nu):
        assert torch.equal(a, b)


def _assert_same_files(a_path, b_path):
    a, b = load_file(a_path), load_file(b_path)
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("lr_decay", [True, False])
def test_state_crosses_the_packages(tmp_path, capsys, lr_decay):
    """A state written by JAX's save_state (its moments, batch statistics
    and counters drawn from a seed, so that none is at its init value)
    loads into the port's template and, written again by the port, is the
    same file: keys, shapes, dtypes (0-d counters) and bits; the LR
    schedule's count is there only with LR_LINEAR_DECAY, as in optax's
    state. The port's stepwise CLI resumes from it. A state written by the
    port loads in JAX's load_state, and JAX writes it back bit for bit."""
    kw = {"LR_LINEAR_DECAY": lr_decay}
    jst = jstages.make_stages(jax_stage_config(**kw))
    jts = jst.init_agent(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)

    def drawn(x):
        x = np.asarray(x)
        if x.dtype == np.int32:
            return jnp.asarray(4, jnp.int32)  # the optimizer's counts: 4 grad steps
        return jnp.asarray(rng.uniform(0.5, 1.5, x.shape).astype(x.dtype))

    jts = jts.replace(
        params=jax.tree_util.tree_map(drawn, jts.params), batch_stats=jax.tree_util.tree_map(drawn, jts.batch_stats),
        opt_state=jax.tree_util.tree_map(drawn, jts.opt_state), step=jnp.asarray(4, jnp.int32),
        timesteps=jnp.asarray(512, jnp.int32), n_updates=jnp.asarray(1, jnp.int32),
        grad_steps=jnp.asarray(4, jnp.int32),
    )
    jax_file, port_file = str(tmp_path / "jax.safetensors"), str(tmp_path / "port.safetensors")
    jckpt.save_state(jts, jax_file)
    n_params = len(jax.tree_util.tree_leaves(jts.params))
    assert sum(k.startswith("opt_state/") for k in load_file(jax_file)) == 1 + 2 * n_params + lr_decay

    stages = make_stages(stage_config(**kw))
    ts = tckpt.load_state(stages.init_agent(torch.Generator().manual_seed(9)), jax_file)
    assert (ts.n_updates, ts.grad_steps, ts.timesteps, ts.step) == (1, 4, 512, 4)
    tckpt.save_state(ts, port_file)
    _assert_same_files(jax_file, port_file)

    # the port's stepwise CLI resumes from JAX's file, up to NUM_UPDATES
    resumed = str(tmp_path / "resumed.safetensors")
    cli.main(["+alg=pqn_cartpole", "DEVICE=cpu", "TRAINER=stepwise", *TINY, "TOTAL_TIMESTEPS=2048",
              f"LR_LINEAR_DECAY={lr_decay}", f"RESUME_FROM={jax_file}", f"CHECKPOINT_PATH={resumed}"])
    out = capsys.readouterr().out
    assert f"Resumed from {jax_file} at 1 updates / 512 env steps" in out and f"State saved to {resumed}" in out
    port_state = load_file(resumed)
    assert int(port_state["counters/n_updates"]) == 4 and int(port_state["counters/grad_steps"]) == 16

    # and JAX reads the port's file into its own template
    restored = jckpt.load_state(jst.init_agent(jax.random.PRNGKey(7)), resumed)
    assert int(restored.n_updates) == 4 and int(restored.step) == 16
    jckpt.save_state(restored, str(tmp_path / "again.safetensors"))
    _assert_same_files(resumed, str(tmp_path / "again.safetensors"))


def test_stepwise_cli_trains_and_checkpoints(tmp_path, capsys):
    """TRAINER=stepwise through the CLI: the JSONL rows of the updates, the
    state at CHECKPOINT_PATH's default, <SAVE_PATH>/<ENV_NAME>_state
    .safetensors; and the cuda policy leaves such a config unfused, so its
    rollout takes the epsilon-greedy kernel (on the CPU nothing changes)."""
    jsonl = tmp_path / "m.jsonl"
    cli.main(["+alg=pqn_cartpole", "DEVICE=cpu", "TRAINER=stepwise", *TINY, "TOTAL_TIMESTEPS=2048",
              "CHECKPOINT_EVERY=2", f"SAVE_PATH={tmp_path}", f"LOG_JSONL={jsonl}"])
    assert f"State saved to {tmp_path}/CartPole-v1_state.safetensors" in capsys.readouterr().out
    rows = [json.loads(line) for line in jsonl.read_text().splitlines()]
    assert [r["step"] for r in rows] == [0, 1, 2, 3] and all(np.isfinite(r["td_loss"]) for r in rows)
    cfg = compose(alg="pqn_cartpole", overrides=["TRAINER=stepwise"])
    assert "FUSED_ROLLOUT" not in cfg and cfg["EXPLORATION_KERNEL"] == "pallas"
    assert compose(alg="pqn_cartpole")["FUSED_ROLLOUT"] is True
