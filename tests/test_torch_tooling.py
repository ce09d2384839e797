"""The port's tooling on the CPU: the VDN and actor-critic trainers'
LOG_VIA_CALLBACK (tests/torch_callback_cases.py), the sweep against the
JAX package's trial picks, the GIF writer against JAX's bytes, the rollout
tool on the port's and the JAX CLI's run dirs (tests/test_rollout_tool.py),
the profiling helpers (tests/test_utils.py:46-59) and the logger's callback
and wandb fallback."""

import glob
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch
from torch_callback_cases import check_callback_rows

from purejaxql_torch import cli
from purejaxql_torch.algo.stages import make_stages
from purejaxql_torch.core.checkpoint import load_params
from purejaxql_torch.core.config import compose
from purejaxql_torch.scripts.rollout import main as rollout_main
from purejaxql_torch.utils import gif as tgif
from purejaxql_torch.utils import profiling
from purejaxql_torch.utils import sweep as tsweep
from purejaxql_torch.utils.logging import MemorySink, MetricLogger, make_logger
from purejaxql_tpu import cli as jcli
from purejaxql_tpu.core import checkpoint as jckpt
from purejaxql_tpu.core.config import compose as jcompose
from purejaxql_tpu.utils import gif as jgif
from purejaxql_tpu.utils import sweep as jsweep

CARTPOLE = ["NUM_ENVS=16", "NUM_STEPS=32", "NUM_MINIBATCHES=4", "NUM_EPOCHS=2", "HIDDEN_SIZE=32",
            "TEST_DURING_TRAINING=False"]
PENDULUM = ["+alg=pqn_dm_suite", "ENV_NAME=Pendulum-v1", "NUM_ENVS=16", "NUM_STEPS=16", "NUM_MINIBATCHES=2",
            "NUM_EPOCHS=1", "ACTOR_HIDDEN_SIZES=[32,32]", "CRITIC_HIDDEN_SIZES=[32,32]", "TEST_DURING_TRAINING=False"]


@pytest.mark.parametrize("family", ["ac", "vdn"])
def test_callback_rows_are_log_history_rows(family):
    """The VDN and actor-critic trainers' callback rows:
    tests/torch_callback_cases.py:check_callback_rows."""
    check_callback_rows(family)


def test_make_callback_tags_seeds_and_wandb_falls_back(monkeypatch, capsys):
    """WANDB_LOG_ALL_SEEDS repeats each row under rng{seed}/ (the seed's
    lane index); LOG_MODE=online without wandb (its import blocked here)
    logs to the other sinks, as the JAX package's make_logger."""
    monkeypatch.setitem(sys.modules, "wandb", None)
    mem = MemorySink()
    MetricLogger([mem], log_all_seeds=True).make_callback()({"update_steps": 3, "td_loss": np.float32(0.5)}, 1)
    assert mem.rows == [{"step": 3, "update_steps": 3, "td_loss": 0.5, "rng1/update_steps": 3, "rng1/td_loss": 0.5}]
    logger = make_logger({"LOG_MODE": "online", "WANDB_LOG_ALL_SEEDS": True})
    assert "wandb not available; skipping wandb sink" in capsys.readouterr().err
    assert logger.sinks == [] and logger.log_all_seeds


@pytest.mark.parametrize("count", [2, 5])
def test_sweep_picks_the_jax_trials(monkeypatch, capsys, count):
    """The local random search draws the JAX package's trials from
    random.Random(SEED): the same picks, trial by trial, and the same best
    trial, with each objective standing in for a training run (wandb's
    import blocked, as where it is not installed)."""
    monkeypatch.setitem(sys.modules, "wandb", None)
    space = {"LR": [0.001, 0.0005, 0.0001, 0.00005], "NUM_EPOCHS": [1, 2, 4]}
    picks = {}
    for name, module in (("port", tsweep), ("jax", jsweep)):
        seen = picks.setdefault(name, [])
        monkeypatch.setattr(module, "_objective", lambda c, seen=seen: seen.append(
            (c["LR"], c["NUM_EPOCHS"])) or -abs(np.log10(c["LR"]) + 3.5) - c["NUM_EPOCHS"])
        config = {"ENV_NAME": "CartPole-v1", "SEED": 7, "SWEEP_SPACE": space, "SWEEP_COUNT": count}
        assert module.run_sweep(config) == module.run_sweep(config, count=count)
    out = capsys.readouterr().out.splitlines()
    assert picks["port"] == picks["jax"] and len(picks["port"]) == 2 * count
    assert out[0] == out[2] and json.loads(out[0])["best"] is not None


def test_gif_writes_the_jax_bytes(tmp_path):
    """write_gif and render_grid_episode_gif write JAX's bytes: frames of
    palette indices past the LZW clear budget, and a (T, H, W, C) grid
    trajectory at two scales."""
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 11, (40, 56)).astype(np.uint8) for _ in range(3)]
    palette = tgif.palette_for_channels(10)
    assert palette == jgif.palette_for_channels(10)
    tgif.write_gif(str(tmp_path / "t.gif"), frames, palette, delay_cs=5)
    jgif.write_gif(str(tmp_path / "j.gif"), frames, palette, delay_cs=5)
    assert (tmp_path / "t.gif").read_bytes() == (tmp_path / "j.gif").read_bytes()
    obs = (rng.uniform(0, 1, (6, 10, 10, 4)) > 0.7).astype(np.float32)
    for scale in (1, 8):
        np.testing.assert_array_equal(tgif.grid_obs_to_indexed(obs[0], scale), jgif.grid_obs_to_indexed(obs[0], scale))
        tgif.render_grid_episode_gif(str(tmp_path / "t2.gif"), obs, scale=scale)
        jgif.render_grid_episode_gif(str(tmp_path / "j2.gif"), obs, scale=scale)
        data = (tmp_path / "t2.gif").read_bytes()
        assert data[:6] == b"GIF89a" and data == (tmp_path / "j2.gif").read_bytes()


def _rollout(run_dir, tmp_path, capsys, episodes, *extra):
    traj = str(tmp_path / "traj.npz")
    assert rollout_main(["--run-dir", str(run_dir), "--episodes", str(episodes), "--save-traj", traj,
                         "--device", "cpu", *extra]) == 0
    out = capsys.readouterr().out
    assert "returns:" in out
    data = np.load(traj)
    assert data["returns"].shape == (episodes,) and np.isfinite(data["returns"]).all()
    assert data["obs"].shape[0] == episodes
    return data, out


def test_rollout_tool_on_port_and_jax_cartpole_runs(tmp_path, capsys):
    """tests/test_rollout_tool.py's CartPole case on the port's CLI run (a
    16k-step agent beats random play, ~20), then the tool on a run dir of
    the JAX CLI (one update: its files, not its learning)."""
    assert cli.main(["+alg=pqn_cartpole", "DEVICE=cpu", f"SAVE_PATH={tmp_path / 'port'}", "TOTAL_TIMESTEPS=16384",
                     "TOTAL_TIMESTEPS_DECAY=16384", *CARTPOLE]) == 0
    data, _ = _rollout(tmp_path / "port" / "CartPole-v1", tmp_path, capsys, 4)
    assert data["returns"].mean() > 9.0 and data["obs"].shape[2:] == (4,)
    assert jcli.main(["+alg=pqn_cartpole", f"SAVE_PATH={tmp_path / 'jax'}", "TOTAL_TIMESTEPS=512",
                      "TOTAL_TIMESTEPS_DECAY=512", *CARTPOLE]) == 0
    _rollout(tmp_path / "jax" / "CartPole-v1", tmp_path, capsys, 3, "--max-steps", "64")


def test_rollout_tool_on_port_and_jax_pendulum_runs(tmp_path, capsys):
    """tests/test_rollout_tool.py's actor-critic case: the port's checkpoint
    carries the actor, the critics and the observation statistics, and the
    deterministic actor rolls out with them frozen (Pendulum's returns are
    negative costs above -2000); then a run dir as the JAX CLI writes it
    (purejaxql_tpu/cli.py:116-139: JAX's save_run of the tree with its
    norm_stats, and JAX's composed config) from those weights, which rolls
    out as the port's does."""
    assert cli.main([*PENDULUM, "DEVICE=cpu", f"SAVE_PATH={tmp_path / 'port'}", "TOTAL_TIMESTEPS=2048"]) == 0
    params = load_params(glob.glob(str(tmp_path / "port" / "Pendulum-v1" / "*.safetensors"))[0])
    assert {"actor", "critic", "norm_stats"} <= set(params) and torch.isfinite(params["norm_stats"]["mean"]).all()
    data, _ = _rollout(tmp_path / "port" / "Pendulum-v1", tmp_path, capsys, 3)
    assert (data["returns"] < 0).all() and (data["returns"] > -2000).all()
    jconfig = jcompose(overrides=[*PENDULUM, "TOTAL_TIMESTEPS=2048"])
    tree = jax.tree_util.tree_map(lambda t: t.numpy(), params)
    jckpt.save_run(tree, jconfig, str(tmp_path / "jax" / "Pendulum-v1"), "pqn_ac_Pendulum-v1_seed0", vmapped=False)
    again, _ = _rollout(tmp_path / "jax" / "Pendulum-v1", tmp_path, capsys, 3)
    np.testing.assert_array_equal(again["returns"], data["returns"])


def test_rollout_tool_renders_minatar(tmp_path, capsys):
    """--ascii and --gif on a Breakout-MinAtar run of the port's CLI: the
    first frames as text and the first episode as a GIF."""
    assert cli.main(["+alg=pqn_minatar", "ENV_NAME=Breakout-MinAtar", "DEVICE=cpu", f"SAVE_PATH={tmp_path}",
                     "TOTAL_TIMESTEPS=256", "TOTAL_TIMESTEPS_DECAY=256", "NUM_ENVS=8", "NUM_STEPS=32",
                     "NUM_MINIBATCHES=1", "NUM_EPOCHS=1", "HIDDEN_SIZE=16", "TEST_DURING_TRAINING=False"]) == 0
    gif_path = str(tmp_path / "breakout.gif")
    data, out = _rollout(tmp_path / "Breakout-MinAtar", tmp_path, capsys, 2, "--max-steps", "40", "--ascii",
                         "--gif", gif_path, "--gif-scale", "2")
    assert data["obs"].shape[1:] == (40, 10, 10, 4) and "--- t=0" in out and "gif saved to" in out
    assert open(gif_path, "rb").read(6) == b"GIF89a"


def test_throughput_accounting():
    t = profiling.Throughput()
    out = t.mark(1000)
    assert out["env_steps"] == 1000 and out["sps"] > 0
    assert t.mark(3000)["env_steps"] == 3000


def test_time_fn_returns_timings():
    out = profiling.time_fn(lambda x: (x * 2).sum(), torch.ones(128), warmup=1, iters=2)
    assert out["best_s"] > 0 and out["mean_s"] >= out["best_s"]


def test_trace_and_stage_timings(tmp_path):
    """trace() writes a Chrome trace of the block; stage_timings times
    each stage of a tiny stage bundle, evaluate with TEST_DURING_TRAINING."""
    with profiling.trace(str(tmp_path / "prof")):
        profiling.force(torch.ones(64) @ torch.ones(64))
    assert json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    stages = make_stages(compose(alg="pqn_cartpole", overrides=[
        "DEVICE=cpu", "TOTAL_TIMESTEPS=2048", "NUM_ENVS=8", "NUM_STEPS=16", "NUM_MINIBATCHES=2", "NUM_EPOCHS=1",
        "HIDDEN_SIZE=16", "TEST_DURING_TRAINING=True", "TEST_NUM_ENVS=4", "TEST_NUM_STEPS=20"]))
    out = profiling.stage_timings(stages, iters=1)
    assert set(out) == {"rollout_s", "targets_s", "learn_s", "evaluate_s"} and all(v > 0 for v in out.values())
    assert os.path.isdir(tmp_path / "prof")
