"""The port's multi-GPU layer (purejaxql_torch/parallel/) on the CPU: gloo
ranks spawned by tests/torch_spmd_worker.py, two and four of them, against
the JAX package's SPMD layer under ``jax.shard_map`` on the same numpy
inputs, and the twins of tests/test_spmd.py, tests/test_fused_spmd.py and
tests/multiproc_worker.py's checks.

Tolerances: the global eval mean within 1e-6; the cross-replica BatchNorm
and BatchRenorm forwards, their running statistics and the meaned
gradients within 1e-5 of flax's ``norm_axis_name`` modules; two sharded
minibatch steps' parameters and statistics within 1e-5 of ``value_and_grad``
+ ``lax.pmean`` + the trainer's optax chain. The sharded runs' replicas
are held bit for bit.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import torch_spmd_worker as worker
from purejaxql_torch.core import checkpoint as tckpt
from purejaxql_torch.parallel.mesh import fold_seed, init_distributed
from purejaxql_torch.parallel.spmd import local_config
from purejaxql_tpu.algo.metrics import episode_mean_metrics as jax_episode_mean
from purejaxql_tpu.core.optim import make_optimizer as jax_make_optimizer
from purejaxql_tpu.models.factory import make_q_network as jax_q_network

A = 3


def jax_mesh(k):
    return Mesh(np.array(jax.devices()[:k]), ("env",))


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---- the inputs the ranks and JAX share -------------------------------------------


def eval_cases():
    rng = np.random.RandomState(3)
    T, E = 20, 8
    base = {
        "returned_episode_returns": rng.randn(T, E).astype(np.float32) * 10,
        "returned_episode_lengths": rng.randint(1, 50, (T, E)).astype(np.float32),
        "timestep": rng.randint(0, 500, (T, E)).astype(np.int32),
    }
    ended = rng.rand(T, E) < 0.2
    half = ended.copy()
    half[:, E // 2:] = False  # the second shard ends no episode
    return {
        "mixed": {**base, "returned_episode": ended},
        "one_shard_empty": {**base, "returned_episode": half},
        "none": {**base, "returned_episode": np.zeros((T, E), bool)},
    }


NORM_CONFIGS = {
    "batch_norm": {"NORM_TYPE": "batch_norm", "NORM_INPUT": True, "HIDDEN_SIZE": 16, "NUM_LAYERS": 2},
    "batch_renorm": {"NORM_TYPE": "batch_renorm", "INPUT_NORM_TYPE": "batch_renorm", "NORM_INPUT": True,
                     "HIDDEN_SIZE": 16, "NUM_LAYERS": 2},
    "cnn_batch_norm": {"NORM_TYPE": "batch_norm", "NORM_INPUT": True, "HIDDEN_SIZE": 16},
}


def flax_variables(config, obs_shape, seed, steps=1000):
    """flax variables of the config's network off their init: every param
    moved by 0.05 randn, running means 0.1 randn, variances 1 + |randn|, a
    BatchRenorm's ``steps`` at ``steps`` (1000: past its warm-up)."""
    net = jax_q_network({**config, "ALG_NAME": "pqn"}, A, obs_shape)
    v = np_tree(net.init(jax.random.PRNGKey(seed), jnp.zeros((2, *obs_shape)), train=False))
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(lambda x: (x + 0.05 * rng.randn(*x.shape)).astype(np.float32), v["params"])

    def stat(path, x):
        name = path[-1].key
        if name == "mean":
            return (0.1 * rng.randn(*x.shape)).astype(np.float32)
        if name == "var":
            return (1 + np.abs(rng.randn(*x.shape))).astype(np.float32)
        if name == "steps":
            return np.full(x.shape, steps, np.int32)
        return x

    return {"params": params, "batch_stats": jax.tree_util.tree_map_with_path(stat, v["batch_stats"])}


def norm_cases():
    rng = np.random.RandomState(5)
    cases = {}
    for i, (name, config) in enumerate(NORM_CONFIGS.items()):
        shape = (10, 10, 4) if name.startswith("cnn") else (4,)
        x = rng.rand(16, *shape).astype(np.float32) if name.startswith("cnn") else \
            (rng.randn(16, *shape) * 2 + 0.5).astype(np.float32)
        cases[name] = {"config": {**config, "ALG_NAME": "pqn"}, "action_dim": A, "x": x,
                       "w": (0.1 * rng.randn(16, A)).astype(np.float32),
                       "variables": flax_variables(config, shape, 10 + i)}
    return cases


def minibatch_case():
    rng = np.random.RandomState(9)
    config = {"NORM_TYPE": "batch_norm", "NORM_INPUT": True, "HIDDEN_SIZE": 16, "NUM_LAYERS": 2, "ALG_NAME": "pqn"}
    return {"config": config, "action_dim": A, "variables": flax_variables(config, (4,), 21),
            "obs": (rng.randn(2, 16, 4) * 2).astype(np.float32), "action": rng.randint(0, A, (2, 16)),
            "target": rng.randn(2, 16).astype(np.float32), "max_grad_norm": 0.5, "lr": 1e-3}


PAYLOAD = {"eval_cases": eval_cases(), "norm_cases": norm_cases(), "minibatch": minibatch_case()}


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    """Two ranks, one spawn: every check of this file at world size 2."""
    return worker.spawn(["hygiene", "eval_mean", "norm_forward", "minibatch_steps", "ff_unfused", "ff_batch_norm",
                         "fused_cartpole", "cli_save"], 2, tmp_path_factory.mktemp("ranks2"), PAYLOAD)


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    """Four ranks, one spawn: lockstep, the segments, the (2, 2) mesh."""
    return worker.spawn(["ff_unfused", "ff_segmented", "ff_seeds"], 4, tmp_path_factory.mktemp("ranks4"))


def assert_replicas(results, job):
    """Every rank's parameters and buffers bit-equal to rank 0's."""
    first = results[0][job]["state"]
    for r, res in enumerate(results[1:], 1):
        assert set(res[job]["state"]) == set(first)
        for k, v in res[job]["state"].items():
            np.testing.assert_array_equal(v, first[k], err_msg=f"{job}: rank {r} {k}")


# ---- process group hygiene (tests/multiproc_worker.py) ------------------------------


def test_init_distributed_reads_torchrun_variables(ranks2):
    for r, res in enumerate(ranks2):
        h = res["hygiene"]
        assert (h["rank"], h["world"], h["backend"], h["again"]) == (r, 2, "gloo", True)


def test_is_main_process_on_rank_zero_only(ranks2):
    assert [res["hygiene"]["main"] for res in ranks2] == [True, False]


def test_logger_sinks_on_rank_zero_unless_log_all_processes(ranks2):
    assert [res["hygiene"]["sinks"] for res in ranks2] == [1, 0]
    assert [res["hygiene"]["sinks_all"] for res in ranks2] == [1, 1]


def test_init_distributed_is_a_noop_without_variables(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    assert init_distributed() is False
    assert not torch.distributed.is_initialized()


def test_init_distributed_raises_when_the_world_cannot_join(tmp_path):
    """WORLD_SIZE=2 with no second rank: the request raises after its
    timeout, it never falls back to a run of its own."""
    code = ("from purejaxql_torch.parallel.mesh import init_distributed\n"
            f"init_distributed(backend='gloo', init_method='file://{tmp_path}/store', timeout_s=2)\n"
            "print('joined')\n")
    env = {**os.environ, "RANK": "0", "WORLD_SIZE": "2", "LOCAL_RANK": "0"}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=root, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0 and "joined" not in proc.stdout, proc.stdout
    assert "timeout" in proc.stderr.lower() or "timed out" in proc.stderr.lower(), proc.stderr[-2000:]


def test_a_failing_rank_ends_the_run(tmp_path):
    """A rank that raises while the other waits in a collective ends the
    spawn with its error, long before the group's timeout."""
    import time

    t0 = time.monotonic()
    with pytest.raises(Exception, match="rank 1 fails on purpose"):
        worker.spawn(["failing"], 2, tmp_path)
    assert time.monotonic() - t0 < worker.GROUP_TIMEOUT_S


# ---- against the JAX package ---------------------------------------------------------


@pytest.mark.parametrize("case", sorted(eval_cases()))
def test_episode_mean_metrics_global_matches_jax(ranks2, case):
    infos = PAYLOAD["eval_cases"][case]
    fn = jax.jit(jax.shard_map(lambda i: jax_episode_mean(i, "env"), mesh=jax_mesh(2), in_specs=P(None, "env"),
                               out_specs=P(), check_vma=False))
    want = np_tree(fn({k: jnp.asarray(v) for k, v in infos.items()}))
    for res in ranks2:
        got = res["eval_mean"][case]
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, atol=1e-6, rtol=0, err_msg=k)  # NaN against NaN
    if case == "none":
        assert all(np.isnan(v) for v in ranks2[0]["eval_mean"][case].values())


@pytest.mark.parametrize("name", sorted(NORM_CONFIGS))
def test_cross_replica_norms_match_flax(ranks2, name):
    """A train-mode forward over the two ranks' rows with the statistics
    over the group, then the meaned gradient of sum(w * Q), against flax's
    modules with ``norm_axis_name="env"`` under ``shard_map``."""
    case = PAYLOAD["norm_cases"][name]
    x = case["x"]
    net = jax_q_network(case["config"], A, x.shape[1:], norm_axis_name="env")

    def body(params, bs, x, w):
        def loss(p):
            q, upd = net.apply({"params": p, "batch_stats": bs}, x, train=True, mutable=["batch_stats"])
            return jnp.sum(w * q), (q, upd["batch_stats"])

        (_, (q, stats)), g = jax.value_and_grad(loss, has_aux=True)(params)
        return q, stats, jax.lax.pmean(g, "env")

    fn = jax.jit(jax.shard_map(body, mesh=jax_mesh(2), in_specs=(P(), P(), P("env"), P("env")),
                               out_specs=(P("env"), P(), P()), check_vma=False))
    v = case["variables"]
    q, stats, grads = np_tree(fn(v["params"], v["batch_stats"], jnp.asarray(x), jnp.asarray(case["w"])))
    got = [res["norm_forward"][name] for res in ranks2]
    np.testing.assert_allclose(np.concatenate([g["q"] for g in got]), q, atol=1e-5, rtol=0)
    want_stats = tckpt.params_from_flax({"params": {}, "batch_stats": stats})
    want_grads = tckpt.params_from_flax(grads)
    for g in got:
        assert set(g["stats"]) == set(want_stats) and set(g["grads"]) == set(want_grads)
        for k, t in want_stats.items():
            np.testing.assert_allclose(g["stats"][k], t.numpy(), atol=1e-5, rtol=0, err_msg=k)
        for k, t in want_grads.items():
            np.testing.assert_allclose(g["grads"][k], t.numpy(), atol=1e-5, rtol=0, err_msg=k)
    # the statistics are the global batch's: rank 0's rows alone give other Q-values
    alone = jax_q_network(case["config"], A, x.shape[1:]).apply(v, x[: len(x) // 2], train=True,
                                                               mutable=["batch_stats"])[0]
    assert not np.allclose(np.asarray(alone), got[0]["q"], atol=1e-3)


def test_two_sharded_minibatch_steps_match_jax(ranks2):
    """Two minibatch steps of a BatchNorm network: the train-mode forward
    with global statistics, 0.5 * MSE on the taken actions, the gradient
    mean, clip and RAdam, against JAX's value_and_grad + lax.pmean + the
    trainer's optax chain (purejaxql_tpu/core/optim.py)."""
    case = PAYLOAD["minibatch"]
    net = jax_q_network(case["config"], A, (4,), norm_axis_name="env")
    tx = jax_make_optimizer(case["max_grad_norm"], case["lr"])

    def body(params, bs, obs, act, tgt):
        opt_state = tx.init(params)
        for m in range(obs.shape[0]):
            def loss(p):
                q, upd = net.apply({"params": p, "batch_stats": bs}, obs[m], train=True, mutable=["batch_stats"])
                chosen = jnp.take_along_axis(q, act[m][:, None], -1).squeeze(-1)
                return 0.5 * jnp.square(chosen - tgt[m]).mean(), upd["batch_stats"]

            (_, new_bs), g = jax.value_and_grad(loss, has_aux=True)(params)
            g = jax.lax.pmean(g, "env")
            updates, opt_state = tx.update(g, opt_state, params)
            params, bs = optax.apply_updates(params, updates), new_bs
        return params, bs

    fn = jax.jit(jax.shard_map(body, mesh=jax_mesh(2), in_specs=(P(), P(), P(None, "env"), P(None, "env"),
                                                                    P(None, "env")),
                               out_specs=(P(), P()), check_vma=False))
    v = case["variables"]
    params, stats = np_tree(fn(v["params"], v["batch_stats"], jnp.asarray(case["obs"]),
                               jnp.asarray(case["action"], jnp.int32), jnp.asarray(case["target"])))
    want = tckpt.params_from_flax({"params": params, "batch_stats": stats})
    start = tckpt.params_from_flax(v)
    for res in ranks2:
        got = res["minibatch_steps"]["state"]
        assert set(got) == set(want)
        for k, t in want.items():
            np.testing.assert_allclose(got[k], t.numpy(), atol=1e-5, rtol=0, err_msg=k)
    assert any(not np.allclose(want[k].numpy(), start[k].numpy()) for k in want)
    for k in want:  # lockstep: both ranks hold the same bits
        np.testing.assert_array_equal(ranks2[0]["minibatch_steps"]["state"][k],
                                      ranks2[1]["minibatch_steps"]["state"][k])


# ---- twins of tests/test_spmd.py -----------------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
def test_spmd_counts_global_steps(ranks2, ranks4, world):
    results = ranks2 if world == 2 else ranks4
    for res in results:
        assert res["ff_unfused"]["timesteps"] == 2048
        assert res["ff_unfused"]["metrics"]["env_step"][-1] == 2048
        assert np.isfinite(res["ff_unfused"]["metrics"]["td_loss"]).all()


@pytest.mark.parametrize("world", [2, 4])
def test_spmd_learner_replicas_in_lockstep(ranks2, ranks4, world):
    assert_replicas(ranks2 if world == 2 else ranks4, "ff_unfused")


def test_spmd_2way_finite_returns_and_global_eval(ranks2):
    m0, m1 = (res["ff_unfused"]["metrics"] for res in ranks2)
    assert np.isfinite(m0["returned_episode_returns"]).all()
    assert np.isfinite(m0["test/returned_episode_returns"]).all()
    for k in m0:  # the metrics are meaned over the group, the eval global: the same on both ranks
        np.testing.assert_array_equal(m0[k], m1[k], err_msg=k)


def test_spmd_ranks_step_their_own_envs(ranks2):
    """The shared network, then each rank's own streams: its envs differ."""
    assert not np.array_equal(ranks2[0]["ff_unfused"]["obs"], ranks2[1]["ff_unfused"]["obs"])


def test_spmd_batch_norm_cross_replica(ranks2):
    assert_replicas(ranks2, "ff_batch_norm")
    state = ranks2[0]["ff_batch_norm"]["state"]
    stats = {k: v for k, v in state.items() if k.endswith((".mean", ".var"))}
    assert stats and all(np.isfinite(v).all() for v in stats.values())
    assert not np.allclose(state["BatchNorm_0.mean"], 0.0)


def test_spmd_segmented_bitwise_equals_resumable(ranks4):
    """2 segments sharded 4-way give one resumable run's params and, on each
    rank, its env state bit for bit."""
    for res in ranks4:
        s = res["ff_segmented"]
        assert s["timesteps"] == 4096
        for k, v in s["whole"].items():
            np.testing.assert_array_equal(s["seg"][k], v, err_msg=k)
        assert len(s["whole_env"]) == len(s["seg_env"]) > 4
        for a, b in zip(s["whole_env"], s["seg_env"]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(s["seg_td"].reshape(-1), s["whole_td"])


def test_spmd_seed_axis(ranks4):
    """A (2, 2) mesh: the seed rows train apart, each row's two ranks in
    lockstep; the per-seed leading axis gathered on every rank; counters
    global."""
    for r, res in enumerate(ranks4):
        out = res["ff_seeds"]
        kernel = out["state"]["Dense_0.weight"]
        assert kernel.shape[0] == 2
        assert not np.array_equal(kernel[0], kernel[1])
        for k, v in out["own"].items():  # rank r is on seed row r // 2
            np.testing.assert_array_equal(out["state"][k][r // 2], v, err_msg=k)
            np.testing.assert_array_equal(out["state"][k], ranks4[0]["ff_seeds"]["state"][k])
        assert out["timesteps"] == 2048
        assert (out["metrics"]["env_step"][:, -1] == 2048).all()
        assert np.isfinite(out["metrics"]["td_loss"]).all()


def test_cli_saves_once(ranks2, tmp_path_factory):
    """The CLI's sharded run writes its SAVE_PATH files from rank 0 only."""
    assert [res["cli_save"]["saves"] for res in ranks2] == [["pqn_CartPole-v1_seed0"], []]
    assert all(res["cli_save"]["timesteps"] == 512 for res in ranks2)


def test_fused_rollout_sharded(ranks2):
    """tests/test_fused_spmd.py::test_fused_rollout_under_shard_map: each
    rank runs the CartPole kernel's twin on its NUM_ENVS / 2 envs; finite,
    replicated params; the global counter."""
    assert_replicas(ranks2, "fused_cartpole")
    for res in ranks2:
        out = res["fused_cartpole"]
        assert out["timesteps"] == 1024
        assert all(np.isfinite(v).all() for v in out["state"].values())
        assert np.isfinite(out["metrics"]["returned_episode_returns"]).all()


# ---- the pieces ----------------------------------------------------------------------


def test_local_config_divides_the_global_run():
    config = {"NUM_ENVS": 32, "TEST_NUM_ENVS": 3, "TOTAL_TIMESTEPS": "1e4", "NUM_SEEDS": 1}
    local = local_config(config, 4)
    assert (local["NUM_ENVS"], local["TEST_NUM_ENVS"], local["TOTAL_TIMESTEPS"]) == (8, 1, 2500)
    assert (local["TOTAL_TIMESTEPS_DECAY"], local["TIMESTEP_SCALE"], local["NUM_SEEDS"]) == (2500, 4, 1)
    assert local_config({**config, "TEST_NUM_ENVS": None}, 2)["TEST_NUM_ENVS"] is None
    with pytest.raises(AssertionError):
        local_config(config, 3)


def test_fold_seed_streams_are_not_other_seeds():
    seeds = {fold_seed(s, i) for s in range(8) for i in range(8)}
    assert len(seeds) == 64 and all(0 <= s < 2**62 for s in seeds)
    assert fold_seed(0, 1) != fold_seed(1, 0)
