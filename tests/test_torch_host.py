"""The port's host-env path against the JAX package's: the C++ pool (its own
copy of the sources, the same ABI) bit for bit, the plug-in socket, the
synchronous trainer step for step, the inline eval's split of the rows,
the lag-1 async trainer's acting snapshot, and the CLI."""

import json
import shutil
import subprocess
import textwrap
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from purejaxql_torch import cli
from purejaxql_torch.algo import pqn_host
from purejaxql_torch.core import checkpoint as tckpt
from purejaxql_torch.core.config import compose
from purejaxql_torch.envs import hostpool as thost
from purejaxql_tpu.core import checkpoint as jckpt
from purejaxql_tpu.core.config import compose as jcompose
from purejaxql_tpu.models.cnn import CNNQNetwork as JCNNQNetwork

pytestmark = pytest.mark.skipif(
    shutil.which("make") is None or shutil.which("g++") is None,
    reason="native toolchain unavailable (the JAX package's pool builds with make, the port's with g++)",
)

NATIVE = ("CartPole-v1", "Acrobot-v1", "Breakout-MinAtar", "Asterix-MinAtar", "Freeway-MinAtar",
          "SpaceInvaders-MinAtar", "Seaquest-MinAtar")
PLUGINS = ("PongRam-EH", "Pong-EH", "BreakoutRam-EH", "Breakout-EH")


@pytest.mark.parametrize("env_name", NATIVE + PLUGINS)
def test_pool_is_bit_equal_to_the_jax_pool(env_name):
    """Same seed, same random actions, about 100 steps of 8 envs: the port's
    pool (3 threads) gives the JAX pool's (default threads) obs, rewards and
    dones exactly."""
    from purejaxql_tpu.envs.hostpool import HostEnvPool as JHostEnvPool

    mine, theirs = thost.HostEnvPool(env_name, 8, num_threads=3, seed=5), JHostEnvPool(env_name, 8, seed=5)
    assert (mine.obs_shape, mine.num_actions, mine.obs_dim) == (theirs.obs_shape, theirs.num_actions, theirs.obs_dim)
    np.testing.assert_array_equal(mine.reset(), theirs.reset())
    rng = np.random.RandomState(0)
    n_done = 0
    for _ in range(100):
        actions = rng.randint(0, mine.num_actions, 8)
        for got, want in zip(mine.step(actions), theirs.step(actions)):
            np.testing.assert_array_equal(got, want)
        n_done += int(want.sum())
    mine.close()
    theirs.close()
    if env_name in ("CartPole-v1", "Breakout-MinAtar"):
        assert n_done > 0  # the auto-reset is part of the stream compared


def _plugin_source():
    # the JAX package's own test plug-in (tests/test_hostpool_plugin.py): a
    # plug-in written for its pool, loaded here into the port's
    from test_hostpool_plugin import _PLUGIN_SRC

    return textwrap.dedent(_PLUGIN_SRC)


def test_plugin_abi(tmp_path):
    """A plug-in .so built at test time loads through the port's
    load_plugin and steps (perfect play scores 8 an episode); a bad path, a
    .so without eh_plugin_get and an unknown env name raise as in the JAX
    package."""
    src = tmp_path / "banditwalk.cc"
    src.write_text(_plugin_source())
    so = tmp_path / "libbanditwalk.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-fPIC", "-shared", "-o", str(so), str(src)], check=True)
    thost.load_plugin(so)
    pool = thost.HostEnvPool("BanditWalk-plugin", num_envs=8, seed=0)
    assert (pool.num_actions, pool.obs_shape) == (2, (2,))
    obs = pool.reset()
    total = np.zeros(8)
    for _ in range(8):
        obs, rew, done = pool.step((1 - obs[:, 1]).astype(np.int32))
        total += rew
    assert (total == 8).all() and done.all()
    pool.close()

    with pytest.raises(ValueError, match="failed to load plugin '/nonexistent/libnope.so': dlopen failed"):
        thost.load_plugin("/nonexistent/libnope.so")
    empty = tmp_path / "empty.cc"
    empty.write_text("extern \"C\" int not_the_plugin_symbol() { return 0; }\n")
    subprocess.run(["g++", "-shared", "-fPIC", "-o", str(tmp_path / "libempty.so"), str(empty)], check=True)
    with pytest.raises(ValueError, match="missing eh_plugin_get symbol"):
        thost.load_plugin(tmp_path / "libempty.so")
    with pytest.raises(ValueError, match="envhost has no native env named 'Nope-v0'"):
        thost.HostEnvPool("Nope-v0", 4)
    with pytest.raises(ValueError, match="int32"):
        thost.HostEnvPool("CartPole-v1", 4).step_into(np.zeros(4, np.int64), np.zeros((4, 4), np.float32),
                                                      np.zeros(4, np.float32), np.zeros(4, np.uint8))


class _RecordingPool(thost.HostEnvPool):
    """The port's pool, recording every step's actions and next obs."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.actions, self.obs = [], []

    def step_into(self, actions, obs, rewards, dones):
        super().step_into(actions, obs, rewards, dones)
        self.actions.append(actions.copy())
        self.obs.append(obs.copy())


def _recording_jax_pool(env_name, num_envs, seed):
    from purejaxql_tpu.envs.hostpool import HostEnvPool as JHostEnvPool

    class Recording(JHostEnvPool):
        def step(self, actions):
            out = super().step(actions)
            self.actions.append(np.asarray(actions, np.int32).copy())
            self.obs.append(out[0].copy())
            return out

    pool = Recording(env_name, num_envs, seed=seed)
    pool.actions, pool.obs = [], []
    return pool


def test_sync_trainer_matches_jax_step_for_step(monkeypatch):
    """Host CartPole, 16 envs x 16 steps, 3 updates of one minibatch and one
    epoch at eps 0 from the JAX trainer's own init: the same actions and obs
    in every step, and params, td_loss, done_rate and
    returned_episode_returns within 1e-5. At eps 0 neither trainer draws a
    random action, and with one minibatch the loss mean and the batch
    statistics do not depend on the permutation."""
    from purejaxql_tpu.algo.pqn_host import make_train as jmake_train
    from purejaxql_tpu.models.factory import make_q_network as jmake_q_network

    overrides = ["ENV_NAME=CartPole-v1", "TOTAL_TIMESTEPS=768", "TOTAL_TIMESTEPS_DECAY=768", "NUM_ENVS=16",
                 "NUM_STEPS=16", "NUM_MINIBATCHES=1", "NUM_EPOCHS=1", "HIDDEN_SIZE=32", "EPS_START=0",
                 "EPS_FINISH=0", "TEST_DURING_TRAINING=False", "SEED=3"]
    jconfig = jcompose(alg="pqn_cartpole", overrides=overrides)
    jpool = _recording_jax_pool("CartPole-v1", 16, seed=3)
    jout = jax.jit(jmake_train(jconfig, pool=jpool))(jax.random.PRNGKey(0))
    jax.block_until_ready(jout)
    # the JAX trainer's init (pqn_host.py:91-105): the key after one split
    jnet = jmake_q_network(jconfig, 2, (4,))
    init = jnet.init(jax.random.split(jax.random.PRNGKey(0))[0], jnp.zeros((1, 4)), train=False)
    real = pqn_host.make_q_network

    def from_jax_init(*args, **kw):
        net = real(*args, **kw)
        net.load_state_dict(tckpt.params_from_flax(jax.tree_util.tree_map(np.asarray, init)))
        return net

    monkeypatch.setattr(pqn_host, "make_q_network", from_jax_init)
    tpool = _RecordingPool("CartPole-v1", 16, seed=3)
    tout = pqn_host.make_train(compose(alg="pqn_cartpole", overrides=[*overrides, "DEVICE=cpu"]), pool=tpool)()

    assert len(tpool.actions) == len(jpool.actions) == 48
    for step, (ta, ja, to, jo) in enumerate(zip(tpool.actions, jpool.actions, tpool.obs, jpool.obs)):
        np.testing.assert_array_equal(ta, ja, err_msg=f"actions of step {step}")
        np.testing.assert_array_equal(to, jo, err_msg=f"obs of step {step}")
    want = jax.tree_util.tree_map(np.asarray, jout["runner_state"][0].params)
    got = tckpt.params_to_flax(tout["runner_state"][0].network)["params"]
    leaves_want, leaves_got = (jax.tree_util.tree_flatten_with_path(t)[0] for t in (want, got))
    assert [jax.tree_util.keystr(p) for p, _ in leaves_got] == [jax.tree_util.keystr(p) for p, _ in leaves_want]
    for (path, w), (_, g) in zip(leaves_want, leaves_got):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=jax.tree_util.keystr(path))
    tm = {k: v.numpy() for k, v in tout["metrics"].items()}
    jm = {k: np.asarray(v) for k, v in jout["metrics"].items()}
    assert set(tm) == set(jm)
    np.testing.assert_array_equal(tm["env_step"], jm["env_step"])
    for k in ("td_loss", "done_rate", "returned_episode_returns", "returned_episode_lengths", "reward_per_step"):
        np.testing.assert_allclose(tm[k], jm[k], atol=1e-5, rtol=0, err_msg=k)
    assert tm["done_rate"].max() > 0  # episodes ended inside the compared stream


def test_inline_eval_rows_are_greedy_and_stripped(monkeypatch):
    """TEST_ENVS=8 ride in the pool (after tests/test_pqn_host.py:58-90):
    env_step counts the 16 training envs only, the four test/* keys are
    finite (SCORE_GAME=Breakout-v5 gives the normalized score), the
    training rows' actions come from make_eps_greedy and the greedy rows'
    are the argmax of their Q-values."""
    seen = {"explore": [], "q": []}
    real_explore, real_net = pqn_host.make_eps_greedy, pqn_host.make_q_network

    def spy_explore(*args):
        explore = real_explore(*args)

        def wrapped(q_vals, eps):
            out = explore(q_vals, eps)
            seen["explore"].append((q_vals.shape[0], eps, out.clone()))
            return out

        return wrapped

    def spy_net(*args, **kw):
        net = real_net(*args, **kw)
        net.register_forward_hook(lambda m, i, o: seen["q"].append(o.detach().clone()) if o.shape[0] == 24 else None)
        return net

    monkeypatch.setattr(pqn_host, "make_eps_greedy", spy_explore)
    monkeypatch.setattr(pqn_host, "make_q_network", spy_net)
    config = compose(alg="pqn_cartpole", overrides=[
        "DEVICE=cpu", "TOTAL_TIMESTEPS=8192", "TOTAL_TIMESTEPS_DECAY=8192", "NUM_ENVS=16", "NUM_STEPS=32",
        "NUM_MINIBATCHES=2", "NUM_EPOCHS=1", "HIDDEN_SIZE=32", "TEST_DURING_TRAINING=True", "TEST_ENVS=8",
        "SCORE_GAME=Breakout-v5", "EXPLORATION_KERNEL=pallas",
    ])
    pool = _RecordingPool("CartPole-v1", 24, seed=0)
    out = pqn_host.make_train(config, pool=pool)()
    m = {k: v.numpy() for k, v in out["metrics"].items()}
    assert out["runner_state"][0].timesteps == 8192 and m["env_step"][-1] == 8192
    for k in ("returned_episode_returns", "test/returned_episode_returns", "test/returned_episode_lengths",
              "test/human_normalized_score"):
        assert np.isfinite(m[k]).all(), k
    assert m["returned_episode_returns"][-1] > 0 and m["test/returned_episode_returns"][-1] > 0
    np.testing.assert_allclose(m["test/human_normalized_score"],
                               (m["test/returned_episode_returns"] - 1.7) / (30.5 - 1.7), rtol=1e-5)
    assert len(seen["explore"]) == len(seen["q"]) == len(pool.actions) == 16 * 32
    for (rows, eps, train_actions), q, actions in zip(seen["explore"], seen["q"], pool.actions):
        assert rows == 16
        np.testing.assert_array_equal(actions[:16], train_actions.numpy())
        np.testing.assert_array_equal(actions[16:], q[16:].argmax(-1).numpy())
    assert seen["explore"][0][1] == 1.0 and seen["explore"][-1][1] < 1.0  # the schedule moved


def _async_config(env_name, *extra):
    return compose(alg="pqn_host_minatar", overrides=[
        "DEVICE=cpu", f"ENV_NAME={env_name}", "NUM_MINIBATCHES=2", "NUM_EPOCHS=1", "HIDDEN_SIZE=32", *extra,
    ])


def test_async_trainer_contract():
    """PongRam-EH, 8192 steps (tests/test_pong_plugin.py:155-185):
    timesteps 8192, 32 updates, the JAX async rows' keys (pqn_host.py:570-
    586; PongRam-EH has no human-normalized score); and a pixel run (Pong-EH,
    8 envs) that holds the env-axis / feature-axis split of pqn_host.py:
    393-399."""
    out = pqn_host.make_train_async(_async_config(
        "PongRam-EH", "TOTAL_TIMESTEPS=8192", "TOTAL_TIMESTEPS_DECAY=8192", "NUM_ENVS=16", "NUM_STEPS=16",
        "TEST_ENVS=4"))()
    ts = out["runner_state"][0]
    assert (ts.timesteps, ts.n_updates) == (8192, 32)
    assert set(out["metrics"]) == {"update", "td_loss", "returned_episode_returns", "test/returned_episode_returns"}
    assert all(v.shape == (32,) for v in out["metrics"].values())
    assert torch.isfinite(out["metrics"]["td_loss"]).all()
    assert out["metrics"]["update"].tolist() == list(range(32))

    out = pqn_host.make_train_async(_async_config(
        "Pong-EH", "TOTAL_TIMESTEPS=1024", "TOTAL_TIMESTEPS_DECAY=1024", "NUM_ENVS=8", "NUM_STEPS=8",
        "TEST_ENVS=4"))()
    assert out["runner_state"][0].timesteps == 1024
    assert torch.isfinite(out["metrics"]["td_loss"]).all()


def test_async_rollout_acts_with_a_snapshot_of_u_updates(monkeypatch):
    """The rollout of batch u + 1 acts with the weights after exactly u
    updates, though it runs beside learn u: each rollout past the first
    waits here until learn u has finished, and its recorded Q-values are
    recomputed from a saved copy of the weights after u updates. A worker
    acting through the learner's own module reads the weights after u + 1
    updates and fails this."""
    n_updates = 5
    weights, learned, rollouts = {}, [threading.Event() for _ in range(n_updates)], []
    real_learn, real_rollout = pqn_host.learn_update, pqn_host.host_rollout

    def learn(train_state, *args):
        u = train_state.n_updates
        weights[u] = {k: v.clone() for k, v in train_state.network.state_dict().items()}
        out = real_learn(train_state, *args)
        learned[u].set()
        return out

    def rollout(pool, network, explore, eps, bufs, n_train):
        k = len(rollouts)
        if k > 0:
            assert learned[k - 1].wait(60)
        real_rollout(pool, network, explore, eps, bufs, n_train)
        rollouts.append((bufs.obs.clone(), bufs.q_val[:, :n_train].clone()))

    monkeypatch.setattr(pqn_host, "learn_update", learn)
    monkeypatch.setattr(pqn_host, "host_rollout", rollout)
    config = _async_config("BreakoutRam-EH", f"TOTAL_TIMESTEPS={n_updates * 128}",
                           f"TOTAL_TIMESTEPS_DECAY={n_updates * 128}", "NUM_ENVS=16", "NUM_STEPS=8", "TEST_ENVS=2",
                           "LR=0.003")
    train = pqn_host.make_train_async(config)
    net = pqn_host.make_q_network(config, 4, (24,), generator=torch.Generator().manual_seed(0))
    train()
    assert len(rollouts) == n_updates and len(weights) == n_updates

    def q_of(u, obs):
        net.load_state_dict(weights[u])
        with torch.no_grad():
            return net(obs.flatten(0, 1), train=False).view(*obs.shape[:2], -1)

    for k in range(1, n_updates):
        obs, q_rec = rollouts[k]
        torch.testing.assert_close(q_rec, q_of(k - 1, obs), atol=1e-6, rtol=0)
        if k + 1 < n_updates:  # the weights one update later would not give them
            assert (q_rec - q_of(k, obs)).abs().max() > 1e-4


def test_cli_host_recipe(tmp_path, capsys, monkeypatch):
    """The README's CPU recipe: +alg=pqn_host_minatar at a tiny length
    writes a safetensors file that the JAX loader reads into its
    CNNQNetwork (the same Q-values); NUM_SEEDS=2 exits as the JAX CLI does;
    ASYNC_ENVS=True goes through make_train_async."""
    jsonl = tmp_path / "m.jsonl"
    common = ["+alg=pqn_host_minatar", "DEVICE=cpu", "TOTAL_TIMESTEPS=1024", "TOTAL_TIMESTEPS_DECAY=1024",
              "NUM_ENVS=16", "NUM_STEPS=16", "NUM_MINIBATCHES=2", "NUM_EPOCHS=1", "HIDDEN_SIZE=32", "TEST_ENVS=4",
              f"SAVE_PATH={tmp_path / 'models'}"]
    outs = cli.single_run(compose(overrides=[*common, f"LOG_JSONL={jsonl}"]))
    assert "Training took" in capsys.readouterr().out
    run_dir = tmp_path / "models" / "Breakout-MinAtar"
    saved = jckpt.load_params(str(run_dir / "pqn_host_Breakout-MinAtar_seed0.safetensors"))
    jnet = JCNNQNetwork(action_dim=3, hidden_size=32)
    init = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 10, 10, 4)), train=False)
    shapes = lambda t: jax.tree_util.tree_map(lambda v: tuple(np.shape(v)), t)  # noqa: E731
    assert shapes(saved) == shapes(init["params"])
    x = np.random.RandomState(0).rand(5, 10, 10, 4).astype(np.float32)
    want = outs["runner_state"][0].network(torch.tensor(x), train=False).detach().numpy()
    got = np.asarray(jnet.apply({"params": saved, "batch_stats": init["batch_stats"]}, x, train=False))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    rows = [json.loads(line) for line in jsonl.read_text().splitlines()]
    assert len(rows) == 4 and rows[-1]["env_step"] == 1024 and "test/returned_episode_returns" in rows[-1]

    with pytest.raises(SystemExit, match="pqn_host supports NUM_SEEDS=1 only"):
        cli.main([*common, "NUM_SEEDS=2"])

    called = []
    real = pqn_host.make_train_async
    monkeypatch.setattr(pqn_host, "make_train_async", lambda *a, **kw: called.append(1) or real(*a, **kw))
    jsonl_async = tmp_path / "a.jsonl"
    cli.main([*common, "ASYNC_ENVS=True", f"LOG_JSONL={jsonl_async}"])
    rows = [json.loads(line) for line in jsonl_async.read_text().splitlines()]
    assert called and [r["update"] for r in rows] == [0, 1, 2, 3]


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_cli_host_writes_no_rows_without_metrics(tmp_path, mode):
    """With COLLECT_METRICS=False the port's CLI writes no JSONL row on
    pqn_host_minatar, sync and ASYNC_ENVS, as the JAX CLI's gate on the
    config (purejaxql_tpu/cli.py:108-111): the host trainers return their
    metrics all the same."""
    jsonl = tmp_path / "m.jsonl"
    outs = cli.single_run(compose(overrides=[
        "+alg=pqn_host_minatar", "DEVICE=cpu", "TOTAL_TIMESTEPS=1024", "TOTAL_TIMESTEPS_DECAY=1024",
        "NUM_ENVS=16", "NUM_STEPS=16", "NUM_MINIBATCHES=2", "NUM_EPOCHS=1", "HIDDEN_SIZE=32", "TEST_ENVS=4",
        "COLLECT_METRICS=False", f"ASYNC_ENVS={mode == 'async'}", f"LOG_JSONL={jsonl}"]))
    assert outs["metrics"]
    assert not jsonl.exists() or jsonl.read_text() == ""


def test_cuda_policy_gives_pqn_host_the_eps_greedy_kernel():
    """On cuda the policy turns on EXPLORATION_KERNEL=pallas for pqn_host,
    as for the unfused FF trainer; an explicit flag wins, PARITY=strict and
    the CPU leave it off; nothing fuses."""
    assert compose(alg="pqn_host_minatar")["EXPLORATION_KERNEL"] == "pallas"
    assert not compose(alg="pqn_host_minatar").get("FUSED_ROLLOUT")
    assert compose(alg="pqn_host_minatar", overrides=["EXPLORATION_KERNEL=off"])["EXPLORATION_KERNEL"] == "off"
    for extra in ("PARITY=strict", "DEVICE=cpu"):
        assert "EXPLORATION_KERNEL" not in compose(alg="pqn_host_minatar", overrides=[extra])
