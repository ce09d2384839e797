"""The trainers on the network configurations of this slice, in the port on
the CPU against the JAX package: one learn minibatch step of the FF trainer
on a batch_norm MinAtar CNN and of the recurrent trainer on a batch_norm
trunk with MEMORY_WINDOW (the module path, targets from the same train-mode
forward) against the JAX compositions from the same weights; the twin of
tests/test_pqn_rnn.py::test_rnn_lstm_multilayer_dueling, both packages
training from the same weights; the twins of
tests/test_batch_renorm.py::test_trainer_with_batch_renorm and
tests/test_pqn_train.py::test_batch_norm_path on the MinAtar CNN; the cuda
policy and the refusals that stay; the async host trainer's snapshot of the
running statistics; the new trees both ways, in memory and through
safetensors.

Tolerances as tests/test_torch_rnn.py's learn step: the loss within 1e-5
relative, the new parameters within 1e-6, the statistics within 1e-6."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from purejaxql_torch.algo import pqn, pqn_host, pqn_rnn
from purejaxql_torch.algo.types import RNNTransition
from purejaxql_torch.core import checkpoint as tckpt
from purejaxql_torch.core.config import compose, derive_pqn_schedule_keys
from purejaxql_torch.core.optim import make_optimizer
from purejaxql_torch.core.schedules import lr_schedule
from purejaxql_torch.models import factory
from purejaxql_torch.models.cnn import CNNQNetwork as TCNNQNetwork
from purejaxql_torch.models.rnn import RNNQNetwork as TRNNQNetwork
from purejaxql_tpu.algo.returns import lambda_returns_closure as jax_lambda_returns_closure
from purejaxql_tpu.core.config import compose as jcompose
from purejaxql_tpu.core.optim import make_optimizer as jax_make_optimizer
from purejaxql_tpu.core.schedules import lr_schedule as jax_lr_schedule
from purejaxql_tpu.models.cnn import CNNQNetwork as JCNNQNetwork
from purejaxql_tpu.models.rnn import RNNQNetwork as JRNNQNetwork
from purejaxql_tpu.core import checkpoint as jckpt
from torch_norm_cases import F, H, init_variables, np_tree, rnn_inputs, shapes

torch.set_num_threads(1)


def _stats_moved(variables, seed):
    """flax variables with the running statistics moved off their init
    (mean 0.1 randn, var 1 + |randn|); the parameters as flax draws them."""
    rng = np.random.RandomState(seed)
    stat = lambda p, x: ((0.1 * rng.randn(*x.shape)) if p[-1].key == "mean" else  # noqa: E731
                         (1 + np.abs(rng.randn(*x.shape))) if p[-1].key == "var" else x)
    variables = np_tree(variables)
    return {"params": variables["params"],
            "batch_stats": jax.tree_util.tree_map_with_path(lambda p, x: np.asarray(stat(p, x), x.dtype),
                                                            variables["batch_stats"])}


def _jax_step(config, loss_fn, params):
    tx = jax_make_optimizer(config["MAX_GRAD_NORM"], jax_lr_schedule(config))

    @jax.jit
    def step(p):
        (loss, upd), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        updates, _ = tx.update(grads, tx.init(p), p)
        return loss, optax.apply_updates(p, updates), upd

    loss, new_params, upd = step(params)
    return float(loss), np_tree(new_params), np_tree(upd)


def _assert_learned_as_jax(tnet, new_params, batch_stats):
    want = tckpt.params_from_flax({"params": new_params, "batch_stats": batch_stats})
    got = tnet.state_dict()
    assert set(got) == set(want)
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), atol=1e-6, rtol=0, err_msg=name)


def test_minatar_batch_norm_learn_step_matches_jax():
    """``pqn.learn_minibatch`` on a batch_norm MinAtar CNN (pqn_minatar with
    NORM_TYPE=batch_norm, unfused) against the JAX trainer's step
    (pqn.py:492-553): the train-mode forward's statistics over the 64 rows'
    pixels and rows, clip + RAdam."""
    config = derive_pqn_schedule_keys(compose(alg="pqn_minatar", overrides=[
        "DEVICE=cpu", "NORM_TYPE=batch_norm", "HIDDEN_SIZE=32"]))
    jnet = JCNNQNetwork(action_dim=6, norm_type="batch_norm", hidden_size=32)
    variables = _stats_moved(jax.jit(lambda k: jnet.init(k, jnp.zeros((1, 10, 10, 4)), train=False))(
        jax.random.PRNGKey(0)), 1)
    tnet = TCNNQNetwork((10, 10, 4), 6, hidden_size=32, norm_type="batch_norm")
    tnet.load_state_dict(tckpt.params_from_flax(variables))
    rng = np.random.RandomState(2)
    obs = (rng.rand(64, 10, 10, 4) < 0.2).astype(np.float32)
    act = rng.randint(0, 6, 64)
    tgt = rng.randn(64).astype(np.float32)

    def loss_fn(p):
        q, upd = jnet.apply({"params": p, "batch_stats": variables["batch_stats"]}, jnp.asarray(obs), train=True,
                            mutable=["batch_stats"])
        chosen = jnp.take_along_axis(q, jnp.asarray(act)[:, None], axis=-1).squeeze(-1)
        return 0.5 * jnp.square(chosen - jnp.asarray(tgt)).mean(), upd["batch_stats"]

    jloss, new_params, jbs = _jax_step(config, loss_fn, variables["params"])
    opt = make_optimizer(tnet.parameters(), config["MAX_GRAD_NORM"], lr_schedule(config))
    loss, _ = pqn.learn_minibatch(tnet, opt, torch.tensor(obs), torch.tensor(act), torch.tensor(tgt))
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    _assert_learned_as_jax(tnet, new_params, jbs)


def test_rnn_batch_norm_trunk_learn_step_matches_jax():
    """``pqn_rnn.learn_minibatch`` on the module path with a batch_norm trunk
    (pqn_rnn_cartpole with NORM_TYPE=batch_norm: ``BatchNorm_0`` the input
    norm, ``BatchNorm_1`` and ``BatchNorm_2`` the trunk's) over a window of
    MEMORY_WINDOW 4 + NUM_STEPS 8 steps: the trunk's statistics over all 12
    x 6 rows of the train-mode forward, the closure targets from the
    stop-gradient of that same forward (pqn_rnn.py:275-341)."""
    config = derive_pqn_schedule_keys(compose(alg="pqn_rnn_cartpole", overrides=[
        "DEVICE=cpu", "NORM_TYPE=batch_norm", "HIDDEN_SIZE=32", "MEMORY_WINDOW=4", "NUM_STEPS=8"]))
    gamma, lam = config["GAMMA"], config["LAMBDA"]
    T, B, H = 12, 6, 32
    jnet = JRNNQNetwork(action_dim=2, hidden_size=H, norm_type="batch_norm")
    variables = _stats_moved(jax.jit(lambda k: jnet.init(k, jnet.initialize_carry(1), jnp.zeros((1, 1, 4)),
                                                         jnp.zeros((1, 1)), jnp.zeros((1, 1), jnp.int32),
                                                         train=False))(jax.random.PRNGKey(3)), 4)
    assert sorted(variables["batch_stats"]) == ["BatchNorm_0", "BatchNorm_1", "BatchNorm_2"]
    rng = np.random.RandomState(5)
    obs = rng.randn(T, B, 4).astype(np.float32)
    act = rng.randint(0, 2, (T, B))
    rew = rng.randn(T, B).astype(np.float32)
    done = rng.rand(T, B) < 0.15
    hs = (0.3 * rng.randn(T, B, H)).astype(np.float32)
    last_done = np.concatenate([np.zeros((1, B), bool), done[:-1]])
    last_act = np.concatenate([np.zeros((1, B), np.int64), act[:-1]])

    def loss_fn(p):
        (_, q), upd = jnet.apply({"params": p, "batch_stats": variables["batch_stats"]}, [jnp.asarray(hs[0])],
                                 jnp.asarray(obs), jnp.asarray(last_done), jnp.asarray(last_act), train=True,
                                 mutable=["batch_stats"])
        tq = jax.lax.stop_gradient(q)
        target = jax_lambda_returns_closure(tq[-1].max(-1), jnp.asarray(rew)[:-1], jnp.asarray(done, jnp.float32)[:-1],
                                            tq[:-1].max(-1), gamma, lam).reshape(-1)
        chosen = jnp.take_along_axis(q, jnp.asarray(act)[..., None], -1).squeeze(-1)[:-1].reshape(-1)
        return 0.5 * jnp.square(chosen - target).mean(), upd["batch_stats"]

    jloss, new_params, jbs = _jax_step(config, loss_fn, variables["params"])
    tnet = TRNNQNetwork(4, 2, hidden_size=H, norm_type="batch_norm")
    tnet.load_state_dict(tckpt.params_from_flax(variables))
    opt = make_optimizer(tnet.parameters(), config["MAX_GRAD_NORM"], lr_schedule(config))
    mb = RNNTransition(obs=torch.tensor(obs), action=torch.tensor(act), reward=torch.tensor(rew),
                       done=torch.tensor(done).float(), last_hs=(torch.tensor(hs),),
                       last_done=torch.tensor(last_done), last_action=torch.tensor(last_act),
                       q_val=torch.zeros(T, B, 2))
    loss, _ = pqn_rnn.learn_minibatch(tnet, opt, mb, gamma, lam)
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    _assert_learned_as_jax(tnet, new_params, jbs)


def test_rnn_lstm_multilayer_dueling_twin(monkeypatch):
    """tests/test_pqn_rnn.py::test_rnn_lstm_multilayer_dueling (LSTM, 2 RNN
    layers, dueling, NORM_TYPE=batch_norm, NORM_INPUT) trained by both
    packages from the same weights: the JAX trainer's init (the first half
    of its key's split, pqn_rnn.py:132-149), loaded into the port's network.
    Both train finite TD losses, keep the same tree, and move every running
    statistic (the random streams differ, ROADMAP.md)."""
    over = ["TOTAL_TIMESTEPS=1024", "TOTAL_TIMESTEPS_DECAY=1024", "NUM_ENVS=16", "NUM_STEPS=32",
            "NUM_MINIBATCHES=4", "NUM_EPOCHS=2", "HIDDEN_SIZE=32", "TEST_DURING_TRAINING=False", "RNN_CELL=lstm",
            "NUM_RNN_LAYERS=2", "DUELING=True", "NORM_TYPE=batch_norm", "NORM_INPUT=True"]
    from purejaxql_tpu.algo.pqn_rnn import make_train as jax_make_train

    key = jax.random.PRNGKey(0)
    jconfig = jcompose(alg="pqn_rnn_cartpole", overrides=over)
    jout = jax.jit(jax_make_train(jconfig))(key)
    jnet = JRNNQNetwork(action_dim=2, hidden_size=32, num_rnn_layers=2, cell_type="lstm", norm_input=True,
                        norm_type="batch_norm", dueling=True, add_last_action=jconfig["ADD_LAST_ACTION"])
    init = np_tree(jax.jit(lambda k: jnet.init(k, jnet.initialize_carry(1), jnp.zeros((1, 1, 4)), jnp.zeros((1, 1)),
                                               jnp.zeros((1, 1), jnp.int32), train=False))(jax.random.split(key)[0]))
    make = factory.make_rnn_q_network

    def from_jax_init(*args, **kw):
        net = make(*args, **kw)
        net.load_state_dict(tckpt.params_from_flax(init))
        return net

    monkeypatch.setattr(pqn_rnn, "make_rnn_q_network", from_jax_init)
    tout = pqn_rnn.make_train(compose(alg="pqn_rnn_cartpole", overrides=["DEVICE=cpu", *over]))()
    assert np.isfinite(np.asarray(jout["metrics"]["td_loss"])).all()
    assert torch.isfinite(tout["metrics"]["td_loss"]).all()
    jstate = jout["runner_state"][0]
    jtree = np_tree({"params": jstate.params, "batch_stats": jstate.batch_stats})
    ttree = tckpt.params_to_flax(tout["runner_state"][0].network)
    assert shapes(ttree) == shapes(jtree) == shapes(init)
    assert sorted(ttree["batch_stats"]) == ["BatchNorm_0", "BatchNorm_1", "BatchNorm_2"]
    for tree in (jtree, ttree):
        for name, leaves in tree["batch_stats"].items():
            assert not np.allclose(leaves["mean"], init["batch_stats"][name]["mean"]), name


def _minatar_config(**kw):
    return compose(alg="pqn_minatar", overrides=[
        "DEVICE=cpu", "ENV_NAME=Breakout-MinAtar", "TOTAL_TIMESTEPS=1024", "TOTAL_TIMESTEPS_DECAY=1024",
        "NUM_ENVS=16", "NUM_STEPS=16", "NUM_MINIBATCHES=2", "NUM_EPOCHS=1", "HIDDEN_SIZE=32",
        "TEST_DURING_TRAINING=False", *[f"{k}={v}" for k, v in kw.items()]])


def test_minatar_trainer_with_batch_renorm_and_batch_norm():
    """The twins of tests/test_batch_renorm.py::test_trainer_with_batch_renorm
    and tests/test_pqn_train.py::test_batch_norm_path on the MinAtar CNN
    (unfused: FUSED_ROLLOUT needs layer_norm and is refused off it): a
    batch_renorm trunk counts one ``steps`` a grad step, and a batch_norm
    trunk with NORM_INPUT moves every running statistic; finite losses."""
    out = pqn.make_train(_minatar_config(NORM_TYPE="batch_renorm"))()
    net = out["runner_state"][0].network
    grad_steps = int(out["metrics"]["grad_steps"][-1])
    assert grad_steps == 1024 // (16 * 16) * 2 and torch.isfinite(out["metrics"]["td_loss"]).all()
    assert [int(net.CNN_0.BatchRenorm_0.steps), int(net.CNN_0.BatchRenorm_1.steps)] == [grad_steps] * 2
    out = pqn.make_train(_minatar_config(NORM_TYPE="batch_norm", NORM_INPUT=True))()
    assert torch.isfinite(out["metrics"]["td_loss"]).all()
    fresh = TCNNQNetwork((10, 10, 4), 3, hidden_size=32, norm_type="batch_norm")
    buffers = dict(out["runner_state"][0].network.named_buffers())
    assert set(buffers) == {f"{m}.{leaf}" for m in ("BatchNorm_0", "CNN_0.BatchNorm_0", "CNN_0.BatchNorm_1")
                            for leaf in ("mean", "var")}
    for name, value in fresh.named_buffers():
        assert not torch.allclose(buffers[name], value), name
    with pytest.raises(ValueError, match="FUSED_ROLLOUT"):
        pqn.make_train(_minatar_config(NORM_TYPE="batch_norm", FUSED_ROLLOUT=True))


def test_cuda_policy_and_refusals_for_batch_stat_trunks():
    """On cuda the policy leaves FAST_BPTT off for a recurrent batch-stat
    trunk (``supports_fast_bptt`` needs layer_norm, as JAX's), so the
    default run takes the module path; FAST_BPTT asked for on one is
    refused, as by the JAX trainer (tests/test_fast_rnn.py:188-195); the
    FF trainer's FAST_TARGETS stays refused off layer_norm; the factory
    takes every NORM_TYPE."""
    for alg, norm in (("pqn_rnn_cartpole", "batch_norm"), ("pqn_rnn_craftax", "batch_norm"),
                      ("pqn_rnn_memory_chain", "batch_renorm")):
        cfg = compose(alg=alg, overrides=[f"NORM_TYPE={norm}"])
        assert "FAST_BPTT" not in cfg and "PALLAS_BPTT" not in cfg, alg
        assert cfg["EXPLORATION_KERNEL"] == "pallas"
        with pytest.raises(ValueError, match="FAST_BPTT"):
            pqn_rnn.make_train({**cfg, "DEVICE": "cpu", "FAST_BPTT": True})
    assert compose(alg="pqn_rnn_cartpole")["FAST_BPTT"] is True
    with pytest.raises(ValueError, match="FAST_TARGETS"):
        pqn.make_train(compose(alg="pqn_craftax", overrides=["DEVICE=cpu", "NORM_TYPE=batch_norm",
                                                              "FAST_TARGETS=True"]))
    craftax = compose(alg="pqn_craftax", overrides=["NORM_TYPE=batch_norm", "BF16_COMPUTE=True"])
    assert "FAST_TARGETS" not in craftax and craftax["EXPLORATION_KERNEL"] == "pallas"
    net = factory.make_rnn_q_network(compose(alg="pqn_rnn_craftax", overrides=["DEVICE=cpu", "NORM_TYPE=batch_norm",
                                                                             "HIDDEN_SIZE=16"]), 4, (8,))
    assert net.input_norm_type == "batch_renorm" and net.norms == [f"BatchRenorm_{i + 1}" for i in range(net.num_layers)]


def test_async_host_snapshot_carries_the_running_statistics(monkeypatch):
    """pqn_host_minatar with a batch_norm CNN, ASYNC_ENVS: the rollout of
    batch u + 1 acts with the running statistics after exactly u updates
    (the actor's snapshot copies the buffers as well as the weights,
    pqn_host.py:374-376), statistics that move from one update to the
    next."""
    n_updates = 4
    learner, learned, actors = {}, [threading.Event() for _ in range(n_updates)], []
    real_learn, real_rollout = pqn_host.learn_update, pqn_host.host_rollout

    def learn(train_state, *args):
        u = train_state.n_updates
        learner[u] = {k: v.clone() for k, v in train_state.network.named_buffers()}
        out = real_learn(train_state, *args)
        learned[u].set()
        return out

    def rollout(pool, network, *args):
        k = len(actors)
        if k > 0:
            assert learned[k - 1].wait(60)
        actors.append({k: v.clone() for k, v in network.named_buffers()})
        real_rollout(pool, network, *args)

    monkeypatch.setattr(pqn_host, "learn_update", learn)
    monkeypatch.setattr(pqn_host, "host_rollout", rollout)
    config = compose(alg="pqn_host_minatar", overrides=[
        "DEVICE=cpu", "NUM_MINIBATCHES=2", "NUM_EPOCHS=1", "HIDDEN_SIZE=32", "NORM_TYPE=batch_norm",
        f"TOTAL_TIMESTEPS={n_updates * 128}", f"TOTAL_TIMESTEPS_DECAY={n_updates * 128}", "NUM_ENVS=16",
        "NUM_STEPS=8", "TEST_ENVS=2"])
    pqn_host.make_train_async(config)()
    assert len(actors) == n_updates and set(actors[0]) == {
        f"{m}.{leaf}" for m in ("BatchNorm_0", "CNN_0.BatchNorm_0", "CNN_0.BatchNorm_1") for leaf in ("mean", "var")}
    for k in range(1, n_updates):
        for name, value in actors[k].items():
            assert torch.equal(value, learner[k - 1][name]), (k, name)
        if k > 1:  # rollouts 0 and 1 act before any update
            assert not torch.equal(actors[k]["CNN_0.BatchNorm_1.mean"], actors[k - 1]["CNN_0.BatchNorm_1.mean"])


# ---- the new trees both ways ---------------------------------------------------------------

TREES = {
    "minatar_batch_norm": lambda: (JCNNQNetwork(action_dim=4, norm_type="batch_norm", hidden_size=32),
                                   TCNNQNetwork((10, 10, 4), 4, hidden_size=32, norm_type="batch_norm"),
                                   (jnp.zeros((2, *(10, 10, 4))),)),
    "minatar_batch_renorm": lambda: (JCNNQNetwork(action_dim=4, norm_type="batch_renorm", hidden_size=32),
                                     TCNNQNetwork((10, 10, 4), 4, hidden_size=32, norm_type="batch_renorm"),
                                     (jnp.zeros((2, *(10, 10, 4))),)),
    "nature_batch_renorm": lambda: (JCNNQNetwork(action_dim=4, norm_type="batch_renorm", trunk="nature"),
                                    TCNNQNetwork((84, 84, 4), 4, norm_type="batch_renorm", trunk="nature"),
                                    (jnp.zeros((2, 84, 84, 4)),)),
    "rnn_mixed_lstm": lambda: (
        JRNNQNetwork(action_dim=4, hidden_size=H, cell_type="lstm", norm_type="batch_renorm", dueling=True),
        TRNNQNetwork(F, 4, hidden_size=H, cell_type="lstm", norm_type="batch_renorm", dueling=True),
        rnn_inputs("gru", (), 0)[0]),
    "rnn_craftax_batch_renorm": lambda: (
        JRNNQNetwork(action_dim=4, hidden_size=H, norm_type="batch_renorm", input_norm_type="batch_renorm"),
        TRNNQNetwork(F, 4, hidden_size=H, norm_type="batch_renorm", input_norm_type="batch_renorm"),
        rnn_inputs("gru", (), 0)[0]),
}


@pytest.mark.parametrize("kind", sorted(TREES))
def test_new_trees_cross_both_ways(kind, tmp_path):
    """Each new tree (``CNN_0.BatchNorm_i``, ``CNN_0.BatchRenorm_i`` with
    ``mean``, ``var``, ``r_max``, ``d_max`` and int32 ``steps``, the
    recurrent trunk's norms): the port's ``params_to_flax`` gives flax's
    names and shapes, and a tree written by one package's ``save_params``
    (params and batch_stats) loads in the other's into the same leaves, bit
    for bit, int32 ``steps`` included."""
    jnet, tnet, args = TREES[kind]()
    if kind.startswith("rnn_mixed"):  # one LSTM layer: a (c, h) carry
        args = ([(args[0][0], args[0][0])], *args[1:])
    variables = init_variables(jnet, args, 1, seed=11)
    tnet.load_state_dict(tckpt.params_from_flax(variables))
    tree = tckpt.params_to_flax(tnet)
    assert shapes(tree) == shapes(variables)
    for (path, a), (_, b) in zip(*(jax.tree_util.tree_flatten_with_path(t)[0] for t in (tree, variables))):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))
        assert a.dtype == b.dtype, jax.tree_util.keystr(path)
    tckpt.save_params(tree, str(tmp_path / "port.safetensors"))
    from_port = np_tree(jckpt.load_params(str(tmp_path / "port.safetensors")))
    jckpt.save_params(variables, str(tmp_path / "jax.safetensors"))
    from_jax = tckpt.load_params(str(tmp_path / "jax.safetensors"))
    other = TREES[kind]()[1]
    other.load_state_dict(tckpt.params_from_flax(from_jax))
    # the port's file in JAX and JAX's in the port (0-d leaves stay 0-d)
    for loaded in (from_port, tckpt.params_to_flax(other)):
        assert shapes(loaded) == shapes(variables)
        for (path, a), (_, b) in zip(*(jax.tree_util.tree_flatten_with_path(t)[0] for t in (loaded, variables))):
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=jax.tree_util.keystr(path))
