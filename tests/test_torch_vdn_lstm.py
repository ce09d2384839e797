"""The VDN trainer with an LSTM and with a batch-stat trunk, in the port on
the CPU against the JAX package: two grad steps of each on one window
against the JAX math of pqn_vdn.py:287-394 (the flax module forward over the
agents-major rows, ``_compute_targets``, the MSE, clip + RAdam), the (c, h)
carries through tiny runs for one seed and two, what JAX does with an LSTM
under FAST_BPTT (it raises ``KeyError: 'GRUCell_0'``; the port raises the
same), and the cuda policy, which leaves FAST_BPTT off for both.

Tolerances as tests/test_torch_vdn.py's grad steps: each loss and the params
after both within 1e-5 of JAX's, batch statistics within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from purejaxql_torch.algo import pqn_vdn
from purejaxql_torch.algo.types import MARLTransition
from purejaxql_torch.core import checkpoint as tckpt
from purejaxql_torch.core.config import compose
from purejaxql_torch.core.optim import make_optimizer
from purejaxql_torch.models.rnn import RNNQNetwork as TRNNQNetwork
from purejaxql_torch.ops import gru_scan as tgs
from purejaxql_torch.ops import lambda_returns as tlr
from purejaxql_tpu.core.config import compose as jcompose
from purejaxql_tpu.core.optim import make_optimizer as jax_make_optimizer
from purejaxql_tpu.models.rnn import RNNQNetwork as JRNNQNetwork
from test_torch_vdn import jax_vdn_targets, tiny_vdn_config
from torch_norm_cases import np_tree, shapes

torch.set_num_threads(1)

T, A, B, D, N_ACT, H = 9, 3, 4, 7, 5, 32
# the two networks: an LSTM on the layer_norm trunk, a GRU on a batch_norm
# trunk (the VDN trainer passes NORM_TYPE as written and a BatchNorm input)
NETS = {"lstm": dict(cell_type="lstm", norm_type="layer_norm"), "batch_norm": dict(cell_type="gru",
                                                                                  norm_type="batch_norm")}


def _window(cell, seed=0):
    """A numpy-seeded minibatch (T, A, B): obs, legal actions, team rewards
    and dones, the stored carries ((c, h) for an LSTM)."""
    rng = np.random.RandomState(seed)
    avail = (rng.rand(T, A, B, N_ACT) < 0.6).astype(np.float32)
    avail[..., 0] = 1.0
    action = np.array([rng.choice(np.flatnonzero(row)) for row in avail.reshape(-1, N_ACT)]).reshape(T, A, B)
    carry = lambda: 0.3 * rng.randn(T, A, B, H).astype(np.float32)  # noqa: E731
    return dict(
        obs=rng.randn(T, A, B, D).astype(np.float32), action=action.astype(np.int64),
        reward=rng.randn(T, 1, B).astype(np.float32), done=(rng.rand(T, 1, B) < 0.25).astype(np.float32),
        last_hs=((carry(), carry()),) if cell == "lstm" else (carry(),),
        last_done=(rng.rand(T, A, B) < 0.2).astype(np.float32), avail_actions=avail,
    )


@pytest.mark.parametrize("kind", sorted(NETS))
def test_vdn_grad_steps_match_jax_math(kind):
    """Two minibatch steps of ``pqn_vdn.learn_minibatch`` (the module path)
    from flax's weights, the running statistics moved off their init: the
    LSTM's (c, h) carry as the window's first hidden state; a batch_norm
    trunk's statistics over all T x A x B rows (``BatchNorm_1``,
    ``BatchNorm_2`` after the input's ``BatchNorm_0``). No kernel launches
    on the CPU."""
    config = tiny_vdn_config(TOTAL_TIMESTEPS=300, NUM_ENVS=4, NUM_STEPS=25, NUM_MINIBATCHES=1, NUM_EPOCHS=1)
    config["NUM_UPDATES"] = 3
    gamma, lam = config["GAMMA"], config["LAMBDA"]
    jnet = JRNNQNetwork(action_dim=N_ACT, hidden_size=H, num_layers=2, add_last_action=False, **NETS[kind])
    variables = jax.jit(lambda k: jnet.init(k, jnet.initialize_carry(1), jnp.zeros((1, 1, D)), jnp.zeros((1, 1)),
                                            jnp.zeros((1, 1), jnp.int32), train=False))(jax.random.PRNGKey(3))
    variables = {**variables, "batch_stats": jax.tree_util.tree_map(lambda v: v + 0.25, variables["batch_stats"])}
    assert sorted(variables["batch_stats"]) == (["BatchNorm_0", "BatchNorm_1", "BatchNorm_2"] if kind == "batch_norm"
                                                else ["BatchNorm_0"])
    w = jax.tree_util.tree_map(jnp.asarray, _window(kind))

    def loss_fn(params, batch_stats):
        hs0 = jax.tree_util.tree_map(lambda x: x[0].reshape(-1, H), list(w["last_hs"]))
        obs, ld = w["obs"].reshape(T, -1, D), w["last_done"].reshape(T, -1)
        (_, q), updates = jnet.apply({"params": params, "batch_stats": batch_stats}, hs0, obs, ld,
                                     jnp.zeros(ld.shape, jnp.int32), train=True, mutable=["batch_stats"])
        q = q.reshape(T, A, -1, N_ACT)
        valid_q = jax.lax.stop_gradient(q) - (1 - w["avail_actions"]) * 1e10
        target = jax_vdn_targets(valid_q[-1].max(-1).sum(0), valid_q[:-1], w["reward"][:-1, 0], w["done"][:-1, 0],
                                 gamma, lam).reshape(-1)
        chosen = jnp.take_along_axis(q, w["action"][..., None], -1).squeeze(-1)
        loss = jnp.mean((chosen.sum(1)[:-1].reshape(-1) - jax.lax.stop_gradient(target)) ** 2)
        return loss, updates["batch_stats"]

    tx = jax_make_optimizer(config["MAX_GRAD_NORM"], optax.linear_schedule(config["LR"], 1e-10, 3))

    @jax.jit
    def learn(params, batch_stats, opt_state):
        (loss, bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, batch_stats)
        updates, opt_state = tx.update(grads, opt_state, params)
        return loss, optax.apply_updates(params, updates), bs, opt_state

    params, bs, opt_state = variables["params"], variables["batch_stats"], tx.init(variables["params"])
    tnet = TRNNQNetwork(D, N_ACT, hidden_size=H, num_layers=2, **NETS[kind])
    tnet.load_state_dict(tckpt.params_from_flax(np_tree(variables)))
    opt = make_optimizer(tnet.parameters(), config["MAX_GRAD_NORM"], pqn_vdn.vdn_lr(config))
    to_t = lambda v: tuple(to_t(x) for x in v) if isinstance(v, tuple) else torch.tensor(v)  # noqa: E731
    mb = MARLTransition(**{k: to_t(v) for k, v in _window(kind).items()},
                        last_action=torch.zeros(T, A, B, dtype=torch.long), q_val=torch.zeros(T, A, B, N_ACT))
    before = (tgs.gru_scan_fwd.launches, tlr.lambda_returns_closure.launches)
    for _ in range(2):
        jloss, params, bs, opt_state = learn(params, bs, opt_state)
        loss, chosen = pqn_vdn.learn_minibatch(tnet, opt, mb, gamma, lam)
        np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5, rtol=1e-5)
    assert chosen.shape == (T, A, B)
    assert (tgs.gru_scan_fwd.launches, tlr.lambda_returns_closure.launches) == before
    want = tckpt.params_from_flax({"params": np_tree(params), "batch_stats": np_tree(bs)})
    for name, value in tnet.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), atol=1e-5 if name in dict(
            tnet.named_parameters()) else 1e-6, rtol=0, err_msg=name)


@pytest.mark.parametrize("seeds", [1, 2])
def test_tiny_lstm_vdn_runs_with_its_carries(seeds):
    """RNN_CELL=lstm on Spread through the trainer's entry point: the (c, h)
    carries of every agent (A, S * E, H) in the rollout's carry and the
    memory, finite losses, the tree the JAX trainer builds (its program
    traced, not compiled); with 2 seeds each lane's carries its own block
    (``agent_rows``)."""
    config = tiny_vdn_config(TOTAL_TIMESTEPS=256, NUM_EPOCHS=1, RNN_CELL="lstm", NUM_SEEDS=seeds)
    out = pqn_vdn.make_train(config)()
    train_state, memory, carry, _ = out["runner_state"]
    assert torch.isfinite(out["metrics"]["td_loss"]).all()
    c, h = carry[0][0]
    assert c.shape == h.shape == (3, seeds * 8, 32) and not torch.equal(c, h)
    assert [tuple(x.shape) for x in memory.last_hs[0]] == [(10, 3, seeds * 8, 32)] * 2
    if seeds == 1:
        from purejaxql_tpu.algo.pqn_vdn import make_train as jax_make_train

        jcfg = jcompose(alg="pqn_vdn_spread", overrides=[
            "TOTAL_TIMESTEPS=256", "NUM_ENVS=8", "NUM_STEPS=8", "MEMORY_WINDOW=2", "NUM_MINIBATCHES=2",
            "NUM_EPOCHS=1", "HIDDEN_SIZE=32", "TEST_DURING_TRAINING=False", "RNN_CELL=lstm"])
        jparams = jax.eval_shape(jax_make_train(jcfg), jax.random.PRNGKey(0))["runner_state"][0].params
        assert shapes(tckpt.params_to_flax(train_state.network)["params"]) == shapes(jparams)


def test_lstm_fast_bptt_raises_as_jax_and_the_policy_leaves_it_off():
    """The JAX VDN trainer with RNN_CELL=lstm and FAST_BPTT=True:
    ``supports_fast_bptt`` accepts the LSTM, but the FAST_BPTT forward gets
    no cell type (pqn_vdn.py:322-341) and raises ``KeyError: 'GRUCell_0'``
    when its program is traced; the port raises the same KeyError when the
    trainer is built. The cuda policy turns FAST_BPTT on for neither an
    LSTM nor a batch-stat VDN config (the JAX policy does for the LSTM,
    core/config.py:203-208), so their default runs take the module path."""
    from purejaxql_tpu.algo.pqn_vdn import make_train as jax_make_train

    jcfg = jcompose(alg="pqn_vdn_spread", overrides=[
        "TOTAL_TIMESTEPS=2000", "NUM_ENVS=16", "NUM_STEPS=25", "NUM_MINIBATCHES=4", "NUM_EPOCHS=1", "HIDDEN_SIZE=32",
        "TEST_DURING_TRAINING=False", "RNN_CELL=lstm", "FAST_BPTT=True"])
    with pytest.raises(KeyError, match="GRUCell_0"):
        jax.eval_shape(jax_make_train(jcfg), jax.random.PRNGKey(0))
    with pytest.raises(KeyError, match="GRUCell_0"):
        pqn_vdn.make_train(tiny_vdn_config(RNN_CELL="lstm", FAST_BPTT=True))
    for over in (["RNN_CELL=lstm"], ["NORM_TYPE=batch_norm"], ["NORM_TYPE=batch_renorm"]):
        cfg = compose(alg="pqn_vdn_spread", overrides=over)
        assert "FAST_BPTT" not in cfg and "PALLAS_BPTT" not in cfg, over
    with pytest.raises(ValueError, match="FAST_BPTT"):
        pqn_vdn.make_train(tiny_vdn_config(NORM_TYPE="batch_norm", FAST_BPTT=True))
    assert compose(alg="pqn_vdn_spread")["FAST_BPTT"] is True
