"""The port's recurrent slice on the CPU against the JAX package: the
MemoryChain env, the GRU network and its checkpoint crossing, the GRU scan's
plain twins against the Pallas kernels (interpret mode), the FAST_BPTT
forward and its gradients, the closure-form lambda returns, one learn step,
tiny trainer runs, the CUDA policy and the CLI recipe.

Sizes are tiny (T 13, B 4, H 32, as tests/test_fast_rnn.py); each Pallas
kernel runs in interpret mode twice in this file."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from purejaxql_torch import cli
from purejaxql_torch.algo import pqn_rnn
from purejaxql_torch.algo.returns import lambda_returns_closure
from purejaxql_torch.algo.types import RNNTransition
from purejaxql_torch.core import checkpoint as tckpt
from purejaxql_torch.core.config import compose
from purejaxql_torch.core.optim import make_optimizer
from purejaxql_torch.core.schedules import lr_schedule
from purejaxql_torch.envs import make as tmake
from purejaxql_torch.envs.base import NO_DRAWS
from purejaxql_torch.envs.classic.memory_chain import (
    MemoryChainDraws,
    MemoryChainState,
    start_state,
)
from purejaxql_torch.models.rnn import RNNQNetwork as TRNNQNetwork
from purejaxql_torch.ops import fast_rnn as tfast
from purejaxql_torch.ops import gru_scan as tgs
from purejaxql_torch.ops import lambda_returns as tlr
from purejaxql_tpu.algo.returns import lambda_returns_closure as jax_lambda_returns_closure
from purejaxql_tpu.core import checkpoint as jckpt
from purejaxql_tpu.core.optim import make_optimizer as jax_make_optimizer
from purejaxql_tpu.core.schedules import lr_schedule as jax_lr_schedule
from purejaxql_tpu.envs import make as jmake
from purejaxql_tpu.models.rnn import RNNQNetwork as JRNNQNetwork
from purejaxql_tpu.ops import fast_rnn as jfast

torch.set_num_threads(1)

T, B, F, H, A = 13, 4, 6, 32, 3


def tiny_rnn_config(alg="pqn_rnn_cartpole", **kw):
    return compose(
        alg=alg,
        overrides=[
            "DEVICE=cpu", "TOTAL_TIMESTEPS=2048", "TOTAL_TIMESTEPS_DECAY=2048", "NUM_ENVS=8",
            "NUM_STEPS=16", "NUM_MINIBATCHES=2", "NUM_EPOCHS=2", "HIDDEN_SIZE=32",
            "TEST_DURING_TRAINING=False",
        ] + [f"{k}={v}" for k, v in kw.items()],
    )


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---- MemoryChain ------------------------------------------------------------------


@pytest.mark.parametrize("memory_length", [5, 10])
def test_memory_chain_reset_and_step_match_jax(memory_length):
    """Random play in the JAX env (auto-reset on): every state it reaches,
    stepped by both envs with the same actions, gives the same obs, state,
    reward and done; every reset, built from the JAX env's context and
    query, gives the same obs."""
    jenv, jparams = jmake("MemoryChain-bsuite", memory_length=memory_length)
    tenv, tparams = tmake("MemoryChain-bsuite", memory_length=memory_length)
    n = 64
    keys = jax.random.split(jax.random.PRNGKey(memory_length), n)
    jobs, jstate = jax.vmap(jenv.reset, in_axes=(0, None))(keys, jparams)
    tstate = start_state(MemoryChainDraws(torch.tensor(np.asarray(jstate.context)), torch.tensor(np.asarray(jstate.query))))
    np.testing.assert_array_equal(tenv.get_obs(tstate, tparams).numpy(), np.asarray(jobs))
    step_env = jax.jit(jax.vmap(jenv.step_env, in_axes=(None, 0, 0, None)), static_argnums=3)
    step = jax.jit(jax.vmap(jenv.step, in_axes=(0, 0, 0, None)), static_argnums=3)
    rng = np.random.RandomState(memory_length)
    rewards = []
    for i in range(3 * memory_length):
        act = rng.randint(0, 2, n).astype(np.int32)
        tstate = MemoryChainState(**{f.name: torch.tensor(np.asarray(getattr(jstate, f.name)))
                                     for f in dataclasses.fields(MemoryChainState)})
        jo, js, jr, jd, _ = step_env(jax.random.PRNGKey(0), jstate, jnp.asarray(act), jparams)
        to, ts, tr, td, _ = tenv.step_env(tstate, torch.tensor(act).long(), tparams, NO_DRAWS)
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        for f in dataclasses.fields(MemoryChainState):
            np.testing.assert_array_equal(getattr(ts, f.name).numpy(), np.asarray(getattr(js, f.name)), f.name)
        rewards.append(np.asarray(jr))
        _, jstate, *_ = step(jax.random.split(jax.random.PRNGKey(100 + i), n), jstate, jnp.asarray(act), jparams)
    rewards = np.stack(rewards)
    assert (rewards == 1).any() and (rewards == -1).any() and (rewards == 0).any()


def test_memory_chain_reset_draws_and_auto_reset():
    env, params = tmake("MemoryChain-bsuite", memory_length=3)
    gen = torch.Generator().manual_seed(0)
    obs, state = env.reset(gen, 4096, params)
    share = state.context.float().mean().item()
    assert abs(share - 0.5) < 0.03 and (state.query == 0).all()
    assert torch.equal(obs[:, 2], 2 * state.context[:, 0].float() - 1)
    bit = state.context[:, 0].clone()
    for t in range(3):
        obs, state, reward, done, _ = env.step(gen, state, torch.zeros(4096, dtype=torch.long), params)
        assert torch.equal(obs[:, 1] == 0, torch.ones(4096, dtype=torch.bool)) or t == 1
    # the third step scored +1 where the bit was 0, -1 where it was 1, ended
    # every episode and reset it
    assert torch.equal(reward, torch.where(bit == 0, 1.0, -1.0))
    assert done.all() and (state.time == 0).all()
    assert (obs[:, 0] == 0).all() and (obs[:, 2].abs() == 1).all()


# ---- the network and its checkpoint ------------------------------------------------


def _inputs(seed=0, t=T, b=B, f=F, a=A):
    rng = np.random.RandomState(seed)
    x = rng.randn(t, b, f).astype(np.float32)
    done = rng.rand(t, b) < 0.2
    last_action = rng.randint(0, a, (t, b)).astype(np.int32)
    return x, done, last_action


NET_CASES = {
    "1gru_lastaction": dict(num_rnn_layers=1, add_last_action=True, norm_input=False),
    "2gru_normin": dict(num_rnn_layers=2, add_last_action=False, norm_input=True),
    "2gru_lastaction_normin": dict(num_rnn_layers=2, add_last_action=True, norm_input=True),
}


def _networks(kw, seed=3):
    jnet = JRNNQNetwork(action_dim=A, hidden_size=H, num_layers=2, cell_type="gru",
                        norm_type="layer_norm", **kw)
    x, done, la = _inputs()
    hs = [h + 0.3 for h in jnet.initialize_carry(B)]
    variables = jnet.init(jax.random.PRNGKey(seed), hs, jnp.asarray(x), jnp.asarray(done),
                          jnp.asarray(la), train=False)
    # move the running statistics off their init so that eval mode reads them
    variables = {**variables, "batch_stats": jax.tree_util.tree_map(lambda v: v + 0.25, variables["batch_stats"])}
    tnet = TRNNQNetwork(F, A, hidden_size=H, num_layers=2, **kw)
    tnet.load_state_dict(tckpt.params_from_flax(_np(variables)))
    return jnet, tnet, variables, hs


@pytest.mark.parametrize("case", sorted(NET_CASES))
def test_rnn_network_matches_flax(case):
    """From crossed weights, with resets, in train and eval mode: Q and the
    new hidden states within 1e-5, batch statistics within 1e-6."""
    jnet, tnet, variables, hs = _networks(NET_CASES[case])
    x, done, la = _inputs(1)
    ths = [torch.tensor(np.asarray(h)) for h in hs]
    args = (jnp.asarray(x), jnp.asarray(done), jnp.asarray(la))
    # eval mode first: a train-mode call moves the port's running statistics
    jh, jq = jnet.apply(variables, hs, *args, train=False)
    with torch.no_grad():
        th, tq = tnet(ths, torch.tensor(x), torch.tensor(done), torch.tensor(la), train=False)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-5, rtol=0)
    for a, b in zip(th, jh):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)
    (jh, jq), upd = jnet.apply(variables, hs, *args, train=True, mutable=["batch_stats"])
    th, tq = tnet(ths, torch.tensor(x), torch.tensor(done), torch.tensor(la), train=True)
    np.testing.assert_allclose(tq.detach().numpy(), np.asarray(jq), atol=1e-5, rtol=0)
    for a, b in zip(th, jh):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-5, rtol=0)
    stats = tckpt.params_to_flax(tnet)["batch_stats"]["BatchNorm_0"]
    for leaf in ("mean", "var"):
        np.testing.assert_allclose(stats[leaf], np.asarray(upd["batch_stats"]["BatchNorm_0"][leaf]), atol=1e-6, rtol=0)


def test_rnn_checkpoint_round_trip(tmp_path):
    """The port's params in flax names and layouts give flax's Q, and a
    safetensors file written by the port loads in the JAX package's loader
    with flax's tree and shapes (and back)."""
    kw = NET_CASES["2gru_lastaction_normin"]
    jnet, _, variables, hs = _networks(kw)
    tnet = TRNNQNetwork(F, A, hidden_size=H, num_layers=2, generator=torch.Generator().manual_seed(5), **kw)
    flax_vars = tckpt.params_to_flax(tnet)
    x, done, la = _inputs(2)
    _, jq = jnet.apply(jax.tree_util.tree_map(jnp.asarray, flax_vars), hs, jnp.asarray(x), jnp.asarray(done),
                       jnp.asarray(la), train=False)
    with torch.no_grad():
        _, tq = tnet([torch.tensor(np.asarray(h)) for h in hs], torch.tensor(x), torch.tensor(done),
                     torch.tensor(la), train=False)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-5, rtol=0)
    path = str(tmp_path / "rnn.safetensors")
    tckpt.save_params(flax_vars["params"], path)
    loaded = jckpt.load_params(path)
    shapes = lambda t: jax.tree_util.tree_map(lambda v: tuple(np.shape(v)), t)  # noqa: E731
    assert shapes(loaded) == shapes(variables["params"])
    assert "bias" not in loaded["ScannedRNN_1"]["GRUCell_0"]["hz"]
    back = TRNNQNetwork(F, A, hidden_size=H, num_layers=2, **kw)
    back.load_state_dict(tckpt.params_from_flax(tckpt.load_params(path)), strict=False)
    for (name, p), q in zip(back.named_parameters(), tnet.parameters()):
        assert torch.equal(p, q), name


# ---- the GRU scan: twins against the Pallas kernels ---------------------------------


def _scan_inputs(seed=0):
    rng = np.random.RandomState(seed)
    q, _ = np.linalg.qr(rng.randn(3 * H, 3 * H))
    return [np.asarray(a, np.float32) for a in (
        rng.randn(T, B, 3 * H), rng.rand(T, B, 1) > 0.2, 0.5 * rng.randn(B, H), q[:H],
        0.1 * rng.randn(H), rng.randn(T, B, H), rng.randn(B, H),
    )]


def test_gru_scan_fwd_plain_matches_pallas_interpret():
    """y, r, z, n and c of every step within 1e-6 of `_gru_core_fwd_call`
    in interpret mode."""
    xi, keep, h0, w_h, b_hn, _, _ = _scan_inputs()
    want = jfast._gru_core_fwd_call(*map(jnp.asarray, (xi, keep, h0, w_h, b_hn)), True)
    got = tgs.gru_scan_fwd(*map(torch.tensor, (xi, keep, h0, w_h, b_hn)))
    assert len(got) == 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)


def test_gru_scan_bwd_plain_matches_pallas_interpret_and_autograd():
    """On the same residuals and cotangents: dxi, dh0, dW_h and db_hn within
    1e-5 of `_gru_core_bwd` in interpret mode, and the grads of GRUScan
    (the twins, on the CPU) within 1e-5 of torch autograd through the plain
    forward loop."""
    xi, keep, h0, w_h, b_hn, g_y, g_hT = _scan_inputs(1)
    y, r, z, n, c = tgs.gru_scan_fwd_plain(*map(torch.tensor, (xi, keep, h0, w_h, b_hn)))
    hprev = torch.cat([torch.tensor(h0)[None], y[:-1]])
    res = (torch.tensor(keep), hprev, torch.tensor(w_h), r, z, n, c)
    got = tgs.gru_scan_bwd(*res, torch.tensor(g_y), torch.tensor(g_hT))
    want = jfast._gru_core_bwd(True, tuple(jnp.asarray(t.numpy()) for t in res), (jnp.asarray(g_hT), jnp.asarray(g_y)))
    for g, w in zip(got, (want[0], want[2], want[3], want[4])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)

    grads = []
    for use_function in (True, False):
        args = [torch.tensor(a, requires_grad=i != 1) for i, a in enumerate((xi, keep, h0, w_h, b_hn))]
        if use_function:
            h_T, ys = tgs.GRUScan.apply(*args)
        else:
            ys = tgs.gru_scan_fwd_plain(*args)[0]
            h_T = ys[-1]
        (torch.sum(torch.sin(ys) * torch.tensor(g_y)) + torch.sum(h_T * torch.tensor(g_hT))).backward()
        grads.append([a.grad for i, a in enumerate(args) if i != 1])
    for g, w in zip(*grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, rtol=0)
    # a cotangent autograd leaves undefined counts as zeros: h_T unused
    args = [torch.tensor(a, requires_grad=i != 1) for i, a in enumerate((xi, keep, h0, w_h, b_hn))]
    tgs.GRUScan.apply(*args)[1].sum().backward()
    assert torch.isfinite(args[3].grad).all()


@pytest.mark.parametrize("B", [1, 2, 3, 16, 96])
@pytest.mark.parametrize("H", [32, 96, 128, 256, 512, 1024])
def test_gru_scan_plan_covers_every_unit_and_row(H, B):
    """The kernels' launch plan: every hidden unit has one owner CTA and
    every row one cluster, clusters of at most 16 CTAs within a CTA's 227
    KB of shared memory, W_h resident up to H 512, a warp per 2 units."""
    plan = tgs.scan_plan(B, H)
    assert plan.cluster in (1, 2, 4, 8, 16)
    # CTA c owns units [c U, min(H, (c + 1) U))
    owners = [(c * plan.units, min(plan.units, H - c * plan.units)) for c in range(plan.cluster)]
    assert all(n >= 1 for _, n in owners)
    units = [u for first, n in owners for u in range(first, first + n)]
    assert units == list(range(H))
    assert plan.rows in (1, 2, 4, 8) and plan.clusters == -(-B // plan.rows)
    rows = [b for k in range(plan.clusters) for b in range(k * plan.rows, min(B, (k + 1) * plan.rows))]
    assert rows == list(range(B))
    assert plan.smem_bytes <= 232_448
    assert plan.resident == (H <= 512)
    assert plan.threads == 32 * min(-(-plan.units // 2), 32) and plan.threads <= 1024
    assert plan.registers == (H <= 256)
    if (B, H) == (2, 256):
        assert (plan.cluster, plan.units, plan.rows, plan.clusters) == (16, 16, 2, 1)


KW = dict(num_layers=2, num_rnn_layers=2, action_dim=A, add_last_action=True, norm_input=True)


def test_fast_rnn_train_forward_and_grads_match_jax():
    """`fast_rnn_train_forward` with the kernels' twins (pallas=True) and the
    plain loop against the JAX function with the Pallas kernels in interpret
    mode: Q, hidden and batch_stats, and the grads of sum(sin(q)) at JAX's
    own tolerance (atol 3e-5, rtol 1e-4)."""
    jnet, tnet, variables, hs = _networks({k: KW[k] for k in ("num_rnn_layers", "add_last_action", "norm_input")})
    x, done, la = _inputs(4)
    done_f = done.astype(np.float32)

    def jloss(p):
        newh, q, bs = jfast.fast_rnn_train_forward(
            p, variables["batch_stats"], hs, jnp.asarray(x), jnp.asarray(done_f), jnp.asarray(la),
            pallas=True, interpret=True, **KW,
        )
        return jnp.sum(jnp.sin(q)), (newh, q, bs)

    (_, (jh, jq, jbs)), jgrads = jax.value_and_grad(jloss, has_aux=True)(variables["params"])
    want_grads = tckpt.params_from_flax({"params": _np(jgrads)})
    for pallas in (True, False):
        params = dict(tnet.named_parameters())
        th, tq, tbs = tfast.fast_rnn_train_forward(
            params, dict(tnet.named_buffers()), [torch.tensor(np.asarray(h)) for h in hs],
            torch.tensor(x), torch.tensor(done_f), torch.tensor(la), pallas=pallas, **KW,
        )
        np.testing.assert_allclose(tq.detach().numpy(), np.asarray(jq), atol=1e-5, rtol=0)
        for a, b in zip(th, jh):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-5, rtol=0)
        for name in ("mean", "var"):
            np.testing.assert_allclose(tbs[f"BatchNorm_0.{name}"].numpy(),
                                       np.asarray(jbs["BatchNorm_0"][name]), atol=1e-6, rtol=0)
        grads = torch.autograd.grad(torch.sin(tq).sum(), list(params.values()), allow_unused=True,
                                    materialize_grads=True)
        for (name, _), g in zip(params.items(), grads):
            np.testing.assert_allclose(g.numpy(), want_grads[name].numpy(), atol=3e-5, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lambda_returns_closure_matches_jax(seed):
    rng = np.random.RandomState(seed)
    t, e = (17, 5) if seed else (1, 3)
    last_q, max_qs = rng.randn(e).astype(np.float32), rng.randn(t, e).astype(np.float32)
    rew = rng.randn(t, e).astype(np.float32)
    done = rng.rand(t, e) < 0.3
    want = jax_lambda_returns_closure(*map(jnp.asarray, (last_q, rew, done, max_qs)), 0.99, 0.95)
    got = lambda_returns_closure(*map(torch.tensor, (last_q, rew, done, max_qs)), 0.99, 0.95)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


# ---- one learn step, tiny runs ------------------------------------------------------


LEARN_KW = dict(num_rnn_layers=1, add_last_action=True, norm_input=False)


@pytest.fixture(scope="module")
def jax_learn_step():
    """A memory window made with JAX (random play of MemoryChain, memory
    length 4, through the JAX RNN network, 6 envs x 14 steps, the incoming
    hidden states, done flags and actions stored as pqn_rnn.py stores them),
    and one learn step on it by JAX's math (pqn_rnn.py:275-341) built from
    `fast_rnn_train_forward`, `lambda_returns_closure` and `make_optimizer`:
    the config, the variables, the window, the loss, the new params and the
    new batch_stats."""
    from purejaxql_torch.core.config import derive_pqn_schedule_keys

    config = derive_pqn_schedule_keys(compose(alg="pqn_rnn_memory_chain", overrides=[
        "DEVICE=cpu", "HIDDEN_SIZE=32", "NUM_MINIBATCHES=1", "NUM_EPOCHS=1"]))
    gamma, lam = config["GAMMA"], config["LAMBDA"]
    jnet = JRNNQNetwork(action_dim=2, hidden_size=32, num_layers=2, cell_type="gru", norm_type="layer_norm",
                        **LEARN_KW)
    jenv, jparams = jmake("MemoryChain-bsuite", memory_length=4)
    n, steps = 6, 14
    obs, state = jax.vmap(jenv.reset, in_axes=(0, None))(jax.random.split(jax.random.PRNGKey(0), n), jparams)
    hs = jnet.initialize_carry(n)
    variables = jnet.init(jax.random.PRNGKey(1), hs, obs[None], jnp.zeros((1, n)), jnp.zeros((1, n), jnp.int32),
                          train=False)
    apply = jax.jit(lambda v, h, o, d, a: jnet.apply(v, h, o[None], d[None], a[None], train=False)[0])
    step = jax.jit(jax.vmap(jenv.step, in_axes=(0, 0, 0, None)), static_argnums=3)
    rng = np.random.RandomState(0)
    done, last_action, rows = jnp.zeros(n, bool), jnp.zeros(n, jnp.int32), []
    for i in range(steps):
        new_hs = apply(variables, hs, obs, done, last_action)
        action = jnp.asarray(rng.randint(0, 2, n).astype(np.int32))
        new_obs, state, reward, new_done, _ = step(jax.random.split(jax.random.PRNGKey(10 + i), n), state, action, jparams)
        rows.append((obs, action, reward, new_done, hs[0], done, last_action))
        hs, obs, done, last_action = new_hs, new_obs, new_done, action
    window = [np.stack([np.asarray(r[k]) for r in rows]) for k in range(7)]
    w_obs, w_act, w_rew, w_done, w_hs, w_ldone, w_lact = window

    def loss_fn(p):
        _, q, bs = jfast.fast_rnn_train_forward(
            p, variables["batch_stats"], [jnp.asarray(w_hs[0])], jnp.asarray(w_obs), jnp.asarray(w_ldone),
            jnp.asarray(w_lact), num_layers=2, action_dim=2, **LEARN_KW,
        )
        tq = jax.lax.stop_gradient(q)
        target = jax_lambda_returns_closure(
            tq[-1].max(-1), jnp.asarray(w_rew)[:-1], jnp.asarray(w_done)[:-1], tq[:-1].max(-1), gamma, lam
        ).reshape(-1)
        chosen = jnp.take_along_axis(q, jnp.asarray(w_act)[..., None], -1).squeeze(-1)[:-1].reshape(-1)
        return 0.5 * jnp.square(chosen - target).mean(), bs

    tx = jax_make_optimizer(config["MAX_GRAD_NORM"], jax_lr_schedule(config))

    @jax.jit
    def learn(params):
        (loss, bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, _ = tx.update(grads, tx.init(params), params)
        return loss, optax.apply_updates(params, updates), bs

    jloss, new_params, jbs = learn(variables["params"])
    return config, variables, window, float(jloss), _np(new_params), _np(jbs)


@pytest.mark.parametrize("fast_bptt,pallas", [(False, False), (True, True)])
def test_learn_minibatch_matches_jax_math(jax_learn_step, fast_bptt, pallas):
    """One minibatch step (NUM_MINIBATCHES=1, NUM_EPOCHS=1) on the JAX-made
    window against JAX's (the fixture), through the network's module forward
    and through FAST_BPTT with the GRU scan's twins: the loss within 1e-5,
    new params within 1e-6 and batch_stats within 1e-6."""
    config, variables, window, jloss, new_params, jbs = jax_learn_step
    w_obs, w_act, w_rew, w_done, w_hs, w_ldone, w_lact = window
    steps, n = w_act.shape
    assert w_done.any() and (w_rew != 0).any()
    tnet = TRNNQNetwork(3, 2, hidden_size=32, num_layers=2, **LEARN_KW)
    tnet.load_state_dict(tckpt.params_from_flax(_np(variables)))
    opt = make_optimizer(tnet.parameters(), config["MAX_GRAD_NORM"], lr_schedule(config))
    mb = RNNTransition(
        obs=torch.tensor(w_obs), action=torch.tensor(w_act).long(), reward=torch.tensor(w_rew),
        done=torch.tensor(w_done), last_hs=(torch.tensor(w_hs),), last_done=torch.tensor(w_ldone),
        last_action=torch.tensor(w_lact).long(), q_val=torch.zeros(steps, n, 2),
    )
    loss, chosen = pqn_rnn.learn_minibatch(tnet, opt, mb, config["GAMMA"], config["LAMBDA"], fast_bptt, pallas)
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    assert chosen.shape == ((steps - 1) * n,)
    want = tckpt.params_from_flax({"params": new_params})
    for name, p in tnet.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-6, rtol=0, err_msg=name)
    for leaf in ("mean", "var"):
        np.testing.assert_allclose(getattr(tnet.BatchNorm_0, leaf).numpy(), jbs["BatchNorm_0"][leaf],
                                   atol=1e-6, rtol=0)


@pytest.mark.parametrize("fast_bptt,pallas", [(False, False), (True, True)])
def test_learn_minibatch_through_the_closure_wrapper_matches_the_loop(jax_learn_step, monkeypatch, fast_bptt,
                                                                      pallas):
    """The minibatch step takes its targets through
    ``ops.lambda_returns.lambda_returns_closure``, which on the CPU is the
    plain loop the step ran before: the same loss, chosen Q-values, params
    and batch_stats to the last bit as with the loop itself, and no launch
    counted."""
    config, variables, window, _, _, _ = jax_learn_step
    w_obs, w_act, w_rew, w_done, w_hs, w_ldone, w_lact = window
    steps, n = w_act.shape
    mb = RNNTransition(
        obs=torch.tensor(w_obs), action=torch.tensor(w_act).long(), reward=torch.tensor(w_rew),
        done=torch.tensor(w_done), last_hs=(torch.tensor(w_hs),), last_done=torch.tensor(w_ldone),
        last_action=torch.tensor(w_lact).long(), q_val=torch.zeros(steps, n, 2),
    )
    assert pqn_rnn.lambda_returns_closure is tlr.lambda_returns_closure
    results = []
    for targets in (tlr.lambda_returns_closure, lambda_returns_closure):
        monkeypatch.setattr(pqn_rnn, "lambda_returns_closure", targets)
        tnet = TRNNQNetwork(3, 2, hidden_size=32, num_layers=2, **LEARN_KW)
        tnet.load_state_dict(tckpt.params_from_flax(_np(variables)))
        opt = make_optimizer(tnet.parameters(), config["MAX_GRAD_NORM"], lr_schedule(config))
        before = tlr.lambda_returns_closure.launches
        loss, chosen = pqn_rnn.learn_minibatch(tnet, opt, mb, config["GAMMA"], config["LAMBDA"], fast_bptt, pallas)
        assert tlr.lambda_returns_closure.launches == before
        results.append([loss, chosen, *tnet.parameters(), *tnet.buffers()])
    for got, want in zip(*results):
        assert torch.equal(got, want)


@pytest.mark.parametrize("alg,extra", [
    ("pqn_rnn_cartpole", {}),
    ("pqn_rnn_memory_chain", {"FAST_BPTT": True, "PALLAS_BPTT": True, "MEMORY_WINDOW": 8}),
])
def test_tiny_rnn_train_counts_and_determinism(alg, extra):
    """The step, update and grad-step counts, finite metrics, the memory's
    length (MEMORY_WINDOW + NUM_STEPS), the eval, no kernel launch on the
    CPU, and one result per seed."""
    config = tiny_rnn_config(alg, TEST_DURING_TRAINING=True, TEST_NUM_ENVS=8, TEST_NUM_STEPS=24,
                             TEST_INTERVAL=0.25, **extra)
    before = (tgs.gru_scan_fwd.launches, tgs.gru_scan_bwd.launches, tlr.lambda_returns.launches,
              tlr.lambda_returns_closure.launches)
    out = pqn_rnn.make_train(config)()
    m = out["metrics"]
    n_updates = 2048 // 16 // 8
    assert int(m["env_step"][-1]) == 2048 and int(m["update_steps"][-1]) == n_updates
    assert int(m["grad_steps"][-1]) == n_updates * 2 * 2
    assert all(v.shape == (n_updates,) for v in m.values())
    assert torch.isfinite(m["td_loss"]).all() and torch.isfinite(m["qvals"]).all()
    assert torch.isfinite(m["test/returned_episode_returns"]).all()
    train_state, memory, carry, _ = out["runner_state"]
    assert memory.obs.shape[0] == config.get("MEMORY_WINDOW", 4) + 16
    assert memory.last_hs[0].shape == (memory.obs.shape[0], 8, 32)
    assert train_state.step == n_updates * 4
    assert (tgs.gru_scan_fwd.launches, tgs.gru_scan_bwd.launches, tlr.lambda_returns.launches,
            tlr.lambda_returns_closure.launches) == before
    again = pqn_rnn.make_train(config)()["runner_state"][0]
    for (name, x), y in zip(train_state.network.named_parameters(), again.network.parameters()):
        assert torch.equal(x, y), name
    other = pqn_rnn.make_train(config)(seed=1)
    assert not torch.equal(m["td_loss"], other["metrics"]["td_loss"])


def test_rnn_unsupported_options_raise():
    for kw in ({"RNN_CELL": "lstm"}, {"NORM_TYPE": "batch_norm"},
               {"INPUT_NORM_TYPE": "batch_renorm"}, {"BF16_COMPUTE": True}, {"NUM_SEEDS": 2},
               {"DONE_MASKED_INFO_METRICS": True}, {"USE_OPTIMISTIC_RESETS": True},
               {"RESET_BANK": 256}, {"LOG_VIA_CALLBACK": True}):
        with pytest.raises(NotImplementedError):
            pqn_rnn.make_train(tiny_rnn_config(**kw))
    with pytest.raises(ValueError, match="FAST_BPTT"):
        pqn_rnn.make_train(tiny_rnn_config(FAST_BPTT=True, NORM_TYPE="batch_norm"))
    with pytest.raises(ValueError, match="FAST_BPTT"):
        pqn_rnn.make_train(tiny_rnn_config(FAST_BPTT=True, PALLAS_BPTT=True, RNN_CELL="lstm"))
    # a dueling head is ported (the VDN slice), but not on the fast path, as in JAX
    with pytest.raises(ValueError, match="FAST_BPTT"):
        pqn_rnn.make_train(tiny_rnn_config(FAST_BPTT=True, DUELING=True))
    with pytest.raises(ValueError, match="NUM_MINIBATCHES"):
        pqn_rnn.make_train(tiny_rnn_config(NUM_MINIBATCHES=3))
    # an image observation is flattened as the JAX trainer flattens it
    # (pqn_rnn.py:72, tests/test_torch_options.py); kept whole, it is refused
    with pytest.raises(NotImplementedError, match="flat observations"):
        pqn_rnn.make_train(tiny_rnn_config(ENV_NAME="Breakout-MinAtar", FLATTEN_OBS=False))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pqn_rnn.make_train({**tiny_rnn_config(), "DEVICE": None})


def test_cuda_policy_turns_on_the_gru_kernels(capsys):
    cfg = compose(alg="pqn_rnn_memory_chain")
    assert cfg["FAST_BPTT"] is True and cfg["PALLAS_BPTT"] is True
    assert "FAST_BPTT=True, PALLAS_BPTT=True" in capsys.readouterr().err
    assert compose(alg="pqn_rnn_cartpole")["PALLAS_BPTT"] is True
    for ov in (["DEVICE=cpu"], ["PARITY=strict"]):
        cfg = compose(alg="pqn_rnn_memory_chain", overrides=ov)
        assert "FAST_BPTT" not in cfg and "PALLAS_BPTT" not in cfg
    cfg = compose(alg="pqn_rnn_memory_chain", overrides=["PALLAS_BPTT=False"])
    assert cfg["FAST_BPTT"] is True and cfg["PALLAS_BPTT"] is False
    cfg = compose(alg="pqn_rnn_memory_chain", overrides=["FAST_BPTT=False"])
    assert cfg["FAST_BPTT"] is False and "PALLAS_BPTT" not in cfg
    # outside the fast family nothing is turned on
    for ov in (["NORM_TYPE=batch_norm"], ["DUELING=True"]):
        cfg = compose(alg="pqn_rnn_memory_chain", overrides=ov)
        assert "FAST_BPTT" not in cfg and "PALLAS_BPTT" not in cfg
    cfg = compose(alg="pqn_rnn_memory_chain", overrides=["RNN_CELL=lstm"])
    assert cfg["FAST_BPTT"] is True and "PALLAS_BPTT" not in cfg


def test_rnn_cli_recipe_writes_what_the_jax_loader_reads(tmp_path, capsys):
    jsonl = tmp_path / "m.jsonl"
    cli.main([
        "+alg=pqn_rnn_memory_chain", "DEVICE=cpu", "TOTAL_TIMESTEPS=1024", "TOTAL_TIMESTEPS_DECAY=1024",
        "NUM_ENVS=8", "NUM_STEPS=16", "NUM_MINIBATCHES=2", "NUM_EPOCHS=1", "HIDDEN_SIZE=32",
        "TEST_NUM_ENVS=8", "TEST_NUM_STEPS=16", f"SAVE_PATH={tmp_path / 'models'}", f"LOG_JSONL={jsonl}",
    ])
    assert "Training took" in capsys.readouterr().out
    run_dir = tmp_path / "models" / "MemoryChain-bsuite"
    saved = jckpt.load_params(str(run_dir / "pqn_rnn_MemoryChain-bsuite_seed0.safetensors"))
    jnet = JRNNQNetwork(action_dim=2, hidden_size=32, num_layers=2, add_last_action=True)
    init = jnet.init(jax.random.PRNGKey(0), jnet.initialize_carry(1), jnp.zeros((1, 1, 3)),
                     jnp.zeros((1, 1)), jnp.zeros((1, 1), jnp.int32), train=False)["params"]
    shapes = lambda t: jax.tree_util.tree_map(lambda v: tuple(np.shape(v)), t)  # noqa: E731
    assert shapes(saved) == shapes(init)
    assert (run_dir / "pqn_rnn_MemoryChain-bsuite_seed0_config.yaml").exists()
    rows = [json.loads(line) for line in jsonl.read_text().splitlines()]
    assert len(rows) == 1024 // 16 // 8 and rows[-1]["env_step"] == 1024
    # the family still to port is refused by name
    with pytest.raises(SystemExit, match="not ported yet"):
        cli.main(["+alg=pqn_rnn_memory_chain", "DEVICE=cpu", "ALG_NAME=pqn_host"])


@pytest.mark.slow
def test_rnn_solves_memory_task_ff_does_not():
    """As tests/test_pqn_rnn.py holds the JAX package: on MemoryChain at its
    full config the recurrent trainer's last three greedy evals average above
    0.8, the feedforward trainer's stay below 0.5 (a few minutes on the CPU)."""
    from purejaxql_torch.algo import pqn

    rnn = compose(alg="pqn_rnn_memory_chain", overrides=["DEVICE=cpu", "TEST_NUM_STEPS=64", "FAST_BPTT=True",
                                                          "PALLAS_BPTT=True"])
    r = pqn_rnn.make_train(rnn)()["metrics"]["test/returned_episode_returns"]
    assert r[-3:].mean().item() > 0.8, r
    ff = compose(alg="pqn_rnn_memory_chain", overrides=["DEVICE=cpu", "TEST_NUM_STEPS=64", "ALG_NAME=pqn"])
    f = pqn.make_train(ff)()["metrics"]["test/returned_episode_returns"]
    assert f[-3:].mean().item() < 0.5, f
