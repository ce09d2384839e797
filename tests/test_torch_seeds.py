"""NUM_SEEDS > 1 in the port on the CPU: the seed-stacked networks, learn
steps and GRU scan twins against ``jax.vmap`` of the JAX package's, and the
seeded trainers inside the port (stacked against S single networks, lane
init for every family, NUM_SEEDS=1 unchanged in every trainer, tiny runs,
the CLI's per-seed checkpoints, FUSED_ROLLOUT's refusal, the options that
train with seeds, and the cuda policy); tests/test_torch_seeds_modules.py,
_envs.py and _trainers.py hold the rest against ``jax.vmap``.

Sizes are tiny (S 2-3, H <= 32, a few envs); weights come from
``jax.vmap(network.init)`` over split keys and cross with
``params_from_flax``, leading seed axis and all."""

import hashlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from purejaxql_torch import cli
from purejaxql_torch.algo import pqn, pqn_ac, pqn_rnn, pqn_vdn, seeds
from purejaxql_torch.algo.types import RNNTransition
from purejaxql_torch.core import checkpoint as tckpt
from purejaxql_torch.core.config import compose, derive_pqn_schedule_keys
from purejaxql_torch.core.optim import make_optimizer
from purejaxql_torch.core.schedules import lr_schedule
from purejaxql_torch.models.actor_critic import Actor, CriticEnsemble
from purejaxql_torch.models.cnn import CNNQNetwork as TCNNQNetwork
from purejaxql_torch.models.factory import make_q_network, make_rnn_q_network
from purejaxql_torch.models.qnet import QNetwork as TQNetwork
from purejaxql_torch.models.rnn import RNNQNetwork as TRNNQNetwork
from purejaxql_torch.ops import fast_rnn as tfast
from purejaxql_torch.ops import gru_scan as tgs
from purejaxql_torch.utils.logging import MetricLogger, Sink
from purejaxql_tpu.algo.returns import lambda_returns_closure as jax_lambda_returns_closure
from purejaxql_tpu.core import checkpoint as jckpt
from purejaxql_tpu.core.optim import make_optimizer as jax_make_optimizer
from purejaxql_tpu.core.schedules import lr_schedule as jax_lr_schedule
from purejaxql_tpu.models.cnn import CNNQNetwork as JCNNQNetwork
from purejaxql_tpu.models.qnet import QNetwork as JQNetwork
from purejaxql_tpu.models.rnn import RNNQNetwork as JRNNQNetwork
from purejaxql_tpu.ops import fast_rnn as jfast

torch.set_num_threads(1)

S = 3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _gens(n):
    return [torch.Generator().manual_seed(100 + i) for i in range(n)]


def _fold(x):
    """(S, N, ...) -> seed-major rows (S * N, ...)."""
    return torch.tensor(np.asarray(x)).flatten(0, 1)


# per family: the flax network, the port's seed-stacked one, a batch of
# observations from a numpy generator (S, N, ...) and the number of actions
FAMILIES = {
    "mlp": (
        "pqn_cartpole",
        lambda: JQNetwork(action_dim=2, hidden_size=32, num_layers=2),
        lambda s: TQNetwork(obs_dim=4, action_dim=2, hidden_size=32, generator=_gens(s), seeds=s),
        lambda rng, s, n: (rng.randn(s, n, 4) * [0.5, 1.0, 0.05, 1.0]).astype(np.float32),
        2,
    ),
    "cnn": (
        "pqn_minatar",
        lambda: JCNNQNetwork(action_dim=3, hidden_size=16),
        lambda s: TCNNQNetwork((6, 6, 4), 3, hidden_size=16, generator=_gens(s), seeds=s),
        lambda rng, s, n: (rng.rand(s, n, 6, 6, 4) < 0.2).astype(np.float32),
        3,
    ),
}


def _vmapped_init(jnet, obs1, n_seeds, *args):
    keys = jax.random.split(jax.random.PRNGKey(7), n_seeds)
    return jax.jit(jax.vmap(lambda k: jnet.init(k, obs1, *args, train=False)))(keys)


# ---- the stacked networks against jax.vmap ------------------------------------------


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_stacked_network_matches_vmapped_flax(family):
    """Eval and train forwards of the seed-stacked MLP and MinAtar CNN from
    ``jax.vmap(init)``'s weights against ``jax.vmap(apply)`` within 1e-5,
    each seed's BatchNorm statistics within 1e-5, and the weights back in
    flax's vmapped tree."""
    _, make_jnet, make_tnet, make_obs, _ = FAMILIES[family]
    rng = np.random.RandomState(0)
    jnet, tnet = make_jnet(), make_tnet(S)
    variables = _vmapped_init(jnet, jnp.asarray(make_obs(rng, 1, 1)[0]), S)
    # running statistics off their init, so that eval mode reads them
    variables = {**variables, "batch_stats": jax.tree_util.tree_map(lambda v: v + 0.25, variables["batch_stats"])}
    tnet.load_state_dict(tckpt.params_from_flax(_np(variables)))
    obs = make_obs(rng, S, 12)
    jq = jax.jit(jax.vmap(lambda v, x: jnet.apply(v, x, train=False)))(variables, jnp.asarray(obs))
    with torch.no_grad():
        tq = tnet(_fold(obs), train=False)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq).reshape(tq.shape), atol=1e-5, rtol=0)
    jq, upd = jax.jit(jax.vmap(lambda v, x: jnet.apply(v, x, train=True, mutable=["batch_stats"])))(
        variables, jnp.asarray(obs))
    tq = tnet(_fold(obs), train=True)
    np.testing.assert_allclose(tq.detach().numpy(), np.asarray(jq).reshape(tq.shape), atol=1e-5, rtol=0)
    stats = tckpt.params_to_flax(tnet)["batch_stats"]["BatchNorm_0"]
    for leaf in ("mean", "var"):
        np.testing.assert_allclose(stats[leaf], np.asarray(upd["batch_stats"]["BatchNorm_0"][leaf]), atol=1e-5, rtol=0)
    shapes = lambda t: jax.tree_util.tree_map(lambda v: tuple(np.shape(v)), t)  # noqa: E731
    assert shapes(tckpt.params_to_flax(tnet)["params"]) == shapes(variables["params"])


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_three_seeded_minibatch_steps_match_vmapped_jax(family):
    """Three minibatch steps of 3 seeds from ``jax.vmap(init)``'s weights:
    the vmapped flax train-mode forward, the loss of pqn.py:536-541 and
    make_optimizer under ``jax.vmap``, against ``learn_minibatch`` on the
    seed-major rows, with test_torch_pqn.py's tolerances. Seed 0's targets
    are large enough that its gradient norm exceeds MAX_GRAD_NORM and seed
    1's small enough that it does not: the loss must be each seed's own
    mean and the clip each seed's own norm (seed 1's targets are its own
    Q-values plus a little noise)."""
    alg, make_jnet, make_tnet, make_obs, n_actions = FAMILIES[family]
    config = derive_pqn_schedule_keys(compose(alg=alg, overrides=["DEVICE=cpu"]))
    rng = np.random.RandomState(1)
    jnet, tnet = make_jnet(), make_tnet(S)
    variables = _vmapped_init(jnet, jnp.asarray(make_obs(rng, 1, 1)[0]), S)
    tx = jax_make_optimizer(config["MAX_GRAD_NORM"], jax_lr_schedule(config))
    params, batch_stats = variables["params"], variables["batch_stats"]
    opt_state = jax.vmap(tx.init)(params)
    tnet.load_state_dict(tckpt.params_from_flax(_np(variables)))
    opt = make_optimizer(tnet.parameters(), config["MAX_GRAD_NORM"], lr_schedule(config), S)
    scale = np.array([300.0, 0.01, 2.0], np.float32)[:, None]

    def loss_fn(p, bs, obs, act, tgt):
        q, upd = jnet.apply({"params": p, "batch_stats": bs}, obs, train=True, mutable=["batch_stats"])
        chosen = jnp.take_along_axis(q, act[:, None], axis=-1).squeeze(-1)
        return 0.5 * jnp.square(chosen - tgt).mean(), (upd, chosen)

    grad_fn = jax.jit(jax.vmap(jax.value_and_grad(loss_fn, has_aux=True)))
    update = jax.jit(jax.vmap(tx.update))
    for step in range(3):
        obs = make_obs(rng, S, 32)
        act = rng.randint(0, n_actions, (S, 32)).astype(np.int32)
        noise = (rng.randn(S, 32) * scale).astype(np.float32)
        _, (_, chosen) = grad_fn(params, batch_stats, jnp.asarray(obs), jnp.asarray(act), jnp.zeros((S, 32)))[0]
        tgt = np.asarray(chosen) + noise
        (jloss, (upd, _)), grads = grad_fn(params, batch_stats, jnp.asarray(obs), jnp.asarray(act), jnp.asarray(tgt))
        norms = np.asarray(jax.vmap(optax.global_norm)(grads))
        assert norms[0] > config["MAX_GRAD_NORM"] > norms[1], norms
        updates, opt_state = update(grads, opt_state, params)
        new_params = optax.apply_updates(params, updates)
        batch_stats = upd["batch_stats"]

        before = {k: v.detach().clone() for k, v in tnet.named_parameters()}
        loss, _ = pqn.learn_minibatch(tnet, opt, _fold(obs), _fold(act).long(), _fold(tgt))
        np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=1e-5)
        want_new = tckpt.params_from_flax({"params": _np(new_params)})
        want_old = tckpt.params_from_flax({"params": _np(params)})
        for name, p in tnet.named_parameters():
            got = p.detach()
            np.testing.assert_allclose(got.numpy(), want_new[name].numpy(), atol=1e-6, rtol=0, err_msg=name)
            d_want = (want_new[name] - want_old[name]).numpy()
            d_got = (got - before[name]).numpy()
            ulp = np.spacing(np.abs(want_new[name].numpy()).max())
            np.testing.assert_allclose(
                d_got, d_want, rtol=0, atol=max(1e-4 * np.abs(d_want).max(), 2 * ulp), err_msg=name
            )
        stats = tckpt.params_to_flax(tnet)["batch_stats"]["BatchNorm_0"]
        for leaf in ("mean", "var"):
            np.testing.assert_allclose(
                stats[leaf], np.asarray(batch_stats["BatchNorm_0"][leaf]), rtol=1e-5, atol=1e-7
            )
        params = new_params
    assert opt.count == 3


RT, RB, RF, RH, RA = 7, 3, 5, 16, 3


def _rnn_inputs(seed, s=S):
    rng = np.random.RandomState(seed)
    x = rng.randn(RT, s, RB, RF).astype(np.float32)
    done = rng.rand(RT, s, RB) < 0.2
    last_action = rng.randint(0, RA, (RT, s, RB)).astype(np.int32)
    return x, done, last_action


def _rnn_pair(cell, s=S, **kw):
    """The flax RNN network and the port's seed-stacked one from
    ``jax.vmap(init)``'s weights, and each seed's carry (S, B, H)."""
    kw = {"num_rnn_layers": 1, "add_last_action": True, "norm_input": True, **kw}
    jnet = JRNNQNetwork(action_dim=RA, hidden_size=RH, num_layers=2, cell_type=cell, norm_type="layer_norm", **kw)
    x, done, la = _rnn_inputs(0, s)
    hs1 = jnet.initialize_carry(RB)
    keys = jax.random.split(jax.random.PRNGKey(3), s)
    variables = jax.jit(jax.vmap(lambda k: jnet.init(k, hs1, jnp.asarray(x[:, 0]), jnp.asarray(done[:, 0]),
                                                     jnp.asarray(la[:, 0]), train=False)))(keys)
    variables = {**variables, "batch_stats": jax.tree_util.tree_map(lambda v: v + 0.25, variables["batch_stats"])}
    tnet = TRNNQNetwork(RF, RA, hidden_size=RH, num_layers=2, cell_type=cell, generator=_gens(s), seeds=s, **kw)
    tnet.load_state_dict(tckpt.params_from_flax(_np(variables)))
    rng = np.random.RandomState(9)
    hs = jax.tree_util.tree_map(lambda h: jnp.asarray(0.3 * rng.randn(s, *h.shape).astype(np.float32)), hs1)
    return jnet, tnet, variables, hs


def _t_carry(hs):
    """flax's per-seed carries (S, B, H) as the port's seed-major (S * B, H)."""
    return [tuple(_fold(v) for v in h) if isinstance(h, tuple) else _fold(h) for h in hs]


def _seed_major(x):
    """(T, S, B, ...) -> (T, S * B, ...)."""
    return torch.tensor(np.asarray(x)).flatten(1, 2)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_stacked_rnn_network_matches_vmapped_flax(cell):
    """The seed-stacked RNNQNetwork (GRU and LSTM cells, the dense trunk, a
    BatchNorm input, the last action) from ``jax.vmap(init)``'s weights:
    Q and the new carries in eval and train mode within 1e-5 of
    ``jax.vmap(apply)``, each seed's batch statistics within 1e-6."""
    jnet, tnet, variables, hs = _rnn_pair(cell)
    x, done, la = _rnn_inputs(1)
    args = [jnp.asarray(a).swapaxes(0, 1) for a in (x, done, la)]  # each seed's (T, B, ...)
    targs = [_seed_major(a) for a in (x, done, la)]
    for train in (False, True):
        if train:
            (jh, jq), upd = jax.jit(jax.vmap(
                lambda v, h, *a: jnet.apply(v, h, *a, train=True, mutable=["batch_stats"])))(variables, hs, *args)
        else:
            jh, jq = jax.jit(jax.vmap(lambda v, h, *a: jnet.apply(v, h, *a, train=False)))(variables, hs, *args)
        with torch.set_grad_enabled(train):
            th, tq = tnet(_t_carry(hs), *targs, train=train)
        np.testing.assert_allclose(tq.detach().numpy(), _seed_major(np.asarray(jq).swapaxes(0, 1)).numpy(),
                                   atol=1e-5, rtol=0)
        for a, b in zip(jax.tree_util.tree_leaves(_t_carry(jh)), jax.tree_util.tree_leaves(th)):
            np.testing.assert_allclose(b.detach().numpy(), a.numpy(), atol=1e-5, rtol=0)
    for leaf in ("mean", "var"):
        np.testing.assert_allclose(getattr(tnet.BatchNorm_0, leaf).numpy(),
                                   np.asarray(upd["batch_stats"]["BatchNorm_0"][leaf]), atol=1e-6, rtol=0)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_seeded_fast_rnn_train_forward_and_grads_match_vmapped_jax(cell):
    """``fast_rnn_train_forward`` with stacked params on seed-major rows (for
    GRU through the seeded scan twins and through the plain loop) against
    ``jax.vmap`` of the JAX function: Q, carries and each seed's batch
    statistics, and the grads of sum(sin(q)) at JAX's tolerance (atol 3e-5,
    rtol 1e-4)."""
    jnet, tnet, variables, hs = _rnn_pair(cell)
    x, done, la = _rnn_inputs(4)
    kw = dict(num_layers=2, num_rnn_layers=1, action_dim=RA, add_last_action=True, norm_input=True)
    jargs = [jnp.asarray(a).swapaxes(0, 1) for a in (x, done.astype(np.float32), la)]

    def jloss(p, bs, h, *a):
        newh, q, nbs = jfast.fast_rnn_train_forward(p, bs, h, *a, cell_type=cell, **kw)
        return jnp.sum(jnp.sin(q)), (newh, q, nbs)

    (_, (jh, jq, jbs)), jgrads = jax.jit(jax.vmap(jax.value_and_grad(jloss, has_aux=True)))(
        variables["params"], variables["batch_stats"], hs, *jargs)
    want_grads = tckpt.params_from_flax({"params": _np(jgrads)})
    for pallas in ((True, False) if cell == "gru" else (False,)):
        params = dict(tnet.named_parameters())
        th, tq, tbs = tfast.fast_rnn_train_forward(
            params, dict(tnet.named_buffers()), _t_carry(hs), _seed_major(x), _seed_major(done.astype(np.float32)),
            _seed_major(la), cell_type=cell, pallas=pallas, seeds=S, **kw,
        )
        np.testing.assert_allclose(tq.detach().numpy(), _seed_major(np.asarray(jq).swapaxes(0, 1)).numpy(),
                                   atol=1e-5, rtol=0)
        for a, b in zip(jax.tree_util.tree_leaves(_t_carry(jh)), jax.tree_util.tree_leaves(th)):
            np.testing.assert_allclose(b.detach().numpy(), a.numpy(), atol=1e-5, rtol=0)
        for name in ("mean", "var"):
            np.testing.assert_allclose(tbs[f"BatchNorm_0.{name}"].numpy(), np.asarray(jbs["BatchNorm_0"][name]),
                                       atol=1e-6, rtol=0)
        grads = torch.autograd.grad(torch.sin(tq).sum(), list(params.values()), allow_unused=True,
                                    materialize_grads=True)
        for (name, _), g in zip(params.items(), grads):
            np.testing.assert_allclose(g.numpy(), want_grads[name].numpy(), atol=3e-5, rtol=1e-4, err_msg=name)


def test_seeded_gru_scan_twins_match_vmapped_pallas_interpret():
    """The seeded twins (a stacked W_h, seed-major rows) against
    ``jax.vmap(_gru_core(..., interpret=True))`` at (S 2, T 5, B 3, H 8):
    h_T and y within 1e-6, and the grads of random cotangents of both
    through GRUScan within 1e-5 of the vmapped ``jax.vjp``."""
    s, t, b, h = 2, 5, 3, 8
    rng = np.random.RandomState(0)
    xi, g_y = (rng.randn(s, t, b, k * h).astype(np.float32) for k in (3, 1))
    keep = (rng.rand(s, t, b, 1) > 0.2).astype(np.float32)
    h0 = (0.5 * rng.randn(s, b, h)).astype(np.float32)
    w_h = np.stack([np.linalg.qr(rng.randn(3 * h, 3 * h))[0][:h] for _ in range(s)]).astype(np.float32)
    b_hn = (0.1 * rng.randn(s, h)).astype(np.float32)
    g_hT = rng.randn(s, b, h).astype(np.float32)

    def core(*a):
        return jfast._gru_core(*a, True)

    (want_hT, want), vjp = jax.vjp(jax.vmap(core), *map(jnp.asarray, (xi, keep, h0, w_h, b_hn)))
    want_grads = vjp((jnp.asarray(g_hT), jnp.asarray(g_y)))
    rows = lambda a: torch.tensor(a).transpose(0, 1).flatten(1, 2)  # noqa: E731  (S, T, B, .) -> (T, S B, .)
    args = [rows(xi), rows(keep), torch.tensor(h0).flatten(0, 1), torch.tensor(w_h), torch.tensor(b_hn)]
    args = [a.requires_grad_(i != 1) for i, a in enumerate(args)]
    h_T, y = tgs.GRUScan.apply(*args)
    np.testing.assert_allclose(y.detach().numpy(), rows(np.asarray(want)).numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(h_T.detach().numpy(), np.asarray(want_hT).reshape(s * b, h), atol=1e-6, rtol=0)
    ((y * rows(g_y)).sum() + (h_T * torch.tensor(g_hT).flatten(0, 1)).sum()).backward()
    for i, got in ((0, args[0].grad), (2, args[2].grad), (3, args[3].grad), (4, args[4].grad)):
        w = np.asarray(want_grads[i])
        w = rows(w) if i == 0 else torch.tensor(w).flatten(0, 1) if i == 2 else torch.tensor(w)
        np.testing.assert_allclose(got.numpy(), w.numpy(), atol=1e-5, rtol=0, err_msg=str(i))


def test_seeded_rnn_learn_minibatch_matches_vmapped_jax():
    """One recurrent minibatch step of 2 seeds (a window each, the closure
    targets, MAX_GRAD_NORM crossed by one seed and not the other) against
    the vmapped JAX learn step of test_torch_rnn.py (pqn_rnn.py:275-341):
    each seed's loss within 1e-5, new params within 1e-6, batch statistics
    within 1e-6; through the module path and FAST_BPTT with the twins."""
    s = 2
    config = derive_pqn_schedule_keys(compose(alg="pqn_rnn_memory_chain", overrides=[
        "DEVICE=cpu", "HIDDEN_SIZE=16", "NUM_MINIBATCHES=1", "NUM_EPOCHS=1"]))
    gamma, lam = config["GAMMA"], config["LAMBDA"]
    jnet, _, variables, hs = _rnn_pair("gru", s, norm_input=False)
    rng = np.random.RandomState(5)
    x, ldone, lact = _rnn_inputs(6, s)
    act = rng.randint(0, RA, (RT, s, RB))
    rew = (rng.randn(RT, s, RB) * np.array([80.0, 0.05])[None, :, None]).astype(np.float32)
    done = rng.rand(RT, s, RB) < 0.2
    kw = dict(num_layers=2, num_rnn_layers=1, action_dim=RA, add_last_action=True, norm_input=False)
    tx = jax_make_optimizer(config["MAX_GRAD_NORM"], jax_lr_schedule(config))

    def loss_fn(p, bs, h, obs, ld, la, a, r, d):
        _, q, nbs = jfast.fast_rnn_train_forward(p, bs, h, obs, ld, la, **kw)
        tq = jax.lax.stop_gradient(q)
        target = jax_lambda_returns_closure(tq[-1].max(-1), r[:-1], d[:-1], tq[:-1].max(-1), gamma, lam).reshape(-1)
        chosen = jnp.take_along_axis(q, a[..., None], -1).squeeze(-1)[:-1].reshape(-1)
        return 0.5 * jnp.square(chosen - target).mean(), nbs

    def learn(p, bs, *window):
        (loss, nbs), grads = jax.value_and_grad(loss_fn, has_aux=True)(p, bs, *window)
        updates, _ = tx.update(grads, tx.init(p), p)
        return loss, optax.apply_updates(p, updates), nbs, optax.global_norm(grads)

    window = [jnp.asarray(a).swapaxes(0, 1) for a in (x, ldone.astype(np.float32), lact, act, rew, done.astype(np.float32))]
    jloss, new_params, jbs, norms = jax.jit(jax.vmap(learn))(variables["params"], variables["batch_stats"], hs, *window)
    assert norms[0] > config["MAX_GRAD_NORM"] > norms[1], norms
    want = tckpt.params_from_flax({"params": _np(new_params)})
    mb = RNNTransition(
        obs=_seed_major(x), action=_seed_major(act).long(), reward=_seed_major(rew), done=_seed_major(done),
        last_hs=(_seed_major(np.broadcast_to(np.asarray(hs[0])[None], (RT, s, RB, RH))),),
        last_done=_seed_major(ldone), last_action=_seed_major(lact).long(), q_val=torch.zeros(RT, s * RB, RA),
    )
    for fast_bptt in (False, True):
        tnet = TRNNQNetwork(RF, RA, hidden_size=RH, num_layers=2, generator=_gens(s), seeds=s,
                            num_rnn_layers=1, add_last_action=True, norm_input=False)
        tnet.load_state_dict(tckpt.params_from_flax(_np(variables)))
        opt = make_optimizer(tnet.parameters(), config["MAX_GRAD_NORM"], lr_schedule(config), s)
        loss, chosen = pqn_rnn.learn_minibatch(tnet, opt, mb, gamma, lam, fast_bptt, fast_bptt)
        np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=1e-5)
        assert chosen.shape == ((RT - 1) * s * RB,)
        for name, p in tnet.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-6, rtol=0, err_msg=name)
        for leaf in ("mean", "var"):
            np.testing.assert_allclose(getattr(tnet.BatchNorm_0, leaf).numpy(), np.asarray(jbs["BatchNorm_0"][leaf]),
                                       atol=1e-6, rtol=0)


# ---- inside the port ----------------------------------------------------------------


def _singles(stacked_net, make_single, n):
    """n single networks holding lane i of the stacked one's weights."""
    nets = []
    for i in range(n):
        net = make_single()
        net.load_state_dict({k: v[i] for k, v in stacked_net.state_dict().items()})
        nets.append(net)
    return nets


@pytest.mark.parametrize("learn", ["learn_minibatch", "learn_minibatch_td", "learn_minibatch_fast_td"])
def test_stacked_learn_step_equals_s_single_steps(learn):
    """Each FF learn function on 3 seeds' folded minibatch against the same
    function run on each seed's network and optimizer alone: losses, params
    and batch statistics to float tolerance, two steps."""
    config = derive_pqn_schedule_keys(compose(alg="pqn_cartpole", overrides=["DEVICE=cpu", "NORM_TYPE=batch_norm"]))
    kw = dict(obs_dim=4, action_dim=2, hidden_size=16, norm_type="batch_norm")
    stacked = TQNetwork(**kw, generator=_gens(S), seeds=S)
    singles = _singles(stacked, lambda: TQNetwork(**kw), S)
    opt = make_optimizer(stacked.parameters(), config["MAX_GRAD_NORM"], lr_schedule(config), S)
    opts = [make_optimizer(n.parameters(), config["MAX_GRAD_NORM"], lr_schedule(config)) for n in singles]
    fn = getattr(pqn, learn)
    rng = np.random.RandomState(2)
    for _ in range(2):
        obs, next_obs = (torch.tensor(rng.randn(S, 32, 4).astype(np.float32)) for _ in range(2))
        act = torch.tensor(rng.randint(0, 2, (S, 32)))
        tgt = torch.tensor((rng.randn(S, 32) * [[50.0], [0.1], [1.0]]).astype(np.float32))
        done = torch.tensor(rng.rand(S, 32) < 0.3)
        extra = lambda i: () if learn == "learn_minibatch" else (next_obs[i], tgt[i], done[i], 0.99)  # noqa: E731
        args = lambda i: (obs[i], act[i]) + ((tgt[i],) if learn == "learn_minibatch" else ()) + extra(i)  # noqa: E731
        loss, _ = fn(stacked, opt, *(a.flatten(0, 1) if torch.is_tensor(a) else a for a in args(slice(None))))
        for i in range(S):
            loss_i, _ = fn(singles[i], opts[i], *args(i))
            torch.testing.assert_close(loss[i], loss_i, atol=1e-6, rtol=1e-5)
    for i, net in enumerate(singles):
        for (name, got), want in zip(stacked.state_dict().items(), net.state_dict().values()):
            torch.testing.assert_close(got[i], want, atol=1e-6, rtol=1e-5, msg=name)


def test_stacked_rnn_learn_step_equals_s_single_steps():
    """The recurrent learn_minibatch on 3 seeds' folded window (FAST_BPTT
    through the seeded GRU twins) against each seed's network alone."""
    config = derive_pqn_schedule_keys(compose(alg="pqn_rnn_memory_chain", overrides=["DEVICE=cpu"]))
    kw = dict(obs_dim=RF, action_dim=RA, hidden_size=RH, num_layers=2, add_last_action=True)
    stacked = TRNNQNetwork(**kw, generator=_gens(S), seeds=S)
    singles = _singles(stacked, lambda: TRNNQNetwork(**kw), S)
    opt = make_optimizer(stacked.parameters(), config["MAX_GRAD_NORM"], lr_schedule(config), S)
    rng = np.random.RandomState(3)
    x, ldone, lact = _rnn_inputs(7)
    fields = dict(obs=x, action=rng.randint(0, RA, (RT, S, RB)), reward=rng.randn(RT, S, RB).astype(np.float32),
                  done=rng.rand(RT, S, RB) < 0.2, last_done=ldone, last_action=lact)
    hs = (0.3 * rng.randn(RT, S, RB, RH)).astype(np.float32)

    def window(sl):
        t = {k: torch.tensor(np.asarray(v)[:, sl]).flatten(1, 2) for k, v in fields.items()}
        return RNNTransition(obs=t["obs"], action=t["action"].long(), reward=t["reward"], done=t["done"],
                             last_hs=(torch.tensor(hs[:, sl]).flatten(1, 2),), last_done=t["last_done"],
                             last_action=t["last_action"].long(), q_val=torch.zeros(RT, t["obs"].shape[1], RA))

    loss, _ = pqn_rnn.learn_minibatch(stacked, opt, window(slice(None)), 0.99, 0.95, True, True)
    for i, net in enumerate(singles):
        opt_i = make_optimizer(net.parameters(), config["MAX_GRAD_NORM"], lr_schedule(config))
        loss_i, _ = pqn_rnn.learn_minibatch(net, opt_i, window(slice(i, i + 1)), 0.99, 0.95, True, True)
        torch.testing.assert_close(loss[i], loss_i, atol=1e-6, rtol=1e-5)
        for (name, got), want in zip(stacked.state_dict().items(), net.state_dict().values()):
            torch.testing.assert_close(got[i], want, atol=1e-6, rtol=1e-5, msg=name)


def _lane_networks(alg, extra, generator, n_seeds):
    """The networks a trainer of ``alg`` draws, in its order, from one
    generator or (``n_seeds`` > 1) from a list of them, and the members a
    seed of each (the critic ensemble's M)."""
    config = compose(alg=alg, overrides=["DEVICE=cpu", "HIDDEN_SIZE=16", "SEED=4"]
                     + [f"{k}={v}" for k, v in extra.items()])
    if alg == "pqn_pendulum":
        kw = dict(generator=generator, seeds=n_seeds)
        return [(Actor(3, 1, 2.0, 0.0, [16, 16], **kw), 1), (CriticEnsemble(2, 3, 1, [16, 16], **kw), 2)]
    if alg.startswith("pqn_vdn"):
        return [(make_rnn_q_network({**config, "ADD_LAST_ACTION": False}, 5, (14,), generator=generator,
                                    norms=(config["NORM_TYPE"], "batch_norm"), hidden_size=256, seeds=n_seeds), 1)]
    make = make_rnn_q_network if alg.startswith("pqn_rnn") else make_q_network
    obs_shape = {"pqn_minatar": (10, 10, 4), "pqn_craftax": (2883,)}.get(alg, (3,) if alg.startswith("pqn_rnn") else (4,))
    return [(make(config, 3, obs_shape, generator=generator, seeds=n_seeds), 1)]


@pytest.mark.parametrize("alg,extra", [
    ("pqn_cartpole", {}), ("pqn_minatar", {"ENV_NAME": "Breakout-MinAtar"}),
    ("pqn_rnn_memory_chain", {}), ("pqn_rnn_memory_chain", {"RNN_CELL": "lstm"}),
    ("pqn_craftax", {"NUM_LAYERS": 2}), ("pqn_rnn_craftax", {}), ("pqn_vdn_spread", {}), ("pqn_pendulum", {}),
])
def test_lane_i_is_the_single_seed_network_of_seed_plus_i(alg, extra):
    """The seed rule (``algo/seeds.py:seed_generators``): lane i of the
    stacked network is, bit for bit, the network a single-seed run with
    SEED + i draws (MLP, MinAtar CNN, GRU and LSTM networks, the craftax
    family's with their BatchRenorm input, the VDN network, and the
    actor-critic pair, lane i's critics the i-th block of M members)."""
    stacked = _lane_networks(alg, extra, seeds.seed_generators(4, S), S)
    for i in range(S):
        single = _lane_networks(alg, extra, torch.Generator().manual_seed(4 + i), 1)
        for (net, m), (one, _) in zip(stacked, single):
            for (name, want), got in zip(one.state_dict().items(), net.state_dict().values()):
                lane = got[i * m:(i + 1) * m] if m > 1 else got[i]
                assert torch.equal(lane, want), (i, name)


def _digest(out):
    h = hashlib.sha256()
    state = out["runner_state"][0]
    nets = [st.network for _, st in sorted(state.items())] if isinstance(state, dict) else [state.network]
    for net in nets:
        for name, t in sorted(list(net.named_parameters()) + list(net.named_buffers())):
            h.update(name.encode())
            h.update(t.detach().contiguous().numpy().tobytes())
    for k, v in sorted(out["metrics"].items()):
        h.update(k.encode())
        h.update(v.contiguous().numpy().tobytes())
    return h.hexdigest()[:32]


TINY = ["DEVICE=cpu", "TOTAL_TIMESTEPS=1024", "TOTAL_TIMESTEPS_DECAY=1024", "NUM_ENVS=8", "NUM_STEPS=16",
        "NUM_MINIBATCHES=2", "NUM_EPOCHS=2", "HIDDEN_SIZE=32", "TEST_DURING_TRAINING=True", "TEST_NUM_ENVS=8",
        "TEST_NUM_STEPS=24", "TEST_INTERVAL=0.5"]
AC_TINY = ["ACTOR_HIDDEN_SIZES=[32,32]", "CRITIC_HIDDEN_SIZES=[32,32]"]
CRAFTAX_TINY = ["OPTIMISTIC_RESET_RATIO=4", "NUM_LAYERS=2"]
# sha256 of every final parameter, statistic and metric of a NUM_SEEDS=1
# run, recorded on the commit before the seed axis came in (the FF and
# recurrent trainers), or before it came to that trainer or option (craftax,
# pqn_rnn_craftax, VDN, actor-critic)
ONE_SEED_RUNS = {
    "cartpole": ("pqn_cartpole", [], "9b1752111a6ef42055182b9fc1c39f04"),
    "cartpole_td": ("pqn_cartpole", ["Q_LAMBDA=False", "DONE_MASKED_INFO_METRICS=True"],
                    "95e57b4fe68dde8cba34ced29c1b7203"),
    "cartpole_fast_td": ("pqn_cartpole", ["Q_LAMBDA=False", "FAST_TARGETS=True", "NUM_MINIBATCHES=1",
                                          "SKIP_NOOP_PERMUTE=True"], "3ae44e8f8f56d7c271e6db8b8c1de8bc"),
    "breakout": ("pqn_minatar", ["ENV_NAME=Breakout-MinAtar", "NORM_TYPE=layer_norm"],
                 "90c93bf7a0157348681d3dc05064bf79"),
    "memory_chain": ("pqn_rnn_memory_chain", [], "9d2e3c16842af0b177206c1a16fe78a8"),
    "memory_chain_fast": ("pqn_rnn_memory_chain", ["FAST_BPTT=True", "PALLAS_BPTT=True"],
                          "f7192c5b41379dcb77a98228f3d97f19"),
    "craftax": ("pqn_craftax", CRAFTAX_TINY, "2fddbbca7e8bd3e4c6250714cb70b3ca"),
    "craftax_fast_bf16": ("pqn_craftax", CRAFTAX_TINY + [
        "RESET_BANK=8", "RESET_BANK_REFRESH_EVERY=4", "FAST_TARGETS=True", "NUM_MINIBATCHES=1",
        "SKIP_NOOP_PERMUTE=True", "BF16_COMPUTE=True"], "0a3b2cb9daf5b41053d4c095a15f3d5f"),
    "rnn_craftax_fast_bf16": ("pqn_rnn_craftax", [
        "OPTIMISTIC_RESET_RATIO=4", "NUM_LAYERS=1", "MEMORY_WINDOW=4", "RESET_BANK=8", "RESET_BANK_REFRESH_EVERY=4",
        "FAST_BPTT=True", "BF16_COMPUTE=True"], "d8fd2075bc7a779f9ae02fb766dc2c80"),
    "vdn_spread_fast": ("pqn_vdn_spread", ["MEMORY_WINDOW=2", "FAST_BPTT=True", "PALLAS_BPTT=True"],
                        "f145e029776711b96032650a24929044"),
    "pendulum": ("pqn_pendulum", AC_TINY, "cb0a3003aaca0a8f4571476a6edf5281"),
    "pendulum_normalized": ("pqn_pendulum", AC_TINY + ["NORMALIZE_OBS=True", "NORMALIZE_REWARD=True"],
                            "da9d46b6edacd1593f4fa3dfe7711eed"),
}


def _trainer(alg):
    if alg.startswith("pqn_rnn"):
        return pqn_rnn
    if alg.startswith("pqn_vdn"):
        return pqn_vdn
    return pqn_ac if alg in ("pqn_pendulum", "pqn_reacher", "pqn_locomotion") else pqn


@pytest.mark.parametrize("case", sorted(ONE_SEED_RUNS))
def test_one_seed_runs_as_before_bit_for_bit(case):
    """NUM_SEEDS=1 runs the single-seed program: tiny CartPole (lambda
    returns, concat 1-step TD, FAST_TARGETS), Breakout (the CNN, unfused),
    MemoryChain (module path, FAST_BPTT with the scan's twins), pqn_craftax
    (optimistic resets; the bank, FAST_TARGETS and bf16), pqn_rnn_craftax
    (the bank, FAST_BPTT in bf16), VDN Spread (the scan's twins) and
    Pendulum (unfused, with and without both normalizers) give the final
    params, statistics and metrics recorded before the seed axis, to the
    last bit."""
    alg, extra, want = ONE_SEED_RUNS[case]
    assert _digest(_trainer(alg).make_train(compose(alg=alg, overrides=TINY + extra))()) == want


@pytest.mark.parametrize("alg,extra", [
    ("pqn_cartpole", []), ("pqn_minatar", ["ENV_NAME=Breakout-MinAtar", "HIDDEN_SIZE=16"]),
    ("pqn_rnn_memory_chain", ["FAST_BPTT=True", "PALLAS_BPTT=True"]),
])
def test_tiny_seeded_train_shapes_lanes_and_determinism(alg, extra):
    """A tiny NUM_SEEDS=3 run: every metric (3, NUM_UPDATES), the counters
    one seed's, the envs and carries seed-major, the lanes' params and
    losses different, and a second run equal to the bit."""
    trainer = pqn_rnn if alg.startswith("pqn_rnn") else pqn
    config = compose(alg=alg, overrides=TINY + extra + ["NUM_SEEDS=3"])
    out = trainer.make_train(config)()
    m = out["metrics"]
    n_updates = 1024 // 16 // 8
    assert all(v.shape == (S, n_updates) for v in m.values())
    assert (m["env_step"][:, -1] == 1024).all() and (m["grad_steps"][:, -1] == n_updates * 4).all()
    assert torch.isfinite(m["td_loss"]).all() and len(set(m["td_loss"][:, -1].tolist())) == S
    ts = out["runner_state"][0]
    assert ts.timesteps == 1024
    w = ts.network.state_dict()["Dense_0.weight"]
    assert w.shape[0] == S and not torch.equal(w[0], w[1])
    if trainer is pqn_rnn:
        assert out["runner_state"][1].obs.shape[1] == S * 8 and out["runner_state"][2][0][0].shape == (S * 8, 32)
    again = trainer.make_train(config)()
    for (name, x), y in zip(ts.network.state_dict().items(), again["runner_state"][0].network.state_dict().values()):
        assert torch.equal(x, y), name


def test_cli_with_two_seeds_writes_per_seed_files_the_jax_loader_reads(tmp_path, capsys):
    """``NUM_SEEDS=2``: the aggregate rate counts both seeds, one
    ``_vmap{i}`` file a seed, no single-seed file; the JAX loader reads file
    i into flax's tree, whose network gives lane i's Q-values (within
    1e-5); and the JSONL rows of seed 0, then seed 1."""
    jsonl = tmp_path / "m.jsonl"
    outs = cli.single_run(compose(alg="pqn_cartpole", overrides=[
        "DEVICE=cpu", "NUM_SEEDS=2", "TOTAL_TIMESTEPS=1024", "TOTAL_TIMESTEPS_DECAY=1024",
        "NUM_ENVS=8", "NUM_STEPS=16", "NUM_MINIBATCHES=2", "NUM_EPOCHS=1", "HIDDEN_SIZE=32",
        "TEST_DURING_TRAINING=False", f"SAVE_PATH={tmp_path / 'models'}", f"LOG_JSONL={jsonl}",
    ]))
    assert "— 2048 env steps" in capsys.readouterr().out
    run_dir = tmp_path / "models" / "CartPole-v1"
    assert not (run_dir / "pqn_CartPole-v1_seed0.safetensors").exists()
    jnet = JQNetwork(action_dim=2, hidden_size=32, num_layers=2)
    variables = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 4)), train=False)
    shapes = lambda t: jax.tree_util.tree_map(lambda v: tuple(np.shape(v)), t)  # noqa: E731
    obs = np.random.RandomState(0).randn(2, 6, 4).astype(np.float32)
    with torch.no_grad():
        tq = outs["runner_state"][0].network(_fold(obs), train=False).reshape(2, 6, 2)
    for i in range(2):
        saved = jckpt.load_params(str(run_dir / f"pqn_CartPole-v1_seed0_vmap{i}.safetensors"))
        assert shapes(saved) == shapes(variables["params"])
        # the unused input norm's statistics are not saved: the init's serve
        jq = jnet.apply({"params": saved, "batch_stats": variables["batch_stats"]}, jnp.asarray(obs[i]), train=False)
        np.testing.assert_allclose(tq[i].numpy(), np.asarray(jq), atol=1e-5, rtol=0)
    assert not torch.equal(tq[0], tq[1])
    rows = [json.loads(line) for line in jsonl.read_text().splitlines()]
    assert [r["update_steps"] for r in rows] == list(range(1, 9)) * 2


def test_checkpoint_crosses_a_seed_stacked_cnn_both_ways():
    """A seed-stacked conv (S, O, I, H, W) is flax's vmapped HWIO kernel (S,
    H, W, I, O), and back."""
    net = TCNNQNetwork((10, 10, 4), 3, hidden_size=16, generator=_gens(2), seeds=2)
    tree = tckpt.params_to_flax(net)
    assert tree["params"]["CNN_0"]["Conv_0"]["kernel"].shape == (2, 3, 3, 4, 16)
    np.testing.assert_array_equal(tree["params"]["CNN_0"]["Conv_0"]["kernel"][1],
                                  net.CNN_0.Conv_0.weight[1].detach().numpy().transpose(2, 3, 1, 0))
    back = TCNNQNetwork((10, 10, 4), 3, hidden_size=16, generator=_gens(2), seeds=2)
    torch.nn.init.zeros_(back.CNN_0.Conv_0.weight)
    back.load_state_dict(tckpt.params_from_flax(tree))
    assert all(torch.equal(a, b) for a, b in zip(back.parameters(), net.parameters()))


def test_log_history_replays_each_seed_in_turn():
    rows = []

    class Rows(Sink):
        def log(self, metrics, step):
            rows.append((step, float(metrics["td_loss"])))

    MetricLogger([Rows()]).log_history({
        "update_steps": torch.tensor([[1, 2], [1, 2]]), "td_loss": torch.tensor([[0.5, 0.25], [2.0, 1.0]]),
    })
    assert rows == [(1, 0.5), (2, 0.25), (1, 2.0), (2, 1.0)]


@pytest.mark.parametrize("trainer,alg,kw", [
    (pqn, "pqn_cartpole", {"FUSED_ROLLOUT": True}),
])
def test_what_stays_single_seed_is_refused_with_seeds(trainer, alg, kw):
    """FUSED_ROLLOUT, whose kernels run one seed (the JAX CLI refuses it
    with seeds too), raises NotImplementedError naming it with NUM_SEEDS >
    1; every other option trains with seeds
    (``test_what_ran_single_seed_now_trains_with_seeds``)."""
    config = {**compose(alg=alg, overrides=TINY), "NUM_SEEDS": 2, **kw}
    with pytest.raises(NotImplementedError, match=next(iter(kw))):
        trainer.make_train(config)


@pytest.mark.parametrize("trainer,alg,kw", [
    (pqn, "pqn_cartpole", {"BATCH_ENV": True}),
    (pqn, "pqn_cartpole", {"USE_OPTIMISTIC_RESETS": True, "OPTIMISTIC_RESET_RATIO": 4}),
    (pqn, "pqn_cartpole", {"USE_OPTIMISTIC_RESETS": True, "OPTIMISTIC_RESET_RATIO": 4, "RESET_BANK": 8}),
    (pqn, "pqn_cartpole", {"BF16_COMPUTE": True}),
    (pqn, "pqn_cartpole", {"INPUT_NORM_TYPE": "batch_renorm", "NORM_INPUT": True}),
    (pqn_rnn, "pqn_rnn_memory_chain", {"BATCH_ENV": True}),
    (pqn_rnn, "pqn_rnn_memory_chain", {"BF16_COMPUTE": True, "FAST_BPTT": True}),
    (pqn_rnn, "pqn_rnn_memory_chain", {"INPUT_NORM_TYPE": "batch_renorm", "NORM_INPUT": True}),
])
def test_what_ran_single_seed_now_trains_with_seeds(trainer, alg, kw):
    """The options the port refused with seeds before (the batched env
    modes, the reset bank, BF16_COMPUTE, a BatchRenorm input) train a tiny
    NUM_SEEDS=2 run: every metric (2, NUM_UPDATES), the losses finite, the
    lanes' losses apart."""
    config = {**compose(alg=alg, overrides=TINY), "NUM_SEEDS": 2, **kw}
    m = trainer.make_train(config)()["metrics"]
    assert all(v.shape == (2, 1024 // 16 // 8) for v in m.values())
    assert torch.isfinite(m["td_loss"]).all() and torch.isfinite(m["qvals"]).all()
    assert not torch.equal(m["td_loss"][0], m["td_loss"][1])


def test_cuda_policy_with_four_seeds():
    """On cuda (the default DEVICE) NUM_SEEDS=4 never fuses a rollout, as the
    JAX policy (purejaxql_tpu/core/config.py:113-118), and turns on the
    epsilon-greedy kernel, and for the recurrent trainer FAST_BPTT and
    PALLAS_BPTT, as for one seed."""
    for alg in ("pqn_cartpole", "pqn_minatar"):
        cfg = compose(alg=alg, overrides=["NUM_SEEDS=4"])
        assert "FUSED_ROLLOUT" not in cfg and "EVAL_EARLY_EXIT" not in cfg
        assert cfg["EXPLORATION_KERNEL"] == "pallas"
        assert compose(alg=alg)["FUSED_ROLLOUT"] is True
    for alg in ("pqn_rnn_memory_chain", "pqn_rnn_cartpole"):
        cfg = compose(alg=alg, overrides=["NUM_SEEDS=4"])
        assert (cfg["FAST_BPTT"], cfg["PALLAS_BPTT"], cfg["EXPLORATION_KERNEL"]) == (True, True, "pallas")
