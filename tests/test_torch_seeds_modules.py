"""NUM_SEEDS > 1 in the port's networks on the CPU, against ``jax.vmap`` of
the JAX package's modules over the lanes: the stacked BatchRenorm across its
warm-up (train, eval and frozen), the bfloat16 seed-stacked MLP (with
pqn_craftax's input BatchRenorm) and MinAtar CNN, three seeded Craftax
minibatch steps (concat 1-step TD and FAST_TARGETS), and the seeded BPTT
forward with a BatchRenorm input in float32 and bfloat16.

Sizes are tiny (2-3 lanes, H <= 64); weights come from ``jax.vmap(init)``
over split keys, moved off their init, and cross with ``params_from_flax``,
leading seed axis and all. Tolerances are each single-seed test's: the
same arithmetic a lane."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from purejaxql_torch.algo import pqn
from purejaxql_torch.core import checkpoint as tckpt
from purejaxql_torch.core.config import compose, derive_pqn_schedule_keys
from purejaxql_torch.core.optim import make_optimizer
from purejaxql_torch.core.schedules import lr_schedule
from purejaxql_torch.models.cnn import CNNQNetwork as TCNNQNetwork
from purejaxql_torch.models.qnet import QNetwork as TQNetwork
from purejaxql_torch.models.qnet import frozen_statistics
from purejaxql_torch.models.rnn import RNNQNetwork as TRNNQNetwork
from purejaxql_torch.models.stacked import StackedBatchRenorm
from purejaxql_torch.ops import fast_rnn as tfast
from purejaxql_tpu.core.optim import make_optimizer as jax_make_optimizer
from purejaxql_tpu.core.schedules import lr_schedule as jax_lr_schedule
from purejaxql_tpu.models.batch_renorm import BatchRenorm as JBatchRenorm
from purejaxql_tpu.models.cnn import CNNQNetwork as JCNNQNetwork
from purejaxql_tpu.models.qnet import QNetwork as JQNetwork
from purejaxql_tpu.models.rnn import RNNQNetwork as JRNNQNetwork
from purejaxql_tpu.ops import fast_rnn as jfast

torch.set_num_threads(1)

OBS_DIM, N_ACTIONS = 2883, 34
BF16_STEP = 2.0**-5  # tests/test_torch_bf16.py: two bfloat16 rounding steps of a value in [2, 4)
F32_BOUND = 0.05


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _gens(n):
    return [torch.Generator().manual_seed(100 + i) for i in range(n)]


def _fold(x):
    """(S, N, ...) -> seed-major rows (S * N, ...)."""
    return torch.tensor(np.asarray(x)).flatten(0, 1)


def _off_init(variables, seed, steps=None):
    """Vmapped flax variables with every param moved by 0.05 randn and each
    lane's running statistics off their init (mean 0.1 randn, var 1 +
    |randn|; a BatchRenorm's ``steps`` by lane where given)."""
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(lambda x: (np.asarray(x) + 0.05 * rng.randn(*np.shape(x))).astype(np.float32),
                                    variables["params"])

    def stat(path, x):
        name = path[-1].key
        if name == "mean":
            return (0.1 * rng.randn(*np.shape(x))).astype(np.float32)
        if name == "var":
            return (1 + np.abs(rng.randn(*np.shape(x)))).astype(np.float32)
        if name == "steps" and steps is not None:
            return np.asarray(steps, np.int32)
        return np.asarray(x)

    return {"params": params, "batch_stats": jax.tree_util.tree_map_with_path(stat, variables["batch_stats"])}


def _forager_like_obs(rng, s, n):
    obs = (rng.rand(s, n, OBS_DIM) < 0.03).astype(np.float32)
    obs[..., -48:] = rng.rand(s, n, 48).astype(np.float32)
    return obs


def _assert_state_equal(tnet, variables, atol, msg=""):
    want = tckpt.params_from_flax({"params": _np(variables["params"]), "batch_stats": _np(variables["batch_stats"])})
    for name, got in tnet.state_dict().items():
        np.testing.assert_allclose(got.numpy(), want[name].numpy(), atol=atol, rtol=0, err_msg=f"{msg} {name}")


# ---- the stacked BatchRenorm ---------------------------------------------------------


def test_stacked_batch_renorm_matches_vmapped_flax_across_warmup():
    """Five train-mode calls of 3 lanes (warm-up 3; the lanes start at steps
    0, 2 and 5, so one lane is warmed up from the first call, one from the
    second, one from the fourth) on shifted batches: outputs within 1e-6
    and the running statistics within 1e-6 relative (as
    tests/test_torch_craftax.py's single module), each lane's ``steps`` its
    own, the gradients of a loss with respect to the input, the scale and
    the bias within 1e-5; a frozen train call normalizes as a train call
    and leaves every buffer; then eval mode."""
    S, N, F = 3, 48, 8
    rng = np.random.RandomState(0)
    jmod = JBatchRenorm(use_running_average=False, warmup_steps=3, momentum=0.9)
    keys = jax.random.split(jax.random.PRNGKey(0), S)
    variables = _off_init(jax.jit(jax.vmap(lambda k: jmod.init(k, jnp.zeros((N, F)))))(keys), 1, steps=[0, 2, 5])
    tmod = StackedBatchRenorm(S, F, momentum=0.9, warmup_steps=3)
    sd = tckpt.params_from_flax({"params": {"m": variables["params"]}, "batch_stats": {"m": variables["batch_stats"]}})
    tmod.load_state_dict({k.removeprefix("m."): v for k, v in sd.items()})
    apply = jax.vmap(lambda v, x: jmod.apply(v, x, mutable=["batch_stats"]))

    def loss(params, xx, batch_stats, w):
        y, upd = apply({"params": params, "batch_stats": batch_stats}, xx)
        return (y * w).sum(), (y, upd)

    grad_fn = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))
    for step in range(5):
        x = (rng.randn(S, N, F) * (1 + step) + step * np.array([0.0, 1.0, -2.0])[:, None, None]).astype(np.float32)
        w = rng.randn(S, N, F).astype(np.float32)
        (_, (jy, upd)), (jg_p, jg_x) = grad_fn(variables["params"], jnp.asarray(x), variables["batch_stats"],
                                               jnp.asarray(w))
        if step == 2:  # a frozen call first: the train-mode output, no buffer moved
            before = {k: v.clone() for k, v in tmod.state_dict().items()}
            with torch.no_grad(), frozen_statistics(tmod):
                np.testing.assert_allclose(tmod(torch.tensor(x), train=True).numpy(), np.asarray(jy), atol=1e-6,
                                           rtol=1e-6)
            assert all(torch.equal(before[k], v) for k, v in tmod.state_dict().items())
        tx = torch.tensor(x, requires_grad=True)
        ty = tmod(tx, train=True)
        (ty * torch.tensor(w)).sum().backward()
        np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg_x), atol=1e-5, rtol=0)
        np.testing.assert_allclose(tmod.weight.grad.numpy(), np.asarray(jg_p["scale"]), atol=1e-5, rtol=1e-6)
        np.testing.assert_allclose(tmod.bias.grad.numpy(), np.asarray(jg_p["bias"]), atol=1e-5, rtol=1e-6)
        tmod.zero_grad()
        variables = {"params": variables["params"], "batch_stats": _np(upd["batch_stats"])}
        for leaf in ("mean", "var", "r_max", "d_max"):
            np.testing.assert_allclose(getattr(tmod, leaf).numpy(), variables["batch_stats"][leaf], atol=1e-6,
                                       rtol=1e-6, err_msg=f"{leaf} after step {step}")
        assert tmod.steps.tolist() == variables["batch_stats"]["steps"].tolist() == [step + 1, step + 3, step + 6]
    x = rng.randn(S, 16, F).astype(np.float32)
    want = jax.jit(jax.vmap(lambda v, xx: JBatchRenorm(use_running_average=True, warmup_steps=3).apply(v, xx)))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        np.testing.assert_allclose(tmod(torch.tensor(x), train=False).numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


# ---- bfloat16 with seeds ---------------------------------------------------------------


def _mlp(dtype_j, dtype_t, s):
    kw = dict(hidden_size=64, num_layers=2, norm_input=True, input_norm_type="batch_renorm")
    return (JQNetwork(action_dim=N_ACTIONS, dtype=dtype_j, **kw),
            TQNetwork(OBS_DIM, N_ACTIONS, dtype=dtype_t, generator=_gens(s), seeds=s, **kw))


def _cnn(dtype_j, dtype_t, s):
    return (JCNNQNetwork(action_dim=3, hidden_size=32, dtype=dtype_j),
            TCNNQNetwork((10, 10, 4), 3, hidden_size=32, dtype=dtype_t, generator=_gens(s), seeds=s))


# per network: its modules by dtype, an observation batch (S, N, ...)
NETS = {
    "mlp_input_batch_renorm": (_mlp, (1, OBS_DIM), lambda rng, s: _forager_like_obs(rng, s, 128)),
    "minatar_cnn": (_cnn, (1, 10, 10, 4), lambda rng, s: (rng.rand(s, 64, 10, 10, 4) < 0.2).astype(np.float32)),
}


@pytest.mark.parametrize("kind", sorted(NETS))
def test_bf16_stacked_network_matches_vmapped_flax(kind):
    """The bfloat16 seed-stacked network (3 lanes) in train mode against
    ``jax.vmap`` of flax's ``dtype=bfloat16`` module on the same weights, at
    tests/test_torch_bf16.py's tolerances: float32 Q-values within two
    bfloat16 steps, 95 % equal, and within F32_BOUND of its own float32
    forward; the statistics within 1e-6 (the input norm runs in float32);
    every activation of the trunk bfloat16, every parameter float32; in
    eval mode within F32_BOUND of its own float32 forward too."""
    S = 3
    make, init_shape, obs_fn = NETS[kind]
    jb, tb = make(jnp.bfloat16, torch.bfloat16, S)
    jf, tf = make(jnp.float32, torch.float32, S)
    keys = jax.random.split(jax.random.PRNGKey(5), S)
    variables = _off_init(jax.jit(jax.vmap(lambda k: jf.init(k, jnp.zeros(init_shape), train=False)))(keys), 2)
    sd = tckpt.params_from_flax(variables)
    tb.load_state_dict(sd)
    tf.load_state_dict(sd)
    obs = obs_fn(np.random.RandomState(1), S)
    # op by op, as tests/test_torch_bf16.py: jit lets XLA keep the bfloat16
    # products in float32 (excess precision), which the flax module rounds
    want, upd = jax.vmap(lambda v, x: jb.apply(v, x, train=True, mutable=["batch_stats"]))(variables, jnp.asarray(obs))
    want = np.asarray(want).reshape(-1, want.shape[-1])
    seen = {}
    for name, module in tb.named_modules():
        if name.startswith(("Dense_", "LayerNorm_", "CNN_0.")):
            module.register_forward_hook(lambda m, i, o, name=name: seen.__setitem__(name, o.dtype))
    with torch.no_grad():
        evals = [net(_fold(obs), train=False).numpy() for net in (tb, tf)]
        got = tb(_fold(obs), train=True)
        f32 = tf(_fold(obs), train=True).numpy()
    assert got.dtype == torch.float32 and set(seen.values()) == {torch.bfloat16}
    got = got.numpy()
    np.testing.assert_allclose(got, want, atol=BF16_STEP, rtol=0)
    assert (got == want).mean() > 0.95
    assert 0 < np.abs(got - f32).max() < F32_BOUND and 0 < np.abs(evals[0] - evals[1]).max() < F32_BOUND
    assert all(p.dtype == torch.float32 for p in tb.parameters())
    stats = tckpt.params_to_flax(tb)["batch_stats"]
    for name, leaves in _np(upd["batch_stats"]).items():
        for leaf, value in leaves.items():
            np.testing.assert_allclose(stats[name][leaf], value, atol=1e-6, rtol=1e-6, err_msg=f"{name}/{leaf}")


# ---- seeded Craftax minibatch steps ---------------------------------------------------


@pytest.mark.parametrize("form", ["concat", "fast_targets"])
def test_three_seeded_craftax_minibatch_steps_match_vmapped_jax(form):
    """Three 1-step-TD minibatch steps of 2 seeds with pqn_craftax's input
    BatchRenorm (lane 1 starts at steps 998, so its renorm correction
    engages on the third call; lane 0 stays in its warm-up), against the
    JAX compositions of tests/test_torch_craftax.py and
    tests/test_torch_reset_bank.py under ``jax.vmap``: the concat forward
    (pqn.py:515-534), or FAST_TARGETS' bootstrap under frozen statistics
    and the loss's forward on obs alone (pqn.py:459-503), each with
    pqn_craftax's clip + RAdam under ``jax.vmap``. Lane 0's rewards are
    large, lane 1's small, so that the loss must be each lane's own mean
    and the clip each lane's own norm: each lane's loss within 1e-5
    relative, params and batch statistics within 1e-5, ``steps`` one a grad
    step a lane."""
    S, n = 2, 96
    config = derive_pqn_schedule_keys(compose(alg="pqn_craftax", overrides=["DEVICE=cpu"]))
    gamma = config["GAMMA"]
    jnet, tnet = _mlp(jnp.float32, torch.float32, S)
    keys = jax.random.split(jax.random.PRNGKey(3), S)
    variables = _off_init(jax.jit(jax.vmap(lambda k: jnet.init(k, jnp.zeros((1, OBS_DIM)), train=False)))(keys), 3,
                          steps=[0, 998])
    tnet.load_state_dict(tckpt.params_from_flax(variables))
    tx = jax_make_optimizer(config["MAX_GRAD_NORM"], jax_lr_schedule(config))
    params, batch_stats = variables["params"], variables["batch_stats"]
    opt_state = jax.jit(jax.vmap(tx.init))(params)
    opt = make_optimizer(tnet.parameters(), config["MAX_GRAD_NORM"], lr_schedule(config), S)
    rng = np.random.RandomState(4)
    train_apply = lambda p, bs, x: jnet.apply({"params": p, "batch_stats": bs}, x, train=True,  # noqa: E731
                                              mutable=["batch_stats"])

    def lane_step(p, bs, os_, obs, act, next_obs, rew, done):
        def loss_fn(pp):
            if form == "concat":
                all_q, upd = train_apply(pp, bs, jnp.concatenate((obs, next_obs)))
                q, q_next = jnp.split(all_q, 2)
                q_next = jnp.max(jax.lax.stop_gradient(q_next), axis=-1)
            else:
                q_next = jnp.max(train_apply(p, bs, next_obs)[0], axis=-1)
                q, upd = train_apply(pp, bs, obs)
            tgt = rew + (1 - done) * gamma * q_next
            chosen = jnp.take_along_axis(q, act[:, None], axis=-1).squeeze(-1)
            return 0.5 * jnp.square(chosen - tgt).mean(), upd

        (loss, upd), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        updates, os_ = tx.update(grads, os_, p)
        return loss, optax.apply_updates(p, updates), upd["batch_stats"], os_

    step = jax.jit(jax.vmap(lane_step))
    learn = pqn.learn_minibatch_td if form == "concat" else pqn.learn_minibatch_fast_td
    for _ in range(3):
        obs, next_obs = _forager_like_obs(rng, S, n), _forager_like_obs(rng, S, n)
        act = rng.randint(0, N_ACTIONS, (S, n)).astype(np.int32)
        rew = (rng.choice([0.0, 1.0, -1.0], (S, n)) * np.array([[30.0], [0.01]])).astype(np.float32)
        done = rng.rand(S, n) < 0.1
        jloss, params, batch_stats, opt_state = step(
            params, batch_stats, opt_state, *map(jnp.asarray, (obs, act, next_obs, rew, done.astype(np.float32))))
        loss, _ = learn(tnet, opt, _fold(obs), _fold(act).long(), _fold(next_obs), _fold(rew), _fold(done), gamma)
        np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=1e-5)
        _assert_state_equal(tnet, {"params": params, "batch_stats": batch_stats}, 1e-5)
    assert tnet.BatchRenorm_0.steps.tolist() == [3, 1001]


# ---- the seeded BPTT forward with a BatchRenorm input ----------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_seeded_fast_rnn_forward_with_batch_renorm_matches_vmapped_jax(dtype):
    """``fast_rnn_train_forward`` of pqn_rnn_craftax's network (an LSTM, an
    input BatchRenorm, the last action) with 2 stacked lanes (lane 1 past
    its warm-up) on seed-major rows, against ``jax.vmap`` of the JAX
    function: Q within 1e-5 in float32 and, as tests/test_torch_lstm.py's
    bfloat16 forward, within 2e-3 in bfloat16; each lane's new statistics
    within 1e-6 and its ``steps`` one more; the module path's train forward
    of the stacked network equal to the function's in float32 (1e-5)."""
    S, T, B, F, H, A = 2, 6, 4, 10, 16, 5
    kw = dict(num_layers=1, num_rnn_layers=1, action_dim=A, add_last_action=True, norm_input=True,
              cell_type="lstm", input_norm_type="batch_renorm")
    jnet = JRNNQNetwork(action_dim=A, hidden_size=H, num_layers=1, num_rnn_layers=1, cell_type="lstm",
                        norm_type="layer_norm", norm_input=True, input_norm_type="batch_renorm", add_last_action=True)
    rng = np.random.RandomState(0)
    x = (rng.randn(T, S, B, F) * 2 + 1).astype(np.float32)
    done = (rng.rand(T, S, B) < 0.2).astype(np.float32)
    la = rng.randint(0, A, (T, S, B)).astype(np.int32)
    hs1 = jnet.initialize_carry(B)
    keys = jax.random.split(jax.random.PRNGKey(3), S)
    variables = _off_init(jax.jit(jax.vmap(lambda k: jnet.init(k, hs1, jnp.asarray(x[:, 0]), jnp.asarray(done[:, 0]),
                                                               jnp.asarray(la[:, 0]), train=False)))(keys), 4,
                          steps=[3, 2000])
    hs = jax.tree_util.tree_map(lambda h: jnp.asarray(0.3 * rng.randn(S, *h.shape).astype(np.float32)), hs1)
    jdtype, tdtype = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    jh, jq, jbs = jax.jit(jax.vmap(lambda v, h, *a: jfast.fast_rnn_train_forward(
        v["params"], v["batch_stats"], h, *a, compute_dtype=jdtype, **kw)))(
        variables, hs, *(jnp.asarray(a).swapaxes(0, 1) for a in (x, done, la)))
    tnet = TRNNQNetwork(F, A, hidden_size=H, num_layers=1, cell_type="lstm", norm_input=True,
                        input_norm_type="batch_renorm", add_last_action=True, generator=_gens(S), seeds=S)
    tnet.load_state_dict(tckpt.params_from_flax(variables))
    rows = lambda a: torch.tensor(np.asarray(a)).flatten(1, 2)  # noqa: E731  (T, S, B, ...) -> (T, S * B, ...)
    thidden = [tuple(_fold(v) for v in h) for h in hs]
    _, tq, tbs = tfast.fast_rnn_train_forward(dict(tnet.named_parameters()), dict(tnet.named_buffers()), thidden,
                                              rows(x), rows(done), rows(la), compute_dtype=tdtype, seeds=S, **kw)
    want = rows(np.asarray(jq).swapaxes(0, 1)).numpy()
    np.testing.assert_allclose(tq.detach().numpy(), want, atol=2e-3 if dtype == "bfloat16" else 1e-5, rtol=0)
    for leaf in ("mean", "var"):
        np.testing.assert_allclose(tbs[f"BatchRenorm_0.{leaf}"].numpy(), np.asarray(jbs["BatchRenorm_0"][leaf]),
                                   atol=1e-6, rtol=0)
    assert tbs["BatchRenorm_0.steps"].tolist() == np.asarray(jbs["BatchRenorm_0"]["steps"]).tolist() == [4, 2001]
    if dtype == "float32":
        with torch.no_grad():
            _, mq = tnet(thidden, rows(x), rows(done), rows(la).long(), train=True)
        np.testing.assert_allclose(mq.numpy(), want, atol=1e-5, rtol=0)
