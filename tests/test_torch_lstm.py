"""The port's LSTM slice on the CPU against the JAX package: flax's
OptimizedLSTMCell and the recurrent network with LSTM cells and a
BatchRenorm input norm (eval and train mode, gradients, the new batch
statistics, fresh and past BatchRenorm's warm-up), their checkpoint crossing
both ways, the FAST_BPTT forward's LSTM and BatchRenorm branches, the
mixed-precision product and the bfloat16 forward, tiny ``pqn_rnn_craftax``
runs (the module path against FAST_BPTT; BATCH_ENV and the reset bank with
done-masked metrics and the eval on), the cuda policy and the CLI recipe.

Sizes are tiny (T 13, B 4, F 6, H 32, as tests/test_fast_rnn.py; the trainer
at H 32, 8 envs x 8 steps); no JAX trainer runs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from purejaxql_torch import cli
from purejaxql_torch.algo import pqn_rnn
from purejaxql_torch.core import checkpoint as tckpt
from purejaxql_torch.core.config import compose
from purejaxql_torch.envs import wrappers
from purejaxql_torch.models.rnn import OptimizedLSTMCell
from purejaxql_torch.models.rnn import RNNQNetwork as TRNNQNetwork
from purejaxql_torch.ops import eps_greedy as teg
from purejaxql_torch.ops import fast_rnn as tfast
from purejaxql_torch.ops import lambda_returns as tlr
from purejaxql_tpu.core import checkpoint as jckpt
from purejaxql_tpu.models.rnn import RNNQNetwork as JRNNQNetwork
from purejaxql_tpu.ops import fast_rnn as jfast

torch.set_num_threads(1)

T, B, F, H, A = 13, 4, 6, 32, 3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _inputs(seed=0, t=T, b=B, f=F, a=A):
    rng = np.random.RandomState(seed)
    x = (1.5 * rng.randn(t, b, f) + 0.5).astype(np.float32)
    done = rng.rand(t, b) < 0.2
    last_action = rng.randint(0, a, (t, b)).astype(np.int32)
    return x, done, last_action


def _carry(tree):
    return [tuple(torch.tensor(np.asarray(v)) for v in layer) for layer in tree]


# ---- the cell ----------------------------------------------------------------------


def test_lstm_cell_matches_flax_forward_and_grads():
    """One step of flax's OptimizedLSTMCell from crossed weights: the new
    (c, h) within 1e-6, the gradients of sum(sin(c') + cos(h')) for every
    kernel, bias and the inputs within 1e-5; the flax tree's names and
    layouts (ii..io without bias, hi..ho with)."""
    rng = np.random.RandomState(0)
    x, c, h = (rng.randn(B, n).astype(np.float32) for n in (F, H, H))
    jcell = fnn.OptimizedLSTMCell(H)
    params = jcell.init(jax.random.PRNGKey(1), (jnp.asarray(c), jnp.asarray(h)), jnp.asarray(x))["params"]
    assert sorted(params) == sorted(["ii", "if", "ig", "io", "hi", "hf", "hg", "ho"])
    assert all("bias" not in params[f"i{g}"] and "bias" in params[f"h{g}"] for g in "ifgo")

    def jloss(p, c, h, x):
        (c2, h2), _ = jcell.apply({"params": p}, (c, h), x)
        return jnp.sum(jnp.sin(c2) + jnp.cos(h2)), (c2, h2)

    (_, (jc, jh)), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        params, jnp.asarray(c), jnp.asarray(h), jnp.asarray(x))
    tcell = OptimizedLSTMCell(F, H)
    tcell.load_state_dict(tckpt.params_from_flax(_np(params)))
    tc, th, tx = (torch.tensor(v, requires_grad=True) for v in (c, h, x))
    c2, h2 = tcell((tc, th), tx)
    np.testing.assert_allclose(c2.detach().numpy(), np.asarray(jc), atol=1e-6, rtol=0)
    np.testing.assert_allclose(h2.detach().numpy(), np.asarray(jh), atol=1e-6, rtol=0)
    names = [n for n, _ in tcell.named_parameters()]
    grads = torch.autograd.grad((torch.sin(c2) + torch.cos(h2)).sum(), [*tcell.parameters(), tc, th, tx])
    want = tckpt.params_from_flax(_np(jgrads[0]))
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-5, rtol=0, err_msg=name)
    for g, w in zip(grads[len(names):], jgrads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)


# ---- the network and its checkpoint -------------------------------------------------

NET_CASES = {
    # the pqn_rnn_craftax shape: BatchRenorm input, NORM_INPUT, the last action in
    "renorm_normin_lastaction_2lstm": dict(num_rnn_layers=2, add_last_action=True, norm_input=True,
                                           input_norm_type="batch_renorm"),
    # tests/test_pqn_rnn.py::test_rnn_lstm_multilayer_dueling's head on the module path
    "renorm_normin_2lstm_dueling": dict(num_rnn_layers=2, add_last_action=True, norm_input=True,
                                        input_norm_type="batch_renorm", dueling=True),
    # the input norm a dummy (rnn.py:125-128): its statistics move all the same
    "renorm_dummy_1lstm": dict(num_rnn_layers=1, add_last_action=False, norm_input=False,
                               input_norm_type="batch_renorm"),
    "batchnorm_dummy_1lstm": dict(num_rnn_layers=1, add_last_action=False, norm_input=False,
                                  input_norm_type="batch_norm"),
}


def _moved_stats(batch_stats, steps):
    """Running statistics off their init, far enough from the inputs' moments
    that BatchRenorm's r and d clip once warmed up; ``steps`` its count."""
    rng = np.random.RandomState(7)
    out = {}
    for name, stats in batch_stats.items():
        stats = dict(_np(stats))
        stats["mean"] = (2.0 * rng.randn(F)).astype(np.float32)
        stats["var"] = rng.uniform(0.01, 2.0, F).astype(np.float32)
        if "steps" in stats:
            stats["steps"] = np.asarray(steps, np.int32)
        out[name] = stats
    return out


def _networks(kw, steps=0, seed=3):
    jnet = JRNNQNetwork(action_dim=A, hidden_size=H, num_layers=1, cell_type="lstm", norm_type="layer_norm", **kw)
    x, done, la = _inputs()
    hs = [jax.tree_util.tree_map(lambda v: v + 0.3, c) for c in jnet.initialize_carry(B)]
    variables = jnet.init(jax.random.PRNGKey(seed), hs, jnp.asarray(x), jnp.asarray(done), jnp.asarray(la),
                          train=False)
    variables = {"params": _np(variables["params"]), "batch_stats": _moved_stats(variables["batch_stats"], steps)}
    tnet = TRNNQNetwork(F, A, hidden_size=H, num_layers=1, cell_type="lstm", **kw)
    tnet.load_state_dict(tckpt.params_from_flax(variables))
    return jnet, tnet, variables, hs


@pytest.mark.parametrize("case,steps", [(case, steps) for case in sorted(NET_CASES)
                                        for steps in ((0, 1500) if "renorm" in case else (0,))])
def test_lstm_network_matches_flax(case, steps):
    """From crossed weights, with resets: eval mode (running statistics),
    then train mode as ``network.apply(train=True, mutable=["batch_stats"])``
    (batch statistics, BatchRenorm's clipped r and d once ``steps`` >= 1,000):
    Q and the new (c, h) of every layer within 1e-5, the gradients of
    sum(sin(q)) within 1e-5 absolute and relative (the head bias's sums 52
    terms near 1: float32 rounding in another order), the new batch
    statistics within 1e-5 (the step count exact)."""
    jnet, tnet, variables, hs = _networks(NET_CASES[case], steps)
    x, done, la = _inputs(1)
    args = (jnp.asarray(x), jnp.asarray(done), jnp.asarray(la))
    targs = (torch.tensor(x), torch.tensor(done), torch.tensor(la))
    jh, jq = jnet.apply(variables, hs, *args, train=False)
    with torch.no_grad():
        th, tq = tnet(_carry(hs), *targs, train=False)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-5, rtol=0)
    for a, b in zip(jax.tree_util.tree_leaves(th), jax.tree_util.tree_leaves(jh)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)

    def jloss(p):
        (newh, q), upd = jnet.apply({"params": p, "batch_stats": variables["batch_stats"]}, hs, *args, train=True,
                                    mutable=["batch_stats"])
        return jnp.sum(jnp.sin(q)), (newh, q, upd["batch_stats"])

    (_, (jh, jq, jstats)), jgrads = jax.value_and_grad(jloss, has_aux=True)(variables["params"])
    th, tq = tnet(_carry(hs), *targs, train=True)
    np.testing.assert_allclose(tq.detach().numpy(), np.asarray(jq), atol=1e-5, rtol=0)
    for a, b in zip(jax.tree_util.tree_leaves(th), jax.tree_util.tree_leaves(jh)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-5, rtol=0)
    names = [n for n, _ in tnet.named_parameters()]
    grads = torch.autograd.grad(torch.sin(tq).sum(), list(tnet.parameters()), allow_unused=True,
                                materialize_grads=True)
    want = tckpt.params_from_flax({"params": _np(jgrads)})
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-5, rtol=1e-5, err_msg=name)
    tstats = tckpt.params_to_flax(tnet)["batch_stats"]
    assert set(tstats) == set(jstats) == {"BatchRenorm_0" if "renorm" in case else "BatchNorm_0"}
    for mod, leaves in _np(jstats).items():
        for leaf, v in leaves.items():
            np.testing.assert_allclose(tstats[mod][leaf], v, atol=1e-5, rtol=0, err_msg=leaf)
    if "renorm" in case:
        assert int(tstats["BatchRenorm_0"]["steps"]) == steps + 1


def test_lstm_checkpoint_crosses_both_ways(tmp_path):
    """The port's LSTM network with a BatchRenorm input in flax names and
    layouts gives flax's Q; its safetensors file loads in the JAX package's
    loader with flax's tree and shapes (OptimizedLSTMCell_0's ii..io without
    bias) and back into the port unchanged."""
    kw = NET_CASES["renorm_normin_lastaction_2lstm"]
    jnet, _, variables, hs = _networks(kw)
    tnet = TRNNQNetwork(F, A, hidden_size=H, num_layers=1, cell_type="lstm",
                        generator=torch.Generator().manual_seed(5), **kw)
    flax_vars = tckpt.params_to_flax(tnet)
    x, done, la = _inputs(2)
    _, jq = jnet.apply(jax.tree_util.tree_map(jnp.asarray, flax_vars), hs, jnp.asarray(x), jnp.asarray(done),
                       jnp.asarray(la), train=False)
    with torch.no_grad():
        _, tq = tnet(_carry(hs), torch.tensor(x), torch.tensor(done), torch.tensor(la), train=False)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-5, rtol=0)
    path = str(tmp_path / "lstm.safetensors")
    tckpt.save_params(flax_vars["params"], path)
    loaded = jckpt.load_params(path)
    shapes = lambda t: jax.tree_util.tree_map(lambda v: tuple(np.shape(v)), t)  # noqa: E731
    assert shapes(loaded) == shapes(variables["params"])
    assert "bias" not in loaded["ScannedRNN_1"]["OptimizedLSTMCell_0"]["if"]
    assert shapes(tckpt.params_to_flax(tnet)["batch_stats"]) == shapes(variables["batch_stats"])
    back = TRNNQNetwork(F, A, hidden_size=H, num_layers=1, cell_type="lstm", **kw)
    back.load_state_dict(tckpt.params_from_flax(tckpt.load_params(path)), strict=False)
    for (name, p), q in zip(back.named_parameters(), tnet.parameters()):
        assert torch.equal(p, q), name


# ---- the FAST_BPTT forward ---------------------------------------------------------

FAST_KW = dict(num_layers=1, num_rnn_layers=2, action_dim=A, add_last_action=True, norm_input=True,
               cell_type="lstm", input_norm_type="batch_renorm")


@pytest.mark.parametrize("steps", [0, 1500])
def test_fast_rnn_lstm_batchrenorm_matches_jax(steps):
    """``fast_rnn_train_forward`` with LSTM cells and the BatchRenorm input
    against the JAX function (tests/test_fast_rnn.py::test_lstm_batchrenorm_
    forward_and_grads_match_flax), fresh and with ``steps`` past the warm-up
    (r and d clipped): Q, the new (c, h) and the new statistics within 1e-5,
    the gradients of sum(sin(q)) within 1e-5 absolute and relative."""
    _, tnet, variables, hs = _networks(NET_CASES["renorm_normin_lastaction_2lstm"], steps)
    x, done, la = _inputs(4)
    done_f = done.astype(np.float32)

    def jloss(p):
        newh, q, bs = jfast.fast_rnn_train_forward(p, variables["batch_stats"], hs, jnp.asarray(x),
                                                   jnp.asarray(done_f), jnp.asarray(la), **FAST_KW)
        return jnp.sum(jnp.sin(q)), (newh, q, bs)

    (_, (jh, jq, jbs)), jgrads = jax.value_and_grad(jloss, has_aux=True)(variables["params"])
    params = dict(tnet.named_parameters())
    th, tq, tbs = tfast.fast_rnn_train_forward(params, dict(tnet.named_buffers()), _carry(hs), torch.tensor(x),
                                               torch.tensor(done_f), torch.tensor(la), **FAST_KW)
    np.testing.assert_allclose(tq.detach().numpy(), np.asarray(jq), atol=1e-5, rtol=0)
    for a, b in zip(jax.tree_util.tree_leaves(th), jax.tree_util.tree_leaves(jh)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-5, rtol=0)
    for leaf, v in _np(jbs["BatchRenorm_0"]).items():
        np.testing.assert_allclose(tbs[f"BatchRenorm_0.{leaf}"].numpy(), v, atol=1e-5, rtol=0, err_msg=leaf)
    assert tbs["BatchRenorm_0.steps"].dtype == torch.int32 and int(tbs["BatchRenorm_0.steps"]) == steps + 1
    grads = torch.autograd.grad(torch.sin(tq).sum(), list(params.values()))
    want = tckpt.params_from_flax({"params": _np(jgrads)})
    for name, g in zip(params, grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-5, rtol=1e-5, err_msg=name)
    # the module path's train forward is the same function
    _, mq = tnet(_carry(hs), torch.tensor(x), torch.tensor(done), torch.tensor(la), train=True)
    np.testing.assert_allclose(mq.detach().numpy(), tq.detach().numpy(), atol=1e-5, rtol=0)


def test_mp_matmul_matches_jax():
    """float32: the plain product, bit for bit; bfloat16: bfloat16 operands,
    float32 accumulation and result, within 1e-5 relative of JAX's
    ``_mp_matmul`` and within bfloat16's tolerance of the exact product
    (tests/test_fast_rnn.py::test_mp_matmul_bf16_close_and_f32_exact)."""
    rng = np.random.RandomState(0)
    a, b = rng.randn(6, 32, 48).astype(np.float32), rng.randn(48, 96).astype(np.float32)
    ta, tb = torch.tensor(a), torch.tensor(b)
    assert torch.equal(tfast._mp_matmul(ta, tb, torch.float32), torch.matmul(ta, tb))
    np.testing.assert_allclose(tfast._mp_matmul(ta, tb).numpy(), np.asarray(jfast._mp_matmul(a, b, jnp.float32)),
                               atol=1e-5, rtol=0)
    got = tfast._mp_matmul(ta, tb, torch.bfloat16)
    assert got.dtype == torch.float32
    want = np.asarray(jfast._mp_matmul(jnp.asarray(a), jnp.asarray(b), jnp.bfloat16))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), a @ b, atol=0.15, rtol=0.03)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_bf16_fast_forward_matches_jax(cell):
    """BF16_COMPUTE's forward (``compute_dtype`` bfloat16) against the JAX
    function's in bfloat16: Q within 2e-3 (an activation a float32 ulp apart
    may round to another bfloat16 operand further on) and the gradients of
    sum(sin(q)) within 1e-2 relative of the largest; both within bfloat16's
    tolerance of the float32 forward."""
    kw = dict(num_rnn_layers=1, add_last_action=True, norm_input=True,
              input_norm_type="batch_renorm" if cell == "lstm" else "batch_norm")
    jnet = JRNNQNetwork(action_dim=A, hidden_size=H, num_layers=1, cell_type=cell, norm_type="layer_norm", **kw)
    x, done, la = _inputs(5)
    hs = jax.tree_util.tree_map(lambda v: v + 0.3, jnet.initialize_carry(B))
    variables = _np(jnet.init(jax.random.PRNGKey(2), hs, jnp.asarray(x), jnp.asarray(done), jnp.asarray(la),
                              train=False))
    tnet = TRNNQNetwork(F, A, hidden_size=H, num_layers=1, cell_type=cell, **kw)
    tnet.load_state_dict(tckpt.params_from_flax(variables))
    fkw = dict(num_layers=1, num_rnn_layers=1, action_dim=A, add_last_action=True, norm_input=True, cell_type=cell,
               input_norm_type=kw["input_norm_type"])
    done_f = done.astype(np.float32)

    def jloss(p):
        _, q, _ = jfast.fast_rnn_train_forward(p, variables["batch_stats"], hs, jnp.asarray(x), jnp.asarray(done_f),
                                               jnp.asarray(la), compute_dtype=jnp.bfloat16, **fkw)
        return jnp.sum(jnp.sin(q)), q

    (_, jq), jgrads = jax.value_and_grad(jloss, has_aux=True)(variables["params"])
    thidden = _carry(hs) if cell == "lstm" else [torch.tensor(np.asarray(h)) for h in hs]
    params = dict(tnet.named_parameters())
    buffers = dict(tnet.named_buffers())
    targs = (torch.tensor(x), torch.tensor(done_f), torch.tensor(la))
    _, tq, _ = tfast.fast_rnn_train_forward(params, buffers, thidden, *targs, compute_dtype=torch.bfloat16, **fkw)
    _, fq, _ = tfast.fast_rnn_train_forward(params, buffers, thidden, *targs, **fkw)
    assert tq.dtype == torch.float32
    np.testing.assert_allclose(tq.detach().numpy(), np.asarray(jq), atol=2e-3, rtol=0)
    np.testing.assert_allclose(tq.detach().numpy(), fq.detach().numpy(), atol=0.05, rtol=0.03)
    grads = torch.autograd.grad(torch.sin(tq).sum(), list(params.values()))
    want = tckpt.params_from_flax({"params": _np(jgrads)})
    for name, g in zip(params, grads):
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, atol=1e-2 * max(np.abs(w).max(), 1e-3), rtol=0, err_msg=name)


# ---- the trainer -------------------------------------------------------------------


def tiny_craftax_config(*extra):
    """pqn_rnn_craftax at H 32, 8 envs x 8 steps, window 4, reset ratio 4,
    1024 steps (16 updates; tests/test_fast_rnn.py::test_trainer_fast_bptt_
    lstm_craftax_trains)."""
    return compose(alg="pqn_rnn_craftax", overrides=[
        "DEVICE=cpu", "TOTAL_TIMESTEPS=1024", "TOTAL_TIMESTEPS_DECAY=1024", "NUM_ENVS=8", "NUM_STEPS=8",
        "MEMORY_WINDOW=4", "NUM_MINIBATCHES=2", "NUM_EPOCHS=1", "HIDDEN_SIZE=32", "NUM_LAYERS=1",
        "NUM_RNN_LAYERS=1", "OPTIMISTIC_RESET_RATIO=4", "TEST_DURING_TRAINING=False", *extra,
    ])


def test_tiny_craftax_fast_bptt_matches_the_module_path():
    """The module path and FAST_BPTT train the same run: params within atol
    5e-4 and rtol 1e-3, the input BatchRenorm's statistics too (its step
    count equal to the grad steps); the env optimistic, the LSTM memory of
    (c, h) pairs, no kernel launched on the CPU."""
    before = (teg.eps_greedy.launches, tlr.lambda_returns_closure.launches)
    outs = [pqn_rnn.make_train(tiny_craftax_config(*extra))() for extra in ((), ("FAST_BPTT=True",))]
    assert (teg.eps_greedy.launches, tlr.lambda_returns_closure.launches) == before
    for out in outs:
        train_state, memory, carry, _, _ = out["runner_state"]
        assert train_state.grad_steps == 16 * 2 and int(train_state.network.BatchRenorm_0.steps) == 32
        assert isinstance(carry[4], wrappers.LogEnvState) and isinstance(carry[0][0], tuple)
        c, h = memory.last_hs[0]
        assert c.shape == h.shape == (4 + 8, 8, 32)
        assert torch.isfinite(out["metrics"]["td_loss"]).all()
    a, b = (out["runner_state"][0].network.state_dict() for out in outs)
    for name in a:
        np.testing.assert_allclose(a[name].float().numpy(), b[name].float().numpy(), atol=5e-4, rtol=1e-3,
                                   err_msg=name)


@pytest.mark.parametrize("mode", [
    ("RESET_BANK=16", "RESET_BANK_REFRESH_EVERY=4", "FAST_BPTT=True", "EXPLORATION_KERNEL=pallas",
     "BF16_COMPUTE=True"),
    ("USE_OPTIMISTIC_RESETS=False", "BATCH_ENV=True"),
])
def test_tiny_craftax_batched_modes_with_done_masked_metrics_and_eval(mode):
    """The recurrent trainer in the reset bank (with the epsilon-greedy
    kernel's twin and the bfloat16 BPTT forward) and in BATCH_ENV, with
    6-step episodes, DONE_MASKED_INFO_METRICS (the YAML's) and the eval on
    its own env: the training env's state of the mode, the done-masked
    returned_episode 1 in every update (each rollout ends episodes; its
    plain mean would be about 1/6) with lengths of 6, finite eval metrics."""
    config = tiny_craftax_config("ENV_KWARGS={'max_steps_in_episode': 6}", "TOTAL_TIMESTEPS=256",
                                 "TEST_DURING_TRAINING=True", "TEST_NUM_ENVS=8", "TEST_NUM_STEPS=16",
                                 "TEST_INTERVAL=0.5", *mode)
    out = pqn_rnn.make_train(config)()
    m = out["metrics"]
    env_state = out["runner_state"][2][4]
    if "BATCH_ENV=True" in mode:
        assert isinstance(env_state, wrappers.LogEnvState)
    else:
        assert isinstance(env_state, wrappers.BankedResetState) and env_state.tick == 12 + 4 * 8
    assert torch.equal(m["returned_episode"], torch.ones(4))
    assert torch.equal(m["returned_episode_lengths"], torch.full((4,), 6.0))
    assert torch.isfinite(m["test/returned_episode_returns"]).all()
    assert torch.isfinite(m["td_loss"]).all() and torch.isfinite(m["qvals"]).all()


def test_cuda_policy_for_pqn_rnn_craftax(capsys):
    """On ``cuda``: FAST_BPTT, the reset bank (RESET_BANK=256, the JAX
    policy's, config.py:222-223) and the epsilon-greedy kernel; no
    PALLAS_BPTT for an LSTM stack; PARITY=strict and the CPU turn none on;
    an explicit flag wins."""
    cfg = compose(alg="pqn_rnn_craftax")
    assert cfg["FAST_BPTT"] is True and cfg["RESET_BANK"] == 256 and cfg["EXPLORATION_KERNEL"] == "pallas"
    assert not cfg.get("PALLAS_BPTT")
    assert "FAST_BPTT=True, EXPLORATION_KERNEL=pallas, RESET_BANK=256" in capsys.readouterr().err
    for ov in (["DEVICE=cpu"], ["PARITY=strict"]):
        cfg = compose(alg="pqn_rnn_craftax", overrides=ov)
        assert not any(k in cfg for k in ("FAST_BPTT", "PALLAS_BPTT", "RESET_BANK", "EXPLORATION_KERNEL")), ov
    cfg = compose(alg="pqn_rnn_craftax", overrides=["RESET_BANK=0", "USE_OPTIMISTIC_RESETS=False"])
    assert cfg["RESET_BANK"] == 0
    assert "RESET_BANK" not in compose(alg="pqn_rnn_craftax", overrides=["USE_OPTIMISTIC_RESETS=False"])


def test_craftax_rnn_cli_writes_what_the_jax_loader_reads(tmp_path, capsys):
    """``+alg=pqn_rnn_craftax`` through the CLI on the CPU writes the LSTM
    tree flax builds for the config (BatchRenorm_0, Dense_0, LayerNorm_0,
    ScannedRNN_0/OptimizedLSTMCell_0, the head Dense_1), loaded by the JAX
    package's loader."""
    cli.main([
        "+alg=pqn_rnn_craftax", "DEVICE=cpu", "TOTAL_TIMESTEPS=128", "TOTAL_TIMESTEPS_DECAY=128", "NUM_ENVS=8",
        "NUM_STEPS=16", "NUM_MINIBATCHES=2", "NUM_EPOCHS=1", "HIDDEN_SIZE=16", "OPTIMISTIC_RESET_RATIO=4",
        f"SAVE_PATH={tmp_path / 'models'}", f"LOG_JSONL={tmp_path / 'm.jsonl'}",
    ])
    assert "Training took" in capsys.readouterr().out
    saved = jckpt.load_params(str(tmp_path / "models" / "Craftax-Symbolic-v1"
                                  / "pqn_rnn_Craftax-Symbolic-v1_seed0.safetensors"))
    jnet = JRNNQNetwork(action_dim=34, hidden_size=16, num_layers=1, cell_type="lstm", norm_input=True,
                        input_norm_type="batch_renorm", add_last_action=True)
    init = jnet.init(jax.random.PRNGKey(0), jnet.initialize_carry(1), jnp.zeros((1, 1, 2883)), jnp.zeros((1, 1)),
                     jnp.zeros((1, 1), jnp.int32), train=False)["params"]
    shapes = lambda t: jax.tree_util.tree_map(lambda v: tuple(np.shape(v)), t)  # noqa: E731
    assert shapes(saved) == shapes(init)
    assert tuple(saved["ScannedRNN_0"]["OptimizedLSTMCell_0"]["ii"]["kernel"].shape) == (16 + 34, 16)
