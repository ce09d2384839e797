"""Helpers the tests of the port's network configurations share
(tests/test_torch_norm_variants.py, tests/test_torch_nature_variants.py,
tests/test_torch_norm_variants_trainers.py, tests/test_torch_vdn_lstm.py):
flax variables moved off their init, the flax forward under ``jax.vmap``
over lanes, and the comparison of a port network with its flax twin (eval
mode, two train calls: Q, gradients, running statistics).

Tolerances: float32 Q-values within 1e-5 relative, gradients within 1e-4
of the gradient's largest entry, running statistics within 1e-6; bfloat16
as tests/test_torch_bf16.py: Q-values within two bfloat16 steps (BF16_STEP)
against flax's op-by-op forward, the input norm's statistics within 1e-6
and the trunk's within BF16_STATS and 2**-8 relative, and the whole
gradient within BF16_GRAD of JAX's jitted one in norm (XLA keeps some
bfloat16 products in float32 there, and a bfloat16 activation near 0 that
rounds the other way moves a relu's gradient)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from purejaxql_torch.core import checkpoint as tckpt
from purejaxql_torch.models.cnn import CNNQNetwork as TCNNQNetwork
from purejaxql_tpu.models.cnn import CNNQNetwork as JCNNQNetwork

A = 4
BF16_STEP = 2.0**-5  # tests/test_torch_bf16.py: two bfloat16 rounding steps of a value in [2, 4)
BF16_GRAD = 0.25
# a trunk norm's statistics in bfloat16 average activations that XLA's
# products and the port's may round a bfloat16 step apart in a few rows
# (2**-7 of an activation near 1, 1 % of it into a running statistic): within
# 1e-3 and one bfloat16 step relative (2**-8)
BF16_STATS = 1e-3
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def generators(seeds, base=100):
    gens = [torch.Generator().manual_seed(base + i) for i in range(seeds)]
    return gens[0] if seeds == 1 else gens


def init_variables(jnet, args, seeds, seed):
    """flax variables of ``jnet`` on one lane's ``args``, vmapped over
    ``seeds`` split keys, with every param moved by 0.05 randn and the
    running statistics off their init (mean 0.1 randn, var 1 + |randn|,
    a BatchRenorm's ``steps`` 999)."""
    init = lambda k: jnet.init(k, *args, train=False)  # noqa: E731
    key = jax.random.PRNGKey(seed)
    variables = np_tree(jax.jit(init)(key) if seeds == 1 else jax.jit(jax.vmap(init))(jax.random.split(key, seeds)))
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(lambda x: (x + 0.05 * rng.randn(*x.shape)).astype(np.float32),
                                    variables["params"])

    def stat(path, x):
        name = path[-1].key
        if name == "mean":
            return (0.1 * rng.randn(*x.shape)).astype(np.float32)
        if name == "var":
            return (1 + np.abs(rng.randn(*x.shape))).astype(np.float32)
        if name == "steps":
            return np.full(x.shape, 999, np.int32)
        return x

    return {"params": params, "batch_stats": jax.tree_util.tree_map_with_path(stat, variables["batch_stats"])}


def q_of(out):
    """The Q-values of a flax network's output: the recurrent network gives
    (hidden, q)."""
    return out[1] if isinstance(out, tuple) else out


def jax_forward(jnet, variables, jargs, seeds, train):
    """(Q, batch_stats after the call) of the flax network, vmapped over the
    lanes with seeds; op by op, as tests/test_torch_bf16.py runs it (jit lets
    XLA keep bfloat16 products in float32)."""
    def one(v, *a):
        if not train:
            return q_of(jnet.apply(v, *a, train=False)), v["batch_stats"]
        out, upd = jnet.apply(v, *a, train=True, mutable=["batch_stats"])
        return q_of(out), upd["batch_stats"]

    return one(variables, *jargs) if seeds == 1 else jax.vmap(one)(variables, *jargs)


def assert_stats(tnet, batch_stats, dtype, msg=""):
    """The running statistics within 1e-6; in bfloat16 those of the trunk's
    norms, which average bfloat16 activations, within BF16_STATS."""
    want = tckpt.params_from_flax({"params": {}, "batch_stats": np_tree(batch_stats)})
    got = dict(tnet.named_buffers())
    assert set(got) == set(want), msg
    for name, value in want.items():
        trunk = dtype == "bf16" and not name.startswith(("BatchNorm_0.", "BatchRenorm_0."))
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), atol=BF16_STATS if trunk else 1e-6,
                                   rtol=2.0**-8 if trunk else 1e-6, err_msg=f"{msg} {name}")


def assert_q(got, want, dtype):
    assert got.dtype == np.float32 and want.dtype == np.float32
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    else:  # two bfloat16 steps: 2**-5 in [2, 4), relatively 2**-7 above
        np.testing.assert_allclose(got, want, atol=BF16_STEP, rtol=2.0**-7)


def check_network(jnet, tnet, variables, jargs, targs, to_jax, seeds, dtype):
    """The port's network carrying ``variables`` against flax's: eval mode,
    then two train calls (Q, the running statistics after each call, the
    gradients of sum(w * Q) with respect to every parameter). JAX's
    programs are jitted, but in bfloat16 its Q-values and statistics come
    from flax's op-by-op forward (the jitted program keeps some bfloat16
    products in float32)."""
    tnet.load_state_dict(tckpt.params_from_flax(variables))
    f32 = dtype == "f32"
    forward = lambda v, train: jax_forward(jnet, v, jargs, seeds, train)  # noqa: E731
    if f32:
        forward = jax.jit(forward, static_argnums=1)
    jq, _ = forward(variables, False)
    with torch.no_grad():
        assert_q(to_jax(tnet(*targs, train=False)).numpy(), np.asarray(jq), dtype)
    w = jnp.asarray(np.random.RandomState(7).randn(*jq.shape).astype(np.float32))

    def grads(params, bs):
        def loss(p):
            q, upd = jax_forward(jnet, {"params": p, "batch_stats": bs}, jargs, seeds, train=True)
            return jnp.sum(w * q), (q, upd)

        return jax.value_and_grad(loss, has_aux=True)(params)

    grads = jax.jit(grads)
    batch_stats = variables["batch_stats"]
    for call in range(2):
        (_, (jq, upd)), jgrads = grads(variables["params"], batch_stats)
        if not f32:
            jq, upd = forward({"params": variables["params"], "batch_stats": batch_stats}, True)
        batch_stats = upd
        tnet.zero_grad()
        tq = to_jax(tnet(*targs, train=True))
        (tq * torch.tensor(np.asarray(w))).sum().backward()
        assert_q(tq.detach().numpy(), np.asarray(jq), dtype)
        assert_stats(tnet, batch_stats, dtype, f"call {call}")
        want = tckpt.params_from_flax(np_tree(jgrads))
        params = dict(tnet.named_parameters())
        assert set(params) == set(want)
        got = {k: p.grad if p.grad is not None else torch.zeros_like(p) for k, p in params.items()}  # an unused
        # input norm's gradients are zeros in JAX
        if f32:
            # "of the largest entry": of the whole gradient, so that a tensor
            # whose gradient is zero but for roundings (the input norm's bias
            # ahead of a batch-stat trunk) is held to its noise
            scale = 1e-4 * max(g.abs().max().item() for g in want.values())
            for name, g in want.items():
                np.testing.assert_allclose(got[name].numpy(), g.numpy(), atol=scale, rtol=0,
                                           err_msg=f"call {call} {name}")
        else:
            diff = torch.cat([(got[k] - g).flatten() for k, g in want.items()])
            ref = torch.cat([g.flatten() for g in want.values()])
            assert diff.norm() <= BF16_GRAD * ref.norm(), (call, (diff.norm() / ref.norm()).item())


def shapes(tree):
    return jax.tree_util.tree_map(lambda v: tuple(np.shape(v)), tree)


# the recurrent networks' window: T steps of B envs, F features, H units
T, B, F, H = 6, 4, 5, 16


def rnn_inputs(cell, lanes, seed):
    """(per-lane JAX args, the port's seed-major args): carries (+0.3 off
    zero), obs, done flags and last actions, (..., T, B, .)."""
    rng = np.random.RandomState(seed)
    layers = 2 if cell == "lstm" else 1
    carry = lambda: (0.3 * rng.randn(*lanes, B, H)).astype(np.float32)  # noqa: E731
    hs = [(carry(), carry()) if cell == "lstm" else carry() for _ in range(layers)]
    x = rng.randn(*lanes, T, B, F).astype(np.float32)
    done = rng.rand(*lanes, T, B) < 0.2
    la = rng.randint(0, A, (*lanes, T, B)).astype(np.int32)
    if lanes:  # seed-major rows: (S, B) -> S * B, after the time axis
        fold_t = lambda a: torch.tensor(np.moveaxis(a, 0, 1).reshape(T, -1, *a.shape[3:]))  # noqa: E731
        fold_h = lambda a: torch.tensor(a.reshape(-1, H))  # noqa: E731
        port = ([tuple(map(fold_h, h)) if isinstance(h, tuple) else fold_h(h) for h in hs],
                fold_t(x), fold_t(done), fold_t(la).long())
    else:
        port = ([tuple(map(torch.tensor, h)) if isinstance(h, tuple) else torch.tensor(h) for h in hs],
                torch.tensor(x), torch.tensor(done), torch.tensor(la).long())
    return (hs, jnp.asarray(x), jnp.asarray(done), jnp.asarray(la)), port


NATURE = (84, 84, 4)


def nature_frames(norm, dtype, lanes, seed):
    """Frames of integers 0-15, so that every sum of the input norm's
    statistics is exact in float32 whatever its order (byte frames'
    squares are not: XLA's sums and the port's then differ by 5e-5
    relative); 2 a lane, 4 before a batch-stat trunk, 8 in bfloat16. A
    BatchNorm over the dense layer's 2 rows gives +-(x1 - x2) / |x1 - x2|, a
    ratio of cancelled differences where two rows are close (|mean| / std
    189 in a feature: XLA 8e-5 and the port 5e-4 off a float64 forward); in
    bfloat16 more rows make a row's rounding move a batch statistic less."""
    n = (4 if dtype == "f32" else 8) if norm.startswith("batch") else 2
    return np.random.RandomState(seed).randint(0, 16, (*lanes, n, *NATURE)).astype(np.float32)


def check_nature(norm, dtype, seeds):
    """The Nature CNN with NORM_TYPE ``norm`` and NORM_INPUT against flax's
    ``CNNQNetwork(trunk="nature")`` on the same variables (``jax.vmap`` over
    2 lanes with seeds), in eval mode and two train calls: Q, the
    gradients, the statistics; the trunk's four norms carry flax's names
    (``CNN_0.LayerNorm_i``, ``CNN_0.BatchNorm_i``, ``CNN_0.BatchRenorm_i``,
    or none)."""
    jdtype, tdtype = DTYPES[dtype]
    jnet = JCNNQNetwork(action_dim=A, norm_type=norm, norm_input=True, trunk="nature", dtype=jdtype)
    tnet = TCNNQNetwork(NATURE, A, norm_type=norm, norm_input=True, trunk="nature", dtype=tdtype,
                        generator=generators(seeds), seeds=seeds)
    variables = init_variables(jnet, (jnp.zeros((1, *NATURE)),), seeds, seed=3)
    kind = {"batch_norm": "BatchNorm", "batch_renorm": "BatchRenorm", "layer_norm": "LayerNorm"}.get(norm)
    assert sorted(k for k in variables["params"]["CNN_0"] if not k.startswith(("Conv", "Dense"))) == (
        [f"{kind}_{i}" for i in range(4)] if kind else [])
    lanes = (seeds,) if seeds > 1 else ()
    x = nature_frames(norm, dtype, lanes, seed=4)
    check_network(jnet, tnet, variables, (jnp.asarray(x),), (torch.tensor(x.reshape(-1, *NATURE)),),
                  lambda q: q.reshape(*lanes, -1, A), seeds, dtype)
