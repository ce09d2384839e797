"""The port's QNetwork and MinAtar CNN on weights carried from a flax init,
the safetensors crossing in both directions, and the factory, on the CPU."""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from purejaxql_torch.core import checkpoint as tckpt
from purejaxql_torch.models.cnn import CNNQNetwork as TCNNQNetwork
from purejaxql_torch.models.cnn import Conv
from purejaxql_torch.models.factory import check_rnn_q_network, make_q_network
from purejaxql_torch.models.qnet import BatchNorm
from purejaxql_torch.models.qnet import QNetwork as TQNetwork
from purejaxql_tpu.core import checkpoint as jckpt
from purejaxql_tpu.models.cnn import CNNQNetwork as JCNNQNetwork
from purejaxql_tpu.models.qnet import QNetwork as JQNetwork

pytestmark = pytest.mark.quick
torch.set_num_threads(1)

VARIANTS = [
    dict(hidden_size=256, num_layers=2, norm_type="layer_norm", norm_input=False),
    dict(hidden_size=64, num_layers=3, norm_type="batch_norm", norm_input=True),
    dict(hidden_size=64, num_layers=1, norm_type="none", norm_input=False),
]


def _pair(kw, seed=0):
    jnet = JQNetwork(action_dim=2, **kw)
    variables = jnet.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4)), train=False)
    tnet = TQNetwork(obs_dim=4, action_dim=2, **kw)
    tnet.load_state_dict(tckpt.params_from_flax(jax.tree_util.tree_map(np.asarray, variables)))
    return jnet, variables, tnet


def _batch(n, seed):
    rng = np.random.RandomState(seed)
    obs = (rng.randn(n, 4) * np.array([1.0, 1.5, 0.1, 1.5])).astype(np.float32)
    return obs, rng.randint(0, 2, n).astype(np.int32), rng.randn(n).astype(np.float32)


@pytest.mark.parametrize("kw", VARIANTS)
def test_forward_matches_flax(kw):
    jnet, variables, tnet = _pair(kw)
    obs, _, _ = _batch(64, 1)
    for train in (False, True):
        if train:
            want, _ = jnet.apply(variables, jnp.asarray(obs), train=True, mutable=["batch_stats"])
        else:
            want = jnet.apply(variables, jnp.asarray(obs), train=False)
        with torch.no_grad():
            got = tnet(torch.tensor(obs), train=train)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("kw", VARIANTS)
def test_td_loss_grads_and_batch_stats_match_flax(kw):
    """Gradients of the 0.5 * MSE TD loss (pqn.py:536-541) vs jax.grad, and
    the batch statistics a train-mode call leaves (flax momentum 0.99,
    biased variance), the dummy input BatchNorm's included."""
    jnet, variables, tnet = _pair(kw, seed=3)
    obs, act, tgt = _batch(128, 2)

    def loss_fn(params):
        q, upd = jnet.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(obs), train=True, mutable=["batch_stats"],
        )
        chosen = jnp.take_along_axis(q, jnp.asarray(act)[:, None], axis=-1).squeeze(-1)
        return 0.5 * jnp.square(chosen - jnp.asarray(tgt)).mean(), upd

    (jloss, upd), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])
    q = tnet(torch.tensor(obs), train=True)
    chosen = q.gather(1, torch.tensor(act).long()[:, None]).squeeze(1)
    loss = 0.5 * torch.square(chosen - torch.tensor(tgt)).mean()
    params = list(tnet.parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    flat_j = tckpt.params_from_flax({"params": jax.tree_util.tree_map(np.asarray, jgrads)})
    # rtol 1e-4 plus 1e-5 of the largest gradient: some gradients are
    # zero in exact arithmetic (a Dense bias before a BatchNorm) and only
    # float noise on both sides
    scale = max(np.abs(v.numpy()).max() for v in flat_j.values())
    for (name, _), g in zip(tnet.named_parameters(), grads):
        np.testing.assert_allclose(
            g.numpy(), flat_j[name].numpy(), rtol=1e-4, atol=1e-5 * scale, err_msg=name
        )
    stats = tckpt.params_to_flax(tnet)["batch_stats"]
    want_stats = jax.tree_util.tree_map(np.asarray, upd["batch_stats"])
    assert set(stats) == set(want_stats) and "BatchNorm_0" in stats
    for mod in want_stats:
        for leaf in ("mean", "var"):
            np.testing.assert_allclose(
                stats[mod][leaf], want_stats[mod][leaf], rtol=1e-5, atol=1e-6, err_msg=f"{mod}.{leaf}"
            )
    assert not np.allclose(stats["BatchNorm_0"]["var"], 1.0)  # the dummy norm moved


def test_dense_init_is_lecun_normal():
    gen = torch.Generator().manual_seed(0)
    net = TQNetwork(obs_dim=4, action_dim=2, hidden_size=512, generator=gen)
    w = net.Dense_1.weight.detach()
    # truncated normal at +-2 std, rescaled to variance 1/fan_in
    assert abs(w.std().item() * np.sqrt(512) - 1.0) < 0.02
    std = np.sqrt(1 / 512) / 0.87962566103423978
    assert w.abs().max().item() <= 2 * std + 1e-7
    assert (net.Dense_1.bias == 0).all()


def test_safetensors_cross_both_ways(tmp_path):
    kw = VARIANTS[0]
    jnet, variables, tnet = _pair(kw, seed=5)
    obs, _, _ = _batch(16, 4)
    # port -> JAX: the JAX loader reads what the port saves
    path = str(tmp_path / "port.safetensors")
    tckpt.save_params(tckpt.params_to_flax(tnet)["params"], path)
    jparams = jckpt.load_params(path)
    want = jnet.apply({"params": jparams, "batch_stats": variables["batch_stats"]}, jnp.asarray(obs), train=False)
    with torch.no_grad():
        got = tnet(torch.tensor(obs), train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    # JAX -> port: the port loads what the JAX package saves
    path2 = str(tmp_path / "jax.safetensors")
    jckpt.save_params(variables["params"], path2)
    tnet2 = TQNetwork(obs_dim=4, action_dim=2, **kw)
    tnet2.load_state_dict(tckpt.params_from_flax(tckpt.load_params(path2)), strict=False)
    with torch.no_grad():
        got2 = tnet2(torch.tensor(obs), train=False)
    np.testing.assert_allclose(got2.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    # flax names and layouts on disk
    flat = set(jckpt.load_params(path)["Dense_0"])
    assert flat == {"kernel", "bias"} and jparams["Dense_0"]["kernel"].shape == (4, 256)


def test_save_run_layout(tmp_path):
    _, _, tnet = _pair(VARIANTS[2])
    tckpt.save_run(tnet, {"SEED": 0, "obj": object()}, str(tmp_path), "pqn_run")
    assert (tmp_path / "pqn_run.safetensors").exists()
    assert (tmp_path / "pqn_run_config.yaml").read_text().strip() == "SEED: 0"


# ---- image inputs: BatchNorm, the MinAtar CNN, conv kernels ---------------------------


def _boards(n, seed):
    """MinAtar-like observations: (n, 10, 10, 4) planes of 0s and 1s."""
    return (np.random.RandomState(seed).rand(n, 10, 10, 4) < 0.2).astype(np.float32)


def _jitter(tree, seed, scale=0.1, positive=False):
    """Perturb every leaf, so that biases, scales and running statistics are
    not their init constants and a misplaced leaf shows (``positive`` keeps
    variances positive)."""
    rng = np.random.RandomState(seed)

    def _one(x):
        noise = rng.randn(*np.shape(x))
        return (np.asarray(x) + scale * (np.abs(noise) if positive else noise)).astype(np.float32)

    return jax.tree_util.tree_map(_one, tree)


def test_batch_norm_on_images_matches_flax():
    """flax nn.BatchNorm reduces over every axis but the last: on a
    (B, 10, 10, 4) input the port's BatchNorm keeps (4,) running statistics
    equal to flax's after a train-mode call, and normalises as flax does in
    train and in eval mode. Within 1e-5."""
    x = _boards(32, 0) * 3.0 + np.random.RandomState(1).randn(32, 10, 10, 4).astype(np.float32)
    bn = nn.BatchNorm(use_running_average=False)
    variables = _jitter(bn.init(jax.random.PRNGKey(0), jnp.asarray(x)), 2, positive=True)
    want, upd = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    tbn = BatchNorm(4)
    sd = tckpt.params_from_flax({"params": {"BatchNorm_0": variables["params"]},
                                 "batch_stats": {"BatchNorm_0": variables["batch_stats"]}})
    tbn.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    got = tbn(torch.tensor(x), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    for leaf in ("mean", "var"):
        np.testing.assert_allclose(getattr(tbn, leaf).numpy(), np.asarray(upd["batch_stats"][leaf]), rtol=1e-5, atol=1e-6)
    want_eval = nn.BatchNorm(use_running_average=True).apply(
        {"params": variables["params"], **upd}, jnp.asarray(x)
    )
    got_eval = tbn(torch.tensor(x), train=False)
    np.testing.assert_allclose(got_eval.detach().numpy(), np.asarray(want_eval), atol=1e-5, rtol=0)


def test_nested_conv_kernel_crosses_hwio_oihw():
    """A nested flax conv kernel (HWIO) that is not symmetric in its two
    spatial axes: the port's conv under the same nested name computes what
    flax's does, and the kernel goes back to flax unchanged. A W/H swap, or
    a nested name left untransposed, breaks both."""
    kernel = np.arange(3 * 3 * 4 * 16, dtype=np.float32).reshape(3, 3, 4, 16) / 500.0
    kernel[0, 2] += 1.0  # (di=0, dj=2) is not (di=2, dj=0)
    bias = np.linspace(-0.5, 0.5, 16).astype(np.float32)
    x = np.random.RandomState(0).randn(5, 10, 10, 4).astype(np.float32)
    want = nn.Conv(16, (3, 3), padding="VALID").apply({"params": {"kernel": kernel, "bias": bias}}, jnp.asarray(x))
    module = torch.nn.Module()
    module.CNN_0 = torch.nn.Module()
    module.CNN_0.Conv_0 = Conv(4, 16, generator=None)
    tree = {"params": {"CNN_0": {"Conv_0": {"kernel": kernel, "bias": bias}}}}
    module.load_state_dict(tckpt.params_from_flax(tree))
    with torch.no_grad():
        got = module.CNN_0.Conv_0(torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    back = tckpt.params_to_flax(module)["params"]["CNN_0"]["Conv_0"]
    np.testing.assert_array_equal(back["kernel"], kernel)
    np.testing.assert_array_equal(back["bias"], bias)


def _cnn_pair(seed=0, hidden=32):
    jnet = JCNNQNetwork(action_dim=3, hidden_size=hidden)
    variables = jnet.init(jax.random.PRNGKey(seed), jnp.zeros((1, 10, 10, 4)), train=False)
    variables = {"params": _jitter(variables["params"], seed), "batch_stats": _jitter(variables["batch_stats"], seed + 1, positive=True)}
    tnet = TCNNQNetwork((10, 10, 4), 3, hidden_size=hidden)
    tnet.load_state_dict(tckpt.params_from_flax(variables))
    return jnet, variables, tnet


def test_cnn_forward_matches_flax():
    """Train and eval mode, within 1e-5."""
    jnet, variables, tnet = _cnn_pair()
    obs = _boards(48, 1)
    for train in (False, True):
        want = jnet.apply(variables, jnp.asarray(obs), train=train, mutable=["batch_stats"] if train else False)
        want = want[0] if train else want
        with torch.no_grad():
            got = tnet(torch.tensor(obs), train=train)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_cnn_td_loss_grads_and_batch_stats_match_flax():
    """Gradients of the 0.5 * MSE TD loss vs jax.grad (rtol 1e-4 plus 1e-5
    of the largest gradient), and the (4,) statistics the dummy input
    BatchNorm keeps after a train-mode call (within 1e-5)."""
    jnet, variables, tnet = _cnn_pair(seed=3)
    obs = _boards(64, 2)
    rng = np.random.RandomState(3)
    act, tgt = rng.randint(0, 3, 64), rng.randn(64).astype(np.float32)

    def loss_fn(params):
        q, upd = jnet.apply({"params": params, "batch_stats": variables["batch_stats"]},
                            jnp.asarray(obs), train=True, mutable=["batch_stats"])
        chosen = jnp.take_along_axis(q, jnp.asarray(act)[:, None], axis=-1).squeeze(-1)
        return 0.5 * jnp.square(chosen - jnp.asarray(tgt)).mean(), upd

    (jloss, upd), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])
    q = tnet(torch.tensor(obs), train=True)
    chosen = q.gather(1, torch.tensor(act)[:, None]).squeeze(1)
    loss = 0.5 * torch.square(chosen - torch.tensor(tgt)).mean()
    grads = torch.autograd.grad(loss, list(tnet.parameters()), allow_unused=True, materialize_grads=True)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    flat_j = tckpt.params_from_flax({"params": jax.tree_util.tree_map(np.asarray, jgrads)})
    scale = max(np.abs(v.numpy()).max() for v in flat_j.values())
    for (name, _), g in zip(tnet.named_parameters(), grads):
        np.testing.assert_allclose(g.numpy(), flat_j[name].numpy(), rtol=1e-4, atol=1e-5 * scale, err_msg=name)
    stats = tckpt.params_to_flax(tnet)["batch_stats"]["BatchNorm_0"]
    for leaf in ("mean", "var"):
        want = np.asarray(upd["batch_stats"]["BatchNorm_0"][leaf])
        assert want.shape == (4,)
        np.testing.assert_allclose(stats[leaf], want, rtol=1e-5, atol=1e-6)


def test_cnn_safetensors_cross_both_ways(tmp_path):
    """A file written by either package loads in the other and gives the
    same Q-values (within 1e-5); flax's nested names and layouts on disk."""
    jnet, variables, tnet = _cnn_pair(seed=5, hidden=128)
    obs = _boards(16, 4)
    path = str(tmp_path / "port.safetensors")
    tckpt.save_params(tckpt.params_to_flax(tnet)["params"], path)
    jparams = jckpt.load_params(path)
    want = jnet.apply({"params": jparams, "batch_stats": variables["batch_stats"]}, jnp.asarray(obs), train=False)
    with torch.no_grad():
        got = tnet(torch.tensor(obs), train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    path2 = str(tmp_path / "jax.safetensors")
    jckpt.save_params(variables["params"], path2)
    tnet2 = TCNNQNetwork((10, 10, 4), 3, hidden_size=128)
    tnet2.load_state_dict(tckpt.params_from_flax(tckpt.load_params(path2)), strict=False)
    tnet2.load_state_dict(tckpt.params_from_flax({"params": {}, "batch_stats": variables["batch_stats"]}), strict=False)
    with torch.no_grad():
        got2 = tnet2(torch.tensor(obs), train=False)
    np.testing.assert_allclose(got2.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert jparams["CNN_0"]["Conv_0"]["kernel"].shape == (3, 3, 4, 16)
    assert jparams["CNN_0"]["Dense_0"]["kernel"].shape == (1024, 128)
    assert jparams["Dense_0"]["kernel"].shape == (128, 3)


def test_cnn_init_is_he_normal():
    """Conv and trunk Dense: truncated normal with variance 2 / fan_in; the
    head lecun-normal; biases zero."""
    net = TCNNQNetwork((10, 10, 4), 3, hidden_size=128, generator=torch.Generator().manual_seed(0))
    for w, fan_in, scale, tol in (
        (net.CNN_0.Conv_0.weight, 36, 2.0, 0.1),
        (net.CNN_0.Dense_0.weight, 1024, 2.0, 0.02),
        (net.Dense_0.weight, 128, 1.0, 0.15),
    ):
        w = w.detach()
        assert abs(w.std().item() * np.sqrt(fan_in / scale) - 1.0) < tol
        assert w.abs().max().item() <= 2 * np.sqrt(scale / fan_in) / 0.87962566103423978 + 1e-7
    assert net.CNN_0.Conv_0.weight.shape == (16, 4, 3, 3)
    assert all((b == 0).all() for b in (net.CNN_0.Conv_0.bias, net.CNN_0.Dense_0.bias, net.Dense_0.bias))


def test_factory_builds_the_cnn_and_raises_for_unported_variants():
    cfg = {"NORM_TYPE": "layer_norm", "HIDDEN_SIZE": 32}
    assert isinstance(make_q_network(cfg, 3, (10, 10, 4)), TCNNQNetwork)
    assert isinstance(make_q_network({**cfg, "ARCH": "cnn"}, 3, (10, 10, 4)), TCNNQNetwork)
    assert isinstance(make_q_network(cfg, 2, (4,)), TQNetwork)
    # BF16_COMPUTE is ported for both CNN trunks (tests/test_torch_bf16.py,
    # tests/test_torch_norm_variants.py) and accepted by the recurrent
    # network, which ignores it as the JAX package's does (its FAST_BPTT
    # forward takes it: tests/test_torch_lstm.py); the Nature trunk builds on
    # 84x84 frames (tests/test_torch_nature_cnn.py); every CNN trunk norm
    # builds, in either dtype, and trains (held against flax and the JAX
    # trainer in tests/test_torch_norm_variants.py)
    assert make_q_network({**cfg, "BF16_COMPUTE": True}, 3, (10, 10, 4)).dtype == torch.bfloat16
    nature = make_q_network({**cfg, "CNN_TRUNK": "nature"}, 6, (84, 84, 4))
    assert isinstance(nature, TCNNQNetwork) and nature.CNN_0.Dense_0.weight.shape == (512, 3136)
    for extra, shape, norms in (({"NORM_TYPE": "batch_norm"}, (10, 10, 4), ("BatchNorm_0", "BatchNorm_1")),
                                ({"CNN_TRUNK": "nature", "BF16_COMPUTE": True}, (84, 84, 4), ("LayerNorm_3",)),
                                ({"CNN_TRUNK": "nature", "NORM_TYPE": "batch_norm"}, (84, 84, 4), ("BatchNorm_3",))):
        net = make_q_network({**cfg, **extra}, 3, shape)
        assert all(hasattr(net.CNN_0, n) for n in norms), extra
        q = net(torch.rand(2, *shape) * 255, train=True)
        assert q.shape == (2, 3) and q.dtype == torch.float32 and torch.isfinite(q).all()
    check_rnn_q_network((4,))
    with pytest.raises(NotImplementedError, match="flat observations"):
        check_rnn_q_network((10, 10, 4))
