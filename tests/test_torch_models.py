"""The port's QNetwork on weights carried from a flax init, and the
safetensors crossing in both directions, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from purejaxql_torch.core import checkpoint as tckpt
from purejaxql_torch.models.qnet import QNetwork as TQNetwork
from purejaxql_tpu.core import checkpoint as jckpt
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
