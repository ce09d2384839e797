"""The Nature-DQN trunk (CNN_TRUNK=nature) against flax's ``CNNQNetwork(
trunk="nature")``: the forward and the parameter gradients on 84x84x4
frames from the same weights, and the weights crossing both ways, in
memory and through safetensors files."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from purejaxql_torch.core import checkpoint as tckpt
from purejaxql_torch.models.cnn import CNNQNetwork as TCNNQNetwork
from purejaxql_tpu.core import checkpoint as jckpt
from purejaxql_tpu.models.cnn import CNNQNetwork as JCNNQNetwork

SHAPE = (84, 84, 4)


def _pair(seed=0):
    """The flax network's variables and the port's network carrying them, and
    (4, 84, 84, 4) byte-valued frames from numpy."""
    jnet = JCNNQNetwork(action_dim=6, trunk="nature")
    x = np.random.RandomState(seed).randint(0, 256, (4, *SHAPE)).astype(np.float32)
    variables = jax.tree_util.tree_map(np.asarray, jnet.init(jax.random.PRNGKey(seed), jnp.asarray(x), train=False))
    tnet = TCNNQNetwork(SHAPE, 6, trunk="nature", generator=torch.Generator().manual_seed(seed))
    tnet.load_state_dict(tckpt.params_from_flax(variables))
    return jnet, variables, tnet, x


def test_nature_forward_and_grads_match_flax():
    """Q within 1e-5 relative, every parameter gradient of sum(w * Q) within
    1e-4 (relative to the gradient's largest entry)."""
    jnet, variables, tnet, x = _pair()
    w = np.random.RandomState(1).randn(4, 6).astype(np.float32)

    def jloss(params):
        return jnp.sum(w * jnet.apply({**variables, "params": params}, jnp.asarray(x), train=False))

    q_want = np.asarray(jnet.apply(variables, jnp.asarray(x), train=False))
    g_want = tckpt.params_from_flax(jax.tree_util.tree_map(np.asarray, jax.grad(jloss)(variables["params"])))
    q = tnet(torch.tensor(x), train=False)
    np.testing.assert_allclose(q.detach().numpy(), q_want, rtol=1e-5, atol=1e-5 * np.abs(q_want).max())
    (q * torch.tensor(w)).sum().backward()
    grads = dict(tnet.named_parameters())
    assert set(grads) == set(g_want)
    for name, want in g_want.items():
        # the unused input norm's parameters get no gradient here, zeros in JAX
        got = grads[name].grad if grads[name].grad is not None else torch.zeros_like(grads[name])
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-4 * want.abs().max().item(),
                                   err_msg=name)
    assert tnet.CNN_0.Dense_0.weight.shape == (512, 7 * 7 * 64)


def test_nature_tree_crosses_both_ways(tmp_path):
    """params_to_flax gives flax's tree (names and shapes, CNN_0/Conv_0..2,
    LayerNorm_0..3, Dense_0), the convs HWIO and Dense_0's 3,136 rows in
    flax's NHWC flatten order; a file the port saves loads into the JAX
    package's network, and one the JAX package saves into the port's, each
    giving the same Q-values."""
    jnet, variables, tnet, x = _pair(2)
    tree = tckpt.params_to_flax(tnet)
    shapes = lambda t: jax.tree_util.tree_map(lambda v: tuple(np.shape(v)), t)  # noqa: E731
    assert shapes(tree["params"]) == shapes(variables["params"])
    assert shapes(tree["batch_stats"]) == shapes(variables["batch_stats"])
    assert sorted(tree["params"]["CNN_0"]) == ["Conv_0", "Conv_1", "Conv_2", "Dense_0", "LayerNorm_0",
                                                "LayerNorm_1", "LayerNorm_2", "LayerNorm_3"]
    for (p, a), (_, b) in zip(*(jax.tree_util.tree_flatten_with_path(t)[0] for t in (tree, variables))):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(p))

    # the port's file into the JAX package's network
    other = TCNNQNetwork(SHAPE, 6, trunk="nature", generator=torch.Generator().manual_seed(7))
    tckpt.save_params(tckpt.params_to_flax(other)["params"], str(tmp_path / "port.safetensors"))
    loaded = jckpt.load_params(str(tmp_path / "port.safetensors"))
    q_jax = np.asarray(jnet.apply({"params": loaded, "batch_stats": variables["batch_stats"]}, x, train=False))
    q_port = other(torch.tensor(x), train=False).detach().numpy()
    np.testing.assert_allclose(q_jax, q_port, rtol=1e-5, atol=1e-5 * np.abs(q_port).max())

    # the JAX package's file into the port's network
    jvars = jnet.init(jax.random.PRNGKey(9), jnp.asarray(x), train=False)
    jckpt.save_params(jvars["params"], str(tmp_path / "jax.safetensors"))
    fresh = TCNNQNetwork(SHAPE, 6, trunk="nature", generator=torch.Generator().manual_seed(0))
    fresh.load_state_dict(tckpt.params_from_flax(tckpt.load_params(str(tmp_path / "jax.safetensors"))),
                          strict=False)
    want = np.asarray(jnet.apply(jvars, jnp.asarray(x), train=False))
    np.testing.assert_allclose(fresh(torch.tensor(x), train=False).detach().numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
