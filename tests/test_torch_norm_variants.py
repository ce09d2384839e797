"""Every network configuration the JAX modules take, in the port on the CPU
against the JAX package (the helpers and tolerances: tests/torch_norm_cases.py):
the MinAtar CNN with every trunk norm, in float32 and bfloat16, for one seed
and two, and the actor-critic networks' NORM_TYPE values that JAX turns
into no norm. The Nature trunk's cases are in
tests/test_torch_nature_variants.py (float32) and
tests/test_torch_bf16_variants.py (bfloat16, beside the MLP's BatchRenorm
trunk), the recurrent network's in tests/test_torch_rnn_norm_variants.py,
the trainers, the twins of the JAX tests and the trees in
tests/test_torch_norm_variants_trainers.py.

Inputs come from numpy seeds; the weights are flax's (``jax.vmap(init)``
over split keys with seeds), moved off their init, and cross with
``params_from_flax``. A BatchRenorm starts at ``steps`` 999, so its first
train call normalizes in its warm-up form and its second with the renorm
correction."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from purejaxql_torch.core import checkpoint as tckpt
from purejaxql_torch.models.actor_critic import Actor as TActor
from purejaxql_torch.models.actor_critic import CriticEnsemble
from purejaxql_torch.models.cnn import CNNQNetwork as TCNNQNetwork
from purejaxql_tpu.models.actor_critic import Actor as JActor
from purejaxql_tpu.models.actor_critic import Critic as JCritic
from purejaxql_tpu.models.cnn import CNNQNetwork as JCNNQNetwork
from torch_norm_cases import A, DTYPES, check_network, generators, init_variables, np_tree, shapes

torch.set_num_threads(1)

MINATAR = (10, 10, 4)
# the norm, the dtype and the lanes: every norm x dtype for one seed, and 2
# seeds of a BatchRenorm trunk (a BatchNorm trunk's lanes:
# tests/test_torch_rnn_norm_variants.py; a bfloat16 BatchRenorm's:
# tests/test_torch_bf16_variants.py)
CNN_CASES = [(norm, dtype, 1) for norm in ("batch_norm", "batch_renorm", "none") for dtype in DTYPES]
CNN_CASES += [("batch_renorm", "f32", 2)]


@pytest.mark.parametrize("norm,dtype,seeds", CNN_CASES)
def test_minatar_cnn_trunk_matches_flax(norm, dtype, seeds):
    """The MinAtar CNN with NORM_TYPE ``norm`` and NORM_INPUT against flax's
    ``CNNQNetwork`` on the same variables (``jax.vmap`` over 2 lanes with
    seeds), in eval mode and two train calls: Q, the gradients, the
    statistics; the trunk's norms carry flax's names (``CNN_0.BatchNorm_i``,
    ``CNN_0.BatchRenorm_i``, or none). The input is 0/1 planes normalized
    by the input norm: divided by 255, they leave the conv's output to its
    moved biases (|mean| / std 25 a channel), where the batch statistics'
    E[x^2] - E[x]^2 cancels and XLA's float32 sums miss a float64 forward by
    7.5e-5 (the port's by 5e-7)."""
    jdtype, tdtype = DTYPES[dtype]
    jnet = JCNNQNetwork(action_dim=A, norm_type=norm, norm_input=True, hidden_size=32, dtype=jdtype)
    tnet = TCNNQNetwork(MINATAR, A, hidden_size=32, norm_type=norm, norm_input=True, dtype=tdtype,
                        generator=generators(seeds), seeds=seeds)
    variables = init_variables(jnet, (jnp.zeros((1, *MINATAR)),), seeds, seed=3)
    kind = {"batch_norm": "BatchNorm", "batch_renorm": "BatchRenorm"}.get(norm)
    assert sorted(k for k in variables["params"]["CNN_0"] if not k.startswith(("Conv", "Dense"))) == (
        [f"{kind}_0", f"{kind}_1"] if kind else [])
    lanes = (seeds,) if seeds > 1 else ()
    x = (np.random.RandomState(4).rand(*lanes, 8, *MINATAR) < 0.2).astype(np.float32)
    check_network(jnet, tnet, variables, (jnp.asarray(x),), (torch.tensor(x.reshape(-1, *MINATAR)),),
                  lambda q: q.reshape(*lanes, -1, A), seeds, dtype)


# ---- the actor-critic networks ---------------------------------------------------------


@pytest.mark.parametrize("norm_type", ["batch_renorm", "none", "group_norm"])
def test_ac_norm_types_jax_drops_build_no_norm(norm_type):
    """NORM_TYPE values other than layer_norm and batch_norm: JAX's
    ``_normalizer`` gives no trunk norm (actor_critic.py:19-26), so the
    port's actor and critic ensemble hold no norm module and no norm leaf
    beyond the input BatchNorm: their trees equal flax's, and from crossed
    weights the actions and values agree within 1e-5 in train mode."""
    jactor = JActor(2, action_scale=jnp.asarray(1.5), action_bias=jnp.asarray(0.0), hidden_sizes=(16, 16),
                    norm_type=norm_type)
    jcritic = JCritic(hidden_sizes=(16, 16), norm_type=norm_type)
    av = np_tree(jax.jit(jactor.init)(jax.random.PRNGKey(0), jnp.zeros(3)))
    cv = np_tree(jax.jit(jax.vmap(jcritic.init, in_axes=(0, None, None)))(jax.random.split(jax.random.PRNGKey(1), 2),
                                                                          jnp.zeros(3), jnp.zeros(2)))
    actor = TActor(3, 2, 1.5, 0.0, [16, 16], norm_type=norm_type)
    critics = CriticEnsemble(2, 3, 2, [16, 16], norm_type=norm_type)
    for net, v in ((actor, av), (critics, cv)):
        assert shapes(tckpt.params_to_flax(net)) == shapes(v)
        assert sorted(v["params"]) == ["BatchNorm_0", "Dense_0", "Dense_1", "Dense_2"]
        net.load_state_dict(tckpt.params_from_flax(v))
    rng = np.random.RandomState(2)
    obs, act = rng.randn(12, 3).astype(np.float32), rng.randn(12, 2).astype(np.float32)
    ja = jax.jit(lambda v: jactor.apply(v, jnp.asarray(obs), train=True, mutable=["batch_stats"])[0])(av)
    jv = jax.jit(jax.vmap(lambda v: jcritic.apply(v, jnp.asarray(obs), jnp.asarray(act), train=True,
                                                  mutable=["batch_stats"])[0]))(cv)
    with torch.no_grad():
        np.testing.assert_allclose(actor(torch.tensor(obs), train=True).numpy(), np.asarray(ja), atol=1e-5, rtol=0)
        np.testing.assert_allclose(critics(torch.tensor(obs), torch.tensor(act), train=True).numpy(), np.asarray(jv),
                                   atol=1e-5, rtol=0)


