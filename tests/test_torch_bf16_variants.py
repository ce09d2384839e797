"""The configurations BF16_COMPUTE reaches in this slice, in the port on the
CPU against the JAX package (the helpers and tolerances:
tests/torch_norm_cases.py): the Nature trunk in bfloat16 with a batch-stat
trunk norm (pqn_host_minatar on Pong-EH with BF16_COMPUTE and NORM_TYPE
batch_norm; layer_norm and none: tests/test_torch_nature_variants.py), and
the MLP with a
BatchRenorm trunk in bfloat16 for one seed and two (pqn_craftax with
NORM_TYPE=batch_norm and BF16_COMPUTE), each in eval mode and two train
calls (Q, the gradients, the running statistics). A BatchRenorm starts at
``steps`` 999, so its first train call normalizes in its warm-up form and
its second with the renorm correction."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from purejaxql_torch.models.qnet import QNetwork as TQNetwork
from purejaxql_tpu.models.qnet import QNetwork as JQNetwork
from torch_norm_cases import A, DTYPES, check_nature, check_network, generators, init_variables

torch.set_num_threads(1)


@pytest.mark.parametrize("norm", ["batch_norm", "batch_renorm"])
def test_nature_trunk_in_bf16_matches_flax(norm):
    """``torch_norm_cases.check_nature`` in bfloat16: the trunk casts once
    after the float32 input norm, the convs, the dense layer and the
    LayerNorms and BatchNorms compute in bfloat16 (statistics in float32), a
    BatchRenorm takes its statistics in bfloat16 and hands on float32, and
    Q comes back float32 (cnn.py:26-46, 124-159)."""
    check_nature(norm, "bf16", 1)


@pytest.mark.parametrize("dtype,seeds", [("bf16", 1), ("bf16", 2), ("f32", 2)])
def test_mlp_batch_renorm_trunk_matches_flax(dtype, seeds):
    """The MLP with pqn_craftax's input BatchRenorm and a batch_renorm trunk
    (craftax's NORM_TYPE batch_norm) against flax's ``QNetwork``: in
    bfloat16 the trunk's BatchRenorm takes its batch mean and E[x^2] in
    bfloat16 and hands on float32 (qnet.py:79-88, batch_renorm.py:81-129),
    the next Dense casting back; with 2 seeds under ``jax.vmap``, in float32
    beside it; eval mode and two train calls, across the warm-up."""
    jdtype, tdtype = DTYPES[dtype]
    kw = dict(hidden_size=32, num_layers=2, norm_type="batch_renorm", norm_input=True, input_norm_type="batch_renorm")
    jnet = JQNetwork(action_dim=A, dtype=jdtype, **kw)
    tnet = TQNetwork(24, A, dtype=tdtype, generator=generators(seeds), seeds=seeds, **kw)
    variables = init_variables(jnet, (jnp.zeros((1, 24)),), seeds, seed=5)
    assert sorted(k for k in variables["params"] if k.startswith("Batch")) == [f"BatchRenorm_{i}" for i in range(3)]
    lanes = (seeds,) if seeds > 1 else ()
    x = (np.random.RandomState(6).randn(*lanes, 64, 24) * 2 + 0.5).astype(np.float32)
    check_network(jnet, tnet, variables, (jnp.asarray(x),), (torch.tensor(x.reshape(-1, 24)),),
                  lambda q: q.reshape(*lanes, -1, A), seeds, dtype)
