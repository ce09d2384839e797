"""The recurrent network's trunk norms and the actor-critic networks'
NORM_TYPE values in the port on the CPU against the JAX package (the
helpers and tolerances: tests/torch_norm_cases.py): batch_norm,
batch_renorm and none on GRU and LSTM stacks, over either input norm, for
one seed and two (``jax.vmap``); the AC values JAX turns into no norm.
Inputs come from numpy seeds; the weights are flax's, moved off their init,
and cross with ``params_from_flax``. A BatchRenorm starts at ``steps`` 999,
so its first train call normalizes in its warm-up form and its second with
the renorm correction."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from purejaxql_torch.core import checkpoint as tckpt
from purejaxql_torch.models.actor_critic import Actor as TActor
from purejaxql_torch.models.actor_critic import CriticEnsemble
from purejaxql_torch.models.rnn import RNNQNetwork as TRNNQNetwork
from purejaxql_tpu.models.actor_critic import Actor as JActor
from purejaxql_tpu.models.actor_critic import Critic as JCritic
from purejaxql_tpu.models.rnn import RNNQNetwork as JRNNQNetwork
from torch_norm_cases import F, H, A, check_network, generators, init_variables, np_tree, rnn_inputs, shapes

torch.set_num_threads(1)

# ---- the recurrent network ------------------------------------------------------------

# (NORM_TYPE, input norm type): the gymnax family's batch_norm, the craftax
# family's (batch_renorm both), pqn_rnn_cartpole with NORM_TYPE=batch_renorm
# (a BatchNorm input, BatchRenorm trunk), and none
RNN_NORMS = {"batch_norm": ("batch_norm", "batch_norm"), "batch_renorm": ("batch_renorm", "batch_renorm"),
             "mixed": ("batch_renorm", "batch_norm"), "none": ("none", "batch_norm")}
RNN_CASES = [(norms, cell, 1) for norms in ("batch_norm", "batch_renorm") for cell in ("gru", "lstm")]
RNN_CASES += [("mixed", "lstm", 1), ("none", "gru", 1), ("batch_norm", "gru", 2), ("batch_renorm", "lstm", 2)]


@pytest.mark.parametrize("norms,cell,seeds", RNN_CASES)
def test_rnn_trunk_norms_match_flax(norms, cell, seeds):
    """The recurrent network with a batch-stat trunk against flax's
    ``RNNQNetwork`` (``jax.vmap`` with seeds): eval mode and two train calls
    over a window with resets, the statistics over all T x B rows; the
    norms carry flax's names, read from flax's tree (the input norm first:
    ``BatchNorm_0`` then ``BatchNorm_1..``, ``BatchRenorm_0..``, or a
    BatchNorm input before ``BatchRenorm_0..``); the LSTM cases with 2 layers,
    a dueling head and NORM_INPUT, as tests/test_pqn_rnn.py::
    test_rnn_lstm_multilayer_dueling."""
    norm_type, input_norm_type = RNN_NORMS[norms]
    lstm = cell == "lstm"
    kw = dict(hidden_size=H, num_layers=2, num_rnn_layers=2 if lstm else 1, cell_type=cell, norm_input=lstm,
              norm_type=norm_type, input_norm_type=input_norm_type, add_last_action=not lstm, dueling=lstm)
    jnet = JRNNQNetwork(action_dim=A, **kw)
    tnet = TRNNQNetwork(F, A, generator=generators(seeds), seeds=seeds, **kw)
    lanes = (seeds,) if seeds > 1 else ()
    jargs, targs = rnn_inputs(cell, lanes, seed=8)
    one_lane = jax.tree_util.tree_map(lambda a: a[0] if lanes else a, jargs)
    variables = init_variables(jnet, one_lane, seeds, seed=9)
    assert shapes(tckpt.params_to_flax(tnet)) == shapes(variables)
    check_network(jnet, tnet, variables, jargs, targs,
                  lambda out: out[1].unflatten(1, (seeds, -1)).movedim(1, 0) if lanes else out[1], seeds, "f32")
