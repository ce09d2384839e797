"""The Nature-DQN trunk (CNN_TRUNK=nature) with every trunk norm in
float32, for one seed and two, and with the norms that take no batch
statistics in bfloat16 (the batch-stat ones: tests/test_torch_bf16_variants.py),
in the port on the CPU against flax's
``CNNQNetwork(trunk="nature")`` (the helpers and tolerances:
tests/torch_norm_cases.py): eval mode and two train calls (Q, the
gradients, the running statistics). The stacked Nature trunk runs only
here: no FF env gives frames of 36 px or more, and pqn_host refuses seeds,
as the JAX CLI does."""

import pytest
import torch

from torch_norm_cases import check_nature

torch.set_num_threads(1)

# the norm, the dtype and the lanes: every norm for one seed in float32
# (layer_norm: tests/test_torch_nature_cnn.py), 2 seeds of a batch-stat
# norm (the stacked convs at their strides), layer_norm and none in bfloat16
CASES = [(norm, "f32", 1) for norm in ("batch_norm", "batch_renorm", "none")] + [("batch_renorm", "f32", 2)]
CASES += [("layer_norm", "bf16", 1), ("none", "bf16", 1)]


@pytest.mark.parametrize("norm,dtype,seeds", CASES)
def test_nature_trunk_matches_flax(norm, dtype, seeds):
    """``torch_norm_cases.check_nature``: Q, gradients and statistics
    against flax, the norms under flax's names."""
    check_nature(norm, dtype, seeds)
