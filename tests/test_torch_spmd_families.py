"""The port's sharded trainers beyond FF on the CPU (twins of
tests/test_spmd_families.py): the recurrent, VDN and actor-critic trainers
on two gloo ranks spawned by tests/torch_spmd_worker.py, each through
parallel/spmd.py:make_train_spmd. Each run: the global counter, finite
metrics (the evals' global means among them), and every parameter and
running statistic bit-equal across the ranks."""

import numpy as np
import pytest

import torch_spmd_worker as worker
from purejaxql_torch.algo import pqn, pqn_ac, pqn_rnn, pqn_vdn

JOBS = {  # job: global TOTAL_TIMESTEPS
    "rnn": 1024, "rnn_batch_norm": 512, "vdn": 1600, "ac": 2048, "ac_fused": 2048, "ac_batch_norm": 1024,
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return worker.spawn(list(JOBS), 2, tmp_path_factory.mktemp("families"))


@pytest.mark.parametrize("job", sorted(JOBS))
def test_spmd_family_counts_global_steps(ranks, job):
    for res in ranks:
        assert res[job]["timesteps"] == JOBS[job]
        assert res[job]["metrics"]["env_step"][-1] == JOBS[job]


@pytest.mark.parametrize("job", sorted(JOBS))
def test_spmd_family_replicas_in_lockstep(ranks, job):
    first = ranks[0][job]["state"]
    assert set(ranks[1][job]["state"]) == set(first)
    for k, v in ranks[1][job]["state"].items():
        np.testing.assert_array_equal(v, first[k], err_msg=k)


@pytest.mark.parametrize("job", sorted(JOBS))
def test_spmd_family_metrics_finite_and_global(ranks, job):
    m0, m1 = (res[job]["metrics"] for res in ranks)
    loss = "td_loss" if "td_loss" in m0 else "value_loss"
    assert np.isfinite(m0[loss]).all()
    assert np.isfinite(m0["returned_episode_returns"]).all()
    assert all(np.isfinite(v).all() for k, v in m0.items() if k.startswith("test/"))
    for k in m0:
        np.testing.assert_array_equal(m0[k], m1[k], err_msg=k)


def test_spmd_family_evals_ran(ranks):
    for job in ("rnn", "vdn", "ac", "ac_fused"):
        assert "test/returned_episode_returns" in ranks[0][job]["metrics"], job


def test_spmd_family_batch_stats_moved(ranks):
    """The cross-replica statistics of the batch-norm runs left their init,
    the same on both ranks (the lockstep test)."""
    for job, name in (("rnn_batch_norm", "BatchNorm_0.mean"), ("ac_batch_norm", "actor.BatchNorm_1.mean"),
                      ("ac_batch_norm", "critic.BatchNorm_1.mean")):
        assert not np.allclose(ranks[0][job]["state"][name], 0.0), (job, name)


@pytest.mark.parametrize("make_train", [pqn.make_train, pqn_rnn.make_train, pqn_vdn.make_train, pqn_ac.make_train])
def test_group_trainer_runs_one_seed(make_train):
    """A sharded trainer runs one seed a rank: NUM_SEEDS > 1 with a group
    raises before anything is built (the mesh's seed axis holds seeds)."""
    alg = {pqn.make_train: "pqn_cartpole", pqn_rnn.make_train: "pqn_rnn_cartpole",
           pqn_vdn.make_train: "pqn_vdn_spread", pqn_ac.make_train: "pqn_pendulum"}[make_train]
    config = worker.compose_cpu(alg, NUM_SEEDS=2, NUM_ENVS=8, NUM_MINIBATCHES=2)
    with pytest.raises(NotImplementedError, match="seed axis"):
        make_train(config, group=object())


def test_sharded_training_script_on_cpu_ranks():
    """purejaxql_torch/scripts/sharded_training.py spawns its gloo CPU ranks
    and prints the global counter from rank 0 alone."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "purejaxql_torch.scripts.sharded_training", "--cpu-ranks", "2", "--updates", "2",
         "NUM_ENVS=16", "NUM_STEPS=16", "NUM_MINIBATCHES=2", "NUM_EPOCHS=1", "HIDDEN_SIZE=32"],
        cwd=root, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [line for line in proc.stdout.splitlines() if "global env steps" in line]
    assert len(lines) == 1, proc.stdout
    assert "on 2 ranks (gloo), NUM_ENVS 32 global; global env steps: 1024;" in lines[0], lines[0]
