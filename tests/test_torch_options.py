"""Two trainer options against the JAX package, on the CPU: ARCH=mlp (or
FLATTEN_OBS=True) on an image-observation env flattens each observation
under Log (purejaxql_tpu/algo/pqn.py:64-68, envs/wrappers.py:36-55), and
COLLECT_METRICS=False returns no metric stack (pqn.py:260, pqn_rnn.py:118,
pqn_ac.py:163) and the CLI then logs nothing (purejaxql_tpu/cli.py:108-111)."""

import jax
import jax.numpy as jnp
import pytest
import torch

from purejaxql_torch import cli
from purejaxql_torch.algo import pqn, pqn_ac, pqn_rnn
from purejaxql_torch.core import checkpoint as tckpt
from purejaxql_torch.core.config import compose, resolve_fast_paths
from purejaxql_torch.envs import wrappers
from purejaxql_torch.envs import make as tmake
from purejaxql_tpu.algo.pqn import build_env as jax_build_env
from purejaxql_tpu.models.factory import make_q_network as jax_make_q_network

MINATAR_MLP = ["DEVICE=cpu", "TOTAL_TIMESTEPS=256", "TOTAL_TIMESTEPS_DECAY=256", "NUM_ENVS=8", "NUM_STEPS=16",
               "NUM_MINIBATCHES=2", "NUM_EPOCHS=1", "HIDDEN_SIZE=32", "TEST_DURING_TRAINING=False"]


def _jax_dense_0_shape(config):
    """The kernel shape of Dense_0 in the JAX package's Q-network for the
    config, on the observations of the JAX package's own env stack."""
    jconfig = {k: v for k, v in config.items() if k != "DEVICE"}
    train_env, _, base_env, env_params, _ = jax_build_env(jconfig)
    obs_shape = train_env.observation_space(env_params).shape
    net = jax_make_q_network(jconfig, base_env.action_space(env_params).n, obs_shape)
    variables = net.init(jax.random.PRNGKey(0), jnp.zeros((1, *obs_shape)), train=False)
    return tuple(variables["params"]["Dense_0"]["kernel"].shape)


@pytest.mark.parametrize("flag", ["ARCH=mlp", "FLATTEN_OBS=True"])
@pytest.mark.parametrize("env_name,obs_dim", [("Breakout-MinAtar", 400), ("Seaquest-MinAtar", 1000)])
def test_mlp_on_minatar_flattens_the_observations_as_jax(env_name, obs_dim, flag):
    """pqn_minatar with an MLP on Breakout's 4 and Seaquest's 10 planes: a
    tiny run trains on flat observations, and the trained Dense_0 kernel has
    the shape the JAX package's Q-network gets, (400, 32) and (1000, 32).
    FLATTEN_OBS=True with the CNN's default ARCH picks the MLP by the flat
    observations' rank, as in the JAX package."""
    config = compose(alg="pqn_minatar", overrides=MINATAR_MLP + [f"ENV_NAME={env_name}", flag])
    out = pqn.make_train(config)()
    train_state = out["runner_state"][0]
    kernel = tckpt.params_to_flax(train_state.network)["params"]["Dense_0"]["kernel"]
    assert tuple(kernel.shape) == _jax_dense_0_shape(config) == (obs_dim, 32)
    assert out["runner_state"][1][0].shape == (8, obs_dim)
    assert torch.isfinite(out["metrics"]["td_loss"]).all()


def test_flatten_observation_keeps_the_row_major_order():
    """Each env's planes flattened as the JAX wrapper's obs.reshape(-1):
    (row, col, channel) order, the space a flat Box of the same size."""
    env, params = tmake("SpaceInvaders-MinAtar")
    flat = wrappers.FlattenObservation(env)
    gen = torch.Generator().manual_seed(0)
    obs, state = env.reset(gen, 3, params)
    fobs, _ = flat.reset(torch.Generator().manual_seed(0), 3, params)
    assert torch.equal(fobs, obs.reshape(3, 600))
    action = torch.tensor([0, 1, 3])
    want = env.step_env(state, action, params, env.step_draws(gen, 3))[0]
    assert torch.equal(flat.step_env(state, action, params, flat.step_draws(gen, 3))[0], want.reshape(3, 600))
    assert flat.observation_space(params).shape == (600,)


@pytest.mark.parametrize("flag", ["ARCH=mlp", "FLATTEN_OBS=True"])
@pytest.mark.parametrize("env_name", ["Breakout-MinAtar", "Seaquest-MinAtar"])
def test_cuda_policy_does_not_fuse_a_flattened_minatar_config(env_name, flag):
    """The fused MinAtar kernels run the CNN on the planes, so the cuda
    policy leaves FUSED_ROLLOUT off for an MLP config and the trainer
    refuses it when asked; the CNN config of the same game still fuses."""
    config = compose(alg="pqn_minatar", overrides=MINATAR_MLP + [f"ENV_NAME={env_name}", flag])
    assert not resolve_fast_paths(config, device="cuda").get("FUSED_ROLLOUT")
    assert not pqn.fused_ff_eligible(config)
    with pytest.raises(ValueError, match="FUSED_ROLLOUT"):
        pqn.make_train({**config, "FUSED_ROLLOUT": True})
    cnn = compose(alg="pqn_minatar", overrides=MINATAR_MLP + [f"ENV_NAME={env_name}"])
    assert resolve_fast_paths(cnn, device="cuda")["FUSED_ROLLOUT"] is True


def test_rnn_trainer_flattens_image_observations_as_jax():
    """The recurrent trainer defaults ARCH to mlp (pqn_rnn.py:72), so a
    MinAtar game trains on its flattened planes: (400,) for Breakout, the
    observation shape the JAX trainer's env stack gives."""
    config = compose(alg="pqn_rnn_cartpole", overrides=[
        "DEVICE=cpu", "ENV_NAME=Breakout-MinAtar", "TOTAL_TIMESTEPS=256", "TOTAL_TIMESTEPS_DECAY=256",
        "NUM_ENVS=8", "NUM_STEPS=16", "NUM_MINIBATCHES=2", "NUM_EPOCHS=1", "HIDDEN_SIZE=32",
        "TEST_DURING_TRAINING=False",
    ])
    out = pqn_rnn.make_train(config)()
    jconfig = {k: v for k, v in config.items() if k != "DEVICE"}
    jconfig.setdefault("ARCH", "mlp")
    train_env, _, _, env_params, _ = jax_build_env(jconfig)
    assert out["runner_state"][2][1].shape == (8, *train_env.observation_space(env_params).shape) == (8, 400)
    assert torch.isfinite(out["metrics"]["td_loss"]).all()


def _state(network):
    return {k: v.clone() for k, v in network.state_dict().items()}


# per trainer: make_train and a tiny config with the in-loop eval on, fused
# (the kernels' plain twins on the CPU) and unfused
COLLECT_CASES = {
    "ff_cartpole": (pqn.make_train, "pqn_cartpole", [
        "TOTAL_TIMESTEPS=2048", "TOTAL_TIMESTEPS_DECAY=2048", "NUM_ENVS=8", "NUM_STEPS=16", "NUM_MINIBATCHES=2",
        "NUM_EPOCHS=2", "HIDDEN_SIZE=32", "TEST_DURING_TRAINING=True", "TEST_NUM_ENVS=8", "TEST_NUM_STEPS=32",
        "TEST_INTERVAL=0.5",
    ]),
    "ff_breakout_fused": (pqn.make_train, "pqn_minatar", [
        "ENV_NAME=Breakout-MinAtar", "TOTAL_TIMESTEPS=1024", "TOTAL_TIMESTEPS_DECAY=1024", "NUM_ENVS=8",
        "NUM_STEPS=16", "NUM_MINIBATCHES=2", "NUM_EPOCHS=1", "HIDDEN_SIZE=32", "FUSED_ROLLOUT=True",
        "EVAL_EARLY_EXIT=True", "TEST_DURING_TRAINING=True", "TEST_NUM_ENVS=8", "TEST_NUM_STEPS=32",
        "TEST_INTERVAL=0.5",
    ]),
    "rnn_cartpole": (pqn_rnn.make_train, "pqn_rnn_cartpole", [
        "TOTAL_TIMESTEPS=1024", "TOTAL_TIMESTEPS_DECAY=1024", "NUM_ENVS=8", "NUM_STEPS=16", "NUM_MINIBATCHES=2",
        "NUM_EPOCHS=1", "HIDDEN_SIZE=32", "TEST_DURING_TRAINING=True", "TEST_NUM_ENVS=8", "TEST_NUM_STEPS=20",
        "TEST_INTERVAL=0.5",
    ]),
    "ac_pendulum": (pqn_ac.make_train, "pqn_pendulum", [
        "TOTAL_TIMESTEPS=2048", "NUM_ENVS=16", "NUM_STEPS=32", "NUM_MINIBATCHES=4", "NUM_EPOCHS=1",
        "ACTOR_HIDDEN_SIZES=[32,32]", "CRITIC_HIDDEN_SIZES=[32,32]", "TEST_NUM_ENVS=8", "TEST_NUM_STEPS=40",
        "ENV_KWARGS={'max_steps_in_episode': 40}",
    ]),
    "ac_pendulum_fused": (pqn_ac.make_train, "pqn_pendulum", [
        "TOTAL_TIMESTEPS=2048", "NUM_ENVS=16", "NUM_STEPS=32", "NUM_MINIBATCHES=4", "NUM_EPOCHS=1",
        "ACTOR_HIDDEN_SIZES=[32,32]", "CRITIC_HIDDEN_SIZES=[32,32]", "TEST_NUM_ENVS=8", "TEST_NUM_STEPS=40",
        "ENV_KWARGS={'max_steps_in_episode': 40}",
        "FUSED_ROLLOUT=True",
    ]),
}


@pytest.mark.parametrize("case", sorted(COLLECT_CASES))
def test_collect_metrics_false_returns_no_metrics_and_the_same_params(case):
    """With COLLECT_METRICS=False each trainer returns no metrics, as the
    JAX trainers return {} (pqn.py:638, pqn_rnn.py:413, pqn_ac.py:611), and
    its params, batch statistics, counters and the eval's test metrics are
    bit for bit those of the same run with the key True."""
    make_train, alg, overrides = COLLECT_CASES[case]
    runs = {}
    for collect in (True, False):
        config = compose(alg=alg, overrides=["DEVICE=cpu", *overrides, f"COLLECT_METRICS={collect}"])
        runs[collect] = make_train(config)()
    on, off = runs[True], runs[False]
    assert off["metrics"] == {} and len(on["metrics"]["env_step"]) > 0
    states_on, states_off = on["runner_state"][0], off["runner_state"][0]
    if not isinstance(states_on, dict):
        states_on, states_off = {"q": states_on}, {"q": states_off}
    for name in states_on:
        want, got = _state(states_on[name].network), _state(states_off[name].network)
        assert want.keys() == got.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), (name, k)
        assert states_off[name].timesteps == states_on[name].timesteps
        assert states_off[name].grad_steps == states_on[name].grad_steps
    # the test metrics: the runner state's last dict (the FF and recurrent
    # trainers carry their generators after it)
    test_on, test_off = (next(x for x in reversed(r["runner_state"]) if isinstance(x, dict)) for r in (on, off))
    assert test_on.keys() == test_off.keys() and test_on
    for k in test_on:
        assert torch.isfinite(test_on[k]).all() and torch.equal(test_on[k], test_off[k]), k


def test_cli_with_collect_metrics_false_logs_nothing(tmp_path, capsys):
    """A CLI run with COLLECT_METRICS=False exits 0, reports its env steps,
    saves its params and writes no metric row (purejaxql_tpu/cli.py:108-111);
    the same run with the key True writes one row an update."""
    jsonl = {flag: tmp_path / f"{flag}.jsonl" for flag in (True, False)}
    for flag, path in jsonl.items():
        assert cli.main([
            "+alg=pqn_cartpole", "DEVICE=cpu", "TOTAL_TIMESTEPS=1024", "TOTAL_TIMESTEPS_DECAY=1024",
            "NUM_ENVS=8", "NUM_STEPS=16", "NUM_MINIBATCHES=2", "NUM_EPOCHS=1", "HIDDEN_SIZE=32",
            "TEST_DURING_TRAINING=False", f"COLLECT_METRICS={flag}", f"SAVE_PATH={tmp_path / str(flag)}",
            f"LOG_JSONL={path}",
        ]) == 0
        assert "Training took" in capsys.readouterr().out
        assert (tmp_path / str(flag) / "CartPole-v1" / "pqn_CartPole-v1_seed0.safetensors").exists()
    assert not jsonl[False].exists() or jsonl[False].read_text() == ""
    assert len(jsonl[True].read_text().splitlines()) == 1024 // 16 // 8
