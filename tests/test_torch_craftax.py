"""The port's Craftax-class workload (pqn_craftax) on the CPU, against the JAX
package: BatchRenorm, the QNetwork with an input BatchRenorm, one 1-step-TD
learn step, the optimistic-reset wrapper, the factory's per-family norms,
the cuda policy, and tiny trainer runs (the twin of
tests/test_pqn_train.py::test_craftax_style_batched_path, and pqn_craftax on
Forager with the done-masked metrics)."""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from purejaxql_torch import cli
from purejaxql_torch.algo import pqn
from purejaxql_torch.core import checkpoint as tckpt
from purejaxql_torch.core.config import compose, derive_pqn_schedule_keys
from purejaxql_torch.core.optim import make_optimizer
from purejaxql_torch.core.schedules import lr_schedule
from purejaxql_torch.envs import spaces
from purejaxql_torch.envs import wrappers as tw
from purejaxql_torch.envs.base import Environment, map_state, select_state
from purejaxql_torch.envs.gridworld.forager import Forager
from purejaxql_torch.models.batch_renorm import BatchRenorm as TBatchRenorm
from purejaxql_torch.models.factory import make_q_network
from purejaxql_torch.models.qnet import QNetwork as TQNetwork
from purejaxql_torch.ops import eps_greedy as teg
from purejaxql_torch.ops import lambda_returns as tlr
from purejaxql_torch.utils.logging import MemorySink, MetricLogger
from purejaxql_tpu.core.optim import make_optimizer as jax_make_optimizer
from purejaxql_tpu.core.schedules import lr_schedule as jax_lr_schedule
from purejaxql_tpu.models.batch_renorm import BatchRenorm as JBatchRenorm
from purejaxql_tpu.models.qnet import QNetwork as JQNetwork

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
OBS_DIM, N_ACTIONS = 2883, 34


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturbed(variables, seed):
    """Flax variables with every param moved by 0.05 randn and the running
    statistics moved off their init (mean randn, var 1 + |randn|)."""
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.05 * rng.randn(*np.shape(x))).astype(np.float32), variables["params"]
    )

    def stat(path, x):
        name = path[-1].key
        if name == "mean":
            return rng.randn(*np.shape(x)).astype(np.float32)
        if name == "var":
            return (1 + np.abs(rng.randn(*np.shape(x)))).astype(np.float32)
        return np.asarray(x)

    stats = jax.tree_util.tree_map_with_path(stat, variables["batch_stats"])
    return {"params": params, "batch_stats": stats}


def test_pqn_craftax_yaml_equals_jax():
    mine = yaml.safe_load(open(ROOT / "purejaxql_torch/configs/alg/pqn_craftax.yaml"))
    assert mine == yaml.safe_load(open(ROOT / "purejaxql_tpu/configs/alg/pqn_craftax.yaml"))


def test_batch_renorm_matches_flax_across_warmup():
    """Seven train-mode calls (warm-up 3, so the renorm correction engages
    from the fourth) on shifted batches, then eval mode: outputs within 1e-6
    and the running statistics within 1e-6 (relative above 1: the batch
    moments are summed in another order), steps equal, and the gradients of a loss
    with respect to the input, the scale and the bias within 1e-5."""
    rng = np.random.RandomState(0)
    F = 16
    jmod = JBatchRenorm(use_running_average=False, warmup_steps=3, momentum=0.9)
    x0 = rng.randn(64, F).astype(np.float32)
    variables = _perturbed(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x0)), 1)
    tmod = TBatchRenorm(F, momentum=0.9, warmup_steps=3)
    sd = tckpt.params_from_flax({"params": {"m": variables["params"]}, "batch_stats": {"m": variables["batch_stats"]}})
    tmod.load_state_dict({k.removeprefix("m."): v for k, v in sd.items()})
    for step in range(7):
        x = (rng.randn(64, F) * (1 + step) + step).astype(np.float32)
        w = rng.randn(64, F).astype(np.float32)

        def loss(params, xx):
            y, upd = jmod.apply({"params": params, "batch_stats": variables["batch_stats"]}, xx,
                                mutable=["batch_stats"])
            return (y * w).sum(), (y, upd)

        (_, (jy, upd)), (jg_p, jg_x) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            variables["params"], jnp.asarray(x)
        )
        tx = torch.tensor(x, requires_grad=True)
        ty = tmod(tx, train=True)
        (ty * torch.tensor(w)).sum().backward()
        np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg_x), atol=1e-5, rtol=0)
        np.testing.assert_allclose(tmod.weight.grad.numpy(), np.asarray(jg_p["scale"]), atol=1e-5, rtol=1e-6)
        np.testing.assert_allclose(tmod.bias.grad.numpy(), np.asarray(jg_p["bias"]), atol=1e-5, rtol=1e-6)
        tmod.zero_grad()
        variables = {"params": variables["params"], "batch_stats": _np(upd["batch_stats"])}
        for leaf in ("mean", "var", "r_max", "d_max"):
            np.testing.assert_allclose(getattr(tmod, leaf).numpy(), variables["batch_stats"][leaf], atol=1e-6,
                                       rtol=1e-6, err_msg=f"{leaf} after step {step}")
        assert int(tmod.steps) == int(variables["batch_stats"]["steps"]) == step + 1
        assert tmod.steps.dtype == torch.int32
    x = rng.randn(32, F).astype(np.float32)
    want = JBatchRenorm(use_running_average=True, warmup_steps=3, momentum=0.9).apply(variables, jnp.asarray(x))
    with torch.no_grad():
        np.testing.assert_allclose(tmod(torch.tensor(x), train=False).numpy(), np.asarray(want), atol=1e-6,
                                   rtol=1e-6)


def _qnet_pair(seed=0, hidden=64):
    jnet = JQNetwork(action_dim=N_ACTIONS, hidden_size=hidden, num_layers=2, norm_input=True,
                     input_norm_type="batch_renorm")
    variables = jnet.init(jax.random.PRNGKey(seed), jnp.zeros((1, OBS_DIM)), train=False)
    variables = _perturbed(variables, seed)
    tnet = TQNetwork(OBS_DIM, N_ACTIONS, hidden_size=hidden, num_layers=2, norm_input=True,
                     input_norm_type="batch_renorm")
    tnet.load_state_dict(tckpt.params_from_flax(variables))
    return jnet, variables, tnet


def _forager_like_obs(rng, n):
    """Observations shaped as Forager's: one-hot view bits and small extras."""
    obs = (rng.rand(n, OBS_DIM) < 0.03).astype(np.float32)
    obs[:, -48:] = rng.rand(n, 48).astype(np.float32)
    return obs


def test_qnetwork_with_input_batch_renorm_matches_flax():
    """The QNetwork with an input BatchRenorm at obs 2883, H 64, 2 layers, on
    weights carried from flax: Q-values in eval and train mode within 1e-5,
    the train call's statistics too (steps as int32); the param and stats
    trees name flax's leaves, and they cross back into an equal network."""
    jnet, variables, tnet = _qnet_pair()
    obs = _forager_like_obs(np.random.RandomState(1), 256)
    want = jnet.apply(variables, jnp.asarray(obs), train=False)
    with torch.no_grad():
        np.testing.assert_allclose(tnet(torch.tensor(obs), train=False).numpy(), np.asarray(want), atol=1e-5, rtol=0)
    want, upd = jnet.apply(variables, jnp.asarray(obs), train=True, mutable=["batch_stats"])
    with torch.no_grad():
        np.testing.assert_allclose(tnet(torch.tensor(obs), train=True).numpy(), np.asarray(want), atol=1e-5, rtol=0)
    got = tckpt.params_to_flax(tnet)
    assert jax.tree_util.tree_structure(_np(variables["params"])) == jax.tree_util.tree_structure(got["params"])
    assert set(got["batch_stats"]) == {"BatchRenorm_0"}
    for leaf, want_leaf in _np(upd["batch_stats"])["BatchRenorm_0"].items():
        np.testing.assert_allclose(got["batch_stats"]["BatchRenorm_0"][leaf], want_leaf, atol=1e-6, rtol=0,
                                   err_msg=leaf)
    assert got["batch_stats"]["BatchRenorm_0"]["steps"].dtype == np.int32
    # the stats cross back: a fresh port network from flax variables equals this one
    again = TQNetwork(OBS_DIM, N_ACTIONS, hidden_size=64, num_layers=2, norm_input=True,
                      input_norm_type="batch_renorm")
    again.load_state_dict(tckpt.params_from_flax(got))
    for (name, a), b in zip(tnet.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), name


def test_one_step_td_learn_step_matches_jax():
    """Three 1-step-TD minibatch steps from the same weights and minibatches
    as pqn.py:515-553 composes them (the concat forward in train mode, the
    detached max over the next half, the 0.5 * MSE loss, clip + RAdam with
    pqn_craftax's LR schedule): params and batch statistics within 1e-5."""
    config = derive_pqn_schedule_keys(compose(alg="pqn_craftax", overrides=["DEVICE=cpu"]))
    jnet, variables, tnet = _qnet_pair(seed=3)
    tx = jax_make_optimizer(config["MAX_GRAD_NORM"], jax_lr_schedule(config))
    params, batch_stats = variables["params"], variables["batch_stats"]
    opt_state = tx.init(params)
    opt = make_optimizer(tnet.parameters(), config["MAX_GRAD_NORM"], lr_schedule(config))
    rng = np.random.RandomState(4)
    gamma = config["GAMMA"]
    for step in range(3):
        obs, next_obs = _forager_like_obs(rng, 128), _forager_like_obs(rng, 128)
        act = rng.randint(0, N_ACTIONS, 128).astype(np.int32)
        rew = rng.choice([0.0, 0.1, -0.1, 1.0], 128).astype(np.float32)
        done = rng.rand(128) < 0.1

        def loss_fn(p):
            all_q, upd = jnet.apply({"params": p, "batch_stats": batch_stats},
                                    jnp.concatenate((jnp.asarray(obs), jnp.asarray(next_obs))),
                                    train=True, mutable=["batch_stats"])
            q, q_next = jnp.split(all_q, 2)
            q_next = jnp.max(jax.lax.stop_gradient(q_next), axis=-1)
            tgt = jnp.asarray(rew) + (1 - jnp.asarray(done)) * gamma * q_next
            chosen = jnp.take_along_axis(q, jnp.asarray(act)[:, None], axis=-1).squeeze(-1)
            return 0.5 * jnp.square(chosen - tgt).mean(), upd

        (jloss, upd), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        batch_stats = upd["batch_stats"]
        loss, _ = pqn.learn_minibatch_td(tnet, opt, torch.tensor(obs), torch.tensor(act).long(),
                                         torch.tensor(next_obs), torch.tensor(rew), torch.tensor(done), gamma)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
        want = tckpt.params_from_flax({"params": _np(params), "batch_stats": _np(batch_stats)})
        for name, got in tnet.state_dict().items():
            np.testing.assert_allclose(got.numpy(), want[name].numpy(), atol=1e-5, rtol=0, err_msg=name)
    assert int(tnet.BatchRenorm_0.steps) == 3


def test_reset_slot_map_matches_jax():
    rng = np.random.RandomState(0)
    for num_envs, ratio in ((16, 4), (1024, 16), (8, 8)):
        k = num_envs // ratio
        being_reset = rng.permutation(num_envs)[:k]
        want = jnp.arange(k).repeat(ratio).at[jnp.asarray(being_reset)].set(jnp.arange(k))
        got = tw.reset_slot_map(torch.tensor(being_reset), num_envs, ratio)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sample_being_reset_takes_done_envs_first():
    gen = torch.Generator().manual_seed(0)
    for n_done in (0, 1, 3, 4, 11, 16):
        for _ in range(20):
            done = torch.zeros(16, dtype=torch.bool)
            done[torch.randperm(16, generator=gen)[:n_done]] = True
            picked = tw.sample_being_reset(gen, done, 4)
            assert picked.unique().numel() == 4
            if n_done <= 4:
                assert set(done.nonzero()[:, 0].tolist()) <= set(picked.tolist())
            else:
                assert done[picked].all()
    # among done envs the pick is uniform: each of 8 done envs taken half the time
    done = torch.tensor([True] * 8 + [False] * 8)
    counts = torch.zeros(16)
    for _ in range(2000):
        counts[tw.sample_being_reset(gen, done, 4)] += 1
    assert counts[8:].sum() == 0 and ((counts[:8] / 2000 - 0.5).abs() < 4 * (0.25 / 2000) ** 0.5).all()


@dataclasses.dataclass
class _TagState:
    tag: torch.Tensor
    t: torch.Tensor


class _Tagged(Environment):
    """A raw env whose step ends the episodes the action marks, and whose
    every reset state carries a fresh tag, so a test can see which reset
    state each env took."""

    def __init__(self):
        self.resets = 0

    @property
    def default_params(self):
        return None

    def observation_space(self, params):
        return spaces.Box(0, 1, (1,))

    def action_space(self, params):
        return spaces.Discrete(2)

    def reset_env(self, generator, num_envs, params):
        tag = self.resets + torch.arange(num_envs)
        self.resets += num_envs
        return tag[:, None].float(), _TagState(tag, torch.zeros(num_envs, dtype=torch.int32))

    def step_env(self, state, action, params, draws):
        state = _TagState(state.tag, state.t + 1)
        return state.tag[:, None].float(), state, torch.ones(action.shape[0]), action.bool(), {}


def test_optimistic_resets_reset_every_done_env():
    """Through Log: the done envs take fresh states (t 0, a new tag, the Log
    counters zeroed, the return reported in the info), up to num_resets of
    them on slots of their own, the rest sharing; the others step on."""
    gen = torch.Generator().manual_seed(0)
    raw = _Tagged()
    env = tw.OptimisticResetVecEnv(tw.Log(raw), num_envs=16, reset_ratio=4)

    obs, state = env.reset(gen, 16)
    for step, n_done in enumerate((0, 2, 4, 9, 16)):
        action = torch.zeros(16, dtype=torch.long)
        action[torch.randperm(16, generator=gen)[:n_done]] = 1
        before = state.env_state
        first_fresh = raw.resets
        obs, state, reward, done, info = env.step(gen, state, action)
        assert torch.equal(done, action.bool())
        tags, t = state.env_state.tag, state.env_state.t
        fresh = tags >= first_fresh
        assert torch.equal(fresh, done) and (t[done] == 0).all()
        assert torch.equal(t[~done], before.t[~done] + 1) and torch.equal(tags[~done], before.tag[~done])
        assert len(set(tags[done].tolist())) == min(n_done, 4)
        assert (state.episode_lengths[done] == 0).all() and (state.timestep[done] == 0).all()
        assert (info["returned_episode_lengths"][done] > 0).all()
        assert torch.equal(obs[:, 0], tags.float())


def test_map_state_and_select_state_recurse():
    """A Log state nests the env's state: both helpers reach its tensors."""
    obs, st = tw.Log(Forager()).reset_env(torch.Generator().manual_seed(0), 3, Forager().default_params)
    picked = map_state(lambda x: x[torch.tensor([2, 2, 0])], st)
    assert torch.equal(picked.env_state.blocks[0], st.env_state.blocks[2])
    mixed = select_state(torch.tensor([True, False, True]), picked, st)
    assert torch.equal(mixed.env_state.blocks[1], st.env_state.blocks[1])
    assert torch.equal(mixed.env_state.blocks[2], st.env_state.blocks[0])


def _tiny_cartpole(**kw):
    overrides = [f"{k}={v}" for k, v in kw.items()]
    return compose(alg="pqn_cartpole", overrides=[
        "DEVICE=cpu", "TOTAL_TIMESTEPS=16384", "TOTAL_TIMESTEPS_DECAY=16384", "NUM_ENVS=16", "NUM_STEPS=32",
        "NUM_MINIBATCHES=4", "NUM_EPOCHS=2", "TEST_DURING_TRAINING=False", "HIDDEN_SIZE=64", *overrides,
    ])


@pytest.mark.parametrize("mode", ["USE_OPTIMISTIC_RESETS", "BATCH_ENV"])
def test_craftax_style_batched_path(mode):
    """The twin of tests/test_pqn_train.py::test_craftax_style_batched_path:
    optimistic resets (ratio 4) and 1-step TD on CartPole, and the same with
    BatchEnv: 16384 env steps, finite td_loss, no returns kernel."""
    config = _tiny_cartpole(**{mode: True}, OPTIMISTIC_RESET_RATIO=4, Q_LAMBDA=False)
    before = tlr.lambda_returns.launches
    m = pqn.make_train(config)()["metrics"]
    assert int(m["env_step"][-1]) == 16384
    assert torch.isfinite(m["td_loss"]).all()
    assert tlr.lambda_returns.launches == before


def _tiny_craftax(**kw):
    overrides = [f"{k}={v}" for k, v in kw.items()]
    return compose(alg="pqn_craftax", overrides=[
        "DEVICE=cpu", "TOTAL_TIMESTEPS=2048", "TOTAL_TIMESTEPS_DECAY=2048", "NUM_ENVS=64", "HIDDEN_SIZE=64",
        "NUM_LAYERS=2", *overrides,
    ])


def test_tiny_pqn_craftax_on_forager_with_done_masked_metrics():
    """pqn_craftax at H 64, 2 layers, 64 envs (reset ratio 16: 4 fresh worlds
    a step), 32 updates of 1 step, with a 20-step episode limit so that
    every env ends an episode on the 20th update: finite metrics; the
    done-masked infos are the episode-end values there (length exactly 20,
    returned_episode 1) and 0 elsewhere."""
    config = _tiny_craftax(**{"ENV_KWARGS": "{'max_steps_in_episode': 20}"})
    m = pqn.make_train(config)()["metrics"]
    assert int(m["env_step"][-1]) == 2048 and int(m["grad_steps"][-1]) == 32
    for k in ("td_loss", "qvals", "returned_episode_returns", "achievement_count"):
        assert torch.isfinite(m[k]).all(), k
    lengths, ended = m["returned_episode_lengths"], m["returned_episode"]
    at_end = torch.arange(1, 33) % 20 == 0
    assert torch.equal(ended, at_end.float())
    assert torch.equal(lengths, torch.where(at_end, 20.0, 0.0))


def test_done_masked_metrics_average_over_episode_ends():
    """DONE_MASKED_INFO_METRICS (pqn.py:601-610) on CartPole under optimistic
    resets, where episodes end at scattered steps and a reset zeroes an env's
    Log counters, so that only ending envs report a length: the masked mean
    times the fraction of steps that end an episode is the plain mean, and
    the two differ; the learning is the same run."""
    config = _tiny_cartpole(USE_OPTIMISTIC_RESETS=True, OPTIMISTIC_RESET_RATIO=4, Q_LAMBDA=False)
    masked = pqn.make_train({**config, "DONE_MASKED_INFO_METRICS": True})()["metrics"]
    plain = pqn.make_train(config)()["metrics"]
    assert torch.equal(plain["td_loss"], masked["td_loss"])
    for k in ("returned_episode_lengths", "returned_episode_returns"):
        torch.testing.assert_close(masked[k] * plain["returned_episode"], plain[k], rtol=1e-5, atol=1e-5)
        assert (masked[k] > plain[k] + 1).any(), k
    assert torch.equal(masked["returned_episode"], (plain["returned_episode"] > 0).float())


def test_pqn_craftax_cli_recipe(tmp_path, capsys):
    """The CLI dispatches pqn_craftax to the FF trainer and saves params whose
    tree is flax's, BatchRenorm_0 included."""
    config = _tiny_craftax(SAVE_PATH=str(tmp_path), LOG_JSONL=str(tmp_path / "m.jsonl"),
                           TOTAL_TIMESTEPS=512, TOTAL_TIMESTEPS_DECAY=512)
    cli.single_run(config)
    assert "Training took" in capsys.readouterr().out
    saved = tckpt.load_params(str(tmp_path / "Craftax-Symbolic-v1" / "pqn_craftax_Craftax-Symbolic-v1_seed0.safetensors"))
    assert set(saved) == {"BatchRenorm_0", "Dense_0", "LayerNorm_0", "Dense_1", "LayerNorm_1", "Dense_2"}
    assert tuple(saved["Dense_0"]["kernel"].shape) == (OBS_DIM, 64)


def test_factory_gives_the_craftax_family_batch_renorm():
    """make_q_network routes through resolve_norms: a craftax config with
    NORM_TYPE=batch_norm gets BatchRenorm in the trunk and on the input, as
    the JAX factory gives it, with flax's module names; pqn_craftax's own
    config gets the input BatchRenorm on a layer_norm trunk; the gymnax
    family keeps BatchNorm."""
    cfg = compose(alg="pqn_craftax", overrides=["DEVICE=cpu", "NORM_TYPE=batch_norm", "HIDDEN_SIZE=32"])
    net = make_q_network(cfg, N_ACTIONS, (OBS_DIM,))
    assert net.norm_type == "batch_renorm"
    renorms = {n for n, m in net.named_modules() if isinstance(m, TBatchRenorm)}
    assert renorms == {"BatchRenorm_0", "BatchRenorm_1", "BatchRenorm_2", "BatchRenorm_3", "BatchRenorm_4"}
    from purejaxql_tpu.models.factory import make_q_network as jax_make_q_network

    jvars = jax_make_q_network(cfg, N_ACTIONS, (OBS_DIM,)).init(jax.random.PRNGKey(0), jnp.zeros((1, OBS_DIM)),
                                                               train=False)
    got = tckpt.params_to_flax(net)
    for coll in ("params", "batch_stats"):
        assert jax.tree_util.tree_structure(_np(jvars[coll])) == jax.tree_util.tree_structure(got[coll]), coll
    net = make_q_network(compose(alg="pqn_craftax", overrides=["DEVICE=cpu"]), N_ACTIONS, (OBS_DIM,))
    assert isinstance(net.BatchRenorm_0, TBatchRenorm) and net.norm_type == "layer_norm" and net.norm_input
    assert not any(isinstance(m, TBatchRenorm) for m in make_q_network(
        compose(alg="pqn_cartpole", overrides=["DEVICE=cpu", "NORM_TYPE=batch_norm"]), 2, (4,)).modules())


def test_cuda_policy_turns_on_the_exploration_kernel():
    """On cuda (the default DEVICE), every FF config that runs the unfused
    rollout gets EXPLORATION_KERNEL="pallas", pqn_craftax among them, and
    pqn_craftax also FAST_TARGETS, SKIP_NOOP_PERMUTE and RESET_BANK=256, as
    the JAX policy gives them (tests/test_torch_reset_bank.py holds the
    rest), not FUSED_ROLLOUT; a recurrent config, whose rollout is unfused,
    gets it too (tests/test_torch_lstm.py); a fused config, the CPU,
    PARITY=strict and an explicit setting are left alone. LOG_VIA_CALLBACK
    trains the fast program and hands the logger every LOG_INTERVAL-th
    update's row (the YAML's 100; 32 updates here, so the 4th with 8)."""
    cfg = compose(alg="pqn_craftax")
    assert cfg["EXPLORATION_KERNEL"] == "pallas"
    assert cfg["FAST_TARGETS"] is True and cfg["SKIP_NOOP_PERMUTE"] is True and cfg["RESET_BANK"] == 256
    assert "FUSED_ROLLOUT" not in cfg
    assert compose(alg="pqn_cartpole", overrides=["NUM_LAYERS=3"])["EXPLORATION_KERNEL"] == "pallas"
    assert "EXPLORATION_KERNEL" not in compose(alg="pqn_cartpole")
    assert compose(alg="pqn_rnn_memory_chain")["EXPLORATION_KERNEL"] == "pallas"
    for ov in (["DEVICE=cpu"], ["PARITY=strict"]):
        assert "EXPLORATION_KERNEL" not in compose(alg="pqn_craftax", overrides=ov)
    assert compose(alg="pqn_craftax", overrides=["EXPLORATION_KERNEL=False"])["EXPLORATION_KERNEL"] is False
    mem = MemorySink()
    pqn.make_train({**_tiny_craftax(), "LOG_VIA_CALLBACK": True, "LOG_INTERVAL": 8}, logger=MetricLogger([mem]))()
    assert [r["update_steps"] for r in mem.rows] == [8, 16, 24, 32]


def test_exploration_kernel_flag_picks_the_kernel_wrapper(monkeypatch):
    """EXPLORATION_KERNEL="pallas" sends every rollout step's epsilon-greedy
    through ops/eps_greedy.py:eps_greedy (its twin here, on the CPU);
    unset, none does."""
    calls = []
    real = teg.eps_greedy

    def counting(seed, q, eps):
        calls.append(q.shape)
        return real(seed, q, eps)

    monkeypatch.setattr("purejaxql_torch.algo.exploration.eps_greedy", counting)
    config = _tiny_craftax(TOTAL_TIMESTEPS=640, TOTAL_TIMESTEPS_DECAY=640)
    pqn.make_train({**config, "EXPLORATION_KERNEL": "pallas"})()
    assert calls == [(64, N_ACTIONS)] * 10
    calls.clear()
    pqn.make_train(config)()
    assert calls == []
    with pytest.raises(ValueError, match="EXPLORATION_KERNEL"):
        pqn.make_train({**config, "EXPLORATION_KERNEL": "triton"})()
