"""The port's FF-PQN trainer and CLI on the CPU: one minibatch step against
a JAX composition of the package's pieces, tiny end-to-end runs (fused and
unfused), the Log replay and the chunked eval, and the CLI recipe."""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from purejaxql_torch import cli
from purejaxql_torch.algo import pqn
from purejaxql_torch.core import checkpoint as tckpt
from purejaxql_torch.core.config import compose
from purejaxql_torch.core.optim import make_optimizer
from purejaxql_torch.core.schedules import lr_schedule
from purejaxql_torch.envs import make as tmake
from purejaxql_torch.envs import wrappers as twrappers
from purejaxql_torch.models.cnn import CNNQNetwork as TCNNQNetwork
from purejaxql_torch.models.qnet import QNetwork as TQNetwork
from purejaxql_torch.ops import breakout_rollout as tbr
from purejaxql_torch.ops import cartpole_rollout as tcr
from purejaxql_torch.ops import lambda_returns as tlr
from purejaxql_torch.utils.logging import MemorySink, MetricLogger
from purejaxql_tpu.core import checkpoint as jckpt
from purejaxql_tpu.core.config import derive_pqn_schedule_keys
from purejaxql_tpu.core.optim import make_optimizer as jax_make_optimizer
from purejaxql_tpu.core.schedules import lr_schedule as jax_lr_schedule
from purejaxql_tpu.models.cnn import CNNQNetwork as JCNNQNetwork
from purejaxql_tpu.models.qnet import QNetwork as JQNetwork

torch.set_num_threads(1)


def tiny_config(alg="pqn_cartpole", **kw):
    overrides = [f"{k}={v}" for k, v in kw.items()]
    return compose(
        alg=alg,
        overrides=[
            "DEVICE=cpu",
            "TOTAL_TIMESTEPS=2048",
            "TOTAL_TIMESTEPS_DECAY=2048",
            "NUM_ENVS=8",
            "NUM_STEPS=16",
            "NUM_MINIBATCHES=2",
            "NUM_EPOCHS=2",
            "HIDDEN_SIZE=32",
            "TEST_DURING_TRAINING=False",
        ]
        + overrides,
    )


def _acrobot_obs(rng):
    """128 Acrobot-v1 observations: cos, sin of both angles, both velocities
    within their limits (4 pi, 9 pi)."""
    a = rng.uniform(-np.pi, np.pi, (128, 2))
    v = rng.uniform(-1, 1, (128, 2)) * [4 * np.pi, 9 * np.pi]
    return np.stack([np.cos(a[:, 0]), np.sin(a[:, 0]), np.cos(a[:, 1]), np.sin(a[:, 1]), v[:, 0], v[:, 1]],
                    -1).astype(np.float32)


# per family: the alg config, the flax and port networks, an observation
# batch (128 rows) from a numpy generator, and the number of actions
FAMILIES = {
    "mlp": (
        "pqn_cartpole",
        lambda: JQNetwork(action_dim=2, hidden_size=256, num_layers=2),
        lambda: TQNetwork(obs_dim=4, action_dim=2, hidden_size=256),
        lambda rng: (rng.randn(128, 4) * [0.5, 1.0, 0.05, 1.0]).astype(np.float32),
        2,
    ),
    "acrobot": (
        "pqn_cartpole",
        lambda: JQNetwork(action_dim=3, hidden_size=256, num_layers=2),
        lambda: TQNetwork(obs_dim=6, action_dim=3, hidden_size=256),
        lambda rng: _acrobot_obs(rng),
        3,
    ),
    "cnn": (
        "pqn_minatar",
        lambda: JCNNQNetwork(action_dim=3, hidden_size=32),
        lambda: TCNNQNetwork((10, 10, 4), 3, hidden_size=32),
        lambda rng: (rng.rand(128, 10, 10, 4) < 0.2).astype(np.float32),
        3,
    ),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_minibatch_steps_match_jax_composition(family):
    """Three minibatch steps from the same params, transitions and targets:
    the flax network in train mode, the loss of pqn.py:536-541, and
    make_optimizer with the config's LR schedule, against learn_minibatch,
    for the MLP (pqn_cartpole) and the MinAtar CNN (pqn_minatar). Params
    within 1e-6, their updates within 1e-4 of the update's scale (or two
    ulps of the params), batch statistics within 1e-5. Also the MLP at
    Acrobot-v1's widths (6 obs: cos, sin of both angles, the velocities; 3
    actions)."""
    alg, make_jnet, make_tnet, make_obs, n_actions = FAMILIES[family]
    config = derive_pqn_schedule_keys(compose(alg=alg, overrides=["DEVICE=cpu"]))
    rng = np.random.RandomState(0)
    jnet = make_jnet()
    variables = jnet.init(jax.random.PRNGKey(0), jnp.asarray(make_obs(rng)[:1]), train=False)
    tx = jax_make_optimizer(config["MAX_GRAD_NORM"], jax_lr_schedule(config))
    params, batch_stats = variables["params"], variables["batch_stats"]
    opt_state = tx.init(params)

    tnet = make_tnet()
    tnet.load_state_dict(tckpt.params_from_flax(jax.tree_util.tree_map(np.asarray, variables)))
    opt = make_optimizer(tnet.parameters(), config["MAX_GRAD_NORM"], lr_schedule(config))

    for step in range(3):
        obs = make_obs(rng)
        act = rng.randint(0, n_actions, 128).astype(np.int32)
        tgt = (rng.randn(128) * 2).astype(np.float32)

        def loss_fn(p):
            q, upd = jnet.apply(
                {"params": p, "batch_stats": batch_stats}, jnp.asarray(obs),
                train=True, mutable=["batch_stats"],
            )
            chosen = jnp.take_along_axis(q, jnp.asarray(act)[:, None], axis=-1).squeeze(-1)
            return 0.5 * jnp.square(chosen - jnp.asarray(tgt)).mean(), upd

        (jloss, upd), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        new_params = optax.apply_updates(params, updates)
        batch_stats = upd["batch_stats"]

        before = {k: v.detach().clone() for k, v in tnet.named_parameters()}
        loss, _ = pqn.learn_minibatch(
            tnet, opt, torch.tensor(obs), torch.tensor(act).long(), torch.tensor(tgt)
        )
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
        want_new = tckpt.params_from_flax({"params": jax.tree_util.tree_map(np.asarray, new_params)})
        want_old = tckpt.params_from_flax({"params": jax.tree_util.tree_map(np.asarray, params)})
        for name, p in tnet.named_parameters():
            got = p.detach()
            np.testing.assert_allclose(got.numpy(), want_new[name].numpy(), atol=1e-6, rtol=0, err_msg=name)
            # the update is read back as a difference of float32 params,
            # so it is known only to the params' last bit
            d_want = (want_new[name] - want_old[name]).numpy()
            d_got = (got - before[name]).numpy()
            ulp = np.spacing(np.abs(want_new[name].numpy()).max())
            np.testing.assert_allclose(
                d_got, d_want, rtol=0, atol=max(1e-4 * np.abs(d_want).max(), 2 * ulp), err_msg=name
            )
        stats = tckpt.params_to_flax(tnet)["batch_stats"]["BatchNorm_0"]
        for leaf in ("mean", "var"):
            np.testing.assert_allclose(
                stats[leaf], np.asarray(batch_stats["BatchNorm_0"][leaf]), rtol=1e-5, atol=1e-7
            )
        params = new_params
    assert opt.count == 3


@pytest.mark.parametrize("fused", [False, True])
def test_tiny_train_counts_eval_and_determinism(fused):
    config = tiny_config(
        FUSED_ROLLOUT=fused, EVAL_EARLY_EXIT=fused, TEST_DURING_TRAINING=True,
        TEST_NUM_ENVS=8, TEST_NUM_STEPS=48, TEST_INTERVAL=0.25,
    )
    before = (tlr.lambda_returns.launches, tcr.cartpole_rollout.launches)
    a = pqn.make_train(config)()
    m = a["metrics"]
    n_updates = 2048 // 16 // 8
    assert int(m["env_step"][-1]) == 2048 and int(m["update_steps"][-1]) == n_updates
    assert int(m["grad_steps"][-1]) == n_updates * 2 * 2
    assert all(v.shape == (n_updates,) for v in m.values())
    assert torch.isfinite(m["td_loss"]).all() and torch.isfinite(m["qvals"]).all()
    for k in ("test/returned_episode_returns", "test/returned_episode_lengths", "test/returned_episode"):
        assert k in m
    assert (m["returned_episode_returns"] >= 0).all()
    ts = a["runner_state"][0]
    assert ts.timesteps == 2048 and ts.step == n_updates * 4
    assert set(ts.batch_stats) == {"BatchNorm_0.mean", "BatchNorm_0.var"}
    assert set(ts.params) == {n for n, _ in ts.network.named_parameters()}
    # the CPU takes the plain twins: no kernel launch is counted
    assert (tlr.lambda_returns.launches, tcr.cartpole_rollout.launches) == before
    # one seed, one result; another seed, another
    b = pqn.make_train(config)()
    for (name, x), y in zip(ts.network.named_parameters(), b["runner_state"][0].network.parameters()):
        assert torch.equal(x, y), name
    c = pqn.make_train(config)(seed=1)
    assert not torch.equal(m["td_loss"], c["metrics"]["td_loss"])


def test_log_replay_matches_log_wrapper():
    """The fused path's vectorised Log replay gives the Log wrapper's infos
    and end state on the same reward/done stream."""
    env, params = tmake("CartPole-v1", max_steps_in_episode=9)
    log_env = twrappers.Log(env)
    gen = torch.Generator().manual_seed(0)
    obs, state = log_env.reset(gen, 16, params)
    for _ in range(5):  # enter the window mid-episode
        obs, state, *_ = log_env.step(gen, state, torch.randint(0, 2, (16,), generator=gen), params)
    start = state
    rews, dones, infos = [], [], []
    for _ in range(40):
        obs, state, rew, done, info = log_env.step(
            gen, state, torch.randint(0, 2, (16,), generator=gen), params
        )
        rews.append(rew), dones.append(done), infos.append(info)
    got_state, got = pqn.log_replay(start, torch.stack(rews), torch.stack(dones))
    for k in got:
        want = torch.stack([i[k] for i in infos])
        assert torch.equal(got[k], want), k
    for k in ("episode_returns", "episode_lengths", "returned_episode_returns",
              "returned_episode_lengths", "timestep"):
        assert torch.equal(getattr(got_state, k), getattr(state, k)), k


def _float_stream(T=40, E=6, seed=0):
    """Seaquest-like rewards: kills (0-2) and now and then a cash-in of
    oxygen * 0.1f, with episode ends; env 0 never ends inside the stream."""
    r = np.random.RandomState(seed)
    rew = r.randint(0, 3, (T, E)).astype(np.float32)
    cash = r.rand(T, E) < 0.2
    rew[cash] += r.randint(0, 201, cash.sum()).astype(np.float32) * np.float32(0.1)
    done = r.rand(T, E) < 0.12
    done[:, 0] = False
    return rew, done


def _jax_log_replay(carry, rew, done):
    """The JAX trainer's fused replay, pqn.py:371-397, as a scan."""

    def step(carry, rd):
        ep_r, ep_l, ret_r, ret_l, ts = carry
        r, dn = rd
        ner, nel = ep_r + r, ep_l + 1
        nd = (1 - dn).astype(ner.dtype)
        nd_i = (1 - dn).astype(jnp.int32)
        ret_r = ret_r * nd + ner * dn
        ret_l = ret_l * nd_i + nel * dn.astype(jnp.int32)
        ts = ts + 1
        info = {"returned_episode_returns": ret_r, "returned_episode_lengths": ret_l, "timestep": ts,
                "returned_episode": dn.astype(bool)}
        return (ner * nd, nel * nd_i, ret_r, ret_l, ts), info

    return jax.lax.scan(step, carry, (jnp.asarray(rew), jnp.asarray(done, jnp.float32)))


def test_log_replay_sums_float_rewards_in_step_order_as_jax():
    """On a stream of float rewards (Seaquest's cash-ins), entered
    mid-episode: the fused path's replay gives the JAX trainer's replay scan
    infos and end state exactly, since both add in step order (prefix sums
    differ in the last bits)."""
    rew, done = _float_stream()
    E = rew.shape[1]
    r = np.random.RandomState(1)
    ep_r, ret_r = (r.randint(0, 40, E) * np.float32(0.1)).astype(np.float32), r.rand(E).astype(np.float32)
    ep_l, ret_l, ts = (r.randint(0, 50, E).astype(np.int32) for _ in range(3))
    start = twrappers.LogEnvState(None, *(torch.tensor(x) for x in (ep_r, ep_l, ret_r, ret_l, ts)))
    got_state, got = pqn.log_replay(start, torch.tensor(rew), torch.tensor(done))
    (w_ep_r, w_ep_l, w_ret_r, w_ret_l, w_ts), want = _jax_log_replay(
        tuple(jnp.asarray(x) for x in (ep_r, ep_l, ret_r, ret_l, ts)), rew, done)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    for k, v in (("episode_returns", w_ep_r), ("episode_lengths", w_ep_l), ("returned_episode_returns", w_ret_r),
                 ("returned_episode_lengths", w_ret_l), ("timestep", w_ts)):
        np.testing.assert_array_equal(getattr(got_state, k).numpy(), np.asarray(v), err_msg=k)
    assert done[:, 1:].any(0).all() and (rew != np.round(rew)).any()


def test_fused_eval_sums_float_rewards_as_jax():
    """The fused eval's episode sums (algo/metrics.py:eval_episode_metrics)
    on float rewards: every episode's return from a zero start as the JAX
    eval's ``_ep`` scan sums it (pqn.py:721-736), exactly, and their mean over
    the episode ends."""
    rew, done = _float_stream(seed=2)

    def ep(carry, rd):
        ep_r, ep_l = carry
        r, dn = rd
        ner, nel = ep_r + r, ep_l + 1
        keep = 1.0 - dn
        return (ner * keep, nel * keep), (ner, nel)

    zero = jnp.zeros(rew.shape[1], jnp.float32)
    _, (ner, nel) = jax.lax.scan(ep, (zero, zero), (jnp.asarray(rew), jnp.asarray(done, jnp.float32)))
    zero_t = torch.zeros(rew.shape[1])
    got_r, got_l, _, _ = pqn.running_episode_sums(torch.tensor(rew), torch.tensor(done).float(), zero_t, zero_t)
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(ner))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(nel))
    m = pqn.eval_episode_metrics(torch.tensor(rew), torch.tensor(done).float())
    assert m["returned_episode_returns"].item() == pytest.approx(float(np.asarray(ner)[done].mean()), rel=1e-6)


@pytest.mark.parametrize("early_exit,expected", [(False, 22 / 3), (True, 6.0)])
def test_fused_eval_chunks_and_early_exit(monkeypatch, early_exit, expected):
    """As tests/test_ops.py pins the JAX package's fused eval: with a stub
    kernel that ends every episode at local step 5 of each 8-step chunk,
    the plain chunked eval sees episodes of 6, 8, 8 steps, and
    EVAL_EARLY_EXIT stops after the first chunk (unexecuted steps count as
    not done)."""
    CHUNK, B = 8, 4
    calls = []

    def fake_rollout(seed, eps, weights, stf, sti, T, use_prng=True, max_steps=500):
        calls.append(seed)
        assert T == CHUNK
        rew = torch.ones(T, B)
        done = (torch.arange(T) == 5).to(torch.int32)[:, None].expand(T, B).contiguous()
        return (torch.zeros(T, B, 4), torch.zeros(T, B, dtype=torch.int32), rew, done,
                torch.zeros(T, B, 2), torch.zeros(B, 4), stf, sti)

    monkeypatch.setattr(pqn, "cartpole_rollout", fake_rollout)
    config = tiny_config(
        TOTAL_TIMESTEPS=256, TOTAL_TIMESTEPS_DECAY=256, NUM_ENVS=B, NUM_STEPS=CHUNK,
        NUM_MINIBATCHES=1, NUM_EPOCHS=1, TEST_DURING_TRAINING=True, TEST_NUM_ENVS=B,
        TEST_NUM_STEPS=24, TEST_INTERVAL=0.01, FUSED_ROLLOUT=True, EVAL_EARLY_EXIT=early_exit,
    )
    m = pqn.make_train(config)()["metrics"]
    assert m["test/returned_episode_returns"][-1].item() == pytest.approx(expected)
    assert m["test/returned_episode_lengths"][-1].item() == pytest.approx(expected)


def test_unsupported_options_raise():
    # Q_LAMBDA=False, BATCH_ENV and USE_OPTIMISTIC_RESETS are ported now
    # (tests/test_torch_craftax.py), so are RESET_BANK, FAST_TARGETS and
    # SKIP_NOOP_PERMUTE (tests/test_torch_reset_bank.py); a non-FF ALG_NAME
    # is not
    with pytest.raises(NotImplementedError):
        pqn.make_train(tiny_config(ALG_NAME="pqn_vdn"))
    # LOG_VIA_CALLBACK trains and hands each update's row to the logger's
    # callback, as JAX's (tests/test_torch_tooling.py holds the rows to
    # log_history's and to JAX's)
    mem = MemorySink()
    out = pqn.make_train(tiny_config(LOG_VIA_CALLBACK=True), logger=MetricLogger([mem]))()
    assert [r["update_steps"] for r in mem.rows] == out["metrics"]["update_steps"].tolist() == list(range(1, 17))
    with pytest.raises(ValueError, match="FUSED_ROLLOUT"):
        pqn.make_train(tiny_config(FUSED_ROLLOUT=True, NUM_LAYERS=3))
    with pytest.raises(ValueError, match="Unknown env"):
        pqn.make_train(tiny_config(ENV_NAME="NoSuchEnv-v0"))
    if not torch.cuda.is_available():
        # the GPU is the default device, and its absence is an error
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pqn.make_train({**tiny_config(), "DEVICE": None})


def test_cli_recipe(tmp_path, capsys, monkeypatch):
    jsonl = tmp_path / "m.jsonl"
    cli.main([
        "+alg=pqn_cartpole", "DEVICE=cpu", "TOTAL_TIMESTEPS=2048", "TOTAL_TIMESTEPS_DECAY=2048",
        "NUM_ENVS=8", "NUM_STEPS=16", "NUM_MINIBATCHES=2", "NUM_EPOCHS=2", "HIDDEN_SIZE=32",
        "TEST_DURING_TRAINING=False", f"SAVE_PATH={tmp_path / 'models'}", f"LOG_JSONL={jsonl}",
    ])
    assert "Training took" in capsys.readouterr().out
    run_dir = tmp_path / "models" / "CartPole-v1"
    saved = tckpt.load_params(str(run_dir / "pqn_CartPole-v1_seed0.safetensors"))
    assert tuple(saved["Dense_0"]["kernel"].shape) == (4, 32)
    assert (run_dir / "pqn_CartPole-v1_seed0_config.yaml").exists()
    rows = [json.loads(line) for line in jsonl.read_text().splitlines()]
    assert len(rows) == 16 and rows[-1]["env_step"] == 2048 and "td_loss" in rows[-1]
    # HYP_TUNE runs the local random search, as the JAX CLI does without wandb
    monkeypatch.setitem(sys.modules, "wandb", None)
    cli.main([
        "+alg=pqn_cartpole", "DEVICE=cpu", "HYP_TUNE=True", "SWEEP_COUNT=2", "TOTAL_TIMESTEPS=512",
        "TOTAL_TIMESTEPS_DECAY=512", "NUM_ENVS=8", "NUM_STEPS=16", "NUM_MINIBATCHES=2", "NUM_EPOCHS=1",
        "HIDDEN_SIZE=16", "TEST_DURING_TRAINING=False",
    ])
    best = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert best["best"]["LR"] in (0.001, 0.0005, 0.0001, 0.00005) and np.isfinite(best["score"])


BREAKOUT = dict(alg="pqn_minatar", ENV_NAME="Breakout-MinAtar")


@pytest.mark.parametrize("fused", [False, True])
def test_tiny_breakout_train_counts_and_determinism(fused):
    """Breakout-MinAtar with the MinAtar CNN, fused (the rollout's plain twin
    on the CPU) and unfused, with the in-loop eval on: the step, update and
    grad-step counts, finite metrics, the CNN's flax-named parameters, no
    kernel launch on the CPU, and one result per seed."""
    config = tiny_config(
        **BREAKOUT, FUSED_ROLLOUT=fused, EVAL_EARLY_EXIT=fused, TEST_DURING_TRAINING=True,
        TEST_NUM_ENVS=8, TEST_NUM_STEPS=48, TEST_INTERVAL=0.5,
    )
    before = (tlr.lambda_returns.launches, tbr.breakout_rollout.launches)
    a = pqn.make_train(config)()
    m = a["metrics"]
    n_updates = 2048 // 16 // 8
    assert int(m["env_step"][-1]) == 2048 and int(m["update_steps"][-1]) == n_updates
    assert int(m["grad_steps"][-1]) == n_updates * 2 * 2
    assert all(v.shape == (n_updates,) for v in m.values())
    assert torch.isfinite(m["td_loss"]).all() and torch.isfinite(m["qvals"]).all()
    assert "test/returned_episode_returns" in m
    ts = a["runner_state"][0]
    assert isinstance(ts.network, TCNNQNetwork)
    assert ts.params["CNN_0.Conv_0.weight"].shape == (16, 4, 3, 3)
    assert ts.batch_stats["BatchNorm_0.mean"].shape == (4,)
    obs, log_state = a["runner_state"][1]
    assert obs.shape == (8, 10, 10, 4) and log_state.env_state.brick_map.shape == (8, 10, 10)
    assert (tlr.lambda_returns.launches, tbr.breakout_rollout.launches) == before
    b = pqn.make_train(config)()
    assert torch.equal(m["td_loss"], b["metrics"]["td_loss"])
    c = pqn.make_train(config)(seed=1)
    assert not torch.equal(m["td_loss"], c["metrics"]["td_loss"])


# per MinAtar game: its rollout wrapper in algo/pqn.py, the number of state
# tensors it takes and returns, and the env's max_steps
MINATAR_KERNELS = {
    "Asterix-MinAtar": ("asterix_rollout", 1, 1000),
    "Breakout-MinAtar": ("breakout_rollout", 2, 1000),
    "Freeway-MinAtar": ("freeway_rollout", 1, 2500),
    "SpaceInvaders-MinAtar": ("space_invaders_rollout", 4, 1000),
}


@pytest.mark.parametrize("env_name", sorted(MINATAR_KERNELS))
def test_breakout_fused_eval_goes_through_the_game_dispatch(monkeypatch, env_name):
    """The training rollouts and the chunked eval call the game's rollout
    with the env's own max_steps (Freeway's 2500, the others' 1000, the TPU
    kernels' defaults) and thread the state from chunk to chunk."""
    name, n_state, max_steps = MINATAR_KERNELS[env_name]
    calls = []
    real = getattr(pqn, name)

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        states_in = [x.clone() for x in args[3 : 3 + n_state]]
        calls.append((args[3 + n_state], kwargs["max_steps"], states_in, out[6:]))
        return out

    monkeypatch.setattr(pqn, name, spy)
    config = tiny_config(
        alg="pqn_minatar", ENV_NAME=env_name, TOTAL_TIMESTEPS=256, TOTAL_TIMESTEPS_DECAY=256,
        NUM_ENVS=4, NUM_STEPS=8, NUM_MINIBATCHES=1, NUM_EPOCHS=1, FUSED_ROLLOUT=True,
        EVAL_EARLY_EXIT=False, TEST_DURING_TRAINING=True, TEST_NUM_ENVS=4, TEST_NUM_STEPS=24,
        TEST_INTERVAL=1.0,
    )
    pqn.make_train(config)()
    assert all(T == 8 and ms == max_steps for T, ms, _, _ in calls)
    # an eval of 3 chunks, 8 training rollouts, an eval of 3 chunks; each
    # rollout starts where the one before it in its stream ended
    assert len(calls) == 3 + 8 + 3
    for stream in (calls[:3], calls[3:11], calls[11:]):
        for (_, _, _, out), (_, _, state_in, _) in zip(stream, stream[1:]):
            assert len(out) == len(state_in) == n_state
            assert all(torch.equal(a, b) for a, b in zip(state_in, out))


def test_breakout_fused_rollout_requires_layer_norm_and_raw_input():
    for kw in ({"NORM_INPUT": True}, {"NORM_TYPE": "batch_norm"}):
        with pytest.raises(ValueError, match="FUSED_ROLLOUT"):
            pqn.make_train(tiny_config(**BREAKOUT, FUSED_ROLLOUT=True, **kw))
    # the Nature trunk's VALID convs cannot fit 10x10 planes: its dense layer
    # gets no inputs and the he-normal init divides by the zero fan-in, in the
    # JAX package's network init as in the port's
    with pytest.raises(ZeroDivisionError):
        JCNNQNetwork(action_dim=3, trunk="nature").init(jax.random.PRNGKey(0), jnp.zeros((1, 10, 10, 4)), train=False)
    with pytest.raises(ZeroDivisionError):
        pqn.make_train(tiny_config(**BREAKOUT, CNN_TRUNK="nature"))()


def test_cli_recipe_breakout(tmp_path, capsys):
    """The README's CPU recipe for Breakout: the saved params load in the
    JAX package's loader with flax's names and shapes."""
    jsonl = tmp_path / "m.jsonl"
    cli.main([
        "+alg=pqn_minatar", "ENV_NAME=Breakout-MinAtar", "DEVICE=cpu", "TOTAL_TIMESTEPS=2048",
        "TOTAL_TIMESTEPS_DECAY=2048", "NUM_ENVS=8", "NUM_STEPS=16", "NUM_MINIBATCHES=2",
        "NUM_EPOCHS=2", "HIDDEN_SIZE=32", "TEST_DURING_TRAINING=False",
        f"SAVE_PATH={tmp_path / 'models'}", f"LOG_JSONL={jsonl}",
    ])
    assert "Training took" in capsys.readouterr().out
    run_dir = tmp_path / "models" / "Breakout-MinAtar"
    saved = jckpt.load_params(str(run_dir / "pqn_Breakout-MinAtar_seed0.safetensors"))
    assert saved["CNN_0"]["Conv_0"]["kernel"].shape == (3, 3, 4, 16)
    assert saved["CNN_0"]["Dense_0"]["kernel"].shape == (1024, 32)
    assert saved["Dense_0"]["kernel"].shape == (32, 3)
    assert saved["BatchNorm_0"]["scale"].shape == (4,)
    assert (run_dir / "pqn_Breakout-MinAtar_seed0_config.yaml").exists()
    rows = [json.loads(line) for line in jsonl.read_text().splitlines()]
    assert len(rows) == 16 and rows[-1]["env_step"] == 2048


@pytest.mark.slow
def test_cartpole_learns():
    """The port's counterpart of tests/test_pqn_train.py::test_cartpole_learns
    on the CPU: a 200k-step run must clearly beat the random baseline (~20
    return) with a mean training return above 100 near the end."""
    config = compose(
        alg="pqn_cartpole",
        overrides=[
            "DEVICE=cpu", "TOTAL_TIMESTEPS=200000", "TOTAL_TIMESTEPS_DECAY=200000",
            "TEST_DURING_TRAINING=False",
        ],
    )
    rets = pqn.make_train(config)()["metrics"]["returned_episode_returns"]
    assert rets[-10:].mean().item() > 100, rets[-10:]


@pytest.mark.slow
def test_breakout_learns():
    """The chip gate of pqn_minatar on Breakout-MinAtar, on the CPU: at the
    YAML's full width, 500k env steps through the fused rollout's plain twin
    (the path the card runs through the kernel) must lift the mean of the
    last 10 training returns above 3; random play scores about 0.5."""
    config = compose(
        alg="pqn_minatar",
        overrides=[
            "DEVICE=cpu", "ENV_NAME=Breakout-MinAtar", "TOTAL_TIMESTEPS=500000",
            "TOTAL_TIMESTEPS_DECAY=500000", "TEST_DURING_TRAINING=False",
            "FUSED_ROLLOUT=True",
        ],
    )
    rets = pqn.make_train(config)()["metrics"]["returned_episode_returns"]
    print(f"mean return over the first 10 updates {rets[:10].mean().item():.2f}, "
          f"over the last 10 {rets[-10:].mean().item():.2f}")
    assert rets[-10:].mean().item() > 3, rets[-10:]
