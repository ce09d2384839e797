"""NUM_SEEDS > 1 in the VDN and actor-critic trainers on the CPU: a seeded
VDN ``learn_minibatch`` and a seeded actor step plus critic step against
``jax.vmap`` over the lanes of the JAX math they port, and the CLI's
per-seed checkpoints of both families (the actor-critic family's with each
seed's own ``norm_stats``) read by the JAX loader and carried back into
seeded networks.

Sizes are tiny (2 seeds, H 16-32, a few envs); one lane's rewards are
large and the other's small, so that a step must take each seed's own loss
mean and clip."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from purejaxql_torch import cli
from purejaxql_torch.algo import pqn_ac, pqn_vdn
from purejaxql_torch.algo.types import MARLTransition
from purejaxql_torch.core import checkpoint as tckpt
from purejaxql_torch.core.config import compose
from purejaxql_torch.core.optim import make_optimizer
from purejaxql_torch.core.schedules import linear_schedule
from purejaxql_torch.envs import wrappers as twrap
from purejaxql_torch.models.actor_critic import Actor as TActor
from purejaxql_torch.models.actor_critic import CriticEnsemble
from purejaxql_torch.models.rnn import RNNQNetwork as TRNNQNetwork
from purejaxql_tpu.algo import pqn_ac as jax_pqn_ac
from purejaxql_tpu.core import checkpoint as jckpt
from purejaxql_tpu.core.optim import make_optimizer as jax_make_optimizer
from purejaxql_tpu.models.actor_critic import Actor as JActor
from purejaxql_tpu.models.actor_critic import Critic as JCritic
from purejaxql_tpu.models.rnn import RNNQNetwork as JRNNQNetwork
from test_torch_vdn import jax_vdn_targets  # noqa: E402  (tests/ is on the path, as for torch_minatar_cases)

torch.set_num_threads(1)

S = 2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _gens(n):
    return [torch.Generator().manual_seed(100 + i) for i in range(n)]


def _cols(x, axis):
    """(S, ...) lanes -> the port's seed-major columns: the seed axis moved
    to ``axis`` of one lane's shape and merged with the axis after it, lane
    s's block s."""
    x = np.moveaxis(np.asarray(x), 0, axis)
    return torch.tensor(x.reshape(*x.shape[:axis], -1, *x.shape[axis + 2:]))


# ---- VDN ----------------------------------------------------------------------------------

T, A, B, D, N_ACT, H = 9, 3, 4, 7, 5, 16


def _vdn_windows(seed=0):
    """Each lane's numpy-seeded window (S, T, A, B, ...): obs, legal actions
    under random masks, team rewards (lane 0's 30 times larger than its
    noise, lane 1's 0.05), dones, stored hidden states."""
    rng = np.random.RandomState(seed)
    avail = (rng.rand(S, T, A, B, N_ACT) < 0.5).astype(np.float32)
    avail[..., 0] = 1.0
    action = np.array([rng.choice(np.flatnonzero(r)) for r in avail.reshape(-1, N_ACT)]).reshape(S, T, A, B)
    return dict(
        obs=rng.randn(S, T, A, B, D).astype(np.float32), action=action,
        reward=(rng.randn(S, T, 1, B) * np.array([30.0, 0.05])[:, None, None, None]).astype(np.float32),
        done=(rng.rand(S, T, 1, B) < 0.25).astype(np.float32),
        last_hs=(0.3 * rng.randn(S, T, A, B, H)).astype(np.float32),
        last_done=(rng.rand(S, T, A, B) < 0.2).astype(np.float32), avail_actions=avail,
    )


@functools.lru_cache(maxsize=None)
def _jax_vdn_steps():
    """Two grad steps of each lane by the JAX math under ``jax.vmap``: the
    config, the variables, the windows, each step's losses, the new params
    and batch statistics."""
    config = compose(alg="pqn_vdn_spread", overrides=[
        "DEVICE=cpu", "TOTAL_TIMESTEPS=300", "NUM_ENVS=4", "NUM_STEPS=25", "NUM_MINIBATCHES=1", "NUM_EPOCHS=1"])
    config["NUM_UPDATES"] = 3
    gamma, lam = config["GAMMA"], config["LAMBDA"]
    jnet = JRNNQNetwork(action_dim=N_ACT, hidden_size=H, num_layers=2, num_rnn_layers=1, cell_type="gru",
                        norm_input=False, norm_type="layer_norm", add_last_action=False)
    keys = jax.random.split(jax.random.PRNGKey(3), S)
    variables = jax.jit(jax.vmap(lambda k: jnet.init(k, jnet.initialize_carry(1), jnp.zeros((1, 1, D)),
                                                     jnp.zeros((1, 1)), jnp.zeros((1, 1), jnp.int32),
                                                     train=False)))(keys)
    variables = {**variables, "batch_stats": jax.tree_util.tree_map(lambda v: v + 0.25, variables["batch_stats"])}
    w = _vdn_windows()

    def loss_fn(params, batch_stats, win):
        hs0 = [win["last_hs"][0].reshape(-1, H)]
        ld = win["last_done"].reshape(T, -1)
        (_, q), updates = jnet.apply({"params": params, "batch_stats": batch_stats}, hs0,
                                     win["obs"].reshape(T, -1, D), ld, jnp.zeros(ld.shape, jnp.int32), train=True,
                                     mutable=["batch_stats"])
        q = q.reshape(T, A, -1, N_ACT)
        valid_q = jax.lax.stop_gradient(q) - (1 - win["avail_actions"]) * 1e10
        target = jax_vdn_targets(valid_q[-1].max(-1).sum(0), valid_q[:-1], win["reward"][:-1, 0], win["done"][:-1, 0],
                                 gamma, lam).reshape(-1)
        chosen = jnp.take_along_axis(q, win["action"][..., None], -1).squeeze(-1)
        loss = jnp.mean((chosen.sum(1)[:-1].reshape(-1) - jax.lax.stop_gradient(target)) ** 2)
        return loss, updates["batch_stats"]

    tx = jax_make_optimizer(config["MAX_GRAD_NORM"], optax.linear_schedule(config["LR"], 1e-10, 3))

    def learn(params, batch_stats, opt_state, win):
        (loss, bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, batch_stats, win)
        updates, opt_state = tx.update(grads, opt_state, params)
        return loss, optax.apply_updates(params, updates), bs, opt_state, optax.global_norm(grads)

    learn = jax.jit(jax.vmap(learn))
    params, bs = variables["params"], variables["batch_stats"]
    opt_state = jax.jit(jax.vmap(tx.init))(params)
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    jlosses = []
    for _ in range(2):
        loss, params, bs, opt_state, norms = learn(params, bs, opt_state, jw)
        jlosses.append(np.asarray(loss))
    assert norms[0] > config["MAX_GRAD_NORM"] > norms[1], norms
    return config, variables, w, jlosses, _np(params), _np(bs)


@pytest.mark.parametrize("fast_bptt", [False, True])
def test_seeded_vdn_learn_minibatch_matches_vmapped_jax(fast_bptt):
    """Two grad steps of 2 seeds on their windows (columns (T, A, S * B),
    the network reading its rows (S, A, B)) through the module path and
    through FAST_BPTT with the GRU scan's seeded twins, against the JAX math
    of tests/test_torch_vdn.py (the flax forward over a lane's agents-major
    rows, ``_compute_targets``, the MSE, clip + RAdam under VDN's LR
    schedule) under ``jax.vmap``: each lane's loss within 1e-5, the params
    after both steps within 1e-5, each lane's batch statistics within
    1e-6; lane 0's gradient norm crosses MAX_GRAD_NORM, lane 1's does not."""
    config, variables, w, jlosses, params, bs = _jax_vdn_steps()
    gamma, lam = config["GAMMA"], config["LAMBDA"]
    tnet = TRNNQNetwork(D, N_ACT, hidden_size=H, num_layers=2, generator=_gens(S), seeds=S)
    tnet.load_state_dict(tckpt.params_from_flax(_np(variables)))
    opt = make_optimizer(tnet.parameters(), config["MAX_GRAD_NORM"], pqn_vdn.vdn_lr(config), S)
    mb = MARLTransition(
        obs=_cols(w["obs"], 2), action=_cols(w["action"], 2).long(), reward=_cols(w["reward"], 2),
        done=_cols(w["done"], 2), last_hs=(_cols(w["last_hs"], 2),), last_done=_cols(w["last_done"], 2),
        last_action=torch.zeros(T, A, S * B, dtype=torch.long), avail_actions=_cols(w["avail_actions"], 2),
        q_val=torch.zeros(T, A, S * B, N_ACT))
    for want in jlosses:
        loss, chosen = pqn_vdn.learn_minibatch(tnet, opt, mb, gamma, lam, fast_bptt, fast_bptt)
        np.testing.assert_allclose(loss.numpy(), want, atol=1e-5, rtol=1e-5)
    assert chosen.shape == (T, A, S * B)
    want = tckpt.params_from_flax({"params": _np(params)})
    for name, p in tnet.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-5, rtol=0, err_msg=name)
    for leaf in ("mean", "var"):
        np.testing.assert_allclose(getattr(tnet.BatchNorm_0, leaf).numpy(), np.asarray(bs["BatchNorm_0"][leaf]),
                                   atol=1e-6, rtol=0)


# ---- the actor-critic family --------------------------------------------------------------

AC_H, M, OBS, ACT, SCALE = 32, 2, 3, 1, 2.0


def _ac_lanes():
    """flax's actor and critic, each lane's variables (the critics' M
    members a lane), the statistics off their init; and the port's seeded
    actor and ensemble on those weights (the critics' (S, M, ...) leaves as
    (S * M, ...))."""
    jactor = JActor(ACT, action_scale=jnp.asarray(SCALE), action_bias=jnp.asarray(0.0), hidden_sizes=(AC_H, AC_H),
                    norm_type="layer_norm")
    jcritic = JCritic(hidden_sizes=(AC_H, AC_H), norm_type="layer_norm")
    av = jax.jit(jax.vmap(lambda k: jactor.init(k, jnp.zeros(OBS))))(jax.random.split(jax.random.PRNGKey(0), S))
    cv = jax.jit(jax.vmap(jax.vmap(jcritic.init, in_axes=(0, None, None)), in_axes=(0, None, None)))(
        jax.random.split(jax.random.PRNGKey(1), (S, M)), jnp.zeros(OBS), jnp.zeros(ACT))
    av = {**av, "batch_stats": jax.tree_util.tree_map(lambda v: v + 0.25, av["batch_stats"])}
    cv = {**cv, "batch_stats": jax.tree_util.tree_map(lambda v: v * 1.5 + 0.1, cv["batch_stats"])}
    actor = TActor(OBS, ACT, SCALE, 0.0, [AC_H, AC_H], generator=_gens(S), seeds=S)
    critics = CriticEnsemble(M, OBS, ACT, [AC_H, AC_H], generator=_gens(S), seeds=S)
    actor.load_state_dict(tckpt.params_from_flax(_np(av)))
    critics.load_state_dict(tckpt.params_from_flax(_members(cv)))
    return jactor, jcritic, av, cv, actor, critics


def _members(tree):
    """A critic tree with (S, M, ...) leaves as the ensemble's (S * M, ...)."""
    return jax.tree_util.tree_map(lambda v: np.asarray(v).reshape(-1, *np.shape(v)[2:]), tree)


@pytest.mark.parametrize("use_qlambda", [True, False])
def test_seeded_actor_and_critic_steps_match_vmapped_jax(use_qlambda):
    """One actor step and one critic step of 2 seeds (``learn_minibatch``:
    the actor first, reading the critics before their step) on each seed's
    32 rows, against tests/test_torch_ac.py's JAX composition of
    pqn_ac.py:420-535 under ``jax.vmap`` over the lanes (the critics' M
    members vmapped inside a lane): each lane's critic and actor loss
    within 1e-5 relative, the new params within 1e-6, the batch statistics
    within 1e-6; Q(lambda) targets and the 1-step path, whose double batch
    is each seed's obs, then its next_obs."""
    config = compose(alg="pqn_pendulum", overrides=["DEVICE=cpu"])
    jactor, jcritic, av, cv, actor, critics = _ac_lanes()
    n = 32
    r = np.random.RandomState(5)
    act = r.uniform(-2, 2, (S, n, ACT)).astype(np.float32)
    th = r.uniform(-np.pi, np.pi, (S, n))
    mb = dict(
        done=(r.rand(S, n) < 0.2).astype(np.float32),
        original_action=np.clip(act + r.randn(S, n, ACT) * 0.5, -2, 2).astype(np.float32), action=act,
        next_action=r.uniform(-2, 2, (S, n, ACT)).astype(np.float32), value=np.zeros((S, n), np.float32),
        reward=(r.randn(S, n) * np.array([[40.0], [0.05]])).astype(np.float32),
        obs=np.stack([np.cos(th), np.sin(th), r.uniform(-8, 8, (S, n))], -1).astype(np.float32),
        next_obs=np.stack([np.sin(th), np.cos(th), r.uniform(-8, 8, (S, n))], -1).astype(np.float32),
    )
    target = (mb["reward"] + r.randn(S, n) * 0.1).astype(np.float32)
    tx = jax_make_optimizer(config["MAX_GRAD_NORM"], optax.linear_schedule(config["LR_START"], config["LR_END"], 1000))

    def lane(a_params, a_bs, c_params, c_bs, b, tgt):
        def critic_loss(p):
            def train_pass(o, a):
                return jax.vmap(lambda pp, bs: jcritic.apply({"params": pp, "batch_stats": bs}, o, a, train=True,
                                                             mutable=["batch_stats"]))(p, c_bs)
            if use_qlambda:
                values, upd = train_pass(b["obs"], b["action"])
                t = tgt
            else:
                all_q, upd = train_pass(jnp.concatenate((b["obs"], b["next_obs"])),
                                        jnp.concatenate((b["action"], b["next_action"])))
                values, next_values = jnp.split(all_q, 2, axis=1)
                t = b["reward"] + (1 - b["done"]) * config["GAMMA"] * jax.lax.stop_gradient(next_values).mean(0)
            per = jax.vmap(jax_pqn_ac.smooth_l1_loss, in_axes=(0, None))(values, jax.lax.stop_gradient(t))
            return jnp.sum(jax.vmap(jnp.mean)(per)), upd

        def actor_loss(p):
            action, upd = jactor.apply({"params": p, "batch_stats": a_bs}, b["obs"], train=True,
                                       mutable=["batch_stats"])
            q = jax.vmap(lambda pp, bs: jcritic.apply({"params": pp, "batch_stats": bs}, b["obs"], action,
                                                      train=False))(c_params, c_bs).mean(0)
            norm_diff = jnp.abs((action - b["original_action"]) / SCALE).mean(-1)
            pen = jax_pqn_ac.smooth_l1_loss(action, b["original_action"]).mean(-1)
            penalty = jnp.where(norm_diff < config["THRESHOLD"], 0.0, config["PENALTY_COEFF"] * pen)
            return jnp.mean(-q + penalty), upd

        out = []
        for fn, p in ((critic_loss, c_params), (actor_loss, a_params)):
            (loss, upd), grads = jax.value_and_grad(fn, has_aux=True)(p)
            updates, _ = tx.update(grads, tx.init(p), p)
            out.append((loss, optax.apply_updates(p, updates), upd["batch_stats"]))
        return out

    (jc_loss, jc_params, jc_bs), (ja_loss, ja_params, ja_bs) = jax.jit(jax.vmap(lane))(
        av["params"], av["batch_stats"], cv["params"], cv["batch_stats"],
        {k: jnp.asarray(v) for k, v in mb.items()}, jnp.asarray(target))
    sched = linear_schedule(config["LR_START"], config["LR_END"], 1000)
    aopt = make_optimizer(actor.parameters(), config["MAX_GRAD_NORM"], sched, S)
    copt = make_optimizer(critics.parameters(), config["MAX_GRAD_NORM"], sched, S)
    batch = pqn_ac.ACTransition(**{k: _cols(v, 0) for k, v in mb.items()})
    c_loss, a_loss = pqn_ac.learn_minibatch(actor, critics, aopt, copt, batch,
                                            _cols(target, 0) if use_qlambda else None, config, SCALE, 0.0)
    np.testing.assert_allclose(c_loss.numpy(), np.asarray(jc_loss), rtol=1e-5)
    np.testing.assert_allclose(a_loss.numpy(), np.asarray(ja_loss), rtol=1e-5)
    for net, want in ((critics, tckpt.params_from_flax(_members({"params": jc_params, "batch_stats": jc_bs}))),
                      (actor, tckpt.params_from_flax({"params": _np(ja_params), "batch_stats": _np(ja_bs)}))):
        for name, p in net.state_dict().items():
            np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=1e-6, rtol=0, err_msg=name)


# ---- the CLI ------------------------------------------------------------------------------


def test_cli_with_two_seeds_writes_per_seed_vdn_and_ac_files(tmp_path, capsys):
    """``NUM_SEEDS=2`` through the CLI: the aggregate rate counts both
    seeds; VDN and the actor-critic family write one ``_vmap{i}`` file a
    seed and no single-seed file; the JAX loader reads them; VDN's file i
    holds lane i; the actor-critic file i holds lane i's actor (its greedy
    actions within 1e-5 of flax's on the file's params), its own M critics
    and seed i's own observation statistics (``norm_stats``, the seeds'
    apart); ``load_ac_params`` carries both files back into seeded
    networks and statistics (2, obs_dim), equal to the run's."""
    vdn = cli.single_run(compose(alg="pqn_vdn_spread", overrides=[
        "DEVICE=cpu", "NUM_SEEDS=2", "TOTAL_TIMESTEPS=512", "NUM_ENVS=8", "NUM_STEPS=8", "MEMORY_WINDOW=2",
        "NUM_MINIBATCHES=2", "NUM_EPOCHS=1", "HIDDEN_SIZE=16", "TEST_DURING_TRAINING=False",
        f"SAVE_PATH={tmp_path / 'models'}", f"LOG_JSONL={tmp_path / 'v.jsonl'}"]))
    assert "— 1024 env steps" in capsys.readouterr().out
    run_dir = tmp_path / "models" / "Spread-v0"
    assert not (run_dir / "pqn_vdn_rnn_Spread-v0_seed0.safetensors").exists()
    net = vdn["runner_state"][0].network
    for i in range(S):
        saved = jckpt.load_params(str(run_dir / f"pqn_vdn_rnn_Spread-v0_seed0_vmap{i}.safetensors"))
        np.testing.assert_array_equal(np.asarray(saved["ScannedRNN_0"]["GRUCell_0"]["hn"]["kernel"]),
                                      net.ScannedRNN_0.GRUCell_0.hn.weight[i].T.detach().numpy())
    rows = [json.loads(line) for line in (tmp_path / "v.jsonl").read_text().splitlines()]
    assert [r["update_steps"] for r in rows] == list(range(1, 9)) * 2

    ac = cli.single_run(compose(alg="pqn_pendulum", overrides=[
        "DEVICE=cpu", "NUM_SEEDS=2", "TOTAL_TIMESTEPS=1024", "NUM_ENVS=8", "NUM_STEPS=16", "NUM_MINIBATCHES=2",
        "NUM_EPOCHS=1", "ACTOR_HIDDEN_SIZES=[16,16]", "CRITIC_HIDDEN_SIZES=[16,16]", "NORMALIZE_OBS=True",
        "NORMALIZE_REWARD=True", "TEST_DURING_TRAINING=False", f"SAVE_PATH={tmp_path / 'models'}",
        f"LOG_JSONL={tmp_path / 'a.jsonl'}"]))
    assert "— 2048 env steps" in capsys.readouterr().out
    run_dir = tmp_path / "models" / "Pendulum-v1"
    assert not (run_dir / "pqn_ac_Pendulum-v1_seed0.safetensors").exists()
    states = ac["runner_state"][0]
    stats = ac["runner_state"][1][1]
    assert isinstance(stats, twrap.NormalizeVecObsState) and tuple(stats.mean.shape) == (S, 3)
    assert not torch.equal(stats.mean[0], stats.mean[1])
    jactor = JActor(1, action_scale=jnp.asarray(2.0), action_bias=jnp.asarray(0.0), hidden_sizes=(16, 16))
    init = jax.jit(jactor.init)(jax.random.PRNGKey(0), jnp.zeros(3))
    apply = jax.jit(jactor.apply)
    obs = np.random.RandomState(0).randn(S, 5, 3).astype(np.float32)
    with torch.no_grad():
        got = states["actor"].network(torch.tensor(obs).flatten(0, 1), train=False).reshape(S, 5, 1)
    trees = []
    for i in range(S):
        tree = jckpt.load_params(str(run_dir / f"pqn_ac_Pendulum-v1_seed0_vmap{i}.safetensors"))
        assert set(tree) == {"actor", "critic", "norm_stats"}
        assert np.shape(tree["critic"]["Dense_0"]["kernel"]) == (2, 4, 16)
        np.testing.assert_array_equal(np.asarray(tree["norm_stats"]["mean"]), stats.mean[i].numpy())
        np.testing.assert_array_equal(np.asarray(tree["norm_stats"]["var"]), stats.var[i].numpy())
        want = apply({"params": tree["actor"], "batch_stats": init["batch_stats"]}, jnp.asarray(obs[i]))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want), atol=1e-5, rtol=0)
        trees.append(tckpt.load_params(str(run_dir / f"pqn_ac_Pendulum-v1_seed0_vmap{i}.safetensors")))
    actor = TActor(3, 1, 2.0, 0.0, [16, 16], generator=_gens(S), seeds=S)
    critics = CriticEnsemble(2, 3, 1, [16, 16], generator=_gens(S), seeds=S)
    fresh = twrap.NormalizeVecObsState(mean=torch.zeros(S, 3), var=torch.ones(S, 3), count=torch.ones(S),
                                       env_state=None)
    loaded = tckpt.load_ac_params(trees, actor, critics, fresh)
    assert torch.equal(loaded.mean, stats.mean) and torch.equal(loaded.var, stats.var)
    for mine, theirs in ((actor, states["actor"].network), (critics, states["critic"].network)):
        for (name, p), q in zip(mine.named_parameters(), theirs.parameters()):
            assert torch.equal(p, q), name
