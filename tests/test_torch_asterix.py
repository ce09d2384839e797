"""The port's Asterix-MinAtar against the JAX package's, on the CPU: the env
step on the JAX env's own draws, the reset, the fused rollout's plain twin
against the Pallas kernel (interpret mode, PRNG off), the twin's random
stream, the state matrix, and the trainer."""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_minatar_cases import (
    assert_same_step,
    assert_twin_matches_pallas,
    check_cluster_plan,
    check_tiny_train,
    check_wrapper_on_cpu,
    cnn_pair,
    jax_step_env,
    random_play_states,
    tiny_config,
    to_torch,
)

from purejaxql_torch.algo import pqn
from purejaxql_torch.core.config import compose
from purejaxql_torch.envs import make as tmake
from purejaxql_torch.envs.minatar.asterix import AsterixDraws, AsterixParams, AsterixState
from purejaxql_torch.ops import asterix_rollout as tar
from purejaxql_torch.ops.minatar_rollout import minatar_weights
from purejaxql_tpu.envs import make as jmake
from purejaxql_tpu.ops.pallas_rollout import asterix_rollout_pallas, state_matrix_from_asterix

torch.set_num_threads(1)

ENV = "Asterix-MinAtar"
# test_asterix_learns's gate on the mean of the last 10 training returns
GATE = 0.8


def _draws(keys):
    """The draws the JAX env's step_env makes from each env's key
    (asterix.py:80-92)."""

    def one(key):
        k_slot, k_lr, k_gold = jax.random.split(key, 3)
        return (
            jax.random.uniform(k_slot, (8,), minval=1e-6, maxval=1.0),
            jax.random.bernoulli(k_lr),
            jax.random.bernoulli(k_gold, 1.0 / 3.0),
        )

    gumbel, lr, gold = (torch.tensor(np.asarray(x)) for x in jax.vmap(one)(keys))
    return AsterixDraws(gumbel=gumbel, lr=lr, gold=gold)


def _random_states(n, seed):
    """States that meet every rule: any player cell, entities in any slot,
    spawn and move timers about to fire, ramps due at both parities, speeds
    at their floors, a start already terminal, times near the limit."""
    r = np.random.RandomState(seed)
    i32 = lambda a: np.asarray(a, np.int32)  # noqa: E731
    return {
        "player_x": i32(r.randint(0, 10, n)), "player_y": i32(r.randint(1, 9, n)),
        "e_exists": r.rand(n, 8) < 0.5, "e_x": i32(r.randint(0, 10, (n, 8))),
        "e_lr": r.rand(n, 8) < 0.5, "e_gold": r.rand(n, 8) < 0.3,
        "spawn_speed": i32(r.randint(1, 11, n)), "spawn_timer": i32(r.randint(0, 3, n)),
        "move_speed": i32(r.randint(1, 6, n)), "move_timer": i32(r.randint(0, 3, n)),
        "ramp_timer": i32(r.choice([0, 1, 50], n)), "ramp_index": i32(r.randint(0, 6, n)),
        "terminal": r.rand(n) < 0.05, "time": i32(r.choice([0, 5, 998, 999], n)),
    }


def _step_both(cols, actions, seed):
    keys = jax.random.split(jax.random.PRNGKey(seed), len(actions))
    jout = jax_step_env(ENV, cols, actions, keys)
    tenv, tparams = tmake(ENV)
    tout = tenv.step_env(to_torch(AsterixState, cols), torch.tensor(actions).long(), tparams, _draws(keys))
    return jout, tout


@pytest.mark.parametrize("source", ["random_play", "random_states"])
def test_asterix_step_env_matches_jax(source):
    """Every action from states reached by random play, or from random
    states, on the JAX env's draws: the same next state, obs, reward and
    done, exactly."""
    cols = random_play_states(ENV, 32, 40, 0, 5) if source == "random_play" else _random_states(2048, 1)
    n = len(cols["time"])
    actions = np.random.RandomState(2).randint(0, 5, n).astype(np.int32)
    jout, tout = _step_both(cols, actions, 3)
    assert_same_step(jout, tout)
    rew, done = np.asarray(jout[2]), np.asarray(jout[3])
    assert done.any() and not done.all() and rew.sum() > 0
    if source == "random_states":
        # spawns, ramps of both cadences, entities leaving
        st = tout[1]
        assert (st.e_exists.sum(1) > torch.tensor(cols["e_exists"]).sum(1)).any()
        assert (st.spawn_speed < torch.tensor(cols["spawn_speed"])).any()
        assert (st.move_speed < torch.tensor(cols["move_speed"])).any()


def _case(**kw):
    base = {
        "player_x": 5, "player_y": 5, "e_exists": np.zeros(8, bool), "e_x": np.zeros(8, np.int32),
        "e_lr": np.zeros(8, bool), "e_gold": np.zeros(8, bool), "spawn_speed": 10,
        "spawn_timer": 5, "move_speed": 5, "move_timer": 3, "ramp_timer": 50,
        "ramp_index": 0, "terminal": False, "time": 10,
    }
    base.update(kw)
    return base


def _slots(**by_slot):
    """(e_exists, e_x, e_lr, e_gold) with the given slots set to (x, lr, gold)."""
    ex, x, lr, gold = np.zeros(8, bool), np.zeros(8, np.int32), np.zeros(8, bool), np.zeros(8, bool)
    for k, (xk, lrk, gk) in by_slot.items():
        i = int(k[1:])
        ex[i], x[i], lr[i], gold[i] = True, xk, lrk, gk
    return dict(e_exists=ex, e_x=x, e_lr=lr, e_gold=gold)


def test_asterix_gold_enemy_exit_and_ramp():
    """Hand-set cases step as the JAX package steps them, and as the rules
    say: the player steps onto gold (+1, the gold gone), an enemy reaches the
    player (terminal), an entity leaves the board at the edge, a ramp tick
    speeds up the spawns (even index) or the moves (odd index), and a spawn
    fills the free slot with the highest score."""
    cases = [
        (_case(player_x=4, player_y=3, **_slots(s2=(5, False, True))), 3),  # right onto gold
        (_case(player_y=4, move_timer=0, **_slots(s3=(6, False, False))), 0),  # enemy moves onto the player
        (_case(move_timer=0, **_slots(s0=(9, True, False), s7=(0, False, True))), 0),  # both leave
        (_case(ramp_timer=0, ramp_index=0), 0),
        (_case(ramp_timer=0, ramp_index=1), 0),
        (_case(spawn_timer=0, **_slots(s1=(3, True, False))), 0),
    ]
    cols = {k: np.asarray([c[k] for c, _ in cases]) for k in cases[0][0]}
    actions = np.asarray([a for _, a in cases], np.int32)
    jout, tout = _step_both(cols, actions, 4)
    assert_same_step(jout, tout)
    _, st, rew, done, _ = tout
    assert rew.tolist() == [1.0, 0, 0, 0, 0, 0] and done.tolist() == [False, True] + [False] * 4
    assert not st.e_exists[0, 2] and not st.e_exists[2].any()
    assert st.spawn_speed[3] == 9 and st.move_speed[3] == 5 and st.ramp_timer[3] == 100
    assert st.move_speed[4] == 4 and st.spawn_speed[4] == 10 and st.ramp_index[4] == 2
    free = ~torch.tensor(cases[5][0]["e_exists"])
    draws = _draws(jax.random.split(jax.random.PRNGKey(4), 6))
    want = int(torch.where(free, draws.gumbel[5], -1.0).argmax())
    assert st.e_exists[5].sum() == 2 and st.e_exists[5, want]


def test_asterix_reset_matches_jax():
    env, params = tmake(ENV)
    obs, state = env.reset(torch.Generator().manual_seed(0), 4, params)
    jenv, jparams = jmake(ENV)
    jobs, jstate = jax.vmap(jenv.reset, in_axes=(0, None))(jax.random.split(jax.random.PRNGKey(0), 4), jparams)
    np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs))
    want = to_torch(AsterixState, jstate)
    for f in want.__dataclass_fields__:
        assert torch.equal(getattr(state, f), getattr(want, f)), f


def _pallas_starts(B):
    """Half the envs at an episode's start, half with enemies next to the
    player on its row and the rows above and below, walking at it (only one
    of the 5 actions escapes), and gold on row 2; as the port's state
    matrix."""
    env, params = jmake(ENV)
    _, jstate = jax.vmap(env.reset, in_axes=(0, None))(jax.random.split(jax.random.PRNGKey(1), B), params)
    cols = jax.tree_util.tree_map(np.array, jstate.__dict__)
    r = np.random.RandomState(B)
    h = B // 2
    left = np.arange(B - h) % 2 == 0  # enemies on the player's left, walking right
    for slot in (3, 4, 5):  # rows 4, 5 and 6; the player is at (5, 5)
        cols["e_exists"][h:, slot] = True
        cols["e_x"][h:, slot] = np.where(left, 4, 6)
        cols["e_lr"][h:, slot] = left
    cols["e_exists"][h:, 1] = cols["e_gold"][h:, 1] = True
    cols["e_x"][h:, 1] = r.randint(0, 10, B - h)
    cols["move_timer"][h:] = 0
    cols["spawn_timer"][h:] = r.randint(0, 4, B - h)
    cols["ramp_timer"][h:] = r.randint(0, 3, B - h)
    return tar.state_matrix_from_asterix(to_torch(AsterixState, cols))


@pytest.mark.parametrize("max_steps", [1000, 5])
def test_asterix_rollout_plain_matches_pallas_interpret(max_steps):
    """B 16, T 8, H 128, PRNG off: the plain twin against
    asterix_rollout_pallas(use_prng=False, interpret=True): observations,
    actions, rewards, dones and the (48, B) state equal, Q within 1e-4.
    Enemies on the players' rows end episodes inside the window, so the
    reset is compared; max_steps=5 adds time-limit resets."""
    B, T = 16, 8
    _, variables, tnet = cnn_pair(4, 5, seed=1, hidden=128)
    st0 = _pallas_starts(B)
    want = asterix_rollout_pallas(
        jnp.asarray(0), jnp.asarray(0.0), variables["params"], jnp.asarray(st0.numpy()),
        T, use_prng=False, interpret=True, max_steps=max_steps,
    )
    got = tar.asterix_rollout(0, 0.0, minatar_weights(tnet), st0, T, use_prng=False, max_steps=max_steps)
    assert_twin_matches_pallas(got, want, 5)
    done = got[3].numpy()
    assert done[:, B // 2:].any(0).sum() >= 4  # enemies reached players
    if max_steps == 5:
        assert (done.sum(0) >= 1).all()


def test_asterix_state_matrix_matches_jax_and_round_trips():
    cols = _random_states(8, 5)
    cols["terminal"][:] = False
    jenv, jparams = jmake(ENV)
    _, jstate = jax.vmap(jenv.reset, in_axes=(0, None))(jax.random.split(jax.random.PRNGKey(0), 8), jparams)
    jstate = jstate.replace(**{k: jnp.asarray(v) for k, v in cols.items()})
    st = tar.state_matrix_from_asterix(to_torch(AsterixState, cols))
    assert st.shape == (48, 8) and st.dtype == torch.int32 and st.is_contiguous()
    np.testing.assert_array_equal(st.numpy(), np.asarray(state_matrix_from_asterix(jstate)))
    back = tar.asterix_from_state_matrix(st)
    for f, v in cols.items():
        np.testing.assert_array_equal(getattr(back, f).numpy(), v, err_msg=f)


def test_asterix_rollout_prng_statistics():
    """PRNG on: P(act != greedy) = eps * 4/5 for 5 actions; a spawn is gold
    a third of the time, moves right half of the time, and takes each free
    slot alike; different seeds give different streams."""
    _, _, tnet = cnn_pair(4, 5, seed=2, hidden=32)
    weights = minatar_weights(tnet)
    B, T = 128, 32
    env, params = tmake(ENV)
    _, state = env.reset(torch.Generator().manual_seed(0), B, params)
    st0 = tar.state_matrix_from_asterix(state)
    _, act, _, _, q, _, _ = tar.asterix_rollout(11, 0.3, weights, st0, T)
    p = (act.long() != q.argmax(-1)).float().mean().item()
    assert abs(p - 0.24) < 0.02, p
    # the spawn draws themselves: words 2-11 of every step and env
    u, _, draws = tar._draws(12, T, B, 5, True, "cpu")
    gumbel = torch.stack([d.gumbel for d in draws])
    gold = torch.stack([d.gold for d in draws]).float().mean().item()
    lr = torch.stack([d.lr for d in draws]).float().mean().item()
    assert abs(gold - 1 / 3) < 0.01 and abs(lr - 0.5) < 0.01
    free = torch.rand(T, B, 8, generator=torch.Generator().manual_seed(3)) < 0.5
    slot = torch.where(free, gumbel, -1.0).argmax(-1)
    picked = torch.nn.functional.one_hot(slot, 8).bool() & free
    share = picked.sum((0, 1)).float() / free.sum((0, 1)).float()  # P(picked | free), per slot
    expect = (free.float() / free.sum(-1, keepdim=True).clamp(min=1)).sum((0, 1)) / free.sum((0, 1))
    assert (share - expect).abs().max() < 0.03, (share, expect)
    other = tar.asterix_rollout(13, 0.3, weights, st0, T)[1]
    assert not torch.equal(act, other)


def test_asterix_wrapper_takes_plain_version_on_cpu_without_counting():
    _, _, tnet = cnn_pair(4, 5, seed=0, hidden=32)
    env, params = tmake(ENV)
    _, state = env.reset(torch.Generator().manual_seed(0), 2, params)
    check_wrapper_on_cpu(tar.asterix_rollout, minatar_weights(tnet), (tar.state_matrix_from_asterix(state),), 4, 5)


@pytest.mark.parametrize("fused", [False, True])
def test_tiny_asterix_train_counts_and_determinism(fused):
    check_tiny_train(ENV, fused, 4, tar.asterix_rollout)


def test_pqn_minatar_defaults_to_asterix():
    """The YAML's default game is Asterix: without ENV_NAME the config
    composes it, the cuda policy fuses its rollout (the CPU's does not), and
    a run with no ENV_NAME trains it."""
    cfg = compose(alg="pqn_minatar")
    assert cfg["ENV_NAME"] == ENV and cfg["FUSED_ROLLOUT"] is True and cfg["EVAL_EARLY_EXIT"] is True
    cpu = compose(alg="pqn_minatar", overrides=["DEVICE=cpu"])
    assert "FUSED_ROLLOUT" not in cpu and "EVAL_EARLY_EXIT" not in cpu
    config = tiny_config(TOTAL_TIMESTEPS=256, TOTAL_TIMESTEPS_DECAY=256, TEST_DURING_TRAINING=False)
    assert config["ENV_NAME"] == ENV
    out = pqn.make_train(config)()
    assert out["runner_state"][1][0].shape == (8, 10, 10, 4)


@pytest.mark.parametrize(
    "kwargs",
    [{"ramping": False}, {"ramp_interval": 50}, {"init_spawn_speed": 8}, {"init_move_interval": 4}],
    ids=lambda kw: next(iter(kw)),
)
def test_asterix_fused_rollout_refuses_env_kwargs(kwargs):
    """The kernel keeps `ramping` and the cadences built in, as the TPU
    kernel does (pallas_rollout.py:860), so FUSED_ROLLOUT refuses
    ENV_KWARGS."""
    with pytest.raises(ValueError, match="ENV_KWARGS"):
        pqn.make_train(tiny_config(FUSED_ROLLOUT=True, ENV_KWARGS=kwargs))


def test_asterix_kernel_constants_are_the_default_params():
    """The cadences built into csrc/asterix_rollout.cu are AsterixParams'
    defaults, which the env's reset and ramp use."""
    src = (pathlib.Path(tar.__file__).parents[1] / "csrc" / "asterix_rollout.cu").read_text()
    built_in = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    params = AsterixParams()
    assert built_in["kRampInterval"] == params.ramp_interval
    assert built_in["kInitSpawn"] == params.init_spawn_speed
    assert built_in["kInitMove"] == params.init_move_interval


@pytest.mark.parametrize("H", list(range(32, 257, 32)))
@pytest.mark.parametrize("B", [1, 3, 64, 100, 128, 130])
def test_asterix_plan_covers_every_env_and_column(B, H):
    """The Asterix kernel's launch plan: every env and dense column
    owned once, the header's shared bytes with the kernel's own ints, C 16
    and two CTAs an SM at H 128 (``check_cluster_plan``)."""
    check_cluster_plan(tar.asterix_plan, B, H, 4, tar.GAME_INTS, "asterix_rollout.cu")


def _train_500k(*overrides):
    """The mean training return over the first and the last 10 updates of
    pqn_minatar on Asterix at the YAML's full width, 500k env steps through
    the fused rollout's plain twin (the path the card runs through the
    kernel)."""
    config = compose(
        alg="pqn_minatar",
        overrides=[
            "DEVICE=cpu", "TOTAL_TIMESTEPS=500000", "TOTAL_TIMESTEPS_DECAY=500000",
            "TEST_DURING_TRAINING=False", "FUSED_ROLLOUT=True", *overrides,
        ],
    )
    rets = pqn.make_train(config)()["metrics"]["returned_episode_returns"]
    first, last = rets[:10].mean().item(), rets[-10:].mean().item()
    print(f"{overrides}: mean return over the first 10 updates {first:.2f}, over the last 10 {last:.2f}")
    return last


@pytest.mark.slow
def test_asterix_learns():
    """The chip gate of pqn_minatar on Asterix-MinAtar, the YAML's default
    game, on the CPU: 500k env steps must lift the mean of the last 10
    training returns above GATE, 0.8. This test (seed 0, one thread) goes
    from 0.33 over the first 10 updates (few episodes have ended yet) to
    1.09 over the last 10; seeds 1 and 2 on four threads went to 0.97 and
    1.10, seed 0 on eight threads to 0.93. Without learning
    (test_asterix_fails_the_gate_without_learning) the same run ends at
    0.63 and 0.42 (LR=0, seeds 0 and 1) and at 0.56 and 0.51 (epsilon held
    at 1). 0.8 sits 0.17 above the highest of those and 0.13 below the
    lowest learned run."""
    last = _train_500k()
    assert last > GATE, last


@pytest.mark.slow
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("off", ["LR=0", "EPS_FINISH=1"], ids=["lr0", "eps1"])
def test_asterix_fails_the_gate_without_learning(off, seed):
    """The same run with learning switched off: the weights frozen at their
    random init (LR=0), or epsilon held at 1 (uniform random play). Its last
    10 updates must stay below GATE, so that the gate fails a policy that has
    not learned."""
    last = _train_500k(off, f"SEED={seed}")
    assert last < GATE, last
