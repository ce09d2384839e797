"""The port's Seaquest-MinAtar against the JAX package's, on the CPU: the env
step on the JAX env's own draws (random play, random states, hand-placed
states and the mechanics of tests/test_seaquest.py), the reset, the state
matrix, the fused rollout's plain twin against the Pallas kernel
(interpret mode, PRNG off), the twin's random streams, the CNN at 10
channels and 6 actions, and the trainer."""

import functools
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_minatar_cases import (
    ROLLOUT_NAMES,
    assert_same_step,
    check_cnn_matches_flax_and_crosses,
    check_tiny_train,
    check_wrapper_on_cpu,
    cnn_pair,
    jax_step_env,
    random_play_states,
    to_torch,
)

from purejaxql_torch.algo import pqn
from purejaxql_torch.core.config import compose
from purejaxql_torch.envs import make as tmake
from purejaxql_torch.envs.minatar.seaquest import SeaquestDraws, SeaquestParams, SeaquestState, pick_free_slot
from purejaxql_torch.ops import seaquest_rollout as tsr
from purejaxql_torch.ops.minatar_rollout import minatar_weights
from purejaxql_tpu.envs import make as jmake
from purejaxql_tpu.ops.pallas_rollout import seaquest_rollout_pallas, state_matrix_from_seaquest

torch.set_num_threads(1)

ENV = "Seaquest-MinAtar"
# test_seaquest_learns's gate on the mean of the last 10 training returns
GATE = 0.2
POOLS = {"f": 8, "s": 4, "fb": 4, "eb": 4, "d": 4}


def _draws(keys):
    """The draws the JAX env's step_env makes from each env's key
    (seaquest.py:153-290): fish and subs score from one key, the lane and
    the diver slot come from another."""

    def one(key):
        ks = jax.random.split(key, 6)
        u = lambda k, n: jax.random.uniform(k, (n,), minval=1e-6, maxval=1.0)  # noqa: E731
        return (
            u(ks[0], 4), u(ks[1], 4), u(ks[5], 8), u(ks[5], 4), u(ks[2], 4),
            jax.random.randint(ks[2], (), 1, 9), jax.random.bernoulli(ks[3]),
            jax.random.bernoulli(ks[4], 1.0 / 3.0),
        )

    fb, eb, fish, sub, diver, lane, lr, is_sub = (torch.tensor(np.asarray(x)) for x in jax.jit(jax.vmap(one))(keys))
    return SeaquestDraws(fb=fb, eb=eb, fish=fish, sub=sub, diver=diver, lane=lane.to(torch.int32), lr=lr,
                         is_sub=is_sub)


def _random_states(n, seed):
    """States that meet every rule: the sub anywhere and either way round,
    oxygen from empty to full, 0-6 divers on board, every pool thinly
    filled anywhere with its timers about to fire, subs about to shoot,
    spawns due, surfacing due, a start already terminal, times near the
    limit."""
    r = np.random.RandomState(seed)
    i32 = lambda a: np.asarray(a, np.int32)  # noqa: E731
    cols = {
        "sub_x": i32(r.randint(0, 10, n)), "sub_y": i32(r.choice([0, 0, 1, 2, 4, 8], n)),
        "sub_or": i32(r.randint(0, 2, n)), "oxygen": i32(r.choice([0, 1, 2, 57, 199, 200], n)),
        "divers": i32(r.randint(0, 7, n)), "shot_timer": i32(r.randint(0, 3, n)),
        "spawn_timer": i32(r.randint(0, 3, n)), "diver_spawn_timer": i32(r.randint(0, 3, n)),
        "move_interval": i32(r.randint(1, 6, n)), "surfaced": r.rand(n) < 0.5,
        "terminal": r.rand(n) < 0.05, "time": i32(r.choice([0, 5, 998, 999], n)),
    }
    for p, k in POOLS.items():
        cols[f"{p}_exists"] = r.rand(n, k) < 0.4
        cols[f"{p}_x"] = i32(r.randint(0, 10, (n, k)))
        cols[f"{p}_y"] = i32(r.randint(0, 9, (n, k)) if p in ("fb", "eb") else r.randint(1, 9, (n, k)))
        cols[f"{p}_dir"] = i32(r.choice([-1, 1], (n, k)))
        if p in ("f", "s", "d"):
            cols[f"{p}_timer"] = i32(r.randint(0, 3, (n, k)))
    cols["s_shot_timer"] = i32(r.randint(0, 4, (n, 4)))
    return cols


def _step_both(cols, actions, seed):
    keys = jax.random.split(jax.random.PRNGKey(seed), len(actions))
    jout = jax_step_env(ENV, cols, actions, keys)
    tenv, tparams = tmake(ENV)
    tout = tenv.step_env(to_torch(SeaquestState, cols), torch.tensor(actions).long(), tparams, _draws(keys))
    return jout, tout


@pytest.mark.parametrize("source", ["random_play", "random_states"])
def test_seaquest_step_env_matches_jax(source):
    """Every action from states reached by random play, or from random
    states, on the JAX env's draws: the same next state, obs, reward and
    done, exactly (rewards equal as floats, cash-ins included: the jitted
    JAX step pays oxygen * 0.1f, as the port does)."""
    cols = random_play_states(ENV, 32, 40, 0, 6) if source == "random_play" else _random_states(4096, 1)
    n = len(cols["time"])
    actions = np.random.RandomState(2).randint(0, 6, n).astype(np.int32)
    jout, tout = _step_both(cols, actions, 3)
    assert_same_step(jout, tout)
    rew, done = np.asarray(jout[2]), np.asarray(jout[3])
    assert done.any() and not done.all()
    if source == "random_states":
        st, before = tout[1], to_torch(SeaquestState, cols)
        assert rew.sum() > 0 and (rew != np.round(rew)).any()  # kills and cash-ins
        assert (st.f_exists.sum(1) > before.f_exists.sum(1)).any()  # fish spawned
        assert (st.s_exists.sum(1) > before.s_exists.sum(1)).any()  # subs spawned
        assert (st.eb_exists.sum(1) > before.eb_exists.sum(1)).any()  # subs shot
        assert (st.fb_exists.sum(1) > before.fb_exists.sum(1)).any()  # the player shot
        assert (st.divers > before.divers).any()  # divers picked up


@functools.lru_cache(maxsize=None)
def _jax_start():
    jenv, jparams = jmake(ENV)
    _, jstate = jenv.reset(jax.random.PRNGKey(0), jparams)
    return jax.tree_util.tree_map(np.asarray, jstate.__dict__)


def _fresh(n=1, **kw):
    """``n`` copies of the JAX env's (deterministic) reset state with the
    given fields set, as columns."""
    cols = {k: np.repeat(v[None], n, 0) for k, v in _jax_start().items()}
    for k, v in kw.items():
        if isinstance(v, dict):  # {slot: value} for a pool field
            for slot, x in v.items():
                cols[k][:, slot] = x
        else:
            cols[k][:] = v
    return cols


def _slice(out, lo, hi):
    """Rows lo:hi of a port step's (obs, state, reward, done)."""
    obs, st, rew, done, _ = out
    fields = {f: getattr(st, f)[lo:hi] for f in st.__dataclass_fields__}
    return obs[lo:hi], SeaquestState(**fields), rew[lo:hi], done[lo:hi]


def _step_cases(cases, seed):
    """Step every case, {name: (columns, action)}, in one batch through both
    envs; every row must agree exactly. Returns {name: (obs, state, reward,
    done)} of the port."""
    names = list(cases)
    sizes = [len(cases[k][0]["time"]) for k in names]
    cols = {f: np.concatenate([cases[k][0][f] for k in names]) for f in cases[names[0]][0]}
    actions = np.concatenate([np.broadcast_to(np.int32(cases[k][1]), (n,)) for k, n in zip(names, sizes)])
    jout, tout = _step_both(cols, actions.astype(np.int32), seed)
    assert_same_step(jout, tout)
    bounds = np.cumsum([0] + sizes)
    return {k: _slice(tout, lo, hi) for k, lo, hi in zip(names, bounds[:-1], bounds[1:])}


def _columns(state):
    return {f: getattr(state, f).numpy().copy() for f in state.__dataclass_fields__}


@pytest.fixture(scope="module")
def mechanics():
    """The hand-set cases of tests/test_seaquest.py, a cash-in and the
    hand-placed start of the Pallas exactness test (each of the six
    actions), stepped as one batch through both envs on the JAX env's draws;
    then the second steps of the oxygen and diver cases as another."""
    first = _step_cases({
        "oxygen": (_fresh(sub_y=4, surfaced=False, oxygen=1), 0),
        "diver": (_fresh(sub_x=5, sub_y=4, surfaced=False, oxygen=50, d_exists={0: True}, d_x={0: 5},
                         d_y={0: 3}, d_timer={0: 100}), 2),  # up onto a still diver
        "fatal": (_fresh(sub_y=1, surfaced=False, divers=0, oxygen=50), 2),
        "cash_in": (_fresh(2, sub_y=1, surfaced=False, divers=6, oxygen=np.array([37, 129])), 2),
        "shoot": (_fresh(sub_x=3, sub_y=4, sub_or=1, surfaced=False, f_exists={0: True}, f_x={0: 4},
                         f_y={0: 4}, f_timer={0: 100}), 5),
        "collide": (_fresh(sub_x=4, sub_y=4, surfaced=False, f_exists={0: True}, f_x={0: 4}, f_y={0: 4},
                           f_timer={0: 100}), 0),
        "hand_placed": (_hand_placed(6), np.arange(6, dtype=np.int32)),
    }, 0)
    surfacing = _columns(first["diver"][1])
    surfacing["sub_y"][:] = 1
    second = _step_cases({"oxygen": (_columns(first["oxygen"][1]), 0), "diver": (surfacing, 2)}, 1)
    return first, second


def test_seaquest_oxygen_depletes_underwater_and_kills(mechanics):
    """tests/test_seaquest.py::test_oxygen_depletes_underwater_and_kills:
    two noops underwater from 1 oxygen, 1 -> 0 -> -1, end the episode on
    the second, and the gauge is empty at both."""
    (obs, st, _, done), (obs2, st2, _, done2) = mechanics[0]["oxygen"], mechanics[1]["oxygen"]
    assert not done[0] and st.oxygen[0] == 0 and obs[0, 9, :, 8].sum() == 0
    assert done2[0] and st2.oxygen[0] == -1 and obs2[0, 9, :, 8].sum() == 0


def test_seaquest_diver_pickup_and_surface_refill(mechanics):
    """tests/test_seaquest.py::test_diver_pickup_and_surface_refill: up onto
    a still diver picks it up; surfacing then refills the oxygen and uses
    the diver."""
    (obs, st, _, _), (obs2, st2, rew2, done2) = mechanics[0]["diver"], mechanics[1]["diver"]
    assert st.divers[0] == 1 and not st.d_exists[0, 0] and obs[0, 9, 0, 9] == 1
    assert st2.sub_y[0] == 0 and not done2[0] and st2.oxygen[0] == 200 and st2.divers[0] == 0
    assert rew2[0] == 0 and obs2[0, 9, :, 8].sum() == 9


def test_seaquest_surfacing_without_diver_is_fatal(mechanics):
    _, st, _, done = mechanics[0]["fatal"]
    assert done[0] and st.terminal[0]


def test_seaquest_cash_in_with_six_divers_pays_oxygen_over_ten(mechanics):
    """Surfacing with six divers cashes them in: oxygen / 10 (the surface
    costs no oxygen), a reward that is not an integer, then a full tank and
    no divers. Equal to the JAX env's (held in the fixture), which XLA
    compiles to oxygen * 0.1f: for 129 one bit above 129 / 10."""
    _, st, rew, done = mechanics[0]["cash_in"]
    tenth = np.float32(0.1)
    assert rew.tolist() == [np.float32(37) * tenth, np.float32(129) * tenth]
    assert rew[1] != np.float32(129) / np.float32(10)
    assert rew[0] != round(float(rew[0])) and not done.any()
    assert st.divers.tolist() == [0, 0] and st.oxygen.tolist() == [200, 200]


def test_seaquest_shooting_fish_scores(mechanics):
    _, st, rew, _ = mechanics[0]["shoot"]
    assert rew[0] == 1.0 and not st.f_exists[0, 0] and not st.fb_exists[0].any() and st.shot_timer[0] == 5


def test_seaquest_enemy_collision_kills(mechanics):
    assert mechanics[0]["collide"][3][0]


def test_seaquest_hand_placed_states_step_as_jax(mechanics):
    """The hand-placed start of the Pallas exactness test, each of the six
    actions, steps as the JAX env steps it (held in the fixture): the
    bullet in flight moves on, the sub moves or fires."""
    _, st, _, done = mechanics[0]["hand_placed"]
    assert not done.any() and st.fb_x[:, 2].tolist() == [1] * 6
    assert st.sub_x.tolist() == [5, 4, 5, 6, 5, 5] and st.sub_y.tolist() == [4, 4, 3, 4, 5, 4]
    assert st.fb_exists[5].sum() == 2 and st.shot_timer[5] == 5


def test_seaquest_shapes_and_random_play():
    """tests/test_seaquest.py::test_shapes_and_random_play on the port's own
    draws: 300 random steps of 16 envs through the auto-reset give 0/1
    observations, end episodes and score."""
    env, params = tmake(ENV)
    assert env.observation_space(params).shape == (10, 10, 10) and env.action_space(params).n == 6
    gen = torch.Generator().manual_seed(1)
    obs, state = env.reset(gen, 16, params)
    dones, rews = 0, 0.0
    for _ in range(300):
        action = torch.randint(0, 6, (16,), generator=gen)
        obs, state, rew, done, _ = env.step(gen, state, action, params)
        assert ((obs == 0) | (obs == 1)).all()
        dones, rews = dones + int(done.sum()), rews + float(rew.sum())
    assert dones > 0 and rews > 0


def _hand_placed(B):
    """tests/test_ops.py::test_fused_seaquest_interpret_exactness's start:
    the sub at row 4 under water, fish at (6, 2) moving right and (6, 8)
    moving left, an enemy sub at (3, 9) about to shoot, a friendly bullet
    at (6, 0) in flight, a diver at (5, 5), spawns held off."""
    return _fresh(
        B, spawn_timer=60, diver_spawn_timer=60, sub_y=4, surfaced=False,
        f_exists={0: True, 3: True}, f_x={0: 2, 3: 8}, f_y={0: 6, 3: 6}, f_dir={3: -1},
        s_exists={1: True}, s_x={1: 9}, s_y={1: 3}, s_dir={1: -1}, s_shot_timer=2,
        fb_exists={2: True}, fb_x={2: 0}, fb_y={2: 6}, d_exists={2: True}, d_x={2: 5}, d_y={2: 5},
    )


def test_seaquest_reset_matches_jax():
    env, params = tmake(ENV)
    obs, state = env.reset(torch.Generator().manual_seed(0), 4, params)
    jenv, jparams = jmake(ENV)
    jobs, jstate = jax.vmap(jenv.reset, in_axes=(0, None))(jax.random.split(jax.random.PRNGKey(0), 4), jparams)
    np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs))
    want = to_torch(SeaquestState, jstate)
    for f in want.__dataclass_fields__:
        assert torch.equal(getattr(state, f), getattr(want, f)), f


def test_seaquest_state_matrix_matches_jax_and_round_trips():
    cols = _random_states(8, 5)
    jenv, jparams = jmake(ENV)
    _, jstate = jax.vmap(jenv.reset, in_axes=(0, None))(jax.random.split(jax.random.PRNGKey(0), 8), jparams)
    jstate = jstate.replace(**{k: jnp.asarray(v) for k, v in cols.items()})
    st = tsr.state_matrix_from_seaquest(to_torch(SeaquestState, cols))
    assert st.shape == (128, 8) and st.dtype == torch.int32 and st.is_contiguous()
    np.testing.assert_array_equal(st.numpy(), np.asarray(state_matrix_from_seaquest(jstate)))
    back = tsr.seaquest_from_state_matrix(st)
    for f, v in cols.items():
        np.testing.assert_array_equal(getattr(back, f).numpy(), v, err_msg=f)


@pytest.mark.parametrize("max_steps", [1000, 7])
def test_seaquest_rollout_plain_matches_pallas_interpret(max_steps):
    """B 16, T 20, H 128 (the TPU kernel's packing takes no other width),
    PRNG off, from the hand-placed start: the plain
    twin against seaquest_rollout_pallas(use_prng=False, interpret=True).
    Observations, actions, rewards, dones and the whole (128, B) state
    equal (the PRNG off fixes which slot a spawn takes), Q within 1e-5 (the
    TPU head is padded to 8 rows). The bullet kills the fish, the sub shoots
    back; half the envs start short of oxygen with spawns due, so fish and
    divers spawn and episodes end and reset; max_steps=7 adds time-limit
    resets."""
    B, T = 16, 20
    _, variables, tnet = cnn_pair(10, 6, seed=3, hidden=128)
    cols = _hand_placed(B)
    r = np.random.RandomState(4)
    h = B // 2  # the second half short of oxygen, with spawns due
    cols["oxygen"][h:] = r.randint(2, 9, B - h)
    cols["spawn_timer"][h:] = r.randint(1, 12, B - h)
    cols["diver_spawn_timer"][h:] = r.randint(1, 12, B - h)
    st0 = tsr.state_matrix_from_seaquest(to_torch(SeaquestState, cols))
    want = seaquest_rollout_pallas(
        jnp.asarray(0), jnp.asarray(0.0), variables["params"], jnp.asarray(st0.numpy()),
        T, use_prng=False, interpret=True, max_steps=max_steps,
    )
    got = tsr.seaquest_rollout(0, 0.0, minatar_weights(tnet), st0, T, use_prng=False, max_steps=max_steps)
    assert len(got) == len(want) == 7
    for name, g, w in zip(ROLLOUT_NAMES + ("state",), got, want):
        w = np.asarray(w)
        if name == "q":
            np.testing.assert_allclose(g.numpy(), w[..., :6], atol=1e-5, rtol=0)
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    rew, done = got[2].numpy(), got[3].numpy()
    assert rew.sum() >= B  # the bullet in flight kills a fish in every env
    assert done[:, h:].any(0).all()  # out of oxygen or surfaced without a diver: reset
    if max_steps == 7:
        assert (done.sum(0) >= 2).all()


def test_seaquest_rollout_prng_statistics():
    """PRNG on: P(act != greedy) = eps * 5/6 for 6 actions; the lane is
    uniform on 1-8, a spawn moves right half of the time and is a sub a
    third of the time; the slot scores make a spawn take each free slot
    alike; different seeds give different streams."""
    _, _, tnet = cnn_pair(10, 6, seed=2, hidden=32)
    weights = minatar_weights(tnet)
    B, T = 128, 32
    env, params = tmake(ENV)
    _, state = env.reset(torch.Generator().manual_seed(0), B, params)
    st0 = tsr.state_matrix_from_seaquest(state)
    _, act, _, _, q, _, _ = tsr.seaquest_rollout(11, 0.3, weights, st0, T)
    p = (act.long() != q.argmax(-1)).float().mean().item()
    assert abs(p - 0.25) < 0.02, p
    # the step draws themselves: words 2-28 of every step and env
    _, _, draws = tsr._draws(12, 64, 1024, 6, True, "cpu")  # 65,536 draws of each
    lane = torch.stack([d.lane for d in draws]).flatten()
    share = torch.bincount(lane, minlength=9)[1:].float() / lane.numel()
    assert lane.min() >= 1 and lane.max() <= 8 and (share - 1 / 8).abs().max() < 0.01, share
    lr = torch.stack([d.lr for d in draws]).float().mean().item()
    is_sub = torch.stack([d.is_sub for d in draws]).float().mean().item()
    assert abs(lr - 0.5) < 0.01 and abs(is_sub - 1 / 3) < 0.01
    gen = torch.Generator().manual_seed(3)
    for pool in ("fb", "eb", "fish", "sub", "diver"):
        score = torch.stack([getattr(d, pool) for d in draws])
        free = torch.rand(score.shape, generator=gen) < 0.5
        picked, _ = pick_free_slot(free.flatten(0, 1), score.flatten(0, 1))
        picked = picked.reshape(free.shape)
        assert (picked.sum(-1) == free.any(-1)).all()
        share = picked.sum((0, 1)).float() / free.sum((0, 1)).float()  # P(picked | free), per slot
        expect = (free.float() / free.sum(-1, keepdim=True).clamp(min=1)).sum((0, 1)) / free.sum((0, 1))
        assert (share - expect).abs().max() < 0.03, (pool, share, expect)
    other = tsr.seaquest_rollout(13, 0.3, weights, st0, T)[1]
    assert not torch.equal(act, other)


def test_seaquest_deterministic_slot_choice_follows_the_tpu_kernel():
    """With the PRNG off every slot scores minus its index, and an occupied
    slot counts -1 (`_first_free`): the lowest free slot is taken where it
    is slot 0 or 1, no slot where slot 0 or 1 is occupied and 2 or above is
    the lowest free one."""
    free = torch.tensor([[1, 1, 0, 0], [0, 1, 1, 1], [0, 0, 1, 1], [1, 0, 0, 0], [0, 0, 0, 0]], dtype=torch.bool)
    picked, any_free = pick_free_slot(free, -torch.arange(4.0).expand(5, 4))
    assert picked.int().tolist() == [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 0], [1, 0, 0, 0], [0, 0, 0, 0]]
    assert any_free.tolist() == [True, True, True, True, False]


def test_seaquest_cnn_matches_flax_and_crosses(tmp_path):
    check_cnn_matches_flax_and_crosses(10, 6, tmp_path)


def test_seaquest_wrapper_takes_plain_version_on_cpu_without_counting():
    _, _, tnet = cnn_pair(10, 6, seed=0, hidden=32)
    env, params = tmake(ENV)
    _, state = env.reset(torch.Generator().manual_seed(0), 2, params)
    check_wrapper_on_cpu(tsr.seaquest_rollout, minatar_weights(tnet), (tsr.state_matrix_from_seaquest(state),),
                         10, 6)


@pytest.mark.parametrize("fused", [False, True])
def test_tiny_seaquest_train_counts_and_determinism(fused):
    check_tiny_train(ENV, fused, 10, tsr.seaquest_rollout)


def test_seaquest_kernel_constants_are_the_default_params():
    """The six env params built into csrc/seaquest_rollout.cu are
    SeaquestParams' defaults, which the env's reset and step use."""
    src = (pathlib.Path(tsr.__file__).parents[1] / "csrc" / "seaquest_rollout.cu").read_text()
    built_in = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    params = SeaquestParams()
    assert built_in["kMaxOxygen"] == params.max_oxygen
    assert built_in["kSpawnSpeed"] == params.init_spawn_speed
    assert built_in["kDiverSpawnSpeed"] == params.diver_spawn_speed
    assert built_in["kMoveInterval"] == params.init_move_interval
    assert built_in["kShotCoolDown"] == params.shot_cool_down
    assert built_in["kEnemyShotInterval"] == params.enemy_shot_interval


def _train_500k(*overrides):
    """The mean training return over the first and the last 10 updates of
    pqn_minatar on Seaquest at the YAML's full width, 500k env steps through
    the fused rollout's plain twin (the path the card runs through the
    kernel)."""
    config = compose(
        alg="pqn_minatar",
        overrides=[
            "DEVICE=cpu", f"ENV_NAME={ENV}", "TOTAL_TIMESTEPS=500000", "TOTAL_TIMESTEPS_DECAY=500000",
            "TEST_DURING_TRAINING=False", "FUSED_ROLLOUT=True", *overrides,
        ],
    )
    rets = pqn.make_train(config)()["metrics"]["returned_episode_returns"]
    first, last = rets[:10].mean().item(), rets[-10:].mean().item()
    print(f"{overrides}: mean return over the first 10 updates {first:.3f}, over the last 10 {last:.3f}")
    return last


@pytest.mark.slow
def test_seaquest_learns():
    """The chip gate of pqn_minatar on Seaquest-MinAtar, which the JAX
    package does not have, set from measured runs on the CPU: 500k env steps
    must lift the mean of the last 10 training returns above GATE, 0.2.
    This test (seed 0, one thread) goes from 0.117 over the first 10 updates
    to 0.483 over the last 10; seeds 1 and 2 went to 0.383 and 0.391.
    Without learning (test_seaquest_fails_the_gate_without_learning) the same
    run ends at 0.075 and 0.067 (LR=0, seeds 0 and 1) and at 0.087 and 0.066
    (epsilon held at 1). 0.2 sits 0.113 above the highest of those and 0.183
    below the lowest learned run."""
    last = _train_500k()
    assert last > GATE, last


@pytest.mark.slow
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("off", ["LR=0", "EPS_FINISH=1"], ids=["lr0", "eps1"])
def test_seaquest_fails_the_gate_without_learning(off, seed):
    """The same run with learning switched off: the weights frozen at their
    random init (LR=0), or epsilon held at 1 (uniform random play). Its last
    10 updates must stay below GATE, so that the gate fails a policy that has
    not learned."""
    last = _train_500k(off, f"SEED={seed}")
    assert last < GATE, last
