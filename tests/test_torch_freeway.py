"""The port's Freeway-MinAtar against the JAX package's, on the CPU: the env
step on the JAX env's own draws, the reset's draws by their statistics, the
fused rollout's plain twin against the Pallas kernel (interpret mode, PRNG
off), the twin's random stream, the CNN at 7 channels, and the trainer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_minatar_cases import (
    assert_same_step,
    assert_twin_matches_pallas,
    check_cluster_plan,
    check_cnn_matches_flax_and_crosses,
    check_tiny_train,
    check_wrapper_on_cpu,
    cnn_pair,
    jax_step_env,
    random_play_states,
    to_torch,
)

from purejaxql_torch.envs import make as tmake
from purejaxql_torch.envs.minatar.freeway import FreewayDraws, FreewayState
from purejaxql_torch.ops import freeway_rollout as tfr
from purejaxql_torch.ops.minatar_rollout import minatar_weights
from purejaxql_tpu.envs import make as jmake
from purejaxql_tpu.ops.pallas_rollout import freeway_rollout_pallas, state_matrix_from_freeway

torch.set_num_threads(1)

ENV = "Freeway-MinAtar"


def _draws(keys):
    """The lane speeds and directions the JAX env's step_env draws from each
    env's key (freeway.py:38-48, 93)."""

    def one(key):
        k_speed, k_dir, _ = jax.random.split(key, 3)
        speeds = jax.random.randint(k_speed, (8,), 1, 6)
        return speeds, jnp.where(jax.random.bernoulli(k_dir, 0.5, (8,)), 1, -1)

    speeds, dirs = (torch.tensor(np.asarray(x), dtype=torch.int32) for x in jax.vmap(one)(keys))
    return FreewayDraws(speeds=speeds, dirs=dirs)


def _random_states(n, seed):
    """States that meet every rule: the chicken on any row with its cooldown
    running or over, cars anywhere with their timers about to fire and
    either direction, times near the limit."""
    r = np.random.RandomState(seed)
    i32 = lambda a: np.asarray(a, np.int32)  # noqa: E731
    return {
        "pos": i32(r.randint(0, 10, n)), "car_x": i32(r.randint(0, 10, (n, 8))),
        "car_timer": i32(r.randint(0, 4, (n, 8))),
        "car_speed": i32(r.randint(1, 6, (n, 8)) * r.choice([-1, 1], (n, 8))),
        "move_timer": i32(r.randint(0, 4, n)), "terminal": np.zeros(n, bool),
        "time": i32(r.choice([0, 5, 2498, 2499], n)),
    }


def _step_both(cols, actions, seed):
    keys = jax.random.split(jax.random.PRNGKey(seed), len(actions))
    jout = jax_step_env(ENV, cols, actions, keys)
    tenv, tparams = tmake(ENV)
    tout = tenv.step_env(to_torch(FreewayState, cols), torch.tensor(actions).long(), tparams, _draws(keys))
    return jout, tout


@pytest.mark.parametrize("source", ["random_play", "random_states"])
def test_freeway_step_env_matches_jax(source):
    """Every action from states reached by random play, or from random
    states, on the JAX env's draws: the same next state, obs, reward and
    done, exactly."""
    cols = random_play_states(ENV, 32, 40, 0, 3) if source == "random_play" else _random_states(2048, 1)
    n = len(cols["time"])
    actions = np.random.RandomState(2).randint(0, 3, n).astype(np.int32)
    jout, tout = _step_both(cols, actions, 3)
    assert_same_step(jout, tout)
    if source == "random_states":
        rew, done = np.asarray(jout[2]), np.asarray(jout[3])
        assert done.any() and not done.all() and rew.sum() > 10


def _case(**kw):
    base = {
        "pos": 5, "car_x": np.asarray([0, 1, 2, 3, 5, 6, 7, 8], np.int32),
        "car_timer": np.full(8, 2, np.int32), "car_speed": np.full(8, 3, np.int32),
        "move_timer": 0, "terminal": False, "time": 10,
    }
    base.update(kw)
    return base


def test_freeway_score_hits_and_wrap():
    """Hand-set cases step as the JAX package steps them, and as the rules
    say: the chicken reaches the top (+1, back to the bottom, the lanes take
    the step's speed draws), a car in column 4 on the chicken's row before
    the cars move and one that moves into column 4 send it back, a cooldown
    holds it, and cars wrap round at both edges."""
    lanes = np.asarray([0, 1, 2, 3, 5, 6, 7, 8], np.int32)
    hit_before = lanes.copy()
    hit_before[4] = 4  # the lane of row 5, the chicken's
    move_in = lanes.copy()
    move_in[5] = 3  # row 6: moves right into column 4 this step
    wrap_x = lanes.copy()
    wrap_x[[0, 1]] = [9, 0]
    wrap_speed = np.full(8, 3, np.int32)
    wrap_speed[1] = -3
    cases = [
        (_case(pos=1), 1),  # up into the top row
        (_case(car_x=hit_before), 0),
        (_case(pos=7, car_x=move_in, car_timer=np.zeros(8, np.int32)), 1),  # up onto row 6
        (_case(move_timer=2), 1),  # the cooldown holds the chicken
        (_case(car_x=wrap_x, car_speed=wrap_speed, car_timer=np.zeros(8, np.int32)), 0),
    ]
    cols = {k: np.asarray([c[k] for c, _ in cases]) for k in cases[0][0]}
    actions = np.asarray([a for _, a in cases], np.int32)
    jout, tout = _step_both(cols, actions, 4)
    assert_same_step(jout, tout)
    _, st, rew, done, _ = tout
    draws = _draws(jax.random.split(jax.random.PRNGKey(4), 5))
    assert rew.tolist() == [1.0, 0, 0, 0, 0] and not done.any()
    assert st.pos.tolist() == [9, 9, 9, 5, 5] and st.move_timer.tolist() == [3, 0, 3, 1, 0]
    assert torch.equal(st.car_speed[0], draws.speeds[0] * draws.dirs[0])
    assert st.car_x[4, 0] == 0 and st.car_x[4, 1] == 9


def test_freeway_reset_draws():
    """A reset puts the chicken on the bottom row with no cooldown, the cars
    uniform on the 10 columns, speeds uniform on 1-5 with their timers at
    the speed, and directions +-1 at one half each."""
    env, params = tmake(ENV)
    obs, state = env.reset(torch.Generator().manual_seed(0), 4096, params)
    assert obs.shape == (4096, 10, 10, 7)
    assert (state.pos == 9).all() and (state.move_timer == 0).all() and (state.time == 0).all()
    assert not state.terminal.any()
    x, speed = state.car_x.flatten(), state.car_speed.abs().flatten()
    assert torch.equal(torch.bincount(x, minlength=10) > 0, torch.ones(10, dtype=torch.bool))
    assert (torch.bincount(x, minlength=10).float() / x.numel() - 0.1).abs().max() < 0.01
    assert speed.min() == 1 and speed.max() == 5
    assert (torch.bincount(speed, minlength=6)[1:].float() / speed.numel() - 0.2).abs().max() < 0.01
    assert torch.equal(state.car_timer, state.car_speed.abs())
    assert abs((state.car_speed > 0).float().mean().item() - 0.5) < 0.01
    np.testing.assert_array_equal(obs.numpy(), env.get_obs(state).numpy())


def _pallas_starts(B):
    """Half the envs at an episode's start (the JAX reset), half on random
    states 0-7 steps before the 2500-step limit, so every one of them resets
    inside the window; as the port's state matrix."""
    jenv, jparams = jmake(ENV)
    _, jstate = jax.vmap(jenv.reset, in_axes=(0, None))(jax.random.split(jax.random.PRNGKey(1), B), jparams)
    cols = jax.tree_util.tree_map(np.array, jstate.__dict__)
    h = B // 2
    rand = _random_states(B - h, B)
    for k in cols:
        cols[k][h:] = rand[k]
    cols["time"][h:] = 2500 - 1 - np.arange(B - h) % 8
    return tfr.state_matrix_from_freeway(to_torch(FreewayState, cols))


def test_freeway_rollout_plain_matches_pallas_interpret():
    """B 16, T 8, H 128, PRNG off: the plain twin against
    freeway_rollout_pallas(use_prng=False, interpret=True): observations,
    actions, rewards, dones and the (32, B) state equal, Q within 1e-4.
    Half the envs reach the 2500-step limit inside the window, so the reset
    (cars to column 0, speed 3, direction +1) is compared."""
    B, T = 16, 8
    _, variables, tnet = cnn_pair(7, 3, seed=1, hidden=128)
    st0 = _pallas_starts(B)
    want = freeway_rollout_pallas(
        jnp.asarray(0), jnp.asarray(0.0), variables["params"], jnp.asarray(st0.numpy()),
        T, use_prng=False, interpret=True,
    )
    got = tfr.freeway_rollout(0, 0.0, minatar_weights(tnet), st0, T, use_prng=False)
    assert_twin_matches_pallas(got, want, 3)
    done = got[3].numpy()
    assert done[:, B // 2:].sum(0).tolist() == [1] * (B - B // 2) and not done[:, : B // 2].any()


def test_freeway_state_matrix_matches_jax_and_round_trips():
    cols = _random_states(8, 5)
    jenv, jparams = jmake(ENV)
    _, jstate = jax.vmap(jenv.reset, in_axes=(0, None))(jax.random.split(jax.random.PRNGKey(0), 8), jparams)
    jstate = jstate.replace(**{k: jnp.asarray(v) for k, v in cols.items()})
    st = tfr.state_matrix_from_freeway(to_torch(FreewayState, cols))
    assert st.shape == (32, 8) and st.dtype == torch.int32 and st.is_contiguous()
    np.testing.assert_array_equal(st.numpy(), np.asarray(state_matrix_from_freeway(jstate)))
    back = tfr.freeway_from_state_matrix(st)
    for f, v in cols.items():
        np.testing.assert_array_equal(getattr(back, f).numpy(), v, err_msg=f)


def test_freeway_rollout_prng_statistics():
    """PRNG on: P(act != greedy) = eps * 2/3 for 3 actions; the twin's
    speed, direction and reset-column words are uniform; a reset takes the
    step's speeds and directions; different seeds give different streams."""
    _, _, tnet = cnn_pair(7, 3, seed=2, hidden=32)
    weights = minatar_weights(tnet)
    B, T = 128, 32
    env, params = tmake(ENV)
    _, state = env.reset(torch.Generator().manual_seed(0), B, params)
    st0 = tfr.state_matrix_from_freeway(state)
    _, act, _, _, q, _, _ = tfr.freeway_rollout(11, 0.3, weights, st0, T)
    p = (act.long() != q.argmax(-1)).float().mean().item()
    assert abs(p - 0.2) < 0.02, p
    _, _, cars, reset_x = tfr._draws(12, T, B, 3, True, "cpu")
    speeds = torch.stack([c.speeds for c in cars]).flatten()
    dirs = torch.stack([c.dirs for c in cars]).flatten()
    assert (torch.bincount(speeds, minlength=6)[1:].float() / speeds.numel() - 0.2).abs().max() < 0.01
    assert set(dirs.unique().tolist()) == {-1, 1} and abs((dirs > 0).float().mean().item() - 0.5) < 0.01
    assert (torch.bincount(reset_x.flatten(), minlength=10).float() / reset_x.numel() - 0.1).abs().max() < 0.01
    # every step resets at max_steps=1: the next state holds that step's draws
    stn = tfr.freeway_rollout(12, 0.0, weights, st0, 1, max_steps=1)[6]
    back = tfr.freeway_from_state_matrix(stn)
    assert torch.equal(back.car_x, reset_x[0]) and torch.equal(back.car_timer, cars[0].speeds)
    assert torch.equal(back.car_speed, cars[0].speeds * cars[0].dirs)
    other = tfr.freeway_rollout(13, 0.3, weights, st0, T)[1]
    assert not torch.equal(act, other)


def test_cnn_at_7_channels_matches_flax_and_crosses(tmp_path):
    check_cnn_matches_flax_and_crosses(7, 3, tmp_path)


def test_freeway_wrapper_takes_plain_version_on_cpu_without_counting():
    _, _, tnet = cnn_pair(7, 3, seed=0, hidden=32)
    env, params = tmake(ENV)
    _, state = env.reset(torch.Generator().manual_seed(0), 2, params)
    check_wrapper_on_cpu(tfr.freeway_rollout, minatar_weights(tnet), (tfr.state_matrix_from_freeway(state),), 7, 3)


@pytest.mark.parametrize("fused", [False, True])
def test_tiny_freeway_train_counts_and_determinism(fused):
    check_tiny_train(ENV, fused, 7, tfr.freeway_rollout)


@pytest.mark.parametrize("H", list(range(32, 257, 32)))
@pytest.mark.parametrize("B", [1, 3, 64, 100, 128, 130])
def test_freeway_plan_covers_every_env_and_column(B, H):
    """The kernel's launch plan (csrc/minatar_cluster.cuh): clusters of at
    most 16 CTAs, one env a CTA, so every env has one owner CTA; CTA r of a
    cluster holds the dense weight's columns [r F, (r + 1) F), so every
    conv output (a column) has one owner and the whole dense weight sits on
    chip; the header's shared bytes with the kernel's own ints, within 227
    KB, and two CTAs an SM at H 128 (``check_cluster_plan``)."""
    check_cluster_plan(tfr.freeway_plan, B, H, 7, tfr.GAME_INTS, "freeway_rollout.cu")
