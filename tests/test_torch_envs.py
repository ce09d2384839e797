"""The port's batched CartPole and Breakout-MinAtar, auto-reset and Log
wrapper against the JAX package's, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from purejaxql_torch.envs import make as tmake
from purejaxql_torch.envs import wrappers as twrappers
from purejaxql_torch.envs.base import NO_DRAWS
from purejaxql_torch.envs.classic.cartpole import CartPoleState
from purejaxql_torch.envs.minatar.breakout import BreakoutState, start_state
from purejaxql_tpu.envs import make as jmake
from purejaxql_tpu.envs import wrappers as jwrappers
from purejaxql_tpu.envs.classic.cartpole import CartPoleState as JCartPoleState
from purejaxql_tpu.envs.minatar.breakout import BreakoutState as JBreakoutState

pytestmark = pytest.mark.quick
torch.set_num_threads(1)


def _states(n, seed):
    rng = np.random.RandomState(seed)
    cols = {
        "x": rng.uniform(-3.0, 3.0, n),  # beyond +-2.4 too
        "x_dot": rng.uniform(-2.0, 2.0, n),
        "theta": rng.uniform(-0.3, 0.3, n),  # beyond +-12 degrees too
        "theta_dot": rng.uniform(-3.0, 3.0, n),
    }
    cols = {k: v.astype(np.float32) for k, v in cols.items()}
    cols["time"] = rng.choice([0, 1, 250, 498, 499, 500], n).astype(np.int32)
    return cols, rng.randint(0, 2, n).astype(np.int32)


def test_step_env_matches_jax():
    """Out-of-bounds, time-limit and ordinary states, both actions:
    next obs within 1e-6, reward and done equal."""
    n = 512
    cols, actions = _states(n, 0)
    jenv, jparams = jmake("CartPole-v1")
    jstate = JCartPoleState(**{k: jnp.asarray(v) for k, v in cols.items()})
    jobs, jst, jrew, jdone, _ = jax.vmap(jenv.step_env, in_axes=(None, 0, 0, None))(
        jax.random.PRNGKey(0), jstate, jnp.asarray(actions), jparams
    )
    tenv, tparams = tmake("CartPole-v1")
    tstate = CartPoleState(**{k: torch.tensor(v) for k, v in cols.items()})
    tobs, tst, trew, tdone, _ = tenv.step_env(tstate, torch.tensor(actions).long(), tparams, NO_DRAWS)
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(trew.numpy(), np.asarray(jrew))
    np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
    np.testing.assert_array_equal(tst.time.numpy(), np.asarray(jst.time))
    # the mix covers every case
    assert np.asarray(jdone).any() and not np.asarray(jdone).all()
    assert (np.asarray(jrew) == 0).any() and (np.asarray(jrew) == 1).any()


def test_auto_reset_and_reset_draws():
    env, params = tmake("CartPole-v1")
    gen = torch.Generator().manual_seed(0)
    obs, state = env.reset(gen, 4096, params)
    assert obs.shape == (4096, 4) and state.time.dtype == torch.int32
    assert obs.min() >= -0.05 and obs.max() <= 0.05
    assert abs(obs.mean().item()) < 0.002
    assert abs(obs.std().item() - 0.1 / np.sqrt(12)) < 0.001
    # time limit: step from time 499 ends every episode and resets
    state.time[:] = 499
    obs2, state2, rew, done, _ = env.step(gen, state, torch.zeros(4096, dtype=torch.long), params)
    assert done.all() and (rew == 1).all() and (state2.time == 0).all()
    assert obs2.abs().max() <= 0.05
    np.testing.assert_array_equal(obs2.numpy(), env.get_obs(state2).numpy())
    # no reset where the episode goes on
    state.time[:] = 3
    obs3, state3, _, done3, _ = env.step(gen, state, torch.ones(4096, dtype=torch.long), params)
    assert not done3.any() and (state3.time == 4).all()


def test_log_wrapper_matches_jax():
    """Log accounting over 20 steps of envs whose episodes end by a short
    time limit (7 steps) with alternating pushes, so the reward/done streams
    agree between the packages although the reset draws do not."""
    n, T = 6, 20
    jenv, jparams = jmake("CartPole-v1", max_steps_in_episode=7)
    jlog = jwrappers.Log(jenv)
    jobs, jstate = jax.vmap(jlog.reset, in_axes=(0, None))(
        jax.random.split(jax.random.PRNGKey(0), n), jparams
    )
    tenv, tparams = tmake("CartPole-v1", max_steps_in_episode=7)
    tlog = twrappers.Log(tenv)
    gen = torch.Generator().manual_seed(0)
    tobs, tstate = tlog.reset(gen, n, tparams)
    jstep = jax.jit(jax.vmap(jlog.step, in_axes=(0, 0, 0, None)))
    for t in range(T):
        action = np.full(n, t % 2, np.int32)
        jobs, jstate, jrew, jdone, jinfo = jstep(
            jax.random.split(jax.random.PRNGKey(t + 1), n), jstate, jnp.asarray(action), jparams
        )
        tobs, tstate, trew, tdone, tinfo = tlog.step(gen, tstate, torch.tensor(action).long(), tparams)
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        np.testing.assert_array_equal(trew.numpy(), np.asarray(jrew))
        for k in ("returned_episode_returns", "returned_episode_lengths", "timestep", "returned_episode"):
            np.testing.assert_array_equal(tinfo[k].numpy(), np.asarray(jinfo[k]), err_msg=k)
    assert np.asarray(jinfo["returned_episode_lengths"]).max() == 7


def test_registry():
    env, params = tmake("CartPole-v1", max_steps_in_episode=50)
    assert params.max_steps_in_episode == 50 and env.action_space(params).n == 2
    assert env.observation_space(params).shape == (4,)
    with pytest.raises(ValueError, match="Unknown env"):
        tmake("NoSuchEnv-v0")


# ---- Breakout-MinAtar ------------------------------------------------------------

_BO_FIELDS = ("ball_y", "ball_x", "ball_dir", "pos", "brick_map", "strike",
              "last_y", "last_x", "terminal", "time")


def _random_play_states(n_envs, n_steps, seed):
    """Breakout states that random play reaches in the JAX package (auto-reset
    on), every step of every env, as numpy arrays."""
    env, params = jmake("Breakout-MinAtar")
    _, state = jax.vmap(env.reset, in_axes=(0, None))(
        jax.random.split(jax.random.PRNGKey(seed), n_envs), params
    )
    step = jax.jit(jax.vmap(env.step, in_axes=(0, 0, 0, None)))
    rng = np.random.RandomState(seed)
    seen = []
    for t in range(n_steps):
        seen.append(jax.tree_util.tree_map(np.asarray, state))
        _, state, *_ = step(
            jax.random.split(jax.random.PRNGKey(1000 + t), n_envs), state,
            jnp.asarray(rng.randint(0, 3, n_envs)), params,
        )
    return {f: np.concatenate([getattr(s, f) for s in seen]) for f in _BO_FIELDS}


def _random_boards(n, seed):
    """Random states the ball can be in above the paddle row: any position,
    direction, paddle, strike latch and time, a thinned wall, and a quarter
    of the boards cleared."""
    r = np.random.RandomState(seed)
    by, bx, d = r.randint(0, 9, n), r.randint(0, 10, n), r.randint(0, 4, n)
    walls = (r.rand(n, 10, 10) < 0.6) & (np.arange(10) >= 1)[:, None] & (np.arange(10) <= 3)[:, None]
    walls[: n // 4] = False
    i32 = lambda a: np.asarray(a, np.int32)  # noqa: E731
    return {
        "ball_y": i32(by), "ball_x": i32(bx), "ball_dir": i32(d), "pos": i32(r.randint(0, 10, n)),
        "brick_map": i32(walls), "strike": r.rand(n) < 0.3,
        "last_y": i32(np.clip(by - np.array([-1, -1, 1, 1])[d], 0, 9)),
        "last_x": i32(np.clip(bx - np.array([-1, 1, 1, -1])[d], 0, 9)),
        "terminal": np.zeros(n, bool), "time": i32(r.choice([0, 5, 998, 999], n)),
    }


def _crafted_cases():
    """Hand-set cases, as (state columns, action): a ball flying up into a
    brick with the strike latch off (scores, bounces, brick removed) and on
    (passes, no reward), and a cleared board whose ball the paddle catches
    on the bottom row (the wall respawns)."""
    cols = {f: [] for f in _BO_FIELDS}
    empty = np.zeros((10, 10), np.int32)
    wall = empty.copy()
    wall[1:4] = 1
    for strike, by, bricks in ((False, 4, wall), (True, 4, wall), (False, 8, empty)):
        d = 1 if by == 4 else 2  # up-right into (3, 6); down-right onto (9, 6)
        row = dict(ball_y=by, ball_x=5, ball_dir=d, pos=6, brick_map=bricks, strike=strike,
                   last_y=by + (1 if d == 1 else -1), last_x=4, terminal=False, time=10)
        for f in _BO_FIELDS:
            cols[f].append(row[f])
    cols = {f: np.asarray(v) for f, v in cols.items()}
    for f in _BO_FIELDS:
        if cols[f].dtype == np.int64:
            cols[f] = cols[f].astype(np.int32)
    return cols, np.zeros(3, np.int32)


def _step_both(cols, actions):
    jenv, jparams = jmake("Breakout-MinAtar")
    jstate = JBreakoutState(**{k: jnp.asarray(v) for k, v in cols.items()})
    jout = jax.vmap(jenv.step_env, in_axes=(None, 0, 0, None))(
        jax.random.PRNGKey(0), jstate, jnp.asarray(actions), jparams
    )
    tenv, tparams = tmake("Breakout-MinAtar")
    tstate = BreakoutState(**{k: torch.tensor(v) for k, v in cols.items()})
    tout = tenv.step_env(tstate, torch.tensor(actions).long(), tparams, NO_DRAWS)
    return jout, tout


def _assert_same_step(jout, tout):
    (jobs, jst, jrew, jdone, _), (tobs, tst, trew, tdone, _) = jout, tout
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
    np.testing.assert_array_equal(trew.numpy(), np.asarray(jrew))
    np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
    for f in _BO_FIELDS:
        np.testing.assert_array_equal(getattr(tst, f).numpy(), np.asarray(getattr(jst, f)), err_msg=f)


@pytest.mark.parametrize("source", ["random_play", "random_boards"])
def test_breakout_step_env_matches_jax(source):
    """Every action from states reached by random play, or from random
    boards: the same next state, obs, reward and done, exactly."""
    cols = _random_play_states(64, 60, 0) if source == "random_play" else _random_boards(2048, 1)
    n = len(cols["time"])
    actions = np.random.RandomState(2).randint(0, 3, n).astype(np.int32)
    jout, tout = _step_both(cols, actions)
    _assert_same_step(jout, tout)
    rew, done = np.asarray(jout[2]), np.asarray(jout[3])
    assert done.any() and not done.all()
    if source == "random_boards":
        # bricks scored, latched strikes held through a brick, cleared walls respawned
        assert rew.sum() > 50 and (cols["strike"] & np.asarray(jout[1].strike)).any()
        assert (np.asarray(jout[1].brick_map)[: n // 4].sum((1, 2)) == 30).any()


def test_breakout_strike_latch_and_wall_respawn():
    """The hand-set cases step as the JAX package steps them, and as the
    rules say: a scored brick bounces the ball and is removed, a latched
    strike passes through, a caught ball over a cleared board respawns the
    wall."""
    cols, actions = _crafted_cases()
    jout, tout = _step_both(cols, actions)
    _assert_same_step(jout, tout)
    _, st, rew, done, _ = tout
    assert rew.tolist() == [1.0, 0.0, 0.0] and not done.any()
    assert st.brick_map[0, 3, 6] == 0 and st.ball_y[0] == 4 and st.ball_dir[0] == 2
    assert st.brick_map[1, 3, 6] == 1 and st.ball_y[1] == 3 and bool(st.strike[1])
    assert st.brick_map[2].sum() == 30 and st.ball_y[2] == 8


def test_breakout_reset_matches_jax_and_draws_both_sides():
    """A reset is the JAX package's start for the same side; the side is
    drawn with probability 1/2."""
    env, params = tmake("Breakout-MinAtar")
    obs, state = env.reset(torch.Generator().manual_seed(0), 4096, params)
    assert obs.shape == (4096, 10, 10, 4) and obs.dtype == torch.float32
    assert abs((state.ball_x == 9).float().mean().item() - 0.5) < 0.03
    jenv, jparams = jmake("Breakout-MinAtar")
    jobs, jstate = jax.vmap(jenv.reset, in_axes=(0, None))(
        jax.random.split(jax.random.PRNGKey(0), 64), jparams
    )
    side = (np.asarray(jstate.ball_x) == 9).astype(np.int32)
    assert 0 < side.sum() < 64
    tstate = start_state(torch.tensor(side))
    np.testing.assert_array_equal(env.get_obs(tstate).numpy(), np.asarray(jobs))
    for f in _BO_FIELDS:
        np.testing.assert_array_equal(getattr(tstate, f).numpy(), np.asarray(getattr(jstate, f)), err_msg=f)


@pytest.mark.parametrize("n", [6, 10])
def test_auto_reset_selects_image_obs_per_env(n):
    """Env.step takes the reset obs only for the envs that finished, for
    (E, 10, 10, 4) observations; at E = 10 a mask of shape (E, 1) would
    select by board row instead of by env."""
    env, params = tmake("Breakout-MinAtar")
    gen = torch.Generator().manual_seed(n)
    _, state = env.reset(gen, n, params)
    state.time[::2] = 999  # every other env reaches the time limit
    action = torch.zeros(n, dtype=torch.long)
    obs_st, *_ = env.step_env(state, action, params, NO_DRAWS)
    obs, new_state, _, done, _ = env.step(gen, state, action, params)
    assert done[::2].all() and not done[1::2].any()
    np.testing.assert_array_equal(obs.numpy(), env.get_obs(new_state).numpy())
    assert torch.equal(obs[1::2], obs_st[1::2])
    assert (new_state.time[::2] == 0).all() and (new_state.ball_y[::2] == 3).all()
