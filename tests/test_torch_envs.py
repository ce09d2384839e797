"""The port's batched CartPole, auto-reset and Log wrapper against the JAX
package's, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from purejaxql_torch.envs import make as tmake
from purejaxql_torch.envs import wrappers as twrappers
from purejaxql_torch.envs.classic.cartpole import CartPoleState
from purejaxql_tpu.envs import make as jmake
from purejaxql_tpu.envs import wrappers as jwrappers
from purejaxql_tpu.envs.classic.cartpole import CartPoleState as JCartPoleState

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
    tobs, tst, trew, tdone, _ = tenv.step_env(tstate, torch.tensor(actions).long(), tparams)
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
        tmake("Breakout-MinAtar")
