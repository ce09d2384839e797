"""The port's SpaceInvaders-MinAtar against the JAX package's, on the CPU:
the env step, the reset, the fused rollout's plain twin against the Pallas
kernel (interpret mode, PRNG off), the state matrices, the CNN at 6
channels, and the trainer."""

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
    check_cnn_matches_flax_and_crosses,
    check_tiny_train,
    check_wrapper_on_cpu,
    cnn_pair,
    jax_step_env,
    random_play_states,
    tiny_config,
    to_torch,
)

from purejaxql_torch.algo import pqn
from purejaxql_torch.envs import make as tmake
from purejaxql_torch.envs.base import NO_DRAWS
from purejaxql_torch.envs.minatar.space_invaders import (
    SpaceInvadersParams,
    SpaceInvadersState,
    alien_wave,
)
from purejaxql_torch.ops import space_invaders_rollout as tsr
from purejaxql_torch.ops.minatar_rollout import minatar_weights
from purejaxql_tpu.envs import make as jmake
from purejaxql_tpu.ops.pallas_rollout import (
    space_invaders_rollout_pallas,
    state_matrix_from_space_invaders,
)

torch.set_num_threads(1)

ENV = "SpaceInvaders-MinAtar"


def _random_states(n, seed):
    """States that meet every rule: thinned waves anywhere on the board (at
    the walls, on the bottom row, cleared but for one alien), bullets in
    flight both ways, the timers about to fire, any march interval, times
    near the limit."""
    r = np.random.RandomState(seed)
    i32 = lambda a: np.asarray(a, np.int32)  # noqa: E731
    rows, cols = r.randint(0, 7, n), r.randint(-2, 3, n)
    alien = np.zeros((n, 10, 10), np.int32)
    for i in range(n):
        alien[i, rows[i] : rows[i] + 4, 2 + cols[i] : 8 + cols[i]] = r.rand(4, 6) < 0.6
    alien[: n // 8] = 0
    alien[: n // 8, 3, 4] = 1  # one alien left
    return {
        "pos": i32(r.randint(0, 10, n)), "f_bullet_map": i32(r.rand(n, 10, 10) < 0.05),
        "e_bullet_map": i32(r.rand(n, 10, 10) < 0.05), "alien_map": alien,
        "alien_dir": i32(r.choice([-1, 1], n)), "enemy_move_interval": i32(r.randint(5, 13, n)),
        "alien_move_timer": i32(r.randint(0, 3, n)), "alien_shot_timer": i32(r.randint(0, 3, n)),
        "ramp_index": i32(r.randint(0, 4, n)), "shot_timer": i32(r.randint(0, 3, n)),
        "terminal": r.rand(n) < 0.05, "time": i32(r.choice([0, 5, 998, 999], n)),
    }


def _step_both(cols, actions):
    keys = jax.random.split(jax.random.PRNGKey(0), len(actions))
    jout = jax_step_env(ENV, cols, actions, keys)
    tenv, tparams = tmake(ENV)
    tout = tenv.step_env(to_torch(SpaceInvadersState, cols), torch.tensor(actions).long(), tparams, NO_DRAWS)
    return jout, tout


@pytest.mark.parametrize("source", ["random_play", "random_states"])
def test_space_invaders_step_env_matches_jax(source):
    """Every action from states reached by random play, or from random
    states: the same next state, obs, reward and done, exactly."""
    cols = random_play_states(ENV, 32, 60, 0, 4) if source == "random_play" else _random_states(2048, 1)
    n = len(cols["time"])
    actions = np.random.RandomState(2).randint(0, 4, n).astype(np.int32)
    jout, tout = _step_both(cols, actions)
    assert_same_step(jout, tout)
    rew, done = np.asarray(jout[2]), np.asarray(jout[3])
    assert done.any() and not done.all() and rew.sum() > 0


def _case(**kw):
    base = {
        "pos": 5, "f_bullet_map": np.zeros((10, 10), np.int32), "e_bullet_map": np.zeros((10, 10), np.int32),
        "alien_map": alien_wave(1, "cpu")[0].numpy(), "alien_dir": -1, "enemy_move_interval": 12,
        "alien_move_timer": 5, "alien_shot_timer": 5, "ramp_index": 0, "shot_timer": 0,
        "terminal": False, "time": 10,
    }
    base.update(kw)
    return base


def _map(*cells):
    m = np.zeros((10, 10), np.int32)
    for r, c in cells:
        m[r, c] = 1
    return m


def test_space_invaders_kill_hit_wave_and_bottom():
    """Hand-set cases step as the JAX package steps them, and as the rules
    say: a friendly bullet kills an alien (+1), an enemy bullet reaches the
    cannon (terminal), the last alien dies and the wave respawns with a
    faster march, aliens dropping with one on the bottom row end the
    episode, and the cannon fires from its new column."""
    cases = [
        (_case(f_bullet_map=_map((4, 3))), 0),
        (_case(e_bullet_map=_map((8, 5))), 0),
        (_case(alien_map=_map((2, 6)), f_bullet_map=_map((3, 6))), 0),
        (_case(alien_map=_map((9, 0), (5, 0)), alien_move_timer=0), 0),
        (_case(shot_timer=0), 3),
    ]
    cols = {k: np.asarray([c[k] for c, _ in cases]) for k in cases[0][0]}
    jout, tout = _step_both(cols, np.asarray([a for _, a in cases], np.int32))
    assert_same_step(jout, tout)
    _, st, rew, done, _ = tout
    assert rew.tolist() == [1.0, 0, 1.0, 0, 0] and done.tolist() == [False, True, False, True, False]
    assert st.alien_map[0, 3, 3] == 0 and st.alien_map[0].sum() == 23
    assert torch.equal(st.alien_map[2], alien_wave(1, "cpu")[0]) and st.enemy_move_interval[2] == 11
    assert st.ramp_index[2] == 1 and st.alien_dir[3] == 1
    assert st.f_bullet_map[4, 8, 5] == 1 and st.shot_timer[4] == 5


def test_space_invaders_reset_matches_jax():
    env, params = tmake(ENV)
    obs, state = env.reset(torch.Generator().manual_seed(0), 4, params)
    jenv, jparams = jmake(ENV)
    jobs, jstate = jax.vmap(jenv.reset, in_axes=(0, None))(jax.random.split(jax.random.PRNGKey(0), 4), jparams)
    np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs))
    want = to_torch(SpaceInvadersState, jstate)
    for f in want.__dataclass_fields__:
        assert torch.equal(getattr(state, f), getattr(want, f)), f


def _pallas_starts(B):
    """Half the envs at an episode's start, half on random states, a
    quarter of them with a row of enemy bullets over the cannon's row (a
    terminal step, whatever the action); as the port's state matrices."""
    jenv, jparams = jmake(ENV)
    _, jstate = jax.vmap(jenv.reset, in_axes=(0, None))(jax.random.split(jax.random.PRNGKey(1), B), jparams)
    cols = jax.tree_util.tree_map(np.array, jstate.__dict__)
    h = B // 2
    rand = _random_states(B - h, B)
    rand["terminal"][:] = False
    rand["e_bullet_map"][: (B - h) // 2, 8, :] = 1
    for k in cols:
        cols[k][h:] = rand[k]
    return tsr.state_matrix_from_space_invaders(to_torch(SpaceInvadersState, cols))


def test_space_invaders_rollout_plain_matches_pallas_interpret():
    """B 16, T 8, H 128, PRNG off: the plain twin against
    space_invaders_rollout_pallas(use_prng=False, interpret=True):
    observations, actions, rewards, dones, the (16, B) state and the three
    maps equal, Q within 1e-4. A terminal step inside the window compares
    the reset."""
    B, T = 16, 8
    _, variables, tnet = cnn_pair(6, 4, seed=1, hidden=128)
    packed = _pallas_starts(B)
    want = space_invaders_rollout_pallas(
        jnp.asarray(0), jnp.asarray(0.0), variables["params"], *(jnp.asarray(x.numpy()) for x in packed),
        T, use_prng=False, interpret=True,
    )
    got = tsr.space_invaders_rollout(0, 0.0, minatar_weights(tnet), *packed, T, use_prng=False)
    assert_twin_matches_pallas(got, want, 4)
    done = got[3].numpy()
    assert done[0, B // 2 : B // 2 + 4].all() and got[2].numpy().sum() > 0


def test_space_invaders_state_matrices_match_jax_and_round_trip():
    cols = _random_states(8, 5)
    jenv, jparams = jmake(ENV)
    _, jstate = jax.vmap(jenv.reset, in_axes=(0, None))(jax.random.split(jax.random.PRNGKey(0), 8), jparams)
    jstate = jstate.replace(**{k: jnp.asarray(v) for k, v in cols.items()})
    packed = tsr.state_matrix_from_space_invaders(to_torch(SpaceInvadersState, cols))
    assert [tuple(x.shape) for x in packed] == [(16, 8), (10, 10, 8), (10, 10, 8), (10, 10, 8)]
    for got, want in zip(packed, state_matrix_from_space_invaders(jstate)):
        assert got.dtype == torch.int32 and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = tsr.space_invaders_from_state_matrix(*packed)
    for f, v in cols.items():
        np.testing.assert_array_equal(getattr(back, f).numpy(), v, err_msg=f)


def test_space_invaders_rollout_prng_statistics():
    """PRNG on: P(act != greedy) = eps * 3/4 for 4 actions; different seeds
    give different streams."""
    _, _, tnet = cnn_pair(6, 4, seed=2, hidden=32)
    weights = minatar_weights(tnet)
    env, params = tmake(ENV)
    _, state = env.reset(torch.Generator().manual_seed(0), 128, params)
    packed = tsr.state_matrix_from_space_invaders(state)
    _, act, _, _, q, *_ = tsr.space_invaders_rollout(11, 0.3, weights, *packed, 32)
    p = (act.long() != q.argmax(-1)).float().mean().item()
    assert abs(p - 0.225) < 0.02, p
    other = tsr.space_invaders_rollout(13, 0.3, weights, *packed, 32)[1]
    assert not torch.equal(act, other)


def test_cnn_at_6_channels_matches_flax_and_crosses(tmp_path):
    check_cnn_matches_flax_and_crosses(6, 4, tmp_path)


def test_space_invaders_wrapper_takes_plain_version_on_cpu_without_counting():
    _, _, tnet = cnn_pair(6, 4, seed=0, hidden=32)
    env, params = tmake(ENV)
    _, state = env.reset(torch.Generator().manual_seed(0), 2, params)
    check_wrapper_on_cpu(tsr.space_invaders_rollout, minatar_weights(tnet), tsr.state_matrix_from_space_invaders(state), 6, 4)


@pytest.mark.parametrize("fused", [False, True])
def test_tiny_space_invaders_train_counts_and_determinism(fused):
    check_tiny_train(ENV, fused, 6, tsr.space_invaders_rollout)


@pytest.mark.parametrize(
    "kwargs",
    [{"enemy_move_interval": 8}, {"ramping": False}, {"shot_cool_down": 3}, {"enemy_shot_interval": 7}],
    ids=lambda kw: next(iter(kw)),
)
def test_space_invaders_fused_rollout_refuses_env_kwargs(kwargs):
    """The kernel resets the march interval to 12, always ramps and keeps
    the cooldowns built in, as the TPU kernel does
    (pallas_rollout.py:1473-1474), so FUSED_ROLLOUT refuses ENV_KWARGS."""
    with pytest.raises(ValueError, match="ENV_KWARGS"):
        pqn.make_train(tiny_config(ENV_NAME=ENV, FUSED_ROLLOUT=True, ENV_KWARGS=kwargs))


def test_space_invaders_kernel_constants_are_the_default_params():
    """The values built into csrc/space_invaders_rollout.cu are
    SpaceInvadersParams' defaults, which the env's reset and step use."""
    src = (pathlib.Path(tsr.__file__).parents[1] / "csrc" / "space_invaders_rollout.cu").read_text()
    built_in = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    params = SpaceInvadersParams()
    assert built_in["kResetInterval"] == params.enemy_move_interval
    assert built_in["kShotCoolDown"] == params.shot_cool_down
    assert built_in["kShotInterval"] == params.enemy_shot_interval
