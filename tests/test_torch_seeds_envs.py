"""NUM_SEEDS > 1 in the port's env wrappers on the CPU, against ``jax.vmap``
of the JAX package's over the lanes: the per-seed reset routing (the draw,
the slot map and the scatter; the optimistic and the banked wrapper keeping
each seed's fresh states to that seed's envs), both normalizers on the same
observation and reward streams, and the per-seed noise ladder.

Each seed's E envs are the s-th block of seed-major rows (algo/seeds.py);
each JAX lane owns its own wrapper state, so the port's block s is held to
lane s. Sizes are tiny (2-3 seeds, E <= 16)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from purejaxql_torch.algo import pqn_ac
from purejaxql_torch.algo.exploration import gaussian_noise_ladder
from purejaxql_torch.envs import wrappers as tw
from purejaxql_torch.envs.base import Environment
from purejaxql_tpu.algo.exploration import gaussian_noise_ladder as jax_noise_ladder
from purejaxql_tpu.envs import wrappers as jw
from test_torch_craftax import _Tagged  # tests/ is on the path, as for torch_minatar_cases

torch.set_num_threads(1)


def _fold(x):
    """(S, E, ...) -> seed-major rows (S * E, ...)."""
    return torch.tensor(np.asarray(x)).flatten(0, 1)


# ---- the reset routing ------------------------------------------------------------------


def test_seeded_reset_draw_slots_and_scatter_match_vmapped_jax():
    """3 seeds of 12 envs at reset ratio 4 (3 resets a seed), 0, 2 and 7 of
    them done: ``sample_being_reset`` draws 3 distinct envs in each seed's
    block, every done env of a seed with at most 3 done and only done ones
    of the seed with 7; ``reset_slot_map`` over all rows gives each env a
    slot of its own seed's block, as the vmapped JAX map
    (wrappers.py:254-262) offset by the seed's block; ``scatter_resets``
    equals ``jax.vmap(_scatter_resets)`` on the same draws in bits, and no
    env takes a candidate of another seed."""
    S, E, ratio = 3, 12, 4
    k = E // ratio
    gen = torch.Generator().manual_seed(0)
    done = np.zeros((S, E), bool)
    for s, n_done in enumerate((0, 2, 7)):
        done[s, np.random.RandomState(s).permutation(E)[:n_done]] = True
    for _ in range(10):
        being = tw.sample_being_reset(gen, _fold(done), k, S)
        local = being.reshape(S, k) - E * torch.arange(S)[:, None]
        assert ((local >= 0) & (local < E)).all() and all(row.unique().numel() == k for row in local)
        for s in range(S):
            picked = set(local[s].tolist())
            if done[s].sum() <= k:
                assert set(np.flatnonzero(done[s]).tolist()) <= picked
            else:
                assert done[s][sorted(picked)].all()
        slots = tw.reset_slot_map(being, S * E, ratio).reshape(S, E)
        want = jax.vmap(lambda b: jnp.arange(k).repeat(ratio).at[b].set(jnp.arange(k)))(jnp.asarray(local.numpy()))
        np.testing.assert_array_equal(slots.numpy(), np.asarray(want) + k * np.arange(S)[:, None])
        # candidates tagged by their seed, live rows by -1
        r = np.random.RandomState(1)
        resets = (np.arange(S)[:, None, None] * 100 + r.rand(S, k, 3) * 10).astype(np.float32)
        live = -1 - r.rand(S, E, 3).astype(np.float32)
        got = tw.scatter_resets(_fold(done), being, _fold(resets), _fold(live)).reshape(S, E, 3)
        want = jax.vmap(jw._scatter_resets)(jnp.asarray(done), jnp.asarray(local.numpy()), jnp.asarray(resets),
                                             jnp.asarray(live))
        np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want).view(np.uint32))
        taken = got[..., 0] >= 0
        assert not bool((taken & ~torch.tensor(done)).any())
        for s in range(S):
            assert ((got[s, taken[s], 0] // 100) == s).all()
            assert int(taken[s].sum()) == min(int(done[s].sum()), k)


class _Tagged32(_Tagged):
    """tests/test_torch_craftax.py's tagged env with int32 tags, a leaf the
    bank packs (1- and 4-byte leaves only)."""

    def reset_env(self, generator, num_envs, params):
        obs, state = super().reset_env(generator, num_envs, params)
        return obs, dataclasses.replace(state, tag=state.tag.to(torch.int32))


def _blocks(first, seeds, n):
    """The tags a burst of seeds * n resets from tag ``first`` gives each
    seed: seed s's n in the s-th block."""
    return [set(range(first + s * n, first + (s + 1) * n)) for s in range(seeds)]


def test_seeded_optimistic_and_banked_wrappers_keep_each_seed_to_its_own_resets():
    """2 seeds of 8 envs at ratio 4: through Log, each step of the optimistic
    wrapper makes 2 fresh states a seed and a seed's done envs take only its
    own (up to 2 distinct ones, every done env reset); the banked wrapper
    (a bank of 4 a seed, refreshed every 2 steps) fills each seed's bank
    rows with that seed's fresh states only and serves a seed's done envs
    from its own bank alone, up to 2 a step, the rest deferred."""
    S, E, ratio, bank = 2, 8, 4, 4
    k = E // ratio
    for banked in (False, True):
        gen = torch.Generator().manual_seed(3)
        raw = _Tagged32()
        env = (tw.BankedResetVecEnv(tw.Log(raw), E, ratio, bank, refresh_every=2, seeds=S) if banked
               else tw.OptimisticResetVecEnv(tw.Log(raw), E, ratio, seeds=S))
        obs, state = env.reset(gen, S * E)
        own = _blocks(S * E, S, bank) if banked else [set() for _ in range(S)]
        for step, n_done in enumerate((0, 3, 1, 8, 5, 2, 16)):
            action = torch.zeros(S * E, dtype=torch.long)
            action[torch.randperm(S * E, generator=gen)[:n_done]] = 1
            first = raw.resets
            obs, state, _, done, _ = env.step(gen, state, action)
            if not banked:
                own = _blocks(first, S, k)
            elif step % 2 == 0:  # a refresh burst
                own = [o | f for o, f in zip(own, _blocks(first, S, k))]
            live = state.env_state if banked else state
            tags = live.env_state.tag.reshape(S, E)
            fresh = (live.env_state.t == 0).reshape(S, E)
            for s in range(S):
                d = done.reshape(S, E)[s]
                assert set(tags[s][fresh[s]].tolist()) <= own[s]
                assert not bool((fresh[s] & ~d).any())
                if banked:
                    rows = tw.unpack_rows(state.bank_w8, state.bank_w32, (obs, live))[1].env_state.tag
                    assert set(rows[s * bank:(s + 1) * bank].tolist()) <= own[s]
                    assert int(fresh[s].sum()) == min(int(d.sum()), k)
                else:
                    assert torch.equal(fresh[s], d) and len(set(tags[s][d].tolist())) == min(int(d.sum()), k)


# ---- the normalizers -------------------------------------------------------------------------


class _Stream(Environment):
    """A batched stand-in env replaying seed-major rows of fixed (obs,
    reward, done) streams (S, T, E, ...) for the port's wrappers."""

    def __init__(self, obs, rew, done):
        self.obs, self.rew, self.done, self.t = obs, rew, done, 0

    def reset(self, key, *args):
        self.t = 0
        return _fold(self.obs[:, 0]), None

    def step(self, key, state, action, params=None):
        t = self.t = self.t + 1
        return _fold(self.obs[:, t]), None, _fold(self.rew[:, t - 1]), _fold(self.done[:, t - 1]), {}


class _JStream:
    """The same streams for the JAX wrappers under ``jax.vmap``: the key is
    the lane, and the state carries (lane, t)."""

    def __init__(self, obs, rew, done):
        self.obs, self.rew, self.done = jnp.asarray(obs), jnp.asarray(rew), jnp.asarray(done)

    def reset(self, key, params=None):
        return self.obs[key, 0], (key, 0)

    def step(self, key, state, action, params=None):
        lane, t = state
        return self.obs[lane, t + 1], (lane, t + 1), self.rew[lane, t], self.done[lane, t], {}


def _streams(S, T, E, D, seed):
    """Each seed's observations with its own per-feature offsets and scales
    far from (0, 1), rewards of both signs and its own scale, dones at
    different steps per env, one step where every env ends."""
    r = np.random.RandomState(seed)
    obs = (r.randn(S, T + 1, E, D) * r.uniform(0.1, 30, (S, 1, 1, D)) + r.uniform(-50, 50, (S, 1, 1, D)))
    rew = r.randn(S, T, E) * r.uniform(0.5, 5, (S, 1, 1)) - 1
    done = r.rand(S, T, E) < 0.15
    done[:, T // 2] = True
    return obs.astype(np.float32), rew.astype(np.float32), done


def _close(got, want, msg):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want).reshape(np.shape(got)), rtol=1e-6, atol=1e-6,
                               err_msg=msg)


def test_seeded_normalizers_match_vmapped_jax():
    """3 seeds of 5 envs, each seed's own streams: the observation
    normalizer's normalized obs (within 1e-6 relative to its terms, as
    tests/test_torch_normalize.py), mean and var (3, D) and count (3,)
    against ``jax.vmap`` of the JAX wrapper at reset and every step, then
    its ``eval_step`` (each seed's statistics frozen) for the rest; the
    reward normalizer's reward, running return (15,), mean, var and count
    (3,) against the vmapped JAX wrapper at every step. Each seed's count
    ends at 1e-4 + E (1 + steps) in float32."""
    S, T, E, D = 3, 24, 5, 4
    obs, rew, done = _streams(S, T, E, D, 0)
    lanes = jnp.arange(S)
    zeros = (torch.zeros(S * E, 1), jnp.zeros((S, E, 1)))
    tenv = tw.NormalizeVecObservation(_Stream(obs, rew, done), seeds=S)
    jenv = jw.NormalizeVecObservation(_JStream(obs, rew, done))
    to, ts = tenv.reset(None, S * E)
    jo, js = jax.jit(jax.vmap(jenv.reset))(lanes)
    jstep, jeval = (jax.jit(jax.vmap(f)) for f in (jenv.step, jenv.eval_step))
    half = T // 2
    for t in range(T + 1):
        msg = f"obs step {t}"
        raw = obs[:, t]
        err = np.abs(to.numpy().reshape(S, E, D) - np.asarray(jo))
        scale = (np.abs(raw) + np.abs(np.asarray(js.mean))[:, None]) / np.sqrt(np.asarray(js.var, np.float64) + 1e-8)[:, None]
        assert (err <= 1e-6 * (1 + scale)).all(), (msg, err.max())
        for f in ("mean", "var", "count"):
            _close(getattr(ts, f), getattr(js, f), f"{msg} {f}")
        assert ts.mean.shape == (S, D) and ts.count.shape == (S,) and ts.count.dtype == torch.float32
        if t == T:
            break
        step = "eval_step" if t >= half else "step"
        to, ts, tr, _, _ = getattr(tenv, step)(None, ts, zeros[0])
        jo, js, jr, _, _ = (jeval if t >= half else jstep)(lanes, js, zeros[1])
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr).reshape(-1))
    want = np.float32(1e-4)
    for _ in range(half + 1):
        want = np.float32(want + np.float32(E))
    assert ts.count.tolist() == [float(want)] * S
    assert not torch.equal(ts.mean[0], ts.mean[1])

    tenv = tw.NormalizeVecReward(_Stream(obs, rew, done), 0.99, seeds=S)
    jenv = jw.NormalizeVecReward(_JStream(obs, rew, done), 0.99)
    _, ts = tenv.reset(None, S * E)
    _, js = jax.jit(jax.vmap(jenv.reset))(lanes)
    jstep = jax.jit(jax.vmap(jenv.step))
    for t in range(T):
        _, ts, tr, _, _ = tenv.step(None, ts, zeros[0])
        _, js, jr, _, _ = jstep(lanes, js, zeros[1])
        _close(tr, jr, f"reward step {t}")
        for f in ("mean", "var", "count", "return_val"):
            _close(getattr(ts, f), getattr(js, f), f"reward step {t} {f}")
    assert ts.var.shape == (S,) and ts.return_val.shape == (S * E,)


def test_seeded_eval_starts_under_each_seeds_own_statistics():
    """The unfused AC eval's start with NORMALIZE_OBS (``pqn_ac.eval_start``,
    pqn_ac.py:710-720) with 2 seeds' training statistics (2, D): each seed's
    block of fresh envs takes a copy of its own seed's statistics, its reset
    obs normalized a second time by them, and its first step moves that
    copy, as each vmapped JAX lane's eval does; within 1e-6 relative; the
    training statistics stay as they were."""
    S, E, D = 2, 6, 4
    obs, rew, done = _streams(S, 2, E, D, 3)
    r = np.random.RandomState(4)
    mean, var = r.randn(S, D).astype(np.float32), r.uniform(0.5, 9, (S, D)).astype(np.float32)
    count = np.array([4096.0001, 77.0001], np.float32)
    jenv = jw.NormalizeVecObservation(_JStream(obs, rew, done))

    def lane(key, m, v, c):
        init_obs, reset_state = jenv.reset(key)
        js = jw.NormalizeVecObsState(mean=m, var=v, count=c, env_state=reset_state.env_state)
        jo1, js1, *_ = jenv.step(key, js, jnp.zeros((E, 1)))
        return (init_obs - js.mean) / jnp.sqrt(js.var + 1e-8), jo1, js1

    jo, jo1, js1 = jax.jit(jax.vmap(lane))(jnp.arange(S), *map(jnp.asarray, (mean, var, count)))
    tenv = tw.NormalizeVecObservation(_Stream(obs, rew, done), seeds=S)
    train_t = tw.NormalizeVecObsState(mean=torch.tensor(mean), var=torch.tensor(var), count=torch.tensor(count),
                                      env_state=None)
    t_init, t_reset = tenv.reset(None, S * E)
    to, ts = pqn_ac.eval_start(t_init, t_reset, train_t)
    _close(to, jo, "the eval's first obs")
    to1, ts1, *_ = tenv.step(None, ts, torch.zeros(S * E, 1))
    _close(to1, jo1, "the eval's first step")
    for f in ("mean", "var", "count"):
        _close(getattr(ts1, f), getattr(js1, f), f)
    assert np.array_equal(train_t.mean.numpy(), mean) and np.array_equal(train_t.count.numpy(), count)


# ---- the noise ladder ------------------------------------------------------------------------


def test_seeded_noise_ladder_is_each_seeds_own():
    """``gaussian_noise_ladder`` with 3 seeds of 6 envs: each env's standard
    deviation (its noise over the unit normal drawn for it) is
    linspace(0, noise_std, 6) of its seed's block, what the JAX function
    gives each vmapped lane (exploration.py:62-85), within 1e-6 relative;
    env 0 of every seed stays greedy. Without the ladder every env has
    noise_std."""
    S, E, D = 3, 6, 2
    actions = torch.zeros(S * E, D)
    gen = torch.Generator().manual_seed(0)
    for linspace in (True, False):
        unit = torch.Generator()
        unit.set_state(gen.get_state())
        z = torch.randn(actions.shape, generator=unit)
        out = gaussian_noise_ladder(gen, actions, 0.7, -1e9, 1e9, scale=2.0, linspace=linspace, seeds=S)
        keys = jax.random.split(jax.random.PRNGKey(1), S)
        jout = jax.vmap(lambda k: jax_noise_ladder(k, jnp.zeros((E, D)), 0.7, -1e9, 1e9, 2.0, linspace))(keys)
        jz = jax.vmap(lambda k: jax.random.normal(k, (E, D)))(keys)
        got = (out / (2.0 * z)).numpy().reshape(S, E, D)
        want = np.asarray(jout) / (2.0 * np.asarray(jz))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        if linspace:
            assert (out.reshape(S, E, D)[:, 0] == 0).all()
            np.testing.assert_allclose(got[:, :, 0], np.tile(np.linspace(0, 0.7, E), (S, 1)), rtol=1e-6)
