"""The port's observation and reward normalizers (envs/wrappers.py) on the
CPU against the JAX package's (purejaxql_tpu/envs/wrappers.py:575-690):
the same obs, reward and done streams, episodes ending at different steps,
through both; the running mean, var and count, the normalized obs (relative
to its terms) and reward and `eval_step` within 1e-6 relative, E = 1 among
the cases (JAX's population variance over one env is 0), the two stacked as
the trainer stacks them, and the statistics copied, never written in place."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from purejaxql_torch.envs import wrappers as twrap
from purejaxql_torch.envs.base import Environment
from purejaxql_tpu.envs import wrappers as jwrap

torch.set_num_threads(1)


class _Stream(Environment):
    """A batched stand-in env replaying fixed (obs, reward, done) rows, for
    both packages' wrappers (``to`` makes the row a tensor or an array)."""

    def __init__(self, obs, rew, done, to):
        self.obs, self.rew, self.done, self.to, self.t = obs, rew, done, to, 0

    def reset(self, key, *args):
        self.t = 0
        return self.to(self.obs[0]), None

    def step(self, key, state, action, params=None):
        t = self.t = self.t + 1
        return self.to(self.obs[t]), None, self.to(self.rew[t - 1]), self.to(self.done[t - 1]), {}


def _streams(T, E, D, seed):
    """Observations with per-feature offsets and scales far from (0, 1),
    rewards of both signs, dones at different steps per env (env 0 never
    ends), one step where every env ends."""
    r = np.random.RandomState(seed)
    obs = (r.randn(T + 1, E, D) * r.uniform(0.1, 30, D) + r.uniform(-50, 50, D)).astype(np.float32)
    rew = (r.randn(T, E) * 3 - 1).astype(np.float32)
    done = r.rand(T, E) < 0.15
    done[:, 0] = E == 1 and done[:, 0]
    done[T // 2] = True
    return obs, rew, done


def _close(got, want, msg):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6, atol=1e-6, err_msg=msg)


def _close_normalized(got, want, raw, mean, var, msg):
    """(raw - mean) / sqrt(var + 1e-8) within 1e-6 relative to the terms it
    is made of: float32 rounding of raw and mean, carried through the
    division, bounds it by eps (|raw| + |mean|) / sqrt(var), far above 1e-6
    of the result where raw and mean nearly cancel (a feature at 50 +- 0.1)."""
    scale = (np.abs(raw) + np.abs(np.asarray(mean))) / np.sqrt(np.asarray(var, np.float64) + 1e-8)
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert (err <= 1e-6 * (1 + scale)).all(), (msg, err.max(), (err / (1 + scale)).max())


CASES = {"E5": (60, 5, 4), "E1": (40, 1, 3), "E64": (30, 64, 13)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_obs_normalizer_matches_jax(case):
    """Reset and every step: the normalized obs and the mean, var and count
    as JAX's; then `eval_step` from the end state (statistics frozen) for
    the rest of the stream. The count ends at 1e-4 + E (1 + T) in float32,
    bit for bit; with E = 1 each batch's variance is 0."""
    T, E, D = CASES[case]
    obs, rew, done = _streams(T, E, D, seed=len(case) + E)
    tenv = twrap.NormalizeVecObservation(_Stream(obs, rew, done, torch.tensor))
    jenv = jwrap.NormalizeVecObservation(_Stream(obs, rew, done, jnp.asarray))
    to, ts = tenv.reset(None, E)
    jo, js = jenv.reset(None)
    half = T // 2
    for t in range(T + 1):
        msg = f"{case} step {t}"
        _close_normalized(to, jo, obs[t], js.mean, js.var, msg)
        for f in ("mean", "var", "count"):
            _close(getattr(ts, f), getattr(js, f), f"{msg} {f}")
        assert ts.count.dtype == torch.float32 and ts.count.shape == ()
        if t == T:
            break
        step = "eval_step" if t >= half else "step"
        to, ts, tr, td, _ = getattr(tenv, step)(None, ts, torch.zeros(E, 1))
        jo, js, jr, jd, _ = getattr(jenv, step)(None, js, jnp.zeros((E, 1)))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    want = np.float32(1e-4)
    for _ in range(half + 1):
        want = np.float32(want + np.float32(E))
    assert ts.count.item() == float(np.asarray(js.count)) == float(want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_reward_normalizer_matches_jax(case):
    """Every step: the normalized reward, the running return (reset through
    1 - done) and the mean, var and count as JAX's."""
    T, E, D = CASES[case]
    obs, rew, done = _streams(T, E, D, seed=7 + E)
    tenv = twrap.NormalizeVecReward(_Stream(obs, rew, done, torch.tensor), 0.99)
    jenv = jwrap.NormalizeVecReward(_Stream(obs, rew, done, jnp.asarray), 0.99)
    to, ts = tenv.reset(None, E)
    jo, js = jenv.reset(None)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    for t in range(T):
        to, ts, tr, td, _ = tenv.step(None, ts, torch.zeros(E, 1))
        jo, js, jr, jd, _ = jenv.step(None, js, jnp.zeros((E, 1)))
        msg = f"{case} step {t}"
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo), msg)
        _close(tr, jr, f"{msg} reward")
        for f in ("mean", "var", "count", "return_val"):
            _close(getattr(ts, f), getattr(js, f), f"{msg} {f}")
    # the returns of the envs that ended on the last step restarted there
    ended = done[-1]
    _close(ts.return_val.numpy()[ended], rew[-1][ended], "restarted returns")


def test_stacked_normalizers_and_copies():
    """Reward inside obs normalization, as the trainer stacks them: both
    statistics as JAX's after a stream with episode ends. Stepping a copy of
    the state (the eval's) leaves the original's tensors as they were."""
    T, E, D = 25, 6, 5
    obs, rew, done = _streams(T, E, D, seed=11)
    tenv = twrap.NormalizeVecObservation(twrap.NormalizeVecReward(_Stream(obs, rew, done, torch.tensor), 0.97))
    jenv = jwrap.NormalizeVecObservation(jwrap.NormalizeVecReward(_Stream(obs, rew, done, jnp.asarray), 0.97))
    to, ts = tenv.reset(None, E)
    jo, js = jenv.reset(None)
    for t in range(T - 1):
        to, ts, tr, _, _ = tenv.step(None, ts, torch.zeros(E, 1))
        jo, js, jr, _, _ = jenv.step(None, js, jnp.zeros((E, 1)))
        _close_normalized(to, jo, obs[t + 1], js.mean, js.var, f"obs {t}")
        _close(tr, jr, f"reward {t}")
    for f in ("mean", "var", "count"):
        _close(getattr(ts, f), getattr(js, f), f)
        _close(getattr(ts.env_state, f), getattr(js.env_state, f), f"reward {f}")
    before = {f: getattr(ts, f).clone() for f in ("mean", "var", "count")}
    inner = ts.env_state.return_val.clone()
    copy = dataclasses.replace(ts)
    tenv.step(None, copy, torch.zeros(E, 1))
    for f, v in before.items():
        assert torch.equal(getattr(ts, f), v), f
    assert torch.equal(ts.env_state.return_val, inner)
