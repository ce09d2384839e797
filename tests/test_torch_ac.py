"""The port's actor-critic slice on the CPU against the JAX package:
Pendulum-v1, the ScrubNaN / ClipAction / LogVec wrappers, the Gaussian noise
ladder, the actor, critic and critic ensemble and their checkpoint crossing,
the fused rollout's plain twin against the Pallas kernel (interpret mode),
one learn step on both target paths, tiny trainer runs, the CUDA policy and
the CLI recipe.

Sizes are tiny (B 16, T 12, H 64 for the kernel, as tests/test_ops.py sets
it up; H 32 for the trainer). The Pallas kernel runs in interpret mode twice
in this file."""

import dataclasses
import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from purejaxql_torch import cli
from purejaxql_torch.algo import pqn_ac
from purejaxql_torch.algo.exploration import gaussian_noise_ladder
from purejaxql_torch.core import checkpoint as tckpt
from purejaxql_torch.core.config import compose
from purejaxql_torch.core.optim import make_optimizer
from purejaxql_torch.core.schedules import linear_schedule
from purejaxql_torch.envs import make as tmake
from purejaxql_torch.envs import wrappers as twrap
from purejaxql_torch.envs.base import NO_DRAWS, Environment
from purejaxql_torch.envs.classic import pendulum as tpend
from purejaxql_torch.models.actor_critic import Actor as TActor
from purejaxql_torch.models.actor_critic import Critic as TCritic
from purejaxql_torch.models.actor_critic import CriticEnsemble
from purejaxql_torch.ops import lambda_returns as tlr
from purejaxql_torch.ops import pendulum_rollout as tpr
from purejaxql_torch.utils.logging import MemorySink, MetricLogger
from purejaxql_tpu.algo import pqn_ac as jax_pqn_ac
from purejaxql_tpu.core import checkpoint as jckpt
from purejaxql_tpu.core.optim import make_optimizer as jax_make_optimizer
from purejaxql_tpu.envs import make as jmake
from purejaxql_tpu.envs import wrappers as jwrap
from purejaxql_tpu.envs.classic.pendulum import PendulumState as JPendulumState
from purejaxql_tpu.models.actor_critic import Actor as JActor
from purejaxql_tpu.models.actor_critic import Critic as JCritic
from purejaxql_tpu.ops.pallas_rollout import pendulum_ac_rollout_pallas, state_matrix_from_pendulum

torch.set_num_threads(1)


def ac_config(**kw):
    """tests/test_pqn_ac.py's ac_config, on the CPU."""
    return compose(
        alg="pqn_pendulum",
        overrides=[
            "DEVICE=cpu", "TOTAL_TIMESTEPS=16384", "NUM_ENVS=16", "NUM_STEPS=32",
            "NUM_MINIBATCHES=4", "NUM_EPOCHS=2", "ACTOR_HIDDEN_SIZES=[32,32]",
            "CRITIC_HIDDEN_SIZES=[32,32]", "TEST_DURING_TRAINING=False",
        ] + [f"{k}={v}" for k, v in kw.items()],
    )


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---- Pendulum-v1 -----------------------------------------------------------------


def _jax_states(n, seed):
    """Pendulum states off the reset ranges: |theta| up to 3 pi, theta_dot
    up to the speed limit, times 0..199 with a quarter at 199."""
    r = np.random.RandomState(seed)
    time = r.randint(0, 200, n).astype(np.int32)
    time[: n // 4] = 199
    return JPendulumState(
        theta=jnp.asarray(r.uniform(-3 * np.pi, 3 * np.pi, n).astype(np.float32)),
        theta_dot=jnp.asarray(r.uniform(-8, 8, n).astype(np.float32)),
        last_u=jnp.asarray(r.uniform(-2, 2, n).astype(np.float32)),
        time=jnp.asarray(time),
    )


def _to_torch_state(js):
    return tpend.PendulumState(**{f.name: torch.tensor(np.asarray(getattr(js, f.name)))
                                  for f in dataclasses.fields(tpend.PendulumState)})


def test_pendulum_step_matches_jax():
    """Obs, next state, reward and done of JAX `step_env` on the same states
    and actions (|theta| > pi, actions beyond +-2, the time limit): time and
    done equal, floats within 2e-6 (XLA may fuse a multiply-add)."""
    jenv, jparams = jmake("Pendulum-v1")
    tenv, tparams = tmake("Pendulum-v1")
    n = 512
    js = _jax_states(n, 0)
    act = np.random.RandomState(1).uniform(-3, 3, (n, 1)).astype(np.float32)
    step = jax.jit(jax.vmap(jenv.step_env, in_axes=(None, 0, 0, None)), static_argnums=3)
    jo, jst, jr, jd, _ = step(jax.random.PRNGKey(0), js, jnp.asarray(act), jparams)
    to, tst, tr, td, _ = tenv.step_env(_to_torch_state(js), torch.tensor(act), tparams, NO_DRAWS)
    assert (np.abs(act) > 2).any() and (np.abs(np.asarray(js.theta)) > np.pi).any()
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert n // 4 <= td.sum() < n
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-6, rtol=0)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=2e-6, rtol=1e-6)
    for f in ("theta", "theta_dot", "last_u"):
        np.testing.assert_allclose(getattr(tst, f).numpy(), np.asarray(getattr(jst, f)), atol=2e-6, rtol=0)
    np.testing.assert_array_equal(tst.time.numpy(), np.asarray(jst.time))
    assert tuple(tenv.action_space(tparams).shape) == (1,) and tenv.action_space(tparams).high == 2.0
    assert tenv.observation_space(tparams).shape == (3,)


def test_pendulum_auto_reset_with_fixed_draws(monkeypatch):
    """The auto-reset of `step` with the JAX env's own reset draws (the
    second half of each step key, pendulum.py:52-53) gives JAX `step`'s obs
    and state; the JAX reset from a key and `start_state` from its draws
    agree too."""
    jenv, jparams = jmake("Pendulum-v1")
    tenv, tparams = tmake("Pendulum-v1")
    n = 64
    js = _jax_states(n, 2)
    keys = jax.random.split(jax.random.PRNGKey(3), n)
    high = jnp.array([jnp.pi, 1.0])
    draws = jax.vmap(lambda k: jax.random.uniform(jax.random.split(k)[1], (2,), minval=-high, maxval=high))(keys)
    monkeypatch.setattr(tpend, "draw_start", lambda gen, num: torch.tensor(np.asarray(draws)))
    act = np.random.RandomState(4).uniform(-2, 2, (n, 1)).astype(np.float32)
    jo, jst, _, jd, _ = jax.vmap(jenv.step, in_axes=(0, 0, 0, None))(keys, js, jnp.asarray(act), jparams)
    to, tst, _, td, _ = tenv.step(torch.Generator(), _to_torch_state(js), torch.tensor(act), tparams)
    assert td.any() and not td.all()
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-6, rtol=0)
    for f in ("theta", "theta_dot", "last_u", "time"):
        np.testing.assert_allclose(getattr(tst, f).numpy(), np.asarray(getattr(jst, f)), atol=2e-6, rtol=0)
    jo0, js0 = jax.vmap(jenv.reset_env, in_axes=(0, None))(keys, jparams)
    ts0 = tpend.start_state(torch.tensor(np.asarray(jax.vmap(
        lambda k: jax.random.uniform(k, (2,), minval=-high, maxval=high))(keys))))
    np.testing.assert_allclose(tenv.get_obs(ts0).numpy(), np.asarray(jo0), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(ts0.theta.numpy(), np.asarray(js0.theta))


def test_pendulum_reset_ranges():
    """theta ~ U[-pi, pi) and theta_dot ~ U[-1, 1) by their range, mean and
    variance over 200k draws (4 standard errors)."""
    tenv, tparams = tmake("Pendulum-v1")
    obs, s = tenv.reset(torch.Generator().manual_seed(0), 200_000, tparams)
    for x, h in ((s.theta, math.pi), (s.theta_dot, 1.0)):
        assert -h <= x.min() and x.max() < h
        assert abs(x.mean().item()) < 4 * h / math.sqrt(3 * 200_000)
        assert abs(x.var().item() / (h * h / 3) - 1) < 0.01
    assert (s.time == 0).all() and (s.last_u == 0).all()
    torch.testing.assert_close(obs, torch.stack([s.theta.cos(), s.theta.sin(), s.theta_dot], -1))


# ---- wrappers --------------------------------------------------------------------


class _Stream(Environment):
    """A batched stand-in env replaying fixed (obs, reward, done) rows; it
    records the action it was given. The JAX wrappers get the same rows."""

    def __init__(self, obs, rew, done, to=torch.tensor):
        self.obs, self.rew, self.done, self.to, self.t, self.actions = obs, rew, done, to, 0, []

    def reset(self, key, *args):
        self.t = 0
        return self.to(self.obs[0]), None

    def step(self, key, state, action, params=None):
        self.actions.append(np.asarray(action))
        t = self.t = self.t + 1
        return self.to(self.obs[t]), None, self.to(self.rew[t - 1]), self.to(self.done[t - 1]), {}


def test_scrub_nan_and_clip_action_match_jax():
    """A NaN or Inf reward or obs becomes 0 and `nan_events` counts them per
    env, as the JAX wrapper; ClipAction clips what reaches the env."""
    obs = np.ones((2, 3, 3), np.float32)
    obs[1, 0, 1], obs[1, 2, :2] = np.nan, np.inf
    rew = np.array([[np.nan, -np.inf, 1.5]], np.float32)
    done = np.zeros((1, 3), bool)
    tstream, jstream = _Stream(obs, rew, done), _Stream(obs, rew, done, jnp.asarray)
    tenv = twrap.ClipAction(twrap.ScrubNaN(tstream), low=-2.0, high=2.0)
    jenv = jwrap.ClipAction(jwrap.ScrubNaN(jstream), low=-2.0, high=2.0)
    act = np.array([[-5.0], [0.5], [3.0]], np.float32)
    to, _, tr, _, tinfo = tenv.step(None, None, torch.tensor(act))
    jo, _, jr, _, jinfo = jenv.step(None, None, jnp.asarray(act))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tinfo["nan_events"].numpy(), np.asarray(jinfo["nan_events"]))
    assert tinfo["nan_events"].tolist() == [2, 1, 2] and tr.tolist() == [0.0, 0.0, 1.5]
    np.testing.assert_array_equal(tstream.actions[0], [[-2.0], [0.5], [2.0]])
    np.testing.assert_array_equal(jstream.actions[0], tstream.actions[0])
    assert tenv.reset(None, 3)[0].tolist() == [[1.0] * 3] * 3


def _float_stream(T=40, E=5, seed=0):
    r = np.random.RandomState(seed)
    rew = (-16.27 * r.rand(T, E)).astype(np.float32)
    done = r.rand(T, E) < 0.12
    done[:, 0] = False  # one env never ends inside the stream
    return rew, done


def test_log_vec_and_its_replay_match_jax():
    """On a fixed stream of float rewards: the LogVec infos and state of
    every step equal the JAX wrapper's, and the fused path's replay
    (`log_vec_replay`, step-order sums) gives the same infos and end state,
    exactly: the sums run in the same order."""
    rew, done = _float_stream()
    T, E = rew.shape
    obs = np.zeros((T + 1, E, 3), np.float32)
    tenv, jenv = twrap.LogVec(_Stream(obs, rew, done)), jwrap.LogVec(_Stream(obs, rew, done, jnp.asarray))
    _, ts = tenv.reset(None, E)
    _, js = jenv.reset(None)
    tinfos = []
    for _ in range(T):
        _, ts, _, _, ti = tenv.step(None, ts, torch.zeros(E, 1))
        _, js, _, _, ji = jenv.step(None, js, jnp.zeros((E, 1)))
        for k in ("returned_episode_returns", "returned_episode_lengths", "returned_episode",
                  "timestep", "original_reward"):
            np.testing.assert_array_equal(ti[k].numpy(), np.asarray(ji[k]), k)
        tinfos.append(ti)
    for f in ("episode_returns", "episode_lengths", "returned_episode_returns",
              "returned_episode_lengths", "timestep"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)), f)

    _, start = tenv.reset(None, E)
    # start mid-episode, as a replay after an earlier update does
    start.episode_returns, start.episode_lengths = torch.full((E,), -3.5), torch.full((E,), 7, dtype=torch.int32)
    head, tail = 13, T - 13
    mid, _ = pqn_ac.log_vec_replay(start, torch.tensor(rew[:head]), torch.tensor(done[:head]).float())
    end, infos = pqn_ac.log_vec_replay(mid, torch.tensor(rew[head:]), torch.tensor(done[head:]).float())
    ref = twrap.LogVec(_Stream(obs, rew, done))
    _, rs = ref.reset(None, E)
    rs.episode_returns, rs.episode_lengths = start.episode_returns, start.episode_lengths
    for t in range(T):
        _, rs, _, _, ri = ref.step(None, rs, torch.zeros(E, 1))
        if t >= head:
            for k, v in ri.items():
                assert torch.equal(infos[k][t - head], v), (k, t)
    assert infos["returned_episode_returns"].shape == (tail, E)
    for f in ("episode_returns", "episode_lengths", "returned_episode_returns",
              "returned_episode_lengths", "timestep"):
        assert torch.equal(getattr(end, f), getattr(rs, f)), f


# ---- the noise ladder ----------------------------------------------------------------


def test_gaussian_noise_ladder_statistics_and_clip():
    """Env i's noise has std i / (E - 1) * noise * scale (linspace) or
    noise * scale, mean 0, by 8,192 draws each (within 5 %, about 4.5
    standard errors); clipping keeps every action in the box."""
    E, D, noise, scale = 9, 8192, 0.6, 2.0
    gen = torch.Generator().manual_seed(0)
    zeros = torch.zeros(E, D)
    for linspace in (True, False):
        out = gaussian_noise_ladder(gen, zeros, noise, -1e9, 1e9, scale=scale, linspace=linspace)
        want = np.linspace(0, noise, E) * scale if linspace else np.full(E, noise * scale)
        std = out.std(1).numpy()
        if linspace:
            assert (out[0] == 0).all()
        np.testing.assert_allclose(std[1:], want[1:], rtol=0.05)
        assert (out.mean(1).abs().numpy()[1:] < 5 * want[1:] / math.sqrt(D)).all()
    out = gaussian_noise_ladder(gen, torch.full((E, D), 1.5), noise, -2.0, 2.0, scale=scale)
    assert out.max() == 2.0 and out.min() >= -2.0 and (out[0] == 1.5).all()
    # the JAX ladder's stds, the same formula
    jout = jax_pqn_ac.gaussian_noise_ladder(jax.random.PRNGKey(0), jnp.zeros((E, D)), noise, -1e9, 1e9,
                                            scale=scale)
    np.testing.assert_allclose(np.asarray(jout).std(1)[1:], np.linspace(0, noise, E)[1:] * scale, rtol=0.05)


# ---- the networks and their checkpoint ------------------------------------------------


NET_CASES = {
    "layer_norm_relu": dict(norm_type="layer_norm", activation="relu"),
    "batch_norm_tanh": dict(norm_type="batch_norm", activation="tanh"),
}
H = 32


def _batch(n=24, seed=0):
    r = np.random.RandomState(seed)
    th = r.uniform(-np.pi, np.pi, n)
    obs = np.stack([np.cos(th), np.sin(th), r.uniform(-8, 8, n)], -1).astype(np.float32)
    return obs, r.uniform(-2, 2, (n, 1)).astype(np.float32)


def _flax_nets(case, seed=0, obs_dim=3, act_dim=1, scale=2.0):
    kw = NET_CASES[case]
    jactor = JActor(act_dim, action_scale=jnp.asarray(scale), action_bias=jnp.asarray(0.0), hidden_sizes=(H, H),
                    **kw)
    jcritic = JCritic(hidden_sizes=(H, H), norm_type=kw["norm_type"])
    av = jactor.init(jax.random.PRNGKey(seed), jnp.zeros(obs_dim))
    cv = jax.vmap(jcritic.init, in_axes=(0, None, None))(
        jax.random.split(jax.random.PRNGKey(seed + 1), 2), jnp.zeros(obs_dim), jnp.zeros(act_dim))
    # move the running statistics off their init so that eval mode reads them
    av = {**av, "batch_stats": jax.tree_util.tree_map(lambda v: v + 0.25, av["batch_stats"])}
    cv = {**cv, "batch_stats": jax.tree_util.tree_map(lambda v: v * 1.5 + 0.1, cv["batch_stats"])}
    return jactor, jcritic, av, cv


def _port_nets(case, av=None, cv=None, generator=None, obs_dim=3, act_dim=1, scale=2.0):
    kw = NET_CASES[case]
    actor = TActor(obs_dim, act_dim, scale, 0.0, [H, H], generator=generator, **kw)
    critics = CriticEnsemble(2, obs_dim, act_dim, [H, H], norm_type=kw["norm_type"], generator=generator)
    if av is not None:
        actor.load_state_dict(tckpt.params_from_flax(_np(av)))
        critics.load_state_dict(tckpt.params_from_flax(_np(cv)))
    return actor, critics


@pytest.mark.parametrize("case", sorted(NET_CASES))
def test_actor_critic_and_ensemble_match_flax(case):
    """From crossed weights (the ensemble's member axis crossed as a batch
    axis), in eval and train mode: actions, each member's values and one
    critic alone within 1e-5; the batch statistics after a train-mode call,
    the dummy input BatchNorm's included, within 1e-6."""
    jactor, jcritic, av, cv = _flax_nets(case)
    actor, critics = _port_nets(case, av, cv)
    obs, act = _batch()
    o, a = jnp.asarray(obs), jnp.asarray(act)
    ja = jax.jit(lambda v: jactor.apply(v, o, train=False))(av)
    jv = jax.jit(jax.vmap(lambda v: jcritic.apply(v, o, a, train=False)))(cv)
    with torch.no_grad():
        ta, tv = actor(torch.tensor(obs), train=False), critics(torch.tensor(obs), torch.tensor(act), train=False)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5, rtol=0)
    one = TCritic(3, 1, [H, H], norm_type=NET_CASES[case]["norm_type"])
    one.load_state_dict(tckpt.params_from_flax(_np(jax.tree_util.tree_map(lambda x: x[1], cv))))
    with torch.no_grad():
        np.testing.assert_allclose(one(torch.tensor(obs), torch.tensor(act), train=False).numpy(),
                                   np.asarray(jv[1]), atol=1e-5, rtol=0)

    ja, aupd = jax.jit(lambda v: jactor.apply(v, o, train=True, mutable=["batch_stats"]))(av)
    jv, cupd = jax.jit(jax.vmap(lambda v: jcritic.apply(v, o, a, train=True, mutable=["batch_stats"])))(cv)
    ta, tv = actor(torch.tensor(obs), train=True), critics(torch.tensor(obs), torch.tensor(act), train=True)
    np.testing.assert_allclose(ta.detach().numpy(), np.asarray(ja), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), atol=1e-5, rtol=0)
    for net, upd in ((actor, aupd), (critics, cupd)):
        stats = tckpt.params_to_flax(net)["batch_stats"]
        want = _np(upd["batch_stats"])
        assert jax.tree_util.tree_structure(stats) == jax.tree_util.tree_structure(want)
        for got, ref in zip(jax.tree_util.tree_leaves(stats), jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_port_init_is_orthogonal_with_the_flax_tree():
    """The port's own init: orthogonal kernels (columns when in >= out, rows
    otherwise, scaled by init_scale), zero biases, and params trees whose
    names and shapes equal flax's for the actor and the vmapped critics."""
    gen = torch.Generator().manual_seed(0)
    actor = TActor(3, 1, 2.0, 0.0, [H, H], init_scale=0.5, generator=gen)
    critics = CriticEnsemble(2, 3, 1, [H, H], generator=gen)
    w = actor.Dense_1.weight.detach()
    torch.testing.assert_close(w @ w.T, 0.25 * torch.eye(H), atol=1e-5, rtol=0)
    for m in range(2):
        k = critics.Dense_0.weight[m].detach().T  # (4, H): orthonormal rows
        torch.testing.assert_close(k @ k.T, torch.eye(4), atol=1e-5, rtol=0)
    assert not torch.equal(critics.Dense_1.weight[0], critics.Dense_1.weight[1])
    assert all((m.bias == 0).all() for m in (actor.Dense_0, critics.Dense_2))
    _, _, av, cv = _flax_nets("layer_norm_relu")
    shapes = lambda t: jax.tree_util.tree_map(lambda v: tuple(np.shape(v)), _np(t))  # noqa: E731
    assert shapes(tckpt.params_to_flax(actor)) == shapes(av)
    assert shapes(tckpt.params_to_flax(critics)) == shapes(cv)


def test_jax_saved_ac_params_load_into_the_port(tmp_path):
    """A file the JAX package writes for an AC run (its cli's {"actor",
    "critic"} tree, saved by its save_run with the seed axis) loads into the
    port and gives flax's actions and values."""
    jactor, jcritic, av, cv = _flax_nets("layer_norm_relu", seed=4)
    params = {"actor": av["params"], "critic": cv["params"]}
    jckpt.save_run(jax.tree_util.tree_map(lambda x: x[None], params), {"NUM_SEEDS": 1}, str(tmp_path), "ac")
    loaded = tckpt.load_params(str(tmp_path / "ac.safetensors"))
    actor, critics = _port_nets("layer_norm_relu")
    actor.load_state_dict(tckpt.params_from_flax(loaded["actor"]), strict=False)
    critics.load_state_dict(tckpt.params_from_flax(loaded["critic"]), strict=False)
    obs, act = _batch(seed=5)
    stats = lambda v: {"params": v["params"], "batch_stats": jax.tree_util.tree_map(  # noqa: E731
        lambda x: x * 0 + (x.mean() > 0.5), v["batch_stats"])}  # the init statistics
    ja = jactor.apply(stats(av), jnp.asarray(obs), train=False)
    jv = jax.vmap(lambda v: jcritic.apply(v, jnp.asarray(obs), ja, train=False))(stats(cv))
    with torch.no_grad():
        ta = actor(torch.tensor(obs), train=False)
        tv = critics(torch.tensor(obs), ta, train=False)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5, rtol=0)


# ---- the fused rollout's twin against the Pallas kernel -----------------------------------


@pytest.mark.parametrize("max_steps", [200, 5])
def test_pendulum_twin_matches_pallas_interpret(max_steps):
    """`pendulum_rollout_plain(use_prng=False)` against the Pallas kernel in
    interpret mode at B 16, T 12, H 64 (tests/test_ops.py:629-691), from
    JAX resets and, with max_steps 5, through auto-resets: every output
    within 1e-5, done and time equal."""
    B, T, Hk = 16, 12, 64
    env, params = jmake("Pendulum-v1")
    _, state0 = jax.vmap(env.reset, in_axes=(0, None))(jax.random.split(jax.random.PRNGKey(0), B), params)
    actor = JActor(1, action_scale=jnp.asarray(2.0), action_bias=jnp.asarray(0.0), hidden_sizes=(Hk, Hk),
                   norm_type="layer_norm")
    av = actor.init(jax.random.PRNGKey(1), jnp.zeros(3))
    critic = JCritic(hidden_sizes=(Hk, Hk), norm_type="layer_norm")
    cv = jax.vmap(critic.init, in_axes=(0, None, None))(jax.random.split(jax.random.PRNGKey(2), 2),
                                                       jnp.zeros(3), jnp.zeros(1))
    stf0, sti0 = state_matrix_from_pendulum(state0)
    if max_steps == 5:  # staggered times, so envs reset at different steps
        sti0 = jnp.arange(B, dtype=jnp.int32)[None] % 5
    want = pendulum_ac_rollout_pallas(jnp.asarray(0), jnp.asarray(0.7), av["params"], cv["params"], stf0, sti0,
                                      T, use_prng=False, interpret=True, max_steps=max_steps)
    tactor = TActor(3, 1, 2.0, 0.0, [Hk, Hk])
    tactor.load_state_dict(tckpt.params_from_flax(_np(av)))
    tcrit = CriticEnsemble(2, 3, 1, [Hk, Hk])
    tcrit.load_state_dict(tckpt.params_from_flax(_np(cv)))
    aw, cw = tpr.pendulum_ac_weights(tactor, tcrit)
    got = tpr.pendulum_ac_rollout(0, 0.7, aw, cw, torch.tensor(np.asarray(stf0)), torch.tensor(np.asarray(sti0)),
                                  T, use_prng=False, max_steps=max_steps)
    names = ("obs", "u", "greedy", "value", "reward", "done", "final_obs", "stf", "sti")
    for name, g, w in zip(names, got, want):
        assert tuple(g.shape) == tuple(np.shape(w)), name
        if name in ("done", "sti"):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0, err_msg=name)
    assert (np.asarray(want[5]).sum() > 0) == (max_steps == 5)


def test_pendulum_twin_random_streams():
    """With the PRNG on (Philox words 0-3 of counter (t, env, 0, 0)): z from
    the envs far from the action bounds has mean 0 and variance 1 (4
    standard errors), reset draws lie in [-pi, pi) x [-1, 1), each env's std
    follows the ladder, and different seeds give different streams."""
    T, B = 60, 64
    actor, critics = _port_nets("layer_norm_relu", generator=torch.Generator().manual_seed(3))
    aw, cw = tpr.pendulum_ac_weights(actor, critics)
    stf0 = torch.stack([torch.linspace(-3, 3, B), torch.zeros(B), torch.zeros(B)])
    sti0 = torch.zeros(1, B, dtype=torch.int32)
    noise = 0.05
    out = tpr.pendulum_rollout_plain(9, noise, aw, cw, stf0, sti0, T, linspace_noise=False)
    u, greedy = out[1][..., 0], out[2][..., 0]
    far = greedy.abs() < 2 - 12 * noise  # no draw within 6 std reaches the clip
    z = ((u - greedy) / (2 * noise))[far]
    assert z.numel() > 2000
    assert abs(z.mean().item()) < 4 / math.sqrt(z.numel())
    assert abs(z.var().item() - 1) < 4 * math.sqrt(2 / z.numel())
    # step 0 starts from the same state: the ladder scales env b's z by b / (B - 1)
    ladder = tpr.pendulum_rollout_plain(9, noise, aw, cw, stf0, sti0, 1)
    z0 = (u[0] - greedy[0]) / (2 * noise)
    zl = (ladder[1] - ladder[2])[0, :, 0] / (2 * noise)
    torch.testing.assert_close(zl[far[0]], (z0 * torch.arange(B) / (B - 1))[far[0]], atol=1e-4, rtol=0)
    reset = tpr.pendulum_rollout_plain(5, 0.0, aw, cw, stf0, sti0, T, max_steps=1)[7]
    assert -math.pi <= reset[0].min() and reset[0].max() < math.pi and -1 <= reset[1].min() and reset[1].max() < 1
    other = tpr.pendulum_rollout_plain(10, noise, aw, cw, stf0, sti0, T, linspace_noise=False)
    assert not torch.equal(other[1], out[1])


# ---- one learn step -----------------------------------------------------------------------


# the action dims of the learn step's cases: Pendulum's 1 (torque in
# [-2, 2]), then Reacher's and Pusher's 2 and Walker's 4 (in [-1, 1]), with
# those envs' obs dims
LEARN_DIMS = {1: (3, 2.0), 2: (10, 1.0), 4: (13, 1.0)}


@functools.lru_cache(maxsize=None)
def _learn_inputs(act_dim):
    """The config, a minibatch, its targets and the flax AC variables: for
    action dim 1 made with JAX (Pendulum steps from JAX resets with random
    torques through the JAX env); for 2 and 4 random obs and actions in the
    box."""
    if act_dim != 1:
        obs_dim, scale = LEARN_DIMS[act_dim]
        r = np.random.RandomState(act_dim)
        n = 48
        act = r.uniform(-1, 1, (n, act_dim)).astype(np.float32)
        mb = dict(
            done=(r.rand(n) < 0.2).astype(np.float32),
            original_action=np.clip(act + r.randn(n, act_dim) * 0.3, -1, 1).astype(np.float32), action=act,
            next_action=r.uniform(-1, 1, (n, act_dim)).astype(np.float32), value=np.zeros(n, np.float32),
            reward=r.randn(n).astype(np.float32), obs=r.randn(n, obs_dim).astype(np.float32),
            next_obs=r.randn(n, obs_dim).astype(np.float32),
        )
        target = (mb["reward"] + r.randn(n) * 0.1).astype(np.float32)
        _, _, av, cv = _flax_nets("layer_norm_relu", seed=11, obs_dim=obs_dim, act_dim=act_dim, scale=scale)
        return ac_config(), mb, target, av, cv
    config = ac_config()
    env, params = jmake("Pendulum-v1")
    n = 48
    obs, state = jax.vmap(env.reset, in_axes=(0, None))(jax.random.split(jax.random.PRNGKey(7), n), params)
    r = np.random.RandomState(8)
    act = jnp.asarray(r.uniform(-2, 2, (n, 1)).astype(np.float32))
    next_obs, _, rew, done, _ = jax.vmap(env.step, in_axes=(0, 0, 0, None))(
        jax.random.split(jax.random.PRNGKey(9), n), state, act, params)
    done = jnp.asarray(r.rand(n) < 0.2)
    mb = dict(
        done=np.asarray(done, np.float32), original_action=np.clip(np.asarray(act) + r.randn(n, 1) * 0.3, -2, 2)
        .astype(np.float32), action=np.asarray(act), next_action=r.uniform(-2, 2, (n, 1)).astype(np.float32),
        value=np.zeros(n, np.float32), reward=0.05 * np.asarray(rew), obs=np.asarray(obs), next_obs=np.asarray(next_obs),
    )
    target = (0.05 * np.asarray(rew) + r.randn(n) * 0.1).astype(np.float32)
    _, _, av, cv = _flax_nets("layer_norm_relu", seed=11)
    return config, mb, target, av, cv


def _jax_learn_step(config, mb, target, av, cv, use_qlambda, act_dim=1):
    """pqn_ac.py:420-535 built from JAX pieces: the critic's loss and
    update, then the actor's against the critic before its update."""
    scale = LEARN_DIMS[act_dim][1]
    actor = JActor(act_dim, action_scale=jnp.asarray(scale), action_bias=jnp.asarray(0.0), hidden_sizes=(H, H),
                   norm_type="layer_norm")
    critic = JCritic(hidden_sizes=(H, H), norm_type="layer_norm")
    mb = {k: jnp.asarray(v) for k, v in mb.items()}
    sched = optax.linear_schedule(config["LR_START"], config["LR_END"], 1000)
    tx = jax_make_optimizer(config["MAX_GRAD_NORM"], sched)

    def critic_loss_fn(p):
        def train_pass(o, a):
            return jax.vmap(lambda pp, bs: critic.apply({"params": pp, "batch_stats": bs}, o, a, train=True,
                                                        mutable=["batch_stats"]))(p, cv["batch_stats"])
        if use_qlambda:
            values, upd = train_pass(mb["obs"], mb["action"])
            tgt = jnp.asarray(target)
        else:
            all_q, upd = train_pass(jnp.concatenate((mb["obs"], mb["next_obs"])),
                                    jnp.concatenate((mb["action"], mb["next_action"])))
            values, next_values = jnp.split(all_q, 2, axis=1)
            tgt = mb["reward"] + (1 - mb["done"]) * config["GAMMA"] * jax.lax.stop_gradient(next_values).mean(0)
        per = jax.vmap(jax_pqn_ac.smooth_l1_loss, in_axes=(0, None))(values, jax.lax.stop_gradient(tgt))
        return jnp.sum(jax.vmap(jnp.mean)(per)), upd

    def actor_loss_fn(p):
        action, upd = actor.apply({"params": p, "batch_stats": av["batch_stats"]}, mb["obs"], train=True,
                                  mutable=["batch_stats"])
        q = jax.vmap(lambda v: critic.apply(v, mb["obs"], action, train=False))(cv).mean(0)
        norm_diff = jnp.abs((action - mb["original_action"] - 0.0) / scale).mean(-1)
        pen = jax_pqn_ac.smooth_l1_loss(action, mb["original_action"]).mean(-1)
        penalty = jnp.where(norm_diff < config["THRESHOLD"], 0.0, config["PENALTY_COEFF"] * pen)
        return jnp.mean(-q + penalty), upd

    @jax.jit
    def step(params):
        out = []
        for fn, p in zip((critic_loss_fn, actor_loss_fn), params):
            (loss, upd), grads = jax.value_and_grad(fn, has_aux=True)(p)
            updates, _ = tx.update(grads, tx.init(p), p)
            out.append((loss, optax.apply_updates(p, updates), upd["batch_stats"]))
        return out

    return [(float(loss), _np(p), _np(bs)) for loss, p, bs in step((cv["params"], av["params"]))]


@pytest.mark.parametrize("use_qlambda,act_dim", [
    pytest.param(True, 1, id="True"), pytest.param(False, 1, id="False"),
    pytest.param(True, 2, id="True-act2"), pytest.param(False, 2, id="False-act2"),
    pytest.param(True, 4, id="True-act4"), pytest.param(False, 4, id="False-act4"),
])
def test_learn_minibatch_matches_jax(use_qlambda, act_dim):
    """One critic-and-actor step on the JAX-made minibatch from the same
    flax variables, through `learn_minibatch` (the actor reading the critic
    before its step): losses within 1e-5 relative, new params within 1e-6,
    batch statistics within 1e-6; Q(lambda) targets and the 1-step path;
    action dims 1 (Pendulum), 2 (Reacher, Pusher) and 4 (Walker)."""
    config, mb, target, av, cv = _learn_inputs(act_dim)
    obs_dim, scale = LEARN_DIMS[act_dim]
    (jc_loss, jc_params, jc_bs), (ja_loss, ja_params, ja_bs) = _jax_learn_step(
        config, mb, target, av, cv, use_qlambda, act_dim)
    actor, critics = _port_nets("layer_norm_relu", av, cv, obs_dim=obs_dim, act_dim=act_dim, scale=scale)
    sched = linear_schedule(config["LR_START"], config["LR_END"], 1000)
    aopt = make_optimizer(actor.parameters(), config["MAX_GRAD_NORM"], sched)
    copt = make_optimizer(critics.parameters(), config["MAX_GRAD_NORM"], sched)
    batch = pqn_ac.ACTransition(**{k: torch.tensor(v) for k, v in mb.items()})
    c_loss, a_loss = pqn_ac.learn_minibatch(
        actor, critics, aopt, copt, batch, torch.tensor(target) if use_qlambda else None, config, scale, 0.0)
    np.testing.assert_allclose(c_loss.item(), jc_loss, rtol=1e-5)
    np.testing.assert_allclose(a_loss.item(), ja_loss, rtol=1e-5)
    for net, params, bs in ((critics, jc_params, jc_bs), (actor, ja_params, ja_bs)):
        want = tckpt.params_from_flax({"params": params, "batch_stats": bs})
        for name, p in net.state_dict().items():
            np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=1e-6, rtol=0, err_msg=name)


# ---- the trainer ----------------------------------------------------------------------------


def test_metric_names_match_the_jax_trainer():
    """The unfused trainer's metrics (eval included) carry the JAX trainer's
    names, read from its traced output shapes."""
    config = ac_config(TOTAL_TIMESTEPS=1024, TEST_DURING_TRAINING=True, TEST_NUM_ENVS=4, TEST_NUM_STEPS=8)
    jcfg = dict(config)
    jcfg.pop("DEVICE")
    shapes = jax.eval_shape(jax_pqn_ac.make_train(jcfg), jax.random.PRNGKey(0))
    out = pqn_ac.make_train(config)()
    assert set(out["metrics"]) == set(shapes["metrics"])
    assert all(v.shape == (2,) for v in out["metrics"].values())


def test_tiny_train_counts_paths_and_determinism():
    """ac_config's run: 16,384 env steps with finite losses and the actor's
    counters; the same seed gives the same params, another seed others; the
    1-step TD path runs; nothing launches a kernel on the CPU."""
    before = (tpr.pendulum_ac_rollout.launches, tlr.lambda_returns.launches)
    config = ac_config()
    out = pqn_ac.make_train(config)()
    m = out["metrics"]
    assert int(m["env_step"][-1]) == 16384 and int(m["update_steps"][-1]) == 32
    assert int(m["grad_steps_actor"][-1]) == int(m["grad_steps_critic"][-1]) == 32 * 8
    assert torch.isfinite(m["value_loss"]).all() and torch.isfinite(m["loss_actor"]).all()
    assert float(m["noise"][-1]) == pytest.approx(0.15)
    ts = out["runner_state"][0]
    assert ts["actor"].timesteps == 16384 and ts["critic"].timesteps == 0
    assert ts["critic"].network.Dense_0.weight.shape == (2, 32, 4)
    again = pqn_ac.make_train(config)()["runner_state"][0]
    for key in ("actor", "critic"):
        for (name, x), y in zip(ts[key].network.named_parameters(), again[key].network.parameters()):
            assert torch.equal(x, y), name
    one_step = pqn_ac.make_train(ac_config(USE_QLAMBDA=False, TOTAL_TIMESTEPS=2048))(seed=1)
    assert torch.isfinite(one_step["metrics"]["value_loss"]).all()
    assert not torch.equal(one_step["runner_state"][0]["actor"].network.Dense_0.weight, ts["actor"].network.Dense_0.weight)
    assert (tpr.pendulum_ac_rollout.launches, tlr.lambda_returns.launches) == before


@pytest.mark.parametrize("case", ["unfused", "fused", "normalized"])
def test_the_eval_moves_no_training_draw(case):
    """The greedy evals draw from streams of their own, as JAX splits each
    eval a key: a run with TEST_DURING_TRAINING on ends with the params and
    metrics of the same seed's run with it off, unfused, fused (the twin)
    or with both normalizers (the eval steps a copy of the statistics)."""
    kw = dict(TOTAL_TIMESTEPS=2048, TEST_NUM_ENVS=4, TEST_NUM_STEPS=40, TEST_INTERVAL=0.5,
              ENV_KWARGS="{'max_steps_in_episode': 40}")
    if case == "fused":
        kw.update(FUSED_ROLLOUT=True)
    if case == "normalized":
        kw.update(NORMALIZE_OBS=True, NORMALIZE_REWARD=True)
    on = pqn_ac.make_train(ac_config(TEST_DURING_TRAINING=True, **kw))()
    off = pqn_ac.make_train(ac_config(TEST_DURING_TRAINING=False, **kw))()
    assert torch.isfinite(on["metrics"]["test/returned_episode_returns"]).all()
    for key in ("actor", "critic"):
        for (name, x), y in zip(on["runner_state"][0][key].network.named_parameters(),
                                off["runner_state"][0][key].network.parameters()):
            assert torch.equal(x, y), (key, name)
    for k, v in off["metrics"].items():
        assert torch.equal(on["metrics"][k], v), k


def test_fused_train_on_the_cpu_runs_the_twin_and_its_eval():
    """FUSED_ROLLOUT=True on the CPU (the kernel's twin), as
    test_fused_ac_train_interpret_end_to_end: the chunked greedy eval runs
    and finishes episodes, `timestep` advances, the replay's infos are
    finite, and the twin ran once per update and once per eval chunk."""
    calls = []
    real = tpr.pendulum_rollout_plain

    def counted(*a, **k):
        calls.append(a[1])
        return real(*a, **k)

    tpr.pendulum_rollout_plain = counted
    try:
        out = pqn_ac.make_train(ac_config(
            FUSED_ROLLOUT=True, TOTAL_TIMESTEPS=4096, TEST_DURING_TRAINING=True, TEST_NUM_ENVS=8,
            TEST_INTERVAL=0.5, ENV_KWARGS="{'max_steps_in_episode': 40}"))()
    finally:
        tpr.pendulum_rollout_plain = real
    m = out["metrics"]
    assert m["timestep"].tolist() == [16.5 + 32 * i for i in range(8)]
    assert torch.isfinite(m["test/returned_episode_returns"]).all()
    assert (m["test/returned_episode_lengths"] == 40).all()
    assert torch.isfinite(m["returned_episode_returns"]).all() and (m["returned_episode"] > 0).any()
    # 8 updates, 3 evals of ceil(40 / 32) = 2 chunks at noise 0
    assert len(calls) == 8 + 3 * 2 and calls.count(0.0) == 6


def test_unsupported_options_raise():
    """A non-AC ALG_NAME raises; LOG_VIA_CALLBACK trains and hands each
    update's row to the logger's callback, as JAX's; an
    unknown env raises from the registry, as in JAX; FUSED_ROLLOUT off its
    Pendulum shapes raises ValueError, a new env or either normalizer among
    them (pqn_ac.py:142-158)."""
    with pytest.raises(NotImplementedError):
        pqn_ac.make_train(ac_config(ALG_NAME="pqn"))
    mem = MemorySink()
    pqn_ac.make_train(ac_config(LOG_VIA_CALLBACK=True, TOTAL_TIMESTEPS=1024), logger=MetricLogger([mem]))()
    assert [r["update_steps"] for r in mem.rows] == [1, 2] and all(np.isfinite(r["value_loss"]) for r in mem.rows)
    with pytest.raises(ValueError, match="Unknown env"):
        pqn_ac.make_train(ac_config(ENV_NAME="NoSuchEnv-v0"))
    for kw in ({"ENV_KWARGS": "{'g': 9.8}"}, {"NUM_CRITICS": 3}, {"ACTIVATION": "tanh"},
               {"NORM_TYPE": "batch_norm"}, {"ACTOR_HIDDEN_SIZES": "[32,32,32]"}, {"NORM_INPUT": True},
               {"ENV_NAME": "Reacher-v0"}, {"ENV_NAME": "Hopper-v0"}, {"NORMALIZE_OBS": True},
               {"NORMALIZE_REWARD": True}):
        with pytest.raises(ValueError, match="FUSED_ROLLOUT"):
            pqn_ac.make_train(ac_config(FUSED_ROLLOUT=True, **kw))
    with pytest.raises(ValueError, match="NUM_MINIBATCHES"):
        pqn_ac.make_train(ac_config(NUM_MINIBATCHES=3))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pqn_ac.make_train({**ac_config(), "DEVICE": None})


def test_cuda_policy_turns_on_the_fused_ac_rollout(capsys):
    """As tests/test_fast_defaults.py:60-76: FUSED_ROLLOUT for pqn_pendulum
    on cuda, not with NORMALIZE_OBS, not under PARITY=strict, not on the CPU,
    not with physics ENV_KWARGS the kernel keeps built in; an explicit flag
    wins; EVAL_EARLY_EXIT stays the FF family's."""
    cfg = compose(alg="pqn_pendulum")
    assert cfg["FUSED_ROLLOUT"] is True and "EVAL_EARLY_EXIT" not in cfg
    assert "FUSED_ROLLOUT=True" in capsys.readouterr().err
    assert compose(alg="pqn_pendulum", overrides=["ENV_KWARGS={'max_steps_in_episode': 100}"])["FUSED_ROLLOUT"]
    for ov in (["NORMALIZE_OBS=True"], ["PARITY=strict"], ["DEVICE=cpu"], ["ENV_KWARGS={'g': 9.8}"],
               ["NUM_SEEDS=2"], ["ACTOR_HIDDEN_SIZES=[64]"]):
        assert "FUSED_ROLLOUT" not in compose(alg="pqn_pendulum", overrides=ov), ov
    assert compose(alg="pqn_pendulum", overrides=["FUSED_ROLLOUT=False"])["FUSED_ROLLOUT"] is False
    for alg in ("pqn_reacher", "pqn_dm_suite", "pqn_locomotion", "pqn_manipulation"):
        assert "FUSED_ROLLOUT" not in compose(alg=alg), alg


def test_ac_cli_recipe_writes_what_the_jax_loader_reads(tmp_path, capsys):
    """A CPU CLI run writes the safetensors, the config yaml and the JSONL
    rows; the file loads with the JAX package's loader into the tree of a
    JAX AC init ({"actor", "critic"}, the critic's leaves member-stacked)."""
    jsonl = tmp_path / "m.jsonl"
    cli.main([
        "+alg=pqn_pendulum", "DEVICE=cpu", "TOTAL_TIMESTEPS=2048", "NUM_ENVS=16", "NUM_STEPS=32",
        "NUM_MINIBATCHES=4", "NUM_EPOCHS=1", "ACTOR_HIDDEN_SIZES=[32,32]", "CRITIC_HIDDEN_SIZES=[32,32]",
        "TEST_NUM_ENVS=4", "TEST_NUM_STEPS=8", f"SAVE_PATH={tmp_path / 'models'}", f"LOG_JSONL={jsonl}",
    ])
    assert "Training took" in capsys.readouterr().out
    run_dir = tmp_path / "models" / "Pendulum-v1"
    saved = jckpt.load_params(str(run_dir / "pqn_ac_Pendulum-v1_seed0.safetensors"))
    _, _, av, cv = _flax_nets("layer_norm_relu")
    shapes = lambda t: jax.tree_util.tree_map(lambda v: tuple(np.shape(v)), t)  # noqa: E731
    assert shapes(saved) == shapes({"actor": av["params"], "critic": cv["params"]})
    assert (run_dir / "pqn_ac_Pendulum-v1_seed0_config.yaml").exists()
    rows = [json.loads(line) for line in jsonl.read_text().splitlines()]
    assert len(rows) == 4 and rows[-1]["env_step"] == 2048 and "value_loss" in rows[-1]


# ---- the family beyond Pendulum: the other envs and the normalizers ----------------------------


TINY = ["DEVICE=cpu", "TOTAL_TIMESTEPS=8192", "NUM_ENVS=16", "NUM_STEPS=16", "NUM_MINIBATCHES=2", "NUM_EPOCHS=1",
        "ACTOR_HIDDEN_SIZES=[32,32]", "CRITIC_HIDDEN_SIZES=[32,32]", "TEST_DURING_TRAINING=False", "TEST_NUM_ENVS=8"]
# tests/test_continuous_envs.py::test_ac_trains_on_new_envs's six (alg,
# env) pairs at its tiny size, Reacher (tests/test_pqn_ac.py's learning
# test's config) at the same size, and tests/test_pqn_ac.py::
# test_ac_normalize_wrappers (ac_config with both normalizers), here also
# with its greedy eval
AC_TRAIN_CASES = {
    "swingup": ("pqn_dm_suite", ["ENV_NAME=CartPoleSwingUp-v0", *TINY]),
    "mountain_car": ("pqn_dm_suite", ["ENV_NAME=MountainCarContinuous-v0", *TINY]),
    "ball_in_cup": ("pqn_dm_suite", ["ENV_NAME=BallInCup-v0", *TINY]),
    "hopper": ("pqn_locomotion", ["ENV_NAME=Hopper-v0", *TINY]),
    "walker": ("pqn_locomotion", ["ENV_NAME=Walker-v0", *TINY]),
    "pusher": ("pqn_manipulation", ["ENV_NAME=Pusher-v0", *TINY]),
    "reacher": ("pqn_reacher", TINY),
    # the dm-suite domains of tests/test_dm_suite_tasks.py::
    # test_ac_trains_on_dm_suite_new_envs at its size (4096 env steps), one
    # task of each module
    **{case: ("pqn_dm_suite", [f"ENV_NAME={env}", *TINY, "TOTAL_TIMESTEPS=4096"]) for case, env in (
        ("acrobot_swingup", "AcrobotSwingup-v0"), ("point_mass", "PointMass-v0"), ("swimmer", "SwimmerSwimmer6-v0"),
        ("cheetah", "CheetahRun-v0"), ("finger", "FingerTurnEasy-v0"), ("fish", "FishSwim-v0"))},
    # the 3D legged envs of tests/test_locomotion3d.py::test_ac_trains_on_locomotion3d (the quadruped's
    # 12-wide action the widest), at the dm-suite cases' length, the quadruped also with 2 seeds; a task of
    # each manipulation class, as tests/test_manipulation2d.py::test_ac_trains_on_manipulation_tasks and
    # tests/test_manipulation_playground.py::test_ac_trains_on_manipulation
    **{case: ("pqn_locomotion", [f"ENV_NAME={env}", *TINY, "TOTAL_TIMESTEPS=4096", *extra]) for case, env, extra in (
        ("go1", "Go1JoystickFlatTerrain", []), ("humanoid_walk", "HumanoidWalk", []),
        ("go1_2_seeds", "Go1JoystickFlatTerrain", ["NUM_SEEDS=2"]))},
    **{case: ("pqn_manipulation", [f"ENV_NAME={env}", *TINY]) for case, env in (
        ("pick_place", "PickPlace-v0"), ("peg_insert", "PegInsert-v0"), ("block_rotate", "BlockRotate-v0"),
        ("panda_pick_cube", "PandaPickCube"), ("push_cube", "PandaRobotiqPushCube"), ("hand_over", "AlohaHandOver"))},
    "pendulum_normalized": ("pqn_pendulum", [
        "DEVICE=cpu", "TOTAL_TIMESTEPS=16384", "NUM_ENVS=16", "NUM_STEPS=32", "NUM_MINIBATCHES=4", "NUM_EPOCHS=2",
        "ACTOR_HIDDEN_SIZES=[32,32]", "CRITIC_HIDDEN_SIZES=[32,32]", "NORMALIZE_OBS=True", "NORMALIZE_REWARD=True",
        "TEST_DURING_TRAINING=True", "TEST_NUM_ENVS=4", "TEST_INTERVAL=0.5"]),
}


def _f32_count(first: int, rows: int, times: int) -> float:
    """1e-4 plus ``first`` rows, then ``rows`` rows ``times`` times, summed in
    float32 as the normalizers' counts are."""
    count = np.float32(np.float32(1e-4) + np.float32(first))
    for _ in range(times):
        count = np.float32(count + np.float32(rows))
    return float(count)


@pytest.mark.parametrize("case", sorted(AC_TRAIN_CASES))
def test_ac_trains_on_the_continuous_envs(case):
    """The trainer at the JAX tests' tiny size on each env, DEVICE=cpu: the
    env-step count, finite losses and metrics; with NORMALIZE_OBS the
    training statistics finite and their count 1e-4 + E (1 + updates x
    NUM_STEPS) in float32 (the reset's batch counted), with
    NORMALIZE_REWARD the reward statistics' count 1e-4 + E x updates x
    NUM_STEPS; with seeds, each metric and count one a seed; no kernel
    launched on the CPU."""
    alg, overrides = AC_TRAIN_CASES[case]
    config = compose(alg=alg, overrides=overrides)
    before = tlr.lambda_returns.launches
    out = pqn_ac.make_train(config)()
    m = out["metrics"]
    E, T, seeds = config["NUM_ENVS"], config["NUM_STEPS"], config.get("NUM_SEEDS", 1)
    updates = config["TOTAL_TIMESTEPS"] // (E * T)
    lanes = (seeds,) if seeds > 1 else ()
    assert (m["env_step"][..., -1] == updates * E * T).all() and m["env_step"].shape == (*lanes, updates)
    for k in ("value_loss", "loss_actor", "returned_episode_returns", "original_reward"):
        assert torch.isfinite(m[k]).all(), k
    env_state = out["runner_state"][1][1]
    if config["NORMALIZE_OBS"]:
        assert isinstance(env_state, twrap.NormalizeVecObsState)
        assert torch.isfinite(env_state.mean).all() and (env_state.var >= 0).all()
        assert env_state.count.shape == lanes and (env_state.count == _f32_count(E, E, updates * T)).all()
        env_state = env_state.env_state
    if config["NORMALIZE_REWARD"]:
        assert isinstance(env_state, twrap.NormalizeVecRewState)
        assert (env_state.count == _f32_count(0, E, updates * T)).all()
    if config["TEST_DURING_TRAINING"]:
        assert torch.isfinite(m["test/returned_episode_returns"]).all()
    assert tlr.lambda_returns.launches == before


def test_eval_swap_and_double_normalization_match_jax():
    """The unfused eval's start with NORMALIZE_OBS (pqn_ac.py:710-720) on
    given training statistics: the fresh envs' reset obs, normalized by the
    reset's own fresh statistics, normalized again by the training ones, the
    training statistics over the reset's inner state; its first step moves
    that copy as JAX's does, and the training state stays as it was."""
    E, D = 6, 4
    r = np.random.RandomState(3)
    obs = (r.randn(3, E, D) * 4 + 7).astype(np.float32)
    rew, done = np.zeros((2, E), np.float32), np.zeros((2, E), bool)
    mean, var, count = r.randn(D).astype(np.float32), r.uniform(0.5, 9, D).astype(np.float32), np.float32(4096.0001)
    jenv = jwrap.NormalizeVecObservation(_Stream(obs, rew, done, jnp.asarray))
    init_obs, reset_state = jenv.reset(None)
    train_j = jwrap.NormalizeVecObsState(mean=jnp.asarray(mean), var=jnp.asarray(var), count=jnp.asarray(count),
                                         env_state=None)
    js = train_j.replace(env_state=reset_state.env_state)
    jo = (init_obs - js.mean) / jnp.sqrt(js.var + 1e-8)
    jo1, js1, *_ = jenv.step(None, js, jnp.zeros((E, 1)))

    tenv = twrap.NormalizeVecObservation(_Stream(obs, rew, done, torch.tensor))
    train_t = twrap.NormalizeVecObsState(mean=torch.tensor(mean), var=torch.tensor(var), count=torch.tensor(count),
                                         env_state=None)
    t_init, t_reset = tenv.reset(None, E)
    to, ts = pqn_ac.eval_start(t_init, t_reset, train_t)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6, atol=1e-6)
    assert ts.mean is train_t.mean and ts.var is train_t.var and ts.count is train_t.count
    to1, ts1, *_ = tenv.step(None, ts, torch.zeros(E, 1))
    np.testing.assert_allclose(to1.numpy(), np.asarray(jo1), rtol=1e-6, atol=1e-6)
    for f in ("mean", "var", "count"):
        np.testing.assert_allclose(getattr(ts1, f).numpy(), np.asarray(getattr(js1, f)), rtol=1e-6, atol=1e-6)
    assert np.array_equal(train_t.mean.numpy(), mean) and train_t.count.item() == float(count)


def test_ac_cli_saves_norm_stats_that_the_jax_rollout_reads(tmp_path, capsys):
    """A port CLI run of pqn_dm_suite (NORMALIZE_OBS) writes ``norm_stats``
    {mean, var} of shape (obs_dim,), the run's training statistics, beside
    the actor's and the critics' trees; the JAX package's loader reads the
    file and its rollout script's AC path replays the frozen normalization."""
    from purejaxql_tpu.scripts.rollout import greedy_rollout_ac

    config = compose(alg="pqn_dm_suite", overrides=[
        *TINY, "TOTAL_TIMESTEPS=1024", f"SAVE_PATH={tmp_path / 'models'}", f"LOG_JSONL={tmp_path / 'm.jsonl'}"])
    outs = cli.single_run(config)
    assert "Training took" in capsys.readouterr().out
    saved = jckpt.load_params(str(tmp_path / "models" / "CartPoleSwingUp-v0" /
                                  "pqn_ac_CartPoleSwingUp-v0_seed0.safetensors"))
    assert set(saved) == {"actor", "critic", "norm_stats"}
    stats = outs["runner_state"][1][1]
    for k in ("mean", "var"):
        assert saved["norm_stats"][k].shape == (5,)
        np.testing.assert_array_equal(np.asarray(saved["norm_stats"][k]), getattr(stats, k).numpy())
    assert saved["actor"]["Dense_0"]["kernel"].shape == (5, 32)
    assert saved["critic"]["Dense_0"]["kernel"].shape == (2, 6, 32)
    rets, lens, _ = greedy_rollout_ac(config, saved, 2, 0, 12)
    assert np.isfinite(rets).all() and lens.shape == (2,)


def test_jax_saved_norm_stats_load_into_the_port(tmp_path):
    """A tree the JAX package saves for a NORMALIZE_OBS run ({"actor",
    "critic", "norm_stats"}, through its save_run with the seed axis) loads
    into the port: the weights into the networks and the statistics into a
    new obs-normalizer state, its count and inner state kept; without
    statistics the given state comes back as it was."""
    _, _, av, cv = _flax_nets("layer_norm_relu", seed=6)
    norm = {"mean": np.array([0.5, -1.0, 2.0], np.float32), "var": np.array([1.5, 0.25, 9.0], np.float32)}
    tree = {"actor": av["params"], "critic": cv["params"], "norm_stats": norm}
    jckpt.save_run(jax.tree_util.tree_map(lambda x: x[None], tree), {"NUM_SEEDS": 1}, str(tmp_path), "ac")
    loaded = tckpt.load_params(str(tmp_path / "ac.safetensors"))
    actor, critics = _port_nets("layer_norm_relu")
    state = twrap.NormalizeVecObsState(mean=torch.zeros(3), var=torch.ones(3), count=torch.tensor(33.0),
                                       env_state="inner")
    new = tckpt.load_ac_params(loaded, actor, critics, state)
    assert new is not state and torch.equal(state.mean, torch.zeros(3))
    np.testing.assert_array_equal(new.mean.numpy(), norm["mean"])
    np.testing.assert_array_equal(new.var.numpy(), norm["var"])
    assert new.count.item() == 33.0 and new.env_state == "inner" and new.mean.dtype == torch.float32
    np.testing.assert_array_equal(actor.Dense_0.weight.detach().numpy(),
                                  np.asarray(av["params"]["Dense_0"]["kernel"]).T)
    np.testing.assert_array_equal(critics.Dense_1.weight.detach().numpy(),
                                  np.swapaxes(np.asarray(cv["params"]["Dense_1"]["kernel"]), -1, -2))
    del loaded["norm_stats"]
    assert tckpt.load_ac_params(loaded, actor, critics, state) is state


@pytest.mark.parametrize("fault", [None, "missing", "stray"])
@pytest.mark.parametrize("case", sorted(NET_CASES))
def test_load_ac_params_is_strict_on_the_weights(case, fault):
    """load_ac_params leaves the batch statistics a bare params tree lacks
    as they are, and refuses a tree that lacks a weight of the networks or
    holds one they lack (KeyError naming it)."""
    actor, critics = _port_nets(case, generator=torch.Generator().manual_seed(1))
    tree = {"actor": tckpt.params_to_flax(actor)["params"], "critic": tckpt.params_to_flax(critics)["params"]}
    if fault is None:
        before = {k: v.clone() for k, v in critics.state_dict().items()}
        assert tckpt.load_ac_params(tree, actor, critics) is None
        assert all(torch.equal(v, before[k]) for k, v in critics.state_dict().items())
        return
    if fault == "missing":
        del tree["critic"]["Dense_1"]["kernel"]
    else:
        tree["actor"]["Dense_9"] = {"kernel": np.zeros((H, 1), np.float32)}
    with pytest.raises(KeyError, match="Dense_1.weight" if fault == "missing" else "Dense_9.weight"):
        tckpt.load_ac_params(tree, actor, critics)


@pytest.mark.slow
def test_ac_learns_pendulum():
    """tests/test_pqn_ac.py::test_ac_learns_pendulum on the port: 400k steps
    on the CPU, the best greedy eval above -500 (random play about -1300)
    in one of seeds 0-3. One seed learns past that bar in about half of the
    runs, in JAX as in the port, so the bar is held over seeds, as
    chip_smoke.py holds it; the seeds run until one passes."""
    config = compose(alg="pqn_pendulum", overrides=["DEVICE=cpu", "TOTAL_TIMESTEPS=400000"])
    bests = []
    for seed in range(4):
        bests.append(float(pqn_ac.make_train(config)(seed=seed)["metrics"]["test/returned_episode_returns"].max()))
        if bests[-1] > -500:
            break
    assert max(bests) > -500, bests


@pytest.mark.parametrize("H", list(range(32, 1025, 32)))
@pytest.mark.parametrize("B", [1, 3, 64, 100, 128, 130])
def test_pendulum_plan_covers_every_env_and_unit(B, H):
    """The kernel's launch plan: clusters of at most 16 CTAs, each over a
    group of at most 8 envs, so every env has one cluster (whose CTA 0
    writes it); CTA c owns layer-2 units [c U, (c + 1) U) of each MLP, so
    every hidden unit has one owner; a CTA within 227 KB of shared memory;
    the W2 slices held on chip for H <= 512 and read from L2 above."""
    plan = tpr.pendulum_plan(B, H)
    assert plan.cluster in (1, 2, 4, 8, 16) and plan.threads == 256
    assert plan.group in (1, 2, 4, 8) and plan.clusters == -(-B // plan.group)
    envs = [k * plan.group + g for k in range(plan.clusters) for g in range(plan.group)]
    assert envs[:B] == list(range(B)) and len(envs) - B < plan.group
    units = [c * plan.units + j for c in range(plan.cluster) for j in range(plan.units)]
    assert units == list(range(H)) and 2 * plan.units <= 256
    assert plan.smem_bytes <= 232_448
    assert plan.resident == (H <= 512)
    if plan.resident:
        assert plan.smem_bytes >= 4 * 3 * plan.units * H  # the three W2 slices
    if (B, H) == (64, 256):
        assert (plan.cluster, plan.group, plan.clusters) == (16, 8, 8)
