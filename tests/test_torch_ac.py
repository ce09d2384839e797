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


def _flax_nets(case, seed=0):
    kw = NET_CASES[case]
    jactor = JActor(1, action_scale=jnp.asarray(2.0), action_bias=jnp.asarray(0.0), hidden_sizes=(H, H), **kw)
    jcritic = JCritic(hidden_sizes=(H, H), norm_type=kw["norm_type"])
    av = jactor.init(jax.random.PRNGKey(seed), jnp.zeros(3))
    cv = jax.vmap(jcritic.init, in_axes=(0, None, None))(
        jax.random.split(jax.random.PRNGKey(seed + 1), 2), jnp.zeros(3), jnp.zeros(1))
    # move the running statistics off their init so that eval mode reads them
    av = {**av, "batch_stats": jax.tree_util.tree_map(lambda v: v + 0.25, av["batch_stats"])}
    cv = {**cv, "batch_stats": jax.tree_util.tree_map(lambda v: v * 1.5 + 0.1, cv["batch_stats"])}
    return jactor, jcritic, av, cv


def _port_nets(case, av=None, cv=None, generator=None):
    kw = NET_CASES[case]
    actor = TActor(3, 1, 2.0, 0.0, [H, H], generator=generator, **kw)
    critics = CriticEnsemble(2, 3, 1, [H, H], norm_type=kw["norm_type"], generator=generator)
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


@pytest.fixture(scope="module")
def learn_inputs():
    """A minibatch made with JAX (Pendulum steps from JAX resets with random
    torques through the JAX env), the flax AC variables, the config and the
    targets."""
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


def _jax_learn_step(config, mb, target, av, cv, use_qlambda):
    """pqn_ac.py:420-535 built from JAX pieces: the critic's loss and
    update, then the actor's against the critic before its update."""
    actor = JActor(1, action_scale=jnp.asarray(2.0), action_bias=jnp.asarray(0.0), hidden_sizes=(H, H),
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
        norm_diff = jnp.abs((action - mb["original_action"] - 0.0) / 2.0).mean(-1)
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


@pytest.mark.parametrize("use_qlambda", [True, False])
def test_learn_minibatch_matches_jax(learn_inputs, use_qlambda):
    """One critic-and-actor step on the JAX-made minibatch from the same
    flax variables, through `learn_minibatch` (the actor reading the critic
    before its step): losses within 1e-5 relative, new params within 1e-6,
    batch statistics within 1e-6; Q(lambda) targets and the 1-step path."""
    config, mb, target, av, cv = learn_inputs
    (jc_loss, jc_params, jc_bs), (ja_loss, ja_params, ja_bs) = _jax_learn_step(config, mb, target, av, cv, use_qlambda)
    actor, critics = _port_nets("layer_norm_relu", av, cv)
    sched = linear_schedule(config["LR_START"], config["LR_END"], 1000)
    aopt = make_optimizer(actor.parameters(), config["MAX_GRAD_NORM"], sched)
    copt = make_optimizer(critics.parameters(), config["MAX_GRAD_NORM"], sched)
    batch = pqn_ac.ACTransition(**{k: torch.tensor(v) for k, v in mb.items()})
    c_loss, a_loss = pqn_ac.learn_minibatch(
        actor, critics, aopt, copt, batch, torch.tensor(target) if use_qlambda else None, config, 2.0, 0.0)
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
    for kw in ({"NUM_SEEDS": 2}, {"LOG_VIA_CALLBACK": True}, {"NORMALIZE_OBS": True},
               {"NORMALIZE_REWARD": True}, {"ENV_NAME": "Reacher-v0"}, {"ALG_NAME": "pqn"}):
        with pytest.raises(NotImplementedError):
            pqn_ac.make_train(ac_config(**kw))
    for kw in ({"ENV_KWARGS": "{'g': 9.8}"}, {"NUM_CRITICS": 3}, {"ACTIVATION": "tanh"},
               {"NORM_TYPE": "batch_norm"}, {"ACTOR_HIDDEN_SIZES": "[32,32,32]"}, {"NORM_INPUT": True}):
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


@pytest.mark.slow
def test_ac_learns_pendulum():
    """tests/test_pqn_ac.py::test_ac_learns_pendulum on the port: 400k steps
    on the CPU, the best greedy eval above -500 (random play about -1300)."""
    config = compose(alg="pqn_pendulum", overrides=["DEVICE=cpu", "TOTAL_TIMESTEPS=400000"])
    tr = pqn_ac.make_train(config)()["metrics"]["test/returned_episode_returns"]
    assert tr.max() > -500, tr
