"""The port's discrete classic envs on the CPU against the JAX package:
Acrobot-v1, MountainCar-v0, Catch-bsuite and DeepSea-bsuite (also at
ENV_KWARGS board sizes), and the registry's parity with the JAX one.

For every env: one `step_env` from a batch of random states off the reset
distribution (rows at max_steps - 1 among them) against JAX's; a 100-step
run in which the port steps from JAX's state each time with JAX's own step
draws (Acrobot's torque noise) and reset draws, so that its auto-reset rows
are held too; the reset from JAX's draws, and the port's own draws by their
ranges; the spaces. Ints equal, floats within 1e-5. Each JAX env's step and
reset are jitted once (vmapped, the params closed over) and reused; the
one step from random states runs JAX's step op by op (vmapped, not
jitted): at Acrobot's extreme velocities XLA's fused program differs from
JAX's own op-by-op step by 1.2e-4, the port from the latter by 8e-6."""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from purejaxql_torch.envs import make as tmake
from purejaxql_torch.envs import spaces as tspaces
from purejaxql_torch.envs.classic import acrobot as tacro
from purejaxql_torch.envs.classic import catch as tcatch
from purejaxql_torch.envs.classic import deep_sea as tsea
from purejaxql_torch.envs.classic import mountain_car as tmc
from purejaxql_torch.envs.base import NO_DRAWS
from purejaxql_torch.envs.registry import _REGISTRY as TORCH_REGISTRY
from purejaxql_tpu.envs import make as jmake
from purejaxql_tpu.envs import registry as jregistry
from purejaxql_tpu.envs import spaces as jspaces

torch.set_num_threads(1)

# (name, ENV_KWARGS): the defaults, and a Catch and a DeepSea board of other sizes
CASES = (
    ("Acrobot-v1", ()), ("MountainCar-v0", ()), ("Catch-bsuite", ()), ("Catch-bsuite", (("rows", 6), ("columns", 7))),
    ("DeepSea-bsuite", ()), ("DeepSea-bsuite", (("size", 11),)),
)
IDS = [name + "".join(f"-{k}{v}" for k, v in kw) for name, kw in CASES]
MODULES = {"Acrobot-v1": tacro, "MountainCar-v0": tmc, "Catch-bsuite": tcatch, "DeepSea-bsuite": tsea}


@functools.lru_cache(maxsize=None)
def _envs(name, kw):
    """The JAX env and params, the port's, JAX's step_env and reset_env,
    each vmapped and jitted once, and its step_env vmapped alone."""
    jenv, jparams = jmake(name, **dict(kw))
    tenv, tparams = tmake(name, **dict(kw))
    step = jax.jit(jax.vmap(lambda k, s, a: jenv.step_env(k, s, a, jparams)))
    reset = jax.jit(jax.vmap(lambda k: jenv.reset_env(k, jparams)))
    return jenv, jparams, tenv, tparams, step, reset, jax.vmap(lambda k, s, a: jenv.step_env(k, s, a, jparams))


def _times(r, n, limit):
    time = r.randint(0, limit, n)
    time[: n // 8] = limit - 1
    return time.astype(np.int32)


def _states(name, p, r, n):
    """Random states as numpy fields, off the reset distribution."""
    if name == "Acrobot-v1":
        return dict(joint_angle1=r.uniform(-np.pi, np.pi, n), joint_angle2=r.uniform(-np.pi, np.pi, n),
                    velocity_1=r.uniform(-p.max_vel_1, p.max_vel_1, n),
                    velocity_2=r.uniform(-p.max_vel_2, p.max_vel_2, n), time=_times(r, n, 500))
    if name == "MountainCar-v0":
        pos = r.uniform(p.min_position, p.max_position, n)
        pos[n // 8: n // 4] = p.min_position  # at the left wall
        return dict(position=pos, velocity=r.uniform(-p.max_speed, p.max_speed, n), time=_times(r, n, 200))
    if name == "Catch-bsuite":
        ints = lambda hi: r.randint(0, hi, n).astype(np.int32)  # noqa: E731
        return dict(ball_y=ints(p.rows - 1), ball_x=ints(p.columns), paddle_x=ints(p.columns),
                    time=_times(r, n, p.max_steps_in_episode))
    ints = lambda hi: r.randint(0, hi, n).astype(np.int32)  # noqa: E731
    return dict(row=ints(p.size), column=ints(p.size), action_map=r.randint(0, 2, (n, p.size)).astype(np.int32),
                time=_times(r, n, p.max_steps_in_episode))


def _jax_state(reset, fields):
    """The JAX env's state dataclass from numpy fields (floats as float32)."""
    _, like = reset(jax.random.split(jax.random.PRNGKey(0), 2))
    cast = {k: jnp.asarray(v.astype(np.float32) if v.dtype == np.float64 else v) for k, v in fields.items()}
    return like.replace(**cast)


def _torch_state(tenv, tparams, js):
    """The port's state of a JAX state, field for field."""
    _, like = tenv.reset(torch.Generator(), 1, tparams)
    return dataclasses.replace(like, **{f.name: torch.tensor(np.asarray(getattr(js, f.name)))
                                        for f in dataclasses.fields(like)})


def _assert_outputs(got, want, msg=""):
    """(obs, reward, done, state) as JAX's: ints equal, floats within 1e-5."""
    tobs, trew, tdone, ts = got
    jobs, jrew, jdone, js = want
    pairs = [("obs", tobs, jobs), ("reward", trew, jrew), ("done", tdone, jdone)]
    pairs += [(f.name, getattr(ts, f.name), getattr(js, f.name)) for f in dataclasses.fields(ts)]
    for key, g, w in pairs:
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (msg, key, g.shape, w.shape, g.dtype, w.dtype)
        if g.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, f"{msg} {key}")
        else:
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=f"{msg} {key}")


def _step_draws(name, keys):
    """The draws JAX's step_env makes from each env's step key, in the
    port's layout: Acrobot's U[0, 1) (acrobot.py:70-73), else none."""
    if name == "Acrobot-v1":
        return torch.tensor(np.asarray(jax.vmap(lambda k: jax.random.uniform(k, ()))(keys)))
    return NO_DRAWS


def _reset_draws(name, keys, p):
    """The draws JAX's reset_env makes from each env's key, in the port's
    draw_start layout."""
    if name == "Acrobot-v1":
        draw = lambda k: jax.random.uniform(k, (4,), minval=-0.1, maxval=0.1)  # noqa: E731
    elif name == "MountainCar-v0":
        draw = lambda k: jax.random.uniform(k, (), minval=-0.6, maxval=-0.4)  # noqa: E731
    elif name == "Catch-bsuite":
        draw = lambda k: jax.random.randint(k, (), 0, p.columns).astype(jnp.int32)  # noqa: E731
    else:
        draw = lambda k: jax.random.bernoulli(k, 0.5, (p.size,)).astype(jnp.int32)  # noqa: E731
    return torch.tensor(np.asarray(jax.vmap(draw)(keys)))


def _start(name, draws, tparams):
    mod = MODULES[name]
    return mod.start_state(draws, tparams) if name == "Catch-bsuite" else mod.start_state(draws)


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_step_from_random_states_matches_jax(name, kw):
    """512 random states and actions through one `step_env`: obs, reward,
    done and every state field as JAX's; both done and not done occur, and
    the spaces are JAX's (the board sizes follow ENV_KWARGS)."""
    jenv, jparams, tenv, tparams, _, reset, step = _envs(name, kw)
    n, r = 512, np.random.RandomState(CASES.index((name, kw)))
    js = _jax_state(reset, _states(name, jparams, r, n))
    act = r.randint(0, tenv.action_space(tparams).n, n)
    keys = jax.random.split(jax.random.PRNGKey(7), n)
    jo, jst, jr, jd, _ = step(keys, js, jnp.asarray(act, jnp.int32))
    got = tenv.step_env(_torch_state(tenv, tparams, js), torch.tensor(act), tparams, _step_draws(name, keys))
    _assert_outputs((got[0], got[2], got[3], got[1]), (jo, jr, jd, jst))
    assert 0 < got[3].sum() < n and got[2].dtype == torch.float32 and got[0].dtype == torch.float32
    tobs, jobs = tenv.observation_space(tparams), jenv.observation_space(jparams)
    assert tobs.shape == jobs.shape and got[0].shape == (n, *tobs.shape)
    np.testing.assert_array_equal(np.asarray(tobs.low, np.float32), np.asarray(jobs.low, np.float32))
    np.testing.assert_array_equal(np.asarray(tobs.high, np.float32), np.asarray(jobs.high, np.float32))
    assert tenv.action_space(tparams).n == jenv.action_space(jparams).n
    if name == "Catch-bsuite":
        assert (got[2] == 1).any() and (got[2] == -1).any()


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_run_with_auto_resets_matches_jax(name, kw, monkeypatch):
    """100 steps of 32 envs under random actions, started from JAX resets at
    random times: each step the port's `step` takes JAX's state, the step
    draws JAX's step_env makes from the first half of its key and, for its
    auto-reset, the reset draws from the second half (base.py:75-84); obs,
    reward, done and the state (reset rows included) as JAX's every step."""
    jenv, jparams, tenv, tparams, step, reset, _ = _envs(name, kw)
    n, steps = 32, 100
    r = np.random.RandomState(100 + CASES.index((name, kw)))
    _, js = reset(jax.random.split(jax.random.PRNGKey(1), n))
    js = js.replace(time=jnp.asarray(r.randint(0, jparams.max_steps_in_episode, n).astype(np.int32)))
    js = jax.tree_util.tree_map(lambda x: jnp.array(x, dtype=x.dtype), js)  # strong types: one compile of `step`
    holder = {}
    monkeypatch.setattr(MODULES[name], "draw_start", lambda *a: holder["reset"])
    monkeypatch.setattr(tenv, "step_draws", lambda *a: holder["step"])
    split = jax.jit(jax.vmap(jax.random.split))
    ended = 0
    for t in range(steps):
        keys = split(jax.random.split(jax.random.PRNGKey(1000 + t), n))
        k_step, k_reset = keys[:, 0], keys[:, 1]
        act = r.randint(0, tenv.action_space(tparams).n, n)
        jo, jst, jr, jd, _ = step(k_step, js, jnp.asarray(act, jnp.int32))
        jo_re, js_re = reset(k_reset)
        sel = lambda re, st: jnp.where(jd.reshape(jd.shape + (1,) * (st.ndim - 1)), re, st)  # noqa: E731
        js_next = jax.tree_util.tree_map(sel, js_re, jst)
        jo = sel(jo_re, jo)
        holder["step"], holder["reset"] = _step_draws(name, k_step), _reset_draws(name, k_reset, jparams)
        to, ts, tr, td, _ = tenv.step(torch.Generator(), _torch_state(tenv, tparams, js), torch.tensor(act), tparams)
        _assert_outputs((to, tr, td, ts), (jo, jr, jd, js_next), f"step {t}")
        ended += int(td.sum())
        js = js_next
    assert ended > 0


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_reset_matches_jax_and_its_draws_their_ranges(name, kw):
    """JAX's `reset_env` from 64 keys and the port's `start_state` from the
    same keys' draws give the same obs and state; the port's own reset of
    100k envs draws each value in its range with its mean (within 5
    standard errors)."""
    jenv, jparams, tenv, tparams, step, reset, _ = _envs(name, kw)
    keys = jax.random.split(jax.random.PRNGKey(5), 64)
    jo, js = reset(keys)
    ts = _start(name, _reset_draws(name, keys, jparams), tparams)
    _assert_outputs((tenv.get_obs(ts, tparams), torch.zeros(1), torch.zeros(1, dtype=torch.bool), ts),
                    (jo, np.zeros(1, np.float32), np.zeros(1, bool), js))

    n = 100_000
    obs, s = tenv.reset(torch.Generator().manual_seed(0), n, tparams)
    assert obs.shape == (n, *tenv.observation_space(tparams).shape) and (s.time == 0).all()

    def mean_ok(x, lo, hi, var):
        x = x.double()
        assert lo <= x.min() and x.max() <= hi
        assert abs(x.mean().item() - (lo + hi) / 2) < 5 * math.sqrt(var / x.numel())

    if name == "Acrobot-v1":
        for x in (s.joint_angle1, s.joint_angle2, s.velocity_1, s.velocity_2):
            mean_ok(x, -0.1, 0.1, 0.2**2 / 12)
    elif name == "MountainCar-v0":
        mean_ok(s.position, -0.6, -0.4, 0.2**2 / 12)
        assert (s.velocity == 0).all()
    elif name == "Catch-bsuite":
        c = tparams.columns
        mean_ok(s.ball_x, 0, c - 1, (c * c - 1) / 12)
        assert (s.ball_y == 0).all() and (s.paddle_x == c // 2).all() and s.ball_x.dtype == torch.int32
        assert torch.bincount(s.ball_x.long(), minlength=c).min() > 0
    else:
        mean_ok(s.action_map, 0, 1, 0.25)
        assert s.action_map.shape == (n, tparams.size) and s.action_map.dtype == torch.int32
        assert (s.row == 0).all() and (s.column == 0).all()


def _jax_names():
    jregistry._populate()
    return sorted(jregistry._REGISTRY)


def _space_key(space, jax_side):
    """(kind, shape or n, low, high) of a space, lows and highs as float32."""
    discrete = jspaces.Discrete if jax_side else tspaces.Discrete
    if isinstance(space, discrete):
        return ("discrete", space.n)
    bound = lambda b: np.broadcast_to(np.asarray(b, np.float32), space.shape).tolist()  # noqa: E731
    return ("box", tuple(space.shape), bound(space.low), bound(space.high))


@pytest.mark.parametrize("name", _jax_names())
def test_registry_resolves_every_jax_name(name):
    """Every name of the JAX registry resolves in the port, to an env of the
    same class and name with the same observation and action spaces; the
    JAX registry's fallback to installed packages is not ported."""
    assert name in TORCH_REGISTRY
    jenv, jparams = jmake(name)
    tenv, tparams = tmake(name)
    assert type(tenv).__name__ == type(jenv).__name__ and tenv.name == jenv.name
    assert _space_key(tenv.action_space(tparams), False) == _space_key(jenv.action_space(jparams), True)
    assert _space_key(tenv.observation_space(tparams), False) == _space_key(jenv.observation_space(jparams), True)


def test_unknown_name_raises():
    with pytest.raises(ValueError, match="Unknown env"):
        tmake("NoSuchEnv-v0")


def test_jax_saved_acrobot_checkpoint_loads_into_the_port(tmp_path):
    """A JAX QNetwork at pqn_cartpole's width on Acrobot-v1 (6 obs, 3
    actions, H 256 x 2 with LayerNorm), saved by the JAX package's save_run
    as its CLI saves it, loads into the network the port's trainer builds
    for the same config; on 256 Acrobot observations (resets and random
    steps) the Q-values agree within 1e-5 and the greedy actions are the
    same."""
    from purejaxql_torch.core import checkpoint as tckpt
    from purejaxql_torch.core.config import compose
    from purejaxql_torch.models.factory import make_q_network
    from purejaxql_tpu.core import checkpoint as jckpt
    from purejaxql_tpu.models.qnet import QNetwork as JQNetwork

    config = compose(alg="pqn_cartpole", overrides=["ENV_NAME=Acrobot-v1", "DEVICE=cpu"])
    jnet = JQNetwork(action_dim=3, hidden_size=config["HIDDEN_SIZE"], num_layers=config["NUM_LAYERS"])
    variables = jax.jit(lambda k: jnet.init(k, jnp.zeros((1, 6)), train=False))(jax.random.PRNGKey(3))
    # the CLI saves the vmapped run's params, their seed axis stripped
    jckpt.save_run(jax.tree_util.tree_map(lambda x: x[None], variables["params"]), {"NUM_SEEDS": 1}, str(tmp_path),
                   "pqn_Acrobot-v1_seed0")
    tenv, tparams = tmake("Acrobot-v1")
    tnet = make_q_network(config, tenv.action_space(tparams).n, tenv.observation_space(tparams).shape)
    tnet.load_state_dict(tckpt.params_from_flax(tckpt.load_params(str(tmp_path / "pqn_Acrobot-v1_seed0.safetensors"))),
                         strict=False)
    g = torch.Generator().manual_seed(0)
    obs, state = tenv.reset(g, 256, tparams)
    for _ in range(30):
        obs, state, *_ = tenv.step(g, state, torch.randint(0, 3, (256,), generator=g), tparams)
    want = np.asarray(jax.jit(lambda v, o: jnet.apply(v, o, train=False))(variables, jnp.asarray(obs.numpy())))
    with torch.no_grad():
        got = tnet(obs, train=False).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
