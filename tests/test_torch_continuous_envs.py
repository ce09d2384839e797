"""The port's continuous-control envs on the CPU against the JAX package:
Reacher (dense, easy, hard), CartPoleSwingUp (its four tasks),
MountainCarContinuous, Hopper (hop, stand), Walker (walk, stand, run),
Pusher and BallInCup.

For every task: one step of `step_env` from a batch of random states, off
the reset distribution (Hopper's and Walker's in flight, in stance and just
before touchdown and liftoff), against JAX's vmapped `step_env`; a 100-step
run in which the port steps from JAX's state each time with JAX's own reset
draws, so that its auto-reset rows are held too; the spaces. For every
module: the reset from JAX's draws against JAX's reset, and the port's own
reset draws by their ranges and statistics. Ints equal, floats within 1e-5."""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from purejaxql_torch.envs import make as tmake
from purejaxql_torch.envs.classic import ball_in_cup as tbic
from purejaxql_torch.envs.classic import cartpole_swingup as tswing
from purejaxql_torch.envs.classic import hopper as thop
from purejaxql_torch.envs.classic import mountain_car_continuous as tmcc
from purejaxql_torch.envs.classic import pusher as tpush
from purejaxql_torch.envs.classic import reacher as treach
from purejaxql_torch.envs.classic import walker as twalk
from purejaxql_torch.envs.base import NO_DRAWS
from purejaxql_tpu.envs import make as jmake

torch.set_num_threads(1)

TASKS = (
    "Reacher-v0", "ReacherEasy-v0", "ReacherHard-v0",
    "CartPoleSwingUp-v0", "CartPoleSwingUpSparse-v0", "CartpoleBalance-v0", "CartpoleBalanceSparse-v0",
    "MountainCarContinuous-v0", "Hopper-v0", "HopperStand-v0", "Walker-v0", "WalkerStand-v0", "WalkerRun-v0",
    "Pusher-v0", "BallInCup-v0",
)
SPACES = {  # obs dim, action dim
    "Reacher": (10, 2), "CartPole": (5, 1), "Cartpole": (5, 1), "MountainCar": (2, 1), "Hopper": (8, 2),
    "Walker": (13, 4), "Pusher": (18, 2), "BallInCup": (8, 2),
}
# the port's module of each task, whose draw_start the reset reads
MODULES = {"Reacher": treach, "CartPole": tswing, "Cartpole": tswing, "MountainCar": tmcc, "Hopper": thop,
           "Walker": twalk, "Pusher": tpush, "BallInCup": tbic}


def _family(name):
    return next(k for k in SPACES if name.startswith(k))


# ---- random states off the reset distribution ----------------------------------------


def _times(r, n, limit):
    time = r.randint(0, limit, n)
    time[: n // 8] = limit - 1
    return time.astype(np.int32)


def _arm(r, n):
    return dict(theta=r.uniform(-3 * np.pi, 3 * np.pi, (n, 2)), theta_dot=r.uniform(-9, 9, (n, 2)))


def _tip(theta):
    t0, t1 = theta[:, 0], theta[:, 1]
    return np.stack([0.6 * np.cos(t0) + 0.4 * np.cos(t0 + t1), 0.6 * np.sin(t0) + 0.4 * np.sin(t0 + t1)], -1)


def _reacher(r, n):
    s = _arm(r, n)
    near = _tip(s["theta"]) + r.uniform(-0.3, 0.3, (n, 2))  # half the targets by the fingertip
    s["target"] = np.where(r.rand(n, 1) < 0.5, near, r.uniform(-1, 1, (n, 2)))
    return {**s, "time": _times(r, n, 150)}


def _pusher(r, n):
    s = _arm(r, n)
    # pucks within and just past the contact radius of the new fingertip,
    # and goals near the puck, so that contacts and goal hits occur
    tip = _tip(s["theta"])
    ang = r.uniform(-np.pi, np.pi, n)
    puck = tip + r.uniform(0.0, 0.45, n)[:, None] * np.stack([np.cos(ang), np.sin(ang)], -1)
    goal = puck + r.uniform(-0.15, 0.15, (n, 2))
    return {**s, "puck": puck, "puck_vel": r.uniform(-1, 1, (n, 2)), "goal": goal, "time": _times(r, n, 150)}


def _swingup(r, n):
    return dict(x=r.uniform(-2.6, 2.6, n), x_dot=r.uniform(-6, 6, n), theta=r.uniform(-2 * np.pi, 2 * np.pi, n),
                theta_dot=r.uniform(-10, 10, n), time=_times(r, n, 500))


def _mcc(r, n):
    pos = r.uniform(-1.25, 0.62, n)
    pos[: n // 8] = -1.2  # at the left wall
    return dict(position=pos, velocity=r.uniform(-0.075, 0.075, n), time=_times(r, n, 999))


def _slip(r, n, legs):
    """Bodies with each leg in flight or in stance: planted legs at their
    geometric length with rest lengths from below (just before liftoff when
    moving outward) to above it (compressed), swing legs at angles whose
    touchdown height lies around the body's."""
    z = r.uniform(0.3, 1.2, n)
    x = r.uniform(-1, 1, n)
    shape = (n, legs)
    stance = r.rand(*shape) < 0.5
    phi = r.uniform(-0.45, 0.45, shape)
    planted = z[:, None] / np.cos(phi)
    foot_x = np.where(stance, x[:, None] - z[:, None] * np.tan(phi), x[:, None] + r.uniform(-1, 1, shape))
    leg_rest = np.where(stance, planted + r.uniform(-0.03, 0.12, shape), r.uniform(0.6, 1.0, shape))
    leg_angle = np.where(stance, phi, r.uniform(-0.7, 0.7, shape))
    state = dict(x=x, z=z, vx=r.uniform(-2, 3, n), vz=r.uniform(-2.5, 2.0, n), leg_angle=leg_angle, foot_x=foot_x,
                 leg_rest=leg_rest, stance=stance, time=_times(r, n, 1000))
    if legs == 1:
        state.update({k: state[k][:, 0] for k in ("leg_angle", "foot_x", "leg_rest", "stance")})
    return state


def _ball_in_cup(r, n):
    cup = r.uniform(-0.65, 0.65, (n, 2))
    ang = r.uniform(-np.pi, np.pi, n)
    ball = cup + r.uniform(0.02, 0.32, n)[:, None] * np.stack([np.sin(ang), -np.cos(ang)], -1)
    cup_vel = r.uniform(-2, 2, (n, 2))
    ball_vel = cup_vel + r.uniform(-3, 3, (n, 2))
    # a quarter sitting in the mouth, slow relative to the cup
    k = n // 4
    ball[:k] = cup[:k] + np.stack([r.uniform(-0.04, 0.04, k), r.uniform(-0.05, -0.01, k)], -1)
    ball_vel[:k] = cup_vel[:k] + r.uniform(-0.5, 0.5, (k, 2))
    return dict(cup=cup, cup_vel=cup_vel, ball=ball, ball_vel=ball_vel, time=_times(r, n, 500))


SAMPLERS = {"Reacher": _reacher, "CartPole": _swingup, "Cartpole": _swingup, "MountainCar": _mcc,
            "Hopper": lambda r, n: _slip(r, n, 1), "Walker": lambda r, n: _slip(r, n, 2), "Pusher": _pusher,
            "BallInCup": _ball_in_cup}


def _jax_state(jenv, jparams, fields):
    """The JAX env's state dataclass from numpy fields (floats as float32)."""
    _, like = jax.vmap(jenv.reset_env, in_axes=(0, None))(jax.random.split(jax.random.PRNGKey(0), 2), jparams)
    cast = {k: jnp.asarray(v.astype(np.float32) if v.dtype == np.float64 else v) for k, v in fields.items()}
    return like.replace(**cast)


def _torch_state(tenv, js):
    """The port's state of a JAX state, field for field."""
    _, like = tenv.reset(torch.Generator(), 1)
    return dataclasses.replace(like, **{f.name: torch.tensor(np.asarray(getattr(js, f.name)))
                                        for f in dataclasses.fields(like)})


def _assert_state(ts, js, msg=""):
    for f in dataclasses.fields(ts):
        got, want = getattr(ts, f.name).numpy(), np.asarray(getattr(js, f.name))
        assert got.shape == want.shape, (msg, f.name)
        if got.dtype.kind in "biu":
            np.testing.assert_array_equal(got, want, f"{msg} {f.name}")
        else:
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=f"{msg} {f.name}")


@functools.lru_cache(maxsize=None)
def _jit_substep(name):
    jenv, p = jmake(name)
    return jax.jit(lambda s, a: jenv._substep(s, a, p))


def _at_phase_threshold(name, js, act, i):
    """Whether env ``i``'s step passes within 1e-5 of a SLIP phase threshold
    on JAX's own substeps (op by op): a leg in stance whose length meets its
    rest length (it does on the substep after every touchdown, as contact
    starts uncompressed) or whose radial speed crosses 0, or a swing leg
    whose touchdown height meets the body's or whose body's vertical speed
    crosses 0. A float difference of one bit (XLA's fused arithmetic, the
    trig functions' last bits) decides such a test either way."""
    jenv, p = jmake(name)
    substep = _jit_substep(name)
    s = jax.tree_util.tree_map(lambda x: x[i], js)
    a = jnp.clip(jnp.asarray(act[i]), -1.0, 1.0)
    legs = np.size(np.asarray(s.leg_angle))
    thrust = np.maximum(np.asarray(a[legs:], np.float64), 0.0)
    f64 = lambda st, k: np.atleast_1d(np.asarray(getattr(st, k), np.float64))  # noqa: E731
    for _ in range(p.substeps):
        nxt = substep(s, a)
        stance = np.atleast_1d(np.asarray(s.stance))
        lx = f64(s, "x") - f64(s, "foot_x")
        length = np.sqrt(lx**2 + f64(s, "z") ** 2) + 1e-8
        rest = f64(s, "leg_rest") + p.thrust_ext * thrust
        vr = (f64(s, "vx") * lx + f64(s, "vz") * f64(s, "z")) / length
        z, vz, cos_a = f64(nxt, "z"), f64(nxt, "vz"), np.cos(f64(nxt, "leg_angle"))
        liftoff = stance & (((np.abs(length - rest) < 1e-5) & (vr > -1e-5)) |
                            ((np.abs(vr) < 1e-5) & (length > rest - 1e-5)))
        touchdown = ~stance & (((np.abs(z - p.leg_length * cos_a) < 1e-5) & (vz < 1e-5)) |
                               ((np.abs(vz) < 1e-5) & (z < p.leg_length * cos_a + 1e-5)))
        if (liftoff | touchdown).any():
            return True
        s = nxt
    return False


def _assert_agrees(name, js, act, got, want, msg=""):
    """The port's outputs ``got`` (obs, reward, done, then the state fields)
    as JAX's ``want`` for every env: ints equal, floats within 1e-5. For
    Hopper and Walker an env may differ where its step passes a phase
    threshold within 1e-5 (``_at_phase_threshold``), at most 2 % of them."""
    n = act.shape[0]
    got = [g.numpy().reshape(n, -1) for g in got]
    want = [np.asarray(w).reshape(n, -1) for w in want]
    bad = np.zeros(n, bool)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, msg
        bad |= (g != w).any(1) if g.dtype.kind in "biu" else ~(np.abs(g - w) <= 1e-5).all(1)
    if _family(name) in ("Hopper", "Walker") and bad.any():
        assert bad.sum() <= max(1, n // 50), (msg, np.flatnonzero(bad))
        for i in np.flatnonzero(bad):
            assert _at_phase_threshold(name, js, act, i), (msg, f"env {i} differs off a phase threshold")
        return
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=f"{msg} output {k}")


def _outputs(obs, state, reward, done):
    return [obs, reward, done] + [getattr(state, f.name) for f in dataclasses.fields(state)]


@pytest.mark.parametrize("name", TASKS)
def test_step_from_random_states_matches_jax(name):
    """512 random states and actions (beyond the action box) through one
    `step_env`: obs, reward, done and every state field as JAX's, run op by
    op (vmapped, not jitted); the spaces as JAX's. The batch reaches each
    branch: episode ends, and for Hopper and Walker touchdowns, liftoffs
    and falls."""
    jenv, jparams = jmake(name)
    tenv, tparams = tmake(name)
    family = _family(name)
    n, r = 512, np.random.RandomState(TASKS.index(name))
    js = _jax_state(jenv, jparams, SAMPLERS[family](r, n))
    act = r.uniform(-1.5, 1.5, (n, SPACES[family][1])).astype(np.float32)
    jo, jst, jr, jd, _ = jax.vmap(jenv.step_env, in_axes=(None, 0, 0, None))(
        jax.random.PRNGKey(0), js, jnp.asarray(act), jparams)
    to, tst, tr, td, _ = tenv.step_env(_torch_state(tenv, js), torch.tensor(act), tparams, NO_DRAWS)
    _assert_agrees(name, js, act, _outputs(to, tst, tr, td), _outputs(jo, jst, jr, jd))
    assert 0 < td.sum() < n
    assert tr.dtype == torch.float32 and to.dtype == torch.float32
    if family in ("Hopper", "Walker"):
        before, after = np.asarray(js.stance), tst.stance.numpy()
        assert (~before & after).any() and (before & ~after).any() and (before & after).any()
        assert (tst.z.numpy() < tparams.min_height).any()
    if family in ("Pusher", "BallInCup") or name.endswith(("Easy-v0", "Hard-v0", "Sparse-v0")):
        assert (tr.numpy() > 0.5).any()  # a goal, a catch or a sparse reward is reached
    obs_dim, act_dim = SPACES[family]
    assert tenv.observation_space(tparams).shape == jenv.observation_space(jparams).shape == (obs_dim,)
    assert tenv.action_space(tparams).shape == jenv.action_space(jparams).shape == (act_dim,)
    tlow = np.asarray(tenv.action_space(tparams).low).reshape(-1)[0]
    assert tlow == np.asarray(jenv.action_space(jparams).low).reshape(-1)[0] == -1.0


def _jax_draws(family, key, jparams):
    """The draws the JAX env's `reset_env` makes from ``key``, in the port's
    `draw_start` layout."""
    u = jax.random.uniform
    if family == "Reacher":
        k_theta, k_target = jax.random.split(key)
        k_r, k_a = jax.random.split(k_target)
        return jnp.concatenate([u(k_theta, (2,), minval=-jnp.pi, maxval=jnp.pi),
                                u(k_r, (1,), minval=0.2, maxval=jparams.l1 + jparams.l2 - 0.05),
                                u(k_a, (1,), minval=-jnp.pi, maxval=jnp.pi)])
    if family in ("CartPole", "Cartpole"):
        k1, k2 = jax.random.split(key)
        return jnp.stack([u(k1, (), minval=-0.1, maxval=0.1), u(k2, (), minval=-0.1, maxval=0.1)])
    if family == "MountainCar":
        return u(key, (), minval=-0.6, maxval=-0.4)
    if family in ("Hopper", "Walker"):
        k1, k2 = jax.random.split(key)
        return jnp.stack([u(k1, (), minval=0.0, maxval=0.1), u(k2, (), minval=-0.1, maxval=0.1)])
    if family == "Pusher":
        k_theta, k_puck, k_goal = jax.random.split(key, 3)
        reach = jparams.l1 + jparams.l2
        out = [u(k_theta, (2,), minval=-jnp.pi, maxval=jnp.pi)]
        for k, lo, hi in ((k_puck, 0.3, reach - 0.25), (k_goal, 0.25, 0.5)):
            k_r, k_a = jax.random.split(k)
            out += [u(k_r, (1,), minval=lo, maxval=hi), u(k_a, (1,), minval=-jnp.pi, maxval=jnp.pi)]
        return jnp.concatenate(out)
    k_ang, k_vel = jax.random.split(key)
    return jnp.concatenate([u(k_ang, (1,), minval=-0.4, maxval=0.4), jax.random.normal(k_vel, (2,))])


def _start(tenv, family, draws, tparams):
    """The port's reset state from draws."""
    if family in ("Reacher", "MountainCar"):
        return MODULES[family].start_state(draws)
    if family in ("CartPole", "Cartpole"):
        return tenv.start_state(draws)
    if family in ("Hopper", "Walker"):
        return tenv.start_state(draws, tparams)
    return MODULES[family].start_state(draws, tparams)


MODULE_TASKS = ("Reacher-v0", "CartPoleSwingUp-v0", "CartpoleBalance-v0", "MountainCarContinuous-v0", "Hopper-v0",
                "Walker-v0", "Pusher-v0", "BallInCup-v0")


def _jax_reset(jenv, jparams, keys):
    return jax.vmap(jenv.reset_env, in_axes=(0, None))(keys, jparams)


@pytest.mark.parametrize("name", MODULE_TASKS)
def test_run_with_auto_resets_matches_jax(name, monkeypatch):
    """100 steps of 32 envs under random actions, started from JAX resets at
    random times (so that episodes end in the run): each step the port's
    `step` takes JAX's state and, for its auto-reset, the draws JAX's `step`
    makes from the second half of its key; obs, reward, done and the state
    (reset rows included) as JAX's at every step."""
    jenv, jparams = jmake(name)
    tenv, tparams = tmake(name)
    family = _family(name)
    n, steps = 32, 100
    r = np.random.RandomState(100 + TASKS.index(name))
    _, js = _jax_reset(jenv, jparams, jax.random.split(jax.random.PRNGKey(1), n))
    js = js.replace(time=jnp.asarray(r.randint(0, jparams.max_steps_in_episode, n).astype(np.int32)))
    js = jax.tree_util.tree_map(lambda x: jnp.array(x, dtype=x.dtype), js)  # strong types: one compile of `step`
    step = jax.jit(jax.vmap(lambda k, st, a: jenv.step(k, st, a, jparams)))
    draws_of = jax.jit(jax.vmap(lambda k: _jax_draws(family, jax.random.split(k)[1], jparams)))
    holder = {}
    monkeypatch.setattr(MODULES[family], "draw_start", lambda *a: holder["draws"])
    ended = 0
    for t in range(steps):
        keys = jax.random.split(jax.random.PRNGKey(1000 + t), n)
        act = r.uniform(-1.2, 1.2, (n, SPACES[family][1])).astype(np.float32)
        holder["draws"] = torch.tensor(np.asarray(draws_of(keys)))
        jo, js_next, jr, jd, _ = step(keys, js, jnp.asarray(act))
        to, tst, tr, td, _ = tenv.step(torch.Generator(), _torch_state(tenv, js), torch.tensor(act), tparams)
        _assert_agrees(name, js, act, _outputs(to, tst, tr, td), _outputs(jo, js_next, jr, jd), f"step {t}")
        ended += int(td.sum())
        js = js_next
    assert ended > 0


@pytest.mark.parametrize("name", MODULE_TASKS)
def test_reset_matches_jax_and_its_draws_their_ranges(name):
    """JAX's `reset_env` from 64 keys and the port's `start_state` from the
    same keys' draws give the same obs and state; the port's own reset of
    100k envs draws each value in its range with its mean and variance
    (within 5 standard errors, 3 % on the variance)."""
    jenv, jparams = jmake(name)
    tenv, tparams = tmake(name)
    family = _family(name)
    keys = jax.random.split(jax.random.PRNGKey(5), 64)
    jo, js = _jax_reset(jenv, jparams, keys)
    draws = torch.tensor(np.asarray(jax.vmap(lambda k: _jax_draws(family, k, jparams))(keys)))
    ts = _start(tenv, family, draws, tparams)
    _assert_state(ts, js)
    np.testing.assert_allclose(tenv.get_obs(ts, tparams).numpy() if family in ("Reacher", "Pusher", "BallInCup")
                               else tenv.get_obs(ts).numpy(), np.asarray(jo), atol=1e-5, rtol=0)

    n = 100_000
    obs, s = tenv.reset(torch.Generator().manual_seed(0), n, tparams)
    assert obs.shape == (n, SPACES[family][0]) and (s.time == 0).all()

    def uniform_ok(x, lo, hi):
        x = x.double()
        assert lo <= x.min() and x.max() < hi
        mean, var = (lo + hi) / 2, (hi - lo) ** 2 / 12
        assert abs(x.mean().item() - mean) < 5 * math.sqrt(var / x.numel())
        assert abs(x.var().item() / var - 1) < 0.03

    if family == "Reacher":
        uniform_ok(s.theta, -math.pi, math.pi)
        uniform_ok(s.target.norm(dim=-1), 0.2 - 1e-6, 0.95 + 1e-6)
        uniform_ok(torch.atan2(s.target[:, 1], s.target[:, 0]), -math.pi - 1e-6, math.pi + 1e-6)
    elif family in ("CartPole", "Cartpole"):
        uniform_ok(s.x, -0.1, 0.1)
        uniform_ok(s.theta - (0.0 if "Balance" in name else math.pi), -0.1 - 1e-6, 0.1 + 1e-6)
        assert (s.x_dot == 0).all() and (s.theta_dot == 0).all()
    elif family == "MountainCar":
        uniform_ok(s.position, -0.6, -0.4)
    elif family in ("Hopper", "Walker"):
        uniform_ok(s.z, 1.05 - 1e-6, 1.15 + 1e-6)
        uniform_ok(s.vx, -0.1, 0.1)
        assert not s.stance.any() and (s.leg_rest == 1.0).all() and (s.x == 0).all()
    elif family == "Pusher":
        uniform_ok(s.theta, -math.pi, math.pi)
        uniform_ok(s.puck.norm(dim=-1), 0.3 - 1e-6, 0.75 + 1e-6)
        assert s.goal.norm(dim=-1).max() <= 0.9 + 1e-5
        gap = (s.goal - s.puck).norm(dim=-1)
        assert gap.max() <= 0.5 + 1e-5 and (gap > 0.25).float().mean() > 0.9
    else:
        uniform_ok(torch.atan2(s.ball[:, 0], -s.ball[:, 1]), -0.4 - 1e-6, 0.4 + 1e-6)
        torch.testing.assert_close(s.ball.norm(dim=-1), torch.full((n,), 0.3), atol=1e-6, rtol=0)
        v = s.ball_vel.double()
        assert (v.mean(0).abs() < 5 * 0.1 / math.sqrt(n)).all()
        assert ((v.std(0) / 0.1 - 1).abs() < 0.01).all()
