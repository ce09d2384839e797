"""The port's dm-suite domains on the CPU against the JAX package, every
task: AcrobotSwingup (dense, sparse), PointMass, SwimmerSwimmer6,
CheetahRun, Finger (spin, turn_easy, turn_hard) and FishSwim.

For every task: one `step_env` from a batch of random states off the reset
distribution (rows at max_steps - 1 among them; walls, joint limits and
stops, contacts, legs in stance and in flight, falls) against JAX's step
run op by op (vmapped, not jitted), and the spaces. For every module (one
task each, the tasks of a module differing in their reward alone): a
100-step run in which the port steps from JAX's state each time with JAX's
own reset draws, so that its auto-reset rows are held too, against JAX's
step_env and reset_env jitted once a task; the reset from JAX's draws, and
the port's own draws by their ranges. JAX saved weights at CheetahRun's
widths load into the port. Ints equal, floats within 1e-5, but for Swimmer (see
SWIMMER_ATOL)."""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from purejaxql_torch.envs import make as tmake
from purejaxql_torch.envs.base import NO_DRAWS
from purejaxql_torch.envs.classic import acrobot as tacro
from purejaxql_torch.envs.classic import cheetah as tcheetah
from purejaxql_torch.envs.classic import finger as tfinger
from purejaxql_torch.envs.classic import fish as tfish
from purejaxql_torch.envs.classic import point_mass as tpm
from purejaxql_torch.envs.classic import swimmer as tswim
from purejaxql_tpu.envs import make as jmake

torch.set_num_threads(1)

TASKS = ("AcrobotSwingup-v0", "AcrobotSwingupSparse-v0", "PointMass-v0", "SwimmerSwimmer6-v0", "CheetahRun-v0",
         "FingerSpin-v0", "FingerTurnEasy-v0", "FingerTurnHard-v0", "FishSwim-v0")
MODULE_TASKS = ("AcrobotSwingup-v0", "PointMass-v0", "SwimmerSwimmer6-v0", "CheetahRun-v0", "FingerTurnEasy-v0",
                "FishSwim-v0")
SPACES = {"Acrobot": (6, 1), "PointMass": (4, 2), "Swimmer": (10, 5), "Cheetah": (26, 8), "Finger": (13, 2),
          "Fish": (12, 3)}
# the module whose draw_start each family's reset reads
MODULES = {"Acrobot": tacro, "PointMass": tpm, "Swimmer": tswim, "Cheetah": tcheetah, "Finger": tfinger,
           "Fish": tfish}
# Swimmer's bound: each substep solves two 3 x 3 systems M z = b, whose LU
# (LAPACK's getrf in torch, XLA's own solve in JAX) rounds differently; M's
# condition number reaches ~480 on the random states, so a float32
# round-off of ~1e-7 in M and b moves z by up to ~5e-5, and the body
# velocity in the obs with it. Measured: at most 1.1e-5 on the one step,
# 1.8e-5 over the 100-step run
SWIMMER_ATOL = 5e-5


def _family(name):
    return next(k for k in SPACES if name.startswith(k))


@functools.lru_cache(maxsize=None)
def _envs(name):
    """The JAX env and params, the port's, and JAX's step_env and reset_env
    vmapped and jitted once, and its step_env vmapped alone."""
    jenv, jparams = jmake(name)
    tenv, tparams = tmake(name)
    step = lambda k, s, a: jenv.step_env(k, s, a, jparams)  # noqa: E731
    reset = jax.jit(jax.vmap(lambda k: jenv.reset_env(k, jparams)))
    return jenv, jparams, tenv, tparams, jax.jit(jax.vmap(step)), reset, jax.vmap(step)


# ---- random states off the reset distribution ----------------------------------------


def _times(r, n, limit):
    time = r.randint(0, limit, n)
    time[: n // 8] = limit - 1
    return time.astype(np.int32)


def _acrobot(r, n, p):
    return dict(joint_angle1=r.uniform(-np.pi, np.pi, n), joint_angle2=r.uniform(-np.pi, np.pi, n),
                velocity_1=r.uniform(-p.max_vel_1, p.max_vel_1, n),
                velocity_2=r.uniform(-p.max_vel_2, p.max_vel_2, n), time=_times(r, n, 500))


def _point_mass(r, n, p):
    pos = r.uniform(-1, 1, (n, 2))
    pos[: n // 8, 0] = 1.0  # at a wall
    pos[n // 8: n // 4] *= 0.2  # by the target
    return dict(pos=pos, vel=r.uniform(-2, 2, (n, 2)), time=_times(r, n, 250))


def _swimmer(r, n, p):
    phi = r.uniform(-1.7, 1.7, (n, 5))
    lim = r.rand(n, 5) < 0.15
    phi[lim] = np.sign(phi[lim]) * 1.7  # at a joint limit
    nose = r.uniform(-1, 1, (n, 2))
    target = np.where(r.rand(n, 1) < 0.25, nose + r.uniform(-0.3, 0.3, (n, 2)), r.uniform(-1, 1, (n, 2)))
    return dict(nose=nose, theta=r.uniform(-np.pi, np.pi, n), phi=phi, body_vel=r.uniform(-1, 1, (n, 3)),
                target=target, time=_times(r, n, 500))


def _cheetah(r, n, p):
    """Bodies with each leg in flight or in stance: planted legs at their
    hip's geometric length with rest lengths from below (just before
    liftoff when moving outward) to above it, swing legs at angles whose
    touchdown height lies around their hip's; some bodies low or pitched
    past the limits."""
    z = r.uniform(0.25, 1.1, n)
    pitch = r.uniform(-0.4, 0.4, n)
    pitch[: n // 16] = r.choice([-1.05, 1.05], n // 16)
    x = r.uniform(-1, 1, n)
    h = np.array([1.0, 1.0, -1.0, -1.0]) * p.body_half
    hx, hz = x[:, None] + h * np.cos(pitch)[:, None], z[:, None] + h * np.sin(pitch)[:, None]
    stance = (r.rand(n, 4) < 0.5) & (hz > 0.05)
    phi = r.uniform(-0.45, 0.45, (n, 4))
    planted = hz / np.cos(phi)
    foot_x = np.where(stance, hx - hz * np.tan(phi), hx + r.uniform(-1, 1, (n, 4)))
    leg_rest = np.where(stance, planted + r.uniform(-0.03, 0.12, (n, 4)), r.uniform(0.5, 0.9, (n, 4)))
    leg_angle = np.where(stance, phi, r.uniform(-0.7, 0.7, (n, 4)))
    return dict(x=x, z=z, vx=r.uniform(-2, 4, n), vz=r.uniform(-2.5, 2.0, n), pitch=pitch,
                omega=r.uniform(-3, 3, n), leg_angle=leg_angle, foot_x=foot_x, leg_rest=leg_rest, stance=stance,
                time=_times(r, n, 1000))


def _finger(r, n, p):
    """Joint angles that put the fingertip inside the spinner's rim in
    about a third of the states (contacts), joints at their stops."""
    q = r.uniform(-2, 2, (n, 2))
    k = n // 3
    q[:k] = np.array([0.95, 0.9]) + r.uniform(-0.35, 0.35, (k, 2))  # the tip about the hinge (0.18, -0.18)
    q[k: k + n // 16, 1] = 2.0
    return dict(q=q, qd=r.uniform(-20, 20, (n, 2)), spin=r.uniform(-np.pi, np.pi, n),
                spin_vel=r.uniform(-15, 15, n), target=r.uniform(-np.pi, np.pi, n), time=_times(r, n, 1000))


def _fish(r, n, p):
    x, y = r.uniform(-2, 2, n), r.uniform(-2, 2, n)
    x[: n // 16] = 2.0  # at the arena's edge
    target = np.stack([x, y], -1) + r.uniform(-0.2, 0.2, (n, 2))  # a quarter by the target
    target[n // 4:] = r.uniform(-1.6, 1.6, (n - n // 4, 2))
    return dict(x=x, y=y, heading=r.uniform(-2 * np.pi, 2 * np.pi, n), vx=r.uniform(-1, 1, n), vy=r.uniform(-1, 1, n),
                omega=r.uniform(-3, 3, n), tail=r.uniform(-1, 1, n), tail_vel=r.uniform(-14, 14, n), target=target,
                time=_times(r, n, 1000))


SAMPLERS = {"Acrobot": _acrobot, "PointMass": _point_mass, "Swimmer": _swimmer, "Cheetah": _cheetah,
            "Finger": _finger, "Fish": _fish}


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


def _assert_agrees(name, got, want, msg=""):
    """The port's outputs ``got`` (obs, reward, done, then the state fields)
    as JAX's ``want``: ints equal, floats within 1e-5 (Swimmer's
    SWIMMER_ATOL)."""
    atol = SWIMMER_ATOL if _family(name) == "Swimmer" else 1e-5
    for k, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (msg, k, g.shape, w.shape, g.dtype, w.dtype)
        if g.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, f"{msg} output {k}")
        else:
            np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=f"{msg} output {k}")


def _outputs(obs, state, reward, done):
    return [obs, reward, done] + [getattr(state, f.name) for f in dataclasses.fields(state)]


@pytest.mark.parametrize("name", TASKS)
def test_step_from_random_states_matches_jax(name):
    """512 random states and actions (beyond the action box) through one
    `step_env`: obs, reward, done and every state field as JAX's; the
    spaces as JAX's. The batch reaches each branch: episode ends, walls,
    joint limits and stops, contacts, touchdowns, liftoffs and falls."""
    jenv, jparams, tenv, tparams, _, reset, step = _envs(name)
    family = _family(name)
    n, r = 512, np.random.RandomState(TASKS.index(name))
    js = _jax_state(reset, SAMPLERS[family](r, n, jparams))
    act = r.uniform(-1.5, 1.5, (n, SPACES[family][1])).astype(np.float32)
    jo, jst, jr, jd, _ = step(jax.random.split(jax.random.PRNGKey(0), n), js, jnp.asarray(act))
    to, tst, tr, td, _ = tenv.step_env(_torch_state(tenv, tparams, js), torch.tensor(act), tparams, NO_DRAWS)
    _assert_agrees(name, _outputs(to, tst, tr, td), _outputs(jo, jst, jr, jd))
    assert 0 < td.sum() < n and tr.dtype == torch.float32 and to.dtype == torch.float32
    if family == "Cheetah":
        before, after = np.asarray(js.stance), tst.stance.numpy()
        assert (~before & after).any() and (before & ~after).any() and (before & after).any()
        assert (tst.z.numpy() < tparams.min_height).any() and (tst.pitch.abs().numpy() > tparams.max_pitch).any()
    if family == "Finger":
        rel = tfinger.tip(_torch_state(tenv, tparams, js).q, tparams) - torch.tensor([tparams.cx, tparams.cy])
        assert (tpm.norm2(rel) < tparams.radius).float().mean() > 0.1  # contacts
    if family == "PointMass":
        assert (tst.vel.numpy() == 0).any() and (tr.numpy() > 0.5).any()
    if family == "Swimmer":
        assert (tst.phi.abs().numpy() == tparams.joint_limit).any()
    if name.endswith("Sparse-v0") or family == "Fish":
        assert (tr.numpy() > 0.9).any()  # a sparse reward, a fish inside its target
    obs_dim, act_dim = SPACES[family]
    assert tenv.observation_space(tparams).shape == jenv.observation_space(jparams).shape == (obs_dim,)
    assert tenv.action_space(tparams).shape == jenv.action_space(jparams).shape == (act_dim,)
    for bound in ("low", "high"):
        np.testing.assert_array_equal(np.asarray(getattr(tenv.observation_space(tparams), bound), np.float32),
                                      np.asarray(getattr(jenv.observation_space(jparams), bound), np.float32))
        np.testing.assert_array_equal(np.asarray(getattr(tenv.action_space(tparams), bound), np.float32),
                                      np.asarray(getattr(jenv.action_space(jparams), bound), np.float32))


def _jax_draws(family, key, jparams):
    """The draws the JAX env's `reset_env` makes from ``key``, in the port's
    `draw_start` layout."""
    u = jax.random.uniform
    if family == "Acrobot":
        return u(key, (4,), minval=-0.1, maxval=0.1)
    if family == "PointMass":
        return u(key, (2,), minval=-0.8, maxval=0.8)
    if family == "Cheetah":
        k1, k2 = jax.random.split(key)
        return jnp.stack([u(k1, (), minval=0.0, maxval=0.1), u(k2, (), minval=-0.1, maxval=0.1)])
    k1, k2, k3 = jax.random.split(key, 3)
    if family == "Swimmer":
        return jnp.concatenate([u(k1, (1,), minval=0.4, maxval=0.8), u(k2, (1,), minval=-jnp.pi, maxval=jnp.pi),
                                u(k3, (5,), minval=-0.3, maxval=0.3)])
    if family == "Finger":
        return jnp.concatenate([u(k1, (2,), minval=-0.3, maxval=0.3), u(k2, (1,), minval=-jnp.pi, maxval=jnp.pi),
                                u(k3, (1,), minval=-jnp.pi, maxval=jnp.pi)])
    arena = jparams.arena
    return jnp.concatenate([u(k1, (2,), minval=-0.5, maxval=0.5), u(k2, (1,), minval=-jnp.pi, maxval=jnp.pi),
                            u(k3, (2,), minval=-0.8 * arena, maxval=0.8 * arena)])


def _start(tenv, family, draws, tparams):
    """The port's reset state from draws."""
    if family == "Cheetah":
        return tenv.start_state(draws, tparams)
    if family == "Finger":
        return tenv.start_state(draws)
    return MODULES[family].start_state(draws)


@pytest.mark.parametrize("name", MODULE_TASKS)
def test_run_with_auto_resets_matches_jax(name, monkeypatch):
    """100 steps of 32 envs under random actions, started from JAX resets at
    random times (so that episodes end in the run): each step the port's
    `step` takes JAX's state and, for its auto-reset, the draws JAX's reset
    makes from the second half of the step's key (base.py:75-84); obs,
    reward, done and the state (reset rows included) as JAX's every step."""
    jenv, jparams, tenv, tparams, step, reset, _ = _envs(name)
    family = _family(name)
    n, steps = 32, 100
    r = np.random.RandomState(100 + TASKS.index(name))
    _, js = reset(jax.random.split(jax.random.PRNGKey(1), n))
    js = js.replace(time=jnp.asarray(r.randint(0, jparams.max_steps_in_episode, n).astype(np.int32)))
    js = jax.tree_util.tree_map(lambda x: jnp.array(x, dtype=x.dtype), js)  # strong types: one compile of `step`
    split = jax.jit(jax.vmap(jax.random.split))
    draws_of = jax.jit(jax.vmap(lambda k: _jax_draws(family, k, jparams)))
    holder = {}
    monkeypatch.setattr(MODULES[family], "draw_start", lambda *a: holder["draws"])
    ended = 0
    for t in range(steps):
        keys = split(jax.random.split(jax.random.PRNGKey(1000 + t), n))
        act = r.uniform(-1.2, 1.2, (n, SPACES[family][1])).astype(np.float32)
        jo, jst, jr, jd, _ = step(keys[:, 0], js, jnp.asarray(act))
        jo_re, js_re = reset(keys[:, 1])
        sel = lambda re, st: jnp.where(jd.reshape(jd.shape + (1,) * (st.ndim - 1)), re, st)  # noqa: E731
        js_next = jax.tree_util.tree_map(sel, js_re, jst)
        holder["draws"] = torch.tensor(np.asarray(draws_of(keys[:, 1])))
        to, tst, tr, td, _ = tenv.step(torch.Generator(), _torch_state(tenv, tparams, js), torch.tensor(act), tparams)
        _assert_agrees(name, _outputs(to, tst, tr, td), _outputs(sel(jo_re, jo), js_next, jr, jd), f"step {t}")
        ended += int(td.sum())
        js = js_next
    assert ended > 0


@pytest.mark.parametrize("name", MODULE_TASKS)
def test_reset_matches_jax_and_its_draws_their_ranges(name):
    """JAX's `reset_env` from 64 keys and the port's `start_state` from the
    same keys' draws give the same obs and state; the port's own reset of
    100k envs draws each value in its range with its mean and variance
    (within 5 standard errors, 3 % on the variance)."""
    jenv, jparams, tenv, tparams, _, reset, _ = _envs(name)
    family = _family(name)
    keys = jax.random.split(jax.random.PRNGKey(5), 64)
    jo, js = reset(keys)
    draws = torch.tensor(np.asarray(jax.vmap(lambda k: _jax_draws(family, k, jparams))(keys)))
    ts = _start(tenv, family, draws, tparams)
    _assert_agrees(name, _outputs(tenv.get_obs(ts, tparams), ts, torch.zeros(64), torch.zeros(64, dtype=torch.bool)),
                   _outputs(jo, js, np.zeros(64, np.float32), np.zeros(64, bool)))

    n = 100_000
    obs, s = tenv.reset(torch.Generator().manual_seed(0), n, tparams)
    assert obs.shape == (n, SPACES[family][0]) and (s.time == 0).all()

    def uniform_ok(x, lo, hi):
        x = x.double()
        assert lo <= x.min() and x.max() < hi
        mean, var = (lo + hi) / 2, (hi - lo) ** 2 / 12
        assert abs(x.mean().item() - mean) < 5 * math.sqrt(var / x.numel())
        assert abs(x.var().item() / var - 1) < 0.03

    if family == "Acrobot":
        for x in (s.joint_angle1, s.joint_angle2, s.velocity_1, s.velocity_2):
            uniform_ok(x, -0.1, 0.1)
    elif family == "PointMass":
        uniform_ok(s.pos, -0.8, 0.8)
        assert (s.vel == 0).all()
    elif family == "Swimmer":
        uniform_ok(s.target.norm(dim=-1), 0.4 - 1e-6, 0.8 + 1e-6)
        uniform_ok(torch.atan2(s.target[:, 1], s.target[:, 0]), -math.pi - 1e-6, math.pi + 1e-6)
        uniform_ok(s.phi, -0.3, 0.3)
        assert (s.nose == 0).all() and (s.theta == 0).all() and (s.body_vel == 0).all()
    elif family == "Cheetah":
        uniform_ok(s.z, 0.95 - 1e-6, 1.05 + 1e-6)
        uniform_ok(s.vx, -0.1, 0.1)
        assert not s.stance.any() and (s.leg_rest == tparams.leg_length).all() and (s.x == 0).all()
        assert torch.equal(s.leg_angle[0], torch.tensor([0.15, 0.05, -0.05, -0.15]))
    elif family == "Finger":
        uniform_ok(s.q, -0.3, 0.3)
        uniform_ok(s.spin, -math.pi, math.pi)
        uniform_ok(s.target, -math.pi, math.pi)
        assert (tmake("FingerSpin-v0")[0].reset(torch.Generator(), 8)[1].target == 0).all()
    else:
        uniform_ok(torch.stack([s.x, s.y], -1), -0.5, 0.5)
        uniform_ok(s.heading, -math.pi, math.pi)
        uniform_ok(s.target, -1.6, 1.6)


def test_jax_saved_cheetah_checkpoint_loads_into_the_port(tmp_path):
    """A JAX actor and critic ensemble at pqn_dm_suite's width on CheetahRun
    (26 obs, 8 actions, actor and two critics H 256 x 2 with LayerNorm),
    saved by the JAX package's save_run as its CLI saves the {"actor",
    "critic"} tree, loads into the port's networks through load_ac_params;
    on 128 CheetahRun observations (resets and random steps) the actions
    and each critic's values agree within 1e-5."""
    from purejaxql_torch.core import checkpoint as tckpt
    from purejaxql_torch.core.config import compose
    from purejaxql_torch.models.actor_critic import Actor, CriticEnsemble
    from purejaxql_tpu.core import checkpoint as jckpt
    from purejaxql_tpu.models.actor_critic import Actor as JActor
    from purejaxql_tpu.models.actor_critic import Critic as JCritic

    config = compose(alg="pqn_dm_suite", overrides=["ENV_NAME=CheetahRun-v0", "DEVICE=cpu"])
    tenv, tparams = tmake("CheetahRun-v0")
    obs_dim, act_dim = tenv.observation_space(tparams).shape[0], tenv.action_space(tparams).shape[0]
    a_h, c_h = tuple(config["ACTOR_HIDDEN_SIZES"]), tuple(config["CRITIC_HIDDEN_SIZES"])
    jactor = JActor(act_dim, action_scale=jnp.asarray(1.0), action_bias=jnp.asarray(0.0), hidden_sizes=a_h,
                    norm_type=config["NORM_TYPE"])
    jcritic = JCritic(hidden_sizes=c_h, norm_type=config["NORM_TYPE"])
    av = jax.jit(jactor.init)(jax.random.PRNGKey(1), jnp.zeros(obs_dim))
    cv = jax.jit(jax.vmap(jcritic.init, in_axes=(0, None, None)))(
        jax.random.split(jax.random.PRNGKey(2), 2), jnp.zeros(obs_dim), jnp.zeros(act_dim))
    params = {"actor": av["params"], "critic": cv["params"]}
    # the CLI saves the vmapped run's tree, its seed axis stripped
    jckpt.save_run(jax.tree_util.tree_map(lambda x: x[None], params), {"NUM_SEEDS": 1}, str(tmp_path), "ac")
    actor = Actor(obs_dim, act_dim, 1.0, 0.0, list(a_h), norm_type=config["NORM_TYPE"])
    critics = CriticEnsemble(config["NUM_CRITICS"], obs_dim, act_dim, list(c_h), norm_type=config["NORM_TYPE"])
    tckpt.load_ac_params(tckpt.load_params(str(tmp_path / "ac.safetensors")), actor, critics)
    g = torch.Generator().manual_seed(0)
    obs, state = tenv.reset(g, 128, tparams)
    for _ in range(10):
        obs, state, *_ = tenv.step(g, state, torch.rand(128, act_dim, generator=g) * 2 - 1, tparams)
    o = jnp.asarray(obs.numpy())
    ja = jax.jit(lambda v: jactor.apply(v, o, train=False))(av)
    jv = jax.jit(jax.vmap(lambda v: jcritic.apply(v, o, ja, train=False)))(cv)
    with torch.no_grad():
        ta = actor(obs, train=False)
        tv = critics(obs, ta, train=False)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv).reshape(tv.shape), atol=1e-5, rtol=0)
