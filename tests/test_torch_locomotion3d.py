"""The port's 3D legged locomotion (envs/classic/locomotion3d.py) on the CPU
against the JAX package: the Quadruped and the Biped3D, every task of each,
every robot preset, flat and rough terrain.

For every (class, task) pair and each robot preset at one task: one
`step_env` from a batch of random states (rows at max_steps - 1, legs in
stance and in flight, getup starts, low and pitched bodies) against JAX's
step run op by op (`_jax_step_op_by_op`), and the spaces; the reset from
JAX's draws, and the port's own draws by their ranges. JAX's step_env runs
its 16 substeps in a lax.scan, whose body XLA compiles as one program even
outside jit: at a touchdown on rough terrain that program is 3.8e-5 off
JAX's own op-by-op step (the same step under jax.disable_jit; the port 6.2e-6
off the latter), so the one step is held to JAX's ops one at a time
(OP_BY_OP). For the Quadruped and the Biped3D: a 100-step run in which the
port steps from JAX's state each time with JAX's own reset draws, so that
its auto-reset rows are held too, against JAX's step_env and reset_env
jitted once. JAX saved weights at
pqn_locomotion's widths on Go1JoystickFlatTerrain load into the port. Ints
equal, floats within 1e-5, the Quadruped's turn rates within RATE_ATOL."""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from purejaxql_torch.envs.base import NO_DRAWS
from purejaxql_torch.envs.classic import locomotion3d as tloco
from purejaxql_tpu.envs.classic import locomotion3d as jloco

torch.set_num_threads(1)

# (class, task, robot): every task of each class, each robot preset once,
# rough terrain on both classes
CASES = (
    ("Quadruped", "joystick", "go1"), ("Quadruped", "joystick_rough", "go1"), ("Quadruped", "getup", "go1"),
    ("Quadruped", "handstand", "go1"), ("Quadruped", "footstand", "go1"), ("Quadruped", "walk", "go1"),
    ("Quadruped", "run", "go1"), ("Quadruped", "stand", "go1"), ("Quadruped", "inplace", "spot"),
    ("Quadruped", "joystick", "barkour"),
    ("Biped3D", "joystick", "g1"), ("Biped3D", "joystick_rough", "berkeley"), ("Biped3D", "inplace", "h1"),
    ("Biped3D", "stand", "humanoid"), ("Biped3D", "walk", "humanoid"), ("Biped3D", "run", "humanoid"),
    ("Biped3D", "joystick", "t1"), ("Biped3D", "joystick", "apollo"), ("Biped3D", "joystick", "op3"),
)
# the auto-reset runs: a quadruped task that draws every reset value, and a
# biped task that draws its turn command alone
RUN_CASES = (("Quadruped", "joystick", "go1"), ("Biped3D", "inplace", "h1"))
SPACES = {"Quadruped": (31, 12), "Biped3D": (21, 7)}
# the Quadruped's yaw and pitch rates (state fields, obs columns 6-7) and
# the reward, which reads them: a touchdown's foot point differs by one ulp
# of sin and cos (torch's against XLA's), and over the 16 substeps the foot
# anchor's 525 N/m on a yaw inertia of 0.25 (pitch 0.35) grows that to
# 1.53e-5 in the rates and 9.2e-6 in the reward (measured: the one step of
# every case at 4 seeds, footstand and stand the worst; the Biped3D's
# larger inertias keep it below 3e-6)
RATE_ATOL = 5e-5


def _case_id(case):
    return "-".join(case)


@functools.lru_cache(maxsize=None)
def _envs(case):
    """The JAX env and params, the port's, and JAX's reset_env vmapped (run
    op by op: one reset of a few envs costs less than its compile)."""
    cls, task, robot = case
    jenv = getattr(jloco, cls)(task=task, robot=robot)
    tenv = getattr(tloco, cls)(task=task, robot=robot)
    jparams, tparams = jenv.default_params, tenv.default_params
    return jenv, jparams, tenv, tparams, jax.vmap(lambda k: jenv.reset_env(k, jparams))


# ---- random states off the reset distribution ----------------------------------------


def _random_states(r, n, jenv, p, task):
    """Bodies from low (fallen) to above standing height, some pitched past
    max_pitch; each leg in stance with its foot near under its hip (the
    spring from slack to compressed, moving either way, so that liftoffs
    happen) or in flight at angles whose touchdown height lies around the
    hip's; an eighth of the rows at a getup start, an eighth at
    max_steps - 1."""
    L = jenv.n_legs
    hx, hy = (np.asarray(h, np.float64) for h in jenv._hips(p))
    leg = p.leg_length
    z = leg * r.uniform(0.3, 1.1, n)
    pitch = r.uniform(-0.5, 0.5, n)
    k = n // 16
    pitch[:k] = r.choice([-1.3, 1.3], k)
    x, y, yaw = r.uniform(-1, 1, n), r.uniform(-1, 1, n), r.uniform(-np.pi, np.pi, n)
    cy, sy, cp, sp = np.cos(yaw)[:, None], np.sin(yaw)[:, None], np.cos(pitch)[:, None], np.sin(pitch)[:, None]
    hip_x = x[:, None] + hx * cp * cy - hy * sy
    hip_y = y[:, None] + hx * cp * sy + hy * cy
    hip_z = z[:, None] + hx * sp
    stance = r.rand(n, L) < 0.5
    foot_x = np.where(stance, hip_x + leg * r.uniform(-0.3, 0.3, (n, L)), hip_x + r.uniform(-1, 1, (n, L)))
    foot_y = np.where(stance, hip_y + leg * r.uniform(-0.2, 0.2, (n, L)), hip_y + r.uniform(-1, 1, (n, L)))
    geometric = np.sqrt((hip_x - foot_x) ** 2 + (hip_y - foot_y) ** 2 + hip_z**2)
    leg_rest = np.where(stance, geometric + leg * r.uniform(-0.05, 0.15, (n, L)), leg * r.uniform(0.6, 1.0, (n, L)))
    sag = np.where(stance, r.uniform(-0.3, 0.3, (n, L)), r.uniform(-0.6, 0.6, (n, L)))
    lat = np.where(stance, r.uniform(-0.2, 0.2, (n, L)), r.uniform(-0.4, 0.4, (n, L)))
    command = np.stack([r.uniform(-0.3 * p.cmd_vx, p.cmd_vx, n), r.uniform(-p.cmd_vy, p.cmd_vy, n),
                        r.uniform(-p.cmd_yaw, p.cmd_yaw, n)], -1)
    time = r.randint(0, p.max_steps_in_episode, n)
    time[-n // 8:] = p.max_steps_in_episode - 1
    g = slice(k, k + n // 8)  # getup starts: low, unplanted, splayed
    z[g], stance[g], foot_x[g], foot_y[g] = 0.35 * leg, False, 0.0, 0.0
    sag[g] = np.where(np.arange(L) % 2 == 0, 0.08, -0.08)
    lat[g], leg_rest[g] = 0.0, leg
    return dict(x=x, y=y, z=z, vx=r.uniform(-1.5, 1.5, n), vy=r.uniform(-1.5, 1.5, n), vz=r.uniform(-1, 1, n),
                yaw=yaw, yaw_rate=r.uniform(-2, 2, n), pitch=pitch, pitch_rate=r.uniform(-2, 2, n), sag=sag, lat=lat,
                foot_x=foot_x, foot_y=foot_y, leg_rest=leg_rest, stance=stance, command=command,
                time=time.astype(np.int32))


def _jax_state(fields):
    """The JAX env's state dataclass from numpy fields (floats as float32)."""
    return jloco.Loco3DState(**{k: jnp.asarray(v.astype(np.float32) if v.dtype == np.float64 else v)
                                for k, v in fields.items()})


def _torch_state(tenv, tparams, js):
    """The port's state of a JAX state, field for field."""
    like = tenv.start_state(torch.zeros(1, 5), tparams)
    return dataclasses.replace(like, **{f.name: torch.tensor(np.asarray(getattr(js, f.name)))
                                        for f in dataclasses.fields(like)})


# XLA without its algebraic simplifier (which, among others, turns a division
# by a constant into a product with its reciprocal) and without fusion runs
# each op of a compiled program as JAX runs it op by op: one substep so
# compiled gave JAX's eager substep bit for bit on every case here
# (measured), in 9 s where the eager passes took 34
OP_BY_OP = {"xla_disable_hlo_passes": "algsimp,fusion"}
_FIELDS = [f.name for f in dataclasses.fields(tloco.Loco3DState)]
# the outputs the Quadruped holds to RATE_ATOL: the reward, the rates
_RATES = {1, 3 + _FIELDS.index("yaw_rate"), 3 + _FIELDS.index("pitch_rate")}


def _assert_agrees(cls, got, want, msg=""):
    """The port's outputs ``got`` (obs, reward, done, then the state fields)
    as JAX's ``want``: ints and bools equal, floats within 1e-5 (the
    Quadruped's rates and reward within RATE_ATOL)."""
    rates = cls == "Quadruped"
    for k, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (msg, k, g.shape, w.shape, g.dtype, w.dtype)
        if g.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, f"{msg} output {k}")
            continue
        atol = RATE_ATOL if rates and k in _RATES else 1e-5
        if k == 0 and rates:
            np.testing.assert_allclose(g[:, 6:8], w[:, 6:8], atol=RATE_ATOL, rtol=0, err_msg=f"{msg} obs rates")
            g, w = np.delete(g, [6, 7], 1), np.delete(w, [6, 7], 1)
        np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=f"{msg} output {k}")


def _outputs(obs, state, reward, done):
    return [obs, reward, done] + [getattr(state, f) for f in _FIELDS]


def _same_substeps(case):
    """The cases whose substeps are one program: the same class and robot
    preset on the same terrain (their tasks differ in the reward, the ends
    and the episode length alone)."""
    cls, task, robot = case
    rough = task == "joystick_rough"
    return tuple(c for c in CASES if c[0] == cls and c[2] == robot and (c[1] == "joystick_rough") == rough)


@functools.lru_cache(maxsize=None)
def _jax_substeps(group):
    """Each case's 512 random states and actions, and JAX's 16 substeps of
    them (locomotion3d.py:328-342, the scan unrolled), each substep vmapped
    and compiled OP_BY_OP; the group's rows go through in one pass, one
    compile a group."""
    states, acts = [], []
    for case in group:
        jenv, jparams = _envs(case)[:2]
        r = np.random.RandomState(CASES.index(case))
        states.append(_jax_state(_random_states(r, 512, jenv, jparams, case[1])))
        acts.append(r.uniform(-1.5, 1.5, (512, SPACES[case[0]][1])).astype(np.float32))
        assert dataclasses.replace(jparams, max_steps_in_episode=0) == dataclasses.replace(
            _envs(group[0])[1], max_steps_in_episode=0)
    jenv, jparams = _envs(group[0])[:2]
    cat = lambda *xs: jnp.concatenate(xs)  # noqa: E731
    s, a = jax.tree_util.tree_map(cat, *states), jnp.clip(cat(*acts), -1.0, 1.0)
    substep = jax.jit(jax.vmap(lambda s, a: jenv._substep(s, a, jparams))).lower(s, a).compile(
        compiler_options=OP_BY_OP)
    for _ in range(jparams.substeps):
        s = substep(s, a)
    rows = lambda k: jax.tree_util.tree_map(lambda x: x[512 * k: 512 * (k + 1)], s)  # noqa: E731
    return [(states[k], acts[k], rows(k)) for k in range(len(group))]


def _jax_step_op_by_op(case):
    """JAX's `step_env` (locomotion3d.py:328-349) on the case's random states
    and actions, every op run on its own (the substeps OP_BY_OP, the rest
    vmapped, not jitted): the states, the actions and (obs, state, reward,
    done)."""
    group = _same_substeps(case)
    js, act, s = _jax_substeps(group)[group.index(case)]
    jenv, jparams = _envs(case)[:2]
    a = jnp.clip(act, -1.0, 1.0)
    s = s.replace(time=js.time + 1)
    reward = jax.vmap(lambda s, a: jenv._reward(s, a, jparams))(s, a).astype(jnp.float32)
    done = jax.vmap(lambda s: jenv.is_terminal(s, jparams))(s)
    return js, act, (jax.vmap(lambda s: jenv.get_obs(s, jparams))(s), s, reward, done)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_step_from_random_states_matches_jax(case):
    """512 random states and actions (beyond the action box) through one
    `step_env`: obs, reward, done and every state field as JAX's; the
    spaces as JAX's. The batch holds touchdowns, liftoffs, legs that stay
    planted, episode ends and, for the tasks that end on them, falls."""
    jenv, jparams, tenv, tparams, _ = _envs(case)
    cls, task, _ = case
    n = 512
    js, act, (jo, jst, jr, jd) = _jax_step_op_by_op(case)
    to, tst, tr, td, _ = tenv.step_env(_torch_state(tenv, tparams, js), torch.tensor(act), tparams, NO_DRAWS)
    _assert_agrees(cls, _outputs(to, tst, tr, td), _outputs(jo, jst, jr, jd), _case_id(case))
    assert 0 < td.sum() < n and tr.dtype == torch.float32 and to.dtype == torch.float32
    before, after = np.asarray(js.stance), tst.stance.numpy()
    assert (~before & after).any() and (before & ~after).any() and (before & after).any()
    if task not in ("getup", "handstand", "footstand"):
        assert (tenv.fell(tst, tparams) & (tst.time < tparams.max_steps_in_episode)).any()
    obs_dim, act_dim = SPACES[cls]
    assert tenv.observation_space(tparams).shape == jenv.observation_space(jparams).shape == (obs_dim,)
    assert tenv.action_space(tparams).shape == jenv.action_space(jparams).shape == (act_dim,)
    for bound in ("low", "high"):
        np.testing.assert_array_equal(np.asarray(getattr(tenv.observation_space(tparams), bound), np.float32),
                                      np.asarray(getattr(jenv.observation_space(jparams), bound), np.float32))
        np.testing.assert_array_equal(np.asarray(getattr(tenv.action_space(tparams), bound), np.float32),
                                      np.asarray(getattr(jenv.action_space(jparams), bound), np.float32))


def test_params_and_names_match_jax():
    """Every preset's params field for field (the biped's derived torso
    constants included) and the default name."""
    for cls, presets in (("Quadruped", tloco.Quadruped.PRESETS), ("Biped3D", tloco.Biped3D.PRESETS)):
        for robot in presets:
            for task in getattr(tloco, cls).TASKS:
                jenv = getattr(jloco, cls)(task=task, robot=robot)
                tenv = getattr(tloco, cls)(task=task, robot=robot)
                assert dataclasses.asdict(tenv.default_params) == {
                    f.name: getattr(jenv.default_params, f.name) for f in dataclasses.fields(tenv.default_params)}
                assert tenv.name == jenv.name


def _jax_draws(task, key, p):
    """The draws the JAX env's `reset_env` makes from ``key``, in the port's
    `draw_start` layout [height offset, pitch, command vx, vy, yaw rate]."""
    u = jax.random.uniform
    k1, k2, k3 = jax.random.split(key, 3)
    if task == "getup":
        head = [jnp.asarray(0.0), u(k1, (), minval=-0.6, maxval=0.6)]
    else:
        head = [u(k1, (), minval=0.0, maxval=0.05), u(k2, (), minval=-0.05, maxval=0.05)]
    if task in ("joystick", "joystick_rough"):
        kx, ky, kw = jax.random.split(k3, 3)
        command = [u(kx, (), minval=-0.3 * p.cmd_vx, maxval=p.cmd_vx), u(ky, (), minval=-p.cmd_vy, maxval=p.cmd_vy),
                   u(kw, (), minval=-p.cmd_yaw, maxval=p.cmd_yaw)]
    elif task == "inplace":
        command = [jnp.asarray(0.0), jnp.asarray(0.0), u(k3, (), minval=-p.cmd_yaw, maxval=p.cmd_yaw)]
    else:
        command = [jnp.asarray(0.0)] * 3
    return jnp.stack(head + command)


@pytest.mark.parametrize("case", RUN_CASES, ids=_case_id)
def test_run_with_auto_resets_matches_jax(case, monkeypatch):
    """100 steps of 32 envs under random actions, started from JAX resets at
    random times (so that episodes end in the run): each step the port's
    `step` takes JAX's state and, for its auto-reset, the draws JAX's reset
    makes from the second half of the step's key (base.py:75-84); obs,
    reward, done and the state (reset rows included) as JAX's every step."""
    jenv, jparams, tenv, tparams, reset = _envs(case)
    task = case[1]
    step = jax.jit(jax.vmap(lambda k, s, a: jenv.step_env(k, s, a, jparams)))
    reset = jax.jit(reset)
    n, steps = 32, 100
    r = np.random.RandomState(100 + CASES.index(case))
    _, js = reset(jax.random.split(jax.random.PRNGKey(1), n))
    js = js.replace(time=jnp.asarray(r.randint(0, jparams.max_steps_in_episode, n).astype(np.int32)))
    js = jax.tree_util.tree_map(lambda x: jnp.array(x, dtype=x.dtype), js)  # strong types: one compile of `step`
    split = jax.jit(jax.vmap(jax.random.split))
    draws_of = jax.jit(jax.vmap(lambda k: _jax_draws(task, k, jparams)))
    holder = {}
    monkeypatch.setattr(tloco, "draw_start", lambda *a: holder["draws"])
    ended = 0
    for t in range(steps):
        keys = split(jax.random.split(jax.random.PRNGKey(1000 + t), n))
        act = r.uniform(-1.2, 1.2, (n, SPACES[case[0]][1])).astype(np.float32)
        jo, jst, jr, jd, _ = step(keys[:, 0], js, jnp.asarray(act))
        jo_re, js_re = reset(keys[:, 1])
        sel = lambda re, st: jnp.where(jd.reshape(jd.shape + (1,) * (st.ndim - 1)), re, st)  # noqa: E731
        js_next = jax.tree_util.tree_map(sel, js_re, jst)
        holder["draws"] = torch.tensor(np.asarray(draws_of(keys[:, 1])))
        to, tst, tr, td, _ = tenv.step(torch.Generator(), _torch_state(tenv, tparams, js), torch.tensor(act), tparams)
        _assert_agrees(case[0], _outputs(to, tst, tr, td), _outputs(sel(jo_re, jo), js_next, jr, jd), f"step {t}")
        ended += int(td.sum())
        js = js_next
    assert ended > 0


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_reset_matches_jax_and_its_draws_their_ranges(case):
    """JAX's `reset_env` from 64 keys and the port's `start_state` from the
    same keys' draws give the same obs and state; the port's own reset of
    100k envs draws each value in its range with its mean and variance
    (within 5 standard errors, 3 % on the variance), and sets the rest as
    JAX's reset does."""
    jenv, jparams, tenv, tparams, reset = _envs(case)
    task = case[1]
    keys = jax.random.split(jax.random.PRNGKey(5), 64)
    jo, js = reset(keys)
    draws = torch.tensor(np.asarray(jax.vmap(lambda k: _jax_draws(task, k, jparams))(keys)))
    ts = tenv.start_state(draws, tparams)
    _assert_agrees(case[0], _outputs(tenv.get_obs(ts, tparams), ts, torch.zeros(64),
                                     torch.zeros(64, dtype=torch.bool)),
                   _outputs(jo, js, np.zeros(64, np.float32), np.zeros(64, bool)))

    n, p = 100_000, tparams
    obs, s = tenv.reset(torch.Generator().manual_seed(0), n, p)
    assert obs.shape == (n, SPACES[case[0]][0]) and (s.time == 0).all()

    def uniform_ok(x, lo, hi):
        x = x.double()
        assert lo <= x.min() and x.max() < hi
        mean, var = (lo + hi) / 2, (hi - lo) ** 2 / 12
        assert abs(x.mean().item() - mean) < 5 * math.sqrt(var / x.numel())
        assert abs(x.var().item() / var - 1) < 0.03

    stand_z = p.leg_length * 0.95
    if task == "getup":
        uniform_ok(s.pitch, -0.6, 0.6)
        assert (s.z == torch.tensor(0.35 * p.leg_length)).all() and not s.stance.any()
    else:
        uniform_ok(s.z - stand_z, -1e-6, 0.05 + 1e-6)
        uniform_ok(s.pitch, -0.05, 0.05)
        assert s.stance.all() and torch.equal(s.foot_y[0], tenv.hips(p, "cpu")[1])
    if task in ("joystick", "joystick_rough"):
        uniform_ok(s.command[:, 0], -0.3 * p.cmd_vx, p.cmd_vx)
        uniform_ok(s.command[:, 1], -p.cmd_vy, p.cmd_vy)
    else:
        assert (s.command[:, :2] == 0).all()
    if task in ("joystick", "joystick_rough", "inplace"):
        uniform_ok(s.command[:, 2], -p.cmd_yaw, p.cmd_yaw)
    else:
        assert (s.command == 0).all()
    assert (s.leg_rest == torch.tensor(p.leg_length)).all() and (s.vx == 0).all() and (s.yaw == 0).all()


def test_jax_saved_go1_checkpoint_loads_into_the_port(tmp_path):
    """A JAX actor and critic ensemble at pqn_locomotion's widths on
    Go1JoystickFlatTerrain (31 obs, 12 actions, actor and two critics H 256 x
    2 with LayerNorm), saved by the JAX package's save_run as its CLI saves
    the {"actor", "critic"} tree, loads into the port's networks through
    load_ac_params; on 128 observations (resets and random steps) the
    actions and each critic's values agree within 1e-5."""
    from purejaxql_torch.core import checkpoint as tckpt
    from purejaxql_torch.core.config import compose
    from purejaxql_torch.envs import make as tmake
    from purejaxql_torch.models.actor_critic import Actor, CriticEnsemble
    from purejaxql_tpu.core import checkpoint as jckpt
    from purejaxql_tpu.models.actor_critic import Actor as JActor
    from purejaxql_tpu.models.actor_critic import Critic as JCritic

    config = compose(alg="pqn_locomotion", overrides=["ENV_NAME=Go1JoystickFlatTerrain", "DEVICE=cpu"])
    tenv, tparams = tmake("Go1JoystickFlatTerrain")
    obs_dim, act_dim = tenv.observation_space(tparams).shape[0], tenv.action_space(tparams).shape[0]
    assert (obs_dim, act_dim) == (31, 12)
    a_h, c_h = tuple(config["ACTOR_HIDDEN_SIZES"]), tuple(config["CRITIC_HIDDEN_SIZES"])
    jactor = JActor(act_dim, action_scale=jnp.asarray(1.0), action_bias=jnp.asarray(0.0), hidden_sizes=a_h,
                    norm_type=config["NORM_TYPE"])
    jcritic = JCritic(hidden_sizes=c_h, norm_type=config["NORM_TYPE"])
    # weights drawn with numpy into the trees the JAX init would make (its
    # shapes from eval_shape, which compiles nothing)
    r = np.random.RandomState(1)
    fill = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda x: jnp.asarray(r.normal(0, 1 / np.sqrt(x.shape[-2] if len(x.shape) > 1 else 16), x.shape), jnp.float32),
        t)
    av = fill(jax.eval_shape(jactor.init, jax.random.PRNGKey(1), jnp.zeros(obs_dim)))
    cv = fill(jax.eval_shape(jax.vmap(jcritic.init, in_axes=(0, None, None)),
                             jax.random.split(jax.random.PRNGKey(2), 2), jnp.zeros(obs_dim), jnp.zeros(act_dim)))
    params = {"actor": av["params"], "critic": cv["params"]}
    # the CLI saves the vmapped run's tree, its seed axis stripped
    jckpt.save_run(jax.tree_util.tree_map(lambda x: x[None], params), {"NUM_SEEDS": 1}, str(tmp_path), "ac")
    actor = Actor(obs_dim, act_dim, 1.0, 0.0, list(a_h), norm_type=config["NORM_TYPE"])
    critics = CriticEnsemble(config["NUM_CRITICS"], obs_dim, act_dim, list(c_h), norm_type=config["NORM_TYPE"])
    tckpt.load_ac_params(tckpt.load_params(str(tmp_path / "ac.safetensors")), actor, critics)
    g = torch.Generator().manual_seed(0)
    obs, state = tenv.reset(g, 128, tparams)
    for _ in range(5):
        obs, state, *_ = tenv.step(g, state, torch.rand(128, act_dim, generator=g) * 2 - 1, tparams)
    o = jnp.asarray(obs.numpy())
    ja = jax.jit(lambda v: jactor.apply(v, o, train=False))(av)
    jv = jax.jit(jax.vmap(lambda v: jcritic.apply(v, o, ja, train=False)))(cv)
    with torch.no_grad():
        ta = actor(obs, train=False)
        tv = critics(obs, ta, train=False)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv).reshape(tv.shape), atol=1e-5, rtol=0)
