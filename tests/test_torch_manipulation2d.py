"""The port's 2-D manipulation envs (envs/classic/manipulation2d.py) on the
CPU against the JAX package: PickPlace, PegInsert, BlockRotate (reorient,
spin), PandaPickCube (with and without orientation), PushCube and HandOver.

For every task and variant: one `step_env` from a batch of random states
(grasps, latches and drops, blocks falling and on the floor, pegs above the
table, on it and in the slot, the cone open and closed, walls, contacts,
hand-overs, rows at max_steps - 1) against JAX's step run op by op
(vmapped, not jitted), and the spaces; the reset from JAX's draws, and the
port's own draws by their ranges. For every class: a 100-step run in which
the port steps from JAX's state each time with JAX's own reset draws, so
that its auto-reset rows are held too, against JAX's step_env and reset_env
jitted once. The JAX tests' scripted cases (tests/test_manipulation2d.py,
tests/test_manipulation_playground.py) run through the port step by step
against JAX's outputs. Ints equal, floats within 1e-5; the wrapped angles
(BlockRotate's theta and angle error, PandaPickCube's yaw) modulo 2 pi, as
arctan2 puts a value at +-pi on either side."""

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
from purejaxql_tpu.envs import make as jmake

torch.set_num_threads(1)

TASKS = ("PickPlace-v0", "PegInsert-v0", "BlockRotate-v0", "LeapCubeRotateZAxis", "PandaPickCube",
         "PandaPickCubeOrientation", "PandaRobotiqPushCube", "AlohaHandOver")
# one task of each class for the auto-reset runs (PandaPickCube with the
# orientation draw)
RUN_TASKS = ("PickPlace-v0", "PegInsert-v0", "BlockRotate-v0", "PandaPickCubeOrientation", "PandaRobotiqPushCube",
             "AlohaHandOver")
SPACES = {"PickPlace-v0": (11, 3), "PegInsert-v0": (8, 2), "BlockRotate-v0": (6, 3), "LeapCubeRotateZAxis": (3, 3),
          "PandaPickCube": (13, 3), "PandaPickCubeOrientation": (17, 4), "PandaRobotiqPushCube": (12, 2),
          "AlohaHandOver": (18, 6)}


@functools.lru_cache(maxsize=None)
def _envs(name):
    """The JAX env and params, the port's, JAX's step_env vmapped and jitted
    once, its reset_env vmapped and jitted once, and both vmapped alone (run
    op by op: a call on a few envs costs less than a compile)."""
    jenv, jparams = jmake(name)
    tenv, tparams = tmake(name)
    step = jax.vmap(lambda k, s, a: jenv.step_env(k, s, a, jparams))
    reset = jax.vmap(lambda k: jenv.reset_env(k, jparams))
    return jenv, jparams, tenv, tparams, jax.jit(step), jax.jit(reset), step, reset


# ---- random states off the reset distribution ----------------------------------------


def _times(r, n, limit):
    time = r.randint(0, limit, n)
    time[: n // 8] = limit - 1
    return time.astype(np.int32)


def _near(r, at, radius):
    return at + r.uniform(-radius, radius, at.shape)


def _box(r, n, lo, hi):
    return np.stack([r.uniform(lo[0], hi[0], n), r.uniform(lo[1], hi[1], n)], -1)


def _pick(r, n, p, second_order):
    """Grips near the block in half the rows (grasp radius 0.08), blocks on
    the floor, falling or held, actions that close or open."""
    grip = _box(r, n, (-1, 0), (1, 1))
    block = np.where(r.rand(n, 1) < 0.5, _near(r, grip, 0.1), _box(r, n, (-1, p.block_half), (1, 1)))
    floor = r.rand(n) < 0.25
    block[floor, 1] = p.block_half
    vel = r.uniform(-1, 1, (n, 2))
    vel[floor] = 0.0
    holding = (r.rand(n) < 0.3).astype(np.float32)
    s = dict(grip=grip, block=block, block_vel=vel, holding=holding, target=_box(r, n, (-0.7, 0.35), (0.7, 0.8)),
             time=_times(r, n, p.max_steps_in_episode))
    if second_order:
        s.update(grip_vel=r.uniform(-1.5, 1.5, (n, 2)), yaw=r.uniform(-np.pi, np.pi, n),
                 target_yaw=r.uniform(-np.pi, np.pi, n))
    return s


def _peg(r, n, p):
    """Pegs above the table, just above it over and off the slot, and in the
    slot's channel."""
    slot_x = r.uniform(-0.5, 0.5, n)
    k = r.randint(0, 3, n)
    x = np.where(k == 0, r.uniform(-1, 1, n), slot_x + r.uniform(-0.03, 0.03, n))
    x = np.where(k == 1, slot_x + r.uniform(-0.1, 0.1, n), x)
    z = np.where(k == 0, r.uniform(p.table_z, 0.95, n), p.table_z + r.uniform(-0.01, 0.05, n))
    z = np.where(k == 2, r.uniform(p.table_z - p.slot_depth, p.table_z, n), z)
    return dict(peg=np.stack([x, z], -1), vel=r.uniform(-1.2, 1.2, (n, 2)), slot_x=slot_x,
                time=_times(r, n, p.max_steps_in_episode))


def _rotate(r, n, p):
    theta = r.uniform(-np.pi, np.pi, n)
    target = np.where(r.rand(n) < 0.25, theta + r.uniform(-0.15, 0.15, n), r.uniform(-np.pi, np.pi, n))
    return dict(theta=theta, omega=r.uniform(-4, 4, n), target=target, time=_times(r, n, p.max_steps_in_episode))


def _push(r, n, p):
    """Pushers touching the cube (pusher_r + cube_half = 0.09) in half the
    rows, cubes by their target in a quarter."""
    pusher = r.uniform(-1, 1, (n, 2))
    cube = np.where(r.rand(n, 1) < 0.5, _near(r, pusher, 0.1), r.uniform(-1, 1, (n, 2)))
    target = np.where(r.rand(n, 1) < 0.25, _near(r, cube, 0.1), r.uniform(-0.85, 0.85, (n, 2)))
    return dict(pusher=pusher, cube=cube, cube_vel=r.uniform(-1, 1, (n, 2)), target=target,
                time=_times(r, n, p.max_steps_in_episode))


def _handover(r, n, p):
    """Blocks near the left hand, the right or both (at the midline), each
    holder."""
    lgrip = _box(r, n, (-1, 0), (p.reach_overlap, 1))
    rgrip = _box(r, n, (-p.reach_overlap, 0), (1, 1))
    k = r.randint(0, 4, n)
    mid = _box(r, n, (-0.1, 0.3), (0.1, 0.9))
    lgrip[k == 3], rgrip[k == 3] = _near(r, mid[k == 3], 0.03), _near(r, mid[k == 3], 0.03)
    block = np.where((k == 0)[:, None], _near(r, lgrip, 0.1), _near(r, rgrip, 0.1))
    block = np.where((k == 2)[:, None], _box(r, n, (-1, p.block_half), (1, 1)), block)
    block[k == 3] = mid[k == 3]
    return dict(lgrip=lgrip, rgrip=rgrip, block=block, block_vel=r.uniform(-1, 1, (n, 2)),
                holder=r.randint(0, 3, n).astype(np.float32), target=_box(r, n, (0.4, 0.35), (0.8, 0.8)),
                time=_times(r, n, p.max_steps_in_episode))


def _random_states(name, r, n, p):
    if name == "PickPlace-v0":
        return _pick(r, n, p, False)
    if name.startswith("PandaPickCube"):
        return _pick(r, n, p, True)
    if name == "PegInsert-v0":
        return _peg(r, n, p)
    if name == "PandaRobotiqPushCube":
        return _push(r, n, p)
    if name == "AlohaHandOver":
        return _handover(r, n, p)
    return _rotate(r, n, p)


def _actions(r, n, name):
    """Actions beyond the box, the grip channels often past their close (> 0)
    and open (< -0.5) thresholds."""
    return r.uniform(-1.5, 1.5, (n, SPACES[name][1])).astype(np.float32)


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


def _wrapped(name):
    """The angles arctan2 wraps to [-pi, pi]: (obs columns, indexes in
    ``_outputs``)."""
    if name == "BlockRotate-v0":
        return [5], {3}  # the angle error; theta
    if name == "LeapCubeRotateZAxis":
        return [], {3}
    if name.startswith("PandaPickCube"):
        return [], {7}  # yaw
    return [], set()


def _unwrap(got, want):
    """``got`` moved by whole turns to within pi of ``want``."""
    return want + np.remainder(got - want + np.pi, 2 * np.pi) - np.pi


def _assert_agrees(name, got, want, msg=""):
    """The port's outputs ``got`` (obs, reward, done, then the state fields)
    as JAX's ``want``: ints equal, floats within 1e-5, the wrapped angles
    modulo 2 pi."""
    obs_cols, fields = _wrapped(name)
    for k, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (msg, k, g.shape, w.shape, g.dtype, w.dtype)
        if g.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, f"{msg} output {k}")
            continue
        if k == 0 and obs_cols:
            g = g.copy()
            g[:, obs_cols] = _unwrap(g[:, obs_cols], w[:, obs_cols])
        elif k in fields:
            g = _unwrap(g, w)
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=f"{msg} output {k}")


def _outputs(obs, state, reward, done):
    return [obs, reward, done] + [getattr(state, f.name) for f in dataclasses.fields(state)]


@pytest.mark.parametrize("name", TASKS)
def test_step_from_random_states_matches_jax(name):
    """512 random states and actions (beyond the action box) through one
    `step_env`: obs, reward, done and every state field as JAX's; the
    spaces, the name and the params as JAX's."""
    jenv, jparams, tenv, tparams, _, _, step, reset = _envs(name)
    n, r = 512, np.random.RandomState(TASKS.index(name))
    js = _jax_state(reset, _random_states(name, r, n, jparams))
    act = _actions(r, n, name)
    jo, jst, jr, jd, _ = step(jax.random.split(jax.random.PRNGKey(0), n), js, jnp.asarray(act))
    ts = _torch_state(tenv, tparams, js)
    to, tst, tr, td, info = tenv.step_env(ts, torch.tensor(act), tparams, NO_DRAWS)
    _assert_agrees(name, _outputs(to, tst, tr, td), _outputs(jo, jst, jr, jd))
    assert 0 < td.sum() < n and tr.dtype == torch.float32 and to.dtype == torch.float32 and info == {}
    if name in ("PickPlace-v0", "PandaPickCube", "PandaPickCubeOrientation"):
        before, after = ts.holding.numpy(), tst.holding.numpy()
        assert ((before == 0) & (after == 1)).any() and ((before == 1) & (after == 0)).any()
    if name == "PegInsert-v0":  # pegs held on the table, pegs in the slot
        assert (tst.peg[:, 1] == tparams.table_z).any() and (tst.peg[:, 1] < tparams.table_z).any()
    if name == "AlohaHandOver":
        before, after = ts.holder.numpy(), tst.holder.numpy()
        assert all(((before == a) & (after == b)).any() for a, b in ((0, 1), (0, 2), (1, 2), (1, 0), (2, 0)))
    if name == "PandaRobotiqPushCube":
        assert (torch.norm(ts.cube - tst.pusher, dim=-1) < tparams.pusher_r + tparams.cube_half).any()
    obs_dim, act_dim = SPACES[name]
    assert tenv.observation_space(tparams).shape == jenv.observation_space(jparams).shape == (obs_dim,)
    assert tenv.action_space(tparams).shape == jenv.action_space(jparams).shape == (act_dim,)
    for bound in ("low", "high"):
        np.testing.assert_array_equal(np.asarray(getattr(tenv.observation_space(tparams), bound), np.float32),
                                      np.asarray(getattr(jenv.observation_space(jparams), bound), np.float32))
        np.testing.assert_array_equal(np.asarray(getattr(tenv.action_space(tparams), bound), np.float32),
                                      np.asarray(getattr(jenv.action_space(jparams), bound), np.float32))
    assert tenv.name == jenv.name and type(tenv).__name__ == type(jenv).__name__
    assert dataclasses.asdict(tparams) == {f.name: getattr(jparams, f.name) for f in dataclasses.fields(tparams)}


def _jax_draws(name, key, jparams):
    """The draws the JAX env's `reset_env` makes from ``key``, in the layout
    of the port's `draw_start`."""
    u = jax.random.uniform
    if name in ("PickPlace-v0", "PandaPickCube", "PandaPickCubeOrientation"):
        ks = jax.random.split(key, 5 if name.startswith("PandaPickCube") else 4)
        d = [u(ks[0], (), minval=-0.7, maxval=0.7), u(ks[1], (), minval=-0.7, maxval=0.7),
             u(ks[2], (), minval=0.35, maxval=0.8), u(ks[3], (), minval=-0.7, maxval=0.7)]
        if name.startswith("PandaPickCube"):
            d.append(u(ks[4], (), minval=-jnp.pi, maxval=jnp.pi) if name.endswith("Orientation") else jnp.asarray(0.0))
        return jnp.stack(d)
    if name == "PegInsert-v0":
        k_px, k_pz, k_s = jax.random.split(key, 3)
        return jnp.stack([u(k_px, (), minval=-0.8, maxval=0.8), u(k_pz, (), minval=jparams.table_z + 0.2, maxval=0.9),
                          u(k_s, (), minval=-0.5, maxval=0.5)])
    if name == "PandaRobotiqPushCube":
        k_p, k_c, k_t = jax.random.split(key, 3)
        k_ang, k_r = jax.random.split(k_t)
        return jnp.concatenate([u(k_p, (2,), minval=-0.8, maxval=0.8), u(k_c, (2,), minval=-0.5, maxval=0.5),
                                u(k_ang, (1,), minval=0.0, maxval=2 * jnp.pi), u(k_r, (1,), minval=0.3, maxval=0.6)])
    if name == "AlohaHandOver":
        k_b, k_t, k_l, k_r = jax.random.split(key, 4)
        k_tx, k_tz = jax.random.split(k_t)
        return jnp.stack([u(k_b, (), minval=-0.8, maxval=-0.4), u(k_tx, (), minval=0.4, maxval=0.8),
                          u(k_tz, (), minval=0.35, maxval=0.8), u(k_l, (), minval=-0.8, maxval=-0.2),
                          u(k_r, (), minval=0.2, maxval=0.8)])
    k_t, k_g = jax.random.split(key)
    return jnp.stack([u(k_t, (), minval=-jnp.pi, maxval=jnp.pi), u(k_g, (), minval=-jnp.pi, maxval=jnp.pi)])


@pytest.mark.parametrize("name", RUN_TASKS)
def test_run_with_auto_resets_matches_jax(name, monkeypatch):
    """100 steps of 32 envs under random actions, started from JAX resets at
    random times (so that episodes end in the run): each step the port's
    `step` takes JAX's state and, for its auto-reset, the draws JAX's reset
    makes from the second half of the step's key (base.py:75-84); obs,
    reward, done and the state (reset rows included) as JAX's every step."""
    jenv, jparams, tenv, tparams, step, reset, _, _ = _envs(name)
    n, steps = 32, 100
    r = np.random.RandomState(100 + TASKS.index(name))
    _, js = reset(jax.random.split(jax.random.PRNGKey(1), n))
    js = js.replace(time=jnp.asarray(r.randint(0, jparams.max_steps_in_episode, n).astype(np.int32)))
    js = jax.tree_util.tree_map(lambda x: jnp.array(x, dtype=x.dtype), js)  # strong types: one compile of `step`
    split = jax.jit(jax.vmap(jax.random.split))
    draws_of = jax.jit(jax.vmap(lambda k: _jax_draws(name, k, jparams)))
    holder = {}
    monkeypatch.setattr(type(tenv), "draw_start", lambda *a: holder["draws"])
    ended = 0
    for t in range(steps):
        keys = split(jax.random.split(jax.random.PRNGKey(1000 + t), n))
        act = _actions(r, n, name)
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


@pytest.mark.parametrize("name", TASKS)
def test_reset_matches_jax_and_its_draws_their_ranges(name):
    """JAX's `reset_env` from 64 keys and the port's `start_state` from the
    same keys' draws give the same obs and state; the port's own reset of
    100k envs draws each value in its range with its mean and variance
    (within 5 standard errors, 3 % on the variance), and sets the rest as
    JAX's reset does."""
    jenv, jparams, tenv, tparams, _, _, _, reset = _envs(name)
    keys = jax.random.split(jax.random.PRNGKey(5), 64)
    jo, js = reset(keys)
    draws = torch.tensor(np.asarray(jax.vmap(lambda k: _jax_draws(name, k, jparams))(keys)))
    ts = tenv.start_state(draws, tparams)
    _assert_agrees(name, _outputs(tenv.get_obs(ts, tparams), ts, torch.zeros(64), torch.zeros(64, dtype=torch.bool)),
                   _outputs(jo, js, np.zeros(64, np.float32), np.zeros(64, bool)))

    n, p = 100_000, tparams
    obs, s = tenv.reset(torch.Generator().manual_seed(0), n, p)
    assert obs.shape == (n, SPACES[name][0]) and (s.time == 0).all()

    def uniform_ok(x, lo, hi):
        x = x.double()
        assert lo <= x.min() and x.max() < hi
        mean, var = (lo + hi) / 2, (hi - lo) ** 2 / 12
        assert abs(x.mean().item() - mean) < 5 * math.sqrt(var / x.numel())
        assert abs(x.var().item() / var - 1) < 0.03

    if name in ("PickPlace-v0", "PandaPickCube", "PandaPickCubeOrientation"):
        uniform_ok(s.block[:, 0], -0.7, 0.7)
        uniform_ok(s.target[:, 0], -0.7, 0.7)
        uniform_ok(s.target[:, 1], 0.35, 0.8)
        uniform_ok(s.grip[:, 0], -0.7, 0.7)
        assert (s.block[:, 1] == torch.tensor(p.block_half)).all() and (s.grip[:, 1] == torch.tensor(0.6)).all()
        assert (s.holding == 0).all() and (s.block_vel == 0).all()
        if name.startswith("PandaPickCube"):
            assert (s.yaw == 0).all() and (s.grip_vel == 0).all()
            if name.endswith("Orientation"):
                uniform_ok(s.target_yaw, -math.pi, math.pi)
            else:
                assert (s.target_yaw == 0).all()
    elif name == "PegInsert-v0":
        uniform_ok(s.peg[:, 0], -0.8, 0.8)
        uniform_ok(s.peg[:, 1], p.table_z + 0.2, 0.9)
        uniform_ok(s.slot_x, -0.5, 0.5)
        assert (s.vel == 0).all()
    elif name == "PandaRobotiqPushCube":
        d = type(tenv).draw_start(torch.Generator().manual_seed(0), n)  # the draws the reset made
        assert torch.equal(d[:, :4], torch.cat([s.pusher, s.cube], -1)) and (s.cube_vel == 0).all()
        uniform_ok(s.pusher, -0.8, 0.8)
        uniform_ok(s.cube, -0.5, 0.5)
        uniform_ok(d[:, 4], 0.0, 2 * math.pi)
        uniform_ok(d[:, 5], 0.3, 0.6)
        offset = d[:, 5:6] * torch.stack([torch.cos(d[:, 4]), torch.sin(d[:, 4])], -1)
        assert torch.equal(s.target, torch.clamp(s.cube + offset, -0.85, 0.85))
    elif name == "AlohaHandOver":
        uniform_ok(s.block[:, 0], -0.8, -0.4)
        uniform_ok(s.target[:, 0], 0.4, 0.8)
        uniform_ok(s.target[:, 1], 0.35, 0.8)
        uniform_ok(s.lgrip[:, 0], -0.8, -0.2)
        uniform_ok(s.rgrip[:, 0], 0.2, 0.8)
        assert (s.holder == 0).all() and (s.lgrip[:, 1] == torch.tensor(0.6)).all()
    else:
        uniform_ok(s.theta, -math.pi, math.pi)
        uniform_ok(s.target, -math.pi, math.pi)
        assert (s.omega == 0).all()


# ---- the JAX tests' scripted cases through the port ----------------------------------


def _scripted(name, key, edit, actions):
    """One env reset from ``key``, edited by ``edit`` (JAX state -> JAX
    state), stepped through ``actions`` (each a list, or (edit, action) to
    edit the state first) by JAX and by the port, each from its
    own state (JAX's step jitted): every step's outputs agree. Returns the
    port's states."""
    jenv, jparams, tenv, tparams, step, _, _, reset = _envs(name)
    _, js = reset(key[None])
    js = edit(js)
    ts = _torch_state(tenv, tparams, js)
    states = []
    for t, a in enumerate(actions):
        if isinstance(a, tuple):
            js = a[0](js)
            ts, a = _torch_state(tenv, tparams, js), a[1]
        act = np.asarray([a], np.float32)
        jo, js, jr, jd, _ = step(key[None], js, jnp.asarray(act))
        to, ts, tr, td, _ = tenv.step_env(ts, torch.tensor(act), tparams, NO_DRAWS)
        _assert_agrees(name, _outputs(to, ts, tr, td), _outputs(jo, js, jr, jd), f"step {t}")
        states.append(ts)
    return states


def test_scripted_pick_place_grasp_latches_carries_and_drops():
    """tests/test_manipulation2d.py:21-37: the gripper on the block closes,
    carries it up and right, then opens and the block falls to the floor."""
    states = _scripted("PickPlace-v0", jax.random.PRNGKey(3), lambda s: s.replace(grip=s.block),
                       [[0, 0, 1.0]] + [[1.0, 1.0, 1.0]] * 5 + [[0, 0, -1.0]] * 40)
    assert states[0].holding.item() == 1.0 and states[-1].holding.item() == 0.0


def test_scripted_panda_pick_momentum_grasp_and_wrist():
    """tests/test_manipulation_playground.py:33-115: PandaPickCube coasting
    after a burst, grasping and lifting; the Cartesian pick stopping; the
    wrist turning only a held block."""
    runway = lambda s: s.replace(grip=jnp.array([[-0.9, 0.6]]))  # noqa: E731
    _scripted("PandaPickCube", jax.random.PRNGKey(0), runway, [[1.0, 0.0, -1.0]] * 10 + [[0.0, 0.0, 0.0]])
    onto = lambda s: s.replace(grip=s.block, grip_vel=jnp.zeros((1, 2)))  # noqa: E731
    states = _scripted("PandaPickCube", jax.random.PRNGKey(3), onto, [[0.0, 0.0, 1.0]] + [[0.0, 1.0, 1.0]] * 12)
    assert states[-1].block[0, 1].item() > 0.15
    _scripted("PandaPickCubeCartesian", jax.random.PRNGKey(0), lambda s: s, [[1.0, 0.0, -1.0]] * 5 + [[0, 0, 0]])
    states = _scripted("PandaPickCubeOrientation", jax.random.PRNGKey(6), lambda s: s,
                       [[0.0, 0.0, 1.0, -1.0], (onto, [0.0, 0.0, 0.0, 1.0]), [0.0, 0.0, 1.0, 1.0]])
    assert states[0].yaw.item() == 0.0 and states[-1].yaw.item() != 0.0


def test_scripted_peg_table_blocks_offset_descent_and_walls_clamp():
    """tests/test_manipulation2d.py:53-87: a push down off the slot is
    blocked by the table, an aligned descent enters the slot, the walls
    clamp a peg in it."""
    table_z = jmake("PegInsert-v0")[1].table_z
    off = lambda s: s.replace(peg=jnp.stack([s.slot_x + 0.3, jnp.full(1, table_z + 0.02)], -1))  # noqa: E731
    _scripted("PegInsert-v0", jax.random.PRNGKey(0), off, [[0.0, -1.0]] * 10)
    over = lambda s: s.replace(peg=jnp.stack([s.slot_x, jnp.full(1, table_z + 0.02)], -1))  # noqa: E731
    states = _scripted("PegInsert-v0", jax.random.PRNGKey(1), over, [[0.0, -1.0]] * 10)
    assert states[-1].peg[0, 1].item() < table_z - 0.05
    inside = lambda s: s.replace(peg=jnp.stack([s.slot_x, jnp.full(1, table_z - 0.1)], -1))  # noqa: E731
    _scripted("PegInsert-v0", jax.random.PRNGKey(0), inside, [[1.0, 0.0]] * 10)


def test_scripted_block_rotate_friction_cone():
    """tests/test_manipulation2d.py:90-101 and
    tests/test_manipulation_playground.py:233-255: no squeeze transmits no
    torque, a full squeeze turns the block; the spin task's block spins."""
    level = lambda s: s.replace(theta=jnp.zeros(1), omega=jnp.zeros(1))  # noqa: E731
    states = _scripted("BlockRotate-v0", jax.random.PRNGKey(0), level, [[1.0, -1.0, -1.0]] * 5)
    assert abs(states[-1].theta.item()) < 1e-5
    states = _scripted("BlockRotate-v0", jax.random.PRNGKey(0), level, [[1.0, -1.0, 1.0]] * 5)
    assert states[-1].theta.item() > 0.01
    still = lambda s: s.replace(omega=jnp.zeros(1))  # noqa: E731
    states = _scripted("LeapCubeRotateZAxis", jax.random.PRNGKey(22), still, [[1.0, -1.0, 1.0]] * 40)
    assert states[-1].omega.item() > 0.5


def test_scripted_push_cube_contact_and_friction():
    """tests/test_manipulation_playground.py:160-178: a pusher driven through
    the cube pushes it along, and once it stops the slide decays."""
    beside = lambda s: s.replace(pusher=jnp.array([[-0.08, 0.0]]), cube=jnp.zeros((1, 2)),  # noqa: E731
                                 cube_vel=jnp.zeros((1, 2)))
    states = _scripted("PandaRobotiqPushCube", jax.random.PRNGKey(11), beside, [[1.0, 0.0]] * 15 + [[0.0, 0.0]] * 30)
    assert states[14].cube[0, 0].item() > 0.05 and states[-1].cube_vel.norm().item() < 1e-2


def test_scripted_hand_over_chain():
    """tests/test_manipulation_playground.py:201-230: the left hand takes the
    block, the right takes it over at the midline and carries it."""
    meet = jnp.array([[0.0, 0.6]])
    handed = lambda s: s.replace(lgrip=meet, rgrip=meet, block=meet)  # noqa: E731
    states = _scripted("AlohaHandOver", jax.random.PRNGKey(16), lambda s: s.replace(lgrip=s.block),
                       [[0.0, 0.0, 1.0, 0.0, 0.0, -1.0], (handed, [0.0, 0.0, 1.0, 0.0, 0.0, 1.0])]
                       + [[0.0, 0.0, -1.0, 1.0, 0.5, 1.0]] * 20)
    assert [states[0].holder.item(), states[1].holder.item()] == [1.0, 2.0] and states[-1].block[0, 0].item() > 0.2
