"""The port's Forager (the craftax-class env) against the JAX package's, on the
CPU: worldgen cell for cell from the JAX draws, the reset and the step from
the JAX env's own draws (random play, the hand-set states of
tests/test_forager.py), the golden pins of tests/test_forager_golden.py, and
the port's own draws by their statistics."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from purejaxql_torch.envs import make as tmake
from purejaxql_torch.envs.gridworld import forager as TF
from purejaxql_torch.envs.gridworld import worldgen as TW
from purejaxql_tpu.envs.gridworld import forager as JF
from purejaxql_tpu.envs.gridworld import worldgen as JW

torch.set_num_threads(1)

N = 64  # the batch every jitted JAX function here runs at
JENV = JF.Forager()
PARAMS = JENV.default_params
TENV = TF.Forager()
TPARAMS = TENV.default_params


def _world_draws_one(key):
    """The draws JW.generate_world makes from its key (worldgen.py:116-250)."""
    key, k_cave, *k_ladders = jax.random.split(key, 6)
    k_elev, k_detail, k_feat = jax.random.split(key, 3)
    k_dnoise, k_dfeat = jax.random.split(k_cave)
    rows = [jax.random.randint(k, (2,), lo, hi) for k, (lo, hi) in zip(k_ladders, TW.SEAM_ROWS)]
    cols = [jax.random.randint(jax.random.fold_in(k, 1), (2,), 0, TW.SEAM_COL_RANGE) for k in k_ladders]
    return (
        jax.random.normal(k_elev, (1, 7, 7))[0], jax.random.normal(k_detail, (1, 13, 13))[0],
        jax.random.uniform(k_feat, (48, 48)), jax.random.normal(k_dnoise, (4, 9, 9)),
        jax.random.uniform(k_dfeat, (4, 48, 48)), jnp.stack(rows), jnp.stack(cols),
    )


def _reset_draws_one(key):
    """The draws JF.Forager.reset_env makes from its key (forager.py:383-403)."""
    k_world, k_cow, k_skel, k_orc, k_warden, k_demon, k_necro, k_potion, k_bat, k_wraith, k_queen = (
        jax.random.split(key, 11)
    )
    inner, core = (JW.PAD + 2, JW.PAD + JW.WORLD_SIZE - 2), (JW.PAD + 4, JW.PAD + JW.WORLD_SIZE - 4)
    cells = lambda k, shape, rng: jax.random.randint(k, (*shape, 2), *rng)  # noqa: E731
    return _world_draws_one(k_world) + (
        cells(k_cow, (8,), core), cells(k_skel, (8,), inner), cells(k_orc, (4, 8), inner),
        cells(k_warden, (8,), core), cells(k_demon, (4, 8), inner), cells(k_necro, (8,), core),
        jax.random.permutation(k_potion, 3), cells(k_bat, (4,), inner), cells(k_wraith, (4, 8), inner),
        cells(k_queen, (8,), core),
    )


def _t(x):
    return torch.tensor(np.asarray(x))


def world_draws(parts):
    return TW.WorldDraws(*(_t(p) for p in parts))


def reset_draws(parts):
    return TF.ForagerResetDraws(world_draws(parts[:7]), *(_t(p) for p in parts[7:]))


@pytest.fixture(scope="module")
def jax_fns():
    vm = jax.vmap
    return {
        "reset_draws": jax.jit(vm(_reset_draws_one)),
        "reset": jax.jit(vm(JENV.reset_env, in_axes=(0, None))),
        "step": jax.jit(vm(JENV.step_env, in_axes=(0, 0, 0, None))),
        "step_draws": jax.jit(vm(lambda k: jax.random.uniform(k, (TF.NUM_STEP_DRAWS,)))),
    }


def to_torch_state(js) -> TF.ForagerState:
    return TF.ForagerState(**{f.name: _t(getattr(js, f.name)) for f in dataclasses.fields(TF.ForagerState)})


def assert_same_state(got: TF.ForagerState, want, where=""):
    for f in dataclasses.fields(TF.ForagerState):
        g, w = getattr(got, f.name).numpy(), np.asarray(getattr(want, f.name))
        assert g.dtype == w.dtype, (where, f.name, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{where} {f.name}")


def assert_obs_close(got, want):
    got, want = got.numpy(), np.asarray(want)
    grid = TF.VIEW * TF.VIEW * (TW.NUM_BLOCK_TYPES + TF.NUM_MOB_TYPES)
    np.testing.assert_array_equal(got[:, :grid], want[:, :grid])  # the one-hot view: exact
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def _keys(seed, n=N):
    return jax.random.split(jax.random.PRNGKey(seed), n)


def test_sample_points_match_jnp_linspace():
    for res in (TW.ELEV_RES, TW.DETAIL_RES, TW.DUNGEON_RES):
        want = np.asarray(jax.jit(lambda: jnp.linspace(0.0, res, TW.WORLD_SIZE))())
        np.testing.assert_array_equal(TW._sample_points(res, TW.WORLD_SIZE, "cpu").numpy(), want)


def test_worldgen_matches_jax_cell_for_cell():
    keys = _keys(5, 8)
    want = np.asarray(jax.jit(jax.vmap(JW.generate_world))(keys))
    got = TW.generate_world(world_draws(jax.jit(jax.vmap(_world_draws_one))(keys)))
    assert got.dtype == torch.int8 and got.shape == want.shape == (8, 5, 56, 56)
    np.testing.assert_array_equal(got.numpy(), want)


def test_reset_and_random_play_match_jax(jax_fns):
    """64 envs from the JAX reset draws, then 64 steps of random play from the
    JAX step draws: obs within 1e-6 (the one-hot view exact), reward within
    1e-6, done, info and every state field equal."""
    keys = _keys(0)
    obs_j, st_j = jax_fns["reset"](keys, PARAMS)
    obs_t, st_t = TENV.reset_from_draws(reset_draws(jax_fns["reset_draws"](keys)), TPARAMS)
    assert_same_state(st_t, st_j, "reset")
    assert_obs_close(obs_t, obs_j)
    assert obs_t.shape == (N, TF.OBS_DIM) == (N, 2883)

    # needs, ticks, clocks, mana, XP, inventory and floor drawn at random, so
    # every rule fires within the 64 steps
    rng = np.random.RandomState(0)
    st_j = jax.tree_util.tree_map(np.array, st_j)
    for name, hi in (("health", 10), ("food", 10), ("drink", 10), ("energy", 10), ("hunger", 25),
                     ("thirst", 20), ("fatigue", 30), ("decay_tick", 10), ("regen_tick", 30), ("time", 600),
                     ("mana", 10), ("xp", 40), ("level", 5)):
        getattr(st_j, name)[:] = rng.randint(0, hi, N)
    st_j.health[:] = np.maximum(st_j.health, 1)
    st_j.inventory[:] = rng.randint(0, 4, st_j.inventory.shape) * (rng.rand(*st_j.inventory.shape) < 0.5)
    st_j.sleeping[:] = rng.rand(N) < 0.2
    st_j = jax.tree_util.tree_map(jnp.asarray, st_j)
    seen_rewards, seen_done = set(), 0
    for t in range(64):
        # mostly the actions that change the world, so the rules all run
        action = rng.choice([0, 1, 2, 3, 4, 5, 5, 5, 6, *range(7, 34)], N).astype(np.int32)
        k = _keys(1000 + t)
        draws = jax_fns["step_draws"](k)
        obs_j, st_j2, rew_j, done_j, info_j = jax_fns["step"](k, st_j, jnp.asarray(action), PARAMS)
        obs_t, st_t2, rew_t, done_t, info_t = TENV.step_env(to_torch_state(st_j), torch.tensor(action), TPARAMS,
                                                             _t(draws))
        assert_same_state(st_t2, st_j2, f"step {t}")
        assert_obs_close(obs_t, obs_j)
        np.testing.assert_allclose(rew_t.numpy(), np.asarray(rew_j), atol=1e-6, rtol=0)
        np.testing.assert_array_equal(done_t.numpy(), np.asarray(done_j))
        np.testing.assert_array_equal(info_t["achievement_count"].numpy(), np.asarray(info_j["achievement_count"]))
        seen_rewards.update(np.round(np.asarray(rew_j), 1).tolist())
        seen_done += int(np.asarray(done_j).sum())
        st_j = st_j2
    assert max(seen_rewards) >= 1.0 and min(seen_rewards) < 0 and seen_done > 0, (seen_rewards, seen_done)


def _hand_set_states(jax_fns):
    """The hand-set states of tests/test_forager.py, 64 in one batch, with the
    action each test takes: crafting (a table placed, pickaxes, diamond tools,
    bow and arrows), descent and ascent on every seam, mining gated by tool
    tier, chests, combat (melee on a weakened warden, an arrow down a clear
    and a blocked ray, an ice bolt through two mobs, an adjacent warden on an
    even tick), potions and a starving player."""
    _, st = jax_fns["reset"](_keys(11), PARAMS)
    st = jax.tree_util.tree_map(np.array, st)
    blocks = st.blocks
    actions = np.zeros(N, np.int32)
    I = JF.INV  # noqa: E741

    def put(i, y, x, facing, action, level=None, **inv):
        st.pos[i] = (y, x)
        st.facing[i] = facing
        if level is not None:
            st.level[i] = level
        for k, v in inv.items():
            st.inventory[i, I[k]] = v
        actions[i] = action

    def below(i, level, block, action, which=0, **inv):
        cells = np.argwhere(blocks[i, level] == block)
        y, x = cells[which % len(cells)]
        put(i, y + 1, x, 0, action, level=level, **inv)

    c = JW.PAD + JW.WORLD_SIZE // 2
    # crafting: a table from wood, then every recipe at a table and furnace
    below(0, JW.SURFACE, JW.GRASS, JF.A_PLACE_TABLE, which=100, wood=5)
    for i, act in enumerate([JF.A_MAKE_WP, JF.A_MAKE_SP, JF.A_MAKE_IP, JF.A_MAKE_WS, JF.A_MAKE_SS, JF.A_MAKE_IS,
                             JF.A_MAKE_DP, JF.A_MAKE_DS, JF.A_MAKE_BOW, JF.A_MAKE_ARROW, JF.A_MAKE_IA, JF.A_MAKE_DA,
                             JF.A_PLACE_TORCH, JF.A_PLACE_ENCHANT, JF.A_PLACE_FURNACE, JF.A_PLACE_STONE], 1):
        blocks[i, JW.SURFACE, c, c + 1] = JW.TABLE
        blocks[i, JW.SURFACE, c, c - 1] = JW.FURNACE
        put(i, c, c, 2, act, wood=5, stone=3, coal=2, iron=4, diamond=3)
    # descent and ascent on every seam
    for i, (level, block) in enumerate([(JW.SURFACE, JW.LADDER_DOWN), (JW.CAVE, JW.LADDER_UP),
                                        (JW.CAVE, JW.LADDER_DOWN), (JW.DEEP, JW.LADDER_UP),
                                        (JW.DEEP, JW.LADDER_DOWN), (JW.HELL, JW.LADDER_DOWN),
                                        (JW.ICE_REALM, JW.LADDER_UP)], 17):
        below(i, level, block, JF.A_DO)
    # mining by tool tier, with and without the tool; chests on each floor
    tiers = [(JW.DEEP, JW.RUBY, {}), (JW.DEEP, JW.RUBY, {"iron_pickaxe": 1}),
             (JW.DEEP, JW.SAPPHIRE, {"diamond_pickaxe": 1}), (JW.HELL, JW.OBSIDIAN, {}),
             (JW.HELL, JW.OBSIDIAN, {"diamond_pickaxe": 1}), (JW.CAVE, JW.DIAMOND, {"iron_pickaxe": 1}),
             (JW.CAVE, JW.COAL, {"wood_pickaxe": 1}), (JW.ICE_REALM, JW.CRYSTAL, {"diamond_pickaxe": 1}),
             (JW.SURFACE, JW.TREE, {}), (JW.HELL, JW.CHEST, {}), (JW.ICE_REALM, JW.CHEST, {}),
             (JW.CAVE, JW.STONE, {"wood_pickaxe": 1})]
    for i, (level, block, inv) in enumerate(tiers, 24):
        below(i, level, block, JF.A_DO, **inv)
    # melee on a weakened warden, then an adjacent warden at full health
    for i, (hp, action, time) in enumerate([(1, JF.A_DO, 0), (20, JF.A_NOOP, 1)], 36):
        wy, wx = st.mob_pos[i, JF.WARDEN]
        st.mob_health[i, JF.WARDEN] = hp
        st.mob_alive[i, JF.WARDEN] = True
        st.time[i] = time
        put(i, wy + 1, wx, 0, action, level=JW.DEEP)
    # an arrow down a clear ray at a zombie 3 tiles away, the same ray blocked,
    # and an ice bolt through two zombies on it
    z0 = JF.ZOMBIES.start
    for i, (wall, action) in enumerate([(False, JF.A_SHOOT), (True, JF.A_SHOOT), (False, JF.A_CAST_ICE)], 38):
        put(i, c, c, 2, action, level=JW.SURFACE, bow=1, arrow=3, frost_tome=1)
        st.mana[i] = 5
        st.time[i] = 159
        blocks[i, JW.SURFACE, c + 1 : c + 4, c] = JW.STONE if wall else JW.GRASS
        blocks[i, JW.SURFACE, c + 2 : c + 4, c] = JW.GRASS
        for j, d in enumerate((3, 2)):
            st.mob_pos[i, z0 + j] = (c + d, c)
            st.mob_alive[i, z0 + j] = True
            st.mob_level[i, z0 + j] = JW.SURFACE
            st.mob_health[i, z0 + j] = JF.ARROW_DAMAGE
    # potions of every colour, and a sleeper waking at dawn
    for i, action in enumerate([JF.A_DRINK_RED, JF.A_DRINK_GREEN, JF.A_DRINK_BLUE], 41):
        put(i, c, c, 2, action, potion_red=1, potion_green=1, potion_blue=1)
        st.health[i] = 5
    st.sleeping[44], st.time[44] = True, JENV.default_params.day_length - 1
    # starving: food, drink and energy at zero, the decay tick about to fire
    st.food[45] = st.drink[45] = st.energy[45] = 0
    st.decay_tick[45], st.health[45] = 9, 1
    return jax.tree_util.tree_map(jnp.asarray, st), actions


def test_hand_set_states_match_jax(jax_fns):
    st_j, actions = _hand_set_states(jax_fns)
    k = _keys(77)
    obs_j, st_j2, rew_j, done_j, _ = jax_fns["step"](k, st_j, jnp.asarray(actions), PARAMS)
    obs_t, st_t2, rew_t, done_t, _ = TENV.step_env(to_torch_state(st_j), torch.tensor(actions), TPARAMS,
                                                   _t(jax_fns["step_draws"](k)))
    assert_same_state(st_t2, st_j2, "hand-set")
    assert_obs_close(obs_t, obs_j)
    np.testing.assert_allclose(rew_t.numpy(), np.asarray(rew_j), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(done_t.numpy(), np.asarray(done_j))
    # the cases did what their JAX tests check
    ach, inv = st_t2.achievements.numpy(), st_t2.inventory.numpy()
    A, I = JF._ACH, JF.INV  # noqa: E741
    assert ach[0, A["place_table"]] and inv[1, I["wood_pickaxe"]] == 1 and inv[7, I["diamond_pickaxe"]] == 1
    assert inv[10, I["arrow"]] == JF.ARROWS_PER_CRAFT
    assert st_t2.level[17] == JW.CAVE and ach[17, A["enter_cave"]] and st_t2.level[22] == JW.ICE_REALM
    assert inv[24, I["ruby"]] == 0 and inv[25, I["ruby"]] == 1 and inv[28, I["obsidian"]] == 1
    assert not st_t2.mob_alive[36, JF.WARDEN] and ach[36, A["defeat_warden"]]
    assert st_t2.health[37] <= 9 - 3
    z0 = JF.ZOMBIES.start
    assert not st_t2.mob_alive[38, z0 + 1] and st_t2.mob_alive[39, z0]
    assert not st_t2.mob_alive[40, z0] and not st_t2.mob_alive[40, z0 + 1] and ach[40, A["ice_kill"]]
    assert done_t[45]


def _golden_draws():
    """The reset and step draws and the actions of
    tests/test_forager_golden.py::_rollout (reset seed 7, action seed 8)."""

    def body(rng, _):
        rng, k, ka = jax.random.split(rng, 3)
        return rng, (jax.random.uniform(k, (TF.NUM_STEP_DRAWS,)), jax.random.randint(ka, (), 0, JF.NUM_ACTIONS))

    _, (u, a) = jax.jit(lambda r: jax.lax.scan(body, r, None, 64))(jax.random.PRNGKey(8))
    reset = jax.jit(jax.vmap(_reset_draws_one))(jax.random.PRNGKey(7)[None])
    return reset, np.asarray(u), np.asarray(a)


def test_golden_pins_reproduced():
    reset, u, a = _golden_draws()
    obs, st = TENV.reset_from_draws(reset_draws(reset), TPARAMS)
    assert float(obs.sum()) == 87.0
    osum, rew = [], []
    for t in range(64):
        obs, st, r, d, _ = TENV.step_env(st, torch.tensor(a[t : t + 1]), TPARAMS, torch.tensor(u[t : t + 1]))
        osum.append(float(obs.sum()))
        rew.append(float(r[0]))
    np.testing.assert_allclose(
        osum[-8:], [87.8535, 87.8414, 87.8288, 87.5934, 87.5797, 87.5654, 87.5506, 87.7575], rtol=0, atol=2e-4
    )
    assert sum(rew) == 1.0
    assert st.pos[0].tolist() == [27, 27]
    assert int(st.health[0]) == 9 and int(st.time[0]) == 64
    assert int(st.blocks.long().sum()) == 111053


def test_own_draws_world_composition_and_seeds():
    """Worlds from the port's own generator meet the bands of
    tests/test_forager.py::test_world_composition, and other seeds give other
    worlds."""
    env, params = tmake("Craftax-Symbolic-v1")
    assert isinstance(env, TF.Forager)
    obs, st = env.reset(torch.Generator().manual_seed(0), 8, params)
    assert obs.shape == (8, TF.OBS_DIM) and torch.isfinite(obs).all()
    for b in st.blocks.numpy():
        counts = np.bincount(b[TW.SURFACE].ravel(), minlength=TW.NUM_BLOCK_TYPES)
        cave = np.bincount(b[TW.CAVE].ravel(), minlength=TW.NUM_BLOCK_TYPES)
        assert cave[TW.PATH] > 300 and cave[TW.DIAMOND] > 5
        assert counts[TW.LADDER_DOWN] == 2 and cave[TW.LADDER_UP] == 2
        assert counts[TW.GRASS] > 400 and counts[TW.TREE] > 20 and counts[TW.STONE] > 50
        assert counts[TW.WATER] > 20 and counts[TW.COAL] + counts[TW.IRON] > 5
        assert (b[TW.DEEP] == TW.RUBY).sum() > 5 and (b[: TW.DEEP] == TW.RUBY).sum() == 0
        assert (b[TW.HELL] == TW.CHEST).sum() >= 5 and (b[TW.ICE_REALM] == TW.CHEST).sum() >= 5
    _, st2 = env.reset(torch.Generator().manual_seed(1), 8, params)
    assert (st.blocks != st2.blocks).float().mean() > 0.05
    assert sorted(st.potion_map[0].tolist()) == [0, 1, 2]
    # random play under the port's own step draws, through auto-reset
    gen = torch.Generator().manual_seed(2)
    for _ in range(20):
        obs, st, r, d, info = env.step(gen, st, torch.randint(0, TF.NUM_ACTIONS, (8,), generator=gen), params)
        assert torch.isfinite(obs).all() and torch.isfinite(r).all()
