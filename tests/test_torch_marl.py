"""The port's multi-agent envs (``purejaxql_torch/envs/marl``) on the CPU
against the JAX package's: Spread, Skirmish on two maps and on type lists,
Kitchen on two layouts and MiniHanabi, each stepped from states carried
across from the JAX env with the same actions, its auto-reset lanes fed the
reset the JAX env makes from the same step key; the hand-set scenarios of
the JAX env tests in both packages; the reset draws by their statistics;
the Log wrapper's accounting over a run; the rollout manager and the
registry.

Ints and bools must agree bit for bit, floats within 1e-6 (XLA may turn a
division by a constant into a product with its reciprocal)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from purejaxql_torch.envs import marl as tmarl
from purejaxql_torch.envs.marl.base import CTRolloutManager as TManager
from purejaxql_torch.envs.marl.base import MARLLogState, MARLLogWrapper as TLog
from purejaxql_torch.envs.marl.hanabi import HanabiState
from purejaxql_torch.envs.marl.kitchen import KitchenState
from purejaxql_torch.envs.marl.skirmish import SkirmishDraws, SkirmishState
from purejaxql_torch.envs.marl.spread import SpreadDraws, SpreadState
from purejaxql_tpu.envs import marl as jmarl
from purejaxql_tpu.envs.marl.base import CTRolloutManager as JManager
from purejaxql_tpu.envs.marl.base import MARLLogWrapper as JLog
from purejaxql_tpu.envs.marl.kitchen import A_DOWN, A_INTERACT, A_LEFT, A_NOOP, H_ONION

torch.set_num_threads(1)


def _t(x):
    return torch.tensor(np.asarray(x))


def _draws_kitchen(state):
    return torch.empty(np.asarray(state.time).shape[0], 0)


# name, env kwargs (short horizons, small arenas: resets and fights happen),
# the state class, the reset's draws from the JAX reset state
CASES = {
    "spread": ("Spread-v0", dict(num_agents=3, max_steps=7), SpreadState,
               lambda s: SpreadDraws(_t(s.agent_pos), _t(s.landmark_pos))),
    "skirmish_2s3z": ("Skirmish-v0", dict(map_name="2s3z", arena=3.0, max_steps=12), SkirmishState,
                      lambda s: SkirmishDraws(_t(s.ally_pos), _t(s.enemy_pos))),
    "skirmish_2s1z_vs_3z": ("Skirmish-v0", dict(map_name="2s1z_vs_3z", arena=3.0, max_steps=12), SkirmishState,
                            lambda s: SkirmishDraws(_t(s.ally_pos), _t(s.enemy_pos))),
    # the YAML's lists arrive as lists
    "skirmish_lists": ("Skirmish-v0", dict(ally_types=[0, 0, 1], enemy_types=[0, 1], arena=3.5, max_steps=12),
                       SkirmishState, lambda s: SkirmishDraws(_t(s.ally_pos), _t(s.enemy_pos))),
    "kitchen_cramped": ("Kitchen-v0", dict(layout="cramped_room", max_steps=9), KitchenState, _draws_kitchen),
    "kitchen_ring": ("Kitchen-v0", dict(layout="coord_ring", max_steps=9, shaped_rewards=False), KitchenState,
                     _draws_kitchen),
    "hanabi": ("MiniHanabi-v0", dict(max_steps=12), HanabiState, lambda s: _t(s.deck)),
}
RANDOM_PLAY = sorted(CASES)
# the hand-set scenarios' single-unit skirmishes
CASES["shields"] = ("Skirmish-v0", dict(ally_types=(0,), enemy_types=(0,)), SkirmishState,
                    CASES["skirmish_2s3z"][3])
CASES["sight"] = ("Skirmish-v0", dict(ally_types=(0,), enemy_types=(1,)), SkirmishState, CASES["skirmish_2s3z"][3])


@functools.lru_cache(maxsize=None)
def _jax(case):
    """The JAX env of a case and its jitted, vmapped functions."""
    name, kw, _, _ = CASES[case]
    env = jmarl.make_marl(name, **kw)
    return env, {
        "reset": jax.jit(jax.vmap(env.reset)),
        "step": jax.jit(jax.vmap(env.step)),
        "avail": jax.jit(jax.vmap(env.get_avail_actions)),
        "obs": jax.jit(jax.vmap(env.get_obs)),
        "step1": jax.jit(env.step),
        "reset1": jax.jit(env.reset),
    }


def _torch_env(case):
    name, kw, _, _ = CASES[case]
    return tmarl.make_marl(name, **kw)


def to_torch(cls, jstate):
    return cls(**{f.name: _t(getattr(jstate, f.name)) for f in dataclasses.fields(cls)})


def assert_same(got, want, what):
    """Ints and bools bit for bit, floats within 1e-6."""
    want = np.asarray(want)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0, err_msg=what)
    else:
        np.testing.assert_array_equal(got.astype(want.dtype), want, err_msg=what)


def assert_dicts(got, want, what):
    assert set(got) == set(want), (what, set(got), set(want))
    for k in want:
        assert_same(got[k], want[k], f"{what}[{k}]")


def assert_states(cls, got, want, what="state"):
    for f in dataclasses.fields(cls):
        assert_same(getattr(got, f.name), getattr(want, f.name), f"{what}.{f.name}")


def random_legal(rng, masks, agents, attack_from=None):
    """A legal action an env per agent (numpy), the attacks (indices from
    ``attack_from``) and Kitchen's interact weighted up so that they happen."""
    acts = {}
    for a in agents:
        m = np.asarray(masks[a], np.float64)
        w = m.copy()
        if attack_from is not None:
            w[:, attack_from:] *= 6.0
        p = w / w.sum(1, keepdims=True)
        acts[a] = np.array([rng.choice(m.shape[1], p=row) for row in p], np.int32)
    return acts


@pytest.mark.parametrize("case", RANDOM_PLAY)
def test_env_steps_match_jax(case):
    """Random legal play of 48 envs for 30 steps: each step, from the JAX
    state carried across, the port gives the JAX env's obs, rewards, dones,
    infos, new state and new masks; the reset lanes get the JAX env's reset
    from the same keys."""
    jenv, jf = _jax(case)
    tenv = _torch_env(case)
    _, _, cls, draws_of = CASES[case]
    n, steps = 48, 30
    assert tenv.agents == jenv.agents and tenv.num_agents == jenv.num_agents
    for a in jenv.agents:
        assert tenv.action_space(a).n == jenv.action_space(a).n
        assert tenv.observation_space(a).shape == tuple(jenv.observation_space(a).shape)
    jobs, jstate = jf["reset"](jax.random.split(jax.random.PRNGKey(7), n))
    tstate = tenv.reset_env(draws_of(jstate))
    assert_states(cls, tstate, jstate, "reset")
    assert_dicts(tenv.get_obs(tstate), jobs, "reset obs")
    rng = np.random.RandomState(RANDOM_PLAY.index(case))
    attack_from = 5 if case.startswith("skirmish") else (A_INTERACT if case.startswith("kitchen") else None)
    ended = 0
    for t in range(steps):
        tstate = to_torch(cls, jstate)
        masks = jf["avail"](jstate)
        assert_dicts(tenv.get_avail_actions(tstate), masks, f"avail t={t}")
        acts = random_legal(rng, masks, jenv.agents, attack_from)
        keys = jax.random.split(jax.random.PRNGKey(1000 + t), n)
        jo, jstate, jr, jd, ji = jf["step"](keys, jstate, {a: jnp.asarray(v) for a, v in acts.items()})
        _, reset_state = jf["reset"](keys)
        to, ts, tr, td, ti = tenv.step(tstate, {a: torch.tensor(v).long() for a, v in acts.items()},
                                       draws_of(reset_state))
        assert_dicts(to, jo, f"obs t={t}")
        assert_dicts(tr, jr, f"rewards t={t}")
        assert_dicts(td, jd, f"dones t={t}")
        assert_dicts(ti, ji, f"infos t={t}")
        assert_states(cls, ts, jstate, f"state t={t}")
        ended += int(np.asarray(jd["__all__"]).sum())
    assert ended > 0  # the auto-reset lanes were exercised


# ---- the hand-set scenarios of the JAX env tests, in both packages ------------


def _both_step(case, jstate, acts, key=1):
    """One unbatched step of a hand-set state in both packages (the port at
    E = 1): compares everything and returns the port's outputs."""
    _, jf = _jax(case)
    tenv = _torch_env(case)
    _, _, cls, draws_of = CASES[case]
    k = jax.random.PRNGKey(key)
    jo, js, jr, jd, ji = jf["step1"](k, jstate, {a: jnp.asarray(v, jnp.int32) for a, v in acts.items()})
    _, reset_state = jf["reset1"](k)
    batched = lambda s: jax.tree_util.tree_map(lambda x: jnp.asarray(x)[None], s)  # noqa: E731
    out = tenv.step(to_torch(cls, batched(jstate)), {a: torch.tensor([v]).long() for a, v in acts.items()},
                    draws_of(batched(reset_state)))
    for got, want, what in zip(out, (jo, batched(js), jr, jd, ji), ("obs", "state", "rewards", "dones", "infos")):
        if what == "state":
            assert_states(cls, got, want)
        else:
            assert_dicts(got, jax.tree_util.tree_map(lambda x: jnp.asarray(x)[None], want), what)
    return js, out


def test_skirmish_shields_absorb_then_regen_in_both():
    """tests/test_skirmish.py::test_shields_absorb_then_regen: a ranged hit
    lands on the shield (3 -> 2, health untouched, reward > 0); left unhit,
    the shield regenerates."""
    jenv, _ = _jax("shields")
    _, state = jenv.reset(jax.random.PRNGKey(0))
    state = state.replace(ally_pos=state.enemy_pos[0][None] + jnp.asarray([[2.0, 0.0]]))
    js, (_, ts, tr, _, _) = _both_step("shields", state, {"ally_0": 5})
    assert float(ts.enemy_shield[0, 0]) == 2.0
    assert float(ts.enemy_health[0, 0]) == float(state.enemy_health[0])
    assert float(tr["__all__"][0]) > 0.0
    s = js.replace(ally_pos=jnp.asarray([[-8.0, -8.0]]))
    trace = []
    for t in range(6):
        s, (_, ts, _, td, _) = _both_step("shields", s, {"ally_0": 0}, key=10 + t)
        trace.append(float(ts.enemy_shield[0, 0]))
    assert not bool(td["__all__"][0]) and max(trace) > 2.0, trace


def test_skirmish_sight_gates_observation_in_both():
    """tests/test_skirmish.py::test_sight_range_gates_observation: an enemy
    beyond the ranged ally's sight reads as zeros, in sight it shows."""
    jenv, _ = _jax("sight")
    tenv = _torch_env("sight")
    _, state = jenv.reset(jax.random.PRNGKey(0))
    for enemy_x, visible in ((6.0, False), (-3.0, True)):
        s = state.replace(ally_pos=jnp.asarray([[-6.0, 0.0]]), enemy_pos=jnp.asarray([[enemy_x, 0.0]]))
        want = jenv.get_obs(s)["ally_0"]
        got = tenv.get_obs(to_torch(SkirmishState, jax.tree_util.tree_map(lambda x: jnp.asarray(x)[None], s)))
        assert_same(got["ally_0"][0], want, "obs")
        enemy_slot = got["ally_0"][0, 6:]
        assert bool((enemy_slot != 0).any()) == visible
        assert float(enemy_slot[4]) == float(visible)


def test_kitchen_counter_pass_in_both():
    """tests/test_kitchen.py::test_counter_pass: take an onion, place it on a
    counter, pick it back, every step equal in both packages."""
    jenv, _ = _jax("kitchen_cramped")
    _, state = jenv.reset(jax.random.PRNGKey(0))
    script = [A_LEFT, A_INTERACT, A_DOWN, A_DOWN, A_LEFT, A_INTERACT, A_INTERACT]
    held = []
    for t, a0 in enumerate(script):
        state, (_, ts, _, _, _) = _both_step("kitchen_cramped", state, {"agent_0": a0, "agent_1": A_NOOP}, key=t)
        held.append(int(ts.held[0, 0]))
    assert held[1] == H_ONION and held[5] == 0 and held[6] == H_ONION
    assert int(ts.counter_items.sum()) == 0


def _hanabi_act(env, state, action):
    cur = int(state.cur_player)
    return {env.agents[cur]: action, env.agents[1 - cur]: env.A_NOOP}


@pytest.mark.parametrize("kind", ["color", "rank"])
def test_hanabi_hints_update_knowledge_in_both(kind):
    """tests/test_hanabi.py::test_hint_{color,rank}_updates_knowledge: the
    hinted partner cards are identified, the others lose the hinted value,
    and the hint costs a token."""
    jenv, _ = _jax("hanabi")
    _, state = jenv.reset(jax.random.PRNGKey(3 if kind == "color" else 4))
    partner = 1 - int(state.cur_player)
    cards = np.asarray(state.hands[partner])
    if kind == "color":
        value, base, know, of = int(cards[0]) // jenv.R, 2 * jenv.H, "know_color", lambda c: c // jenv.R
    else:
        value, base, know, of = int(cards[1]) % jenv.R, 2 * jenv.H + jenv.C, "know_rank", lambda c: c % jenv.R
    _, (_, ts, _, _, _) = _both_step("hanabi", state, _hanabi_act(jenv, state, base + value))
    k = getattr(ts, know)[0, partner].numpy()
    for h in range(jenv.H):
        if of(cards[h]) == value:
            assert k[h, value] and k[h].sum() == 1
        else:
            assert not k[h, value]
    assert int(ts.info_tokens[0]) == jenv.max_info - 1


def test_hanabi_lives_exhaustion_in_both():
    """tests/test_hanabi.py::test_lives_exhaustion_ends_episode: the last
    life lost on an unplayable card ends the episode, which auto-resets."""
    jenv, _ = _jax("hanabi")
    _, state = jenv.reset(jax.random.PRNGKey(0))
    cur = int(state.cur_player)
    state = state.replace(lives=jnp.asarray(1, jnp.int32), hands=state.hands.at[cur, 0].set(jenv.R - 1))
    _, (_, ts, tr, td, _) = _both_step("hanabi", state, _hanabi_act(jenv, state, jenv.H))
    assert bool(td["__all__"][0]) and int(ts.time[0]) == 0 and float(tr["__all__"][0]) == 0.0


# ---- reset draws, the Log wrapper, the manager, the registry ------------------


def test_reset_draws_by_their_statistics():
    """Spread's positions uniform in [-1, 1); Skirmish's allies on the left
    quarter, enemies on the right; Hanabi's deck a permutation of its card
    types, its first card a type drawn in proportion to its copies."""
    gen = torch.Generator().manual_seed(0)
    n = 4000
    d = tmarl.make_marl("Spread-v0").reset_draws(gen, n)
    for x in (d.agent_pos, d.landmark_pos):
        assert x.min() >= -1.0 and x.max() < 1.0 and abs(x.mean().item()) < 0.02
        assert abs(x.var().item() - 1 / 3) < 0.02
    env = tmarl.make_marl("Skirmish-v0", map_name="2s3z")
    d = env.reset_draws(gen, n)
    half = env.arena / 2
    assert d.ally_pos[..., 0].min() >= -half and d.ally_pos[..., 0].max() <= -half / 2
    assert d.enemy_pos[..., 0].min() >= half / 2 and d.enemy_pos[..., 0].max() <= half
    for x in (d.ally_pos[..., 1], d.enemy_pos[..., 1]):
        assert x.min() >= -half and x.max() <= half and abs(x.mean().item()) < 0.1
    env = tmarl.make_marl("MiniHanabi-v0")
    deck = env.reset_draws(gen, n)
    jenv = jmarl.make_marl("MiniHanabi-v0")
    types = np.sort(np.asarray(jenv._deck_types))
    assert (np.sort(deck.numpy(), 1) == types).all()
    freq = np.bincount(deck[:, 0].numpy(), minlength=env.C * env.R) / n
    want = np.bincount(types, minlength=env.C * env.R) / len(types)
    assert np.abs(freq - want).max() < 0.025
    _, state = env.reset(gen, 8)
    assert (state.hands.reshape(8, -1) == state.deck[:, :6]).all()


@pytest.mark.parametrize("case", ["kitchen_cramped", "hanabi"])
def test_log_wrapper_accounts_a_run_as_jax(case):
    """The Log-wrapped rollout manager of each package over the same run (the
    same actions and resets, each package stepping its own state, 16 envs x
    40 steps, integer rewards): the returned_episode_* infos and the carried
    returns and lengths equal step for step."""
    name, kw, cls, draws_of = CASES[case]
    n = 16
    jm = JManager(JLog(jmarl.make_marl(name, **kw)), batch_size=n)
    tlog = TLog(tmarl.make_marl(name, **kw))
    tm = TManager(tlog, n)
    assert (tm.max_action_space, tm.obs_size) == (jm.max_action_space, jm.obs_size)
    _, js = jm.batch_reset(jax.random.PRNGKey(0))
    jenv, jf = _jax(case)
    ts = MARLLogState(to_torch(cls, js[0]), *(_t(x) for x in js[1:]))
    rng = np.random.RandomState(1)
    jstep = jax.jit(jm.batch_step)
    ended = 0
    for t in range(40):
        masks = jf["avail"](js[0])
        acts = random_legal(rng, masks, jenv.agents, A_INTERACT if case.startswith("kitchen") else None)
        key = jax.random.PRNGKey(500 + t)
        _, js, jr, jd, ji = jstep(key, js, {a: jnp.asarray(v) for a, v in acts.items()})
        _, reset_state = jf["reset"](jax.random.split(key, n))
        _, ts, _, _, ti = tlog.step(ts, {a: torch.tensor(v).long() for a, v in acts.items()}, draws_of(reset_state))
        assert_dicts(ti, ji, f"infos t={t}")
        for got, want in zip((ts.episode_returns, ts.episode_lengths), js[1:3]):
            assert_same(got, want, f"carry t={t}")
        ended += int(np.asarray(jd["__all__"]).sum())
    assert ended >= n


def test_registry_and_aliases():
    for name, cls in (("Spread-v0", "Spread"), ("simple_spread", "Spread"), ("Skirmish-v0", "Skirmish"),
                      ("HeuristicEnemySMAX", "Skirmish"), ("Kitchen-v0", "Kitchen"), ("overcooked", "Kitchen"),
                      ("MiniHanabi-v0", "MiniHanabi"), ("hanabi", "MiniHanabi")):
        assert type(tmarl.make_marl(name)).__name__ == cls
    with pytest.raises(ValueError, match="Registered"):
        tmarl.make_marl("MPE_simple_spread_v3")
    env = tmarl.make_marl("Skirmish-v0", map_name="2s1z_vs_3z")
    assert env.num_agents == 3 and env.enemy_types == (1, 1, 1)
