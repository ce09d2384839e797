"""The port's Craftax fast program on the CPU, against the JAX package: the
repair of FUSED_ROLLOUT with a batched env mode, the packed rows of the reset
bank, its serve and scatter, BankedResetVecEnv, FAST_TARGETS' minibatch step
and trainer, SKIP_NOOP_PERMUTE and the cuda policy (the twins of
tests/test_reset_bank.py and tests/test_fast_defaults.py::
test_craftax_default_gets_bank_and_fast_targets)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from purejaxql_tpu.algo.pqn import make_train as jax_make_train
from purejaxql_tpu.core.config import compose as jax_compose
from purejaxql_tpu.core.optim import make_optimizer as jax_make_optimizer
from purejaxql_tpu.core.schedules import lr_schedule as jax_lr_schedule
from purejaxql_tpu.envs import wrappers as jw
from purejaxql_tpu.envs.classic.cartpole import CartPoleState as JCartPoleState
from purejaxql_tpu.envs.gridworld.forager import ForagerState as JForagerState
from purejaxql_tpu.models.qnet import QNetwork as JQNetwork
from purejaxql_torch.algo import pqn
from purejaxql_torch.core import checkpoint as tckpt
from purejaxql_torch.core.config import compose, derive_pqn_schedule_keys
from purejaxql_torch.core.optim import make_optimizer
from purejaxql_torch.core.schedules import lr_schedule
from purejaxql_torch.envs import make as tmake
from purejaxql_torch.envs import wrappers as tw
from purejaxql_torch.envs.classic.cartpole import CartPoleState as TCartPoleState
from purejaxql_torch.envs.gridworld.forager import ForagerState as TForagerState
from purejaxql_torch.models.batch_renorm import BatchRenorm as TBatchRenorm
from purejaxql_torch.models.qnet import BatchNorm as TBatchNorm
from purejaxql_torch.models.qnet import QNetwork as TQNetwork
from purejaxql_torch.models.qnet import frozen_statistics

torch.set_num_threads(1)

OBS_DIM, N_ACTIONS = 2883, 34
_JAX_CLASS = {tw.LogEnvState: jw.LogEnvState, TCartPoleState: JCartPoleState, TForagerState: JForagerState}
BATCHED = {
    "optimistic": {"USE_OPTIMISTIC_RESETS": True, "OPTIMISTIC_RESET_RATIO": 4},
    "batch_env": {"BATCH_ENV": True},
    "optimistic_bank": {"USE_OPTIMISTIC_RESETS": True, "OPTIMISTIC_RESET_RATIO": 4, "RESET_BANK": 16},
}


def _overrides(**kw):
    return [
        "TOTAL_TIMESTEPS=2048", "TOTAL_TIMESTEPS_DECAY=2048", "NUM_ENVS=8", "NUM_STEPS=16",
        "NUM_MINIBATCHES=2", "NUM_EPOCHS=2", "HIDDEN_SIZE=32", "TEST_DURING_TRAINING=False",
        *(f"{k}={v}" for k, v in kw.items()),
    ]


def tiny(alg="pqn_cartpole", **kw):
    return compose(alg=alg, overrides=["DEVICE=cpu", *_overrides(**kw)])


def _to_jax(tree):
    """A port state tree (tuples, the port's dataclasses) as the JAX
    package's, field for field."""
    if isinstance(tree, tuple):
        return tuple(_to_jax(t) for t in tree)
    if dataclasses.is_dataclass(tree):
        return _JAX_CLASS[type(tree)](**{f.name: _to_jax(getattr(tree, f.name)) for f in dataclasses.fields(tree)})
    return jnp.asarray(tree.numpy())


def _bits(x):
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8)


def _assert_same_bits(got_tree, want_tree):
    got, want = tw.tree_leaves(got_tree), jax.tree_util.tree_leaves(want_tree)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.from_numpy(np.array(w)).dtype, i
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w), err_msg=f"leaf {i}")


@pytest.mark.parametrize("mode", sorted(BATCHED))
def test_fused_rollout_with_a_batched_env_mode_raises_as_jax(mode):
    """FUSED_ROLLOUT with USE_OPTIMISTIC_RESETS (with or without RESET_BANK)
    or BATCH_ENV: the JAX trainer raises ValueError (pqn.py:243-258, mode !=
    "split"); so does the port, which ran the fused kernel and dropped the
    batched mode before."""
    kw = {"FUSED_ROLLOUT": True, **BATCHED[mode]}
    with pytest.raises(ValueError, match="FUSED_ROLLOUT"):
        jax_make_train(jax_compose(alg="pqn_cartpole", overrides=_overrides(**kw)))
    with pytest.raises(ValueError, match="FUSED_ROLLOUT"):
        pqn.make_train(tiny(**kw))
    assert not pqn.fused_ff_eligible(tiny(**BATCHED[mode]))


def _edge_tree(n):
    rng = np.random.RandomState(3)
    specials = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 1e-38, 3.14, -7.0], np.float32)
    nan_payload = np.array([0x7FC00001, 0xFFC12345], np.uint32).view(np.float32)
    ret = np.resize(np.concatenate([specials, nan_payload]), (n, 4)).astype(np.float32)
    return (
        rng.randint(-128, 128, (n, 3, 4)).astype(np.int8),
        rng.rand(n, 5) < 0.5,
        rng.randint(-(2**30), 2**30, (n, 7)).astype(np.int32),
        ret,
        np.arange(n, dtype=np.int32),
        rng.randint(0, 256, (n, 2)).astype(np.uint8),
    )


def test_pack_rows_equal_jax_and_round_trip_in_bits():
    """bool, int8, uint8, int32 and float32 leaves (NaN with two payloads,
    +-inf, -0.0, a denormal neighbour): the port's packed buffers equal the
    JAX package's byte for byte, and unpacking restores every leaf's bits
    and dtype."""
    tree = _edge_tree(10)
    w8, w32 = tw.pack_rows(tuple(torch.from_numpy(x) for x in tree))
    j8, j32 = jw._pack_rows(tuple(jnp.asarray(x) for x in tree))
    assert w8.dtype == torch.int8 and w32.dtype == torch.int32
    np.testing.assert_array_equal(w8.numpy(), np.asarray(j8))
    np.testing.assert_array_equal(w32.numpy(), np.asarray(j32))
    out = tw.unpack_rows(w8, w32, tuple(torch.from_numpy(x) for x in tree))
    for got, want in zip(out, tree):
        assert got.dtype == torch.from_numpy(want).dtype and got.shape == want.shape
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def _log_state(env_name, n, seed, fresh=False):
    """(obs, Log state) of n reset envs, their counters moved unless ``fresh``."""
    env, params = tmake(env_name)
    obs, state = tw.Log(env).reset_env(torch.Generator().manual_seed(seed), n, params)
    if fresh:
        return obs, state
    rng = np.random.RandomState(seed)
    state.episode_returns = torch.tensor(rng.randn(n).astype(np.float32))
    state.timestep = torch.tensor(rng.randint(0, 99, n).astype(np.int32))
    return obs, state


@pytest.mark.parametrize("env_name", ["CartPole-v1", "Craftax-Symbolic-v1"])
def test_packed_log_state_equals_jax_and_round_trips(env_name):
    """A Log state over CartPole's and over Forager's (the nested dataclass
    order: Log's env state first, then its counters; Forager's int8 block
    stack, bools and int32 fields), with the observations, as the bank
    packs them: the same buffers as the JAX package's ``_pack_rows`` of the
    same values, and an exact round trip."""
    tree = _log_state(env_name, 6, 1)
    w8, w32 = tw.pack_rows(tree)
    j8, j32 = jw._pack_rows(_to_jax(tree))
    np.testing.assert_array_equal(w8.numpy(), np.asarray(j8))
    np.testing.assert_array_equal(w32.numpy(), np.asarray(j32))
    _assert_same_bits(tw.unpack_rows(w8, w32, tree), _to_jax(tree))
    if env_name != "CartPole-v1":
        assert w8.shape[1] > 5 * 56 * 56 + 56 * 56  # the block stack and growth map are 1-byte columns


@pytest.mark.parametrize("n_done", [0, 2, 4, 9, 16])
def test_serve_and_scatter_equal_jax_in_bits(n_done):
    """The deterministic serve on the same (done, being_reset, cand, bank,
    stepped): the port's ``serve_resets`` against JAX's ``_unpack_rows`` of
    the gathered bank rows and ``_scatter_resets``, every leaf equal in
    bits; with more dones than the 4 candidates (9, 16) exactly 4 done envs
    take a bank row and the rest keep their stepped state (deferred)."""
    E, K, BANK = 16, 4, 8
    gen = torch.Generator().manual_seed(n_done)
    stepped = _log_state("CartPole-v1", E, 2)
    bank = tw.pack_rows(_log_state("CartPole-v1", BANK, 3, fresh=True))
    done = torch.zeros(E, dtype=torch.bool)
    done[torch.randperm(E, generator=gen)[:n_done]] = True
    being_reset = tw.sample_being_reset(gen, done, K)
    cand = torch.randint(0, BANK, (K,), generator=gen)
    got = tw.serve_resets(done, being_reset, cand, bank, stepped)
    jstepped = _to_jax(stepped)
    j8, j32 = (jnp.asarray(b.numpy()) for b in bank)
    jc = jnp.asarray(cand.numpy())
    resets = jw._unpack_rows(j8[jc], j32[jc], jstepped)
    want = jw._scatter_resets(jnp.asarray(done.numpy()), jnp.asarray(being_reset.numpy()), resets, jstepped)
    _assert_same_bits(got, want)
    fresh = (got[1].timestep == 0) & (stepped[1].timestep != 0)
    assert int(fresh.sum()) == min(n_done, K) and not bool((fresh & ~done).any())


def test_serve_on_forager_equals_jax_in_bits():
    """The same on Forager's Log states: 8 envs, 3 done, 2 candidates from a
    bank of 4 worlds; the deferred done env keeps its stepped world."""
    stepped = _log_state("Craftax-Symbolic-v1", 8, 4)
    bank = tw.pack_rows(_log_state("Craftax-Symbolic-v1", 4, 5, fresh=True))
    done = torch.tensor([0, 1, 0, 0, 1, 1, 0, 0], dtype=torch.bool)
    being_reset, cand = torch.tensor([5, 1]), torch.tensor([3, 0])
    got = tw.serve_resets(done, being_reset, cand, bank, stepped)
    jstepped = _to_jax(stepped)
    j8, j32 = (jnp.asarray(b.numpy()) for b in bank)
    resets = jw._unpack_rows(j8[jnp.asarray([3, 0])], j32[jnp.asarray([3, 0])], jstepped)
    want = jw._scatter_resets(jnp.asarray(done.numpy()), jnp.asarray([5, 1]), resets, jstepped)
    _assert_same_bits(got, want)
    assert torch.equal(got[1].env_state.blocks[4], stepped[1].env_state.blocks[4])
    assert got[1].timestep.tolist() == [t if i not in (1, 5) else 0 for i, t in enumerate(stepped[1].timestep.tolist())]


def test_banked_reset_semantics():
    """Twin of tests/test_reset_bank.py::test_banked_reset_semantics: the
    bank holds bank_size packed rows; the cursor moves by num_resets (2) on
    ticks 0, 5, 10, ... (one burst each, counted); done envs get fresh
    (time 0) states from the bank, up to num_resets a step, the rest
    deferred; the envs that are not done are the stepped ones (time + 1)."""
    env, params = tmake("CartPole-v1")
    wenv = tw.BankedResetVecEnv(tw.Log(env), num_envs=8, reset_ratio=4, bank_size=16, refresh_every=5)
    gen = torch.Generator().manual_seed(0)
    obs, state = wenv.reset(gen, 8, params)
    assert state.bank_w32.shape[0] == 16 and state.cursor == 0 and state.tick == 0
    bursts0 = tw.BankedResetVecEnv.refreshes
    done_seen = False
    for t in range(60):
        before = state.env_state.env_state.time.clone()
        obs, state, r, done, info = wenv.step(gen, state, torch.zeros(8, dtype=torch.long), params)
        bursts = t // 5 + 1
        assert state.cursor == (2 * bursts) % 16 and state.tick == t + 1
        assert tw.BankedResetVecEnv.refreshes - bursts0 == bursts
        times = state.env_state.env_state.time
        assert torch.equal(times[~done], before[~done] + 1)
        if bool(done.any()):
            done_seen = True
            assert int((times[done] == 0).sum()) >= min(int(done.sum()), 2)
    assert done_seen


def _cartpole_run(alg="pqn_cartpole", **kw):
    out = pqn.make_train(tiny(alg, **kw))()
    return out


def test_reset_bank_trains_and_matches_quality():
    """Twin of ::test_reset_bank_trains_and_matches_quality: CartPole under
    optimistic resets, banked (bank 64, refresh every 4) and not, the same
    budget and seed: the banked run's last-16 mean return above half the
    optimistic one's."""
    kw = dict(TOTAL_TIMESTEPS=32768, TOTAL_TIMESTEPS_DECAY=32768, NUM_ENVS=32, NUM_STEPS=8, HIDDEN_SIZE=64,
              USE_OPTIMISTIC_RESETS=True, OPTIMISTIC_RESET_RATIO=8)
    out_o = _cartpole_run(**kw)
    out_b = _cartpole_run(**kw, RESET_BANK=64, RESET_BANK_REFRESH_EVERY=4)
    assert isinstance(out_b["runner_state"][1][1], tw.BankedResetState)
    r_o = out_o["metrics"]["returned_episode_returns"][-16:].mean().item()
    r_b = out_b["metrics"]["returned_episode_returns"][-16:].mean().item()
    assert np.isfinite(r_b) and r_b > 0.5 * r_o, (r_o, r_b)


def test_reset_bank_on_forager_smoke():
    """Twin of ::test_reset_bank_on_forager_smoke: pqn_craftax on Forager at
    32 envs, reset ratio 8, a bank of 16 refreshed every 4 steps, 8 updates:
    the env-step count, and 2 bursts."""
    config = tiny("pqn_craftax", TOTAL_TIMESTEPS=256, TOTAL_TIMESTEPS_DECAY=256, NUM_ENVS=32, NUM_STEPS=1,
                  NUM_MINIBATCHES=1, NUM_EPOCHS=1, OPTIMISTIC_RESET_RATIO=8, RESET_BANK=16,
                  RESET_BANK_REFRESH_EVERY=4, HIDDEN_SIZE=64, NUM_LAYERS=2, COLLECT_METRICS=False)
    bursts0 = tw.BankedResetVecEnv.refreshes
    out = pqn.make_train(config)()
    assert out["runner_state"][0].timesteps == 256 and out["metrics"] == {}
    assert tw.BankedResetVecEnv.refreshes - bursts0 == 2


def _qnet_pair(seed):
    """The flax QNetwork with pqn_craftax's input BatchRenorm (obs 2883, H 64,
    2 layers) and the port's on the same weights, every param moved by 0.05
    randn and the running statistics off their init."""
    jnet = JQNetwork(action_dim=N_ACTIONS, hidden_size=64, num_layers=2, norm_input=True,
                     input_norm_type="batch_renorm")
    variables = jnet.init(jax.random.PRNGKey(seed), jnp.zeros((1, OBS_DIM)), train=False)
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(lambda x: np.asarray(x) + 0.05 * rng.randn(*x.shape).astype(np.float32),
                                    variables["params"])
    stats = dict(jax.tree_util.tree_map(np.asarray, variables["batch_stats"])["BatchRenorm_0"])
    stats["mean"] = rng.randn(OBS_DIM).astype(np.float32) * 0.1
    stats["var"] = (1 + np.abs(rng.randn(OBS_DIM))).astype(np.float32)
    variables = {"params": params, "batch_stats": {"BatchRenorm_0": stats}}
    tnet = TQNetwork(OBS_DIM, N_ACTIONS, hidden_size=64, num_layers=2, norm_input=True,
                     input_norm_type="batch_renorm")
    tnet.load_state_dict(tckpt.params_from_flax(variables))
    return jnet, variables, tnet


def _forager_like_obs(rng, n):
    obs = (rng.rand(n, OBS_DIM) < 0.03).astype(np.float32)
    obs[:, -48:] = rng.rand(n, 48).astype(np.float32)
    return obs


def test_fast_targets_learn_step_matches_jax():
    """Three FAST_TARGETS minibatch steps with pqn_craftax's input
    BatchRenorm from the same weights and minibatches, against JAX's
    formulation composed as pqn.py:459-503 composes it: the bootstrap
    forward on next_obs in train mode with the pre-step statistics, its
    update discarded; the loss's train-mode forward on obs alone, its update
    kept; clip + RAdam with pqn_craftax's LR schedule. Loss within 1e-5
    relative; params and batch statistics within 1e-5; steps 3, one a grad
    step."""
    config = derive_pqn_schedule_keys(compose(alg="pqn_craftax", overrides=["DEVICE=cpu"]))
    jnet, variables, tnet = _qnet_pair(seed=3)
    tx = jax_make_optimizer(config["MAX_GRAD_NORM"], jax_lr_schedule(config))
    params, batch_stats = variables["params"], variables["batch_stats"]
    opt_state = tx.init(params)
    opt = make_optimizer(tnet.parameters(), config["MAX_GRAD_NORM"], lr_schedule(config))
    rng = np.random.RandomState(4)
    gamma = config["GAMMA"]
    for _ in range(3):
        obs, next_obs = _forager_like_obs(rng, 128), _forager_like_obs(rng, 128)
        act = rng.randint(0, N_ACTIONS, 128).astype(np.int32)
        rew = rng.choice([0.0, 0.1, -0.1, 1.0], 128).astype(np.float32)
        done = rng.rand(128) < 0.1
        q_next, _discarded = jnet.apply({"params": params, "batch_stats": batch_stats}, jnp.asarray(next_obs),
                                        train=True, mutable=["batch_stats"])
        tgt = jnp.asarray(rew) + (1 - jnp.asarray(done)) * gamma * jnp.max(q_next, axis=-1)

        def loss_fn(p):
            q, upd = jnet.apply({"params": p, "batch_stats": batch_stats}, jnp.asarray(obs), train=True,
                                mutable=["batch_stats"])
            chosen = jnp.take_along_axis(q, jnp.asarray(act)[:, None], axis=-1).squeeze(-1)
            return 0.5 * jnp.square(chosen - tgt).mean(), upd

        (jloss, upd), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        batch_stats = upd["batch_stats"]
        loss, _ = pqn.learn_minibatch_fast_td(tnet, opt, torch.tensor(obs), torch.tensor(act).long(),
                                              torch.tensor(next_obs), torch.tensor(rew), torch.tensor(done), gamma)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
        want = tckpt.params_from_flax({"params": jax.tree_util.tree_map(np.asarray, params),
                                       "batch_stats": jax.tree_util.tree_map(np.asarray, batch_stats)})
        for name, got in tnet.state_dict().items():
            np.testing.assert_allclose(got.numpy(), want[name].numpy(), atol=1e-5, rtol=0, err_msg=name)
    assert int(tnet.BatchRenorm_0.steps) == 3


def test_frozen_statistics_normalize_as_train_mode_and_keep_the_buffers():
    """Inside ``frozen_statistics`` a train-mode forward gives the train-mode
    output bit for bit and leaves every BatchNorm's and BatchRenorm's
    buffers (steps too) as they were; after it, the buffers move again."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(32, 6, generator=gen)
    for input_norm, norm_type, cls in (("batch_renorm", "batch_norm", TBatchRenorm),
                                       ("batch_norm", "batch_norm", TBatchNorm)):
        net = TQNetwork(6, 3, hidden_size=16, norm_type=norm_type, norm_input=True, input_norm_type=input_norm,
                        generator=gen)
        before = {k: v.clone() for k, v in net.state_dict().items()}
        with torch.no_grad(), frozen_statistics(net):
            frozen = net(x, train=True)
        assert all(torch.equal(v, before[k]) for k, v in net.state_dict().items())
        assert not any(m.frozen for m in net.modules() if isinstance(m, cls))
        with torch.no_grad():
            assert torch.equal(net(x, train=True), frozen)
        assert not all(torch.equal(v, before[k]) for k, v in net.state_dict().items())


def _params(out):
    return [p.detach() for p in out["runner_state"][0].network.parameters()]


def _td_kw(**kw):
    return {"TOTAL_TIMESTEPS": 4096, "TOTAL_TIMESTEPS_DECAY": 4096, "HIDDEN_SIZE": 64, "Q_LAMBDA": False,
            "LAMBDA": 0, "COLLECT_METRICS": False, **kw}


def test_fast_targets_identical_gradients():
    """Twin of ::test_fast_targets_identical_gradients: CartPole, 1-step TD
    on a layer_norm trunk, the concat form against FAST_TARGETS, the same
    seed: params within rtol 2e-4, atol 2e-5."""
    kw = _td_kw(NUM_ENVS=16, NUM_STEPS=8, NUM_MINIBATCHES=2, NUM_EPOCHS=1, SEED=3)
    for a, b in zip(_params(_cartpole_run(**kw)), _params(_cartpole_run(**kw, FAST_TARGETS=True))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=2e-5)


def test_fast_targets_rejects_batch_stats_norms():
    for make, cfg in ((pqn.make_train, tiny(FAST_TARGETS=True, NORM_TYPE="batch_norm", Q_LAMBDA=False)),
                      (jax_make_train, jax_compose(alg="pqn_cartpole", overrides=_overrides(
                          FAST_TARGETS=True, NORM_TYPE="batch_norm", Q_LAMBDA=False)))):
        with pytest.raises(ValueError, match="FAST_TARGETS"):
            make(cfg)


def test_skip_noop_permute_matches_to_float_tolerance():
    """Twin of ::test_skip_noop_permute_matches_to_float_tolerance: one
    minibatch, FAST_TARGETS (so SKIP_NOOP_PERMUTE by default) against
    SKIP_NOOP_PERMUTE=False: params within rtol 2e-4, atol 2e-5."""
    kw = _td_kw(NUM_ENVS=32, NUM_STEPS=4, NUM_MINIBATCHES=1, NUM_EPOCHS=2, FAST_TARGETS=True, SEED=5)
    for a, b in zip(_params(_cartpole_run(**kw)), _params(_cartpole_run(**kw, SKIP_NOOP_PERMUTE=False))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=2e-5)


def test_skip_noop_permute_leaves_the_random_stream_alone():
    """With LR=0 the params never move, so the rollouts depend on the device
    generator alone: skipped and kept permutations end in the same obs and
    env state bit for bit (the permutation is drawn either way)."""
    kw = _td_kw(NUM_ENVS=32, NUM_STEPS=4, NUM_MINIBATCHES=1, NUM_EPOCHS=2, FAST_TARGETS=True, LR=0.0,
                TOTAL_TIMESTEPS=1024, TOTAL_TIMESTEPS_DECAY=1024)
    skip, keep = (_cartpole_run(**kw, SKIP_NOOP_PERMUTE=flag)["runner_state"][1] for flag in (True, False))
    for a, b in zip(tw.tree_leaves(skip), tw.tree_leaves(keep)):
        assert torch.equal(a, b)


def test_fast_targets_with_input_norm_close():
    """Twin of ::test_fast_targets_with_input_norm_close: NORM_INPUT=True,
    the concat form against FAST_TARGETS (next_obs by its own batch
    moments): finite, and within rtol 0.15, atol 0.02."""
    kw = _td_kw(NUM_ENVS=16, NUM_STEPS=8, NUM_MINIBATCHES=2, NUM_EPOCHS=1, NORM_INPUT=True, SEED=3)
    for a, b in zip(_params(_cartpole_run(**kw)), _params(_cartpole_run(**kw, FAST_TARGETS=True))):
        assert torch.isfinite(b).all()
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0.15, atol=0.02)


def test_craftax_default_gets_bank_and_fast_targets():
    """Twin of tests/test_fast_defaults.py::
    test_craftax_default_gets_bank_and_fast_targets: pqn_craftax on cuda (the
    default DEVICE) gets FAST_TARGETS, SKIP_NOOP_PERMUTE and RESET_BANK=256,
    not FUSED_ROLLOUT; PARITY=strict, the CPU and explicit keys are left
    alone; FAST_TARGETS needs 1-step TD on a layer_norm trunk and
    SKIP_NOOP_PERMUTE one minibatch."""
    cfg = compose(alg="pqn_craftax")
    assert "FUSED_ROLLOUT" not in cfg
    assert cfg["FAST_TARGETS"] is True and cfg["SKIP_NOOP_PERMUTE"] is True and cfg["RESET_BANK"] == 256
    for ov in (["PARITY=strict"], ["DEVICE=cpu"]):
        assert not {"FAST_TARGETS", "SKIP_NOOP_PERMUTE", "RESET_BANK"} & set(compose(alg="pqn_craftax", overrides=ov))
    cfg = compose(alg="pqn_craftax", overrides=["FAST_TARGETS=False", "SKIP_NOOP_PERMUTE=False", "RESET_BANK=0"])
    assert cfg["FAST_TARGETS"] is False and cfg["SKIP_NOOP_PERMUTE"] is False and cfg["RESET_BANK"] == 0
    assert "FAST_TARGETS" not in compose(alg="pqn_craftax", overrides=["NORM_TYPE=batch_norm"])
    assert "FAST_TARGETS" not in compose(alg="pqn_craftax", overrides=["Q_LAMBDA=True"])
    assert "SKIP_NOOP_PERMUTE" not in compose(alg="pqn_craftax", overrides=["NUM_MINIBATCHES=2"])
    assert "RESET_BANK" not in compose(alg="pqn_cartpole")
