"""The port's CUDA kernels against their plain twins, on the card.

Every test here needs an NVIDIA GPU with nvcc (sm_90a) and skips elsewhere.
Run on the card from the root of a checkout:

    python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from purejaxql_torch.algo import pqn, pqn_ac, pqn_rnn, pqn_vdn
from purejaxql_torch.algo.types import MARLTransition
from purejaxql_torch.core.config import compose
from purejaxql_torch.core.optim import make_optimizer
from purejaxql_torch.envs import make as make_env
from purejaxql_torch.envs.minatar.breakout import start_state
from purejaxql_torch.models.actor_critic import Actor, CriticEnsemble
from purejaxql_torch.models.cnn import CNNQNetwork
from purejaxql_torch.models.qnet import QNetwork
from purejaxql_torch.models.rnn import RNNQNetwork
from purejaxql_torch.ops import asterix_rollout as ar
from purejaxql_torch.ops import breakout_rollout as br
from purejaxql_torch.ops import cartpole_rollout as cr
from purejaxql_torch.ops import eps_greedy as eg
from purejaxql_torch.ops import freeway_rollout as fr
from purejaxql_torch.ops import gru_scan as gs
from purejaxql_torch.ops import lambda_returns as lr
from purejaxql_torch.ops import minatar_rollout
from purejaxql_torch.ops import pendulum_rollout as pr
from purejaxql_torch.ops import seaquest_rollout as sq
from purejaxql_torch.ops import space_invaders_rollout as sr
from purejaxql_torch.ops.minatar_rollout import minatar_weights

pytestmark = pytest.mark.cuda

NAMES = ("obs", "act", "rew", "done", "q", "final_obs", "stf", "sti")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels build with nvcc for sm_90a)")
    return torch.device("cuda", 0)


# the trainers' shapes (CartPole (64, 32), MinAtar (32, 128), Pendulum (32,
# 64), the recurrent trainer's windows (131, 2), (67, 2) and RNN Craftax's
# (127, 256), VDN's targets (28, 16) Spread, (67, 16) Skirmish and SMAX,
# (39, 16) Kitchen, (47, 16) Hanabi), short and ragged ones, many blocks
# through the ring, a long T of few envs
LAMBDA_SHAPES = [(64, 32), (32, 128), (32, 64), (131, 2), (67, 2), (127, 256), (28, 16), (67, 16), (39, 16),
                 (47, 16), (127, 2), (63, 2), (1, 7), (2, 33), (64, 200), (300, 4096), (1024, 3)]
LAMBDA_FORMS = {
    "gymnax": (lr.lambda_returns, lr.lambda_returns_plain),
    "closure": (lr.lambda_returns_closure, lr.lambda_returns_closure_plain),
}


def _lambda_inputs(dev, T, E, seed, inf_rows=False):
    """last_q, rewards, 0/1-float dones and max_qs on the card; with
    ``inf_rows`` a NaN, +inf and -inf in a row of max_qs and rewards."""
    rng = np.random.RandomState(seed)
    last_q, rew, maxq = rng.randn(E).astype(np.float32), rng.randn(T, E).astype(np.float32), rng.randn(T, E).astype(np.float32)
    done = (rng.rand(T, E) < 0.15).astype(np.float32)
    if inf_rows:
        maxq[T // 2, : min(E, 3)] = [np.nan, np.inf, -np.inf][: min(E, 3)]
        rew[T // 3, -min(E, 2):] = [np.inf, -np.inf][: min(E, 2)]
    return [torch.tensor(a, device=dev) for a in (last_q, rew, done, maxq)]


@pytest.mark.parametrize("form", list(LAMBDA_FORMS))
@pytest.mark.parametrize("T,E", LAMBDA_SHAPES)
def test_lambda_returns_kernel_matches_plain(dev, T, E, form):
    kernel, plain = LAMBDA_FORMS[form]
    args = _lambda_inputs(dev, T, E, T * 10_000 + E)
    got = kernel(*args, 0.99, 0.95)
    want = plain(*args, 0.99, 0.95)
    # rounded op for op as the twin: equal to the last bit
    assert torch.equal(got, want)


@pytest.mark.parametrize("form", list(LAMBDA_FORMS))
@pytest.mark.parametrize("T,E", [(64, 32), (32, 128), (131, 2), (2, 33), (300, 4096), (1024, 3)])
def test_lambda_returns_kernel_matches_plain_through_nan_and_inf(dev, T, E, form):
    """NaN and +-inf in max_qs and rewards: the twin's bits, NaN where the
    twin has NaN."""
    kernel, plain = LAMBDA_FORMS[form]
    args = _lambda_inputs(dev, T, E, E, inf_rows=True)
    got, want = kernel(*args, 0.99, 0.95), plain(*args, 0.99, 0.95)
    assert want.isnan().any() and want.isfinite().any()
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("form", list(LAMBDA_FORMS))
def test_lambda_returns_kernel_on_unaligned_rows(dev, form):
    """E a multiple of 4 but the operands one float past a 16-byte
    boundary: the kernel copies 4 bytes at a time and gives the twin's
    bits."""
    kernel, plain = LAMBDA_FORMS[form]
    T, E = 40, 64
    args = [torch.cat([torch.zeros(1, device=dev), x.reshape(-1)])[1:].view(x.shape)
            for x in _lambda_inputs(dev, T, E, 3)]
    assert all(x.data_ptr() % 16 == 4 and x.is_contiguous() for x in args)
    assert torch.equal(kernel(*args, 0.99, 0.95), plain(*args, 0.99, 0.95))


def test_lambda_returns_closure_takes_bool_dones(dev):
    last_q, rew, done, maxq = _lambda_inputs(dev, 131, 2, 5)
    got = lr.lambda_returns_closure(last_q, rew, done.bool(), maxq, 0.99, 0.95)
    assert torch.equal(got, lr.lambda_returns_closure_plain(last_q, rew, done, maxq, 0.99, 0.95))


def test_lambda_returns_wrapper_rejects_bad_inputs(dev):
    x = torch.zeros(8, 4, device=dev)
    for fn in (lr.lambda_returns, lr.lambda_returns_closure):
        with pytest.raises(ValueError, match="contiguous"):
            fn(torch.zeros(4, device=dev), x.T.contiguous().T[:, :4], x[:, :3], x, 0.9, 0.9)
        with pytest.raises(ValueError, match="float32"):
            fn(torch.zeros(4, device=dev), x, x.double(), x, 0.9, 0.9)
        with pytest.raises(ValueError, match="T, E >= 1"):
            fn(torch.zeros(0, device=dev), x[:, :0], x[:, :0], x[:, :0], 0.9, 0.9)


@pytest.mark.parametrize("B", [32, 128])
@pytest.mark.parametrize("use_prng", [False, True])
def test_rollout_kernel_matches_plain(dev, B, use_prng):
    gen = torch.Generator().manual_seed(B)
    net = QNetwork(4, 2, hidden_size=256, generator=gen).to(dev)
    weights = cr.cartpole_weights(net)
    stf0 = (torch.rand(4, B, generator=gen) * 0.1 - 0.05).to(dev)
    sti0 = torch.zeros(1, B, dtype=torch.int32, device=dev)
    got = dict(zip(NAMES, cr.cartpole_rollout(7, 0.2, weights, stf0, sti0, 64, use_prng=use_prng)))
    want = dict(zip(NAMES, cr.cartpole_rollout_plain(7, 0.2, weights, stf0, sti0, 64, use_prng=use_prng)))
    for k in ("act", "rew", "done", "sti"):
        assert torch.equal(got[k], want[k]), k
    for k in ("obs", "final_obs", "stf"):
        torch.testing.assert_close(got[k], want[k], atol=1e-5, rtol=0)
    torch.testing.assert_close(got["q"], want["q"], atol=1e-4, rtol=0)


def _cartpole_inputs(dev, B, H, seed=0):
    """Weights of a seeded 2-layer QNetwork and states near the upright
    start, a quarter of them near or past the bounds, at random times."""
    gen = torch.Generator().manual_seed(seed + B + H)
    net = QNetwork(4, 2, hidden_size=H, generator=gen).to(dev)
    rng = np.random.RandomState(seed + B)
    stf0 = rng.uniform(-0.05, 0.05, (4, B)).astype(np.float32)
    stf0[:, : B // 4] *= 40
    sti0 = rng.randint(0, 3, (1, B)).astype(np.int32)
    return cr.cartpole_weights(net), torch.tensor(stf0, device=dev), torch.tensor(sti0, device=dev)


def _assert_cartpole_equal(got, want):
    """Actions, rewards, dones and time equal; obs and state within 1e-5, Q
    within 1e-4 (layer 2 sums in another order than the twin's matmul)."""
    got, want = dict(zip(NAMES, got)), dict(zip(NAMES, want))
    for k in ("act", "rew", "done", "sti"):
        assert torch.equal(got[k], want[k]), k
    for k in ("obs", "final_obs", "stf"):
        torch.testing.assert_close(got[k], want[k], atol=1e-5, rtol=0)
    torch.testing.assert_close(got["q"], want["q"], atol=1e-4, rtol=0, equal_nan=True)


@pytest.mark.parametrize("use_prng", [False, True])
@pytest.mark.parametrize("H", [64, 256, 512, 1024])
@pytest.mark.parametrize("B", [1, 37, 130])
def test_cartpole_kernel_matches_plain_at_ragged_shapes(dev, B, H, use_prng):
    """Clusters whose last group has warps past the last env, the W2 slice
    in shared memory (H <= 512) and read from L2 (H 1024), and max_steps 5
    so that every env resets: the twin's outputs (``_assert_cartpole_equal``)."""
    plan = cr.cartpole_plan(B, H)
    assert plan.resident == (H <= 512)
    weights, stf0, sti0 = _cartpole_inputs(dev, B, H)
    got = cr.cartpole_rollout(7, 0.2, weights, stf0, sti0, 24, use_prng=use_prng, max_steps=5)
    want = cr.cartpole_rollout_plain(7, 0.2, weights, stf0, sti0, 24, use_prng=use_prng, max_steps=5)
    _assert_cartpole_equal(got, want)
    assert (want[3].sum(0) >= 4).all()


def test_cartpole_kernel_repeats_bit_for_bit(dev):
    """Two launches on the same inputs give the same bits on both paths:
    every sum has a fixed order and no atomics."""
    for B, H in ((128, 256), (37, 1024)):
        weights, stf0, sti0 = _cartpole_inputs(dev, B, H, seed=3)
        first, second = (cr.cartpole_rollout(4, 0.3, weights, stf0, sti0, 32, max_steps=9) for _ in range(2))
        assert all(torch.equal(a, b) for a, b in zip(first, second)), (B, H)


def test_cartpole_refused_launch_raises(dev, monkeypatch):
    """A plan the card refuses (here more shared memory than a CTA has)
    raises from the wrapper; nothing retries or falls back to the twin."""
    weights, stf0, sti0 = _cartpole_inputs(dev, 8, 64)
    plan = cr.cartpole_plan(8, 64)._replace(smem_bytes=300_000)
    monkeypatch.setattr(cr, "cartpole_plan", lambda B, H: plan)
    before = cr.cartpole_rollout.launches
    with pytest.raises(RuntimeError, match="cartpole_rollout kernel launch failed"):
        cr.cartpole_rollout(0, 0.1, weights, stf0, sti0, 4)
    assert cr.cartpole_rollout.launches == before


@pytest.mark.parametrize("B", [32, 128])
def test_cartpole_plans_place_every_cluster_at_once(dev, B):
    """The trainer's two launch shapes at H 256, B 32 (training) and B 128
    (the eval chunks): the card places every cluster of the plan at once
    (cudaOccupancyMaxActiveClusters), one wave."""
    plan = cr.cartpole_plan(B, 256)
    assert plan.clusters * plan.cluster <= 132
    assert cr.active_clusters(plan, 256) >= plan.clusters


def test_cartpole_nan_q_takes_the_first_nan(dev):
    """A head bias of [0, NaN] at eps 0: every Q-row holds a NaN at index
    1, which torch.argmax and jnp.argmax take; the kernel acts 1 on every
    env, as its twin."""
    weights, stf0, sti0 = _cartpole_inputs(dev, 37, 256)
    weights = weights[:9] + (torch.tensor([0.0, float("nan")], device=dev),)
    got = cr.cartpole_rollout(7, 0.0, weights, stf0, sti0, 8, use_prng=False)
    want = cr.cartpole_rollout_plain(7, 0.0, weights, stf0, sti0, 8, use_prng=False)
    _assert_cartpole_equal(got, want)
    assert (got[1] == 1).all()


def test_tiny_train_on_the_card_launches_both_kernels(dev):
    config = compose(
        alg="pqn_cartpole",
        overrides=[
            "TOTAL_TIMESTEPS=8192", "TOTAL_TIMESTEPS_DECAY=8192", "TEST_NUM_STEPS=128",
            "TEST_INTERVAL=0.5",
        ],
    )
    lr.lambda_returns.launches = cr.cartpole_rollout.launches = 0
    out = pqn.make_train(config)()
    n_updates = 8192 // 64 // 32
    assert lr.lambda_returns.launches == n_updates
    assert cr.cartpole_rollout.launches > n_updates
    assert all(p.is_cuda for p in out["runner_state"][0].network.parameters())
    assert torch.isfinite(out["metrics"]["td_loss"]).all()


def _breakout_inputs(dev, B=128, hidden=128):
    net = CNNQNetwork((10, 10, 4), 3, hidden_size=hidden, generator=torch.Generator().manual_seed(B)).to(dev)
    side = torch.randint(0, 2, (B,), generator=torch.Generator().manual_seed(0)).to(torch.int32)
    st0, brick0 = br.state_matrix_from_breakout(start_state(side))
    return minatar_weights(net), st0.to(dev), brick0.to(dev)


@pytest.mark.parametrize("use_prng", [False, True])
@pytest.mark.parametrize("max_steps", [1000, 5])
def test_breakout_kernel_matches_plain(dev, use_prng, max_steps):
    """B 128, T 32, H 128: every integer output and the observations equal,
    Q-values within 1e-4."""
    weights, st0, brick0 = _breakout_inputs(dev)
    got = br.breakout_rollout(5, 0.2, weights, st0, brick0, 32, use_prng=use_prng, max_steps=max_steps)
    want = br.breakout_rollout_plain(5, 0.2, weights, st0, brick0, 32, use_prng=use_prng, max_steps=max_steps)
    names = ("obs", "act", "rew", "done", "q", "final_obs", "st", "brick")
    for name, g, w in zip(names, got, want):
        if name == "q":
            torch.testing.assert_close(g, w, atol=1e-4, rtol=0)
        else:
            assert torch.equal(g, w), name
    assert want[3].any()


def test_breakout_wrapper_rejects_bad_inputs(dev):
    weights, st0, brick0 = _breakout_inputs(dev)
    with pytest.raises(ValueError, match="int32"):
        br.breakout_rollout(0, 0.0, weights, st0.long(), brick0, 4)
    with pytest.raises(ValueError, match="hidden size"):
        br.breakout_rollout(0, 0.0, _breakout_inputs(dev, hidden=48)[0], st0, brick0, 4)
    shifted = torch.empty(weights[4].numel() + 1, device=dev)[1:].view_as(weights[4])
    shifted.copy_(weights[4])
    with pytest.raises(ValueError, match="aligned"):
        br.breakout_rollout(0, 0.0, weights[:4] + (shifted,) + weights[5:], st0, brick0, 4)


def test_tiny_breakout_train_on_the_card_launches_both_kernels(dev):
    config = compose(
        alg="pqn_minatar",
        overrides=[
            "ENV_NAME=Breakout-MinAtar", "TOTAL_TIMESTEPS=16384", "TOTAL_TIMESTEPS_DECAY=16384",
            "TEST_NUM_STEPS=64", "TEST_INTERVAL=0.5",
        ],
    )
    lr.lambda_returns.launches = br.breakout_rollout.launches = 0
    out = pqn.make_train(config)()
    n_updates = 16384 // 32 // 128
    assert lr.lambda_returns.launches == n_updates
    assert br.breakout_rollout.launches > n_updates
    assert all(p.is_cuda for p in out["runner_state"][0].network.parameters())
    assert torch.isfinite(out["metrics"]["td_loss"]).all()


# per game: the kernel's wrapper, its plain twin, the state converter, the
# observation channels and the actions
GAMES = {
    "Asterix-MinAtar": (ar.asterix_rollout, ar.asterix_rollout_plain, ar.state_matrix_from_asterix, 4, 5),
    "Freeway-MinAtar": (fr.freeway_rollout, fr.freeway_rollout_plain, fr.state_matrix_from_freeway, 7, 3),
    "Seaquest-MinAtar": (sq.seaquest_rollout, sq.seaquest_rollout_plain, sq.state_matrix_from_seaquest, 10, 6),
    "SpaceInvaders-MinAtar": (
        sr.space_invaders_rollout, sr.space_invaders_rollout_plain, sr.state_matrix_from_space_invaders, 6, 4,
    ),
}


def _game_inputs(dev, env_name, B=128, hidden=128):
    """The game's kernel weights (H 128 unless given) and states after 40
    steps of random play through the twin from a reset."""
    _, plain, to_matrix, channels, actions = GAMES[env_name]
    net = CNNQNetwork(
        (10, 10, channels), actions, hidden_size=hidden, generator=torch.Generator().manual_seed(B),
    ).to(dev)
    weights = minatar_weights(net)
    env, params = make_env(env_name)
    _, state = env.reset(torch.Generator(device=dev).manual_seed(0), B, params)
    packed = to_matrix(state)
    packed = packed if isinstance(packed, tuple) else (packed,)
    return weights, plain(3, 1.0, weights, *packed, 40)[6:]


@pytest.mark.parametrize("use_prng", [False, True])
@pytest.mark.parametrize("env_name", sorted(GAMES))
def test_minatar_kernel_matches_plain(dev, env_name, use_prng):
    """B 128, T 32, H 128: every integer output, the observations and the
    state equal, Q-values within 1e-4."""
    kernel, plain = GAMES[env_name][:2]
    weights, states = _game_inputs(dev, env_name)
    got = kernel(5, 0.2, weights, *states, 32, use_prng=use_prng)
    want = plain(5, 0.2, weights, *states, 32, use_prng=use_prng)
    assert len(got) == len(want) == 6 + len(states)
    for i, (g, w) in enumerate(zip(got, want)):
        if i == 4:
            torch.testing.assert_close(g, w, atol=1e-4, rtol=0)
        else:
            assert torch.equal(g, w), i


def _assert_minatar_equal(got, want):
    """Every output equal but the Q-values (index 4), within 1e-4."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if i == 4:
            torch.testing.assert_close(g, w, atol=1e-4, rtol=0)
        else:
            assert torch.equal(g, w), i


@pytest.mark.parametrize("use_prng", [False, True])
@pytest.mark.parametrize("B,H", [(3, 32), (37, 256), (130, 32), (130, 256), (37, 96)])
def test_freeway_kernel_matches_plain_at_ragged_shapes(dev, B, H, use_prng):
    """Clusters with CTAs past the last env (B not a multiple of the plan's
    C) and the narrowest and widest H, with max_steps 9 so that every env
    resets: the twin's integer outputs, observations and state, Q within
    1e-4."""
    plan = fr.freeway_plan(B, H)
    assert B % plan.cluster and plan.clusters == -(-B // plan.cluster)
    weights, states = _game_inputs(dev, "Freeway-MinAtar", B=B, hidden=H)
    got = fr.freeway_rollout(5, 0.2, weights, *states, 24, use_prng=use_prng, max_steps=9)
    want = fr.freeway_rollout_plain(5, 0.2, weights, *states, 24, use_prng=use_prng, max_steps=9)
    _assert_minatar_equal(got, want)
    assert (want[3].sum(0) >= 2).all()


def test_freeway_kernel_repeats_bit_for_bit(dev):
    """Two launches on the same inputs give the same bits: every sum has a
    fixed order (the partial sums added in rank order) and no atomics."""
    weights, states = _game_inputs(dev, "Freeway-MinAtar", B=130)
    first, second = (fr.freeway_rollout(9, 0.3, weights, *states, 32) for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_freeway_refused_launch_raises(dev, monkeypatch):
    """A plan the card refuses (here more shared memory than a CTA has)
    raises from the wrapper; nothing retries or falls back to the twin."""
    weights, states = _game_inputs(dev, "Freeway-MinAtar", B=16)
    plan = fr.freeway_plan(16, 128)._replace(smem_bytes=300_000)
    monkeypatch.setattr(fr, "freeway_plan", lambda B, H: plan)
    before = fr.freeway_rollout.launches
    with pytest.raises(RuntimeError, match="freeway_rollout kernel launch failed"):
        fr.freeway_rollout(0, 0.1, weights, *states, 4)
    assert fr.freeway_rollout.launches == before


# the games whose kernels run on the cluster CNN besides Freeway: the
# wrapper's module and its plan
CLUSTER_GAMES = {
    "Asterix-MinAtar": (ar, ar.asterix_rollout, ar.asterix_rollout_plain, "asterix_plan"),
    "Seaquest-MinAtar": (sq, sq.seaquest_rollout, sq.seaquest_rollout_plain, "seaquest_plan"),
}


@pytest.mark.parametrize("use_prng", [False, True])
@pytest.mark.parametrize("B,H", [(3, 32), (37, 256), (130, 32), (130, 256), (37, 96)])
@pytest.mark.parametrize("env_name", sorted(CLUSTER_GAMES))
def test_asterix_and_seaquest_kernels_match_plain_at_ragged_shapes(dev, env_name, B, H, use_prng):
    """Clusters with CTAs past the last env (B not a multiple of the plan's
    C) and the narrowest and widest H, with max_steps 9 so that every env
    resets: the twin's integer outputs (Seaquest's cash-ins among the
    rewards), observations and state, Q within 1e-4."""
    module, kernel, plain, plan_name = CLUSTER_GAMES[env_name]
    plan = getattr(module, plan_name)(B, H)
    assert B % plan.cluster and plan.clusters == -(-B // plan.cluster)
    weights, states = _game_inputs(dev, env_name, B=B, hidden=H)
    got = kernel(5, 0.2, weights, *states, 24, use_prng=use_prng, max_steps=9)
    want = plain(5, 0.2, weights, *states, 24, use_prng=use_prng, max_steps=9)
    _assert_minatar_equal(got, want)
    assert (want[3].sum(0) >= 2).all()


def test_seaquest_kernel_pays_cash_ins_as_the_twin(dev):
    """Every env with six divers on board one row under the surface, not
    surfaced, oxygen 1-128: random actions (eps 1) take about a sixth of them
    up to a cash-in, kills + oxygen * 0.1f, a reward that is not whole; the
    kernel's rewards and every other output as the twin's."""
    weights, (st,) = _game_inputs(dev, "Seaquest-MinAtar")
    cash = sq.seaquest_from_state_matrix(st)
    cash.divers[:], cash.sub_y[:] = 6, 1
    cash.oxygen[:] = torch.arange(128, device=dev) % 199 + 1
    cash.surfaced, cash.terminal = torch.zeros_like(cash.surfaced), torch.zeros_like(cash.terminal)
    st = sq.state_matrix_from_seaquest(cash)
    got = sq.seaquest_rollout(7, 1.0, weights, st, 2)
    want = sq.seaquest_rollout_plain(7, 1.0, weights, st, 2)
    _assert_minatar_equal(got, want)
    assert (want[2] != want[2].floor()).sum() > 0


@pytest.mark.parametrize("env_name", sorted(CLUSTER_GAMES))
def test_asterix_and_seaquest_kernels_repeat_bit_for_bit(dev, env_name):
    """Two launches on the same inputs give the same bits: every sum has a
    fixed order (the partial sums added in rank order) and no atomics."""
    kernel = CLUSTER_GAMES[env_name][1]
    weights, states = _game_inputs(dev, env_name, B=130)
    first, second = (kernel(9, 0.3, weights, *states, 32) for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("env_name", sorted(CLUSTER_GAMES))
def test_asterix_and_seaquest_refused_launch_raises(dev, env_name, monkeypatch):
    """A plan the card refuses (here more shared memory than a CTA has)
    raises from the wrapper; nothing retries or falls back to the twin."""
    module, kernel, _, plan_name = CLUSTER_GAMES[env_name]
    weights, states = _game_inputs(dev, env_name, B=16)
    plan = getattr(module, plan_name)(16, 128)._replace(smem_bytes=300_000)
    monkeypatch.setattr(module, plan_name, lambda B, H: plan)
    before = kernel.launches
    with pytest.raises(RuntimeError, match=f"{kernel.__name__} kernel launch failed"):
        kernel(0, 0.1, weights, *states, 4)
    assert kernel.launches == before


@pytest.mark.parametrize("env_name", sorted(CLUSTER_GAMES))
def test_asterix_and_seaquest_plans_place_every_cluster_at_once(dev, env_name):
    """At the trainer's (B 128, H 128) the plan's CTAs stay under the 113 KB
    at which two share an SM, so the card places all 8 clusters of 16 at
    once (cudaOccupancyMaxActiveClusters), not 7 in a first wave."""
    module, kernel, _, plan_name = CLUSTER_GAMES[env_name]
    plan = getattr(module, plan_name)(128, 128)
    assert (plan.cluster, plan.clusters) == (16, 8)
    assert minatar_rollout.active_clusters(kernel.__name__, plan) >= plan.clusters


# Breakout and SpaceInvaders on the cluster CNN: the wrapper's module, the
# wrapper, its twin, its plan's name and its inputs (weights and states after
# 40 steps of random play through the twin)
def _breakout_played(dev, B=128, hidden=128):
    weights, st0, brick0 = _breakout_inputs(dev, B=B, hidden=hidden)
    return weights, br.breakout_rollout_plain(3, 1.0, weights, st0, brick0, 40)[6:]


BREAKOUT_AND_SPACE_INVADERS = {
    "Breakout-MinAtar": (br, br.breakout_rollout, br.breakout_rollout_plain, "breakout_plan", _breakout_played),
    "SpaceInvaders-MinAtar": (
        sr, sr.space_invaders_rollout, sr.space_invaders_rollout_plain, "space_invaders_plan",
        lambda dev, B=128, hidden=128: _game_inputs(dev, "SpaceInvaders-MinAtar", B=B, hidden=hidden),
    ),
}


@pytest.mark.parametrize("use_prng", [False, True])
@pytest.mark.parametrize("B,H", [(1, 32), (37, 256), (130, 32), (130, 256), (37, 32), (1, 256)])
@pytest.mark.parametrize("env_name", sorted(BREAKOUT_AND_SPACE_INVADERS))
def test_breakout_and_space_invaders_kernels_match_plain_at_ragged_shapes(dev, env_name, B, H, use_prng):
    """Clusters with CTAs past the last env (B not a multiple of the plan's
    C) and the narrowest and widest H, with max_steps 9 so that every env
    resets: the twin's integer outputs, observations and state (Breakout's
    brick map, SpaceInvaders' three maps), Q within 1e-4."""
    module, kernel, plain, plan_name, inputs = BREAKOUT_AND_SPACE_INVADERS[env_name]
    plan = getattr(module, plan_name)(B, H)
    assert B % plan.cluster and plan.clusters == -(-B // plan.cluster)
    weights, states = inputs(dev, B=B, hidden=H)
    got = kernel(5, 0.2, weights, *states, 24, use_prng=use_prng, max_steps=9)
    want = plain(5, 0.2, weights, *states, 24, use_prng=use_prng, max_steps=9)
    _assert_minatar_equal(got, want)
    assert (want[3].sum(0) >= 2).all()


@pytest.mark.parametrize("env_name", sorted(BREAKOUT_AND_SPACE_INVADERS))
def test_breakout_and_space_invaders_kernels_repeat_bit_for_bit(dev, env_name):
    """Two launches on the same inputs give the same bits: every sum has a
    fixed order (the partial sums added in rank order) and no atomics."""
    kernel, inputs = BREAKOUT_AND_SPACE_INVADERS[env_name][1], BREAKOUT_AND_SPACE_INVADERS[env_name][4]
    weights, states = inputs(dev, B=130)
    first, second = (kernel(9, 0.3, weights, *states, 32) for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("env_name", sorted(BREAKOUT_AND_SPACE_INVADERS))
def test_breakout_and_space_invaders_refused_launch_raises(dev, env_name, monkeypatch):
    """A plan the card refuses (here more shared memory than a CTA has)
    raises from the wrapper; nothing retries or falls back to the twin."""
    module, kernel, _, plan_name, inputs = BREAKOUT_AND_SPACE_INVADERS[env_name]
    weights, states = inputs(dev, B=16)
    plan = getattr(module, plan_name)(16, 128)._replace(smem_bytes=300_000)
    monkeypatch.setattr(module, plan_name, lambda B, H: plan)
    before = kernel.launches
    with pytest.raises(RuntimeError, match=f"{kernel.__name__} kernel launch failed"):
        kernel(0, 0.1, weights, *states, 4)
    assert kernel.launches == before


@pytest.mark.parametrize("env_name", sorted(BREAKOUT_AND_SPACE_INVADERS))
def test_breakout_and_space_invaders_plans_place_every_cluster_at_once(dev, env_name):
    """At the trainer's (B 128, H 128) the plan's CTAs stay under the 113 KB
    at which two share an SM, so the card places all 8 clusters of 16 at
    once (cudaOccupancyMaxActiveClusters), not 7 in a first wave."""
    module, kernel, _, plan_name, _ = BREAKOUT_AND_SPACE_INVADERS[env_name]
    plan = getattr(module, plan_name)(128, 128)
    assert (plan.cluster, plan.clusters) == (16, 8)
    assert minatar_rollout.active_clusters(kernel.__name__, plan) >= plan.clusters


@pytest.mark.parametrize("use_prng", [False, True])
def test_seaquest_kernel_matches_plain_through_resets(dev, use_prng):
    """B 64, T 40, max_steps 9: every env resets at least four times, so the
    reset and the spawns after it are compared too; integer outputs, the
    observations and the (128, B) state equal, Q-values within 1e-4."""
    weights, states = _game_inputs(dev, "Seaquest-MinAtar", B=64)
    got = sq.seaquest_rollout(7, 0.3, weights, *states, 40, use_prng=use_prng, max_steps=9)
    want = sq.seaquest_rollout_plain(7, 0.3, weights, *states, 40, use_prng=use_prng, max_steps=9)
    for i, (g, w) in enumerate(zip(got, want)):
        if i == 4:
            torch.testing.assert_close(g, w, atol=1e-4, rtol=0)
        else:
            assert torch.equal(g, w), i
    assert (want[3].sum(0) >= 4).all()


@pytest.mark.parametrize("env_name", sorted(GAMES))
def test_tiny_minatar_train_on_the_card_launches_its_kernel(dev, env_name):
    config = compose(
        alg="pqn_minatar",
        overrides=[
            f"ENV_NAME={env_name}", "TOTAL_TIMESTEPS=16384", "TOTAL_TIMESTEPS_DECAY=16384",
            "TEST_NUM_STEPS=64", "TEST_INTERVAL=0.5",
        ],
    )
    kernels = [GAMES[g][0] for g in GAMES] + [br.breakout_rollout]
    for fn in kernels + [lr.lambda_returns]:
        fn.launches = 0
    out = pqn.make_train(config)()
    n_updates = 16384 // 32 // 128
    assert lr.lambda_returns.launches == n_updates
    mine = GAMES[env_name][0]
    assert mine.launches > n_updates
    assert all(fn.launches == 0 for fn in kernels if fn is not mine)
    assert all(p.is_cuda for p in out["runner_state"][0].network.parameters())
    assert torch.isfinite(out["metrics"]["td_loss"]).all()


@pytest.mark.parametrize("env_name", sorted([*GAMES, "Breakout-MinAtar"]))
def test_minatar_kernels_take_the_first_nan(dev, env_name):
    """A NaN head bias on action 2 at eps 0: every Q-row holds a NaN there,
    which torch.argmax and jnp.argmax take; each game's kernel acts 2 on
    every env, as its twin, and matches the twin's every other output."""
    if env_name == "Breakout-MinAtar":
        kernel, plain = br.breakout_rollout, br.breakout_rollout_plain
        weights, states = _breakout_played(dev, B=37)
    else:
        kernel, plain = GAMES[env_name][:2]
        weights, states = _game_inputs(dev, env_name, B=37)
    bias = weights[9].clone()
    bias[2] = float("nan")
    weights = tuple(weights[:9]) + (bias,)
    got = kernel(5, 0.0, weights, *states, 8, use_prng=False)
    want = plain(5, 0.0, weights, *states, 8, use_prng=False)
    for i, (g, w) in enumerate(zip(got, want)):
        if i == 4:
            torch.testing.assert_close(g, w, atol=1e-4, rtol=0, equal_nan=True)
        else:
            assert torch.equal(g, w), i
    assert (got[1] == 2).all() and got[4][..., 2].isnan().all()


def _gru_inputs(dev, T, B, H, seed=0):
    """The GRU scan's inputs from numpy: xi ~ N(0, 1), about 20 % resets, h0
    ~ N(0, 0.25), an orthogonal W_h (the init's scale), b_hn ~ N(0, 0.01),
    and random cotangents."""
    rng = np.random.RandomState(seed)
    q, _ = np.linalg.qr(rng.randn(3 * H, 3 * H))
    arrays = (
        rng.randn(T, B, 3 * H), (rng.rand(T, B, 1) > 0.2), 0.5 * rng.randn(B, H),
        q[:H], 0.1 * rng.randn(H), rng.randn(T, B, H), rng.randn(B, H),
    )
    return [torch.tensor(np.asarray(a, np.float32), device=dev) for a in arrays]


# the trainers' shapes (the slice in registers; VDN's agents x envs rows:
# Spread (29, 48), SMAX (68, 80), Skirmish (68, 48), Kitchen (40, 32),
# Hanabi (48, 32)), several clusters, ragged rows and units (B 3 of R 4;
# H 130: CTAs of 17 units, the slice in shared memory, and a last one of 11;
# H 200: of 13 and a last one of 5), the largest H with the slice in shared
# memory, and one read from L2
GRU_CARD_SHAPES = [
    (132, 2, 256), (68, 2, 256), (29, 48, 256), (68, 80, 256), (68, 48, 256), (40, 32, 256), (48, 32, 256),
    (32, 16, 128), (13, 3, 32), (20, 40, 256), (7, 3, 96), (7, 3, 130), (7, 3, 200), (9, 2, 512), (5, 3, 1024),
]


@pytest.mark.parametrize("T,B,H", GRU_CARD_SHAPES)
def test_gru_scan_kernels_match_plain(dev, T, B, H):
    """Forward outputs within 1e-5 of the twin; backward within 1e-4
    absolute and relative (the kernels sum in another order)."""
    xi, keep, h0, w_h, b_hn, g_y, g_hT = _gru_inputs(dev, T, B, H)
    got = gs.gru_scan_fwd(xi, keep, h0, w_h, b_hn)
    want = gs.gru_scan_fwd_plain(xi, keep, h0, w_h, b_hn)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)
    hprev = torch.cat([h0[None], want[0][:-1]])
    res = (keep, hprev, w_h, *want[1:])
    got = gs.gru_scan_bwd(*res, g_y, g_hT)
    want = gs.gru_scan_bwd_plain(*res, g_y, g_hT)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("T,B,H", [(132, 2, 256), (20, 40, 256), (9, 2, 512)])
def test_gru_scan_kernels_repeat_bit_for_bit(dev, T, B, H):
    """Two launches of each kernel on the same inputs give the same bits:
    every sum has a fixed order and there are no atomics."""
    xi, keep, h0, w_h, b_hn, g_y, g_hT = _gru_inputs(dev, T, B, H, seed=2)
    first, second = (gs.gru_scan_fwd(xi, keep, h0, w_h, b_hn) for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    res = (keep, torch.cat([h0[None], first[0][:-1]]), w_h, *first[1:])
    first, second = (gs.gru_scan_bwd(*res, g_y, g_hT) for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_gru_scan_bwd_is_one_cluster_with_no_copy_of_w_h(dev):
    """At the MemoryChain trainer's shape the plan is one cluster of 16 CTAs
    with W_h resident, and the backward allocates its four outputs and
    nothing else: no transposed W_h, no dc scratch, no partial sums."""
    T, B, H = 132, 2, 256
    plan = gs.scan_plan(B, H)
    assert (plan.cluster, plan.units, plan.rows, plan.clusters) == (16, 16, 2, 1)
    assert plan.resident and plan.registers
    xi, keep, h0, w_h, b_hn, g_y, g_hT = _gru_inputs(dev, T, B, H, seed=3)
    y, r, z, n, c = gs.gru_scan_fwd(xi, keep, h0, w_h, b_hn)
    res = (keep, torch.cat([h0[None], y[:-1]]), w_h, r, z, n, c)
    gs.gru_scan_bwd(*res, g_y, g_hT)  # built and warm
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    dxi, dh0, dw_h, db_hn = gs.gru_scan_bwd(*res, g_y, g_hT)
    torch.cuda.synchronize()
    outs = (dxi, dh0, dw_h, db_hn)
    sizes = sum(-(-o.untyped_storage().nbytes() // 512) * 512 for o in outs)
    assert torch.cuda.max_memory_allocated(dev) - before == sizes
    assert dw_h.untyped_storage().nbytes() == 4 * H * 3 * H
    assert db_hn.untyped_storage().nbytes() == 4 * H


@pytest.mark.parametrize("B", [48, 80, 32])
def test_gru_scan_plans_at_vdn_rows_are_placed(dev, B):
    """At VDN's rows (agents x 16 envs) the plan is clusters of 16 CTAs of 8
    rows, and the card places at least one cluster of each kernel's at
    once (more clusters than it places run in waves)."""
    plan = gs.scan_plan(B, 256)
    assert (plan.cluster, plan.rows, plan.clusters) == (16, 8, B // 8)
    for name in ("gru_scan_fwd", "gru_scan_bwd"):
        assert gs.active_clusters(name, plan) >= 1


def test_gru_scan_refused_launch_raises(dev, monkeypatch):
    """A plan the card refuses (here more shared memory than a CTA has)
    raises from the wrapper; nothing retries or falls back to the twin."""
    xi, keep, h0, w_h, b_hn, _, _ = _gru_inputs(dev, 4, 2, 256)
    plan = gs.scan_plan(2, 256)._replace(fwd_bytes=300_000)
    monkeypatch.setattr(gs, "scan_plan", lambda B, H: plan)
    before = gs.gru_scan_fwd.launches
    with pytest.raises(RuntimeError, match="gru_scan_fwd kernel launch failed"):
        gs.gru_scan_fwd(xi, keep, h0, w_h, b_hn)
    assert gs.gru_scan_fwd.launches == before


def test_gru_scan_autograd_matches_plain_loop(dev):
    """Gradients of sum(sin(y)) + sum(h_T) through GRUScan against autograd
    through the twin's forward loop, at the MemoryChain trainer's shape."""
    xi, keep, h0, w_h, b_hn, _, _ = _gru_inputs(dev, 132, 2, 256, seed=1)
    grads = []
    for use_kernel in (True, False):
        args = [a.clone().requires_grad_(i != 1) for i, a in enumerate((xi, keep, h0, w_h, b_hn))]
        if use_kernel:
            h_T, y = gs.GRUScan.apply(*args)
        else:
            y = gs.gru_scan_fwd_plain(*args)[0]
            h_T = y[-1]
        (torch.sin(y).sum() + h_T.sum()).backward()
        grads.append([a.grad for i, a in enumerate(args) if i != 1])
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


def test_gru_scan_wrappers_reject_bad_inputs(dev):
    xi, keep, h0, w_h, b_hn, g_y, g_hT = _gru_inputs(dev, 8, 2, 32)
    with pytest.raises(ValueError, match="float32"):
        gs.gru_scan_fwd(xi.double(), keep, h0, w_h, b_hn)
    with pytest.raises(ValueError, match="contiguous"):
        gs.gru_scan_fwd(xi, keep, h0, w_h.t().contiguous().t(), b_hn)
    with pytest.raises(ValueError, match="contiguous"):
        gs.gru_scan_bwd(keep, g_y, w_h, g_y, g_y, g_y, g_y, g_y, g_hT[:, :16])


def _seeded_gru_inputs(dev, T, S, B, H, seed=0):
    """S seeds' GRU scan inputs (each as ``_gru_inputs``), seed-major: xi
    (T, S * B, 3H), keep, h0 (S * B, H), W_h (S, H, 3H), b_hn (S, H), g_y,
    g_hT."""
    lanes = [_gru_inputs(dev, T, B, H, seed + 100 * s) for s in range(S)]
    dims = (1, 1, 0, None, None, 1, 0)
    return [torch.stack(xs) if d is None else torch.cat(xs, d) for d, xs in zip(dims, zip(*lanes))]


# the seeded trainers' windows (MemoryChain and RNN CartPole, 4 seeds of B
# 2), several clusters a seed (the partial-sum pass per seed), ragged rows
# and units, the slice in shared memory and read from L2
SEEDED_GRU_SHAPES = [(132, 4, 2, 256), (68, 4, 2, 256), (29, 3, 48, 256), (13, 3, 3, 32), (7, 2, 3, 130),
                     (9, 2, 2, 512), (5, 2, 3, 1024)]


@pytest.mark.parametrize("T,S,B,H", SEEDED_GRU_SHAPES)
def test_seeded_gru_scan_kernels_match_plain(dev, T, S, B, H):
    """One launch for S seeds against the seeded twins: forward within 1e-5,
    backward within 1e-4 absolute and relative, dW_h (S, H, 3H) and db_hn
    (S, H)."""
    xi, keep, h0, w_h, b_hn, g_y, g_hT = _seeded_gru_inputs(dev, T, S, B, H)
    got = gs.gru_scan_fwd(xi, keep, h0, w_h, b_hn)
    want = gs.gru_scan_fwd_plain(xi, keep, h0, w_h, b_hn)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)
    res = (keep, torch.cat([h0[None], want[0][:-1]]), w_h, *want[1:])
    got = gs.gru_scan_bwd(*res, g_y, g_hT)
    want = gs.gru_scan_bwd_plain(*res, g_y, g_hT)
    assert got[2].shape == (S, H, 3 * H) and got[3].shape == (S, H)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("T,S,B,H", SEEDED_GRU_SHAPES)
def test_seeded_gru_scan_lanes_equal_unseeded_launches(dev, T, S, B, H):
    """Lane s of the seeded launch gives, bit for bit, what the unseeded
    launch gives on seed s's rows and weights: forward and backward, and
    each kernel counts one launch for all seeds."""
    xi, keep, h0, w_h, b_hn, g_y, g_hT = _seeded_gru_inputs(dev, T, S, B, H, seed=5)
    gs.gru_scan_fwd.launches = gs.gru_scan_bwd.launches = 0
    fwd = gs.gru_scan_fwd(xi, keep, h0, w_h, b_hn)
    res = (keep, torch.cat([h0[None], fwd[0][:-1]]), w_h, *fwd[1:])
    bwd = gs.gru_scan_bwd(*res, g_y, g_hT)
    assert gs.gru_scan_fwd.launches == gs.gru_scan_bwd.launches == 1
    for s in range(S):
        rows = slice(s * B, (s + 1) * B)
        one = gs.gru_scan_fwd(*(x[:, rows].contiguous() for x in (xi, keep)), h0[rows].contiguous(), w_h[s], b_hn[s])
        assert all(torch.equal(a[:, rows], b) for a, b in zip(fwd, one)), s
        res_s = [res[0][:, rows].contiguous(), res[1][:, rows].contiguous(), w_h[s],
                 *(x[:, rows].contiguous() for x in res[3:])]
        dxi, dh0, dw_h, db_hn = gs.gru_scan_bwd(*res_s, g_y[:, rows].contiguous(), g_hT[rows].contiguous())
        assert torch.equal(bwd[0][:, rows], dxi) and torch.equal(bwd[1][rows], dh0), s
        assert torch.equal(bwd[2][s], dw_h) and torch.equal(bwd[3][s], db_hn), s


def test_tiny_seeded_trains_on_the_card_launch_each_kernel_as_one_seed(dev):
    """NUM_SEEDS=3 on the card: pqn_cartpole through the epsilon-greedy
    kernel (a launch a rollout step) and the returns (one an update), and
    pqn_rnn_memory_chain through both GRU scan kernels and the closure
    returns (one launch of each a grad step): the single-seed counts, every
    metric (3, NUM_UPDATES), the parameters on the card."""
    config = compose(alg="pqn_cartpole", overrides=[
        "NUM_SEEDS=3", "TOTAL_TIMESTEPS=8192", "TOTAL_TIMESTEPS_DECAY=8192", "TEST_NUM_STEPS=32"])
    assert config["EXPLORATION_KERNEL"] == "pallas" and "FUSED_ROLLOUT" not in config
    for fn in (eg.eps_greedy, lr.lambda_returns, cr.cartpole_rollout):
        fn.launches = 0
    out = pqn.make_train(config)()
    updates = 8192 // 64 // 32
    assert (eg.eps_greedy.launches, lr.lambda_returns.launches, cr.cartpole_rollout.launches) == (updates * 64, updates, 0)
    assert all(v.shape == (3, updates) for v in out["metrics"].values())
    assert all(p.is_cuda and p.shape[0] == 3 for p in out["runner_state"][0].network.parameters())
    config = compose(alg="pqn_rnn_memory_chain", overrides=[
        "NUM_SEEDS=3", "TOTAL_TIMESTEPS=8192", "TOTAL_TIMESTEPS_DECAY=8192", "TEST_NUM_STEPS=16"])
    assert config["FAST_BPTT"] is True and config["PALLAS_BPTT"] is True
    for fn in (gs.gru_scan_fwd, gs.gru_scan_bwd, lr.lambda_returns_closure):
        fn.launches = 0
    out = pqn_rnn.make_train(config)()
    grad_steps = 8192 // 128 // 32 * 4 * 16
    assert gs.gru_scan_fwd.launches == gs.gru_scan_bwd.launches == lr.lambda_returns_closure.launches == grad_steps
    assert all(v.shape == (3, 2) for v in out["metrics"].values())
    assert torch.isfinite(out["metrics"]["td_loss"]).all()


def test_tiny_rnn_train_on_the_card_launches_both_kernels(dev):
    config = compose(
        alg="pqn_rnn_memory_chain",
        overrides=["TOTAL_TIMESTEPS=8192", "TOTAL_TIMESTEPS_DECAY=8192", "TEST_NUM_STEPS=64"],
    )
    assert config["FAST_BPTT"] is True and config["PALLAS_BPTT"] is True
    for fn in (gs.gru_scan_fwd, gs.gru_scan_bwd, lr.lambda_returns, lr.lambda_returns_closure):
        fn.launches = 0
    out = pqn_rnn.make_train(config)()
    grad_steps = 8192 // 128 // 32 * 4 * 16
    assert gs.gru_scan_fwd.launches == gs.gru_scan_bwd.launches == grad_steps
    # the closure-form targets: one launch of the returns kernel a grad step
    assert lr.lambda_returns_closure.launches == grad_steps
    assert lr.lambda_returns.launches == 0
    assert all(p.is_cuda for p in out["runner_state"][0].network.parameters())
    assert torch.isfinite(out["metrics"]["td_loss"]).all()


def _vdn_minibatch(dev, T=29, A=3, B=16, D=14, n=5, H=256, seed=0):
    """A numpy-seeded VDN minibatch at Spread's full shape (window 29, 3
    agents x 16 envs, H 256) with masks that leave each row a legal action."""
    rng = np.random.RandomState(seed)
    avail = (rng.rand(T, A, B, n) < 0.6).astype(np.float32)
    avail[..., 0] = 1.0
    action = np.array([rng.choice(np.flatnonzero(r)) for r in avail.reshape(-1, n)]).reshape(T, A, B)
    t = lambda x, dtype=torch.float32: torch.tensor(x, dtype=dtype, device=dev)  # noqa: E731
    return MARLTransition(
        obs=t(rng.randn(T, A, B, D)), action=t(action, torch.long), reward=t(rng.randn(T, 1, B)),
        done=t(rng.rand(T, 1, B) < 0.1), last_hs=(t(0.3 * rng.randn(T, A, B, H)),),
        last_done=t(rng.rand(T, A, B) < 0.1), last_action=t(action, torch.long), avail_actions=t(avail),
        q_val=t(np.zeros((T, A, B, n))),
    )


def test_vdn_learn_step_through_the_kernels_matches_the_twins(dev):
    """Two VDN minibatch steps at Spread's full shape through the GRU scan
    kernels and the closure returns kernel (one launch of each a step)
    against the same steps on the CPU through their twins, from the same
    weights: losses within 1e-4 relative, params within 1e-5."""
    gen = torch.Generator().manual_seed(0)
    cpu_net = RNNQNetwork(14, 5, hidden_size=256, num_layers=2, generator=gen)
    gpu_net = RNNQNetwork(14, 5, hidden_size=256, num_layers=2).to(dev)
    gpu_net.load_state_dict(cpu_net.state_dict())
    results = []
    for net, device in ((gpu_net, dev), (cpu_net, torch.device("cpu"))):
        opt = make_optimizer(net.parameters(), 10.0, 1e-4)
        mb = _vdn_minibatch(device)
        for fn in (gs.gru_scan_fwd, gs.gru_scan_bwd, lr.lambda_returns_closure):
            fn.launches = 0
        losses = [pqn_vdn.learn_minibatch(net, opt, mb, 0.99, 0.85, True, True)[0].item() for _ in range(2)]
        launches = [fn.launches for fn in (gs.gru_scan_fwd, gs.gru_scan_bwd, lr.lambda_returns_closure)]
        results.append((losses, launches, [p.detach().cpu() for p in net.parameters()]))
    (g_losses, g_launches, g_params), (c_losses, c_launches, c_params) = results
    assert g_launches == [2, 2, 2] and c_launches == [0, 0, 0]
    np.testing.assert_allclose(g_losses, c_losses, rtol=1e-4)
    for g, c in zip(g_params, c_params):
        torch.testing.assert_close(g, c, atol=1e-5, rtol=0)


def test_tiny_vdn_train_on_the_card_launches_the_three_kernels(dev):
    config = compose(alg="pqn_vdn_smax", overrides=["TOTAL_TIMESTEPS=16384", "TEST_NUM_STEPS=64"])
    assert config["FAST_BPTT"] is True and config["PALLAS_BPTT"] is True
    for fn in (gs.gru_scan_fwd, gs.gru_scan_bwd, lr.lambda_returns, lr.lambda_returns_closure):
        fn.launches = 0
    out = pqn_vdn.make_train(config)()
    grad_steps = 16384 // 64 // 128 * 2 * 8
    assert gs.gru_scan_fwd.launches == gs.gru_scan_bwd.launches == lr.lambda_returns_closure.launches == grad_steps
    assert lr.lambda_returns.launches == 0
    assert all(p.is_cuda for p in out["runner_state"][0].network.parameters())
    assert torch.isfinite(out["metrics"]["td_loss"]).all()


def _pendulum_inputs(dev, B, H, seed=0):
    """Kernel weights of a seeded actor and two-critic ensemble, and states
    with theta in [-pi, pi), theta_dot in [-8, 8] and times in [0, 200)."""
    gen = torch.Generator().manual_seed(seed)
    actor = Actor(3, 1, 2.0, 0.0, [H, H], generator=gen).to(dev)
    critics = CriticEnsemble(2, 3, 1, [H, H], generator=gen).to(dev)
    r = np.random.RandomState(seed)
    stf = np.stack([r.uniform(-np.pi, np.pi, B), r.uniform(-8, 8, B), np.zeros(B)]).astype(np.float32)
    sti = r.randint(0, 200, (1, B)).astype(np.int32)
    return pr.pendulum_ac_weights(actor, critics), torch.tensor(stf, device=dev), torch.tensor(sti, device=dev)


# the training shape, one that forces resets, a single env, ragged groups,
# the largest H whose W2 slices stay in shared memory (512) and H 1024,
# whose slices are read from L2
PENDULUM_CARD_SHAPES = [
    (32, 64, 256, 200), (40, 16, 64, 10), (20, 1, 256, 7), (20, 100, 256, 7), (20, 1, 512, 7),
    (20, 100, 512, 7), (12, 1, 1024, 5), (12, 100, 1024, 5),
]


@pytest.mark.parametrize("use_prng", [False, True])
@pytest.mark.parametrize("T,B,H,max_steps", PENDULUM_CARD_SHAPES)
def test_pendulum_kernel_matches_plain(dev, T, B, H, max_steps, use_prng):
    """Done and time equal, every float output within 1e-4 of the twin (the
    MLPs sum in another order; on an H100 the largest gap seen is 3.5e-5,
    on the reward)."""
    (aw, cw), stf, sti = _pendulum_inputs(dev, B, H)
    got = pr.pendulum_ac_rollout(11, 0.8, aw, cw, stf, sti, T, use_prng=use_prng, max_steps=max_steps)
    want = pr.pendulum_rollout_plain(11, 0.8, aw, cw, stf, sti, T, use_prng=use_prng, max_steps=max_steps)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype, i
        if i in (5, 8):
            assert torch.equal(g, w), i
        else:
            torch.testing.assert_close(g, w, atol=1e-4, rtol=0)
    assert want[5].any()


def test_pendulum_kernel_repeats_bit_for_bit(dev):
    """Two launches on the same inputs give the same bits on both paths:
    every sum has a fixed order and no atomics."""
    for B, H in ((64, 256), (3, 1024)):
        (aw, cw), stf, sti = _pendulum_inputs(dev, B, H, seed=2)
        first, second = (pr.pendulum_ac_rollout(4, 0.8, aw, cw, stf, sti, 16, max_steps=9) for _ in range(2))
        assert all(torch.equal(a, b) for a, b in zip(first, second)), (B, H)


def test_pendulum_refused_launch_raises(dev, monkeypatch):
    """A plan the card refuses (here more shared memory than a CTA has)
    raises from the wrapper; nothing retries or falls back to the twin."""
    (aw, cw), stf, sti = _pendulum_inputs(dev, 8, 64)
    plan = pr.pendulum_plan(8, 64)._replace(smem_bytes=300_000)
    monkeypatch.setattr(pr, "pendulum_plan", lambda B, H: plan)
    before = pr.pendulum_ac_rollout.launches
    with pytest.raises(RuntimeError, match="pendulum_ac_rollout kernel launch failed"):
        pr.pendulum_ac_rollout(0, 0.1, aw, cw, stf, sti, 4)
    assert pr.pendulum_ac_rollout.launches == before


def test_pendulum_wrapper_rejects_bad_inputs(dev):
    (aw, cw), stf, sti = _pendulum_inputs(dev, 8, 64)
    with pytest.raises(ValueError, match="hidden size"):
        pr.pendulum_ac_rollout(0, 0.1, _pendulum_inputs(dev, 8, 48)[0][0], cw, stf, sti, 4)
    with pytest.raises(ValueError, match="int32"):
        pr.pendulum_ac_rollout(0, 0.1, aw, cw, stf, sti.long(), 4)
    with pytest.raises(ValueError, match="NUM_CRITICS=2"):
        pr.pendulum_ac_rollout(0, 0.1, aw, cw[:10], stf, sti, 4)
    with pytest.raises(ValueError, match="contiguous"):
        pr.pendulum_ac_rollout(0, 0.1, aw, _pendulum_inputs(dev, 8, 32)[0][1], stf, sti, 4)
    shifted = torch.empty(aw[4].numel() + 1, device=dev)[1:].view_as(aw[4])
    shifted.copy_(aw[4])
    with pytest.raises(ValueError, match="aligned"):
        pr.pendulum_ac_rollout(0, 0.1, aw[:4] + (shifted,) + aw[5:], cw, stf, sti, 4)


def test_tiny_pendulum_train_on_the_card_launches_both_kernels(dev):
    config = compose(
        alg="pqn_pendulum",
        overrides=[
            "TOTAL_TIMESTEPS=8192", "TEST_NUM_STEPS=64", "TEST_INTERVAL=0.5",
            "ENV_KWARGS={'max_steps_in_episode': 50}",
        ],
    )
    assert config["FUSED_ROLLOUT"] is True
    for fn in (pr.pendulum_ac_rollout, lr.lambda_returns, cr.cartpole_rollout):
        fn.launches = 0
    out = pqn_ac.make_train(config)()
    n_updates = 8192 // 32 // 64
    assert lr.lambda_returns.launches == n_updates
    # one launch per update and two per eval (64 steps in 32-step chunks)
    assert pr.pendulum_ac_rollout.launches == n_updates + 2 * (1 + n_updates // 2)
    assert cr.cartpole_rollout.launches == 0
    for state in out["runner_state"][0].values():
        assert all(p.is_cuda for p in state.network.parameters())
    assert torch.isfinite(out["metrics"]["value_loss"]).all()
    assert torch.isfinite(out["metrics"]["test/returned_episode_returns"]).all()


def _eps_q(dev, E, A, seed):
    """Q-values with ties (half-integers), one row holding a tie for the
    maximum at two indices and one a NaN."""
    rng = np.random.RandomState(seed)
    q = (np.round(rng.randn(E, A) * 2) / 2).astype(np.float32)
    q[0, [A // 2, A - 1]] = 9.0
    q[1, A - 1] = np.nan
    return torch.tensor(q, device=dev)


@pytest.mark.parametrize("eps", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("E,A", [(1024, 34), (1000, 34), (512, 6), (37, 1), (3, 70)])
def test_eps_greedy_kernel_matches_plain(dev, E, A, eps):
    q = _eps_q(dev, E, A, E + A)
    for seed in (0, 12345, 2**62 + 7, 2**64 - 1):
        got = eg.eps_greedy(seed, q, eps)
        assert got.dtype == torch.int64 and got.shape == (E,)
        assert torch.equal(got, eg.eps_greedy_plain(seed, q, eps)), seed


def eps_edge_rows(A):
    """Q-rows of every kind the argmax rule decides (also the CPU tests'
    in tests/test_torch_eps_greedy.py): -0.0 against +0.0 (each
    order), NaNs of different payloads and signs (the first wins), a NaN
    after an +inf, all -inf, all NaN, and +inf tied with itself."""
    nan = lambda bits: np.array([bits], np.uint32).view(np.float32)[0]  # noqa: E731
    payloads = [nan(0x7FC00000), nan(0x7F800001), nan(0xFFC00000), nan(0x7FFFFFFF)]
    rows = []
    base = -np.ones(A, np.float32)
    for order in ((0.0, -0.0), (-0.0, 0.0)):
        r = base.copy()
        r[[A // 3, A - 1]] = order
        rows.append(r)
    for i, p in enumerate(payloads):
        r = base.copy()
        r[(A // 2 + i) % A] = p
        r[(A // 2 + i + 1) % A] = payloads[(i + 1) % 4]
        rows.append(r)
    r = base.copy()
    r[0], r[A - 1] = np.inf, payloads[2]
    rows.append(r)
    rows.append(np.full(A, -np.inf, np.float32))
    rows.append(np.full(A, payloads[1], np.float32))
    r = base.copy()
    r[[A - 1, A // 2]] = np.inf
    rows.append(r)
    return np.stack(rows)


@pytest.mark.parametrize("A", [1, 2, 34, 65])
def test_eps_greedy_kernel_takes_edge_rows_as_the_twin(dev, A):
    """The edge rows (``eps_edge_rows``), repeated among random ones, bit for
    bit against the twin at eps 0 and 0.3, and at eps 0 against
    torch.argmax on the CPU."""
    rng = np.random.RandomState(A)
    edges = eps_edge_rows(A)
    q = rng.randn(100, A).astype(np.float32)
    q[::7][: len(edges)] = edges
    qd = torch.tensor(q, device=dev)
    for eps in (0.0, 0.3):
        got = eg.eps_greedy(11, qd, eps)
        assert torch.equal(got, eg.eps_greedy_plain(11, qd, eps)), eps
    assert torch.equal(eg.eps_greedy(11, qd, 0.0).cpu(), torch.tensor(q).argmax(-1))


def test_eps_greedy_wrapper_rejects_bad_inputs(dev):
    q = torch.zeros(8, 4, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        eg.eps_greedy(1, q.T, 0.1)
    with pytest.raises(ValueError, match="float32"):
        eg.eps_greedy(1, q.double(), 0.1)
    with pytest.raises(ValueError, match="seed"):
        eg.eps_greedy(-1, q, 0.1)


def test_tiny_pqn_craftax_on_the_card_launches_eps_greedy(dev):
    """pqn_craftax through the cuda policy: one eps_greedy launch per update
    (1 step a rollout), no returns or rollout kernel."""
    config = compose(alg="pqn_craftax", overrides=[
        "TOTAL_TIMESTEPS=4096", "TOTAL_TIMESTEPS_DECAY=4096", "NUM_ENVS=128", "HIDDEN_SIZE=64", "NUM_LAYERS=2",
    ])
    assert config["EXPLORATION_KERNEL"] == "pallas"
    for fn in (eg.eps_greedy, lr.lambda_returns, cr.cartpole_rollout):
        fn.launches = 0
    out = pqn.make_train(config)()
    assert eg.eps_greedy.launches == 4096 // 128
    assert lr.lambda_returns.launches == cr.cartpole_rollout.launches == 0
    assert all(p.is_cuda for p in out["runner_state"][0].network.parameters())
    assert torch.isfinite(out["metrics"]["td_loss"]).all()


def test_lstm_learn_step_on_the_card_matches_the_cpu(dev):
    """Two FAST_BPTT minibatch steps of the LSTM network with the BatchRenorm
    input (pqn_rnn_craftax's, at H 128) over a (33, 64) window: on the card
    through the closure returns kernel (one launch a step), on the CPU
    through its twin, from the same weights: losses within 1e-4 relative,
    params and the input norm's statistics within 1e-4."""
    from purejaxql_torch.algo.types import RNNTransition

    rng = np.random.RandomState(0)
    T, B, F, H, A = 33, 64, 300, 128, 34
    cpu_net = RNNQNetwork(F, A, hidden_size=H, num_layers=1, cell_type="lstm", norm_input=True,
                          input_norm_type="batch_renorm", add_last_action=True,
                          generator=torch.Generator().manual_seed(0))
    gpu_net = RNNQNetwork(F, A, hidden_size=H, num_layers=1, cell_type="lstm", norm_input=True,
                          input_norm_type="batch_renorm", add_last_action=True).to(dev)
    gpu_net.load_state_dict(cpu_net.state_dict())
    arrays = dict(obs=rng.rand(T, B, F).astype(np.float32), action=rng.randint(0, A, (T, B)),
                  reward=rng.randn(T, B).astype(np.float32), done=rng.rand(T, B) < 0.05,
                  last_done=rng.rand(T, B) < 0.05, last_action=rng.randint(0, A, (T, B)),
                  c=0.3 * rng.randn(T, B, H).astype(np.float32), h=0.3 * rng.randn(T, B, H).astype(np.float32))
    results = []
    for net, device in ((gpu_net, dev), (cpu_net, torch.device("cpu"))):
        t = {k: torch.tensor(v, device=device) for k, v in arrays.items()}
        mb = RNNTransition(obs=t["obs"], action=t["action"].long(), reward=t["reward"], done=t["done"],
                           last_hs=((t["c"], t["h"]),), last_done=t["last_done"],
                           last_action=t["last_action"].long(), q_val=torch.zeros(T, B, A, device=device))
        opt = make_optimizer(net.parameters(), 0.5, 3e-4)
        lr.lambda_returns_closure.launches = 0
        losses = [pqn_rnn.learn_minibatch(net, opt, mb, 0.99, 0.7, True)[0].item() for _ in range(2)]
        results.append((losses, lr.lambda_returns_closure.launches,
                        {k: v.detach().cpu() for k, v in net.state_dict().items()}))
    (g_losses, g_launches, g_state), (c_losses, c_launches, c_state) = results
    assert g_launches == 2 and c_launches == 0
    np.testing.assert_allclose(g_losses, c_losses, rtol=1e-4)
    for name in g_state:
        torch.testing.assert_close(g_state[name], c_state[name], atol=1e-4, rtol=0, msg=name)


def test_tiny_rnn_craftax_on_the_card_launches_eps_greedy_and_the_closure_returns(dev):
    """pqn_rnn_craftax through the cuda policy at H 64, 64 envs x 16 steps:
    FAST_BPTT, the reset bank, an epsilon-greedy launch a step of the prefill
    and the rollouts, a closure returns launch a grad step, no GRU, rollout
    or gymnax-form returns kernel."""
    config = compose(alg="pqn_rnn_craftax", overrides=[
        "TOTAL_TIMESTEPS=2048", "NUM_ENVS=64", "NUM_STEPS=16", "HIDDEN_SIZE=64",
    ])
    assert config["FAST_BPTT"] is True and config["RESET_BANK"] == 256 and not config.get("PALLAS_BPTT")
    fns = (eg.eps_greedy, lr.lambda_returns_closure, lr.lambda_returns, gs.gru_scan_fwd, gs.gru_scan_bwd)
    for fn in fns:
        fn.launches = 0
    out = pqn_rnn.make_train(config)()
    assert [fn.launches for fn in fns] == [16 + 2 * 16, 2 * 4 * 4, 0, 0, 0]
    train_state = out["runner_state"][0]
    assert all(p.is_cuda for p in train_state.network.parameters())
    assert int(train_state.network.BatchRenorm_0.steps) == 2 * 4 * 4
    assert all(torch.isfinite(v).all() for v in out["metrics"].values())


# ---- the sharded trainers: 2 ranks of a gloo group on cuda:0 (tests/torch_spmd_worker.py) ----


@pytest.fixture(scope="module")
def cuda_ranks(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels build with nvcc for sm_90a)")
    import torch_spmd_worker as worker

    return worker.spawn(["cuda_collectives", "cuda_ff", "cuda_batch_norm"], 2, tmp_path_factory.mktemp("cuda_ranks"),
                        deadline_s=300)


def test_gloo_collectives_on_cuda_tensors(cuda_ranks):
    for res in cuda_ranks:
        got = res["cuda_collectives"]
        np.testing.assert_array_equal(got["pmean_a"], np.full(5, 1.5, np.float32))
        np.testing.assert_array_equal(got["pmean_b"], np.full((2, 3), 15.0, np.float32))
        np.testing.assert_array_equal(got["psum"], np.full(4, 3.0, np.float32))
        np.testing.assert_array_equal(got["rows"], np.array([[0, 1, 2], [10, 11, 12]]))
        np.testing.assert_array_equal(got["moments"], np.full(3, 1.5, np.float32))
        np.testing.assert_array_equal(got["moments2"], np.full(3, 3.0, np.float32))
        # the cotangents (rank + 1, and 1) meaned over the ranks: d(sum over
        # ranks of each rank's loss) / d(each rank's moments)
        np.testing.assert_array_equal(got["grad_m"], np.full(3, 1.5, np.float32))
        np.testing.assert_array_equal(got["grad_m2"], np.full(3, 1.0, np.float32))


@pytest.mark.parametrize("job", ["cuda_ff", "cuda_batch_norm"])
def test_sharded_trainer_on_cuda_in_lockstep(cuda_ranks, job):
    """Each rank trains on cuda:0 through the kernels; the global counter,
    finite metrics and every parameter and statistic bit-equal across the
    ranks."""
    first = cuda_ranks[0][job]
    # 8 updates of 8 envs x 16 steps a rank: one rollout launch an update
    # fused, one epsilon-greedy launch a rollout step unfused
    kernel, launches = ("cartpole_rollout", 8) if job == "cuda_ff" else ("eps_greedy", 128)
    for res in cuda_ranks:
        out = res[job]
        assert out["timesteps"] == 2048
        assert out["launches"][kernel] == launches and out["launches"]["lambda_returns"] == 8
        assert np.isfinite(out["metrics"]["td_loss"]).all()
        for k, v in out["state"].items():
            np.testing.assert_array_equal(v, first["state"][k], err_msg=k)
