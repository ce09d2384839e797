"""The port's CUDA kernels against their plain twins, on the card.

Every test here needs an NVIDIA GPU with nvcc (sm_90a) and skips elsewhere.
Run on the card from the root of a checkout:

    python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from purejaxql_torch.algo import pqn, pqn_ac, pqn_rnn
from purejaxql_torch.core.config import compose
from purejaxql_torch.envs import make as make_env
from purejaxql_torch.envs.minatar.breakout import start_state
from purejaxql_torch.models.actor_critic import Actor, CriticEnsemble
from purejaxql_torch.models.cnn import CNNQNetwork
from purejaxql_torch.models.qnet import QNetwork
from purejaxql_torch.ops import asterix_rollout as ar
from purejaxql_torch.ops import breakout_rollout as br
from purejaxql_torch.ops import cartpole_rollout as cr
from purejaxql_torch.ops import freeway_rollout as fr
from purejaxql_torch.ops import gru_scan as gs
from purejaxql_torch.ops import lambda_returns as lr
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


@pytest.mark.parametrize("T,E", [(64, 32), (64, 200), (1, 7)])
def test_lambda_returns_kernel_matches_plain(dev, T, E):
    rng = np.random.RandomState(E)
    args = [
        torch.tensor(a, device=dev)
        for a in (
            rng.randn(E).astype(np.float32),
            rng.randn(T, E).astype(np.float32),
            (rng.rand(T, E) < 0.15).astype(np.float32),
            rng.randn(T, E).astype(np.float32),
        )
    ]
    got = lr.lambda_returns(*args, 0.99, 0.95)
    want = lr.lambda_returns_plain(*args, 0.99, 0.95)
    # rounded op for op as the twin: equal to the last bit
    assert torch.equal(got, want)


def test_lambda_returns_wrapper_rejects_bad_inputs(dev):
    x = torch.zeros(8, 4, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        lr.lambda_returns(torch.zeros(4, device=dev), x.T.contiguous().T[:, :4], x[:, :3], x, 0.9, 0.9)
    with pytest.raises(ValueError, match="float32"):
        lr.lambda_returns(torch.zeros(4, device=dev), x, x.double(), x, 0.9, 0.9)


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


def _game_inputs(dev, env_name, B=128):
    """The game's kernel weights (H 128) and states after 40 steps of random
    play through the twin from a reset."""
    _, plain, to_matrix, channels, actions = GAMES[env_name]
    net = CNNQNetwork((10, 10, channels), actions, hidden_size=128, generator=torch.Generator().manual_seed(B)).to(dev)
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


@pytest.mark.parametrize("T,B,H", [(132, 2, 256), (68, 2, 256), (32, 16, 128), (13, 3, 32)])
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


def test_tiny_rnn_train_on_the_card_launches_both_kernels(dev):
    config = compose(
        alg="pqn_rnn_memory_chain",
        overrides=["TOTAL_TIMESTEPS=8192", "TOTAL_TIMESTEPS_DECAY=8192", "TEST_NUM_STEPS=64"],
    )
    assert config["FAST_BPTT"] is True and config["PALLAS_BPTT"] is True
    for fn in (gs.gru_scan_fwd, gs.gru_scan_bwd, lr.lambda_returns):
        fn.launches = 0
    out = pqn_rnn.make_train(config)()
    grad_steps = 8192 // 128 // 32 * 4 * 16
    assert gs.gru_scan_fwd.launches == gs.gru_scan_bwd.launches == grad_steps
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


@pytest.mark.parametrize("use_prng", [False, True])
@pytest.mark.parametrize("T,B,H,max_steps", [(32, 64, 256, 200), (40, 16, 64, 10)])
def test_pendulum_kernel_matches_plain(dev, T, B, H, max_steps, use_prng):
    """The training shape and one that forces resets: done and time equal,
    every float output within 1e-4 of the twin (the MLPs sum in another
    order; on an H100 the largest gap seen is 1.5e-5, on the reward)."""
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
