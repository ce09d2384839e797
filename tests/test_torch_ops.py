"""The plain twins of the port's CUDA kernels against the JAX package's
functions and Pallas kernels (interpret mode, PRNG off), on the CPU, and the
kernel build's cache key. The kernels themselves run on the card:
tests/test_torch_cuda.py and chip_smoke.py hold them against these twins
there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from purejaxql_torch.core.checkpoint import params_from_flax
from purejaxql_torch.envs import make as tmake
from purejaxql_torch.envs.base import NO_DRAWS
from purejaxql_torch.models.cnn import CNNQNetwork as TCNNQNetwork
from purejaxql_torch.models.qnet import QNetwork as TQNetwork
from purejaxql_torch.ops import breakout_rollout as tbr
from purejaxql_torch.ops import build
from purejaxql_torch.ops import cartpole_rollout as tcr
from purejaxql_torch.ops import lambda_returns as tlr
from purejaxql_torch.ops import philox
from purejaxql_torch.ops.minatar_rollout import cnn_forward_plain, minatar_weights
from purejaxql_tpu.algo.returns import lambda_returns as jax_lambda_returns
from purejaxql_tpu.envs import make as jmake
from purejaxql_tpu.models.cnn import CNNQNetwork as JCNNQNetwork
from purejaxql_tpu.models.qnet import QNetwork as JQNetwork
from purejaxql_tpu.ops.pallas_returns import lambda_returns_pallas
from purejaxql_tpu.ops.pallas_rollout import breakout_rollout_pallas, cartpole_rollout_pallas

pytestmark = pytest.mark.quick
torch.set_num_threads(1)


# ---- lambda returns ------------------------------------------------------------


@pytest.mark.parametrize("T,E,gamma,lam", [(16, 200, 0.99, 0.9), (8, 33, 0.95, 0.5), (1, 5, 0.99, 0.95)])
def test_lambda_returns_match_jax_and_pallas(T, E, gamma, lam):
    """Ragged E with random dones: within 1e-5 of algo/returns.lambda_returns
    and of the Pallas kernel in interpret mode."""
    rng = np.random.RandomState(T + E)
    rew = rng.randn(T, E).astype(np.float32)
    done = (rng.rand(T, E) < 0.15).astype(np.float32)
    maxq = rng.randn(T, E).astype(np.float32)
    lastq = rng.randn(E).astype(np.float32)
    args = [jnp.asarray(a) for a in (lastq, rew, done, maxq)]
    want = np.asarray(jax_lambda_returns(*args, gamma, lam))
    got = tlr.lambda_returns(*(torch.tensor(a) for a in (lastq, rew, done, maxq)), gamma, lam)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if T > 1:
        pallas = np.asarray(lambda_returns_pallas(*args, gamma, lam, interpret=True))
        np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-5, atol=1e-5)


def test_wrappers_take_plain_version_on_cpu_without_counting():
    before = (tlr.lambda_returns.launches, tcr.cartpole_rollout.launches)
    x = torch.zeros(4, 3)
    out = tlr.lambda_returns(torch.zeros(3), x, x, x, 0.9, 0.9)
    assert out.shape == (4, 3)
    w = _weights_from_flax(64, 0)[1]
    tcr.cartpole_rollout(0, 0.0, w, torch.zeros(4, 2), torch.zeros(1, 2, dtype=torch.int32), 3)
    assert (tlr.lambda_returns.launches, tcr.cartpole_rollout.launches) == before
    with pytest.raises(ValueError, match="unsupported device"):
        tlr.lambda_returns(*(t.to("meta") for t in (torch.zeros(3), x, x, x)), 0.9, 0.9)


# ---- fused CartPole rollout -----------------------------------------------------------


def _weights_from_flax(H, seed):
    jnet = JQNetwork(action_dim=2, hidden_size=H, num_layers=2, norm_type="layer_norm", norm_input=False)
    variables = jnet.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4)), train=False)
    tnet = TQNetwork(obs_dim=4, action_dim=2, hidden_size=H)
    tnet.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, variables)))
    return variables["params"], tcr.cartpole_weights(tnet)


@pytest.mark.parametrize("max_steps", [500, 5])
def test_rollout_plain_matches_pallas_interpret(max_steps):
    """B 16, T 12, H 256, PRNG off: the plain twin against
    cartpole_rollout_pallas(use_prng=False, interpret=True), as
    tests/test_ops.py holds the TPU kernel against the XLA engine. A short
    max_steps forces time-limit resets to the zero state."""
    B, T = 16, 12
    jparams, weights = _weights_from_flax(256, 1)
    rng = np.random.RandomState(max_steps)
    stf0 = rng.uniform(-0.05, 0.05, (4, B)).astype(np.float32)
    stf0[:, :4] *= 40  # some envs start near or past the bounds
    sti0 = rng.randint(0, 3, (1, B)).astype(np.int32)
    want = cartpole_rollout_pallas(
        jnp.asarray(0), jnp.asarray(0.0), jparams, jnp.asarray(stf0), jnp.asarray(sti0),
        T, use_prng=False, interpret=True, max_steps=max_steps,
    )
    got = tcr.cartpole_rollout(
        0, 0.0, weights, torch.tensor(stf0), torch.tensor(sti0), T,
        use_prng=False, max_steps=max_steps,
    )
    names = ("obs", "act", "rew", "done", "q", "final_obs", "stf", "sti")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        if name == "q":
            w = w[..., :2]  # the TPU head is padded to 8 rows
        if name in ("act", "rew", "done", "sti"):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=0, err_msg=name)
    done = got[3].numpy()
    assert done.any()
    if max_steps == 5:
        assert (done.sum(0) >= 2).all()  # every env hit the time limit twice


def test_rollout_plain_matches_port_env():
    """With the PRNG off and no resets, the fused twin steps as the port's
    env does under greedy actions from the same QNetwork."""
    B, T = 8, 5
    gen = torch.Generator().manual_seed(0)
    net = TQNetwork(obs_dim=4, action_dim=2, hidden_size=64, generator=gen)
    env, params = tmake("CartPole-v1")
    obs, state = env.reset(gen, B, params)
    stf, sti = tcr.state_matrix_from_cartpole(state)
    got = tcr.cartpole_rollout(0, 0.0, tcr.cartpole_weights(net), stf, sti, T, use_prng=False)
    for t in range(T):
        with torch.no_grad():
            act = net(obs, train=False).argmax(-1)
        np.testing.assert_allclose(got[0][t].numpy(), obs.numpy(), atol=1e-6)
        assert torch.equal(got[1][t].long(), act)
        obs, state, rew, done, _ = env.step_env(state, act, params, NO_DRAWS)
        assert not done.any()
        assert torch.equal(got[2][t], rew)
    back = tcr.cartpole_from_state_matrix(got[6], got[7])
    np.testing.assert_allclose(back.x.numpy(), state.x.numpy(), atol=1e-6)
    assert torch.equal(back.time, state.time)


def test_philox_known_answers():
    """Philox4x32-10 against the Random123 known-answer vectors."""
    z = torch.zeros(1, dtype=torch.int64)
    out = tcr.philox4x32_10((z, z, z, z), (0, 0))
    assert [int(v) for v in out] == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    f = z + 0xFFFFFFFF
    out = tcr.philox4x32_10((f, f, f, f), (0xFFFFFFFF, 0xFFFFFFFF))
    assert [int(v) for v in out] == [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]


def test_rollout_prng_statistics():
    """PRNG on: P(act != greedy) = eps / 2 for A = 2, reset draws in
    U(-0.05, 0.05), and different seeds give different streams."""
    weights = _weights_from_flax(64, 2)[1]
    B, T = 128, 32
    stf0 = torch.zeros(4, B)
    sti0 = torch.zeros(1, B, dtype=torch.int32)
    obs, act, _, _, q, _, _, _ = tcr.cartpole_rollout(11, 0.3, weights, stf0, sti0, T)
    p = (act.long() != q.argmax(-1)).float().mean().item()
    assert abs(p - 0.15) < 0.02, p
    draws = tcr.cartpole_rollout(12, 0.0, weights, stf0, sti0, T, max_steps=1)[0][1:]
    assert draws.min() >= -0.05 and draws.max() <= 0.05
    assert abs(draws.mean().item()) < 0.003
    assert abs(draws.std().item() - 0.1 / np.sqrt(12)) < 0.002
    other = tcr.cartpole_rollout(13, 0.0, weights, stf0, sti0, T, max_steps=1)[0][1:]
    assert not torch.equal(draws, other)


def test_philox_module_key_and_counters():
    """The shared generator: a seed's key is its two 32-bit words, the
    counters are the (step, env) grid, and the CartPole rollout draws from
    this same function."""
    assert philox.seed_key(0x0123456789ABCDEF) == (0x89ABCDEF, 0x01234567)
    t, env = philox.step_env_counters(3, 2, "cpu")
    assert t.tolist() == [[0, 0], [1, 1], [2, 2]] and env.tolist() == [[0, 1]] * 3
    assert tcr.philox4x32_10 is philox.philox4x32_10
    z = torch.zeros(1, dtype=torch.int64)
    out = philox.philox4x32_10((z + 0x243F6A88, z + 0x85A308D3, z + 0x13198A2E, z + 0x03707344),
                               (0xA4093822, 0x299F31D0))
    assert [int(v) for v in out] == [0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]


def test_build_key_covers_shared_headers(tmp_path, monkeypatch):
    """A built library is named by a hash of its source and of every shared
    header, so editing a header shared by two kernels rebuilds both, and an
    unchanged tree keeps its name."""
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    (tmp_path / "a.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "shared.cuh").write_text("// v1\n")
    first = build.library_path("a")
    assert build.library_path("a") == first
    (tmp_path / "shared.cuh").write_text("// v2\n")
    second = build.library_path("a")
    assert second != first and second.parent == build.BUILD_DIR
    (tmp_path / "a.cu").write_text('#include "shared.cuh"\n// edited\n')
    assert build.library_path("a") not in (first, second)


# ---- fused Breakout rollout ----------------------------------------------------------


def _breakout_weights_from_flax(seed, hidden=128):
    jnet = JCNNQNetwork(action_dim=3, hidden_size=hidden)
    variables = jnet.init(jax.random.PRNGKey(seed), jnp.zeros((1, 10, 10, 4)), train=False)
    rng = np.random.RandomState(seed)
    # nonzero biases and non-unit scales, so that a misplaced leaf shows
    params = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.05 * rng.randn(*np.shape(x))).astype(np.float32), variables["params"]
    )
    tnet = TCNNQNetwork((10, 10, 4), 3, hidden_size=hidden)
    tnet.load_state_dict(params_from_flax({"params": params}), strict=False)
    return jnet, variables, params, tnet


def _breakout_starts(B, seed):
    """(8, B) state matrices and (10, 10, B) brick maps, int32: half the envs
    at an episode's start from the JAX package's reset, half on random
    boards (any ball position above the paddle row, direction and time,
    thinned walls, strike latches, some walls down to one brick)."""
    env, params = jmake("Breakout-MinAtar")
    _, state = jax.vmap(env.reset, in_axes=(0, None))(jax.random.split(jax.random.PRNGKey(seed), B), params)
    from purejaxql_tpu.ops.pallas_rollout import state_matrix_from_breakout

    st, brick = (np.array(a) for a in state_matrix_from_breakout(state))
    r = np.random.RandomState(seed)
    n = B - B // 2
    by, bx, d = r.randint(0, 9, n), r.randint(0, 10, n), r.randint(0, 4, n)
    st[:, B // 2:] = np.stack([
        by, bx, d, r.randint(0, 10, n), r.randint(0, 2, n),
        np.clip(by - np.array([-1, -1, 1, 1])[d], 0, 9), np.clip(bx - np.array([-1, 1, 1, -1])[d], 0, 9),
        r.randint(0, 1000, n),
    ])
    walls = (r.rand(10, 10, n) < 0.6) & (np.arange(10) >= 1)[:, None, None] & (np.arange(10) <= 3)[:, None, None]
    walls[:, :, : n // 4] = False
    walls[2, 5, : n // 4] = True
    brick[:, :, B // 2:] = walls
    return st.astype(np.int32), brick.astype(np.int32)


@pytest.mark.parametrize("max_steps", [1000, 4])
def test_breakout_rollout_plain_matches_pallas_interpret(max_steps):
    """B 16, T 8, H 128, PRNG off: the plain twin against
    breakout_rollout_pallas(use_prng=False, interpret=True), as
    tests/test_ops.py holds the TPU kernel: observations, actions, rewards,
    dones, the state and the brick map equal, Q-values within 1e-4 (the
    TPU head is padded to 8 rows). max_steps=4 makes every env reset on the
    time limit as well as on misses."""
    B, T = 16, 8
    _, _, jparams, tnet = _breakout_weights_from_flax(1)
    st0, brick0 = _breakout_starts(B, max_steps)
    want = breakout_rollout_pallas(
        jnp.asarray(0), jnp.asarray(0.0), jparams, jnp.asarray(st0), jnp.asarray(brick0),
        T, use_prng=False, interpret=True, max_steps=max_steps,
    )
    got = tbr.breakout_rollout(
        0, 0.0, minatar_weights(tnet), torch.tensor(st0), torch.tensor(brick0), T,
        use_prng=False, max_steps=max_steps,
    )
    names = ("obs", "act", "rew", "done", "q", "final_obs", "st", "brick")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        if name == "q":
            np.testing.assert_allclose(g.numpy(), w[..., :3], atol=1e-4, rtol=0)
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    done, rew = got[3].numpy(), got[2].numpy()
    if max_steps == 4:
        assert (done.sum(0) >= 1).all()
    else:  # misses end episodes, the random boards score bricks
        assert done.any() and rew.any()


def test_breakout_weights_compute_the_cnn():
    """The kernel's weight layout (conv taps with 1/255 folded in, the dense
    weight in flax's (i, j, f) column order, an unpadded head) run through
    the twin's CNN gives the network's Q-values, within 1e-5."""
    _, _, _, tnet = _breakout_weights_from_flax(2, hidden=32)
    weights = minatar_weights(tnet)
    assert [tuple(w.shape) for w in weights] == [
        (36, 16), (16,), (16,), (16,), (32, 1024), (32,), (32,), (32,), (3, 32), (3,)
    ]
    obs = torch.tensor((np.random.RandomState(0).rand(64, 10, 10, 4) < 0.3).astype(np.float32))
    with torch.no_grad():
        want = tnet(obs, train=False)
    np.testing.assert_allclose(cnn_forward_plain(obs, weights).numpy(), want.numpy(), atol=1e-5, rtol=0)


def test_breakout_state_matrix_round_trip():
    st0, brick0 = _breakout_starts(8, 3)
    state = tbr.breakout_from_state_matrix(torch.tensor(st0), torch.tensor(brick0))
    assert state.brick_map.shape == (8, 10, 10) and state.strike.dtype == torch.bool
    assert not state.terminal.any()
    st, brick = tbr.state_matrix_from_breakout(state)
    assert torch.equal(st, torch.tensor(st0)) and torch.equal(brick, torch.tensor(brick0))
    assert st.is_contiguous() and brick.is_contiguous()


def test_breakout_rollout_prng_statistics():
    """PRNG on: P(act != greedy) = eps * 2/3 for 3 actions; with
    max_steps=1 every step resets and the ball starts at x = 9 about half
    the time; different seeds give different streams."""
    _, _, _, tnet = _breakout_weights_from_flax(4, hidden=32)
    weights = minatar_weights(tnet)
    st0, brick0 = (torch.tensor(a) for a in _breakout_starts(128, 4))
    _, act, _, _, q, _, _, _ = tbr.breakout_rollout(11, 0.3, weights, st0, brick0, 32)
    p = (act.long() != q.argmax(-1)).float().mean().item()
    assert abs(p - 0.2) < 0.02, p
    obs = tbr.breakout_rollout(12, 0.0, weights, st0, brick0, 32, max_steps=1)[0]
    ball = obs[1:, :, 3, :, 1]  # the ball's row after each reset
    assert ((ball[..., 0] + ball[..., 9]) == 1).all()
    assert abs(ball[..., 9].mean().item() - 0.5) < 0.03
    other = tbr.breakout_rollout(13, 0.0, weights, st0, brick0, 32, max_steps=1)[0]
    assert not torch.equal(obs, other)


def test_breakout_wrapper_takes_plain_version_on_cpu_without_counting():
    before = tbr.breakout_rollout.launches
    _, _, _, tnet = _breakout_weights_from_flax(0, hidden=32)
    st0, brick0 = (torch.tensor(a) for a in _breakout_starts(2, 0))
    out = tbr.breakout_rollout(0, 0.0, minatar_weights(tnet), st0, brick0, 3)
    assert [tuple(o.shape) for o in out] == [
        (3, 2, 10, 10, 4), (3, 2), (3, 2), (3, 2), (3, 2, 3), (2, 10, 10, 4), (8, 2), (10, 10, 2)
    ]
    assert tbr.breakout_rollout.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        tbr.breakout_rollout(0, 0.0, minatar_weights(tnet), st0.to("meta"), brick0.to("meta"), 3)
