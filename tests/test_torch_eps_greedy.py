"""The epsilon-greedy kernel's plain twin (ops/eps_greedy.py) on the CPU.

The JAX kernel (purejaxql_tpu/ops/pallas_explore.py) seeds the TPU's
hardware PRNG (``pltpu.prng_seed``), which has no interpret-mode rule, so it
cannot run here. The twin is held against JAX's ``eps_greedy_batch`` at
eps = 0 (ties and a NaN included), against a numpy restatement of
``_eps_greedy_kernel``'s arithmetic on the same Philox words, and by the
statistics of the TPU kernel's tests (tests/test_ops.py:58-92): P(random) =
eps within 4 standard deviations, a uniform histogram at eps = 1, and seed
dependence. The twin against the CUDA kernel: tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cuda import eps_edge_rows

from purejaxql_torch.ops import eps_greedy as teg
from purejaxql_torch.ops.philox import philox4x32_10, seed_key
from purejaxql_tpu.algo.exploration import eps_greedy_batch as jax_eps_greedy_batch

torch.set_num_threads(1)


def _q_with_ties(E, A, seed):
    """Q-values with rows of every kind the argmax meets: distinct values,
    a maximum tied two and three ways, all equal, a NaN, two NaNs, -0.0
    against 0.0, and infinities."""
    rng = np.random.RandomState(seed)
    q = rng.randn(E, A).astype(np.float32)
    q[0, [3, 7]] = 9.0
    q[1, [A - 1, 2, 5]] = 9.0
    q[2] = 1.5
    q[3, 4] = np.nan
    q[4, [6, 2]] = np.nan
    q[5] = -1.0
    q[5, [1, 0]] = [0.0, -0.0]
    q[6, [3, 9]] = np.inf
    q[7] = -np.inf
    q[8:] = np.round(q[8:] * 2) / 2  # many ties among the other rows
    return q


@pytest.mark.parametrize("E,A", [(1024, 34), (1000, 34), (512, 6), (8, 1)])
def test_twin_at_eps_zero_equals_jax_eps_greedy_batch(E, A):
    if A >= 10:
        q = _q_with_ties(E, A, E)
    else:  # half-integer values: ties in most rows
        q = (np.round(np.random.RandomState(E).randn(E, A) * 2) / 2).astype(np.float32)
    want = jax.jit(jax_eps_greedy_batch)(jax.random.PRNGKey(0), jnp.asarray(q), jnp.zeros(E))
    got = teg.eps_greedy_plain(12345, torch.tensor(q), 0.0)
    assert got.dtype == torch.int64 and got.shape == (E,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("A", [1, 2, 34, 65])
def test_twin_takes_edge_rows_as_jnp_argmax(A):
    """At eps 0 the twin's action is jnp.argmax's on the edge rows
    (``eps_edge_rows``: signed zeros, NaN payloads, infinities), for a single
    action, two, the Craftax trainer's 34, and 65, more than two per lane
    of a warp."""
    q = eps_edge_rows(A)
    want = np.asarray(jnp.argmax(jnp.asarray(q), axis=-1))
    got = teg.eps_greedy_plain(5, torch.tensor(q), 0.0)
    np.testing.assert_array_equal(got.numpy(), want)
    if A >= 34:  # the rows' own answers: the first zero, the first NaN, ...
        assert list(want[:2]) == [A // 3, A // 3] and want[-2] == 0 and want[-3] == 0


def _numpy_kernel(seed, q, eps):
    """``_eps_greedy_kernel``'s arithmetic in numpy (pallas_explore.py:26-39),
    on the Philox words of counter (0, e, 0, 0): argmax, a coin from the top
    24 bits of word 0 as a float32 in [0, 1), the random action from the top
    24 bits of word 1 mod A."""
    E, A = q.shape
    env = torch.arange(E, dtype=torch.int64)
    zero = torch.zeros_like(env)
    w0, w1, _, _ = (w.numpy().astype(np.uint32) for w in philox4x32_10((zero, env, zero, zero), seed_key(seed)))
    greedy = np.argmax(q, axis=-1).astype(np.int32)
    u = (w0 >> 8).astype(np.int32).astype(np.float32) * np.float32(1.0 / (1 << 24))
    random_actions = (w1 >> 8).astype(np.int32) % A
    return np.where(u < np.float32(eps), random_actions, greedy)


@pytest.mark.parametrize("eps", [0.0, 0.3, 1.0, 0.05])
@pytest.mark.parametrize("seed", [0, 7, 2**62 + 12345, 2**64 - 1])
def test_twin_equals_numpy_restatement_of_the_kernel(eps, seed):
    q = _q_with_ties(1000, 34, seed % 1000)
    np.testing.assert_array_equal(teg.eps_greedy_plain(seed, torch.tensor(q), eps).numpy(), _numpy_kernel(seed, q, eps))


def test_twin_statistics():
    """The twins of test_pallas_eps_greedy_statistics and
    _seed_dependence: P(action != greedy) = eps * (A - 1) / A within 4
    standard deviations over 64 seeds of 1024 envs, a uniform histogram over
    34 actions at eps = 1 (every bin within 4 standard deviations), and other
    seeds give other actions."""
    E, A = 1024, 34
    q = np.zeros((E, A), np.float32)
    q[:, 5] = 1.0  # greedy is action 5 everywhere
    qt = torch.tensor(q)
    for eps in (0.1, 0.5):
        acts = torch.cat([teg.eps_greedy_plain(s, qt, eps) for s in range(64)])
        p = eps * (A - 1) / A
        n = acts.numel()
        assert abs((acts != 5).float().mean().item() - p) < 4 * (p * (1 - p) / n) ** 0.5, eps
    acts = torch.cat([teg.eps_greedy_plain(s, qt, 1.0) for s in range(64)])
    counts = torch.bincount(acts, minlength=A).float()
    mean = acts.numel() / A
    assert ((counts - mean).abs() < 4 * (mean * (1 - 1 / A)) ** 0.5).all(), counts
    a, b = teg.eps_greedy_plain(1, qt, 1.0), teg.eps_greedy_plain(2, qt, 1.0)
    assert (a != b).float().mean() > 0.9


def test_wrapper_takes_the_twin_on_the_cpu():
    q = torch.tensor(_q_with_ties(64, 34, 3))
    before = teg.eps_greedy.launches
    assert torch.equal(teg.eps_greedy(99, q, 0.3), teg.eps_greedy_plain(99, q, 0.3))
    assert teg.eps_greedy.launches == before  # a CPU call launches nothing
    with pytest.raises(ValueError, match="device"):
        teg.eps_greedy(99, q.to("meta"), 0.3)
