"""The returns kernel's two forms on the CPU: the closure-form wrapper's
plain twin against the JAX package's `lambda_returns_closure`, the gymnax
form beside it, and the kernel's launch plan against the source's formula.
The kernel itself runs on the card: tests/test_torch_cuda.py and
chip_smoke.py hold it against these twins there."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from purejaxql_torch.ops import build
from purejaxql_torch.ops import lambda_returns as tlr
from purejaxql_tpu.algo.returns import lambda_returns as jax_lambda_returns
from purejaxql_tpu.algo.returns import lambda_returns_closure as jax_lambda_returns_closure

pytestmark = pytest.mark.quick
torch.set_num_threads(1)


def _inputs(T, E, seed, inf_rows=False):
    """last_q (E,), rewards, dones (bool) and max_qs (T, E) from a seed;
    with ``inf_rows`` a NaN, +inf and -inf in a row of max_qs and rewards."""
    rng = np.random.RandomState(seed)
    last_q = rng.randn(E).astype(np.float32)
    rew = rng.randn(T, E).astype(np.float32)
    done = rng.rand(T, E) < 0.15
    maxq = rng.randn(T, E).astype(np.float32)
    if inf_rows:
        maxq[T // 2, : min(E, 3)] = [np.nan, np.inf, -np.inf][: min(E, 3)]
        rew[T // 3, -min(E, 2):] = [np.inf, -np.inf][: min(E, 2)]
    return last_q, rew, done, maxq


@pytest.mark.parametrize("gamma,lam", [(0.99, 0.95), (0.9, 0.5)])
@pytest.mark.parametrize("T,E", [(1, 5), (2, 3), (33, 37), (128, 130)])
@pytest.mark.parametrize("done_dtype", ["bool", "float32"])
def test_lambda_returns_closure_matches_jax(T, E, gamma, lam, done_dtype):
    """Ragged E with random dones, bool or 0/1-float: the closure wrapper on
    CPU tensors within 1e-5 of algo/returns.lambda_returns_closure, and the
    same bits as its plain twin."""
    last_q, rew, done, maxq = _inputs(T, E, T * 1000 + E)
    want = np.asarray(jax_lambda_returns_closure(*map(jnp.asarray, (last_q, rew, done, maxq)), gamma, lam))
    args = [torch.tensor(last_q), torch.tensor(rew), torch.tensor(done.astype(done_dtype)), torch.tensor(maxq)]
    got = tlr.lambda_returns_closure(*args, gamma, lam)
    assert got.shape == (T, E) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, tlr.lambda_returns_closure_plain(*args, gamma, lam))


@pytest.mark.parametrize("form", ["gymnax", "closure"])
@pytest.mark.parametrize("T,E", [(33, 37), (128, 4)])
def test_lambda_returns_twins_follow_jax_through_nan_and_inf(T, E, form):
    """NaN and +-inf in max_qs and rewards: each twin gives NaN where the
    JAX function gives NaN, the same infinities, and the finite values
    within 1e-5."""
    last_q, rew, done, maxq = _inputs(T, E, 7, inf_rows=True)
    jax_fn, fn = ((jax_lambda_returns, tlr.lambda_returns) if form == "gymnax"
                  else (jax_lambda_returns_closure, tlr.lambda_returns_closure))
    want = np.asarray(jax_fn(*map(jnp.asarray, (last_q, rew, done.astype(np.float32), maxq)), 0.99, 0.95))
    got = fn(*map(torch.tensor, (last_q, rew, done.astype(np.float32), maxq)), 0.99, 0.95).numpy()
    assert np.isnan(want).any() and np.isfinite(want).any()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, equal_nan=True)


def test_closure_wrapper_takes_plain_version_on_cpu_without_counting():
    before = (tlr.lambda_returns.launches, tlr.lambda_returns_closure.launches)
    x = torch.zeros(4, 3)
    assert tlr.lambda_returns_closure(torch.zeros(3), x, x.bool(), x, 0.9, 0.9).shape == (4, 3)
    assert (tlr.lambda_returns.launches, tlr.lambda_returns_closure.launches) == before
    with pytest.raises(ValueError, match="unsupported device"):
        tlr.lambda_returns_closure(*(t.to("meta") for t in (torch.zeros(3), x, x, x)), 0.9, 0.9)


def _smem_bytes_of_source(tile, stages):
    """csrc/lambda_returns.cu's `smem_bytes` expression, evaluated with its
    kChunk."""
    source = (build.CSRC_DIR / "lambda_returns.cu").read_text()
    expr = re.search(r"inline int smem_bytes\(int tile, int stages\) \{\s*return (.*?);", source, re.S)
    chunk = int(re.search(r"constexpr int kChunk = (\d+);", source).group(1))
    return eval(expr.group(1), {}, dict(tile=tile, stages=stages, kChunk=chunk))


def _chunk_steps(T, k, chunk):
    """The steps chunk k covers: from T - 1 - chunk k down, not below 0
    (csrc/lambda_returns.cu, the kernel's comment on chunks)."""
    hi = T - k * chunk
    return range(max(0, hi - chunk), hi)


@pytest.mark.parametrize("E", [1, 2, 3, 4, 7, 32, 33, 128, 200, 4096, 4097])
@pytest.mark.parametrize("T", [1, 2, 15, 16, 17, 32, 64, 127, 131, 300, 1024])
def test_lambda_plan_covers_every_env_and_step(T, E):
    """The returns kernel's launch plan: a tile of envs a block (a power of
    two, at most the chain warp's 32 lanes, the last block masked), so every
    env has one block and one lane; chunks of 16 steps from T down (the
    earliest one shorter), so every step is scanned once, latest first; a
    ring of at most 4 slots for the chunks after the first; the shared
    bytes within 227 KB and equal to the source's formula."""
    plan = tlr.lambda_plan(T, E)
    assert plan.threads == 160
    assert plan.tile & (plan.tile - 1) == 0 and plan.tile <= 32 and (plan.tile >= E or plan.tile == 32)
    envs = [b * plan.tile + c for b in range(plan.blocks) for c in range(plan.tile)]
    assert [e for e in envs if e < E] == list(range(E)) and len(envs) - E < plan.tile
    chunks = -(-T // plan.chunk)
    steps = [t for k in range(chunks) for t in reversed(_chunk_steps(T, k, plan.chunk))]
    assert steps == list(range(T - 1, -1, -1))
    assert plan.chunk == 16 and all(1 <= len(_chunk_steps(T, k, plan.chunk)) <= 16 for k in range(chunks))
    assert plan.stages == min(4, chunks - 1)  # chunk 0 needs no slot
    assert plan.smem_bytes == _smem_bytes_of_source(plan.tile, plan.stages) <= 232_448
    assert plan.smem_bytes >= 12 * plan.stages * plan.chunk * plan.tile  # the slots' floats
    assert plan.ints == (plan.tile, plan.stages, plan.smem_bytes)


def test_lambda_plan_rejects_empty_shapes():
    with pytest.raises(ValueError, match="positive"):
        tlr.lambda_plan(0, 4)
    with pytest.raises(ValueError, match="positive"):
        tlr.lambda_plan(4, 0)
