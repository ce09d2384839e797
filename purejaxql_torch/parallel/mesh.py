"""Process groups, the (seed, env) mesh and the trainers' collectives.

Port of purejaxql_tpu/parallel/mesh.py on ``torch.distributed``. Where the
JAX package runs one program over a device mesh (SPMD by ``shard_map``),
the port runs one process a shard, every rank the same trainer (SPMD by
process). Axis convention, as in the JAX package:

- "env": the data-parallel axis. Envs, rollouts and minibatches shard along
  it; gradients, batch-norm statistics, metrics and eval sums reduce over it.
- "seed": independent replicas; no collective crosses it.

Backends are an explicit choice: ``nccl`` where each rank has a card of its
own, ``gloo`` on the CPU (or several ranks sharing one card, whose CUDA
tensors gloo stages through the host). Every collective of the port is an
all-reduce, the one collective gloo takes on CUDA tensors besides
broadcast; a gather is an all-reduce of a zero-filled stack
(``gather_rows``). A backend that cannot take one raises.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

_TORCHRUN_KEYS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def init_distributed(
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    timeout_s: float = 300.0,
) -> bool:
    """Join the default process group (mesh.py:23-56's semantics).

    The arguments, or torchrun's variables (RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR, MASTER_PORT), make it a request, which must succeed or
    raise: a world of two or more that cannot join raises after
    ``timeout_s`` and never falls back to isolated runs that would train
    disjoint models. With neither it is a no-op (the one-process workflow).
    ``backend`` defaults to ``nccl`` where CUDA is visible and ``gloo``
    elsewhere; with ``nccl`` the rank's card (``local_device``) becomes the
    current one. Returns whether a process group is initialized."""
    if dist.is_initialized():
        return True
    explicit = init_method is not None or world_size is not None or rank is not None
    if not explicit and not any(os.environ.get(k) for k in _TORCHRUN_KEYS):
        return False
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", 1))
    if rank is None:
        rank = int(os.environ.get("RANK", 0))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_device())
    dist.init_process_group(
        backend=backend,
        init_method=init_method or "env://",
        world_size=world_size,
        rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return True


def local_device() -> torch.device:
    """The rank's card: ``cuda:{LOCAL_RANK % device_count}``."""
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count())


def make_mesh(env: Optional[int] = None, seed: int = 1, device_type: Optional[str] = None):
    """The (seed, env) ``DeviceMesh`` over every rank of the default group,
    ``mesh_dim_names=("seed", "env")``, rank ``r`` at (r // env, r % env);
    ``env=None`` takes the ranks the seed axis leaves. ``device_type``
    defaults to ``cuda`` on an ``nccl`` world and ``cpu`` on a ``gloo`` one
    (whose groups take CUDA tensors too). Each axis's process group is
    ``mesh.get_group("env")`` / ``mesh.get_group("seed")``."""
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    if env is None:
        assert n % seed == 0, f"{n} ranks not divisible by seed={seed}"
        env = n // seed
    assert seed * env == n, f"mesh {seed}x{env} != {n} ranks"
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (seed, env), mesh_dim_names=("seed", "env"))


def is_main_process() -> bool:
    """Rank 0 of the default group, or no group at all."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _all_reduce_(tensors: Sequence[torch.Tensor], group, mean: bool) -> None:
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1).to(tensors[0].dtype) for t in tensors])
    dist.all_reduce(flat, group=group)
    if mean:
        flat.div_(dist.get_world_size(group))
    start = 0
    for t in tensors:
        t.copy_(flat[start:start + t.numel()].view(t.shape))
        start += t.numel()


def psum_(tensors: Sequence[torch.Tensor], group) -> None:
    """``lax.psum`` in place: each tensor summed over ``group``, as one
    all-reduce of a flat buffer (in the first tensor's dtype)."""
    _all_reduce_(tensors, group, mean=False)


def pmean_(tensors: Sequence[torch.Tensor], group) -> None:
    """``lax.pmean`` in place: each tensor's sum over ``group`` divided by
    the group's size, as one all-reduce of a flat buffer."""
    _all_reduce_(tensors, group, mean=True)


class _PMean(torch.autograd.Function):
    """``lax.pmean`` with its transpose: the backward all-reduce-means the
    cotangent, as JAX's pmean transposes under ``shard_map``, so a loss
    that reads global batch statistics gets the global batch's gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y.div_(dist.get_world_size(group))

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone()
        dist.all_reduce(g, group=ctx.group)
        return g.div_(dist.get_world_size(ctx.group)), None


def pmean_moments(mean: torch.Tensor, mean2: torch.Tensor, group):
    """A batch norm's local mean and E[x^2] all-reduce-meaned over ``group``
    in one collective (flax's ``lax.pmean(concatenate([mean, mean2]))``,
    linen/normalization.py:128), differentiable, in float32 and back to
    their dtype."""
    both = torch.cat([mean.reshape(-1), mean2.reshape(-1)]).float()
    out = _PMean.apply(both, group).to(mean.dtype)
    return out[:mean.numel()].view(mean.shape), out[mean.numel():].view(mean2.shape)


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """(group size, *x.shape): row i is rank i's ``x`` (its rank in
    ``group``), an all-reduce of a zero-filled stack with each rank's own
    row written."""
    out = torch.zeros((dist.get_world_size(group), *x.shape), dtype=x.dtype, device=x.device)
    out[dist.get_rank(group)] = x
    dist.all_reduce(out, group=group)
    return out


def fold_seed(seed: int, index: int) -> int:
    """A seed for stream ``index`` of ``seed`` (``jax.random.fold_in``'s
    role): SplitMix64's finalizer over both, below 2^62. Distinct from
    ``seed + index``, so shard 1's stream is not another seed's
    (algo/seeds.py gives lane i the seed ``seed + i``)."""
    mask = (1 << 64) - 1
    x = (seed * 0x9E3779B97F4A7C15 + (index + 1) * 0xD1B54A32D192ED03) & mask
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & mask
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & mask
    return (x ^ (x >> 31)) >> 2
