"""The seed axis of the trainers: NUM_SEEDS = S > 1 trains S seeds as one
program, what ``jax.jit(jax.vmap(make_train(config)))`` over
``jax.random.split(rng, NUM_SEEDS)`` computes in the JAX package
(purejaxql_tpu/cli.py:72-88), in every trainer (FF, recurrent, VDN,
actor-critic) and with every option the JAX CLI vmaps. Every leaf of
``runner_state`` and ``metrics`` gets a leading seed axis of S.

Layout. The network carries the seed axis in its parameters (models/
stacked.py, ``seeds=S``); everything outside it sees *seed-major folded
rows*: S * E envs, seed s's E envs the s-th block, so the envs, the Log
wrapper, epsilon-greedy ((S * E, A) rows) and the lambda returns ((T, S * E)
columns) run as for one seed with S times the envs. Each env steps on its
own, so the fold is exact. Where a wrapper couples envs, it does so within
each seed's block of E (envs/wrappers.py, ``seeds=S``): the optimistic
resets' pool and the reset bank, one a seed, and the actor-critic family's
observation and reward statistics, one state a seed. The VDN trainer keeps
the agents inside each seed's block of rows (algo/pqn_vdn.py), and the
critic ensemble holds M members a seed (models/actor_critic.py). What
differs from one seed:

- the loss is the sum over seeds of each seed's mean (``seed_mean``), so
  each seed's gradient is the one its lane alone would take;
- ``core/optim.py`` clips by each seed's own global norm;
- each seed shuffles its own rows (``seed_permutations``): minibatch m of
  every seed goes into one step, seed-major (``seed_minibatches``);
- the metrics reduce per seed (``seed_mean``, ``seed_sum``), (S,) an
  update; ``timesteps`` counts one seed's steps, as a vmapped lane does.

Randomness (``seed_generators``): lane i's network is drawn from a host
generator seeded SEED + i, so it is the network of a single-seed run with
SEED + i, bit for bit. Lane 0's generator then seeds the device generator
and the kernels, as a single-seed run's does; every env reset, exploration
draw and permutation of all S lanes comes from those streams, so the lanes
train on draws of their own, and no lane repeats a single-seed run past its
initial weights (the streams cannot match JAX's anyway, ROADMAP.md). With
NUM_SEEDS = 1 the trainers run the single-seed program as it is.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

# options whose program is single-seed: the fused rollout kernels, which
# the JAX CLI refuses with seeds too (purejaxql_tpu/cli.py:71-83)
_SINGLE_SEED = ("FUSED_ROLLOUT",)
# families whose envs are stateful host processes, one seed a run: the
# JAX CLI's refusal (purejaxql_tpu/cli.py:57-60; pqn_atari.py:457-458)
SINGLE_SEED_FAMILIES = {"pqn_host": "pqn_host supports NUM_SEEDS=1 only"}


def check_seeds(config: Dict[str, Any]) -> None:
    """Raise ``NotImplementedError`` naming the pair for an option or a
    family (``SINGLE_SEED_FAMILIES``) that runs one seed only
    (``ValueError`` for NUM_SEEDS < 1)."""
    seeds = config.get("NUM_SEEDS", 1)
    if seeds < 1:
        raise ValueError(f"NUM_SEEDS must be at least 1, got {seeds}")
    if seeds == 1:
        return
    family = str(config.get("ALG_NAME"))
    if family in SINGLE_SEED_FAMILIES:
        raise NotImplementedError(SINGLE_SEED_FAMILIES[family])
    for key in _SINGLE_SEED:
        if config.get(key):
            raise NotImplementedError(
                f"{key} with NUM_SEEDS > 1: its kernels run one seed, as in the JAX CLI; drop the flag or run one seed"
            )


def check_group_seeds(config: Dict[str, Any], group) -> None:
    """A sharded trainer (a process ``group``) runs one seed a rank: the
    mesh's seed axis stands for NUM_SEEDS (parallel/spmd.py), as the JAX
    package's sharded trainers ignore it."""
    if group is not None and config.get("NUM_SEEDS", 1) != 1:
        raise NotImplementedError(
            "NUM_SEEDS > 1 with a process group: a sharded trainer runs one seed a rank; "
            "seeds go on the mesh's seed axis (parallel/spmd.py:make_train_spmd_seeds)"
        )


def seed_generators(seed: int, seeds: int) -> List[torch.Generator]:
    """The host generators of the lanes: lane i's seeded ``seed + i``."""
    return [torch.Generator().manual_seed(seed + i) for i in range(seeds)]


def run_generators(host_gen: torch.Generator, device, group=None):
    """A run's (host, device) generators once its network is drawn from
    ``host_gen``: the device generator seeded by a draw of ``host_gen``. In
    a process ``group`` (a sharded trainer) the rank draws from streams of
    its own, the network being the same on every rank: first a host
    generator seeded by ``parallel/mesh.py:fold_seed`` of a draw of
    ``host_gen`` and the rank's index in the group, as the JAX trainers fold
    the axis index in after ``create_agent`` (pqn.py:298-303)."""
    from purejaxql_torch.algo.exploration import draw_seed

    if group is not None:
        import torch.distributed as dist

        from purejaxql_torch.parallel.mesh import fold_seed

        host_gen = torch.Generator().manual_seed(fold_seed(draw_seed(host_gen), dist.get_rank(group)))
    return host_gen, torch.Generator(device=device).manual_seed(draw_seed(host_gen))


def seed_sum(x: torch.Tensor, seeds: int, dim: int = 0) -> torch.Tensor:
    """The sum of ``x``, or with seeds > 1 each seed's sum, (S,), where
    ``dim`` holds seed-major folded rows."""
    if seeds == 1:
        return x.sum()
    dim %= x.dim()
    return x.unflatten(dim, (seeds, -1)).movedim(dim, 0).reshape(seeds, -1).sum(1)


def seed_mean(x: torch.Tensor, seeds: int, dim: int = 0) -> torch.Tensor:
    """The mean of ``x``, or with seeds > 1 each seed's mean, (S,), where
    ``dim`` holds seed-major folded rows."""
    if seeds == 1:
        return x.mean()
    dim %= x.dim()
    return x.unflatten(dim, (seeds, -1)).movedim(dim, 0).reshape(seeds, -1).mean(1)


def seed_rows(x: torch.Tensor, seeds: int) -> torch.Tensor:
    """(T, S * E, ...) rollout columns -> (S, T * E, ...): each seed's rows,
    time-major as one seed's."""
    return x.reshape(x.shape[0], seeds, -1, *x.shape[2:]).transpose(0, 1).reshape(seeds, -1, *x.shape[2:])


def seed_permutations(generator: torch.Generator, seeds: int, n: int, device) -> torch.Tensor:
    """(S, n): a permutation of n rows a seed. One seed draws
    ``torch.randperm`` as the single-seed trainer does; several draw an
    (S, n) uniform and sort it."""
    if seeds == 1:
        return torch.randperm(n, generator=generator, device=device)[None]
    return torch.rand(seeds, n, generator=generator, device=device).argsort(1)


def take_rows(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """x (S, n, ...) with each seed's rows in the order of its row of
    ``perm`` (S, n)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], perm]


def seed_column_minibatches(generator: torch.Generator, seeds: int, n: int, n_minibatches: int,
                            device) -> torch.Tensor:
    """(M, S * n / M): the column indices of each minibatch over S * n
    seed-major columns (the recurrent and VDN trainers' envs), each seed's n
    permuted (``seed_permutations``); minibatch m takes block m of every
    seed's, seed-major."""
    perm = seed_permutations(generator, seeds, n, device) + n * torch.arange(seeds, device=device)[:, None]
    return seed_minibatches(perm, n_minibatches)


def seed_minibatches(x: torch.Tensor, n_minibatches: int) -> torch.Tensor:
    """(S, n, ...) -> (M, S * n / M, ...): minibatch m holds block m of
    every seed's rows, seed-major."""
    S = x.shape[0]
    return x.reshape(S, n_minibatches, -1, *x.shape[2:]).transpose(0, 1).reshape(n_minibatches, -1, *x.shape[2:])
