"""One run sharded over the ranks of a process group (port of
examples/sharded_training.py): envs split along the mesh's env axis, the
learner replicas in lockstep (parallel/spmd.py).

    # N gloo processes on the CPU, spawned here
    python -m purejaxql_torch.scripts.sharded_training --cpu-ranks 2
    # a card a rank over nccl
    torchrun --nproc_per_node N -m purejaxql_torch.scripts.sharded_training [--alg A] [--updates U]

By default each rank steps the YAML's NUM_ENVS (NUM_ENVS global is that
times the ranks); ``--strong`` keeps the YAML's NUM_ENVS global. The run is
``--updates`` updates without evals. Rank 0 prints the global env-step
counter, the last update's mean return (the same on every rank), the wall
(set-up included, the ranks lined up first) and env-steps/s, and the mean
time of one gradient all-reduce at the network's size. Extra ``KEY=value``
arguments override the config.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time


def run(rank: int, world: int, store, args) -> None:
    """One rank: join the group, train, print from rank 0. ``store`` is a
    ``file://`` rendezvous for spawned CPU ranks, or None under torchrun."""
    import torch
    import torch.distributed as dist

    from purejaxql_torch.core.config import compose
    from purejaxql_torch.parallel.mesh import init_distributed, is_main_process, make_mesh, pmean_
    from purejaxql_torch.parallel.spmd import make_train_spmd

    if store is not None:
        init_distributed(backend="gloo", init_method=store, world_size=world, rank=rank)
    else:
        init_distributed()
    n = dist.get_world_size()
    cpu = ["DEVICE=cpu"] if store is not None else []
    yaml = compose(alg=args.alg, overrides=[*cpu, *args.overrides])
    envs = yaml["NUM_ENVS"] * (1 if args.strong else n)
    steps = args.updates * envs * yaml["NUM_STEPS"]
    config = compose(alg=args.alg, overrides=[
        f"NUM_ENVS={envs}", f"TOTAL_TIMESTEPS={steps}", f"TOTAL_TIMESTEPS_DECAY={steps}",
        "TEST_DURING_TRAINING=False", *cpu, *args.overrides,
    ])
    mesh = make_mesh(env=n)
    sync = torch.cuda.synchronize if torch.cuda.is_available() and not cpu else (lambda: None)
    dist.barrier()
    t0 = time.perf_counter()
    out = make_train_spmd(config, mesh)()
    sync()
    wall = time.perf_counter() - t0
    states = out["train_state"].values() if isinstance(out["train_state"], dict) else [out["train_state"]]
    grads = [[torch.zeros_like(p) for p in s.optimizer.params] for s in states]
    for g in grads:
        pmean_(g, mesh.get_group("env"))
    dist.barrier()
    sync()
    t1 = time.perf_counter()
    for _ in range(20):
        for g in grads:
            pmean_(g, mesh.get_group("env"))
    sync()
    allreduce_ms = 1e3 * (time.perf_counter() - t1) / (20 * len(grads))
    if is_main_process():
        timesteps = next(iter(states)).timesteps
        print(f"{args.alg} on {n} rank{'s' if n > 1 else ''} ({dist.get_backend()}), NUM_ENVS {envs} global; "
              f"global env steps: {timesteps}; final mean return: "
              f"{float(out['metrics']['returned_episode_returns'][-1]):.2f}; wall {wall:.2f} s, "
              f"{timesteps / wall:.0f} env-steps/s; one gradient all-reduce {allreduce_ms:.3f} ms")
    dist.destroy_process_group()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu-ranks", type=int, default=0,
                    help="spawn this many gloo ranks on the CPU (default: join torchrun's group)")
    ap.add_argument("--alg", default="pqn_cartpole")
    ap.add_argument("--updates", type=int, default=16)
    ap.add_argument("--strong", action="store_true", help="the YAML's NUM_ENVS global, split over the ranks")
    args, args.overrides = ap.parse_known_args(argv)
    if not args.cpu_ranks:
        return run(int(os.environ.get("RANK", 0)), int(os.environ.get("WORLD_SIZE", 1)), None, args)
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(run, args=(args.cpu_ranks, f"file://{tmp}/store", args), nprocs=args.cpu_ranks)


if __name__ == "__main__":
    main()
