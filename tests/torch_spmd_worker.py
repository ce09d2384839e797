"""Rank code for tests/test_torch_spmd.py and tests/test_torch_spmd_families.py
(not collected by pytest, as tests/multiproc_worker.py is not).

``spawn(jobs, world, tmp_dir, payload)`` starts ``world`` processes with
``torch.multiprocessing``, each one rank of a ``gloo`` group on the CPU
joined through a ``file://`` store in ``tmp_dir`` (no TCP port to collide
between test workers), one thread each. Every rank runs the named jobs in
order, each a function of this module taking the rank's context, and saves
their results to ``tmp_dir/rank{r}.pt``; ``spawn`` returns the ranks'
results. The process group has a timeout and the spawn a deadline, so a
rank that raises or hangs fails the test with a non-zero exit of its own and
never blocks the suite. This module imports the port only, never JAX.
"""

from __future__ import annotations

import os
import time
from types import SimpleNamespace

import numpy as np
import torch

GROUP_TIMEOUT_S = 60.0


def spawn(jobs, world: int, tmp_dir, payload=None, deadline_s: float = 150.0):
    """Run ``jobs`` (names of this module's job functions) on ``world``
    spawned ranks; returns the list of the ranks' result dicts, each
    ``{job: result}``."""
    import torch.multiprocessing as mp

    tmp_dir = str(tmp_dir)
    torch.save(payload or {}, os.path.join(tmp_dir, "payload.pt"))
    ctx = mp.start_processes(_rank_main, args=(world, tmp_dir, tuple(jobs)), nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + deadline_s
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            raise TimeoutError(f"{world} ranks of {jobs} still running after {deadline_s} s")
    return [torch.load(os.path.join(tmp_dir, f"rank{r}.pt"), weights_only=False) for r in range(world)]


def _rank_main(rank: int, world: int, tmp_dir: str, jobs) -> None:
    import torch.distributed as dist

    from purejaxql_torch.parallel.mesh import init_distributed

    torch.set_num_threads(1)
    # torchrun's variables; init_distributed reads the rank and world from them
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    assert init_distributed(backend="gloo", init_method=f"file://{tmp_dir}/store", timeout_s=GROUP_TIMEOUT_S)
    ctx = SimpleNamespace(rank=rank, world=world, tmp_dir=tmp_dir,
                          payload=torch.load(os.path.join(tmp_dir, "payload.pt"), weights_only=False))
    results = {}
    for job in jobs:
        results[job] = globals()[job](ctx)
    torch.save(results, os.path.join(tmp_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


# ---- helpers ---------------------------------------------------------------


def compose_cpu(alg: str, **overrides):
    from purejaxql_torch.core.config import compose

    return compose(alg=alg, overrides=[f"{k}={v}" for k, v in {"DEVICE": "cpu", **overrides}.items()])


def state_of(train_state):
    """Every parameter and buffer of a train state as numpy (the
    actor-critic family's under ``actor.`` and ``critic.``)."""
    from purejaxql_torch.parallel.spmd import named_state

    return {k: v.detach().cpu().numpy() for k, v in named_state(train_state).items()}


def metrics_of(metrics):
    return {k: np.asarray(v.cpu()) for k, v in metrics.items()}


def shard(x: np.ndarray, ctx, axis: int = 0) -> torch.Tensor:
    return torch.tensor(np.split(x, ctx.world, axis)[ctx.rank])


# the tests' small configs: global NUM_ENVS, sharded by the spawn's world
FF = dict(TOTAL_TIMESTEPS=2048, TOTAL_TIMESTEPS_DECAY=2048, NUM_ENVS=16, NUM_STEPS=16, NUM_MINIBATCHES=2,
          NUM_EPOCHS=1, HIDDEN_SIZE=32, TEST_DURING_TRAINING=False)


def _spmd(config, make_train=None, extra=None, **kw):
    import torch.distributed as dist

    from purejaxql_torch.parallel.mesh import make_mesh
    from purejaxql_torch.parallel.spmd import make_train_spmd

    if make_train is not None:
        kw["make_train"] = make_train
    t0 = time.perf_counter()
    out = make_train_spmd(config, make_mesh(env=dist.get_world_size()), **kw)()
    counters = out["train_state"]["actor"] if isinstance(out["train_state"], dict) else out["train_state"]
    return {"state": state_of(out["train_state"]), "metrics": metrics_of(out["metrics"]),
            "timesteps": counters.timesteps, "seconds": time.perf_counter() - t0,
            **(extra(out) if extra is not None else {})}


# ---- jobs ------------------------------------------------------------------


def hygiene(ctx):
    """The process group from torchrun's variables, the main process, and
    the logger's sinks on rank 0 only (on every rank with
    LOG_ALL_PROCESSES)."""
    import torch.distributed as dist

    from purejaxql_torch.parallel.mesh import init_distributed, is_main_process
    from purejaxql_torch.utils.logging import make_logger

    return {
        "rank": dist.get_rank(), "world": dist.get_world_size(), "backend": dist.get_backend(),
        "again": init_distributed(), "main": is_main_process(),
        "sinks": len(make_logger({"LOG_CONSOLE": True}).sinks),
        "sinks_all": len(make_logger({"LOG_CONSOLE": True, "LOG_ALL_PROCESSES": True}).sinks),
    }


def eval_mean(ctx):
    """``episode_mean_metrics`` over the group on each case's env shard."""
    import torch.distributed as dist

    from purejaxql_torch.algo.metrics import episode_mean_metrics

    out = {}
    for name, infos in ctx.payload["eval_cases"].items():
        local = {k: shard(v, ctx, 1) for k, v in infos.items()}
        out[name] = {k: float(v) for k, v in episode_mean_metrics(local, group=dist.group.WORLD).items()}
    return out


def norm_forward(ctx):
    """A train-mode forward of each case's network (``make_q_network`` with
    the group) from the flax weights on the rank's rows, then the gradient
    of sum(w * Q) all-reduce-meaned: Q, the running statistics after it,
    the gradients."""
    import torch.distributed as dist

    from purejaxql_torch.core.checkpoint import params_from_flax
    from purejaxql_torch.models.factory import make_q_network
    from purejaxql_torch.parallel.mesh import pmean_

    out = {}
    for name, case in ctx.payload["norm_cases"].items():
        x = case["x"]
        net = make_q_network(case["config"], case["action_dim"], x.shape[1:], generator=torch.Generator(),
                             group=dist.group.WORLD)
        net.load_state_dict(params_from_flax(case["variables"]))
        q = net(shard(x, ctx), train=True)
        (q * shard(case["w"], ctx)).sum().backward()
        params = dict(net.named_parameters())
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params.values()]
        pmean_(grads, dist.group.WORLD)
        out[name] = {"q": q.detach().numpy(), "stats": {k: v.numpy() for k, v in net.named_buffers()},
                     "grads": {k: g.numpy() for k, g in zip(params, grads)}}
    return out


def minibatch_steps(ctx):
    """Two minibatch steps of the FF trainer (``algo/pqn.py:learn_minibatch``:
    the train-mode forward, the TD loss, the gradient mean, clip and RAdam)
    on the rank's rows of each minibatch."""
    import torch.distributed as dist

    from purejaxql_torch.algo.pqn import learn_minibatch
    from purejaxql_torch.core.checkpoint import params_from_flax
    from purejaxql_torch.core.optim import make_optimizer
    from purejaxql_torch.models.factory import make_q_network

    case = ctx.payload["minibatch"]
    group = dist.group.WORLD
    net = make_q_network(case["config"], case["action_dim"], case["obs"].shape[2:], generator=torch.Generator(),
                         group=group)
    net.load_state_dict(params_from_flax(case["variables"]))
    optimizer = make_optimizer(net.parameters(), case["max_grad_norm"], case["lr"], group=group)
    losses = []
    for m in range(case["obs"].shape[0]):
        loss, _ = learn_minibatch(net, optimizer, shard(case["obs"][m], ctx), shard(case["action"][m], ctx).long(),
                                  shard(case["target"][m], ctx))
        losses.append(float(loss))
    return {"state": {k: v.detach().numpy() for k, v in net.state_dict().items()}, "losses": losses}


def ff_unfused(ctx):
    """pqn_cartpole sharded, with the eval: the global counter, the
    replicas, finite metrics, the rank's last observations (its own envs)."""
    return _spmd(compose_cpu("pqn_cartpole", **{**FF, "TEST_DURING_TRAINING": True, "TEST_INTERVAL": 0.5,
                                                 "TEST_NUM_ENVS": 8, "TEST_NUM_STEPS": 100}),
                 extra=lambda out: {"obs": out["runner_state"][1][0].numpy()})


def ff_batch_norm(ctx):
    """The cross-replica BatchNorm config (NORM_TYPE=batch_norm, NORM_INPUT)."""
    return _spmd(compose_cpu("pqn_cartpole", **FF, NORM_TYPE="batch_norm", NORM_INPUT=True))


def ff_segmented(ctx):
    """``train_segmented_spmd`` in 2 segments against one
    ``make_train_spmd_resumable`` run: params and the rank's env state."""
    import torch.distributed as dist

    from purejaxql_torch.parallel.mesh import make_mesh
    from purejaxql_torch.parallel.spmd import make_train_spmd_resumable, train_segmented_spmd

    config = compose_cpu("pqn_cartpole", **{**FF, "TOTAL_TIMESTEPS": 4096, "TOTAL_TIMESTEPS_DECAY": 4096})
    mesh = make_mesh(env=dist.get_world_size())
    whole = make_train_spmd_resumable(config, mesh)()
    seg = train_segmented_spmd(config, mesh, num_segments=2)

    def env_leaves(runner_state):
        obs, log_state = runner_state[1]
        leaves = [obs, log_state.episode_returns, log_state.episode_lengths, log_state.timestep]
        leaves += [getattr(log_state.env_state, f) for f in vars(log_state.env_state)]
        return [t.numpy() for t in leaves if torch.is_tensor(t)]

    return {"whole": state_of(whole["runner_state"][0]), "seg": state_of(seg["runner_state"][0]),
            "whole_env": env_leaves(whole["runner_state"]), "seg_env": env_leaves(seg["runner_state"]),
            "whole_td": whole["metrics"]["td_loss"].numpy(), "seg_td": seg["metrics"]["td_loss"].numpy(),
            "timesteps": seg["runner_state"][0].timesteps}


def ff_seeds(ctx):
    """``make_train_spmd_seeds`` on a (2, world / 2) mesh."""
    from purejaxql_torch.parallel.mesh import make_mesh
    from purejaxql_torch.parallel.spmd import make_train_spmd_seeds

    out = make_train_spmd_seeds(compose_cpu("pqn_cartpole", **FF), make_mesh(seed=2))()
    return {"state": {k: v.numpy() for k, v in out["state_dict"].items()}, "metrics": metrics_of(out["metrics"]),
            "own": state_of(out["train_state"]), "timesteps": out["train_state"].timesteps}


def cli_save(ctx):
    """The CLI's sharded run with SAVE_PATH: how often this rank saved."""
    from purejaxql_torch import cli
    from purejaxql_torch.core import checkpoint

    calls = []
    save_run = checkpoint.save_run
    checkpoint.save_run = lambda *a, **k: (calls.append(a[3]), save_run(*a, **k))
    try:
        config = compose_cpu("pqn_cartpole", **{**FF, "TOTAL_TIMESTEPS": 512},
                             SAVE_PATH=os.path.join(ctx.tmp_dir, "cli"))
        outs = cli.single_run(config)
    finally:
        checkpoint.save_run = save_run
    return {"saves": calls, "timesteps": outs["train_state"].timesteps}


def fused_cartpole(ctx):
    """FUSED_ROLLOUT=True sharded: the CartPole kernel's twin on each
    rank's envs (tests/test_fused_spmd.py::test_fused_rollout_under_shard_map)."""
    config = compose_cpu("pqn_cartpole", TOTAL_TIMESTEPS=1024, TOTAL_TIMESTEPS_DECAY=1024, NUM_ENVS=32,
                         NUM_STEPS=16, NUM_MINIBATCHES=1, NUM_EPOCHS=1, HIDDEN_SIZE=64,
                         TEST_DURING_TRAINING=False, FUSED_ROLLOUT=True)
    return _spmd(config)


def rnn(ctx):
    """pqn_rnn_cartpole sharded (tests/test_spmd_families.py::test_spmd_rnn),
    with an eval, on FAST_BPTT through the GRU kernels' twins."""
    from purejaxql_torch.algo import pqn_rnn

    config = compose_cpu("pqn_rnn_cartpole", TOTAL_TIMESTEPS=1024, TOTAL_TIMESTEPS_DECAY=1024, NUM_ENVS=8,
                         NUM_STEPS=16, NUM_MINIBATCHES=2, NUM_EPOCHS=1, HIDDEN_SIZE=32, MEMORY_WINDOW=2,
                         TEST_DURING_TRAINING=True, TEST_INTERVAL=0.5, TEST_NUM_ENVS=4, TEST_NUM_STEPS=30,
                         FAST_BPTT=True, PALLAS_BPTT=True)
    return _spmd(config, pqn_rnn.make_train)


def rnn_batch_norm(ctx):
    """The recurrent trainer with a BatchNorm trunk and input (the module
    path): cross-replica statistics in lockstep."""
    from purejaxql_torch.algo import pqn_rnn

    config = compose_cpu("pqn_rnn_cartpole", TOTAL_TIMESTEPS=512, TOTAL_TIMESTEPS_DECAY=512, NUM_ENVS=8,
                         NUM_STEPS=16, NUM_MINIBATCHES=2, NUM_EPOCHS=1, HIDDEN_SIZE=32, MEMORY_WINDOW=2,
                         TEST_DURING_TRAINING=False, NORM_TYPE="batch_norm", NORM_INPUT=True)
    return _spmd(config, pqn_rnn.make_train)


def vdn(ctx):
    """pqn_vdn_spread sharded (tests/test_spmd_families.py::test_spmd_vdn)."""
    from purejaxql_torch.algo import pqn_vdn

    config = compose_cpu("pqn_vdn_spread", TOTAL_TIMESTEPS=1600, NUM_ENVS=8, NUM_STEPS=25, MEMORY_WINDOW=2,
                         NUM_MINIBATCHES=2, NUM_EPOCHS=1, HIDDEN_SIZE=32, TEST_DURING_TRAINING=True,
                         TEST_INTERVAL=0.5, TEST_NUM_ENVS=4, FAST_BPTT=True, PALLAS_BPTT=True)
    return _spmd(config, pqn_vdn.make_train)


def ac(ctx):
    """pqn_pendulum sharded, unfused with the greedy eval
    (tests/test_spmd_families.py::test_spmd_ac)."""
    from purejaxql_torch.algo import pqn_ac

    config = compose_cpu("pqn_pendulum", TOTAL_TIMESTEPS=2048, NUM_ENVS=16, NUM_STEPS=32, NUM_MINIBATCHES=2,
                         NUM_EPOCHS=1, ACTOR_HIDDEN_SIZES="[32,32]", CRITIC_HIDDEN_SIZES="[32,32]",
                         TEST_DURING_TRAINING=True, TEST_INTERVAL=0.5, TEST_NUM_ENVS=8, TEST_NUM_STEPS=200)
    return _spmd(config, pqn_ac.make_train)


def ac_fused(ctx):
    """pqn_pendulum sharded with FUSED_ROLLOUT: the Pendulum kernel's twin
    on each rank's envs, the chunked eval's global mean."""
    from purejaxql_torch.algo import pqn_ac

    config = compose_cpu("pqn_pendulum", TOTAL_TIMESTEPS=2048, NUM_ENVS=16, NUM_STEPS=32, NUM_MINIBATCHES=2,
                         NUM_EPOCHS=1, ACTOR_HIDDEN_SIZES="[256,256]", CRITIC_HIDDEN_SIZES="[256,256]",
                         TEST_DURING_TRAINING=True, TEST_INTERVAL=0.5, TEST_NUM_ENVS=8, TEST_NUM_STEPS=200,
                         FUSED_ROLLOUT=True)
    return _spmd(config, pqn_ac.make_train)


def ac_batch_norm(ctx):
    """The actor-critic trainer with batch_norm: the actor's BatchNorms and
    the critic ensemble's stacked ones over the group, in lockstep."""
    from purejaxql_torch.algo import pqn_ac

    config = compose_cpu("pqn_pendulum", TOTAL_TIMESTEPS=1024, NUM_ENVS=16, NUM_STEPS=32, NUM_MINIBATCHES=2,
                         NUM_EPOCHS=1, ACTOR_HIDDEN_SIZES="[32,32]", CRITIC_HIDDEN_SIZES="[32,32]",
                         TEST_DURING_TRAINING=False, NORM_TYPE="batch_norm")
    return _spmd(config, pqn_ac.make_train)


def failing(ctx):
    """Rank 1 raises before a collective that rank 0 enters."""
    import torch.distributed as dist

    if ctx.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.all_reduce(torch.ones(1))
    return {}


# ---- on the card (tests/test_torch_cuda.py): CUDA tensors through gloo on cuda:0 ----


def cuda_collectives(ctx):
    """The port's collectives on CUDA tensors: pmean_, psum_, gather_rows,
    and pmean_moments with its backward (the cotangent meaned too)."""
    import torch.distributed as dist

    from purejaxql_torch.parallel.mesh import gather_rows, pmean_, pmean_moments, psum_

    group, dev = dist.group.WORLD, torch.device("cuda", 0)
    a, b = torch.full((5,), ctx.rank + 1.0, device=dev), torch.full((2, 3), 10.0 * (ctx.rank + 1), device=dev)
    pmean_([a, b], group)
    c = torch.full((4,), ctx.rank + 1.0, device=dev)
    psum_([c], group)
    rows = gather_rows(torch.arange(3, device=dev) + 10 * ctx.rank, group)
    m = torch.full((3,), ctx.rank + 1.0, device=dev, requires_grad=True)
    m2 = torch.full((3,), 2.0 * (ctx.rank + 1), device=dev, requires_grad=True)
    gm, gm2 = pmean_moments(m, m2, group)
    ((ctx.rank + 1.0) * gm.sum() + gm2.sum()).backward()
    return {k: v.detach().cpu().numpy() for k, v in
            {"pmean_a": a, "pmean_b": b, "psum": c, "rows": rows, "moments": gm, "moments2": gm2,
             "grad_m": m.grad, "grad_m2": m2.grad}.items()}


# the CartPole kernel takes H // 32 actions: H 64 for CartPole's 2
CUDA_FF = {**FF, "HIDDEN_SIZE": 64}


def _cuda_spmd(config):
    from purejaxql_torch.ops import cartpole_rollout, eps_greedy, lambda_returns

    counters = {"lambda_returns": lambda_returns.lambda_returns, "cartpole_rollout": cartpole_rollout.cartpole_rollout,
                "eps_greedy": eps_greedy.eps_greedy}
    for f in counters.values():
        f.launches = 0
    out = _spmd(config)
    out["device"] = str(torch.cuda.get_device_name(0))
    out["launches"] = {k: f.launches for k, f in counters.items()}
    return out


def cuda_ff(ctx):
    """pqn_cartpole sharded on cuda:0 (the cuda policy: the CartPole kernel,
    the returns kernel)."""
    from purejaxql_torch.core.config import compose

    return _cuda_spmd(compose(alg="pqn_cartpole", overrides=[f"{k}={v}" for k, v in CUDA_FF.items()]))


def cuda_batch_norm(ctx):
    """The cross-replica BatchNorm config on cuda:0 (unfused: the
    epsilon-greedy kernel)."""
    from purejaxql_torch.core.config import compose

    return _cuda_spmd(compose(alg="pqn_cartpole", overrides=[f"{k}={v}" for k, v in CUDA_FF.items()]
                              + ["NORM_TYPE=batch_norm", "NORM_INPUT=True"]))
