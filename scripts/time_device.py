#!/usr/bin/env python3
"""The device time of the epsilon-greedy and lambda-returns kernels
(csrc/eps_greedy.cu, csrc/lambda_returns.cu, both of its forms), apart from
their wrappers' host time, on one GPU, beside an empty kernel's launch
floor.

    python scripts/time_device.py [--out FILE] [--parent-csrc DIR]

Each kernel at its trainers' shapes: epsilon-greedy at (E 1024, A 34),
pqn_craftax's NUM_ENVS and actions; the lambda returns' gymnax form at
(T 32, E 128), pqn_minatar's, (T 64, E 32), pqn_cartpole's, and (T 32,
E 64), pqn_pendulum's, and their closure form at (T 131, E 2) and (T 67,
E 2), the recurrent trainer's minibatch windows on MemoryChain and on
CartPole (MEMORY_WINDOW + NUM_STEPS - 1 steps of NUM_ENVS /
NUM_MINIBATCHES envs), and at (T 28, E 16) and (T 67, E 16), the VDN
trainer's on Spread and on Skirmish / SMAX; and an empty kernel
(``EMPTY_SOURCE``, built by nvcc with the port's flags into build/, launched
through ctypes) on epsilon-greedy's grid at that shape (128 blocks of 256
threads), the floor that any launch of that grid pays, and beside it a
kernel on the same grid that only reads each row's first Q-value and
writes one int64 from it (``load_store_kernel``), the floor of a launch
whose output waits on one read of its input. For each, over ITERS
back-to-back calls of the wrapper:

1. ``wrapper_ms``: CUDA events around the calls, divided by their count, as
   chip_smoke.py times every kernel: the card waits on the host's Python,
   allocation and ctypes path between launches;
2. ``device_ms``: torch.profiler's CUDA time of the kernel, found by name,
   divided by the launches it counted (null where the profiler saw none);
3. ``graph_ms``: a CUDA graph that captured the same calls, replayed under
   CUDA events: the launches back to back on the device with no host work
   between them, so one launch's floor where the kernel is shorter.

With ``--parent-csrc DIR`` (an earlier csrc/, e.g. ``git archive <commit>
purejaxql_torch/csrc`` unpacked under build/), the earlier epsilon-greedy
and lambda-returns kernels too, each built from DIR with the same nvcc
flags and called through its C entry point on the same inputs (the
returns' entry point with the one-thread-an-env signature), the earlier
epsilon-greedy's actions and the earlier gymnax returns held against the
current kernel's bit for bit; each pair is measured in turns: earlier,
current, current, earlier.

The outputs are held against the plain twin first. Prints one JSON line a
kernel and shape, then a summary object as the last line with the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ITERS = 200
# a kernel that does nothing, launched as epsilon-greedy launches its own
EMPTY_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
__global__ void load_store_kernel(const float* q, long long* out, int E, int A) {
  const int e = blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  if (e < E && (threadIdx.x & 31) == 0) out[e] = q[(long long)e * A] > 0.0f;
}
extern "C" int load_store_launch(int blocks, int threads, const float* q, long long* out, int E, int A,
                                 void* stream) {
  load_store_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(q, out, E, A);
  return (int)cudaGetLastError();
}
"""
EPS_GREEDY_SHAPE = (1024, 34)
LAMBDA_SHAPES = ((32, 128), (64, 32), (32, 64))
CLOSURE_SHAPES = ((131, 2), (67, 2), (28, 16), (67, 16))


def events_ms(fn, iters: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profiled_ms(fn, pattern: str, iters: int):
    """(mean CUDA time of the kernels whose name holds `pattern`, their
    count, their names) from torch.profiler over `iters` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us, count, names = 0.0, 0, []
    for e in prof.key_averages():
        if pattern not in e.key or e.key.startswith("cuda"):
            continue
        us = getattr(e, "self_device_time_total", None)
        us = us if us is not None else getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            total_us += us
            count += e.count
            names.append(e.key)
    return (total_us / 1000.0 / count if count else None), count, names


def graph_ms(fn, iters: int) -> float:
    """CUDA events around replays of a graph that captured `iters` calls."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return events_ms(graph.replay, 5) / iters


def floor_library():
    """EMPTY_SOURCE built into build/time_device/ with the port's nvcc flags
    and loaded."""
    import ctypes

    from purejaxql_torch.ops import build

    out_dir = os.path.join(ROOT, "build", "time_device")
    os.makedirs(out_dir, exist_ok=True)
    src, lib_path = os.path.join(out_dir, "empty.cu"), os.path.join(out_dir, "empty.so")
    with open(src, "w") as f:
        f.write(EMPTY_SOURCE)
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", lib_path, src], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the empty kernel:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(lib_path)


def empty_kernel(lib, blocks: int, threads: int):
    """A call that launches EMPTY_SOURCE's empty kernel on the current
    stream."""
    import ctypes

    import torch

    fn = lib.empty_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]

    def call():
        err = fn(blocks, threads, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"the empty kernel's launch failed ({err})")

    return call


def load_store_kernel(lib, blocks: int, threads: int, q):
    """A call that launches EMPTY_SOURCE's load_store_kernel over the rows
    of q into a new int64 vector on the current stream."""
    import ctypes

    import torch

    fn = lib.load_store_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]

    def call():
        out = torch.empty(q.shape[0], dtype=torch.int64, device=q.device)
        err = fn(blocks, threads, q.data_ptr(), out.data_ptr(), *q.shape, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"the load-store kernel's launch failed ({err})")
        return out

    return call


def parent_eps_greedy(src_dir: str):
    """The earlier epsilon-greedy kernel's C entry point (the same signature
    as csrc/eps_greedy.cu's), built into build/time_device/ from DIR with
    DIR's headers, as a call with the current wrapper's arguments."""
    import ctypes

    import torch

    from purejaxql_torch.ops import build

    out_dir = os.path.join(ROOT, "build", "time_device")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, "eps_greedy_parent.so")
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", src_dir, "-o", lib_path, os.path.join(src_dir, "eps_greedy.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the earlier eps_greedy.cu:\n{proc.stdout}{proc.stderr}")
    fn = ctypes.CDLL(lib_path).eps_greedy_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_uint64,
                   ctypes.c_void_p]

    def call(seed, q, eps):
        out = torch.empty(q.shape[0], dtype=torch.int64, device=q.device)
        err = fn(q.data_ptr(), out.data_ptr(), *q.shape, eps, seed, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"the earlier eps_greedy's launch failed ({err})")
        return out

    return call


def parent_lambda_returns(src_dir: str):
    """The earlier lambda-returns kernel's gymnax entry point (the
    one-thread-an-env signature: pointers, T, E, gamma, gamma * lam,
    stream), built into build/time_device/ from DIR with DIR's headers, as a
    call with the current wrapper's arguments."""
    import ctypes

    import torch

    from purejaxql_torch.ops import build

    out_dir = os.path.join(ROOT, "build", "time_device")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, "lambda_returns_parent.so")
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", src_dir, "-o", lib_path,
           os.path.join(src_dir, "lambda_returns.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the earlier lambda_returns.cu:\n{proc.stdout}{proc.stderr}")
    fn = ctypes.CDLL(lib_path).lambda_returns_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]

    def call(last_q, rew, done, maxq, gamma, lam):
        T, E = rew.shape
        out = torch.empty_like(rew)
        err = fn(last_q.data_ptr(), rew.data_ptr(), done.data_ptr(), maxq.data_ptr(), out.data_ptr(), T, E, gamma,
                 gamma * lam, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"the earlier lambda_returns' launch failed ({err})")
        return out

    return call


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=None, help="also write the summary JSON here")
    ap.add_argument("--parent-csrc", default=None,
                    help="directory with the earlier eps_greedy.cu, lambda_returns.cu and their headers")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_device: no GPU visible", file=sys.stderr)
        return 1
    from purejaxql_torch.ops import eps_greedy as eg
    from purejaxql_torch.ops import lambda_returns as lr

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []
    E, A = EPS_GREEDY_SHAPE
    q = torch.randn(E, A, device=dev, generator=gen)
    if not torch.equal(eg.eps_greedy(3, q, 0.1), eg.eps_greedy_plain(3, q, 0.1)):
        raise AssertionError("eps_greedy differs from its twin")
    current = ("eps_greedy", {"E": E, "A": A}, lambda: eg.eps_greedy(3, q, 0.1))
    if args.parent_csrc:
        old_call = parent_eps_greedy(args.parent_csrc)
        if not torch.equal(old_call(3, q, 0.1), eg.eps_greedy(3, q, 0.1)):
            raise AssertionError("the earlier eps_greedy's actions differ from the current kernel's")
        earlier = ("eps_greedy", {"E": E, "A": A, "version": "earlier"}, lambda: old_call(3, q, 0.1))
        cases += [earlier, current, current, earlier]  # in turns
    else:
        cases.append(current)
    blocks = -(-E // 8)  # csrc/eps_greedy.cu: 8 warps a block, a warp a row
    floors = floor_library()
    cases.append(("empty_kernel", {"blocks": blocks, "threads": 256}, empty_kernel(floors, blocks, 256)))
    cases.append(("load_store_kernel", {"blocks": blocks, "threads": 256, "E": E, "A": A},
                  load_store_kernel(floors, blocks, 256, q)))
    old_returns = parent_lambda_returns(args.parent_csrc) if args.parent_csrc else None
    for T, E in LAMBDA_SHAPES + CLOSURE_SHAPES:
        last_q, maxq = torch.randn(E, device=dev, generator=gen), torch.randn(T, E, device=dev, generator=gen)
        rew = torch.randn(T, E, device=dev, generator=gen)
        done = (torch.rand(T, E, device=dev, generator=gen) < 0.1).float()
        name, kernel, plain = (("lambda_returns", lr.lambda_returns, lr.lambda_returns_plain) if (T, E) in LAMBDA_SHAPES
                               else ("lambda_returns_closure", lr.lambda_returns_closure,
                                     lr.lambda_returns_closure_plain))
        got = kernel(last_q, rew, done, maxq, 0.99, 0.95)
        if not torch.equal(got, plain(last_q, rew, done, maxq, 0.99, 0.95)):
            raise AssertionError(f"{name} at ({T}, {E}) differs from its twin")
        current = (name, {"T": T, "E": E},
                   lambda kernel=kernel, a=(last_q, rew, done, maxq): kernel(*a, 0.99, 0.95))
        if old_returns is not None and name == "lambda_returns":
            if not torch.equal(old_returns(last_q, rew, done, maxq, 0.99, 0.95), got):
                raise AssertionError(f"the earlier lambda_returns differs from the current kernel at ({T}, {E})")
            earlier = (name, {"T": T, "E": E, "version": "earlier"},
                       lambda a=(last_q, rew, done, maxq): old_returns(*a, 0.99, 0.95))
            cases += [earlier, current, current, earlier]  # in turns
        else:
            cases.append(current)
    rows = []
    for name, shape, fn in cases:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        wrapper = events_ms(fn, ITERS)
        # both forms of the returns launch lambda_returns_kernel<form>
        device, count, names = profiled_ms(fn, "lambda_returns" if name.startswith("lambda_returns") else name, ITERS)
        row = {"kernel": name, "shape": shape, "wrapper_ms": wrapper, "device_ms": device,
               "profiled_launches": count, "profiled_names": names, "graph_ms": graph_ms(fn, ITERS)}
        print(json.dumps(row))
        rows.append(row)
    summary = json.dumps({"card": card, "iters": ITERS, "rows": rows})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(summary + "\n")
    print(summary)
    return 0


if __name__ == "__main__":
    sys.exit(main())
