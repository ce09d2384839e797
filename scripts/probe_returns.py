#!/usr/bin/env python3
"""Clock-probe the lambda-returns kernel (csrc/lambda_returns.cu) on one GPU:
where a launch's cycles go, chunk by chunk.

    python scripts/probe_returns.py [--out FILE]

The kernel in the tree carries no probe. This script copies
csrc/lambda_returns.cu to build/probe_returns/, inserts clock64() marks
(raising if the source no longer has the line a mark goes after), builds
the patched kernel with the port's nvcc flags, and runs it at the trainers'
shapes under ``lambda_plan``, its outputs held against the twin. Lane 0 of
the chain warp of block 0 records the clock at the kernel's entry, after
the mbarriers' init, when each chunk's scan starts (chunk 0's loads are
issued at the entry and land inside its scan; a later chunk's wait is for
its slot) and when its steps are scanned; thread 32 (the first loader)
when it has issued each of chunks 1-4; and both ends in %globaltimer nanoseconds, so the
cycles give the SM clock. A second patched copy ("stores at the chunk's
end") keeps the chain but stores only each chunk's earliest step, to show
what the per-step stores cost. Each copy and the tree's kernel are timed
as a replayed CUDA graph of back-to-back launches (time_device.py's
``graph_ms``), in turns. Also writes the SASS of the tree's kernels
(cuobjdump) beside the summary where ``--out`` is given. Prints one JSON
line a shape and a summary object as the last line with the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# (form, T, E): the FF trainers' shapes and the recurrent trainer's window
SHAPES = (("gymnax", 64, 32), ("gymnax", 32, 128), ("closure", 131, 2))
PROBE_DEFS = """
__device__ long long g_probe[80];
#define PROBE_ON (blockIdx.x == 0 && threadIdx.x == 0)
#define PROBE(i) do { if (PROBE_ON) g_probe[i] = clock64(); } while (0)
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
"""
# marks: 0 entry, 1 after the init barrier, 2 chunk 0's scan starts (its
# loads issued at the entry, landing inside the scan), 2 + 2k (k > 0) chunk
# k's slot landed, 3 + 2k chunk k scanned (its loads from the slot included;
# k < 32), 65 + k the first loader issued chunk k (1 <= k <= 4), 70 the chain's
# end, 71 the first loader's end, 78 and 79 the globaltimer
MARKS = (
    ("#include <cuda_runtime.h>\n", PROBE_DEFS),
    ("  const int chunks = (T + kChunk - 1) / kChunk;\n",
     "  PROBE(0);\n  if (PROBE_ON) g_probe[78] = global_ns();\n"),
    ("    asm volatile(\"fence.mbarrier_init.release.cluster;\" ::: \"memory\");\n  }\n  __syncthreads();\n",
     "  PROBE(1);\n"),
    ("      arrive_on_copies(smem_addr(&full[s]));\n",
     "      if (blockIdx.x == 0 && threadIdx.x == 32 && k <= 4) g_probe[65 + k] = clock64();\n"),
    ("    asm volatile(\"cp.async.wait_all;\" ::: \"memory\");\n",
     "    if (blockIdx.x == 0 && threadIdx.x == 32) g_probe[71] = clock64();\n"),
    ("  float* dst = out + (long)(T - 1) * E + e0 + lane;  // step T - 1 - i at dst - i E\n", "  PROBE(2);\n"),
    ("  scan_chunk<kClosure, true>(r0, d0, q0, lam_ret, next_q, lq, gamma, gamma_lam, dst, E, min(T, kChunk), live);\n",
     "  PROBE(3);\n"),
    ("    bar_wait(smem_addr(&full[s]), phase);\n", "    if (k < 32) PROBE(2 + 2 * k);\n"),
    ("    scan_chunk<kClosure, false>(r, d, q, lam_ret, next_q, lq, gamma, gamma_lam, dst, E, min(hi, kChunk), live);\n",
     "    if (k < 32) PROBE(3 + 2 * k);\n"),
    ("      phase ^= 1;\n    }\n  }\n", "  PROBE(70);\n  if (PROBE_ON) g_probe[79] = global_ns();\n"),
)
READ_FN = """
extern "C" int probe_read(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_probe, 80 * sizeof(long long));
}
"""
# the variant that stores only each chunk's earliest step
STORE_LINE = "    store_if(dst, lam_ret, live & (i < rows));\n"
STORE_AT_END = ("    dst -= E;\n  }\n", "  store_if(dst + (long)(kChunk + 1 - rows) * E, lam_ret, live);\n")


def patched(src: str, marks, extra: str = "") -> str:
    for anchor, mark in marks:
        if src.count(anchor) != 1:
            raise RuntimeError(f"csrc/lambda_returns.cu no longer has one line to mark after: {anchor!r}")
        src = src.replace(anchor, anchor + mark)
    return src + extra


def build_copy(probe_dir: str, name: str, src: str):
    from purejaxql_torch.ops import build

    path = os.path.join(probe_dir, f"{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    lib_path = os.path.join(probe_dir, f"{name}.so")
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", lib_path, path], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(lib_path)
    for symbol in ("lambda_returns_f32", "lambda_returns_closure_f32"):
        fn = getattr(lib, symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float] + [
            ctypes.c_int] * 3 + [ctypes.c_void_p]
    return lib


def caller(lib, form: str, args):
    """A call of `lib`'s entry point for `form` on (last_q, rewards, dones,
    max_qs) under the tree's plan."""
    import torch

    from purejaxql_torch.ops.lambda_returns import lambda_plan

    fn = lib.lambda_returns_f32 if form == "gymnax" else lib.lambda_returns_closure_f32
    T, E = args[1].shape

    def call():
        out = torch.empty_like(args[1])
        err = fn(*(x.data_ptr() for x in args), out.data_ptr(), T, E, 0.99, 0.99 * 0.95, *lambda_plan(T, E).ints,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"the probed kernel's launch failed ({err})")
        return out

    return call


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=None, help="also write the summary JSON here, and the SASS beside it")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("probe_returns: no GPU visible", file=sys.stderr)
        return 1
    from time_device import graph_ms

    from purejaxql_torch.ops import build
    from purejaxql_torch.ops import lambda_returns as lr

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    probe_dir = os.path.join(ROOT, "build", "probe_returns")
    shutil.rmtree(probe_dir, ignore_errors=True)
    os.makedirs(probe_dir)
    src = (build.CSRC_DIR / "lambda_returns.cu").read_text()
    probed = build_copy(probe_dir, "probed", patched(src, MARKS, READ_FN))
    if src.count(STORE_LINE) != 1:
        raise RuntimeError("csrc/lambda_returns.cu no longer has one per-step store")
    end_stores = build_copy(probe_dir, "end_stores", patched(src.replace(STORE_LINE, ""), (STORE_AT_END,)))
    read = probed.probe_read
    read.restype = ctypes.c_int
    read.argtypes = [ctypes.c_void_p]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    summary = {"card": card, "shapes": []}
    for form, T, E in SHAPES:
        x = [torch.randn(E, device=dev, generator=gen), torch.randn(T, E, device=dev, generator=gen),
             (torch.rand(T, E, device=dev, generator=gen) < 0.1).float(), torch.randn(T, E, device=dev, generator=gen)]
        kernel, plain = ((lr.lambda_returns, lr.lambda_returns_plain) if form == "gymnax"
                         else (lr.lambda_returns_closure, lr.lambda_returns_closure_plain))
        call = caller(probed, form, x)
        if not torch.equal(call(), plain(*x, 0.99, 0.95)):
            raise AssertionError(f"the probed kernel differs from the twin at {form} ({T}, {E})")
        for _ in range(5):  # the marks of a warm launch
            call()
        torch.cuda.synchronize()
        marks = (ctypes.c_longlong * 80)()
        if read(marks) != 0:
            raise RuntimeError("probe_read failed")
        plan = lr.lambda_plan(T, E)
        chunks = -(-T // plan.chunk)
        prev, per_chunk = marks[1], []
        for k in range(min(chunks, 32)):
            landed, scanned = marks[2 + 2 * k], marks[3 + 2 * k]
            rows = min(T - k * plan.chunk, plan.chunk)
            per_chunk.append({"wait": landed - prev, "scan": scanned - landed, "steps": rows,
                              "scan_a_step": (scanned - landed) / rows})
            prev = scanned
        cycles, ns = marks[70] - marks[0], marks[79] - marks[78]
        times = {}
        tree = lambda kernel=kernel: kernel(*x, 0.99, 0.95)  # noqa: E731
        ends = caller(end_stores, form, x)
        for name, fn in (("tree", tree), ("probed", call), ("end_stores", ends), ("end_stores", ends),
                         ("probed", call), ("tree", tree)):  # in turns
            times.setdefault(name, []).append(graph_ms(fn, 200))
        row = {
            "form": form, "T": T, "E": E, "plan": plan._asdict(),
            "cycles": {"init": marks[1] - marks[0], "chunks": per_chunk, "chain_end": marks[70] - marks[0],
                       "loader_issued": [marks[65 + k] - marks[0] for k in range(1, min(chunks, 5))],
                       "loader_end": marks[71] - marks[0]},
            "chain_ns": ns, "sm_mhz": 1e3 * cycles / ns if ns else None, "graph_ms": times,
        }
        print(json.dumps(row))
        summary["shapes"].append(row)
    line = json.dumps(summary)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
        cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
        sass = subprocess.run([cuobjdump, "-sass", str(build.library_path("lambda_returns"))], capture_output=True,
                              text=True)
        with open(os.path.splitext(os.path.abspath(args.out))[0] + ".sass", "w") as f:
            f.write(sass.stdout + sass.stderr)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
