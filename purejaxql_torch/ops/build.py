"""Build the hand-written CUDA kernels under ``csrc/`` and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``. A library is
built at first use into ``build/purejaxql_torch/`` at the root of the
checkout, under a name keyed by a hash of its source, every shared header
``csrc/*.cuh`` and the flags, so an edited source or header is rebuilt and an
unchanged one is not. ``build`` starts one
``nvcc`` per source, all together, and waits for them.

Nothing here runs at import: the CPU tests import every module, and this
host has neither ``nvcc`` nor a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "purejaxql_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile the named sources that are not built yet, one ``nvcc`` each,
    in parallel. Returns seconds per source compiled; the compiler's output
    (register and spill counts from ``-Xptxas -v``) is kept beside each
    library as ``.log``. Raises with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [
            nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp),
            str(CSRC_DIR / f"{name}.cu"),
        ]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs[name] = (proc, tmp, out, time.perf_counter())
    seconds = {}
    for name, (proc, tmp, out, t0) in jobs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
        os.replace(tmp, out)
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def check_launch(lib: ctypes.CDLL, err: int, name: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")
        msg.restype = ctypes.c_char_p
        msg.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{name} kernel launch failed: {msg(err).decode()} ({err})")
