"""Host env pool: the ctypes bridge to the port's C++ batched env service.

Port of purejaxql_tpu/envs/hostpool.py. The C++ sources are this package's
own copies (``cpp/envhost/envhost.cc``, ``cpp/plugins/{pong,breakout}/``),
with the JAX package's C ABI (``eh_make``, ``eh_step``, ``eh_load_plugin``,
``EhPluginVTable``): a plug-in built for one pool loads into the other
(docs/ENVHOST_PLUGIN.md). Each env has its own ``std::mt19937_64`` stream,
so the same seed and the same actions give the same observations bit for
bit, whatever the thread count.

Building: ``g++``, called from here as ``ops/build.py`` calls ``nvcc`` (no
``make``), with the flags of the JAX package's Makefiles, into
``build/purejaxql_torch/envhost/`` at the root of the checkout, under a
name keyed by a hash of the source, the flags, the compiler's version and
the host CPU (``-march=native``); all at first use, under a ``flock``, as
several test workers build at once. A failed build or ``dlopen`` raises:
nothing falls back to another library.

The trainer (algo/pqn_host.py) calls ``step_into`` with its own (pinned)
buffers; JAX's ``make_callback_env`` (its io_callback bridge) has no
counterpart here.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

CPP_DIR = Path(__file__).resolve().parents[1] / "cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "purejaxql_torch" / "envhost"
# purejaxql_tpu/cpp/Makefile's and cpp/plugins/*/Makefile's flags: the
# same flags give the same bits as the JAX package's build
ENVHOST_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")
PLUGIN_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared", "-Wall")
# library: (source under cpp/, flags); the bundled plug-ins, each a pixel
# (84x84x4) and a RAM-style build of one source
LIBRARIES = {
    "envhost": ("envhost/envhost.cc", ENVHOST_FLAGS),
    "ehpong": ("plugins/pong/pong.cc", PLUGIN_FLAGS),
    "ehpong_ram": ("plugins/pong/pong.cc", PLUGIN_FLAGS + ("-DEH_PONG_RAM",)),
    "ehbreakout": ("plugins/breakout/breakout.cc", PLUGIN_FLAGS),
    "ehbreakout_ram": ("plugins/breakout/breakout.cc", PLUGIN_FLAGS + ("-DEH_BREAKOUT_RAM",)),
}
PLUGINS = ("ehpong", "ehpong_ram", "ehbreakout", "ehbreakout_ram")
# eh_load_plugin's return codes (envhost.cc), as the JAX package words them
PLUGIN_ERRORS = {
    -1: "dlopen failed",
    -2: "missing eh_plugin_get symbol",
    -3: "plugin init returned nonzero",
    -4: "invalid vtable (name/callbacks/shape)",
}


def compiler() -> str:
    """The C++ compiler: $CXX, else g++ on the PATH."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler: the host env pool builds with g++ (or $CXX)")
    return cxx


@functools.lru_cache(maxsize=None)
def _toolchain_key() -> bytes:
    """The compiler's version and the host CPU's model and flags: a library
    built with -march=native on one machine is not loaded on another."""
    version = subprocess.run([compiler(), "--version"], capture_output=True, text=True, check=True).stdout
    cpu = ""
    try:
        with open("/proc/cpuinfo") as f:
            cpu = "".join(line for line in f if line.startswith(("model name", "flags")))
    except OSError:
        pass
    return (version + cpu).encode()


def library_path(name: str) -> Path:
    source, flags = LIBRARIES[name]
    h = hashlib.sha256((CPP_DIR / source).read_bytes())
    h.update(" ".join(flags).encode() + b"\0" + _toolchain_key())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=tuple(LIBRARIES)) -> Dict[str, float]:
    """Compile the named libraries that are not built yet, one ``g++``
    each, all started together, under a lock on the build directory.
    Returns seconds per library compiled. Raises with the compiler's output
    on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        jobs = {}
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            source, flags = LIBRARIES[name]
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [compiler(), *flags, "-o", str(tmp), str(CPP_DIR / source), "-ldl"]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs[name] = (proc, tmp, out, time.perf_counter())
        seconds = {}
        for name, (proc, tmp, out, t0) in jobs.items():
            log, _ = proc.communicate()
            seconds[name] = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed for cpp/{LIBRARIES[name][0]}:\n{log}")
            os.replace(tmp, out)
    return seconds


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The port's envhost library, built if needed, its C ABI typed."""
    build(["envhost"])
    lib = ctypes.CDLL(str(library_path("envhost")))
    lib.eh_make.restype = ctypes.c_void_p
    lib.eh_make.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint64]
    lib.eh_close.restype = None
    lib.eh_close.argtypes = [ctypes.c_void_p]
    for fn in (lib.eh_obs_dim, lib.eh_num_actions, lib.eh_num_envs, lib.eh_obs_rank):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p]
    lib.eh_obs_shape.restype = None
    lib.eh_obs_shape.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)]
    lib.eh_reset.restype = None
    lib.eh_reset.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
    lib.eh_step.restype = None
    lib.eh_step.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.eh_load_plugin.restype = ctypes.c_int
    lib.eh_load_plugin.argtypes = [ctypes.c_char_p]
    return lib


def load_plugin(so_path) -> None:
    """Register an external game plug-in (a .so exposing ``eh_plugin_get``,
    docs/ENVHOST_PLUGIN.md) with the port's pool; afterwards
    ``HostEnvPool(name)`` resolves the plug-in's self-declared env name.
    Raises ``ValueError`` with the JAX package's reason on failure."""
    rc = load_library().eh_load_plugin(os.fspath(so_path).encode())
    if rc != 0:
        reason = PLUGIN_ERRORS.get(rc, f"error {rc}")
        raise ValueError(f"failed to load plugin {os.fspath(so_path)!r}: {reason}")


@functools.lru_cache(maxsize=None)
def ensure_bundled_plugins() -> None:
    """Build and register the bundled plug-in games (``cpp/plugins/``):
    Pong-EH / PongRam-EH and Breakout-EH / BreakoutRam-EH, each a pixel
    (84x84x4) and a RAM-style build. Once a process."""
    build(PLUGINS)
    for name in PLUGINS:
        load_plugin(library_path(name))


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class HostEnvPool:
    """Batched C++ env pool with auto-reset, gymnax-flavoured numpy API."""

    def __init__(self, env_name: str = "CartPole-v1", num_envs: int = 64, num_threads: Optional[int] = None,
                 seed: int = 0):
        lib = load_library()
        if env_name.endswith("-EH"):
            ensure_bundled_plugins()
        num_threads = num_threads or min(num_envs, os.cpu_count() or 1)
        self._lib = lib
        self._handle = lib.eh_make(env_name.encode(), num_envs, num_threads, seed)
        if not self._handle:
            raise ValueError(f"envhost has no native env named '{env_name}'")
        self.num_envs = num_envs
        self.obs_dim = lib.eh_obs_dim(self._handle)
        self.num_actions = lib.eh_num_actions(self._handle)
        dims = (ctypes.c_int32 * lib.eh_obs_rank(self._handle))()
        lib.eh_obs_shape(self._handle, dims)
        # the logical (unflattened) obs shape, e.g. (10, 10, 4) for grid games
        self.obs_shape = tuple(int(d) for d in dims)

    def _check(self, name: str, a: np.ndarray, dtype, shape, out: bool = True) -> None:
        if a.dtype != dtype or a.shape != shape or not a.flags.c_contiguous or (out and not a.flags.writeable):
            raise ValueError(f"HostEnvPool: {name} must be a C-contiguous {np.dtype(dtype)} array of shape {shape}"
                             f"{' that can be written' if out else ''}, got {a.dtype} {a.shape}")

    def reset_into(self, obs: np.ndarray) -> None:
        """Reset every env, writing the (num_envs, obs_dim) float32 obs into ``obs``."""
        self._check("obs", obs, np.float32, (self.num_envs, self.obs_dim))
        self._lib.eh_reset(self._handle, _ptr(obs, ctypes.c_float))

    def step_into(self, actions: np.ndarray, obs: np.ndarray, rewards: np.ndarray, dones: np.ndarray) -> None:
        """Step every env with ``actions`` ((num_envs,) int32), writing the
        next obs (after an auto-reset where an episode ended), the rewards
        and the 0/1 uint8 dones into the caller's buffers. ctypes releases
        the GIL for the call."""
        self._check("actions", actions, np.int32, (self.num_envs,), out=False)
        self._check("obs", obs, np.float32, (self.num_envs, self.obs_dim))
        self._check("rewards", rewards, np.float32, (self.num_envs,))
        self._check("dones", dones, np.uint8, (self.num_envs,))
        self._lib.eh_step(self._handle, _ptr(actions, ctypes.c_int32), _ptr(obs, ctypes.c_float),
                          _ptr(rewards, ctypes.c_float), _ptr(dones, ctypes.c_uint8))

    def reset(self) -> np.ndarray:
        obs = np.empty((self.num_envs, self.obs_dim), np.float32)
        self.reset_into(obs)
        return obs

    def step(self, actions: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        obs = np.empty((self.num_envs, self.obs_dim), np.float32)
        rewards = np.empty((self.num_envs,), np.float32)
        dones = np.empty((self.num_envs,), np.uint8)
        self.step_into(np.ascontiguousarray(actions, np.int32), obs, rewards, dones)
        return obs, rewards, dones.astype(bool)

    def close(self) -> None:
        if self._handle:
            self._lib.eh_close(self._handle)
            self._handle = None

    def __del__(self):
        if getattr(self, "_handle", None):
            self.close()
