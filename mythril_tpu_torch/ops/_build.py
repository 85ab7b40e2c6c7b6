"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``), one
process per source, all started together, and linked into one shared
library with a plain C interface that ``ctypes`` loads.  The library is
named by a hash of the sources and flags: it is built at first use and
rebuilt whenever a source changes.  Nothing here runs at import time.
``build`` also takes other sources (a measurement script's kernel) into a
library of their own.

The build directory is the kernel build cache, the port's counterpart of
the JAX package's persistent XLA compilation cache: a library found there
is loaded without a build.  ``build_dir()`` is, in this order, the
directory ``set_cache_dir`` was given (``--compile-cache-dir``, or
``DIR/kernels`` under ``--cache-root``), the ``MYTHRIL_TPU_COMPILATION_CACHE``
variable (``0``/``off``/``no``/``false`` or empty: a directory of the
process's own, removed at exit, so every process builds), and
``mythril_tpu_torch/_build/`` (``BUILD_DIR``, listed in ``.gitignore``).
Every ``build`` counts ``compilecache.hits`` (the library was there) or
``compilecache.misses`` (nvcc ran) in the metrics registry.  It holds an
exclusive ``fcntl.flock`` on ``<library>.lock`` around its check and the
build, so processes that share a cache (the analysis service's pool
workers) build a library once: the one that builds counts the miss, one
that finds the library after waiting counts a hit.

Pointers and the CUDA stream are passed as ``c_void_p``; each C entry
returns ``cudaGetLastError()`` of its launch and the Python wrapper raises
when it is not zero.

Once the device plane is installed (``observability/deviceplane.py``),
``build`` reports to it: a library found on disk is a cache hit, one that
must be built a miss and a compile event with its wall, tagged with the
calling thread's dispatch scope.
"""

from __future__ import annotations

import atexit
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import List, Optional

from mythril_tpu_torch.device import DeviceError

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

ENV_CACHE = "MYTHRIL_TPU_COMPILATION_CACHE"
_OFF = ("", "0", "off", "no", "false")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_cache_dir: Optional[Path] = None  # set_cache_dir's directory
_own_dir: Optional[Path] = None  # the cache switched off: this process's own
_own_lock = threading.Lock()


class KernelBuildError(DeviceError):
    """nvcc is missing or refused a source."""


class KernelLaunchError(DeviceError):
    """A kernel's C entry reported a CUDA error, or the card cannot hold the
    launch shape."""


def cache_counters():
    """The ``compilecache.hits`` and ``compilecache.misses`` counters,
    created at 0 (persistent: the sweep between contracts keeps them, as
    the JAX package's)."""
    from mythril_tpu_torch.observability.metrics import get_registry

    reg = get_registry()
    return (reg.counter("compilecache.hits", persistent=True),
            reg.counter("compilecache.misses", persistent=True))


def set_cache_dir(cache_dir) -> None:
    """Build into and load from ``cache_dir`` (None: the variable, else the
    default); the library already loaded in this process stays loaded."""
    global _cache_dir
    _cache_dir = None if cache_dir is None else Path(cache_dir).expanduser().resolve()


def build_dir() -> Path:
    """The kernel build cache's directory (see the module docstring)."""
    global _own_dir
    if _cache_dir is not None:
        return _cache_dir
    env = os.environ.get(ENV_CACHE)
    if env is None:
        return BUILD_DIR
    if env.strip().lower() not in _OFF:
        return Path(env).expanduser().resolve()
    with _own_lock:
        if _own_dir is None:
            _own_dir = Path(tempfile.mkdtemp(prefix="mythril-kernels-"))
            atexit.register(shutil.rmtree, str(_own_dir), True)
    return _own_dir


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(srcs: List[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(srcs) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(srcs: Optional[List[Path]] = None, name: str = "mythril_kernels") -> Path:
    srcs = sources() if srcs is None else srcs
    return build_dir() / f"lib{name}_{_digest(srcs)}.so"


def build_log() -> str:
    """What nvcc printed when it built the current library (ptxas's register
    and shared-memory report), kept beside it; empty before the build."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(srcs: Optional[List[Path]] = None, name: str = "mythril_kernels") -> Path:
    """Compile every source (default: the package's) in parallel and link;
    a no-op when up to date.  One process at a time builds a library."""
    srcs = sources() if srcs is None else srcs
    lib = library_path(srcs, name)
    lib.parent.mkdir(parents=True, exist_ok=True)
    with open(lib.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        return _build_locked(srcs, lib)


def _build_locked(srcs: List[Path], lib: Path) -> Path:
    from mythril_tpu_torch.observability import deviceplane

    found = lib.exists()
    plane = deviceplane.installed()
    if plane:
        deviceplane.on_cache(found)
    hits, misses = cache_counters()
    (hits if found else misses).inc()
    if found:
        return lib
    t0 = time.perf_counter()
    compiler = nvcc()
    with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
        objs, procs = [], []
        for src in srcs:
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [compiler, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        logs, failed = [], []
        for src, proc in zip(srcs, procs):
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise KernelBuildError(
                f"nvcc failed on {', '.join(failed)}:\n" + "\n".join(logs)
            )
        tmp_lib = Path(tmp) / lib.name
        link = subprocess.run(
            [compiler, *ARCH_FLAGS, "-shared", *map(str, objs), "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise KernelBuildError(f"link failed:\n{link.stdout}")
        lib.with_suffix(".log").write_text("\n".join(logs))
        os.replace(tmp_lib, lib)
    if plane:
        deviceplane.on_compile(time.perf_counter() - t0)
    return lib


class TapeArgs(ctypes.Structure):
    """Mirror of ``mk::TapeArgs`` in ``csrc/tape_vm.cuh`` (same field order)."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "rec", "root_order", "pre", "leaves", "tables", "leaf_vals", "tab_idx", "tab_val",
        "tab_valid", "tab_default", "kstate", "spill", "live_in", "live_out", "truth", "regs",
    )] + [(name, ctypes.c_int) for name in (
        "V", "T", "A", "K", "R", "B", "S", "n_leaf", "n_table", "zero_slot", "n_pre",
        "t_begin", "t_end", "squeeze_step", "absorb_step", "n_live_in", "n_live_out",
    )]


def load() -> ctypes.CDLL:
    """The kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for fn in (lib.mk_keccak_f1600, lib.mk_keccak_f1600_warp):
                fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
                fn.restype = ctypes.c_int
            lib.mk_tape_vm_segment.argtypes = [ctypes.POINTER(TapeArgs), ctypes.c_void_p]
            lib.mk_tape_vm_segment.restype = ctypes.c_int
            lib.mk_tape_vm_shape.argtypes = [
                ctypes.POINTER(TapeArgs), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_longlong),
            ]
            lib.mk_tape_vm_shape.restype = None
            from mythril_tpu_torch.frontier.step import FrontierArgs

            lib.mk_frontier_segment.argtypes = [ctypes.POINTER(FrontierArgs), ctypes.c_void_p]
            lib.mk_frontier_segment.restype = ctypes.c_int
            lib.mk_frontier_segment_shape.argtypes = [ctypes.POINTER(FrontierArgs)] + [
                ctypes.POINTER(ctypes.c_int)] * 4
            lib.mk_frontier_segment_shape.restype = ctypes.c_int
            lib.mk_frontier_max_paths.argtypes = [ctypes.POINTER(ctypes.c_int)]
            lib.mk_frontier_max_paths.restype = ctypes.c_int
            from mythril_tpu_torch.frontier.step import ShardArgs

            lib.mk_frontier_segment_shards.argtypes = [ctypes.POINTER(ShardArgs), ctypes.c_void_p]
            lib.mk_frontier_segment_shards.restype = ctypes.c_int
            lib.mk_frontier_shard_max_paths.argtypes = [ctypes.POINTER(ctypes.c_int)]
            lib.mk_frontier_shard_max_paths.restype = ctypes.c_int
            lib.mk_frontier_enable_peers.argtypes = [
                ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int)]
            lib.mk_frontier_enable_peers.restype = ctypes.c_int
            from mythril_tpu_torch.absdomain.device import KbArgs
            from mythril_tpu_torch.devsolver.device import DpllArgs

            lib.mk_known_bits.argtypes = [ctypes.POINTER(KbArgs), ctypes.c_void_p]
            lib.mk_known_bits.restype = ctypes.c_int
            lib.mk_dpll.argtypes = [ctypes.POINTER(DpllArgs), ctypes.c_void_p]
            lib.mk_dpll.restype = ctypes.c_int
            from mythril_tpu_torch.ops.lowering import LowerArgs

            lib.mk_lowering.argtypes = [ctypes.POINTER(LowerArgs), ctypes.c_void_p]
            lib.mk_lowering.restype = ctypes.c_int
            lib.mk_dpll_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
            lib.mk_dpll_smem_bytes.restype = ctypes.c_longlong
            _lib = lib
        return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if rc != 0:
        raise KernelLaunchError(f"{what}: CUDA error {rc} at launch")
