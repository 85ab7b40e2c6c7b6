"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``), one
process per source, all started together, and linked into one shared
library with a plain C interface that ``ctypes`` loads.  The library goes
to ``mythril_tpu_torch/_build/`` (listed in ``.gitignore``), named by a hash
of the sources and flags: it is built at first use and rebuilt whenever a
source changes.  Nothing here runs at import time.

Pointers and the CUDA stream are passed as ``c_void_p``; each C entry
returns ``cudaGetLastError()`` of its launch and the Python wrapper raises
when it is not zero.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
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


def library_path() -> Path:
    return BUILD_DIR / f"libmythril_kernels_{_digest()}.so"


def build_log() -> str:
    """What nvcc printed when it built the current library (ptxas's register
    and shared-memory report), kept beside it; empty before the build."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build() -> Path:
    """Compile every source in parallel and link; a no-op when up to date."""
    lib = library_path()
    if lib.exists():
        return lib
    compiler = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [compiler, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        logs, failed = [], []
        for src, proc in zip(sources(), procs):
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
            _lib = lib
        return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
