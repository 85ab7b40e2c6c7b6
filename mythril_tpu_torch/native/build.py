"""Lazy in-tree build of the native library (g++ -O2 -shared -fPIC).

The boundary is a C ABI loaded with ctypes.  The library goes to
``mythril_tpu_torch/_build/`` (listed in ``.gitignore``), never beside the
sources, and is rebuilt whenever a source file is newer; concurrent builds
are serialized with an exclusive lock so parallel pytest workers don't race
the compiler.  Only the sources under ``native/src/`` are compiled.
"""

from __future__ import annotations

import fcntl
import logging
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

log = logging.getLogger(__name__)

_SRC_DIR = Path(__file__).parent / "src"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_LIB_PATH = _BUILD_DIR / "libmythril_native.so"
_SOURCES = ["bitblast.cpp", "keccak.cpp"]


def _fresh(sources) -> bool:
    return _LIB_PATH.exists() and all(
        _LIB_PATH.stat().st_mtime >= s.stat().st_mtime for s in sources
    )


def library_path() -> Optional[Path]:
    """Path to the built library, building it if needed; None if impossible."""
    sources = [_SRC_DIR / s for s in _SOURCES if (_SRC_DIR / s).exists()]
    if not sources:
        return None
    if _fresh(sources):
        return _LIB_PATH
    gxx = shutil.which("g++") or shutil.which("c++")
    if gxx is None:
        log.debug("no C++ compiler on PATH; native tier disabled")
        return None
    try:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(_LIB_PATH.with_suffix(".lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if _fresh(sources):
                return _LIB_PATH
            tmp = _LIB_PATH.with_suffix(".so.tmp")
            cmd = [gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o", str(tmp),
                   *[str(s) for s in sources]]
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                log.warning("native build failed:\n%s", proc.stderr[-2000:])
                return None
            os.replace(tmp, _LIB_PATH)
            return _LIB_PATH
    except Exception as e:  # hung compiler, lock failure, ... — callers
        # treat library_path()/available() as non-throwing
        log.debug("native build unavailable: %s", e)
        return None
