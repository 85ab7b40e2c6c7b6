"""The kernel build cache (``ops/_build.py``), the port's counterpart of the
JAX package's persistent XLA compilation cache
(``mythril_tpu/__init__.py`` ``enable_persistent_compilation_cache``).

* The build directory: ``--compile-cache-dir`` (``set_cache_dir``) over the
  ``MYTHRIL_TPU_COMPILATION_CACHE`` variable over ``mythril_tpu_torch/_build``;
  the variable at ``0``/``off``/``no``/``false`` or empty gives the process a
  directory of its own.  ``--cache-root DIR`` derives ``DIR/kernels`` and
  ``DIR/querycache``, and explicit flags win over the derived paths.
* ``compilecache.hits`` and ``compilecache.misses``: a library found in the
  cache is a hit and runs no nvcc; a library that is not there is a miss and
  one build.  The CPU has no nvcc, so a stand-in library file and a
  stand-in nvcc take their places.
"""

from __future__ import annotations

from pathlib import Path

import pytest

from tests._torch_parity import _one_torch_thread  # noqa: F401  (autouse fixture)


@pytest.fixture
def build(monkeypatch):
    """``ops/_build.py`` with its directory state restored after the test
    and the variable unset."""
    from mythril_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "_cache_dir", None)
    monkeypatch.setattr(_build, "_own_dir", None)
    monkeypatch.delenv(_build.ENV_CACHE, raising=False)
    return _build


def _counts() -> tuple:
    from mythril_tpu_torch.ops import _build

    hits, misses = _build.cache_counters()
    return hits.value, misses.value


def test_the_default_is_the_package_build_directory(build):
    assert build.build_dir() == build.BUILD_DIR == Path(build.PKG) / "_build"
    assert build.library_path().parent == build.BUILD_DIR


def test_the_variable_relocates_it(build, tmp_path, monkeypatch):
    monkeypatch.setenv(build.ENV_CACHE, str(tmp_path / "env"))
    assert build.build_dir() == tmp_path / "env"


@pytest.mark.parametrize("value", ["0", "off", "no", "false", "", " OFF "])
def test_the_variable_switched_off_gives_the_process_its_own_directory(build, value,
                                                                       monkeypatch):
    monkeypatch.setenv(build.ENV_CACHE, value)
    own = build.build_dir()
    assert own != build.BUILD_DIR and own.is_dir() and own.name.startswith("mythril-kernels-")
    assert build.build_dir() == own  # one directory for the process


def test_the_flag_wins_over_the_variable(build, tmp_path, monkeypatch):
    import mythril_tpu_torch

    monkeypatch.setenv(build.ENV_CACHE, str(tmp_path / "env"))
    mythril_tpu_torch.enable_persistent_compilation_cache(str(tmp_path / "flag"))
    assert build.build_dir() == tmp_path / "flag"
    mythril_tpu_torch.enable_persistent_compilation_cache(None)
    assert build.build_dir() == tmp_path / "env"


def test_arming_the_cache_creates_its_counters(build):
    import mythril_tpu_torch
    from mythril_tpu_torch.observability import get_registry

    reg = get_registry()
    for name in ("compilecache.hits", "compilecache.misses"):
        reg._metrics.pop(name, None)
    mythril_tpu_torch.enable_persistent_compilation_cache()
    snap = reg.snapshot()
    assert snap["compilecache.hits"] == snap["compilecache.misses"] == 0
    reg.reset()  # the sweep between contracts keeps them
    assert "compilecache.hits" in reg.snapshot()


def test_a_library_in_the_cache_is_a_hit_and_runs_no_nvcc(build, tmp_path, monkeypatch):
    """A copy of the built library in a fresh directory: loaded from there."""
    def no_nvcc():
        raise AssertionError("nvcc ran on a cache hit")

    monkeypatch.setattr(build, "nvcc", no_nvcc)
    build.set_cache_dir(tmp_path / "seeded")
    lib = build.library_path()
    lib.parent.mkdir()
    lib.write_bytes(b"a stand-in library")
    hits, misses = _counts()
    assert build.build() == lib
    assert _counts() == (hits + 1, misses)


def test_a_missing_library_is_a_miss_and_one_build(build, tmp_path, monkeypatch):
    """A stand-in nvcc (it touches its ``-o`` file and logs each run): the
    first build is a miss with one compile per source and one link, the
    second a hit with no run."""
    runs = tmp_path / "runs.log"
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\necho run >> "%s"\n'
                    'while [ $# -gt 1 ]; do [ "$1" = -o ] && touch "$2"; shift; done\n' % runs)
    fake.chmod(0o755)
    src = tmp_path / "k.cu"
    src.write_text("// a kernel\n")
    monkeypatch.setattr(build, "nvcc", lambda: str(fake))
    build.set_cache_dir(tmp_path / "cache")
    hits, misses = _counts()
    lib = build.build([src], name="probe")
    assert lib.parent == tmp_path / "cache" and lib.exists()
    assert _counts() == (hits, misses + 1) and runs.read_text().count("run") == 2
    assert build.build([src], name="probe") == lib
    assert _counts() == (hits + 1, misses + 1) and runs.read_text().count("run") == 2


_BUILDER = r"""
import json, sys, time
from pathlib import Path
sys.path.insert(0, sys.argv[1])
from mythril_tpu_torch.ops import _build
_build.nvcc = lambda: sys.argv[2]
_build.set_cache_dir(sys.argv[3])
go = Path(sys.argv[3]).parent / "go"
print("ready", flush=True)
while not go.exists():
    time.sleep(0.01)
_build.build([Path(sys.argv[4])], name="probe")
hits, misses = _build.cache_counters()
print(json.dumps([hits.value, misses.value]), flush=True)
"""


def test_two_processes_build_a_library_once(tmp_path):
    """Two processes build the same library into one cache at once, with a
    stand-in nvcc that takes a second a run: the lock lets one build (one
    compile and one link, its miss) and the other find the library after
    waiting (its hit)."""
    import subprocess
    import sys

    runs = tmp_path / "runs.log"
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\necho run >> "%s"\nsleep 1\n'
                    'while [ $# -gt 1 ]; do [ "$1" = -o ] && touch "$2"; shift; done\n' % runs)
    fake.chmod(0o755)
    src = tmp_path / "k.cu"
    src.write_text("// a kernel\n")
    repo = Path(__file__).resolve().parent.parent
    procs = [subprocess.Popen(
        [sys.executable, "-c", _BUILDER, str(repo), str(fake), str(tmp_path / "cache"), str(src)],
        stdout=subprocess.PIPE, text=True) for _ in range(2)]
    for proc in procs:
        assert proc.stdout.readline().strip() == "ready"
    (tmp_path / "go").touch()
    counts = sorted(tuple(__import__("json").loads(proc.communicate(timeout=120)[0]))
                    for proc in procs)
    assert [proc.returncode for proc in procs] == [0, 0]
    assert counts == [(0, 1), (1, 0)]
    assert runs.read_text().count("run") == 2


def test_the_cache_root_derives_both_directories(build, tmp_path):
    from mythril_tpu_torch.facade.mythril_analyzer import AnalyzerArgs
    from mythril_tpu_torch.facade.warm import apply_analyzer_args, resolve_cache_root
    from mythril_tpu_torch.querycache import configure
    from mythril_tpu_torch.support.support_args import args

    root = tmp_path / "root"
    assert resolve_cache_root(None) == (None, None)
    assert resolve_cache_root(str(root)) == (str(root / "querycache"), str(root / "kernels"))
    saved = vars(args).copy()
    try:
        apply_analyzer_args(AnalyzerArgs(cache_root=str(root)))
        assert args.query_cache_dir == str(root / "querycache")
        assert build.build_dir() == root / "kernels"
        # explicit per-cache flags win over the derived paths
        apply_analyzer_args(AnalyzerArgs(cache_root=str(root), query_cache_dir=str(tmp_path / "q"),
                                         compile_cache_dir=str(tmp_path / "k")))
        assert args.query_cache_dir == str(tmp_path / "q")
        assert build.build_dir() == tmp_path / "k"
    finally:
        vars(args).update(saved)
        configure(enabled=args.query_cache, cache_dir=args.query_cache_dir)


def test_the_jax_package_has_the_same_switches():
    """The variable's name and its off values are the JAX package's."""
    import inspect

    import mythril_tpu
    from mythril_tpu_torch.ops import _build

    src = inspect.getsource(mythril_tpu.enable_persistent_compilation_cache)
    assert f'"{_build.ENV_CACHE}"' in src
    assert '"", "0", "off", "no", "false"' in src and _build._OFF == ("", "0", "off", "no", "false")
