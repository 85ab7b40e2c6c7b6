"""mythril_tpu_torch: the PyTorch/CUDA port of mythril_tpu.

The port mirrors the JAX package's layout and names module for module, and
imports ``torch`` but never ``jax`` and nothing of ``mythril_tpu``.  Kernels
are CUDA C++ for Hopper (``sm_90a``) under ``csrc/``, built at first use by
``ops/_build.py``; each has a plain PyTorch version beside it that the CPU
tests and ``chip_smoke.py`` hold it against.  The solver's exact tier, the
native CDCL bit-blaster (``native/``), is the JAX package's host C++, which
g++ builds into ``_build/`` at first use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``device.py``).
"""

__version__ = "0.1.0"


def enable_persistent_compilation_cache(cache_dir=None) -> None:
    """The port's counterpart of the JAX package's persistent XLA
    compilation cache: the kernel library is built into, and loaded from,
    the kernel build cache (``ops/_build.py``).  ``cache_dir`` (the
    ``--compile-cache-dir`` flag) wins over the ``MYTHRIL_TPU_COMPILATION_CACHE``
    variable, which wins over ``mythril_tpu_torch/_build/``; the variable
    at ``0``/``off``/``no``/``false`` gives each process a build directory
    of its own, so every process builds.  Creates the ``compilecache.hits``
    and ``compilecache.misses`` counters that each build counts into."""
    from mythril_tpu_torch.ops import _build

    _build.set_cache_dir(cache_dir)
    _build.cache_counters()
