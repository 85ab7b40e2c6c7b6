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
