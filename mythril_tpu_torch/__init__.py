"""mythril_tpu_torch: the PyTorch/CUDA port of mythril_tpu.

The port mirrors the JAX package's layout and names module for module, and
imports ``torch`` but never ``jax`` and nothing of ``mythril_tpu``.  Kernels
are CUDA C++ for Hopper (``sm_90a``) under ``csrc/``, built at first use by
``ops/_build.py``; each has a plain PyTorch version beside it that the CPU
tests and ``chip_smoke.py`` hold it against.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``device.py``).
"""
