"""Native (C++) runtime components of the port.

The JAX package's in-tree C++ (``mythril_tpu/native/``), kept as the port's
own copies: the bit-blasting CDCL solver (the solver's exact tier 2, the
Optimize session and the transaction-end issue gate) and the batched
keccak the host path hashes with.  g++ builds them into one library under
``mythril_tpu_torch/_build/`` at first use (``build.py``); every entry point
reports itself unavailable when no compiler is present.
"""
