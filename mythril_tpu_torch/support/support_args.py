"""Global analysis flags the port's solver slice reads.

The subset of ``mythril_tpu/support/support_args.py``'s ``Args`` that the
probe solver consults.  ``probe_backend``: ``"device"`` evaluates candidate
batches with the tape VM (the CUDA kernel on the card, its plain PyTorch
version on the CPU) and plays the role of the JAX package's forced
``"jax"`` backend; ``"host"`` never dispatches and evaluates candidates with
the exact host evaluator only.
"""

from __future__ import annotations

from dataclasses import dataclass

PROBE_BACKENDS = ("device", "host")


@dataclass
class Args:
    solver_timeout: int = 10000  # ms, per query
    probe_candidates: int = 48
    probe_rounds: int = 4
    probe_backend: str = "device"  # device | host


args = Args()
