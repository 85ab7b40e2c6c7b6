"""Helpers shared by the tests that hold mythril_tpu_torch against mythril_tpu.

The two packages have separate term interners, so terms cross between them
the way the port's ``serialize.from_jax_dump`` documents: dump on the JAX
side, rebuild on the port side.  Candidate assignments are rebuilt the same
way.  ``jax_same_tiers`` configures the JAX solver to run exactly the tiers
the port carries (tape-VM probe forced on, no query cache, no pre-filter, no
device bit-blast tier, no native CDCL).
"""

from __future__ import annotations

import contextlib
from typing import List, Sequence


def to_port(jax_terms: Sequence) -> List:
    from mythril_tpu.smt.serialize import dump_terms
    from mythril_tpu_torch.smt.serialize import from_jax_dump

    return from_jax_dump(dump_terms(list(jax_terms)))


def to_port_assignment(asg, jax_to_port: dict):
    """A JAX ``Assignment`` over the port's terms (``jax_to_port``: term map)."""
    from mythril_tpu_torch.smt.concrete_eval import ArrayValue, Assignment

    out = Assignment()
    for v, val in asg.scalars.items():
        out.scalars[jax_to_port[v]] = val
    for av, arr in asg.arrays.items():
        out.arrays[jax_to_port[av]] = ArrayValue(
            arr.backing, arr.default, arr.salt, arr.range_bits
        )
    return out


@contextlib.contextmanager
def jax_same_tiers():
    """The JAX solver restricted to the port's tiers, caches cleared."""
    from mythril_tpu.native import bitblast
    from mythril_tpu.querycache import configure, get_query_cache
    from mythril_tpu.smt.solver import clear_model_cache
    from mythril_tpu.support.support_args import args

    saved = (args.probe_backend, args.prefilter, args.devsolver, args.query_cache)
    saved_qc = get_query_cache().enabled
    saved_available = bitblast.available
    args.probe_backend, args.prefilter, args.devsolver, args.query_cache = (
        "jax", False, False, False,
    )
    configure(enabled=False)
    bitblast.available = lambda: False
    clear_model_cache()
    try:
        yield
    finally:
        (args.probe_backend, args.prefilter, args.devsolver, args.query_cache) = saved
        configure(enabled=saved_qc)
        bitblast.available = saved_available
        clear_model_cache()


@contextlib.contextmanager
def port_device_backend():
    """The port's solver with the device probe on and its caches cleared."""
    from mythril_tpu_torch.smt.solver import clear_model_cache
    from mythril_tpu_torch.support.support_args import args

    saved = args.probe_backend
    args.probe_backend = "device"
    clear_model_cache()
    try:
        yield
    finally:
        args.probe_backend = saved
        clear_model_cache()
