"""Taint bits over the arena row graph: device-evaluated detector sources.

Host taint is annotation objects on smt wrappers, installed by detector
post-hooks on taint-source opcodes (reference
mythril/analysis/module/modules/dependence_on_origin.py:60-66: ORIGIN's
result is annotated, a JUMPI whose condition carries the annotation raises
the issue).  On the device frontier, every value is an arena row and every
row records the rows it was computed from — the ref graph IS an exact
dataflow (taint) relation, computed for free by the segment.  So a
taint-source hook needs NO device event and NO host replay: the engine
seeds the source's env row with a taint bit (`HostArena.add_taint`), and
the walker, when decoding any row at a sink (a JUMPI condition, a CALL
argument), unions in the annotations synthesized from the taint bits
reachable in the row's dependency closure — the same reachability the
host's operator-level annotation unions compute.

A detection module opts in by declaring ``taint_source_hooks`` (see
analysis/module/base.py): a mapping from hooked opcode to the taint bit
that reproduces its post-hook's only effect.  When EVERY hook on an opcode
is so declared, the engine drops the opcode from the evented set entirely
(frontier/engine._hook_info) — unlike ``concrete_nop_hooks``, which still
events on symbolic operands, a taint-source opcode never ships an event.

The registry below maps bits to annotation factories (used by the walker
to synthesize instances) and matchers (used by the mid-frame encoder to
map a host wrapper's annotations back to bits when a host-stepped state
re-enters the device).  Modules register at import; unregistered bits
synthesize nothing, so seeding is harmless when a module is disabled.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

TAINT_ORIGIN = 1 << 0
TAINT_TIMESTAMP = 1 << 1
TAINT_NUMBER = 1 << 2
TAINT_COINBASE = 1 << 3
TAINT_GASLIMIT = 1 << 4
TAINT_BLOCKHASH = 1 << 5

from mythril_tpu_torch.frontier.code import (
    CTX_COINBASE, CTX_GASLIMIT, CTX_NUMBER, CTX_ORIGIN, CTX_TIMESTAMP,
)

# THE table tying each seedable bit to the env ctx slot whose row carries
# it: engine._seed_ctx iterates this to seed, and ``suppressible`` guards
# event suppression with it — one source of truth, so a bit cannot be
# declared suppressible without also being seeded.  The row at each slot
# must be DEDICATED (arena.fresh_var_row), never interned — see
# _seed_ctx's no_fold/aliasing comments.  BLOCKHASH is deliberately
# absent: it parks on device, so its host hooks always run.
ENV_SOURCE_SLOTS = {
    TAINT_ORIGIN: CTX_ORIGIN,
    TAINT_TIMESTAMP: CTX_TIMESTAMP,
    TAINT_NUMBER: CTX_NUMBER,
    TAINT_COINBASE: CTX_COINBASE,
    TAINT_GASLIMIT: CTX_GASLIMIT,
}
SEEDED_BITS = frozenset(ENV_SOURCE_SLOTS)

# bit -> the opcode whose result carries it.  The static pre-analysis
# (mythril_tpu_torch/staticpass) keys its may_reach relation on this table:
# a bit's flow starts at every reachable instruction of its source
# opcode.  BLOCKHASH appears here even though it is not device-seeded
# (it parks): static reachability covers host-installed annotations too.
SOURCE_OPCODES = {
    TAINT_ORIGIN: "ORIGIN",
    TAINT_TIMESTAMP: "TIMESTAMP",
    TAINT_NUMBER: "NUMBER",
    TAINT_COINBASE: "COINBASE",
    TAINT_GASLIMIT: "GASLIMIT",
    TAINT_BLOCKHASH: "BLOCKHASH",
}


def suppressible(bit: int) -> bool:
    """True when dropping a source hook's device events is safe: the engine
    seeds the bit (ENV_SOURCE_SLOTS) and a registered factory can
    synthesize the annotation."""
    return bit in SEEDED_BITS and bit in _factories

# bit -> () -> annotation instance (singletons: annotations are inspected
# by isinstance / attribute only, never mutated per-site)
_factories: Dict[int, Callable[[], object]] = {}
_singletons: Dict[int, object] = {}
# (bit, annotation -> bool): reverse mapping for host->device re-entry
_matchers: List[Tuple[int, Callable[[object], bool]]] = []


def register(bit: int, factory: Callable[[], object],
             matcher: Callable[[object], bool]) -> None:
    """Bind a taint bit to its annotation class.

    Idempotent for the SAME factory object (module re-imports).  A
    different factory on an already-bound bit raises: two detectors
    sharing one bit would synthesize the wrong annotation class at every
    sink, and the static pass keys its reachability on these bits — the
    invariant must be enforced, not assumed.
    """
    if bit <= 0 or (bit & (bit - 1)):
        raise ValueError(f"taint bit must be a single set bit, got {bit:#x}")
    if bit in _factories:
        if _factories[bit] is factory:
            return
        raise ValueError(
            f"taint bit {bit:#x} already registered with a different factory"
        )
    _factories[bit] = factory
    _matchers.append((bit, matcher))


def annotations_for_mask(mask: int) -> Tuple[object, ...]:
    """Synthesized annotation instances for a row taint mask, in ascending
    bit order (deterministic: the first predictable-op annotation names the
    operation in the issue text, so the order must not depend on dict or
    scheduling state)."""
    if not mask:
        return ()
    out = []
    for bit in sorted(_factories):
        if mask & bit:
            inst = _singletons.get(bit)
            if inst is None:
                inst = _singletons[bit] = _factories[bit]()
            out.append(inst)
    return tuple(out)


def mask_for_annotations(annotations) -> int:
    """Taint bits equivalent to a host wrapper's annotations (mid-frame
    device re-entry: a host-installed annotation must survive as a bit on
    the encoded row or the sink check would miss it)."""
    mask = 0
    for a in annotations:
        for bit, match in _matchers:
            if match(a):
                mask |= bit
                break
    return mask
