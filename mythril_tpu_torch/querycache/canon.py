"""Renaming-invariant canonicalization of constraint sets.

Extends the node encoding of :mod:`mythril_tpu_torch.smt.serialize` with a
variable-anonymized form so that two queries differing only in the NAMES of
their free symbols hash identically.  The engine re-derives the same
structural constraints under fresh symbol names on every run (``caller_2``,
``calldata_KillBilly_3`` ... carry per-run instance counters), so a plain
content hash of the serialized DAG would never hit across runs.

The canonical form of a conjunct set:

1.  Per conjunct, serialize the DAG in deterministic traversal order with
    ``var``/``array_var`` aux (the name) blanked but sorts kept — the
    *shape*.  The variable leaves encountered during that traversal are
    recorded in order (the *occurrence list*).
2.  Sort the conjuncts by shape digest (stable, so same-shape conjuncts
    keep their input order).
3.  Scan the sorted occurrence lists and assign each distinct variable a
    canonical index at first occurrence.  The query encoding is the sorted
    list of ``(shape, occurrence-index-pattern)`` pairs; its sha256 is the
    query hash.

The encoding is a complete invariant: the term set is reconstructible from
it up to variable names, so hash equality implies alpha-equivalence and a
cached UNSAT verdict transfers soundly.  SAT models are stored keyed by
canonical index and re-validated against the new query before being served,
so exactness never rests on the hash alone.

Per-conjunct *named* digests (shape + the actual variable names) are also
produced: the unsat-core subsumption tier must key cores by those, because
a core's meaning depends on WHICH variables its conjuncts share — renaming
each conjunct independently would conflate ``{x>5, x<3}`` (unsat) with
``{x>5, y<3}`` (sat).
"""

from __future__ import annotations

import hashlib
import json
from typing import Dict, List, Optional, Sequence, Tuple

from mythril_tpu_torch.smt import terms
from mythril_tpu_torch.smt.concrete_eval import ArrayValue, Assignment
from mythril_tpu_torch.smt.serialize import _encode_aux, _encode_sort
from mythril_tpu_torch.smt.terms import Term

# per-conjunct fingerprints keyed by interned term id.  Bounded; cleared via
# clear_memos() whenever the solver's term-referencing caches are cleared,
# so a hypothetical intern-table reset can never serve a stale tid mapping.
_FP_MEMO: Dict[int, Tuple[str, Tuple[Term, ...], str]] = {}
_FP_MEMO_CAP = 65536


def digest(blob: str) -> str:
    return hashlib.sha256(blob.encode()).hexdigest()


def clear_memos() -> None:
    _FP_MEMO.clear()


def conjunct_fingerprint(t: Term) -> Tuple[str, Tuple[Term, ...], str]:
    """``(shape, occurrences, named)`` for one conjunct.

    ``shape``: digest of the DAG with variable names anonymized.
    ``occurrences``: the variable leaves in serialization order (shared
    leaves appear once, at their first-visit position — the DAG dedup is
    part of the shape, so ``x+x`` and ``x+y`` differ structurally).
    ``named``: digest additionally committing to the actual names, the key
    the core-subsumption tier matches on.
    """
    hit = _FP_MEMO.get(t.tid)
    if hit is not None:
        return hit
    order = terms.topo_order([t])
    index = {n.tid: i for i, n in enumerate(order)}
    nodes = []
    occurrences: List[Term] = []
    for n in order:
        if n.op in ("var", "array_var"):
            occurrences.append(n)
            aux = None  # identity is restored by the query-level numbering
        else:
            aux = _encode_aux(n.aux)
        nodes.append(
            [n.op, _encode_sort(n.sort), aux, [index[a.tid] for a in n.args]]
        )
    shape = digest(json.dumps(nodes, separators=(",", ":")))
    named = digest(shape + "|" + json.dumps([v.aux for v in occurrences]))
    if len(_FP_MEMO) >= _FP_MEMO_CAP:
        _FP_MEMO.clear()
    out = (shape, tuple(occurrences), named)
    _FP_MEMO[t.tid] = out
    return out


class QueryFingerprint:
    """Canonical identity of one conjunct set.

    ``qhash``: renaming-invariant content hash of the whole set.
    ``var_order``: THIS query's variable terms by canonical index — the
    mapping a cached model's canonical-index values are rebuilt through.
    ``conj_hashes``: the name-preserving per-conjunct digests, the set the
    core-subsumption tier tests cached cores against.
    """

    __slots__ = ("qhash", "var_order", "conj_hashes")

    def __init__(self, qhash: str, var_order: Tuple[Term, ...],
                 conj_hashes: frozenset):
        self.qhash = qhash
        self.var_order = var_order
        self.conj_hashes = conj_hashes


def fingerprint(conjuncts: Sequence[Term]) -> QueryFingerprint:
    fps = [conjunct_fingerprint(c) for c in conjuncts]
    order = sorted(range(len(conjuncts)), key=lambda i: fps[i][0])
    var_index: Dict[int, int] = {}
    var_order: List[Term] = []
    enc = []
    for i in order:
        shape, occurrences, _named = fps[i]
        pattern = []
        for v in occurrences:
            j = var_index.get(v.tid)
            if j is None:
                j = len(var_order)
                var_index[v.tid] = j
                var_order.append(v)
            pattern.append(j)
        enc.append([shape, pattern])
    qhash = digest(json.dumps(enc, separators=(",", ":")))
    return QueryFingerprint(
        qhash, tuple(var_order), frozenset(f[2] for f in fps)
    )


# ---------------------------------------------------------------------------
# Model (de)serialization.  Entries carry BOTH keys per variable: the
# canonical index (exact-hit rebuild onto an alpha-renamed query) and the
# (name, sort) pair (cross-query model-reuse probing).
# ---------------------------------------------------------------------------


def _sort_key(enc):
    return tuple(enc) if isinstance(enc, list) else enc


def dump_model(asg: Assignment, var_index: Dict[int, int]) -> Optional[dict]:
    """JSON-able form of a validated model; None when it cannot be cached
    faithfully (uninterpreted-function entries have no stable cross-run
    key).  Variables outside ``var_index`` are dropped — recycled models
    carry assignments for unrelated queries' symbols, which cannot affect
    this query's evaluation."""
    if asg.ufs:
        return None
    scalars = []
    for t, v in asg.scalars.items():
        ci = var_index.get(t.tid)
        if ci is None:
            continue
        scalars.append(
            [ci, t.aux, _encode_sort(t.sort),
             bool(v) if t.sort is terms.BOOL else int(v)]
        )
    arrays = []
    for t, av in asg.arrays.items():
        ci = var_index.get(t.tid)
        if ci is None:
            continue
        arrays.append(
            [ci, t.aux, _encode_sort(t.sort), {
                "backing": {str(k): int(v) for k, v in av.backing.items()},
                "default": int(av.default),
                "salt": int(av.salt),
                "range_bits": int(av.range_bits),
            }]
        )
    return {"scalars": scalars, "arrays": arrays}


def _load_array(data: dict) -> ArrayValue:
    return ArrayValue(
        {int(k): int(v) for k, v in data.get("backing", {}).items()},
        int(data.get("default", 0)),
        int(data.get("salt", 0)),
        int(data.get("range_bits", 0)),
    )


def load_model(data: dict, var_order: Sequence[Term]) -> Optional[Assignment]:
    """Rebuild a cached model onto ``var_order`` (canonical index -> this
    query's variable).  None on any index/sort mismatch — the caller then
    treats the entry as a miss."""
    scalars: Dict[Term, object] = {}
    arrays: Dict[Term, ArrayValue] = {}
    try:
        for ci, _name, sort_enc, v in data.get("scalars", ()):
            if ci >= len(var_order):
                return None
            t = var_order[ci]
            if _sort_key(_encode_sort(t.sort)) != _sort_key(sort_enc):
                return None
            scalars[t] = bool(v) if t.sort is terms.BOOL else int(v)
        for ci, _name, sort_enc, av in data.get("arrays", ()):
            if ci >= len(var_order):
                return None
            t = var_order[ci]
            if _sort_key(_encode_sort(t.sort)) != _sort_key(sort_enc):
                return None
            arrays[t] = _load_array(av)
    except (TypeError, ValueError, KeyError):
        return None
    return Assignment(scalars, arrays)


def model_on_query(data: dict, query_vars: Sequence[Term]) -> Optional[Assignment]:
    """Materialize a cached model onto a DIFFERENT query's variables by
    (name, sort) matching.  Unmatched query variables keep the Assignment
    completion default (0 / empty array); extra cached entries are ignored.
    The result is only a CANDIDATE — the caller must validate it with
    concrete_eval.evaluate before answering SAT."""
    scalars_by_name: Dict[tuple, object] = {}
    arrays_by_name: Dict[tuple, dict] = {}
    try:
        for _ci, name, sort_enc, v in data.get("scalars", ()):
            scalars_by_name[(name, _sort_key(sort_enc))] = v
        for _ci, name, sort_enc, av in data.get("arrays", ()):
            arrays_by_name[(name, _sort_key(sort_enc))] = av
    except (TypeError, ValueError):
        return None
    scalars: Dict[Term, object] = {}
    arrays: Dict[Term, ArrayValue] = {}
    matched = False
    for t in query_vars:
        key = (t.aux, _sort_key(_encode_sort(t.sort)))
        if t.op == "var":
            v = scalars_by_name.get(key)
            if v is not None:
                scalars[t] = bool(v) if t.sort is terms.BOOL else int(v)
                matched = True
        elif t.op == "array_var":
            av = arrays_by_name.get(key)
            if av is not None:
                try:
                    arrays[t] = _load_array(av)
                except (TypeError, ValueError):
                    return None
                matched = True
    if not matched:
        return None
    return Assignment(scalars, arrays)
