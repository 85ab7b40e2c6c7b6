"""Copy of ``mythril_tpu/smt/serialize.py`` for the PyTorch port.  A dump made
by the JAX package is plain JSON that ``load_terms`` (alias
``from_jax_dump``) rebuilds unchanged: term DAGs are the state that carries
across the two packages.

Term-DAG serialization: checkpointing and cross-host shipping.

The reference has no checkpoint/resume (SURVEY.md §5.4); the TPU build's
recovery story is frontier snapshots between transactions, which requires
round-tripping the interned term DAGs that back constraints, storage arrays
and balance arrays.  Format: a JSON-able dict of topologically ordered nodes
``[op, sort, aux, [child indices]]`` — re-interning on load restores full
structural sharing (identical sub-DAGs collapse back onto the same Term).
Also the wire format for DCN corpus sharding (one contract batch per host).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from mythril_tpu_torch.smt import terms
from mythril_tpu_torch.smt.terms import Term


def _encode_sort(sort):
    if sort is terms.BOOL:
        return "bool"
    return list(sort)


def _decode_sort(enc):
    if enc == "bool":
        return terms.BOOL
    return tuple(enc)


def _encode_aux(aux):
    # tuples must survive JSON exactly (they are part of the intern key);
    # recursive: apply's aux is (name, (widths...), out_width)
    if isinstance(aux, tuple):
        return {"t": [_encode_aux(a) for a in aux]}
    return aux


def _decode_aux(enc):
    if isinstance(enc, dict) and "t" in enc:
        return tuple(_decode_aux(a) for a in enc["t"])
    return enc


def dump_terms(roots: Sequence[Term]) -> dict:
    """Serialize the DAGs under ``roots`` (order preserved)."""
    order = terms.topo_order(list(roots))
    index: Dict[int, int] = {t.tid: i for i, t in enumerate(order)}
    nodes = [
        [
            t.op,
            _encode_sort(t.sort),
            _encode_aux(t.aux),
            [index[a.tid] for a in t.args],
        ]
        for t in order
    ]
    return {"nodes": nodes, "roots": [index[r.tid] for r in roots]}


def load_terms(data: dict) -> List[Term]:
    """Rebuild terms; returns the root list in original order."""
    rebuilt: List[Term] = []
    for op, sort, aux, arg_idx in data["nodes"]:
        rebuilt.append(
            terms._mk(
                op,
                _decode_sort(sort),
                tuple(rebuilt[i] for i in arg_idx),
                _decode_aux(aux),
            )
        )
    return [rebuilt[i] for i in data["roots"]]


def from_jax_dump(data: dict) -> List[Term]:
    """Rebuild a ``mythril_tpu.smt.serialize.dump_terms`` dump as port terms."""
    return load_terms(data)
