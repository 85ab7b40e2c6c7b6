"""The solver's device SAT tier (tier 0.65): decide narrow path conditions.

The port's counterpart of ``mythril_tpu/devsolver``.  Where the prefilter
(tier 0.58) can only refute, this tier decides: path conditions whose free
support fits a bit budget after the prefilter's narrowing are bit-blasted
to a packed 3-CNF plane (``blaster.py``) and searched by batched unit
propagation and bounded DPLL (``device.dpll``: the CUDA kernel on the card,
``kernel.run_plain`` on the CPU), with a three-valued verdict per query:

* UNSAT is exact: serialization abstractions only add behaviors and the
  narrowing pins are implied by the asserted conjuncts;
* SAT is a candidate until proven: the model is rebuilt through
  ``bitblast._rebuild_assignment`` and re-evaluated against the original
  terms; a model that does not hold falls through as UNKNOWN (and counts in
  ``model_validation_failures`` when the encoding was full);
* UNKNOWN (budget lapse, unsupported structure) falls through to the exact
  tiers unchanged.

Entry points: ``decide_batch(rows, device)`` / ``decide(conjuncts,
device)``; ``configure()`` sets the budgets (``support_args.args``); ``reset_state()``
drops the verdict memo and the admission accounting.  The ``devsolver.*``
counters (and ``devsolver.kernel_wall_s``, the host wall of the planes'
``run_device`` calls) live in the metrics registry, as in the JAX package;
the module attributes ``admitted``, ``decided_sat``, ``decided_unsat``,
``unknown`` and ``model_validation_failures`` read them.  Unsupported structure and host-side errors
of the blaster fall through; a ``DeviceError`` propagates.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

from mythril_tpu_torch.device import DeviceLike, resolve
from mythril_tpu_torch.native.bitblast import Unsupported
from mythril_tpu_torch.smt.terms import Term
from mythril_tpu_torch.support.support_args import args

__all__ = ["decide", "decide_batch", "configure", "reset_state", "reset_counters"]

SAT, UNSAT, UNKNOWN = "sat", "unsat", "unknown"

# verdict memo: frozenset of conjunct tids -> (status, assignment).  UNSAT
# and validated SAT are semantic facts; UNKNOWN is deterministic for fixed
# budgets, so caching it stops the tier re-paying blast cost on repeated
# queries.  Bounded FIFO.
_MEMO_CAP = 8192
_memo: "OrderedDict[frozenset, tuple]" = OrderedDict()
_memo_lock = threading.Lock()

_COUNTER_NAMES = ("admitted", "decided_sat", "decided_unsat", "unknown",
                  "model_validation_failures")


def configure(bit_budget: Optional[int] = None,
              iters: Optional[int] = None) -> None:
    """Set the tier's budgets; they live in ``support_args.args``
    (``devsolver_bit_budget``, ``devsolver_iters``), which ``decide_batch``
    reads on every call."""
    if bit_budget is not None:
        args.devsolver_bit_budget = int(bit_budget)
    if iters is not None:
        args.devsolver_iters = int(iters)


def reset_state() -> None:
    """Drop the verdict memo and the admission accounting."""
    from mythril_tpu_torch.devsolver import admission

    with _memo_lock:
        _memo.clear()
    admission.reset_state()


def _counters():
    from mythril_tpu_torch.observability import get_registry

    reg = get_registry()
    return (
        reg.counter("devsolver.admitted"),
        reg.counter("devsolver.decided_sat"),
        reg.counter("devsolver.decided_unsat"),
        reg.counter("devsolver.unknown"),
        reg.counter("devsolver.model_validation_failures"),
        reg.counter("devsolver.kernel_wall_s"),
    )


def __getattr__(name: str):
    """The ``devsolver.*`` counters by their JAX names."""
    if name in _COUNTER_NAMES:
        from mythril_tpu_torch.observability import get_registry

        m = get_registry()._metrics.get("devsolver." + name)
        return m.value if m is not None else 0
    raise AttributeError(name)


def reset_counters() -> None:
    from mythril_tpu_torch.observability import get_registry

    get_registry().reset(prefix="devsolver.")


def _memo_get(key: frozenset):
    with _memo_lock:
        return _memo.get(key)


def _memo_put(key: frozenset, verdict: tuple) -> None:
    with _memo_lock:
        _memo[key] = verdict
        while len(_memo) > _MEMO_CAP:
            _memo.popitem(last=False)


def _validate(conjuncts, blasted, assign_row):
    """Rebuild + validate one SAT candidate; None when it does not hold."""
    from mythril_tpu_torch.devsolver import blaster
    from mythril_tpu_torch.native import bitblast

    try:
        mb = blaster.model_bytes(blasted, assign_row)
        asg, _violations, _kec = bitblast._rebuild_assignment(blasted.tape, mb)
        if bitblast._model_validates(conjuncts, asg):
            return asg
    except Exception:
        pass
    return None


def decide_batch(conjunct_sets: Sequence[Sequence[Term]], device: DeviceLike = None
                 ) -> List[Tuple[str, Optional[object]]]:
    """One (status, model) per row: ``"sat"`` (a validated ``Assignment``),
    ``"unsat"`` (exact) or ``"unknown"`` (fall through).  ``device``: None
    is the CUDA card; pass ``"cpu"`` for the plain path."""
    from mythril_tpu_torch.devsolver import admission, blaster, device as dpll_device, kernel

    n = len(conjunct_sets)
    results: List[Optional[tuple]] = [None] * n
    keys = [frozenset(t.tid for t in cs) for cs in conjunct_sets]
    c_adm, c_sat, c_unsat, c_unk, c_badmodel, c_wall = _counters()
    point = admission.current_point()

    fresh: List[int] = []
    seen_pos: dict = {}
    for i, key in enumerate(keys):
        hit = _memo_get(key)
        if hit is not None:
            results[i] = hit
        elif key in seen_pos:
            results[i] = ("dup", seen_pos[key])
        else:
            seen_pos[key] = i
            fresh.append(i)

    # blast the admitted fresh rows
    blasted: dict = {}
    for i in list(fresh):
        if not admission.policy.admit(point):
            results[i] = (UNKNOWN, None)
            c_unk.inc()
            fresh.remove(i)
            continue
        c_adm.inc()
        try:
            b = blaster.blast(list(conjunct_sets[i]), bit_budget=args.devsolver_bit_budget)
        except Unsupported:
            results[i] = (UNKNOWN, None)
            _memo_put(keys[i], (UNKNOWN, None))
            c_unk.inc()
            admission.policy.note(point, decided=False)
            fresh.remove(i)
            continue
        except Exception:  # host-side structure the blaster does not take
            results[i] = (UNKNOWN, None)
            c_unk.inc()
            admission.policy.note(point, decided=False)
            fresh.remove(i)
            continue
        if b.verdict == UNSAT:
            results[i] = (UNSAT, None)
            _memo_put(keys[i], (UNSAT, None))
            c_unsat.inc()
            admission.policy.note(point, decided=True)
            fresh.remove(i)
            continue
        blasted[i] = b

    # packed planes for the survivors, chunked at the largest query bucket
    dev = resolve(device) if blasted else None
    q_cap = kernel.Q_BUCKETS[-1]
    all_idx = sorted(blasted)
    for chunk in range(0, len(all_idx), q_cap):
        idx = all_idx[chunk:chunk + q_cap]
        n_vars = max(blasted[i].n_vars for i in idx)
        plane = kernel.pack_plane(
            [(blasted[i].clauses, blasted[i].dec_vars) for i in idx], n_vars)
        t0 = time.perf_counter()
        status, assign = dpll_device.run_device(plane, args.devsolver_iters, dev)
        c_wall.inc(round(time.perf_counter() - t0, 6))

        for qi, i in enumerate(idx):
            if int(status[qi]) == kernel.UNSAT_Q:
                verdict: tuple = (UNSAT, None)
            elif int(status[qi]) == kernel.SAT_Q:
                asg = _validate(list(conjunct_sets[i]), blasted[i], assign[qi])
                if asg is None:
                    # on a full encoding a model that fails validation is a
                    # soundness alarm; on a projected, truncated or lazily
                    # abstracted one it is the expected fallthrough
                    if (blasted[i].projected == 0 and blasted[i].truncated == 0
                            and not blasted[i].abstracted):
                        c_badmodel.inc()
                    verdict = (UNKNOWN, None)
                else:
                    verdict = (SAT, asg)
            else:
                verdict = (UNKNOWN, None)
            results[i] = verdict
            _memo_put(keys[i], verdict)
            admission.policy.note(point, decided=verdict[0] in (SAT, UNSAT))
            if verdict[0] == SAT:
                c_sat.inc()
            elif verdict[0] == UNSAT:
                c_unsat.inc()
            else:
                c_unk.inc()

    out: List[Tuple[str, Optional[object]]] = []
    for i in range(n):
        r = results[i]
        if r is not None and r[0] == "dup":
            r = results[r[1]]
        if r is None:
            r = (UNKNOWN, None)
        out.append(r)
    return out


def decide(conjuncts: Sequence[Term], device: DeviceLike = None
           ) -> Tuple[str, Optional[object]]:
    """The single-row form (the solver's tier 0.65)."""
    return decide_batch([conjuncts], device)[0]
