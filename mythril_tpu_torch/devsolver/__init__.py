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
drops the verdict memo and the admission accounting.  The JAX package's
``devsolver.*`` counters are the module integers ``admitted``,
``decided_sat``, ``decided_unsat``, ``unknown`` and
``model_validation_failures``.  Unsupported structure and host-side errors
of the blaster fall through; a ``DeviceError`` propagates.
"""

from __future__ import annotations

import threading
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

admitted = 0
decided_sat = 0
decided_unsat = 0
unknown = 0
model_validation_failures = 0


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


def reset_counters() -> None:
    global admitted, decided_sat, decided_unsat, unknown, model_validation_failures
    admitted = decided_sat = decided_unsat = unknown = model_validation_failures = 0


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
    global admitted, decided_sat, decided_unsat, unknown, model_validation_failures
    from mythril_tpu_torch.devsolver import admission, blaster, device as dpll_device, kernel

    n = len(conjunct_sets)
    results: List[Optional[tuple]] = [None] * n
    keys = [frozenset(t.tid for t in cs) for cs in conjunct_sets]
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
            unknown += 1
            fresh.remove(i)
            continue
        admitted += 1
        try:
            b = blaster.blast(list(conjunct_sets[i]), bit_budget=args.devsolver_bit_budget)
        except Unsupported:
            results[i] = (UNKNOWN, None)
            _memo_put(keys[i], (UNKNOWN, None))
            unknown += 1
            admission.policy.note(point, decided=False)
            fresh.remove(i)
            continue
        except Exception:  # host-side structure the blaster does not take
            results[i] = (UNKNOWN, None)
            unknown += 1
            admission.policy.note(point, decided=False)
            fresh.remove(i)
            continue
        if b.verdict == UNSAT:
            results[i] = (UNSAT, None)
            _memo_put(keys[i], (UNSAT, None))
            decided_unsat += 1
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
        status, assign = dpll_device.run_device(plane, args.devsolver_iters, dev)

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
                        model_validation_failures += 1
                    verdict = (UNKNOWN, None)
                else:
                    verdict = (SAT, asg)
            else:
                verdict = (UNKNOWN, None)
            results[i] = verdict
            _memo_put(keys[i], verdict)
            admission.policy.note(point, decided=verdict[0] in (SAT, UNSAT))
            if verdict[0] == SAT:
                decided_sat += 1
            elif verdict[0] == UNSAT:
                decided_unsat += 1
            else:
                unknown += 1

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
