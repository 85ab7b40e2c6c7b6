"""IntegerArithmetics: overflow/underflow that reaches a sink (SWC-101).

Reference parity: mythril/analysis/module/modules/integer.py:1-350 — ADD/MUL/
SUB/EXP results are annotated with their overflow predicate; an issue is
raised only when an annotated (tainted) value reaches a sink (SSTORE / JUMPI /
CALL / RETURN) and both the overflow and the path are satisfiable at
transaction end.
"""

from __future__ import annotations

import logging
from typing import List, Optional

from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.potential_issues import (
    PotentialIssue,
    get_potential_issues_annotation,
)
from mythril_tpu_torch.analysis.swc_data import INTEGER_OVERFLOW_AND_UNDERFLOW
from mythril_tpu_torch.core.state.global_state import GlobalState
from mythril_tpu_torch.smt import (
    BitVec,
    Bool,
    BVAddNoOverflow,
    BVMulNoOverflow,
    BVSubNoUnderflow,
    Not,
)

log = logging.getLogger(__name__)

DESCRIPTION = """
Check for integer underflows.
For every SUB instruction, check if there's a possible state where op1 > op0.
For every ADD, MUL instruction, check if there's a possible state where op1 + op0 > 2^32 - 1.
"""


def _iroot_ceil(n: int, e: int) -> int:
    """Smallest b with b**e >= n (exact integer e-th root, rounded up)."""
    if e <= 1 or n <= 1:
        return n
    lo, hi = 1, 1 << (-(-n.bit_length() // e) + 1)
    while lo < hi:
        mid = (lo + hi) // 2
        if mid**e >= n:
            hi = mid
        else:
            lo = mid + 1
    return lo


# overflow bands for fully-symbolic EXP: (exponent, smallest overflowing base)
_EXP_BANDS = tuple(
    (k, _iroot_ceil(1 << 256, k))
    for k in (2, 3, 4, 6, 8, 11, 16, 22, 32, 43, 64, 86, 128, 172, 256)
)


class OverUnderflowAnnotation:
    """Attached to a result BitVec: remembers the violating predicate."""

    __slots__ = ("overflowing_state", "operator", "constraint")

    def __init__(self, overflowing_state: GlobalState, operator: str, constraint: Bool):
        self.overflowing_state = overflowing_state
        self.operator = operator
        self.constraint = constraint


class IntegerArithmetics(DetectionModule):
    name = "Integer overflow or underflow"
    swc_id = INTEGER_OVERFLOW_AND_UNDERFLOW
    description = DESCRIPTION
    entry_point = EntryPoint.CALLBACK
    pre_hooks = [
        "ADD",
        "MUL",
        "SUB",
        "EXP",
        "SSTORE",
        "JUMPI",
        "CALL",
        "RETURN",
    ]
    # _handle_add/mul/sub/exp return immediately when both operands are
    # concrete (a.value/b.value not None) — the device suppresses those
    # events (solc code is dominated by concrete pointer arithmetic)
    concrete_nop_hooks = frozenset({"ADD", "MUL", "SUB", "EXP"})
    # staticpass: the SSTORE/JUMPI/CALL/RETURN hooks only verify overflow
    # annotations installed by the arithmetic hooks
    static_required_ops = frozenset({"ADD", "MUL", "SUB", "EXP"})

    def _execute(self, state: GlobalState) -> None:
        opcode = state.get_current_instruction()["opcode"]
        if opcode in ("ADD", "MUL", "SUB", "EXP"):
            getattr(self, f"_handle_{opcode.lower()}")(state)
        else:
            getattr(self, f"_handle_sink_{opcode.lower()}")(state)
        return None

    # -- taint sources -----------------------------------------------------

    def _handle_add(self, state: GlobalState) -> None:
        a, b = state.mstate.stack[-1], state.mstate.stack[-2]
        if a.value is not None and b.value is not None:
            return
        annotation = OverUnderflowAnnotation(
            state, "addition", Not(BVAddNoOverflow(a, b, False))
        )
        # annotate the operand: the ADD handler's result unions operand
        # annotations, so the taint rides forward to any sink
        state.mstate.stack[-1].annotate(annotation)

    def _handle_mul(self, state: GlobalState) -> None:
        a, b = state.mstate.stack[-1], state.mstate.stack[-2]
        if a.value is not None and b.value is not None:
            return
        annotation = OverUnderflowAnnotation(
            state, "multiplication", Not(BVMulNoOverflow(a, b, False))
        )
        state.mstate.stack[-1].annotate(annotation)

    def _handle_sub(self, state: GlobalState) -> None:
        a, b = state.mstate.stack[-1], state.mstate.stack[-2]
        if a.value is not None and b.value is not None:
            return
        annotation = OverUnderflowAnnotation(
            state, "subtraction", Not(BVSubNoUnderflow(a, b, False))
        )
        state.mstate.stack[-1].annotate(annotation)

    def _handle_exp(self, state: GlobalState) -> None:
        base, exponent = state.mstate.stack[-1], state.mstate.stack[-2]
        if base.value is not None and exponent.value is not None:
            return
        constraint = self._exp_overflow_condition(base, exponent)
        if constraint is None:
            return
        annotation = OverUnderflowAnnotation(state, "exponentiation", constraint)
        state.mstate.stack[-1].annotate(annotation)

    @staticmethod
    def _exp_overflow_condition(base: BitVec, exponent: BitVec) -> Optional[Bool]:
        """base ** exponent >= 2^256, without a symbolic power term.

        One side concrete gives the exact threshold on the other; both
        symbolic uses a band cover: base >= 2^ceil(256/k) and exponent >= k
        implies overflow for any band k (sound; bands at ~sqrt(2) spacing
        keep the miss window small)."""
        from mythril_tpu_torch.smt import And, Or, UGE, symbol_factory

        def bv(v: int) -> BitVec:
            return symbol_factory.BitVecVal(v, 256)

        if base.value is not None:
            b = base.value
            if b <= 1:
                return None
            e, power = 0, 1
            while power < (1 << 256):
                power *= b
                e += 1
            return UGE(exponent, bv(e))  # smallest e with b**e >= 2^256
        if exponent.value is not None:
            e = exponent.value
            if e == 0:
                return None
            if e == 1:
                return None  # base itself cannot exceed 2^256 - 1
            if e >= 256:
                return UGE(base, bv(2))
            # smallest b with b**e >= 2^256: integer e-th root of 2^256,
            # adjusted (2**ceil(256/e) overshoots whenever e does not divide
            # 256, silently missing a band of real overflows)
            thresh = _iroot_ceil(1 << 256, e)
            return UGE(base, bv(thresh))
        return Or(
            *[
                And(UGE(base, bv(thresh)), UGE(exponent, bv(k)))
                for k, thresh in _EXP_BANDS
            ]
        )

    # -- sinks --------------------------------------------------------------

    def _collect(self, value: BitVec) -> List[OverUnderflowAnnotation]:
        return [a for a in value.annotations if isinstance(a, OverUnderflowAnnotation)]

    def _handle_sink_sstore(self, state: GlobalState) -> None:
        value = state.mstate.stack[-2]
        self._register(state, self._collect(value))

    def _handle_sink_jumpi(self, state: GlobalState) -> None:
        condition = state.mstate.stack[-2]
        self._register(state, self._collect(condition))

    def _handle_sink_call(self, state: GlobalState) -> None:
        value = state.mstate.stack[-3]
        self._register(state, self._collect(value))

    def _handle_sink_return(self, state: GlobalState) -> None:
        offset = state.mstate.stack[-1]
        self._register(state, self._collect(offset))

    def _register(self, state: GlobalState, annotations: List[OverUnderflowAnnotation]) -> None:
        """Park EVERY overflow annotation riding the sink value.

        The reference collects all of them into a set and reports each
        satisfiable one (integer.py:211-259) — parking only the first would
        make WHICH site gets reported depend on annotation ordering, i.e.
        on scheduling (caught by the cooperative differential test)."""
        if not annotations:
            return
        if self._cache_key(state) in self.cache:
            return
        parked = get_potential_issues_annotation(state)

        def _ckey(constraints):
            return tuple(
                c.raw.tid if hasattr(c, "raw") else id(c) for c in constraints
            )

        # key includes the constraint identity: two parks of the same site
        # from different overflowing states carry DIFFERENT predicates, and
        # only one of them may be satisfiable — dropping by address alone
        # could park the unsatisfiable variant forever
        seen = {
            (p.address, p.title, _ckey(p.constraints))
            for p in parked.potential_issues
            if p.detector is self
        }
        for annotation in annotations:
            ostate = annotation.overflowing_state
            address = ostate.get_current_instruction()["address"]
            title = (
                "Integer Underflow"
                if annotation.operator == "subtraction"
                else "Integer Overflow"
            )
            key = (address, title, _ckey([annotation.constraint]))
            if key in seen:
                continue
            seen.add(key)
            potential_issue = PotentialIssue(
                contract=ostate.environment.active_account.contract_name,
                function_name=ostate.node.function_name if ostate.node else "unknown",
                address=address,
                swc_id=INTEGER_OVERFLOW_AND_UNDERFLOW,
                title=title,
                severity="High",
                bytecode=ostate.environment.code.bytecode,
                description_head=f"The arithmetic operator can {'underflow' if annotation.operator == 'subtraction' else 'overflow'}.",
                description_tail=(
                    "It is possible to cause an integer overflow or underflow in the "
                    "arithmetic operation. Prevent this by constraining inputs using "
                    "the require() statement or use the OpenZeppelin SafeMath library "
                    "for integer arithmetic operations. Refer to the transaction "
                    "sequence to see how the overflow can be triggered."
                ),
                detector=self,
                constraints=[annotation.constraint],
            )
            parked.potential_issues.append(potential_issue)


detector = IntegerArithmetics
