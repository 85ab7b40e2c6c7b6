"""Carrier walker: replay device events through real host GlobalStates.

The device executes the pure-opcode flood; everything the analysis layer can
observe — detector pre/post hooks, plugin signals, transaction-end world
states, annotations (taint) — is reproduced here by advancing a *carrier*
``GlobalState`` through the recorded event stream of each path:

  * E_HOOK / E_TERMINAL events route through ``laser.execute_state`` — the
    exact code path the host engine uses (mythril_tpu_torch/core/svm.py:274-373,
    reference mythril/laser/ethereum/svm.py:336-449) — so hooks, signal
    handling, potential-issue checks and open-state archiving behave
    identically;
  * E_FORK events fire the JUMPI pre-hooks and then apply the device's
    branch decision (the fork the host engine would have made via
    ``copy.copy``, reference instructions.py:791-823);
  * between events the carrier's stack is synthesized from decoded operand
    rows — detectors only inspect the operands of the hooked opcode.

Annotation (taint) parity: host taint lives on smt wrapper objects and
propagates through operators.  The walker binds the wrapper that a hook saw
(and possibly annotated) to the arena row of that op's result; decoding any
later row unions the annotations of every bound row in its dependency
closure — the same reachability the host's operator-level unions compute.
"""

from __future__ import annotations

import copy as _copy
import logging
from typing import Dict, List, Optional, Set

import numpy as np

from mythril_tpu_torch.frontier import ops as O
from mythril_tpu_torch.frontier import taint
from mythril_tpu_torch.frontier.arena import HostArena
from mythril_tpu_torch.frontier.records import PathRecord
from mythril_tpu_torch.plugins.signals import PluginSkipState

log = logging.getLogger(__name__)


def fork_branch_row(ev: np.ndarray, taken: bool) -> int:
    """Arena row of the constraint an E_FORK event appends, or -1.

    THE authoritative decoding of the fork payload (written by
    step.py's jumpi handler / batch phase): for a single decided branch
    (extra == -1) the appended condition sits at EV_OP0+2; for a granted
    fork the taken child appends EV_OP0+2 (cond) and the falling-through
    parent EV_OP0+3 (Not cond).  Used by the event replay below and by the
    engine's lineage reconstruction (engine._lineage_constraint_rows).
    """
    extra = int(ev[O.EV_EXTRA])
    if extra == -3:
        return -1  # taken branch with invalid dest: path died, no constraint
    if extra == -1 or taken:
        return int(ev[O.EV_OP0 + 2])
    return int(ev[O.EV_OP0 + 3])


class Walker:
    def __init__(self, lasers, arena: HostArena, tables, seeds: List):
        """``lasers`` and ``tables`` are PER-SEED lists (parallel to
        ``seeds``): a multi-code batch replays each path through the laser
        and dispatch tables of the analysis that seeded it, so a corpus-wide
        segment harvests into 17 independent analyses correctly.  A single
        laser / CodeTables is accepted for the single-contract case."""
        if not isinstance(lasers, (list, tuple)):
            lasers = [lasers] * len(seeds)
        if not isinstance(tables, (list, tuple)):
            tables = [tables] * len(seeds)
        self.lasers = list(lasers)
        self.arena = arena
        self.tables = list(tables)
        self.seeds = seeds  # list of seed GlobalStates (one per tx spawn)
        # device gas counters start at 0 per path; issues must report
        # seed-relative totals (carrier copies don't carry custom attrs)
        self.gas_base = [
            (s.mstate.min_gas_used, s.mstate.max_gas_used) for s in seeds
        ]
        # arena row -> wrapper bound at a hook site (annotation carrier).
        # Partitioned PER LASER: annotations only ever flow within one
        # analysis (wrapper objects never cross lasers on the host), and the
        # partition is what lets the sharded harvest executor replay
        # different lasers' paths concurrently — a worker's decode closure
        # is a pure function of its own laser's replay history, with no
        # cross-thread binds (or memo clears) to race.  Interned arena rows
        # shared across lasers (e.g. common constants) no longer leak one
        # analysis' annotations into another — that was a latent bug of the
        # shared table, not behavior to preserve.
        self._bind_ctx: Dict[int, tuple] = {}  # id(laser) -> (bound, memo)
        # optional park routing hook (frontier/pipeline.py): called as
        # park_sink(laser, rec, carrier, snap) for parked carriers; a True
        # return means the sink took ownership (e.g. queued the state for
        # device re-injection) and the work-list append is skipped.  This
        # decouples harvesting a park from injecting it back somewhere.
        self.park_sink = None

    def add_seed(self, laser, tables, carrier) -> int:
        """Register a new seed mid-run (pipeline re-injection): appends to
        every per-seed parallel list and returns the new seed index."""
        idx = len(self.seeds)
        self.seeds.append(carrier)
        self.lasers.append(laser)
        self.tables.append(tables)
        self.gas_base.append(
            (carrier.mstate.min_gas_used, carrier.mstate.max_gas_used)
        )
        return idx

    def laser_for(self, rec: PathRecord):
        return self.lasers[rec.seed_idx]

    def tables_for(self, rec: PathRecord):
        return self.tables[rec.seed_idx]

    # ------------------------------------------------------------------
    # decode with annotation closure
    # ------------------------------------------------------------------

    def _binding(self, seed_idx: int) -> tuple:
        """(bound, anno_memo) dicts for the laser that owns ``seed_idx``.
        setdefault keeps creation atomic under concurrent replay workers
        (distinct lasers race only on the outer dict, never on a context).
        A laser-less walker (decode-only use) shares one sentinel context."""
        key = (
            id(self.lasers[seed_idx]) if seed_idx < len(self.lasers) else -1
        )
        return self._bind_ctx.setdefault(key, ({}, {}))

    def _annos(self, row: int, seed_idx: int) -> frozenset:
        bound, anno_memo = self._binding(seed_idx)
        got = anno_memo.get(row)
        if got is not None:
            return got
        out: Set = set()
        mask = 0
        stack = [int(row)]
        seen = set()
        while stack:
            r = stack.pop()
            if r < 0 or r in seen:
                continue
            seen.add(r)
            w = bound.get(r)
            if w is not None:
                out.update(getattr(w, "annotations", ()))
            ar = self.arena
            mask |= int(ar.taint[r])
            for ch in (ar.a[r], ar.b[r], ar.c[r]):
                ch = int(ch)
                if ch >= 0 and ar._row_has_term_arg(r, ch):
                    stack.append(ch)
        if mask:
            # taint-source bits reachable in the closure synthesize the
            # annotations their post-hooks would have installed — those
            # hooks' opcodes ship no device events at all (frontier/taint.py)
            out.update(taint.annotations_for_mask(mask))
        result = frozenset(out)
        anno_memo[row] = result
        return result

    def decode_wrapped(self, row: int, seed_idx: int = 0):
        """Arena row -> smt wrapper (BitVec/Bool) with taint closure.

        ``seed_idx`` selects the binding context (per laser): replay-time
        decodes pass the record's seed; the default covers single-laser
        callers (tests, single-contract engines)."""
        from mythril_tpu_torch.smt import BitVec, Bool
        from mythril_tpu_torch.smt import terms as T

        row = int(row)
        bound, _memo = self._binding(seed_idx)
        got = bound.get(row)
        if got is not None:
            return got
        term = self.arena.decode(row)
        annos = self._annos(row, seed_idx)
        if term.sort is T.BOOL:
            return Bool(term, annotations=annos)
        return BitVec(term, annotations=annos)

    def bind(self, row: int, wrapper, seed_idx: int = 0) -> None:
        if row is None or row < 0:
            return
        bound, anno_memo = self._binding(seed_idx)
        bound[int(row)] = wrapper
        anno_memo.clear()

    # ------------------------------------------------------------------
    # carrier management
    # ------------------------------------------------------------------

    def root_carrier(self, rec: PathRecord):
        seed = self.seeds[rec.seed_idx]
        carrier = _copy.copy(seed)
        return carrier

    def materialize(self, rec: PathRecord) -> None:
        """Ensure rec.carrier exists (walking ancestors as needed)."""
        if rec.carrier is not None or rec.dead:
            return
        if rec.parent is None:
            rec.carrier = self.root_carrier(rec)
            return
        parent = rec.parent
        self.advance(parent, rec.fork_event_idx + 1)
        if rec.carrier is None and not rec.dead:
            if parent.dead:
                # a hook killed the parent before the fork replayed: the
                # whole subtree dies with it (host parity: the state was
                # dropped before the JUMPI executed); the child inherits
                # the parent's termination class (a hook prune that kills
                # the subtree counts each descendant under the same class)
                rec.dead = True
                if rec.term_class is None:
                    rec.term_class = parent.term_class
                return
            # parent advance should have installed it via the fork event
            raise RuntimeError("fork event did not produce the child carrier")

    def advance(self, rec: PathRecord, upto: int) -> None:
        """Process rec.events[rec.carrier_pos:upto) on the carrier."""
        if rec.dead:
            return
        self.materialize(rec)
        if rec.dead:
            return
        while rec.carrier_pos < min(upto, len(rec.events)):
            ev = rec.events[rec.carrier_pos]
            rec.carrier_pos += 1
            try:
                self._process_event(rec, ev)
            except Exception:
                # an event that cannot replay poisons everything downstream
                # of it — kill the subtree cleanly (children see parent.dead)
                # instead of leaving half-advanced state behind
                rec.dead = True
                rec.carrier = None
                raise
            if rec.dead:
                return

    # ------------------------------------------------------------------
    # event processing
    # ------------------------------------------------------------------

    def _set_stack_from_ops(self, carrier, ev, seed_idx: int) -> None:
        ops = [int(ev[O.EV_OP0 + j]) for j in range(7)]
        ops = [r for r in ops if r >= 0]
        # ops are in pop order: stack top is ops[0]
        carrier.mstate.stack[:] = [
            self.decode_wrapped(r, seed_idx) for r in reversed(ops)
        ]

    def _set_gas(self, carrier, seed_idx: int, gmin: int, gmax: int) -> None:
        base = self.gas_base[seed_idx]
        carrier.mstate.min_gas_used = base[0] + gmin
        carrier.mstate.max_gas_used = base[1] + gmax

    def _restore_memory(self, rec: PathRecord) -> None:
        """Write the device's word table into the carrier memory.

        Most MSTOREs ship no event (code.py: MSTORE left _ALWAYS_EVENT;
        the user_assertions panic gate suppresses hook events for concrete
        non-panic values), so carrier memory is rebuilt wholesale from the
        final snapshot — once per path instead of once per write.  Called
        before the terminal event replays (RETURN/REVERT read their
        payload from memory) and before a parked carrier resumes on the
        host engine."""
        final = rec.final
        if final is None or rec.carrier is None:
            return
        for addr, row in final.get("mem", ()):
            rec.carrier.mstate.memory.write_word_at(
                int(addr), self.decode_wrapped(int(row), rec.seed_idx)
            )

    def _process_event(self, rec: PathRecord, ev: np.ndarray) -> None:
        carrier = rec.carrier
        kind = int(ev[O.EV_KIND])
        pc = int(ev[O.EV_PC])
        carrier.mstate.pc = pc
        self._set_gas(carrier, rec.seed_idx, int(ev[O.EV_GMIN]), int(ev[O.EV_GMAX]))

        laser = self.laser_for(rec)
        if kind == O.E_TERMINAL:
            # the terminal instruction (RETURN/REVERT payload, LOG data)
            # reads carrier memory, which per-write replay no longer keeps
            # current — install the device word table first
            self._restore_memory(rec)
        if kind in (O.E_HOOK, O.E_TERMINAL):
            self._set_stack_from_ops(carrier, ev, rec.seed_idx)
            new_states, op_code = laser.execute_state(carrier)
            if laser.requires_statespace:
                laser.manage_cfg(op_code, new_states)
            if kind == O.E_TERMINAL and new_states:
                # an INNER transaction ended on device: the host terminal
                # handler resumed the caller frame(s) (svm._end_message_call
                # via the <op>_post resume) — they continue on the host work
                # list.  (Outermost ends return [] after archiving the open
                # world state.)
                laser.work_list.extend(new_states)
                rec.carrier = None
                return
            if not new_states:
                rec.dead = True  # terminal, exceptional, or skipped
                rec.carrier = None
                return
            rec.carrier = new_states[0]
            if len(new_states) > 1:
                # can only happen if a hooked op forked on host; the device
                # never lets that happen (JUMPI is E_FORK)
                log.warning("unexpected host fork during event replay")
            res = int(ev[O.EV_RES])
            if res >= 0 and rec.carrier.mstate.stack:
                self.bind(res, rec.carrier.mstate.stack[-1], rec.seed_idx)
            return

        if kind == O.E_FORK:
            names = self.tables_for(rec).opcode_names
            op_name = names[pc] if pc < len(names) else "JUMPI"
            dest_row = int(ev[O.EV_OP0 + 0])
            word_row = int(ev[O.EV_OP0 + 1])
            if word_row >= 0:
                carrier.mstate.stack[:] = [
                    self.decode_wrapped(word_row, rec.seed_idx),
                    self.decode_wrapped(dest_row, rec.seed_idx),
                ]
            else:
                carrier.mstate.stack[:] = []
            # JUMPI pre-hooks (detectors); a skip kills the whole subtree,
            # matching the host engine dropping the state pre-execution
            try:
                for hook in laser._pre_hooks.get(op_name, []):
                    hook(carrier)
            except PluginSkipState:
                rec.dead = True
                # termination attribution: a detector/static-pass hook
                # pruned the path (harvest stamps the class at commit)
                if rec.term_class is None:
                    rec.term_class = "staticpass_pruned"
                rec.carrier = None
                return

            extra = int(ev[O.EV_EXTRA])
            if extra == -3:  # taken branch with invalid dest: path dies
                rec.dead = True
                rec.carrier = None
                return
            if extra == -1:  # single-branch decision (concrete or fall-only)
                cons_row = fork_branch_row(ev, taken=True)
                condition = None
                if cons_row >= 0:
                    condition = self.decode_wrapped(cons_row, rec.seed_idx)
                    carrier.world_state.constraints.append(condition)
                carrier.mstate.pc = int(ev[O.EV_RES])  # decided next pc
                carrier.mstate.depth += 1
                self._branch_node(laser, carrier, condition)
                return
            # granted fork: extra = child slot; child record was linked at
            # harvest via children_by_event
            cond_row = fork_branch_row(ev, taken=True)
            ncond_row = fork_branch_row(ev, taken=False)
            child = rec.children_by_event.get(rec.carrier_pos - 1)
            if child is not None and not child.dead:
                child_carrier = _copy.copy(carrier)
                cond = self.decode_wrapped(cond_row, rec.seed_idx)
                child_carrier.world_state.constraints.append(cond)
                child_carrier.mstate.pc = int(ev[O.EV_OP0 + 4])
                child_carrier.mstate.depth += 1
                self._branch_node(laser, child_carrier, cond)
                child.carrier = child_carrier
            ncond = self.decode_wrapped(ncond_row, rec.seed_idx)
            carrier.world_state.constraints.append(ncond)
            carrier.mstate.pc = pc + 1
            carrier.mstate.depth += 1
            self._branch_node(laser, carrier, ncond)
            return

        log.warning("unknown event kind %d", kind)

    @staticmethod
    def _branch_node(laser, carrier, condition) -> None:
        """CFG node transition for a JUMPI branch: function-entry naming and
        statespace bookkeeping (mirrors svm.manage_cfg for JUMPI,
        reference mythril/laser/ethereum/svm.py:506-532)."""
        if not laser.requires_statespace:
            return
        from mythril_tpu_torch.core.cfg import JumpType

        laser._new_node_state(carrier, JumpType.CONDITIONAL, condition)
        if carrier.node is not None:
            carrier.node.states.append(carrier)

    # ------------------------------------------------------------------
    # path completion
    # ------------------------------------------------------------------

    def finish(self, rec: PathRecord) -> None:
        """Path halted on device: drain events, then act on the halt kind.

        Split into ``replay`` (laser-local: event drain + park-carrier
        restore, safe to run concurrently for DIFFERENT lasers) and
        ``commit`` (cross-laser side effects: park routing through the
        shared ``park_sink``), so the sharded harvest executor can fan
        replays out per laser and serialize commits in slot order.  Calling
        ``finish`` is exactly ``replay`` then ``commit`` — the serial path
        and the oracle for parity tests."""
        self.replay(rec)
        self.commit(rec)

    def replay(self, rec: PathRecord) -> None:
        """Drain the record's events and restore a parked carrier's device
        state (pc/stack/gas/memory) — everything expensive, everything
        laser-local.  Terminal paths fully complete here: their E_TERMINAL
        event runs the terminal instruction through ``laser.execute_state``
        (transaction end -> open states / inner-call resumes), all appends
        landing on the owning laser's own lists."""
        self.advance(rec, len(rec.events))
        if rec.dead or rec.final is None:
            return
        halt = rec.final["halt"]
        if halt in (O.H_PARK, O.H_PENDING_FORK):
            carrier = rec.carrier
            if carrier is None:
                return
            snap = rec.final
            self._restore_memory(rec)
            carrier.mstate.pc = snap["pc"]
            carrier.mstate.stack[:] = [
                self.decode_wrapped(int(r), rec.seed_idx)
                for r in snap["stack"]
            ]
            self._set_gas(carrier, rec.seed_idx, snap["gas_min"], snap["gas_max"])
            carrier.mstate.depth = snap["depth"]
            carrier.mstate.memory_size = snap["mem_size"]
            if snap.get("semantic_park"):
                # the device provably cannot execute THIS instruction:
                # engine._mid_eligible keeps the state host-side until the
                # host engine advances it past the parking pc
                carrier._frontier_park_pc = snap["pc"]

    def commit(self, rec: PathRecord) -> None:
        """Route a replayed record's outcome: park-sink / work-list hand-off
        for parked carriers, no-ops for the rest.  The park sink is shared
        across lasers (pipeline re-injection queue), so the executor calls
        this on the main thread in slot order — queue order is bit-identical
        to the serial harvest."""
        if rec.dead or rec.final is None:
            return
        halt = rec.final["halt"]
        if halt in (O.H_STOP, O.H_RETURN, O.H_REVERT, O.H_SELFDESTRUCT,
                    O.H_INVALID):
            # the E_TERMINAL event already ran the terminal instruction via
            # execute_state (transaction end -> open states); nothing to do
            return
        if halt in (O.H_DEPTH, O.H_LOOP):
            return  # silently dropped, host strategy / loop-bound parity
        if halt in (O.H_PARK, O.H_PENDING_FORK):
            carrier = rec.carrier
            if carrier is None:
                return
            snap = rec.final
            sink = self.park_sink
            if sink is not None:
                try:
                    if sink(self.laser_for(rec), rec, carrier, snap):
                        return
                except Exception as e:  # pragma: no cover - defensive
                    log.warning("park sink failed: %s", e)
            self.laser_for(rec).work_list.append(carrier)
            return
        log.warning("unhandled halt kind %d", halt)
