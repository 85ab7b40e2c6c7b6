"""Persistent SMT query cache: verdict memoization + cheap reuse tiers.

An in-process LRU (always on unless ``--no-query-cache``) layered over an
optional disk store (``--query-cache-dir``), keyed by the renaming-invariant
canonical hash from :mod:`mythril_tpu_torch.querycache.canon`.  Lookup runs three
tiers, every one strictly cheaper than any solver dispatch:

exact
    The canonical hash indexes a stored verdict.  A SAT entry carries its
    model (canonical-index keyed); the model is rebuilt onto THIS query's
    variables and re-validated with ``concrete_eval.evaluate`` before being
    served, so a served SAT is sound by construction exactly like a probe
    hit.  A served UNSAT is sound because hash equality implies
    alpha-equivalence (canon.py's encoding is a complete invariant).
    UNKNOWN entries carry the budget they were produced under and are
    served only to requests with an equal-or-smaller budget — a larger
    budget must retry, exactly reproducing what cold solving would do.

core subsumption
    Minimized unsat cores are stored as sets of name-preserving conjunct
    hashes.  A cached core that is a SUBSET of the query's conjunct-hash
    set proves the query unsat (a conjunction containing an unsatisfiable
    subset is unsatisfiable; names must match, so shared-variable identity
    is preserved).

model reuse
    Recently cached SAT models are materialized onto the query's variables
    by (name, sort) and evaluated; a satisfying one answers SAT without
    solving — the cross-run analogue of the solver's in-process
    recent-model replay tier.

Every tier either re-validates on the live query or rests on an exact
argument, so cached answers are verdict-identical to cold solving.

Counters (``querycache.*``) live in the observability registry and flow
into jsonv2 report meta / ``--metrics-out`` like every other subsystem's.

The port's copy of ``mythril_tpu/querycache/cache.py`` adds, after
``materialize_counters``: ``COUNTERS``, a view of the ``querycache.*``
counters by name without the prefix; ``entry_hits(entry, span)``, which
sets the hits the body took on the entry point's span as the JAX package's
``querycache_hits`` argument and counts them, when there are any, in the
labeled counter ``querycache.entry_hits{entry}`` (``ENTRY_HITS``, a view);
and ``reset_counters``.
"""

from __future__ import annotations

import contextlib
import logging
import threading
from collections import OrderedDict
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

from mythril_tpu_torch.observability import tracer as _otrace
from mythril_tpu_torch.observability import views
from mythril_tpu_torch.querycache import canon
from mythril_tpu_torch.querycache.store import DiskStore
from mythril_tpu_torch.smt.concrete_eval import Assignment, evaluate
from mythril_tpu_torch.smt.terms import Term

log = logging.getLogger(__name__)

# mirror smt.solver's verdict strings without importing it (the solver
# imports this package at its hook sites; a module-level back-import would
# be a cycle)
SAT = "sat"
UNSAT = "unsat"
UNKNOWN = "unknown"

_UNSET = object()

_COUNTERS = (
    "querycache.lookups",
    "querycache.exact_hits",
    "querycache.model_hits",
    "querycache.core_hits",
    "querycache.unknown_hits",
    "querycache.unknown_retries",
    "querycache.misses",
    "querycache.stores",
    "querycache.disk_reads",
    "querycache.disk_writes",
    "querycache.validation_failures",
)

_HIT_COUNTERS = (
    "querycache.exact_hits",
    "querycache.model_hits",
    "querycache.core_hits",
    "querycache.unknown_hits",
)


def _registry():
    from mythril_tpu_torch.observability.metrics import get_registry

    return get_registry()


def materialize_counters() -> None:
    """Force-create the querycache.* counters so registry snapshots (report
    meta, --metrics-out, bench) always carry the full block, zeroes
    included, even for runs where the cache never fired."""
    reg = _registry()
    for name in _COUNTERS:
        reg.counter(name)


# the counters by name without the prefix, and the hits by entry point
COUNTERS = views.CounterView("querycache.", [n.split(".", 1)[1] for n in _COUNTERS])
ENTRY_HITS = views.LabeledView("querycache.entry_hits")


def reset_counters() -> None:
    _registry().reset(prefix="querycache.")


@contextlib.contextmanager
def entry_hits(entry: str, span=None):
    """The hits the body takes under the entry point ``entry`` (issue
    confirmation, the frontier's prune check and mutation prefetch): set on
    ``span`` as ``querycache_hits`` and counted in ``ENTRY_HITS``."""
    from mythril_tpu_torch.querycache import get_query_cache

    cache = get_query_cache()
    before = cache.hits_total()
    yield
    hits = cache.hits_total() - before
    if span is not None:
        span.set(querycache_hits=hits)
    if hits:
        _registry().labeled_counter("querycache.entry_hits",
                                    label_name="entry").inc(entry, hits)


class QueryCache:
    # models probed per lookup in the reuse tier (each miss is one host
    # DAG evaluation, same cost class as the solver's replay tier)
    MODEL_PROBE_LIMIT = 8
    # cores larger than this are not stored: a wide core almost never
    # recurs as a subset of a different query, and subset checks over the
    # member index stay O(small)
    CORE_SIZE_CAP = 12
    # greedy core minimization is attempted only below this set size
    # (quadratic interval-refutation walks)
    MINIMIZE_CAP = 16

    def __init__(self, max_entries: int = 4096, max_models: int = 64,
                 max_cores: int = 4096) -> None:
        self.enabled = True
        self.max_entries = max_entries
        self.max_models = max_models
        self.max_cores = max_cores
        # RLock: lookup can trigger a disk read that re-enters bookkeeping
        self._lock = threading.RLock()
        self._store: Optional[DiskStore] = None
        self._entries: "OrderedDict[str, dict]" = OrderedDict()
        self._models: "OrderedDict[str, dict]" = OrderedDict()
        self._cores: Dict[str, FrozenSet[str]] = {}
        # one representative member (min hash) -> core ids: a core can only
        # subsume a query that contains its representative, so lookup walks
        # the query's own hashes instead of every stored core
        self._core_members: Dict[str, List[str]] = {}
        self._fp_memo: Dict[frozenset, canon.QueryFingerprint] = {}

    # -- configuration ------------------------------------------------

    def configure(self, enabled=None, cache_dir=_UNSET) -> None:
        with self._lock:
            if enabled is not None:
                self.enabled = bool(enabled)
            if cache_dir is _UNSET:
                return
            if cache_dir is None:
                self._store = None
                return
            try:
                self._store = DiskStore(cache_dir)
            except OSError as e:
                log.warning("query cache dir %s unusable (%s); disk layer off",
                            cache_dir, e)
                self._store = None
                return
            for cid, hashes in self._store.load_cores(self.max_cores).items():
                self._add_core(cid, hashes, write=False)

    def reset(self) -> None:
        """Drop the in-process layers (bench cold runs / per-test isolation).
        The disk store survives and its cores are re-indexed, so a
        configured warm run hits only through disk."""
        with self._lock:
            self._entries.clear()
            self._models.clear()
            self._cores.clear()
            self._core_members.clear()
            self.clear_memos()
            if self._store is not None:
                for cid, hashes in self._store.load_cores(self.max_cores).items():
                    self._add_core(cid, hashes, write=False)

    def clear_memos(self) -> None:
        """Drop term-id-keyed memos only (they reference interned Terms;
        cleared alongside the solver's term caches so dropped DAGs can be
        collected and tids can never be served stale)."""
        self._fp_memo.clear()
        canon.clear_memos()

    # -- fingerprints --------------------------------------------------

    def _fingerprint(self, conj: Sequence[Term]) -> canon.QueryFingerprint:
        key = frozenset(c.tid for c in conj)
        fp = self._fp_memo.get(key)
        if fp is None:
            if len(self._fp_memo) >= 8192:
                self._fp_memo.clear()
            fp = canon.fingerprint(conj)
            self._fp_memo[key] = fp
        return fp

    # -- lookup ---------------------------------------------------------

    def lookup(
        self,
        conjuncts: Sequence[Term],
        budget_ms: Optional[int] = None,
        probe_models: bool = True,
    ) -> Optional[Tuple[str, Optional[Assignment]]]:
        """Decide the conjunction from cached knowledge, or None (miss).

        ``budget_ms``: the requesting query's solver budget — required for
        serving cached UNKNOWNs (None never serves them).  ``probe_models``
        gates the model-reuse tier for batched callers that replay models
        over a merged union themselves.
        """
        if not self.enabled or not conjuncts:
            return None
        reg = _registry()
        with self._lock:
            reg.counter("querycache.lookups").inc()
            fp = self._fingerprint(conjuncts)
            result, tier = self._lookup_locked(
                conjuncts, fp, budget_ms, probe_models, reg
            )
        if result is None:
            reg.counter("querycache.misses").inc()
            return None
        reg.counter("querycache." + tier).inc()
        if _otrace.get_tracer().enabled:
            with _otrace.span(
                "querycache.hit", cat="smt",
                tier=tier[:-1] if tier.endswith("s") else tier,
                status=result[0], conjuncts=len(conjuncts),
            ):
                pass
        return result

    def _lookup_locked(self, conjuncts, fp, budget_ms, probe_models, reg):
        entry = self._entries.get(fp.qhash)
        if entry is not None:
            self._entries.move_to_end(fp.qhash)
        elif self._store is not None:
            entry = self._store.read_entry(fp.qhash)
            if entry is not None:
                reg.counter("querycache.disk_reads").inc()
                self._remember_entry(fp.qhash, entry)
        if entry is not None:
            verdict = entry.get("verdict")
            if verdict == UNSAT:
                return (UNSAT, None), "exact_hits"
            if verdict == SAT:
                model = entry.get("model")
                asg = canon.load_model(model, fp.var_order) if model else None
                if asg is not None and self._validates(conjuncts, asg):
                    self._remember_model(fp.qhash, model)
                    return (SAT, asg), "exact_hits"
                # hash collisions are cryptographically negligible, but the
                # validation gate means even one could only cost a miss
                reg.counter("querycache.validation_failures").inc()
            elif verdict == UNKNOWN:
                cached_budget = entry.get("budget_ms")
                if (
                    budget_ms is not None
                    and cached_budget is not None
                    and int(budget_ms) <= int(cached_budget)
                ):
                    return (UNKNOWN, None), "unknown_hits"
                reg.counter("querycache.unknown_retries").inc()
        cid = self._subsuming_core(fp.conj_hashes)
        if cid is not None:
            return (UNSAT, None), "core_hits"
        if probe_models:
            for qhash in list(reversed(self._models))[: self.MODEL_PROBE_LIMIT]:
                if qhash == fp.qhash:
                    continue  # the exact tier already tried this one
                asg = canon.model_on_query(self._models[qhash], fp.var_order)
                if asg is not None and self._validates(conjuncts, asg):
                    return (SAT, asg), "model_hits"
        return None, None

    @staticmethod
    def _validates(conjuncts, asg) -> bool:
        try:
            vals = evaluate(conjuncts, asg)
        except Exception:
            return False
        return all(vals[c] for c in conjuncts)

    def _subsuming_core(self, conj_hashes: frozenset) -> Optional[str]:
        for h in conj_hashes:
            for cid in self._core_members.get(h, ()):
                if self._cores[cid] <= conj_hashes:
                    return cid
        return None

    # -- record ---------------------------------------------------------

    def record(
        self,
        conjuncts: Sequence[Term],
        status: str,
        asg: Optional[Assignment] = None,
        budget_ms: Optional[int] = None,
    ) -> None:
        """Persist a verdict.  Idempotent: re-recording a verdict that was
        itself served from the cache is a no-op, and a decided (SAT/UNSAT)
        verdict is never downgraded to UNKNOWN.  UNKNOWN entries keep the
        LARGEST budget they failed under."""
        if not self.enabled or not conjuncts:
            return
        if status not in (SAT, UNSAT, UNKNOWN):
            return
        reg = _registry()
        with self._lock:
            fp = self._fingerprint(conjuncts)
            existing = self._entries.get(fp.qhash)
            if status == UNKNOWN:
                budget = int(budget_ms or 0)
                if existing is not None:
                    if existing.get("verdict") != UNKNOWN:
                        return
                    if budget <= int(existing.get("budget_ms") or 0):
                        return
                entry = {"verdict": UNKNOWN, "budget_ms": budget}
            elif status == SAT:
                if existing is not None and existing.get("verdict") == SAT:
                    return
                if asg is None:
                    return
                var_index = {t.tid: i for i, t in enumerate(fp.var_order)}
                model = canon.dump_model(asg, var_index)
                if model is None:
                    # a SAT entry without a revalidatable model could never
                    # be served soundly — don't store one
                    return
                entry = {"verdict": SAT, "model": model}
                self._remember_model(fp.qhash, model)
            else:
                if existing is not None and existing.get("verdict") == UNSAT:
                    return
                entry = {"verdict": UNSAT}
                self._record_core(conjuncts)
            self._remember_entry(fp.qhash, entry)
            reg.counter("querycache.stores").inc()
            if self._store is not None and self._store.write_entry(fp.qhash, entry):
                reg.counter("querycache.disk_writes").inc()

    def _record_core(self, conjuncts: Sequence[Term]) -> None:
        core = self._minimize_core(list(conjuncts))
        if len(core) > self.CORE_SIZE_CAP:
            return
        hashes = frozenset(canon.conjunct_fingerprint(c)[2] for c in core)
        cid = canon.digest("|".join(sorted(hashes)))
        self._add_core(cid, hashes, write=True)

    def _minimize_core(self, core: List[Term]) -> List[Term]:
        """Greedy-drop minimization, justified conjunct by conjunct with the
        EXACT interval refuter (never the heuristic probe: every retained
        subset must itself be proven unsat, or the full recorded-UNSAT set
        is kept unminimized)."""
        if len(core) > self.MINIMIZE_CAP:
            return core
        from mythril_tpu_torch.smt.intervals import refute

        try:
            if not refute(core):
                return core
            i = 0
            while i < len(core) and len(core) > 1:
                trial = core[:i] + core[i + 1:]
                if refute(trial):
                    core = trial
                else:
                    i += 1
        except Exception:
            pass
        return core

    def _add_core(self, cid: str, hashes: FrozenSet[str], write: bool) -> None:
        if not hashes or cid in self._cores or len(self._cores) >= self.max_cores:
            return
        self._cores[cid] = hashes
        self._core_members.setdefault(min(hashes), []).append(cid)
        if write and self._store is not None:
            self._store.write_core(cid, hashes)

    # -- bounded containers --------------------------------------------

    def _remember_entry(self, qhash: str, entry: dict) -> None:
        if qhash in self._entries:
            self._entries.move_to_end(qhash)
        self._entries[qhash] = entry
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)

    def _remember_model(self, qhash: str, model: dict) -> None:
        if qhash in self._models:
            self._models.move_to_end(qhash)
        self._models[qhash] = model
        while len(self._models) > self.max_models:
            self._models.popitem(last=False)

    # -- introspection --------------------------------------------------

    def hits_total(self) -> int:
        reg = _registry()
        return sum(reg.counter(name).value for name in _HIT_COUNTERS)

    def stats(self) -> dict:
        reg = _registry()
        out = {name.split(".", 1)[1]: reg.counter(name).value
               for name in _COUNTERS}
        out["entries"] = len(self._entries)
        out["cores"] = len(self._cores)
        out["disk"] = self._store is not None
        return out
