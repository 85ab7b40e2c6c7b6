"""Cross-process completed-result LRU under ``--cache-root``.

The admission controller's in-memory replay log dies with its process
and is invisible to anything else sharing the cache root.  This store
persists each completed flight's event log (the same replay-then-live
event list a late subscriber gets) as one small JSON file keyed by
``(codehash, options_key)`` — so a dedup hit survives worker affinity,
daemon restarts, and multiple daemons sharing one ``--cache-root``
(exactly like the SMT query cache and kernel build cache beside it).

Concurrency: writes are atomic (tmp + ``os.replace``), reads tolerate
missing/garbled files (a torn concurrent eviction reads as a miss), and
LRU pressure is by mtime — ``get`` touches the file, eviction removes
the oldest.  No cross-process lock is needed: the worst race re-analyzes
one contract, it never corrupts a result.

Only ``done``-terminated logs are stored, mirroring the in-memory
policy: a tenant-scoped failure must not poison later submissions.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
from typing import Any, List, Optional, Tuple

log = logging.getLogger(__name__)

__all__ = ["ResultStore"]


class ResultStore:
    def __init__(self, root: str, max_entries: int = 1024):
        self.root = os.path.abspath(os.path.expanduser(root))
        self.max_entries = max_entries
        os.makedirs(self.root, exist_ok=True)

    def _path(self, key: Tuple) -> str:
        digest = hashlib.sha256(repr(key).encode()).hexdigest()[:40]
        return os.path.join(self.root, f"{digest}.json")

    def get(self, key: Tuple) -> Optional[List[Tuple[str, Any]]]:
        """Replay log for ``key``, or None.  Touches the entry (LRU)."""
        path = self._path(key)
        try:
            with open(path, "r", encoding="utf-8") as f:
                doc = json.load(f)
            events = [(str(k), p) for k, p in doc["events"]]
        except (OSError, ValueError, KeyError, TypeError):
            return None
        if not events or events[-1][0] != "done":
            return None
        try:
            os.utime(path)
        except OSError:
            pass
        return events

    def put(self, key: Tuple, events: List[Tuple[str, Any]]) -> bool:
        """Persist a completed replay log; returns False on skip/error."""
        if not events or events[-1][0] != "done":
            return False
        path = self._path(key)
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(
                    {"key": repr(key),
                     "events": [[k, p] for k, p in events]},
                    f, default=repr,
                )
            os.replace(tmp, path)
        except (OSError, ValueError):
            log.debug("result store put failed for %r", key, exc_info=True)
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return False
        self._evict()
        return True

    def _evict(self) -> None:
        try:
            entries = [
                os.path.join(self.root, n)
                for n in os.listdir(self.root)
                if n.endswith(".json")
            ]
            if len(entries) <= self.max_entries:
                return
            entries.sort(key=lambda p: os.path.getmtime(p))
            for path in entries[: len(entries) - self.max_entries]:
                os.unlink(path)
        except OSError:
            pass  # concurrent eviction; next put retries

    def __len__(self) -> int:
        try:
            return sum(
                1 for n in os.listdir(self.root) if n.endswith(".json")
            )
        except OSError:
            return 0
