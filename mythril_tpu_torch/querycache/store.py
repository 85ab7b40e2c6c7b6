"""Disk-backed store for cached solver verdicts.

Layout under the cache root (``--query-cache-dir``):

    entries/<h[:2]>/<h>.json   one verdict per canonical query hash
    cores/<id>.json            one minimized unsat core per file

Entries are tiny JSON documents written via write-then-``os.replace`` —
atomic on POSIX, so concurrent corpus shards (mythril_tpu_torch/parallel/corpus.py
runs one process per shard against a shared filesystem) can write the same
entry simultaneously and readers only ever observe a complete file.
Last-writer-wins is safe: two entries for one hash are verdict-identical by
construction (the hash pins the query up to variable renaming and verdicts
are deterministic facts about it; UNKNOWN entries may differ only in the
budget, where losing the larger value merely costs a retry).

Everything is best-effort: any I/O or decode failure degrades to a cache
miss, never to a wrong verdict or a crashed analysis.
"""

from __future__ import annotations

import itertools
import json
import os
from pathlib import Path
from typing import Dict, FrozenSet, Iterable, Optional

_TMP_COUNTER = itertools.count()


class DiskStore:
    def __init__(self, root) -> None:
        self.root = Path(root)
        self.entries_dir = self.root / "entries"
        self.cores_dir = self.root / "cores"
        self.entries_dir.mkdir(parents=True, exist_ok=True)
        self.cores_dir.mkdir(parents=True, exist_ok=True)

    def _entry_path(self, qhash: str) -> Path:
        return self.entries_dir / qhash[:2] / (qhash + ".json")

    def _atomic_write(self, path: Path, obj: dict) -> None:
        path.parent.mkdir(parents=True, exist_ok=True)
        # pid + counter keep concurrent writers' temp files distinct even on
        # filesystems where open(..., 'x') races are possible
        tmp = path.parent / f".{path.name}.{os.getpid()}.{next(_TMP_COUNTER)}.tmp"
        tmp.write_text(json.dumps(obj, separators=(",", ":")))
        os.replace(tmp, path)

    def read_entry(self, qhash: str) -> Optional[dict]:
        try:
            return json.loads(self._entry_path(qhash).read_text())
        except (OSError, ValueError):
            return None

    def write_entry(self, qhash: str, entry: dict) -> bool:
        try:
            self._atomic_write(self._entry_path(qhash), entry)
            return True
        except OSError:
            return False

    def write_core(self, core_id: str, hashes: Iterable[str]) -> bool:
        try:
            self._atomic_write(
                self.cores_dir / (core_id + ".json"),
                {"hashes": sorted(hashes)},
            )
            return True
        except OSError:
            return False

    def load_cores(self, limit: int = 4096) -> Dict[str, FrozenSet[str]]:
        """All stored cores (id -> conjunct-hash set), capped at ``limit``."""
        out: Dict[str, FrozenSet[str]] = {}
        try:
            paths = sorted(self.cores_dir.glob("*.json"))
        except OSError:
            return out
        for p in paths[:limit]:
            try:
                data = json.loads(p.read_text())
            except (OSError, ValueError):
                continue
            hashes = data.get("hashes")
            if hashes and all(isinstance(h, str) for h in hashes):
                out[p.stem] = frozenset(hashes)
        return out
