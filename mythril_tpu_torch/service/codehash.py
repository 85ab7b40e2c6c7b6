"""Canonical request identity: codehash, options key, issue digest.

Admission dedups submissions that will provably produce the same result:
the *canonical codehash* (keccak of the normalized runtime bytecode —
hex casing, ``0x`` prefixes and whitespace are presentation, not
identity) crossed with the *options key* (the analysis options that can
change the issue set).  Two requests with equal ``(codehash,
options_key)`` share one analysis.

``issue_digest`` is the determinism unit: the fields of an issue that
are invariant under batch composition.  ``Issue.address`` is the
instruction offset and ``bytecode_hash`` the code identity, so both
survive re-batching; transaction sequences and rendered descriptions
embed the per-slot account address the cooperative sweep assigns
(``BASE_ADDRESS + 0x10000*i``) and are therefore excluded — they vary
with batch position by construction, not by finding.
"""

from __future__ import annotations

import re
from typing import Optional, Sequence, Tuple

from mythril_tpu_torch.support.support_utils import get_code_hash

__all__ = [
    "canonical_codehash",
    "issue_digest",
    "normalize_code",
    "options_key",
]

_HEX_RE = re.compile(r"\A(?:[0-9a-f]{2})*\Z")


def normalize_code(code) -> bytes:
    """Normalize a submitted contract to runtime bytecode bytes.

    Accepts ``bytes``/``bytearray`` or a hex string with optional ``0x``
    prefix, any casing, and embedded whitespace (copy-paste from
    explorers / build artifacts).  Raises ``ValueError`` for anything
    that is not plain hex or for empty code.
    """
    if isinstance(code, (bytes, bytearray)):
        raw = bytes(code)
    elif isinstance(code, str):
        text = "".join(code.split()).lower()
        if text.startswith("0x"):
            text = text[2:]
        if not _HEX_RE.match(text):
            raise ValueError("contract code is not valid hex")
        raw = bytes.fromhex(text)
    else:
        raise ValueError(f"unsupported code type {type(code).__name__}")
    if not raw:
        raise ValueError("empty contract code")
    return raw


def canonical_codehash(code) -> str:
    """0x-prefixed keccak of the normalized runtime bytecode.

    Matches ``support_utils.get_code_hash`` (and therefore
    ``Issue.bytecode_hash``) exactly, so issue attribution and admission
    identity agree by construction.
    """
    return get_code_hash(normalize_code(code))


def options_key(
    transaction_count: int,
    modules: Optional[Sequence[str]] = None,
    strategy: str = "bfs",
    execution_timeout: int = 60,
    coverage_target: Optional[float] = None,
) -> Tuple:
    """Hashable key over the options that can change an issue set.

    Module order is presentation (the loader filters a fixed registry),
    so the key sorts it.  Requests with equal keys are batch-compatible:
    the cooperative sweep runs one shared configuration per batch.
    A coverage target changes WHEN exploration stops, so it is part of
    the key (target-bounded and budget-bounded runs must not dedup).
    """
    mods = tuple(sorted(modules)) if modules else None
    return (int(transaction_count), mods, str(strategy),
            int(execution_timeout),
            float(coverage_target) if coverage_target is not None else None)


def issue_digest(issue) -> Tuple:
    """Batch-invariant identity of one finding.

    Works on ``analysis.report.Issue`` objects and on the wire dicts the
    service streams (so clients can compute the same digests).
    """
    if isinstance(issue, dict):
        return (
            str(issue.get("swc_id", "")),
            int(issue.get("address", -1)),
            str(issue.get("bytecode_hash", "")),
            str(issue.get("title", "")),
            str(issue.get("function", "")),
        )
    return (
        str(issue.swc_id),
        int(issue.address),
        str(issue.bytecode_hash),
        str(issue.title),
        str(issue.function),
    )
