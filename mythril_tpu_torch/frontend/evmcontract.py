"""EVMContract: container for runtime + creation bytecode.

Reference parity: mythril/ethereum/evmcontract.py:14-115 (library-placeholder
scrubbing included; the ZODB persistence base is dropped as legacy).
"""

from __future__ import annotations

import re

from mythril_tpu_torch.frontend.disassembler import Disassembly
from mythril_tpu_torch.support.support_utils import get_code_hash


class EVMContract:
    def __init__(
        self,
        code: str = "",
        creation_code: str = "",
        name: str = "Unknown",
        enable_online_lookup: bool = False,
    ):
        # scrub unresolved library placeholders __LibName____ -> zero address
        creation_code = re.sub(r"(_{2}.{38})", "0" * 40, creation_code)
        code = re.sub(r"(_{2}.{38})", "0" * 40, code)

        self.creation_code = creation_code
        self.name = name
        self.code = code
        self.disassembly = Disassembly(code, enable_online_lookup=enable_online_lookup) if code else None
        self.creation_disassembly = (
            Disassembly(creation_code, enable_online_lookup=enable_online_lookup)
            if creation_code
            else None
        )

    @property
    def bytecode_hash(self) -> str:
        return get_code_hash(self.code)

    @property
    def creation_bytecode_hash(self) -> str:
        return get_code_hash(self.creation_code)

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "code": self.code,
            "creation_code": self.creation_code,
            "disassembly": self.disassembly.get_easm() if self.disassembly else "",
        }

    def get_easm(self) -> str:
        return self.disassembly.get_easm() if self.disassembly else ""

    def get_creation_easm(self) -> str:
        return self.creation_disassembly.get_easm() if self.creation_disassembly else ""

    def matches_expression(self, expression: str) -> bool:
        """Mini query language: func#name#, code#hex# joined by 'and'/'or'."""
        str_eval = ""
        tokens = re.split(r"\s+(and|or)\s+", expression, flags=re.IGNORECASE)
        for token in tokens:
            if token.lower() in ("and", "or"):
                str_eval += f" {token.lower()} "
                continue
            m = re.match(r"func#([a-zA-Z0-9\s_,(\\)\[\]]+)#", token)
            if m:
                sign_hash = "0x" + __import__(
                    "mythril_tpu_torch.ops.keccak", fromlist=["keccak256"]
                ).keccak256(m.group(1).encode()).hex()[:8]
                str_eval += str(
                    int(sign_hash, 16) in (self.disassembly.func_hashes if self.disassembly else [])
                )
                continue
            m = re.match(r"code#([a-zA-Z0-9\s,\[\]]+)#", token)
            if m:
                str_eval += str(m.group(1).strip() in self.code)
        return bool(eval(str_eval or "False"))  # noqa: S307 - mini-DSL, trusted input
