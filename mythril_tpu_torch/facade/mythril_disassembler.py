"""Disassembler facade: load contracts from bytecode / address / solidity.

Reference parity: mythril/mythril/mythril_disassembler.py:26-318 — including
the on-chain storage-slot reader with mapping-slot keccak math and the solc
>= 0.8 integer-module toggle.
"""

from __future__ import annotations

import logging
import re
from typing import List, Optional, Tuple

from mythril_tpu_torch.exceptions import CriticalError
from mythril_tpu_torch.frontend.evmcontract import EVMContract
from mythril_tpu_torch.frontend.soliditycontract import SolidityContract, get_contracts_from_file
from mythril_tpu_torch.ops.keccak import keccak256
from mythril_tpu_torch.support.loader import DynLoader
from mythril_tpu_torch.support.signatures import SignatureDB
from mythril_tpu_torch.support.support_args import args

log = logging.getLogger(__name__)


class MythrilDisassembler:
    def __init__(
        self,
        eth=None,
        solc_version: Optional[str] = None,
        solc_settings_json: Optional[str] = None,
        enable_online_lookup: bool = False,
    ):
        self.eth = eth
        self.solc_binary = self._init_solc_binary(solc_version)
        self.solc_settings_json = solc_settings_json
        self.enable_online_lookup = enable_online_lookup
        self.sigs = SignatureDB(enable_online_lookup=enable_online_lookup)
        self.contracts: List[EVMContract] = []

    @staticmethod
    def _init_solc_binary(version: Optional[str]) -> str:
        """Pick the solc binary; versioned binaries are expected on PATH as
        solc-vX.Y.Z (py-solc-x style management is unavailable offline)."""
        if not version:
            return "solc"
        if version.startswith("v"):
            version = version[1:]
        candidate = f"solc-v{version}"
        import shutil

        if shutil.which(candidate):
            return candidate
        log.warning("versioned solc %s not found; falling back to `solc`", candidate)
        return "solc"

    def load_from_bytecode(
        self, code: str, bin_runtime: bool = False, address: Optional[str] = None
    ) -> Tuple[str, EVMContract]:
        if address is None:
            address = "0x" + "0" * 38 + "06"
        code = code.replace("0x", "")
        if bin_runtime:
            contract = EVMContract(
                code=code, name="MAIN", enable_online_lookup=self.enable_online_lookup
            )
        else:
            contract = EVMContract(
                creation_code=code, name="MAIN", enable_online_lookup=self.enable_online_lookup
            )
        self.contracts.append(contract)
        self._refresh_integer_module()
        return address, contract

    def load_from_address(self, address: str) -> Tuple[str, EVMContract]:
        if not re.match(r"0x[a-fA-F0-9]{40}", address):
            raise CriticalError("invalid contract address")
        if self.eth is None:
            raise CriticalError(
                "please set an RPC provider (--rpc) to load contracts from the chain"
            )
        code = self.eth.eth_getCode(address)
        if not code or code == "0x":
            raise CriticalError("no code at the given address")
        contract = EVMContract(
            code=code[2:], name=address, enable_online_lookup=self.enable_online_lookup
        )
        self.contracts.append(contract)
        self._refresh_integer_module()
        return address, contract

    def load_from_solidity(
        self, solidity_files: List[str]
    ) -> Tuple[str, List[SolidityContract]]:
        address = "0x" + "0" * 38 + "06"
        contracts = []
        for file in solidity_files:
            if ":" in file:
                file_path, contract_name = file.rsplit(":", 1)
            else:
                file_path, contract_name = file, None
            if contract_name:
                contract = SolidityContract(
                    file_path,
                    name=contract_name,
                    solc_settings_json=self.solc_settings_json,
                    solc_binary=self.solc_binary,
                )
                contracts.append(contract)
            else:
                contracts.extend(
                    get_contracts_from_file(
                        file_path,
                        solc_settings_json=self.solc_settings_json,
                        solc_binary=self.solc_binary,
                    )
                )
        self.contracts.extend(contracts)
        self._refresh_integer_module()
        return address, contracts

    def _refresh_integer_module(self) -> None:
        """Re-derive args.use_integer_module over ALL queued contracts.

        solc >= 0.8 has checked arithmetic: disable the integer module only
        when EVERY contract queued on this disassembler (the analyzer runs
        them all) provably targets >= 0.8.  A contract without a readable
        pragma — including raw bytecode and on-chain loads — counts as
        unknown, keeping the module enabled.
        """
        pragmas = []
        for contract in self.contracts:
            files = getattr(contract, "solidity_files", None)
            source = files[0].code if files else ""
            pragma = re.search(r"pragma solidity\s+[^0-9]*0\.([0-9]+)", source)
            pragmas.append(int(pragma.group(1)) if pragma else 0)
        args.use_integer_module = not (pragmas and all(p >= 8 for p in pragmas))

    def get_state_variable_from_storage(self, address: str, params: List[str]) -> str:
        """Read storage slots, incl. mapping/array math (reference :200-318)."""
        (position, length, mappings) = (0, 1, [])
        out = ""
        try:
            if params[0] == "mapping":
                if len(params) < 3:
                    raise CriticalError("mapping requires: mapping <position> <key1> [...]")
                position = int(params[1])
                for key in params[2:]:
                    mappings.append(int(key, 0))
                position_formatted = position.to_bytes(32, "big")
                for mapping_idx in mappings:
                    key_formatted = mapping_idx.to_bytes(32, "big")
                    slot = int.from_bytes(
                        keccak256(key_formatted + position_formatted), "big"
                    )
                    value = self.eth.eth_getStorageAt(address, slot)
                    out += f"{hex(slot)}: {value}\n"
                return out
            position = int(params[0])
            if len(params) >= 2:
                length = int(params[1])
            if len(params) == 3 and params[2] == "array":
                position_formatted = position.to_bytes(32, "big")
                base = int.from_bytes(keccak256(position_formatted), "big")
                for i in range(length):
                    value = self.eth.eth_getStorageAt(address, base + i)
                    out += f"{hex(base + i)}: {value}\n"
                return out
            for i in range(position, position + length):
                value = self.eth.eth_getStorageAt(address, i)
                out += f"{i}: {value}\n"
            return out
        except ValueError as e:
            raise CriticalError(f"invalid storage index: {e}") from e
