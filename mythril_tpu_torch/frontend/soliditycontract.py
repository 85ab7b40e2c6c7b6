"""Solidity frontend: compile .sol files via solc standard-json.

Reference parity: mythril/solidity/soliditycontract.py:80-150 and
mythril/ethereum/util.py:38-70 — SolidityContract carries runtime+creation
bytecode and source maps (incl. solc generatedSources).
"""

from __future__ import annotations

import json
import os
import subprocess
from typing import Dict, List, Optional

from mythril_tpu_torch.exceptions import CompilerError, NoContractFoundError
from mythril_tpu_torch.frontend.evmcontract import EVMContract


class SolcSource:
    def __init__(self, filename: str, code: str):
        self.filename = filename
        self.code = code
        self.lines = code.splitlines()


class SourceCodeInfo:
    def __init__(self, filename, lineno, code, solidity_file_idx=0):
        self.filename = filename
        self.lineno = lineno
        self.code = code
        self.solidity_file_idx = solidity_file_idx


def get_solc_json(file_path: str, solc_binary: str = "solc", solc_settings_json: Optional[str] = None) -> Dict:
    """Compile via solc --standard-json (reference ethereum/util.py:38-70)."""
    with open(file_path) as f:
        source = f.read()
    settings = {
        "optimizer": {"enabled": False},
        "outputSelection": {
            "*": {
                "*": [
                    "evm.bytecode.object",
                    "evm.deployedBytecode.object",
                    "evm.deployedBytecode.sourceMap",
                    "evm.bytecode.sourceMap",
                    "abi",
                ]
            }
        },
    }
    if solc_settings_json:
        with open(solc_settings_json) as f:
            settings.update(json.load(f))
    standard_input = {
        "language": "Solidity",
        "sources": {file_path: {"content": source}},
        "settings": settings,
    }
    try:
        proc = subprocess.run(
            [solc_binary, "--standard-json", "--allow-paths", "."],
            input=json.dumps(standard_input).encode(),
            capture_output=True,
            check=False,
        )
    except FileNotFoundError as e:
        raise CompilerError(
            f"Compiler not found: {solc_binary}. Install solc or pass --solc-binary."
        ) from e
    if not proc.stdout:
        raise CompilerError(
            f"solc produced no output (exit {proc.returncode}): "
            f"{proc.stderr.decode(errors='replace')[:500]}"
        )
    out = json.loads(proc.stdout)
    for err in out.get("errors", []):
        if err.get("severity") == "error":
            raise CompilerError(err.get("formattedMessage", str(err)))
    return out


class SolidityContract(EVMContract):
    def __init__(
        self,
        input_file: str,
        name: Optional[str] = None,
        solc_settings_json: Optional[str] = None,
        solc_binary: str = "solc",
    ):
        solc_json = get_solc_json(input_file, solc_binary, solc_settings_json)
        self.solc_json = solc_json
        self.input_file = input_file
        self.solidity_files = [
            SolcSource(input_file, open(input_file).read())
        ]

        contracts = solc_json.get("contracts", {}).get(input_file, {})
        if not contracts:
            raise NoContractFoundError(f"no contract found in {input_file}")

        picked = None
        if name:
            if name not in contracts:
                raise NoContractFoundError(f"contract {name} not found in {input_file}")
            picked = (name, contracts[name])
        else:
            # last contract with non-empty runtime code (reference behavior)
            for cname, data in contracts.items():
                if data.get("evm", {}).get("deployedBytecode", {}).get("object"):
                    picked = (cname, data)
        if picked is None:
            raise NoContractFoundError(f"no deployable contract in {input_file}")

        cname, data = picked
        code = data["evm"]["deployedBytecode"]["object"]
        creation_code = data["evm"]["bytecode"]["object"]
        self.source_map = data["evm"]["deployedBytecode"].get("sourceMap", "")
        self.creation_source_map = data["evm"]["bytecode"].get("sourceMap", "")
        super().__init__(code=code, creation_code=creation_code, name=cname)

    def get_source_info(self, address: int, constructor: bool = False) -> Optional[SourceCodeInfo]:
        """Bytecode address -> source line (solc source maps, reference :140-175)."""
        srcmap = self.creation_source_map if constructor else self.source_map
        disassembly = self.creation_disassembly if constructor else self.disassembly
        if not srcmap or disassembly is None:
            return None
        index = disassembly.index_of_address(address)
        if index is None:
            return None
        entries = srcmap.split(";")
        s = length = f = -1
        for i, entry in enumerate(entries):
            fields = entry.split(":")
            if len(fields) > 0 and fields[0]:
                s = int(fields[0])
            if len(fields) > 1 and fields[1]:
                length = int(fields[1])
            if len(fields) > 2 and fields[2]:
                f = int(fields[2])
            if i == index:
                break
        if s < 0 or f < 0:
            return None
        source = self.solidity_files[0]
        code = source.code[s : s + length]
        lineno = source.code[:s].count("\n") + 1
        return SourceCodeInfo(source.filename, lineno, code, 0)


def get_contracts_from_file(input_file: str, solc_settings_json=None, solc_binary="solc") -> List[SolidityContract]:
    """All deployable contracts in a file (reference soliditycontract.py:50)."""
    solc_json = get_solc_json(input_file, solc_binary, solc_settings_json)
    contracts = solc_json.get("contracts", {}).get(input_file, {})
    out = []
    for cname, data in contracts.items():
        if data.get("evm", {}).get("deployedBytecode", {}).get("object"):
            out.append(
                SolidityContract(
                    input_file,
                    name=cname,
                    solc_settings_json=solc_settings_json,
                    solc_binary=solc_binary,
                )
            )
    return out
