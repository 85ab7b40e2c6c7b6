"""Typed schema for the concolic JSON input (reference parity: concolic/concrete_data.py:1-34)."""

from __future__ import annotations

from typing import Dict, List, TypedDict


class AccountData(TypedDict):
    balance: str
    code: str
    nonce: int
    storage: Dict[str, str]


class InitialState(TypedDict):
    accounts: Dict[str, AccountData]


class TransactionData(TypedDict):
    address: str
    blockCoinbase: str
    blockDifficulty: str
    blockGasLimit: str
    blockNumber: str
    blockTime: str
    gasLimit: str
    gasPrice: str
    input: str
    origin: str
    value: str


class ConcreteData(TypedDict):
    initialState: InitialState
    steps: List[TransactionData]
