"""Hand-assembled benchmark contracts: the BECToken batchTransfer shape.

The image carries no solc and the reference mount ships no compiled
BECToken, so the wide "real-shaped" workload is assembled here instruction
by instruction, mirroring the structures solc 0.4 emits for
``/root/reference/solidity_examples/BECToken.sol``:

  * a selector dispatcher over seven public functions,
  * keccak-addressed mapping storage (``balances[addr]`` at
    ``keccak(addr . slot)`` — MSTOREs + SHA3 over scratch memory, exactly
    solc's layout),
  * SafeMath-checked add/sub on every balance move (BECToken.sol:20-30),
  * owner/paused modifiers (``onlyOwner``/``whenNotPaused``,
    BECToken.sol:176-231),
  * and THE bug: ``batchTransfer`` computes ``amount = cnt * _value``
    UNCHECKED (BECToken.sol:257-259, SWC-101 / CVE-2018-10299) before a
    ``cnt``-bounded loop of checked per-receiver credits reading
    ``_receivers[i]`` straight from calldata.

Width comes from where it comes from in real audits: the dispatcher forks
per function, every require forks, the batch loop forks per iteration on
the symbolic ``cnt``, and multi-tx analysis crosses all of it.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from mythril_tpu_torch.support.support_utils import keccak256


def selector(signature: str) -> int:
    return int.from_bytes(keccak256(signature.encode())[:4], "big")


class Asm:
    """Minimal EVM assembler: opcodes, minimal-width PUSH, label fixups."""

    _OPS = {
        "STOP": 0x00, "ADD": 0x01, "MUL": 0x02, "SUB": 0x03, "DIV": 0x04,
        "LT": 0x10, "GT": 0x11, "EQ": 0x14, "ISZERO": 0x15, "AND": 0x16,
        "SHL": 0x1B, "SHR": 0x1C, "SHA3": 0x20, "ADDRESS": 0x30,
        "CALLER": 0x33, "CALLVALUE": 0x34, "CALLDATALOAD": 0x35,
        "CALLDATASIZE": 0x36, "POP": 0x50, "MLOAD": 0x51, "MSTORE": 0x52,
        "SLOAD": 0x54, "SSTORE": 0x55, "JUMP": 0x56, "JUMPI": 0x57,
        "JUMPDEST": 0x5B, "GAS": 0x5A, "CALL": 0xF1, "RETURN": 0xF3,
        "SELFDESTRUCT": 0xFF, "REVERT": 0xFD, "TIMESTAMP": 0x42,
        "STATICCALL": 0xFA, "ORIGIN": 0x32,
    }

    def __init__(self):
        self.out = bytearray()
        self.labels: Dict[str, int] = {}
        self.fixups: List[Tuple[int, str]] = []

    def op(self, *names: str) -> "Asm":
        for name in names:
            if name.startswith("DUP"):
                self.out.append(0x80 + int(name[3:]) - 1)
            elif name.startswith("SWAP"):
                self.out.append(0x90 + int(name[4:]) - 1)
            else:
                self.out.append(self._OPS[name])
        return self

    def push(self, value: int) -> "Asm":
        data = value.to_bytes(max(1, (value.bit_length() + 7) // 8), "big")
        self.out.append(0x60 + len(data) - 1)
        self.out.extend(data)
        return self

    def push_label(self, name: str) -> "Asm":
        self.out.append(0x61)  # PUSH2
        self.fixups.append((len(self.out), name))
        self.out.extend(b"\x00\x00")
        return self

    def label(self, name: str) -> "Asm":
        assert name not in self.labels, name
        self.labels[name] = len(self.out)
        return self.op("JUMPDEST")

    def jump(self, name: str) -> "Asm":
        return self.push_label(name).op("JUMP")

    def jumpi(self, name: str) -> "Asm":
        return self.push_label(name).op("JUMPI")

    def revert(self) -> "Asm":
        return self.push(0).push(0).op("REVERT")

    def assemble(self) -> bytes:
        for pos, name in self.fixups:
            self.out[pos: pos + 2] = self.labels[name].to_bytes(2, "big")
        return bytes(self.out)


# storage layout (solc order for BECToken's inheritance chain)
SLOT_OWNER = 0
SLOT_PAUSED = 1
SLOT_BALANCES = 2  # mapping(address => uint256)
SLOT_ALLOWED = 3  # approval mapping (flattened to one level here)

SEL_BALANCE_OF = selector("balanceOf(address)")
SEL_TRANSFER = selector("transfer(address,uint256)")
SEL_BATCH_TRANSFER = selector("batchTransfer(address[],uint256)")
SEL_APPROVE = selector("approve(address,uint256)")
SEL_TRANSFER_OWNERSHIP = selector("transferOwnership(address)")
SEL_PAUSE = selector("pause()")
SEL_UNPAUSE = selector("unpause()")


def _mapping_slot(a: Asm, slot: int) -> None:
    """key (on stack) -> storage slot keccak(key . slot), solc's layout:
    MSTORE(0, key); MSTORE(32, slot); SHA3(0, 64)."""
    a.push(0).op("MSTORE")
    a.push(slot).push(32).op("MSTORE")
    a.push(64).push(0).op("SHA3")


def _arg(a: Asm, index: int) -> None:
    """Push calldata argument ``index`` (head slot at 4 + 32*index)."""
    a.push(4 + 32 * index).op("CALLDATALOAD")


def _require(a: Asm, ok_label: str) -> None:
    """Branch on the condition on stack; fall-through reverts."""
    a.jumpi(ok_label)
    a.revert()
    a.label(ok_label)


def _only_owner(a: Asm, tag: str) -> None:
    a.push(SLOT_OWNER).op("SLOAD", "CALLER", "EQ")
    _require(a, f"own_{tag}")


def _when_not_paused(a: Asm, tag: str) -> None:
    a.push(SLOT_PAUSED).op("SLOAD", "ISZERO")
    _require(a, f"np_{tag}")


def _return_one(a: Asm) -> None:
    a.push(1).push(0).op("MSTORE").push(32).push(0).op("RETURN")


def bectoken_like() -> bytes:
    """Assemble the BECToken-shaped runtime (see module docstring)."""
    a = Asm()

    # ---- dispatcher: selector = shr(224, calldataload(0)) ----
    a.push(0).op("CALLDATALOAD").push(0xE0).op("SHR")
    for sel, lbl in (
        (SEL_TRANSFER, "transfer"),
        (SEL_BATCH_TRANSFER, "batch"),
        (SEL_BALANCE_OF, "balanceOf"),
        (SEL_APPROVE, "approve"),
        (SEL_TRANSFER_OWNERSHIP, "transferOwnership"),
        (SEL_PAUSE, "pause"),
        (SEL_UNPAUSE, "unpause"),
    ):
        a.op("DUP1").push(sel).op("EQ").jumpi(lbl)
    a.revert()

    # ---- balanceOf(address) ----
    a.label("balanceOf")
    _arg(a, 0)
    _mapping_slot(a, SLOT_BALANCES)
    a.op("SLOAD").push(0).op("MSTORE").push(32).push(0).op("RETURN")

    # ---- transfer(address to, uint256 value) [whenNotPaused, SafeMath] ----
    a.label("transfer")
    _when_not_paused(a, "transfer")
    # require(to != 0)
    _arg(a, 0)
    a.op("ISZERO", "ISZERO")
    _require(a, "t_to")
    # bal = balances[caller]; require(value <= bal)  (SafeMath sub)
    a.op("CALLER")
    _mapping_slot(a, SLOT_BALANCES)
    a.op("DUP1", "SLOAD")  # [slot_c, bal]
    _arg(a, 1)  # [slot_c, bal, value]
    a.op("DUP2", "DUP2", "GT", "ISZERO")  # value <= bal
    _require(a, "t_bal")
    # balances[caller] = bal - value
    a.op("DUP2", "DUP2", "SWAP1", "SUB")  # [slot_c, bal, value, bal-value]
    a.op("DUP4", "SSTORE")  # [slot_c, bal, value]
    # rb = balances[to]; c = rb + value; require(c >= rb) (SafeMath add)
    _arg(a, 0)
    _mapping_slot(a, SLOT_BALANCES)  # [slot_c, bal, value, slot_to]
    a.op("DUP1", "SLOAD")  # [.., slot_to, rb]
    a.op("DUP3", "DUP2", "ADD")  # [.., slot_to, rb, rb+value]
    a.op("DUP1", "DUP3", "GT", "ISZERO")  # rb <= rb+value
    _require(a, "t_add")
    a.op("SWAP1", "POP", "SWAP1", "SSTORE")  # balances[to] = c
    _return_one(a)

    # ---- batchTransfer(address[] receivers, uint256 value) ----
    # THE BUG (BECToken.sol:255-268): amount = cnt * value, UNCHECKED.
    # TRUE solc dynamic-array layout: the first head word holds the byte
    # OFFSET of the array data region, so the length is read through one
    # level of calldata indirection — ``cnt = calldataload(4 +
    # calldataload(4))`` — and element i at ``ptr + 32 + 32*i``.  This is
    # the CVE-2018-10299 shape as solc emits it (resolved by the solver's
    # dynamic select hints / CDCL Ackermann congruence; ROADMAP.md item 1).
    a.label("batch")
    _when_not_paused(a, "batch")
    # ptr = 4 + calldataload(4)   (array data region)
    a.push(4).op("CALLDATALOAD")
    a.push(4).op("ADD")  # [ptr]
    # cnt = calldataload(ptr)     (array length, via indirection)
    a.op("DUP1", "CALLDATALOAD")  # [ptr, cnt]
    _arg(a, 1)  # [ptr, cnt, value]
    # amount = cnt * value   <-- unchecked multiply, SWC-101
    # (stack indices below are all relative to the top; ptr stays parked
    # at the bottom of the frame until the loop body needs it)
    a.op("DUP2", "DUP2", "MUL")  # [ptr, cnt, value, amount]
    # require(cnt > 0 && cnt <= 20)
    a.op("DUP3")
    a.push(0).op("LT")  # 0 < cnt
    _require(a, "b_cnt0")
    a.push(20).op("DUP4", "GT", "ISZERO")  # cnt <= 20
    _require(a, "b_cnt20")
    # require(value > 0)
    a.op("DUP2")
    a.push(0).op("LT")
    _require(a, "b_val")
    # require(balances[caller] >= amount)
    a.op("CALLER")
    _mapping_slot(a, SLOT_BALANCES)  # [ptr, cnt, value, amount, slot_c]
    a.op("DUP1", "SLOAD")  # [ptr, cnt, value, amount, slot_c, bal]
    a.op("DUP1", "DUP4", "GT", "ISZERO")  # not(amount > bal)
    _require(a, "b_bal")
    # balances[caller] = bal - amount
    a.op("DUP3", "SWAP1", "SUB")  # [ptr, cnt, value, amount, slot_c, bal-amount]
    a.op("SWAP1", "SSTORE")  # [ptr, cnt, value, amount]
    a.op("POP")  # [ptr, cnt, value]
    # for (i = 0; i < cnt; i++) balances[receivers[i]] += value (checked)
    a.push(0)  # [ptr, cnt, value, i]
    a.label("b_loop")
    a.op("DUP1", "DUP4", "GT")  # cnt > i
    a.op("ISZERO").jumpi("b_done")
    # receiver = calldataload(ptr + 32 + 32*i)  (element i of the array)
    a.op("DUP1")
    a.push(32).op("MUL")
    a.push(32).op("ADD")  # [ptr, cnt, value, i, 32+32*i]
    a.op("DUP5", "ADD", "CALLDATALOAD")  # [ptr, cnt, value, i, receiver]
    _mapping_slot(a, SLOT_BALANCES)  # [ptr, cnt, value, i, slot_r]
    a.op("DUP1", "SLOAD")  # [ptr, cnt, value, i, slot_r, rb]
    a.op("DUP4", "DUP2", "ADD")  # [.., slot_r, rb, rb+value]
    a.op("DUP1", "DUP3", "GT", "ISZERO")  # rb <= rb+value (SafeMath add)
    _require(a, "b_add")
    a.op("SWAP1", "POP", "SWAP1", "SSTORE")  # balances[receiver] = sum
    a.push(1).op("ADD")  # i++
    a.jump("b_loop")
    a.label("b_done")
    _return_one(a)

    # ---- approve(address spender, uint256 value) ----
    a.label("approve")
    _when_not_paused(a, "approve")
    _arg(a, 1)  # value
    _arg(a, 0)  # spender
    _mapping_slot(a, SLOT_ALLOWED)
    a.op("SSTORE")
    _return_one(a)

    # ---- transferOwnership(address) [onlyOwner] ----
    a.label("transferOwnership")
    _only_owner(a, "xfer")
    _arg(a, 0)
    a.push(SLOT_OWNER).op("SSTORE")
    _return_one(a)

    # ---- pause() / unpause() [onlyOwner] ----
    a.label("pause")
    _only_owner(a, "pause")
    a.push(1).push(SLOT_PAUSED).op("SSTORE")
    _return_one(a)

    a.label("unpause")
    _only_owner(a, "unpause")
    a.push(0).push(SLOT_PAUSED).op("SSTORE")
    _return_one(a)

    return a.assemble()


# ---------------------------------------------------------------------------
# EtherStore: the canonical reentrancy shape
# (/root/reference/solidity_examples/etherstore.sol, SWC-107)
# ---------------------------------------------------------------------------

ES_SLOT_LIMIT = 0  # withdrawalLimit
ES_SLOT_LASTTIME = 1  # mapping(address => uint256) lastWithdrawTime
ES_SLOT_BALANCES = 2  # mapping(address => uint256) balances

SEL_DEPOSIT = selector("depositFunds()")
SEL_WITHDRAW = selector("withdrawFunds(uint256)")


def etherstore_like() -> bytes:
    """EtherStore's withdrawFunds: three requires, then an external CALL to
    ``msg.sender`` carrying value BEFORE the balance decrement — the
    textbook reentrancy window (etherstore.sol:14-24).  Detected as
    SWC-107 (external call to user-supplied address / state change after
    call)."""
    a = Asm()
    a.push(0).op("CALLDATALOAD").push(0xE0).op("SHR")
    for sel, lbl in ((SEL_DEPOSIT, "deposit"), (SEL_WITHDRAW, "withdraw")):
        a.op("DUP1").push(sel).op("EQ").jumpi(lbl)
    a.revert()

    # ---- depositFunds(): balances[caller] += callvalue ----
    a.label("deposit")
    a.op("CALLER")
    _mapping_slot(a, ES_SLOT_BALANCES)  # [slot_b]
    a.op("DUP1", "SLOAD")  # [slot_b, bal]
    a.op("CALLVALUE", "ADD")  # [slot_b, bal+value]  (0.5.0: unchecked +=)
    a.op("SWAP1", "SSTORE")
    a.op("STOP")

    # ---- withdrawFunds(uint256 amt) ----
    a.label("withdraw")
    _arg(a, 0)  # [amt]
    # require(balances[caller] >= amt)
    a.op("CALLER")
    _mapping_slot(a, ES_SLOT_BALANCES)  # [amt, slot_b]
    a.op("DUP1", "SLOAD")  # [amt, slot_b, bal]
    a.op("DUP3", "GT", "ISZERO")  # not(amt > bal)
    _require(a, "w_bal")  # [amt, slot_b]
    # require(amt <= withdrawalLimit)
    a.push(ES_SLOT_LIMIT).op("SLOAD")  # [amt, slot_b, limit]
    a.op("DUP3", "GT", "ISZERO")  # not(amt > limit)
    _require(a, "w_lim")  # [amt, slot_b]
    # require(now >= lastWithdrawTime[caller] + 1 weeks)
    a.op("CALLER")
    _mapping_slot(a, ES_SLOT_LASTTIME)
    a.op("SLOAD")  # [amt, slot_b, last]
    a.push(604800).op("ADD")  # [amt, slot_b, last+1w]
    a.op("TIMESTAMP", "LT", "ISZERO")  # not(now < last+1w)
    _require(a, "w_time")  # [amt, slot_b]
    # caller.call.value(amt)("") — the reentrancy window
    a.push(0).push(0).push(0).push(0)  # out_sz out_off in_sz in_off
    a.op("DUP6")  # value = amt
    a.op("CALLER", "GAS", "CALL")  # [amt, slot_b, success]
    _require(a, "w_ok")  # [amt, slot_b]
    # balances[caller] -= amt   (STATE CHANGE AFTER THE CALL)
    a.op("DUP1", "SLOAD")  # [amt, slot_b, bal]
    a.op("DUP3", "SWAP1", "SUB")  # [amt, slot_b, bal-amt]
    a.op("DUP2", "SSTORE")  # [amt, slot_b]
    # lastWithdrawTime[caller] = now
    a.op("TIMESTAMP", "CALLER")  # [amt, slot_b, ts, caller]
    _mapping_slot(a, ES_SLOT_LASTTIME)  # [amt, slot_b, ts, slot_t]
    a.op("SSTORE")
    a.op("STOP")
    return a.assemble()


# ---------------------------------------------------------------------------
# Rubixi: the constructor-name ownership takeover
# (/root/reference/solidity_examples/rubixi.sol, SWC-105 via dynamicPyramid)
# ---------------------------------------------------------------------------

RX_SLOT_FEES = 1  # collectedFees
RX_SLOT_CREATOR = 5  # creator

SEL_DYNAMIC_PYRAMID = selector("dynamicPyramid()")
SEL_COLLECT_ALL = selector("collectAllFees()")


def rubixi_like() -> bytes:
    """Rubixi's famous bug: ``dynamicPyramid()`` was the constructor name
    of an earlier revision, left public and unguarded (rubixi.sol:29-31) —
    anyone calls it to become ``creator`` and then drains fees through
    ``collectAllFees`` (rubixi.sol:36-40).  Detected as SWC-105
    (unprotected ether withdrawal: 2-tx takeover then drain)."""
    a = Asm()
    a.push(0).op("CALLDATALOAD").push(0xE0).op("SHR")
    for sel, lbl in (
        (SEL_DYNAMIC_PYRAMID, "pyramid"),
        (SEL_COLLECT_ALL, "collect"),
    ):
        a.op("DUP1").push(sel).op("EQ").jumpi(lbl)
    # fallback: init() — collectedFees += callvalue / 10
    a.push(RX_SLOT_FEES).op("SLOAD")  # [fees]
    a.push(10).op("CALLVALUE", "DIV", "ADD")  # [fees + value/10]
    a.push(RX_SLOT_FEES).op("SSTORE")
    a.op("STOP")

    # ---- dynamicPyramid(): creator = msg.sender  (NO GUARD — the bug) ----
    a.label("pyramid")
    a.op("CALLER")
    a.push(RX_SLOT_CREATOR).op("SSTORE")
    a.op("STOP")

    # ---- collectAllFees() [onlyowner]: creator.transfer(collectedFees) ----
    a.label("collect")
    a.push(RX_SLOT_CREATOR).op("SLOAD", "CALLER", "EQ")
    _require(a, "c_own")
    a.push(RX_SLOT_FEES).op("SLOAD")  # [fees]
    a.op("DUP1")
    a.push(0).op("LT")  # 0 < fees
    _require(a, "c_pos")  # [fees]
    a.push(0).push(0).push(0).push(0)
    a.op("DUP5")  # value = fees
    a.push(RX_SLOT_CREATOR).op("SLOAD")  # to = creator
    a.op("GAS", "CALL")  # [fees, success]
    _require(a, "c_ok")
    a.push(0).push(RX_SLOT_FEES).op("SSTORE")  # collectedFees = 0
    a.op("STOP")
    return a.assemble()
