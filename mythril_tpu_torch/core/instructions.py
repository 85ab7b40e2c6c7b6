"""Symbolic semantics for every EVM opcode.

Reference parity: mythril/laser/ethereum/instructions.py (2,476 LoC) — one
handler per opcode mutating a forked GlobalState; the ``StateTransition``
decorator copies the state, accumulates gas bounds, advances the pc and
enforces STATICCALL write protection (reference :96-200).  ``jumpi_`` is the
path-forking point (reference :1557-1633); CALL-family handlers raise
TransactionStartSignal and resume through ``*_post`` handlers
(reference :1959-2335).

Design deltas from the reference (TPU-first):
  * comparisons push ``If(cond, 1, 0)`` words whose conditions stay word-level
    terms the probe evaluates in batch;
  * EXP is a first-class ``bvexp`` term (no Power-UF axioms);
  * SHA3 of concrete-length memory produces a real ``keccak`` term evaluated
    concretely by every backend (no interval axioms).
"""

from __future__ import annotations

import copy as _copy
import logging
from typing import Callable, List, Optional, Union

from mythril_tpu_torch.core import util
from mythril_tpu_torch.core.evm_exceptions import (
    InvalidInstruction,
    InvalidJumpDestination,
    OutOfGasException,
    StackUnderflowException,
    VmException,
    WriteProtection,
)
from mythril_tpu_torch.core.instruction_data import (
    GAS_CALLSTIPEND,
    calculate_native_gas,
    calculate_sha3_gas,
    get_opcode_gas,
)
from mythril_tpu_torch.core.state.calldata import ConcreteCalldata, SymbolicCalldata
from mythril_tpu_torch.core.state.global_state import GlobalState
from mythril_tpu_torch.core.transaction.transaction_models import (
    ContractCreationTransaction,
    MessageCallTransaction,
    TransactionEndSignal,
    TransactionStartSignal,
)
from mythril_tpu_torch.smt import (
    And,
    BitVec,
    Bool,
    Concat,
    Exp,
    Extract,
    If,
    Keccak,
    LShR,
    Not,
    Or,
    SDiv,
    SignExt,
    SRem,
    UDiv,
    UGE,
    UGT,
    ULE,
    ULT,
    URem,
    ZeroExt,
    symbol_factory,
)
from mythril_tpu_torch.support.support_args import args

log = logging.getLogger(__name__)

TT256 = 2**256
TT256M1 = 2**256 - 1


def _as_bool(word: BitVec) -> Bool:
    """EVM truthiness: any nonzero word."""
    return word != symbol_factory.BitVecVal(0, word.size())


def _bool_word(cond: Bool) -> BitVec:
    return If(cond, symbol_factory.BitVecVal(1, 256), symbol_factory.BitVecVal(0, 256))


def transfer_ether(global_state: GlobalState, sender: BitVec, receiver: BitVec, value: BitVec):
    """Constrained balance transfer (reference instructions.py:72-93)."""
    value = value if isinstance(value, BitVec) else symbol_factory.BitVecVal(value, 256)
    global_state.world_state.constraints.append(
        UGE(global_state.world_state.balances[sender], value)
    )
    global_state.world_state.balances[receiver] += value
    global_state.world_state.balances[sender] -= value


class StateTransition:
    """Handler decorator: fork the state, meter gas, advance the pc."""

    def __init__(
        self,
        increment_pc: bool = True,
        enable_gas: bool = True,
        is_state_mutation_instruction: bool = False,
    ):
        self.increment_pc = increment_pc
        self.enable_gas = enable_gas
        self.is_state_mutation_instruction = is_state_mutation_instruction

    def __call__(self, func: Callable) -> Callable:
        def wrapper(instr_obj, global_state: GlobalState):
            if self.is_state_mutation_instruction and global_state.environment.static:
                raise WriteProtection(
                    f"cannot execute {func.__name__} inside a static call"
                )
            new_state = _copy.copy(global_state)
            old_pc = new_state.mstate.pc
            states = func(instr_obj, new_state)
            # gas accrues on the successors AFTER the handler ran (reference
            # instructions.py:192-195): terminal ops end the transaction from
            # inside the handler and so never charge their own opcode gas,
            # and OOG surfaces on the instruction *after* the budget is blown
            if self.enable_gas:
                gmin, gmax = get_opcode_gas(instr_obj.op_code)
                for s in states:
                    s.mstate.min_gas_used += gmin
                    s.mstate.max_gas_used += gmax
                    s.mstate.check_gas()
            if self.increment_pc:
                for s in states:
                    if s.mstate.pc == old_pc:
                        s.mstate.pc += 1
            return states

        wrapper.__name__ = func.__name__
        return wrapper


class Instruction:
    """Executable semantics for one opcode occurrence.

    Reference parity: Instruction.evaluate dynamic dispatch to ``<op>_`` /
    ``<op>_post`` (reference instructions.py:233-265).
    """

    def __init__(
        self,
        op_code: str,
        dynamic_loader=None,
        pre_hooks: Optional[List[Callable]] = None,
        post_hooks: Optional[List[Callable]] = None,
    ):
        self.op_code = op_code.upper()
        self.dynamic_loader = dynamic_loader
        self.pre_hook = pre_hooks or []
        self.post_hook = post_hooks or []

    def evaluate(self, global_state: GlobalState, post: bool = False) -> List[GlobalState]:
        op = self.op_code.lower()
        if op.startswith("push") and op != "push0":
            op = "push"
        elif op == "push0":
            op = "push0"
        elif op.startswith("dup"):
            op = "dup"
        elif op.startswith("swap"):
            op = "swap"
        elif op.startswith("log"):
            op = "log"
        elif op == "keccak256":
            op = "sha3"
        elif op == "prevrandao":
            op = "difficulty"
        handler_name = op + ("_post" if post else "_")
        handler = getattr(self, handler_name, None)
        if handler is None:
            raise NotImplementedError(f"no semantics for opcode {self.op_code}")
        for hook in self.pre_hook:
            hook(global_state)
        result = handler(global_state)
        for hook in self.post_hook:
            for s in result:
                hook(s)
        return result

    # ==================================================================
    # stack / constants
    # ==================================================================

    @StateTransition()
    def push_(self, global_state: GlobalState) -> List[GlobalState]:
        instr = global_state.get_current_instruction()
        value = int(instr["argument"], 16)
        global_state.mstate.stack.append(symbol_factory.BitVecVal(value, 256))
        return [global_state]

    @StateTransition()
    def push0_(self, global_state: GlobalState) -> List[GlobalState]:
        global_state.mstate.stack.append(symbol_factory.BitVecVal(0, 256))
        return [global_state]

    @StateTransition()
    def dup_(self, global_state: GlobalState) -> List[GlobalState]:
        n = int(self.op_code[3:])
        global_state.mstate.stack.append(global_state.mstate.stack[-n])
        return [global_state]

    @StateTransition()
    def swap_(self, global_state: GlobalState) -> List[GlobalState]:
        n = int(self.op_code[4:])
        stack = global_state.mstate.stack
        stack[-1], stack[-n - 1] = stack[-n - 1], stack[-1]
        return [global_state]

    @StateTransition()
    def pop_(self, global_state: GlobalState) -> List[GlobalState]:
        global_state.mstate.stack.pop()
        return [global_state]

    # ==================================================================
    # arithmetic
    # ==================================================================

    @StateTransition()
    def add_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate.stack
        a, b = s.pop(), s.pop()
        s.append(a + b)
        return [global_state]

    @StateTransition()
    def sub_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate.stack
        a, b = s.pop(), s.pop()
        s.append(a - b)
        return [global_state]

    @StateTransition()
    def mul_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate.stack
        a, b = s.pop(), s.pop()
        s.append(a * b)
        return [global_state]

    @StateTransition()
    def div_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate.stack
        a, b = s.pop(), s.pop()
        s.append(UDiv(a, b))
        return [global_state]

    @StateTransition()
    def sdiv_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate.stack
        a, b = s.pop(), s.pop()
        s.append(SDiv(a, b))
        return [global_state]

    @StateTransition()
    def mod_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate.stack
        a, b = s.pop(), s.pop()
        s.append(URem(a, b))
        return [global_state]

    @StateTransition()
    def smod_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate.stack
        a, b = s.pop(), s.pop()
        s.append(SRem(a, b))
        return [global_state]

    @StateTransition()
    def addmod_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate.stack
        a, b, m = s.pop(), s.pop(), s.pop()
        wide = URem(ZeroExt(256, a) + ZeroExt(256, b), ZeroExt(256, m))
        s.append(Extract(255, 0, wide))
        return [global_state]

    @StateTransition()
    def mulmod_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate.stack
        a, b, m = s.pop(), s.pop(), s.pop()
        wide = URem(ZeroExt(256, a) * ZeroExt(256, b), ZeroExt(256, m))
        s.append(Extract(255, 0, wide))
        return [global_state]

    @StateTransition()
    def exp_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate.stack
        base, exponent = s.pop(), s.pop()
        s.append(Exp(base, exponent))
        return [global_state]

    @StateTransition()
    def signextend_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate.stack
        b, x = s.pop(), s.pop()
        if b.value is not None:
            if b.value >= 31:
                s.append(x)
            else:
                bits = 8 * (b.value + 1)
                s.append(SignExt(256 - bits, Extract(bits - 1, 0, x)))
            return [global_state]
        result = x
        for i in range(31):
            bits = 8 * (i + 1)
            result = If(
                b == symbol_factory.BitVecVal(i, 256),
                SignExt(256 - bits, Extract(bits - 1, 0, x)),
                result,
            )
        s.append(result)
        return [global_state]

    # ==================================================================
    # comparison & bitwise
    # ==================================================================

    @StateTransition()
    def lt_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate.stack
        a, b = s.pop(), s.pop()
        s.append(_bool_word(ULT(a, b)))
        return [global_state]

    @StateTransition()
    def gt_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate.stack
        a, b = s.pop(), s.pop()
        s.append(_bool_word(UGT(a, b)))
        return [global_state]

    @StateTransition()
    def slt_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate.stack
        a, b = s.pop(), s.pop()
        s.append(_bool_word(a < b))
        return [global_state]

    @StateTransition()
    def sgt_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate.stack
        a, b = s.pop(), s.pop()
        s.append(_bool_word(a > b))
        return [global_state]

    @StateTransition()
    def eq_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate.stack
        a, b = s.pop(), s.pop()
        s.append(_bool_word(a == b))
        return [global_state]

    @StateTransition()
    def iszero_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate.stack
        a = s.pop()
        s.append(_bool_word(a == symbol_factory.BitVecVal(0, 256)))
        return [global_state]

    @StateTransition()
    def and_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate.stack
        a, b = s.pop(), s.pop()
        s.append(a & b)
        return [global_state]

    @StateTransition()
    def or_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate.stack
        a, b = s.pop(), s.pop()
        s.append(a | b)
        return [global_state]

    @StateTransition()
    def xor_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate.stack
        a, b = s.pop(), s.pop()
        s.append(a ^ b)
        return [global_state]

    @StateTransition()
    def not_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate.stack
        s.append(~s.pop())
        return [global_state]

    @StateTransition()
    def byte_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate.stack
        index, word = s.pop(), s.pop()
        if index.value is not None:
            if index.value >= 32:
                s.append(symbol_factory.BitVecVal(0, 256))
            else:
                lo = 8 * (31 - index.value)
                s.append(ZeroExt(248, Extract(lo + 7, lo, word)))
            return [global_state]
        shift = (symbol_factory.BitVecVal(31, 256) - index) * 8
        result = If(
            ULT(index, symbol_factory.BitVecVal(32, 256)),
            LShR(word, shift) & symbol_factory.BitVecVal(0xFF, 256),
            symbol_factory.BitVecVal(0, 256),
        )
        s.append(result)
        return [global_state]

    @StateTransition()
    def shl_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate.stack
        shift, value = s.pop(), s.pop()
        s.append(value << shift)
        return [global_state]

    @StateTransition()
    def shr_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate.stack
        shift, value = s.pop(), s.pop()
        s.append(LShR(value, shift))
        return [global_state]

    @StateTransition()
    def sar_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate.stack
        shift, value = s.pop(), s.pop()
        s.append(value >> shift)
        return [global_state]

    # ==================================================================
    # sha3
    # ==================================================================

    @StateTransition()
    def sha3_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate.stack
        offset, length = s.pop(), s.pop()
        mstate = global_state.mstate
        if length.value is not None:
            size = length.value
            if size > 0:
                gmin, gmax = calculate_sha3_gas(size)
                mstate.min_gas_used += gmin
                mstate.max_gas_used += gmax
                mstate.check_gas()
            if offset.value is not None:
                mstate.mem_extend(offset.value, size)
            if size == 0:
                data = None
                result = symbol_factory.BitVecVal(
                    0xC5D2460186F7233C927E7DB2DCC703C0E500B653CA82273B7BFAD8045D85A470, 256
                )
            else:
                parts = [mstate.memory.get_byte(offset + i) for i in range(size)]
                data = Concat(*parts) if len(parts) > 1 else parts[0]
                result = Keccak(data)
        else:
            # symbolic length: fresh data symbol, hash stays invertible for the
            # probe through concrete evaluation of the keccak op
            data = global_state.new_bitvec(
                f"keccak_input_pc{mstate.pc}", 512
            )
            result = Keccak(data)
        s.append(result)
        return [global_state]

    # ==================================================================
    # environment
    # ==================================================================

    @StateTransition()
    def address_(self, global_state: GlobalState) -> List[GlobalState]:
        global_state.mstate.stack.append(global_state.environment.address)
        return [global_state]

    @StateTransition()
    def balance_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate.stack
        address = s.pop()
        s.append(global_state.world_state.balances[address])
        return [global_state]

    @StateTransition()
    def origin_(self, global_state: GlobalState) -> List[GlobalState]:
        global_state.mstate.stack.append(global_state.environment.origin)
        return [global_state]

    @StateTransition()
    def caller_(self, global_state: GlobalState) -> List[GlobalState]:
        global_state.mstate.stack.append(global_state.environment.sender)
        return [global_state]

    @StateTransition()
    def callvalue_(self, global_state: GlobalState) -> List[GlobalState]:
        global_state.mstate.stack.append(global_state.environment.callvalue)
        return [global_state]

    @StateTransition()
    def calldataload_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate.stack
        offset = s.pop()
        s.append(global_state.environment.calldata.get_word_at(offset))
        return [global_state]

    @StateTransition()
    def calldatasize_(self, global_state: GlobalState) -> List[GlobalState]:
        global_state.mstate.stack.append(global_state.environment.calldata.calldatasize)
        return [global_state]

    @StateTransition()
    def calldatacopy_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate.stack
        dest, offset, size = s.pop(), s.pop(), s.pop()
        mstate = global_state.mstate
        calldata = global_state.environment.calldata
        if size.value is not None:
            n = min(size.value, 0x10000)
            if dest.value is not None:
                mstate.mem_extend(dest.value, n)
            for i in range(n):
                mstate.memory.set_byte(dest + i, calldata[offset + i] if offset.value is None else calldata[offset.value + i])
        else:
            # symbolic size: approximate with fresh bytes over one word
            for i in range(32):
                mstate.memory.set_byte(
                    dest + i, global_state.new_bitvec(f"calldatacopy_{mstate.pc}_{i}", 8)
                )
        return [global_state]

    @StateTransition()
    def codesize_(self, global_state: GlobalState) -> List[GlobalState]:
        code = global_state.environment.code
        no_of_bytes = len(code.bytecode)
        if isinstance(
            global_state.current_transaction, ContractCreationTransaction
        ):
            # constructor arguments live AFTER the creation code; model them
            # as the tx calldata appended past the code end (reference
            # instructions.py:980-989): concrete calldata extends CODESIZE
            # by its real length, symbolic calldata by 16 32-byte argument
            # slots with the size pinned so bounds checks in solc's arg
            # decoder are decidable
            calldata = global_state.environment.calldata
            if isinstance(calldata, ConcreteCalldata):
                no_of_bytes += calldata.size
            else:
                no_of_bytes += 0x200
                global_state.world_state.constraints.append(
                    calldata.calldatasize
                    == symbol_factory.BitVecVal(no_of_bytes, 256)
                )
        global_state.mstate.stack.append(
            symbol_factory.BitVecVal(no_of_bytes, 256)
        )
        return [global_state]

    def _copy_code_to_memory(
        self, global_state, code_bytes: bytes, dest, offset, size,
        overflow_calldata=None,
    ):
        """``overflow_calldata``: creation-tx constructor-argument model —
        reads past the code end route to the transaction calldata at the
        shifted offset (reference instructions.py:1080-1101) instead of
        zero-padding, so symbolic constructor arguments work."""
        mstate = global_state.mstate
        if size.value is None:
            for i in range(32):
                mstate.memory.set_byte(
                    dest + i, global_state.new_bitvec(f"codecopy_{mstate.pc}_{i}", 8)
                )
            return
        n = min(size.value, 0x20000)
        if dest.value is not None:
            mstate.mem_extend(dest.value, n)
        start = offset.value
        for i in range(n):
            if start is not None:
                if start + i < len(code_bytes):
                    b = code_bytes[start + i]
                elif overflow_calldata is not None:
                    b = overflow_calldata[start + i - len(code_bytes)]
                else:
                    b = 0
                mstate.memory.set_byte(dest + i, b)
            else:
                mstate.memory.set_byte(
                    dest + i, global_state.new_bitvec(f"codecopy_{mstate.pc}_{i}", 8)
                )

    @StateTransition()
    def codecopy_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate.stack
        dest, offset, size = s.pop(), s.pop(), s.pop()
        code = global_state.environment.code.bytecode
        overflow = None
        if isinstance(
            global_state.current_transaction, ContractCreationTransaction
        ):
            # constructor args follow the creation code (see codesize_)
            overflow = global_state.environment.calldata
        self._copy_code_to_memory(
            global_state, code, dest, offset, size, overflow_calldata=overflow
        )
        return [global_state]

    @StateTransition()
    def gasprice_(self, global_state: GlobalState) -> List[GlobalState]:
        global_state.mstate.stack.append(global_state.environment.gasprice)
        return [global_state]

    @StateTransition()
    def basefee_(self, global_state: GlobalState) -> List[GlobalState]:
        global_state.mstate.stack.append(global_state.environment.basefee)
        return [global_state]

    @StateTransition()
    def extcodesize_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate.stack
        address = s.pop()
        if address.value is not None:
            acct = global_state.world_state.accounts.get(address.value)
            if acct is not None and acct.code is not None:
                s.append(symbol_factory.BitVecVal(len(acct.code.bytecode), 256))
                return [global_state]
            if self.dynamic_loader is not None and getattr(self.dynamic_loader, "active", False):
                code = self.dynamic_loader.dynld(f"0x{address.value:040x}")
                if code:
                    s.append(symbol_factory.BitVecVal(len(code.bytecode), 256))
                    return [global_state]
        s.append(global_state.new_bitvec(f"extcodesize_{address.raw.tid}", 256))
        return [global_state]

    @StateTransition()
    def extcodecopy_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate.stack
        address, dest, offset, size = s.pop(), s.pop(), s.pop(), s.pop()
        code_bytes = b""
        if address.value is not None:
            acct = global_state.world_state.accounts.get(address.value)
            if acct is not None and acct.code is not None:
                code_bytes = acct.code.bytecode
        self._copy_code_to_memory(global_state, code_bytes, dest, offset, size)
        return [global_state]

    @StateTransition()
    def extcodehash_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate.stack
        address = s.pop()
        if address.value is not None:
            acct = global_state.world_state.accounts.get(address.value)
            if acct is not None and acct.code is not None:
                from mythril_tpu_torch.ops.keccak import keccak256

                h = int.from_bytes(keccak256(acct.code.bytecode), "big")
                s.append(symbol_factory.BitVecVal(h, 256))
                return [global_state]
        s.append(global_state.new_bitvec(f"extcodehash_{address.raw.tid}", 256))
        return [global_state]

    @StateTransition()
    def returndatasize_(self, global_state: GlobalState) -> List[GlobalState]:
        data = global_state.last_return_data
        if data is None:
            global_state.mstate.stack.append(symbol_factory.BitVecVal(0, 256))
        elif isinstance(data, (bytes, bytearray, list)):
            global_state.mstate.stack.append(symbol_factory.BitVecVal(len(data), 256))
        else:
            global_state.mstate.stack.append(
                global_state.new_bitvec("returndatasize", 256)
            )
        return [global_state]

    @StateTransition()
    def returndatacopy_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate.stack
        dest, offset, size = s.pop(), s.pop(), s.pop()
        data = global_state.last_return_data
        mstate = global_state.mstate
        if size.value is None or data is None:
            for i in range(32):
                mstate.memory.set_byte(
                    dest + i, global_state.new_bitvec(f"returndatacopy_{mstate.pc}_{i}", 8)
                )
            return [global_state]
        n = min(size.value, 0x10000)
        if dest.value is not None:
            mstate.mem_extend(dest.value, n)
        start = offset.value or 0
        for i in range(n):
            if start + i < len(data):
                b = data[start + i]
                mstate.memory.set_byte(dest + i, b)
            else:
                mstate.memory.set_byte(dest + i, 0)
        return [global_state]

    # ==================================================================
    # block context
    # ==================================================================

    @StateTransition()
    def blockhash_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate.stack
        block_number = s.pop()
        s.append(global_state.new_bitvec(f"blockhash_block_{block_number.raw.tid}", 256))
        return [global_state]

    @StateTransition()
    def coinbase_(self, global_state: GlobalState) -> List[GlobalState]:
        env = global_state.environment
        global_state.mstate.stack.append(
            env.coinbase
            if env.coinbase is not None
            else global_state.new_bitvec("coinbase", 256)
        )
        return [global_state]

    @StateTransition()
    def timestamp_(self, global_state: GlobalState) -> List[GlobalState]:
        env = global_state.environment
        global_state.mstate.stack.append(
            env.timestamp
            if env.timestamp is not None
            else symbol_factory.BitVecSym("timestamp", 256)
        )
        return [global_state]

    @StateTransition()
    def number_(self, global_state: GlobalState) -> List[GlobalState]:
        global_state.mstate.stack.append(global_state.environment.block_number)
        return [global_state]

    @StateTransition()
    def difficulty_(self, global_state: GlobalState) -> List[GlobalState]:
        env = global_state.environment
        global_state.mstate.stack.append(
            env.difficulty
            if env.difficulty is not None
            else global_state.new_bitvec("block_difficulty", 256)
        )
        return [global_state]

    @StateTransition()
    def gaslimit_(self, global_state: GlobalState) -> List[GlobalState]:
        env = global_state.environment
        global_state.mstate.stack.append(
            env.block_gaslimit
            if env.block_gaslimit is not None
            else symbol_factory.BitVecVal(global_state.mstate.gas_limit, 256)
        )
        return [global_state]

    @StateTransition()
    def chainid_(self, global_state: GlobalState) -> List[GlobalState]:
        global_state.mstate.stack.append(global_state.environment.chainid)
        return [global_state]

    @StateTransition()
    def selfbalance_(self, global_state: GlobalState) -> List[GlobalState]:
        balance = global_state.world_state.balances[global_state.environment.address]
        global_state.mstate.stack.append(balance)
        return [global_state]

    # ==================================================================
    # memory
    # ==================================================================

    @StateTransition()
    def mload_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate.stack
        offset = s.pop()
        if offset.value is not None:
            global_state.mstate.mem_extend(offset.value, 32)
        s.append(global_state.mstate.memory.get_word_at(offset))
        return [global_state]

    @StateTransition()
    def mstore_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate.stack
        offset, value = s.pop(), s.pop()
        if offset.value is not None:
            global_state.mstate.mem_extend(offset.value, 32)
        global_state.mstate.memory.write_word_at(offset, value)
        return [global_state]

    @StateTransition()
    def mstore8_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate.stack
        offset, value = s.pop(), s.pop()
        if offset.value is not None:
            global_state.mstate.mem_extend(offset.value, 1)
        global_state.mstate.memory.set_byte(offset, Extract(7, 0, value))
        return [global_state]

    @StateTransition()
    def msize_(self, global_state: GlobalState) -> List[GlobalState]:
        global_state.mstate.stack.append(
            symbol_factory.BitVecVal(global_state.mstate.memory_size, 256)
        )
        return [global_state]

    # ==================================================================
    # storage
    # ==================================================================

    @StateTransition()
    def sload_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate.stack
        index = s.pop()
        s.append(global_state.environment.active_account.storage[index])
        return [global_state]

    @StateTransition(is_state_mutation_instruction=True)
    def sstore_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate.stack
        index, value = s.pop(), s.pop()
        global_state.environment.active_account.storage[index] = value
        return [global_state]

    # ==================================================================
    # control flow
    # ==================================================================

    @StateTransition(increment_pc=False)
    def jump_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate.stack
        dest = s.pop()
        if dest.value is None:
            raise InvalidJumpDestination("symbolic jump destination")
        index = util.get_instruction_index(
            global_state.environment.code.instruction_list, dest.value
        )
        if index is None:
            raise InvalidJumpDestination(f"JUMP to missing address {dest.value}")
        target = global_state.environment.code.instruction_list[index]
        if target.opcode != "JUMPDEST":
            raise InvalidJumpDestination(f"JUMP to non-JUMPDEST {dest.value}")
        global_state.mstate.pc = index
        global_state.mstate.depth += 1
        return [global_state]

    @StateTransition(increment_pc=False)
    def jumpi_(self, global_state: GlobalState) -> List[GlobalState]:
        """THE forking point (reference instructions.py:1557-1633)."""
        s = global_state.mstate.stack
        dest, cond_word = s.pop(), s.pop()
        condition = _as_bool(cond_word)
        states: List[GlobalState] = []

        # fall-through branch
        if not condition.is_true:
            fallthrough = _copy.copy(global_state)
            fallthrough.world_state.constraints.append(Not(condition))
            fallthrough.mstate.pc += 1
            fallthrough.mstate.depth += 1
            states.append(fallthrough)

        # taken branch
        if not condition.is_false:
            if dest.value is None:
                log.debug("symbolic jumpi destination at pc %d", global_state.mstate.pc)
            else:
                index = util.get_instruction_index(
                    global_state.environment.code.instruction_list, dest.value
                )
                if index is not None and (
                    global_state.environment.code.instruction_list[index].opcode
                    == "JUMPDEST"
                ):
                    taken = _copy.copy(global_state)
                    taken.world_state.constraints.append(condition)
                    taken.mstate.pc = index
                    taken.mstate.depth += 1
                    states.append(taken)
        return states

    @StateTransition()
    def jumpdest_(self, global_state: GlobalState) -> List[GlobalState]:
        return [global_state]

    @StateTransition()
    def pc_(self, global_state: GlobalState) -> List[GlobalState]:
        instr = global_state.get_current_instruction()
        global_state.mstate.stack.append(
            symbol_factory.BitVecVal(instr["address"], 256)
        )
        return [global_state]

    @StateTransition()
    def gas_(self, global_state: GlobalState) -> List[GlobalState]:
        mstate = global_state.mstate
        if args.concrete_gas:
            # deterministic (concolic/conformance) replay: GAS pushes the
            # remaining gas AFTER this instruction's own cost of 2, from the
            # exact lower-bound accounting (min tracks real cost for every
            # concretely-replayed op; reference skiplists these fixtures).
            # Symbolic analysis keeps the fresh symbol below so gas never
            # over-concretizes paths.
            global_state.mstate.stack.append(
                symbol_factory.BitVecVal(
                    max(0, mstate.gas_limit - mstate.min_gas_used - 2), 256
                )
            )
            return [global_state]
        global_state.mstate.stack.append(global_state.new_bitvec("gas", 256))
        return [global_state]

    @StateTransition(is_state_mutation_instruction=True)
    def log_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate.stack
        num_topics = int(self.op_code[3:])
        offset, length = s.pop(), s.pop()
        for _ in range(num_topics):
            s.pop()
        # logged data lives in memory: a concrete range charges expansion
        # (an absurd range must OOG, VMTests log1MemExp); symbolic ranges
        # stay uncharged like the other approximated memory ops
        try:
            off = util.get_concrete_int(offset)
            ln = util.get_concrete_int(length)
            if ln:
                global_state.mstate.mem_extend(off, ln)
        except TypeError:
            pass
        return [global_state]

    # ==================================================================
    # create
    # ==================================================================

    def _create_transaction_helper(self, global_state, value, init_bytes, op_code, salt=None):
        world_state = global_state.world_state
        caller = global_state.environment.address
        environment = global_state.environment

        if salt is not None and all(b.value is not None for b in []):
            pass
        code_raw = []
        for b in init_bytes:
            if isinstance(b, int):
                code_raw.append(b)
            elif b.value is not None:
                code_raw.append(b.value)
            else:
                # symbolic init code byte: concretize to 0
                code_raw.append(0)
        from mythril_tpu_torch.frontend.disassembler import Disassembly

        code = Disassembly(bytes(code_raw))
        callee_account = world_state.create_account(
            0, concrete_storage=True, creator=caller.value
        )
        callee_account.contract_name = f"created_{callee_account.address.value:x}"[:20]
        transaction = ContractCreationTransaction(
            world_state=world_state,
            caller=caller,
            callee_account=callee_account,
            code=code,
            # EMPTY CONCRETE calldata, not the symbolic default: the
            # constructor args of an inner CREATE/CREATE2 are already
            # embedded in init_bytes, so the symbolic constructor-arg
            # model (codesize_/codecopy_ +0x200 phantom bytes) must not
            # apply — CODESIZE must be exact here
            call_data=ConcreteCalldata(0, []),
            gas_price=environment.gasprice,
            gas_limit=global_state.mstate.gas_left,
            origin=environment.origin,
            call_value=value,
            contract_name=callee_account.contract_name,
        )
        raise TransactionStartSignal(transaction, op_code, global_state)

    @StateTransition(is_state_mutation_instruction=True)
    def create_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate.stack
        value, offset, size = s.pop(), s.pop(), s.pop()
        if size.value is None or offset.value is None:
            s.append(symbol_factory.BitVecVal(0, 256))
            return [global_state]
        init_bytes = global_state.mstate.memory.read_bytes(offset.value, size.value)
        self._create_transaction_helper(global_state, value, init_bytes, "CREATE")

    @StateTransition(is_state_mutation_instruction=True)
    def create2_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate.stack
        value, offset, size, salt = s.pop(), s.pop(), s.pop(), s.pop()
        if size.value is None or offset.value is None:
            s.append(symbol_factory.BitVecVal(0, 256))
            return [global_state]
        init_bytes = global_state.mstate.memory.read_bytes(offset.value, size.value)
        self._create_transaction_helper(global_state, value, init_bytes, "CREATE2", salt)

    @StateTransition()
    def create_post(self, global_state: GlobalState) -> List[GlobalState]:
        return self._handle_create_post(global_state)

    @StateTransition()
    def create2_post(self, global_state: GlobalState) -> List[GlobalState]:
        return self._handle_create_post(global_state)

    def _handle_create_post(self, global_state: GlobalState) -> List[GlobalState]:
        return_value = global_state.last_return_data
        if isinstance(return_value, BitVec):
            global_state.mstate.stack.append(return_value)
        elif isinstance(return_value, int):
            global_state.mstate.stack.append(
                symbol_factory.BitVecVal(return_value, 256)
            )
        else:
            global_state.mstate.stack.append(symbol_factory.BitVecVal(0, 256))
        return [global_state]

    # ==================================================================
    # calls — parameter plumbing lives in core/call.py
    # ==================================================================

    def _generic_call_(
        self, global_state: GlobalState, op_code: str
    ) -> List[GlobalState]:
        from mythril_tpu_torch.core import call as call_helpers

        instr = global_state.get_current_instruction()
        memory_out_offset, memory_out_size = call_helpers.get_call_output_location(
            global_state, op_code
        )
        try:
            (
                callee_address,
                callee_account,
                call_data,
                value,
                gas,
                memory_out_offset,
                memory_out_size,
            ) = call_helpers.get_call_parameters(
                global_state, self.dynamic_loader, with_value=op_code in ("CALL", "CALLCODE")
            )
        except call_helpers.SymbolicCalleeError:
            # unresolvable callee: push fresh return value and move on
            ret = global_state.new_bitvec(f"retval_{instr['address']}", 256)
            global_state.mstate.stack.append(ret)
            global_state.world_state.constraints.append(
                Or(ret == symbol_factory.BitVecVal(0, 256), ret == symbol_factory.BitVecVal(1, 256))
            )
            return [global_state]

        if op_code == "CALL" and global_state.environment.static:
            if not (value.value == 0):
                raise WriteProtection("CALL with value inside a static call")

        native_result = call_helpers.native_call(
            global_state, callee_address, call_data, memory_out_offset, memory_out_size
        )
        if native_result is not None:
            return native_result

        if callee_account is not None and callee_account.code is None:
            # EOA transfer: no code to execute
            if op_code in ("CALL", "CALLCODE") and value is not None:
                transfer_ether(
                    global_state, global_state.environment.address, callee_address, value
                )
            ret = global_state.new_bitvec(f"retval_{instr['address']}", 256)
            global_state.mstate.stack.append(ret)
            global_state.world_state.constraints.append(
                ret == symbol_factory.BitVecVal(1, 256)
            )
            return [global_state]

        environment = global_state.environment
        if op_code == "CALL":
            sender, receiver, code, static, callvalue = (
                environment.address,
                callee_address,
                callee_account.code,
                environment.static,
                value,
            )
            callee = callee_account
        elif op_code == "CALLCODE":
            sender, receiver, code, static, callvalue = (
                environment.address,
                environment.address,
                callee_account.code,
                environment.static,
                value,
            )
            callee = environment.active_account
        elif op_code == "DELEGATECALL":
            sender, receiver, code, static, callvalue = (
                environment.sender,
                environment.address,
                callee_account.code,
                environment.static,
                environment.callvalue,
            )
            callee = environment.active_account
        else:  # STATICCALL
            sender, receiver, code, static, callvalue = (
                environment.address,
                callee_address,
                callee_account.code,
                True,
                symbol_factory.BitVecVal(0, 256),
            )
            callee = callee_account

        transaction = MessageCallTransaction(
            world_state=global_state.world_state,
            gas_price=environment.gasprice,
            gas_limit=gas.value if gas.value is not None else global_state.mstate.gas_left,
            origin=environment.origin,
            caller=sender,
            callee_account=callee,
            code=code,
            call_data=call_data,
            call_value=callvalue,
            static=static,
        )
        # stash the caller's output window on the tx so _end_message_call can
        # hand it back to the *_post handler after the child returns
        transaction.memory_out_offset = memory_out_offset
        transaction.memory_out_size = memory_out_size
        raise TransactionStartSignal(transaction, op_code, global_state)

    @StateTransition(increment_pc=False)
    def call_(self, global_state: GlobalState) -> List[GlobalState]:
        states = self._generic_call_(global_state, "CALL")
        for st in states:
            st.mstate.pc += 1
        return states

    @StateTransition(increment_pc=False)
    def callcode_(self, global_state: GlobalState) -> List[GlobalState]:
        states = self._generic_call_(global_state, "CALLCODE")
        for st in states:
            st.mstate.pc += 1
        return states

    @StateTransition(increment_pc=False)
    def delegatecall_(self, global_state: GlobalState) -> List[GlobalState]:
        states = self._generic_call_(global_state, "DELEGATECALL")
        for st in states:
            st.mstate.pc += 1
        return states

    @StateTransition(increment_pc=False)
    def staticcall_(self, global_state: GlobalState) -> List[GlobalState]:
        states = self._generic_call_(global_state, "STATICCALL")
        for st in states:
            st.mstate.pc += 1
        return states

    def _generic_call_post(self, global_state: GlobalState) -> List[GlobalState]:
        """Resume the caller after the child tx ended (reference :2040+)."""
        instr = global_state.get_current_instruction()
        return_data = global_state.last_return_data
        ret = global_state.new_bitvec(f"retval_{instr['address']}", 256)
        global_state.mstate.stack.append(ret)
        # write child's return data into caller memory if requested
        out_offset, out_size = getattr(global_state, "call_output_location", (None, None))
        if (
            isinstance(return_data, (bytes, bytearray, list))
            and out_offset is not None
            and out_offset.value is not None
            and out_size is not None
            and out_size.value is not None
        ):
            n = min(len(return_data), out_size.value)
            for i in range(n):
                global_state.mstate.memory.set_byte(out_offset + i, return_data[i])
        return [global_state]

    @StateTransition()
    def call_post(self, global_state: GlobalState) -> List[GlobalState]:
        return self._generic_call_post(global_state)

    @StateTransition()
    def callcode_post(self, global_state: GlobalState) -> List[GlobalState]:
        return self._generic_call_post(global_state)

    @StateTransition()
    def delegatecall_post(self, global_state: GlobalState) -> List[GlobalState]:
        return self._generic_call_post(global_state)

    @StateTransition()
    def staticcall_post(self, global_state: GlobalState) -> List[GlobalState]:
        return self._generic_call_post(global_state)

    # ==================================================================
    # terminal
    # ==================================================================

    @StateTransition()
    def return_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate.stack
        offset, length = s.pop(), s.pop()
        return_data = None
        if offset.value is not None and length.value is not None:
            n = min(length.value, 0x10000)
            raw = global_state.mstate.memory.read_bytes(offset.value, n)
            if all(b.value is not None for b in raw):
                return_data = bytes(b.value for b in raw)
            else:
                return_data = raw
        global_state.current_transaction.end(global_state, return_data=return_data)

    @StateTransition()
    def stop_(self, global_state: GlobalState) -> List[GlobalState]:
        global_state.current_transaction.end(global_state, return_data=None)

    @StateTransition()
    def revert_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate.stack
        offset, length = s.pop(), s.pop()
        return_data = None
        if offset.value is not None and length.value is not None:
            n = min(length.value, 0x10000)
            raw = global_state.mstate.memory.read_bytes(offset.value, n)
            if all(b.value is not None for b in raw):
                return_data = bytes(b.value for b in raw)
        global_state.current_transaction.end(
            global_state, return_data=return_data, revert=True
        )

    @StateTransition(is_state_mutation_instruction=True)
    def selfdestruct_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate.stack
        target = s.pop()
        account = global_state.environment.active_account
        balance = global_state.world_state.balances[account.address]
        global_state.world_state.balances[target] += balance
        global_state.world_state.balances[account.address] = symbol_factory.BitVecVal(0, 256)
        account.deleted = True
        global_state.current_transaction.end(global_state)

    @StateTransition()
    def invalid_(self, global_state: GlobalState) -> List[GlobalState]:
        raise InvalidInstruction("INVALID opcode reached")

    @StateTransition()
    def assert_fail_(self, global_state: GlobalState) -> List[GlobalState]:
        raise InvalidInstruction("assertion failure")
