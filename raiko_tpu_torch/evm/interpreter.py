"""EVM bytecode interpreter (Cancun level).

From-scratch implementation of the interpreter loop the reference gets
from revm (lib/src/builder.rs:113-128 execution path): full opcode set
through Cancun (PUSH0, TLOAD/TSTORE, MCOPY, BLOBHASH, BLOBBASEFEE),
EIP-2929 warm/cold access costs, EIP-2200/3529 SSTORE metering + refunds,
EIP-150 63/64 call forwarding, EIP-3860 initcode limits, EIP-6780
SELFDESTRUCT, memory expansion gas, static-call protection, call/create
depth 1024.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..proto.types import Log
from ..utils import keccak256
from . import precompiles
from .state import StateJournal

U256 = 1 << 256
M256 = U256 - 1
S_SIGN = 1 << 255

MAX_CODE_SIZE = 24576
MAX_INITCODE_SIZE = 2 * MAX_CODE_SIZE
CALL_STIPEND = 2300


@dataclass
class BlockEnv:
    number: int = 0
    timestamp: int = 0
    gas_limit: int = 30_000_000
    base_fee: int = 0
    coinbase: bytes = b"\x00" * 20
    prevrandao: bytes = b"\x00" * 32
    chain_id: int = 1
    blob_base_fee: int = 1
    difficulty: int = 0


@dataclass
class TxEnv:
    origin: bytes = b"\x00" * 20
    gas_price: int = 0
    blob_hashes: list = field(default_factory=list)


@dataclass
class CallResult:
    success: bool
    gas_left: int
    output: bytes = b""
    create_address: bytes | None = None


class EvmError(Exception):
    pass


class EVM:
    def __init__(
        self,
        state: StateJournal,
        block: BlockEnv,
        tx: TxEnv,
        is_taiko=False,
        tracer=None,
        acct_log: dict | None = None,
    ):
        self.state = state
        self.block = block
        self.tx = tx
        self.depth = 0
        # account-context read log for the covered-frame replay
        # (stark/airs/evm_air.py): (kind, key) -> value, poisoned to None
        # when the same key is read with different values mid-tx
        self.acct_log = acct_log
        self.is_taiko = is_taiko
        # optional per-step tracer (evm/tracer.StructTracer); None keeps
        # the interpreter loop at one is-None check per step
        self.tracer = tracer

    # ------------------------------------------------------------------
    def _alog(self, kind: int, key: int, value: int) -> None:
        if self.acct_log is None or key >= (1 << 160):
            return
        k = (kind, key)
        prev = self.acct_log.get(k, value)
        self.acct_log[k] = value if prev == value else None

    def call(
        self,
        caller: bytes,
        to: bytes,
        value: int,
        data: bytes,
        gas: int,
        is_static: bool = False,
        transfers_value: bool | None = None,
    ) -> CallResult:
        """Message call to ``to`` (top-level or internal)."""
        if self.depth > 1024:
            return CallResult(False, gas)
        state = self.state
        snap = state.snapshot()
        if transfers_value is None:
            transfers_value = value > 0
        if transfers_value and value > 0:
            if state.balance(caller) < value:
                return CallResult(False, gas)
            state.sub_balance(caller, value)
            state.add_balance(to, value)
        if precompiles.is_precompile(to):
            used, output = precompiles.run(to, data, gas)
            if output is None:
                state.revert(snap)
                return CallResult(False, 0)
            return CallResult(True, gas - used, output)
        code = state.code(to)
        if not code:
            return CallResult(True, gas)
        self.depth += 1
        try:
            result = self._execute(
                code=code,
                address=to,
                caller=caller,
                value=value,
                data=data,
                gas=gas,
                is_static=is_static,
            )
        finally:
            self.depth -= 1
        if not result.success:
            state.revert(snap)
        return result

    def create(
        self,
        caller: bytes,
        value: int,
        initcode: bytes,
        gas: int,
        salt: bytes | None = None,
    ) -> CallResult:
        state = self.state
        if self.depth > 1024:
            return CallResult(False, gas)
        if state.balance(caller) < value:
            return CallResult(False, gas)
        # compute address
        from ..proto import rlp

        if salt is None:
            addr = keccak256(rlp.encode([caller, state.nonce(caller) - 1]))[12:]
        else:
            addr = keccak256(b"\xff" + caller + salt + keccak256(initcode))[12:]
        state.access_account(addr)
        # collision check
        existing = state._load(addr)
        if existing.code or existing.nonce:
            return CallResult(False, 0)
        snap = state.snapshot()
        state.mark_created(addr)
        state.set_nonce(addr, 1)  # EIP-161
        if value > 0:
            state.sub_balance(caller, value)
            state.add_balance(addr, value)
        self.depth += 1
        try:
            result = self._execute(
                code=initcode,
                address=addr,
                caller=caller,
                value=value,
                data=b"",
                gas=gas,
                is_static=False,
                is_create=True,
            )
        finally:
            self.depth -= 1
        if result.success:
            deployed = result.output
            deposit = 200 * len(deployed)
            if (
                len(deployed) > MAX_CODE_SIZE
                or (deployed[:1] == b"\xef")
                or deposit > result.gas_left
            ):
                state.revert(snap)
                return CallResult(False, 0)
            state.set_code(addr, deployed)
            return CallResult(True, result.gas_left - deposit, b"", addr)
        state.revert(snap)
        return CallResult(False, result.gas_left, result.output)

    # ------------------------------------------------------------------
    def _execute(
        self,
        code: bytes,
        address: bytes,
        caller: bytes,
        value: int,
        data: bytes,
        gas: int,
        is_static: bool,
        is_create: bool = False,
    ) -> CallResult:
        state = self.state
        stack: list[int] = []
        mem = bytearray()
        pc = 0
        gas_left = gas
        returndata = b""
        jumpdests = _valid_jumpdests(code)

        def use(amount: int):
            nonlocal gas_left
            if amount > gas_left:
                raise _OutOfGas()
            gas_left -= amount

        def mem_extend(offset: int, size: int):
            if size == 0:
                return
            new_len = offset + size
            if new_len > len(mem):
                new_words = (new_len + 31) // 32
                old_words = (len(mem) + 31) // 32
                cost = (3 * new_words + new_words * new_words // 512) - (
                    3 * old_words + old_words * old_words // 512
                )
                use(cost)
                mem.extend(b"\x00" * (new_words * 32 - len(mem)))

        def push(v: int):
            if len(stack) >= 1024:
                raise EvmError("stack overflow")
            stack.append(v & M256)

        def pop() -> int:
            if not stack:
                raise EvmError("stack underflow")
            return stack.pop()

        def check_mem_bounds(off, size):
            if size > 0 and (off > 1 << 32 or size > 1 << 32):
                raise _OutOfGas()

        tr = self.tracer
        try:
            while pc < len(code):
                op = code[pc]
                if tr is not None:
                    tr.step(pc, op, gas_left, self.depth, stack)
                pc += 1
                # -- push family (most common) --
                if 0x60 <= op <= 0x7F:
                    n = op - 0x5F
                    use(3)
                    push(int.from_bytes(code[pc : pc + n], "big"))
                    pc += n
                elif op == 0x5F:  # PUSH0
                    use(2)
                    push(0)
                elif 0x80 <= op <= 0x8F:  # DUP
                    use(3)
                    n = op - 0x7F
                    if len(stack) < n:
                        raise EvmError("stack underflow")
                    push(stack[-n])
                elif 0x90 <= op <= 0x9F:  # SWAP
                    use(3)
                    n = op - 0x8F
                    if len(stack) < n + 1:
                        raise EvmError("stack underflow")
                    stack[-1], stack[-n - 1] = stack[-n - 1], stack[-1]
                elif op == 0x01:  # ADD
                    use(3)
                    push(pop() + pop())
                elif op == 0x02:  # MUL
                    use(5)
                    push(pop() * pop())
                elif op == 0x03:  # SUB
                    use(3)
                    a = pop()
                    push(a - pop())
                elif op == 0x04:  # DIV
                    use(5)
                    a, b = pop(), pop()
                    push(a // b if b else 0)
                elif op == 0x05:  # SDIV
                    use(5)
                    a, b = _sgn(pop()), _sgn(pop())
                    if b == 0:
                        push(0)
                    else:
                        q = abs(a) // abs(b)
                        push(-q if (a < 0) != (b < 0) else q)
                elif op == 0x06:  # MOD
                    use(5)
                    a, b = pop(), pop()
                    push(a % b if b else 0)
                elif op == 0x07:  # SMOD
                    use(5)
                    a, b = _sgn(pop()), _sgn(pop())
                    if b == 0:
                        push(0)
                    else:
                        r = abs(a) % abs(b)
                        push(-r if a < 0 else r)
                elif op == 0x08:  # ADDMOD
                    use(8)
                    a, b, n = pop(), pop(), pop()
                    push((a + b) % n if n else 0)
                elif op == 0x09:  # MULMOD
                    use(8)
                    a, b, n = pop(), pop(), pop()
                    push((a * b) % n if n else 0)
                elif op == 0x0A:  # EXP
                    a, e = pop(), pop()
                    use(10 + 50 * ((e.bit_length() + 7) // 8))
                    push(pow(a, e, U256))
                elif op == 0x0B:  # SIGNEXTEND
                    use(5)
                    b, x = pop(), pop()
                    if b < 31:
                        bit = 8 * b + 7
                        if x & (1 << bit):
                            x |= M256 ^ ((1 << (bit + 1)) - 1)
                        else:
                            x &= (1 << (bit + 1)) - 1
                    push(x)
                elif op == 0x10:  # LT
                    use(3)
                    push(1 if pop() < pop() else 0)
                elif op == 0x11:  # GT
                    use(3)
                    push(1 if pop() > pop() else 0)
                elif op == 0x12:  # SLT
                    use(3)
                    push(1 if _sgn(pop()) < _sgn(pop()) else 0)
                elif op == 0x13:  # SGT
                    use(3)
                    push(1 if _sgn(pop()) > _sgn(pop()) else 0)
                elif op == 0x14:  # EQ
                    use(3)
                    push(1 if pop() == pop() else 0)
                elif op == 0x15:  # ISZERO
                    use(3)
                    push(1 if pop() == 0 else 0)
                elif op == 0x16:  # AND
                    use(3)
                    push(pop() & pop())
                elif op == 0x17:  # OR
                    use(3)
                    push(pop() | pop())
                elif op == 0x18:  # XOR
                    use(3)
                    push(pop() ^ pop())
                elif op == 0x19:  # NOT
                    use(3)
                    push(M256 ^ pop())
                elif op == 0x1A:  # BYTE
                    use(3)
                    i, x = pop(), pop()
                    push((x >> (8 * (31 - i))) & 0xFF if i < 32 else 0)
                elif op == 0x1B:  # SHL
                    use(3)
                    s, v = pop(), pop()
                    push(v << s if s < 256 else 0)
                elif op == 0x1C:  # SHR
                    use(3)
                    s, v = pop(), pop()
                    push(v >> s if s < 256 else 0)
                elif op == 0x1D:  # SAR
                    use(3)
                    s, v = pop(), _sgn(pop())
                    if s >= 256:
                        push(0 if v >= 0 else M256)
                    else:
                        push(v >> s)
                elif op == 0x20:  # KECCAK256
                    off, size = pop(), pop()
                    check_mem_bounds(off, size)
                    use(30 + 6 * ((size + 31) // 32))
                    mem_extend(off, size)
                    push(int.from_bytes(keccak256(bytes(mem[off : off + size])), "big"))
                elif op == 0x30:  # ADDRESS
                    use(2)
                    push(int.from_bytes(address, "big"))
                elif op == 0x31:  # BALANCE
                    a = _addr(pop())
                    use(2600 if state.access_account(a) else 100)
                    bal = state.balance(a)
                    self._alog(1, int.from_bytes(a, "big"), bal)
                    push(bal)
                elif op == 0x32:  # ORIGIN
                    use(2)
                    push(int.from_bytes(self.tx.origin, "big"))
                elif op == 0x33:  # CALLER
                    use(2)
                    push(int.from_bytes(caller, "big"))
                elif op == 0x34:  # CALLVALUE
                    use(2)
                    push(value)
                elif op == 0x35:  # CALLDATALOAD
                    use(3)
                    off = pop()
                    push(int.from_bytes(data[off : off + 32].ljust(32, b"\x00"), "big") if off < len(data) else 0)
                elif op == 0x36:  # CALLDATASIZE
                    use(2)
                    push(len(data))
                elif op == 0x37:  # CALLDATACOPY
                    dst, src, size = pop(), pop(), pop()
                    check_mem_bounds(dst, size)
                    use(3 + 3 * ((size + 31) // 32))
                    mem_extend(dst, size)
                    chunk = data[src : src + size] if src < len(data) else b""
                    mem[dst : dst + size] = chunk.ljust(size, b"\x00")
                elif op == 0x38:  # CODESIZE
                    use(2)
                    push(len(code))
                elif op == 0x39:  # CODECOPY
                    dst, src, size = pop(), pop(), pop()
                    check_mem_bounds(dst, size)
                    use(3 + 3 * ((size + 31) // 32))
                    mem_extend(dst, size)
                    chunk = code[src : src + size] if src < len(code) else b""
                    mem[dst : dst + size] = chunk.ljust(size, b"\x00")
                elif op == 0x3A:  # GASPRICE
                    use(2)
                    push(self.tx.gas_price)
                elif op == 0x3B:  # EXTCODESIZE
                    a = _addr(pop())
                    use(2600 if state.access_account(a) else 100)
                    cs = len(state.code(a))
                    self._alog(2, int.from_bytes(a, "big"), cs)
                    push(cs)
                elif op == 0x3C:  # EXTCODECOPY
                    a = _addr(pop())
                    dst, src, size = pop(), pop(), pop()
                    check_mem_bounds(dst, size)
                    use((2600 if state.access_account(a) else 100) + 3 * ((size + 31) // 32))
                    mem_extend(dst, size)
                    ext = state.code(a)
                    chunk = ext[src : src + size] if src < len(ext) else b""
                    mem[dst : dst + size] = chunk.ljust(size, b"\x00")
                elif op == 0x3D:  # RETURNDATASIZE
                    use(2)
                    push(len(returndata))
                elif op == 0x3E:  # RETURNDATACOPY
                    dst, src, size = pop(), pop(), pop()
                    check_mem_bounds(dst, size)
                    use(3 + 3 * ((size + 31) // 32))
                    if src + size > len(returndata):
                        raise EvmError("returndata out of bounds")
                    mem_extend(dst, size)
                    mem[dst : dst + size] = returndata[src : src + size]
                elif op == 0x3F:  # EXTCODEHASH
                    a = _addr(pop())
                    use(2600 if state.access_account(a) else 100)
                    ch = (
                        int.from_bytes(keccak256(state.code(a)), "big")
                        if state.exists(a)
                        else 0
                    )
                    self._alog(3, int.from_bytes(a, "big"), ch)
                    push(ch)
                elif op == 0x40:  # BLOCKHASH
                    use(20)
                    n = pop()
                    if 0 < self.block.number - n <= 256:
                        bh = int.from_bytes(state.db.block_hash(n), "big")
                    else:
                        bh = 0
                    self._alog(4, n, bh)
                    push(bh)
                elif op == 0x41:  # COINBASE
                    use(2)
                    push(int.from_bytes(self.block.coinbase, "big"))
                elif op == 0x42:  # TIMESTAMP
                    use(2)
                    push(self.block.timestamp)
                elif op == 0x43:  # NUMBER
                    use(2)
                    push(self.block.number)
                elif op == 0x44:  # PREVRANDAO
                    use(2)
                    push(int.from_bytes(self.block.prevrandao, "big"))
                elif op == 0x45:  # GASLIMIT
                    use(2)
                    push(self.block.gas_limit)
                elif op == 0x46:  # CHAINID
                    use(2)
                    push(self.block.chain_id)
                elif op == 0x47:  # SELFBALANCE
                    use(5)
                    sb = state.balance(address)
                    self._alog(1, int.from_bytes(address, "big"), sb)
                    push(sb)
                elif op == 0x48:  # BASEFEE
                    use(2)
                    push(self.block.base_fee)
                elif op == 0x49:  # BLOBHASH
                    use(3)
                    i = pop()
                    if i < len(self.tx.blob_hashes):
                        push(int.from_bytes(self.tx.blob_hashes[i], "big"))
                    else:
                        push(0)
                elif op == 0x4A:  # BLOBBASEFEE
                    use(2)
                    push(self.block.blob_base_fee)
                elif op == 0x50:  # POP
                    use(2)
                    pop()
                elif op == 0x51:  # MLOAD
                    use(3)
                    off = pop()
                    check_mem_bounds(off, 32)
                    mem_extend(off, 32)
                    push(int.from_bytes(mem[off : off + 32], "big"))
                elif op == 0x52:  # MSTORE
                    use(3)
                    off, v = pop(), pop()
                    check_mem_bounds(off, 32)
                    mem_extend(off, 32)
                    mem[off : off + 32] = v.to_bytes(32, "big")
                elif op == 0x53:  # MSTORE8
                    use(3)
                    off, v = pop(), pop()
                    check_mem_bounds(off, 1)
                    mem_extend(off, 1)
                    mem[off] = v & 0xFF
                elif op == 0x54:  # SLOAD
                    slot = pop()
                    use(2100 if state.access_slot(address, slot) else 100)
                    push(state.sload(address, slot))
                elif op == 0x55:  # SSTORE
                    if is_static:
                        raise EvmError("SSTORE in static context")
                    if gas_left <= CALL_STIPEND:
                        raise _OutOfGas()
                    slot, new = pop(), pop()
                    cold = state.access_slot(address, slot)
                    cur = state.sload(address, slot)
                    orig = state.original_storage(address, slot)
                    if new == cur:
                        cost = 100
                    elif cur == orig:
                        cost = 20000 if orig == 0 else 2900
                    else:
                        cost = 100
                    if cold:
                        cost += 2100
                    use(cost)
                    # refunds (EIP-3529)
                    if cur != new:
                        if cur == orig:
                            if orig != 0 and new == 0:
                                state.add_refund(4800)
                        else:
                            if orig != 0:
                                if cur == 0:
                                    state.sub_refund(4800)
                                elif new == 0:
                                    state.add_refund(4800)
                            if new == orig:
                                state.add_refund(19900 if orig == 0 else 2800)
                    state.sstore(address, slot, new)
                elif op == 0x56:  # JUMP
                    use(8)
                    dest = pop()
                    if dest not in jumpdests:
                        raise EvmError("bad jump")
                    pc = dest
                elif op == 0x57:  # JUMPI
                    use(10)
                    dest, cond = pop(), pop()
                    if cond:
                        if dest not in jumpdests:
                            raise EvmError("bad jump")
                        pc = dest
                elif op == 0x58:  # PC
                    use(2)
                    push(pc - 1)
                elif op == 0x59:  # MSIZE
                    use(2)
                    push(len(mem))
                elif op == 0x5A:  # GAS
                    use(2)
                    push(gas_left)
                elif op == 0x5B:  # JUMPDEST
                    use(1)
                elif op == 0x5C:  # TLOAD
                    use(100)
                    push(state.tload(address, pop()))
                elif op == 0x5D:  # TSTORE
                    if is_static:
                        raise EvmError("TSTORE in static context")
                    use(100)
                    slot, v = pop(), pop()
                    state.tstore(address, slot, v)
                elif op == 0x5E:  # MCOPY
                    dst, src, size = pop(), pop(), pop()
                    check_mem_bounds(max(dst, src), size)
                    use(3 + 3 * ((size + 31) // 32))
                    mem_extend(max(dst, src), size)
                    mem[dst : dst + size] = bytes(mem[src : src + size])
                elif 0xA0 <= op <= 0xA4:  # LOG
                    if is_static:
                        raise EvmError("LOG in static context")
                    ntopics = op - 0xA0
                    off, size = pop(), pop()
                    topics = [pop().to_bytes(32, "big") for _ in range(ntopics)]
                    check_mem_bounds(off, size)
                    use(375 + 375 * ntopics + 8 * size)
                    mem_extend(off, size)
                    state.add_log(Log(address, topics, bytes(mem[off : off + size])))
                elif op == 0xF0 or op == 0xF5:  # CREATE / CREATE2
                    if is_static:
                        raise EvmError("CREATE in static context")
                    val, off, size = pop(), pop(), pop()
                    salt = pop().to_bytes(32, "big") if op == 0xF5 else None
                    check_mem_bounds(off, size)
                    if size > MAX_INITCODE_SIZE:
                        raise _OutOfGas()
                    words = (size + 31) // 32
                    cost = 32000 + 2 * words
                    if op == 0xF5:
                        cost += 6 * words
                    use(cost)
                    mem_extend(off, size)
                    initcode = bytes(mem[off : off + size])
                    fwd = gas_left - gas_left // 64
                    use(fwd)
                    state.set_nonce(address, state.nonce(address) + 1)
                    res = self.create(address, val, initcode, fwd, salt)
                    gas_left += res.gas_left
                    returndata = res.output if not res.success else b""
                    push(int.from_bytes(res.create_address, "big") if res.success and res.create_address else 0)
                elif op in (0xF1, 0xF2, 0xF4, 0xFA):  # CALL/CALLCODE/DELEGATECALL/STATICCALL
                    g = pop()
                    a = _addr(pop())
                    if op in (0xF1, 0xF2):
                        val = pop()
                    else:
                        val = 0
                    in_off, in_size, out_off, out_size = pop(), pop(), pop(), pop()
                    check_mem_bounds(in_off, in_size)
                    check_mem_bounds(out_off, out_size)
                    if op == 0xF1 and val > 0 and is_static:
                        raise EvmError("value CALL in static context")
                    access = 2600 if state.access_account(a) else 100
                    extra = 0
                    if val > 0:
                        extra += 9000
                        if op == 0xF1 and not state.exists(a):
                            extra += 25000
                    use(access + extra)
                    mem_extend(in_off, in_size)
                    mem_extend(out_off, out_size)
                    avail = gas_left - gas_left // 64
                    g = min(g, avail)
                    use(g)
                    if val > 0:
                        g += CALL_STIPEND
                    args = bytes(mem[in_off : in_off + in_size])
                    if op == 0xF1:
                        res = self.call(address, a, val, args, g, is_static)
                    elif op == 0xF2:  # CALLCODE: run a's code in our context
                        res = self._call_with_code(
                            code_addr=a, address=address, caller=address,
                            value=val, data=args, gas=g, is_static=is_static,
                            transfer=False,
                        )
                    elif op == 0xF4:  # DELEGATECALL
                        res = self._call_with_code(
                            code_addr=a, address=address, caller=caller,
                            value=value, data=args, gas=g, is_static=is_static,
                            transfer=False,
                        )
                    else:  # STATICCALL
                        res = self.call(address, a, 0, args, g, True)
                    gas_left += res.gas_left
                    returndata = res.output
                    n = min(out_size, len(res.output))
                    mem[out_off : out_off + n] = res.output[:n]
                    push(1 if res.success else 0)
                elif op == 0xF3:  # RETURN
                    off, size = pop(), pop()
                    check_mem_bounds(off, size)
                    use(0)
                    mem_extend(off, size)
                    return CallResult(True, gas_left, bytes(mem[off : off + size]))
                elif op == 0xFD:  # REVERT
                    off, size = pop(), pop()
                    check_mem_bounds(off, size)
                    mem_extend(off, size)
                    return CallResult(False, gas_left, bytes(mem[off : off + size]))
                elif op == 0xFE:  # INVALID
                    raise EvmError("invalid opcode")
                elif op == 0xFF:  # SELFDESTRUCT
                    if is_static:
                        raise EvmError("SELFDESTRUCT in static context")
                    target = _addr(pop())
                    cost = 5000
                    if state.access_account(target):
                        cost += 2600
                    bal = state.balance(address)
                    if bal > 0 and not state.exists(target):
                        cost += 25000
                    use(cost)
                    state.touch(address)
                    if bal > 0:
                        state.sub_balance(address, bal)
                        state.add_balance(target, bal)
                    state.selfdestruct(address)
                    return CallResult(True, gas_left)
                elif op == 0x00:  # STOP
                    return CallResult(True, gas_left)
                else:
                    raise EvmError(f"unknown opcode 0x{op:02x}")
            return CallResult(True, gas_left)
        except _OutOfGas:
            return CallResult(False, 0)
        except EvmError:
            return CallResult(False, 0)
        except (IndexError, OverflowError):
            return CallResult(False, 0)

    def _call_with_code(
        self, code_addr, address, caller, value, data, gas, is_static, transfer
    ) -> CallResult:
        """DELEGATECALL / CALLCODE: run code_addr's code in address's
        storage context."""
        if self.depth > 1024:
            return CallResult(False, gas)
        state = self.state
        if precompiles.is_precompile(code_addr):
            used, output = precompiles.run(code_addr, data, gas)
            if output is None:
                return CallResult(False, 0)
            return CallResult(True, gas - used, output)
        code = state.code(code_addr)
        if not code:
            return CallResult(True, gas)
        snap = state.snapshot()
        self.depth += 1
        try:
            result = self._execute(
                code=code,
                address=address,
                caller=caller,
                value=value,
                data=data,
                gas=gas,
                is_static=is_static,
            )
        finally:
            self.depth -= 1
        if not result.success:
            state.revert(snap)
        return result


class _OutOfGas(Exception):
    pass


def _sgn(v: int) -> int:
    return v - U256 if v >= S_SIGN else v


def _addr(v: int) -> bytes:
    return (v & ((1 << 160) - 1)).to_bytes(20, "big")


def _valid_jumpdests(code: bytes) -> set:
    out = set()
    i = 0
    while i < len(code):
        op = code[i]
        if op == 0x5B:
            out.add(i)
        if 0x60 <= op <= 0x7F:
            i += op - 0x5F
        i += 1
    return out
