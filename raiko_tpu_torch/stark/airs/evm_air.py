"""EVM execution-trace AIRs: the zkEVM statement core.

Port of raiko_tpu/stark/airs/evm_air.py, copied but for the device: the
proving and verifying entry points (``prove_frame``, ``prove_call_tree``,
``prove_frame_trace``, ``verify_frame_payload``) take the device the
STARK runs on ("cuda" or "cpu").  The tables' ``eager_quotient`` stays as
the reference has it; the port's prover evaluates every AIR's quotient
on the device and does not read it.

Proves that a frame of EVM bytecode EXECUTES correctly: "program `code`,
started with environment `env`, stack pointer 0 and `gas0` gas, runs to a
STOP halt with final stack pointer `sp_f` and `gas_f` gas left" — the
TPU-native replacement for the execution proof the reference delegates to
its vendored zkVMs (risc0/sp1 guests re-running `calculate_block_header`,
provers/risc0/guest/src/main.rs:15-29; SURVEY.md §2.2), built the
multi-table way those provers' "interactions" work rather than as one
monolithic machine.

Three tables over a shared LogUp bus (prover.prove_tables):

  EvmCpuAir      one row per executed step.  256-bit words live as bit
                 columns; per-opcode semantics (adder gadget, bitwise,
                 comparisons, nonzero gadget, stack-motion, gas metering,
                 pc control flow) are flag-gated block constraints.
  EvmProgramAir  the program ROM: one row per instruction (pc, opcode,
                 push immediate), COMMITTED FIXED columns derived from
                 the public bytecode; a witness multiplicity column
                 counts visits.
  EvmStackAir    the read-write-memory argument for the stack: accesses
                 sorted by (address, sub-clock), read-after-write value
                 consistency, first-access-must-write.

Bus channels (challenge 0 = chi, the tuple-code geometric challenge):

  channel 0 (gamma_F, challenge 1): instruction fetches.  The ROM sends
      code(pc, op, imm) = pc + op*chi + sum_j imm_byte_j * chi^{j+3}
      with multiplicity = visit count; every non-halted CPU row receives
      its (pc, op, f_push*pushed-word) tuple — so opcodes and push
      immediates are exactly the public program's, and pc can never
      point into push data (no ROM row exists there).
  channel 1 (gamma_S, challenge 2): stack accesses.  The CPU sends up to
      four per row (R0/R1 reads, W0/W1 writes) as
      code(addr, clk4, iw, value) = addr + clk4*chi + iw*chi^2
                                    + sum_j value_byte_j * chi^{j+3},
      clk4 = 4*clk + slot (reads order before writes within a step);
      the stack table receives each access once.

Soundness of the covered-opcode restriction: a CPU row's committed flag
one-hot must rebuild the fetched opcode byte from covered bases only
(op = sum flag*base + family flag*n with n range-checked), so a trace
touching any uncovered opcode is unsatisfiable rather than silently
wrong.  Out-of-gas wraps the 32-bit-range-checked gas register mod p and
is likewise unsatisfiable; stack under/overflow produces a slot address
outside the stack table's 11-bit range and breaks the channel balance.

  channel 2 (gamma_C, challenge 3): calldata loads.  An in-bounds
      CALLDATALOAD (offset < calldatasize, proven through the shared
      adder gadget against the public size) sends
      code(offset, word) = offset + sum_j word_byte_j * chi^{j+1};
      EvmCalldataAir — committed-fixed columns derived from the PUBLIC
      calldata, one row per byte offset holding the zero-padded 32-byte
      big-endian word at that offset — receives each load with a witness
      multiplicity.  Out-of-bounds loads are forced to push zero.
  channel 3 (gamma_M, challenge 4): memory.  Word-aligned MLOAD/MSTORE
      send code(word_addr, 4*clk, iw, word); MemRamAir receives them
      sorted by (word_addr, clk) with read-after-write consistency and
      the EVM's zero-initialized semantics (a FRESH read sees zero).
      The msize register M (words) is a held CPU column; expansion gas
      3*dM + d(floor(M^2/512)) is charged through 9-bit remainder and
      18-bit quotient-delta witnesses (sound because M is capped at
      2^13 words, keeping M^2 < p).
  channels 4-6 (gamma_B / gamma_D / gamma_K, challenges 5-7): the
      KECCAK256 sponge bridge (stark/airs/evm_keccak.py).
  channel 7 (gamma_ST, challenge 8): storage.  SLOAD/SSTORE send
      code(4*clk, iw, cold, g1, g2, slot, value); EvmStorageAir
      (stark/airs/evm_storage.py) receives them against the PUBLIC
      per-slot (slot, original, count, prewarm) groups, enforcing read
      values, cold-access flags, and the EIP-2200 gas-case flags that
      price SSTORE on the CPU row.

Covered: STOP, ADD, MUL, SUB, DIV, SDIV, MOD, SMOD, SIGNEXTEND,
LT/GT/SLT/SGT, EQ, ISZERO, AND/OR/XOR/NOT, BYTE/SHL/SHR/SAR, KECCAK256
(32-byte-aligned offset), CALLDATALOAD, POP, MLOAD/MSTORE at ANY
byte offset (two-word read + one-hot recombination; MSTORE is a full
read-modify-write of up to two words, the spliced write values formed
as in-channel one-hot expressions), MSIZE, MSTORE8 (any byte offset,
single-word RMW), CALLDATACOPY + CODECOPY (aligned dest, ANY size
incl. byte tails — the final partial word is a read-modify-write whose
spliced value is selected by a FIXED slack one-hot — and ANY source
offset incl. past-the-end zero fill; one bridge row per copied word,
stark/airs/evm_copy.py; CODECOPY's source words are FIXED columns from
the public bytecode), RETURNDATACOPY (empty-
returndata form: offset = size = 0 pinned; larger arguments
exceptionally halt under EIP-211 since covered frames make no calls),
PUSH0-32, DUP1-16, SWAP1-16, LOG0-4 (32-byte-aligned range), JUMP/JUMPI/PC/GAS/JUMPDEST, and the
constant-push environment opcodes (ADDRESS..BLOBBASEFEE below).
LOGn (round 4) spans TWO rows like CALL: the log row reads offset/size
and meters 375*n + 8*size + expansion; the logext row reads the topic
values through the stack channel (slot activity gated by the mirrored
family bits) and the record (clk, fam_n, data span, topics) goes to the
PUBLIC EvmLogAir over BUS_LG, with the logged memory words read by a
kind-3 MemSpanBridgeAir — published topics and data are execution-bound,
closing the round-3 "topics feed only the receipt log" gap.
SDIV/SMOD/EXP are proven in the dedicated arithmetic table
(stark/airs/evm_arith.py) over the BUS_AR channel (channel 8); EXP gas
charges 10 + 50*L with L bound EXACTLY by a 33-wide one-hot: suffix-zero
forbids under-claims, and a nonzero-inverse on byte L-1 forbids
over-claims.
MUL is a schoolbook byte product with 13-bit range-checked carries;
DIV/MOD prove q*b + r = a with a zero high half and r <= b - 1 via a
byte borrow chain (division by zero pushes zero through the nonzero
gadget); the shifts run in two one-hot stages (byte-granular via a
32-wide one-hot, then bit-granular via an 8-wide one-hot), with SAR
sign-filling and shift >= 256 handled by the nonzero gadget;
SIGNEXTEND reuses the byte one-hot with sign fill.  SLOAD/SSTORE run
against the storage journal (EIP-2929 warm/cold + EIP-2200 gas cases +
the 2300-gas sentry).  LOGn meters 375*n + 8*size + expansion and pops
its topics without stack-channel reads (topic values feed only the
receipt log, outside the frame statement; popped cells are always
re-written before any further read).  MSTORE8 reads the old word at
sub-clock 4*clk and writes the spliced word at 4*clk + 1 (the second
memory accumulator AUX_M2); an unaligned MLOAD reads words w and w+1
(second read on AUX_M2) and recombines C = (B << 8k | W >> 8(32-k))
through the same one-hot; MSTORE reads old words w[, w+1] (slots 0, 1)
and writes the spliced words (slots 2, 3 via AUX_M3/AUX_M4), whose
values are one-hot pattern EXPRESSIONS over (old, B, k) — no extra
witness words.  CALLDATACOPY/CODECOPY run through copy bridges
(channel BUS_CP, kind-tagged tuples): the CPU sends (clk, destw,
offset, sw, kind); the calldata bridge reads each source word from the
calldata channel (or constrains it zero past the end), the code bridge
carries its source words as fixed columns, and both write every word
to RAM at destw + j; byte tails read the old word at sub-clock +1 and
write the splice at +2.

CALL composition (rounds 4-5, docs/EVM_COMPOSITION.md): CALL (0xF1),
DELEGATECALL (0xF4) and STATICCALL (0xFA) occupy TWO rows — the "call"
row reads argsOff/addr/argsSize/gas, charges the EIP-2929 base (cold
flag journaled via BUS_AD against stark/airs/evm_call.py's EvmAddrAir)
plus 9000 on value transfers, and expands memory to cover both the
args and ret ranges (a max gadget over two materialized targets); the
"callret" row reads value/retOff/retSize (value only on 7-arg CALL —
the KDEL/KSTA kind bits shift the 6-arg variants' stack offsets by
one), runs the EIP-150 63/64 forwarding gadget (avail = the row's gas
register, gas_in = min cap + 2300*[value != 0]), pays gas_in minus the
stipend, receives gas_ret/success/rds back through the CALLRET channel
and pushes the success bit.  The callee executes as its OWN frame
group in the same proof: the caller sends a CALLREQ tuple carrying
(call id = caller fid + clk, gas_in, env address, value, calldatasize,
env caller, callee fid, static flag, code address); under DELEGATECALL
the env words come from the CALLER's publics while the code address
stays the target, so the callee provably runs the target's code in the
caller's context.  The callee's CPU receives the tuple built from its
OWN publics, so LogUp equality forces the callee's environment to be
exactly what the caller created.  Argument/returndata bytes move
through MemSpanBridgeAir instances whose fixed words are the callee's
public calldata/returndata, instanced in-circuit by BUS_BR tuples.
The identity precompile (0x04) answers CALLREQ from a
PrecompileCallAir.  Value transfers ride the TREE-level balance
journal (EvmBalanceAir over BUS_BL): the call row sends a debit
(caller) + credit (target) with the value word, BALANCE/SELFBALANCE
send reads, and the journal's per-address running-balance chain (with
no-borrow/no-wrap adders) pins originals to finals.  REVERT (0xFD) is
a third halt opcode carrying a returndata span; the callee's CALLRET
success term becomes 1 - PUB_REVERTED and PUB_REVERTED gates every
effectful opcode (coverage v1: reverting frames are effect-free).  A
static frame (PUB_STATIC, propagated through CALLREQ exp 42) is gated
off SSTORE/LOG/value-transfer in-circuit.  CREATE/CREATE2 run the
initcode as a child frame (kind-4 memory bridge binds the initcode to
the child's public CODE; the child's returndata is the deployed code;
the new address is pushed from the createret row's B word and bound to
the child's env through a dedicated CREATE CALLREQ; the keccak address
derivation is a relativized public).  Remaining coverage restrictions
(reported uncovered, never mis-proven): 32-byte-aligned arg/ret
ranges, retSize <= rds, effect-free reverts, at most one
storage-active frame per address, no CALLCODE, value only to provably
non-empty accounts, success-only CREATE.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ...fields import babybear as bb
from ...fields import babybear_ext as ef
from ..air import Air, ConstraintBuilder

# --------------------------------------------------------------------------
# opcode tables
# --------------------------------------------------------------------------

# name -> (opbyte, static gas, pops, pushes)
SIMPLE_OPS = {
    "stop": (0x00, 0, 0, 0),
    "add": (0x01, 3, 2, 1),
    "mul": (0x02, 5, 2, 1),
    "sub": (0x03, 3, 2, 1),
    "div": (0x04, 5, 2, 1),
    "sdiv": (0x05, 5, 2, 1),
    "mod": (0x06, 5, 2, 1),
    "smod": (0x07, 5, 2, 1),
    "exp": (0x0A, 0, 2, 1),  # gas fully dynamic: 10 + 50*byte_len(exp)
    "signextend": (0x0B, 5, 2, 1),
    "lt": (0x10, 3, 2, 1),
    "gt": (0x11, 3, 2, 1),
    "slt": (0x12, 3, 2, 1),
    "sgt": (0x13, 3, 2, 1),
    "eq": (0x14, 3, 2, 1),
    "iszero": (0x15, 3, 1, 1),
    "and": (0x16, 3, 2, 1),
    "or": (0x17, 3, 2, 1),
    "xor": (0x18, 3, 2, 1),
    "not": (0x19, 3, 1, 1),
    "byte": (0x1A, 3, 2, 1),
    "keccak": (0x20, 30, 2, 1),
    "shl": (0x1B, 3, 2, 1),
    "shr": (0x1C, 3, 2, 1),
    "sar": (0x1D, 3, 2, 1),
    "calldataload": (0x35, 3, 1, 1),
    "calldatacopy": (0x37, 3, 3, 0),  # + 3/word + expansion (dynamic)
    "codecopy": (0x39, 3, 3, 0),  # + 3/word + expansion (dynamic)
    # covered RETURNDATACOPY: size must be 0 (no calls in a covered
    # frame => returndata is empty; any size > 0 reverts)
    "returndatacopy": (0x3E, 3, 3, 0),
    "pop": (0x50, 2, 1, 0),
    "mload": (0x51, 3, 1, 1),
    "mstore": (0x52, 3, 2, 0),
    "mstore8": (0x53, 3, 2, 0),
    "sload": (0x54, 0, 1, 1),  # gas fully dynamic (EIP-2929)
    "sstore": (0x55, 0, 2, 0),  # gas fully dynamic (EIP-2200/2929)
    "msize": (0x59, 2, 0, 1),
    "return": (0xF3, 0, 2, 0),  # halt; memory-expansion gas only
    "jump": (0x56, 8, 1, 0),
    "jumpi": (0x57, 10, 2, 0),
    "pc": (0x58, 2, 0, 1),
    "gas": (0x5A, 2, 0, 1),
    "jumpdest": (0x5B, 1, 0, 0),
    "push0": (0x5F, 2, 0, 1),
    # CALL occupies TWO consecutive CPU rows (docs/EVM_COMPOSITION.md):
    # the "call" row reads argsOff/addr/argsSize/gas and does the memory
    # expansion + EIP-2929 base charge; the "callret" row reads
    # value/retOff/retSize, runs the 63/64 forwarding gadget, exchanges
    # the CALLREQ/CALLRET tuples and pushes success.  Both rows fetch
    # the same instruction.  Round 5: the SAME two-row shape also covers
    # DELEGATECALL (0xF4) and STATICCALL (0xFA) via the KDEL/KSTA kind
    # bits (op = 0xF1 + 3*kdel + 9*ksta), and value-bearing CALL via the
    # callret row's nonzero gadget on the popped value word (9000 gas +
    # 2300 stipend + balance-journal debit/credit over BUS_BL).
    "call": (0xF1, 100, 0, 0),
    "callret": (0xF1, 0, 0, 0),
    # REVERT (0xFD): a third halt opcode with a returndata span like
    # RETURN; the callee's CALLRET success term becomes 1 - PUB_REVERTED
    # and the caller pushes that bit.  Coverage v1: a reverting frame
    # must be effect-free (no SSTORE, no LOGs, no calls) — the rollback
    # is then a no-op, enforced in-circuit by PUB_REVERTED gating.
    "revert": (0xFD, 0, 2, 0),
    # CREATE (0xF0) / CREATE2 (0xF5 via the KC2 bit): two rows like
    # CALL.  The "create" row reads offset/size/value (+salt), charges
    # 32000 + initcode word costs + expansion; the "createret" row runs
    # the all-but-1/64 forwarding, exchanges CALLREQ/CALLRET with the
    # INITCODE child frame (code = the public initcode, bound to caller
    # memory by a kind-4 bridge; deployed code = the child's public
    # returndata, deposit 200/byte re-charged at the boundary) and
    # pushes the new address (bound to the child's env.address through
    # the CALLREQ; its keccak derivation stays a relativized public).
    "create": (0xF0, 32000, 0, 0),
    "createret": (0xF0, 0, 0, 0),
    # account-state family (round 4): values come from the PUBLIC
    # account-context table (evm_call.AcctCtxAir) over BUS_AC; the
    # EIP-2929 100/2600 address pricing rides the same address journal
    # as CALL (base 100 static + 2500*cold dynamic)
    "balance": (0x31, 100, 1, 1),
    "extcodesize": (0x3B, 100, 1, 1),
    "extcodehash": (0x3F, 100, 1, 1),
    "blockhash": (0x40, 20, 1, 1),
    "selfbalance": (0x47, 5, 0, 1),
}

# constant-push environment opcodes: name -> opbyte (gas 2, 0 pops, 1 push)
ENV_OPS = {
    "address": 0x30,
    "origin": 0x32,
    "caller": 0x33,
    "callvalue": 0x34,
    "calldatasize": 0x36,
    "codesize": 0x38,
    "gasprice": 0x3A,
    # RETURNDATASIZE binds the CONSTANT env public; the executor leaves
    # coverage if a push would diverge from the live rds (post-CALL)
    "returndatasize": 0x3D,
    "coinbase": 0x41,
    "timestamp": 0x42,
    "number": 0x43,
    "prevrandao": 0x44,
    "gaslimit": 0x45,
    "chainid": 0x46,
    "basefee": 0x48,
    "blobbasefee": 0x4A,
}

# families: op = base + n (n = 1..cap); gas = static per op.  LOGn is
# the family op = 0x9F + n (n = 1..5, topics = n - 1): static gas 0 here
# because its 375*n part is metered dynamically (375 + 375*topics =
# 375*n), plus 8*size and memory expansion.
FAMILIES = {
    "push": (0x5F, 32, 3),
    "dup": (0x7F, 16, 3),
    "swap": (0x8F, 16, 3),
    "log": (0x9F, 5, 0),
    # round 4: every LOGn occupies TWO rows — the "log" row reads
    # offset/size and meters gas; the "logext" row reads the topic
    # values through the stack channel and sends the log record on
    # BUS_LG (the execution<->receipt binding's in-circuit half)
    "logext": (0x9F, 5, 0),
}

FLAG_NAMES = list(SIMPLE_OPS) + list(ENV_OPS) + list(FAMILIES)
NF = len(FLAG_NAMES)
FLAG_IDX = {n: i for i, n in enumerate(FLAG_NAMES)}

COVERED_OPBYTES = frozenset(
    [v[0] for v in SIMPLE_OPS.values()]
    + list(ENV_OPS.values())
    + [base + n for base, cap, _ in FAMILIES.values() for n in range(1, cap + 1)]
    + [0xF4, 0xFA]  # DELEGATECALL / STATICCALL share the CALL rows
    + [0xF5]  # CREATE2 shares the CREATE rows (KC2 bit)
)

# sp delta per flag
_ARITH2 = ("add", "sub", "lt", "gt", "slt", "sgt", "eq", "and", "or", "xor")
_CMP = ("lt", "gt", "slt", "sgt")
# every pop-2-push-1 opcode (stack channel slots R0/R1/W0)
_POP2PUSH1 = _ARITH2 + (
    "mul", "div", "sdiv", "mod", "smod", "exp", "signextend", "byte", "shl",
    "shr", "sar", "keccak",
)
_SHIFTS = ("shl", "shr", "sar")


def _sp_delta(name: str) -> int:
    if name in _POP2PUSH1:
        return -1
    if name in (
        "iszero", "not", "swap", "jumpdest", "stop", "calldataload", "mload",
        "sload", "call", "balance", "extcodesize", "extcodehash", "blockhash",
        "create",
    ):
        return 0
    if name in ("pop", "jump"):
        return -1
    if name in ("jumpi", "mstore", "mstore8", "sstore", "return", "revert"):
        return -2
    if name in ("calldatacopy", "codecopy", "returndatacopy"):
        return -3
    if name == "callret":
        return -6  # CALL's net: 7 pops + 1 push, on the second row
    if name == "createret":
        return -2  # CREATE's net: 3 pops + 1 push (CREATE2: -3 via KC2)
    if name == "log":
        return -2  # offset + size; topics pop on the logext row
    if name == "logext":
        return 0  # real delta is -(fam_n - 1); added explicitly in eval
    return 1  # push/push0/dup/pc/gas/env


def _gas_cost(name: str) -> int:
    if name in SIMPLE_OPS:
        return SIMPLE_OPS[name][1]
    if name in ENV_OPS:
        return 2
    return FAMILIES[name][2]


# --------------------------------------------------------------------------
# CPU column layout
# --------------------------------------------------------------------------

PC = 0
OP = 1
CLK = 2
HALTED = 3
TAKEN = 4
S_INV = 5
FLAG0 = 6
FAMB0 = FLAG0 + NF  # 5 bits: fam_n - 1
SPB0 = FAMB0 + 5  # 10 bits
SP_TOP = SPB0 + 10  # sp == 1024 indicator
GASB0 = SP_TOP + 1  # 32 bits
CARRY0 = GASB0 + 32  # 16 adder carries
NZ0 = CARRY0 + 16  # 16 nonzero-gadget indicators
INV0 = NZ0 + 16  # 16 nonzero-gadget inverses
A0 = INV0 + 16  # word A: 256 bits (little-endian)
B0 = A0 + 256
C0 = B0 + 256
W0 = C0 + 256  # adder diff witness (cmp/calldataload) | byte-shifted B' (shifts)
# scratch bits, overlaid by mutually exclusive opcode groups:
#   MUL:    32 x 13-bit schoolbook byte carries
#   shifts: 32-wide byte one-hot + 8-wide bit one-hot (rest unused)
SCRATCH0 = W0 + 256
MULC0 = SCRATCH0
OHQ0 = SCRATCH0
OHR0 = SCRATCH0 + 32
N_SCRATCH = 32 * 13
# memory-op witnesses (own region: `grow` and `dq` feed cross-row
# register transitions, so they can't share bits with the scratch
# overlay): grow flag, 14-bit max-comparison diff, old/new msize-squared
# remainders (9 bits each), 18-bit quotient delta
MW_GROW = SCRATCH0 + N_SCRATCH
MW_D0 = MW_GROW + 1
MW_R0 = MW_D0 + 14
MW_R1 = MW_R0 + 9
MW_DQ0 = MW_R1 + 9
# msize register: word count, held across rows (<= 2^13 words covered)
MEMB0 = MW_DQ0 + 18
# KECCAK256 witnesses: sw = ceil(size/32) (10 bits), slack = 32*sw - size
# (5 bits), and the raw `needed` column for the expansion comparison
# (keeps the max-gadget at degree <= 3 across mload/mstore/keccak)
KSW0 = MEMB0 + 14
KSL0 = KSW0 + 10
KNEED = KSL0 + 5  # raw column (not boolean)
# DIV/MOD remainder bound r <= b-1: byte borrow chain (32 borrows +
# 32 x 8 difference-byte bits)
DMB0 = KNEED + 1  # 32 borrow bits
DMT0 = DMB0 + 32  # 256 t-byte bits
# storage witnesses: cold-access flag + the SSTORE gas-case one-hot
# (g1 = clean nonzero write 2900, g2 = clean zero write 20000); the
# EIP-2200 sentry decomposition overlays scratch bits 0..31
SCOLD = DMT0 + 256
SG1 = SCOLD + 1
SG2 = SG1 + 1
# CALL-row raw (non-boolean) witnesses: the big-request inverse, the
# [retSize != 0] inverse, and the two materialized expansion targets of
# the max gadget (argneed/retneed); meaningful on call rows only
CC_INVH = SG2 + 1
CC_INVR = CC_INVH + 1
CC_ARGNEED = CC_INVR + 1
CC_RETNEED = CC_ARGNEED + 1
# call-variant kind bits (round 5): KDEL = DELEGATECALL, KSTA =
# STATICCALL (op = 0xF1 + 3*kdel + 9*ksta); valid on call/callret rows
# only, mirrored from the call row onto its callret row
KDEL = CC_RETNEED + 1
KSTA = KDEL + 1
# CREATE2 selector (op = 0xF0 + 5*kc2), valid on create/createret rows
KC2 = KSTA + 1
CPU_WIDTH = KC2 + 1

# CALL-row scratch overlay (the SCRATCH0 bit region is free on call /
# callret rows: no mul carries, no shift one-hots)
CW_BIGREQ = 0  # + SCRATCH0; [requested gas >= 2^28]
CW_TR = 1  # [retSize != 0]
CW_MM = 2  # max-gadget selector: argneed >= retneed
CW_CFID0 = 3  # 16 bits: callee frame id
CW_DMAX0 = 19  # 14 bits: |argneed - retneed|
# CALLRET-row scratch overlay
RW_Q0 = 0  # 22 bits: avail div 64
RW_R0 = 22  # 6 bits: avail mod 64
RW_M = 28  # min selector: cap < requested
RW_D0 = 29  # 30 bits: |requested - cap|
RW_GASIN0 = 59  # 28 bits: forwarded gas
RW_GASRET0 = 87  # 28 bits: callee gas left (CALLRET-bound)
RW_RDS0 = 115  # 13 bits: callee returndata size (CALLRET-bound)
RW_RDIFF0 = 128  # 13 bits: rds - retSize when retSize != 0

MAX_MEM_WORDS_LOG = 13  # coverage cap: 2^13 32-byte words (256 KiB)
MAX_KECCAK_CALLS = 64  # per-frame cap on proven KECCAK256 calls

# aux layout: fetch + 4 stack-slot + calldata + memory + hash-call accs
AUX_F = 0
AUX_SLOT0 = 4
AUX_CD = AUX_SLOT0 + 16
AUX_M = AUX_CD + 4
AUX_K = AUX_M + 4
AUX_ST = AUX_K + 4
AUX_AR = AUX_ST + 4
AUX_M2 = AUX_AR + 4  # 2nd RAM tuple (m8 write / unaligned 2nd-word read)
AUX_M3 = AUX_M2 + 4  # 3rd RAM tuple (MSTORE word-1 write)
AUX_M4 = AUX_M3 + 4  # 4th RAM tuple (unaligned MSTORE word-2 write)
AUX_CP = AUX_M4 + 4  # calldata-copy call sends
# call composition (docs/EVM_COMPOSITION.md)
AUX_CQ = AUX_CP + 4  # CALLREQ sends (call rows)
AUX_CQI = AUX_CQ + 4  # CALLREQ receive inverse witness (callee, last row)
AUX_CR = AUX_CQI + 4  # CALLRET receives (call rows)
AUX_CRI = AUX_CR + 4  # CALLRET send inverse witness (callee, last row)
AUX_BRA = AUX_CRI + 4  # args-bridge instancing sends
AUX_BRW = AUX_BRA + 4  # ret-write-bridge instancing sends
AUX_BRR = AUX_BRW + 4  # callee ret-read-bridge instancing sends
AUX_ADR = AUX_BRR + 4  # address-journal sends
AUX_AC = AUX_ADR + 4  # account-context sends
AUX_LG = AUX_AC + 4  # log-record sends
# balance-journal channel (round 5, tree-level EvmBalanceAir over BUS_BL)
AUX_BLR = AUX_LG + 4  # balance READ sends (BALANCE / SELFBALANCE rows)
AUX_BLD = AUX_BLR + 4  # balance DEBIT sends (value-bearing call rows)
AUX_BLC = AUX_BLD + 4  # balance CREDIT sends (value-bearing call rows)
# CREATE composition (round 5): its CALLREQ/CALLRET tuples differ from
# CALL's in too many terms for flag-selected sharing (degree budget),
# so the create rows drive their own accumulators + a kind-4 initcode
# bridge instancing accumulator
AUX_CQ2 = AUX_BLC + 4  # CREATE CALLREQ sends
AUX_CR2 = AUX_CQ2 + 4  # CREATE CALLRET receives
AUX_BRI = AUX_CR2 + 4  # initcode-bridge instancing sends
CPU_AUX_W = AUX_BRI + 4

CHAL_CHI = 0
CHAL_F = 1
CHAL_S = 2
CHAL_C = 3
CHAL_M = 4
CHAL_B = 5  # keccak rate-block codes (bridge -> sponge)
CHAL_D = 6  # keccak digest codes (sponge -> bridge)
CHAL_K = 7  # hash-call tuples (CPU -> bridge)
CHAL_ST = 8  # storage access tuples (CPU -> storage journal)
CHAL_AR = 9  # signed-arithmetic call tuples (CPU -> arith table)
CHAL_CP = 10  # calldata-copy call tuples (CPU -> copy bridge)
# cross-frame channels (docs/EVM_COMPOSITION.md): tuples carry frame ids
# INSIDE the tuple, so these gammas are NOT fid-shifted
CHAL_CQ = 11  # CALLREQ: caller CALL row -> callee frame / precompile
CHAL_CR = 12  # CALLRET: callee halt -> caller CALL row
CHAL_BR = 13  # args/ret memory-span bridge instancing tuples
CHAL_AD = 14  # address-access tuples (CPU -> address journal, EIP-2929)
CHAL_AC = 15  # account-context tuples (CPU -> AcctCtxAir, per-frame)
CHAL_LG = 16  # log-record tuples (CPU -> EvmLogAir, per-frame)
CHAL_BL = 17  # balance-journal tuples (tree-level, fid inside the tuple)
NUM_CHALLENGES = 18
BUS_FETCH = 0
BUS_STACK = 1
BUS_CD = 2
BUS_MEM = 3
BUS_BLOCKS = 4
BUS_DIG = 5
BUS_KCALL = 6
BUS_STOR = 7
BUS_AR = 8  # SDIV/SMOD/EXP calls -> evm_arith.py
BUS_CP = 9  # CALLDATACOPY calls -> evm_copy.py
BUS_CQ = 10  # CALLREQ tuples (cross-frame)
BUS_CR = 11  # CALLRET tuples (cross-frame)
BUS_BR = 12  # bridge instancing tuples
BUS_AD = 13  # address-access tuples
BUS_AC = 14  # account-context tuples (codesize/codehash/blockhash)
BUS_LG = 15  # log-record tuples (LOGn topics + data span)
BUS_BL = 16  # balance-journal tuples (reads + value-transfer deltas)
NUM_BUS = 17
ENV_IDX_CDSIZE = list(ENV_OPS).index("calldatasize")
ENV_IDX_ADDRESS = list(ENV_OPS).index("address")
ENV_IDX_CALLER = list(ENV_OPS).index("caller")
ENV_IDX_CALLVALUE = list(ENV_OPS).index("callvalue")

# publics layout
PUB_GAS0 = 0  # lo, hi
PUB_GASF = 2  # lo, hi
PUB_SPF = 4
PUB_ENV0 = 5  # 16 limbs per env op, ENV_OPS order
# frame-composition publics (docs/EVM_COMPOSITION.md): the frame id
# instancing every per-frame channel, the callee linkage (is_callee +
# the caller's (fid, clk) call id), and the returndata statement (rds +
# whether a returndata bridge is attached)
PUB_FID = PUB_ENV0 + 16 * len(ENV_OPS)
PUB_IS_CALLEE = PUB_FID + 1
PUB_CID_FID = PUB_FID + 2
PUB_CID_CLK = PUB_FID + 3
PUB_RDS = PUB_FID + 4
PUB_HASRET = PUB_FID + 5
# round 5: the static-context flag (STATICCALL descendants — gates every
# write opcode in-circuit), the reverted flag (halt was REVERT; flips
# the CALLRET success term), and the code address (the account whose
# code this frame runs — differs from env.address under DELEGATECALL)
PUB_STATIC = PUB_FID + 6
PUB_REVERTED = PUB_FID + 7
PUB_CODEADDR0 = PUB_FID + 8  # 10 address limbs
NUM_PUBLICS = PUB_CODEADDR0 + 10

MAX_STEPS_LOG = 20  # clk4 = 4*clk + slot < 2^22
MAX_GAS_LOG = 28  # frame gas < 2^28: keeps every gas equation far from
# the field modulus (p ~ 2^30.9), so a +-p wrap of the gas register is
# never representable in the range-checked bits — out-of-gas and gas
# inflation are unsatisfiable, not merely improbable
# the fid-instancing chi power: one past the longest channel tuple
# (the arith tuple ends at chi^96)
FID_CHI_POW = 97
MAX_FRAMES_PER_TREE = 64  # fid < 64; keccak msg ids stride by this

# limb i of a 256-bit word = sum_b 2^b * bit[16i + b]  (16 x 256 linmap)
_LIMB_MAT = [[0] * 256 for _ in range(16)]
for _i in range(16):
    for _b in range(16):
        _LIMB_MAT[_i][16 * _i + _b] = 1 << _b

# byte i of a 256-bit word = sum_b 2^b * bit[8i + b]  (32 x 256 linmap)
_BYTE_MAT = [[0] * 256 for _ in range(32)]
for _i in range(32):
    for _b in range(8):
        _BYTE_MAT[_i][8 * _i + _b] = 1 << _b

# mul carry k = sum_t 2^t * scratch[13k + t]  (32 x 416 linmap)
_MULC_MAT = [[0] * N_SCRATCH for _ in range(32)]
for _k in range(32):
    for _t in range(13):
        _MULC_MAT[_k][13 * _k + _t] = 1 << _t


def _fetch_code_host(pc: int, op: int, imm_bytes: bytes, chi: tuple) -> tuple:
    """pc + op*chi + sum_j imm_j * chi^{j+3} (32 imm bytes)."""
    acc = ef.h_add(ef.h_from_base(pc), ef.h_mul(ef.h_from_base(op), chi))
    p = ef.h_mul(ef.h_mul(chi, chi), chi)
    for j in range(32):
        byt = imm_bytes[j] if j < len(imm_bytes) else 0
        if byt:
            acc = ef.h_add(acc, ef.h_mul(ef.h_from_base(byt), p))
        p = ef.h_mul(p, chi)
    return acc


def _slot_code_host(addr: int, clk4: int, iw: int, value: int, chi: tuple) -> tuple:
    """addr + clk4*chi + iw*chi^2 + sum_j value_byte_j * chi^{j+3}."""
    acc = ef.h_add(ef.h_from_base(addr), ef.h_mul(ef.h_from_base(clk4), chi))
    chi2 = ef.h_mul(chi, chi)
    if iw:
        acc = ef.h_add(acc, chi2)
    p = ef.h_mul(chi2, chi)
    for j in range(32):
        byt = (value >> (8 * j)) & 0xFF
        if byt:
            acc = ef.h_add(acc, ef.h_mul(ef.h_from_base(byt), p))
        p = ef.h_mul(p, chi)
    return acc


# --------------------------------------------------------------------------
# frame-id channel instancing (docs/EVM_COMPOSITION.md)
#
# Every PER-FRAME channel tuple is instanced by folding the frame id at
# chi^97 (one power past the longest tuple).  Implemented equivalently by
# shifting the channel's gamma: gamma_eff = gamma - fid * chi^97, so no
# tuple-code construction changes — sender and receiver of the same frame
# use the same shifted gamma, and tuples of different frames can only
# collide at a chi root (negligible).
# --------------------------------------------------------------------------

# challenge indices whose gammas are fid-shifted (per-frame channels).
# CHAL_B / CHAL_D (bridge <-> sponge) are NOT shifted: those tuples are
# instanced by striding the message ids with fid * MAX_FRAMES_PER_TREE
# instead, so the shared KeccakSpongeV2Air needs no fid notion.
_FID_CHALS = (
    CHAL_F, CHAL_S, CHAL_C, CHAL_M, CHAL_K, CHAL_ST, CHAL_AR, CHAL_CP,
    CHAL_AD, CHAL_AC, CHAL_LG,
)


def _h_chi97(chi: tuple) -> tuple:
    c = chi
    for _ in range(5):  # chi^2, 4, 8, 16, 32
        c = ef.h_mul(c, c)
    c64 = ef.h_mul(c, c)
    return ef.h_mul(ef.h_mul(c64, c), chi)  # chi^(64+32+1)


def fid_challenges(challenges: list, fid: int) -> list:
    """Host-side: the challenge list with per-frame gammas shifted by
    -fid*chi^97.  Identity when fid == 0."""
    if not fid:
        return list(challenges)
    chi = challenges[CHAL_CHI]
    shift = ef.h_mul(ef.h_from_base(fid % bb.P), _h_chi97(chi))
    out = list(challenges)
    for idx in _FID_CHALS:
        if idx < len(out):
            out[idx] = ef.h_sub(out[idx], shift)
    return out


def _eval_chi97(b: ConstraintBuilder, chi4: list) -> list:
    c = chi4
    for _ in range(5):
        c = b.ef_mul4(c, c)
    c64 = b.ef_mul4(c, c)
    return b.ef_mul4(b.ef_mul4(c64, c), chi4)


def fid_gamma(b: ConstraintBuilder, chi4: list, gamma4: list, fid_expr) -> list:
    """Constraint-side gamma shift: gamma - fid * chi^97 (degree of
    fid_expr is 0 — it is a public)."""
    c97 = _eval_chi97(b, chi4)
    return b.ef_sub4(gamma4, [b.mul(fid_expr, c97[c]) for c in range(4)])


# --------------------------------------------------------------------------
# frame executor (trace generation)
# --------------------------------------------------------------------------


class UncoveredFrame(Exception):
    """Frame uses an opcode / behavior outside the covered statement."""


@dataclass
class FrameEnv:
    """Environment-opcode constants of one frame (ENV_OPS order)."""

    address: int = 0
    origin: int = 0
    caller: int = 0
    callvalue: int = 0
    calldatasize: int = 0
    codesize: int = 0
    gasprice: int = 0
    returndatasize: int = 0
    coinbase: int = 0
    timestamp: int = 0
    number: int = 0
    prevrandao: int = 0
    gaslimit: int = 30_000_000
    chainid: int = 1
    basefee: int = 0
    blobbasefee: int = 1

    def words(self) -> list[int]:
        return [getattr(self, name) for name in ENV_OPS]


@dataclass
class _Step:
    pc: int
    op: int
    name: str
    fam_n: int
    gas_before: int
    sp_before: int
    a: int = 0
    b: int = 0
    c: int = 0
    w: int = 0
    carries: list = field(default_factory=lambda: [0] * 16)
    nz: list = field(default_factory=lambda: [0] * 16)
    inv: list = field(default_factory=lambda: [0] * 16)
    s_inv: int = 0
    taken: int = 0
    mulc: list | None = None  # 32 schoolbook byte carries (MUL/DIV/MOD)
    dmt: list | None = None  # DIV/MOD borrow-chain t bytes
    dmb: list | None = None  # DIV/MOD borrow bits
    qsel: int = -1  # byte-shift one-hot index (shift/BYTE rows, not big)
    expL: int = -1  # EXP: exponent byte length (33-wide one-hot)
    rsel: int = -1  # bit-shift one-hot index (shift rows, not big)
    m_before: int = 0  # msize register (words) before this step
    grow: int = 0  # memory-op witnesses (MLOAD/MSTORE/KECCAK rows)
    d: int = 0
    r0: int = 0
    r1: int = 0
    dq: int = 0
    kneed: int = 0  # expansion target word count for the max gadget
    ksw: int = 0  # KECCAK256: ceil(size/32)
    ksl: int = 0  # KECCAK256: 32*ksw - size
    kreads: list = field(default_factory=list)  # (word_addr, value) reads
    scold: int = 0  # storage: cold access (EIP-2929)
    sg1: int = 0  # SSTORE clean nonzero write (2900)
    sg2: int = 0  # SSTORE clean zero write (20000)
    sentry: int = 0  # SSTORE: gas_before - 2301 (EIP-2200 sentry)
    mem_access: tuple | None = None  # (word_addr, iw, value) at slot 0
    mem_access2: tuple | None = None  # (word_addr, iw, value) at slot 1
    mem_access3: tuple | None = None  # (word_addr, iw, value) at slot 2
    mem_access4: tuple | None = None  # (word_addr, iw, value) at slot 3
    accesses: list = field(default_factory=list)  # (slot, addr, iw, value)
    callw: dict | None = None  # call/callret row witnesses (CW_*/RW_* keys)
    kdel: int = 0  # call-variant bits (DELEGATECALL / STATICCALL),
    ksta: int = 0  # set on both rows of the pair
    kc2: int = 0  # CREATE2 selector (create/createret rows)


@dataclass
class FrameTrace:
    code: bytes
    env: FrameEnv
    gas0: int
    steps: list
    gas_f: int
    sp_f: int
    visit_counts: dict  # pc -> count
    calldata: bytes = b""
    cd_loads: dict = field(default_factory=dict)  # offset -> load count
    m_final: int = 0  # msize register (words) at halt
    # KECCAK256 calls: (clk, offw, size, words, digest) — (offw, size)
    # become public bridge structure, words/digest stay witness
    keccak_calls: list = field(default_factory=list)
    # storage journal: accesses (slot, clk4, iw, value, cold, g1, g2) and
    # the PUBLIC per-slot groups [(slot, original, count, prewarm, final)]
    storage_accesses: list = field(default_factory=list)
    storage_groups: list = field(default_factory=list)
    # signed-arithmetic calls: (kind, a, b, result) proven in ArithAir
    # (stark/airs/evm_arith.py) over the BUS_AR channel
    arith_calls: list = field(default_factory=list)
    # CALLDATACOPY calls: (clk, destw, offset, sw, words) — (destw,
    # offset, sw) become public bridge structure (evm_copy.py)
    copy_calls: list = field(default_factory=list)
    # frame-composition statement (docs/EVM_COMPOSITION.md): returndata
    # size claimed by the halt (0 for STOP, the RETURN size otherwise)
    rds: int = 0
    # the RETURN row's (clk, word offset, words incl. padded tail) — the
    # callee-side returndata bridge structure; None when rds == 0
    ret_span: tuple | None = None
    # child call sites: dicts recorded by the executor per covered
    # CALL/STATICCALL (clk of the CALL row, callee trace or precompile
    # record, gas accounting, memory spans)
    call_sites: list = field(default_factory=list)
    # address-access journal (EIP-2929, call rows): accesses
    # (addr, clk4, cold) and PUBLIC groups [(addr, count, prewarm)]
    addr_accesses: list = field(default_factory=list)
    addr_groups: list = field(default_factory=list)
    # account-context records (kind, key, value, count) — PUBLIC rows of
    # evm_call.AcctCtxAir (balance/codesize/codehash/blockhash)
    acct_groups: list = field(default_factory=list)
    # LOGn records: per-log PUBLIC (fam_n, offw, size, topics, data
    # words) — the execution-bound receipt-log statement (EvmLogAir)
    log_records: list = field(default_factory=list)
    # balance-journal events (round 5): (clk4, kind, addr, value) with
    # kind 1 = read (BALANCE/SELFBALANCE push), 2 = debit, 3 = credit
    # (value-bearing CALL); received by the tree-level EvmBalanceAir
    bal_events: list = field(default_factory=list)
    # tree-level balance originals/finals (root frame only): addr -> int
    bal_originals: dict = field(default_factory=dict)
    bal_finals: dict = field(default_factory=dict)
    # static context (STATICCALL descendant) and reverted halt (round 5)
    static: int = 0
    reverted: int = 0
    # the account whose CODE this frame executes (== env.address except
    # under DELEGATECALL, where env.address is the caller's account)
    code_addr: int = 0
    # proving-time composition role (assigned by the call-tree prover)
    fid: int = 0
    is_callee: int = 0
    cid: tuple = (0, 0)  # (caller fid, caller CALL-row clk)
    hasret: int = 0  # callee-side returndata bridge attached

    @property
    def accesses(self):
        out = []
        for clk, st in enumerate(self.steps):
            for slot, addr, iw, value in st.accesses:
                out.append((addr, 4 * clk + slot, iw, value))
        return out

    @property
    def mem_accesses(self):
        out = []
        for clk, st in enumerate(self.steps):
            if st.mem_access is not None:
                waddr, iw, value = st.mem_access
                out.append((waddr, 4 * clk, iw, value))
            if st.mem_access2 is not None:
                waddr, iw, value = st.mem_access2
                out.append((waddr, 4 * clk + 1, iw, value))
            if st.mem_access3 is not None:
                waddr, iw, value = st.mem_access3
                out.append((waddr, 4 * clk + 2, iw, value))
            if st.mem_access4 is not None:
                waddr, iw, value = st.mem_access4
                out.append((waddr, 4 * clk + 3, iw, value))
            for waddr, value in st.kreads:
                out.append((waddr, 4 * clk + 1, 0, value))
        # copy-bridge accesses: tail-word RMW read at sub-clock +1,
        # writes at +2 (evm_copy.py rows)
        for _kind, clk, destw, off, sw, slack, words, _srcs, tail_old in (
            self.copy_calls
        ):
            if slack:
                out.append((destw + sw - 1, 4 * clk + 1, 0, tail_old))
            for i, wv in enumerate(words):
                out.append((destw + i, 4 * clk + 2, 1, wv))
        # call-composition bridge accesses: args words read at the CALL
        # row's sub-clock +1, returndata words written at the callret
        # row's sub-clock +1 (both sent by MemSpanBridgeAir instances)
        for site in self.call_sites:
            for j, wv in enumerate(site["args_words"]):
                out.append((site["args_offw"] + j, 4 * site["clk"] + 1, 0, wv))
            for j, wv in enumerate(site["ret_words"]):
                out.append(
                    (site["ret_offw"] + j, 4 * (site["clk"] + 1) + 1, 1, wv)
                )
        # log-data bridge accesses: the logged range read at the LOG
        # row's sub-clock +1 (MemSpanBridgeAir kind 3)
        for lr in self.log_records:
            for j, wv in enumerate(lr["data_words"]):
                out.append((lr["offw"] + j, 4 * lr["clk"] + 1, 0, wv))
        # callee-side returndata binding: the RETURN range read back at
        # the RETURN row's sub-clock +1 when a parent consumes it
        if self.hasret and self.ret_span:
            rclk, roffw, rwords = self.ret_span
            for j, wv in enumerate(rwords):
                out.append((roffw + j, 4 * rclk + 1, 0, wv))
        return out


_M256 = (1 << 256) - 1
_SGN = 1 << 255


def _flip(v: int) -> int:
    return v ^ _SGN


def _nonzero_witness(limbs: list[int]) -> tuple[list, list, int, int]:
    nz, inv = [], []
    for x in limbs:
        if x % bb.P == 0:
            nz.append(0)
            inv.append(0)
        else:
            nz.append(1)
            inv.append(pow(x % bb.P, bb.P - 2, bb.P))
    s = sum(nz)
    s_inv = pow(s, bb.P - 2, bb.P) if s else 0
    taken = 1 if s else 0
    return nz, inv, s_inv, taken


def _add_carries(x: int, y: int) -> list[int]:
    carries = []
    c = 0
    for i in range(16):
        t = ((x >> (16 * i)) & 0xFFFF) + ((y >> (16 * i)) & 0xFFFF) + c
        c = t >> 16
        carries.append(c)
    return carries


def _divmod_witness(q: int, bv: int, r: int, a: int):
    """Witnesses for q*b + r = a (b != 0; all zero when b == 0):
    the 13-bit schoolbook chain carries and the borrow chain proving
    t = b - 1 - r >= 0 (byte diffs + borrows)."""
    qb = [(q >> (8 * i)) & 0xFF for i in range(32)]
    bb_ = [(bv >> (8 * i)) & 0xFF for i in range(32)]
    rb = [(r >> (8 * i)) & 0xFF for i in range(32)]
    ab = [(a >> (8 * i)) & 0xFF for i in range(32)]
    carries = []
    c = 0
    for k in range(32):
        s = sum(qb[i] * bb_[k - i] for i in range(k + 1)) + rb[k] + c
        assert (s & 0xFF) == (ab[k] if bv else 0)
        c = s >> 8
        assert c < (1 << 13)
        carries.append(c)
    tb, brs = [], []
    br = 0
    for k in range(32):
        d = bb_[k] - rb[k] - (1 if k == 0 else 0) - br
        br = 1 if d < 0 else 0
        tb.append(d + 256 * br)
        brs.append(br)
    assert bv == 0 or brs[31] == 0
    return carries, tb, brs


def _mul_carries(x: int, y: int) -> list[int]:
    """Schoolbook byte-product carries: at output byte position k,
    sum_{i+j=k} x_i*y_j + carry_{k-1} = c_k + 256*carry_k with every
    carry < 2^13 (32 terms of <= 255*255 plus a prior carry)."""
    xb = [(x >> (8 * i)) & 0xFF for i in range(32)]
    yb = [(y >> (8 * j)) & 0xFF for j in range(32)]
    carries = []
    c = 0
    for k in range(32):
        s = sum(xb[i] * yb[k - i] for i in range(k + 1)) + c
        c = s >> 8
        assert c < (1 << 13)
        carries.append(c)
    return carries


def execute_frame(
    code: bytes,
    env: FrameEnv,
    gas: int,
    max_steps: int = 1 << MAX_STEPS_LOG,
    calldata: bytes | None = None,
    storage: dict | None = None,
    warm_slots: set | None = None,
    world: dict | None = None,
    warm_addresses: set | None = None,
    depth: int = 0,
    _tree_addrs: set | None = None,
    acct_ctx: dict | None = None,
    balances: dict | None = None,
    static: bool = False,
    code_addr: int | None = None,
    _tree_storage_addrs: set | None = None,
    _bal_seq: list | None = None,
    nonces: dict | None = None,
) -> FrameTrace:
    """Run the covered-subset stack machine, recording the full witness.

    Semantics mirror evm/interpreter.py exactly for the covered opcodes
    (same gas costs, same stack discipline); anything outside raises
    UncoveredFrame.  Running off the end of code is a virtual STOP
    (interpreter loop exit, interpreter.py:244/706).  ``calldata``
    defaults to env.calldatasize zero bytes; when given it must match
    env.calldatasize (the public CALLDATASIZE word binds the table)."""
    assert 0 <= gas < 1 << MAX_GAS_LOG, "frame gas must stay below 2^28"
    env = env if env.codesize else FrameEnv(**{**env.__dict__, "codesize": len(code)})
    if calldata is None:
        calldata = bytes(env.calldatasize)
    if env.calldatasize == 0 and calldata:
        env = FrameEnv(**{**env.__dict__, "calldatasize": len(calldata)})
    if env.calldatasize != len(calldata) or len(calldata) >= (1 << 15):
        raise UncoveredFrame("calldata size out of coverage")
    cd_loads: dict[int, int] = {}
    jumpdests = set()
    i = 0
    while i < len(code):
        if code[i] == 0x5B:
            jumpdests.add(i)
        if 0x60 <= code[i] <= 0x7F:
            i += code[i] - 0x5F
        i += 1
    env_by_op = {opb: (name, env.words()[i]) for i, (name, opb) in enumerate(ENV_OPS.items())}

    steps: list[_Step] = []
    stack: list[int] = []
    pc = 0
    gas_left = gas
    visit: dict[int, int] = {}
    mem_words: dict[int, int] = {}
    m_words = 0
    keccak_calls: list = []
    arith_calls: list = []
    copy_calls: list = []
    ret_rds = 0
    ret_span = None
    reverted = 0
    # live RETURNDATASIZE (EIP-211): covered env pushes of 0x3D must
    # match it — the in-circuit push binds the CONSTANT env public, so a
    # divergence (push after a call changed rds) must leave coverage
    cur_rds = env.returndatasize
    call_sites: list = []
    # EIP-2929 address access set, shared down the call tree; precompiles
    # and the tree-visited addresses
    warm_addr = warm_addresses if warm_addresses is not None else set()
    prewarm_addr = set(warm_addr)
    tree_addrs = _tree_addrs if _tree_addrs is not None else {env.address}
    # round 5: address revisits ARE covered (delegatecall proxies, repeat
    # transfers) as long as at most ONE frame per address touches storage
    # — the per-address prestate chain stays well-ordered then
    storage_addrs = (
        _tree_storage_addrs if _tree_storage_addrs is not None else set()
    )
    addr_accesses: list = []  # (addr, clk4, cold)
    addr_counts: dict[int, int] = {}
    # balance journal (round 5): live balances shared down the tree,
    # originals snapshotted at tree entry; events (clk4, kind, addr, v)
    bal_live = balances if balances is not None else {}
    bal_originals = dict(bal_live) if depth == 0 else {}
    bal_events: list = []
    # tree-wide monotone sequence: orders a single address's events
    # across interleaved frames when the journal trace is built
    bal_seq = _bal_seq if _bal_seq is not None else [0]
    is_static = bool(static)

    def bal_event(clk4: int, kind: int, addr_i: int, value: int) -> None:
        bal_seq[0] += 1
        bal_events.append((clk4, kind, addr_i, value, bal_seq[0]))

    def bal_read(clk4: int, addr_i: int) -> int:
        if addr_i not in bal_live:
            raise UncoveredFrame("balance outside captured set")
        v = int(bal_live[addr_i])
        bal_event(clk4, 1, addr_i, v)
        return v
    # account-context records: (kind, key, value) -> multiplicity
    # (kind 1 balance, 2 codesize, 3 codehash, 4 blockhash)
    acct_counts: dict[tuple, int] = {}
    # LOGn records (clk, fam_n, offw, size, topics, data words)
    log_records: list = []

    def acct_lookup(kind: int, key_i: int):
        v = (acct_ctx or {}).get((kind, key_i))
        if v is None:
            raise UncoveredFrame("account context outside captured set")
        rec = (kind, key_i, int(v))
        acct_counts[rec] = acct_counts.get(rec, 0) + 1
        return int(v)
    # storage journal: originals are the coverage boundary — slots not in
    # the provided pre-image map make the frame uncovered
    storage_orig = dict(storage or {})
    storage_cur = dict(storage_orig)
    warm = set(warm_slots or ())
    prewarm = set(warm)
    storage_accesses: list = []
    slot_counts: dict[int, int] = {}

    def use(n):
        nonlocal gas_left
        gas_left -= n
        if gas_left < 0:
            raise UncoveredFrame("out of gas")

    def mem_expand(st, needed):
        """Grow the msize register to max(m, needed); returns the dynamic
        gas (3 per new word + quadratic term), recording the witnesses."""
        nonlocal m_words
        if needed > (1 << MAX_MEM_WORDS_LOG):
            raise UncoveredFrame("memory beyond covered bound")
        st.kneed = needed
        st.grow = 1 if needed > m_words else 0
        st.d = needed - m_words - 1 if st.grow else m_words - needed
        old = m_words
        new = needed if st.grow else m_words
        st.r0 = (old * old) % 512
        st.r1 = (new * new) % 512
        st.dq = (new * new - old * old - st.r1 + st.r0) // 512
        m_words = new
        return 3 * (new - old) + st.dq

    while True:
        if len(steps) >= max_steps:
            raise UncoveredFrame("step budget exceeded")
        op = code[pc] if pc < len(code) else 0x00  # virtual STOP
        if op not in COVERED_OPBYTES:
            raise UncoveredFrame(f"opcode 0x{op:02x} not covered")
        visit[pc] = visit.get(pc, 0) + 1
        st = _Step(pc=pc, op=op, name="", fam_n=0, gas_before=gas_left,
                   sp_before=len(stack), m_before=m_words)
        steps.append(st)
        sp = len(stack)

        def pop2():
            if sp < 2:
                raise UncoveredFrame("stack underflow")
            a, b_ = stack.pop(), stack.pop()
            st.accesses.append((0, sp - 1, 0, a))
            st.accesses.append((1, sp - 2, 0, b_))
            return a, b_

        def pop1():
            if sp < 1:
                raise UncoveredFrame("stack underflow")
            a = stack.pop()
            st.accesses.append((0, sp - 1, 0, a))
            return a

        def push(v, at):
            if len(stack) >= 1024:
                raise UncoveredFrame("stack overflow")
            stack.append(v & _M256)
            st.c = v & _M256
            st.accesses.append((2, at, 1, v & _M256))

        if op == 0x00:
            st.name = "stop"
            use(0)
            break
        elif op == 0x01:
            st.name = "add"
            a, b_ = pop2()
            use(3)
            st.a, st.b = a, b_
            st.carries = _add_carries(a, b_)
            push(a + b_, sp - 2)
        elif op == 0x02:
            st.name = "mul"
            a, b_ = pop2()
            use(5)
            st.a, st.b = a, b_
            st.mulc = _mul_carries(a, b_)
            push(a * b_, sp - 2)
        elif op == 0x0A:
            st.name = "exp"
            a, b_ = pop2()  # base, exponent
            st.a, st.b = a, b_
            elen = (b_.bit_length() + 7) // 8
            use(10 + 50 * elen)
            st.qsel = -1  # one-hot lives at SCRATCH0 + elen (33-wide)
            st.mulc = None
            st.expL = elen
            if elen:  # minimality: byte elen-1 is nonzero
                v_top = (b_ >> (8 * (elen - 1))) & 0xFF
                st.s_inv = v_top
                st.inv[0] = pow(v_top, bb.P - 2, bb.P)
            c = pow(a, b_, 1 << 256)
            arith_calls.append((3, a, b_, c))
            push(c, sp - 2)
        elif op in (0x05, 0x07):
            st.name = "sdiv" if op == 0x05 else "smod"
            a, b_ = pop2()
            use(5)
            st.a, st.b = a, b_
            sa_ = a - (1 << 256) if a >> 255 else a
            sb_ = b_ - (1 << 256) if b_ >> 255 else b_
            if sb_ == 0:
                res = 0
            elif op == 0x05:
                res = abs(sa_) // abs(sb_)
                if (sa_ < 0) != (sb_ < 0):
                    res = -res
            else:
                res = abs(sa_) % abs(sb_)
                if sa_ < 0:
                    res = -res
            res &= _M256
            arith_calls.append((1 if op == 0x05 else 2, a, b_, res))
            push(res, sp - 2)
        elif op in (0x04, 0x06):
            st.name = "div" if op == 0x04 else "mod"
            a, b_ = pop2()
            use(5)
            st.a, st.b = a, b_
            st.nz, st.inv, st.s_inv, st.taken = _nonzero_witness(
                [(b_ >> (16 * i)) & 0xFFFF for i in range(16)]
            )
            q, r = (a // b_, a % b_) if b_ else (0, 0)
            st.mulc, st.dmt, st.dmb = _divmod_witness(q, b_, r, a)
            if op == 0x04:
                st.w = r
                push(q, sp - 2)
            else:
                st.w = q
                push(r, sp - 2)
        elif op == 0x0B:
            st.name = "signextend"
            a, b_ = pop2()  # a = byte index k, b = value
            use(5)
            st.a, st.b = a, b_
            st.nz, st.inv, st.s_inv, st.taken = _nonzero_witness(
                [(a >> 5).bit_count()] + [0] * 15
            )
            if st.taken:  # k >= 32: value unchanged
                push(b_, sp - 2)
            else:
                st.qsel = a
                mask = (1 << (8 * a + 8)) - 1
                v = b_ & mask
                if (b_ >> (8 * a + 7)) & 1:
                    v |= _M256 ^ mask
                push(v, sp - 2)
        elif op == 0x03:
            st.name = "sub"
            a, b_ = pop2()
            use(3)
            st.a, st.b = a, b_
            c = (a - b_) & _M256
            st.carries = _add_carries(b_, c)
            push(c, sp - 2)
        elif op in (0x10, 0x11, 0x12, 0x13):
            st.name = {0x10: "lt", 0x11: "gt", 0x12: "slt", 0x13: "sgt"}[op]
            a, b_ = pop2()
            use(3)
            st.a, st.b = a, b_
            af, bf = (_flip(a), _flip(b_)) if op in (0x12, 0x13) else (a, b_)
            if op in (0x10, 0x12):  # lt: B + W = A + k*2^256
                st.w = (af - bf) & _M256
                st.carries = _add_carries(bf, st.w)
            else:  # gt
                st.w = (bf - af) & _M256
                st.carries = _add_carries(af, st.w)
            push(st.carries[15], sp - 2)
        elif op == 0x14:
            st.name = "eq"
            a, b_ = pop2()
            use(3)
            st.a, st.b = a, b_
            limbs = [
                (((a >> (16 * i)) & 0xFFFF) - ((b_ >> (16 * i)) & 0xFFFF)) % bb.P
                for i in range(16)
            ]
            st.nz, st.inv, st.s_inv, st.taken = _nonzero_witness(limbs)
            push(1 - st.taken, sp - 2)
        elif op == 0x15:
            st.name = "iszero"
            a = pop1()
            use(3)
            st.a = a
            limbs = [(a >> (16 * i)) & 0xFFFF for i in range(16)]
            st.nz, st.inv, st.s_inv, st.taken = _nonzero_witness(limbs)
            push(1 - st.taken, sp - 1)
        elif op in (0x16, 0x17, 0x18):
            st.name = {0x16: "and", 0x17: "or", 0x18: "xor"}[op]
            a, b_ = pop2()
            use(3)
            st.a, st.b = a, b_
            c = a & b_ if op == 0x16 else (a | b_ if op == 0x17 else a ^ b_)
            push(c, sp - 2)
        elif op == 0x19:
            st.name = "not"
            a = pop1()
            use(3)
            st.a = a
            push(_M256 ^ a, sp - 1)
        elif op == 0x20:
            st.name = "keccak"
            a, size = pop2()  # a = offset, size = length
            if a % 32 or a >= (1 << 18):
                raise UncoveredFrame("unaligned or far KECCAK256 range")
            if size >= (1 << 13):
                raise UncoveredFrame("KECCAK256 size beyond covered bound")
            if len(keccak_calls) >= MAX_KECCAK_CALLS:
                raise UncoveredFrame("too many KECCAK256 calls")
            st.a, st.b = a, size
            st.nz, st.inv, st.s_inv, st.taken = _nonzero_witness(
                [(size & 0x7FFF).bit_count()] + [0] * 15
            )
            sw = (size + 31) // 32
            st.ksw, st.ksl = sw, 32 * sw - size
            waddr = a // 32
            dyn = mem_expand(st, (waddr + sw) if size else 0)
            use(30 + 6 * sw + dyn)
            words = [mem_words.get(waddr + i, 0) for i in range(sw)]
            st.kreads = [(waddr + i, w) for i, w in enumerate(words)]
            data = b"".join(w.to_bytes(32, "big") for w in words)[:size]
            from ...utils.keccak_py import keccak256

            digest = keccak256(data)
            keccak_calls.append((len(steps) - 1, waddr, size, words, digest))
            push(int.from_bytes(digest, "big"), sp - 2)
        elif op == 0x1A:
            st.name = "byte"
            a, b_ = pop2()  # a = byte index, b = value
            use(3)
            st.a, st.b = a, b_
            st.nz, st.inv, st.s_inv, st.taken = _nonzero_witness(
                [(a >> 5).bit_count()] + [0] * 15
            )
            if st.taken:  # index >= 32
                push(0, sp - 2)
            else:
                st.qsel = a
                push((b_ >> (8 * (31 - a))) & 0xFF, sp - 2)
        elif op in (0x1B, 0x1C, 0x1D):
            st.name = {0x1B: "shl", 0x1C: "shr", 0x1D: "sar"}[op]
            a, b_ = pop2()  # a = shift amount, b = value
            use(3)
            st.a, st.b = a, b_
            st.nz, st.inv, st.s_inv, st.taken = _nonzero_witness(
                [(a >> 8).bit_count()] + [0] * 15
            )
            sign = b_ >> 255
            if st.taken:  # shift >= 256
                push(_M256 * sign if op == 0x1D else 0, sp - 2)
            else:
                s = a & 0xFF
                st.qsel, st.rsel = s >> 3, s & 7
                if op == 0x1B:
                    bp = (b_ << (8 * st.qsel)) & _M256
                    c = (bp << st.rsel) & _M256
                else:
                    sb = b_ - (1 << 256) if (op == 0x1D and sign) else b_
                    bp = (sb >> (8 * st.qsel)) & _M256
                    c = (sb >> (8 * st.qsel + st.rsel)) & _M256
                st.w = bp
                push(c, sp - 2)
        elif op == 0x35:
            st.name = "calldataload"
            a = pop1()
            use(3)
            st.a = a
            size = env.calldatasize
            st.w = (a - size) & _M256
            st.carries = _add_carries(size, st.w)
            if st.carries[15]:  # a < size
                cd_loads[a] = cd_loads.get(a, 0) + 1
                word = calldata[a : a + 32].ljust(32, b"\x00")
                push(int.from_bytes(word, "big"), sp - 1)
            else:
                push(0, sp - 1)
        elif op == 0x37:
            st.name = "calldatacopy"
            if sp < 3:
                raise UncoveredFrame("stack underflow")
            dest, off = pop2()
            size = stack.pop()
            st.accesses.append((2, sp - 3, 0, size))
            if dest % 32 or dest >= (1 << 18):
                raise UncoveredFrame("unaligned or far CALLDATACOPY dest")
            if size >= (1 << 13):
                raise UncoveredFrame("CALLDATACOPY size beyond bound")
            if off >= (1 << 15):
                raise UncoveredFrame("CALLDATACOPY offset beyond bound")
            st.a, st.b, st.w = dest, size, off
            st.nz, st.inv, st.s_inv, st.taken = _nonzero_witness(
                [(size & 0x7FFF).bit_count()] + [0] * 15
            )
            sw = (size + 31) // 32
            slack = 32 * sw - size
            st.ksw, st.ksl = sw, slack
            destw = dest // 32
            dyn = mem_expand(st, (destw + sw) if size else 0)
            use(3 + 3 * sw + dyn)
            words = []
            src_words = []
            tail_old = None
            for i in range(sw):
                src = off + 32 * i
                chunk = calldata[src : src + 32]
                srcw = int.from_bytes(chunk.ljust(32, b"\x00"), "big")
                src_words.append(srcw)
                if slack and i == sw - 1:  # tail splice keeps old bytes
                    t_keep = 8 * slack
                    tail_old = mem_words.get(destw + i, 0)
                    wv = (srcw >> t_keep << t_keep) | (
                        tail_old & ((1 << t_keep) - 1)
                    )
                else:
                    wv = srcw
                words.append(wv)
                mem_words[destw + i] = wv
                if src < env.calldatasize:  # bridge's calldata send
                    cd_loads[src] = cd_loads.get(src, 0) + 1
            copy_calls.append(
                (
                    "calldata", len(steps) - 1, destw, off, sw, slack,
                    words, src_words, tail_old,
                )
            )
        elif op == 0x39:
            st.name = "codecopy"
            if sp < 3:
                raise UncoveredFrame("stack underflow")
            dest, off = pop2()
            size = stack.pop()
            st.accesses.append((2, sp - 3, 0, size))
            if dest % 32 or dest >= (1 << 18):
                raise UncoveredFrame("unaligned or far CODECOPY dest")
            if size >= (1 << 13):
                raise UncoveredFrame("CODECOPY size beyond bound")
            if off >= (1 << 15):
                raise UncoveredFrame("CODECOPY offset beyond bound")
            st.a, st.b, st.w = dest, size, off
            st.nz, st.inv, st.s_inv, st.taken = _nonzero_witness(
                [(size & 0x7FFF).bit_count()] + [0] * 15
            )
            sw = (size + 31) // 32
            slack = 32 * sw - size
            st.ksw, st.ksl = sw, slack
            destw = dest // 32
            dyn = mem_expand(st, (destw + sw) if size else 0)
            use(3 + 3 * sw + dyn)
            words = []
            tail_old = None
            for i in range(sw):
                chunk = code[off + 32 * i : off + 32 * i + 32]
                srcw = int.from_bytes(chunk.ljust(32, b"\x00"), "big")
                if slack and i == sw - 1:
                    t_keep = 8 * slack
                    tail_old = mem_words.get(destw + i, 0)
                    wv = (srcw >> t_keep << t_keep) | (
                        tail_old & ((1 << t_keep) - 1)
                    )
                else:
                    wv = srcw
                words.append(wv)
                mem_words[destw + i] = wv
            copy_calls.append(
                (
                    "code", len(steps) - 1, destw, off, sw, slack,
                    words, None, tail_old,
                )
            )
        elif op == 0x3E:
            st.name = "returndatacopy"
            if sp < 3:
                raise UncoveredFrame("stack underflow")
            dest, off = pop2()
            size = stack.pop()
            st.accesses.append((2, sp - 3, 0, size))
            if size != 0 or off != 0:
                # returndata is empty in a covered frame; offset + size
                # > 0 exceptionally halts (EIP-211 bounds check)
                raise UncoveredFrame("RETURNDATACOPY with data")
            st.a, st.b, st.w = dest, 0, 0
            st.nz, st.inv, st.s_inv, st.taken = _nonzero_witness([0] * 16)
            use(3)
        elif op in (0x31, 0x3B, 0x3F):
            st.name = {0x31: "balance", 0x3B: "extcodesize", 0x3F: "extcodehash"}[op]
            a = pop1()
            st.a = a
            addr = a & ((1 << 160) - 1)
            cold = 0 if (addr in warm_addr or 1 <= addr <= 0x0A) else 1
            warm_addr.add(addr)
            st.scold = cold
            addr_accesses.append((addr, 4 * (len(steps) - 1), cold))
            addr_counts[addr] = addr_counts.get(addr, 0) + 1
            use(100 + 2500 * cold)
            if op == 0x31:
                # BALANCE reads the live balance journal (round 5): the
                # running balance, not a static context record
                push(bal_read(4 * (len(steps) - 1), addr), sp - 1)
            else:
                kind = {0x3B: 2, 0x3F: 3}[op]
                push(acct_lookup(kind, addr), sp - 1)
        elif op == 0x40:
            st.name = "blockhash"
            n_arg = pop1()
            st.a = n_arg
            use(20)
            if n_arg >= (1 << 160):
                raise UncoveredFrame("BLOCKHASH number beyond 160 bits")
            push(acct_lookup(4, n_arg), sp - 1)
        elif op == 0x47:
            st.name = "selfbalance"
            use(5)
            push(bal_read(4 * (len(steps) - 1), env.address), sp)
        elif op in (0xF0, 0xF5):
            # CREATE / CREATE2: two rows; the initcode runs as a child
            # frame whose CODE is bound to the caller's memory span by a
            # kind-4 bridge; the new address is pushed as the createret
            # row's B word and bound to the child's env.address through
            # the CALLREQ (its keccak derivation is a relativized
            # public, docs/SOUNDNESS.md)
            st.name = "create"
            kc2 = 1 if op == 0xF5 else 0
            nargs = 3 + kc2
            if sp < nargs:
                raise UncoveredFrame("stack underflow")
            if world is None:
                raise UncoveredFrame("no world state for CREATE")
            if depth >= 8:
                raise UncoveredFrame("call depth beyond coverage")
            if is_static:
                raise UncoveredFrame("CREATE in a static context")
            value = stack.pop()
            offset = stack.pop()
            size = stack.pop()
            salt = stack.pop() if kc2 else 0
            if offset % 32 or offset >= (1 << 18):
                raise UncoveredFrame("unaligned or far CREATE range")
            if size >= (1 << 13):
                raise UncoveredFrame("initcode beyond covered bound")
            st.a, st.b, st.c, st.w = offset, size, salt, value
            st.kc2 = kc2
            st.accesses = [
                (0, sp - 2, 0, offset),
                (1, sp - 3, 0, size),
                (3, sp - 1, 0, value),
            ] + ([(2, sp - 4, 0, salt)] if kc2 else [])
            # [size != 0] through the row's nonzero gadget (f_kr group)
            st.nz, st.inv, st.s_inv, st.taken = _nonzero_witness(
                [(size & 0x7FFF).bit_count()] + [0] * 15
            )
            sw = (size + 31) // 32
            st.ksw, st.ksl = sw, 32 * sw - size
            st.callw = {
                "bigreq": 0, "invh": 0, "tr": 0, "invr": 0, "mm": 0,
                "dmax": 0, "argneed": 0, "retneed": 0, "cfid": 0,
            }
            use(32000 + (2 + 6 * kc2) * sw)
            use(mem_expand(st, (offset // 32 + sw) if size else 0))
            clk_call = len(steps) - 1
            if value:
                if bal_live.get(env.address, 0) < value:
                    raise UncoveredFrame("insufficient balance for CREATE")
            initcode_words = [
                mem_words.get(offset // 32 + j, 0) for j in range(sw)
            ]
            initcode = b"".join(
                wv.to_bytes(32, "big") for wv in initcode_words
            )[:size]
            # address derivation (relativized public; exact host keccak)
            from ...utils import keccak256 as _kec

            if kc2:
                new_addr = int.from_bytes(
                    _kec(
                        b"\xff"
                        + env.address.to_bytes(20, "big")
                        + salt.to_bytes(32, "big")
                        + _kec(initcode)
                    )[12:],
                    "big",
                )
            else:
                if nonces is None or env.address not in nonces:
                    raise UncoveredFrame("creator nonce outside captured set")
                from ...proto import rlp as _rlp

                n_cr = int(nonces[env.address])
                n_bytes = (
                    n_cr.to_bytes((n_cr.bit_length() + 7) // 8, "big")
                    if n_cr
                    else b""
                )
                new_addr = int.from_bytes(
                    _kec(
                        _rlp.encode(
                            [env.address.to_bytes(20, "big"), n_bytes]
                        )
                    )[12:],
                    "big",
                )
                nonces[env.address] = n_cr + 1
            if new_addr in tree_addrs:
                raise UncoveredFrame("created address revisited")
            # all-but-1/64 forwarding (no gas argument, no stipend)
            avail = gas_left
            q64, r64 = avail // 64, avail % 64
            child_gas0 = 63 * q64 + r64
            # the createret row
            st2 = _Step(
                pc=pc, op=op, name="createret", fam_n=0,
                gas_before=gas_left, sp_before=sp, m_before=m_words,
            )
            steps.append(st2)
            visit[pc] = visit.get(pc, 0) + 1
            st2.a, st2.b = value, new_addr
            st2.kc2 = kc2
            st2.nz, st2.inv, st2.s_inv, st2.taken = _nonzero_witness(
                [(value >> (16 * i)) & 0xFFFF for i in range(16)]
            )
            if value:
                bal_event(4 * clk_call + 2, 2, env.address, value)
                bal_event(4 * clk_call + 3, 3, new_addr, value)
                bal_live[env.address] -= value
                bal_live[new_addr] = bal_live.get(new_addr, 0) + value
            tree_addrs.add(new_addr)
            cenv = FrameEnv(
                address=new_addr,
                origin=env.origin,
                caller=env.address,
                callvalue=value,
                calldatasize=0,
                codesize=len(initcode),
                gasprice=env.gasprice,
                returndatasize=0,
                coinbase=env.coinbase,
                timestamp=env.timestamp,
                number=env.number,
                prevrandao=env.prevrandao,
                gaslimit=env.gaslimit,
                chainid=env.chainid,
                basefee=env.basefee,
                blobbasefee=env.blobbasefee,
            )
            child = execute_frame(
                initcode,
                cenv,
                child_gas0,
                max_steps,
                calldata=b"",
                storage={},
                warm_slots=set(),
                world=world,
                warm_addresses=warm_addr,
                depth=depth + 1,
                _tree_addrs=tree_addrs,
                acct_ctx=acct_ctx,
                balances=bal_live,
                static=False,
                code_addr=new_addr,
                _tree_storage_addrs=storage_addrs,
                _bal_seq=bal_seq,
                nonces=nonces,
            )
            if child.reverted:
                raise UncoveredFrame("reverting initcode not covered")
            gas_ret = child.gas_f
            rds_child = child.rds
            deployed = (
                b"".join(
                    wv.to_bytes(32, "big") for wv in child.ret_span[2]
                )[:rds_child]
                if child.ret_span
                else b""
            )
            if gas_ret < 200 * rds_child:
                raise UncoveredFrame("CREATE deposit out of gas")
            use(child_gas0 - gas_ret + 200 * rds_child)
            world[new_addr] = {"code": deployed, "storage": {}}
            cur_rds = 0  # successful CREATE clears returndata
            st2.callw = {
                "q": q64,
                "r": r64,
                "m": 0,
                "d": 0,
                "gasin": child_gas0,
                "gasret": gas_ret,
                "rds": rds_child,
                "rdiff": 0,
            }
            call_sites.append(
                {
                    "clk": clk_call,
                    "addr": new_addr,
                    "cold": 0,
                    "gas_in": child_gas0,
                    "args_offw": offset // 32,
                    "args_sw": sw,
                    "args_words": initcode_words if size else [],
                    "ret_offw": 0,
                    "ret_sw": 0,
                    "precompile": None,
                    "callee": child,
                    "static": 0,
                    "kdel": 0,
                    "ksta": 0,
                    "create": 1,
                    "kc2": kc2,
                    "rds": rds_child,
                    "gas_ret": gas_ret,
                    "ret_words": [],
                }
            )
            if len(stack) >= 1024:
                raise UncoveredFrame("stack overflow")
            stack.append(new_addr)
            st2.accesses.append((3, sp - 3 - kc2, 1, new_addr))
        elif op in (0xF1, 0xF4, 0xFA):
            # CALL / DELEGATECALL / STATICCALL (docs/EVM_COMPOSITION.md):
            # two rows, the callee as its own frame bound through
            # CALLREQ/CALLRET; coverage: 32-byte-aligned arg/ret ranges,
            # retSize <= rds, value-bearing only through the balance
            # journal, at most one storage-active frame per address
            st.name = "call"
            kdel = 1 if op == 0xF4 else 0
            ksta = 1 if op == 0xFA else 0
            k6 = kdel or ksta
            nargs = 6 if k6 else 7
            if sp < nargs:
                raise UncoveredFrame("stack underflow")
            if world is None:
                raise UncoveredFrame("no world state for CALL")
            if depth >= 8:
                raise UncoveredFrame("call depth beyond coverage")
            g_req = stack.pop()
            addr_w = stack.pop()
            value = 0 if k6 else stack.pop()
            args_off = stack.pop()
            args_size = stack.pop()
            ret_off = stack.pop()
            ret_size = stack.pop()
            if value != 0 and is_static:
                raise UncoveredFrame("value CALL in a static context")
            if any(v % 32 for v in (args_off, args_size, ret_off, ret_size)):
                raise UncoveredFrame("unaligned CALL memory range")
            if args_off >= (1 << 18) or ret_off >= (1 << 18):
                raise UncoveredFrame("far CALL memory range")
            if args_size >= (1 << 13) or ret_size >= (1 << 13):
                raise UncoveredFrame("CALL range beyond coverage")
            addr = addr_w & ((1 << 160) - 1)
            st.a, st.b, st.c, st.w = args_off, addr_w, args_size, g_req
            st.kdel, st.ksta = kdel, ksta
            st.accesses = [
                (0, sp - 4 + k6, 0, args_off),
                (1, sp - 2, 0, addr_w),
                (2, sp - 5 + k6, 0, args_size),
                (3, sp - 1, 0, g_req),
            ]
            # [argsSize != 0] through the row's nonzero gadget (popcount
            # of C's low 15 bits, like the f_kr sizes)
            st.nz, st.inv, st.s_inv, st.taken = _nonzero_witness(
                [(args_size & 0x7FFF).bit_count()] + [0] * 15
            )
            asw = (args_size + 31) // 32
            rsw = (ret_size + 31) // 32
            st.ksw, st.ksl = asw, 0
            cold = 0 if (addr in warm_addr or 1 <= addr <= 0x0A) else 1
            warm_addr.add(addr)
            st.scold = cold
            clk_call = len(steps) - 1
            addr_accesses.append((addr, 4 * clk_call, cold))
            addr_counts[addr] = addr_counts.get(addr, 0) + 1
            use(100 + 2500 * cold)
            argneed = (args_off // 32 + asw) if args_size else 0
            retneed = (ret_off // 32 + rsw) if ret_size else 0
            use(mem_expand(st, max(argneed, retneed)))
            if value:
                # EIP-150 CallValueTransferGas, charged before the 63/64
                # cap; the 25000 new-account surcharge stays uncovered,
                # so the target must provably be non-empty
                if addr not in bal_live:
                    raise UncoveredFrame("value CALL outside balance set")
                info0 = world.get(addr)
                if bal_live[addr] == 0 and not (info0 and info0.get("code")):
                    raise UncoveredFrame("value CALL to maybe-empty account")
                if bal_live.get(env.address, 0) < value:
                    raise UncoveredFrame("insufficient balance for CALL")
                use(9000)
            # call-row witnesses: the max gadget + requested-gas flags
            h_pop = bin(g_req >> MAX_GAS_LOG).count("1")
            bigreq = 1 if h_pop else 0
            r_pop = (ret_size & 0x7FFF).bit_count()
            st.callw = {
                "bigreq": bigreq,
                "invh": pow(h_pop, bb.P - 2, bb.P) if h_pop else 0,
                "tr": 1 if ret_size else 0,
                "invr": pow(r_pop, bb.P - 2, bb.P) if r_pop else 0,
                "mm": 1 if argneed >= retneed else 0,
                "dmax": abs(argneed - retneed),
                "argneed": argneed,
                "retneed": retneed,
                "cfid": 0,  # assigned at prove time (fid of the callee)
            }
            # 63/64 forwarding (EIP-150): avail is the gas after the base
            # + value + expansion charges — this row's post-charge gas
            avail = gas_left
            q64, r64 = avail // 64, avail % 64
            cap = 63 * q64 + r64
            reqlo = g_req & ((1 << MAX_GAS_LOG) - 1)
            m_sel = 1 if (bigreq or g_req > cap) else 0
            gas_in = cap if m_sel else g_req
            dmin = (reqlo + (bigreq << MAX_GAS_LOG) - cap) if m_sel else (cap - reqlo)
            # the callee's gas0 includes the 2300 stipend on value calls
            child_gas0 = gas_in + (2300 if value else 0)
            # args bytes from caller memory (fresh reads are zero)
            args_words = [
                mem_words.get(args_off // 32 + j, 0) for j in range(asw)
            ]
            args_data = b"".join(
                wv.to_bytes(32, "big") for wv in args_words
            )[:args_size]
            # the callret row
            st2 = _Step(
                pc=pc, op=op, name="callret", fam_n=0,
                gas_before=gas_left, sp_before=sp, m_before=m_words,
            )
            steps.append(st2)
            visit[pc] = visit.get(pc, 0) + 1
            st2.a, st2.b, st2.c = (0 if k6 else value), ret_off, ret_size
            st2.kdel, st2.ksta = kdel, ksta
            st2.ksw, st2.ksl = rsw, 0
            # the callret row's nonzero gadget carries [value != 0]
            st2.nz, st2.inv, st2.s_inv, st2.taken = _nonzero_witness(
                [((0 if k6 else value) >> (16 * i)) & 0xFFFF for i in range(16)]
            )
            st2.accesses = (
                [] if k6 else [(0, sp - 3, 0, value)]
            ) + [
                (1, sp - 6 + k6, 0, ret_off),
                (2, sp - 7 + k6, 0, ret_size),
            ]
            # balance-journal debit/credit at the call row's sub-clocks
            # +2 / +3 (value transfers happen before the callee runs)
            if value:
                bal_event(4 * clk_call + 2, 2, env.address, value)
                bal_event(4 * clk_call + 3, 3, addr, value)
                bal_live[env.address] -= value
                bal_live[addr] = bal_live.get(addr, 0) + value
            # execute the callee
            child_static = is_static or bool(ksta)
            site = {
                "clk": clk_call,
                "addr": addr,
                "cold": cold,
                "gas_in": child_gas0,
                "args_offw": args_off // 32,
                "args_sw": asw,
                "args_words": args_words if args_size else [],
                "ret_offw": ret_off // 32,
                "ret_sw": rsw if ret_size else 0,
                "precompile": None,
                "callee": None,
                "static": 1 if child_static else 0,
                "kdel": kdel,
                "ksta": ksta,
            }
            if 1 <= addr <= 0x0A:
                if addr != 0x04:
                    raise UncoveredFrame("precompile not covered")
                if kdel:
                    raise UncoveredFrame("DELEGATECALL to precompile")
                if value:
                    raise UncoveredFrame("value to precompile not covered")
                pcost = 15 + 3 * asw
                if child_gas0 < pcost:
                    raise UncoveredFrame("precompile out of gas")
                gas_ret = child_gas0 - pcost
                rds_child = args_size
                out_words = list(args_words)
                success = 1
                site["precompile"] = "identity"
            else:
                info = world.get(addr)
                ccode = bytes(info["code"]) if info and info.get("code") else b""
                if not ccode and not k6 and value == 0 and addr not in bal_live:
                    # plain zero-value call to an unknown codeless target:
                    # can't distinguish existing-empty from nonexistent
                    raise UncoveredFrame("codeless callee outside balance set")
                tree_addrs.add(addr)
                if kdel:
                    # DELEGATECALL: target CODE in the CALLER's context —
                    # address/caller/callvalue/storage all the parent's
                    cenv = FrameEnv(
                        **{
                            **env.__dict__,
                            "calldatasize": args_size,
                            "codesize": len(ccode),
                            "returndatasize": 0,
                        }
                    )
                    cstorage = dict(storage_cur)
                    cwarm = set(warm)
                else:
                    cenv = FrameEnv(
                        address=addr,
                        origin=env.origin,
                        caller=env.address,
                        callvalue=value,
                        calldatasize=args_size,
                        codesize=len(ccode),
                        gasprice=env.gasprice,
                        returndatasize=0,
                        coinbase=env.coinbase,
                        timestamp=env.timestamp,
                        number=env.number,
                        prevrandao=env.prevrandao,
                        gaslimit=env.gaslimit,
                        chainid=env.chainid,
                        basefee=env.basefee,
                        blobbasefee=env.blobbasefee,
                    )
                    cstorage = (info or {}).get("storage")
                    cwarm = (info or {}).get("warm_slots")
                child = execute_frame(
                    ccode,
                    cenv,
                    child_gas0,
                    max_steps,
                    calldata=args_data,
                    storage=cstorage,
                    warm_slots=cwarm,
                    world=world,
                    warm_addresses=warm_addr,
                    depth=depth + 1,
                    _tree_addrs=tree_addrs,
                    acct_ctx=acct_ctx,
                    balances=bal_live,
                    static=child_static,
                    code_addr=addr,
                    _tree_storage_addrs=storage_addrs,
                    _bal_seq=bal_seq,
                    nonces=nonces,
                )
                gas_ret = child.gas_f
                rds_child = child.rds
                out_words = list(child.ret_span[2]) if child.ret_span else []
                success = 0 if child.reverted else 1
                if not success and value:
                    # a reverted value call rolls the transfer back —
                    # outside the effect-free-revert coverage (v1)
                    raise UncoveredFrame("reverted value CALL")
                site["callee"] = child
            if ret_size:
                if rds_child < ret_size:
                    raise UncoveredFrame(
                        "returndata shorter than retSize not covered"
                    )
                for j in range(rsw):
                    mem_words[ret_off // 32 + j] = out_words[j]
                site["ret_words"] = out_words[:rsw]
            else:
                site["ret_words"] = []
            cur_rds = rds_child
            use(gas_in - gas_ret)
            st2.callw = {
                "q": q64,
                "r": r64,
                "m": m_sel,
                "d": dmin,
                "gasin": child_gas0,
                "gasret": gas_ret,
                "rds": rds_child,
                "rdiff": (rds_child - ret_size) if ret_size else 0,
            }
            site["gas_ret"] = gas_ret
            site["rds"] = rds_child
            call_sites.append(site)
            # push the callee's success bit (0 for a reverted callee)
            if len(stack) >= 1024:
                raise UncoveredFrame("stack overflow")
            stack.append(success)
            st2.w = success
            st2.accesses.append((3, sp - 7 + k6, 1, success))
        elif op == 0x50:
            st.name = "pop"
            a = pop1()
            use(2)
            st.a = a
        elif op == 0x51:
            st.name = "mload"
            a = pop1()
            if a >= (1 << 18):
                raise UncoveredFrame("far memory access")
            st.a = a
            waddr = a // 32
            k = a % 32
            st.qsel = k
            st.nz, st.inv, st.s_inv, st.taken = _nonzero_witness(
                [k] + [0] * 15
            )
            use(3 + mem_expand(st, waddr + 1 + (1 if k else 0)))
            w1 = mem_words.get(waddr, 0)
            st.b = w1
            st.mem_access = (waddr, 0, w1)
            if k:
                w2 = mem_words.get(waddr + 1, 0)
                st.w = w2
                st.mem_access2 = (waddr + 1, 0, w2)
                v = ((w1 << (8 * k)) | (w2 >> (8 * (32 - k)))) & _M256
            else:
                v = w1
            push(v, sp - 1)
        elif op == 0x52:
            st.name = "mstore"
            a, v = pop2()  # a = offset, v = value
            if a >= (1 << 18):
                raise UncoveredFrame("far memory access")
            st.a, st.b = a, v
            waddr = a // 32
            k = a % 32
            st.qsel = k
            st.nz, st.inv, st.s_inv, st.taken = _nonzero_witness(
                [k] + [0] * 15
            )
            use(3 + mem_expand(st, waddr + 1 + (1 if k else 0)))
            old1 = mem_words.get(waddr, 0)
            st.c = old1
            st.mem_access = (waddr, 0, old1)
            if k == 0:
                new1 = v
                st.mem_access3 = (waddr, 1, new1)
                mem_words[waddr] = new1
            else:
                old2 = mem_words.get(waddr + 1, 0)
                st.w = old2
                keep_hi = 8 * (32 - k)  # bits of word 1 kept (value terms)
                new1 = (old1 >> keep_hi << keep_hi) | (v >> (8 * k))
                new2 = ((v << keep_hi) & _M256) | (
                    old2 & ((1 << keep_hi) - 1)
                )
                st.mem_access2 = (waddr + 1, 0, old2)
                st.mem_access3 = (waddr, 1, new1)
                st.mem_access4 = (waddr + 1, 1, new2)
                mem_words[waddr] = new1
                mem_words[waddr + 1] = new2
        elif op == 0x53:
            st.name = "mstore8"
            a, v = pop2()  # a = offset, v = value
            if a >= (1 << 18):
                raise UncoveredFrame("far memory access")
            st.a, st.b = a, v
            waddr = a // 32
            k = a % 32  # big-endian byte index within the word
            st.qsel = k
            use(3 + mem_expand(st, waddr + 1))
            old = mem_words.get(waddr, 0)
            st.w = old
            shift = 8 * (31 - k)
            new = (old & ~(0xFF << shift)) | ((v & 0xFF) << shift)
            mem_words[waddr] = new
            st.c = new
            st.mem_access = (waddr, 0, old)
            st.mem_access2 = (waddr, 1, new)
        elif op == 0x54:
            st.name = "sload"
            a = pop1()
            if a not in storage_orig:
                raise UncoveredFrame("storage slot outside captured set")
            st.a = a
            st.scold = 0 if a in warm else 1
            warm.add(a)
            use(2100 if st.scold else 100)
            v = storage_cur[a]
            push(v, sp - 1)
            slot_counts[a] = slot_counts.get(a, 0) + 1
            storage_accesses.append(
                (a, 4 * (len(steps) - 1), 0, v, st.scold, 0, 0)
            )
        elif op == 0x55:
            st.name = "sstore"
            if is_static:
                raise UncoveredFrame("SSTORE in a static context")
            if gas_left <= 2300:
                raise UncoveredFrame("SSTORE sentry (EIP-2200)")
            st.nz, st.inv, st.s_inv, st.taken = _nonzero_witness(
                [(gas_left >> 12).bit_count()] + [0] * 15
            )
            st.sentry = 0 if st.taken else (gas_left & 0xFFF) - 2301
            a, new = pop2()
            if a not in storage_orig:
                raise UncoveredFrame("storage slot outside captured set")
            st.a, st.b = a, new
            st.scold = 0 if a in warm else 1
            warm.add(a)
            cur = storage_cur[a]
            orig = storage_orig[a]
            if new != cur and cur == orig:
                if orig == 0:
                    st.sg2 = 1
                else:
                    st.sg1 = 1
            cost = 100 + 2800 * st.sg1 + 19900 * st.sg2 + 2100 * st.scold
            use(cost)
            storage_cur[a] = new
            slot_counts[a] = slot_counts.get(a, 0) + 1
            storage_accesses.append(
                (a, 4 * (len(steps) - 1), 1, new, st.scold, st.sg1, st.sg2)
            )
        elif op == 0x59:
            st.name = "msize"
            use(2)
            push(32 * m_words, sp)
        elif op == 0xF3:
            st.name = "return"
            a, size = pop2()  # a = offset, size = length
            if a % 32 or a >= (1 << 18):
                raise UncoveredFrame("unaligned or far RETURN range")
            if size >= (1 << 13):
                raise UncoveredFrame("RETURN size beyond covered bound")
            st.a, st.b = a, size
            st.nz, st.inv, st.s_inv, st.taken = _nonzero_witness(
                [(size & 0x7FFF).bit_count()] + [0] * 15
            )
            sw = (size + 31) // 32
            st.ksw, st.ksl = sw, 32 * sw - size
            use(mem_expand(st, (a // 32 + sw) if size else 0))
            ret_rds = size
            if size:
                ret_span = (
                    len(steps) - 1,
                    a // 32,
                    [mem_words.get(a // 32 + i, 0) for i in range(sw)],
                )
            break
        elif op == 0xFD:
            # REVERT (round 5): third halt opcode with a returndata span.
            # Coverage v1: the frame must be EFFECT-FREE (no storage
            # writes, no logs, no calls, no balance deltas) so the
            # rollback is a no-op — require()-guard reverts, the common
            # real-block shape.  Effectful reverts stay uncovered.
            st.name = "revert"
            if any(acc[2] for acc in storage_accesses):
                raise UncoveredFrame("REVERT after storage writes")
            if log_records or call_sites:
                raise UncoveredFrame("REVERT after logs or calls")
            if any(ev[1] != 1 for ev in bal_events):
                raise UncoveredFrame("REVERT after value transfer")
            a, size = pop2()  # a = offset, size = length
            if a % 32 or a >= (1 << 18):
                raise UncoveredFrame("unaligned or far REVERT range")
            if size >= (1 << 13):
                raise UncoveredFrame("REVERT size beyond covered bound")
            st.a, st.b = a, size
            st.nz, st.inv, st.s_inv, st.taken = _nonzero_witness(
                [(size & 0x7FFF).bit_count()] + [0] * 15
            )
            sw = (size + 31) // 32
            st.ksw, st.ksl = sw, 32 * sw - size
            use(mem_expand(st, (a // 32 + sw) if size else 0))
            ret_rds = size
            reverted = 1
            if size:
                ret_span = (
                    len(steps) - 1,
                    a // 32,
                    [mem_words.get(a // 32 + i, 0) for i in range(sw)],
                )
            break
        elif 0xA0 <= op <= 0xA4:
            st.name = "log"
            if is_static:
                raise UncoveredFrame("LOG in a static context")
            st.fam_n = op - 0x9F  # topics = fam_n - 1
            topics = op - 0xA0
            if sp < 2 + topics:
                raise UncoveredFrame("stack underflow")
            a, size = pop2()  # offset, size (stack-channel reads)
            if a % 32 or a >= (1 << 18):
                raise UncoveredFrame("unaligned or far LOG range")
            if size >= (1 << 13):
                raise UncoveredFrame("LOG size beyond covered bound")
            st.a, st.b = a, size
            st.nz, st.inv, st.s_inv, st.taken = _nonzero_witness(
                [(size & 0x7FFF).bit_count()] + [0] * 15
            )
            sw = (size + 31) // 32
            st.ksw, st.ksl = sw, 32 * sw - size
            dyn = mem_expand(st, (a // 32 + sw) if size else 0)
            use(375 * (topics + 1) + 8 * size + dyn)
            # the logext row: topic values are REAL stack reads, and the
            # (topics, data span) record feeds BUS_LG + a data bridge —
            # the execution side of the receipt binding
            clk_log = len(steps) - 1
            st2 = _Step(
                pc=pc, op=op, name="logext", fam_n=st.fam_n,
                gas_before=gas_left, sp_before=sp - 2, m_before=m_words,
            )
            steps.append(st2)
            visit[pc] = visit.get(pc, 0) + 1
            tvals = [0, 0, 0, 0]
            for t_i in range(topics):
                tv = stack.pop()
                tvals[t_i] = tv
                st2.accesses.append((t_i, sp - 3 - t_i, 0, tv))
            st2.a, st2.b, st2.c, st2.w = tvals
            data_words = [
                mem_words.get(a // 32 + i, 0) for i in range(sw)
            ]
            bal_seq[0] += 1
            log_records.append(
                {
                    "clk": clk_log,
                    "fam_n": st.fam_n,
                    "offw": a // 32,
                    "size": size,
                    "topics": tvals,
                    "data_words": data_words if size else [],
                    # tree-global emission order (receipts-link payload
                    # field; lying about it changes the re-derived
                    # receipts-trie root, which must match the proven
                    # containment root — self-correcting)
                    "seq": bal_seq[0],
                }
            )
        elif op == 0x56:
            st.name = "jump"
            use(8)
            dest = pop1()
            st.a = dest
            if dest not in jumpdests:
                raise UncoveredFrame("bad jump")
            pc = dest
            continue
        elif op == 0x57:
            st.name = "jumpi"
            use(10)
            dest, cond = pop2()
            st.a, st.b = dest, cond
            limbs = [(cond >> (16 * i)) & 0xFFFF for i in range(16)]
            st.nz, st.inv, st.s_inv, st.taken = _nonzero_witness(limbs)
            if cond:
                if dest not in jumpdests:
                    raise UncoveredFrame("bad jump")
                pc = dest
                continue
        elif op == 0x58:
            st.name = "pc"
            use(2)
            push(pc, sp)
        elif op == 0x5A:
            st.name = "gas"
            use(2)
            push(gas_left, sp)
        elif op == 0x5B:
            st.name = "jumpdest"
            use(1)
        elif op == 0x5F:
            st.name = "push0"
            use(2)
            push(0, sp)
        elif 0x60 <= op <= 0x7F:
            st.name = "push"
            st.fam_n = op - 0x5F
            use(3)
            v = int.from_bytes(code[pc + 1 : pc + 1 + st.fam_n], "big")
            push(v, sp)
            pc += 1 + st.fam_n
            continue
        elif 0x80 <= op <= 0x8F:
            st.name = "dup"
            st.fam_n = op - 0x7F
            if sp < st.fam_n:
                raise UncoveredFrame("stack underflow")
            use(3)
            v = stack[-st.fam_n]
            st.a = v
            st.accesses.append((0, sp - st.fam_n, 0, v))
            push(v, sp)
        elif 0x90 <= op <= 0x9F:
            st.name = "swap"
            st.fam_n = op - 0x8F
            if sp < st.fam_n + 1:
                raise UncoveredFrame("stack underflow")
            use(3)
            a, b_ = stack[-1], stack[-1 - st.fam_n]
            st.a, st.b = a, b_
            stack[-1], stack[-1 - st.fam_n] = b_, a
            st.accesses.append((0, sp - 1, 0, a))
            st.accesses.append((1, sp - 1 - st.fam_n, 0, b_))
            st.accesses.append((2, sp - 1, 1, b_))
            st.accesses.append((3, sp - 1 - st.fam_n, 1, a))
        elif op in env_by_op:
            st.name, v = env_by_op[op]
            use(2)
            if op == 0x3D and v != cur_rds:
                # the in-circuit push binds the CONSTANT env public; a
                # post-call RETURNDATASIZE that diverges from it would be
                # mis-proven — leave coverage instead
                raise UncoveredFrame("RETURNDATASIZE diverges from env")
            push(v, sp)
        else:  # pragma: no cover — COVERED_OPBYTES gate above
            raise UncoveredFrame(f"opcode 0x{op:02x} not covered")
        pc += 1

    if storage_accesses:
        # at most ONE frame per address may touch storage in a tree (the
        # per-address prestate chain has no global clock across frames)
        if env.address in storage_addrs:
            raise UncoveredFrame("two storage-active frames at one address")
        storage_addrs.add(env.address)
    return FrameTrace(
        code=code,
        env=env,
        gas0=gas,
        steps=steps,
        gas_f=gas_left,
        sp_f=len(stack),
        visit_counts=visit,
        calldata=calldata,
        cd_loads=cd_loads,
        m_final=m_words,
        keccak_calls=keccak_calls,
        arith_calls=arith_calls,
        copy_calls=copy_calls,
        storage_accesses=storage_accesses,
        storage_groups=sorted(
            (
                slot,
                storage_orig[slot],
                cnt,
                1 if slot in prewarm else 0,
                storage_cur[slot],
            )
            for slot, cnt in slot_counts.items()
        ),
        rds=ret_rds,
        ret_span=ret_span,
        call_sites=call_sites,
        addr_accesses=addr_accesses,
        addr_groups=sorted(
            (a, cnt, 1 if (a in prewarm_addr or 1 <= a <= 0x0A) else 0)
            for a, cnt in addr_counts.items()
        ),
        acct_groups=sorted(
            (k, key, v, cnt) for (k, key, v), cnt in acct_counts.items()
        ),
        log_records=log_records,
        bal_events=bal_events,
        bal_originals=bal_originals,
        bal_finals=(dict(bal_live) if depth == 0 else {}),
        static=1 if is_static else 0,
        reverted=reverted,
        code_addr=env.address if code_addr is None else int(code_addr),
    )


# --------------------------------------------------------------------------
# trace building (numpy)
# --------------------------------------------------------------------------


def _word_bits(v: int) -> np.ndarray:
    out = np.zeros(256, dtype=np.uint32)
    for k in range(256):
        if (v >> k) & 1:
            out[k] = 1
    return out


def _pow2_atleast(k: int, floor: int = 32) -> int:
    n = floor
    while n < k:
        n <<= 1
    return n


def build_cpu_trace(ft: FrameTrace) -> tuple[np.ndarray, list[int]]:
    """(n, CPU_WIDTH) main trace + the publics vector."""
    steps = ft.steps
    n = _pow2_atleast(len(steps) + 1)
    tr = np.zeros((n, CPU_WIDTH), dtype=np.uint32)
    for clk, st in enumerate(steps):
        row = tr[clk]
        row[PC] = st.pc
        row[OP] = st.op
        row[CLK] = clk
        row[TAKEN] = st.taken
        row[S_INV] = st.s_inv
        row[FLAG0 + FLAG_IDX[st.name]] = 1
        if st.fam_n:
            for i in range(5):
                row[FAMB0 + i] = (st.fam_n - 1 >> i) & 1
        sp = st.sp_before
        if sp == 1024:
            row[SP_TOP] = 1
        else:
            for i in range(10):
                row[SPB0 + i] = (sp >> i) & 1
        for i in range(32):
            row[GASB0 + i] = (st.gas_before >> i) & 1
        for i in range(16):
            row[CARRY0 + i] = st.carries[i]
            row[NZ0 + i] = st.nz[i]
            row[INV0 + i] = st.inv[i]
        if st.mulc is not None:
            for k in range(32):
                for t in range(13):
                    row[MULC0 + 13 * k + t] = (st.mulc[k] >> t) & 1
        if st.dmt is not None:
            for k in range(32):
                row[DMB0 + k] = st.dmb[k]
                for t in range(8):
                    row[DMT0 + 8 * k + t] = (st.dmt[k] >> t) & 1
        if st.qsel >= 0:
            row[OHQ0 + st.qsel] = 1
        if st.rsel >= 0:
            row[OHR0 + st.rsel] = 1
        if st.expL >= 0:
            row[SCRATCH0 + st.expL] = 1
        row[SCOLD] = st.scold
        row[SG1] = st.sg1
        row[SG2] = st.sg2
        row[KDEL] = st.kdel
        row[KSTA] = st.ksta
        row[KC2] = st.kc2
        if st.name == "sstore":
            for i in range(12):
                row[MULC0 + i] = (st.sentry >> i) & 1
        row[MW_GROW] = st.grow
        for i in range(14):
            row[MW_D0 + i] = (st.d >> i) & 1
        for i in range(9):
            row[MW_R0 + i] = (st.r0 >> i) & 1
            row[MW_R1 + i] = (st.r1 >> i) & 1
        for i in range(18):
            row[MW_DQ0 + i] = (st.dq >> i) & 1
        for i in range(14):
            row[MEMB0 + i] = (st.m_before >> i) & 1
        for i in range(10):
            row[KSW0 + i] = (st.ksw >> i) & 1
        for i in range(5):
            row[KSL0 + i] = (st.ksl >> i) & 1
        row[KNEED] = st.kneed
        if st.callw is not None:
            cw = st.callw
            if st.name in ("call", "create"):
                row[SCRATCH0 + CW_BIGREQ] = cw["bigreq"]
                row[SCRATCH0 + CW_TR] = cw["tr"]
                row[SCRATCH0 + CW_MM] = cw["mm"]
                for i in range(16):
                    row[SCRATCH0 + CW_CFID0 + i] = (cw["cfid"] >> i) & 1
                for i in range(14):
                    row[SCRATCH0 + CW_DMAX0 + i] = (cw["dmax"] >> i) & 1
                row[CC_INVH] = cw["invh"]
                row[CC_INVR] = cw["invr"]
                row[CC_ARGNEED] = cw["argneed"]
                row[CC_RETNEED] = cw["retneed"]
            else:  # callret
                for i in range(22):
                    row[SCRATCH0 + RW_Q0 + i] = (cw["q"] >> i) & 1
                for i in range(6):
                    row[SCRATCH0 + RW_R0 + i] = (cw["r"] >> i) & 1
                row[SCRATCH0 + RW_M] = cw["m"]
                for i in range(30):
                    row[SCRATCH0 + RW_D0 + i] = (cw["d"] >> i) & 1
                for i in range(28):
                    row[SCRATCH0 + RW_GASIN0 + i] = (cw["gasin"] >> i) & 1
                    row[SCRATCH0 + RW_GASRET0 + i] = (cw["gasret"] >> i) & 1
                for i in range(13):
                    row[SCRATCH0 + RW_RDS0 + i] = (cw["rds"] >> i) & 1
                    row[SCRATCH0 + RW_RDIFF0 + i] = (cw["rdiff"] >> i) & 1
        row[A0 : A0 + 256] = _word_bits(st.a)
        row[B0 : B0 + 256] = _word_bits(st.b)
        row[C0 : C0 + 256] = _word_bits(st.c)
        row[W0 : W0 + 256] = _word_bits(st.w)
    # halted padding: pc/sp/gas hold, flags clear, op = 0
    last_pc = steps[-1].pc if steps else 0
    for r in range(len(steps), n):
        row = tr[r]
        row[PC] = last_pc
        row[CLK] = r
        row[HALTED] = 1
        sp = ft.sp_f
        if sp == 1024:
            row[SP_TOP] = 1
        else:
            for i in range(10):
                row[SPB0 + i] = (sp >> i) & 1
        for i in range(32):
            row[GASB0 + i] = (ft.gas_f >> i) & 1
        for i in range(14):
            row[MEMB0 + i] = (ft.m_final >> i) & 1
    publics = frame_publics(
        ft.env,
        ft.gas0,
        ft.gas_f,
        ft.sp_f,
        fid=ft.fid,
        is_callee=ft.is_callee,
        cid=ft.cid,
        rds=ft.rds,
        hasret=ft.hasret,
        static=ft.static,
        reverted=ft.reverted,
        code_addr=ft.code_addr or ft.env.address,
    )
    return tr, publics


def _bits_to_bytes(bits: np.ndarray) -> np.ndarray:
    """(n, 256) bit columns -> (n, 32) little-endian bytes."""
    w = np.array([1 << b for b in range(8)], dtype=np.uint64)
    return bits.reshape(bits.shape[0], 32, 8).astype(np.uint64) @ w


_PU = np.uint64(bb.P)


def _np_chi_pows(chi: tuple, upto: int) -> list[np.ndarray]:
    """[chi^0 .. chi^upto] as (4,) uint64 arrays."""
    pows = [np.array(ef.H_ONE, dtype=np.uint64)]
    c = np.array([x % bb.P for x in chi], dtype=np.uint64)
    for _ in range(upto):
        pows.append(ef.npef_mul(pows[-1], c))
    return pows


def _np_tuple_code(
    base: np.ndarray, weighted: list[tuple[np.ndarray, int]], pows
) -> np.ndarray:
    """base + sum_k val_k * chi^{e_k} over (n,) uint64 value arrays."""
    acc = ef.npef_from_base(base)
    for vals, e in weighted:
        acc = ef.npef_add(acc, ef.npef_mul(ef.npef_from_base(vals), pows[e]))
    return acc


class EvmCpuAir(Air):
    """One row per EVM step (see module docstring for the statement)."""

    width = CPU_WIDTH
    aux_width = CPU_AUX_W
    num_aux_challenges = NUM_CHALLENGES
    num_bus_values = NUM_BUS
    quotient_chunks = 2
    eager_quotient = True  # see prover._quotient_stage_for

    def __init__(self, fid: int = 0):
        self.fid = int(fid)
        self._publics: list | None = None  # set by frame_tables (host aux)

    # ---------------- host-side channel terms (aux / bus) ----------------
    def _cols(self, trace: np.ndarray):
        t = trace.astype(np.uint64)
        flags = {nm: t[:, FLAG0 + i] for i, nm in enumerate(FLAG_NAMES)}
        fam_n = 1 + sum(t[:, FAMB0 + i] << np.uint64(i) for i in range(5))
        sp = (
            sum(t[:, SPB0 + i] << np.uint64(i) for i in range(10))
            + t[:, SP_TOP] * np.uint64(1024)
        )
        return t, flags, fam_n, sp

    def _channel_terms(self, trace: np.ndarray, challenges):
        challenges = fid_challenges(challenges, self.fid)
        chi, gamma_f, gamma_s, gamma_c, gamma_m = challenges[:5]
        gamma_k = challenges[CHAL_K]
        pows = _np_chi_pows(chi, 97)
        t, flags, fam_n, sp = self._cols(trace)
        n = trace.shape[0]
        clk = t[:, CLK]
        halted = t[:, HALTED]
        bytesA = _bits_to_bytes(trace[:, A0 : A0 + 256])
        bytesB = _bits_to_bytes(trace[:, B0 : B0 + 256])
        bytesC = _bits_to_bytes(trace[:, C0 : C0 + 256])
        gf = np.array([x % bb.P for x in gamma_f], dtype=np.uint64)
        gs = np.array([x % bb.P for x in gamma_s], dtype=np.uint64)
        gc = np.array([x % bb.P for x in gamma_c], dtype=np.uint64)
        # fetch receives
        imm = bytesC * flags["push"][:, None]
        code_f = _np_tuple_code(
            t[:, PC],
            [(t[:, OP], 1)] + [(imm[:, j], j + 3) for j in range(32)],
            pows,
        )
        inv_f = ef.npef_inv(ef.npef_sub(gf[None, :], code_f))
        num_f = (_PU - np.uint64(1)) * (1 - halted) % _PU  # -(1-halted)
        fetch_terms = ef.npef_mul(ef.npef_from_base(num_f), inv_f)
        # calldata sends (in-bounds loads only: carry15 == 1)
        cdl_act = flags["calldataload"] * t[:, CARRY0 + 15] % _PU
        offset = sum(t[:, A0 + b] << np.uint64(b) for b in range(16))
        code_c = _np_tuple_code(
            offset, [(bytesC[:, j], j + 1) for j in range(32)], pows
        )
        inv_c = ef.npef_inv(ef.npef_sub(gc[None, :], code_c))
        cdl_terms = ef.npef_mul(ef.npef_from_base(cdl_act), inv_c)
        # memory sends (word-granular RAM tuples)
        gm = np.array([x % bb.P for x in gamma_m], dtype=np.uint64)
        m8 = flags["mstore8"]
        mem_act = (flags["mload"] + flags["mstore"] + m8) % _PU
        waddr = sum(t[:, A0 + b] << np.uint64(b - 5) for b in range(5, 18))
        bytesW = _bits_to_bytes(trace[:, W0 : W0 + 256])
        # first tuple value: C (MSTORE's old word / the generic slot),
        # except MLOAD (word B) and MSTORE8's READ of the old word (W)
        vmem = np.where(
            flags["mload"][:, None] == 1,
            bytesB,
            np.where(m8[:, None] == 1, bytesW, bytesC),
        )
        code_m = _np_tuple_code(
            waddr,
            [(4 * clk, 1)]
            + [(vmem[:, j], j + 3) for j in range(32)],
            pows,
        )
        inv_m = ef.npef_inv(ef.npef_sub(gm[None, :], code_m))
        mem_terms = ef.npef_mul(ef.npef_from_base(mem_act), inv_m)
        # second tuple: MSTORE8's spliced-word WRITE at waddr, or an
        # unaligned MLOAD/MSTORE second-word READ at waddr + 1
        mld = flags["mload"]
        mst = flags["mstore"]
        k_low5 = sum(t[:, A0 + bit] << np.uint64(bit) for bit in range(5))
        unal = (k_low5 != 0).astype(np.uint64)
        v2 = np.where((mld + mst)[:, None] == 1, bytesW, bytesC)
        code_m2 = _np_tuple_code(
            (waddr + mld + mst) % _PU,
            [(4 * clk + 1, 1), (m8, 2)]
            + [(v2[:, j], j + 3) for j in range(32)],
            pows,
        )
        inv_m2 = ef.npef_inv(ef.npef_sub(gm[None, :], code_m2))
        mem2_terms = ef.npef_mul(
            ef.npef_from_base((m8 + (mld + mst) * unal) % _PU), inv_m2
        )
        # calldata-copy call sends: clk + destw*chi + off*chi^2 + sw*chi^3
        gcp = np.array(
            [x % bb.P for x in challenges[CHAL_CP]], dtype=np.uint64
        )
        cdc = flags["calldatacopy"]
        ccp = flags["codecopy"]
        offv = sum(t[:, W0 + bit] << np.uint64(bit) for bit in range(15))
        swv = sum(t[:, KSW0 + i] << np.uint64(i) for i in range(10))
        slackv = sum(t[:, KSL0 + i] << np.uint64(i) for i in range(5))
        code_cp = _np_tuple_code(
            clk,
            [(waddr, 1), (offv, 2), (swv, 3), (ccp, 4), (slackv, 5)],
            pows,
        )
        inv_cp = ef.npef_inv(ef.npef_sub(gcp[None, :], code_cp))
        cp_terms = ef.npef_mul(ef.npef_from_base((cdc + ccp) % _PU), inv_cp)
        # third/fourth tuples: MSTORE's spliced word-1 / word-2 WRITES
        # (values derived host-side exactly as the circuit's one-hot
        # pattern sums)
        k_int = k_low5.astype(np.int64)
        n = trace.shape[0]
        v3 = np.zeros_like(bytesC)
        v4 = np.zeros_like(bytesC)
        for r in range(n):
            if mst[r] != 1:
                continue
            k = int(k_int[r])
            old1 = sum(int(bytesC[r, j]) << (8 * j) for j in range(32))
            old2 = sum(int(bytesW[r, j]) << (8 * j) for j in range(32))
            vv = sum(int(bytesB[r, j]) << (8 * j) for j in range(32))
            keep = 8 * (32 - k)
            if k == 0:
                n1, n2 = vv, 0
            else:
                n1 = (old1 >> keep << keep) | (vv >> (8 * k))
                n2 = ((vv << keep) & ((1 << 256) - 1)) | (
                    old2 & ((1 << keep) - 1)
                )
            for j in range(32):
                v3[r, j] = (n1 >> (8 * j)) & 0xFF
                v4[r, j] = (n2 >> (8 * j)) & 0xFF
        code_m3 = _np_tuple_code(
            waddr,
            [(4 * clk + 2, 1), (np.ones_like(clk), 2)]
            + [(v3[:, j], j + 3) for j in range(32)],
            pows,
        )
        inv_m3 = ef.npef_inv(ef.npef_sub(gm[None, :], code_m3))
        mem3_terms = ef.npef_mul(ef.npef_from_base(mst % _PU), inv_m3)
        code_m4 = _np_tuple_code(
            (waddr + 1) % _PU,
            [(4 * clk + 3, 1), (np.ones_like(clk), 2)]
            + [(v4[:, j], j + 3) for j in range(32)],
            pows,
        )
        inv_m4 = ef.npef_inv(ef.npef_sub(gm[None, :], code_m4))
        mem4_terms = ef.npef_mul(
            ef.npef_from_base((mst * unal) % _PU), inv_m4
        )
        # hash-call sends (KECCAK256)
        gk = np.array([x % bb.P for x in gamma_k], dtype=np.uint64)
        size_lo = sum(t[:, B0 + bit] << np.uint64(bit) for bit in range(16))
        code_k = _np_tuple_code(
            clk,
            [(waddr, 1), (size_lo, 2)]
            + [(bytesC[:, j], j + 3) for j in range(32)],
            pows,
        )
        inv_k = ef.npef_inv(ef.npef_sub(gk[None, :], code_k))
        kcall_terms = ef.npef_mul(
            ef.npef_from_base(flags["keccak"]), inv_k
        )
        # storage sends (SLOAD/SSTORE)
        gamma_st = challenges[CHAL_ST]
        gst = np.array([x % bb.P for x in gamma_st], dtype=np.uint64)
        sl, ss = flags["sload"], flags["sstore"]
        v_st = np.where(ss[:, None] == 1, bytesB, bytesC)
        code_st = _np_tuple_code(
            4 * clk,
            [
                (ss, 1),
                (t[:, SCOLD], 2),
                (t[:, SG1], 3),
                (t[:, SG2], 4),
            ]
            + [(bytesA[:, j], j + 5) for j in range(32)]
            + [(v_st[:, j], j + 37) for j in range(32)],
            pows,
        )
        inv_st = ef.npef_inv(ef.npef_sub(gst[None, :], code_st))
        stor_terms = ef.npef_mul(ef.npef_from_base((sl + ss) % _PU), inv_st)
        # signed-arithmetic sends (SDIV/SMOD -> ArithAir):
        #   kind + sum_j a_j chi^{1+j} + b_j chi^{33+j} + c_j chi^{65+j}
        gar = np.array(
            [x % bb.P for x in challenges[CHAL_AR]], dtype=np.uint64
        )
        kind = (flags["sdiv"] + 2 * flags["smod"] + 3 * flags["exp"]) % _PU
        code_ar = _np_tuple_code(
            kind,
            [(bytesA[:, j], 1 + j) for j in range(32)]
            + [(bytesB[:, j], 33 + j) for j in range(32)]
            + [(bytesC[:, j], 65 + j) for j in range(32)],
            pows,
        )
        inv_ar = ef.npef_inv(ef.npef_sub(gar[None, :], code_ar))
        ar_terms = ef.npef_mul(
            ef.npef_from_base(
                (flags["sdiv"] + flags["smod"] + flags["exp"]) % _PU
            ),
            inv_ar,
        )
        # stack sends
        p21 = sum(flags[nm] for nm in _POP2PUSH1)
        cdl = flags["calldataload"]
        mld, mst, msz = flags["mload"], flags["mstore"], flags["msize"]
        cdc_f = (
            flags["calldatacopy"] + flags["codecopy"]
            + flags["returndatacopy"]
        )
        fcl, fcr = flags["call"], flags["callret"]
        anycall = fcl + fcr
        acp = (
            flags["balance"] + flags["extcodesize"] + flags["extcodehash"]
            + flags["blockhash"]
        )
        fsb = flags["selfbalance"]
        flgx = flags["logext"]
        fb0 = t[:, FAMB0]
        fb1 = t[:, FAMB0 + 1]
        fb2 = t[:, FAMB0 + 2]
        lg_ind = [
            (fb0 + fb1 + fb2 - fb0 * fb1) % _PU,
            fb1 + fb2,
            fb0 * fb1 + fb2,
            fb2,
        ]
        # 6-arg call variants (DELEGATECALL/STATICCALL) shift the call-
        # pair stack offsets by one; REVERT pops like RETURN; create
        # rows read offset/size/value (+salt) and push the new address
        k6 = t[:, KDEL] + t[:, KSTA]
        kc2 = t[:, KC2]
        cre, crr = flags["create"], flags["createret"]
        pops_w0 = (
            2 * p21 + flags["iszero"] + flags["not"] + flags["swap"]
            + cdl + mld + sl + 3 * cdc_f + 5 * fcl + 7 * fcr + acp
            + 3 * flgx - anycall * k6 + 4 * cre * kc2 + _PU
        ) % _PU
        env_sum = sum(flags[nm] for nm in ENV_OPS)
        ret = flags["return"] + flags["revert"]
        active = [
            p21
            + flags["iszero"] + flags["not"] + flags["pop"]
            + flags["jump"] + flags["jumpi"] + flags["dup"] + flags["swap"]
            + cdl + mld + mst + sl + ss + ret + flags["log"]
            + flags["mstore8"] + cdc_f + anycall + acp + flgx * lg_ind[0]
            + cre + _PU - fcr * k6,
            p21 + flags["jumpi"] + flags["swap"] + mst + ss + ret
            + flags["log"] + flags["mstore8"] + cdc_f + anycall + cre
            + flgx * lg_ind[1],
            p21
            + flags["iszero"] + flags["not"] + flags["push0"] + flags["push"]
            + flags["dup"] + flags["swap"] + flags["pc"] + flags["gas"]
            + env_sum + cdl + mld + msz + sl + cdc_f + anycall + acp + fsb
            + flgx * lg_ind[2] + cre * kc2,
            flags["swap"] + anycall + cre + crr + flgx * lg_ind[3],
        ]
        addr = [
            (
                sp + _PU - 1 - flags["dup"] * (fam_n - 1) - 3 * fcl
                - 2 * fcr + fcl * k6 + _PU - cre
            )
            % _PU,
            (
                sp + 2 * _PU - 2 - flags["swap"] * (fam_n - 1) - 4 * fcr
                + fcr * k6 + _PU - cre
            )
            % _PU,
            (sp + _PU * 2 - pops_w0) % _PU,
            (
                sp + 2 * _PU - 1 - flags["swap"] * fam_n - 6 * fcr
                - 3 * flgx + fcr * k6 + 2 * _PU - 2 * crr - crr * kc2
            )
            % _PU,
        ]
        w0_bytes = np.where(
            (flags["swap"] + cdc_f)[:, None] == 1, bytesB, bytesC
        )
        slot1 = np.where(cdc_f[:, None] == 1, bytesW, bytesB)
        slot3 = np.where(
            crr[:, None] == 1,
            bytesB,
            np.where((anycall + flgx + cre)[:, None] == 1, bytesW, bytesA),
        )
        vbytes = [bytesA, slot1, w0_bytes, slot3]
        slot_terms = []
        for s in range(4):
            iw_s = np.full(n, s >= 2, dtype=np.uint64)
            if s == 2:
                # READS: copies' third pop, call/ret sizes, topic 3,
                # CREATE2's salt
                iw_s = iw_s - cdc_f - anycall - flgx - cre
            if s == 3:
                # gas pop / topic 4 / create's value pop are READS
                iw_s = iw_s - fcl - flgx - cre
            code = _np_tuple_code(
                addr[s],
                [(4 * clk + s, 1), (iw_s % _PU, 2)]
                + [(vbytes[s][:, j], j + 3) for j in range(32)],
                pows,
            )
            inv = ef.npef_inv(ef.npef_sub(gs[None, :], code))
            slot_terms.append(ef.npef_mul(ef.npef_from_base(active[s] % _PU), inv))
        return (
            fetch_terms,
            slot_terms,
            cdl_terms,
            mem_terms,
            kcall_terms,
            stor_terms,
            ar_terms,
            mem2_terms,
            mem3_terms,
            mem4_terms,
            cp_terms,
        )

    @staticmethod
    def _excl_prefix(terms: np.ndarray) -> np.ndarray:
        c = np.cumsum(terms, axis=0) % _PU
        return ef.npef_sub(c, terms)  # plain uint64 subtract would wrap

    def _call_channel_terms(self, trace: np.ndarray, challenges):
        """Host-side composition-channel terms (sparse python loops over
        the call rows; self._publics is set by frame_tables)."""
        n = trace.shape[0]
        chi = challenges[CHAL_CHI]
        g_cq = challenges[CHAL_CQ]
        g_cr = challenges[CHAL_CR]
        g_br = challenges[CHAL_BR]
        shifted = fid_challenges(challenges, self.fid)
        g_ad = shifted[CHAL_AD]
        g_ac = shifted[CHAL_AC]
        g_lg = shifted[CHAL_LG]
        pubs = self._publics or [0] * NUM_PUBLICS
        pows = [ef.H_ONE]
        for _ in range(68):
            pows.append(ef.h_mul(pows[-1], chi))

        def hcode(base, terms):
            acc = ef.h_from_base(base % bb.P)
            for v, e in terms:
                v = int(v) % bb.P
                if v:
                    acc = ef.h_add(acc, ef.h_mul(ef.h_from_base(v), pows[e]))
            return acc

        def word(r, base):
            return sum(int(trace[r, base + i]) << i for i in range(256))

        def sbits(r, base, nb):
            return sum(
                int(trace[r, SCRATCH0 + base + i]) << i for i in range(nb)
            )

        out = {
            k: np.zeros((n, 4), dtype=np.uint64)
            for k in (
                "cq", "cr", "bra", "brw", "brr", "adr", "ac", "lg",
                "blr", "bld", "blc", "cq2", "cr2", "bri",
            )
        }
        g_bl = challenges[CHAL_BL]
        denoms = []
        meta = []  # (key, row, sign)
        caller_l = [
            pubs[PUB_ENV0 + 16 * ENV_IDX_ADDRESS + i] for i in range(10)
        ]
        callerenv_l = [
            pubs[PUB_ENV0 + 16 * ENV_IDX_CALLER + i] for i in range(10)
        ]
        cv_l = [
            pubs[PUB_ENV0 + 16 * ENV_IDX_CALLVALUE + i] for i in range(16)
        ]
        static_pub = pubs[PUB_STATIC]
        idx_call = FLAG0 + FLAG_IDX["call"]
        for r in np.nonzero(trace[:, idx_call])[0]:
            r = int(r)
            Bw = word(r, B0)
            Awn = word(r + 1, A0)
            Cw = word(r, C0)
            Cwn = word(r + 1, C0)
            Bwn = word(r + 1, B0)
            gasin = sbits(r + 1, RW_GASIN0, 28)
            gasret = sbits(r + 1, RW_GASRET0, 28)
            rds = sbits(r + 1, RW_RDS0, 13)
            cfid = sbits(r, CW_CFID0, 16)
            kdel = int(trace[r, KDEL])
            ksta = int(trace[r, KSTA])
            taken_n = int(trace[r + 1, TAKEN])
            succ = int(trace[r + 1, W0])
            addr_l = [(Bw >> (16 * i)) & 0xFFFF for i in range(10)]
            val_l = [(Awn >> (16 * i)) & 0xFFFF for i in range(16)]
            # DELEGATECALL: the callee keeps the CALLER's context words
            env_addr_l = caller_l if kdel else addr_l
            env_val_l = cv_l if kdel else val_l
            env_caller_l = callerenv_l if kdel else caller_l
            static_child = static_pub + ksta - static_pub * ksta
            code_cq = hcode(
                self.fid,
                [(r, 1), (gasin & 0xFFFF, 2), (gasin >> 16, 3)]
                + [(env_addr_l[i], 4 + i) for i in range(10)]
                + [(env_val_l[i], 14 + i) for i in range(16)]
                + [(Cw & 0x7FFF, 30)]
                + [(env_caller_l[i], 31 + i) for i in range(10)]
                + [(cfid, 41), (static_child, 42)]
                + [(addr_l[i], 43 + i) for i in range(10)],
            )
            denoms.append(ef.h_sub(g_cq, code_cq))
            meta.append(("cq", r, +1))
            code_cr = hcode(
                self.fid,
                [(r, 1), (gasret & 0xFFFF, 2), (gasret >> 16, 3), (succ, 4), (rds, 5)],
            )
            denoms.append(ef.h_sub(g_cr, code_cr))
            meta.append(("cr", r, -1))
            if taken_n:
                # balance-journal debit/credit (value-bearing call)
                vb = [(Awn >> (8 * j)) & 0xFF for j in range(32)]
                code_bld = hcode(
                    self.fid,
                    [(4 * r + 2, 1), (2, 2)]
                    + [(caller_l[i], 3 + i) for i in range(10)]
                    + [(vb[j], 13 + j) for j in range(32)],
                )
                denoms.append(ef.h_sub(g_bl, code_bld))
                meta.append(("bld", r, +1))
                code_blc = hcode(
                    self.fid,
                    [(4 * r + 3, 1), (3, 2)]
                    + [(addr_l[i], 3 + i) for i in range(10)]
                    + [(vb[j], 13 + j) for j in range(32)],
                )
                denoms.append(ef.h_sub(g_bl, code_blc))
                meta.append(("blc", r, +1))
            asw = sum(int(trace[r, KSW0 + i]) << i for i in range(10))
            rsw = sum(int(trace[r + 1, KSW0 + i]) << i for i in range(10))
            if Cw:
                code = hcode(
                    self.fid,
                    [(4 * r + 1, 1), (word(r, A0) // 32, 3), (asw, 4), (cfid, 5)],
                )
                denoms.append(ef.h_sub(g_br, code))
                meta.append(("bra", r, +1))
            if Cwn:
                code = hcode(
                    self.fid,
                    [(4 * r + 5, 1), (1, 2), (Bwn // 32, 3), (rsw, 4), (cfid, 5)],
                )
                denoms.append(ef.h_sub(g_br, code))
                meta.append(("brw", r, +1))
            code_ad = hcode(
                4 * r,
                [(int(trace[r, SCOLD]), 1)]
                + [(addr_l[i], 2 + i) for i in range(10)],
            )
            denoms.append(ef.h_sub(g_ad, code_ad))
            meta.append(("adr", r, +1))
        # create rows: CREATE CALLREQ/CALLRET (address/value from the
        # createret row's B/A words), the kind-4 initcode bridge, and
        # the balance debit/credit on value-bearing creates
        idx_cre = FLAG0 + FLAG_IDX["create"]
        for r in np.nonzero(trace[:, idx_cre])[0]:
            r = int(r)
            Awn = word(r + 1, A0)
            Bwn = word(r + 1, B0)
            gasin = sbits(r + 1, RW_GASIN0, 28)
            gasret = sbits(r + 1, RW_GASRET0, 28)
            rds = sbits(r + 1, RW_RDS0, 13)
            cfid = sbits(r, CW_CFID0, 16)
            taken_n = int(trace[r + 1, TAKEN])
            addr_l = [(Bwn >> (16 * i)) & 0xFFFF for i in range(10)]
            val_l = [(Awn >> (16 * i)) & 0xFFFF for i in range(16)]
            code_cq2 = hcode(
                self.fid,
                [(r, 1), (gasin & 0xFFFF, 2), (gasin >> 16, 3)]
                + [(addr_l[i], 4 + i) for i in range(10)]
                + [(val_l[i], 14 + i) for i in range(16)]
                + [(caller_l[i], 31 + i) for i in range(10)]
                + [(cfid, 41), (static_pub, 42)]
                + [(addr_l[i], 43 + i) for i in range(10)],
            )
            denoms.append(ef.h_sub(g_cq, code_cq2))
            meta.append(("cq2", r, +1))
            code_cr2 = hcode(
                self.fid,
                [(r, 1), (gasret & 0xFFFF, 2), (gasret >> 16, 3), (1, 4), (rds, 5)],
            )
            denoms.append(ef.h_sub(g_cr, code_cr2))
            meta.append(("cr2", r, -1))
            sw_cre = sum(int(trace[r, KSW0 + i]) << i for i in range(10))
            if int(trace[r, TAKEN]):  # size != 0: the initcode bridge
                code = hcode(
                    self.fid,
                    [
                        (4 * r + 1, 1), (4, 2), (word(r, A0) // 32, 3),
                        (sw_cre, 4), (cfid, 5),
                    ],
                )
                denoms.append(ef.h_sub(g_br, code))
                meta.append(("bri", r, +1))
            if taken_n:
                vb = [(Awn >> (8 * j)) & 0xFF for j in range(32)]
                code_bld = hcode(
                    self.fid,
                    [(4 * r + 2, 1), (2, 2)]
                    + [(caller_l[i], 3 + i) for i in range(10)]
                    + [(vb[j], 13 + j) for j in range(32)],
                )
                denoms.append(ef.h_sub(g_bl, code_bld))
                meta.append(("bld", r, +1))
                code_blc = hcode(
                    self.fid,
                    [(4 * r + 3, 1), (3, 2)]
                    + [(addr_l[i], 3 + i) for i in range(10)]
                    + [(vb[j], 13 + j) for j in range(32)],
                )
                denoms.append(ef.h_sub(g_bl, code_blc))
                meta.append(("blc", r, +1))
        # log rows: the record tuple (topics from the NEXT row) + the
        # data-bridge instancing tuple (kind 3) when size != 0
        idx_log = FLAG0 + FLAG_IDX["log"]
        for r in np.nonzero(trace[:, idx_log])[0]:
            r = int(r)
            fam = 1 + sum(
                int(trace[r, FAMB0 + i]) << i for i in range(5)
            )
            Aw = word(r, A0)
            Bw = word(r, B0)
            topics = [word(r + 1, base) for base in (A0, B0, C0, W0)]
            terms = [(fam, 1), (Aw // 32, 2), (Bw & 0xFFFF, 3)]
            for ti, tv in enumerate(topics):
                terms += [
                    ((tv >> (16 * i)) & 0xFFFF, 4 + 16 * ti + i)
                    for i in range(16)
                ]
            code = hcode(r, terms)
            denoms.append(ef.h_sub(g_lg, code))
            meta.append(("lg", r, +1))
            if Bw:  # size != 0: the data bridge exists
                sw_log = sum(
                    int(trace[r, KSW0 + i]) << i for i in range(10)
                )
                code = hcode(
                    self.fid,
                    [(4 * r + 1, 1), (3, 2), (Aw // 32, 3), (sw_log, 4)],
                )
                denoms.append(ef.h_sub(g_br, code))
                meta.append(("bra", r, +1))
        # account-state rows: the context tuples + (for the three
        # address-priced ops) journal entries keyed by the A word;
        # BALANCE/SELFBALANCE reads go to the balance journal (round 5)
        for name, kind in (
            ("balance", 1),
            ("extcodesize", 2),
            ("extcodehash", 3),
            ("blockhash", 4),
            ("selfbalance", 1),
        ):
            for r in np.nonzero(trace[:, FLAG0 + FLAG_IDX[name]])[0]:
                r = int(r)
                Aw = word(r, A0)
                Cw = word(r, C0)
                if name == "selfbalance":
                    key_l = [
                        pubs[PUB_ENV0 + 16 * ENV_IDX_ADDRESS + i]
                        for i in range(10)
                    ]
                else:
                    key_l = [(Aw >> (16 * i)) & 0xFFFF for i in range(10)]
                if name in ("balance", "selfbalance"):
                    code_bl = hcode(
                        self.fid,
                        [(4 * r, 1), (1, 2)]
                        + [(key_l[i], 3 + i) for i in range(10)]
                        + [((Cw >> (8 * j)) & 0xFF, 13 + j) for j in range(32)],
                    )
                    denoms.append(ef.h_sub(g_bl, code_bl))
                    meta.append(("blr", r, +1))
                else:
                    code = hcode(
                        kind,
                        [(key_l[i], 1 + i) for i in range(10)]
                        + [((Cw >> (8 * j)) & 0xFF, 11 + j) for j in range(32)],
                    )
                    denoms.append(ef.h_sub(g_ac, code))
                    meta.append(("ac", r, +1))
                if name in ("balance", "extcodesize", "extcodehash"):
                    code_ad = hcode(
                        4 * r,
                        [(int(trace[r, SCOLD]), 1)]
                        + [(key_l[i], 2 + i) for i in range(10)],
                    )
                    denoms.append(ef.h_sub(g_ad, code_ad))
                    meta.append(("adr", r, +1))
        if pubs[PUB_HASRET]:
            idx_ret = FLAG0 + FLAG_IDX["return"]
            idx_rev = FLAG0 + FLAG_IDX["revert"]
            halt_rows = np.nonzero(
                trace[:, idx_ret] | trace[:, idx_rev]
            )[0]
            for r in halt_rows:
                r = int(r)
                ksw = sum(int(trace[r, KSW0 + i]) << i for i in range(10))
                code = hcode(
                    self.fid,
                    [(4 * r + 1, 1), (2, 2), (word(r, A0) // 32, 3), (ksw, 4)],
                )
                denoms.append(ef.h_sub(g_br, code))
                meta.append(("brr", r, +1))
        # callee endpoints (publics-only codes)
        invQ = ef.H_ZERO
        invR = ef.H_ZERO
        if pubs[PUB_IS_CALLEE]:
            code_recv = hcode(
                pubs[PUB_CID_FID],
                [
                    (pubs[PUB_CID_CLK], 1),
                    (pubs[PUB_GAS0], 2),
                    (pubs[PUB_GAS0 + 1], 3),
                ]
                + [
                    (pubs[PUB_ENV0 + 16 * ENV_IDX_ADDRESS + i], 4 + i)
                    for i in range(10)
                ]
                + [
                    (pubs[PUB_ENV0 + 16 * ENV_IDX_CALLVALUE + i], 14 + i)
                    for i in range(16)
                ]
                + [(pubs[PUB_ENV0 + 16 * ENV_IDX_CDSIZE], 30)]
                + [
                    (pubs[PUB_ENV0 + 16 * ENV_IDX_CALLER + i], 31 + i)
                    for i in range(10)
                ]
                + [(pubs[PUB_FID], 41), (pubs[PUB_STATIC], 42)]
                + [(pubs[PUB_CODEADDR0 + i], 43 + i) for i in range(10)],
            )
            code_send = hcode(
                pubs[PUB_CID_FID],
                [
                    (pubs[PUB_CID_CLK], 1),
                    (pubs[PUB_GASF], 2),
                    (pubs[PUB_GASF + 1], 3),
                    (1 - pubs[PUB_REVERTED], 4),
                    (pubs[PUB_RDS], 5),
                ],
            )
            denoms.append(ef.h_sub(g_cq, code_recv))
            meta.append(("invq", -1, -1))
            denoms.append(ef.h_sub(g_cr, code_send))
            meta.append(("invr", -1, +1))
        invs = ef.h_batch_inv(denoms) if denoms else []
        for (key, r, sign), iv in zip(meta, invs):
            term = iv if sign > 0 else ef.h_neg(iv)
            if key == "invq":
                invQ = term
            elif key == "invr":
                invR = term
            else:
                out[key][r] = term
        return out, invQ, invR

    def aux_trace(self, trace: np.ndarray, challenges) -> np.ndarray:
        (
            fetch_terms,
            slot_terms,
            cdl_terms,
            mem_terms,
            kcall_terms,
            stor_terms,
            ar_terms,
            mem2_terms,
            mem3_terms,
            mem4_terms,
            cp_terms,
        ) = self._channel_terms(trace, challenges)
        aux = np.zeros((trace.shape[0], CPU_AUX_W), dtype=np.uint32)
        aux[:, AUX_F : AUX_F + 4] = self._excl_prefix(fetch_terms)
        for s in range(4):
            aux[:, AUX_SLOT0 + 4 * s : AUX_SLOT0 + 4 * s + 4] = self._excl_prefix(
                slot_terms[s]
            )
        aux[:, AUX_CD : AUX_CD + 4] = self._excl_prefix(cdl_terms)
        aux[:, AUX_M : AUX_M + 4] = self._excl_prefix(mem_terms)
        aux[:, AUX_K : AUX_K + 4] = self._excl_prefix(kcall_terms)
        aux[:, AUX_ST : AUX_ST + 4] = self._excl_prefix(stor_terms)
        aux[:, AUX_AR : AUX_AR + 4] = self._excl_prefix(ar_terms)
        aux[:, AUX_M2 : AUX_M2 + 4] = self._excl_prefix(mem2_terms)
        aux[:, AUX_M3 : AUX_M3 + 4] = self._excl_prefix(mem3_terms)
        aux[:, AUX_M4 : AUX_M4 + 4] = self._excl_prefix(mem4_terms)
        aux[:, AUX_CP : AUX_CP + 4] = self._excl_prefix(cp_terms)
        ct, invQ, invR = self._call_channel_terms(trace, challenges)
        aux[:, AUX_AC : AUX_AC + 4] = self._excl_prefix(ct["ac"])
        aux[:, AUX_LG : AUX_LG + 4] = self._excl_prefix(ct["lg"])
        aux[:, AUX_CQ : AUX_CQ + 4] = self._excl_prefix(ct["cq"])
        aux[:, AUX_CQI : AUX_CQI + 4] = np.array(invQ, dtype=np.uint64)[None, :]
        aux[:, AUX_CR : AUX_CR + 4] = self._excl_prefix(ct["cr"])
        aux[:, AUX_CRI : AUX_CRI + 4] = np.array(invR, dtype=np.uint64)[None, :]
        aux[:, AUX_BRA : AUX_BRA + 4] = self._excl_prefix(ct["bra"])
        aux[:, AUX_BRW : AUX_BRW + 4] = self._excl_prefix(ct["brw"])
        aux[:, AUX_BRR : AUX_BRR + 4] = self._excl_prefix(ct["brr"])
        aux[:, AUX_ADR : AUX_ADR + 4] = self._excl_prefix(ct["adr"])
        aux[:, AUX_BLR : AUX_BLR + 4] = self._excl_prefix(ct["blr"])
        aux[:, AUX_BLD : AUX_BLD + 4] = self._excl_prefix(ct["bld"])
        aux[:, AUX_BLC : AUX_BLC + 4] = self._excl_prefix(ct["blc"])
        aux[:, AUX_CQ2 : AUX_CQ2 + 4] = self._excl_prefix(ct["cq2"])
        aux[:, AUX_CR2 : AUX_CR2 + 4] = self._excl_prefix(ct["cr2"])
        aux[:, AUX_BRI : AUX_BRI + 4] = self._excl_prefix(ct["bri"])
        return aux

    def bus_values(self, trace: np.ndarray, challenges) -> list[tuple]:
        (
            fetch_terms,
            slot_terms,
            cdl_terms,
            mem_terms,
            kcall_terms,
            stor_terms,
            ar_terms,
            mem2_terms,
            mem3_terms,
            mem4_terms,
            cp_terms,
        ) = self._channel_terms(trace, challenges)
        # the last row is always halted padding: its own terms vanish
        fetch = tuple(int(v) for v in fetch_terms.sum(axis=0) % _PU)
        stack = ef.H_ZERO
        for st in slot_terms:
            stack = ef.h_add(stack, tuple(int(v) for v in st.sum(axis=0) % _PU))
        cdl = tuple(int(v) for v in cdl_terms.sum(axis=0) % _PU)
        mem = tuple(
            int(v)
            for v in (
                mem_terms.sum(axis=0)
                + mem2_terms.sum(axis=0)
                + mem3_terms.sum(axis=0)
                + mem4_terms.sum(axis=0)
            )
            % _PU
        )
        kcall = tuple(int(v) for v in kcall_terms.sum(axis=0) % _PU)
        stor = tuple(int(v) for v in stor_terms.sum(axis=0) % _PU)
        ar = tuple(int(v) for v in ar_terms.sum(axis=0) % _PU)
        cp = tuple(int(v) for v in cp_terms.sum(axis=0) % _PU)
        ct, invQ, invR = self._call_channel_terms(trace, challenges)

        def _tot(key):
            return tuple(int(v) for v in ct[key].sum(axis=0) % _PU)

        bus_cq = ef.h_add(ef.h_add(_tot("cq"), _tot("cq2")), invQ)
        bus_cr = ef.h_add(ef.h_add(_tot("cr"), _tot("cr2")), invR)
        bus_br = ef.h_add(
            ef.h_add(ef.h_add(_tot("bra"), _tot("brw")), _tot("brr")),
            _tot("bri"),
        )
        bus_ad = _tot("adr")
        bus_ac = _tot("ac")
        bus_lg = _tot("lg")
        bus_bl = ef.h_add(ef.h_add(_tot("blr"), _tot("bld")), _tot("blc"))
        return [
            fetch, stack, cdl, mem, ef.H_ZERO, ef.H_ZERO, kcall, stor, ar, cp,
            bus_cq, bus_cr, bus_br, bus_ad, bus_ac, bus_lg, bus_bl,
        ]

    # ------------------------------- constraints -------------------------
    def eval(self, b: ConstraintBuilder) -> None:  # noqa: C901
        one = b.constant(1)
        chi = b.challenge_ef(CHAL_CHI)
        chi2 = b.ef_mul4(chi, chi)
        fid_pub = b.public(PUB_FID)
        _c97 = _eval_chi97(b, chi)
        fid_shift = [b.mul(fid_pub, _c97[c]) for c in range(4)]
        g_f = b.ef_sub4(b.challenge_ef(CHAL_F), fid_shift)
        g_s = b.ef_sub4(b.challenge_ef(CHAL_S), fid_shift)
        g_c = b.ef_sub4(b.challenge_ef(CHAL_C), fid_shift)
        g_m = b.ef_sub4(b.challenge_ef(CHAL_M), fid_shift)
        g_k = b.ef_sub4(b.challenge_ef(CHAL_K), fid_shift)
        g_st = b.ef_sub4(b.challenge_ef(CHAL_ST), fid_shift)

        pc = b.local(PC)
        pc_n = b.next(PC)
        op = b.local(OP)
        op_n = b.next(OP)
        clk = b.local(CLK)
        clk_n = b.next(CLK)
        halted = b.local(HALTED)
        halted_n = b.next(HALTED)
        taken = b.local(TAKEN)
        s_inv = b.local(S_INV)
        f = {nm: b.local(FLAG0 + i) for i, nm in enumerate(FLAG_NAMES)}

        def fsum(names):
            acc = None
            for nm in names:
                acc = f[nm] if acc is None else b.add(acc, f[nm])
            return acc

        fam_n = one
        for i in range(5):
            fam_n = b.add(fam_n, b.scale(1 << i, b.local(FAMB0 + i)))

        def sp_expr(nx: bool):
            g = b.next if nx else b.local
            acc = b.scale(1024, g(SP_TOP))
            for i in range(10):
                acc = b.add(acc, b.scale(1 << i, g(SPB0 + i)))
            return acc

        def gas_expr(nx: bool, bits: range, shift: int):
            g = b.next if nx else b.local
            acc = None
            for i in bits:
                t = b.scale(1 << (i - shift), g(GASB0 + i))
                acc = t if acc is None else b.add(acc, t)
            return acc

        sp = sp_expr(False)
        sp_n = sp_expr(True)
        G = gas_expr(False, range(32), 0)
        G_n = gas_expr(True, range(32), 0)
        Gn_lo = gas_expr(True, range(16), 0)
        Gn_hi = gas_expr(True, range(16, 32), 16)

        carries = [b.local(CARRY0 + i) for i in range(16)]

        Ablk = b.local_block(range(A0, A0 + 256))
        Bblk = b.local_block(range(B0, B0 + 256))
        Cblk = b.local_block(range(C0, C0 + 256))
        Wblk = b.local_block(range(W0, W0 + 256))
        lA = b.linmap(_LIMB_MAT, Ablk)
        lB = b.linmap(_LIMB_MAT, Bblk)
        lC = b.linmap(_LIMB_MAT, Cblk)
        lW = b.linmap(_LIMB_MAT, Wblk)

        # 1. booleanity (bit columns + flags + state bits)
        bit_cols = (
            [HALTED, TAKEN]
            + [FLAG0 + i for i in range(NF)]
            + [FAMB0 + i for i in range(5)]
            + [SPB0 + i for i in range(10)]
            + [SP_TOP]
            + [GASB0 + i for i in range(32)]
            + [CARRY0 + i for i in range(16)]
            + [NZ0 + i for i in range(16)]
            + list(range(A0, A0 + 1024))
            + list(range(SCRATCH0, KNEED))  # KNEED itself is a raw column
            + list(range(DMB0, CC_INVH))  # CC_INVH..CC_RETNEED are raw
            + [KDEL, KSTA, KC2]
        )
        bits = b.local_block(bit_cols)
        b.all_rows_block(b.mul(bits, b.sub(bits, one)), len(bit_cols))

        # 2. exactly one flag on live rows; none when halted
        b.all_rows(b.sub(fsum(FLAG_NAMES), b.sub(one, halted)))

        # 3. opcode byte reconstruction from covered bases only
        op_expr = None
        for nm, (byte, _, _, _) in SIMPLE_OPS.items():
            term = b.scale(byte, f[nm]) if byte else None
            if term is not None:
                op_expr = term if op_expr is None else b.add(op_expr, term)
        for nm, byte in ENV_OPS.items():
            op_expr = b.add(op_expr, b.scale(byte, f[nm]))
        for nm, (base, _, _) in FAMILIES.items():
            op_expr = b.add(op_expr, b.scale(base, f[nm]))
        fam_f = fsum(FAMILIES)
        op_expr = b.add(op_expr, b.mul(fam_f, fam_n))
        # call-variant bytes: 0xF1 + 3*kdel (DELEGATECALL 0xF4) + 9*ksta
        # (STATICCALL 0xFA) on both rows of the pair
        kdel_l = b.local(KDEL)
        ksta_l = b.local(KSTA)
        f_callpair = b.add(f["call"], f["callret"])
        op_expr = b.add(
            op_expr,
            b.mul(
                f_callpair, b.add(b.scale(3, kdel_l), b.scale(9, ksta_l))
            ),
        )
        # CREATE2 selector: op = 0xF0 + 5*kc2, create/createret rows only
        kc2_l = b.local(KC2)
        f_crepair = b.add(f["create"], f["createret"])
        op_expr = b.add(op_expr, b.mul(f_crepair, b.scale(5, kc2_l)))
        b.all_rows(b.sub(op, op_expr))
        # kind bits live on call/callret (resp. create) rows only, at
        # most one set, and mirror onto the pair's second row
        b.all_rows(b.mul(kdel_l, b.sub(one, f_callpair)))
        b.all_rows(b.mul(ksta_l, b.sub(one, f_callpair)))
        b.all_rows(b.mul(kdel_l, ksta_l))
        b.transition(b.mul(f["call"], b.sub(b.next(KDEL), kdel_l)))
        b.transition(b.mul(f["call"], b.sub(b.next(KSTA), ksta_l)))
        b.all_rows(b.mul(kc2_l, b.sub(one, f_crepair)))
        b.transition(b.mul(f["create"], b.sub(b.next(KC2), kc2_l)))
        # dup/swap n <= 16
        b.all_rows(b.mul(b.add(f["dup"], f["swap"]), b.local(FAMB0 + 4)))
        # log n <= 5: n-1 in 0..4 — bits 3/4 clear, and bit 2 excludes 5..7
        logf2 = b.add(f["log"], f["logext"])
        b.all_rows(
            b.mul(logf2, b.add(b.local(FAMB0 + 3), b.local(FAMB0 + 4)))
        )
        b.all_rows(
            b.mul(
                b.mul(logf2, b.local(FAMB0 + 2)),
                b.add(b.local(FAMB0), b.local(FAMB0 + 1)),
            )
        )

        # 4. halting discipline (STOP, RETURN or REVERT)
        b.first_row(halted)
        b.transition(
            b.sub(
                b.sub(b.sub(b.sub(halted_n, halted), f["stop"]), f["return"]),
                f["revert"],
            )
        )
        b.last_row(b.sub(halted, one))
        # the reverted public selects WHICH halt opcode ended the frame
        rev_pub = b.public(PUB_REVERTED)
        static_pub = b.public(PUB_STATIC)
        b.all_rows(b.mul(rev_pub, b.add(f["stop"], f["return"])))
        b.all_rows(b.mul(b.sub(one, rev_pub), f["revert"]))
        # coverage v1: a reverting frame is effect-free, and a static
        # frame makes no writes (STATICCALL semantics) — in-circuit
        for gate in (rev_pub, static_pub):
            b.all_rows(b.mul(gate, f["sstore"]))
            b.all_rows(b.mul(gate, f["log"]))
            b.all_rows(b.mul(gate, f["create"]))
        b.all_rows(b.mul(rev_pub, f["call"]))

        # 5. clock
        b.first_row(clk)
        b.transition(b.sub(clk_n, b.add(clk, one)))

        # 6. program counter
        b.first_row(pc)
        dest = lA[0]
        # call and log rows do not advance pc (their second rows do)
        seq = b.sub(
            b.sub(
                b.sub(
                    b.sub(
                        b.sub(b.sub(b.sub(one, halted), f["stop"]), f["jump"]),
                        f["jumpi"],
                    ),
                    b.add(f["return"], f["revert"]),
                ),
                b.add(f["call"], f["create"]),
            ),
            f["log"],
        )
        adv = b.add(seq, b.mul(f["push"], fam_n))
        jmp = b.mul(f["jump"], b.sub(dest, pc))
        jmpi = b.mul(
            f["jumpi"],
            b.add(b.mul(taken, b.sub(dest, pc)), b.sub(one, taken)),
        )
        b.transition(b.sub(pc_n, b.add(b.add(pc, adv), b.add(jmp, jmpi))))
        # jump targets must fetch a JUMPDEST
        b.transition(b.mul(f["jump"], b.sub(op_n, b.constant(0x5B))))
        b.transition(b.mul(b.mul(f["jumpi"], taken), b.sub(op_n, b.constant(0x5B))))
        # dest < 2^15
        jsel = b.add(f["jump"], b.mul(f["jumpi"], taken))
        desthi = b.local_block(range(A0 + 15, A0 + 256))
        b.all_rows_block(b.mul(jsel, desthi), 241)

        # 7. stack pointer
        b.first_row(sp)
        b.all_rows(b.mul(b.local(SP_TOP), b.sub(sp, b.constant(1024))))
        delta = None
        for nm in FLAG_NAMES:
            d = _sp_delta(nm)
            if d == 0:
                continue
            term = b.scale(d % bb.P, f[nm])
            delta = term if delta is None else b.add(delta, term)
        # the logext row pops the fam_n - 1 topic values
        delta = b.sub(delta, b.mul(f["logext"], b.sub(fam_n, one)))
        # 6-arg call variants (DELEGATECALL/STATICCALL) pop one less:
        # the callret net is -5, not -6; CREATE2 pops one more than
        # CREATE (the salt)
        delta = b.add(delta, b.mul(f["callret"], b.add(kdel_l, ksta_l)))
        delta = b.sub(delta, b.mul(f["createret"], kc2_l))
        b.transition(b.sub(sp_n, b.add(sp, delta)))
        b.last_row(b.sub(sp, b.public(PUB_SPF)))

        # 8. gas metering
        g0 = b.add(b.public(PUB_GAS0), b.scale(1 << 16, b.public(PUB_GAS0 + 1)))
        gf_pub = b.add(b.public(PUB_GASF), b.scale(1 << 16, b.public(PUB_GASF + 1)))
        b.first_row(b.sub(G, g0))
        b.last_row(b.sub(G, gf_pub))
        cost = None
        for nm in FLAG_NAMES:
            c = _gas_cost(nm)
            if c == 0:
                continue
            term = b.scale(c, f[nm])
            cost = term if cost is None else b.add(cost, term)
        # dynamic memory expansion: 3 per new word + the quadratic-term
        # delta (witnessed as dq, bound in section 14d), plus KECCAK256's
        # 6 gas per hashed word
        f_kec = f["keccak"]
        f_ret = b.add(f["return"], f["revert"])  # both halt with a span
        f_log = f["log"]
        f_m8 = f["mstore8"]
        # keccak/return/revert/log/create/calldatacopy/codecopy all meter
        # a word-aligned (offset, size) range via the sw/slack machinery
        f_kr = b.add(
            b.add(b.add(f_kec, f_ret), b.add(f_log, f["create"])),
            b.add(f["calldatacopy"], f["codecopy"]),
        )
        # expansion/dq group (MSTORE8 expands too, at ANY byte offset)
        f_mx = b.add(
            b.add(b.add(b.add(f["mload"], f["mstore"]), f_kr), f_m8),
            f["call"],
        )

        def reg_val(base: int, nbits: int, nx: bool):
            g = b.next if nx else b.local
            acc = None
            for i in range(nbits):
                t = b.scale(1 << i, g(base + i))
                acc = t if acc is None else b.add(acc, t)
            return acc

        M = reg_val(MEMB0, 14, False)
        M_n = reg_val(MEMB0, 14, True)
        dqval = reg_val(MW_DQ0, 18, False)
        swval = reg_val(KSW0, 10, False)
        cost = b.add(cost, b.add(b.scale(3, b.sub(M_n, M)), b.mul(f_mx, dqval)))
        cost = b.add(cost, b.scale(6, b.mul(f_kec, swval)))
        # CALLDATACOPY: 3 per copied word; size must be a word multiple
        # (slack = 0) and the offset (W) must fit 15 bits
        cost = b.add(
            cost,
            b.scale(3, b.mul(b.add(f["calldatacopy"], f["codecopy"]), swval)),
        )
        # LOGn: 375*n (n = topics + 1) + 8*size (size = B low 15 bits,
        # bound by the f_kr group's 32*sw = size + slack constraint)
        cost = b.add(cost, b.mul(f_log, b.scale(375, fam_n)))
        cost = b.add(cost, b.scale(8, b.mul(f_log, lB[0])))
        # EXP: 10 + 50*L where the 33-wide one-hot at SCRATCH0 selects the
        # exponent byte length L; bytes >= L of B must be zero (suffix
        # sums).  L can only be OVER-claimed (never under: the suffix
        # check forbids it), i.e. a dishonest prover can at most charge
        # itself extra gas — same trust class as the frame gas publics.
        f_exp = f["exp"]
        exp_oh = [b.local(SCRATCH0 + i) for i in range(33)]
        oh_sum = exp_oh[0]
        lsum = None
        for i in range(1, 33):
            oh_sum = b.add(oh_sum, exp_oh[i])
            t = b.scale(i, exp_oh[i])
            lsum = t if lsum is None else b.add(lsum, t)
        b.all_rows(b.mul(f_exp, b.sub(oh_sum, one)))
        cost = b.add(
            cost, b.mul(f_exp, b.add(b.constant(10), b.scale(50, lsum)))
        )
        # minimality: the byte at L-1 must be NONZERO (L cannot be over-
        # claimed; the suffix check already forbids under-claims).  The
        # selected byte is materialized in S_INV (raw, unused by the
        # nonzero gadget on exp rows since its inputs are all zero) and
        # inverted through INV0[0].
        # (the selected-byte sum is emitted in 14a next to bbytes)
        # storage gas (EIP-2929/2200): SLOAD 100 + 2000*cold; SSTORE
        # 100 + 2800*g1 + 19900*g2 + 2100*cold
        f_sl, f_ss = f["sload"], f["sstore"]
        scold = b.local(SCOLD)
        sg1 = b.local(SG1)
        sg2 = b.local(SG2)
        cost = b.add(cost, b.scale(100, b.add(f_sl, f_ss)))
        cost = b.add(cost, b.scale(2000, b.mul(f_sl, scold)))
        cost = b.add(cost, b.scale(2100, b.mul(f_ss, scold)))
        cost = b.add(cost, b.add(b.scale(2800, sg1), b.scale(19900, sg2)))
        # CALL / BALANCE / EXTCODESIZE / EXTCODEHASH: +2500 on a cold
        # address (base 100 is the flag's static cost); the callret row
        # pays gas_in and gets gas_ret back
        f_acctaddr = b.add(
            b.add(f["balance"], f["extcodesize"]), f["extcodehash"]
        )
        cost = b.add(
            cost,
            b.scale(2500, b.mul(b.add(f["call"], f_acctaddr), scold)),
        )

        def scratch_val(base: int, nbits: int, nx: bool = False):
            g = b.next if nx else b.local
            acc = None
            for i in range(nbits):
                t = b.scale(1 << i, g(SCRATCH0 + base + i))
                acc = t if acc is None else b.add(acc, t)
            return acc

        gasin_l = scratch_val(RW_GASIN0, 28)
        gasret_l = scratch_val(RW_GASRET0, 28)
        # the callret row pays the forwarded gas (gasin already includes
        # the 2300 stipend on value calls — the caller never paid it, so
        # it is subtracted back out) and receives the callee's leftover
        cost = b.add(
            cost,
            b.mul(
                f["callret"],
                b.sub(
                    b.sub(gasin_l, gasret_l),
                    b.scale(2300, taken),
                ),
            ),
        )
        # CallValueTransferGas (9000) on the call row when the NEXT row's
        # nonzero gadget says the popped value word is nonzero
        cost = b.add(
            cost, b.scale(9000, b.mul(f["call"], b.next(TAKEN)))
        )
        # CREATE: initcode word cost (EIP-3860: 2/word; CREATE2 adds the
        # 6/word hashing charge); the createret row pays the forwarded
        # gas, receives the child's leftover, and re-charges the
        # 200/byte code deposit on the child's public returndata size
        cost = b.add(
            cost,
            b.mul(
                f["create"],
                b.add(
                    b.scale(2, swval), b.scale(6, b.mul(kc2_l, swval))
                ),
            ),
        )
        rds_loc = scratch_val(RW_RDS0, 13)
        cost = b.add(
            cost,
            b.mul(
                f["createret"],
                b.add(
                    b.sub(gasin_l, gasret_l), b.scale(200, rds_loc)
                ),
            ),
        )
        b.transition(b.sub(G_n, b.sub(G, cost)))
        # gas register capped below 2^28 (MAX_GAS_LOG): bits 28..31 are
        # zero on every row, so no gas equation can wrap mod p — the
        # property the old "32-bit register wraps mod p" note only
        # conjectured is now structural
        gas_top = b.local_block(range(GASB0 + MAX_GAS_LOG, GASB0 + 32))
        b.all_rows_block(gas_top, 32 - MAX_GAS_LOG)
        # returndata-size public: the halting step binds PUB_RDS (the
        # RETURN size's low limb — its high bits are zero via the f_kr
        # group's 15-bit size check; 0 for STOP)
        b.all_rows(b.mul(f_ret, b.sub(lB[0], b.public(PUB_RDS))))
        b.all_rows(b.mul(f["stop"], b.public(PUB_RDS)))
        # EXP byte-length suffix check (bbytes defined in section 14a;
        # emitted there to reuse the byte linmaps)

        # 9. the shared 256-bit adder gadget: X + Y = Z + carry-out*2^256
        def flip_limb(l15, msb):
            # top limb with the sign bit inverted: l + 2^15 - 2^16*msb
            return b.sub(b.add(l15, b.constant(1 << 15)), b.scale(1 << 16, msb))

        a_msb = b.local(A0 + 255)
        b_msb = b.local(B0 + 255)
        lAf15 = flip_limb(lA[15], a_msb)
        lBf15 = flip_limb(lB[15], b_msb)
        cmp_f = fsum(_CMP)
        f_cdl = f["calldataload"]
        # block form: limb blocks with the sign-flipped top limb variants
        lAf = b.concat_rows([lA[:15], b.stack_block([lAf15])])
        lBf = b.concat_rows([lB[:15], b.stack_block([lBf15])])
        sizeblk = b.public_block(
            range(PUB_ENV0 + 16 * ENV_IDX_CDSIZE, PUB_ENV0 + 16 * ENV_IDX_CDSIZE + 16)
        )
        cb = b.local_block(range(CARRY0, CARRY0 + 16))
        cb_prev = b.concat_rows([b.scale(0, cb[:1]), cb[:15]])
        X = b.add(
            b.add(b.mul(f["add"], lA), b.mul(b.add(f["sub"], f["lt"]), lB)),
            b.add(
                b.add(b.mul(f["gt"], lA), b.mul(f_cdl, sizeblk)),
                b.add(b.mul(f["slt"], lBf), b.mul(f["sgt"], lAf)),
            ),
        )
        Y = b.add(
            b.add(b.mul(f["add"], lB), b.mul(f["sub"], lC)),
            b.mul(b.add(cmp_f, f_cdl), lW),
        )
        Z = b.add(
            b.add(b.mul(f["add"], lC), b.mul(b.add(f["sub"], f["lt"]), lA)),
            b.add(
                b.add(b.mul(f["gt"], lB), b.mul(f_cdl, lA)),
                b.add(b.mul(f["slt"], lAf), b.mul(f["sgt"], lBf)),
            ),
        )
        b.all_rows_block(
            b.sub(
                b.add(b.add(X, Y), cb_prev),
                b.add(Z, b.scale(1 << 16, cb)),
            ),
            16,
        )

        # 10. nonzero gadget (EQ / ISZERO / JUMPI condition / shift "big"
        # / DIV-MOD divisor / KECCAK256 size / SIGNEXTEND index)
        f_sh3 = fsum(_SHIFTS)
        f_byte = f["byte"]
        f_se = f["signextend"]
        f_dm = b.add(f["div"], f["mod"])
        # "shift amount >= 256" <=> some A bit >= 8; "index >= 32" <=> >= 5
        a_hi8 = b.linmap([[1] * 248], b.local_block(range(A0 + 8, A0 + 256)))[0]
        a_hi5 = b.linmap([[1] * 251], b.local_block(range(A0 + 5, A0 + 256)))[0]
        b_lo15 = b.linmap([[1] * 15], b.local_block(range(B0, B0 + 15)))[0]
        g_hi20 = b.linmap(
            [[1] * 20], b.local_block(range(GASB0 + 12, GASB0 + 32))
        )[0]
        # block form: all 16 limb inputs at once; the single-limb inputs
        # (shift/BYTE/SIGNEXTEND/KECCAK/RETURN/SSTORE gates) live on row 0
        o_low5 = None
        for bit in range(5):
            t = b.scale(1 << bit, b.local(A0 + bit))
            o_low5 = t if o_low5 is None else b.add(o_low5, t)
        c_pop15 = b.linmap([[1] * 15], b.local_block(range(C0, C0 + 15)))[0]
        extra0 = b.add(
            b.add(b.mul(f_sh3, a_hi8), b.mul(b.add(f_byte, f_se), a_hi5)),
            b.add(
                b.add(
                    b.mul(
                        b.add(
                            b.add(f_kec, f_ret),
                            b.add(
                                b.add(f["log"], f["create"]),
                                b.add(f["calldatacopy"], f["codecopy"]),
                            ),
                        ),
                        b_lo15,
                    ),
                    b.mul(f["sstore"], g_hi20),
                ),
                b.add(
                    b.mul(b.add(f["mload"], f["mstore"]), o_low5),
                    # call row: taken = [argsSize != 0] (C's popcount)
                    b.mul(f["call"], c_pop15),
                ),
            ),
        )
        inp_blk = b.add(
            b.add(
                b.mul(f["eq"], b.sub(lA, lB)),
                b.add(b.mul(f["iszero"], lA), b.mul(f["jumpi"], lB)),
            ),
            b.add(
                # the callret/createret row's gadget carries [value != 0]:
                # A holds the value word (pinned 0 on 6-arg variants;
                # bound to the create row's W pop on createret rows)
                b.add(
                    b.mul(f_dm, lB),
                    b.mul(b.add(f["callret"], f["createret"]), lA),
                ),
                b.concat_rows([b.stack_block([extra0]), b.scale(0, lA[:15])]),
            ),
        )
        nzb = b.local_block(range(NZ0, NZ0 + 16))
        invb = b.local_block(range(INV0, INV0 + 16))
        b.all_rows_block(b.sub(nzb, b.mul(inp_blk, invb)), 16)
        b.all_rows_block(b.mul(inp_blk, b.sub(one, nzb)), 16)
        s_acc = b.block_rowsum(nzb)
        b.all_rows(b.sub(taken, b.mul(s_acc, s_inv)))
        b.all_rows(b.mul(s_acc, b.sub(one, taken)))

        # 11. boolean results (comparisons / EQ / ISZERO)
        eqz = b.add(f["eq"], f["iszero"])
        b.all_rows(b.mul(cmp_f, b.sub(b.local(C0), carries[15])))
        b.all_rows(b.mul(eqz, b.sub(b.local(C0), b.sub(one, taken))))
        chi_bits = b.local_block(range(C0 + 1, C0 + 256))
        b.all_rows_block(b.mul(b.add(cmp_f, eqz), chi_bits), 255)

        # 12. bitwise / copy semantics
        AB = b.mul(Ablk, Bblk)
        b.all_rows_block(b.mul(f["and"], b.sub(Cblk, AB)), 256)
        b.all_rows_block(
            b.mul(f["or"], b.sub(Cblk, b.sub(b.add(Ablk, Bblk), AB))), 256
        )
        b.all_rows_block(
            b.mul(f["xor"], b.sub(Cblk, b.sub(b.add(Ablk, Bblk), b.scale(2, AB)))),
            256,
        )
        b.all_rows_block(
            b.mul(f["not"], b.sub(Cblk, b.sub(one, Ablk))), 256
        )
        b.all_rows_block(b.mul(f["dup"], b.sub(Cblk, Ablk)), 256)
        b.all_rows_block(b.mul(f["push0"], Cblk), 256)

        # 13. environment constants from publics
        for k, nm in enumerate(ENV_OPS):
            pub = b.public_block(range(PUB_ENV0 + 16 * k, PUB_ENV0 + 16 * k + 16))
            diff = b.sub(b.stack_block([lC[i] for i in range(16)]), pub)
            b.all_rows_block(b.mul(f[nm], diff), 16)

        # 14. PC / GAS pushes
        b.all_rows(b.mul(f["pc"], b.sub(lC[0], pc)))
        pchi = b.local_block(range(C0 + 16, C0 + 256))
        b.all_rows_block(b.mul(f["pc"], pchi), 240)
        b.transition(b.mul(f["gas"], b.sub(lC[0], Gn_lo)))
        b.transition(b.mul(f["gas"], b.sub(lC[1], Gn_hi)))
        gashi = b.local_block(range(C0 + 32, C0 + 256))
        b.all_rows_block(b.mul(f["gas"], gashi), 224)

        # 14a. MUL: schoolbook byte product with 13-bit carries.  At each
        # output byte k: sum_{i+j=k} a_i*b_j + carry_{k-1} = c_k + 256*carry_k;
        # the high half of the product is discarded (mod 2^256 semantics).
        f_mul = f["mul"]
        abytes = b.linmap(_BYTE_MAT, Ablk)
        bbytes = b.linmap(_BYTE_MAT, Bblk)
        cbytes = b.linmap(_BYTE_MAT, Cblk)
        wbytes = b.linmap(_BYTE_MAT, Wblk)
        scratch_blk = b.local_block(range(SCRATCH0, SCRATCH0 + N_SCRATCH))
        mulc = b.linmap(_MULC_MAT, scratch_blk)
        mulc_prev = b.concat_rows([b.scale(0, mulc[:1]), mulc[:31]])

        def shift32_down(blk, k):
            """Row j -> blk[j - k] over a 32-row block (zeros below)."""
            if k == 0:
                return blk
            return b.concat_rows([b.scale(0, blk[:k]), blk[: 32 - k]])

        def byte_conv(qb):
            """32-row block: conv_k = sum_{i<=k} qb_i * b_{k-i} (block
            form: 32 scalar-row x block products instead of 528 scalar
            graph nodes — XLA compile time scales with node count)."""
            acc = None
            for i in range(32):
                t = b.mul(qb[i], shift32_down(bbytes, i))
                acc = t if acc is None else b.add(acc, t)
            return acc

        # suffix sums of B's bytes: suffix_i = sum_{j >= i} b_j, so the
        # whole discarded high half is sum_i qb_i * suffix_{32-i} (i>=1)
        _SUF_MAT = [[1 if j > 31 - i else 0 for j in range(32)] for i in range(32)]
        bsuffix = b.linmap(_SUF_MAT, bbytes)  # bsuffix[i] = sum_{j>=32-i} b_j

        def high_half(qb):
            acc = None
            for i in range(1, 32):
                t = b.mul(qb[i], bsuffix[i])
                acc = t if acc is None else b.add(acc, t)
            return acc

        # EXP suffix-zero: one-hot position i forbids any B byte >= i
        _ESUF = [
            [1 if j >= i else 0 for j in range(32)] for i in range(33)
        ]
        bsfx = b.linmap(_ESUF, bbytes)  # bsfx[i] = sum_{j>=i} b_j
        for i in range(33):
            b.all_rows(b.mul(b.mul(f_exp, exp_oh[i]), bsfx[i]))
        # EXP minimality: selected byte b_{L-1} (held in S_INV) nonzero
        vsel = None
        for i in range(1, 33):
            t = b.mul(exp_oh[i], bbytes[i - 1])
            vsel = t if vsel is None else b.add(vsel, t)
        b.all_rows(b.mul(f_exp, b.sub(s_inv, vsel)))
        b.all_rows(
            b.mul(
                f_exp,
                b.sub(
                    b.mul(s_inv, b.local(INV0)),
                    b.sub(one, exp_oh[0]),
                ),
            )
        )

        conv_ab = byte_conv(abytes)
        b.all_rows_block(
            b.mul(
                f_mul,
                b.sub(
                    b.add(conv_ab, mulc_prev),
                    b.add(cbytes, b.scale(256, mulc)),
                ),
            ),
            32,
        )

        # 14a'. DIV / MOD: q*b + r = a over the integers (same 13-bit
        # chain carries; DIV: q = C, r = W; MOD: q = W, r = C), the high
        # half of q*b forced to zero, and r <= b - 1 via a byte borrow
        # chain.  b == 0 (taken = 0 through the nonzero gadget on B's
        # limbs) forces q = r = 0 and the chain target becomes 0.
        dmbr = b.local_block(range(DMB0, DMB0 + 32))
        dmbr_prev = b.concat_rows([b.scale(0, dmbr[:1]), dmbr[:31]])
        _DMT_MAT = [[0] * 256 for _ in range(32)]
        for _k in range(32):
            for _t in range(8):
                _DMT_MAT[_k][8 * _k + _t] = 1 << _t
        tbytes = b.linmap(_DMT_MAT, b.local_block(range(DMT0, DMT0 + 256)))
        sub1 = b.const_vec([1] + [0] * 31)  # the "- 1" at byte 0
        for fg, qb, rb in ((f["div"], cbytes, wbytes), (f["mod"], wbytes, cbytes)):
            conv = byte_conv(qb)
            target = b.mul(taken, abytes)
            b.all_rows_block(
                b.mul(
                    fg,
                    b.sub(
                        b.add(b.add(conv, rb), mulc_prev),
                        b.add(target, b.scale(256, mulc)),
                    ),
                ),
                32,
            )
            b.all_rows(b.mul(fg, b.add(high_half(qb), mulc[31])))
            # borrow chain: b_k - r_k - [k==0] - br_{k-1} + 256*br_k = t_k
            chain = b.sub(
                b.add(b.sub(bbytes, rb), b.scale(256, dmbr)),
                b.add(b.add(sub1, dmbr_prev), tbytes),
            )
            b.all_rows_block(b.mul(fg, chain), 32)
        # no final borrow when b != 0; q = r = 0 when b == 0
        b.all_rows(b.mul(b.mul(f_dm, taken), dmbr[31]))
        not_taken_dm = b.mul(f_dm, b.sub(one, taken))
        b.all_rows_block(b.mul(not_taken_dm, Cblk), 256)
        b.all_rows_block(b.mul(not_taken_dm, Wblk), 256)

        # 14b. shifts / BYTE: two one-hot stages.  Stage 1 (byte shift by
        # q, one-hot OHQ) lands in the W region; stage 2 (bit shift by r,
        # one-hot OHR) produces C.  A shift amount >= 256 (taken=1, via
        # the nonzero gadget above) zeroes both one-hots, forcing C = 0
        # (SHL/SHR) or the sign fill (SAR).
        f_shl, f_shr, f_sar = f["shl"], f["shr"], f["sar"]
        ohq = [b.local(OHQ0 + q) for q in range(32)]
        ohr = [b.local(OHR0 + r) for r in range(8)]
        sum_ohq = ohq[0]
        wq1 = None  # sum q * ohq_q
        for q in range(1, 32):
            sum_ohq = b.add(sum_ohq, ohq[q])
            t = b.scale(q, ohq[q])
            wq1 = t if wq1 is None else b.add(wq1, t)
        sum_ohr = ohr[0]
        wr = None  # sum r * ohr_r
        for r in range(1, 8):
            sum_ohr = b.add(sum_ohr, ohr[r])
            t = b.scale(r, ohr[r])
            wr = t if wr is None else b.add(wr, t)
        not_big = b.sub(one, taken)
        f_m8q = f["mstore8"]
        shift_any = b.add(b.add(f_sh3, b.add(f_byte, f_se)), f_m8q)
        b.all_rows(b.mul(shift_any, b.sub(sum_ohq, not_big)))
        b.all_rows(b.mul(f_sh3, b.sub(sum_ohr, not_big)))
        b.all_rows(b.mul(b.add(b.add(f_byte, f_se), f_m8q), sum_ohr))
        s_low = None  # low byte of A (shift amount)
        for bit in range(8):
            t = b.scale(1 << bit, b.local(A0 + bit))
            s_low = t if s_low is None else b.add(s_low, t)
        i_low = None  # low 5 bits of A (BYTE index)
        for bit in range(5):
            t = b.scale(1 << bit, b.local(A0 + bit))
            i_low = t if i_low is None else b.add(i_low, t)
        b.all_rows(
            b.mul(f_sh3, b.sub(b.add(b.scale(8, wq1), wr), b.mul(not_big, s_low)))
        )
        b.all_rows(
            b.mul(
                b.add(b.add(f_byte, f_se), f_m8q),
                b.sub(wq1, b.mul(not_big, i_low)),
            )
        )

        def shift_up(blk, k):
            """Row i -> blk[i + k], zero beyond the end."""
            if k == 0:
                return blk
            return b.concat_rows([blk[k:], b.scale(0, blk[:k])])

        def shift_up_fill(blk, k, fill):
            if k == 0:
                return blk
            pad = b.mul(fill, b.add(b.scale(0, blk[:k]), one))
            return b.concat_rows([blk[k:], pad])

        def shift_down(blk, k):
            """Row i -> blk[i - k], zero below zero."""
            if k == 0:
                return blk
            return b.concat_rows([b.scale(0, blk[:k]), blk[: 256 - k]])

        def onehot_sum(sels, blocks):
            acc = None
            for s_, blk_ in zip(sels, blocks):
                t = b.mul(s_, blk_)
                acc = t if acc is None else b.add(acc, t)
            return acc

        # stage 1: W = B byte-shifted by q (sign-filled for SAR)
        b.all_rows_block(
            b.mul(
                f_shr,
                b.sub(Wblk, onehot_sum(ohq, [shift_up(Bblk, 8 * q) for q in range(32)])),
            ),
            256,
        )
        b.all_rows_block(
            b.mul(
                f_shl,
                b.sub(
                    Wblk, onehot_sum(ohq, [shift_down(Bblk, 8 * q) for q in range(32)])
                ),
            ),
            256,
        )
        b.all_rows_block(
            b.mul(
                f_sar,
                b.sub(
                    Wblk,
                    onehot_sum(
                        ohq, [shift_up_fill(Bblk, 8 * q, b_msb) for q in range(32)]
                    ),
                ),
            ),
            256,
        )
        # stage 2: C = W bit-shifted by r
        b.all_rows_block(
            b.mul(
                f_shr,
                b.sub(Cblk, onehot_sum(ohr, [shift_up(Wblk, r) for r in range(8)])),
            ),
            256,
        )
        b.all_rows_block(
            b.mul(
                f_shl,
                b.sub(Cblk, onehot_sum(ohr, [shift_down(Wblk, r) for r in range(8)])),
            ),
            256,
        )
        b.all_rows_block(
            b.mul(
                f_sar,
                b.sub(
                    Cblk,
                    b.add(
                        onehot_sum(
                            ohr, [shift_up_fill(Wblk, r, b_msb) for r in range(8)]
                        ),
                        b.mul(taken, b_msb),
                    ),
                ),
            ),
            256,
        )
        # MLOAD (any offset): one-hot bound to k = A mod 32 directly
        # (taken = [k != 0] via the nonzero gadget), value recombined
        # from the two read words: C = (B << 8k | W >> 8(32-k))
        f_mldq = b.add(f["mload"], f["mstore"])
        b.all_rows(b.mul(f_mldq, b.sub(sum_ohq, one)))
        b.all_rows(b.mul(f_mldq, b.sub(wq1, i_low)))
        b.all_rows(b.mul(f_mldq, sum_ohr))
        mld_acc = None
        for k in range(32):
            if k == 0:
                pat = Bblk
            else:
                pat = b.concat_rows([Wblk[8 * (32 - k) :], Bblk[: 256 - 8 * k]])
            t = b.mul(ohq[k], pat)
            mld_acc = t if mld_acc is None else b.add(mld_acc, t)
        b.all_rows_block(b.mul(f["mload"], b.sub(Cblk, mld_acc)), 256)

        # MSTORE8: C (the written word) = W (the read word) with the
        # big-endian byte k replaced by B's low byte
        m8_acc = None
        for k in range(32):
            lo = 8 * (31 - k)
            parts = []
            if lo > 0:
                parts.append(Wblk[:lo])
            parts.append(Bblk[:8])
            if lo + 8 < 256:
                parts.append(Wblk[lo + 8 :])
            pat = b.concat_rows(parts)
            t = b.mul(ohq[k], pat)
            m8_acc = t if m8_acc is None else b.add(m8_acc, t)
        b.all_rows_block(b.mul(f_m8q, b.sub(Cblk, m8_acc)), 256)

        # BYTE: C byte 0 = big-endian byte q of B; upper bits zero
        sel = None
        for q in range(32):
            bq = b.local_block(range(B0 + 8 * (31 - q), B0 + 8 * (31 - q) + 8))
            t = b.mul(ohq[q], bq)
            sel = t if sel is None else b.add(sel, t)
        c_low8 = b.local_block(range(C0, C0 + 8))
        b.all_rows_block(b.mul(f_byte, b.sub(c_low8, sel)), 8)
        byte_hi = b.local_block(range(C0 + 8, C0 + 256))
        b.all_rows_block(b.mul(f_byte, byte_hi), 248)
        # SIGNEXTEND: C = B through byte k, sign-filled above; k >= 32
        # (taken) copies B unchanged
        se_acc = None
        for q in range(32):
            keep = 8 * q + 8
            sign_bit = b.local(B0 + 8 * q + 7)
            fillpat = b.mul(
                sign_bit, b.add(b.scale(0, Bblk[: 256 - keep]), one)
            )
            pat = (
                Bblk
                if keep == 256
                else b.concat_rows([Bblk[:keep], fillpat])
            )
            t = b.mul(ohq[q], pat)
            se_acc = t if se_acc is None else b.add(se_acc, t)
        b.all_rows_block(
            b.mul(f_se, b.sub(Cblk, b.add(se_acc, b.mul(taken, Bblk)))), 256
        )

        # 14c. CALLDATALOAD: out-of-bounds (offset >= size, carry15 == 0)
        # pushes zero; in-bounds sends (offset, word) on the calldata
        # channel (adder gadget wiring proves the bound, section 9).
        b.all_rows_block(
            b.mul(b.mul(f_cdl, b.sub(one, carries[15])), Cblk), 256
        )

        # 14d. memory (word-aligned MLOAD/MSTORE + MSIZE).  The msize
        # register M (words) grows to max(M, waddr+1) via the witnessed
        # comparison; the quadratic gas term's delta dq is bound by
        # M'^2 - M^2 = 512*dq + r1 - r0 with 9-bit remainders (values
        # stay < 2^26 < p under the 2^13-word coverage cap).
        f_mld, f_mst, f_msz = f["mload"], f["mstore"], f["msize"]
        grow = b.local(MW_GROW)
        kneed = b.local(KNEED)
        dval = reg_val(MW_D0, 14, False)
        r0val = reg_val(MW_R0, 9, False)
        r1val = reg_val(MW_R1, 9, False)
        slval = reg_val(KSL0, 5, False)
        waddr = None
        for bit in range(5, 18):
            t = b.scale(1 << (bit - 5), b.local(A0 + bit))
            waddr = t if waddr is None else b.add(waddr, t)
        # the expansion target: waddr+1 for MLOAD/MSTORE; for KECCAK256,
        # waddr+sw when size != 0 (taken, via the nonzero gadget), else 0
        b.all_rows(
            b.mul(f["mstore8"], b.sub(kneed, b.add(waddr, one)))
        )
        b.all_rows(
            b.mul(
                b.add(f_mld, f_mst),
                b.sub(kneed, b.add(b.add(waddr, one), taken)),
            )
        )
        b.all_rows(
            b.mul(f_kr, b.sub(kneed, b.mul(taken, b.add(waddr, swval))))
        )
        # KECCAK256/RETURN word count: 32*sw = size + slack (slack < 32),
        # and size must fit 15 bits
        b.all_rows(
            b.mul(f_kr, b.sub(b.scale(32, swval), b.add(lB[0], slval)))
        )
        kec_size_hi = b.local_block(range(B0 + 15, B0 + 256))
        b.all_rows_block(b.mul(f_kr, kec_size_hi), 241)
        b.first_row(M)
        b.transition(b.sub(M_n, b.add(M, b.mul(grow, b.sub(kneed, M)))))
        b.all_rows(b.mul(grow, b.sub(one, f_mx)))
        b.all_rows(b.mul(grow, b.sub(b.sub(kneed, b.add(M, one)), dval)))
        b.all_rows(
            b.mul(b.mul(f_mx, b.sub(one, grow)), b.sub(b.sub(M, kneed), dval))
        )
        # range: offset bits 18..255 zero for every memory-metering op;
        # 32-byte alignment (bits 0..4 zero) for all EXCEPT MSTORE8,
        # which addresses single bytes
        addr_hi_bits = b.local_block(range(A0 + 18, A0 + 256))
        b.all_rows_block(b.mul(f_mx, addr_hi_bits), 238)
        addr_lo_bits = b.local_block(range(A0, A0 + 5))
        b.all_rows_block(
            b.mul(
                b.sub(b.sub(b.sub(f_mx, f["mstore8"]), f_mld), f["mstore"]),
                addr_lo_bits,
            ),
            5,
        )
        # quadratic-term delta
        b.transition(
            b.mul(
                f_mx,
                b.sub(
                    b.sub(b.mul(M_n, M_n), b.mul(M, M)),
                    b.add(b.sub(r1val, r0val), b.scale(512, dqval)),
                ),
            )
        )
        # MSIZE pushes 32*M
        b.all_rows(
            b.mul(
                f_msz,
                b.sub(b.add(lC[0], b.scale(1 << 16, lC[1])), b.scale(32, M)),
            )
        )
        msz_hi = b.local_block(range(C0 + 19, C0 + 256))
        b.all_rows_block(b.mul(f_msz, msz_hi), 237)

        # 14e. memory channel: one RAM tuple per MLOAD/MSTORE, and
        # MSTORE8's read-modify-write pair (read old W at 4clk, write the
        # spliced C at 4clk+1 through the second accumulator)
        vmem = b.add(
            Cblk,
            b.add(
                b.mul(f_mld, b.sub(Bblk, Cblk)),
                b.mul(f["mstore8"], b.sub(Wblk, Cblk)),
            ),
        )
        vcode_m = b.bit_block_code(vmem, chi, b.constant(0), 32)
        inner_m = vcode_m
        clk4m = b.scale(4, clk)
        code_m = b.ef_add4(
            b.ef_from_base4(waddr),
            b.ef_mul4(
                chi, b.ef_add4(b.ef_from_base4(clk4m), b.ef_mul4(chi, inner_m))
            ),
        )
        accM = [b.aux(AUX_M + c) for c in range(4)]
        accM_n = [b.aux_next(AUX_M + c) for c in range(4)]
        prodM = b.ef_mul4(b.ef_sub4(accM_n, accM), b.ef_sub4(g_m, code_m))
        actM = b.ef_from_base4(b.add(b.add(f_mld, f_mst), f["mstore8"]))
        for c in range(4):
            b.transition(b.sub(prodM[c], actM[c]))
            b.first_row(accM[c])
        f_mm = b.add(f_mld, f_mst)
        v2 = b.add(Cblk, b.mul(f_mm, b.sub(Wblk, Cblk)))
        vcode_m2 = b.bit_block_code(v2, chi, b.constant(0), 32)
        inner_m2 = b.ef_add4(b.ef_from_base4(f["mstore8"]), vcode_m2)
        waddr2 = b.add(waddr, f_mm)
        code_m2 = b.ef_add4(
            b.ef_from_base4(waddr2),
            b.ef_mul4(
                chi,
                b.ef_add4(
                    b.ef_from_base4(b.add(clk4m, one)), b.ef_mul4(chi, inner_m2)
                ),
            ),
        )
        accM2 = [b.aux(AUX_M2 + c) for c in range(4)]
        accM2_n = [b.aux_next(AUX_M2 + c) for c in range(4)]
        prodM2 = b.ef_mul4(b.ef_sub4(accM2_n, accM2), b.ef_sub4(g_m, code_m2))
        actM2 = b.ef_from_base4(
            b.add(f["mstore8"], b.mul(f_mm, taken))
        )
        for c in range(4):
            b.transition(b.sub(prodM2[c], actM2[c]))
            b.first_row(accM2[c])
        # third tuple: MSTORE's word-1 WRITE at sub-clock +2 — the value
        # is the one-hot splice expression (keep old1's top k bytes, fill
        # the rest with B >> 8k); k = 0 degenerates to plain B
        new1_acc = None
        for k in range(32):
            if k == 0:
                pat = Bblk
            else:
                pat = b.concat_rows([Bblk[8 * k :], Cblk[8 * (32 - k) :]])
            t = b.mul(ohq[k], pat)
            new1_acc = t if new1_acc is None else b.add(new1_acc, t)
        vcode_m3 = b.bit_block_code(new1_acc, chi, b.constant(0), 32)
        inner_m3 = b.ef_add4(b.ef_from_base4(one), vcode_m3)
        code_m3 = b.ef_add4(
            b.ef_from_base4(waddr),
            b.ef_mul4(
                chi,
                b.ef_add4(
                    b.ef_from_base4(b.add(clk4m, b.constant(2))),
                    b.ef_mul4(chi, inner_m3),
                ),
            ),
        )
        accM3 = [b.aux(AUX_M3 + c) for c in range(4)]
        accM3_n = [b.aux_next(AUX_M3 + c) for c in range(4)]
        prodM3 = b.ef_mul4(b.ef_sub4(accM3_n, accM3), b.ef_sub4(g_m, code_m3))
        actM3 = b.ef_from_base4(f_mst)
        for c in range(4):
            b.transition(b.sub(prodM3[c], actM3[c]))
            b.first_row(accM3[c])
        # fourth tuple: unaligned MSTORE's word-2 WRITE at sub-clock +3
        # (B's low 8k bits land in the top, old2's low bits kept)
        new2_acc = None
        for k in range(32):
            if k == 0:
                pat = b.scale(0, Bblk)
            else:
                pat = b.concat_rows([Wblk[: 8 * (32 - k)], Bblk[: 8 * k]])
            t = b.mul(ohq[k], pat)
            new2_acc = t if new2_acc is None else b.add(new2_acc, t)
        vcode_m4 = b.bit_block_code(new2_acc, chi, b.constant(0), 32)
        inner_m4 = b.ef_add4(b.ef_from_base4(one), vcode_m4)
        code_m4 = b.ef_add4(
            b.ef_from_base4(b.add(waddr, one)),
            b.ef_mul4(
                chi,
                b.ef_add4(
                    b.ef_from_base4(b.add(clk4m, b.constant(3))),
                    b.ef_mul4(chi, inner_m4),
                ),
            ),
        )
        accM4 = [b.aux(AUX_M4 + c) for c in range(4)]
        accM4_n = [b.aux_next(AUX_M4 + c) for c in range(4)]
        prodM4 = b.ef_mul4(b.ef_sub4(accM4_n, accM4), b.ef_sub4(g_m, code_m4))
        actM4 = b.ef_from_base4(b.mul(f_mst, taken))
        for c in range(4):
            b.transition(b.sub(prodM4[c], actM4[c]))
            b.first_row(accM4[c])

        # 14f. hash-call channel (one tuple per KECCAK256):
        #   clk + chi*waddr + chi^2*size + sum_j digest_byte_j * chi^{j+3}
        dcode = b.bit_block_code(Cblk, chi, b.constant(0), 32)
        code_k = b.ef_add4(
            b.ef_from_base4(clk),
            b.ef_mul4(
                chi,
                b.ef_add4(
                    b.ef_from_base4(waddr),
                    b.ef_mul4(chi, b.ef_add4(b.ef_from_base4(lB[0]), dcode)),
                ),
            ),
        )
        accK = [b.aux(AUX_K + c) for c in range(4)]
        accK_n = [b.aux_next(AUX_K + c) for c in range(4)]
        prodK = b.ef_mul4(b.ef_sub4(accK_n, accK), b.ef_sub4(g_k, code_k))
        actK = b.ef_from_base4(f_kec)
        for c in range(4):
            b.transition(b.sub(prodK[c], actK[c]))
            b.first_row(accK[c])

        # 14g. storage (SLOAD/SSTORE): witness gating, the EIP-2200
        # sentry, and the storage-journal channel.  cold/g1/g2 are CPU
        # witnesses whose truth the storage table enforces through the
        # tuple code.
        f_stor = b.add(f_sl, f_ss)
        # SCOLD doubles as the address cold flag on CALL / BALANCE /
        # EXTCODESIZE / EXTCODEHASH rows (EIP-2929)
        b.all_rows(
            b.mul(
                scold,
                b.sub(
                    one,
                    b.add(
                        b.add(f_stor, f["call"]),
                        b.add(
                            b.add(f["balance"], f["extcodesize"]),
                            f["extcodehash"],
                        ),
                    ),
                ),
            ),
        )
        b.all_rows(b.mul(sg1, b.sub(one, f_ss)))
        b.all_rows(b.mul(sg2, b.sub(one, f_ss)))
        b.all_rows(b.mul(sg1, sg2))
        # EIP-2200 sentry, wrap-safe (G spans up to 2^32 > p): either some
        # G bit >= 12 is set (taken, via the nonzero gadget), or the low
        # 12 bits are >= 2301 (12-bit witness; the difference range then
        # stays within +-2^12 << p, so no modular wrap is possible)
        sent12 = reg_val(MULC0, 12, False)
        g_low12 = gas_expr(False, range(12), 0)
        b.all_rows(
            b.mul(
                b.mul(f_ss, b.sub(one, taken)),
                b.sub(g_low12, b.add(sent12, b.constant(2301))),
            )
        )
        slotcode = b.bit_block_code(Ablk, chi, b.constant(0), 32)
        v_st = b.add(Cblk, b.mul(f_ss, b.sub(Bblk, Cblk)))
        vcode_st = b.bit_block_code(v_st, chi, b.constant(0), 32)
        chi4p = b.ef_mul4(chi2, chi2)
        chi8p = b.ef_mul4(chi4p, chi4p)
        chi16p = b.ef_mul4(chi8p, chi8p)
        chi32p = b.ef_mul4(chi16p, chi16p)
        chi36p = b.ef_mul4(chi32p, chi4p)
        chi3p = b.ef_mul4(chi2, chi)
        clk4st = b.scale(4, clk)
        code_st = b.ef_from_base4(clk4st)
        code_st = b.ef_add4(code_st, [b.mul(f_ss, chi[c]) for c in range(4)])
        code_st = b.ef_add4(code_st, [b.mul(scold, chi2[c]) for c in range(4)])
        code_st = b.ef_add4(code_st, [b.mul(sg1, chi3p[c]) for c in range(4)])
        code_st = b.ef_add4(code_st, [b.mul(sg2, chi4p[c]) for c in range(4)])
        code_st = b.ef_add4(code_st, b.ef_mul4(chi4p, slotcode))
        code_st = b.ef_add4(code_st, b.ef_mul4(chi36p, vcode_st))
        accST = [b.aux(AUX_ST + c) for c in range(4)]
        accST_n = [b.aux_next(AUX_ST + c) for c in range(4)]
        prodST = b.ef_mul4(b.ef_sub4(accST_n, accST), b.ef_sub4(g_st, code_st))
        actST = b.ef_from_base4(f_stor)
        for c in range(4):
            b.transition(b.sub(prodST[c], actST[c]))
            b.first_row(accST[c])

        # 14h. signed-arithmetic channel: SDIV/SMOD send
        #   kind + sum_j a_j chi^{1+j} + b_j chi^{33+j} + c_j chi^{65+j}
        # to ArithAir (evm_arith.py), which proves the signed semantics.
        g_ar = b.ef_sub4(b.challenge_ef(CHAL_AR), fid_shift)
        f_sdv, f_smd = f["sdiv"], f["smod"]
        kind_expr = b.add(
            b.add(f_sdv, b.scale(2, f_smd)), b.scale(3, f_exp)
        )
        chi8c = b.ef_mul4(b.ef_mul4(chi2, chi2), b.ef_mul4(chi2, chi2))
        chi16c = b.ef_mul4(chi8c, chi8c)
        chi32c = b.ef_mul4(chi16c, chi16c)
        chi64c = b.ef_mul4(chi32c, chi32c)
        code_ar = b.bit_block_code(Ablk, chi, kind_expr, 32)
        code_ar = b.ef_add4(
            code_ar,
            b.ef_mul4(chi32c, b.bit_block_code(Bblk, chi, b.constant(0), 32)),
        )
        code_ar = b.ef_add4(
            code_ar,
            b.ef_mul4(chi64c, b.bit_block_code(Cblk, chi, b.constant(0), 32)),
        )
        accAR = [b.aux(AUX_AR + c) for c in range(4)]
        accAR_n = [b.aux_next(AUX_AR + c) for c in range(4)]
        prodAR = b.ef_mul4(b.ef_sub4(accAR_n, accAR), b.ef_sub4(g_ar, code_ar))
        actAR = b.ef_from_base4(b.add(b.add(f_sdv, f_smd), f_exp))
        for c in range(4):
            b.transition(b.sub(prodAR[c], actAR[c]))
            b.first_row(accAR[c])

        # 14i. copies: word-multiple size (slack = 0), 15-bit source
        # offset, the copy-call channel send (kind 0 = calldata, 1 =
        # code), and RETURNDATACOPY's size == 0 pin (covered frames have
        # empty returndata)
        f_cdcc = b.add(f["calldatacopy"], f["codecopy"])
        w_hi15 = b.local_block(range(W0 + 15, W0 + 256))
        b.all_rows_block(b.mul(f_cdcc, w_hi15), 241)
        b.all_rows_block(b.mul(f["returndatacopy"], Bblk), 256)
        b.all_rows_block(b.mul(f["returndatacopy"], Wblk), 256)
        g_cp = b.ef_sub4(b.challenge_ef(CHAL_CP), fid_shift)
        offv = None
        for bit in range(15):
            t = b.scale(1 << bit, b.local(W0 + bit))
            offv = t if offv is None else b.add(offv, t)
        chi3cp = b.ef_mul4(chi2, chi)
        chi4cp = b.ef_mul4(chi2, chi2)
        code_cp = b.ef_add4(
            b.ef_from_base4(clk),
            b.ef_add4(
                b.ef_add4(
                    b.ef_mul4(chi, b.ef_from_base4(waddr)),
                    b.ef_mul4(chi2, b.ef_from_base4(offv)),
                ),
                b.ef_add4(
                    b.ef_add4(
                        b.ef_mul4(chi3cp, b.ef_from_base4(swval)),
                        [b.mul(f["codecopy"], chi4cp[c]) for c in range(4)],
                    ),
                    b.ef_mul4(
                        b.ef_mul4(chi4cp, chi),
                        b.ef_from_base4(slval),
                    ),
                ),
            ),
        )
        accCP = [b.aux(AUX_CP + c) for c in range(4)]
        accCP_n = [b.aux_next(AUX_CP + c) for c in range(4)]
        prodCP = b.ef_mul4(b.ef_sub4(accCP_n, accCP), b.ef_sub4(g_cp, code_cp))
        actCP = b.ef_from_base4(f_cdcc)
        for c in range(4):
            b.transition(b.sub(prodCP[c], actCP[c]))
            b.first_row(accCP[c])

        # 15. fetch channel (receive one instruction tuple per live row)
        imm_bits = b.mul(f["push"], Cblk)
        imm_code = b.bit_block_code(imm_bits, chi, b.constant(0), 32)
        code_f = b.ef_add4(
            b.ef_from_base4(pc),
            b.ef_add4(
                [b.mul(op, chi[c]) for c in range(4)],
                b.ef_mul4(chi2, imm_code),
            ),
        )
        accF = [b.aux(AUX_F + c) for c in range(4)]
        accF_n = [b.aux_next(AUX_F + c) for c in range(4)]
        prod = b.ef_mul4(b.ef_sub4(accF_n, accF), b.ef_sub4(g_f, code_f))
        live = b.ef_from_base4(b.sub(one, halted))
        for c in range(4):
            b.transition(b.add(prod[c], live[c]))
            b.first_row(accF[c])

        # 16. stack channel (up to four access tuples per row)
        p21 = fsum(_POP2PUSH1)
        env_f = fsum(ENV_OPS)
        f_cdc = b.add(
            f["calldatacopy"], b.add(f["codecopy"], f["returndatacopy"])
        )
        f_cl = f["call"]
        f_cr = f["callret"]
        f_anycall = b.add(f_cl, f_cr)
        # account-state family: pop-1-push-1 (selfbalance pushes only)
        f_acp = b.add(
            b.add(f["balance"], f["extcodesize"]),
            b.add(f["extcodehash"], f["blockhash"]),
        )
        f_sb = f["selfbalance"]
        # logext: slot s reads topic s+1 iff fam_n - 1 > s (fam bits)
        fb0 = b.local(FAMB0)
        fb1 = b.local(FAMB0 + 1)
        fb2 = b.local(FAMB0 + 2)
        lg_ind = [
            b.sub(b.add(b.add(fb0, fb1), fb2), b.mul(fb0, fb1)),
            b.add(fb1, fb2),
            b.add(b.mul(fb0, fb1), fb2),
            fb2,
        ]
        f_lgx = f["logext"]
        # 6-arg call variants shift every call-pair stack offset by one
        k6_loc = b.add(kdel_l, ksta_l)
        f_cre = f["create"]
        f_crr = f["createret"]
        pops_w0 = b.add(
            b.add(
                b.scale(2, p21),
                b.add(
                    b.add(f["iszero"], f["not"]),
                    b.add(f["swap"], b.add(f_cdl, b.add(f_mld, f_sl))),
                ),
            ),
            b.add(
                b.add(
                    b.add(
                        b.scale(3, f_cdc),
                        # call reads argsSize @sp-5 (-4 on 6-arg);
                        # callret retSize @sp-7 (-6 on 6-arg)
                        b.sub(
                            b.add(b.scale(5, f_cl), b.scale(7, f_cr)),
                            b.mul(f_anycall, k6_loc),
                        ),
                    ),
                    f_acp,
                ),
                b.add(
                    b.scale(3, f_lgx),  # logext slot2: topic 3 at sp-3
                    # CREATE2 slot2: the salt at sp-4
                    b.scale(4, b.mul(f_cre, kc2_l)),
                ),
            ),
        )
        actives = [
            b.add(
                p21,
                b.add(
                    b.add(b.add(f["iszero"], f["not"]), b.add(f["pop"], f["jump"])),
                    b.add(
                        b.add(b.add(f["jumpi"], f["dup"]), b.add(f["swap"], f_cdl)),
                        b.add(
                            b.add(
                                b.add(f_mld, f_mst),
                                b.add(f["mstore8"], b.add(f_sl, f_ss)),
                            ),
                            b.add(
                                b.add(b.add(f_ret, f_log), b.add(f_cdc, f_cre)),
                                b.add(
                                    # 6-arg callret rows have no value
                                    # pop: slot 0 goes inactive
                                    b.sub(f_anycall, b.mul(f_cr, k6_loc)),
                                    b.add(f_acp, b.mul(f_lgx, lg_ind[0])),
                                ),
                            ),
                        ),
                    ),
                ),
            ),
            b.add(
                p21,
                b.add(
                    b.add(f["jumpi"], b.add(f["swap"], f["mstore8"])),
                    b.add(
                        b.add(f_mst, f_ss),
                        b.add(
                            b.add(b.add(f_ret, f_log), b.add(f_cdc, f_cre)),
                            b.add(f_anycall, b.mul(f_lgx, lg_ind[1])),
                        ),
                    ),
                ),
            ),
            b.add(
                p21,
                b.add(
                    b.add(b.add(f["iszero"], f["not"]), b.add(f["push0"], f["push"])),
                    b.add(
                        b.add(f["dup"], f["swap"]),
                        b.add(
                            b.add(f["pc"], f["gas"]),
                            b.add(
                                b.add(
                                    env_f,
                                    b.add(
                                        f_cdc,
                                        b.add(f_anycall, b.add(f_acp, f_sb)),
                                    ),
                                ),
                                b.add(
                                    b.add(
                                        f_cdl,
                                        b.add(b.add(f_mld, f_msz), f_sl),
                                    ),
                                    b.mul(f_lgx, lg_ind[2]),
                                ),
                            ),
                        ),
                    ),
                ),
            ),
            b.add(
                b.add(b.add(f["swap"], f_anycall), b.add(f_cre, f_crr)),
                b.mul(f_lgx, lg_ind[3]),
            ),
        ]
        # slot-2 activity: add the CREATE2 salt read
        actives[2] = b.add(actives[2], b.mul(f_cre, kc2_l))
        fam_m1 = b.sub(fam_n, one)
        addrs = [
            # call row: argsOff at sp-4 (sp-3 on 6-arg); callret row:
            # value at sp-3 (slot inactive on 6-arg); create row: the
            # initcode offset at sp-2
            b.sub(
                b.sub(b.sub(sp, one), b.mul(f["dup"], fam_m1)),
                b.add(
                    b.sub(
                        b.add(b.scale(3, f_cl), b.scale(2, f_cr)),
                        b.mul(f_cl, k6_loc),
                    ),
                    f_cre,
                ),
            ),
            # call row: addr at sp-2 (default); callret: retOff at sp-6
            # (sp-5 on 6-arg); create row: the initcode size at sp-3
            b.sub(
                b.sub(b.sub(sp, b.constant(2)), b.mul(f["swap"], fam_m1)),
                b.add(
                    b.sub(b.scale(4, f_cr), b.mul(f_cr, k6_loc)), f_cre
                ),
            ),
            b.sub(sp, pops_w0),
            # call row: gas at sp-1 (default); callret: success at sp-7
            # (sp-6 on 6-arg); logext: topic 4 at sp-4; create row: the
            # value at sp-1 (default); createret: address push at
            # sp-3 (sp-4 on CREATE2)
            b.sub(
                b.sub(b.sub(sp, one), b.mul(f["swap"], fam_n)),
                b.add(
                    b.sub(
                        b.add(b.scale(6, f_cr), b.scale(3, f_lgx)),
                        b.mul(f_cr, k6_loc),
                    ),
                    b.add(b.scale(2, f_crr), b.mul(f_crr, kc2_l)),
                ),
            ),
        ]
        w0_bits = b.add(
            Cblk,
            b.mul(b.add(f["swap"], f_cdc), b.sub(Bblk, Cblk)),
        )
        slot1_bits = b.add(Bblk, b.mul(f_cdc, b.sub(Wblk, Bblk)))
        slot3_bits = b.add(
            b.add(
                Ablk,
                b.mul(
                    b.add(b.add(f_anycall, f_lgx), f_cre),
                    b.sub(Wblk, Ablk),
                ),
            ),
            # createret pushes the new address (the row's B word)
            b.mul(f_crr, b.sub(Bblk, Ablk)),
        )
        vblks = [Ablk, slot1_bits, w0_bits, slot3_bits]
        acc_sum = None
        for s in range(4):
            vcode = b.bit_block_code(vblks[s], chi, b.constant(0), 32)
            iw_s = b.constant(1 if s >= 2 else 0)
            if s == 2:
                # third-pop READS: copies, call/callret sizes, topic 3,
                # CREATE2's salt
                iw_s = b.sub(
                    iw_s, b.add(b.add(f_cdc, f_anycall), b.add(f_lgx, f_cre))
                )
            if s == 3:
                # call row's gas pop, logext's topic 4, and the create
                # row's value pop are READS
                iw_s = b.sub(iw_s, b.add(b.add(f_cl, f_lgx), f_cre))
            inner = b.ef_add4(b.ef_from_base4(iw_s), vcode)
            clk4 = b.add(b.scale(4, clk), b.constant(s))
            code = b.ef_add4(
                b.ef_from_base4(addrs[s]),
                b.ef_mul4(
                    chi, b.ef_add4(b.ef_from_base4(clk4), b.ef_mul4(chi, inner))
                ),
            )
            acc = [b.aux(AUX_SLOT0 + 4 * s + c) for c in range(4)]
            acc_n = [b.aux_next(AUX_SLOT0 + 4 * s + c) for c in range(4)]
            prod = b.ef_mul4(b.ef_sub4(acc_n, acc), b.ef_sub4(g_s, code))
            act4 = b.ef_from_base4(actives[s])
            for c in range(4):
                b.transition(b.sub(prod[c], act4[c]))
                b.first_row(acc[c])
            acc_sum = acc if acc_sum is None else b.ef_add4(acc_sum, acc)

        # 16a. calldata channel (send in-bounds loads)
        code_cd = b.bit_block_code(Cblk, chi, lA[0], 32)
        accC = [b.aux(AUX_CD + c) for c in range(4)]
        accC_n = [b.aux_next(AUX_CD + c) for c in range(4)]
        prodC = b.ef_mul4(b.ef_sub4(accC_n, accC), b.ef_sub4(g_c, code_cd))
        act_cd = b.ef_from_base4(b.mul(f_cdl, carries[15]))
        for c in range(4):
            b.transition(b.sub(prodC[c], act_cd[c]))
            b.first_row(accC[c])

        # 16b. call composition (docs/EVM_COMPOSITION.md): the two-row
        # CALL shape, the 63/64 forwarding gadget, and the cross-frame
        # CALLREQ/CALLRET/bridge/address channels
        g_cq = b.challenge_ef(CHAL_CQ)
        g_cr = b.challenge_ef(CHAL_CR)
        g_br = b.challenge_ef(CHAL_BR)
        g_ad = b.ef_sub4(b.challenge_ef(CHAL_AD), fid_shift)
        # chi power ladder chi^0..chi^67 (CALLREQ ends at 41, the log
        # record's topic limbs at 67)
        chip = [b.ef_from_base4(one), list(chi)]
        for _ in range(66):
            chip.append(b.ef_mul4(chip[-1], chi))

        def lincode(base_expr, terms):
            acc4 = b.ef_from_base4(base_expr)
            for ex, e in terms:
                acc4 = b.ef_add4(acc4, [b.mul(ex, chip[e][c]) for c in range(4)])
            return acc4

        f_cr_n = b.next(FLAG0 + FLAG_IDX["callret"])
        # pairing: a row is followed by a callret row iff it is a call row
        b.transition(b.sub(f_cr_n, f_cl))
        b.first_row(f["callret"])
        # ... and by a createret row iff it is a create row
        f_crr_n = b.next(FLAG0 + FLAG_IDX["createret"])
        b.transition(b.sub(f_crr_n, f_cre))
        b.first_row(f_crr)
        # create-pair bindings: the createret row's A word re-reads the
        # create row's popped VALUE (W), and the pushed address word (B)
        # fits 160 bits
        an_blk_cre = b.next_block(range(A0, A0 + 256))
        b.transition_block(b.mul(f_cre, b.sub(an_blk_cre, Wblk)), 256)
        bn_hi160 = b.next_block(range(B0 + 160, B0 + 256))
        b.transition_block(b.mul(f_cre, bn_hi160), 96)
        # all-but-1/64 forwarding: avail = the createret row's gas
        # register; the child gets EXACTLY the cap (no gas argument, no
        # stipend)
        q_cre = None
        for i in range(22):
            tv = b.scale(1 << i, b.next(SCRATCH0 + RW_Q0 + i))
            q_cre = tv if q_cre is None else b.add(q_cre, tv)
        r_cre = None
        for i in range(6):
            tv = b.scale(1 << i, b.next(SCRATCH0 + RW_R0 + i))
            r_cre = tv if r_cre is None else b.add(r_cre, tv)
        gasin_cre = None
        for i in range(28):
            tv = b.scale(1 << i, b.next(SCRATCH0 + RW_GASIN0 + i))
            gasin_cre = tv if gasin_cre is None else b.add(gasin_cre, tv)
        b.transition(
            b.mul(f_cre, b.sub(G_n, b.add(b.scale(64, q_cre), r_cre)))
        )
        b.transition(
            b.mul(
                f_cre, b.sub(gasin_cre, b.add(b.scale(63, q_cre), r_cre))
            )
        )
        # ... and by a logext row iff it is a log row, with the family
        # bits mirrored so the topic count carries over
        f_lg = f["log"]
        f_le = f["logext"]
        f_le_n = b.next(FLAG0 + FLAG_IDX["logext"])
        b.transition(b.sub(f_le_n, f_lg))
        b.first_row(f_le)
        for fb in range(5):
            b.transition(
                b.mul(f_lg, b.sub(b.next(FAMB0 + fb), b.local(FAMB0 + fb)))
            )
        # --- call-row ranges: argsSize aligned, < 2^15, word count bound
        c_hi = b.local_block(range(C0 + 15, C0 + 256))
        b.all_rows_block(b.mul(f_cl, c_hi), 241)
        c_lo5 = b.local_block(range(C0, C0 + 5))
        b.all_rows_block(b.mul(f_cl, c_lo5), 5)
        c_val15 = None
        for i in range(15):
            tv = b.scale(1 << i, b.local(C0 + i))
            c_val15 = tv if c_val15 is None else b.add(c_val15, tv)
        b.all_rows(b.mul(f_cl, b.sub(b.scale(32, swval), c_val15)))
        b.all_rows(b.mul(f_cl, slval))
        # --- callret-row ranges (via call-row transitions): retSize and
        # retOff aligned and bounded, the value word pinned to zero, the
        # success push pinned to one
        cn_hi = b.next_block(range(C0 + 15, C0 + 256))
        b.transition_block(b.mul(f_cl, cn_hi), 241)
        cn_lo5 = b.next_block(range(C0, C0 + 5))
        b.transition_block(b.mul(f_cl, cn_lo5), 5)
        bn_hi = b.next_block(range(B0 + 18, B0 + 256))
        b.transition_block(b.mul(f_cl, bn_hi), 238)
        bn_lo5 = b.next_block(range(B0, B0 + 5))
        b.transition_block(b.mul(f_cl, bn_lo5), 5)
        # the callret row's A word holds the popped value on a 7-arg
        # CALL; 6-arg variants pin it to zero (DELEGATECALL's forwarded
        # callvalue enters the CALLREQ tuple from the publics instead)
        k6_n = b.add(b.next(KDEL), b.next(KSTA))
        an_blk = b.next_block(range(A0, A0 + 256))
        b.transition_block(b.mul(b.mul(f_cl, k6_n), an_blk), 256)
        wn_rest = b.next_block(range(W0 + 1, W0 + 256))
        b.transition_block(b.mul(f_cl, wn_rest), 255)
        # success bit: bound to the callee's CALLRET tuple (not pinned);
        # a VALUE-bearing call must succeed (reverted value calls roll
        # the transfer back and stay uncovered)
        b.all_rows(b.mul(b.mul(f_cr, taken), b.sub(one, b.local(W0))))
        cn_val15 = None
        for i in range(15):
            tv = b.scale(1 << i, b.next(C0 + i))
            cn_val15 = tv if cn_val15 is None else b.add(cn_val15, tv)
        swval_n = None
        for i in range(10):
            tv = b.scale(1 << i, b.next(KSW0 + i))
            swval_n = tv if swval_n is None else b.add(swval_n, tv)
        slval_n = None
        for i in range(5):
            tv = b.scale(1 << i, b.next(KSL0 + i))
            slval_n = tv if slval_n is None else b.add(slval_n, tv)
        b.transition(b.mul(f_cl, b.sub(b.scale(32, swval_n), cn_val15)))
        b.transition(b.mul(f_cl, slval_n))
        # --- [retSize != 0] witness and the expansion max gadget
        tr_w = b.local(SCRATCH0 + CW_TR)
        invr_w = b.local(CC_INVR)
        cn_pop = None
        for i in range(15):
            tv = b.next(C0 + i)
            cn_pop = tv if cn_pop is None else b.add(cn_pop, tv)
        b.transition(b.mul(f_cl, b.sub(tr_w, b.mul(cn_pop, invr_w))))
        b.transition(b.mul(b.mul(f_cl, cn_pop), b.sub(one, tr_w)))
        waddr_bn = None
        for bit in range(5, 18):
            tv = b.scale(1 << (bit - 5), b.next(B0 + bit))
            waddr_bn = tv if waddr_bn is None else b.add(waddr_bn, tv)
        argneed_w = b.local(CC_ARGNEED)
        retneed_w = b.local(CC_RETNEED)
        b.all_rows(
            b.mul(f_cl, b.sub(argneed_w, b.mul(taken, b.add(waddr, swval))))
        )
        b.transition(
            b.mul(
                f_cl,
                b.sub(retneed_w, b.mul(tr_w, b.add(waddr_bn, swval_n))),
            )
        )
        mm_w = b.local(SCRATCH0 + CW_MM)
        dmax_w = scratch_val(CW_DMAX0, 14)
        b.all_rows(
            b.mul(
                b.mul(f_cl, mm_w), b.sub(b.sub(argneed_w, retneed_w), dmax_w)
            )
        )
        b.all_rows(
            b.mul(
                b.mul(f_cl, b.sub(one, mm_w)),
                b.sub(b.sub(retneed_w, argneed_w), dmax_w),
            )
        )
        b.all_rows(
            b.mul(
                f_cl,
                b.sub(
                    b.sub(kneed, retneed_w),
                    b.mul(mm_w, b.sub(argneed_w, retneed_w)),
                ),
            )
        )
        # --- 63/64 forwarding (EIP-150): avail = the callret row's gas
        bigreq_w = b.local(SCRATCH0 + CW_BIGREQ)
        invh_w = b.local(CC_INVH)
        h_req = b.linmap(
            [[1] * (256 - MAX_GAS_LOG)],
            b.local_block(range(W0 + MAX_GAS_LOG, W0 + 256)),
        )[0]
        b.all_rows(b.mul(f_cl, b.sub(bigreq_w, b.mul(h_req, invh_w))))
        b.all_rows(b.mul(b.mul(f_cl, h_req), b.sub(one, bigreq_w)))
        reqlo = None
        for i in range(MAX_GAS_LOG):
            tv = b.scale(1 << i, b.local(W0 + i))
            reqlo = tv if reqlo is None else b.add(reqlo, tv)
        q_n = scratch_val(RW_Q0, 22, True)
        r_n = scratch_val(RW_R0, 6, True)
        m_n = b.next(SCRATCH0 + RW_M)
        d_n = scratch_val(RW_D0, 30, True)
        gasin_n = scratch_val(RW_GASIN0, 28, True)
        gasret_n = scratch_val(RW_GASRET0, 28, True)
        rds_n = scratch_val(RW_RDS0, 13, True)
        rdiff_n = scratch_val(RW_RDIFF0, 13, True)
        cap = b.add(b.scale(63, q_n), r_n)
        b.transition(
            b.mul(f_cl, b.sub(G_n, b.add(b.scale(64, q_n), r_n)))
        )
        # r < 64 is structural (6 bits); big requests force the cap
        b.transition(b.mul(b.mul(f_cl, bigreq_w), b.sub(one, m_n)))
        b.transition(
            b.mul(
                b.mul(f_cl, m_n),
                b.sub(
                    b.add(reqlo, b.scale(1 << MAX_GAS_LOG, bigreq_w)),
                    b.add(cap, d_n),
                ),
            )
        )
        b.transition(
            b.mul(
                b.mul(f_cl, b.sub(one, m_n)),
                b.sub(cap, b.add(reqlo, d_n)),
            )
        )
        # forwarded gas = min(req, cap) + the 2300 stipend on value calls
        b.transition(
            b.mul(
                f_cl,
                b.sub(
                    b.sub(
                        b.sub(gasin_n, b.scale(2300, b.next(TAKEN))), reqlo
                    ),
                    b.mul(m_n, b.sub(cap, reqlo)),
                ),
            )
        )
        # retSize <= rds when data is copied back
        b.transition(
            b.mul(
                b.mul(f_cl, tr_w),
                b.sub(rds_n, b.add(cn_val15, rdiff_n)),
            )
        )
        # --- CALLREQ sends (+1 per call row; tuple mixes call-row values
        # with the callret row's forwarding witnesses)
        lA_n = b.linmap(_LIMB_MAT, b.next_block(range(A0, A0 + 256)))
        gasin_lo_n = scratch_val(RW_GASIN0, 16, True)
        gasin_hi_n = None
        for i in range(16, 28):
            tv = b.scale(1 << (i - 16), b.next(SCRATCH0 + RW_GASIN0 + i))
            gasin_hi_n = tv if gasin_hi_n is None else b.add(gasin_hi_n, tv)
        gasret_lo_n = scratch_val(RW_GASRET0, 16, True)
        gasret_hi_n = None
        for i in range(16, 28):
            tv = b.scale(1 << (i - 16), b.next(SCRATCH0 + RW_GASRET0 + i))
            gasret_hi_n = tv if gasret_hi_n is None else b.add(gasret_hi_n, tv)
        cfid_w = scratch_val(CW_CFID0, 16)
        caller_pub = [
            b.public(PUB_ENV0 + 16 * ENV_IDX_ADDRESS + i) for i in range(10)
        ]
        callerenv_pub = [
            b.public(PUB_ENV0 + 16 * ENV_IDX_CALLER + i) for i in range(10)
        ]
        cvown_pub = [
            b.public(PUB_ENV0 + 16 * ENV_IDX_CALLVALUE + i) for i in range(16)
        ]
        # DELEGATECALL keeps the caller's context: the callee's address /
        # callvalue / caller words come from THIS frame's publics; the
        # target address still binds the callee's CODE (exps 43-52)
        static_child = b.sub(
            b.add(static_pub, ksta_l), b.mul(static_pub, ksta_l)
        )
        code_cq = lincode(
            fid_pub,
            [(clk, 1), (gasin_lo_n, 2), (gasin_hi_n, 3)]
            + [
                (
                    b.add(lB[i], b.mul(kdel_l, b.sub(caller_pub[i], lB[i]))),
                    4 + i,
                )
                for i in range(10)
            ]
            + [
                (b.add(lA_n[i], b.mul(kdel_l, cvown_pub[i])), 14 + i)
                for i in range(16)
            ]
            + [(c_val15, 30)]
            + [
                (
                    b.add(
                        caller_pub[i],
                        b.mul(kdel_l, b.sub(callerenv_pub[i], caller_pub[i])),
                    ),
                    31 + i,
                )
                for i in range(10)
            ]
            + [(cfid_w, 41), (static_child, 42)]
            + [(lB[i], 43 + i) for i in range(10)],
        )
        accCQ = [b.aux(AUX_CQ + c) for c in range(4)]
        accCQ_n = [b.aux_next(AUX_CQ + c) for c in range(4)]
        prodCQ = b.ef_mul4(b.ef_sub4(accCQ_n, accCQ), b.ef_sub4(g_cq, code_cq))
        fcl4 = b.ef_from_base4(f_cl)
        for c in range(4):
            b.transition(b.sub(prodCQ[c], fcl4[c]))
            b.first_row(accCQ[c])
        # --- CALLRET receives (-1 per call row); exp 4 carries the
        # callee's success bit, pushed as the callret row's W word
        code_cr = lincode(
            fid_pub,
            [
                (clk, 1),
                (gasret_lo_n, 2),
                (gasret_hi_n, 3),
                (b.next(W0), 4),
                (rds_n, 5),
            ],
        )
        accCR = [b.aux(AUX_CR + c) for c in range(4)]
        accCR_n = [b.aux_next(AUX_CR + c) for c in range(4)]
        prodCR = b.ef_mul4(b.ef_sub4(accCR_n, accCR), b.ef_sub4(g_cr, code_cr))
        for c in range(4):
            b.transition(b.add(prodCR[c], fcl4[c]))
            b.first_row(accCR[c])
        # --- CREATE composition: its own CALLREQ send / CALLRET receive
        # (the tuple differs from CALL's in the address/value/cds terms;
        # flag-selected sharing would blow the degree budget).  The new
        # address (B_next) doubles as the callee's env address AND its
        # code address; cds is zero; success is pinned to one (reverting
        # initcode is uncovered).
        lB_n16 = b.linmap(_LIMB_MAT, b.next_block(range(B0, B0 + 256)))
        code_cq2 = lincode(
            fid_pub,
            [(clk, 1), (gasin_lo_n, 2), (gasin_hi_n, 3)]
            + [(lB_n16[i], 4 + i) for i in range(10)]
            + [(lA_n[i], 14 + i) for i in range(16)]
            + [(caller_pub[i], 31 + i) for i in range(10)]
            + [(cfid_w, 41), (static_pub, 42)]
            + [(lB_n16[i], 43 + i) for i in range(10)],
        )
        accCQ2 = [b.aux(AUX_CQ2 + c) for c in range(4)]
        accCQ2_n = [b.aux_next(AUX_CQ2 + c) for c in range(4)]
        prodCQ2 = b.ef_mul4(
            b.ef_sub4(accCQ2_n, accCQ2), b.ef_sub4(g_cq, code_cq2)
        )
        fcre4 = b.ef_from_base4(f_cre)
        for c in range(4):
            b.transition(b.sub(prodCQ2[c], fcre4[c]))
            b.first_row(accCQ2[c])
        code_cr2 = lincode(
            fid_pub,
            [
                (clk, 1),
                (gasret_lo_n, 2),
                (gasret_hi_n, 3),
                (one, 4),
                (rds_n, 5),
            ],
        )
        accCR2 = [b.aux(AUX_CR2 + c) for c in range(4)]
        accCR2_n = [b.aux_next(AUX_CR2 + c) for c in range(4)]
        prodCR2 = b.ef_mul4(
            b.ef_sub4(accCR2_n, accCR2), b.ef_sub4(g_cr, code_cr2)
        )
        for c in range(4):
            b.transition(b.add(prodCR2[c], fcre4[c]))
            b.first_row(accCR2[c])
        # initcode-bridge instancing (kind 4): the caller-memory span the
        # child's public CODE must equal, sent when size != 0
        code_bri = lincode(
            fid_pub,
            [
                (b.add(b.scale(4, clk), one), 1),
                (b.constant(4), 2),
                (waddr, 3),
                (swval, 4),
                (cfid_w, 5),
            ],
        )
        accBRI = [b.aux(AUX_BRI + c) for c in range(4)]
        accBRI_n = [b.aux_next(AUX_BRI + c) for c in range(4)]
        prodBRI = b.ef_mul4(
            b.ef_sub4(accBRI_n, accBRI), b.ef_sub4(g_br, code_bri)
        )
        act_bri = b.ef_from_base4(b.mul(f_cre, taken))
        for c in range(4):
            b.transition(b.sub(prodBRI[c], act_bri[c]))
            b.first_row(accBRI[c])
        # --- bridge instancing sends: args (kind 0), ret-write (kind 1)
        # on call rows; the callee's ret-read (kind 2) on its RETURN row
        # one accumulator carries BOTH the args-bridge tuples (call rows,
        # kind 0) and the log-data-bridge tuples (log rows, kind 3): the
        # rows are disjoint, so the kind term is just 3*f_log*chi^2, and
        # cfid_w is zero on log rows (no call witness bits set)
        code_bra = lincode(
            fid_pub,
            [
                (b.add(b.scale(4, clk), one), 1),
                (b.scale(3, f_lg), 2),
                (waddr, 3),
                (swval, 4),
                (cfid_w, 5),
            ],
        )
        accBRA = [b.aux(AUX_BRA + c) for c in range(4)]
        accBRA_n = [b.aux_next(AUX_BRA + c) for c in range(4)]
        prodBRA = b.ef_mul4(
            b.ef_sub4(accBRA_n, accBRA), b.ef_sub4(g_br, code_bra)
        )
        act_bra = b.ef_from_base4(b.mul(b.add(f_cl, f_lg), taken))
        for c in range(4):
            b.transition(b.sub(prodBRA[c], act_bra[c]))
            b.first_row(accBRA[c])
        code_brw = lincode(
            fid_pub,
            [
                (b.add(b.scale(4, clk), b.constant(5)), 1),
                (one, 2),
                (waddr_bn, 3),
                (swval_n, 4),
                (cfid_w, 5),
            ],
        )
        accBRW = [b.aux(AUX_BRW + c) for c in range(4)]
        accBRW_n = [b.aux_next(AUX_BRW + c) for c in range(4)]
        prodBRW = b.ef_mul4(
            b.ef_sub4(accBRW_n, accBRW), b.ef_sub4(g_br, code_brw)
        )
        act_brw = b.ef_from_base4(b.mul(f_cl, tr_w))
        for c in range(4):
            b.transition(b.sub(prodBRW[c], act_brw[c]))
            b.first_row(accBRW[c])
        code_brr = lincode(
            fid_pub,
            [
                (b.add(b.scale(4, clk), one), 1),
                (b.constant(2), 2),
                (waddr, 3),
                (swval, 4),
            ],
        )
        accBRR = [b.aux(AUX_BRR + c) for c in range(4)]
        accBRR_n = [b.aux_next(AUX_BRR + c) for c in range(4)]
        prodBRR = b.ef_mul4(
            b.ef_sub4(accBRR_n, accBRR), b.ef_sub4(g_br, code_brr)
        )
        act_brr = b.ef_from_base4(
            b.mul(f_ret, b.public(PUB_HASRET))
        )
        for c in range(4):
            b.transition(b.sub(prodBRR[c], act_brr[c]))
            b.first_row(accBRR[c])
        # --- address-journal sends (per-frame channel, fid-shifted):
        # CALL rows key by the B word, account-state rows by the A word
        adr_limbs = [
            b.add(lB[i], b.mul(f_acctaddr, b.sub(lA[i], lB[i])))
            for i in range(10)
        ]
        code_ad = lincode(
            b.scale(4, clk),
            [(scold, 1)] + [(adr_limbs[i], 2 + i) for i in range(10)],
        )
        accAD = [b.aux(AUX_ADR + c) for c in range(4)]
        accAD_n = [b.aux_next(AUX_ADR + c) for c in range(4)]
        prodAD = b.ef_mul4(b.ef_sub4(accAD_n, accAD), b.ef_sub4(g_ad, code_ad))
        actAD = b.ef_from_base4(b.add(f_cl, f_acctaddr))
        for c in range(4):
            b.transition(b.sub(prodAD[c], actAD[c]))
            b.first_row(accAD[c])
        # --- account-context sends (balance/codesize/codehash/blockhash
        # + SELFBALANCE keying its OWN address publics); values are the
        # pushed C word, bound against the PUBLIC AcctCtxAir rows
        g_ac = b.ef_sub4(b.challenge_ef(CHAL_AC), fid_shift)
        # balance/selfbalance reads moved to the balance journal (round
        # 5); the context table keeps codesize/codehash/blockhash
        kind_ac = b.add(
            b.scale(2, f["extcodesize"]),
            b.add(
                b.scale(3, f["extcodehash"]), b.scale(4, f["blockhash"])
            ),
        )
        self_pub = [
            b.public(PUB_ENV0 + 16 * ENV_IDX_ADDRESS + i) for i in range(10)
        ]
        ac_keys = [
            b.add(lA[i], b.mul(f_sb, b.sub(self_pub[i], lA[i])))
            for i in range(10)
        ]
        vcode_ac = b.bit_block_code(Cblk, chi, b.constant(0), 32)
        code_ac = lincode(
            kind_ac, [(ac_keys[i], 1 + i) for i in range(10)]
        )
        code_ac = b.ef_add4(code_ac, b.ef_mul4(chip[10], vcode_ac))
        # BLOCKHASH keys must stay below 2^160
        a_hi160 = b.local_block(range(A0 + 160, A0 + 256))
        b.all_rows_block(b.mul(f["blockhash"], a_hi160), 96)
        accAC = [b.aux(AUX_AC + c) for c in range(4)]
        accAC_n = [b.aux_next(AUX_AC + c) for c in range(4)]
        prodAC = b.ef_mul4(b.ef_sub4(accAC_n, accAC), b.ef_sub4(g_ac, code_ac))
        actAC = b.ef_from_base4(b.sub(f_acp, f["balance"]))
        for c in range(4):
            b.transition(b.sub(prodAC[c], actAC[c]))
            b.first_row(accAC[c])
        # --- balance-journal sends (round 5, BUS_BL, unshifted gamma —
        # the frame id rides inside the tuple): READ on balance /
        # selfbalance rows (value = the pushed C word), DEBIT/CREDIT on
        # value-bearing call rows (value = the callret row's A word)
        g_bl = b.challenge_ef(CHAL_BL)
        # value bytes land at chi^{13+j}; bit_block_code emits byte j at
        # chi^{j+1}, so the block multiplier is chi^12
        chi12p = b.ef_mul4(chi8p, chi4p)
        code_blr = lincode(
            fid_pub,
            [(b.scale(4, clk), 1), (one, 2)]
            + [(ac_keys[i], 3 + i) for i in range(10)],
        )
        code_blr = b.ef_add4(code_blr, b.ef_mul4(chi12p, vcode_ac))
        accBLR = [b.aux(AUX_BLR + c) for c in range(4)]
        accBLR_n = [b.aux_next(AUX_BLR + c) for c in range(4)]
        prodBLR = b.ef_mul4(
            b.ef_sub4(accBLR_n, accBLR), b.ef_sub4(g_bl, code_blr)
        )
        actBLR = b.ef_from_base4(b.add(f["balance"], f_sb))
        for c in range(4):
            b.transition(b.sub(prodBLR[c], actBLR[c]))
            b.first_row(accBLR[c])
        vcode_an = b.bit_block_code(an_blk, chi, b.constant(0), 32)
        # value transfers: plain CALL and CREATE rows both debit/credit
        act_bl_call = b.ef_from_base4(
            b.mul(b.add(f_cl, f_cre), b.next(TAKEN))
        )
        code_bld = lincode(
            fid_pub,
            [(b.add(b.scale(4, clk), b.constant(2)), 1), (b.constant(2), 2)]
            + [(caller_pub[i], 3 + i) for i in range(10)],
        )
        code_bld = b.ef_add4(code_bld, b.ef_mul4(chi12p, vcode_an))
        accBLD = [b.aux(AUX_BLD + c) for c in range(4)]
        accBLD_n = [b.aux_next(AUX_BLD + c) for c in range(4)]
        prodBLD = b.ef_mul4(
            b.ef_sub4(accBLD_n, accBLD), b.ef_sub4(g_bl, code_bld)
        )
        code_blc = lincode(
            fid_pub,
            [(b.add(b.scale(4, clk), b.constant(3)), 1), (b.constant(3), 2)]
            + [
                # credit key: the call target (local B) — or the NEW
                # address (next-row B) on create rows
                (b.add(lB[i], b.mul(f_cre, b.sub(lB_n16[i], lB[i]))), 3 + i)
                for i in range(10)
            ],
        )
        code_blc = b.ef_add4(code_blc, b.ef_mul4(chi12p, vcode_an))
        accBLC = [b.aux(AUX_BLC + c) for c in range(4)]
        accBLC_n = [b.aux_next(AUX_BLC + c) for c in range(4)]
        prodBLC = b.ef_mul4(
            b.ef_sub4(accBLC_n, accBLC), b.ef_sub4(g_bl, code_blc)
        )
        for c in range(4):
            b.transition(b.sub(prodBLD[c], act_bl_call[c]))
            b.first_row(accBLD[c])
            b.transition(b.sub(prodBLC[c], act_bl_call[c]))
            b.first_row(accBLC[c])
        # --- log-record sends (per-frame channel): on a log row, the
        # record tuple carries (clk, fam_n, data span) plus the four
        # topic words read on the NEXT (logext) row as 16-bit limbs
        g_lg = b.ef_sub4(b.challenge_ef(CHAL_LG), fid_shift)
        lB_n = b.linmap(_LIMB_MAT, b.next_block(range(B0, B0 + 256)))
        lC_n = b.linmap(_LIMB_MAT, b.next_block(range(C0, C0 + 256)))
        lW_n = b.linmap(_LIMB_MAT, b.next_block(range(W0, W0 + 256)))
        code_lg = lincode(
            clk,
            [(fam_n, 1), (waddr, 2), (lB[0], 3)]
            + [(lA_n[i], 4 + i) for i in range(16)]
            + [(lB_n[i], 20 + i) for i in range(16)]
            + [(lC_n[i], 36 + i) for i in range(16)]
            + [(lW_n[i], 52 + i) for i in range(16)],
        )
        accLG = [b.aux(AUX_LG + c) for c in range(4)]
        accLG_n = [b.aux_next(AUX_LG + c) for c in range(4)]
        prodLG = b.ef_mul4(b.ef_sub4(accLG_n, accLG), b.ef_sub4(g_lg, code_lg))
        actLG = b.ef_from_base4(f_lg)
        for c in range(4):
            b.transition(b.sub(prodLG[c], actLG[c]))
            b.first_row(accLG[c])
        # --- callee-side channel endpoints: one CALLREQ receive and one
        # CALLRET send, built purely from publics, bound through inverse
        # witnesses at the (always halted) last row
        is_callee4 = b.ef_from_base4(b.public(PUB_IS_CALLEE))
        cvalue_pub = [
            b.public(PUB_ENV0 + 16 * ENV_IDX_CALLVALUE + i) for i in range(16)
        ]
        caddr_pub = [
            b.public(PUB_ENV0 + 16 * ENV_IDX_ADDRESS + i) for i in range(10)
        ]
        ccaller_pub = [
            b.public(PUB_ENV0 + 16 * ENV_IDX_CALLER + i) for i in range(10)
        ]
        code_cq_recv = lincode(
            b.public(PUB_CID_FID),
            [
                (b.public(PUB_CID_CLK), 1),
                (b.public(PUB_GAS0), 2),
                (b.public(PUB_GAS0 + 1), 3),
            ]
            + [(caddr_pub[i], 4 + i) for i in range(10)]
            + [(cvalue_pub[i], 14 + i) for i in range(16)]
            + [(b.public(PUB_ENV0 + 16 * ENV_IDX_CDSIZE), 30)]
            + [(ccaller_pub[i], 31 + i) for i in range(10)]
            + [(fid_pub, 41), (static_pub, 42)]
            + [(b.public(PUB_CODEADDR0 + i), 43 + i) for i in range(10)],
        )
        invQ = [b.aux(AUX_CQI + c) for c in range(4)]
        prodQ = b.ef_mul4(invQ, b.ef_sub4(g_cq, code_cq_recv))
        for c in range(4):
            b.last_row(b.add(prodQ[c], is_callee4[c]))
        code_cr_send = lincode(
            b.public(PUB_CID_FID),
            [
                (b.public(PUB_CID_CLK), 1),
                (b.public(PUB_GASF), 2),
                (b.public(PUB_GASF + 1), 3),
                (b.sub(one, rev_pub), 4),
                (b.public(PUB_RDS), 5),
            ],
        )
        invR = [b.aux(AUX_CRI + c) for c in range(4)]
        prodR = b.ef_mul4(invR, b.ef_sub4(g_cr, code_cr_send))
        for c in range(4):
            b.last_row(b.sub(prodR[c], is_callee4[c]))

        # 17. bus bindings (last row is always halted padding)
        for c in range(4):
            b.last_row(b.sub(accF[c], b.bus_coord(4 * BUS_FETCH + c)))
            b.last_row(b.sub(acc_sum[c], b.bus_coord(4 * BUS_STACK + c)))
            b.last_row(b.sub(accC[c], b.bus_coord(4 * BUS_CD + c)))
            b.last_row(
                b.sub(
                    b.add(b.add(accM[c], accM2[c]), b.add(accM3[c], accM4[c])),
                    b.bus_coord(4 * BUS_MEM + c),
                )
            )
            b.last_row(b.bus_coord(4 * BUS_BLOCKS + c))
            b.last_row(b.bus_coord(4 * BUS_DIG + c))
            b.last_row(b.sub(accK[c], b.bus_coord(4 * BUS_KCALL + c)))
            b.last_row(b.sub(accST[c], b.bus_coord(4 * BUS_STOR + c)))
            b.last_row(b.sub(accAR[c], b.bus_coord(4 * BUS_AR + c)))
            b.last_row(b.sub(accCP[c], b.bus_coord(4 * BUS_CP + c)))
            b.last_row(
                b.sub(
                    b.add(b.add(accCQ[c], accCQ2[c]), invQ[c]),
                    b.bus_coord(4 * BUS_CQ + c),
                )
            )
            b.last_row(
                b.sub(
                    b.add(b.add(accCR[c], accCR2[c]), invR[c]),
                    b.bus_coord(4 * BUS_CR + c),
                )
            )
            b.last_row(
                b.sub(
                    b.add(
                        b.add(b.add(accBRA[c], accBRW[c]), accBRR[c]),
                        accBRI[c],
                    ),
                    b.bus_coord(4 * BUS_BR + c),
                )
            )
            b.last_row(b.sub(accAD[c], b.bus_coord(4 * BUS_AD + c)))
            b.last_row(b.sub(accAC[c], b.bus_coord(4 * BUS_AC + c)))
            b.last_row(b.sub(accLG[c], b.bus_coord(4 * BUS_LG + c)))
            b.last_row(
                b.sub(
                    b.add(b.add(accBLR[c], accBLD[c]), accBLC[c]),
                    b.bus_coord(4 * BUS_BL + c),
                )
            )


# --------------------------------------------------------------------------
# EvmProgramAir — the instruction ROM (committed fixed columns)
# --------------------------------------------------------------------------

RM_MULT = 0
ROM_WIDTH = 1
RF_ACTIVE = 0
RF_PC = 1
RF_OP = 2
RF_IMM0 = 3  # 32 little-endian bytes of the pushed value
ROM_NFIXED = RF_IMM0 + 32


def program_instructions(code: bytes) -> list[tuple[int, int, int]]:
    """(pc, opcode, push_value) per instruction start, plus the virtual
    STOP at pc == len(code) (running off the end halts,
    interpreter.py:244/706).  Push data bytes are NOT instruction rows,
    so a jump into push data can never satisfy the fetch channel."""
    out = []
    pc = 0
    while pc < len(code):
        op = code[pc]
        if 0x60 <= op <= 0x7F:
            n = op - 0x5F
            imm = int.from_bytes(code[pc + 1 : pc + 1 + n], "big")
            out.append((pc, op, imm))
            pc += 1 + n
        else:
            out.append((pc, op, 0))
            pc += 1
    out.append((len(code), 0x00, 0))
    return out


class EvmProgramAir(Air):
    """One row per instruction; sends (pc, op, imm) fetch tuples with a
    witness visit-count multiplicity on the fetch channel."""

    width = ROM_WIDTH
    aux_width = 4
    num_aux_challenges = NUM_CHALLENGES
    num_bus_values = 2
    quotient_chunks = 2
    commit_fixed = True
    # host-numpy constraint eval: the jitted quotient stage for this
    # shape measured a >25-minute, multi-GB XLA:CPU compile (the root
    # cause of the round-3 "2.3 CPU-hours per e2e test" finding)
    eager_quotient = True

    def __init__(self, code: bytes, fid: int = 0):
        assert len(code) < (1 << 15), "program counter is 15-bit"
        self.code = bytes(code)
        self.fid = int(fid)
        self.instructions = program_instructions(self.code)
        self.n = _pow2_atleast(len(self.instructions) + 1)

    def structure_key(self) -> tuple:
        return ()  # constraint graph is instance-independent

    def fixed_columns(self, n: int):
        assert n == self.n
        cols = np.zeros((ROM_NFIXED, n), dtype=np.uint32)
        for row, (pc, op, imm) in enumerate(self.instructions):
            cols[RF_ACTIVE, row] = 1
            cols[RF_PC, row] = pc
            cols[RF_OP, row] = op
            for j in range(32):
                cols[RF_IMM0 + j, row] = (imm >> (8 * j)) & 0xFF
        return cols

    def trace(self, visit_counts: dict) -> np.ndarray:
        tr = np.zeros((self.n, ROM_WIDTH), dtype=np.uint32)
        for row, (pc, _, _) in enumerate(self.instructions):
            tr[row, RM_MULT] = visit_counts.get(pc, 0) % bb.P
        return tr

    def _terms(self, trace: np.ndarray, challenges) -> np.ndarray:
        challenges = fid_challenges(challenges, self.fid)
        chi, gamma_f = challenges[0], challenges[1]
        pows = _np_chi_pows(chi, 36)
        n = trace.shape[0]
        pc = np.zeros(n, dtype=np.uint64)
        op = np.zeros(n, dtype=np.uint64)
        imm = np.zeros((n, 32), dtype=np.uint64)
        active = np.zeros(n, dtype=np.uint64)
        for row, (p, o, im) in enumerate(self.instructions):
            pc[row], op[row], active[row] = p, o, 1
            for j in range(32):
                imm[row, j] = (im >> (8 * j)) & 0xFF
        code = _np_tuple_code(
            pc, [(op, 1)] + [(imm[:, j], j + 3) for j in range(32)], pows
        )
        gf = np.array([x % bb.P for x in gamma_f], dtype=np.uint64)
        inv = ef.npef_inv(ef.npef_sub(gf[None, :], code))
        mult = trace[:, RM_MULT].astype(np.uint64) * active % _PU
        return ef.npef_mul(ef.npef_from_base(mult), inv)

    def aux_trace(self, trace: np.ndarray, challenges) -> np.ndarray:
        terms = self._terms(trace, challenges)
        aux = np.zeros((trace.shape[0], 4), dtype=np.uint32)
        aux[:] = EvmCpuAir._excl_prefix(terms)
        return aux

    def bus_values(self, trace: np.ndarray, challenges) -> list[tuple]:
        terms = self._terms(trace, challenges)
        return [tuple(int(v) for v in terms.sum(axis=0) % _PU), ef.H_ZERO]

    def eval(self, b: ConstraintBuilder) -> None:
        chi = b.challenge_ef(CHAL_CHI)
        g_f = fid_gamma(b, chi, b.challenge_ef(CHAL_F), b.public(0))
        active = b.fixed(RF_ACTIVE)
        pc = b.fixed(RF_PC)
        op = b.fixed(RF_OP)
        mult = b.local(RM_MULT)

        code = b.ef_add4(
            b.ef_from_base4(pc), [b.mul(op, chi[c]) for c in range(4)]
        )
        pw = b.ef_mul4(b.ef_mul4(chi, chi), chi)  # chi^3
        for j in range(32):
            immj = b.fixed(RF_IMM0 + j)
            code = b.ef_add4(code, [b.mul(immj, pw[c]) for c in range(4)])
            if j < 31:
                pw = b.ef_mul4(pw, chi)

        acc = [b.aux(c) for c in range(4)]
        acc_n = [b.aux_next(c) for c in range(4)]
        prod = b.ef_mul4(b.ef_sub4(acc_n, acc), b.ef_sub4(g_f, code))
        send = b.ef_from_base4(b.mul(active, mult))
        for c in range(4):
            b.transition(b.sub(prod[c], send[c]))
            b.first_row(acc[c])
            b.last_row(b.sub(acc[c], b.bus_coord(4 * BUS_FETCH + c)))
            b.last_row(b.bus_coord(4 * BUS_STACK + c))


# --------------------------------------------------------------------------
# EvmStackAir — read-write-memory argument for the stack
# --------------------------------------------------------------------------

SK_ABITS = 0  # 11 address bits
SK_CBITS = 11  # 22 clk4 bits
SK_IW = 33
SK_SA = 34  # same-address-as-previous-row flag
SK_DBITS = 35  # 22 bits: strictly-increasing diff witness
SK_V0 = 57  # 256 value bits
STACK_WIDTH = SK_V0 + 256
SF_ACTIVE = 0
SF_ACTIVE_N = 1  # ACTIVE shifted up one row (fixed cols have no `next` view)


class EvmStackAir(Air):
    """Stack accesses sorted by (addr, clk4); receives every CPU access.

    Ordering: within an address, clk4 strictly increases (d = clk4 diff
    - 1 range-checked); across addresses, addr strictly increases.  A
    read (iw = 0) must repeat the previous row's value at the same
    address; the first access at each address must be a write."""

    width = STACK_WIDTH
    aux_width = 4
    num_aux_challenges = NUM_CHALLENGES
    num_bus_values = 2
    quotient_chunks = 2
    commit_fixed = True
    eager_quotient = True

    def __init__(self, num_accesses: int, fid: int = 0):
        self.T = int(num_accesses)
        self.fid = int(fid)
        self.n = _pow2_atleast(self.T + 1)

    def fixed_columns(self, n: int):
        assert n == self.n
        cols = np.zeros((2, n), dtype=np.uint32)
        cols[SF_ACTIVE, : self.T] = 1
        if self.T > 1:
            cols[SF_ACTIVE_N, : self.T - 1] = 1
        return cols

    def trace(self, accesses: list[tuple[int, int, int, int]]) -> np.ndarray:
        """accesses: (addr, clk4, is_write, value) in ANY order; sorted
        here."""
        assert len(accesses) == self.T
        acc = sorted(accesses)
        tr = np.zeros((self.n, STACK_WIDTH), dtype=np.uint32)
        prev_addr = None
        prev_clk = None
        for row, (addr, clk4, iw, value) in enumerate(acc):
            assert 0 <= addr < (1 << 11) and 0 <= clk4 < (1 << 22)
            for i in range(11):
                tr[row, SK_ABITS + i] = (addr >> i) & 1
            for i in range(22):
                tr[row, SK_CBITS + i] = (clk4 >> i) & 1
            tr[row, SK_IW] = iw
            if prev_addr is not None and addr == prev_addr:
                tr[row, SK_SA] = 1
                d = clk4 - prev_clk - 1
            elif prev_addr is not None:
                d = addr - prev_addr - 1
            else:
                d = 0
            assert 0 <= d < (1 << 22)
            for i in range(22):
                tr[row, SK_DBITS + i] = (d >> i) & 1
            tr[row, SK_V0 : SK_V0 + 256] = _word_bits(value)
            prev_addr, prev_clk = addr, clk4
        return tr

    def _terms(self, trace: np.ndarray, challenges) -> np.ndarray:
        challenges = fid_challenges(challenges, self.fid)
        chi, gamma_s = challenges[0], challenges[2]
        pows = _np_chi_pows(chi, 36)
        t = trace.astype(np.uint64)
        addr = sum(t[:, SK_ABITS + i] << np.uint64(i) for i in range(11))
        clk4 = sum(t[:, SK_CBITS + i] << np.uint64(i) for i in range(22))
        vbytes = _bits_to_bytes(trace[:, SK_V0 : SK_V0 + 256])
        code = _np_tuple_code(
            addr,
            [(clk4, 1), (t[:, SK_IW], 2)]
            + [(vbytes[:, j], j + 3) for j in range(32)],
            pows,
        )
        gs = np.array([x % bb.P for x in gamma_s], dtype=np.uint64)
        inv = ef.npef_inv(ef.npef_sub(gs[None, :], code))
        active = np.zeros(trace.shape[0], dtype=np.uint64)
        active[: self.T] = _PU - np.uint64(1)  # receive: -1
        return ef.npef_mul(ef.npef_from_base(active), inv)

    def aux_trace(self, trace: np.ndarray, challenges) -> np.ndarray:
        aux = np.zeros((trace.shape[0], 4), dtype=np.uint32)
        aux[:] = EvmCpuAir._excl_prefix(self._terms(trace, challenges))
        return aux

    def bus_values(self, trace: np.ndarray, challenges) -> list[tuple]:
        terms = self._terms(trace, challenges)
        return [ef.H_ZERO, tuple(int(v) for v in terms.sum(axis=0) % _PU)]

    def eval(self, b: ConstraintBuilder) -> None:
        one = b.constant(1)
        chi = b.challenge_ef(CHAL_CHI)
        g_s = fid_gamma(b, chi, b.challenge_ef(CHAL_S), b.public(0))
        active = b.fixed(SF_ACTIVE)

        def val(nx: bool, base: int, nbits: int):
            g = b.next if nx else b.local
            acc = None
            for i in range(nbits):
                t = b.scale(1 << i, g(base + i))
                acc = t if acc is None else b.add(acc, t)
            return acc

        addr = val(False, SK_ABITS, 11)
        addr_n = val(True, SK_ABITS, 11)
        clk4 = val(False, SK_CBITS, 22)
        clk4_n = val(True, SK_CBITS, 22)
        d_n = val(True, SK_DBITS, 22)
        iw = b.local(SK_IW)
        iw_n = b.next(SK_IW)
        sa = b.local(SK_SA)
        sa_n = b.next(SK_SA)

        # booleanity
        bit_cols = list(range(SK_ABITS, SK_ABITS + 11)) + list(
            range(SK_CBITS, SK_CBITS + 22)
        ) + [SK_IW, SK_SA] + list(range(SK_DBITS, SK_DBITS + 22)) + list(
            range(SK_V0, SK_V0 + 256)
        )
        bits = b.local_block(bit_cols)
        b.all_rows_block(b.mul(bits, b.sub(bits, one)), len(bit_cols))

        # sa only on active rows; row 0 is never a continuation
        b.all_rows(b.mul(b.sub(one, active), sa))
        b.first_row(sa)
        # same-address rows repeat the address and step the clock
        b.transition(b.mul(sa_n, b.sub(addr_n, addr)))
        # d' = sa' ? clk4' - clk4 - 1 : addr' - addr - 1   (on active rows)
        clk_diff = b.sub(b.sub(clk4_n, clk4), one)
        addr_diff = b.sub(b.sub(addr_n, addr), one)
        sel = b.add(b.mul(sa_n, clk_diff), b.mul(b.sub(one, sa_n), addr_diff))
        # gate by next-active (padding rows are unconstrained)
        nact = b.fixed(SF_ACTIVE_N)
        b.transition(b.mul(nact, b.sub(d_n, sel)))
        # first access at a new address must be a write
        b.transition(b.mul(nact, b.mul(b.sub(one, sa_n), b.sub(one, iw_n))))
        b.first_row(b.mul(active, b.sub(one, iw)))
        # read-after-write consistency
        vblk = b.local_block(range(SK_V0, SK_V0 + 256))
        vblk_n = b.next_block(range(SK_V0, SK_V0 + 256))
        b.transition_block(
            b.mul(b.mul(sa_n, b.sub(one, iw_n)), b.sub(vblk_n, vblk)), 256
        )

        # receive channel
        vcode = b.bit_block_code(vblk, chi, b.constant(0), 32)
        inner = b.ef_add4(b.ef_from_base4(iw), vcode)
        code = b.ef_add4(
            b.ef_from_base4(addr),
            b.ef_mul4(chi, b.ef_add4(b.ef_from_base4(clk4), b.ef_mul4(chi, inner))),
        )
        acc = [b.aux(c) for c in range(4)]
        acc_n = [b.aux_next(c) for c in range(4)]
        prod = b.ef_mul4(b.ef_sub4(acc_n, acc), b.ef_sub4(g_s, code))
        act4 = b.ef_from_base4(active)
        for c in range(4):
            b.transition(b.add(prod[c], act4[c]))
            b.first_row(acc[c])
            b.last_row(b.sub(acc[c], b.bus_coord(4 * BUS_STACK + c)))
            b.last_row(b.bus_coord(4 * BUS_FETCH + c))


# --------------------------------------------------------------------------
# MemRamAir — read-write-memory argument for the word-granular RAM
# --------------------------------------------------------------------------

MR_ABITS = 0  # 13 word-address bits
MR_CBITS = 13  # 22 clk4 bits
MR_IW = 35
MR_SA = 36  # same-address-as-previous-row flag
MR_FR = 37  # fresh-read flag: (1 - sa) * (1 - iw)
MR_DBITS = 38  # 22 bits: strictly-increasing diff witness
MR_V0 = 60  # 256 value bits
MEM_WIDTH = MR_V0 + 256
MF_ACTIVE = 0
MF_ACTIVE_N = 1


class MemRamAir(Air):
    """EVM memory as word-granular RAM sorted by (word addr, clk4).

    Same ordering discipline as EvmStackAir, with the EVM's
    zero-initialized semantics: the first access at an address may be a
    read, but then its value must be zero (fresh-read rule), instead of
    the stack's first-access-must-write rule."""

    width = MEM_WIDTH
    aux_width = 4
    num_aux_challenges = NUM_CHALLENGES
    num_bus_values = 4
    quotient_chunks = 2
    commit_fixed = True
    eager_quotient = True

    def __init__(self, num_accesses: int, fid: int = 0):
        self.T = int(num_accesses)
        self.fid = int(fid)
        self.n = _pow2_atleast(self.T + 1)

    def fixed_columns(self, n: int):
        assert n == self.n
        cols = np.zeros((2, n), dtype=np.uint32)
        cols[MF_ACTIVE, : self.T] = 1
        if self.T > 1:
            cols[MF_ACTIVE_N, : self.T - 1] = 1
        return cols

    def trace(self, accesses: list[tuple[int, int, int, int]]) -> np.ndarray:
        """accesses: (word_addr, clk4, is_write, value) in ANY order."""
        assert len(accesses) == self.T
        acc = sorted(accesses)
        tr = np.zeros((self.n, MEM_WIDTH), dtype=np.uint32)
        prev_addr = None
        prev_clk = None
        for row, (addr, clk4, iw, value) in enumerate(acc):
            assert 0 <= addr < (1 << 13) and 0 <= clk4 < (1 << 22)
            for i in range(13):
                tr[row, MR_ABITS + i] = (addr >> i) & 1
            for i in range(22):
                tr[row, MR_CBITS + i] = (clk4 >> i) & 1
            tr[row, MR_IW] = iw
            if prev_addr is not None and addr == prev_addr:
                tr[row, MR_SA] = 1
                d = clk4 - prev_clk - 1
            elif prev_addr is not None:
                d = addr - prev_addr - 1
            else:
                d = 0
            assert 0 <= d < (1 << 22)
            tr[row, MR_FR] = (1 - tr[row, MR_SA]) * (1 - iw)
            for i in range(22):
                tr[row, MR_DBITS + i] = (d >> i) & 1
            tr[row, MR_V0 : MR_V0 + 256] = _word_bits(value)
            prev_addr, prev_clk = addr, clk4
        # padding rows: sa = iw = 0 -> fr = 1, zero value (zero-init reads)
        tr[self.T :, MR_FR] = 1
        return tr

    def _terms(self, trace: np.ndarray, challenges) -> np.ndarray:
        challenges = fid_challenges(challenges, self.fid)
        chi, gamma_m = challenges[CHAL_CHI], challenges[CHAL_M]
        pows = _np_chi_pows(chi, 36)
        t = trace.astype(np.uint64)
        addr = sum(t[:, MR_ABITS + i] << np.uint64(i) for i in range(13))
        clk4 = sum(t[:, MR_CBITS + i] << np.uint64(i) for i in range(22))
        vbytes = _bits_to_bytes(trace[:, MR_V0 : MR_V0 + 256])
        code = _np_tuple_code(
            addr,
            [(clk4, 1), (t[:, MR_IW], 2)]
            + [(vbytes[:, j], j + 3) for j in range(32)],
            pows,
        )
        gm = np.array([x % bb.P for x in gamma_m], dtype=np.uint64)
        inv = ef.npef_inv(ef.npef_sub(gm[None, :], code))
        active = np.zeros(trace.shape[0], dtype=np.uint64)
        active[: self.T] = _PU - np.uint64(1)  # receive: -1
        return ef.npef_mul(ef.npef_from_base(active), inv)

    def aux_trace(self, trace: np.ndarray, challenges) -> np.ndarray:
        aux = np.zeros((trace.shape[0], 4), dtype=np.uint32)
        aux[:] = EvmCpuAir._excl_prefix(self._terms(trace, challenges))
        return aux

    def bus_values(self, trace: np.ndarray, challenges) -> list[tuple]:
        terms = self._terms(trace, challenges)
        return [
            ef.H_ZERO,
            ef.H_ZERO,
            ef.H_ZERO,
            tuple(int(v) for v in terms.sum(axis=0) % _PU),
        ]

    def eval(self, b: ConstraintBuilder) -> None:
        one = b.constant(1)
        chi = b.challenge_ef(CHAL_CHI)
        g_m = fid_gamma(b, chi, b.challenge_ef(CHAL_M), b.public(0))
        active = b.fixed(MF_ACTIVE)

        def val(nx: bool, base: int, nbits: int):
            g = b.next if nx else b.local
            acc = None
            for i in range(nbits):
                t = b.scale(1 << i, g(base + i))
                acc = t if acc is None else b.add(acc, t)
            return acc

        addr = val(False, MR_ABITS, 13)
        addr_n = val(True, MR_ABITS, 13)
        clk4 = val(False, MR_CBITS, 22)
        clk4_n = val(True, MR_CBITS, 22)
        d_n = val(True, MR_DBITS, 22)
        iw = b.local(MR_IW)
        sa = b.local(MR_SA)
        sa_n = b.next(MR_SA)
        fr = b.local(MR_FR)

        # booleanity
        bit_cols = (
            list(range(MR_ABITS, MR_ABITS + 13))
            + list(range(MR_CBITS, MR_CBITS + 22))
            + [MR_IW, MR_SA, MR_FR]
            + list(range(MR_DBITS, MR_DBITS + 22))
            + list(range(MR_V0, MR_V0 + 256))
        )
        bits = b.local_block(bit_cols)
        b.all_rows_block(b.mul(bits, b.sub(bits, one)), len(bit_cols))

        # sa only on active rows; row 0 is never a continuation
        b.all_rows(b.mul(b.sub(one, active), sa))
        b.first_row(sa)
        # same-address rows repeat the address and step the clock
        b.transition(b.mul(sa_n, b.sub(addr_n, addr)))
        clk_diff = b.sub(b.sub(clk4_n, clk4), one)
        addr_diff = b.sub(b.sub(addr_n, addr), one)
        sel = b.add(b.mul(sa_n, clk_diff), b.mul(b.sub(one, sa_n), addr_diff))
        nact = b.fixed(MF_ACTIVE_N)
        b.transition(b.mul(nact, b.sub(d_n, sel)))
        # fresh-read rule: fr = (1-sa)(1-iw); a fresh read sees zero
        b.all_rows(b.sub(fr, b.mul(b.sub(one, sa), b.sub(one, iw))))
        vblk = b.local_block(range(MR_V0, MR_V0 + 256))
        b.all_rows_block(b.mul(fr, vblk), 256)
        # read-after-write consistency
        vblk_n = b.next_block(range(MR_V0, MR_V0 + 256))
        iw_n = b.next(MR_IW)
        b.transition_block(
            b.mul(b.mul(sa_n, b.sub(one, iw_n)), b.sub(vblk_n, vblk)), 256
        )

        # receive channel
        vcode = b.bit_block_code(vblk, chi, b.constant(0), 32)
        inner = b.ef_add4(b.ef_from_base4(iw), vcode)
        code = b.ef_add4(
            b.ef_from_base4(addr),
            b.ef_mul4(chi, b.ef_add4(b.ef_from_base4(clk4), b.ef_mul4(chi, inner))),
        )
        acc = [b.aux(c) for c in range(4)]
        acc_n = [b.aux_next(c) for c in range(4)]
        prod = b.ef_mul4(b.ef_sub4(acc_n, acc), b.ef_sub4(g_m, code))
        act4 = b.ef_from_base4(active)
        for c in range(4):
            b.transition(b.add(prod[c], act4[c]))
            b.first_row(acc[c])
            b.last_row(b.sub(acc[c], b.bus_coord(4 * BUS_MEM + c)))
            b.last_row(b.bus_coord(4 * BUS_FETCH + c))
            b.last_row(b.bus_coord(4 * BUS_STACK + c))
            b.last_row(b.bus_coord(4 * BUS_CD + c))


# --------------------------------------------------------------------------
# EvmCalldataAir — per-offset word table over the public calldata
# --------------------------------------------------------------------------

CD_MULT = 0
CD_WIDTH = 1
CF_ACTIVE = 0
CF_OFF = 1
CF_B0 = 2  # 32 little-endian bytes of the zero-padded big-endian word
CD_NFIXED = CF_B0 + 32


class EvmCalldataAir(Air):
    """One row per calldata byte offset, holding the 32-byte big-endian
    word starting there (zero-padded past the end — EVM CALLDATALOAD
    semantics); committed-fixed columns derived from the PUBLIC calldata,
    a witness multiplicity column counting in-bounds loads."""

    width = CD_WIDTH
    aux_width = 4
    num_aux_challenges = NUM_CHALLENGES
    num_bus_values = 3
    quotient_chunks = 2
    commit_fixed = True
    eager_quotient = True

    def __init__(self, calldata: bytes, fid: int = 0):
        assert len(calldata) < (1 << 15), "calldata offsets are 15-bit"
        self.calldata = bytes(calldata)
        self.fid = int(fid)
        self.n = _pow2_atleast(len(self.calldata) + 1)

    def structure_key(self) -> tuple:
        return ()  # constraint graph is instance-independent

    def fixed_columns(self, n: int):
        assert n == self.n
        cols = np.zeros((CD_NFIXED, n), dtype=np.uint32)
        cd = self.calldata
        for o in range(len(cd)):
            cols[CF_ACTIVE, o] = 1
            cols[CF_OFF, o] = o
            v = int.from_bytes(cd[o : o + 32].ljust(32, b"\x00"), "big")
            for j in range(32):
                cols[CF_B0 + j, o] = (v >> (8 * j)) & 0xFF
        return cols

    def trace(self, cd_loads: dict) -> np.ndarray:
        tr = np.zeros((self.n, CD_WIDTH), dtype=np.uint32)
        for o, cnt in cd_loads.items():
            tr[o, CD_MULT] = cnt % bb.P
        return tr

    def _terms(self, trace: np.ndarray, challenges) -> np.ndarray:
        challenges = fid_challenges(challenges, self.fid)
        chi, gamma_c = challenges[CHAL_CHI], challenges[CHAL_C]
        pows = _np_chi_pows(chi, 36)
        n = trace.shape[0]
        fx = self.fixed_columns(n).astype(np.uint64)
        code = _np_tuple_code(
            fx[CF_OFF], [(fx[CF_B0 + j], j + 1) for j in range(32)], pows
        )
        gc = np.array([x % bb.P for x in gamma_c], dtype=np.uint64)
        inv = ef.npef_inv(ef.npef_sub(gc[None, :], code))
        # receive: -mult on active rows
        mult = (_PU - trace[:, CD_MULT].astype(np.uint64)) * fx[CF_ACTIVE] % _PU
        return ef.npef_mul(ef.npef_from_base(mult), inv)

    def aux_trace(self, trace: np.ndarray, challenges) -> np.ndarray:
        aux = np.zeros((trace.shape[0], 4), dtype=np.uint32)
        aux[:] = EvmCpuAir._excl_prefix(self._terms(trace, challenges))
        return aux

    def bus_values(self, trace: np.ndarray, challenges) -> list[tuple]:
        terms = self._terms(trace, challenges)
        return [ef.H_ZERO, ef.H_ZERO, tuple(int(v) for v in terms.sum(axis=0) % _PU)]

    def eval(self, b: ConstraintBuilder) -> None:
        chi = b.challenge_ef(CHAL_CHI)
        g_c = fid_gamma(b, chi, b.challenge_ef(CHAL_C), b.public(0))
        active = b.fixed(CF_ACTIVE)
        off = b.fixed(CF_OFF)
        mult = b.local(CD_MULT)

        code = b.ef_from_base4(off)
        pw = list(chi)
        for j in range(32):
            byt = b.fixed(CF_B0 + j)
            code = b.ef_add4(code, [b.mul(byt, pw[c]) for c in range(4)])
            if j < 31:
                pw = b.ef_mul4(pw, chi)

        acc = [b.aux(c) for c in range(4)]
        acc_n = [b.aux_next(c) for c in range(4)]
        prod = b.ef_mul4(b.ef_sub4(acc_n, acc), b.ef_sub4(g_c, code))
        recv = b.ef_from_base4(b.mul(active, mult))
        for c in range(4):
            b.transition(b.add(prod[c], recv[c]))
            b.first_row(acc[c])
            b.last_row(b.sub(acc[c], b.bus_coord(4 * BUS_CD + c)))
            b.last_row(b.bus_coord(4 * BUS_FETCH + c))
            b.last_row(b.bus_coord(4 * BUS_STACK + c))


# --------------------------------------------------------------------------
# frame payload: prove / verify
# --------------------------------------------------------------------------


def frame_tables(ft: FrameTrace):
    """[(air, trace, publics)] for prover.prove_tables.  Every per-frame
    table is instanced by ft.fid (publics[0] of each non-CPU table)."""
    fid = int(ft.fid)
    cpu = EvmCpuAir(fid)
    cpu_trace, publics = build_cpu_trace(ft)
    cpu._publics = publics  # host-side composition-channel codes
    rom = EvmProgramAir(ft.code, fid)
    stk = EvmStackAir(len(ft.accesses), fid)
    cdt = EvmCalldataAir(ft.calldata, fid)
    ram = MemRamAir(len(ft.mem_accesses), fid)
    tables = [
        (cpu, cpu_trace, publics),
        (rom, rom.trace(ft.visit_counts), [fid]),
        (stk, stk.trace(ft.accesses), [fid]),
        (cdt, cdt.trace(ft.cd_loads), [fid]),
        (ram, ram.trace(ft.mem_accesses), [fid]),
    ]
    if ft.storage_groups:
        from .evm_storage import EvmStorageAir

        stor = EvmStorageAir(ft.storage_groups, fid)
        tables.append((stor, stor.trace(ft.storage_accesses), [fid]))
    if ft.keccak_calls:
        from .evm_keccak import EvmKeccakCallAir, EvmSpongeAir

        bridge = EvmKeccakCallAir(
            [(offw, size) for _, offw, size, _, _ in ft.keccak_calls], fid
        )
        witness = [
            (clk, words, digest)
            for clk, _, _, words, digest in ft.keccak_calls
        ]
        messages = [
            b"".join(w.to_bytes(32, "big") for w in words)[:size]
            for _, _, size, words, _ in ft.keccak_calls
        ]
        sponge = EvmSpongeAir.from_messages(
            messages, msg_id_offset=fid * MAX_KECCAK_CALLS
        )
        tables.append((bridge, bridge.trace(witness), [fid]))
        tables.append((sponge, sponge.trace(), []))
    if ft.arith_calls:
        from .evm_arith import ArithAir

        ar = ArithAir([k for k, *_ in ft.arith_calls], fid)
        tables.append((ar, ar.trace(ft.arith_calls), [fid]))
    cd_copies = [c for c in ft.copy_calls if c[0] == "calldata"]
    code_copies = [c for c in ft.copy_calls if c[0] == "code"]
    if cd_copies:
        from .evm_copy import EvmCopyAir

        cp = EvmCopyAir(
            [(d, o, w, sl) for _, _, d, o, w, sl, _, _, _ in cd_copies],
            ft.env.calldatasize,
            fid,
        )
        tables.append(
            (
                cp,
                cp.trace(
                    [
                        (clk, srcs, told)
                        for _, clk, _, _, _, _, _, srcs, told in cd_copies
                    ]
                ),
                [fid],
            )
        )
    if code_copies:
        from .evm_copy import CodeCopyAir

        cc = CodeCopyAir(
            [(d, o, w, sl) for _, _, d, o, w, sl, _, _, _ in code_copies],
            ft.code,
            fid,
        )
        tables.append(
            (
                cc,
                cc.trace(
                    [
                        (clk, told)
                        for _, clk, _, _, _, _, _, _, told in code_copies
                    ]
                ),
                [fid],
            )
        )
    return tables


def frame_publics(
    env: FrameEnv,
    gas0: int,
    gas_f: int,
    sp_f: int,
    fid: int = 0,
    is_callee: int = 0,
    cid: tuple = (0, 0),
    rds: int = 0,
    hasret: int = 0,
    static: int = 0,
    reverted: int = 0,
    code_addr: int | None = None,
) -> list[int]:
    publics = [gas0 & 0xFFFF, gas0 >> 16, gas_f & 0xFFFF, gas_f >> 16, sp_f]
    for w in env.words():
        publics.extend((w >> (16 * i)) & 0xFFFF for i in range(16))
    publics.extend(
        [int(fid), int(is_callee), int(cid[0]), int(cid[1]), int(rds), int(hasret)]
    )
    ca = env.address if code_addr is None else int(code_addr)
    publics.extend([int(static), int(reverted)])
    publics.extend((ca >> (16 * i)) & 0xFFFF for i in range(10))
    return publics


def prove_frame(
    code: bytes, env: FrameEnv, gas: int, device, calldata: bytes | None = None
) -> dict:
    """Execute a covered frame and prove it on ``device`` ("cuda" or
    "cpu"); raises UncoveredFrame when the frame leaves the covered
    statement."""
    return prove_frame_trace(execute_frame(code, env, gas, calldata=calldata), device)


def flatten_call_tree(root: FrameTrace) -> list[FrameTrace]:
    """Assign frame ids/roles through the tree (DFS, root first) and
    return the ordered frame list.  Precompile call sites consume a fid
    too (their PrecompileCallAir instance carries it in the tuples)."""
    frames: list[FrameTrace] = []
    next_fid = [0]

    def visit(ft: FrameTrace, is_callee: int, cid: tuple, hasret: int):
        ft.fid = next_fid[0]
        next_fid[0] += 1
        ft.is_callee = is_callee
        ft.cid = cid
        ft.hasret = hasret
        frames.append(ft)
        for site in ft.call_sites:
            cfid = next_fid[0]
            site["cfid"] = cfid
            # bind the callee fid into the call row's witness
            ft.steps[site["clk"]].callw["cfid"] = cfid
            if site["precompile"] is not None:
                next_fid[0] += 1
            else:
                # create sites consume the child's returndata as the
                # DEPLOYED code: attach its ret-read bridge whenever the
                # child returned bytes
                hr = 1 if site["ret_sw"] else 0
                if site.get("create") and site.get("rds"):
                    hr = 1
                visit(site["callee"], 1, (ft.fid, site["clk"]), hr)
    visit(root, 0, (0, 0), 0)
    if len(frames) > MAX_FRAMES_PER_TREE or next_fid[0] > MAX_FRAMES_PER_TREE:
        raise UncoveredFrame("call tree beyond the frame budget")
    return frames


def frame_record(ft: FrameTrace) -> dict:
    """The PUBLIC statement of one frame in the call-tree payload."""
    rec = {
        "calls": [
            {
                "clk": site["clk"],
                "cfid": site["cfid"],
                "precompile": site["precompile"],
                "args_offw": site["args_offw"],
                "args_sw": site["args_sw"] if site["args_words"] else 0,
                "ret_offw": site["ret_offw"],
                "ret_sw": site["ret_sw"],
                "static": site.get("static", 0),
                "create": site.get("create", 0),
                "kc2": site.get("kc2", 0),
                **(
                    {
                        "gas_in": site["gas_in"],
                        "args_words": [hex(w) for w in site["args_words"]],
                    }
                    if site["precompile"] is not None
                    else {}
                ),
            }
            for site in ft.call_sites
        ],
        "addr_groups": [
            [hex(a), c, w] for a, c, w in ft.addr_groups
        ],
        "acct_ctx": [
            [k, hex(key), hex(v)] for k, key, v, _ in ft.acct_groups
        ],
        "logs": [
            [
                lr["clk"], lr["fam_n"], lr["offw"], lr["size"],
                [hex(t) for t in lr["topics"]],
                [hex(w) for w in lr["data_words"]],
                lr.get("seq", 0),
            ]
            for lr in ft.log_records
        ],
    }
    if ft.hasret and ft.ret_span:
        rec["ret_clk"] = ft.ret_span[0]
        rec["ret_offw"] = ft.ret_span[1]
        rec["returndata_words"] = [hex(w) for w in ft.ret_span[2]]
    rec2 = {
        "code": ft.code.hex(),
        "calldata": ft.calldata.hex(),
        "env": {k: hex(v) for k, v in ft.env.__dict__.items()},
        "gas0": ft.gas0,
        "gas_f": ft.gas_f,
        "sp_f": ft.sp_f,
        "fid": ft.fid,
        "is_callee": ft.is_callee,
        "cid": [int(ft.cid[0]), int(ft.cid[1])],
        "rds": ft.rds,
        "hasret": ft.hasret,
        "static": ft.static,
        "reverted": ft.reverted,
        "code_addr": hex(ft.code_addr or ft.env.address),
        "accesses": len(ft.accesses),
        "mem_accesses": len(ft.mem_accesses),
        "keccak_calls": [
            [offw, size] for _, offw, size, _, _ in ft.keccak_calls
        ],
        "arith_calls": [k for k, *_ in ft.arith_calls],
        "copy_calls": [
            [destw, off, sw, slack]
            for kind, _, destw, off, sw, slack, _, _, _ in ft.copy_calls
            if kind == "calldata"
        ],
        "codecopy_calls": [
            [destw, off, sw, slack]
            for kind, _, destw, off, sw, slack, _, _, _ in ft.copy_calls
            if kind == "code"
        ],
        "storage": [
            [hex(slot), hex(orig), count, prewarm, hex(final)]
            for slot, orig, count, prewarm, final in ft.storage_groups
        ],
        "steps": len(ft.steps),
    }
    rec2.update(rec)
    return rec2


def _frame_extra_tables(ft: FrameTrace) -> list:
    """Prover-side composition tables of ONE frame: the address journal,
    the per-site bridges/precompiles, and the callee ret-read bridge."""
    from .evm_call import (
        KIND_ARGS,
        KIND_RETREAD,
        KIND_RETWRITE,
        PRECOMPILE_ADDR,
        EvmAddrAir,
        MemSpanBridgeAir,
        PrecompileCallAir,
        precompile_gas,
    )

    from .evm_call import AcctCtxAir

    tables = []
    fid = ft.fid
    if ft.addr_groups:
        adj = EvmAddrAir(ft.addr_groups, fid)
        tables.append((adj, adj.trace(ft.addr_accesses), [fid]))
    if ft.acct_groups:
        rows = [(k, key, v) for k, key, v, _ in ft.acct_groups]
        counts = [c for _, _, _, c in ft.acct_groups]
        act = AcctCtxAir(rows, fid)
        tables.append((act, act.trace(counts), [fid]))
    if ft.log_records:
        from .evm_call import KIND_LOGDATA, EvmLogAir

        recs = [
            (lr["fam_n"], lr["offw"], lr["size"], lr["topics"])
            for lr in ft.log_records
        ]
        lga = EvmLogAir(recs, fid)
        tables.append(
            (lga, lga.trace([lr["clk"] for lr in ft.log_records]), [fid])
        )
        for lr in ft.log_records:
            if lr["data_words"]:
                br = MemSpanBridgeAir(
                    fid, 4 * lr["clk"] + 1, KIND_LOGDATA, lr["offw"],
                    lr["data_words"], 0, 0,
                )
                tables.append((br, br.trace(), br.publics()))
    from .evm_call import KIND_INITCODE

    for site in ft.call_sites:
        if site["args_words"]:
            kind_b = KIND_INITCODE if site.get("create") else KIND_ARGS
            br = MemSpanBridgeAir(
                fid, 4 * site["clk"] + 1, kind_b, site["args_offw"],
                site["args_words"], 0, site["cfid"],
            )
            tables.append((br, br.trace(), br.publics()))
        if site["ret_sw"]:
            br = MemSpanBridgeAir(
                fid, 4 * site["clk"] + 5, KIND_RETWRITE, site["ret_offw"],
                site["ret_words"], 1, site["cfid"],
            )
            tables.append((br, br.trace(), br.publics()))
        if site["precompile"] is not None:
            kind = site["precompile"]
            cds = 32 * site["args_sw"]
            pc = PrecompileCallAir(
                site["cfid"], fid, site["clk"], site["gas_in"],
                site["gas_in"] - precompile_gas(kind, cds), cds,
                PRECOMPILE_ADDR[kind], ft.env.address,
                static=site.get("static", 0),
            )
            tables.append((pc, pc.trace(), pc.publics()))
    if ft.hasret and ft.ret_span:
        rclk, roffw, rwords = ft.ret_span
        br = MemSpanBridgeAir(
            fid, 4 * rclk + 1, KIND_RETREAD, roffw, rwords, 0, 0
        )
        tables.append((br, br.trace(), br.publics()))
    return tables


def balance_journal(fts: list[FrameTrace]):
    """Aggregate the tree's balance events into the journal statement:
    -> (groups [(addr, orig, final, count)], per-group ordered events
    [(fid, clk4, kind, value)]) — or (None, None) when no frame touches
    balances."""
    root = fts[0]
    by_addr: dict[int, list] = {}
    for ft in fts:
        for clk4, kind, addr, value, seq in ft.bal_events:
            by_addr.setdefault(addr, []).append(
                (seq, ft.fid, clk4, kind, value)
            )
    if not by_addr:
        return None, None
    groups = []
    events = []
    for addr in sorted(by_addr):
        # true cross-frame execution order within the address group
        evs = [t[1:] for t in sorted(by_addr[addr])]
        orig = int(root.bal_originals.get(addr, 0))
        fin = int(root.bal_finals.get(addr, orig))
        groups.append((addr, orig, fin, len(evs)))
        events.append(evs)
    return groups, events


def prove_call_tree(root: FrameTrace, device) -> dict:
    """Prove a call tree (root + every callee frame + composition
    tables + the tree-level balance journal) in ONE multi-table proof
    with a shared bus, on ``device`` ("cuda" or "cpu").  Building the
    tables' traces is a ``frames.tables`` span, serialising the proofs a
    ``frames.serialize`` span."""
    from ...utils.measurement import Measurement
    from .. import prover as sp
    from ..serde import proof_to_dict
    from .evm_call import EvmBalanceAir

    with Measurement("frames.tables"):
        fts = flatten_call_tree(root)
        tables = []
        frames = []
        for ft in fts:
            frames.append(frame_record(ft))
            tables.extend(frame_tables(ft))
            tables.extend(_frame_extra_tables(ft))
        out = {"kind": "evm-call-tree-v1", "frames": frames}
        groups, events = balance_journal(fts)
        if groups:
            bal = EvmBalanceAir(groups)
            tables.append((bal, bal.trace(events), bal.publics()))
            out["balances"] = [
                [hex(a), hex(o), hex(f), c] for a, o, f, c in groups
            ]
    proofs = sp.prove_tables(tables, device)
    with Measurement("frames.serialize"):
        out["starks"] = [proof_to_dict(p) for p in proofs]
    return out


def prove_frame_trace(ft: FrameTrace, device) -> dict:
    return prove_call_tree(ft, device)


def _frame_extra_airs_from_record(rec: dict, by_fid: dict):
    """Composition tables of one frame, rebuilt from PUBLIC records (the
    bridge word values come from the counterpart frame's public calldata
    / returndata, so channel balance proves the memory movement)."""
    from .evm_call import (
        KIND_ARGS,
        KIND_RETREAD,
        KIND_RETWRITE,
        PRECOMPILE_ADDR,
        EvmAddrAir,
        MemSpanBridgeAir,
        PrecompileCallAir,
        precompile_gas,
    )

    fid = int(rec.get("fid", 0))
    env_addr = int(rec["env"]["address"], 16)
    airs = []
    pubs = []
    from .evm_call import AcctCtxAir

    groups = [
        (int(a, 16), int(c), int(w)) for a, c, w in rec.get("addr_groups", [])
    ]
    if groups:
        airs.append(EvmAddrAir(groups, fid))
        pubs.append([fid])
    acct_rows = [
        (int(k), int(key, 16), int(v, 16))
        for k, key, v in rec.get("acct_ctx", [])
    ]
    if acct_rows:
        airs.append(AcctCtxAir(acct_rows, fid))
        pubs.append([fid])
    logs = rec.get("logs", [])
    if logs:
        from .evm_call import KIND_LOGDATA, EvmLogAir

        lrecs = []
        for clk, fam, offw, size, topics, words, *_seq in logs:
            fam, offw, size = int(fam), int(offw), int(size)
            tvals = [int(t, 16) for t in topics]
            wvals = [int(w, 16) for w in words]
            if len(wvals) != ((size + 31) // 32 if size else 0):
                raise ValueError("log data words/size mismatch")
            lrecs.append((fam, offw, size, tvals))
        airs.append(EvmLogAir(lrecs, fid))
        pubs.append([fid])
        for clk, fam, offw, size, topics, words, *_seq in logs:
            if int(size):
                br = MemSpanBridgeAir(
                    fid, 4 * int(clk) + 1, KIND_LOGDATA, int(offw),
                    [int(w, 16) for w in words], 0, 0,
                )
                airs.append(br)
                pubs.append(br.publics())
    for site in rec.get("calls", []):
        clk = int(site["clk"])
        cfid = int(site["cfid"])
        if not (0 <= clk < (1 << MAX_STEPS_LOG)) or not (
            0 < cfid < (1 << 16)
        ):
            raise ValueError("call-site clk/cfid out of range")
        kind = site.get("precompile")
        args_sw = int(site.get("args_sw", 0))
        ret_sw = int(site.get("ret_sw", 0))
        if kind is not None:
            if kind not in PRECOMPILE_ADDR:
                raise ValueError("unknown precompile")
            if cfid in by_fid:
                raise ValueError("precompile fid collides with a frame")
            words = [int(w, 16) for w in site.get("args_words", [])]
            if len(words) != args_sw:
                raise ValueError("precompile args length mismatch")
            ret_words = words[:ret_sw]
            if ret_sw > args_sw:
                raise ValueError("precompile retSize beyond returndata")
        elif int(site.get("create", 0)):
            # CREATE: the kind-4 bridge words are the child's public
            # CODE (the initcode the caller's memory must contain)
            callee = by_fid.get(cfid)
            if callee is None:
                raise ValueError("create site without initcode frame")
            ccode = bytes.fromhex(callee.get("code", ""))
            if args_sw != (len(ccode) + 31) // 32:
                raise ValueError("initcode word count mismatch")
            if callee.get("calldata"):
                raise ValueError("initcode frame must have empty calldata")
            padded = ccode.ljust(32 * args_sw, b"\x00")
            words = [
                int.from_bytes(padded[32 * j : 32 * j + 32], "big")
                for j in range(args_sw)
            ]
            if ret_sw:
                raise ValueError("create sites have no ret buffer")
            ret_words = []
        else:
            callee = by_fid.get(cfid)
            if callee is None:
                raise ValueError("call site without callee frame")
            ccd = bytes.fromhex(callee.get("calldata", ""))
            if len(ccd) != 32 * args_sw:
                raise ValueError("callee calldata length mismatch")
            words = [
                int.from_bytes(ccd[32 * j : 32 * j + 32], "big")
                for j in range(args_sw)
            ]
            rw = [int(w, 16) for w in callee.get("returndata_words", [])]
            if ret_sw > len(rw):
                raise ValueError("retSize beyond callee returndata")
            ret_words = rw[:ret_sw]
        if args_sw:
            from .evm_call import KIND_INITCODE

            kind_b = KIND_INITCODE if int(site.get("create", 0)) else KIND_ARGS
            br = MemSpanBridgeAir(
                fid, 4 * clk + 1, kind_b, int(site["args_offw"]),
                words, 0, cfid,
            )
            airs.append(br)
            pubs.append(br.publics())
        if ret_sw:
            br = MemSpanBridgeAir(
                fid, 4 * clk + 5, KIND_RETWRITE, int(site["ret_offw"]),
                ret_words, 1, cfid,
            )
            airs.append(br)
            pubs.append(br.publics())
        if kind is not None:
            gas_in = int(site["gas_in"])
            cds = 32 * args_sw
            cost = precompile_gas(kind, cds)
            if not (0 <= cost <= gas_in < 1 << MAX_GAS_LOG):
                raise ValueError("precompile gas out of range")
            if int(site.get("static", 0)) not in (0, 1):
                raise ValueError("bad precompile static flag")
            pc = PrecompileCallAir(
                cfid, fid, clk, gas_in, gas_in - cost, cds,
                PRECOMPILE_ADDR[kind], env_addr,
                static=int(site.get("static", 0)),
            )
            airs.append(pc)
            pubs.append(pc.publics())
    if int(rec.get("hasret", 0)):
        rwords = [int(w, 16) for w in rec.get("returndata_words", [])]
        rds = int(rec.get("rds", 0))
        if len(rwords) != (rds + 31) // 32 or not rwords:
            raise ValueError("returndata words/rds mismatch")
        br = MemSpanBridgeAir(
            fid, 4 * int(rec["ret_clk"]) + 1, KIND_RETREAD,
            int(rec["ret_offw"]), rwords, 0, 0,
        )
        airs.append(br)
        pubs.append(br.publics())
    return airs, pubs


def _frame_airs_from_record(rec: dict):
    """-> (airs, expected_publics_per_table) rebuilt from the PUBLIC
    frame record; raises on malformed records."""
    code = bytes.fromhex(rec["code"])
    calldata = bytes.fromhex(rec.get("calldata", ""))
    env = FrameEnv(**{k: int(v, 16) for k, v in rec["env"].items()})
    gas0, gas_f, sp_f = int(rec["gas0"]), int(rec["gas_f"]), int(rec["sp_f"])
    fid = int(rec.get("fid", 0))
    is_callee = int(rec.get("is_callee", 0))
    cid = tuple(int(x) for x in rec.get("cid", (0, 0)))
    rds = int(rec.get("rds", 0))
    hasret = int(rec.get("hasret", 0))
    n_acc = int(rec["accesses"])
    n_mem = int(rec.get("mem_accesses", 0))
    kcalls = [(int(o), int(s)) for o, s in rec.get("keccak_calls", [])]
    sgroups = [
        (int(s, 16), int(o, 16), int(c), int(w), int(f, 16))
        for s, o, c, w, f in rec.get("storage", [])
    ]
    ar_kinds = rec.get("arith_calls", [])
    if isinstance(ar_kinds, int):
        ar_kinds = [1] * ar_kinds
    ar_kinds = [int(k) for k in ar_kinds]
    cp_calls = [
        (int(d), int(o), int(w), int(sl))
        for d, o, w, sl in rec.get("copy_calls", [])
    ]
    cc_calls = [
        (int(d), int(o), int(w), int(sl))
        for d, o, w, sl in rec.get("codecopy_calls", [])
    ]
    if not (0 <= gas_f <= gas0 < 1 << MAX_GAS_LOG and 0 <= sp_f <= 1024):
        raise ValueError("gas/sp out of range")
    if env.calldatasize != len(calldata) or len(calldata) >= (1 << 15):
        raise ValueError("calldata size mismatch")
    if env.address >= 1 << 160 or env.caller >= 1 << 160:
        raise ValueError("address publics exceed 160 bits")
    if len(kcalls) > MAX_KECCAK_CALLS:
        raise ValueError("too many keccak calls")
    if not (0 <= fid < MAX_FRAMES_PER_TREE) or is_callee not in (0, 1):
        raise ValueError("bad frame role")
    if not (0 <= rds < (1 << 13)) or hasret not in (0, 1):
        raise ValueError("bad returndata statement")
    if hasret and (is_callee == 0 or rds == 0):
        raise ValueError("returndata bridge without a callee returndata")
    static = int(rec.get("static", 0))
    reverted = int(rec.get("reverted", 0))
    code_addr = int(rec.get("code_addr", hex(env.address)), 16)
    if static not in (0, 1) or reverted not in (0, 1):
        raise ValueError("bad static/reverted flags")
    if not (0 <= code_addr < (1 << 160)):
        raise ValueError("code address exceeds 160 bits")
    if reverted and is_callee == 0:
        raise ValueError("the root frame cannot be reverted")
    cpu_pub = frame_publics(
        env, gas0, gas_f, sp_f, fid=fid, is_callee=is_callee, cid=cid,
        rds=rds, hasret=hasret, static=static, reverted=reverted,
        code_addr=code_addr,
    )
    airs = [
        EvmCpuAir(fid),
        EvmProgramAir(code, fid),
        EvmStackAir(n_acc, fid),
        EvmCalldataAir(calldata, fid),
        MemRamAir(n_mem, fid),
    ]
    pubs = [cpu_pub, [fid], [fid], [fid], [fid]]
    if sgroups:
        from .evm_storage import EvmStorageAir

        airs.append(EvmStorageAir(sgroups, fid))
        pubs.append([fid])
    if kcalls:
        from .evm_keccak import EvmKeccakCallAir, EvmSpongeAir

        bridge = EvmKeccakCallAir(kcalls, fid)
        airs.append(bridge)
        pubs.append([fid])
        airs.append(
            EvmSpongeAir(
                bridge.block_counts(),
                msg_id_offset=fid * MAX_KECCAK_CALLS,
            )
        )
        pubs.append([])
    if ar_kinds:
        from .evm_arith import ArithAir

        airs.append(ArithAir(ar_kinds, fid))
        pubs.append([fid])
    if cp_calls:
        from .evm_copy import EvmCopyAir

        airs.append(EvmCopyAir(cp_calls, env.calldatasize, fid))
        pubs.append([fid])
    if cc_calls:
        from .evm_copy import CodeCopyAir

        airs.append(CodeCopyAir(cc_calls, code, fid))
        pubs.append([fid])
    return airs, pubs


def frame_group_airs(payload: dict, with_proofs: bool = True):
    """Rebuild a call-tree payload's (airs, publics, proofs) from the
    PUBLIC statement; None on structural mismatch.  Shared by
    verify_frame_payload and the recursion seal (provers/seal.py);
    ``with_proofs=False`` rebuilds the statement alone (proofs None) for
    stripped payload descriptors."""
    from ..serde import proof_from_dict

    if payload.get("kind") != "evm-call-tree-v1":
        return None
    try:
        frames = payload["frames"]
        if not frames or len(frames) > MAX_FRAMES_PER_TREE:
            return None
        fids = [int(rec.get("fid", 0)) for rec in frames]
        if len(set(fids)) != len(fids):
            return None
        # the root frame is not a callee; every other frame must be one
        # (floating frames rejected; the CALLREQ/CALLRET bus balance then
        # enforces the tree linkage — callee publics equal what the
        # caller's CALL row sent, gas returns match, data bridges anchor)
        if int(frames[0].get("is_callee", 0)) != 0:
            return None
        if any(int(rec.get("is_callee", 0)) != 1 for rec in frames[1:]):
            return None
        by_fid = {int(rec.get("fid", 0)): rec for rec in frames}
        airs = []
        pubs = []
        for rec in frames:
            a, p = _frame_airs_from_record(rec)
            airs.extend(a)
            pubs.extend(p)
            a2, p2 = _frame_extra_airs_from_record(rec, by_fid)
            airs.extend(a2)
            pubs.extend(p2)
        # tree-level balance journal: the PUBLIC (addr, orig, final,
        # count) groups; omitting it while any CPU sent a BUS_BL tuple
        # leaves the bus unbalanced, so presence is forced by content
        if payload.get("balances"):
            from .evm_call import EvmBalanceAir

            groups = [
                (int(a, 16), int(o, 16), int(f, 16), int(c))
                for a, o, f, c in payload["balances"]
            ]
            bal = EvmBalanceAir(groups)
            airs.append(bal)
            pubs.append(bal.publics())
        if not with_proofs:
            return airs, pubs, None
        starks = payload["starks"]
        if len(starks) != len(airs):
            return None
        proofs = [proof_from_dict(d) for d in starks]
    except (KeyError, ValueError, TypeError, AssertionError):
        return None
    for air, proof in zip(airs, proofs):
        if hasattr(air, "num_perms"):  # the sponge sizes by permutations
            from .keccak_air import ROWS

            if (1 << proof.log_n) != ROWS * air.num_perms:
                return None
        elif hasattr(air, "n"):
            if (1 << proof.log_n) != air.n:
                return None
    return airs, pubs, proofs


def verify_frame_payload(payload: dict, device) -> bool:
    """Rebuild every frame's AIR instances from the PUBLIC call-tree
    statement and verify the single multi-table STARK.  Cross-frame
    consistency (CALLREQ/CALLRET linkage) is enforced by the global bus
    balance, not by host-side equality checks."""
    from .. import verifier as sv

    grp = frame_group_airs(payload)
    if grp is None:
        return False
    airs, pubs, proofs = grp
    for proof, expect_pub in zip(proofs, pubs):
        if proof.publics != expect_pub:
            return False
    return sv.verify_tables(airs, proofs, device)
