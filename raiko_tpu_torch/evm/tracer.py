"""Per-transaction EVM execution tracing (geth structLog style).

TPU-native parity item for the reference's optional execution-trace
feature, which dumps per-tx JSON traces to ``traces/`` during block
re-execution (raiko README "Execution Trace" section; SURVEY.md §5
tracing/profiling).  Enable by passing ``trace_dir`` to
``execute_block_txs`` or setting ``RAIKO_TRACE_DIR``; each transaction
writes ``<dir>/<block>-<txidx>.json`` with the familiar geth shape:

    {"txHash": ..., "gas": N, "failed": bool, "returnValue": hex,
     "structLogs": [{"pc", "op", "gas", "depth", "stack"}, ...]}

Tracing is strictly opt-in: the interpreter's hot loop pays one ``is
not None`` check per step when disabled.
"""

from __future__ import annotations

import json
import os

_NAMES = {
    0x00: "STOP", 0x01: "ADD", 0x02: "MUL", 0x03: "SUB", 0x04: "DIV",
    0x05: "SDIV", 0x06: "MOD", 0x07: "SMOD", 0x08: "ADDMOD",
    0x09: "MULMOD", 0x0A: "EXP", 0x0B: "SIGNEXTEND",
    0x10: "LT", 0x11: "GT", 0x12: "SLT", 0x13: "SGT", 0x14: "EQ",
    0x15: "ISZERO", 0x16: "AND", 0x17: "OR", 0x18: "XOR", 0x19: "NOT",
    0x1A: "BYTE", 0x1B: "SHL", 0x1C: "SHR", 0x1D: "SAR",
    0x20: "KECCAK256",
    0x30: "ADDRESS", 0x31: "BALANCE", 0x32: "ORIGIN", 0x33: "CALLER",
    0x34: "CALLVALUE", 0x35: "CALLDATALOAD", 0x36: "CALLDATASIZE",
    0x37: "CALLDATACOPY", 0x38: "CODESIZE", 0x39: "CODECOPY",
    0x3A: "GASPRICE", 0x3B: "EXTCODESIZE", 0x3C: "EXTCODECOPY",
    0x3D: "RETURNDATASIZE", 0x3E: "RETURNDATACOPY", 0x3F: "EXTCODEHASH",
    0x40: "BLOCKHASH", 0x41: "COINBASE", 0x42: "TIMESTAMP", 0x43: "NUMBER",
    0x44: "PREVRANDAO", 0x45: "GASLIMIT", 0x46: "CHAINID",
    0x47: "SELFBALANCE", 0x48: "BASEFEE", 0x49: "BLOBHASH",
    0x4A: "BLOBBASEFEE",
    0x50: "POP", 0x51: "MLOAD", 0x52: "MSTORE", 0x53: "MSTORE8",
    0x54: "SLOAD", 0x55: "SSTORE", 0x56: "JUMP", 0x57: "JUMPI",
    0x58: "PC", 0x59: "MSIZE", 0x5A: "GAS", 0x5B: "JUMPDEST",
    0x5C: "TLOAD", 0x5D: "TSTORE", 0x5E: "MCOPY", 0x5F: "PUSH0",
    0xF0: "CREATE", 0xF1: "CALL", 0xF2: "CALLCODE", 0xF3: "RETURN",
    0xF4: "DELEGATECALL", 0xF5: "CREATE2", 0xFA: "STATICCALL",
    0xFD: "REVERT", 0xFE: "INVALID", 0xFF: "SELFDESTRUCT",
}
for _i in range(32):
    _NAMES[0x60 + _i] = f"PUSH{_i + 1}"
for _i in range(16):
    _NAMES[0x80 + _i] = f"DUP{_i + 1}"
    _NAMES[0x90 + _i] = f"SWAP{_i + 1}"
for _i in range(5):
    _NAMES[0xA0 + _i] = f"LOG{_i}"


def op_name(op: int) -> str:
    return _NAMES.get(op, f"opcode 0x{op:02x}")


class StructTracer:
    """Collects one structLog entry per interpreter step.

    ``max_stack`` bounds the recorded stack tail (top last, geth order);
    gasCost is derived post-hoc per frame as the gas delta to the frame's
    next step (call-family rows therefore include the child frame's
    consumption, matching the reference's flat trace view)."""

    def __init__(self, max_stack: int = 16):
        self.max_stack = max_stack
        self.logs: list[dict] = []

    def step(self, pc: int, op: int, gas: int, depth: int, stack: list[int]):
        tail = stack[-self.max_stack :] if self.max_stack else []
        self.logs.append(
            {
                "pc": pc,
                "op": op_name(op),
                "gas": gas,
                "depth": depth,
                "stack": [hex(v) for v in tail],
            }
        )

    def finish(self, tx_hash: bytes, gas_used: int, failed: bool, output: bytes) -> dict:
        # per-step cost = delta to the next step AT ANY depth (flat view)
        for a, b in zip(self.logs, self.logs[1:]):
            a["gasCost"] = max(a["gas"] - b["gas"], 0) if a["depth"] <= b["depth"] else a["gas"] - b["gas"]
        if self.logs:
            self.logs[-1]["gasCost"] = 0
        return {
            "txHash": "0x" + tx_hash.hex(),
            "gas": gas_used,
            "failed": failed,
            "returnValue": output.hex(),
            "structLogs": self.logs,
        }


def write_trace(trace_dir: str, block_number: int, tx_index: int, doc: dict) -> str:
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"{block_number}-{tx_index}.json")
    with open(path, "w") as f:
        json.dump(doc, f)
    return path
