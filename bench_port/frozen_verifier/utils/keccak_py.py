"""Keccak-256 (legacy 0x01 padding) in pure Python: the plain host version.

Role in the framework: Ethereum hashes everything with Keccak-256 — MPT node
references, block/tx hashes, the on-chain protocol-instance hash (reference:
lib/src/primitives/keccak.rs:34-38, lib/src/primitives/mpt.rs:117-121).  The
card batches thousands of node hashes through the CUDA kernel in
``ops/keccak.py`` and the host hashes through the C library of
``utils/native.py`` (csrc/keccak256_host.cpp); this module is the plain
Python version, the oracle of the tests, and what a few AIR trace builders
call directly.

All Keccak constants (round constants, rho rotation offsets) are *derived*
from the FIPS-202 specification at import time rather than transcribed, so a
typo cannot silently corrupt them.
"""

from __future__ import annotations

MASK64 = (1 << 64) - 1


def _derive_round_constants() -> list[int]:
    # FIPS-202 §3.2.5: rc(t) from LFSR x^8 + x^6 + x^5 + x^4 + 1.
    def rc_bit(t: int) -> int:
        if t % 255 == 0:
            return 1
        r = 1
        for _ in range(t % 255):
            r <<= 1
            if r & 0x100:
                r ^= 0x171
        return r & 1

    rcs = []
    for ir in range(24):
        rc = 0
        for j in range(7):
            if rc_bit(j + 7 * ir):
                rc |= 1 << ((1 << j) - 1)
        rcs.append(rc)
    return rcs


def _derive_rho_offsets() -> list[list[int]]:
    # FIPS-202 §3.2.2: offsets (t+1)(t+2)/2 walking (x,y) -> (y, 2x+3y).
    offs = [[0] * 5 for _ in range(5)]
    x, y = 1, 0
    for t in range(24):
        offs[x][y] = ((t + 1) * (t + 2) // 2) % 64
        x, y = y, (2 * x + 3 * y) % 5
    return offs


ROUND_CONSTANTS: list[int] = _derive_round_constants()
RHO_OFFSETS: list[list[int]] = _derive_rho_offsets()


def _rotl64(v: int, n: int) -> int:
    n %= 64
    return ((v << n) | (v >> (64 - n))) & MASK64


def keccak_f1600(state: list[int]) -> list[int]:
    """One Keccak-f[1600] permutation. ``state`` is 25 u64 lanes, A[x][y] at
    index x + 5*y."""
    a = list(state)
    for rc in ROUND_CONSTANTS:
        # theta
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl64(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x + 5 * y] ^= d[x]
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl64(
                    a[x + 5 * y], RHO_OFFSETS[x][y]
                )
        # chi
        for x in range(5):
            for y in range(5):
                a[x + 5 * y] = b[x + 5 * y] ^ (
                    (~b[(x + 1) % 5 + 5 * y] & MASK64) & b[(x + 2) % 5 + 5 * y]
                )
        # iota
        a[0] ^= rc
    return a


def keccak256(data: bytes) -> bytes:
    """Keccak-256 of ``data`` (pre-SHA3 0x01 padding, as used by Ethereum)."""
    rate = 136  # 1088-bit rate for 256-bit output
    state = [0] * 25
    # pad10*1 with 0x01 domain bit
    padded = bytearray(data)
    pad_len = rate - (len(padded) % rate)
    padded += b"\x01" + b"\x00" * (pad_len - 2) + b"\x80" if pad_len >= 2 else b"\x81"
    for off in range(0, len(padded), rate):
        block = padded[off : off + rate]
        for i in range(rate // 8):
            state[i] ^= int.from_bytes(block[8 * i : 8 * i + 8], "little")
        state = keccak_f1600(state)
    out = b"".join(state[i].to_bytes(8, "little") for i in range(4))
    return out


KECCAK_EMPTY = bytes.fromhex(
    "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"
)
