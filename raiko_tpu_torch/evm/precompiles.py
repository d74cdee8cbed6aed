"""EVM precompiled contracts 0x01-0x0a (Cancun set).

Each entry returns (gas_cost, output_bytes | None); None output = precompile
error (consumes all gas).  The KZG point-evaluation precompile (0x0a) runs
through raiko_tpu.kzg — the same code path the proving side uses
(reference eip4844.rs tests cross-check through this precompile)."""

from __future__ import annotations

import hashlib

from ..utils import keccak256, secp256k1
from . import bn254

ADDRESSES = {bytes(19) + bytes([i]) for i in range(1, 11)}


def is_precompile(address: bytes) -> bool:
    return address in ADDRESSES


def run(address: bytes, data: bytes, gas: int) -> tuple[int, bytes | None]:
    """Execute precompile; returns (gas_used, output or None-on-error).
    If cost > gas the caller treats it as out-of-gas (gas_used = gas)."""
    idx = address[19]
    fn = _TABLE[idx]
    return fn(data, gas)


def _ecrecover(data: bytes, gas: int):
    cost = 3000
    if cost > gas:
        return gas, None
    d = data.ljust(128, b"\x00")[:128]
    h, v, r, s = d[:32], int.from_bytes(d[32:64], "big"), int.from_bytes(d[64:96], "big"), int.from_bytes(d[96:128], "big")
    if v not in (27, 28):
        return cost, b""
    addr = secp256k1.ecrecover(h, v, r, s)
    if addr is None:
        return cost, b""
    return cost, addr.rjust(32, b"\x00")


def _sha256(data: bytes, gas: int):
    cost = 60 + 12 * ((len(data) + 31) // 32)
    if cost > gas:
        return gas, None
    return cost, hashlib.sha256(data).digest()


def _ripemd160(data: bytes, gas: int):
    cost = 600 + 120 * ((len(data) + 31) // 32)
    if cost > gas:
        return gas, None
    return cost, hashlib.new("ripemd160", data).digest().rjust(32, b"\x00")


def _identity(data: bytes, gas: int):
    cost = 15 + 3 * ((len(data) + 31) // 32)
    if cost > gas:
        return gas, None
    return cost, data


def _modexp(data: bytes, gas: int):
    d = data
    bl = int.from_bytes(d[0:32].ljust(32, b"\x00"), "big")
    el = int.from_bytes(d[32:64].ljust(32, b"\x00"), "big")
    ml = int.from_bytes(d[64:96].ljust(32, b"\x00"), "big")
    if bl == 0 and ml == 0:
        cost = 200
        if cost > gas:
            return gas, None
        return cost, b""
    # EIP-2565 gas
    def words(x):
        return (x + 7) // 8

    mult = max(words(bl), words(ml)) ** 2
    body = d[96:]
    e_bytes = body[bl : bl + el].ljust(el, b"\x00") if el else b""
    e_head = int.from_bytes(e_bytes[:32], "big")
    if el <= 32:
        iter_count = max(e_head.bit_length() - 1, 0)
    else:
        iter_count = 8 * (el - 32) + max(e_head.bit_length() - 1, 0)
    iter_count = max(iter_count, 1)
    cost = max(200, mult * iter_count // 3)
    if cost > gas:
        return gas, None
    b = int.from_bytes(body[:bl].ljust(bl, b"\x00"), "big")
    e = int.from_bytes(e_bytes, "big")
    m = int.from_bytes(body[bl + el : bl + el + ml].ljust(ml, b"\x00"), "big")
    if m == 0:
        out = 0
    else:
        out = pow(b, e, m)
    return cost, out.to_bytes(ml, "big")


def _bn_add(data: bytes, gas: int):
    cost = 150
    if cost > gas:
        return gas, None
    d = data.ljust(128, b"\x00")[:128]
    try:
        p1 = _read_g1(d[:64])
        p2 = _read_g1(d[64:128])
    except ValueError:
        return gas, None
    return cost, _write_g1(bn254.g1_add(p1, p2))


def _bn_mul(data: bytes, gas: int):
    cost = 6000
    if cost > gas:
        return gas, None
    d = data.ljust(96, b"\x00")[:96]
    try:
        p = _read_g1(d[:64])
    except ValueError:
        return gas, None
    k = int.from_bytes(d[64:96], "big")
    return cost, _write_g1(bn254.g1_mul(p, k))


def _bn_pairing(data: bytes, gas: int):
    if len(data) % 192 != 0:
        return gas, None
    k = len(data) // 192
    cost = 45000 + 34000 * k
    if cost > gas:
        return gas, None
    pairs = []
    for i in range(k):
        chunk = data[192 * i : 192 * (i + 1)]
        try:
            p = _read_g1(chunk[:64])
        except ValueError:
            return gas, None
        # G2 encoding: x = a*u + b as (a_bytes, b_bytes) -> (b, a)
        xa = int.from_bytes(chunk[64:96], "big")
        xb = int.from_bytes(chunk[96:128], "big")
        ya = int.from_bytes(chunk[128:160], "big")
        yb = int.from_bytes(chunk[160:192], "big")
        if max(xa, xb, ya, yb) >= bn254.P:
            return gas, None
        if (xa, xb, ya, yb) == (0, 0, 0, 0):
            q = None
        else:
            q = ((xb, xa), (yb, ya))
            if not bn254.g2_in_subgroup(q):
                return gas, None
        pairs.append((p, q))
    ok = bn254.pairing_check([pq for pq in pairs if pq[0] is not None and pq[1] is not None])
    return cost, (1 if ok else 0).to_bytes(32, "big")


def _read_g1(d: bytes):
    x = int.from_bytes(d[:32], "big")
    y = int.from_bytes(d[32:64], "big")
    if x >= bn254.P or y >= bn254.P:
        raise ValueError("coordinate out of range")
    if x == 0 and y == 0:
        return None
    pt = (x, y)
    if not bn254.g1_is_on_curve(pt):
        raise ValueError("not on curve")
    return pt


def _write_g1(pt) -> bytes:
    if pt is None:
        return bytes(64)
    return pt[0].to_bytes(32, "big") + pt[1].to_bytes(32, "big")


# -- blake2f (EIP-152) ------------------------------------------------------

_B2_IV = [
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B, 0xA54FF53A5F1D36F1,
    0x510E527FADE682D1, 0x9B05688C2B3E6C1F, 0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
]
_B2_SIGMA = [
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
]
_M64 = (1 << 64) - 1


def _rotr64(x, n):
    return ((x >> n) | (x << (64 - n))) & _M64


def _blake2f(data: bytes, gas: int):
    if len(data) != 213:
        return gas, None
    rounds = int.from_bytes(data[:4], "big")
    if data[212] not in (0, 1):
        return gas, None
    cost = rounds
    if cost > gas:
        return gas, None
    h = [int.from_bytes(data[4 + 8 * i : 12 + 8 * i], "little") for i in range(8)]
    m = [int.from_bytes(data[68 + 8 * i : 76 + 8 * i], "little") for i in range(16)]
    t0 = int.from_bytes(data[196:204], "little")
    t1 = int.from_bytes(data[204:212], "little")
    final = data[212] == 1
    v = h[:] + _B2_IV[:]
    v[12] ^= t0
    v[13] ^= t1
    if final:
        v[14] ^= _M64

    def g(a, b, c, d, x, y):
        v[a] = (v[a] + v[b] + x) & _M64
        v[d] = _rotr64(v[d] ^ v[a], 32)
        v[c] = (v[c] + v[d]) & _M64
        v[b] = _rotr64(v[b] ^ v[c], 24)
        v[a] = (v[a] + v[b] + y) & _M64
        v[d] = _rotr64(v[d] ^ v[a], 16)
        v[c] = (v[c] + v[d]) & _M64
        v[b] = _rotr64(v[b] ^ v[c], 63)

    for r in range(rounds):
        s = _B2_SIGMA[r % 10]
        g(0, 4, 8, 12, m[s[0]], m[s[1]])
        g(1, 5, 9, 13, m[s[2]], m[s[3]])
        g(2, 6, 10, 14, m[s[4]], m[s[5]])
        g(3, 7, 11, 15, m[s[6]], m[s[7]])
        g(0, 5, 10, 15, m[s[8]], m[s[9]])
        g(1, 6, 11, 12, m[s[10]], m[s[11]])
        g(2, 7, 8, 13, m[s[12]], m[s[13]])
        g(3, 4, 9, 14, m[s[14]], m[s[15]])
    out = b"".join(
        ((h[i] ^ v[i] ^ v[i + 8]) & _M64).to_bytes(8, "little") for i in range(8)
    )
    return cost, out


def _point_evaluation(data: bytes, gas: int):
    cost = 50000
    if cost > gas:
        return gas, None
    from ..kzg import eip4844

    out = eip4844.point_evaluation_precompile(data)
    if out is None:
        return gas, None
    return cost, out


_TABLE = {
    1: _ecrecover,
    2: _sha256,
    3: _ripemd160,
    4: _identity,
    5: _modexp,
    6: _bn_add,
    7: _bn_mul,
    8: _bn_pairing,
    9: _blake2f,
    10: _point_evaluation,
}
