"""secp256k1 ECDSA: recover + sign (pure Python host implementation).

Role: transaction sender recovery during block re-execution (reference
lib/src/builder.rs:108-110, patched secp256k1 crate) and the TEE-style
prover's signing step (provers/sgx/guest/src/signature.rs:10-60).  Bulk
recovery on the card goes through ``ops/secp.py`` (kernel B4); this module
is the exact reference and the host path.
"""

from __future__ import annotations

import hmac
import hashlib

from .native import keccak256

P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
G = (GX, GY)


def _inv(a: int, m: int = P) -> int:
    return pow(a, -1, m)


def _add(a, b):
    if a is None:
        return b
    if b is None:
        return a
    if a[0] == b[0]:
        if (a[1] + b[1]) % P == 0:
            return None
        lam = 3 * a[0] * a[0] * _inv(2 * a[1]) % P
    else:
        lam = (b[1] - a[1]) * _inv(b[0] - a[0]) % P
    x = (lam * lam - a[0] - b[0]) % P
    return (x, (lam * (a[0] - x) - a[1]) % P)


def _mul(pt, k: int):
    k %= N
    result = None
    while k:
        if k & 1:
            result = _add(result, pt)
        pt = _add(pt, pt)
        k >>= 1
    return result


def _mul2(p1, k1: int, p2, k2: int):
    """k1*p1 + k2*p2 (Shamir's trick)."""
    both = _add(p1, p2)
    result = None
    for i in range(max(k1.bit_length(), k2.bit_length()) - 1, -1, -1):
        result = _add(result, result)
        b1 = (k1 >> i) & 1
        b2 = (k2 >> i) & 1
        if b1 and b2:
            result = _add(result, both)
        elif b1:
            result = _add(result, p1)
        elif b2:
            result = _add(result, p2)
    return result


def recover_pubkey(msg_hash: bytes, r: int, s: int, rec_id: int):
    """Recover the public key point, or None if invalid.

    rec_id: 0/1 (y parity), 2/3 adds N to r (astronomically rare)."""
    if not (1 <= r < N and 1 <= s < N) or rec_id not in (0, 1, 2, 3):
        return None
    x = r + (N if rec_id >= 2 else 0)
    if x >= P:
        return None
    y2 = (pow(x, 3, P) + 7) % P
    y = pow(y2, (P + 1) // 4, P)
    if y * y % P != y2:
        return None
    if (y & 1) != (rec_id & 1):
        y = P - y
    e = int.from_bytes(msg_hash, "big") % N
    r_inv = pow(r, -1, N)
    # Q = r^-1 (s*R - e*G)
    q = _mul2((x, y), s * r_inv % N, (GX, P - GY), e * r_inv % N)
    return q


def ecrecover(msg_hash: bytes, v: int, r: int, s: int) -> bytes | None:
    """EVM-style ecrecover: v in {27, 28} (or 0/1); returns 20-byte address."""
    rec_id = v - 27 if v >= 27 else v
    if rec_id not in (0, 1):
        return None
    q = recover_pubkey(msg_hash, r, s, rec_id)
    if q is None:
        return None
    pub = q[0].to_bytes(32, "big") + q[1].to_bytes(32, "big")
    return keccak256(pub)[12:]


def sign(msg_hash: bytes, secret: int) -> tuple[int, int, int]:
    """Deterministic ECDSA (RFC 6979, SHA-256).  Returns (r, s, rec_id)
    with low-s normalization (Ethereum convention)."""
    e = int.from_bytes(msg_hash, "big") % N
    k = _rfc6979_k(msg_hash, secret)
    pt = _mul(G, k)
    r = pt[0] % N
    assert r != 0
    s = _inv(k, N) * (e + r * secret) % N
    assert s != 0
    rec_id = (pt[1] & 1) ^ (1 if pt[0] >= N else 0)
    if s > N // 2:
        s = N - s
        rec_id ^= 1
    return r, s, rec_id


def pubkey(secret: int):
    return _mul(G, secret)


def pubkey_to_address(pt) -> bytes:
    pub = pt[0].to_bytes(32, "big") + pt[1].to_bytes(32, "big")
    return keccak256(pub)[12:]


def _rfc6979_k(msg_hash: bytes, secret: int) -> int:
    x = secret.to_bytes(32, "big")
    h1 = msg_hash
    v = b"\x01" * 32
    k = b"\x00" * 32
    k = hmac.new(k, v + b"\x00" + x + h1, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    k = hmac.new(k, v + b"\x01" + x + h1, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    while True:
        v = hmac.new(k, v, hashlib.sha256).digest()
        cand = int.from_bytes(v, "big")
        if 1 <= cand < N:
            return cand
        k = hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()
