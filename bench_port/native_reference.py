"""The plain reference of a served ``native`` request: its instance hash
and its KZG proof, worked out from what the chain posted.

Nothing here imports the port.  The BLS12-381 arithmetic, the blob's
field elements, the evaluation point and the barycentric evaluation are
frozen copies of ``raiko_tpu_torch/kzg/host_curve.py`` and
``kzg/eip4844.py`` (the host path, in Python integers); the trusted setup
is its own copy in ``data/``; Keccak-256 is the frozen verifier's plain
Python copy.  The roots of unity are worked out from EIP-4844's primitive
root; the setup's G1 points, a copy of the program's table, are held to
the published generator (``setup_faults``).  The ABI encoding of the instance is written out by hand from
the reference raiko's ``LibPublicInput`` (lib/src/protocol_instance.rs).

What it reads of the chain: the block's transactions as posted in the
blob, the ``BlockProposed`` event's data as the L1 contract logged it
(its metadata is hashed as posted), and the L2 header's parent hash,
block hash and state root as the chain simulator produced them.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

from frozen_verifier.utils.keccak_py import keccak256

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
N = 4096
BYTES_PER_BLOB = 32 * N
META_WORDS = 14  # BlockMetadata: a static tuple of 14 words
SETUP = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "trusted_setup.npz")
PRIMITIVE_ROOT = 7  # EIP-4844's PRIMITIVE_ROOT_OF_UNITY
# BLS12-381's G1 generator, as the curve's standard publishes it
G1_GENERATOR = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)


def roots_of_unity() -> list[int]:
    """The N-th roots of unity in natural order, from the spec's primitive root."""
    w = pow(PRIMITIVE_ROOT, (R - 1) // N, R)
    out = [1] * N
    for i in range(1, N):
        out[i] = out[i - 1] * w % R
    return out


def load_setup() -> tuple[list, list]:
    """(G1 Lagrange points, roots of unity), both in bit-reversed order."""
    with np.load(SETUP) as z:
        g1_arr = z["g1_lagrange"]
    g1 = [(int.from_bytes(bytes(g1_arr[i, 0]), "big"), int.from_bytes(bytes(g1_arr[i, 1]), "big"))
          for i in range(N)]
    roots = roots_of_unity()
    brp = [int(format(i, "012b")[::-1], 2) for i in range(N)]
    return g1, [roots[brp[i]] for i in range(N)]


def setup_faults(setup) -> int:
    """1 unless the G1 Lagrange points add up to the generator, as the
    Lagrange basis of any honest setup does (the basis sums to 1), else 0.
    One altered point breaks the sum."""
    total = None
    for pt in setup[0]:
        total = g1_add(total, pt)
    return int(total != G1_GENERATOR)


def g1_add(a, b):
    """Affine addition on BLS12-381 G1 (None is the point at infinity)."""
    if a is None:
        return b
    if b is None:
        return a
    if a[0] == b[0]:
        if (a[1] + b[1]) % P == 0:
            return None
        lam = 3 * a[0] * a[0] * pow(2 * a[1], -1, P) % P
    else:
        lam = (b[1] - a[1]) * pow(b[0] - a[0], -1, P) % P
    x3 = (lam * lam - a[0] - b[0]) % P
    return (x3, (lam * (a[0] - x3) - a[1]) % P)


def g1_msm(points, scalars):
    """Pippenger's sum of scalars_i · points_i, windows of 8 bits."""
    c = 8
    result = None
    for w in reversed(range((256 + c - 1) // c)):
        if result is not None:
            for _ in range(c):
                result = g1_add(result, result)
        buckets: dict = {}
        for pt, s in zip(points, scalars):
            digit = (s >> (c * w)) & ((1 << c) - 1)
            if digit:
                buckets[digit] = g1_add(buckets.get(digit), pt)
        running = acc = None
        for b in range(max(buckets, default=0), 0, -1):
            running = g1_add(running, buckets.get(b))
            acc = g1_add(acc, running)
        result = g1_add(result, acc)
    return result


def g1_compress(pt) -> bytes:
    if pt is None:
        return bytes([0xC0] + [0] * 47)
    x, y = pt
    b = bytearray(x.to_bytes(48, "big"))
    b[0] |= 0x80 | (0x20 if y > (P - 1) // 2 else 0)
    return bytes(b)


def field_elements(blob: bytes) -> list[int]:
    if len(blob) != BYTES_PER_BLOB:
        raise ValueError(f"a blob has {BYTES_PER_BLOB} bytes, not {len(blob)}")
    out = [int.from_bytes(blob[32 * i: 32 * i + 32], "big") for i in range(N)]
    if any(v >= R for v in out):
        raise ValueError("a blob element is not below the field's modulus")
    return out


def evaluation_point(blob: bytes, versioned_hash: bytes) -> int:
    """z = sha256(sha256(blob) ‖ versioned hash) mod r."""
    return int.from_bytes(hashlib.sha256(hashlib.sha256(blob).digest() + versioned_hash).digest(), "big") % R


def _batch_inverse(vals: list[int]) -> list[int]:
    prefix = [1] * (len(vals) + 1)
    for i, v in enumerate(vals):
        prefix[i + 1] = prefix[i] * v % R
    inv_all = pow(prefix[-1], -1, R)
    out = [0] * len(vals)
    for i in range(len(vals) - 1, -1, -1):
        out[i] = prefix[i] * inv_all % R
        inv_all = inv_all * vals[i] % R
    return out


def evaluate(fields: list[int], roots: list[int], z: int) -> int:
    """The blob polynomial at z, from its values on the roots (barycentric)."""
    if z in roots:
        return fields[roots.index(z)]
    inv = _batch_inverse([(z - w) % R for w in roots])
    total = 0
    for f, w, iv in zip(fields, roots, inv):
        total = (total + f * w % R * iv) % R
    return total * (pow(z, N, R) - 1) % R * pow(N, -1, R) % R


def kzg_proof(blob: bytes, versioned_hash: bytes, setup) -> bytes:
    """The KZG opening proof of the blob at its evaluation point: the
    commitment to (f(X) - f(z)) / (X - z), compressed."""
    g1, roots = setup
    fields = field_elements(blob)
    z = evaluation_point(blob, versioned_hash)
    y = evaluate(fields, roots, z)
    if z in roots:
        raise ValueError("the evaluation point is a root of unity")  # chance 2^-243
    inv = _batch_inverse([(w - z) % R for w in roots])
    q = [(f - y) * iv % R for f, iv in zip(fields, inv)]
    return g1_compress(g1_msm(g1, q))


def proof_of_equivalence(blob: bytes, versioned_hash: bytes, setup) -> tuple[int, int]:
    """(z, y) as the instance carries them: each 32-byte big-endian value
    read as a little-endian integer."""
    z = evaluation_point(blob, versioned_hash)
    y = evaluate(field_elements(blob), setup[1], z)
    return int.from_bytes(z.to_bytes(32, "big"), "little"), int.from_bytes(y.to_bytes(32, "big"), "little")


def meta_abi(event_data: bytes) -> bytes:
    """The BlockMetadata words of a BlockProposed event's data (uint96 bond,
    then the static metadata tuple inline, then the deposits' offset)."""
    return bytes(event_data[32: 32 + 32 * META_WORDS])


def blob_hash(event_data: bytes) -> bytes:
    """The metadata's blobHash, its third word."""
    meta = meta_abi(event_data)
    return meta[64:96]


def _word(v) -> bytes:
    if isinstance(v, (bytes, bytearray)):
        return bytes(v).rjust(32, b"\x00")
    return int(v).to_bytes(32, "big")


def instance_hash(chain_id: int, verifier: bytes, parent_hash: bytes, block_hash: bytes, state_root: bytes,
                  graffiti: bytes, prover: bytes, event_data: bytes, poe: tuple[int, int]) -> bytes:
    """keccak(abi.encode("VERIFY_PROOF", chainId, verifier, transition,
    sgxInstance = 0, prover, metaHash, (poe.x, poe.y))): twelve head words,
    the first the offset of the string, then the string's length and
    bytes."""
    tag = b"VERIFY_PROOF"
    head = [12 * 32, chain_id, verifier, parent_hash, block_hash, state_root, graffiti,
            b"\x00" * 20, prover, keccak256(meta_abi(event_data)), poe[0], poe[1]]
    tail = _word(len(tag)) + tag.ljust(32, b"\x00")
    return keccak256(b"".join(_word(v) for v in head) + tail)
