"""EIP-4844 blob / KZG commitment path.

Behavioral parity with reference lib/src/primitives/eip4844.rs (which wraps
rust-kzg-zkcrypto, itself c-kzg-compatible):

- ``blob_to_kzg_commitment``   (ref :80-89)  — 4096-point MSM on TPU
- ``get_evaluation_point``     (ref :44-48)  — x = sha256(sha256(blob) ‖ vh)
- ``proof_of_equivalence``     (ref :50-65)  — (x, y) barycentric evaluation
- ``calc_kzg_proof[_with_point]`` (ref :67-78) — quotient-poly MSM
- ``commitment_to_version_hash``  (ref :91-95)
- ``verify_kzg_proof``         — pairing check (verifier side, host)
- ``point_evaluation_precompile`` — the EVM precompile semantics used by the
  reference tests (eip4844.rs:111-133)

Blob semantics follow the consensus spec exactly: 4096 x 32-byte big-endian
field elements, each < BLS_MODULUS; the element order corresponds to the
bit-reversal-permuted roots of unity (matching the embedded Lagrange-form
trusted setup, extracted + validated by tools/extract_kzg_setup.py).

The MSMs run on the torch device the caller names (``device``), through
the port's Pippenger MSM (ops/msm.py) and its CUDA kernels on a card, or
on the host reference path (``host_curve.g1_msm``) when ``device`` is None.
"""

from __future__ import annotations

import functools
import hashlib
import os

import numpy as np
import torch

from ..ops import msm as msmmod
from . import curve
from . import host_curve as hc

BYTES_PER_FIELD_ELEMENT = 32
FIELD_ELEMENTS_PER_BLOB = 4096
BYTES_PER_BLOB = BYTES_PER_FIELD_ELEMENT * FIELD_ELEMENTS_PER_BLOB
BLS_MODULUS = hc.R
VERSIONED_HASH_VERSION_KZG = 0x01
# fflonk-style precompile return value:
FIELD_ELEMENTS_PER_BLOB_BYTES = FIELD_ELEMENTS_PER_BLOB.to_bytes(32, "big")
BLS_MODULUS_BYTES = BLS_MODULUS.to_bytes(32, "big")


class Eip4844Error(ValueError):
    pass


@functools.lru_cache(maxsize=1)
def setup():
    """Load the extracted trusted setup.

    Returns dict with:
      g1_lagrange: list of 4096 affine int pairs (brp order)
      g2_monomial: list of 65 affine Fp2 pairs
      roots_brp:   np.uint64-free list of 4096 ints, roots in brp order
    """
    path = os.path.join(os.path.dirname(__file__), "data", "trusted_setup.npz")
    with np.load(path) as z:  # each array read once: z[name] reads it anew
        g1_arr, g2_arr, roots_arr = z["g1_lagrange"], z["g2_monomial"], z["roots_natural"]
    g1 = [
        (
            int.from_bytes(bytes(g1_arr[i, 0]), "big"),
            int.from_bytes(bytes(g1_arr[i, 1]), "big"),
        )
        for i in range(4096)
    ]
    g2 = [
        (
            (
                int.from_bytes(bytes(g2_arr[i, 0, 0]), "big"),
                int.from_bytes(bytes(g2_arr[i, 0, 1]), "big"),
            ),
            (
                int.from_bytes(bytes(g2_arr[i, 1, 0]), "big"),
                int.from_bytes(bytes(g2_arr[i, 1, 1]), "big"),
            ),
        )
        for i in range(65)
    ]
    roots_nat = [
        int.from_bytes(bytes(roots_arr[i]), "big") for i in range(4096)
    ]
    roots_brp = [roots_nat[_brp(i)] for i in range(4096)]
    return {"g1_lagrange": g1, "g2_monomial": g2, "roots_brp": roots_brp}


def _brp(i: int, bits: int = 12) -> int:
    return int(format(i, f"0{bits}b")[::-1], 2)


@functools.lru_cache(maxsize=None)
def _device_setup(device: torch.device) -> torch.Tensor:
    """Trusted-setup G1 points on `device`, (4096, 3, 24) int64 Montgomery,
    built once per device."""
    pts = curve.points_from_affine(setup()["g1_lagrange"])
    return torch.as_tensor(pts.astype(np.int64), device=device)


def _limbs(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(arr.astype(np.int64), device=device)


def blob_to_field_elements(blob: bytes) -> list[int]:
    """Deserialize + validate a blob (ref deserialize_blob_rust)."""
    if len(blob) != BYTES_PER_BLOB:
        raise Eip4844Error(f"blob must be {BYTES_PER_BLOB} bytes, got {len(blob)}")
    out = []
    for i in range(FIELD_ELEMENTS_PER_BLOB):
        v = int.from_bytes(blob[32 * i : 32 * i + 32], "big")
        if v >= BLS_MODULUS:
            raise Eip4844Error(f"field element {i} out of range")
        out.append(v)
    return out


_MOD_WORDS = np.frombuffer(BLS_MODULUS.to_bytes(32, "big"), dtype=">u8").astype(
    np.uint64
)


def blob_to_limbs(blob: bytes) -> np.ndarray:
    """Blob bytes -> validated (4096, 16) u32 16-bit-limb scalars, fully
    vectorized (the int round-trip costs ~100 ms/blob, comparable to the
    whole device MSM)."""
    if len(blob) != BYTES_PER_BLOB:
        raise Eip4844Error(f"blob must be {BYTES_PER_BLOB} bytes, got {len(blob)}")
    words = np.frombuffer(blob, dtype=">u8").reshape(FIELD_ELEMENTS_PER_BLOB, 4)
    words = words.astype(np.uint64)
    # lexicographic v < modulus over 4 big-endian u64 words
    lt = np.zeros(FIELD_ELEMENTS_PER_BLOB, dtype=bool)
    eq = np.ones(FIELD_ELEMENTS_PER_BLOB, dtype=bool)
    for j in range(4):
        lt |= eq & (words[:, j] < _MOD_WORDS[j])
        eq &= words[:, j] == _MOD_WORDS[j]
    if not lt.all():
        bad = int(np.nonzero(~lt)[0][0])
        raise Eip4844Error(f"field element {bad} out of range")
    limbs_be = np.frombuffer(blob, dtype=">u2").reshape(FIELD_ELEMENTS_PER_BLOB, 16)
    return limbs_be[:, ::-1].astype(np.uint32)


def _msm(scalars: list[int], device) -> tuple[int, int] | None:
    """Σ scalars_i · setup_i as an affine point (None = infinity), on
    `device` (None: the host MSM)."""
    if device is None:
        return hc.g1_msm(setup()["g1_lagrange"], scalars)
    res = msmmod.msm(_device_setup(device), _limbs(msmmod.scalars_to_limbs(scalars), device))
    return curve.to_affine(res)


def blob_to_kzg_commitment(blob: bytes, device) -> bytes:
    """48-byte compressed commitment (ref calc_kzg_proof_commitment :80-89),
    its MSM on `device` (None: the host)."""
    if device is None:
        return hc.g1_compress(_msm(blob_to_field_elements(blob), None))
    res = msmmod.msm(_device_setup(device), _limbs(blob_to_limbs(blob), device))
    return hc.g1_compress(curve.to_affine(res))


def blobs_to_kzg_commitments(blobs: list[bytes], device) -> list[bytes]:
    """Commitments for several blobs in ONE batched MSM (ops/msm.msm_multi):
    all EIP-4844 MSMs share the trusted-setup points, so B blobs become one
    (B, 4096)-scalar batch, amortizing the fixed per-launch cost that
    dominates a lone 4096-point MSM.  None: one host MSM per blob."""
    if not blobs:
        return []
    if device is None:
        pts = setup()["g1_lagrange"]
        return [hc.g1_compress(hc.g1_msm(pts, blob_to_field_elements(b))) for b in blobs]
    limbs = np.stack([blob_to_limbs(b) for b in blobs])
    res = msmmod.msm_multi(_device_setup(device), _limbs(limbs, device)).cpu()
    return [hc.g1_compress(curve.to_affine(res[i])) for i in range(len(blobs))]


def commitment_to_version_hash(commitment: bytes) -> bytes:
    h = bytearray(hashlib.sha256(commitment).digest())
    h[0] = VERSIONED_HASH_VERSION_KZG
    return bytes(h)


def hash_to_bls_field(data32: bytes) -> int:
    """Interpret 32 bytes as BE integer mod r (c-kzg hash_to_bls_field)."""
    return int.from_bytes(data32, "big") % BLS_MODULUS


def get_evaluation_point(blob: bytes, versioned_hash: bytes) -> int:
    """x = hash_to_bls_field(sha256(sha256(blob) ‖ versioned_hash))
    (ref :44-48)."""
    blob_hash = hashlib.sha256(blob).digest()
    return hash_to_bls_field(hashlib.sha256(blob_hash + versioned_hash).digest())


def evaluate_polynomial_in_evaluation_form(fields: list[int], z: int) -> int:
    """Barycentric evaluation at z of the polynomial given by its
    evaluations over the brp-ordered roots (consensus-spec semantics)."""
    r = BLS_MODULUS
    roots = setup()["roots_brp"]
    for i, w in enumerate(roots):
        if z == w:
            return fields[i]
    # batch inversion of (z - w_i)
    diffs = [(z - w) % r for w in roots]
    inv = _batch_inverse(diffs, r)
    total = 0
    for f, w, iv in zip(fields, roots, inv):
        total = (total + f * w % r * iv) % r
    width_inv = pow(FIELD_ELEMENTS_PER_BLOB, -1, r)
    return total * (pow(z, FIELD_ELEMENTS_PER_BLOB, r) - 1) % r * width_inv % r


def _batch_inverse(vals: list[int], m: int) -> list[int]:
    prefix = [1] * (len(vals) + 1)
    for i, v in enumerate(vals):
        prefix[i + 1] = prefix[i] * v % m
    inv_all = pow(prefix[-1], -1, m)
    out = [0] * len(vals)
    for i in range(len(vals) - 1, -1, -1):
        out[i] = prefix[i] * inv_all % m
        inv_all = inv_all * vals[i] % m
    return out


def compute_kzg_proof(blob: bytes, z: int, device) -> tuple[bytes, int]:
    """KZG opening proof for the blob polynomial at point z, its MSM on
    `device` (None: the host).

    Returns (48-byte compressed proof, y).  Mirrors c-kzg
    compute_kzg_proof: quotient in evaluation form with the special-case
    row when z hits a domain point."""
    r = BLS_MODULUS
    fields = blob_to_field_elements(blob)
    roots = setup()["roots_brp"]
    y = evaluate_polynomial_in_evaluation_form(fields, z)
    q = [0] * FIELD_ELEMENTS_PER_BLOB
    hit = None
    for i, w in enumerate(roots):
        if w == z:
            hit = i
            break
    if hit is None:
        denoms = [(w - z) % r for w in roots]
        inv = _batch_inverse(denoms, r)
        for i in range(FIELD_ELEMENTS_PER_BLOB):
            q[i] = (fields[i] - y) * inv[i] % r
    else:
        # z is the hit-th domain point (consensus-spec compute_kzg_proof:
        # ordinary rows use (w_i - z); the hit row is
        # sum_{i != hit} (f_i - y) * w_i / (z * (z - w_i)))
        denoms = [(w - z) % r if i != hit else 1 for i, w in enumerate(roots)]
        inv = _batch_inverse(denoms, r)
        for i in range(FIELD_ELEMENTS_PER_BLOB):
            if i != hit:
                q[i] = (fields[i] - y) * inv[i] % r
        denoms2 = [
            (z * ((z - w) % r)) % r if i != hit else 1
            for i, w in enumerate(roots)
        ]
        inv2 = _batch_inverse(denoms2, r)
        s = 0
        for i, w in enumerate(roots):
            if i == hit:
                continue
            s = (s + (fields[i] - y) * w % r * inv2[i]) % r
        q[hit] = s
    proof_pt = _msm(q, device)
    return hc.g1_compress(proof_pt), y


def verify_kzg_proof(
    commitment: bytes, z: int, y: int, proof: bytes
) -> bool:
    """Pairing check: e(C - y*G1, G2) == e(Q, [s]G2 - z*G2)  <=>
    e(C - y*G1, -G2) * e(Q, [s - z]G2) == 1."""
    c = hc.g1_decompress(commitment)
    q = hc.g1_decompress(proof)
    g2 = setup()["g2_monomial"]
    s_g2 = g2[1]
    p_min_y = hc.g1_add(c, hc.g1_neg(hc.g1_mul(hc.G1_GEN, y)))
    s_min_z = hc.g2_add(s_g2, hc.g2_neg(hc.g2_mul(hc.G2_GEN, z)))
    return hc.pairing_check(
        [(p_min_y, hc.g2_neg(hc.G2_GEN)), (q, s_min_z)]
    )


def verify_blob_kzg_proof(blob: bytes, commitment: bytes, proof: bytes) -> bool:
    """Consensus-spec blob proof verification (challenge derived from blob
    and commitment)."""
    fields = blob_to_field_elements(blob)
    z = _compute_challenge(blob, commitment)
    y = evaluate_polynomial_in_evaluation_form(fields, z)
    return verify_kzg_proof(commitment, z, y, proof)


def _compute_challenge(blob: bytes, commitment: bytes) -> int:
    """Consensus-spec compute_challenge: sha256(DST ‖ u128_be(4096) ‖ blob ‖
    commitment) mod r."""
    dst = b"FSBLOBVERIFY_V1_"
    data = dst + FIELD_ELEMENTS_PER_BLOB.to_bytes(16, "big") + blob + commitment
    return hash_to_bls_field(hashlib.sha256(data).digest())


def proof_of_equivalence(
    blob: bytes, versioned_hash: bytes
) -> tuple[bytes, bytes]:
    """(x, y) as 32-byte BE pairs (ref :50-65)."""
    fields = blob_to_field_elements(blob)
    x = get_evaluation_point(blob, versioned_hash)
    y = evaluate_polynomial_in_evaluation_form(fields, x)
    return x.to_bytes(32, "big"), y.to_bytes(32, "big")


def calc_kzg_proof(blob: bytes, versioned_hash: bytes, device) -> bytes:
    """Proof at the Fiat-Shamir evaluation point (ref :67-72), its MSM on
    `device` (None: the host)."""
    return compute_kzg_proof(blob, get_evaluation_point(blob, versioned_hash), device)[0]


def point_evaluation_precompile(input_data: bytes) -> bytes | None:
    """EVM 0x0a point-evaluation precompile semantics (EIP-4844).

    input: versioned_hash(32) ‖ z(32) ‖ y(32) ‖ commitment(48) ‖ proof(48).
    Returns the 64-byte success output, or None on failure (the EVM treats
    failure as a precompile error)."""
    if len(input_data) != 192:
        return None
    vh = input_data[:32]
    z = int.from_bytes(input_data[32:64], "big")
    y = int.from_bytes(input_data[64:96], "big")
    commitment = input_data[96:144]
    proof = input_data[144:192]
    if z >= BLS_MODULUS or y >= BLS_MODULUS:
        return None
    if commitment_to_version_hash(commitment) != vh:
        return None
    try:
        if not verify_kzg_proof(commitment, z, y, proof):
            return None
    except Exception:
        return None
    return FIELD_ELEMENTS_PER_BLOB_BYTES + BLS_MODULUS_BYTES
