"""BabyBear prime field (p = 2^31 - 2^27 + 1) on torch tensors.

Port of raiko_tpu/fields/babybear.py: the base field of the STARK pipeline
(trace values, NTT/LDE, Poseidon2 hashing).  Elements are Montgomery form
with R = 2^32, as in the reference, so values agree bit for bit.

Every element is < p < 2^31, so a tensor of them is int32 without
repacking: that is the layout of the CUDA kernels (which read the bits as
u32) and of the port's STARK tensors.  The arithmetic here computes in
int64, because torch's uint32 has no add, shift or compare on the CPU and
a product of two elements needs 62 bits; each result keeps the dtype of
the first operand.  The Montgomery product a·b·R^-1 mod p is
((a·b) mod p)·(R^-1 mod p) mod p: the reduction is exact, so it equals
the reference's u32 Montgomery reduction.

Host helpers (Python ints and numpy) are copies of the reference's, for
twiddle tables and tests.
"""

from __future__ import annotations

import numpy as np
import torch

P = 2013265921  # 15 * 2^27 + 1
TWO_ADICITY = 27
# multiplicative generator of F_p^* (smallest: 31)
GENERATOR = 31
# R = 2^32 mod p, Montgomery radix
R = (1 << 32) % P
R2 = (R * R) % P
RINV = pow(R, -1, P)
# -p^{-1} mod 2^32
NPRIME = (-pow(P, -1, 1 << 32)) % (1 << 32)


def _i64(x) -> torch.Tensor:
    return x.long() if isinstance(x, torch.Tensor) else torch.as_tensor(x, dtype=torch.int64)


def _like(out: torch.Tensor, a) -> torch.Tensor:
    return out.to(a.dtype) if isinstance(a, torch.Tensor) else out


def mont_mul(a, b) -> torch.Tensor:
    """Montgomery product a·b·R^-1 mod p of elements in [0, p)."""
    return _like((_i64(a) * _i64(b)) % P * RINV % P, a)


def add(a, b) -> torch.Tensor:
    s = _i64(a) + _i64(b)
    return _like(torch.where(s >= P, s - P, s), a)


def sub(a, b) -> torch.Tensor:
    d = _i64(a) - _i64(b)
    return _like(torch.where(d < 0, d + P, d), a)


def neg(a) -> torch.Tensor:
    a64 = _i64(a)
    return _like(torch.where(a64 == 0, a64, P - a64), a)


def to_mont(a) -> torch.Tensor:
    """Standard -> Montgomery form: a·R mod p."""
    return mont_mul(a, R2)


def from_mont(a) -> torch.Tensor:
    """Montgomery -> standard form: a·R^-1 mod p."""
    return mont_mul(a, 1)


def mont_pow(a, e: int) -> torch.Tensor:
    """a^e (a in Montgomery form, e a Python int) -> Montgomery form."""
    base = _i64(a)
    result = torch.full_like(base, R)  # mont(1)
    while e > 0:
        if e & 1:
            result = mont_mul(result, base)
        base = mont_mul(base, base)
        e >>= 1
    return _like(result, a)


def mont_inv(a) -> torch.Tensor:
    """Multiplicative inverse via Fermat (a in Montgomery form)."""
    return mont_pow(a, P - 2)


# ---------------------------------------------------------------------------
# host-side helpers (Python ints / numpy; for twiddle precompute and tests)
# ---------------------------------------------------------------------------


def h_pow(a: int, e: int, p: int = P) -> int:
    return pow(a, e, p)


def h_inv(a: int) -> int:
    return pow(a, P - 2, P)


def two_adic_generator(bits: int) -> int:
    """Primitive 2^bits-th root of unity (standard form)."""
    assert 0 <= bits <= TWO_ADICITY
    return pow(GENERATOR, (P - 1) >> bits, P)


def np_to_mont(x: np.ndarray) -> np.ndarray:
    """numpy u32 standard-form -> Montgomery form (host precompute)."""
    v = (x.astype(np.uint64) * np.uint64(R)) % np.uint64(P)
    return v.astype(np.uint32)


def np_from_mont(x: np.ndarray) -> np.ndarray:
    v = (x.astype(np.uint64) * np.uint64(RINV)) % np.uint64(P)
    return v.astype(np.uint32)


def np_powers(w: int, n: int) -> np.ndarray:
    """[w^0, w^1, ..., w^(n-1)] mod p as uint32 (standard form), by
    doubling: each step extends the run by its last power times w^len."""
    out = np.ones(max(n, 1), dtype=np.uint64)
    length, step = 1, w % P
    while length < n:
        take = min(length, n - length)
        out[length : length + take] = out[:take] * np.uint64(step) % np.uint64(P)
        length += take
        step = step * step % P
    return out[:n].astype(np.uint32)
