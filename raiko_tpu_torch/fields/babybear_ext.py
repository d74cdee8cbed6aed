"""Quartic extension of BabyBear: F_p[x] / (x^4 - 11), on torch tensors.

Port of raiko_tpu/fields/babybear_ext.py.  The STARK protocol samples its
mixing, folding and out-of-domain challenges from this extension.

Device representation: (..., 4) Montgomery coordinate tensors (int32
storage, as the base field's; the arithmetic runs in int64); every op
broadcasts over leading axes and keeps the first operand's dtype.  Host
representation: 4-tuples of ints (standard form) for the verifier, and
(n, 4) uint64 numpy arrays (``npef_*``); the host half is a copy of the
reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from . import babybear as bb

W = 11  # x^4 = W
DEGREE = 4


# ----------------------------------------------------------- device side --


def ef_zero(shape, device) -> torch.Tensor:
    return torch.zeros(tuple(shape) + (4,), dtype=torch.int32, device=device)


def ef_one(shape, device) -> torch.Tensor:
    one = ef_zero(shape, device)
    one[..., 0] = bb.R  # mont(1)
    return one


def ef_from_base(x: torch.Tensor) -> torch.Tensor:
    """Lift base-field (...,) to EF (..., 4)."""
    z = torch.zeros_like(x)
    return torch.stack([x, z, z, z], dim=-1)


def ef_add(a, b):
    return bb.add(a, b)


def ef_sub(a, b):
    return bb.sub(a, b)


def ef_neg(a):
    return bb.neg(a)


def ef_mul(a, b):
    """Schoolbook quartic product with the x^4 = W reduction.  The reference
    adds 16 Montgomery products; here the raw products are reduced mod p,
    summed per power of x (4 terms at most), the x^4..x^6 sums folded in
    times W, and the Montgomery factor R^-1 applied once: the same exact
    value."""
    a64, b64 = bb._i64(a), bb._i64(b)
    prod = a64[..., :, None] * b64[..., None, :] % bb.P  # (..., 4, 4)
    c = [0] * 7
    for i in range(4):
        for j in range(4):
            c[i + j] = c[i + j] + prod[..., i, j]
    out = torch.stack([c[0] + W * c[4], c[1] + W * c[5], c[2] + W * c[6], c[3]], dim=-1)
    return bb._like(out % bb.P * bb.RINV % bb.P, a)


def ef_mul_base(a, x):
    """EF (..., 4) times base (...,) -> EF."""
    return bb.mont_mul(a, x[..., None])


def ef_pow(a, e: int):
    result = ef_one(a.shape[:-1], a.device).to(a.dtype)
    base = a
    while e:
        if e & 1:
            result = ef_mul(result, base)
        base = ef_mul(base, base)
        e >>= 1
    return result


# ------------------------------------------------------------- host side --


def h_add(a, b):
    return tuple((x + y) % bb.P for x, y in zip(a, b))


def h_sub(a, b):
    return tuple((x - y) % bb.P for x, y in zip(a, b))


def h_neg(a):
    return tuple((-x) % bb.P for x in a)


def h_mul(a, b):
    c = [0] * 7
    for i in range(4):
        for j in range(4):
            c[i + j] = (c[i + j] + a[i] * b[j]) % bb.P
    return tuple((c[k] + W * c[k + 4]) % bb.P for k in range(3)) + (c[3],)


def h_from_base(x: int):
    return (x % bb.P, 0, 0, 0)


H_ZERO = (0, 0, 0, 0)
H_ONE = (1, 0, 0, 0)


def h_pow(a, e: int):
    result = H_ONE
    base = a
    while e:
        if e & 1:
            result = h_mul(result, base)
        base = h_mul(base, base)
        e >>= 1
    return result


def h_batch_inv(vals: list[tuple]) -> list[tuple]:
    """Batch inversion (Montgomery's trick): one h_inv + 3(k-1) h_muls."""
    if not vals:
        return []
    prefix = [H_ONE]
    for v in vals:
        prefix.append(h_mul(prefix[-1], v))
    inv = h_inv(prefix[-1])
    out: list[tuple] = [H_ZERO] * len(vals)
    for i in range(len(vals) - 1, -1, -1):
        out[i] = h_mul(prefix[i], inv)
        inv = h_mul(inv, vals[i])
    return out


# The Frobenius map a -> a^(p^k) by constants: x^(i p^k) = x^i W^(i (p^k - 1)/4)
# (4 divides p - 1), so coefficient i is scaled by FROBENIUS[k][i].
FROBENIUS = tuple(
    tuple(pow(W, i * (bb.P**k - 1) // 4, bb.P) for i in range(4)) for k in range(4)
)


def h_frobenius(a, k: int):
    """a^(p^k) for k in 0..3."""
    return tuple(x * c % bb.P for x, c in zip(a, FROBENIUS[k]))


def h_inv(a):
    """Inverse via the norm map: a^{-1} = conj / norm with
    conj = a^{p} * a^{p^2} * a^{p^3} (norm lands in F_p)."""
    conj = h_mul(h_mul(h_frobenius(a, 1), h_frobenius(a, 2)), h_frobenius(a, 3))
    norm = h_mul(a, conj)
    assert norm[1] == norm[2] == norm[3] == 0
    n_inv = pow(norm[0], bb.P - 2, bb.P)
    return tuple(c * n_inv % bb.P for c in conj)


# ------------------------------------------------- vectorized host side --
# Standard-form (n, 4) uint64 numpy arrays — for challenge-dependent aux
# traces (LogUp helpers) over 10k+ rows, where per-row Python-tuple math
# would dominate proving time.

_PU = np.uint64(bb.P)


def npef_from_base(x: np.ndarray) -> np.ndarray:
    out = np.zeros(x.shape + (4,), dtype=np.uint64)
    out[..., 0] = x % _PU
    return out


def npef_add(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a + b) % _PU


def npef_sub(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a + _PU - b % _PU) % _PU


def npef_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Schoolbook quartic product; operands broadcast over leading axes."""
    a = a % _PU
    b = b % _PU
    shape = np.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    c = [np.zeros(shape, dtype=np.uint64) for _ in range(7)]
    for i in range(4):
        for j in range(4):
            c[i + j] = (c[i + j] + (a[..., i] * b[..., j]) % _PU) % _PU
    w = np.uint64(W)
    return np.stack(
        [
            (c[0] + w * c[4]) % _PU,
            (c[1] + w * c[5]) % _PU,
            (c[2] + w * c[6]) % _PU,
            c[3],
        ],
        axis=-1,
    )


def _np_base_inv(x: np.ndarray) -> np.ndarray:
    """Vectorized Fermat inverse in the base field ((n,) uint64)."""
    result = np.ones_like(x)
    base = x % _PU
    e = bb.P - 2
    while e:
        if e & 1:
            result = (result * base) % _PU
        base = (base * base) % _PU
        e >>= 1
    return result


_NP_FROBENIUS = np.array(FROBENIUS, dtype=np.uint64)


def npef_frobenius(a: np.ndarray, k: int) -> np.ndarray:
    """Vectorized a^(p^k) for k in 0..3 (see FROBENIUS)."""
    return (a % _PU) * _NP_FROBENIUS[k] % _PU


def npef_inv(a: np.ndarray) -> np.ndarray:
    """Vectorized EF inverse via the norm map (see h_inv)."""
    conj = npef_mul(npef_mul(npef_frobenius(a, 1), npef_frobenius(a, 2)), npef_frobenius(a, 3))
    norm = npef_mul(a, conj)
    n_inv = _np_base_inv(norm[..., 0])
    return (conj * n_inv[..., None]) % _PU


def to_device(vals: list[tuple], device) -> torch.Tensor:
    """Host EF tuples -> (N, 4) int32 Montgomery tensor on `device`."""
    arr = np.array(vals, dtype=np.uint64).reshape(-1, 4)
    return torch.as_tensor(((arr * bb.R) % bb.P).astype(np.int32), device=device)


def from_device(arr: torch.Tensor) -> list[tuple]:
    """(..., 4) Montgomery tensor on any device -> standard-form EF tuples."""
    a = bb.from_mont(arr).cpu().numpy()
    return [tuple(int(v) for v in row) for row in a.reshape(-1, 4)]
