"""BLS12-381 G1 arithmetic on torch tensors: complete projective formulas.

Port of raiko_tpu/kzg/curve.py.  A point is homogeneous projective
(X : Y : Z), each coordinate a 24-limb Montgomery Fp element, stacked as one
(..., 3, 24) int64 tensor.  Addition and doubling are the Renes-Costello-
Batina complete formulas for a = 0 (Alg. 7/9, b3 = 12) with the reference's
operation order and its two stacked ``mont_mul`` layers, so projective
outputs equal the reference's bit for bit.

This is the plain version that the CUDA kernels in ops/ec_cuda.py are held
against.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields.limbs import FP
from . import host_curve as hc


def make_point(x_int: int, y_int: int) -> np.ndarray:
    """Affine ints -> (3, 24) Montgomery projective with Z=1 (host)."""
    return np.stack([FP.to_mont_int(x_int), FP.to_mont_int(y_int), FP.to_mont_int(1)])


def identity(shape=(), device="cpu") -> torch.Tensor:
    """(0 : 1 : 0)."""
    z = torch.zeros((3, 24), dtype=torch.int64, device=device)
    z[1] = FP.const("r", device)
    return z.expand(tuple(shape) + (3, 24))


def points_from_affine(coords: list[tuple[int, int] | None]) -> np.ndarray:
    """Host: list of affine int pairs (None = infinity) -> (N, 3, 24)."""
    out = np.zeros((len(coords), 3, 24), dtype=np.uint32)
    one = FP.to_mont_int(1)
    for i, c in enumerate(coords):
        if c is None:
            out[i, 1] = one
        else:
            out[i, 0] = FP.to_mont_int(c[0])
            out[i, 1] = FP.to_mont_int(c[1])
            out[i, 2] = one
    return out


def to_affine(pt) -> tuple[int, int] | None:
    """Host: (3, 24) Montgomery projective -> affine int pair."""
    pt = np.asarray(pt.cpu() if isinstance(pt, torch.Tensor) else pt)
    x = FP.from_mont_limbs(pt[0])
    y = FP.from_mont_limbs(pt[1])
    z = FP.from_mont_limbs(pt[2])
    if z == 0:
        return None
    zinv = pow(z, -1, hc.P)
    return (x * zinv % hc.P, y * zinv % hc.P)


def _mul_b3(t):
    """t * 12 via doublings: 12t = 8t + 4t."""
    t2 = FP.add(t, t)
    t4 = FP.add(t2, t2)
    t8 = FP.add(t4, t4)
    return FP.add(t8, t4)


def _stk(*xs):
    return torch.stack(xs, dim=-2)


def add(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Complete projective addition (RCB15 Alg. 7, a=0, b3=12).

    p, q: (..., 3, 24) -> (..., 3, 24).  Handles identity and P==Q."""
    X1, Y1, Z1 = p[..., 0, :], p[..., 1, :], p[..., 2, :]
    X2, Y2, Z2 = q[..., 0, :], q[..., 1, :], q[..., 2, :]
    # layer A: pairwise coordinate sums
    sA = FP.add(_stk(X1, X2, Y1, Y2, X1, X2), _stk(Y1, Y2, Z1, Z2, Z1, Z2))
    # layer M1: 6 independent products
    m1 = FP.mont_mul(
        _stk(X1, Y1, Z1, sA[..., 0, :], sA[..., 2, :], sA[..., 4, :]),
        _stk(X2, Y2, Z2, sA[..., 1, :], sA[..., 3, :], sA[..., 5, :]),
    )
    t0, t1, t2 = m1[..., 0, :], m1[..., 1, :], m1[..., 2, :]
    s1, s2, s3 = m1[..., 3, :], m1[..., 4, :], m1[..., 5, :]
    u = FP.add(_stk(t0, t1, t0), _stk(t1, t2, t2))
    v = FP.sub(_stk(s1, s2, s3), u)
    t3, t4, y3a = v[..., 0, :], v[..., 1, :], v[..., 2, :]
    # b3 chains: 3*t0, 12*t2, 12*y3a via batched doublings
    d1 = FP.add(_stk(t0, t2, y3a), _stk(t0, t2, y3a))  # 2x
    d2 = FP.add(d1, _stk(t0, d1[..., 1, :], d1[..., 2, :]))  # 3t0, 4t2, 4y
    d3 = FP.add(d2[..., 1:3, :], d2[..., 1:3, :])  # 8t2, 8y
    d4 = FP.add(d3, d2[..., 1:3, :])  # 12t2, 12y
    t0b = d2[..., 0, :]
    t2b = d4[..., 0, :]
    y3b = d4[..., 1, :]
    z3a = FP.add(t1, t2b)
    t1b = FP.sub(t1, t2b)
    # layer M2: 6 independent products
    m2 = FP.mont_mul(
        _stk(t4, t3, y3b, t1b, t0b, z3a),
        _stk(y3b, t1b, t0b, z3a, t3, t4),
    )
    X3 = FP.sub(m2[..., 1, :], m2[..., 0, :])
    # Y3 = t1b*z3a + y3b*t0b ; Z3 = z3a*t4 + t0b*t3
    yz = FP.add(_stk(m2[..., 3, :], m2[..., 5, :]), _stk(m2[..., 2, :], m2[..., 4, :]))
    return _stk(X3, yz[..., 0, :], yz[..., 1, :])


def double(p: torch.Tensor) -> torch.Tensor:
    """Complete projective doubling (RCB15 Alg. 9, a=0, b3=12), with the
    field multiplies batched into two stacked ``mont_mul`` calls."""
    X, Y, Z = p[..., 0, :], p[..., 1, :], p[..., 2, :]
    # layer M1: t0 = Y*Y, t1 = Y*Z, t2 = Z*Z, txy = X*Y
    m1 = FP.mont_mul(_stk(Y, Y, Z, X), _stk(Y, Z, Z, Y))
    t0, t1, t2, txy = (m1[..., i, :] for i in range(4))
    z3 = FP.add(t0, t0)
    z3 = FP.add(z3, z3)
    z3 = FP.add(z3, z3)  # 8*Y^2
    t2b = _mul_b3(t2)
    y3a = FP.add(t0, t2b)
    t2x3 = FP.add(FP.add(t2b, t2b), t2b)
    t0b = FP.sub(t0, t2x3)
    # layer M2: X3a = t2b*z3, Z3 = t1*z3, Y3m = t0b*y3a, X3m = t0b*txy
    m2 = FP.mont_mul(_stk(t2b, t1, t0b, t0b), _stk(z3, z3, y3a, txy))
    X3 = FP.add(m2[..., 3, :], m2[..., 3, :])
    Y3 = FP.add(m2[..., 0, :], m2[..., 2, :])
    Z3 = m2[..., 1, :]
    return _stk(X3, Y3, Z3)


def select(mask, p, q):
    """Elementwise point select: mask ? p : q.  mask: (...,) bool."""
    return torch.where(mask[..., None, None], p, q)
