"""BLS12-381 G1 kernels on the card: B1 ``ec_add``, B2 ``ec_weighted_fold``
and B3 ``ec_double``.

Counterpart of raiko_tpu/ops/ec_pallas.py; the CUDA source is
csrc/bls12_381_g1.cu (its header note says what bounds each kernel on the
H100 and how the design answers it).

The wrappers take points in the kernels' layout, (..., 3, 12) int32 tensors
holding 32-bit Montgomery limbs (convert.pack32 of the public (..., 3, 24)
layout).  On a CUDA tensor a wrapper launches its kernel or raises; only a
CPU tensor goes to the plain version beside it, which unpacks, runs the
kzg/curve.py formulas and packs again, bit for bit the same result.

B1 runs each pair on a group of lanes that split the addition's two layers
of six products: 8 lanes per pair (two products deep, 64 registers) where a
launch is below one wave and its time is one addition's latency, 2 lanes
per pair (no lane idle, 80 registers) where the multiply rate bounds it.
"""

from __future__ import annotations

import torch

from .. import convert, kernels
from ..kzg import curve

NLIMBS32 = 12

# B1's two layouts (csrc/bls12_381_g1.cu), as lanes per pair: 8, one
# product of each layer per lane, the shortest addition; 2, three products
# per lane, no lane idle.  ec_add takes 8 up to SPLIT8_MAX_M pairs and 2
# above.  On an H100 the two crossed between 8,192 pairs (8 lanes 15.2 us,
# 2 lanes 23.8 us) and 16,384 (27.2 and 26.2 us; PERF.md).
ADD_LANE_CHOICES = (2, 8)
SPLIT8_MAX_M = 8192

# Rows per plain-version chunk: one stacked mont_mul holds a
# (6·rows, 24, 47) int64 temporary.  On the CPU 256 rows (14 MB) keep it
# near the caches and ran 2-3x faster than 2048.
_PLAIN_ROWS = 256


def ec_add_plain(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Plain torch B1: complete addition of (M, 3, 12) packed points."""
    outs = []
    for i in range(0, p.shape[0], _PLAIN_ROWS):
        a = convert.unpack32(p[i : i + _PLAIN_ROWS])
        b = convert.unpack32(q[i : i + _PLAIN_ROWS])
        outs.append(convert.pack32(curve.add(a, b)))
    return torch.cat(outs) if outs else p.clone()


def ec_add(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Batched complete G1 addition, bit-exact with kzg/curve.py:add.

    p, q: (M, 3, 12) int32 packed Montgomery projective -> (M, 3, 12)."""
    return ec_add_lanes(p, q, add_lanes(p.shape[0]))


def add_lanes(m: int) -> int:
    """Lanes per pair that ``ec_add`` runs M = m pairs with."""
    return 8 if m <= SPLIT8_MAX_M else 2


def ec_add_lanes(p: torch.Tensor, q: torch.Tensor, lanes: int) -> torch.Tensor:
    """``ec_add`` in the layout of `lanes` lanes per pair (one of
    ADD_LANE_CHOICES) on the card; the plain version on the CPU."""
    if p.shape != q.shape or p.dim() != 3 or p.shape[1:] != (3, NLIMBS32):
        raise ValueError(f"ec_add: expected two (M, 3, 12) tensors, got {p.shape}, {q.shape}")
    if p.device.type == "cpu" and q.device.type == "cpu":
        return ec_add_plain(p, q)
    kernels.check(p, "ec_add p", torch.int32, (3, NLIMBS32))
    kernels.check(q, "ec_add q", torch.int32, (3, NLIMBS32))
    if lanes not in ADD_LANE_CHOICES:
        raise ValueError(f"ec_add: lanes must be one of {ADD_LANE_CHOICES}, got {lanes}")
    out = torch.empty_like(p)
    if p.shape[0]:
        kernels.launch("raiko_bls12_381_ec_add", "ec_add", p, q, out, p.shape[0], lanes)
    return out


def ec_double_plain(p: torch.Tensor) -> torch.Tensor:
    """Plain torch B3: complete doubling of (M, 3, 12) packed points."""
    outs = [convert.pack32(curve.double(convert.unpack32(p[i : i + _PLAIN_ROWS])))
            for i in range(0, p.shape[0], _PLAIN_ROWS)]
    return torch.cat(outs) if outs else p.clone()


def ec_double(p: torch.Tensor) -> torch.Tensor:
    """Batched complete G1 doubling, bit-exact with kzg/curve.py:double.

    p: (M, 3, 12) int32 packed Montgomery projective -> (M, 3, 12)."""
    if p.dim() != 3 or p.shape[1:] != (3, NLIMBS32) or p.dtype != torch.int32:
        raise ValueError(f"ec_double: expected an (M, 3, 12) int32 tensor, got {p.dtype} {tuple(p.shape)}")
    if p.device.type == "cpu":
        return ec_double_plain(p)
    kernels.check(p, "ec_double p", torch.int32, (3, NLIMBS32))
    out = torch.empty_like(p)
    if p.shape[0]:
        kernels.launch("raiko_bls12_381_ec_double", "ec_double", p, out, p.shape[0])
    return out


def ec_weighted_fold_plain(vals: torch.Tensor) -> torch.Tensor:
    """Plain torch B2: a Horner chain of kzg/curve.py double and add."""
    v = convert.unpack32(vals)
    acc = v[:, -1]
    for j in range(v.shape[1] - 2, -1, -1):
        acc = curve.add(curve.double(acc), v[:, j])
    return convert.pack32(acc)


def ec_weighted_fold(vals: torch.Tensor) -> torch.Tensor:
    """Σ_j 2^j · vals[:, j] for vals (B, J, 3, 12) packed Montgomery
    projective -> (B, 3, 12): the Pippenger bucket recombination, one
    warp per batch entry."""
    if vals.dim() != 4 or vals.shape[2:] != (3, NLIMBS32) or vals.shape[1] < 1:
        raise ValueError(f"ec_weighted_fold: expected (B, J >= 1, 3, 12), got {vals.shape}")
    if vals.device.type == "cpu":
        return ec_weighted_fold_plain(vals)
    kernels.check(vals, "ec_weighted_fold vals", torch.int32, (3, NLIMBS32))
    bsz, j = vals.shape[:2]
    out = torch.empty((bsz, 3, NLIMBS32), dtype=torch.int32, device=vals.device)
    if bsz:
        kernels.launch("raiko_bls12_381_weighted_fold", "ec_weighted_fold", vals, out, bsz, j)
    return out
