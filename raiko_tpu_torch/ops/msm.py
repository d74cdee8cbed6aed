"""Pippenger multi-scalar multiplication on torch tensors: the KZG hot path.

Port of raiko_tpu/ops/msm.py.  A blob commitment or opening proof is one
4096-point MSM over the trusted setup; the steps are the reference's:

1. decompose the scalars into 32 8-bit window digits (a reshape of the
   16-bit limbs);
2. give every (point, window) pair with a nonzero digit a flat bucket key
   and sort the keys (``torch.sort``, a library op, as JAX left its sort to
   XLA);
3. sum each bucket's points;
4. scatter the bucket sums into a dense (windows, 256) bucket matrix;
5. reduce it with the bit-masked partial sums S'_j and one 256-entry
   weighted Horner fold (kernel B2).

What changed from the reference, and why: PyTorch runs eagerly, so shapes
may depend on the data.

* Zero digits are dropped before step 3 instead of being routed to a dump
  slot of identities (XLA's static shapes were the only reason to keep
  them).
* Step 3 is a segmented pairwise tree reduction: each level adds the
  odd-ranked entries of every bucket into their even-ranked neighbours, so
  a bucket of L points takes ceil(log2 L) levels and the whole step
  M - (#buckets) additions.  The reference's three-phase segmented scan
  (about 3.5 M additions) computed every prefix only because XLA needs a
  static-shape associative scan; only the bucket totals are used.
* Step 5 gathers, for each bit k, the 128 buckets whose index has bit k set
  instead of masking the other 128 to identities: the same sums with half
  the additions.
* There is one algorithm for every device.  The reference's CPU fork (a
  suffix-scan reduction and an unsplit scan) existed only because XLA:CPU
  compiles slowly.

Inside, points are in the kernels' packed layout, (..., 3, 12) int32 of
32-bit Montgomery limbs (``convert.pack32``), so every EC addition goes to
kernel B1 (``ec_cuda.ec_add``) and the final fold to kernel B2
(``ec_cuda.ec_weighted_fold``) on a CUDA tensor, and to their plain
versions on a CPU tensor.  The public functions take and return the
reference's (..., 3, 24) layout.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import convert
from ..kzg import curve
from . import ec_cuda

WINDOW_BITS = 8
NWINDOWS = 32  # 256-bit scalars
NBUCKETS = 1 << WINDOW_BITS

# _BIT_BUCKETS[k] = the 128 bucket indices with bit k set
_BIT_BUCKETS = np.array(
    [[b for b in range(NBUCKETS) if (b >> k) & 1] for k in range(WINDOW_BITS)],
    dtype=np.int64,
)


def scalars_to_limbs(scalars: list[int]) -> np.ndarray:
    """Host: scalar ints -> (N, 16) u32 array of 16-bit limbs (LE)."""
    buf = b"".join(s.to_bytes(32, "little") for s in scalars)
    return np.frombuffer(buf, dtype="<u2").reshape(len(scalars), 16).astype(np.uint32)


def _identity32(shape, device) -> torch.Tensor:
    return convert.pack32(curve.identity(shape, device))


def _segment_sums(keys: torch.Tensor, pts: torch.Tensor):
    """Sum runs of equal keys: sorted keys (L,), packed points (L, 3, 12)
    -> (unique keys (S,), their sums (S, 3, 12)).

    Pairwise tree per run: at each level every entry of odd rank within its
    run is added into its left neighbour and dropped, and the ranks halve."""
    if keys.numel() == 0:
        return keys, pts
    device = keys.device
    n = keys.shape[0]
    starts = torch.ones(n, dtype=torch.bool, device=device)
    starts[1:] = keys[1:] != keys[:-1]
    pos = torch.arange(n, device=device)
    run_start = torch.cummax(torch.where(starts, pos, 0), dim=0).values
    rank = pos - run_start
    while True:
        right = (rank & 1) == 1
        ridx = torch.nonzero(right).squeeze(1)
        if ridx.numel() == 0:
            return keys, pts
        lidx = ridx - 1
        pts = pts.index_copy(0, lidx, ec_cuda.ec_add(pts[lidx], pts[ridx]))
        keep = ~right
        keys, pts, rank = keys[keep], pts[keep], rank[keep] >> 1


def bucket_matrix(points32: torch.Tensor, scalar_limbs: torch.Tensor) -> torch.Tensor:
    """Steps 1-4: per-(window, bucket) sums for B MSMs over one point set.

    points32: (N, 3, 12) int32 packed; scalar_limbs: (B, N, 16) int64
    16-bit limbs.  Returns (B, NWINDOWS, NBUCKETS, 3, 12) packed, with
    bucket 0 (the zero digit) left at the identity."""
    bsz, n = scalar_limbs.shape[:2]
    device = points32.device
    # 1. window digits (B, N, 32): limb w -> digits 2w (low byte), 2w+1 (high)
    digits = torch.stack([scalar_limbs & 0xFF, scalar_limbs >> 8], dim=-1).reshape(
        bsz, n, NWINDOWS
    )
    # 2. flat keys (b, w, digit); zero digits are dropped
    win = torch.arange(NWINDOWS, device=device).view(1, 1, NWINDOWS)
    batch = torch.arange(bsz, device=device).view(bsz, 1, 1)
    keys = ((batch * NWINDOWS + win) * NBUCKETS + digits).reshape(-1)
    point_idx = torch.arange(n, device=device).view(1, n, 1).expand(bsz, n, NWINDOWS)
    nonzero = digits.reshape(-1) != 0
    keys, point_idx = keys[nonzero], point_idx.reshape(-1)[nonzero]
    keys, order = torch.sort(keys, stable=True)
    # 3. bucket sums
    ukeys, sums = _segment_sums(keys, points32[point_idx[order]])
    # 4. dense bucket matrix
    buckets = _identity32((bsz * NWINDOWS * NBUCKETS,), device).clone()
    buckets[ukeys] = sums
    return buckets.reshape(bsz, NWINDOWS, NBUCKETS, 3, ec_cuda.NLIMBS32)


def combine_buckets(buckets: torch.Tensor) -> torch.Tensor:
    """(..., NWINDOWS, NBUCKETS, 3, 12) packed bucket sums -> (..., 3, 12).

    Expanding each bucket index over its bits,

        Σ_w 2^{8w} Σ_b b·B_{w,b}  =  Σ_{j=0}^{255} 2^j · S'_j ,
        S'_{8w+k} = Σ_{b: bit k of b set} B_{w,b} ,

    so the reduction is 7 levels of halving batched additions over the
    (W, 8, 128) selected buckets and one Horner fold (kernel B2)."""
    lead = buckets.shape[:-4]
    w = buckets.shape[-4]
    limbs = buckets.shape[-1]
    b = buckets.reshape((-1, w, NBUCKETS, 3, limbs))
    bsz = b.shape[0]
    sel = torch.as_tensor(_BIT_BUCKETS, device=buckets.device)
    arr = b[:, :, sel]  # (B, W, 8, 128, 3, 12)
    while arr.shape[3] > 1:
        half = arr.shape[3] // 2
        lo = arr[:, :, :, :half].reshape(-1, 3, limbs)
        hi = arr[:, :, :, half:].reshape(-1, 3, limbs)
        arr = ec_cuda.ec_add(lo.contiguous(), hi.contiguous()).reshape(
            bsz, w, WINDOW_BITS, half, 3, limbs
        )
    # j = 8w + k: the row-major (w, k) flatten puts S'_j at index j
    sprime = arr[:, :, :, 0].reshape(bsz, w * WINDOW_BITS, 3, limbs).contiguous()
    return ec_cuda.ec_weighted_fold(sprime).reshape(lead + (3, limbs))


def msm_multi(points: torch.Tensor, scalar_limbs: torch.Tensor) -> torch.Tensor:
    """B independent MSMs over the same point set.

    points: (N, 3, 24) int64 Montgomery projective; scalar_limbs: (B, N, 16)
    int64 16-bit limbs (standard-form integers) on the same device.
    Returns (B, 3, 24)."""
    if points.dim() != 3 or points.shape[1:] != (3, 24):
        raise ValueError(f"msm: expected points (N, 3, 24), got {tuple(points.shape)}")
    if scalar_limbs.dim() != 3 or scalar_limbs.shape[1:] != (points.shape[0], 16):
        raise ValueError(
            f"msm: expected scalars (B, {points.shape[0]}, 16), got {tuple(scalar_limbs.shape)}"
        )
    buckets = bucket_matrix(convert.pack32(points), scalar_limbs.long())
    return convert.unpack32(combine_buckets(buckets))


def msm(points: torch.Tensor, scalar_limbs: torch.Tensor) -> torch.Tensor:
    """Σ_i scalar_i · P_i: points (N, 3, 24), scalar_limbs (N, 16) -> (3, 24)."""
    return msm_multi(points, scalar_limbs.unsqueeze(0))[0]
