"""Distributed Pippenger MSM: points sharded over the ranks, bucket matrices
reduced with a collective (SURVEY.md §2.3(b)).

Port of raiko_tpu/parallel/msm_dist.py.  Each rank runs the bucket
accumulation over its N/D points (``ops.msm.bucket_matrix``), producing a
dense (windows, buckets) EC matrix; the matrices are all-gathered and
EC-added in rank order (EC addition is not a ring sum, so the combine is
an explicit fold over the gathered operands, kernel B1), and the shared
bit-masked sums and window fold (``combine_buckets``: B1, then B2) finish
identically on every rank.  Projective coordinates are not unique:
compare results as affine points.
"""

from __future__ import annotations

import torch

from .. import convert
from ..ops import ec_cuda, msm as msmmod
from . import mesh as meshmod


def make_msm_dist(mesh: meshmod.Mesh):
    """A distributed MSM on `mesh`.  The returned function takes the whole
    (N, 3, 24) Montgomery points and (N, 16) scalar limbs on every rank (N a
    multiple of the mesh size) and returns one (3, 24) projective point on
    every rank."""
    d = mesh.size

    def run(points: torch.Tensor, scalar_limbs: torch.Tensor) -> torch.Tensor:
        n = points.shape[0]
        assert n % d == 0, f"{n} points do not shard over {d} ranks"
        mine = slice(mesh.rank * (n // d), (mesh.rank + 1) * (n // d))
        buckets = msmmod.bucket_matrix(convert.pack32(points[mine]), scalar_limbs[mine].long()[None])
        gathered = meshmod.all_gather(mesh, buckets, 0)  # (D, 32, 256, 3, 12)
        acc = gathered[0]
        for i in range(1, d):
            acc = ec_cuda.ec_add(acc.reshape(-1, 3, ec_cuda.NLIMBS32).contiguous(),
                                 gathered[i].reshape(-1, 3, ec_cuda.NLIMBS32).contiguous()).reshape(acc.shape)
        return convert.unpack32(msmmod.combine_buckets(acc))

    return run
