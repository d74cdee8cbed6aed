"""Distributed NTT: four-step decomposition with an all-to-all transpose.

Port of raiko_tpu/parallel/ntt_dist.py.  The big-N NTT splits as
N = R x C (n = n1*C + n2): size-R column NTTs on each rank's C/D columns,
a twiddle multiply, ONE all-to-all transpose across the ranks, then size-C
row NTTs.  Butterfly stages stay rank-local on both sides of the
transpose; the all-to-all is the only traffic between ranks.  Both local
passes are kernel B5 (``ntt``) on a CUDA device.

Order bookkeeping (as the reference's): with bit-reversed-output local
NTTs, the step-4 output matrix indexed [brp_R(k1), brp_C(k2)] holds
X[k1 + R*k2]; its row-major flattening is the global bit-reversed order of
N = R*C.  So the slices of every rank, joined in rank order
(``gather_ntt``), equal ``ops.ntt.ntt(x)`` element for element: rank r
holds the contiguous slice [r*N/D, (r+1)*N/D), as the reference's output
is sharded ``P(axis)``.
"""

from __future__ import annotations

import torch

from ..fields import babybear as bb
from ..ops import ntt as nttmod
from . import mesh as meshmod


def make_ntt_dist(mesh: meshmod.Mesh, log_n: int):
    """A distributed forward NTT of size 2^log_n on `mesh`.

    The returned function takes the whole (N,) Montgomery input on every
    rank (on ``mesh.device``) and returns this rank's (N/D,) slice of the
    bit-reversed output."""
    d = mesh.size
    log_r = log_n // 2
    log_c = log_n - log_r
    r, c = 1 << log_r, 1 << log_c
    assert r % d == 0 and c % d == 0, "the mesh must divide both factors"
    cols = slice(mesh.rank * (c // d), (mesh.rank + 1) * (c // d))
    tw = torch.as_tensor(nttmod._fourstep_twiddles(log_r, log_c)[:, cols].astype("int64"), device=mesh.device)

    def run(x: torch.Tensor) -> torch.Tensor:
        xs = x.reshape(r, c)[:, cols]  # this rank's (R, C/D) column slice
        a = nttmod.ntt(xs.T.contiguous()).T  # size-R column NTTs -> bit-reversed rows
        a = bb.mont_mul(a, tw)  # twiddle w_N^{k1*n2}
        recv = meshmod.all_to_all(mesh, a, 0, 1)  # rows out, columns in: (R/D, C)
        return nttmod.ntt(recv.contiguous()).reshape(-1)  # size-C row NTTs

    return run


def gather_ntt(mesh: meshmod.Mesh, part: torch.Tensor) -> torch.Tensor:
    """The whole (N,) output from every rank's slice, on every rank."""
    return meshmod.all_gather(mesh, part, 0)
