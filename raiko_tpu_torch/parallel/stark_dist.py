"""Sharded STARK trace commitment: the multi-GPU prover step.

Port of raiko_tpu/parallel/stark_dist.py.  Parallelism axes over the ranks:

- **column parallel** (tensor-parallel analog): trace columns shard across
  ranks; each column's interpolation and coset LDE are rank-local NTT work
  (kernel B5: ``intt``, ``ntt_coset``);
- **all-to-all reshard** (sequence-parallel analog): the LDE goes from
  column shards to row shards in one collective;
- **row parallel** (data-parallel analog): Poseidon2 leaf hashing
  (``poseidon2_hash_rows``) and the lower Merkle levels
  (``poseidon2_merkle``) run on rank-local row shards; the subtree roots
  are all-gathered and the top of the tree is folded identically on every
  rank (``poseidon2_compress``, log2(D) levels).

``make_commit_cols_dist`` is the prover's drop-in for ``commit_cols``: the
same (coeffs, lde, levels), bit for bit, on every rank, since the
prover's later stages and its queries read all of them.  Its columns are
interpolated and extended on their own rank; coefficients and LDE are
all-gathered together, each rank hashes its block of rows of the whole
LDE, and the leaves are all-gathered into one ``poseidon2_merkle``
launch, so every rank holds every level.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import convert
from ..fields import babybear as bb
from ..ops import merkle, ntt as nttmod, poseidon2 as p2
from ..stark.prover import BLOWUP_LOG
from . import mesh as meshmod


def make_trace_commit_dist(mesh: meshmod.Mesh):
    """A sharded trace-commitment step on `mesh`.

    The returned function takes the whole (n, W) uint32 standard-form trace
    on every rank (W a multiple of the mesh size) and returns the (8,)
    Montgomery Merkle root on every rank."""
    d = mesh.size

    def run(trace: np.ndarray) -> torch.Tensor:
        n, w = trace.shape
        assert w % d == 0, f"{w} columns do not shard over {d} ranks"
        per = w // d
        mine = trace[:, mesh.rank * per : (mesh.rank + 1) * per]
        cols = bb.to_mont(convert.words_from_numpy(mine.T, mesh.device))  # (W/D, n)
        coeffs = nttmod.interpolate(cols)
        lde = nttmod.lde_from_coeffs(coeffs, BLOWUP_LOG, bb.GENERATOR)  # (W/D, m)
        rows = meshmod.all_to_all(mesh, lde, 1, 0)  # columns -> row blocks: (W, m/D)
        levels = merkle.commit(p2.hash_rows(rows.T))
        cur = meshmod.all_gather(mesh, merkle.root(levels)[None, :], 0)  # (D, 8) subtree roots
        while cur.shape[0] > 1:  # the top of the tree, alike on every rank
            cur = p2.compress(cur[0::2], cur[1::2])
        return cur[0]

    return run


def can_commit(mesh: meshmod.Mesh, n: int) -> bool:
    """Whether a commitment of n-row columns shards over `mesh`: its LDE's
    rows must split evenly (shapes only, so every rank agrees)."""
    return (n << BLOWUP_LOG) % mesh.size == 0


def make_commit_cols_dist(mesh: meshmod.Mesh):
    """The prover's sharded ``commit_cols`` on `mesh`.

    The returned ``commit(cols_m, shift)`` takes the whole (k, n) Montgomery
    columns on every rank and returns (coeffs (k, n), lde (k, 4n), Merkle
    levels) equal to ``stark.prover.commit_cols``'s, on every rank.  Column
    counts that the mesh does not divide are zero-padded for the NTT stage
    and sliced back before hashing."""
    d = mesh.size

    def commit(cols_m: torch.Tensor, shift: int):
        if cols_m.device != mesh.device:
            raise ValueError(f"columns on {cols_m.device}, the mesh's rank on {mesh.device}")
        k, n = cols_m.shape
        m = n << BLOWUP_LOG
        assert can_commit(mesh, n), f"{m} LDE rows do not shard over {d} ranks"
        per = -(-k // d)
        mine = cols_m[mesh.rank * per : (mesh.rank + 1) * per]
        if mine.shape[0] < per:
            mine = torch.cat([mine, mine.new_zeros((per - mine.shape[0], n))])
        coeffs = nttmod.interpolate(mine)
        lde = nttmod.lde_from_coeffs(coeffs, BLOWUP_LOG, shift)
        both = meshmod.all_gather(mesh, torch.cat([coeffs.to(lde.dtype), lde], 1), 0)[:k]  # (k, n + m)
        coeffs_all = both[:, :n].to(coeffs.dtype).contiguous()
        lde_all = both[:, n:].contiguous()
        rows = m // d
        leaves = p2.hash_rows(lde_all[:, mesh.rank * rows : (mesh.rank + 1) * rows].T)
        return coeffs_all, lde_all, merkle.commit(meshmod.all_gather(mesh, leaves, 0))

    return commit
