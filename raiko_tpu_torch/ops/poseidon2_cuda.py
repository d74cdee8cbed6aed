"""Poseidon2 on the card: ``poseidon2_hash_rows``, ``poseidon2_compress`` and
``poseidon2_merkle``.

Counterparts of raiko_tpu/ops/poseidon2.py hash_rows and compress (XLA in
the JAX package; no Pallas kernel exists for them), hand-written because
the STARK commitment's time goes there.  The CUDA source is
csrc/babybear_poseidon2.cu (its header note says what bounds the kernels on
the H100 and how the design answers it).

``poseidon2_hash_rows`` runs each row's sponge on a group of four lanes,
one M4 block of the state per lane, so the commitment's 4,096 rows fill a
warp on every scheduler of the card; with one warp each, the lanes' chain of
dependent instructions bounds it, not the multiply rate (92 registers; 1.65
ms at 4,096 x 4,160 on an H100, PERF.md).  ``poseidon2_compress`` runs each
state's permutation on such a group too.  ``poseidon2_merkle`` builds every
level of a Merkle tree in one launch: a block builds the levels of a
subtree in shared memory, and the last block to finish among siblings goes
on with their parent subtree (a ticket counter the wrapper zeroes), so the
tree costs one permutation's latency per level and no launch per level.

On a CUDA tensor a wrapper launches its kernel or raises; only a CPU tensor
goes to the plain version in ops/poseidon2.py, bit for bit the same result.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels
from . import poseidon2 as p2


@functools.lru_cache(maxsize=None)
def _constants(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(p2.packed_constants().astype(np.int32), device=device)


def poseidon2_hash_rows(rows: torch.Tensor) -> torch.Tensor:
    """(B, W) Montgomery rows -> (B, 8) int32 sponge digests, bit-exact with
    raiko_tpu/ops/poseidon2.py:hash_rows.  On the card ``rows`` is int32 with
    any non-negative strides: the kernel reads element (i, w) at
    i·stride(0) + w·stride(1), so a transposed view costs no copy."""
    if rows.dim() != 2:
        raise ValueError(f"poseidon2_hash_rows: expected (B, W), got {tuple(rows.shape)}")
    if rows.device.type == "cpu":
        return p2.hash_rows_plain(rows)
    if rows.device.type != "cuda" or rows.dtype != torch.int32:
        raise ValueError(f"poseidon2_hash_rows: expected CUDA int32, got {rows.device} {rows.dtype}")
    if rows.device.index != torch.cuda.current_device():
        raise ValueError(f"poseidon2_hash_rows: tensor on {rows.device}, but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if min(rows.stride()) < 0:
        raise ValueError("poseidon2_hash_rows: negative strides are not supported")
    bsz, width = rows.shape
    out = torch.empty((bsz, p2.OUT), dtype=torch.int32, device=rows.device)
    if bsz:
        kernels.launch("raiko_poseidon2_hash_rows", "poseidon2_hash_rows", rows, out,
                       _constants(rows.device), bsz, width, rows.stride(0), rows.stride(1),
                       p2.width_separator(width))
    return out


def poseidon2_compress(state: torch.Tensor) -> torch.Tensor:
    """(n, 16) concatenated (left, right) digests -> (n, 8) int32: the
    truncated permutation, bit-exact with raiko_tpu/ops/poseidon2.py:compress."""
    if state.dim() != 2 or state.shape[1] != p2.WIDTH:
        raise ValueError(f"poseidon2_compress: expected (n, 16), got {tuple(state.shape)}")
    if state.device.type == "cpu":
        return p2.compress_plain(state)
    kernels.check(state, "poseidon2_compress", torch.int32, (p2.WIDTH,))
    out = torch.empty((state.shape[0], p2.OUT), dtype=torch.int32, device=state.device)
    if state.shape[0]:
        kernels.launch("raiko_poseidon2_compress", "poseidon2_compress", kernels.aligned(state), out,
                       _constants(state.device), state.shape[0])
    return out


def poseidon2_merkle_plain(leaves: torch.Tensor) -> torch.Tensor:
    """Plain torch Merkle tree: the internal nodes of the tree over (N, 8)
    leaves, level by level from the leaves' parents to the root, as one
    (N - 1, 8) int32 tensor."""
    levels, cur = [], leaves
    while cur.shape[0] > 1:
        cur = p2.compress_plain(cur.reshape(cur.shape[0] // 2, p2.WIDTH))
        levels.append(cur)
    return torch.cat(levels) if levels else torch.empty((0, p2.OUT), dtype=torch.int32, device=leaves.device)


def poseidon2_merkle(leaves: torch.Tensor) -> torch.Tensor:
    """(N, 8) Montgomery leaves, N a power of two -> the (N - 1, 8) int32
    internal nodes of their Merkle tree, level 1 (the leaves' parents)
    first and the root last; each level's node i compresses nodes 2i and
    2i + 1 of the level below, bit-exact with raiko_tpu/ops/merkle.py:commit.
    One launch on the card."""
    if leaves.dim() != 2 or leaves.shape[1] != p2.OUT:
        raise ValueError(f"poseidon2_merkle: expected (N, 8), got {tuple(leaves.shape)}")
    n = leaves.shape[0]
    if n < 1 or n & (n - 1):
        raise ValueError(f"poseidon2_merkle: leaf count must be a power of two, got {n}")
    if leaves.device.type == "cpu":
        return poseidon2_merkle_plain(leaves)
    kernels.check(leaves, "poseidon2_merkle", torch.int32, (p2.OUT,))
    out = torch.empty((n - 1, p2.OUT), dtype=torch.int32, device=leaves.device)
    if n > 1:
        tickets = torch.zeros(n // 2, dtype=torch.int32, device=leaves.device)
        kernels.launch("raiko_poseidon2_merkle", "poseidon2_merkle", kernels.aligned(leaves), out,
                       _constants(leaves.device), n.bit_length() - 1, tickets)
    return out
