"""Merkle tree commitment over Poseidon2 digests.

Port of raiko_tpu/ops/merkle.py: vector commitments for STARK trace
layers.  Each level halves the node count by compressing sibling pairs
(the port's plain version of its ``poseidon2_merkle`` kernel).  Leaves
arrive in bit-reversed LDE order,
which makes sibling pairs adjacent rows: a level's (n, 8) digests viewed
as (n/2, 16) are its pairs, with no gather.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import babybear as bb
from . import poseidon2 as p2


def commit(leaves: torch.Tensor) -> list[torch.Tensor]:
    """Build all levels.  leaves: (N, 8) Montgomery, N a power of two.

    Returns [leaves, level1, ..., root] where root has shape (1, 8)."""
    n = leaves.shape[0]
    if leaves.dim() != 2 or leaves.shape[1] != p2.OUT or n < 1 or n & (n - 1):
        raise ValueError(f"merkle.commit: expected (N, 8) leaves, N a power of two, got {tuple(leaves.shape)}")
    levels, cur = [leaves], leaves
    while cur.shape[0] > 1:
        cur = p2.compress_plain(cur.reshape(cur.shape[0] // 2, p2.WIDTH))
        levels.append(cur)
    return levels


def root(levels: list[torch.Tensor]) -> torch.Tensor:
    return levels[-1][0]


def open_path(levels: list[torch.Tensor], index: int) -> list[np.ndarray]:
    """Authentication path for leaf ``index`` (Montgomery form, host)."""
    path = []
    for lvl in levels[:-1]:
        path.append(lvl[index ^ 1].cpu().numpy().astype(np.uint32))
        index >>= 1
    return path


def open_paths(levels: list[torch.Tensor], indices: list[int]) -> list[list[np.ndarray]]:
    """Authentication paths for many leaves in standard form (the proof
    wire format): one gather and one transfer per tree level."""
    idx = np.asarray(indices, np.int64)
    per_level = []
    for lvl in levels[:-1]:
        sib = torch.as_tensor(idx ^ 1, device=lvl.device)
        per_level.append(bb.from_mont(lvl.index_select(0, sib)).cpu().numpy().astype(np.uint32))
        idx = idx >> 1
    return [[lv[q] for lv in per_level] for q in range(len(indices))]


def verify_path(leaf: np.ndarray, index: int, path: list[np.ndarray], expected_root: np.ndarray) -> bool:
    """Host-side path verification (Montgomery digests, CPU compression)."""
    cur = torch.as_tensor(np.asarray(leaf).astype(np.int64)).reshape(1, p2.OUT)
    for sib in path:
        s = torch.as_tensor(np.asarray(sib).astype(np.int64)).reshape(1, p2.OUT)
        cur = p2.compress(s, cur) if index & 1 else p2.compress(cur, s)
        index >>= 1
    return bool((cur[0].numpy() == np.asarray(expected_root).astype(np.int64)).all())
