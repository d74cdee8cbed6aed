"""Poseidon2 on the card: ``poseidon2_hash_rows`` and ``poseidon2_compress``.

Counterparts of raiko_tpu/ops/poseidon2.py hash_rows and compress (XLA in
the JAX package; no Pallas kernel exists for them), hand-written because
the STARK commitment's time goes there.  The CUDA source is
csrc/babybear_poseidon2.cu (its header note says what bounds the kernels on
the H100 and how the design answers it).

``poseidon2_hash_rows`` runs each row's sponge on a group of four lanes,
one M4 block of the state per lane, so the commitment's 4,096 rows fill a
warp on every scheduler of the card; with one warp each, the lanes' chain of
dependent instructions bounds it, not the multiply rate (92 registers; 1.65
ms at 4,096 x 4,160 on an H100, PERF.md).  ``poseidon2_compress`` runs one
pair per thread.

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
        kernels.launch("raiko_poseidon2_compress", "poseidon2_compress", state, out,
                       _constants(state.device), state.shape[0])
    return out
