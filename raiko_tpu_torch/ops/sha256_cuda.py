"""SHA-256 compression on the card: kernel ``sha256_compress``.

Counterpart of raiko_tpu/ops/sha256.py sha256_compress_batch and the block
loop of _sha256_blocks (XLA in the JAX package; no Pallas kernel exists for
them).  The CUDA source is csrc/sha256.cu (its header note says what bounds
the kernel on the H100 and how the design answers it).

On a CUDA tensor the wrapper launches the kernel or raises; only a CPU
tensor goes to the plain version in ops/sha256.py, bit for bit the same
result.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels
from . import sha256 as sh


@functools.lru_cache(maxsize=None)
def _constants(device: torch.device) -> torch.Tensor:
    """K (64 words) then H0 (8 words), int32."""
    return torch.as_tensor(np.concatenate([sh.K, sh.H0]).view(np.int32), device=device)


def sha256_compress(state: torch.Tensor | None, blocks: torch.Tensor,
                    nblocks: torch.Tensor) -> torch.Tensor:
    """From state (B, 8) int32 words (H0 where None), compress message b's
    first nblocks[b] ((B,) int32, at most T) of blocks (B, T, 16) int32
    big-endian words -> (B, 8) int32."""
    if blocks.dim() != 3 or blocks.shape[2] != 16 or blocks.dtype != torch.int32:
        raise ValueError(f"sha256_compress: expected (B, T, 16) int32 blocks, got {blocks.dtype} "
                         f"{tuple(blocks.shape)}")
    bsz = blocks.shape[0]
    if state is not None and (state.shape != (bsz, 8) or state.dtype != torch.int32):
        raise ValueError(f"sha256_compress: expected a ({bsz}, 8) int32 state, got {state.dtype} "
                         f"{tuple(state.shape)}")
    if nblocks.shape != (bsz,) or nblocks.dtype != torch.int32:
        raise ValueError(f"sha256_compress: expected ({bsz},) int32 block counts")
    if blocks.device.type == "cpu":
        return sh.sha256_blocks_plain(state, blocks, nblocks)
    kernels.check(blocks, "sha256_compress blocks", torch.int32, (blocks.shape[1], 16))
    if state is not None:
        kernels.check(state, "sha256_compress state", torch.int32, (8,))
    kernels.check(nblocks, "sha256_compress nblocks", torch.int32, (bsz,))
    out = torch.empty((bsz, 8), dtype=torch.int32, device=blocks.device)
    if bsz:
        kernels.launch("raiko_sha256_compress", "sha256_compress", state, out, blocks, nblocks,
                       _constants(blocks.device), bsz, blocks.shape[1])
    return out
