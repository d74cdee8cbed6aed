"""SHA-256 compression on the card: kernel ``sha256_compress``.

Counterpart of raiko_tpu/ops/sha256.py sha256_compress_batch and the block
loop of _sha256_blocks (XLA in the JAX package; no Pallas kernel exists for
them).  The CUDA source is csrc/sha256.cu (its header note says what bounds
the kernel on the H100 and how the design answers it).

On a CUDA tensor the wrapper launches the kernel or raises; only a CPU
tensor goes to the plain version in ops/sha256.py, bit for bit the same
result.

Two layouts of the kernel, chosen by width and block count
(``compress_layout``): "split", a schedule warp that hands K + W to a round
warp through shared memory, so that the round chain's own stream is
shorter and a message's blocks follow each other with their schedules
ready, for narrow batches of multi-block messages; "thread", one thread a
message with the fewest instructions, for one-block messages and for wide
batches where the card is full.  ``sha256_compress_layout`` runs one
layout.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels
from . import sha256 as sh

# "split" for up to SPLIT_MAX_B messages of more than one block, "thread"
# otherwise.  On an H100, mixes of 0-299 bytes (one to five blocks): split
# 8.7-9.1 us at 1,024 to 8,192 messages, thread 10.9-11.1; at 16,384 split
# 12.2-12.4, thread 11.0-11.2, and thread ever further ahead above.
# One-block messages ran the same in either layout within the runs' spread
# up to 8,192 (3.7-4.1 us), where the parent's thread code stays (PERF.md)
LAYOUTS = ("split", "thread")
SPLIT_MAX_B = 8192


@functools.lru_cache(maxsize=None)
def _constants(device: torch.device) -> torch.Tensor:
    """K (64 words) then H0 (8 words), int32."""
    return torch.as_tensor(np.concatenate([sh.K, sh.H0]).view(np.int32), device=device)


def compress_layout(b: int, t: int) -> str:
    """The layout that ``sha256_compress`` runs `b` messages of at most `t`
    blocks in."""
    return "split" if b <= SPLIT_MAX_B and t > 1 else "thread"


def sha256_compress(state: torch.Tensor | None, blocks: torch.Tensor,
                    nblocks: torch.Tensor) -> torch.Tensor:
    """From state (B, 8) int32 words (H0 where None), compress message b's
    first nblocks[b] ((B,) int32, at most T) of blocks (B, T, 16) int32
    big-endian words -> (B, 8) int32."""
    layout = compress_layout(*blocks.shape[:2]) if blocks.dim() == 3 else "thread"
    return sha256_compress_layout(state, blocks, nblocks, layout)


def sha256_compress_layout(state: torch.Tensor | None, blocks: torch.Tensor, nblocks: torch.Tensor,
                           layout: str) -> torch.Tensor:
    """``sha256_compress`` in `layout` (one of LAYOUTS) on the card; the
    plain version on the CPU."""
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
    if layout not in LAYOUTS:
        raise ValueError(f"sha256_compress: layout must be one of {LAYOUTS}, got {layout!r}")
    out = torch.empty((bsz, 8), dtype=torch.int32, device=blocks.device)
    if bsz:
        kernels.launch("raiko_sha256_compress", "sha256_compress", state, out, blocks, nblocks,
                       _constants(blocks.device), bsz, blocks.shape[1], int(layout == "split"))
    return out
