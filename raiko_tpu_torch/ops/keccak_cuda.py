"""Keccak-f[1600] on the card: kernel ``keccak_f1600``.

Counterpart of raiko_tpu/ops/keccak.py keccak_f1600_batch and the absorb
loop of _keccak256_blocks (XLA in the JAX package; no Pallas kernel exists
for them).  The CUDA source is csrc/keccak_f1600.cu (its header note says
what bounds the kernel on the H100 and how the design answers it).

One C entry serves both wrappers: one permutation of given states, or
Keccak-256's absorb and squeeze over each message's own number of rate
blocks.  On a CUDA tensor a wrapper launches the kernel or raises; only a
CPU tensor goes to the plain version in ops/keccak.py, bit for bit the same
result.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels
from . import keccak as kk


@functools.lru_cache(maxsize=None)
def _round_constants(device: torch.device) -> torch.Tensor:
    """The 24 round constants as (24, 2) int32 lo/hi words."""
    return torch.as_tensor(kk._RC_ARR.astype(np.uint32).view(np.int32), device=device)


def _check_words(t: torch.Tensor, name: str, tail: tuple) -> None:
    """The kernel reads 64-bit lanes: 8-byte aligned int32 pairs."""
    kernels.check(t, name, torch.int32, tail)
    if t.data_ptr() % 8:
        raise ValueError(f"{name}: expected an 8-byte aligned tensor")


def keccak_f1600(state: torch.Tensor) -> torch.Tensor:
    """One Keccak-f[1600] of (B, 25, 2) int32 lo/hi words -> (B, 25, 2)."""
    if state.dim() != 3 or state.shape[1:] != (25, 2) or state.dtype != torch.int32:
        raise ValueError(f"keccak_f1600: expected (B, 25, 2) int32, got {state.dtype} {tuple(state.shape)}")
    if state.device.type == "cpu":
        return kk.keccak_f1600_plain(state)
    _check_words(state, "keccak_f1600 state", (25, 2))
    out = torch.empty_like(state)
    if state.shape[0]:
        kernels.launch("raiko_keccak_f1600", "keccak_f1600", state, out, None, None,
                       _round_constants(state.device), state.shape[0], 0, 25)
    return out


def keccak256_blocks(blocks: torch.Tensor, nblocks: torch.Tensor) -> torch.Tensor:
    """Keccak-256 of padded messages: blocks (B, T, 34) int32 rate-block
    words, message b absorbing its first nblocks[b] blocks ((B,) int32, 1 to
    T) -> (B, 8) int32 digest words."""
    if blocks.dim() != 3 or blocks.shape[2] != kk.WORDS or blocks.dtype != torch.int32:
        raise ValueError(f"keccak256_blocks: expected (B, T, 34) int32, got {blocks.dtype} "
                         f"{tuple(blocks.shape)}")
    if nblocks.shape != blocks.shape[:1] or nblocks.dtype != torch.int32:
        raise ValueError(f"keccak256_blocks: expected ({blocks.shape[0]},) int32 block counts")
    if blocks.device.type == "cpu":
        return kk.keccak256_blocks_plain(blocks, nblocks)
    _check_words(blocks, "keccak256_blocks blocks", (blocks.shape[1], kk.WORDS))
    kernels.check(nblocks, "keccak256_blocks nblocks", torch.int32, (blocks.shape[0],))
    out = torch.empty((blocks.shape[0], 8), dtype=torch.int32, device=blocks.device)
    if blocks.shape[0]:
        kernels.launch("raiko_keccak_f1600", "keccak_f1600", None, out, blocks, nblocks,
                       _round_constants(blocks.device), blocks.shape[0], blocks.shape[1], 4)
    return out
