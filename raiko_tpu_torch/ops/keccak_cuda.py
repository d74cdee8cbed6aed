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

A permutation runs on a pair of lanes a state, bit-interleaved (each lane
keeps the even or the odd bits of the 25 lanes as 32-bit words; half the
stream a lane, twice the warps).  Absorbing has two layouts: the pair for
narrow batches, one thread a state for wide ones (``absorb_lanes``);
``keccak256_blocks_lanes`` runs one of them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels
from . import keccak as kk


# Lanes a state absorbing (csrc/keccak_f1600.cu): 2, a bit-interleaved
# pair, or 1.  On an H100 the pair absorbed MPT-node-sized messages faster
# up to PAIR_MAX_MESSAGES (8,192: 17.8-18.0 against 22.6-23.3 us), one
# thread a message from 16,384 (22.9-23.1 against 28.2 us; PERF.md)
LANE_CHOICES = (1, 2)
PAIR_MAX_MESSAGES = 8192


def absorb_lanes(b: int) -> int:
    """Lanes a state that ``keccak256_blocks`` absorbs `b` messages with."""
    return 2 if b <= PAIR_MAX_MESSAGES else 1


def _unzip64(v: int) -> tuple[int, int]:
    """(even bits, odd bits) of the 64-bit `v`, each as a 32-bit word."""
    even = sum(((v >> (2 * j)) & 1) << j for j in range(32))
    odd = sum(((v >> (2 * j + 1)) & 1) << j for j in range(32))
    return even, odd


@functools.lru_cache(maxsize=None)
def _round_constants(device: torch.device, lanes: int) -> torch.Tensor:
    """The 24 round constants as (24, 2) int32 words: (lo, hi) for one lane
    a state, (even bits, odd bits) for a pair."""
    if lanes == 1:
        words = kk._RC_ARR
    else:
        words = np.array([_unzip64(int(lo) | int(hi) << 32) for lo, hi in kk._RC_ARR], dtype=np.int64)
    return torch.as_tensor(words.astype(np.uint32).view(np.int32), device=device)


def _check_words(t: torch.Tensor, name: str, tail: tuple) -> None:
    """The kernel reads 64-bit lanes: 8-byte aligned int32 pairs."""
    kernels.check(t, name, torch.int32, tail)
    if t.data_ptr() % 8:
        raise ValueError(f"{name}: expected an 8-byte aligned tensor")


def _check_lanes(lanes: int) -> None:
    if lanes not in LANE_CHOICES:
        raise ValueError(f"keccak: lanes must be one of {LANE_CHOICES}, got {lanes}")


def keccak_f1600(state: torch.Tensor) -> torch.Tensor:
    """One Keccak-f[1600] of (B, 25, 2) int32 lo/hi words -> (B, 25, 2), on
    a pair of lanes a state on the card; the plain version on the CPU."""
    if state.dim() != 3 or state.shape[1:] != (25, 2) or state.dtype != torch.int32:
        raise ValueError(f"keccak_f1600: expected (B, 25, 2) int32, got {state.dtype} {tuple(state.shape)}")
    if state.device.type == "cpu":
        return kk.keccak_f1600_plain(state)
    _check_words(state, "keccak_f1600 state", (25, 2))
    out = torch.empty_like(state)
    if state.shape[0]:
        kernels.launch("raiko_keccak_f1600", "keccak_f1600", state, out, None, None,
                       _round_constants(state.device, 2), state.shape[0], 0, 2)
    return out


def keccak256_blocks(blocks: torch.Tensor, nblocks: torch.Tensor) -> torch.Tensor:
    """Keccak-256 of padded messages: blocks (B, T, 34) int32 rate-block
    words, message b absorbing its first nblocks[b] blocks ((B,) int32, 1 to
    T) -> (B, 8) int32 digest words."""
    return keccak256_blocks_lanes(blocks, nblocks, absorb_lanes(blocks.shape[0] if blocks.dim() else 0))


def keccak256_blocks_lanes(blocks: torch.Tensor, nblocks: torch.Tensor, lanes: int) -> torch.Tensor:
    """``keccak256_blocks`` with `lanes` lanes a state on the card; the plain
    version on the CPU."""
    if blocks.dim() != 3 or blocks.shape[2] != kk.WORDS or blocks.dtype != torch.int32:
        raise ValueError(f"keccak256_blocks: expected (B, T, 34) int32, got {blocks.dtype} "
                         f"{tuple(blocks.shape)}")
    if nblocks.shape != blocks.shape[:1] or nblocks.dtype != torch.int32:
        raise ValueError(f"keccak256_blocks: expected ({blocks.shape[0]},) int32 block counts")
    if blocks.device.type == "cpu":
        return kk.keccak256_blocks_plain(blocks, nblocks)
    _check_words(blocks, "keccak256_blocks blocks", (blocks.shape[1], kk.WORDS))
    kernels.check(nblocks, "keccak256_blocks nblocks", torch.int32, (blocks.shape[0],))
    _check_lanes(lanes)
    out = torch.empty((blocks.shape[0], 8), dtype=torch.int32, device=blocks.device)
    if blocks.shape[0]:
        kernels.launch("raiko_keccak_f1600", "keccak_f1600", None, out, blocks, nblocks,
                       _round_constants(blocks.device, lanes), blocks.shape[0], blocks.shape[1], lanes)
    return out
