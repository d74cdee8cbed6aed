"""Layouts between numpy, the plain torch versions and the CUDA kernels.

* The packing between the public layout (16-bit limbs in int64, as the
  reference's 16-bit limbs in u32) and the CUDA kernels' 32-bit limbs
  (carried as the bits of int32, since torch's uint32 lacks most ops).
  BLS12-381 uses 24 x 16 <-> 12 x 32 limbs and secp256k1 16 x 16 <-> 8 x 32.
  The Montgomery radix is the same either way (R = 2^384, R = 2^256), so
  only the packing changes.
* BabyBear arrays and 32-bit words (Keccak, SHA-256): numpy uint32 (the
  JAX package's layout) <-> torch int32 (the kernels' layout; a BabyBear
  element is < p < 2^31, a word any 32 bits).
"""

from __future__ import annotations

import numpy as np
import torch


MASK32 = 0xFFFFFFFF


def int32_bits(u32: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same 32 bits."""
    # map [2^31, 2^32) to the negative int32 with the same bits
    return (u32 - ((u32 >> 31) << 32)).to(torch.int32)


def uint32_values(words: torch.Tensor) -> torch.Tensor:
    """int32 (or int64) 32-bit words -> int64 values in [0, 2^32)."""
    return words.to(torch.int64) & MASK32


def pack32(limbs16: torch.Tensor) -> torch.Tensor:
    """(..., 2k) int64 16-bit limbs -> (..., k) int32 holding u32 limbs."""
    pairs = limbs16.reshape(limbs16.shape[:-1] + (-1, 2))
    return int32_bits(pairs[..., 0] | (pairs[..., 1] << 16))


def unpack32(words: torch.Tensor) -> torch.Tensor:
    """(..., k) int32 holding u32 limbs -> (..., 2k) int64 16-bit limbs."""
    u32 = uint32_values(words)
    return torch.stack([u32 & 0xFFFF, u32 >> 16], dim=-1).reshape(words.shape[:-1] + (-1,))


def words_from_numpy(arr, device) -> torch.Tensor:
    """32-bit words (numpy uint32: BabyBear values, hash words) -> an int32
    tensor on `device` (the same bits)."""
    words = np.ascontiguousarray(arr, dtype=np.uint32).view(np.int32)
    return torch.tensor(words, device=device)  # a copy: the array stays the caller's


def bb_to_numpy(t: torch.Tensor) -> np.ndarray:
    """BabyBear tensor (int32 or int64) -> numpy uint32."""
    return t.detach().cpu().numpy().astype(np.uint32)
