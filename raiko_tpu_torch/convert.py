"""State carried from the reference package into the port: numpy in, tensors out.

* The trusted-setup G1 points of ``raiko_tpu.kzg.eip4844.setup()`` as the
  port's (4096, 3, 24) Montgomery tensor.
* The packing between the public layout (16-bit limbs in int64, as the
  reference's 16-bit limbs in u32) and the CUDA kernels' 32-bit limbs
  (carried as the bits of int32, since torch's uint32 lacks most ops).
  BLS12-381 uses 24 x 16 <-> 12 x 32 limbs and secp256k1 16 x 16 <-> 8 x 32.
  The Montgomery radix is the same either way (R = 2^384, R = 2^256), so
  only the packing changes.
"""

from __future__ import annotations

import torch

from raiko_tpu.kzg import eip4844 as ref_eip4844

from .kzg import curve


def pack32(limbs16: torch.Tensor) -> torch.Tensor:
    """(..., 2k) int64 16-bit limbs -> (..., k) int32 holding u32 limbs."""
    pairs = limbs16.reshape(limbs16.shape[:-1] + (-1, 2))
    u32 = pairs[..., 0] | (pairs[..., 1] << 16)
    # map [2^31, 2^32) to the negative int32 with the same bits
    return (u32 - ((u32 >> 31) << 32)).to(torch.int32)


def unpack32(words: torch.Tensor) -> torch.Tensor:
    """(..., k) int32 holding u32 limbs -> (..., 2k) int64 16-bit limbs."""
    u32 = words.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([u32 & 0xFFFF, u32 >> 16], dim=-1).reshape(words.shape[:-1] + (-1,))


def setup_points(device) -> torch.Tensor:
    """The trusted setup's G1 Lagrange points, (4096, 3, 24) int64 Montgomery."""
    pts = curve.points_from_affine(ref_eip4844.setup()["g1_lagrange"])
    return torch.as_tensor(pts.astype("int64"), device=device)
