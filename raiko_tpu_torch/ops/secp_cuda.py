"""secp256k1 Shamir ladder on the card: kernel B4 ``shamir_ladder``.

Counterpart of raiko_tpu/ops/secp_pallas.py; the CUDA source is
csrc/secp256k1_ladder.cu (its header note says what bounds the kernel on the
H100 and how the design answers it).  The kernel also completes the window
table [∞, T1, T2, T1+T2] from the two base points, the add that
raiko_tpu/ops/secp.py:_recover_launch_tpu ran before the Pallas ladder.

On a CUDA tensor the wrapper launches the kernel or raises; only a CPU tensor
goes to the plain version beside it, bit for bit the same result.
"""

from __future__ import annotations

import torch

from .. import convert, kernels
from . import secp

NLIMBS32 = 8


def shamir_ladder_plain(base: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain torch B4: table completion with ops/secp.add, then the
    ops/secp._shamir ladder."""
    b = convert.unpack32(base)
    table = torch.stack([secp.identity(b.shape[:1], b.device), b[:, 0], b[:, 1], secp.add(b[:, 0], b[:, 1])], dim=1)
    idx = idx.long()
    return convert.pack32(secp._shamir(table, idx & 1, idx >> 1))


def shamir_ladder(base: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched u1*T1 + u2*T2, one ladder per lane.

    base: (B, 2, 3, 8) int32 packed Montgomery projective [T1, T2]
    idx:  (256, B) int32 in 0..3, bit k of (u1, u2) packed as b1 + 2*b2,
          MSB first.
    Returns (B, 3, 8) packed projective points, bit-exact with
    ops/secp._shamir on the completed table."""
    if base.dim() != 4 or base.shape[1:] != (2, 3, NLIMBS32):
        raise ValueError(f"shamir_ladder: expected base (B, 2, 3, 8), got {base.shape}")
    if idx.shape != (256, base.shape[0]):
        raise ValueError(f"shamir_ladder: expected idx (256, {base.shape[0]}), got {idx.shape}")
    if base.device.type == "cpu" and idx.device.type == "cpu":
        return shamir_ladder_plain(base, idx)
    kernels.check(base, "shamir_ladder base", torch.int32, (2, 3, NLIMBS32))
    kernels.check(idx, "shamir_ladder idx", torch.int32, (base.shape[0],))
    out = torch.empty((base.shape[0], 3, NLIMBS32), dtype=torch.int32, device=base.device)
    if base.shape[0]:
        kernels.launch("raiko_secp256k1_shamir_ladder", "shamir_ladder", base, idx, out, base.shape[0])
    return out
