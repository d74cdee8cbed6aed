"""Batched Keccak-256 on torch tensors, lane-parallel over many messages.

Port of raiko_tpu/ops/keccak.py: the batched hash of MPT nodes, headers and
the protocol instance (reference lib/src/primitives/keccak.rs:34-38,
mpt.rs:117-121), bit-exact with the host keccak (utils/keccak_py.py, whose
derived constants it uses).

Layouts are the reference's: a state is (B, 25, 2) 32-bit words, lane
x + 5y split into (lo, hi); a rate block is 34 little-endian words (17
lanes as lo/hi pairs); a digest is 8 little-endian words.  Words are
carried as the bits of int32 (convert.int32_bits), the kernel's layout.

On a CUDA tensor the wrappers in ops/keccak_cuda.py launch the kernel
(csrc/keccak_f1600.cu) or raise; on a CPU tensor they run the plain
versions here, the reference's whole-state formulation in int64 holding
32-bit words: theta's column parities and rolled neighbours, rho's per-lane
rotation, pi's static gather, chi's row mix and iota.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import convert
from ..convert import MASK32
from ..utils.keccak_py import RHO_OFFSETS, ROUND_CONSTANTS
from . import keccak_cuda

RATE = 136  # bytes, Keccak-256
WORDS = RATE // 4

# per-lane rho rotation amounts, lane = x + 5y
_RHO_VEC = np.array([RHO_OFFSETS[i % 5][i // 5] for i in range(25)], dtype=np.int64)
# pi: lane j receives lane _PI_SRC[j]
_PI_SRC = np.zeros(25, dtype=np.int64)
for _x in range(5):
    for _y in range(5):
        _PI_SRC[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _x + 5 * _y
_RC_ARR = np.array([[rc & MASK32, rc >> 32] for rc in ROUND_CONSTANTS], dtype=np.int64)


def _rot_pair(lo, hi, n):
    """Rotate (lo, hi) 32-bit halves, held in int64, left by per-lane
    amounts n in [0, 64).  Every value is non-negative, so >> is logical."""
    swap = n >= 32
    lo1 = torch.where(swap, hi, lo)
    hi1 = torch.where(swap, lo, hi)
    m = n & 31
    return (((lo1 << m) & MASK32) | (hi1 >> (32 - m)),
            ((hi1 << m) & MASK32) | (lo1 >> (32 - m)))


def _permute(lo: torch.Tensor, hi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Keccak-f[1600] on (B, 25) int64 halves."""
    bsz = lo.shape[0]
    rho = torch.as_tensor(_RHO_VEC, device=lo.device)
    pi_src = torch.as_tensor(_PI_SRC, device=lo.device)
    for rc_lo, rc_hi in _RC_ARR.tolist():
        # theta: column parities, mixed with their rotated neighbours
        g_lo, g_hi = lo.reshape(bsz, 5, 5), hi.reshape(bsz, 5, 5)  # [y][x]
        c_lo = g_lo[:, 0] ^ g_lo[:, 1] ^ g_lo[:, 2] ^ g_lo[:, 3] ^ g_lo[:, 4]
        c_hi = g_hi[:, 0] ^ g_hi[:, 1] ^ g_hi[:, 2] ^ g_hi[:, 3] ^ g_hi[:, 4]
        r_lo = ((c_lo << 1) & MASK32) | (c_hi >> 31)
        r_hi = ((c_hi << 1) & MASK32) | (c_lo >> 31)
        d_lo = torch.roll(c_lo, 1, 1) ^ torch.roll(r_lo, -1, 1)
        d_hi = torch.roll(c_hi, 1, 1) ^ torch.roll(r_hi, -1, 1)
        lo = (g_lo ^ d_lo[:, None, :]).reshape(bsz, 25)
        hi = (g_hi ^ d_hi[:, None, :]).reshape(bsz, 25)
        # rho, pi
        lo, hi = _rot_pair(lo, hi, rho)
        lo, hi = lo[:, pi_src], hi[:, pi_src]
        # chi
        g_lo, g_hi = lo.reshape(bsz, 5, 5), hi.reshape(bsz, 5, 5)
        lo = (g_lo ^ (~torch.roll(g_lo, -1, 2) & torch.roll(g_lo, -2, 2))).reshape(bsz, 25)
        hi = (g_hi ^ (~torch.roll(g_hi, -1, 2) & torch.roll(g_hi, -2, 2))).reshape(bsz, 25)
        # iota
        lo[:, 0] ^= rc_lo
        hi[:, 0] ^= rc_hi
    return lo, hi


def keccak_f1600_plain(state: torch.Tensor) -> torch.Tensor:
    """Plain torch Keccak-f[1600] of (B, 25, 2) words -> (B, 25, 2) int32."""
    u = convert.uint32_values(state)
    lo, hi = _permute(u[:, :, 0], u[:, :, 1])
    return convert.int32_bits(torch.stack([lo, hi], dim=-1))


def keccak256_blocks_plain(blocks: torch.Tensor, nblocks: torch.Tensor) -> torch.Tensor:
    """Plain absorb-and-squeeze: blocks (B, T, 34) padded rate blocks,
    message b using its first nblocks[b] -> (B, 8) int32 digest words."""
    bsz, nmax, _ = blocks.shape
    words = convert.uint32_values(blocks).reshape(bsz, nmax, 17, 2)
    lo = torch.zeros((bsz, 25), dtype=torch.int64, device=blocks.device)
    hi = torch.zeros_like(lo)
    for t in range(nmax):
        nlo, nhi = lo.clone(), hi.clone()
        nlo[:, :17] ^= words[:, t, :, 0]
        nhi[:, :17] ^= words[:, t, :, 1]
        nlo, nhi = _permute(nlo, nhi)
        live = (nblocks > t)[:, None]
        lo, hi = torch.where(live, nlo, lo), torch.where(live, nhi, hi)
    return convert.int32_bits(torch.stack([lo[:, :4], hi[:, :4]], dim=-1).reshape(bsz, 8))


def keccak_f1600_batch(state: torch.Tensor) -> torch.Tensor:
    """One permutation over a batch: state (B, 25, 2) int32 words, [..., 0]
    the low half of each lane -> (B, 25, 2) int32."""
    return keccak_cuda.keccak_f1600(state)


def _nblocks(length: int) -> int:
    return length // RATE + 1


def _pad_into(buf: np.ndarray, msg: bytes, nblocks: int) -> None:
    buf[: len(msg)] = np.frombuffer(msg, dtype=np.uint8)
    buf[len(msg)] ^= 0x01
    buf[nblocks * RATE - 1] ^= 0x80


def pack_messages(msgs: list[bytes]) -> tuple[np.ndarray, int]:
    """Pad messages of one block count into ((B, nblocks, 34) uint32 words,
    nblocks), the reference's layout; raises on mixed block counts."""
    nblocks = max(_nblocks(len(m)) for m in msgs)
    if any(_nblocks(len(m)) != nblocks for m in msgs):
        raise ValueError("pack_messages: group messages by block count before packing")
    buf = np.zeros((len(msgs), nblocks * RATE), dtype=np.uint8)
    for i, m in enumerate(msgs):
        _pad_into(buf[i], m, nblocks)
    return buf.view(np.uint32).reshape(len(msgs), nblocks, WORDS), nblocks


def pack_ragged(msgs: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    """Pad messages of any lengths into ((B, T, 34) uint32 words, (B,)
    int32 block counts), T the largest count: the zero blocks past a
    message's own count are never absorbed."""
    counts = np.array([_nblocks(len(m)) for m in msgs], dtype=np.int32)
    buf = np.zeros((len(msgs), int(counts.max()) * RATE), dtype=np.uint8)
    for i, m in enumerate(msgs):
        _pad_into(buf[i], m, int(counts[i]))
    return buf.view(np.uint32).reshape(len(msgs), -1, WORDS), counts


def keccak256_batch(msgs: list[bytes], device) -> list[bytes]:
    """Keccak-256 of each message, all in one batch on `device` (the
    counterpart of raiko_tpu/ops/keccak.py:keccak256_tpu, which grouped the
    batch by block count; here one launch absorbs every message's own
    number of blocks).  Bit-exact with the host keccak."""
    if not msgs:
        return []
    words, counts = pack_ragged(msgs)
    digests = keccak_cuda.keccak256_blocks(convert.words_from_numpy(words, device),
                                           torch.as_tensor(counts, device=device))
    raw = digests.cpu().numpy().astype("<i4").tobytes()
    return [raw[32 * i : 32 * i + 32] for i in range(len(msgs))]


def keccak256_fixed(data: torch.Tensor) -> torch.Tensor:
    """Keccak-256 of each row of data, (B, L) uint8 with L < 136, on the
    tensor's device with no host round trip -> (B, 8) int32 digest words."""
    if data.dim() != 2 or data.dtype != torch.uint8 or data.shape[1] >= RATE:
        raise ValueError(f"keccak256_fixed: expected (B, L < {RATE}) uint8, got {data.dtype} "
                         f"{tuple(data.shape)}")
    bsz, length = data.shape
    padded = torch.zeros((bsz, RATE), dtype=torch.uint8, device=data.device)
    padded[:, :length] = data
    padded[:, length] ^= 0x01
    padded[:, RATE - 1] ^= 0x80
    return keccak_cuda.keccak256_blocks(padded.view(torch.int32).reshape(bsz, 1, WORDS),
                                        torch.ones((bsz,), dtype=torch.int32, device=data.device))
