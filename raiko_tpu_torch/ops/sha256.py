"""Batched SHA-256 on torch tensors.

Port of raiko_tpu/ops/sha256.py: the batch side of the EIP-4844 hashes
(commitments to versioned hashes, reference lib/src/primitives/
eip4844.rs:44-48,91-95); small host-side hashes use hashlib.  The constants
are derived (integer cube and square roots of the first primes), as the
reference derives them.

Layouts are the reference's: a state is (B, 8) words, a block (B, 16)
big-endian message words, carried as the bits of int32 (the kernel's
layout).  On a CUDA tensor the wrappers in ops/sha256_cuda.py launch the
kernel (csrc/sha256.cu) or raise; on a CPU tensor they run the plain
version here, the reference's schedule expansion and 64 rounds in int64
holding 32-bit words.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import convert
from ..convert import MASK32
from . import sha256_cuda


def _primes(n: int) -> list[int]:
    ps, c = [], 2
    while len(ps) < n:
        if all(c % p for p in ps):
            ps.append(c)
        c += 1
    return ps


def _iroot(x: int, k: int) -> int:
    """Integer k-th root by Newton's iteration on Python ints."""
    if x == 0:
        return 0
    r = 1 << ((x.bit_length() + k - 1) // k)
    while True:
        nr = ((k - 1) * r + x // r ** (k - 1)) // k
        if nr >= r:
            return r
        r = nr


# frac(cbrt(p))·2^32 of the first 64 primes, frac(sqrt(p))·2^32 of the first 8
K = np.array([_iroot(p << 96, 3) & MASK32 for p in _primes(64)], dtype=np.uint32)
H0 = np.array([_iroot(p << 64, 2) & MASK32 for p in _primes(8)], dtype=np.uint32)


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x >> n) | ((x << (32 - n)) & MASK32)


def _compress(state: list[torch.Tensor], w: list[torch.Tensor]) -> list[torch.Tensor]:
    """One compression of int64 words: state 8 x (B,), w 16 x (B,)."""
    w = list(w)
    for i in range(16, 64):
        s0 = _rotr(w[i - 15], 7) ^ _rotr(w[i - 15], 18) ^ (w[i - 15] >> 3)
        s1 = _rotr(w[i - 2], 17) ^ _rotr(w[i - 2], 19) ^ (w[i - 2] >> 10)
        w.append((w[i - 16] + s0 + w[i - 7] + s1) & MASK32)
    a, b, c, d, e, f, g, h = state
    for k_i, w_i in zip(K.tolist(), w):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = h + s1 + ch + k_i + w_i
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        a, b, c, d, e, f, g, h = (t1 + s0 + maj) & MASK32, a, b, c, (d + t1) & MASK32, e, f, g
    return [(x + y) & MASK32 for x, y in zip(state, (a, b, c, d, e, f, g, h))]


def sha256_blocks_plain(state: torch.Tensor | None, blocks: torch.Tensor,
                        nblocks: torch.Tensor) -> torch.Tensor:
    """Plain torch compression chain: from state (B, 8) words (H0 where
    None), compress message b's first nblocks[b] of blocks (B, T, 16) ->
    (B, 8) int32 words."""
    bsz, nmax, _ = blocks.shape
    if state is None:
        st = convert.uint32_values(torch.as_tensor(H0.astype(np.int64), device=blocks.device)).expand(bsz, 8)
    else:
        st = convert.uint32_values(state)
    words = convert.uint32_values(blocks)
    cur = [st[:, i] for i in range(8)]
    for t in range(nmax):
        new = _compress(cur, [words[:, t, i] for i in range(16)])
        live = nblocks > t
        cur = [torch.where(live, n, c) for n, c in zip(new, cur)]
    return convert.int32_bits(torch.stack(cur, dim=1))


def sha256_compress_batch(state: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """One compression: state (B, 8), block (B, 16) big-endian words, both
    int32 -> (B, 8) int32."""
    if block.dim() != 2 or block.shape[1] != 16:
        raise ValueError(f"sha256_compress_batch: expected a (B, 16) block, got {tuple(block.shape)}")
    return sha256_cuda.sha256_compress(state, block.reshape(block.shape[0], 1, 16),
                                       torch.ones((block.shape[0],), dtype=torch.int32, device=block.device))


def _nblocks(length: int) -> int:
    return (length + 8) // 64 + 1


def _words(buf: np.ndarray) -> np.ndarray:
    """(..., 64·T) bytes -> (..., T, 16) big-endian uint32 words."""
    return buf.view(">u4").astype(np.uint32).reshape(buf.shape[:-1] + (-1, 16))


def _pad_into(buf: np.ndarray, msg: bytes, nblocks: int) -> None:
    buf[: len(msg)] = np.frombuffer(msg, dtype=np.uint8)
    buf[len(msg)] = 0x80
    end = 64 * nblocks
    buf[end - 8 : end] = np.frombuffer((8 * len(msg)).to_bytes(8, "big"), dtype=np.uint8)


def pack_messages(msgs: list[bytes]) -> tuple[np.ndarray, int]:
    """Pad messages of one block count into ((B, nblocks, 16) big-endian
    uint32 words, nblocks), the reference's layout; raises on mixed counts."""
    nblocks = max(_nblocks(len(m)) for m in msgs)
    if any(_nblocks(len(m)) != nblocks for m in msgs):
        raise ValueError("pack_messages: group messages by block count before packing")
    buf = np.zeros((len(msgs), 64 * nblocks), dtype=np.uint8)
    for i, m in enumerate(msgs):
        _pad_into(buf[i], m, nblocks)
    return _words(buf), nblocks


def pack_ragged(msgs: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    """Pad messages of any lengths into ((B, T, 16) words, (B,) int32 block
    counts), T the largest count."""
    counts = np.array([_nblocks(len(m)) for m in msgs], dtype=np.int32)
    buf = np.zeros((len(msgs), 64 * int(counts.max())), dtype=np.uint8)
    for i, m in enumerate(msgs):
        _pad_into(buf[i], m, int(counts[i]))
    return _words(buf), counts


def sha256_batch(msgs: list[bytes], device) -> list[bytes]:
    """SHA-256 of each message, all in one batch on `device` (the
    counterpart of raiko_tpu/ops/sha256.py:sha256_tpu, which grouped the
    batch by block count; here one launch compresses every message's own
    number of blocks).  Bit-exact with hashlib."""
    if not msgs:
        return []
    words, counts = pack_ragged(msgs)
    digests = sha256_cuda.sha256_compress(None, convert.words_from_numpy(words, device),
                                          torch.as_tensor(counts, device=device))
    raw = digests.cpu().numpy().view(np.uint32).astype(">u4").tobytes()
    return [raw[32 * i : 32 * i + 32] for i in range(len(msgs))]
