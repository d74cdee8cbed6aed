"""Poseidon2 permutation over BabyBear on torch tensors.

Port of raiko_tpu/ops/poseidon2.py: the STARK commitment's hash, width 16,
S-box x^7, 8 external rounds (4 + 4) around 13 internal rounds, the M4
circulant external layer and the ``sum + mu_i * x_i`` internal layer.  The
round constants and the internal diagonal are the reference's, derived
here the same way (SHA-256 in counter mode over the reference's domain
tag), so outputs agree bit for bit.

``hash_rows`` (the row sponge) and ``compress`` (the Merkle 2-to-1
compression) run the port's plain versions, the only ones the frozen copy
keeps.  Tensors hold Montgomery-form elements, batch axis first; digests
come back int32.

The host (Python int / numpy) helpers are copies of the reference's.
"""

from __future__ import annotations

import functools
import hashlib

import numpy as np
import torch

from ..fields import babybear as bb

WIDTH = 16
RATE = 8
OUT = 8
ROUNDS_F = 8  # external (full) rounds, split 4 + 4
ROUNDS_P = 13  # internal (partial) rounds
ALPHA = 7

_DOMAIN = b"raiko-tpu/poseidon2/babybear/v1"


def _prf_field_elements(tag: bytes, n: int) -> np.ndarray:
    """n BabyBear elements from SHA-256(domain || tag || counter), rejection
    sampled to remove modulo bias."""
    out = []
    ctr = 0
    while len(out) < n:
        h = hashlib.sha256(_DOMAIN + b"/" + tag + ctr.to_bytes(4, "big")).digest()
        for off in range(0, 32, 4):
            v = int.from_bytes(h[off : off + 4], "big")
            # rejection sample: accept v < floor(2^32/p)*p
            if v < (2**32 // bb.P) * bb.P:
                out.append(v % bb.P)
                if len(out) == n:
                    break
        ctr += 1
    return np.array(out, dtype=np.uint32)


@functools.lru_cache(maxsize=1)
def _derive_constants():
    """(external rc (8, 16), internal rc (13,), mu (16,)), Montgomery form."""
    ext = _prf_field_elements(b"external-rc", ROUNDS_F * WIDTH).reshape(ROUNDS_F, WIDTH)
    internal = _prf_field_elements(b"internal-rc", ROUNDS_P)
    # internal diagonal mu (out_i = sum + mu_i * x_i); ensure the implied
    # matrix (all-ones + diag(mu)) is invertible over F_p
    attempt = 0
    while True:
        mu = _prf_field_elements(b"internal-diag" + bytes([attempt]), WIDTH)
        m = [[(1 + (int(mu[i]) if i == j else 0)) % bb.P for j in range(WIDTH)] for i in range(WIDTH)]
        # determinant via fraction-free Gaussian elimination mod p
        det = 1
        mm = [row[:] for row in m]
        singular = False
        for c in range(WIDTH):
            piv = next((r for r in range(c, WIDTH) if mm[r][c] != 0), None)
            if piv is None:
                singular = True
                break
            if piv != c:
                mm[c], mm[piv] = mm[piv], mm[c]
                det = (-det) % bb.P
            det = (det * mm[c][c]) % bb.P
            inv = pow(mm[c][c], bb.P - 2, bb.P)
            for r in range(c + 1, WIDTH):
                f = (mm[r][c] * inv) % bb.P
                for k in range(c, WIDTH):
                    mm[r][k] = (mm[r][k] - f * mm[c][k]) % bb.P
        if not singular and det != 0:
            break
        attempt += 1
    return (
        bb.np_to_mont(ext),
        bb.np_to_mont(internal),
        bb.np_to_mont(mu),
    )


def packed_constants() -> np.ndarray:
    """The constants in the CUDA kernels' layout: external rc (128),
    internal rc (13), mu (16), one uint32 vector."""
    ext, internal, mu = _derive_constants()
    return np.concatenate([ext.reshape(-1), internal, mu])


@functools.lru_cache(maxsize=None)
def _device_constants(device: torch.device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return tuple(torch.as_tensor(c.astype(np.int64), device=device) for c in _derive_constants())


def _sbox(x: torch.Tensor) -> torch.Tensor:
    x2 = bb.mont_mul(x, x)
    x4 = bb.mont_mul(x2, x2)
    x3 = bb.mont_mul(x2, x)
    return bb.mont_mul(x4, x3)


def _external_linear(state: torch.Tensor) -> torch.Tensor:
    """M_E = circ(2·M4, M4, M4, M4) on (B, 16) int64 elements: the M4 block
    [[5,7,1,3],[4,6,1,1],[1,3,5,7],[1,1,4,6]] on each group of four, then
    each position adds its sum over the groups.  The small-integer sums stay
    below 64p before the one reduction, so the result is canonical."""
    a, b, c, d = state.reshape(-1, 4, 4).unbind(-1)  # each (B, group)
    m = torch.stack([5 * a + 7 * b + c + 3 * d, 4 * a + 6 * b + c + d,
                     a + 3 * b + 5 * c + 7 * d, a + b + 4 * c + 6 * d], dim=-1)
    return ((m + m.sum(dim=1, keepdim=True)) % bb.P).reshape(-1, WIDTH)


def permute(state: torch.Tensor) -> torch.Tensor:
    """Poseidon2 permutation of (B, 16) Montgomery states, plain torch in
    int64: the arithmetic the CUDA kernels are held against.  Off the
    commitment's path, so plain torch on every device: the commitment
    permutes inside the hash_rows and compress kernels."""
    ext_rc, int_rc, mu = _device_constants(state.device)
    s = _external_linear(state.long())
    half = ROUNDS_F // 2
    for r in range(half):
        s = _external_linear(_sbox(bb.add(s, ext_rc[r])))
    for r in range(ROUNDS_P):
        s0 = _sbox(bb.add(s[:, :1], int_rc[r]))
        s = torch.cat([s0, s[:, 1:]], dim=1)
        s = bb.add(s.sum(dim=1, keepdim=True) % bb.P, bb.mont_mul(s, mu))
    for r in range(half, ROUNDS_F):
        s = _external_linear(_sbox(bb.add(s, ext_rc[r])))
    return s.to(state.dtype)


def width_separator(width: int) -> int:
    """The sponge's capacity word: the row width, Montgomery form."""
    return bb.R * (width % bb.P) % bb.P


def hash_rows_plain(rows: torch.Tensor) -> torch.Tensor:
    """Plain torch sponge: each row of (B, W) -> (B, 8) digest, absorbing
    RATE elements per permutation (zero-padded last chunk) with the width in
    the last capacity word."""
    bsz, w = rows.shape
    nchunks = max(1, -(-w // RATE))
    padded = torch.zeros((bsz, nchunks * RATE), dtype=torch.int64, device=rows.device)
    padded[:, :w] = rows
    state = torch.zeros((bsz, WIDTH), dtype=torch.int64, device=rows.device)
    state[:, WIDTH - 1] = width_separator(w)
    for c in range(nchunks):
        absorbed = bb.add(state[:, :RATE], padded[:, c * RATE : (c + 1) * RATE])
        state = permute(torch.cat([absorbed, state[:, RATE:]], dim=1))
    return state[:, :OUT].to(torch.int32)


def compress_plain(state: torch.Tensor) -> torch.Tensor:
    """Plain torch 2-to-1 compression of (n, 16) = (left ‖ right) states
    -> (n, 8): the truncated permutation."""
    return permute(state)[:, :OUT].to(torch.int32)


def hash_rows(rows: torch.Tensor) -> torch.Tensor:
    """Sponge-hash each row of a (B, W) matrix into a (B, 8) digest (int32,
    Montgomery)."""
    if rows.dim() != 2:
        raise ValueError(f"hash_rows: expected (B, W), got {tuple(rows.shape)}")
    return hash_rows_plain(rows)


def compress(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """2-to-1 digest compression: truncated permutation.
    left/right: (B, 8) -> (B, 8), all Montgomery form."""
    return compress_plain(torch.cat([left, right], dim=1).to(torch.int32))


# ---------------------------------------------------------------------------
# host (python-int) reference: round-by-round, copies of the reference's
# ---------------------------------------------------------------------------

M4 = ((5, 7, 1, 3), (4, 6, 1, 1), (1, 3, 5, 7), (1, 1, 4, 6))


def host_constants():
    """(ext_rc (8,16), int_rc (13,), mu (16,)) as standard-form ints."""
    ext, internal, mu = _derive_constants()
    return (
        bb.np_from_mont(ext).tolist(),
        bb.np_from_mont(internal).tolist(),
        bb.np_from_mont(mu).tolist(),
    )


def host_ext_linear(s: list[int]) -> list[int]:
    groups = []
    for g in range(4):
        grp = s[4 * g : 4 * g + 4]
        groups.append([sum(M4[i][j] * grp[j] for j in range(4)) % bb.P for i in range(4)])
    sums = [sum(grp[i] for grp in groups) % bb.P for i in range(4)]
    return [(groups[g][i] + sums[i]) % bb.P for g in range(4) for i in range(4)]


def host_int_linear(s: list[int], mu: list[int]) -> list[int]:
    tot = sum(s) % bb.P
    return [(tot + mu[c] * s[c]) % bb.P for c in range(WIDTH)]


def host_sbox(v: int) -> int:
    return pow(v, ALPHA, bb.P)


def host_round_sequence():
    """The 21 rounds as (kind, rc_vector) with kind in {'ext','int'}."""
    ext_rc, int_rc, _ = host_constants()
    seq = []
    for r in range(ROUNDS_F // 2):
        seq.append(("ext", ext_rc[r]))
    for r in range(ROUNDS_P):
        seq.append(("int", [int_rc[r]] + [0] * (WIDTH - 1)))
    for r in range(ROUNDS_F // 2, ROUNDS_F):
        seq.append(("ext", ext_rc[r]))
    return seq


def host_permute(state: list[int]) -> list[int]:
    """Full permutation via the round sequence, standard form."""
    _, _, mu = host_constants()
    s = host_ext_linear(state)
    for kind, rc in host_round_sequence():
        if kind == "ext":
            s = host_ext_linear([host_sbox((s[c] + rc[c]) % bb.P) for c in range(WIDTH)])
        else:
            v = [host_sbox((s[0] + rc[0]) % bb.P)] + s[1:]
            s = host_int_linear(v, mu)
    return s


_PNP = np.uint64(bb.P)


def _np_sbox(v: np.ndarray) -> np.ndarray:
    """x^7 mod p vectorized (inputs < p < 2^31: every product of two
    reduced values fits u64)."""
    x2 = v * v % _PNP
    x3 = x2 * v % _PNP
    return x3 * x3 % _PNP * v % _PNP


def _np_ext_linear(s: np.ndarray) -> np.ndarray:
    """(B, 16) batched external linear layer (the M4 circulant form)."""
    g = s.reshape(-1, 4, 4)
    m4 = np.array(M4, dtype=np.uint64)
    grp = (g @ m4.T) % _PNP  # (B, 4, 4)
    sums = grp.sum(axis=1) % _PNP  # (B, 4)
    return ((grp + sums[:, None, :]) % _PNP).reshape(-1, WIDTH)


@functools.lru_cache(maxsize=1)
def _np_round_consts():
    ext_rc, int_rc, mu = host_constants()
    return (
        [np.array(rc, dtype=np.uint64) for rc in ext_rc],
        [np.uint64(rc) for rc in int_rc],
        np.array(mu, dtype=np.uint64),
    )


def host_permute_batch(states: np.ndarray) -> np.ndarray:
    """Batched host permutation: (B, 16) standard-form uint64 -> same,
    bit-equal to ``host_permute`` per row."""
    ext_rc, int_rc, mu = _np_round_consts()
    s = _np_ext_linear(states.astype(np.uint64) % _PNP)
    ei = 0
    ii = 0
    for kind, _ in host_round_sequence():
        if kind == "ext":
            s = _np_ext_linear(_np_sbox((s + ext_rc[ei]) % _PNP))
            ei += 1
        else:
            s0 = _np_sbox((s[:, 0] + int_rc[ii]) % _PNP)
            ii += 1
            s = s.copy()
            s[:, 0] = s0
            tot = s.sum(axis=1) % _PNP
            s = (tot[:, None] + mu[None, :] * s) % _PNP
    return s


def host_hash_row(row: list[int]) -> list[int]:
    """Standard-form sponge hash of one row, bit-equal to ``hash_rows``."""
    w = len(row)
    nchunks = max(1, -(-w // RATE))
    padded = [int(v) % bb.P for v in row] + [0] * (nchunks * RATE - w)
    state = [0] * WIDTH
    state[WIDTH - 1] = w % bb.P
    for c in range(nchunks):
        for i in range(RATE):
            state[i] = (state[i] + padded[c * RATE + i]) % bb.P
        state = host_permute(state)
    return state[:OUT]


def host_compress(left, right) -> list[int]:
    """2-to-1 compression on standard-form ints, bit-equal to ``compress``."""
    return host_permute([int(v) % bb.P for v in left] + [int(v) % bb.P for v in right])[:OUT]
