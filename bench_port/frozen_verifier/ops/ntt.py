"""Number-theoretic transform over BabyBear on torch tensors.

Port of raiko_tpu/ops/ntt.py: the NTT/LDE stage of the STARK column
commitment.  The order conventions are the reference's, end to end: the
forward transform is decimation-in-frequency (natural input -> bit-reversed
output) and the inverse decimation-in-time (bit-reversed input -> natural
output), so committed data stays in bit-reversed coset order and no
bit-reversal gather follows the transforms.

Arrays are (batch, N) BabyBear tensors in Montgomery form, N a power of
two.  The frozen copy keeps only the port's plain versions of kernel B5
(stage by stage, in int64) and of its coset prologue (``coset_pad``).

Twiddle tables are numpy, built on the host once per size.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields import babybear as bb


@functools.lru_cache(maxsize=64)
def _root_powers(log_n: int, inverse: bool) -> np.ndarray:
    """w^j for j < N/2, Montgomery form, w the primitive N-th root (or its
    inverse).  Stage s of the DIF transform needs (w^(2^s))^j = w^(j·2^s),
    so this one table serves every stage at stride 2^s."""
    w = bb.two_adic_generator(log_n)
    if inverse:
        w = bb.h_inv(w)
    return bb.np_to_mont(bb.np_powers(w, max((1 << log_n) // 2, 1)))


@functools.lru_cache(maxsize=64)
def _twiddles(log_n: int, inverse: bool) -> tuple[np.ndarray, ...]:
    """Per-stage twiddle tables (Montgomery form), as the reference's:
    stage s of the DIF transform needs w_{N/2^s}^j for j < N/2^{s+1}; the
    inverse (DIT) transform consumes the inverse tables in reverse order."""
    full = _root_powers(log_n, inverse)
    return tuple(full[:: 1 << s][: (1 << log_n) >> (s + 1)] for s in range(log_n))


def bit_reverse_indices(n: int) -> np.ndarray:
    """Permutation taking bit-reversed order to natural order (host-side)."""
    log_n = n.bit_length() - 1
    idx = np.arange(n, dtype=np.uint32)
    rev = np.zeros(n, dtype=np.uint32)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def _log2(n: int) -> int:
    log_n = n.bit_length() - 1
    if n < 1 or 1 << log_n != n:
        raise ValueError(f"NTT size must be a power of two, got {n}")
    return log_n


def _stage_table(log_n: int, s: int, inverse: bool, device) -> torch.Tensor:
    return torch.as_tensor(_twiddles(log_n, inverse)[s].astype(np.int64), device=device)


def _n_inv(log_n: int) -> int:
    """1/N in Montgomery form."""
    return bb.h_inv(1 << log_n) * bb.R % bb.P


def _forward(x: torch.Tensor) -> torch.Tensor:
    """Plain B5, forward: natural in -> bit-reversed out, (B, N)."""
    bsz, n = x.shape
    log_n = _log2(n)
    y = x.long()
    for s in range(log_n):
        half = n >> (s + 1)
        v = y.reshape(bsz, 1 << s, 2, half)
        u, w = v[:, :, 0], v[:, :, 1]
        tw = _stage_table(log_n, s, False, x.device)
        y = torch.stack([bb.add(u, w), bb.mont_mul(bb.sub(u, w), tw)], dim=2).reshape(bsz, n)
    return y.to(x.dtype)


def _inverse(x: torch.Tensor) -> torch.Tensor:
    """Plain B5, inverse: bit-reversed in -> natural out, times 1/N."""
    bsz, n = x.shape
    log_n = _log2(n)
    y = x.long()
    for s in reversed(range(log_n)):
        half = n >> (s + 1)
        v = y.reshape(bsz, 1 << s, 2, half)
        u = v[:, :, 0]
        w = bb.mont_mul(v[:, :, 1], _stage_table(log_n, s, True, x.device))
        y = torch.stack([bb.add(u, w), bb.sub(u, w)], dim=2).reshape(bsz, n)
    return bb.mont_mul(y, _n_inv(log_n)).to(x.dtype)


def ntt(x: torch.Tensor) -> torch.Tensor:
    """Forward NTT, natural order in -> bit-reversed order out.

    x: (..., N) Montgomery form, N a power of two."""
    lead = x.shape[:-1]
    return _forward(x.reshape(-1, x.shape[-1])).reshape(lead + x.shape[-1:])


def intt(x: torch.Tensor) -> torch.Tensor:
    """Inverse NTT (with the 1/N scale), bit-reversed order in -> natural
    order out."""
    lead = x.shape[:-1]
    return _inverse(x.reshape(-1, x.shape[-1])).reshape(lead + x.shape[-1:])


def lde(x: torch.Tensor, blowup_log: int, shift: int | None = None) -> torch.Tensor:
    """Low-degree extension by 2^blowup_log onto a shifted coset.

    x: (..., N) evaluations over the size-N subgroup in natural order,
    Montgomery form.  Returns (..., N·2^blowup) coset evaluations in
    bit-reversed order (the order the Merkle commitment consumes)."""
    return lde_from_coeffs(interpolate(x), blowup_log, shift)


@functools.lru_cache(maxsize=32)
def _coset_powers(n: int, shift: int) -> np.ndarray:
    return bb.np_to_mont(bb.np_powers(shift, n))


def coset_pad(coeffs: torch.Tensor, blowup_log: int, shift: int | None = None) -> torch.Tensor:
    """Coefficients (..., N) scaled by shift^i and zero-padded to
    N·2^blowup_log: the input of the LDE's forward NTT."""
    n = coeffs.shape[-1]
    if shift is None:
        shift = bb.GENERATOR
    powers = torch.as_tensor(_coset_powers(n, shift).astype(np.int64), device=coeffs.device)
    return torch.nn.functional.pad(bb.mont_mul(coeffs, powers), (0, (n << blowup_log) - n))


def lde_from_coeffs(coeffs: torch.Tensor, blowup_log: int, shift: int | None = None) -> torch.Tensor:
    """Evaluate coefficient-form polynomials (..., N) over the shifted coset
    of size N·2^blowup_log.  Output in bit-reversed order, Montgomery form:
    coefficients scaled by shift^i, zero-padded, forward NTT."""
    n = coeffs.shape[-1]
    lead = coeffs.shape[:-1]
    out = _forward(coset_pad(coeffs.reshape(-1, n), blowup_log, shift))
    return out.reshape(lead + (n << blowup_log,))


@functools.lru_cache(maxsize=None)
def _bit_reverse_tensor(n: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(bit_reverse_indices(n).astype(np.int64), device=device)


def interpolate(evals: torch.Tensor) -> torch.Tensor:
    """Natural-order subgroup evaluations -> coefficient form (both
    Montgomery), evals (..., N): the inverse NTT of the bit-reversed
    evaluations."""
    rev = _bit_reverse_tensor(evals.shape[-1], evals.device)
    return intt(evals.index_select(-1, rev))
