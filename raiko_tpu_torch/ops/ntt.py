"""Number-theoretic transform over BabyBear on torch tensors.

Port of raiko_tpu/ops/ntt.py: the NTT/LDE stage of the STARK column
commitment.  The order conventions are the reference's, end to end: the
forward transform is decimation-in-frequency (natural input -> bit-reversed
output) and the inverse decimation-in-time (bit-reversed input -> natural
output), so committed data stays in bit-reversed coset order and no
bit-reversal gather follows the transforms.

Arrays are (batch, N) BabyBear tensors in Montgomery form (int32, or int64
on the CPU), N a power of two.  ``ntt`` and ``intt`` go to kernel B5
(ops/ntt_cuda.py) on a CUDA tensor, at every size, and to its plain
version on a CPU tensor; ``ntt_fourstep`` is the same call, since the
kernel chooses its own split.  ``lde_from_coeffs`` is one launch of B5
with its coset prologue (``ntt_cuda.ntt_coset``): the coefficients are
scaled by shift^i and zero-padded as the kernel loads them, where the
reference leaves the scaling, the pad and the transform to one XLA jit.
``coset_pad`` stays, as that prologue's plain version.  The bit-reverse
gather before ``interpolate``'s inverse transform stays a torch op.

Twiddle tables are numpy, built on the host once per size.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields import babybear as bb
from . import ntt_cuda


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


@functools.lru_cache(maxsize=32)
def _fourstep_twiddles(log_r: int, log_c: int, inverse: bool = False) -> np.ndarray:
    """w_N^{±k1·n2} with rows in bit-reversed k1 order, (R, C) Montgomery:
    the cross twiddles between the four-step split's two passes."""
    r, c = 1 << log_r, 1 << log_c
    w = bb.two_adic_generator(log_r + log_c)
    if inverse:
        w = bb.h_inv(w)
    rev = bit_reverse_indices(r)
    out = np.empty((r, c), dtype=np.uint32)
    for row in range(r):
        out[row] = bb.np_powers(pow(w, int(rev[row]), bb.P), c)
    return bb.np_to_mont(out)


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


def ntt(x: torch.Tensor) -> torch.Tensor:
    """Forward NTT, natural order in -> bit-reversed order out.

    x: (..., N) Montgomery form, N a power of two."""
    lead = x.shape[:-1]
    return ntt_cuda.ntt(x.reshape(-1, x.shape[-1])).reshape(lead + x.shape[-1:])


def intt(x: torch.Tensor) -> torch.Tensor:
    """Inverse NTT (with the 1/N scale), bit-reversed order in -> natural
    order out."""
    lead = x.shape[:-1]
    return ntt_cuda.intt(x.reshape(-1, x.shape[-1])).reshape(lead + x.shape[-1:])


def ntt_fourstep(x: torch.Tensor) -> torch.Tensor:
    """The reference's four-step forward NTT, identical in output to
    ``ntt``: here the same call (kernel B5 splits large sizes itself)."""
    return ntt(x)


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
    coefficients scaled by shift^i, zero-padded, forward NTT (one kernel
    launch on the card)."""
    n = coeffs.shape[-1]
    lead = coeffs.shape[:-1]
    out = ntt_cuda.ntt_coset(coeffs.reshape(-1, n), blowup_log, bb.GENERATOR if shift is None else shift)
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
