"""Forward BabyBear NTT whose DFT passes are exact int8 limb products.

Port of raiko_tpu/ops/ntt_mxu.py.  N = R·C with R, C <= 128 (the split
log R = ⌊log N / 2⌋); each pass multiplies the rows of a fixed M x M DFT
matrix W[k, j] = w_M^{brp(k)·j} (standard form) into the Montgomery inputs
exactly over the integers: every operand is cut into four BALANCED signed
8-bit digits (in [-128, 128); every value < p fits), the 16 digit-pair
products run as one stacked (4M, M) x (M, 4L) product whose dot products
are exact in int32, and the seven diagonal sums S_s = Σ_{i+j=s} P_ij,
|S_s| <= 4·128·2^14 = 2^23, are re-centred by 2^23 and recombined mod p as
Σ_s (S_s + 2^23)·2^{8s} - K.  Between the passes come the four-step cross
twiddles.  The output equals ops/ntt.py:ntt bit for bit (bit-reversed
order).

``ntt_mxu`` is the one public function, the counterpart of both of the
reference's names (``ntt_mxu`` and the Pallas ``ntt_mxu_pallas`` compute the
same function).  On a CUDA tensor it launches kernel B6
(ops/ntt_mxu_cuda.py, csrc/babybear_ntt_mxu.cu) or raises; on a CPU tensor
it runs the plain version below, the same limb formulation in torch.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields import babybear as bb
from . import ntt as nttmod
from . import ntt_mxu_cuda

_OFFSET = 1 << 23  # re-centring offset of the signed diagonal sums
MAX_LOG_M = 7  # one DFT matrix is at most 128 x 128


def _balanced_limbs_int(v: int) -> list[int]:
    """Four balanced signed 8-bit digits of v < p (host)."""
    out, carry = [], 0
    for i in range(4):
        d = ((v >> (8 * i)) & 0xFF) + carry
        carry = int(d >= 128)
        out.append(d - 256 * carry)
    if carry:
        raise ValueError(f"{v} does not fit four balanced digits")
    return out


def _balanced_limbs(x: torch.Tensor) -> list[torch.Tensor]:
    """int64 values < p -> four int64 tensors of balanced digits."""
    out = []
    carry = torch.zeros_like(x)
    for i in range(4):
        d = ((x >> (8 * i)) & 0xFF) + carry
        carry = (d >= 128).long()
        out.append(d - 256 * carry)
    return out


@functools.lru_cache(maxsize=8)
def _dft_matrix_limbs(log_m: int) -> np.ndarray:
    """W[k, j] = w_M^{brp(k)·j} as (4, M, M) int8 balanced limbs."""
    m = 1 << log_m
    w = bb.two_adic_generator(log_m)
    rev = nttmod.bit_reverse_indices(m)
    mat = np.stack([bb.np_powers(pow(w, int(rev[k]), bb.P), m) for k in range(m)])
    return torch.stack(_balanced_limbs(torch.as_tensor(mat.astype(np.int64)))).numpy().astype(np.int8)


@functools.lru_cache(maxsize=8)
def _recombine_consts(m: int) -> tuple[list[int], int]:
    """(b_s), b_s = 2^{8s}·R mod p, so mont_mul(T_s, b_s) = T_s·2^{8s}, and
    the offset correction K = Σ_s 2^23·2^{8s} mod p."""
    bs = [pow(2, 8 * s, bb.P) * bb.R % bb.P for s in range(7)]
    k_const = sum(_OFFSET * pow(2, 8 * s, bb.P) for s in range(7)) % bb.P
    return bs, k_const


def _split(n: int) -> tuple[int, int]:
    """(log R, log C) of the reference's split; raises above R, C = 128."""
    log_n = nttmod._log2(n)
    log_r = log_n // 2
    if log_n - log_r > MAX_LOG_M:
        raise ValueError(f"ntt_mxu: N = {n} exceeds 128 x 128; use ops/ntt.py:ntt")
    return log_r, log_n - log_r


# Batch rows per plain chunk: the stacked product is 16 N int64 per row.
_PLAIN_ROWS = 256


def _dft_minor(mat: torch.Tensor, log_m: int) -> torch.Tensor:
    """DFT along axis -2 of (B, M, L) int64 Montgomery values: the stacked
    limb product, the seven diagonal sums and the recombination.  The
    product runs in float64, which holds these integers (|sum| < 2^23)
    exactly on every device (CUDA has no int64 matmul)."""
    m = 1 << log_m
    bsz, _, lanes = mat.shape
    w_stack = torch.as_tensor(_dft_matrix_limbs(log_m).reshape(4 * m, m), dtype=torch.float64,
                              device=mat.device)
    x_stack = torch.cat(_balanced_limbs(mat), dim=-1).double()  # (B, M, 4L)
    pfull = torch.matmul(w_stack, x_stack).long().reshape(bsz, 4, m, 4, lanes)
    bs, k_const = _recombine_consts(m)
    acc = None
    for s in range(7):
        st = sum(pfull[:, i, :, s - i, :] for i in range(max(0, s - 3), min(s, 3) + 1))
        term = bb.mont_mul(st + _OFFSET, bs[s])
        acc = term if acc is None else bb.add(acc, term)
    return bb.sub(acc, k_const)


def ntt_mxu_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain torch B6 on (B, N) Montgomery rows, N <= 2^14."""
    bsz, n = x.shape
    log_r, log_c = _split(n)
    tw = torch.as_tensor(nttmod._fourstep_twiddles(log_r, log_c).astype(np.int64), device=x.device)
    outs = []
    for i in range(0, bsz, _PLAIN_ROWS):
        mat = x[i : i + _PLAIN_ROWS].long().reshape(-1, 1 << log_r, 1 << log_c)
        a = bb.mont_mul(_dft_minor(mat, log_r), tw)
        out = _dft_minor(a.transpose(-1, -2), log_c)
        outs.append(out.transpose(-1, -2).reshape(-1, n))
    return torch.cat(outs).to(x.dtype) if outs else x.clone()


def ntt_mxu(x: torch.Tensor) -> torch.Tensor:
    """Forward NTT, natural in -> bit-reversed out, bit-exact with
    ops/ntt.py:ntt.  x: (..., N) int32 Montgomery, N = R·C, R, C <= 128."""
    lead = x.shape[:-1]
    return ntt_mxu_cuda.ntt_mxu(x.reshape(-1, x.shape[-1])).reshape(lead + x.shape[-1:])
