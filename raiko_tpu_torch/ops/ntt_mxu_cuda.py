"""The int8 limb-product NTT on the card: kernel B6 ``ntt_mxu``.

Counterpart of raiko_tpu/ops/ntt_mxu.py:ntt_mxu_pallas (kernel
_mxu_dft_pallas); the CUDA source is csrc/babybear_ntt_mxu.cu (its header
note says what bounds the kernel on the H100 and how the design answers it).

The wrapper takes (batch, N) int32 Montgomery rows, N <= 2^14.  On a CUDA
tensor it launches the kernel (one launch per DFT pass, both from one C
entry) or raises; only a CPU tensor goes to the plain version in
ops/ntt_mxu.py, bit for bit the same result.  The DFT matrices are packed
on the host once per size and device: word (k, g, i) holds the int8 limbs
W_i[k, 4g..4g+3], the operand layout of ``__dp4a``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels
from . import ntt as nttmod
from . import ntt_mxu as mxu


def _packed_matrix(log_m: int) -> np.ndarray:
    """(M, G, 4) int32, G = ceil(M / 4): the limbs W_i[k, 4g..4g+3] of each
    row k, limb i, as four little-endian bytes, zero past column M."""
    limbs = mxu._dft_matrix_limbs(log_m)  # (4, M, M) int8
    m = 1 << log_m
    groups = -(-m // 4)
    padded = np.zeros((4, m, 4 * groups), dtype=np.int8)
    padded[:, :, :m] = limbs
    words = padded.reshape(4, m, groups, 4).transpose(1, 2, 0, 3)  # (M, G, limb, byte)
    return np.ascontiguousarray(words).view(np.int32).reshape(m, groups, 4)


@functools.lru_cache(maxsize=None)
def _tables(log_r: int, log_c: int, device: torch.device) -> tuple[torch.Tensor, ...]:
    """(W_R packed, W_C packed, cross twiddles (R, C), [b_0..b_6, K]) as
    int32 on `device`."""
    def up(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a).astype(np.int32), device=device)

    bs, k_const = mxu._recombine_consts(1 << log_c)
    return (up(_packed_matrix(log_r)), up(_packed_matrix(log_c)),
            up(nttmod._fourstep_twiddles(log_r, log_c)), up(np.array(bs + [k_const], dtype=np.int64)))


def ntt_mxu(x: torch.Tensor) -> torch.Tensor:
    """B6 on (B, N) int32 Montgomery rows: forward NTT, natural in ->
    bit-reversed out, bit-exact with raiko_tpu/ops/ntt.py:ntt."""
    if x.dim() != 2 or x.dtype != torch.int32:
        raise ValueError(f"ntt_mxu: expected (batch, N) int32, got {x.dtype} {tuple(x.shape)}")
    log_r, log_c = mxu._split(x.shape[1])
    if x.device.type == "cpu":
        return mxu.ntt_mxu_plain(x)
    kernels.check(x, "ntt_mxu", torch.int32, (x.shape[1],))
    out = torch.empty_like(x)
    if x.shape[0]:
        w_r, w_c, cross, consts = _tables(log_r, log_c, x.device)
        kernels.launch("raiko_babybear_ntt_mxu", "ntt_mxu", x, out, w_r, w_c, cross, consts,
                       x.shape[0], log_r, log_c)
    return out
