"""The int8 limb-product NTT on the card: kernel B6 ``ntt_mxu``.

Counterpart of raiko_tpu/ops/ntt_mxu.py:ntt_mxu_pallas (kernel
_mxu_dft_pallas); the CUDA source is csrc/babybear_ntt_mxu.cu (its header
note says what bounds the kernel on the H100 and how the design answers it).

The wrapper takes (batch, N) int32 Montgomery rows, N <= 2^14.  On a CUDA
tensor it launches the kernel (one launch for N <= 2^12, both passes of a
row in one block; two over tiles of 32 lanes above, through a scratch
buffer) or raises; only a CPU tensor goes to the plain version in
ops/ntt_mxu.py, bit for bit the same result.  The DFT matrices' digits are
packed on the host once per size and device as the tensor-core A fragments
(``_packed_matrix``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels
from . import ntt as nttmod
from . import ntt_mxu as mxu

ROW_ROUTE_MAX_LOG_N = 12  # one block per row up to here, two launches over tiles above

def _packed_matrix(log_m: int) -> np.ndarray:
    """(KB, KC, 4, 32, 4) int32, KB = ceil(M / 16), KC = ceil(M / 32): the
    m16n8k32 A fragments of the digit matrices W_i.  Word [kb, kc, i, lane,
    r] holds the bytes W_i[16 kb + g + 8 (r & 1), 32 kc + 16 (r >> 1) + 4 t
    + b], b = 0..3, for lane = 4 g + t; zero outside M x M."""
    limbs = mxu._dft_matrix_limbs(log_m)  # (4, M, M) int8
    m = 1 << log_m
    kbs, kcs = -(-m // 16), -(-m // 32)
    padded = np.zeros((4, 16 * kbs, 32 * kcs), dtype=np.int8)
    padded[:, :m, :m] = limbs
    # row = 16 kb + 8 rh + g, column = 32 kc + 16 ch + 4 t + b, r = 2 ch + rh
    a = padded.reshape(4, kbs, 2, 8, kcs, 2, 4, 4)  # i, kb, rh, g, kc, ch, t, b
    a = a.transpose(1, 4, 0, 3, 6, 5, 2, 7)  # kb, kc, i, g, t, ch, rh, b
    return np.ascontiguousarray(a).reshape(kbs, kcs, 4, 32, 4, 4).view(np.int32)[..., 0]


@functools.lru_cache(maxsize=None)
def _tables(log_r: int, log_c: int, device: torch.device) -> tuple[torch.Tensor, ...]:
    """(W_R packed, W_C packed, cross twiddles (R, C)) as int32 on `device`."""
    def up(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a).astype(np.int32), device=device)

    return (up(_packed_matrix(log_r)), up(_packed_matrix(log_c)), up(nttmod._fourstep_twiddles(log_r, log_c)))


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
        scratch = torch.empty_like(x) if log_r + log_c > ROW_ROUTE_MAX_LOG_N else None
        w_r, w_c, cross = _tables(log_r, log_c, x.device)
        kernels.launch("raiko_babybear_ntt_mxu", "ntt_mxu", x, out, scratch, w_r, w_c, cross,
                       x.shape[0], log_r, log_c)
    return out
