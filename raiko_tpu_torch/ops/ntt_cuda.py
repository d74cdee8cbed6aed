"""BabyBear NTT on the card: kernel B5 ``ntt`` / ``intt``.

Counterpart of raiko_tpu/ops/ntt_pallas.py (ntt_fused, intt_fused), for
every power-of-two size from 2 to 2^24; the CUDA source is
csrc/babybear_ntt.cu (its header note says what bounds the kernel on the
H100 and how the design answers it).  Each thread runs 3-5 butterfly
stages on its elements in registers between exchanges through shared
memory; sizes up to 4,096 run whole rows in a block, larger ones the
four-step split.  ``ntt_coset`` is the forward transform with the LDE's
prologue: the coefficients are scaled by shift^i and zero-padded as they
are loaded, so the padded copy is never written.

The wrappers take (batch, N) BabyBear tensors in Montgomery form.  On a
CUDA tensor they launch the kernel, which takes contiguous int32, or raise;
only a CPU tensor goes to the plain version beside them, the reference's
stage-by-stage DIF / DIT in int64 (for ``ntt_coset``, after the reference's
scaling and pad), bit for bit the same result.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels
from ..fields import babybear as bb
from . import ntt as nttmod

MAX_LOG_N = 24
ROW_PASS_MAX_LOG_N = 12  # whole rows in one block's shared memory up to here


def _stage_table(log_n: int, s: int, inverse: bool, device) -> torch.Tensor:
    return torch.as_tensor(nttmod._twiddles(log_n, inverse)[s].astype(np.int64), device=device)


def ntt_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain torch B5, forward: natural in -> bit-reversed out, (B, N)."""
    bsz, n = x.shape
    log_n = nttmod._log2(n)
    y = x.long()
    for s in range(log_n):
        half = n >> (s + 1)
        v = y.reshape(bsz, 1 << s, 2, half)
        u, w = v[:, :, 0], v[:, :, 1]
        tw = _stage_table(log_n, s, False, x.device)
        y = torch.stack([bb.add(u, w), bb.mont_mul(bb.sub(u, w), tw)], dim=2).reshape(bsz, n)
    return y.to(x.dtype)


def intt_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain torch B5, inverse: bit-reversed in -> natural out, times 1/N."""
    bsz, n = x.shape
    log_n = nttmod._log2(n)
    y = x.long()
    for s in reversed(range(log_n)):
        half = n >> (s + 1)
        v = y.reshape(bsz, 1 << s, 2, half)
        u = v[:, :, 0]
        w = bb.mont_mul(v[:, :, 1], _stage_table(log_n, s, True, x.device))
        y = torch.stack([bb.add(u, w), bb.sub(u, w)], dim=2).reshape(bsz, n)
    return bb.mont_mul(y, _n_inv(log_n)).to(x.dtype)


def _n_inv(log_n: int) -> int:
    """Montgomery form of 1/N."""
    return bb.h_inv(1 << log_n) * bb.R % bb.P


def _up(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(a.astype(np.int32), device=device)


@functools.lru_cache(maxsize=None)
def _tables(log_n: int, inverse: bool, device: torch.device) -> tuple:
    """(log_r, tw_rows, tw_cols, cross) on `device` as int32: one pass
    (log_r = 0, tw_rows = the per-stage tables of w_N, end to end) or the
    four-step split (tw_rows, tw_cols those of w_C and w_R, cross = the
    (R, C) cross twiddles)."""
    def stages(log: int) -> torch.Tensor:
        return _up(np.concatenate(nttmod._twiddles(log, inverse)), device)

    if log_n <= ROW_PASS_MAX_LOG_N:
        return 0, stages(log_n), None, None
    log_r = log_n // 2
    log_c = log_n - log_r
    return log_r, stages(log_c), stages(log_r), _up(nttmod._fourstep_twiddles(log_r, log_c, inverse), device)


@functools.lru_cache(maxsize=None)
def _coset_table(n: int, shift: int, device: torch.device) -> torch.Tensor:
    return _up(nttmod._coset_powers(n, shift), device)


def _launch(x: torch.Tensor, out: torch.Tensor, log_n: int, inverse: bool, name: str,
            coset: torch.Tensor | None = None) -> None:
    """Kernel B5 on checked CUDA int32 rows, x -> out, both 16-byte aligned
    (`out` may be `x`); with `coset`, x holds the first x.shape[1]
    coefficients of each row."""
    log_r, tw_rows, tw_cols, cross = _tables(log_n, inverse, x.device)
    if x.shape[0]:
        kernels.launch("raiko_babybear_ntt", name, x, out, tw_rows, tw_cols, cross,
                       x.shape[0], log_n, log_r, int(inverse), _n_inv(log_n), coset,
                       nttmod._log2(x.shape[1]))


def _checked_log_n(x: torch.Tensor, n: int, name: str) -> int:
    if x.dim() != 2:
        raise ValueError(f"{name}: expected (batch, N), got {tuple(x.shape)}")
    log_n = nttmod._log2(n)
    if x.device.type != "cpu":
        if not 1 <= log_n <= MAX_LOG_N:
            raise ValueError(f"{name}: N must be in [2, 2^{MAX_LOG_N}] on the card, got {n}")
        kernels.check(x, name, torch.int32, (x.shape[1],))
    return log_n


def _transform(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    name = "intt" if inverse else "ntt"
    log_n = _checked_log_n(x, x.shape[-1], name)
    if x.device.type == "cpu":
        return intt_plain(x) if inverse else ntt_plain(x)
    out = torch.empty_like(x)
    _launch(kernels.aligned(x), out, log_n, inverse, name)
    return out


def ntt(x: torch.Tensor) -> torch.Tensor:
    """Forward NTT of (B, N) Montgomery rows, natural in -> bit-reversed
    out, bit-exact with raiko_tpu/ops/ntt.py:ntt."""
    return _transform(x, inverse=False)


def intt(x: torch.Tensor) -> torch.Tensor:
    """Inverse NTT of (B, N) Montgomery rows, bit-reversed in -> natural
    out (with the 1/N scale), bit-exact with raiko_tpu/ops/ntt.py:intt."""
    return _transform(x, inverse=True)


def ntt_coset_plain(coeffs: torch.Tensor, blowup_log: int, shift: int) -> torch.Tensor:
    """Plain torch B5 with the prologue: the forward NTT of the coset-scaled,
    zero-padded coefficients."""
    return ntt_plain(nttmod.coset_pad(coeffs, blowup_log, shift))


def ntt_coset(coeffs: torch.Tensor, blowup_log: int, shift: int) -> torch.Tensor:
    """(B, n) Montgomery coefficients -> (B, n·2^blowup_log) evaluations over
    the coset shift·<w>, bit-reversed: ntt(coset_pad(coeffs, ...)), the
    function of raiko_tpu/ops/ntt.py:lde_from_coeffs.  On the card the
    scaling and the zero-pad happen as the kernel loads its input."""
    if blowup_log < 0:
        raise ValueError(f"ntt_coset: blowup_log must be >= 0, got {blowup_log}")
    n = coeffs.shape[-1]
    log_n = _checked_log_n(coeffs, n << blowup_log, "ntt_coset")
    if coeffs.device.type == "cpu":
        return ntt_coset_plain(coeffs, blowup_log, shift)
    out = torch.empty((coeffs.shape[0], n << blowup_log), dtype=torch.int32, device=coeffs.device)
    _launch(kernels.aligned(coeffs), out, log_n, False, "ntt_coset", _coset_table(n, shift % bb.P, coeffs.device))
    return out
