"""STARK prover, first piece: the column commitment.

Port of the commitment half of raiko_tpu/stark/prover.py.  A trace's
columns are interpolated (inverse NTT), extended onto the blowup-4 coset
(forward NTT with the coset scaling on load), the LDE's rows hashed into
leaves (the Poseidon2 sponge) and the leaves committed in a Merkle tree:
kernels B5 (intt, ntt_coset), poseidon2_hash_rows and poseidon2_merkle on
the card, one launch each, their plain versions on the CPU.
Everything stays in bit-reversed coset order, as in the reference.

The rest of the prover (quotient, out-of-domain openings, DEEP, FRI) is
the next slice of the port.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from .. import convert
from ..fields import babybear as bb
from ..ops import merkle, ntt
from ..ops import poseidon2 as p2

BLOWUP_LOG = 2


def commit_cols(cols_m: torch.Tensor, shift: int) -> tuple[torch.Tensor, torch.Tensor, list[torch.Tensor]]:
    """Commit (W, n) columns in Montgomery form on their device, the
    counterpart of ``_commit_cols_local``.  Returns (coeffs (W, n),
    lde (W, n·4) in bit-reversed coset order, Merkle levels of the LDE's
    rows)."""
    coeffs = ntt.interpolate(cols_m)
    lde = ntt.lde_from_coeffs(coeffs, BLOWUP_LOG, shift)
    levels = merkle.commit(p2.hash_rows(lde.T))
    return coeffs, lde, levels


_FIXED_ROOT_CACHE: dict = {}


def fixed_commit_root(fixed: np.ndarray, shift: int, device) -> list[int]:
    """Commitment root (standard form) of a fixed-column matrix (W, n),
    uint32 standard form, committed on `device`; cached by content, since
    statements repeat."""
    fixed = np.ascontiguousarray(fixed)
    key = (hashlib.sha256(fixed.tobytes()).digest(), fixed.shape, shift)
    r = _FIXED_ROOT_CACHE.get(key)
    if r is None:
        fixed_m = bb.to_mont(convert.words_from_numpy(fixed, device))
        _, _, levels = commit_cols(fixed_m, shift)
        r = convert.bb_to_numpy(bb.from_mont(merkle.root(levels))).tolist()
        _FIXED_ROOT_CACHE[key] = r
    return r
