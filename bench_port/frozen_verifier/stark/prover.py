"""What the frozen verifier needs of the port's ``stark/prover.py``: the
proof's parameters and the ``StarkProof`` record that ``serde`` rebuilds,
and the commitment of a fixed segment, whose root the verifier recomputes.
The rest of the proving pipeline itself is not part of the frozen copy."""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import convert
from ..fields import babybear as bb
from ..ops import merkle, ntt
from ..ops import poseidon2 as p2
from . import fri

BLOWUP_LOG = 2
# 45 queries * 2 bits/query (rate 1/4, capacity conjecture) + 10 grind
# bits = ~100-bit conjectured query soundness
NUM_QUERIES = 45
GRIND_BITS = 10  # FRI proof-of-work (channel.grind)


@dataclass
class StarkProof:
    log_n: int
    width: int
    pow_nonce: int
    publics: list
    trace_root: list
    quotient_root: list
    trace_at_zeta: list  # W EF tuples
    trace_at_zeta_g: list  # W EF tuples
    quotient_at_zeta: list  # 4 * quotient_chunks EF tuples
    fri_proof: fri.FriProof
    queries: list  # per query: trace_row, trace_path, quot_row, quot_path
    # auxiliary segment (permutation/lookup arguments); empty when unused.
    # queries additionally carry aux_row/aux_path.
    aux_root: list = field(default_factory=list)
    aux_at_zeta: list = field(default_factory=list)
    aux_at_zeta_g: list = field(default_factory=list)
    # challenge-dependent public EF scalars (global LogUp bus contributions)
    bus: list = field(default_factory=list)
    # committed fixed segment (Air.commit_fixed): deterministic
    # preprocessed-column commitment whose root the verifier recomputes
    # from the statement; queries additionally carry fixed_row/fixed_path.
    fixed_root: list = field(default_factory=list)
    fixed_at_zeta: list = field(default_factory=list)


def commit_cols(cols_m: torch.Tensor, shift: int) -> tuple[torch.Tensor, torch.Tensor, list[torch.Tensor]]:
    """Commit (W, n) Montgomery columns: (coeffs (W, n), LDE (W, n·4) in
    bit-reversed coset order, Merkle levels of the LDE's rows)."""
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
