"""The flagship step: one STARK trace commitment.

Counterpart of the jitted ``commit_step`` of ``__graft_entry__.entry()``
in the JAX package: a trace's columns go through interpolation, the
blowup-4 coset LDE over the field generator, Poseidon2 row hashing and the
Merkle tree, and the step returns the (8,) root in Montgomery form.

    from raiko_tpu_torch.stark.commit_step import commit_step
    root = commit_step(trace, "cuda")   # trace: (n, W) uint32 standard form
"""

from __future__ import annotations

import numpy as np
import torch

from .. import convert
from .. import device as device_mod
from ..fields import babybear as bb
from .prover import BLOWUP_LOG, commit_cols


def commit_step(trace, device) -> torch.Tensor:
    """trace: (n, W) standard-form BabyBear values (numpy uint32 or a
    tensor) -> the (8,) Merkle root on `device`, int32 Montgomery form."""
    dev = device_mod.get(device)
    if isinstance(trace, np.ndarray):
        trace = convert.words_from_numpy(trace, dev)
    tm = bb.to_mont(trace.to(dev).T.contiguous())
    _, _, levels = commit_cols(tm, bb.GENERATOR)
    return levels[-1][0]
