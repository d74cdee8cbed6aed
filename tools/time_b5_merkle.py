#!/usr/bin/env python3
"""Time kernel B5 (``ntt`` / ``intt``), the coset LDE, the Merkle tree and
the whole STARK trace commitment on the card, each result checked bit for
bit against its plain PyTorch version.

    python3 tools/time_b5_merkle.py                      # this checkout
    python3 tools/time_b5_merkle.py --root DIR           # another checkout's raiko_tpu_torch

The shapes are the keccak sponge chunk's commitment (1,024 rows x 4,160
columns, blowup 4): B5's forward transform at 4,160 x 4,096 and inverse at
4,160 x 1,024, the LDE (``ntt.lde_from_coeffs``: 4,160 x 1,024 coefficients
to 4,160 x 4,096 coset evaluations), the Merkle tree over 4,096 leaves
(``merkle.commit``), ``poseidon2_compress`` at 2,048 pairs, and the warm
commitment (``commit_step``) with its stages.  Every entry point is the
checkout's own, so a parent and its change compare in one call.  Each result
is one JSON line; the first line is nvidia-smi's name and power limit.
Needs one CUDA card; JAX and the JAX package are refused.
"""

from __future__ import annotations

import sys
import time

from kernel_timing import cuda_ms, emit, graph_ms, start

# importable once kernel_timing has put the repo first on sys.path
from chip_smoke import KECCAK_COLS, KECCAK_ROWS, SEED


def wall_ms(fn, reps: int) -> list[float]:
    """Milliseconds of each of `reps` synchronised calls, host clock."""
    import torch

    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def main() -> int:
    args = start(__doc__)
    import numpy as np
    import torch

    from raiko_tpu_torch import convert, kernels
    from raiko_tpu_torch.fields import babybear as bb
    from raiko_tpu_torch.ops import merkle, ntt, ntt_cuda, poseidon2 as p2, poseidon2_cuda
    from raiko_tpu_torch.stark.commit_step import commit_step

    label = args.label
    rng = np.random.default_rng(SEED)

    def mont(shape) -> torch.Tensor:
        return convert.words_from_numpy(bb.np_to_mont(rng.integers(0, bb.P, shape, dtype=np.uint32)), "cuda")

    def timed(name: str, fn, equal: bool, reps: int, graph: bool = True, **extra) -> None:
        """events_ms: back-to-back calls, the host's cost per call included
        where it is the longer; graph_ms: the card's time per call, for the
        short kernels (a CUDA graph cannot hold the parent's LDE, which
        copies a table from the host on every call)."""
        emit(kernel=name, label=label, equal=equal, events_ms=cuda_ms(fn, reps),
             graph_ms=graph_ms(fn, reps) if graph else None, **extra)

    lde_rows = KECCAK_ROWS << 2
    for name, shape in (("ntt", (KECCAK_COLS, lde_rows)), ("intt", (KECCAK_COLS, KECCAK_ROWS))):
        x = mont(shape)
        plain = ntt_cuda.ntt_plain if name == "ntt" else ntt_cuda.intt_plain
        fn = lambda: getattr(ntt_cuda, name)(x)
        timed(name, fn, bool(torch.equal(fn(), plain(x))), 20, shape=list(shape))
    coeffs = mont((KECCAK_COLS, KECCAK_ROWS))
    fn = lambda: ntt.lde_from_coeffs(coeffs, 2, bb.GENERATOR)
    timed("lde_from_coeffs", fn, bool(torch.equal(fn(), ntt_cuda.ntt_plain(ntt.coset_pad(coeffs, 2, bb.GENERATOR)))),
          20, graph=False, shape=[KECCAK_COLS, KECCAK_ROWS, 2])
    leaves = mont((lde_rows, p2.OUT))
    want, cur = [leaves], leaves
    while cur.shape[0] > 1:
        cur = p2.compress_plain(cur.reshape(-1, p2.WIDTH))
        want.append(cur)
    kernels.LAUNCHES.reset()
    levels = merkle.commit(leaves)
    launches = kernels.LAUNCHES.snapshot()
    timed("merkle_commit", lambda: merkle.commit(leaves),
          len(levels) == len(want) and all(torch.equal(a, b) for a, b in zip(levels, want)), 20, leaves=lde_rows,
          launches=launches, wall_ms=wall_ms(lambda: merkle.commit(leaves), 5))
    pairs = mont((2048, p2.WIDTH))
    fn = lambda: poseidon2_cuda.poseidon2_compress(pairs)
    timed("poseidon2_compress", fn, bool(torch.equal(fn(), p2.compress_plain(pairs))), 20)

    trace = rng.integers(0, bb.P, (KECCAK_ROWS, KECCAK_COLS), dtype=np.uint32)
    root = commit_step(trace, "cuda")
    kernels.LAUNCHES.reset()
    commit_step(trace, "cuda")
    launches = kernels.LAUNCHES.snapshot()
    up = convert.words_from_numpy(trace, "cuda")
    emit(kernel="commit_step", label=label, root=convert.bb_to_numpy(root).tolist(), launches=launches,
         warm_wall_ms=wall_ms(lambda: commit_step(trace, "cuda"), 5),
         upload_wall_ms=wall_ms(lambda: convert.words_from_numpy(trace, "cuda"), 5),
         to_mont_ms=cuda_ms(lambda: bb.to_mont(up.T.contiguous()), 5))
    return 0


if __name__ == "__main__":
    sys.exit(main())
