#!/usr/bin/env python3
"""Time kernel B1 (``ec_add``) and ``poseidon2_hash_rows`` on the card, each
checked bit for bit against its plain PyTorch version; B1 also in each of
its layouts where a checkout's kernels offer a choice.

    python3 tools/time_b1_hash_rows.py                 # this checkout
    python3 tools/time_b1_hash_rows.py --root DIR      # another checkout's raiko_tpu_torch

B1 runs at the widths a served blob MSM launches it with (256 to 65,536
pairs) and at 131,072; poseidon2_hash_rows on the keccak chunk's LDE
transpose (4,096 rows x 4,160 columns) and the flagship's (1,024 x 48);
both also at edge shapes (checked, not timed).  An older checkout without
B1 layouts is timed through its one wrapper.
Small widths are timed as a CUDA graph of back-to-back launches, so the
host's cost per call is left out: the number is the card's time per launch.
Each result is one JSON line; the first line is nvidia-smi's name and power
limit.  Needs one CUDA card; JAX and the JAX package are refused.
"""

from __future__ import annotations

import sys

from kernel_timing import cuda_ms as events_ms, emit, graph_ms, start

WIDTHS = (256, 1024, 4096, 8192, 16384, 32768, 65536, 131072)
EDGE_M = (1, 5, 33, 257, 16385)  # checked, not timed: partial warps and blocks
EDGE_ROWS, EDGE_WIDTHS = (1, 3, 33, 4101), (1, 7, 8, 9, 48, 200)
SEED = 20240613


def main() -> int:
    args = start(__doc__)
    import numpy as np
    import torch

    from raiko_tpu_torch import convert
    from raiko_tpu_torch.fields import babybear as bb
    from raiko_tpu_torch.kzg import curve
    from raiko_tpu_torch.ops import ec_cuda, poseidon2 as p2, poseidon2_cuda

    rng = np.random.default_rng(SEED)

    # B1: p affine setup points, q general projective, with P + P, P + O,
    # O + Q and O + O among the first pairs
    setup32 = convert.pack32(convert.setup_points(torch.device("cuda")))
    pick = lambda k: setup32[torch.as_tensor(rng.integers(0, setup32.shape[0], k), device="cuda")]
    m_max = WIDTHS[-1]
    p = pick(m_max)
    q = ec_cuda.ec_add_plain(pick(m_max), pick(m_max))
    inf = convert.pack32(curve.identity((16,), "cuda"))
    q[:16] = p[:16]
    q[16:32] = inf
    p[32:48] = inf
    p[48:64] = inf
    q[48:64] = inf
    want = ec_cuda.ec_add_plain(p, q)
    layouts = getattr(ec_cuda, "ADD_LANE_CHOICES", (None,))
    for m in EDGE_M:
        pm, qm = p[:m].contiguous(), q[:m].contiguous()
        equal = {str(lanes): bool(torch.equal(ec_cuda.ec_add(pm, qm) if lanes is None
                                              else ec_cuda.ec_add_lanes(pm, qm, lanes), want[:m]))
                 for lanes in layouts}
        emit(kernel="ec_add", label=args.label, m=m, equal=equal)
    for m in WIDTHS:
        pm, qm = p[:m].contiguous(), q[:m].contiguous()
        row = {"kernel": "ec_add", "label": args.label, "m": m}
        if hasattr(ec_cuda, "add_lanes"):
            row["wrapper_lanes"] = ec_cuda.add_lanes(m)
        for lanes in layouts:
            fn = (lambda: ec_cuda.ec_add(pm, qm)) if lanes is None else (lambda: ec_cuda.ec_add_lanes(pm, qm, lanes))
            equal = bool(torch.equal(fn(), want[:m]))
            key = "wrapper" if lanes is None else f"lanes{lanes}"
            row[f"{key}_equal"] = equal
            row[f"{key}_graph_ms"] = graph_ms(fn, 20 if m <= 16384 else 5)
            if m == m_max:
                row[f"{key}_events_ms"] = events_ms(fn, 20)
        if layouts != (None,):
            row["wrapper_graph_ms"] = graph_ms(lambda: ec_cuda.ec_add(pm, qm), 20 if m <= 16384 else 5)
        emit(**row)

    # poseidon2_hash_rows at row counts that are no multiple of a block's
    # rows, contiguous and transposed, then on the LDE transposes
    bad = []
    for rows_n in EDGE_ROWS:
        for width in EDGE_WIDTHS:
            x = convert.words_from_numpy(bb.np_to_mont(rng.integers(0, bb.P, (rows_n, width), dtype=np.uint32)),
                                         "cuda")
            want_e = p2.hash_rows_plain(x)
            for transposed, view in ((False, x), (True, x.T.contiguous().T)):
                if not torch.equal(poseidon2_cuda.poseidon2_hash_rows(view), want_e):
                    bad.append([rows_n, width, transposed])
    emit(kernel="poseidon2_hash_rows", label=args.label, edges_equal=not bad, bad=bad)
    for rows_n, width in ((4096, 4160), (1024, 48)):
        lde = convert.words_from_numpy(bb.np_to_mont(rng.integers(0, bb.P, (width, rows_n), dtype=np.uint32)),
                                       "cuda")
        rows = lde.T
        fn = lambda: poseidon2_cuda.poseidon2_hash_rows(rows)
        emit(kernel="poseidon2_hash_rows", label=args.label, shape=[rows_n, width],
             equal=bool(torch.equal(fn(), p2.hash_rows_plain(rows))), events_ms=events_ms(fn, 5))
    return 0


if __name__ == "__main__":
    sys.exit(main())
