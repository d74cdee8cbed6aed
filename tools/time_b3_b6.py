#!/usr/bin/env python3
"""Time kernels B3 (``ec_double``) and B6 (``ntt_mxu``) on the card, B6
beside B5's ``ntt``.

    python3 tools/time_b3_b6.py                      # this checkout
    python3 tools/time_b3_b6.py --root DIR           # another checkout's raiko_tpu_torch

B3 runs at 256 to 1,048,576 points (half affine points, half with Z != 1,
identities among them); B6 and B5 at every size 2^1 to 2^14 over 2^20
elements (64 x 2^14 the largest).  Times are the card's time per call from
a CUDA graph of back-to-back calls (``graph_ms``), CUDA-event means beside
B3's (``events_ms``).  The checks against the plain versions are
chip_smoke.py's phase ``ops``; this only times.  Each result is one JSON
line; the first line is nvidia-smi's name and power limit.  Needs one CUDA
card; JAX and the JAX package are refused.
"""

from __future__ import annotations

import sys

from kernel_timing import cuda_ms as events_ms, emit, graph_ms, start

from chip_smoke import SEED

B3_WIDTHS = (256, 1024, 4096, 8192, 16384, 32768, 65536, 131072, 524288, 1048576)
B6_MAX_LOG_N = 14


def main() -> int:
    args = start(__doc__)
    import numpy as np
    import torch

    from raiko_tpu_torch import convert
    from raiko_tpu_torch.fields import babybear as bb
    from raiko_tpu_torch.kzg import curve
    from raiko_tpu_torch.ops import ec_cuda, ntt_cuda, ntt_mxu

    label = args.label
    rng = np.random.default_rng(SEED)
    setup32 = convert.pack32(convert.setup_points(torch.device("cuda")))
    pick = lambda k: setup32[torch.as_tensor(rng.integers(0, setup32.shape[0], k), device="cuda")]

    m_max = B3_WIDTHS[-1]
    pts = pick(m_max)
    pts[m_max // 2 :] = ec_cuda.ec_add_plain(pick(m_max // 2), pick(m_max // 2))
    pts[::97] = convert.pack32(curve.identity((), "cuda"))
    for m in B3_WIDTHS:
        pm = pts[:m]
        fn = lambda: ec_cuda.ec_double(pm)
        reps = 20 if m <= 16384 else 5
        emit(kernel="ec_double", label=label, m=m, graph_ms=graph_ms(fn, reps), events_ms=events_ms(fn, reps))

    for log_n in range(1, B6_MAX_LOG_N + 1):
        x = convert.words_from_numpy(
            bb.np_to_mont(rng.integers(0, bb.P, (1 << (20 - log_n), 1 << log_n), dtype=np.uint32)), "cuda")
        emit(kernel="ntt_mxu", label=label, shape=list(x.shape), graph_ms=graph_ms(lambda: ntt_mxu.ntt_mxu(x), 10),
             b5_graph_ms=graph_ms(lambda: ntt_cuda.ntt(x), 10))
    return 0


if __name__ == "__main__":
    sys.exit(main())
