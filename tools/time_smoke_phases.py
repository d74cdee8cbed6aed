#!/usr/bin/env python3
"""Seconds of phases of a checkout's chip_smoke.py on the card, so that two
checkouts compare in one call.

    python3 tools/time_smoke_phases.py --root DIR --label NAME [PHASE ...]

Runs the checkout's own chip_smoke.py functions: its device and build
phases, the setup points' upload, then each PHASE named (default: ops; any
of kernels, stark_kernels, ops, kzg, stark, stark_prove, parallel, block_prove,
seal), each as
chip_smoke.py runs it, checks included.  Prints the phases' own lines, then
one JSON line per PHASE with its seconds, then one per payload
verification a phase started in the background.  Needs one CUDA card; the
checkout's chip_smoke.py refuses JAX and the JAX package on import.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import sys
import time

PHASES = ("kernels", "stark_kernels", "ops", "kzg", "stark", "stark_prove", "parallel", "block_prove", "seal")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        help="checkout whose chip_smoke.py to time")
    parser.add_argument("--label", default="", help="a name for this checkout in the output")
    parser.add_argument("phases", nargs="*", default=["ops"], choices=PHASES, metavar="PHASE")
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke as smoke

    if smoke.ROOT != root:
        raise SystemExit(f"time_smoke_phases: imported {smoke.ROOT}'s chip_smoke.py, not {root}'s")
    if hasattr(smoke, "pin_hash_seed"):  # block_prove's golden needs the seed
        smoke.pin_hash_seed([os.path.abspath(__file__), *sys.argv[1:]])
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_smoke_phases: torch sees no CUDA device")
    from raiko_tpu_torch import convert

    card = smoke.phase_device()
    smoke.phase_build()
    given = {"card": card, "setup32": convert.pack32(convert.setup_points(torch.device("cuda")))}
    for name in args.phases:
        fn = getattr(smoke, f"phase_{name}")
        t0 = time.perf_counter()
        fn(**{k: given[k] for k in inspect.signature(fn).parameters})
        torch.cuda.synchronize()
        print(json.dumps({"label": args.label, "phase": name, "seconds": time.perf_counter() - t0}), flush=True)
    # the payload verifications a phase started in the background
    for pending in getattr(smoke, "_BACKGROUND", []):
        verified, seconds = pending.result()
        print(json.dumps({"label": args.label, "verify": pending.kind, "verified": verified, "seconds": seconds}),
              flush=True)
        if not verified:
            raise SystemExit(f"time_smoke_phases: a served {pending.kind} payload does not verify")
    return 0


if __name__ == "__main__":
    sys.exit(main())
