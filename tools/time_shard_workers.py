#!/usr/bin/env python3
"""Seconds of the served tpu_shard block at each shard pool size, on the card.

    python3 tools/time_shard_workers.py [WORKERS ...]   # default: 4 1 1 4

Builds chip_smoke.py's 100-tx taiko_a7 blob block (``build_chain``), then
proves it through ``Raiko(..., "cuda").prove`` as a ``tpu_shard`` request
with chip_smoke.py's ``SHARD_SERVED_ARGS`` (recursion on, its call trees
cut to ``SHARD_SERVED_FRAMES``) and ``shard_workers`` set to each WORKERS
in turn.  Prints one JSON line per proof: the pool size, seconds, the
recursion circuit's and the prover's stage seconds summed over the pool's
threads, the kernels' launches, and the payload's sha256, which must be
the same at every pool size (the futures are read in submission order).
Needs one CUDA card; chip_smoke.py refuses JAX and the JAX package on
import.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("workers", nargs="*", type=int, default=[4, 1, 1, 4])
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke

    smoke.pin_hash_seed([os.path.abspath(__file__), *sys.argv[1:]])
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_shard_workers: torch sees no CUDA device")
    from raiko_tpu_torch import kernels
    from raiko_tpu_torch.chain import SupportedChainSpecs
    from raiko_tpu_torch.core.interfaces import ProofRequest, ProofType
    from raiko_tpu_torch.core.orchestrator import Raiko
    from raiko_tpu_torch.testing.workload import build_chain

    smoke.phase_device()
    smoke.phase_build()
    cuda = torch.device("cuda")
    build_chain(1, smoke.BLOCK_SERVED_TXS, cuda)
    shas = set()
    for workers in args.workers:
        prover_args = {**smoke.SHARD_SERVED_ARGS, "shard_workers": workers}
        req = ProofRequest(block_number=1, network="taiko_a7", proof_type=ProofType.TPU_SHARD,
                           prover_args=prover_args)
        raiko = Raiko(SupportedChainSpecs(), req, cuda)
        gi = raiko.generate_input()
        out = raiko.get_output(gi)
        torch.cuda.synchronize()
        kernels.LAUNCHES.reset()
        with smoke.SpanMeter() as spans:
            t0 = time.perf_counter()
            proof = raiko.prove(gi, out)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        sha = hashlib.sha256(json.dumps(json.loads(proof.proof), sort_keys=True).encode()).hexdigest()
        shas.add(sha)
        print(json.dumps({"shard_workers": workers, "txs": len(gi.transactions), "prover_args": prover_args,
                          "seconds": seconds, "spans_s": spans.take(), "launches": kernels.LAUNCHES.snapshot(),
                          "payload_bytes": len(proof.proof), "sha256": sha}), flush=True)
    if len(shas) != 1:
        raise SystemExit(f"time_shard_workers: the payload differs between pool sizes: {sorted(shas)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
