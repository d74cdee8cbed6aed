#!/usr/bin/env python3
"""Where one EVM call tree's proof spends its time on the card.

    python3 tools/profile_evm_tree.py [--reps N]

Proves the call tree of ``tests/golden/stark_evm_call_tree.json`` (a
caller that CALLs a callee and the identity precompile: 17 tables) with
``evm_air.prove_call_tree(..., "cuda")``: once cold, then ``--reps`` warm
proofs, the last under torch.profiler.  Each proof's canonical JSON must
hash to the JAX golden's sha256, and the port's verifier must accept it
(timed).  Prints one JSON line per warm proof with the prover's stage
spans (wall ms, ``Measurement``), then one ``profile`` line: for each
stage, its wall ms, its device ms and the CUDA kernels launched inside
its ``stark.*`` ranges (the runtime's launch calls, counted on the host),
and the whole proof's device time and launches.  The quotient stage
evaluates every AIR's constraints op by op on the device, so its launches
are the number to read.  Needs one CUDA card; JAX and the JAX package are
refused as in chip_smoke.py.
"""

from __future__ import annotations

import sys

for _name in ("jax", "jaxlib", "raiko_tpu"):
    sys.modules[_name] = None

import argparse
import bisect
import hashlib
import json
import os
import subprocess
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=2, help="warm proofs (the last one profiled)")
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("profile_evm_tree: torch sees no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    from raiko_tpu_torch import kernels
    from raiko_tpu_torch.ops import poseidon2_host as p2h
    from raiko_tpu_torch.stark.airs import evm_air as ea
    from raiko_tpu_torch.utils.measurement import Measurement

    kernels.library()
    with open(os.path.join(ROOT, "tests", "golden", "stark_evm_call_tree.json")) as f:
        g = json.load(f)
    inp = g["inputs"]

    def tree():
        return ea.execute_frame(bytes.fromhex(inp["caller"]), ea.FrameEnv(**inp["env"]), inp["gas"],
                                world={inp["callee_address"]: {"code": bytes.fromhex(inp["callee"])}},
                                warm_addresses=set())

    def sha(obj) -> str:
        return hashlib.sha256(json.dumps(obj, sort_keys=True).encode()).hexdigest()

    spans: dict = {}

    def record(title: str, seconds: float) -> None:
        if title.startswith("stark."):
            spans[title] = spans.get(title, 0.0) + seconds * 1e3

    token = Measurement.subscribe(record)

    def prove_once(label: str):
        spans.clear()
        kernels.LAUNCHES.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        payload = ea.prove_call_tree(tree(), "cuda")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        ok = sha(payload) == g["sha256"]
        print(json.dumps({"proof": label, "wall_ms": wall_ms, "tables": len(payload["starks"]),
                          "equal_golden": ok, "stage_wall_ms": dict(spans),
                          "launches": kernels.LAUNCHES.snapshot()}), flush=True)
        if not ok:
            raise AssertionError(f"{label}: the proof differs from the JAX golden")
        return payload, wall_ms

    payload, _ = prove_once("cold")
    t0 = time.perf_counter()
    verified = ea.verify_frame_payload(payload, "cuda")
    print(json.dumps({"verify_s": time.perf_counter() - t0, "verified": verified,
                      "host_poseidon2": p2h.implementation()}), flush=True)
    if not verified:
        raise AssertionError("the port's verifier rejects the proof")
    for rep in range(args.reps - 1):
        prove_once(f"warm{rep}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall_ms = prove_once("profiled")
    Measurement.unsubscribe(token)

    events = prof.events()
    ranges = [e for e in events if e.device_type == DeviceType.CPU and e.name.startswith("stark.")]
    launch_ts = sorted(e.time_range.start for e in events
                       if e.device_type == DeviceType.CPU and "LaunchKernel" in e.name)
    stages: dict = {}
    for e in ranges:
        row = stages.setdefault(e.name, {"wall_ms": 0.0, "device_ms": 0.0, "launches": 0, "ranges": 0})
        row["wall_ms"] += e.cpu_time_total / 1e3
        row["device_ms"] += e.device_time_total / 1e3
        row["launches"] += (bisect.bisect_right(launch_ts, e.time_range.end)
                            - bisect.bisect_left(launch_ts, e.time_range.start))
        row["ranges"] += 1
    device_ms = sum(e.time_range.elapsed_us() for e in events
                    if e.device_type == DeviceType.CUDA and not e.name.startswith("stark.")) / 1e3
    print(json.dumps({"profile": "evm_call_tree", "wall_ms": wall_ms, "device_ms": device_ms,
                      "busy_share": device_ms / wall_ms, "launches": len(launch_ts), "stages": stages}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
