#!/usr/bin/env python3
"""Where one EVM call tree's proof spends its time on the card.

    python3 tools/profile_evm_tree.py [--reps N]

Proves the call tree of ``tests/golden/stark_evm_call_tree.json`` (a
caller that CALLs a callee and the identity precompile: 17 tables) with
``evm_air.prove_call_tree(..., "cuda")``: once cold, then ``--reps`` warm
proofs, the last under torch.profiler.  Each proof's canonical JSON must
hash to the JAX golden's sha256, and the port's verifier must accept it
(timed).  Prints one JSON line per warm proof with the prover's stage
spans (wall ms, ``Measurement``), then one ``profile`` line, read from the
profiler's trace (``export_chrome_trace``): for each stage, its wall ms,
the device time of the kernels, copies and fills launched inside its
``stark.*`` ranges (each device event goes to the innermost range around
its launch call, matched by the trace's correlation id) and their
launches; the device time launched outside every range; and the whole
proof's wall, its device busy time (the union of the device events) and
busy share.  The port's own kernels, which ctypes launches, count like
torch's: the trace sees their launch calls and their device events.
The quotient stage evaluates each table's constraints in kernel Q1 (up
to three launches a table: its uniform values, its walk, its segments'
sum; beside its finish's NTTs and commitment).  Needs one
CUDA card; JAX and the JAX package are refused as in chip_smoke.py.
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
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def stage_profile(events: list) -> dict:
    """Per ``stark.*`` stage of a chrome trace: wall ms, device ms and
    launches; the device ms launched outside every stage; the device busy
    ms (the union of the device events' intervals) and the device events'
    total."""
    ranges: dict = {}  # thread -> [(start, end, name)] by start
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name", "").startswith("stark.") and "dur" in e:
            ranges.setdefault(e.get("tid"), []).append((e["ts"], e["ts"] + e["dur"], e["name"]))
    for rs in ranges.values():
        rs.sort()
    starts = {tid: [r[0] for r in rs] for tid, rs in ranges.items()}

    def stage_at(tid, ts: float):
        """The innermost stage range of thread `tid` (of any thread where
        `tid` is None) around `ts`, or None."""
        best = None
        for t in ranges if tid is None else [tid] if tid in ranges else []:
            rs = ranges[t]
            for i in range(bisect.bisect_right(starts[t], ts) - 1, -1, -1):
                lo, hi, name = rs[i]
                if best is not None and lo < ts - best[0]:
                    break  # a range that starts earlier and holds ts is longer
                if ts <= hi and (best is None or hi - lo < best[0]):
                    best = (hi - lo, name)
        return None if best is None else best[1]

    stages: dict = {}
    for lo, hi, name in (r for rs in ranges.values() for r in rs):
        row = stages.setdefault(name, {"wall_ms": 0.0, "device_ms": 0.0, "launches": 0, "ranges": 0})
        row["wall_ms"] += (hi - lo) / 1e3
        row["ranges"] += 1
    launch_at: dict = {}  # correlation id -> (thread, start) of the runtime call that issued it
    launches = 0
    for e in events:
        if e.get("cat") not in ("cuda_runtime", "cuda_driver"):
            continue
        corr = e.get("args", {}).get("correlation")
        if corr is not None:
            launch_at[corr] = (e.get("tid"), e["ts"])
        if "LaunchKernel" in e.get("name", ""):
            launches += 1
            name = stage_at(e.get("tid"), e["ts"])
            if name is not None:
                stages[name]["launches"] += 1
    device = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    outside_ms, unmatched = 0.0, 0
    for e in device:
        tid, ts = launch_at.get(e.get("args", {}).get("correlation"), (None, None))
        if ts is None:
            unmatched += 1
            ts = e["ts"]
        name = stage_at(tid, ts)
        if name is None:
            outside_ms += e["dur"] / 1e3
        else:
            stages[name]["device_ms"] += e["dur"] / 1e3
    busy, end = 0.0, None
    for lo, hi in sorted((e["ts"], e["ts"] + e["dur"]) for e in device):
        if end is None or lo > end:
            busy += hi - lo
            end = hi
        elif hi > end:
            busy += hi - end
            end = hi
    return {"device_busy_ms": busy / 1e3, "device_event_ms": sum(e["dur"] for e in device) / 1e3,
            "device_events": len(device), "device_events_without_launch": unmatched,
            "device_ms_outside_stages": outside_ms, "launches": launches, "stages": stages}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=2, help="warm proofs (the last one profiled)")
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    import torch
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

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    profile_line = stage_profile(trace.get("traceEvents", trace) if isinstance(trace, dict) else trace)
    print(json.dumps({"profile": "evm_call_tree", "wall_ms": wall_ms, **profile_line,
                      "busy_share": profile_line["device_busy_ms"] / wall_ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
