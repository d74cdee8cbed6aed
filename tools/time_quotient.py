#!/usr/bin/env python3
"""Time kernel Q1 (the quotient stage's constraint evaluation,
``ops/quotient_cuda.py``) on the card, each result checked bit for bit
against the tape's plain version and, for the EVM CPU table, against the
op-by-op evaluation.

    python3 tools/time_quotient.py                 # this checkout
    python3 tools/time_quotient.py --root DIR      # another checkout's raiko_tpu_torch
    python3 tools/time_quotient.py --segments 8 16 32 --lanes 8 16 32   # + the EVM CPU table and the keccak chunk at each G and L
    python3 tools/time_quotient.py --block-lanes 128 256 512 --warp-tile 2048 4096   # + both at each cap of a block's lanes and of a warp's tile

The tables: every table of the EVM call tree of
``tests/golden/stark_evm_call_tree.json`` (17 tables, the EVM CPU table
1,995 columns over 32 rows), fib, the Poseidon2 transcript AIR and the
keccak chunk (1,024 x 4,160, 3,461 fixed columns), from their goldens'
inputs, with seeded challenges and alpha (``testing/quotient.py``).  For
each: the tape's size and layout (L, G, steps, staged columns), Q1's
CUDA-event mean over REPS calls of its launches alone (``ms``; the same
calls as one CUDA graph, the card's time without the host's,
``graph_ms``; the host's time to launch them, unsynchronised,
``host_ms``) and of the wrapper's whole call (``call_ms``: its host half
and the scalars' upload too; alpha's powers are the prover's, made
once), its launches per call,
the launch's shape, the bound (``chip_smoke.quotient_work``), and one
synchronised call each of the plain version and, for the EVM CPU tables,
of the op-by-op evaluation; ``uniform_ms``, the uniform values' launch
alone, where the checkout has it.  One JSON line per table, and for the
first EVM CPU table a ``profile`` line (torch.profiler over five calls:
the events with the most host or device time).  With ``--segments`` (G,
``quotient_tape.record(..., segments=G)``; 0 the recorder's own choice),
``--lanes`` (L), ``--warp-tile`` (``quotient_tape.WARP_TILE_WORDS``) and
``--block-lanes`` (``quotient_cuda.BLOCK_LANES``), one more line for each
combination on the first EVM CPU table and the keccak chunk, checked and
timed the same way.  The first
line is nvidia-smi's name and power limit.  Needs one CUDA card; JAX and
the JAX package are refused.
"""

from __future__ import annotations

import time

from kernel_timing import cuda_ms, emit, graph_ms, start

# importable once kernel_timing has put the repo first on sys.path
from chip_smoke import load_golden, once_ms, phase_device, quotient_work

REPS = 10


def _profile(fn, calls: int = 5) -> list:
    """torch.profiler's table of `calls` calls of `fn`: the ten events with
    the most host time (self), each with its device time and count."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = sorted(prof.key_averages(), key=lambda e: -(e.self_cpu_time_total + e.self_device_time_total))
    return [{"name": e.key[:80], "count": e.count, "self_cpu_ms": e.self_cpu_time_total / 1e3,
             "self_device_ms": e.self_device_time_total / 1e3} for e in events[:10]]


def _layout(tape, m: int) -> dict:
    """A tape's layout and launch shape, as far as its checkout records
    them."""
    from raiko_tpu_torch.ops import quotient_cuda

    keys = ("lanes", "segments", "instructions", "nops", "steps", "max_steps", "max_slots", "max_columns",
            "columns_staged", "max_segment_rows", "uniform", "uniform_levels", "uniform_steps")
    out = {k: tape.stats[k] for k in keys if k in tape.stats}
    shape = quotient_cuda.launch_shape(tape, m)
    out["launch_shape"] = shape
    if hasattr(tape, "smem_bytes"):
        out["smem_bytes"] = shape[3]
    return out


def main() -> None:
    args = start(__doc__, extra=lambda p: (p.add_argument("--segments", type=int, nargs="*", default=[]),
                                            p.add_argument("--lanes", type=int, nargs="*", default=[]),
                                            p.add_argument("--block-lanes", type=int, nargs="*", default=[]),
                                            p.add_argument("--warp-tile", type=int, nargs="*", default=[])))
    import torch

    from raiko_tpu_torch import kernels
    from raiko_tpu_torch.ops import quotient_cuda
    from raiko_tpu_torch.stark import quotient_tape
    from raiko_tpu_torch.testing.goldens import call_tree_tables, golden_air
    from raiko_tpu_torch.testing.quotient import numerator_case

    card = phase_device()
    tables = [(f"call_tree[{i}]", t) for i, t in enumerate(call_tree_tables(load_golden("evm_call_tree")["inputs"]))]
    tables += [(case, golden_air(case, load_golden(case)["inputs"])[:3]) for case in ("fib", "transcript", "keccak_chunk")]
    for name, (air, trace, publics) in tables:
        case = numerator_case(air, trace, publics, "cuda")
        tape = case.tape()
        m = case.dom.m
        torch.cuda.synchronize()
        kernels.LAUNCHES.reset()
        got = case.kernel()
        torch.cuda.synchronize()
        launches = kernels.LAUNCHES.snapshot()
        want, plain_ms = once_ms(case.plain)
        row = {"table": name, "air": type(air).__name__, "trace": list(trace.shape), "m": m,
               "equal_plain": bool(torch.equal(got, want)), "launches": launches, **tape.stats, **_layout(tape, m)}
        if type(air).__name__ == "EvmCpuAir":
            op, op_ms = once_ms(case.op_by_op)
            row.update(equal_op_by_op=bool(torch.equal(got.long(), op.long())), op_by_op_ms=op_ms)
        if hasattr(quotient_cuda, "uniform_scalars") and len(tape.uniform):
            row["uniform_ms"] = cuda_ms(lambda: quotient_cuda.uniform_scalars(tape, case.publics, case.chal, case.bus,
                                                                               "cuda"), REPS)
        bound_ms, bound_by = card.bound(**quotient_work(tape, m))
        run = case.launches()
        t0 = time.perf_counter()
        for _ in range(REPS):
            run()
        host_ms = (time.perf_counter() - t0) * 1e3 / REPS
        emit(**row, ms=cuda_ms(run, REPS), graph_ms=graph_ms(run, REPS), host_ms=host_ms,
             call_ms=cuda_ms(case.kernel, REPS), plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        if not row["equal_plain"] or not row.get("equal_op_by_op", True):
            raise AssertionError(f"{name}: Q1 differs: {row}")
        if name == "call_tree[0]":
            emit(table=name, profile=_profile(case.kernel))
        if name not in ("call_tree[0]", "keccak_chunk"):
            continue
        if not (args.segments or args.lanes or args.warp_tile or args.block_lanes):
            continue
        saved = {k: getattr(mod, k) for mod, k, given in (
            (quotient_tape, "WARP_TILE_WORDS", args.warp_tile), (quotient_cuda, "BLOCK_LANES", args.block_lanes))
            if given}
        for tile in args.warp_tile or [None]:
            if tile:
                quotient_tape.WARP_TILE_WORDS = tile
            for g in args.segments or [0]:
                for lanes in args.lanes or [None]:
                    kw = {"segments": g or None, **({"lanes": lanes} if lanes else {})}
                    other = quotient_tape.record(air, m, **kw)
                    for cap in args.block_lanes or [None]:
                        if cap:
                            quotient_cuda.BLOCK_LANES = cap
                        same = bool(torch.equal(case.kernel(other), want))
                        emit(table=name, forced=kw, warp_tile=tile, block_lanes=cap, equal_plain=same,
                             ms=cuda_ms(case.launches(other), REPS), call_ms=cuda_ms(lambda: case.kernel(other), REPS),
                             **{**other.stats, **_layout(other, m)})
                        if not same:
                            raise AssertionError(f"{name}: Q1 at {kw}, warp tile {tile}, block lanes {cap} differs")
        for mod in (quotient_tape, quotient_cuda):
            for k, v in saved.items():
                if hasattr(mod, k):
                    setattr(mod, k, v)

if __name__ == "__main__":
    main()
