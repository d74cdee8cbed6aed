#!/usr/bin/env python3
"""Time kernel Q1 (the quotient stage's constraint evaluation,
``ops/quotient_cuda.py``) on the card, each result checked bit for bit
against the tape's plain version and, for the EVM CPU table, against the
op-by-op evaluation.

    python3 tools/time_quotient.py                 # this checkout
    python3 tools/time_quotient.py --root DIR      # another checkout's raiko_tpu_torch
    python3 tools/time_quotient.py --segments 16 32 64 128   # + the EVM CPU table and the keccak chunk at each G

The tables: every table of the EVM call tree of
``tests/golden/stark_evm_call_tree.json`` (17 tables, the EVM CPU table
1,995 columns over 32 rows), fib, the Poseidon2 transcript AIR and the
keccak chunk (1,024 x 4,160, 3,461 fixed columns), from their goldens'
inputs, with seeded challenges and alpha (``testing/quotient.py``).  For
each: the tape's size, Q1's CUDA-event mean over REPS calls of its
launches alone (``ms``) and of the wrapper's whole call (``call_ms``:
its host half and the scalars' upload too; alpha's powers are the
prover's, made once), its launches per call, the bound
(``chip_smoke.quotient_work``), and one synchronised call each of the
plain version and, for the EVM CPU tables, of the op-by-op evaluation.
One JSON line per table, and for the first EVM CPU table a ``profile``
line (torch.profiler over five calls: the events with the most host or
device time); with ``--segments``, one more line per G: Q1 on the
first EVM CPU table and on the keccak chunk recorded with G segments
(``quotient_tape.record(..., segments=G)``), checked and timed the same
way.  The first line is nvidia-smi's name and power limit.  Needs one
CUDA card; JAX and the JAX package are refused.
"""

from __future__ import annotations

from kernel_timing import cuda_ms, emit, start

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


def main() -> None:
    args = start(__doc__, extra=lambda p: p.add_argument("--segments", type=int, nargs="*", default=[]))
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
        torch.cuda.synchronize()
        kernels.LAUNCHES.reset()
        got = case.kernel()
        torch.cuda.synchronize()
        launches = kernels.LAUNCHES.snapshot()
        want, plain_ms = once_ms(case.plain)
        row = {"table": name, "air": type(air).__name__, "trace": list(trace.shape), "m": case.dom.m,
               "equal_plain": bool(torch.equal(got, want)), "launches": launches, **tape.stats}
        if type(air).__name__ == "EvmCpuAir":
            op, op_ms = once_ms(case.op_by_op)
            row.update(equal_op_by_op=bool(torch.equal(got.long(), op.long())), op_by_op_ms=op_ms)
        bound_ms, bound_by = card.bound(**quotient_work(tape, case.dom.m))
        emit(**row, ms=cuda_ms(case.launches(), REPS), call_ms=cuda_ms(case.kernel, REPS), plain_ms=plain_ms,
             bound_ms=bound_ms, bound_by=bound_by, launch_shape=quotient_cuda.launch_shape(tape, case.dom.m))
        if not row["equal_plain"] or not row.get("equal_op_by_op", True):
            raise AssertionError(f"{name}: Q1 differs: {row}")
        if name == "call_tree[0]":
            emit(table=name, profile=_profile(case.kernel))
        if name in ("call_tree[0]", "keccak_chunk"):
            for g in args.segments:
                forced = quotient_tape.record(air, case.dom.m, segments=g)
                same = bool(torch.equal(case.kernel(forced), want))
                emit(table=name, equal_plain=same, ms=cuda_ms(case.launches(forced), REPS),
                     call_ms=cuda_ms(lambda: case.kernel(forced), REPS),
                     launch_shape=quotient_cuda.launch_shape(forced, case.dom.m), **forced.stats)
                if not same:
                    raise AssertionError(f"{name}: Q1 at G = {g} differs")


if __name__ == "__main__":
    main()
