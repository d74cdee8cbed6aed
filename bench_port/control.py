#!/usr/bin/env python3
"""Readings for the limits of ``correct``: sound runs, the control and the
faults, at a cell's own size, several seeds in one process.

    python3 bench_port/control.py --workload NAME --seconds S --seeds N [N ...] \\
        [--inject none control stale ...] --out READINGS.jsonl

For each seed and each name of ``--inject`` (``none``: the program as it
is; otherwise a fault the cell's unit defines, planted in the timed path)
it runs ``run.py``'s whole run and appends one line to ``--out``: the
seed, the fault, ``correct`` and every checked number with its limit.
The benchmark's own runs plant nothing: only this script and the tests
pass a fault.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import run  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--inject", nargs="+", default=["none", "control"])
    p.add_argument("--out", required=True, help="the file the readings are appended to")
    args = p.parse_args()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    for seed in args.seeds:
        for fault in args.inject:
            rc = run.main(["--workload", args.workload, "--seed", str(seed), "--seconds", str(args.seconds)],
                          inject=None if fault == "none" else fault)
            res = run.LAST_RESULT if rc == 0 else None
            line = {"workload": args.workload, "seed": seed, "inject": fault, "rc": rc,
                    "correct": None if res is None else res["correct"],
                    "attempted": None if res is None else res["attempted"],
                    "checked": None if res is None else res["checked"],
                    "metrics": None if res is None else res["metrics"]}
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
            print("control " + json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    run.pin_hash_seed_of(os.path.abspath(__file__), sys.argv[1:])
    sys.exit(main())
