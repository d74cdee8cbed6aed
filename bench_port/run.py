#!/usr/bin/env python3
"""The port's benchmark: one cell of ``BENCHMARK.json`` a run.

    python3 bench_port/run.py --workload NAME --seed N --seconds S --trace 0|1

Drives ``raiko_tpu_torch`` (the PyTorch and CUDA port) on one CUDA card.
Everything that belongs to one cell is found by name:

* the cell in ``BENCHMARK.json`` names a configuration, whose ``file``
  holds its settings, and a traffic mix, ``traffic/<traffic>.json``;
* the mix names its unit, ``units/<unit>.py``: the code that sets the
  cell up from the seed, runs one unit of work, and checks the window's
  answers against the plain reference;
* each metric is read by ``metrics/<name>.py``, a function of the run.

A run sets up (building the blocks from the seed, warming every shape the
window uses: ``setup_s``), then runs units back to back for ``--seconds``
(closed loop, one caller), then checks what the window produced.  With
``--trace 1`` the window runs under torch.profiler and the per-layer
metrics are printed instead of the end-to-end ones.  The last line of
standard output is the result; the checks' numbers and limits are the
last lines of standard error and the result's last key, ``checked``.

The run exits non-zero with no result when torch sees fewer CUDA cards
than the cell asks for, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BENCHMARK = os.path.join(ROOT, "BENCHMARK.json")
REFUSED = ("jax", "jaxlib", "flax", "raiko_tpu")
# the state-trie statement's order follows Python's string hashing
# (chip_smoke.py pins it the same way), so every run is pinned
HASH_SEED = "0"
LAST_RESULT: dict | None = None  # the last result main() printed, for control.py


def pin_hash_seed_of(script: str, argv: list[str]) -> None:
    """Re-execute `script` under PYTHONHASHSEED=HASH_SEED unless it is."""
    if os.environ.get("PYTHONHASHSEED") != HASH_SEED:
        os.execve(sys.executable, [sys.executable, script, *argv], {**os.environ, "PYTHONHASHSEED": HASH_SEED})


def fix_cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths.
    The port's own kernels build into ``raiko_tpu_torch/_build/``; these
    are torch's and Triton's, should anything use them."""
    cache = os.path.join(HERE, "_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def refused_modules() -> list[str]:
    """Loaded modules of JAX or of the JAX package, by whole top-level name."""
    return sorted(m for m, mod in list(sys.modules.items()) if mod is not None and m.split(".")[0] in REFUSED)


def load_cell(bench: dict, name: str) -> tuple[dict, dict, dict]:
    """(cell, its configuration's settings, its traffic mix), found by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"run.py: no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(ROOT, config["file"])) as f:
        settings = json.load(f)
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return cell, settings, traffic


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics this cell reports: its end-to-end ones, or with `trace`
    its per-layer ones; a metric without ``workloads`` is every cell's."""
    metrics = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in metrics if cell in m.get("workloads", [cell])]


class Spans:
    """The port's ``Measurement`` spans that end while it listens, from any
    thread: (title, seconds)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.items: list = []
        self.listening = False

    def __call__(self, title: str, seconds: float) -> None:
        if self.listening:
            with self._lock:
                self.items.append((title, seconds))

    def total_s(self, prefix: str) -> float:
        """Seconds of the spans whose title starts with `prefix`."""
        return sum(s for t, s in self.items if t.startswith(prefix))


class Run:
    """What a metric reader sees of one run."""

    def __init__(self, cell: dict, settings: dict, traffic: dict, device: str = "cuda"):
        self.cell, self.settings, self.traffic, self.device = cell, settings, traffic, device
        self.setup_s = 0.0
        self.window_s = 0.0
        self.unit_s: list[float] = []  # each unit's seconds, in order
        self.failed = 0
        self.spans = Spans()
        self.counters: dict = {}  # name -> count over the window
        self.trace = None  # profile_trace.Trace of a traced window
        self.card: dict = {}

    def sync(self) -> None:
        """Wait for the card's queued work (nothing to wait for on the CPU)."""
        if self.device == "cuda":
            import torch

            torch.cuda.synchronize()

    @property
    def units(self) -> int:
        return len(self.unit_s)

    def seconds_per_unit(self) -> float | None:
        """The window over every unit it completed: all the work and all
        the time."""
        return self.window_s / self.units if self.units else None

    def percentile(self, q: float) -> float | None:
        """The q-th percentile (0-100) of the units' seconds, over all of
        them (``statistics.quantiles``, the exclusive method)."""
        if len(self.unit_s) < 2:
            return None
        return statistics.quantiles(self.unit_s, n=100)[int(q) - 1]


def card_info(torch) -> dict:
    """The card's name, count, SMs, clocks and power limit."""
    def smi(query: str) -> str:
        proc = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader,nounits"],
                              capture_output=True, text=True, timeout=60)
        return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 and proc.stdout.strip() else ""

    info = {"kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
            "sms": torch.cuda.get_device_properties(0).multi_processor_count}
    raw = smi("clocks.max.sm,clocks.sm,power.limit")
    try:
        max_sm, sm, limit = (float(x) for x in raw.split(","))
    except ValueError:
        max_sm, sm, limit = 1980.0, 0.0, 0.0  # H100 SXM's maximum SM clock
    info.update(max_sm_mhz=max_sm, sm_mhz=sm, power_limit_w=limit)
    return info


def record_kernel_shapes():
    """Wrap the four commitment kernels' entry points so that each launch
    runs inside a profiler range that names its kernel and shape: the
    roofline readers count each launch's work from it.  Only a traced run
    does this; returns the function that restores the entry points."""
    import torch

    from raiko_tpu_torch.ops import ntt_cuda, poseidon2_cuda

    def wrap(mod, attr, name, shape_of):
        orig = getattr(mod, attr)

        def wrapped(*args, **kwargs):
            shape = shape_of(*args, **kwargs)
            with torch.profiler.record_function(f"bench.kernel {name} {'x'.join(map(str, shape))}"):
                return orig(*args, **kwargs)

        setattr(mod, attr, wrapped)
        return lambda: setattr(mod, attr, orig)

    restores = [
        wrap(ntt_cuda, "intt", "intt", lambda x: tuple(x.shape)),
        wrap(ntt_cuda, "ntt_coset", "ntt_coset", lambda c, b, s: (c.shape[0], c.shape[1], b)),
        wrap(poseidon2_cuda, "poseidon2_hash_rows", "poseidon2_hash_rows", lambda r: tuple(r.shape)),
        wrap(poseidon2_cuda, "poseidon2_merkle", "poseidon2_merkle", lambda leaves: (leaves.shape[0],)),
    ]
    return lambda: [r() for r in restores]


def run_window(run: Run, unit, seconds: float, traced: bool, units: int | None = None):
    """Units back to back until `seconds` have passed and the unit's cycle
    of inputs (``unit.cycle`` units) has come round to its start: every run
    then holds the same mix, whatever the seed and wherever the time runs
    out.  Each unit runs to its end, and the window ends with the last.
    `units` (tests only) runs that many units instead, whatever the time.
    The unit's ``window_start`` and ``window_end`` read its counters."""
    import torch

    def loop():
        unit.window_start()
        run.spans.listening = True
        t0 = time.perf_counter()
        i = 0
        while True:
            t = time.perf_counter()
            done = i == units if units is not None else t - t0 >= seconds and i > 0 and i % unit.cycle == 0
            if done:
                break
            try:
                unit.run(i)
            except Exception as exc:  # an answer that never comes: counted, reported
                run.failed += 1
                print(f"unit {i} failed: {type(exc).__name__}: {exc}", file=sys.stderr, flush=True)
            run.unit_s.append(time.perf_counter() - t)
            i += 1
        run.sync()
        run.window_s = time.perf_counter() - t0
        run.spans.listening = False
        unit.window_end()

    if not traced:
        loop()
        return
    from torch.profiler import ProfilerActivity, profile

    from profile_trace import Trace, export

    restore = record_kernel_shapes()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function("bench.window"):
                loop()
    finally:
        restore()
    run.trace = Trace(export(prof))


def main(argv=None, inject=None, device: str = "cuda", units: int | None = None) -> int:
    """One run.  `inject` (tests and ``control.py`` only) names a fault or
    the control to plant in the timed path, as the unit defines them;
    `device` "cpu" (tests only) skips the look for a card, runs the port's
    plain versions and reports the platform "cpu"; `units` (tests only)
    runs that many units in the window, whatever the time."""
    argv = sys.argv[1:] if argv is None else argv
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    fix_cache_dirs()
    with open(BENCHMARK) as f:
        bench = json.load(f)
    cell, settings, traffic = load_cell(bench, args.workload)

    t_setup = time.perf_counter()
    import torch

    on_card = device == "cuda"
    if on_card and (not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]):
        print(f"run.py: the cell needs {cell['chips']} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    for path in (ROOT, HERE):
        if path not in sys.path:
            sys.path.insert(0, path)
    from raiko_tpu_torch.utils.measurement import Measurement

    run = Run(cell, settings, traffic, device)
    run.card = card_info(torch) if on_card else {"kind": "cpu", "sm_mhz": 0.0, "max_sm_mhz": 0.0, "power_limit_w": 0.0}
    token = Measurement.subscribe(run.spans)
    unit_mod = load_module(os.path.join(HERE, "units", traffic["unit"] + ".py"), "bench_unit_" + traffic["unit"])
    unit = unit_mod.Unit(seed=args.seed, settings=settings, traffic=traffic, run=run, inject=inject, device=device)
    try:
        unit.setup()
        run.sync()
        run.setup_s = time.perf_counter() - t_setup
        print(json.dumps({"setup_s": run.setup_s, **unit.describe()}), flush=True)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        run_window(run, unit, args.seconds, bool(args.trace), units)
        memory_peak = (max(torch.cuda.max_memory_allocated(d) for d in range(torch.cuda.device_count()))
                       if on_card else 0)
    finally:
        unit.close()
        Measurement.unsubscribe(token)

    metrics = {}
    for m in cell_metrics(bench, cell["name"], bool(args.trace)):
        reader = load_module(os.path.join(HERE, "metrics", m["name"] + ".py"), "bench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    print(json.dumps({"unit_s": run.unit_s, "window_s": run.window_s, "counters": run.counters}), flush=True)
    checked = unit.check()  # the program's state is freed first: the reference runs after
    found = refused_modules()
    if found:
        print(f"run.py: JAX or the JAX package was loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    correct = run.failed == 0 and run.units > 0 and all(c["value"] <= c["limit"] for c in checked.values())
    device = {"platform": "gpu" if on_card else "cpu", "kind": run.card["kind"],
              "count": cell["chips"] if on_card else 0, "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": run.units, "failed": run.failed, "metrics": metrics, "device": device}
    if run.trace is not None:
        device.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        result["breakdown"] = {"device_ops": run.trace.top_device_ops(), "idle_gaps": run.trace.idle_gaps()}
    result["card"] = {k: run.card[k] for k in ("sm_mhz", "max_sm_mhz", "power_limit_w")}
    result["checked"] = checked
    for name, c in checked.items():
        print(f"checked {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    global LAST_RESULT
    LAST_RESULT = result
    return 0


if __name__ == "__main__":
    pin_hash_seed_of(os.path.abspath(__file__), sys.argv[1:])
    sys.exit(main())
