"""What a traced run reads from torch.profiler's chrome trace.

The attribution follows ``tools/profile_evm_tree.py``'s ``stage_profile``:
each device event (kernel, copy, fill) belongs to the annotated ranges
(``record_function``) open around the runtime call that launched it, on
the launching thread, matched by the trace's correlation id; the device's
busy time is the union of the device events' intervals (that function's
arithmetic, copied).  Here every range that encloses the launch counts,
not only the innermost, and everything is clipped to the window's own
range, ``bench.window``.
"""

from __future__ import annotations

import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"
KERNEL_RANGE = "bench.kernel "  # run.py's range around a commitment kernel's launch


def export(prof) -> list[dict]:
    """The trace's events, through a temporary file that is removed."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    return trace.get("traceEvents", []) if isinstance(trace, dict) else trace


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, None
    for lo, hi in sorted(intervals):
        if end is None or lo > end:
            busy += hi - lo
            end = hi
        elif hi > end:
            busy += hi - end
            end = hi
    return busy


def enclosing(ranges: list, points: list) -> list:
    """For each time in `points` (sorted), the `ranges` ((start, end, name),
    properly nested, sorted by start) open at it, outermost first."""
    out, stack, i = [], [], 0
    for ts in points:
        while i < len(ranges) and ranges[i][0] <= ts:
            while stack and stack[-1][1] < ranges[i][0]:
                stack.pop()
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] < ts:
            stack.pop()
        out.append([r for r in stack if r[1] >= ts])
    return out


class Trace:
    """A traced window: its device events, each with the ranges open at its
    launch, and the host's ranges."""

    def __init__(self, events: list[dict]):
        win = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == WINDOW and "dur" in e]
        if not win:
            raise ValueError(f"the trace has no {WINDOW} range")
        self.t0, self.t1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
        self.ranges: dict = {}  # thread -> [(start, end, name)] by start
        for e in events:
            if e.get("cat") == "user_annotation" and "dur" in e and e.get("name") != WINDOW:
                self.ranges.setdefault(e.get("tid"), []).append((e["ts"], e["ts"] + e["dur"], e["name"]))
        for rs in self.ranges.values():
            rs.sort(key=lambda r: (r[0], -r[1]))
        launch_at: dict = {}  # correlation id -> (thread, start) of the runtime call that issued it
        for e in events:
            corr = e.get("args", {}).get("correlation")
            if e.get("cat") in ("cuda_runtime", "cuda_driver") and corr is not None:
                launch_at[corr] = (e.get("tid"), e["ts"])
        raw = []  # (start, end, name, cat, launching thread, launch time)
        for e in events:
            if e.get("cat") not in DEVICE_CATS or "dur" not in e:
                continue
            lo, hi = max(e["ts"], self.t0), min(e["ts"] + e["dur"], self.t1)
            if hi <= lo:
                continue
            tid, ts = launch_at.get(e.get("args", {}).get("correlation"), (None, e["ts"]))
            raw.append((lo, hi, e.get("name", ""), e["cat"], tid, ts))
        self.device = []  # (start, end, name, cat, the ranges open at the launch)
        by_tid: dict = {}
        for ev in raw:
            by_tid.setdefault(ev[4], []).append(ev)
        for tid, evs in by_tid.items():
            evs.sort(key=lambda ev: ev[5])
            opened = enclosing(self.ranges.get(tid, []), [ev[5] for ev in evs])
            self.device.extend((lo, hi, name, cat, names) for (lo, hi, name, cat, _, _), names in zip(evs, opened))

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        return union_us((lo, hi) for lo, hi, *_ in self.device) / 1e6

    def device_s_in(self, prefix: str) -> float:
        """Device seconds of the events launched inside a range whose name
        starts with `prefix`."""
        return sum(hi - lo for lo, hi, _, _, opened in self.device
                   if any(r[2].startswith(prefix) for r in opened)) / 1e6

    def kernel_calls(self) -> list:
        """(kernel, shape, device seconds) of each commitment-kernel call
        that ``run.py`` wrapped in a ``bench.kernel`` range, its kernels'
        device time summed; calls with no kernel in the window are left out."""
        calls: dict = {}
        for lo, hi, _, cat, opened in self.device:
            if cat != "kernel":
                continue
            for r in opened:
                if r[2].startswith(KERNEL_RANGE):
                    calls[r] = calls.get(r, 0.0) + (hi - lo) / 1e6
        out = []
        for r, s in calls.items():
            kernel, shape = r[2][len(KERNEL_RANGE):].split(" ")
            out.append((kernel, tuple(int(x) for x in shape.split("x")), s))
        return out

    @staticmethod
    def _stage(opened: list) -> str:
        inner = [r[2] for r in opened if not r[2].startswith(KERNEL_RANGE)]
        return inner[-1] if inner else "outside"

    def top_device_ops(self, k: int = 10) -> list:
        """The k device operations that took most time, each named by the
        innermost stage range open at its launch and its own name."""
        by: dict = {}
        for lo, hi, name, _, opened in self.device:
            key = f"{self._stage(opened)} | {name}"[:160]
            by[key] = by.get(key, 0.0) + (hi - lo) / 1e6
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """The device's idle time in the window, summed by what the host was
        doing: the innermost range open at each gap's middle, on the thread
        whose innermost range there is shortest; the k largest."""
        spans = sorted((lo, hi) for lo, hi, *_ in self.device)
        gaps, end = [], self.t0
        for lo, hi in spans:
            if lo > end:
                gaps.append((end, lo))
            end = max(end, hi)
        if self.t1 > end:
            gaps.append((end, self.t1))
        mids = [(lo + hi) / 2 for lo, hi in gaps]
        best = [None] * len(gaps)  # (length, name)
        for rs in self.ranges.values():
            for j, opened in enumerate(enclosing(rs, mids)):
                inner = [r for r in opened if not r[2].startswith(KERNEL_RANGE)]
                if inner and (best[j] is None or inner[-1][1] - inner[-1][0] < best[j][0]):
                    best[j] = (inner[-1][1] - inner[-1][0], inner[-1][2])
        by: dict = {}
        for (lo, hi), b in zip(gaps, best):
            name = b[1] if b else "outside every range"
            by[name] = by.get(name, 0.0) + (hi - lo) / 1e6
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:k]]
