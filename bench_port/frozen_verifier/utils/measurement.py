"""Instrumentation: wall-clock spans + device step counters
(reference lib/src/lib.rs Measurement :110-157 / CycleTracker :75-108).

The reference's CycleTracker emits zkVM cycle markers; the TPU analog
reports wall-time plus optional device-op annotations, printed in the same
start/end marker style so log tooling can parse both."""

from __future__ import annotations

import logging
import time

log = logging.getLogger("raiko_tpu")


class Measurement:
    """Wall-clock span with inplace progress reporting.

    ``subscribe(fn)`` registers a listener called as ``fn(title,
    seconds)`` when any span stops — the hook bench tooling uses to
    build per-stage breakdowns (tools/bench_block.py) without parsing
    logs.  Returns a token for ``unsubscribe``."""

    _listeners: dict[int, object] = {}
    _next_token = 0

    @classmethod
    def subscribe(cls, fn) -> int:
        cls._next_token += 1
        cls._listeners[cls._next_token] = fn
        return cls._next_token

    @classmethod
    def unsubscribe(cls, token: int) -> None:
        cls._listeners.pop(token, None)

    def __init__(self, title: str = ""):
        self.title = title
        self.t0 = time.perf_counter()
        if title:
            log.info("%s...", title)

    def stop(self) -> float:
        return self.stop_with(f"==> {self.title} took")

    def stop_with(self, message: str) -> float:
        dt = time.perf_counter() - self.t0
        log.info("%s %.3fs", message, dt)
        for fn in list(self._listeners.values()):
            try:
                fn(self.title, dt)
            except Exception:
                pass
        return dt

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


class CycleTracker:
    """start/end markers (reference emits 'cycle-tracker-start/end:' on
    SP1; we emit the same marker text with wall-nanos so existing parsers
    work)."""

    def __init__(self, title: str):
        import sys

        self.title = title
        self.t0 = time.perf_counter_ns()
        print(f"cycle-tracker-start: {title}", file=sys.stderr)

    def end(self) -> None:
        import sys

        print(
            f"cycle-tracker-end: {self.title} {time.perf_counter_ns() - self.t0}",
            file=sys.stderr,
        )
