"""Instrumentation: the port's one span, ``Measurement``
(reference lib/src/lib.rs Measurement :110-157)."""

from __future__ import annotations

import logging
import sys
import threading
import time

log = logging.getLogger("raiko_tpu")


def _profiler_on() -> bool:
    """Whether torch.profiler is recording: one module lookup and one flag
    (no profiler can run before torch is imported, and a module that has no
    device work, such as the guest's re-execution, does not import it)."""
    torch = sys.modules.get("torch")
    return torch is not None and torch.autograd.profiler._is_profiler_enabled


class Measurement:
    """A span of work: its seconds on the host clock, and, while
    torch.profiler records, a profiler range of the same name on the same
    thread, so a trace puts every launch and every idle gap of the device
    under the innermost span open on the launching thread.  With no
    profiler on, a span opens no range.

    Two rules follow from the range: a span stops on the thread that
    started it, and no span stays open across an ``await`` (the coroutines
    of one event-loop thread interleave, so their ranges would not nest).
    A profiler records the ranges of the thread that started it, and of
    every thread only when asked to (``profile_all_threads``).

    ``subscribe(fn)`` registers a listener called as ``fn(title,
    seconds)`` when any span stops, on the span's thread: the hook the
    benchmark's per-layer metrics read (``bench_port/run.py``'s ``Spans``).
    Returns a token for ``unsubscribe``."""

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
        self._range = None
        if _profiler_on():
            import torch

            self._range = torch.profiler.record_function(title)
            self._range.__enter__()
            self._thread = threading.get_ident()
        self.t0 = time.perf_counter()
        if title:
            log.info("%s...", title)

    def stop(self) -> float:
        dt = time.perf_counter() - self.t0
        if self._range is not None:
            if threading.get_ident() != self._thread:
                raise RuntimeError(f"span {self.title!r} stopped on another thread than the one that started it")
            self._range.__exit__(None, None, None)
            self._range = None
        log.info("==> %s took %.3fs", self.title, dt)
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
