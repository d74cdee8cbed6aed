"""Structured rolling file logs + per-stage peak-memory accounting.

Reference analogs:
- host/src/bin/main.rs:31-58 — tracing-subscriber daily-rolling JSON file
  logs when ``--log-path`` is set (stdout pretty logs otherwise).
- host/src/lib.rs:210-232 — the ``cap`` allocator wrapper reporting peak
  allocated bytes per pipeline stage (host/src/proof.rs:219-258).

TPU-native reinterpretation: Python's allocator is not the interesting
one (numpy/XLA buffers dominate), so per-stage accounting reads the
kernel's accounting instead: VmRSS deltas + the process VmHWM high-water
mark from ``/proc/self/status``, sampled at stage boundaries.
"""

from __future__ import annotations

import json
import logging
import logging.handlers
import os
import time


class JsonLineFormatter(logging.Formatter):
    """One JSON object per line, shaped like tracing-subscriber's json
    layer: timestamp, level, target (logger name), message, fields."""

    def format(self, record: logging.LogRecord) -> str:
        obj = {
            "timestamp": time.strftime(
                "%Y-%m-%dT%H:%M:%S", time.gmtime(record.created)
            )
            + f".{int(record.msecs):03d}Z",
            "level": record.levelname,
            "target": record.name,
            "fields": {"message": record.getMessage()},
        }
        if record.exc_info:
            obj["fields"]["exception"] = self.formatException(record.exc_info)
        extra = getattr(record, "fields", None)
        if extra:
            obj["fields"].update(extra)
        return json.dumps(obj, default=str)


def init_logging(
    log_level: str = "info",
    log_path: str | None = None,
    max_bytes: int = 64 << 20,
    backup_count: int = 14,
) -> None:
    """stdout pretty logs always; JSON-lines rolling file when log_path
    is given (the reference rolls daily; we roll by size with the same
    retention spirit — 14 files kept)."""
    level = getattr(logging, log_level.upper(), logging.INFO)
    root = logging.getLogger()
    root.setLevel(level)
    if not any(
        isinstance(h, logging.StreamHandler)
        and not isinstance(h, logging.FileHandler)
        for h in root.handlers
    ):
        sh = logging.StreamHandler()
        sh.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
        )
        root.addHandler(sh)
    if log_path:
        os.makedirs(log_path, exist_ok=True)
        fh = logging.handlers.RotatingFileHandler(
            os.path.join(log_path, "raiko.log"),
            maxBytes=max_bytes,
            backupCount=backup_count,
        )
        fh.setFormatter(JsonLineFormatter())
        root.addHandler(fh)


def _proc_mem() -> tuple[int, int]:
    """(VmRSS bytes, VmHWM bytes) from /proc; (0, 0) off-Linux."""
    rss = hwm = 0
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    rss = int(line.split()[1]) * 1024
                elif line.startswith("VmHWM:"):
                    hwm = int(line.split()[1]) * 1024
    except OSError:
        pass
    return rss, hwm


class MemStage:
    """Per-stage memory accounting context (ref host/src/proof.rs:219-258:
    ``memory::reset_stats`` / ``memory::print_stats`` around each stage).

    Usage::

        with MemStage("prepare_input") as m: ...
        # logs rss delta + process high-water mark, keeps .rss_delta
    """

    log = logging.getLogger("raiko.memory")

    def __init__(self, stage: str):
        self.stage = stage
        self.rss_delta = 0
        self.peak = 0

    def __enter__(self) -> "MemStage":
        self._rss0, _ = _proc_mem()
        return self

    def __exit__(self, *exc) -> None:
        rss1, hwm = _proc_mem()
        self.rss_delta = rss1 - self._rss0
        self.peak = hwm
        self.log.info(
            "%s: rss_delta=%.1f MB rss=%.1f MB peak=%.1f MB",
            self.stage,
            self.rss_delta / 1048576,
            rss1 / 1048576,
            hwm / 1048576,
            extra={
                "fields": {
                    "stage": self.stage,
                    "rss_delta_bytes": self.rss_delta,
                    "rss_bytes": rss1,
                    "peak_bytes": hwm,
                }
            },
        )
        return None
