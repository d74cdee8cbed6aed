"""What the frozen copy keeps of the port's ``kernels.py``: the path of its
C sources and the launch counter.  It holds no CUDA kernel: the frozen
verifier runs on the CPU, where every op is the port's plain version."""

from __future__ import annotations

import os
import threading
from collections import Counter

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")


class LaunchCounter:
    """Calls per name, safe across threads."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Counter = Counter()

    def add(self, name: str) -> None:
        with self._lock:
            self._counts[name] += 1

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counts)

