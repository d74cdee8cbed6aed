"""Host Keccak-256 in C (csrc/keccak256_host.cpp), through ctypes.

Trie node references during preflight and re-execution, sender addresses,
transaction and block hashes and the instance hash are hashed one message
at a time on the host, where the cost per call matters more than
throughput (the role sha3's C code plays in the reference, SURVEY.md
§2.2); large batches go to the card's kernel (``ops/keccak.py``).

g++ builds the library at first use into ``_build/host/<hash>/`` beside
the package (``host_build.build``, listed in .gitignore), keyed by the
source's content, and ctypes loads it.  A build or load failure raises:
nothing falls back to ``keccak_py``, which stays as the oracle of the
tests.  ``CALLS`` counts the calls into the library, so a run can show
that its hashing went through it.
"""

from __future__ import annotations

import ctypes
import os
import threading

from .. import host_build
from ..kernels import CSRC, LaunchCounter

SOURCE = os.path.join(CSRC, "keccak256_host.cpp")
BUILD_ROOT = host_build.BUILD_ROOT
NAME = "c"  # what ``implementation()`` reports once the library is loaded

CALLS = LaunchCounter()

_ENTRIES = {
    "raiko_keccak256": [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p],
    "raiko_keccak256_batch": [ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64,
                              ctypes.c_char_p],
}

_lock = threading.Lock()
_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(host_build.build(SOURCE, BUILD_ROOT))
            for name, argtypes in _ENTRIES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = None
            _lib = lib
        return _lib


def implementation() -> str:
    """Which Keccak-256 the host functions run: loads the library (or
    raises) and returns ``NAME`` and the library's path."""
    lib = _load()
    return f"{NAME} ({lib._name})"


def keccak256(data: bytes) -> bytes:
    lib = _load()
    CALLS.add("raiko_keccak256")
    out = ctypes.create_string_buffer(32)
    lib.raiko_keccak256(data, len(data), out)
    return out.raw


def keccak256_batch(msgs: list[bytes]) -> list[bytes]:
    """Hash many variable-length messages in one call into the library."""
    n = len(msgs)
    if n == 0:
        return []
    lib = _load()
    CALLS.add("raiko_keccak256_batch")
    blob = b"".join(msgs)
    offsets = (ctypes.c_uint64 * (n + 1))()
    acc = 0
    for i, m in enumerate(msgs):
        offsets[i] = acc
        acc += len(m)
    offsets[n] = acc
    out = ctypes.create_string_buffer(32 * n)
    lib.raiko_keccak256_batch(blob, offsets, n, out)
    return [out.raw[32 * i : 32 * i + 32] for i in range(n)]
