"""ctypes bindings for the C++ host-runtime library (native/).

Auto-builds ``libraiko_native.so`` on first import if the toolchain is
available, and falls back to pure-Python implementations otherwise.  The
native library carries the host-side hot loops that are neither TPU work nor
tolerable in Python: sequential Keccak-256 during MPT traversal, batch
ecrecover, etc. (the role blst/sha3/secp256k1 C code plays in the reference,
SURVEY.md §2.2).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libraiko_native.so"))

_lock = threading.Lock()
_lib = None
_tried = False


def _load() -> ctypes.CDLL | None:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            if not os.path.exists(_LIB_PATH):
                subprocess.run(
                    ["make", "-s", "-C", os.path.abspath(_NATIVE_DIR)],
                    check=True,
                    capture_output=True,
                    timeout=300,
                )
            lib = ctypes.CDLL(_LIB_PATH)
            lib.raiko_keccak256.argtypes = [
                ctypes.c_char_p,
                ctypes.c_uint64,
                ctypes.c_char_p,
            ]
            lib.raiko_keccak256_batch.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.c_uint64,
                ctypes.c_char_p,
            ]
            _lib = lib
        except Exception:
            _lib = None
        return _lib


def native_available() -> bool:
    return _load() is not None


def keccak256(data: bytes) -> bytes:
    lib = _load()
    if lib is None:
        from .keccak_py import keccak256 as py_keccak256

        return py_keccak256(data)
    out = ctypes.create_string_buffer(32)
    lib.raiko_keccak256(data, len(data), out)
    return out.raw


def keccak256_batch(msgs: list[bytes]) -> list[bytes]:
    """Hash many variable-length messages in one native call."""
    lib = _load()
    if lib is None:
        from .keccak_py import keccak256 as py_keccak256

        return [py_keccak256(m) for m in msgs]
    n = len(msgs)
    if n == 0:
        return []
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
