"""The host Poseidon2 permutation in C (csrc/poseidon2_host.cpp).

The Fiat-Shamir channel, the verifier's Merkle paths and the transcript
AIR's trace run the BabyBear Poseidon2 permutation one state at a time on
the host.  ``ops/poseidon2.py``'s ``host_permute``, ``host_hash_row`` and
``host_compress`` are the plain Python versions; the functions here give
the same words bit for bit, from a small C library.

g++ builds the library at first use into ``_build/host/<hash>/`` beside
the package (``host_build.build``, listed in .gitignore), keyed by the
source's content, and ctypes loads it; the round constants are handed to
it once from ``poseidon2.host_constants``.  A build or load failure raises: nothing
falls back to the Python versions.  ``CALLS`` counts the calls into the
library, so a run can show that its transcript went through it.

Every function takes and returns standard-form elements (Python ints
or numpy arrays); inputs are reduced mod p first.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from .. import host_build
from ..fields import babybear as bb
from ..kernels import CSRC, LaunchCounter
from . import poseidon2 as p2

SOURCE = os.path.join(CSRC, "poseidon2_host.cpp")
BUILD_ROOT = host_build.BUILD_ROOT
NAME = "c"  # what ``implementation()`` reports once the library is loaded

CALLS = LaunchCounter()

_P64 = np.uint64(bb.P)
_PTR = ctypes.c_void_p  # a ctypes array or a numpy array's address
_U64 = ctypes.c_uint64
_ENTRIES = {
    "raiko_p2_init": ([_PTR], None),
    "raiko_p2_permute": ([_PTR, _U64], None),
    "raiko_p2_absorb": ([_PTR, _PTR, _U64], None),
    "raiko_p2_squeeze": ([_PTR, _PTR, _U64], None),
    "raiko_p2_hash_rows": ([_PTR, _U64, _U64, _PTR], None),
    "raiko_p2_compress": ([_PTR, _U64, _PTR], None),
    "raiko_p2_path_ok": ([_PTR, _U64, _PTR, _U64, _PTR], ctypes.c_int),
    "raiko_p2_row_path_ok": ([_PTR, _U64, _U64, _PTR, _U64, _PTR], ctypes.c_int),
}

_lock = threading.Lock()
_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(host_build.build(SOURCE, BUILD_ROOT))
            for name, (argtypes, restype) in _ENTRIES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            ext_rc, int_rc, mu = p2.host_constants()
            lib.raiko_p2_init(_words([v for rc in ext_rc for v in rc] + list(int_rc) + list(mu)))
            _lib = lib
        return _lib


def implementation() -> str:
    """Which permutation the host functions run: loads the library (or
    raises) and returns ``NAME`` and the library's path."""
    lib = _load()
    return f"{NAME} ({lib._name})"


def _words(vals):
    """Standard-form uint32 words of any ints (reduced mod p): a ctypes
    array for a sequence, a contiguous uint32 array for a numpy array
    (the C calls take its address)."""
    if isinstance(vals, np.ndarray):
        return np.ascontiguousarray(vals.astype(np.uint64) % _P64, dtype=np.uint32)
    return (ctypes.c_uint32 * len(vals))(*[int(v) % bb.P for v in vals])


def _ptr(buf):
    return buf.ctypes.data if isinstance(buf, np.ndarray) else buf


def _out(n: int):
    return (ctypes.c_uint32 * n)()


def _call(name: str, *args):
    lib = _load()
    CALLS.add(name)
    return getattr(lib, name)(*args)


def permute(state) -> list[int]:
    """One permutation; bit-equal to ``poseidon2.host_permute``."""
    if len(state) != 16:
        raise ValueError(f"a Poseidon2 state has 16 words, not {len(state)}")
    s = _words(list(state))
    _call("raiko_p2_permute", s, 1)
    return s[:]


def permute_batch(states: np.ndarray) -> np.ndarray:
    """(B, 16) states -> (B, 16) uint64; bit-equal to
    ``poseidon2.host_permute_batch``."""
    s = _words(np.asarray(states).reshape(-1, 16))
    _call("raiko_p2_permute", _ptr(s), s.shape[0])
    return s.astype(np.uint64)


def absorb(state, elems) -> list[int]:
    """The channel's absorb: each chunk of up to 8 elements added into
    the state's first words, then one permutation; returns the state."""
    s = _words(list(state))
    _call("raiko_p2_absorb", s, _words(list(elems)), len(elems))
    return s[:]


def squeeze(state, n: int) -> tuple[list[int], list[int]]:
    """The channel's squeeze: (the n elements read, the state after)."""
    s = _words(list(state))
    out = _out(-(-n // 8) * 8)
    _call("raiko_p2_squeeze", s, out, n)
    return out[:n], s[:]


def hash_row(row) -> list[int]:
    """One row's digest; bit-equal to ``poseidon2.host_hash_row``."""
    words = _words(row if isinstance(row, np.ndarray) else list(row))
    out = _out(8)
    _call("raiko_p2_hash_rows", _ptr(words), 1, len(words), out)
    return out[:]


def compress(left, right) -> list[int]:
    """Bit-equal to ``poseidon2.host_compress``."""
    out = _out(8)
    _call("raiko_p2_compress", _words(list(left) + list(right)), 1, out)
    return out[:]


def _digests_ok(*digests) -> bool:
    return all(len(d) == 8 for d in digests)


def _path_words(path):
    return _words([v for d in path for v in d])


def path_ok(leaf, index: int, path, root) -> bool:
    """Walk a Merkle path of standard-form digests from a leaf digest
    (the sibling on the left where the index is odd) and compare with
    the root.  A digest that is not 8 words long fails the check."""
    if not _digests_ok(leaf, root, *path):
        return False
    return bool(_call("raiko_p2_path_ok", _words(list(leaf)), int(index), _path_words(path), len(path),
                      _words(list(root))))


def row_path_ok(row, index: int, path, root) -> bool:
    """``hash_row`` of a row, then ``path_ok``: one call."""
    if not _digests_ok(root, *path):
        return False
    words = _words(row if isinstance(row, np.ndarray) else list(row))
    return bool(_call("raiko_p2_row_path_ok", _ptr(words), len(words), int(index), _path_words(path), len(path),
                      _words(list(root))))
