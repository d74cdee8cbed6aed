"""Build, load and launch the hand-written CUDA kernels under csrc/.

The sources are compiled once per content hash, each by its own

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas -v -c

all started together, and linked with ``nvcc -shared`` into
``_build/<hash>/`` beside this file (listed in .gitignore), at the first
launch; the shared library is loaded with ctypes.  Every C entry
takes its pointers and the stream as ``void*`` and returns
``cudaGetLastError()``; ``launch`` raises if that is not 0.  A failed build
raises: nothing falls back to the plain versions.

Each wrapper counts its launches in ``LAUNCHES`` where it launches, so a run
can show that its path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections import Counter

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
SOURCES = ("bls12_381_g1.cu", "secp256k1_ladder.cu", "babybear_ntt.cu", "babybear_poseidon2.cu",
           "babybear_ntt_mxu.cu", "keccak_f1600.cu", "sha256.cu", "babybear_quotient.cu")
HEADERS = ("field32.cuh", "field32_coop.cuh", "babybear.cuh", "order_by_count.cuh")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C entry -> argtypes after the leading pointers (all entries end in a stream)
_ENTRIES = {
    "raiko_bls12_381_ec_add": 3 * [ctypes.c_void_p] + [ctypes.c_longlong, ctypes.c_int],
    "raiko_bls12_381_weighted_fold": 2 * [ctypes.c_void_p] + [ctypes.c_longlong, ctypes.c_int],
    "raiko_secp256k1_shamir_ladder": 3 * [ctypes.c_void_p] + [ctypes.c_longlong],
    "raiko_babybear_ntt": 5 * [ctypes.c_void_p] + [ctypes.c_longlong] + 3 * [ctypes.c_int]
    + [ctypes.c_uint, ctypes.c_void_p, ctypes.c_int],
    "raiko_poseidon2_hash_rows": 3 * [ctypes.c_void_p] + [ctypes.c_longlong, ctypes.c_int]
    + 2 * [ctypes.c_longlong] + [ctypes.c_uint],
    "raiko_poseidon2_compress": 3 * [ctypes.c_void_p] + [ctypes.c_longlong],
    "raiko_poseidon2_merkle": 3 * [ctypes.c_void_p] + [ctypes.c_int, ctypes.c_void_p],
    "raiko_bls12_381_ec_double": 2 * [ctypes.c_void_p] + [ctypes.c_longlong],
    "raiko_babybear_ntt_mxu": 6 * [ctypes.c_void_p] + [ctypes.c_longlong] + 2 * [ctypes.c_int],
    "raiko_keccak_f1600": 5 * [ctypes.c_void_p] + [ctypes.c_longlong] + 2 * [ctypes.c_int],
    "raiko_sha256_compress": 5 * [ctypes.c_void_p] + [ctypes.c_longlong] + 2 * [ctypes.c_int],
    "raiko_babybear_quotient_uniform": 2 * [ctypes.c_void_p] + 3 * [ctypes.c_int],
    "raiko_babybear_quotient": 14 * [ctypes.c_void_p] + [ctypes.c_int, ctypes.c_longlong] + 5 * [ctypes.c_int],
    "raiko_babybear_quotient_sum": 2 * [ctypes.c_void_p] + [ctypes.c_int, ctypes.c_longlong],
}


class LaunchCounter:
    """Launch counts per kernel, safe across the server's worker threads."""

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


LAUNCHES = LaunchCounter()

_lib = None
_lib_lock = threading.Lock()
BUILD_INFO: dict = {}


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> str:
    """Compile the sources if this content hash has no library yet (one nvcc
    per source, in parallel, then one link); returns the library's path.
    The ptxas report goes to build.log beside it."""
    out_dir = os.path.join(BUILD_ROOT, _source_hash())
    lib_path = os.path.join(out_dir, "libraiko_kernels.so")
    log_path = os.path.join(out_dir, "build.log")
    if os.path.exists(lib_path):
        BUILD_INFO.update(path=lib_path, log=log_path, seconds=0.0, cached=True)
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    objs = [os.path.join(out_dir, f"{os.path.splitext(src)[0]}.{tag}.o") for src in SOURCES]
    t0 = time.perf_counter()
    procs = [
        (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", obj, os.path.join(CSRC, src)]
                    for src, obj in zip(SOURCES, objs))
    ]
    log, failed = [], []
    for cmd, proc in procs:
        output = proc.communicate()[0]
        log.append(" ".join(cmd) + "\n" + output)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} (rc {proc.returncode}):\n{output[-4000:]}")
    tmp = f"{lib_path}.{tag}"
    if not failed:
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(link, capture_output=True, text=True)
        log.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link (rc {proc.returncode}):\n{proc.stderr[-4000:]}")
    seconds = time.perf_counter() - t0
    with open(log_path, "w") as f:
        f.write("\n".join(log))
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, lib_path)
    BUILD_INFO.update(path=lib_path, log=log_path, seconds=seconds, cached=False)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, args in _ENTRIES.items():
                fn = getattr(lib, name)
                fn.argtypes = args + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def launch(entry: str, counter: str, *args) -> None:
    """Call C entry `entry` on torch's current stream and count the launch
    under `counter`.  Tensor arguments pass their data pointers, None a
    null pointer."""
    fn = getattr(library(), entry)
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    err = fn(*c_args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err} at launch")
    LAUNCHES.add(counter)


def aligned(t: torch.Tensor) -> torch.Tensor:
    """`t`, or a copy of it when its data does not start on 16 bytes (a view
    into a larger tensor): the kernels read and write 16 bytes a lane."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def check(t: torch.Tensor, name: str, dtype: torch.dtype, tail: tuple) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` whose trailing
    dimensions are `tail`."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensor on {t.device}, but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape[-len(tail):]) != tail:
        raise ValueError(f"{name}: expected trailing shape {tail}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
