"""Build the port's host C libraries (csrc/*.cpp) with g++ at first use.

Each library is compiled once per content hash into
``_build/host/<hash>/lib<source>.so`` beside this file (listed in
.gitignore), keyed by the source's content and the flags, and loaded with
ctypes by its module (``ops/poseidon2_host.py``, ``utils/native.py``).  A
failed build raises with g++'s stderr: nothing falls back to a Python
version.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile

BUILD_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build", "host")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")


def build(source: str, build_root: str) -> str:
    """Compile `source` into `build_root` unless this content hash has a
    library there already; return the library's path."""
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    out_dir = os.path.join(build_root, digest)
    path = os.path.join(out_dir, f"lib{os.path.splitext(os.path.basename(source))[0]}.so")
    if os.path.exists(path):
        return path
    os.makedirs(out_dir, exist_ok=True)
    # build beside the target and rename, so that processes building at
    # once never load a half-written file
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, source], capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {source}:\n{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path
