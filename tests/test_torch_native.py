"""The port's host Keccak-256 in C (``utils/native.py``,
``csrc/keccak256_host.cpp``) against ``utils/keccak_py.py`` and the JAX
package's ``raiko_tpu.utils.keccak256``.

Digests must be equal byte for byte (tolerance 0) at the padding edges
(lengths 0, 1, 135, 136, 137, 271, 272: the rate is 136 bytes) and on
seeded random messages up to 2 KB; ``keccak256_batch`` must equal the
single hashes on empty, one-empty and ragged batches; ``CALLS`` counts the
calls into the library.  A source that does not compile makes the first
call raise, with g++'s error, instead of returning a digest.  A copy of the
package alone, in an empty directory and with ``jax`` and ``raiko_tpu``
refused, builds its own library under the copy's ``_build/host/`` and
hashes: the port needs nothing of the repo around it.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from raiko_tpu.utils import keccak256 as jax_keccak256
from raiko_tpu_torch import host_build
from raiko_tpu_torch.utils import keccak_py, native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 20261018
EDGE_LENGTHS = [0, 1, 135, 136, 137, 271, 272]


def _messages(n: int, max_len: int, seed: int = SEED) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, int(rng.integers(0, max_len + 1)), dtype=np.uint8).tobytes() for _ in range(n)]


def test_library_loads():
    impl = native.implementation()
    assert impl.startswith(native.NAME + " (")
    assert os.path.realpath(impl[len(native.NAME) + 2 : -1]).startswith(
        os.path.realpath(os.path.join(REPO, "raiko_tpu_torch", "_build", "host")) + os.sep)


@pytest.mark.parametrize("length", EDGE_LENGTHS)
def test_edge_lengths_match_python_and_jax(length):
    msg = bytes((7 * i + length) % 256 for i in range(length))
    got = native.keccak256(msg)
    assert got == keccak_py.keccak256(msg)
    assert got == jax_keccak256(msg)


def test_known_digests():
    assert native.keccak256(b"") == keccak_py.KECCAK_EMPTY
    assert native.keccak256(b"abc").hex() == "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45"


def test_random_messages_match_python_and_jax():
    """200 seeded messages of 0-2,048 bytes."""
    for msg in _messages(200, 2048):
        got = native.keccak256(msg)
        assert got == keccak_py.keccak256(msg)
        assert got == jax_keccak256(msg)


@pytest.mark.parametrize("msgs", [
    [],
    [b""],
    [b"", b"\x00", b"", b"a" * 136],
    [bytes([i]) * n for i, n in enumerate(EDGE_LENGTHS)],
    _messages(64, 600, SEED + 1),
], ids=["empty", "one_empty", "with_empties", "edge_lengths", "ragged_64"])
def test_batch_matches_singles(msgs):
    assert native.keccak256_batch(msgs) == [native.keccak256(m) for m in msgs]
    assert native.keccak256_batch(msgs) == [keccak_py.keccak256(m) for m in msgs]


def test_calls_are_counted():
    native.implementation()
    native.CALLS.reset()
    for m in (b"", b"x", b"y" * 300):
        native.keccak256(m)
    native.keccak256_batch([b"a", b"b"])
    native.keccak256_batch([])  # no message: no call into the library
    assert native.CALLS.snapshot() == {"raiko_keccak256": 3, "raiko_keccak256_batch": 1}
    native.CALLS.reset()
    assert native.CALLS.snapshot() == {}


@pytest.mark.parametrize("entry", ["keccak256", "keccak256_batch", "implementation"])
def test_build_failure_raises(entry, tmp_path, monkeypatch):
    """No fallback: a source that does not compile fails the first call,
    and g++'s message reaches the caller."""
    bad = tmp_path / "keccak256_host.cpp"
    bad.write_text('extern "C" void raiko_keccak256(const unsigned char* d) { not_a_function(d); }\n')
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_ROOT", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    call = {"keccak256": lambda: native.keccak256(b"abc"),
            "keccak256_batch": lambda: native.keccak256_batch([b"abc"]),
            "implementation": native.implementation}[entry]
    with pytest.raises(RuntimeError, match="not_a_function"):
        call()
    assert native._lib is None
    assert not any(f.endswith(".so") for _, _, files in os.walk(tmp_path / "build") for f in files)


def test_build_is_keyed_by_source_and_flags(tmp_path, monkeypatch):
    src = tmp_path / "k.cpp"
    src.write_text('extern "C" int raiko_one() { return 1; }\n')
    first = host_build.build(str(src), str(tmp_path / "b"))
    assert os.path.basename(first) == "libk.so"
    assert host_build.build(str(src), str(tmp_path / "b")) == first  # built once
    src.write_text('extern "C" int raiko_one() { return 2; }\n')
    changed = host_build.build(str(src), str(tmp_path / "b"))
    monkeypatch.setattr(host_build, "CXX_FLAGS", (*host_build.CXX_FLAGS, "-O1"))
    other = host_build.build(str(src), str(tmp_path / "b"))
    assert len({first, changed, other}) == 3


_STANDALONE = r"""
import json, sys
for name in ("jax", "jaxlib", "raiko_tpu"):
    sys.modules[name] = None  # import raises ModuleNotFoundError
import raiko_tpu_torch
from raiko_tpu_torch.utils import keccak256, keccak256_batch, native
msgs = [bytes(range(n % 256)) * (1 + n // 256) for n in (0, 1, 135, 136, 137, 271, 272, 1000)]
print(json.dumps({
    "package": raiko_tpu_torch.__file__,
    "implementation": native.implementation(),
    "digests": [keccak256(m).hex() for m in msgs],
    "batch": [d.hex() for d in keccak256_batch(msgs)],
    "calls": native.CALLS.snapshot(),
}))
"""


def test_package_copy_alone_builds_and_hashes(tmp_path):
    """The package copied alone (no ``_build/``, no repo around it) builds
    its own library and hashes, with the JAX package refused."""
    copy = tmp_path / "raiko_tpu_torch"
    shutil.copytree(os.path.join(REPO, "raiko_tpu_torch"), copy,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH" and not k.startswith("RAIKO_")}
    env["OMP_NUM_THREADS"] = "1"
    r = subprocess.run([sys.executable, "-c", _STANDALONE], capture_output=True, text=True,
                       timeout=300, env=env, cwd=tmp_path)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert os.path.realpath(res["package"]).startswith(os.path.realpath(copy) + os.sep)
    impl = res["implementation"]
    assert impl.startswith("c (")
    assert os.path.realpath(impl[3:-1]).startswith(os.path.realpath(copy / "_build" / "host") + os.sep)
    msgs = [bytes(range(n % 256)) * (1 + n // 256) for n in (0, 1, 135, 136, 137, 271, 272, 1000)]
    want = [keccak_py.keccak256(m).hex() for m in msgs]
    assert res["digests"] == want
    assert res["batch"] == want
    assert res["calls"] == {"raiko_keccak256": len(msgs), "raiko_keccak256_batch": 1}
    assert sorted(os.listdir(tmp_path)) == ["raiko_tpu_torch"]  # nothing built beside the package
