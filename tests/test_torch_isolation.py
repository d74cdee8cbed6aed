"""The port stands alone: it imports nothing of ``raiko_tpu`` and no JAX.

Every module of ``raiko_tpu_torch`` and ``chip_smoke.py`` is read as a
syntax tree: no import of ``raiko_tpu`` (absolute, or relative out of the
package) and none of ``jax``; no port module names a path that leaves the
package (``".."``, ``os.pardir``, more ``os.path.dirname`` or ``.parent``
steps up from ``__file__`` than the module lies deep in it), and neither
they nor ``chip_smoke.py`` name the JAX package's ``native/`` library.  A subprocess that refuses both imports every
port module, serves one v2 ``native`` request for a 16-tx taiko_a7 blob
block through the port's server on the CPU (whose hashing must go through
the port's own host Keccak library, ``utils/native.py``), proves the same block again
on the port's host path (``device=None``: host MSM, per-tx recovery), which
shares no code with the kernels, runs the flagship commitment step,
whose root must equal the JAX step's, proves and verifies a fib AIR,
whose proof must hash as the JAX package's golden proof does, and
aggregates a smaller fib proof through the recursion circuit at
``NUM_QUERIES`` 4, whose outer proof must hash as the JAX golden's
(``stark_recursion_fib.json``) and verify.
"""

import ast
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "raiko_tpu_torch")
FORBIDDEN = ("raiko_tpu", "jax", "jaxlib")


def _port_sources() -> list[str]:
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        paths += [os.path.join(root, f) for f in sorted(files) if f.endswith(".py")]
    return sorted(os.path.relpath(p, REPO) for p in paths)


def _imported_roots(path: str) -> set[str]:
    """Top-level package of every import in the file, relative imports
    resolved against the file's package."""
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), path)
    package = os.path.dirname(path).replace(os.sep, ".").split(".") if os.path.dirname(path) else []
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = package[: len(package) - node.level + 1]
                target = base + (node.module.split(".") if node.module else [])
                roots.add(target[0] if target else "")
            else:
                roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_sources())
def test_port_module_imports_no_reference(path):
    roots = _imported_roots(path)
    assert not roots & set(FORBIDDEN), f"{path} imports {sorted(roots & set(FORBIDDEN))}"
    if path.startswith("raiko_tpu_torch"):
        assert "" not in roots  # no relative import climbs out of the package


def _docstrings(tree: ast.AST) -> set[int]:
    return {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant) and isinstance(node.body[0].value.value, str)}


def _steps_up(node: ast.AST) -> int | None:
    """How many directories up from ``__file__`` the path expression
    `node` climbs (``os.path.dirname`` calls, ``.parent`` and ``.parents[k]``
    steps; ``abspath``, ``realpath`` and ``Path`` keep the level), or None
    where it is not built from ``__file__``."""
    if isinstance(node, ast.Name):
        return 0 if node.id == "__file__" else None
    if isinstance(node, ast.Call) and len(node.args) == 1:
        name = node.func.attr if isinstance(node.func, ast.Attribute) else getattr(node.func, "id", "")
        inner = _steps_up(node.args[0])
        if inner is None:
            return None
        if name == "dirname":
            return inner + 1
        if name in ("abspath", "realpath", "normpath", "Path"):
            return inner
        return None
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and node.func.attr == "resolve":
        return _steps_up(node.func.value)
    if isinstance(node, ast.Attribute) and node.attr == "parent":
        inner = _steps_up(node.value)
        return None if inner is None else inner + 1
    if (isinstance(node, ast.Subscript) and isinstance(node.value, ast.Attribute)
            and node.value.attr == "parents" and isinstance(node.slice, ast.Constant)):
        inner = _steps_up(node.value.value)
        return None if inner is None else inner + node.slice.value + 1
    return None


def _paths_out_of_the_package(path: str) -> list[str]:
    """Where the module at `path` names a path that leaves the port's
    package, or the JAX package's ``native/`` library."""
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), path)
    in_port = path.startswith("raiko_tpu_torch" + os.sep)
    depth = len(os.path.dirname(path).split(os.sep))  # raiko_tpu_torch/ops/x.py: 2 steps up reach the package
    docs = _docstrings(tree)
    found = []
    for node in ast.walk(tree):
        where = f"{path}:{getattr(node, 'lineno', '?')}"
        if isinstance(node, ast.Constant) and isinstance(node.value, str) and id(node) not in docs:
            text = node.value.replace("\\", "/")
            if "native/" in text or "libraiko_native" in text:
                found.append(f"{where}: names native/ ({node.value!r})")
            if in_port and (text == ".." or "../" in text or text.endswith("/..")):
                found.append(f"{where}: climbs with {node.value!r}")
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "join":
            if any(isinstance(a, ast.Constant) and a.value == "native" for a in node.args):
                found.append(f"{where}: joins 'native' into a path")
        if in_port:
            if isinstance(node, ast.Attribute) and node.attr == "pardir":
                found.append(f"{where}: climbs with os.pardir")
            steps = _steps_up(node)
            if steps is not None and steps > depth:
                found.append(f"{where}: climbs {steps} directories up from __file__, out of the package")
    return found


@pytest.mark.parametrize("path", _port_sources())
def test_port_module_names_no_path_out_of_the_package(path):
    assert _paths_out_of_the_package(path) == []


def test_path_walk_sees_what_leaves_the_package(tmp_path, monkeypatch):
    """The walk above flags each way out that it names, and passes the
    package's own ``csrc/`` and ``_build/``."""
    pkg = tmp_path / "raiko_tpu_torch" / "utils"
    pkg.mkdir(parents=True)
    (pkg / "ok.py").write_text(
        "import os\n"
        "CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), 'csrc')\n")
    (pkg / "bad.py").write_text(
        "import os, pathlib\n"
        "A = os.path.join(os.path.dirname(__file__), '..', '..', 'native')\n"
        "B = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))\n"
        "C = pathlib.Path(__file__).resolve().parents[2]\n"
        "D = os.path.join(os.path.dirname(__file__), os.pardir)\n"
        "E = 'native/libraiko_native.so'\n")
    monkeypatch.setattr(sys.modules[__name__], "REPO", str(tmp_path))
    assert _paths_out_of_the_package(os.path.join("raiko_tpu_torch", "utils", "ok.py")) == []
    found = _paths_out_of_the_package(os.path.join("raiko_tpu_torch", "utils", "bad.py"))
    lines = sorted({int(f.split(":")[1]) for f in found})
    assert lines == [2, 3, 4, 5, 6], found


def test_port_tree_is_whole():
    paths = _port_sources()
    assert len(paths) > 60
    for gone in ("raiko_tpu_torch/seams.py", "raiko_tpu_torch/host/reference.py"):
        assert gone not in paths


_SCRIPT = r"""
import hashlib, importlib, json, pkgutil, socket, sys, time, urllib.request

for name in ("jax", "jaxlib", "raiko_tpu"):
    sys.modules[name] = None  # import raises ModuleNotFoundError
sys.path.insert(0, REPO)

import numpy as np
import raiko_tpu_torch
for m in pkgutil.walk_packages(raiko_tpu_torch.__path__, "raiko_tpu_torch."):
    importlib.import_module(m.name)

from raiko_tpu_torch.chain import SupportedChainSpecs
from raiko_tpu_torch.core.interfaces import ProofRequest, ProofType
from raiko_tpu_torch.core.orchestrator import Raiko
from raiko_tpu_torch.core.provider import register_sim
from raiko_tpu_torch.host.cli import BackgroundServer
from raiko_tpu_torch.proto.types import Transaction
from raiko_tpu_torch.stark.commit_step import commit_step
from raiko_tpu_torch.testing.chainsim import ChainSim, TaikoSim
from raiko_tpu_torch.utils import secp256k1

key = 0xC0FFEE
l1 = ChainSim("ethereum", device=None)
l1.produce_block([])
l2 = TaikoSim(l1, "taiko_a7", device=None)
l2.fund(secp256k1.pubkey_to_address(secp256k1.pubkey(key)), 10**20)
txs = []
for i in range(16):
    tx = Transaction(tx_type=2, chain_id=167009, nonce=i, max_priority_fee_per_gas=1,
                     max_fee_per_gas=100, gas_limit=21000, to=b"\x77" * 20, value=i + 1)
    txs.append(tx.sign(key))
l2.produce_taiko_block(txs, use_blob=True)
register_sim("ethereum", l1)
register_sim("taiko_a7", l2)

def post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"content-type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())

with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
body = {"block_number": 1, "network": "taiko_a7", "proof_type": "native"}
argv = ["--device", "cpu", "--address", "127.0.0.1", "--port", str(port), "--log-level", "warning"]
from raiko_tpu_torch.utils import native
native.CALLS.reset()
with BackgroundServer(argv):
    r = post(f"http://127.0.0.1:{port}/v2/proof", body)
    while r["status"] == "ok" and r["data"]["status"] in ("registered", "work_in_progress"):
        time.sleep(0.25)
        r = post(f"http://127.0.0.1:{port}/v2/proof", body)
keccak_calls_served = sum(native.CALLS.snapshot().values())
req = ProofRequest(block_number=1, network="taiko_a7", proof_type=ProofType.NATIVE)
raiko = Raiko(SupportedChainSpecs(), req, None)
gi = raiko.generate_input()
out = raiko.get_output(gi)
host = raiko.prove(gi, out)
served = r["data"].get("proof") or {}
trace = np.random.default_rng(0).integers(0, 2013265921, (256, 48), np.uint32)
root = commit_step(trace, "cpu").numpy().astype(np.uint32).tolist()
from raiko_tpu_torch.stark import prover as stark_prover, serde as stark_serde, verifier as stark_verifier
from raiko_tpu_torch.stark.airs.fib import FibAir
fib_trace, fib_publics = FibAir.trace(6)
fib_proof = stark_prover.prove(FibAir(), fib_trace, fib_publics, device="cpu")
fib_json = json.dumps(stark_serde.proof_to_dict(fib_proof), sort_keys=True)
fib_verified = stark_verifier.verify(FibAir(), fib_proof, device="cpu")
from raiko_tpu_torch.stark import recursion
stark_prover.NUM_QUERIES = stark_verifier.NUM_QUERIES = 4
rec_trace, rec_publics = FibAir.trace(4)
rec_inner = stark_prover.prove(FibAir(), rec_trace, rec_publics, device="cpu")
rec_table = recursion.InnerTable(FibAir(), 4, rec_publics)
rec_outer = recursion.prove_recursion([[rec_table]], [[rec_inner]], "cpu")
rec_json = json.dumps([stark_serde.proof_to_dict(p) for p in rec_outer], sort_keys=True)
print(json.dumps({
    "status": r["data"]["status"],
    "keccak_implementation": native.implementation(),
    "keccak_calls_served": keccak_calls_served,
    "input_equal": served.get("input") == host.input_hash == "0x" + out.hash.hex(),
    "kzg_equal": host.kzg_proof is not None and served.get("kzg_proof") == host.kzg_proof,
    "txs": len(gi.transactions),
    "root": root,
    "fib_verified": fib_verified,
    "fib_sha256": hashlib.sha256(fib_json.encode()).hexdigest(),
    "recursion_verified": recursion.verify_recursion([[rec_table]], rec_outer, "cpu"),
    "recursion_sha256": hashlib.sha256(rec_json.encode()).hexdigest(),
    "refused_loaded": sorted(m for m, mod in sys.modules.items()
                             if m.split(".")[0] in ("jax", "jaxlib", "raiko_tpu") and mod is not None),
}))
"""


def test_port_serves_and_commits_with_reference_refused():
    env = {k: v for k, v in os.environ.items() if not k.startswith("RAIKO_")}
    env["OMP_NUM_THREADS"] = "1"  # the suite's parallel workers share the cores
    r = subprocess.run(
        [sys.executable, "-c", f"REPO = {REPO!r}\n" + _SCRIPT],
        capture_output=True, text=True, timeout=900, env=env, cwd=REPO,
    )
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["status"] == "success"
    impl = res["keccak_implementation"]
    assert impl.startswith("c (")
    assert os.path.realpath(impl[3:-1]).startswith(os.path.realpath(os.path.join(PORT, "_build", "host")) + os.sep)
    assert res["keccak_calls_served"] > 0
    assert res["input_equal"] is True
    assert res["kzg_equal"] is True
    assert res["txs"] >= 16
    assert res["root"] == [1103079180, 844803899, 311541641, 1509639592,
                           1993886486, 1956685620, 1597694602, 1842386190]
    assert res["fib_verified"] is True
    with open(os.path.join(REPO, "tests", "golden", "stark_fib.json")) as f:
        golden = json.load(f)  # the JAX package's proof (tools/make_stark_goldens.py)
    assert res["fib_sha256"] == golden["sha256"]
    with open(os.path.join(REPO, "tests", "golden", "stark_recursion_fib.json")) as f:
        golden = json.load(f)
    assert res["recursion_verified"] is True
    assert res["recursion_sha256"] == golden["sha256"]
    assert res["refused_loaded"] == []
