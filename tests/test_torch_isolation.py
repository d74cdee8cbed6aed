"""The port stands alone: it imports nothing of ``raiko_tpu`` and no JAX.

Every module of ``raiko_tpu_torch`` and ``chip_smoke.py`` is read as a
syntax tree: no import of ``raiko_tpu`` (absolute, or relative out of the
package) and none of ``jax``.  A subprocess that refuses both imports every
port module, serves one v2 ``native`` request for a 16-tx taiko_a7 blob
block through the port's server on the CPU, proves the same block again
on the port's host path (``device=None``: host MSM, per-tx recovery), which
shares no code with the kernels, and runs the flagship commitment step;
its root must equal the JAX step's.
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


def test_port_tree_is_whole():
    paths = _port_sources()
    assert len(paths) > 60
    for gone in ("raiko_tpu_torch/seams.py", "raiko_tpu_torch/host/reference.py"):
        assert gone not in paths


_SCRIPT = r"""
import importlib, json, pkgutil, socket, sys, time, urllib.request

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
with BackgroundServer(argv):
    r = post(f"http://127.0.0.1:{port}/v2/proof", body)
    while r["status"] == "ok" and r["data"]["status"] in ("registered", "work_in_progress"):
        time.sleep(0.25)
        r = post(f"http://127.0.0.1:{port}/v2/proof", body)
req = ProofRequest(block_number=1, network="taiko_a7", proof_type=ProofType.NATIVE)
raiko = Raiko(SupportedChainSpecs(), req, None)
gi = raiko.generate_input()
out = raiko.get_output(gi)
host = raiko.prove(gi, out)
served = r["data"].get("proof") or {}
trace = np.random.default_rng(0).integers(0, 2013265921, (256, 48), np.uint32)
root = commit_step(trace, "cpu").numpy().astype(np.uint32).tolist()
print(json.dumps({
    "status": r["data"]["status"],
    "input_equal": served.get("input") == host.input_hash == "0x" + out.hash.hex(),
    "kzg_equal": host.kzg_proof is not None and served.get("kzg_proof") == host.kzg_proof,
    "txs": len(gi.transactions),
    "root": root,
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
    assert res["input_equal"] is True
    assert res["kzg_equal"] is True
    assert res["txs"] >= 16
    assert res["root"] == [1103079180, 844803899, 311541641, 1509639592,
                           1993886486, 1956685620, 1597694602, 1842386190]
    assert res["refused_loaded"] == []
