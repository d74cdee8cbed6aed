"""The port runs without JAX.

The card's machine may have no JAX, so nothing on the port's path may
import it, directly or through the reference modules it reuses (as
``raiko_tpu.evm.execute._batch_recover_senders`` does through
``raiko_tpu.ops.secp``).  A subprocess refuses every ``jax``/``jaxlib``
import, serves one v2 ``native`` request for a 16-tx taiko_a7 blob block
through the port's server on the CPU, and proves the same block again
with the reference orchestrator on its host path: the served instance hash
and KZG proof must equal the host path's.  A scan of the port's sources
finds no JAX import.
"""

import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import importlib.abc, json, socket, sys, time, urllib.request

class _NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError(f"{name}: JAX is blocked in this process")
        return None

sys.meta_path.insert(0, _NoJax())
sys.path[:0] = [REPO, REPO + "/tests"]

from chainsim import ChainSim, TaikoSim
from raiko_tpu_torch import seams
from raiko_tpu_torch.host import reference as ref
from raiko_tpu_torch.host.cli import BackgroundServer

key = 0xC0FFEE
l1 = ChainSim("ethereum")
l1.produce_block([])
l2 = TaikoSim(l1, "taiko_a7")
l2.fund(ref.secp256k1.pubkey_to_address(ref.secp256k1.pubkey(key)), 10**20)
txs = []
for i in range(16):
    tx = ref.Transaction(tx_type=2, chain_id=167009, nonce=i, max_priority_fee_per_gas=1,
                         max_fee_per_gas=100, gas_limit=21000, to=b"\x77" * 20, value=i + 1)
    txs.append(tx.sign(key))
with seams.host_path():  # block production re-executes the txs
    l2.produce_taiko_block(txs, use_blob=True)
ref.register_sim("ethereum", l1)
ref.register_sim("taiko_a7", l2)

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
req = ref.ProofRequest(block_number=1, network="taiko_a7", proof_type=ref.ProofType.NATIVE)
raiko = ref.Raiko(ref.SupportedChainSpecs(), req)
with seams.host_path():
    gi = raiko.generate_input()
    out = raiko.get_output(gi)
    host = raiko.prove(gi, out)
served = r["data"].get("proof") or {}
print(json.dumps({
    "status": r["data"]["status"],
    "input_equal": served.get("input") == host.input_hash == "0x" + out.hash.hex(),
    "kzg_equal": host.kzg_proof is not None and served.get("kzg_proof") == host.kzg_proof,
    "txs": len(gi.transactions),
    "jax_loaded": any(m.split(".")[0] in ("jax", "jaxlib") for m in sys.modules),
}))
"""


def test_port_slice_runs_with_jax_blocked():
    env = {k: v for k, v in os.environ.items() if not k.startswith("RAIKO_")}
    env["OMP_NUM_THREADS"] = "1"  # the suite's parallel workers share the cores
    r = subprocess.run(
        [sys.executable, "-c", f"REPO = {REPO!r}\n" + _SCRIPT],
        capture_output=True, text=True, timeout=600, env=env, cwd=REPO,
    )
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["status"] == "success"
    assert res["input_equal"] is True
    assert res["kzg_equal"] is True
    assert res["txs"] >= 16
    assert res["jax_loaded"] is False


def test_port_sources_import_no_jax():
    pattern = re.compile(r"^\s*(import\s+jax|from\s+jax|import\s+jaxlib|from\s+jaxlib)\b", re.M)
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "raiko_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    offenders = []
    for path in paths:
        with open(path) as f:
            if pattern.search(f.read()):
                offenders.append(os.path.relpath(path, REPO))
    assert len(paths) > 10 and offenders == []
