"""The port's served block-proof path on the CPU, against the JAX package.

The same simulated taiko_a7 chain is built twice from the same keys and
txs: once by the reference's simulator (tests/chainsim.py) for the
reference ``raiko_tpu`` orchestrator, once by the port's own copy
(raiko_tpu_torch.testing.chainsim) for the port.  A blob block of 16 user
txs is proven ``native`` by the reference on its host path and by the
port's ``Raiko`` on the CPU device, where every MSM runs the port's
Pippenger with the kernels' plain versions: the instance hash and the KZG
blob proof must be equal.  The same block then goes through the port's
server as a v2 request, as tests/test_host.py drives the reference's.
"""

import importlib
import inspect
import json
import socket
import time
import urllib.request

import pytest
import torch

import chainsim as ref_chainsim
from raiko_tpu.chain import SupportedChainSpecs as RefSpecs
from raiko_tpu.core.interfaces import ProofRequest as RefRequest
from raiko_tpu.core.interfaces import ProofType as RefProofType
from raiko_tpu.core.orchestrator import Raiko as RefRaiko
from raiko_tpu.core import provider as ref_provider
from raiko_tpu.proto.types import Transaction as RefTransaction
from raiko_tpu_torch import device as device_mod
from raiko_tpu_torch.chain import SupportedChainSpecs
from raiko_tpu_torch.core import provider
from raiko_tpu_torch.core.interfaces import GuestError, ProofRequest, ProofType
from raiko_tpu_torch.core.orchestrator import Raiko
from raiko_tpu_torch.host import cli
from raiko_tpu_torch.proto.types import Transaction
from raiko_tpu_torch.testing import chainsim
from raiko_tpu_torch.utils import secp256k1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs files in parallel workers: torch's own thread pool per
    # worker would oversubscribe the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KEYS = [0xCAFE + i for i in range(4)]
SENDERS = [secp256k1.pubkey_to_address(secp256k1.pubkey(k)) for k in KEYS]


def _mktx(tx_cls, key_i, nonce, value):
    tx = tx_cls(tx_type=2, chain_id=167009, nonce=nonce, max_priority_fee_per_gas=1,
                max_fee_per_gas=100, gas_limit=21000, to=bytes([0x88, value]) * 10, value=value)
    return tx.sign(KEYS[key_i])


def _build(sims, tx_cls, **device):
    """Block 1: 16 transfers as a blob; block 2: one transfer in calldata.
    `device` is the port simulator's (the reference's takes none)."""
    l1 = sims.ChainSim("ethereum", **device)
    l1.produce_block([])
    l2 = sims.TaikoSim(l1, "taiko_a7", **device)
    for s in SENDERS:
        l2.fund(s, 10**20)
    l2.produce_taiko_block([_mktx(tx_cls, i % 4, i // 4, i + 1) for i in range(16)], use_blob=True)
    l2.produce_taiko_block([_mktx(tx_cls, 0, 4, 99)], use_blob=False)
    return l1, l2


@pytest.fixture(scope="module")
def chain():
    ref_provider._SIM_REGISTRY.clear()
    provider._SIM_REGISTRY.clear()
    for name, sim in zip(("ethereum", "taiko_a7"), _build(ref_chainsim, RefTransaction)):
        ref_provider.register_sim(name, sim)
    for name, sim in zip(("ethereum", "taiko_a7"), _build(chainsim, Transaction, device=None)):
        provider.register_sim(name, sim)
    yield
    ref_provider._SIM_REGISTRY.clear()
    provider._SIM_REGISTRY.clear()


def _prove(raiko):
    gi = raiko.generate_input()
    output = raiko.get_output(gi)
    return gi, output, raiko.prove(gi, output)


@pytest.fixture(scope="module")
def reference_proof(chain):
    """Block 1 proven by the reference orchestrator on its host path."""
    req = RefRequest(block_number=1, network="taiko_a7", proof_type=RefProofType.NATIVE)
    return _prove(RefRaiko(RefSpecs(), req))


def test_port_raiko_matches_reference_on_blob_block(chain, reference_proof):
    ref_gi, ref_out, ref_proof = reference_proof
    req = ProofRequest(block_number=1, network="taiko_a7", proof_type=ProofType.NATIVE)
    gi, out, proof = _prove(Raiko(SupportedChainSpecs(), req, "cpu"))
    assert len(gi.transactions) >= 16
    assert gi.taiko.blob_commitment == ref_gi.taiko.blob_commitment
    assert out.hash == ref_out.hash
    assert proof.input_hash == ref_proof.input_hash == "0x" + out.hash.hex()
    assert proof.kzg_proof is not None and proof.kzg_proof == ref_proof.kzg_proof


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"content-type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serve(base, body):
    r = _post(f"{base}/v2/proof", body)
    assert r["status"] == "ok"
    for _ in range(480):
        if r["data"]["status"] == "success":
            break
        assert r["data"]["status"] in ("registered", "work_in_progress"), r
        time.sleep(0.25)
        r = _post(f"{base}/v2/proof", body)
    assert r["data"]["status"] == "success", r
    return r["data"]["proof"]


def test_v2_request_through_port_server(chain, reference_proof):
    port = _free_port()
    argv = ["--device", "cpu", "--address", "127.0.0.1", "--port", str(port), "--log-level", "warning"]
    with cli.BackgroundServer(argv) as srv:
        assert srv.device == torch.device("cpu")
        base = f"http://127.0.0.1:{port}"
        blob = _serve(base, {"block_number": 1, "network": "taiko_a7", "proof_type": "native"})
        assert blob["input"] == reference_proof[2].input_hash
        assert blob["kzg_proof"] == reference_proof[2].kzg_proof
        body = {"block_number": 2, "network": "taiko_a7", "proof_type": "native"}
        proof = _serve(base, body)
        assert proof["input"].startswith("0x") and proof["kzg_proof"] is None
        assert _post(f"{base}/v2/proof", body)["data"]["proof"] == proof


def test_only_native_is_registered(chain):
    # the other backends are later slices of the port: refused as the
    # reference refuses an unregistered proof type
    req = ProofRequest(block_number=2, network="taiko_a7", proof_type=ProofType.TPU_STARK)
    raiko = Raiko(SupportedChainSpecs(), req, None)
    gi = raiko.generate_input()
    with pytest.raises(GuestError):
        raiko.prove(gi, raiko.get_output(gi))


def test_device_choice_is_explicit():
    assert device_mod.get("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        device_mod.get("meta")
    if torch.cuda.is_available():
        assert device_mod.get("cuda").type == "cuda"
        assert cli.parse_opts(["--log-level", "warning"]).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            device_mod.get("cuda")
        with pytest.raises(RuntimeError):
            cli.parse_opts(["--log-level", "warning"])  # --device defaults to cuda
    cfg = cli.parse_opts(["--device", "cpu", "--port", "9", "--log-level", "warning"])
    assert (cfg.device, cfg.port) == (torch.device("cpu"), 9)
    assert Raiko(SupportedChainSpecs(), None, None).device is None


@pytest.mark.parametrize("entry", [
    "core.orchestrator.Raiko", "core.preflight.preflight", "kzg.eip4844.blob_to_kzg_commitment",
    "kzg.eip4844.blobs_to_kzg_commitments", "kzg.eip4844.compute_kzg_proof",
    "kzg.eip4844.calc_kzg_proof", "host.actor.HostConfig", "testing.chainsim.ChainSim",
])
def test_entry_point_device_has_no_default(entry):
    # a caller that leaves the device out must not land on the host path
    module, name = entry.rsplit(".", 1)
    fn = getattr(importlib.import_module(f"raiko_tpu_torch.{module}"), name)
    param = inspect.signature(fn).parameters["device"]
    assert param.default is inspect.Parameter.empty
