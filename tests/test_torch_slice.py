"""The port's served block-proof path on the CPU, against the JAX package.

A simulated taiko_a7 blob block of 16 user txs is proven ``native`` twice:
by the reference ``raiko_tpu`` orchestrator on its host path, and by the
port's ``Raiko`` with the seams bound to the CPU, where every MSM runs the
port's Pippenger with the kernels' plain versions.  The instance hash and
the KZG blob proof must be equal.  One v2 request then goes through the
port's server, as tests/test_host.py drives the reference's.
"""

import json
import socket
import time
import urllib.request

import pytest
import torch

from chainsim import ChainSim, TaikoSim
from raiko_tpu.chain import SupportedChainSpecs
from raiko_tpu.core.interfaces import ProofRequest, ProofType
from raiko_tpu.core.orchestrator import Raiko as RefRaiko
from raiko_tpu.core.provider import _SIM_REGISTRY, register_sim
from raiko_tpu.evm import execute as ref_execute
from raiko_tpu.kzg import eip4844 as ref_eip4844
from raiko_tpu.proto.types import Transaction
from raiko_tpu.utils import secp256k1
from raiko_tpu_torch import device as device_mod
from raiko_tpu_torch import seams
from raiko_tpu_torch.core.orchestrator import Raiko
from raiko_tpu_torch.host import cli


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
SEAMS = [
    (ref_eip4844, "tpu_default"),
    (ref_eip4844, "_msm"),
    (ref_eip4844, "blob_to_kzg_commitment"),
    (ref_eip4844, "blobs_to_kzg_commitments"),
    (ref_execute, "_batch_recover_senders"),
]


def _mktx(key_i, nonce, value):
    tx = Transaction(tx_type=2, chain_id=167009, nonce=nonce, max_priority_fee_per_gas=1,
                     max_fee_per_gas=100, gas_limit=21000, to=bytes([0x88, value]) * 10, value=value)
    return tx.sign(KEYS[key_i])


@pytest.fixture(scope="module")
def chain():
    _SIM_REGISTRY.clear()
    l1 = ChainSim("ethereum")
    l1.produce_block([])
    l2 = TaikoSim(l1, "taiko_a7")
    for s in SENDERS:
        l2.fund(s, 10**20)
    l2.produce_taiko_block([_mktx(i % 4, i // 4, i + 1) for i in range(16)], use_blob=True)
    l2.produce_taiko_block([_mktx(0, 4, 99)], use_blob=False)
    register_sim("ethereum", l1)
    register_sim("taiko_a7", l2)
    yield l1, l2
    _SIM_REGISTRY.clear()


def _prove(raiko):
    gi = raiko.generate_input()
    output = raiko.get_output(gi)
    return gi, output, raiko.prove(gi, output)


def test_port_raiko_matches_reference_on_blob_block(chain):
    req = ProofRequest(block_number=1, network="taiko_a7", proof_type=ProofType.NATIVE)
    originals = [getattr(m, n) for m, n in SEAMS]
    ref_gi, ref_out, ref_proof = _prove(RefRaiko(SupportedChainSpecs(), req))
    gi, out, proof = _prove(Raiko(SupportedChainSpecs(), req, "cpu"))
    assert len(gi.transactions) >= 16
    assert gi.taiko.blob_commitment == ref_gi.taiko.blob_commitment
    assert out.hash == ref_out.hash
    assert proof.input_hash == ref_proof.input_hash == "0x" + out.hash.hex()
    assert proof.kzg_proof is not None and proof.kzg_proof == ref_proof.kzg_proof
    assert [getattr(m, n) for m, n in SEAMS] == originals


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"content-type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_v2_request_through_port_server(chain):
    port = _free_port()
    argv = ["--device", "cpu", "--address", "127.0.0.1", "--port", str(port), "--log-level", "warning"]
    body = {"block_number": 2, "network": "taiko_a7", "proof_type": "native"}
    originals = [getattr(m, n) for m, n in SEAMS]
    with cli.BackgroundServer(argv) as srv:
        assert srv.device == "cpu"
        assert all(getattr(m, n) is not o for (m, n), o in zip(SEAMS, originals))
        base = f"http://127.0.0.1:{port}"
        r = _post(f"{base}/v2/proof", body)
        assert r["status"] == "ok"
        for _ in range(240):
            if r["data"]["status"] == "success":
                break
            assert r["data"]["status"] in ("registered", "work_in_progress")
            time.sleep(0.25)
            r = _post(f"{base}/v2/proof", body)
        assert r["data"]["status"] == "success"
        proof = r["data"]["proof"]
        assert proof["input"].startswith("0x") and proof["kzg_proof"] is None
        assert _post(f"{base}/v2/proof", body)["data"]["proof"] == proof
    assert [getattr(m, n) for m, n in SEAMS] == originals


def test_seams_bind_and_restore():
    originals = [getattr(m, n) for m, n in SEAMS]
    with seams.bound("cpu") as dev:
        assert dev == torch.device("cpu")
        bound = [getattr(m, n) for m, n in SEAMS]
        assert all(b is not o for b, o in zip(bound, originals))
        assert ref_eip4844.tpu_default() is True
        with pytest.raises(RuntimeError):
            with seams.bound("cpu"):
                pass
    assert [getattr(m, n) for m, n in SEAMS] == originals
    with pytest.raises(ZeroDivisionError):
        with seams.bound("cpu"):
            raise ZeroDivisionError
    assert [getattr(m, n) for m, n in SEAMS] == originals
    with seams.host_path():
        assert ref_eip4844.tpu_default() is False
        assert ref_execute._batch_recover_senders([_mktx(0, 0, 1)] * 16) is None
        with pytest.raises(RuntimeError):
            with seams.bound("cpu"):
                pass
    assert [getattr(m, n) for m, n in SEAMS] == originals


def test_device_choice_is_explicit():
    assert device_mod.get("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        device_mod.get("meta")
    if torch.cuda.is_available():
        assert device_mod.get("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            device_mod.get("cuda")
    assert cli.parse_args([])[0] == "cuda"
    assert cli.parse_args(["--device", "cpu", "--port", "9"]) == ("cpu", ["--port", "9"])
