"""The port's last backends and test AIRs on the CPU, against the JAX package.

- ``tee`` (provers/tee.py): the same simulated taiko_a7 calldata block is
  built by the reference's simulator (tests/chainsim.py) and the port's
  own; the port's TEE proof, signed with the same sealed key, equals the
  reference's byte for byte (RFC 6979 signatures are deterministic) and
  recovers to the instance address; the instance registers through the
  port's ``install_sgx_verifier``, and a forged quote is refused
  (tests/test_core.py, tests/test_onchain.py).
- ``onchain``: the calldata of ``registerInstance`` and ``verifyProof``
  equals the reference's; a transcript payload passes the port's
  ``install_proof_verifier`` and a tampered one fails.
- ``remote`` (provers/remote.py): one port server forwards a request to
  another over v2; a stalled remote is cancelled mid-poll and its session
  id cleared; a remote proof bound to another instance is refused
  (tests/test_remote.py).
- ``harness``: the guest subprocess (``python -m
  raiko_tpu_torch.harness.guest``) re-executes the block to the port's
  instance hash, and the in-guest suite passes (tests/test_core.py).
- ``lookup`` and ``bus`` (stark/airs/): the LogUp aux segment's test AIRs;
  their proofs equal the JAX package's live proofs byte for byte as
  canonical JSON, and every tampered case of tests/test_aux_segment.py is
  rejected.
"""

import copy
import http.server
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import chainsim as ref_chainsim
from raiko_tpu.chain import SupportedChainSpecs as RefSpecs
from raiko_tpu.core import provider as ref_provider
from raiko_tpu.core.interfaces import ProofRequest as RefRequest
from raiko_tpu.core.interfaces import ProofType as RefProofType
from raiko_tpu.core.orchestrator import Raiko as RefRaiko
from raiko_tpu.proto.types import Transaction as RefTransaction
from raiko_tpu.provers import base as ref_base
from raiko_tpu.provers import onchain as ref_onchain
from raiko_tpu.provers.tee import TeeProver as RefTeeProver
from raiko_tpu.stark import prover as jprover
from raiko_tpu.stark import serde as jserde
from raiko_tpu.stark.airs.bus import BusTableAir as JBusTableAir
from raiko_tpu.stark.airs.lookup import LookupAir as JLookupAir
from raiko_tpu_torch.chain import SupportedChainSpecs
from raiko_tpu_torch.core import provider
from raiko_tpu_torch.core.interfaces import GuestError, ProofRequest, ProofType
from raiko_tpu_torch.core.orchestrator import Raiko
from raiko_tpu_torch.core.provider import SimBlockDataProvider
from raiko_tpu_torch.fields import babybear as bb
from raiko_tpu_torch.harness import run_guest
from raiko_tpu_torch.host import cli
from raiko_tpu_torch.proto.types import Transaction
from raiko_tpu_torch.provers import ProverCtx, base, onchain
from raiko_tpu_torch.provers.remote import RemoteCancelled
from raiko_tpu_torch.provers.tee import TeeProver
from raiko_tpu_torch.provers.tpu_stark import prove_transcript
from raiko_tpu_torch.stark import prover, serde, verifier
from raiko_tpu_torch.stark.airs.bus import BusTableAir
from raiko_tpu_torch.stark.airs.lookup import LookupAir
from raiko_tpu_torch.tasks import TaskDescriptor, get_task_manager
from raiko_tpu_torch.testing import chainsim
from raiko_tpu_torch.testing.chainsim import install_proof_verifier, install_sgx_verifier
from raiko_tpu_torch.utils import secp256k1

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = [0xB0B + i for i in range(2)]
SENDERS = [secp256k1.pubkey_to_address(secp256k1.pubkey(k)) for k in KEYS]
SGX_VERIFIER = b"\x51" * 20
PROOF_VERIFIER = b"\x52" * 20


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs files in parallel workers: torch's own thread pool per
    # worker would oversubscribe the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mktx(tx_cls, key_i, nonce, chain_id):
    tx = tx_cls(tx_type=2, chain_id=chain_id, nonce=nonce, max_priority_fee_per_gas=1,
                max_fee_per_gas=100, gas_limit=21000, to=b"\x88" * 20, value=1 + nonce)
    return tx.sign(KEYS[key_i])


def _build(sims, tx_cls, **device):
    """L1: one transfer; L2 block 1: two transfers in calldata.  `device`
    is the port simulator's (the reference's takes none)."""
    l1 = sims.ChainSim("ethereum", **device)
    l1.fund(SENDERS[0], 10**20)
    l1.produce_block([_mktx(tx_cls, 0, 0, 1)])
    l2 = sims.TaikoSim(l1, "taiko_a7", **device)
    for s in SENDERS:
        l2.fund(s, 10**20)
    l2.produce_taiko_block([_mktx(tx_cls, 0, 0, 167009), _mktx(tx_cls, 1, 0, 167009)], use_blob=False)
    return l1, l2


@pytest.fixture(scope="module")
def chains():
    ref_provider._SIM_REGISTRY.clear()
    provider._SIM_REGISTRY.clear()
    for name, sim in zip(("ethereum", "taiko_a7"), _build(ref_chainsim, RefTransaction)):
        ref_provider.register_sim(name, sim)
    for name, sim in zip(("ethereum", "taiko_a7"), _build(chainsim, Transaction, device=None)):
        provider.register_sim(name, sim)
    yield
    ref_provider._SIM_REGISTRY.clear()
    provider._SIM_REGISTRY.clear()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"content-type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def _prove(raiko, ctx=None):
    gi = raiko.generate_input()
    output = raiko.get_output(gi)
    return gi, output, raiko.prove(gi, output, ctx=ctx)


def test_registry_has_every_backend():
    for proof_type in ProofType:
        assert base.get_prover(proof_type).proof_type == proof_type


# --- tee and the on-chain services


@pytest.fixture
def tee_provers(tmp_path, monkeypatch):
    """The port's and the reference's TEE provers on one sealed key."""
    port_tee = TeeProver(key_dir=str(tmp_path))
    info = port_tee.bootstrap()
    ref_tee = RefTeeProver(key_dir=str(tmp_path))
    base.get_prover(ProofType.TEE)
    monkeypatch.setitem(base._REGISTRY, ProofType.TEE, port_tee)
    monkeypatch.setitem(ref_base._REGISTRY, RefProofType.TEE, ref_tee)
    return port_tee, info


def test_tee_proof_equals_reference(chains, tee_provers):
    _, info = tee_provers
    req = ProofRequest(block_number=1, network="taiko_a7", proof_type=ProofType.TEE)
    gi, output, proof = _prove(Raiko(SupportedChainSpecs(), req, None))
    ref_req = RefRequest(block_number=1, network="taiko_a7", proof_type=RefProofType.TEE)
    _, ref_output, ref_proof = _prove(RefRaiko(RefSpecs(), ref_req))
    assert output.hash == ref_output.hash
    assert (proof.proof, proof.input_hash, proof.quote) == (ref_proof.proof, ref_proof.input_hash, ref_proof.quote)
    raw = bytes.fromhex(proof.proof[2:])
    assert len(raw) == 4 + 20 + 65
    new_instance = raw[4:24]
    assert "0x" + new_instance.hex() == info["new_instance"]
    ih = bytes.fromhex(proof.input_hash[2:])
    r, s, v = int.from_bytes(raw[24:56], "big"), int.from_bytes(raw[56:88], "big"), raw[88]
    assert secp256k1.ecrecover(ih, v, r, s) == new_instance


def test_tee_bootstrap_request_and_missing_key(chains, tmp_path, monkeypatch):
    fresh = TeeProver(key_dir=str(tmp_path / "none"))
    base.get_prover(ProofType.TEE)
    monkeypatch.setitem(base._REGISTRY, ProofType.TEE, fresh)
    req = ProofRequest(block_number=1, network="taiko_a7", proof_type=ProofType.TEE)
    with pytest.raises(GuestError, match="not bootstrapped"):
        _prove(Raiko(SupportedChainSpecs(), req, None))
    req = ProofRequest(block_number=1, network="taiko_a7", proof_type=ProofType.TEE,
                       prover_args={"tee": {"bootstrap": True}})
    _, _, proof = _prove(Raiko(SupportedChainSpecs(), req, None))
    assert proof.meta["new_instance"].startswith("0x") and proof.quote == proof.meta["quote"]


def test_sgx_instance_registration(tmp_path):
    sim = chainsim.ChainSim("ethereum", device=None)
    registry = install_sgx_verifier(sim, SGX_VERIFIER)
    sim_provider = SimBlockDataProvider(sim)
    prover_a = TeeProver(key_dir=str(tmp_path / "a"))
    info = prover_a.bootstrap()
    assert prover_a.register_instance(sim_provider, SGX_VERIFIER) == 1
    assert "0x" + registry["instances"][1].hex() == info["new_instance"]
    prover_b = TeeProver(key_dir=str(tmp_path / "b"))
    prover_b.bootstrap()
    assert prover_b.register_instance(sim_provider, SGX_VERIFIER) == 2
    # a forged quote (another bound address) is refused by the contract
    bad = bytearray(bytes.fromhex(info["quote"]))
    bad[20] ^= 1
    with pytest.raises(Exception):
        onchain.register_sgx_instance(sim_provider, SGX_VERIFIER, bytes(bad), registry["instances"][1])


def test_onchain_calldata_equals_reference():
    quote, instance = b"RAIKO-TPU-MOCK-QUOTE" + b"\x07" * 52, b"\x07" * 20
    assert onchain.encode_register_instance(quote, instance) == ref_onchain.encode_register_instance(quote, instance)
    assert onchain.decode_register_instance(onchain.encode_register_instance(quote, instance)) == (quote, instance)
    journal, seal = bytes(range(32)), b"\x01\x02" * 40
    assert onchain.encode_verify_proof(journal, seal) == ref_onchain.encode_verify_proof(journal, seal)
    assert onchain.decode_verify_proof(onchain.encode_verify_proof(journal, seal)) == (journal, seal)
    payload = {"kind": "x", "n": [1, 2]}
    assert onchain.seal_from_payload(payload) == ref_onchain.seal_from_payload(payload)


def test_verify_proof_onchain_roundtrip():
    """tests/test_onchain.py's round trip: a transcript payload as the
    seal verifies through eth_call; a wrong journal, a tampered payload and
    a codeless address do not."""
    sim = chainsim.ChainSim("ethereum", device=None)
    install_proof_verifier(sim, PROOF_VERIFIER, "cpu")
    sim_provider = SimBlockDataProvider(sim)
    ih = bytes(range(32))
    payload = prove_transcript(ih, "cpu")
    seal = onchain.seal_from_payload(payload)
    assert onchain.verify_proof_onchain(sim_provider, PROOF_VERIFIER, ih, seal)
    assert not onchain.verify_proof_onchain(sim_provider, PROOF_VERIFIER, bytes(31) + b"\x01", seal)
    bad_seal = onchain.seal_from_payload(dict(payload, digest=[0] * 8))
    assert not onchain.verify_proof_onchain(sim_provider, PROOF_VERIFIER, ih, bad_seal)
    assert not onchain.verify_proof_onchain(sim_provider, b"\x99" * 20, ih, seal)


# --- remote: one port server forwards to another


@pytest.fixture(scope="module")
def worker(chains):
    port = _free_port()
    argv = ["--device", "cpu", "--address", "127.0.0.1", "--port", str(port), "--log-level", "warning"]
    with cli.BackgroundServer(argv):
        yield f"http://127.0.0.1:{port}"


def test_remote_prove_e2e(worker):
    gport = _free_port()
    argv = ["--device", "cpu", "--address", "127.0.0.1", "--port", str(gport), "--log-level", "warning"]
    body = {"block_number": 1, "network": "taiko_a7", "proof_type": "remote", "endpoint": worker,
            "remote_proof_type": "native", "poll_interval": 0.1}
    with cli.BackgroundServer(argv):
        base_url = f"http://127.0.0.1:{gport}"
        deadline = time.time() + 120
        r = _post(f"{base_url}/v2/proof", body)
        while r["status"] == "ok" and "proof" not in (r["data"] or {}) and time.time() < deadline:
            time.sleep(0.2)
            r = _post(f"{base_url}/v2/proof", body)
    assert r["status"] == "ok" and "proof" in r["data"], r
    proof = r["data"]["proof"]
    req = ProofRequest(block_number=1, network="taiko_a7", proof_type=ProofType.NATIVE)
    _, output, _ = _prove(Raiko(SupportedChainSpecs(), req, None))
    assert proof["input"] == "0x" + output.hash.hex()
    # the worker proved it (its report holds the inner proof system)
    with urllib.request.urlopen(f"{worker}/v2/proof/report", timeout=10) as resp:
        rep = json.loads(resp.read())
    assert any(entry[0]["proof_system"] == "native" for entry in rep)


class _Remote:
    """A fake remote host: ``reply`` answers /v2/proof, and cancels are
    recorded."""

    def __init__(self, reply: dict):
        self.cancelled = threading.Event()
        outer = self

        class H(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                self.rfile.read(int(self.headers.get("content-length", 0)))
                if self.path.endswith("/cancel"):
                    outer.cancelled.set()
                    payload = {"status": "ok", "data": None}
                else:
                    payload = reply
                blob = json.dumps(payload).encode()
                self.send_response(200)
                self.send_header("content-type", "application/json")
                self.send_header("content-length", str(len(blob)))
                self.end_headers()
                self.wfile.write(blob)

            def log_message(self, *a):
                pass

        self.port = _free_port()
        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", self.port), H)
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.httpd.shutdown()


def test_remote_midflight_cancel(chains):
    with _Remote({"status": "ok", "data": {"status": "work_in_progress"}}) as stall:
        req = ProofRequest(block_number=1, network="taiko_a7", proof_type=ProofType.REMOTE,
                           prover_args={"endpoint": f"http://127.0.0.1:{stall.port}",
                                        "remote_proof_type": "native", "poll_interval": 0.05})
        raiko = Raiko(SupportedChainSpecs(), req, None)
        gi = raiko.generate_input()
        output = raiko.get_output(gi)
        tasks = get_task_manager(None, 1 << 20)
        key = TaskDescriptor(chain_id=167009, blockhash=b"\x11" * 32, proof_system="remote",
                             prover="0x" + "00" * 20)
        ctx = ProverCtx(key=key, id_store=tasks, cancel_ev=threading.Event(), request=req)
        result: dict = {}

        def prove():
            try:
                raiko.prove(gi, output, ctx=ctx)
                result["outcome"] = "completed"
            except RemoteCancelled:
                result["outcome"] = "cancelled"

        t = threading.Thread(target=prove)
        t.start()
        deadline = time.time() + 10
        while time.time() < deadline and not tasks.read_id(key):
            time.sleep(0.02)
        sid = tasks.read_id(key)
        assert sid and json.loads(sid)["endpoint"] == f"http://127.0.0.1:{stall.port}"
        base.get_prover(ProofType.REMOTE).cancel(key, tasks)
        t.join(timeout=30)
        assert not t.is_alive()
        assert result["outcome"] == "cancelled"
        assert stall.cancelled.wait(5)
        assert tasks.read_id(key) is None


def test_remote_output_binding_check(chains):
    reply = {"status": "ok", "data": {"status": "success", "proof": {"proof": "00", "input": "0x" + "ab" * 32}}}
    with _Remote(reply) as remote:
        req = ProofRequest(block_number=1, network="taiko_a7", proof_type=ProofType.REMOTE,
                           prover_args={"endpoint": f"http://127.0.0.1:{remote.port}", "poll_interval": 0.05})
        with pytest.raises(GuestError, match="bound to"):
            _prove(Raiko(SupportedChainSpecs(), req, None))


# --- the guest harness


def test_guest_subprocess_runner(chains):
    req = ProofRequest(block_number=1, network="taiko_a7", proof_type=ProofType.NATIVE)
    gi, output, _ = _prove(Raiko(SupportedChainSpecs(), req, None))
    res = run_guest(gi.to_bytes(), "None")
    assert res.instance_hash == "0x" + output.hash.hex()
    assert res.header_hash == "0x" + output.header.hash().hex()


def test_in_guest_test_suite():
    env = {k: v for k, v in os.environ.items() if not k.startswith("RAIKO_")}
    proc = subprocess.run([sys.executable, "-m", "raiko_tpu_torch.harness.guest", "test"],
                          capture_output=True, timeout=120, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr.decode()
    assert b"3 tests, 0 failures" in proc.stderr


# --- the LogUp aux segment's test AIRs (tests/test_aux_segment.py)


def _canon(proof) -> str:
    return json.dumps(serde.proof_to_dict(proof), sort_keys=True)


def _lookup_case(seed: int):
    rng = np.random.default_rng(seed)
    table = rng.integers(0, bb.P, 64).tolist()
    looked = [table[int(i)] for i in rng.integers(0, 64, 64)]
    return table, looked


def test_logup_lookup_equals_jax():
    table, looked = _lookup_case(13)
    trace = LookupAir.make_trace(looked, table)
    assert np.array_equal(trace, JLookupAir.make_trace(looked, table))
    proof = prover.prove(LookupAir(), trace, [], "cpu")
    assert verifier.verify(LookupAir(), proof, "cpu")
    assert _canon(proof) == json.dumps(jserde.proof_to_dict(jprover.prove(JLookupAir(), trace, [])), sort_keys=True)


@pytest.mark.parametrize("case", ["missing_value", "wrong_multiplicity"])
def test_logup_tampered_rejected(case):
    table, looked = _lookup_case(14 if case == "missing_value" else 15)
    if case == "missing_value":
        looked[5] = (max(table) + 1) % bb.P  # not in the table
    trace = LookupAir.make_trace(looked, table)
    if case == "wrong_multiplicity":
        trace[3, 2] = (int(trace[3, 2]) + 1) % bb.P
    assert not verifier.verify(LookupAir(), prover.prove(LookupAir(), trace, [], "cpu"), "cpu")


def test_multi_table_bus_equals_jax():
    rng = np.random.default_rng(31)
    sent = rng.integers(0, bb.P, 64).tolist()
    send, recv = BusTableAir(1), BusTableAir(-1)
    t_send = BusTableAir.make_trace(sent, [2] * 32 + [0] * 32)
    t_recv = BusTableAir.make_trace(sent[:32], [2] * 32)
    proofs = prover.prove_tables([(send, t_send, []), (recv, t_recv, [])], "cpu")
    assert verifier.verify_tables([send, recv], proofs, "cpu")
    restored = [serde.proof_from_dict(serde.proof_to_dict(p)) for p in proofs]
    assert verifier.verify_tables([send, recv], restored, "cpu")
    jproofs = jprover.prove_tables([(JBusTableAir(1), t_send, []), (JBusTableAir(-1), t_recv, [])])
    assert [_canon(p) for p in proofs] == [json.dumps(jserde.proof_to_dict(p), sort_keys=True) for p in jproofs]
    # equal-size tables whose eval() graphs differ (send vs receive)
    t16 = BusTableAir.make_trace(sent[:16], [1] * 16)
    assert verifier.verify_tables([send, recv], prover.prove_tables([(send, t16, []), (recv, t16, [])], "cpu"),
                                  "cpu")


@pytest.mark.parametrize("case", ["imbalance", "forged_bus_value"])
def test_multi_table_bus_tampered_rejected(case):
    rng = np.random.default_rng(32 if case == "imbalance" else 33)
    sent = rng.integers(0, bb.P, 32).tolist()
    recv_vals = list(sent)
    recv_vals[3] = (recv_vals[3] + 1) % bb.P  # never sent
    send, recv = BusTableAir(1), BusTableAir(-1)
    proofs = prover.prove_tables([(send, BusTableAir.make_trace(sent, [1] * 32), []),
                                  (recv, BusTableAir.make_trace(recv_vals, [1] * 32), [])], "cpu")
    if case == "forged_bus_value":
        # balance the bus by lying about the send table's contribution
        proofs = [copy.deepcopy(p) for p in proofs]
        proofs[0].bus = [tuple((bb.P - v) % bb.P for v in proofs[1].bus[0])]
    assert not verifier.verify_tables([send, recv], proofs, "cpu")
