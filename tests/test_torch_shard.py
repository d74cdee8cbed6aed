"""The port's ``tpu_shard`` backend on the CPU, against the JAX package.

``prove_sharded`` (the Poseidon2 transcript split into continuity-chained
shards) is compared with the JAX package's live, and the recursively
aggregated shards (``prove_sharded_recursive``, ``NUM_QUERIES`` 4, as
tests/test_recursion.py runs it) with the golden that
``tools/make_stark_goldens.py`` wrote with the JAX package, as
``json.dumps(payload, sort_keys=True)``, byte for byte.  Each verifies,
and tampered boundaries, blocks, digests and shard proofs are rejected.
The ``slow`` tests prove the recursive shards at production parameters
and the golden's 10-tx block as a ``tpu_shard`` request (in a subprocess
under the golden's ``PYTHONHASHSEED``) against their goldens; the
``cuda`` tests prove the goldens on a card.
"""

import contextlib
import copy
import hashlib
import json
import os
import subprocess
import sys

import pytest
import torch

from raiko_tpu.provers import tpu_shard as jshard
from raiko_tpu_torch.core.interfaces import ProofType
from raiko_tpu_torch.core.provider import SimBlockDataProvider
from raiko_tpu_torch.fields import babybear as bb
from raiko_tpu_torch.provers import base, onchain
from raiko_tpu_torch.provers import tpu_shard as shard
from raiko_tpu_torch.stark import prover, verifier
from raiko_tpu_torch.testing.chainsim import ChainSim, install_proof_verifier

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
IH = bytes(range(32))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs files in parallel workers: torch's own thread pool per
    # worker would oversubscribe the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    return torch.device("cuda")


def _golden(case: str) -> dict:
    with open(os.path.join(GOLDEN, f"stark_{case}.json")) as f:
        return json.load(f)


def _sha(obj) -> str:
    return hashlib.sha256(json.dumps(obj, sort_keys=True).encode()).hexdigest()


@contextlib.contextmanager
def _num_queries(n: int):
    """NUM_QUERIES = n in the port's prover and verifier (the verifier
    imports the constant; the recursion circuit reads the prover's)."""
    saved = prover.NUM_QUERIES, verifier.NUM_QUERIES
    prover.NUM_QUERIES = verifier.NUM_QUERIES = n
    try:
        yield
    finally:
        prover.NUM_QUERIES, verifier.NUM_QUERIES = saved


def test_registry_returns_the_shard_prover():
    assert isinstance(base.get_prover(ProofType.TPU_SHARD), shard.TpuShardProver)


# --- the transcript shards


@pytest.fixture(scope="module")
def sharded():
    return shard.prove_sharded(IH, "cpu")


def test_prove_sharded_equals_jax(sharded):
    assert sharded["kind"] == "poseidon2-transcript-sharded-v1"
    assert len(sharded["shards"]) == len(sharded["boundaries"]) - 1 == 2
    assert _sha(sharded) == _sha(jshard.prove_sharded(IH))


def _tampered_shards(payload):
    """(label, payload) for each way a sharded transcript can be altered."""
    out = []
    bad = copy.deepcopy(payload)
    bad["boundaries"][1][0] = (bad["boundaries"][1][0] + 1) % bb.P
    out.append(("boundary", bad))
    bad = copy.deepcopy(payload)
    bad["digest"] = [0] * 8
    out.append(("digest", bad))
    bad = copy.deepcopy(payload)
    bad["shards"][0]["blocks"][0][0] += 1
    out.append(("blocks", bad))
    bad = copy.deepcopy(payload)
    bad["shards"][1]["stark"]["trace_root"][0] = (bad["shards"][1]["stark"]["trace_root"][0] + 1) % bb.P
    out.append(("shard proof", bad))
    bad = copy.deepcopy(payload)
    bad["shards"] = bad["shards"][:1]
    out.append(("shard count", bad))
    out.append(("kind", dict(payload, kind="poseidon2-transcript-v1")))
    return out


def test_sharded_verifies_and_rejects_tampering(sharded):
    assert shard.verify_sharded(sharded, "cpu")
    for label, bad in _tampered_shards(sharded):
        assert not shard.verify_sharded(bad, "cpu"), label


# --- the recursive shards at NUM_QUERIES = 4


@pytest.fixture(scope="module")
def recursive_q4():
    with _num_queries(_golden("shard_recursive_q4")["inputs"]["num_queries"]):
        return shard.prove_sharded_recursive(IH, "cpu")


@pytest.fixture
def small_queries():
    with _num_queries(_golden("shard_recursive_q4")["inputs"]["num_queries"]):
        yield


def test_recursive_shards_equal_jax_golden(recursive_q4):
    g = _golden("shard_recursive_q4")
    assert recursive_q4["kind"] == "poseidon2-transcript-sharded-recursive-v1"
    assert recursive_q4["boundaries"] == g["boundaries"]
    assert [[d["log_n"], d["width"]] for d in recursive_q4["outer"]] == g["outer_tables"]
    assert _sha(recursive_q4) == g["sha256"]


def test_recursive_shards_verify_and_reject_tampering(recursive_q4, small_queries):
    assert shard.verify_sharded_recursive(recursive_q4, "cpu")
    bad = copy.deepcopy(recursive_q4)
    bad["boundaries"][1][0] = (bad["boundaries"][1][0] + 1) % bb.P
    assert not shard.verify_sharded_recursive(bad, "cpu")
    bad = copy.deepcopy(recursive_q4)
    bad["outer"][0]["trace_root"][0] = (bad["outer"][0]["trace_root"][0] + 1) % bb.P
    assert not shard.verify_sharded_recursive(bad, "cpu")
    assert not shard.verify_sharded_recursive(dict(recursive_q4, digest=[0] * 8), "cpu")


def test_recursive_shards_onchain(recursive_q4, small_queries):
    """The constant-shape recursive artifact through the port's on-chain
    verifier (tests/test_onchain.py's call shape)."""
    sim = ChainSim("ethereum", device=None)
    addr = b"\x52" * 20
    install_proof_verifier(sim, addr, "cpu")
    provider = SimBlockDataProvider(sim)
    artifact = onchain.seal_from_payload(recursive_q4)
    assert onchain.payload_from_seal(artifact) == recursive_q4
    assert onchain.verify_proof_onchain(provider, addr, IH, artifact)
    assert not onchain.verify_proof_onchain(provider, addr, bytes(32), artifact)


@pytest.mark.slow
def test_recursive_shards_full_size_equal_jax_golden():
    payload = shard.prove_sharded_recursive(IH, "cpu")
    assert _sha(payload) == _golden("shard_recursive")["sha256"]
    assert shard.verify_sharded_recursive(payload, "cpu")


# --- the 10-tx block as a tpu_shard request against its JAX golden

# The state-trie statement's message order follows the reference
# preflight's set of accessed accounts, so the block is proven in a
# subprocess under the golden's PYTHONHASHSEED (tools/make_stark_goldens.py).
_BLOCK_SCRIPT = r"""
import hashlib, json, sys
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(int(sys.argv[4]))
from raiko_tpu_torch.chain import SupportedChainSpecs
from raiko_tpu_torch.core.interfaces import ProofRequest, ProofType
from raiko_tpu_torch.core.orchestrator import Raiko
from raiko_tpu_torch.provers import tpu_shard
from raiko_tpu_torch.testing.workload import build_chain

inp, device = json.loads(sys.argv[2]), sys.argv[3]
sha = lambda o: hashlib.sha256(json.dumps(o, sort_keys=True).encode()).hexdigest()
build_chain(1, inp["txs"], None)
req = ProofRequest(block_number=inp["block_number"], network=inp["network"],
                   proof_type=ProofType.TPU_SHARD, prover_args=dict(inp["prover_args"]))
raiko = Raiko(SupportedChainSpecs(), req, device)
gi = raiko.generate_input()
out = raiko.get_output(gi)
proof = raiko.prove(gi, out)
payload = json.loads(proof.proof)
print(json.dumps({
    "block_hash": gi.block_header.hash().hex(), "instance_hash": out.hash.hex(),
    "input": proof.input_hash, "kzg_proof": proof.kzg_proof, "sha256": sha(payload),
    "statements": {slot: sha(payload[slot]) for slot in sorted(payload)},
    "verified": tpu_shard.verify_block_sharded(payload, device)}))
"""


def _check_shard_block_10tx(device: str, threads: int) -> None:
    g = _golden("shard_block_10tx")
    inp = g["inputs"]
    repo = os.path.dirname(os.path.dirname(GOLDEN))
    run = subprocess.run(
        [sys.executable, "-c", _BLOCK_SCRIPT, repo, json.dumps(inp), device, str(threads)],
        env={**os.environ, "PYTHONHASHSEED": inp["python_hash_seed"]},
        capture_output=True, text=True, timeout=3000,
    )
    assert run.returncode == 0, run.stderr[-4000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    assert got["block_hash"] == g["block_hash"], "the block recipe drifted from the golden's"
    assert got["instance_hash"] == g["instance_hash"]
    assert got["statements"] == g["statements"]
    assert got["sha256"] == g["sha256"]
    assert got["input"] == g["input"] and got["kzg_proof"] == g["kzg_proof"]
    assert got["verified"]


@pytest.mark.slow
def test_shard_block_10tx_on_cpu_equals_jax_golden():
    _check_shard_block_10tx("cpu", 4)


# --- on a card


@pytest.mark.cuda
def test_cuda_recursive_shards_equal_jax_goldens(cuda_device):
    with _num_queries(_golden("shard_recursive_q4")["inputs"]["num_queries"]):
        payload = shard.prove_sharded_recursive(IH, cuda_device)
        assert _sha(payload) == _golden("shard_recursive_q4")["sha256"]
        assert shard.verify_sharded_recursive(payload, cuda_device)
    payload = shard.prove_sharded_recursive(IH, cuda_device)
    assert _sha(payload) == _golden("shard_recursive")["sha256"]
    assert shard.verify_sharded_recursive(payload, cuda_device)


@pytest.mark.cuda
def test_cuda_sharded_verifies(cuda_device):
    payload = shard.prove_sharded(IH, cuda_device)
    assert shard.verify_sharded(payload, cuda_device)
    for label, bad in _tampered_shards(payload):
        assert not shard.verify_sharded(bad, cuda_device), label


@pytest.mark.cuda
def test_shard_block_10tx_on_card_equals_jax_golden(cuda_device):
    _check_shard_block_10tx("cuda", 4)
