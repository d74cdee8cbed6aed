"""The port's ``tpu_stark`` backend and its containment AIRs, against the
JAX package, on the CPU.

The containment AIRs (``ByteCodeAir``, ``ContainAir``) and the keccak
sponge they bind (``KeccakSpongeV2Air``, built from messages and from
block counts) are host numpy in both packages: on seeded messages the
port's trace, aux trace, bus values, publics and fixed columns equal the
JAX AIRs' as arrays (tolerance 0), and so do ``pad_keccak`` and the bus
codes.  The three-message containment chain, proven by the port on the
CPU, equals the JAX payload of ``tools/make_stark_goldens.py``
(``stark_containment_chain.json``) byte for byte as ``json.dumps(payload,
sort_keys=True)``, and the port's verifier accepts it and rejects a wrong
root and tampered block counts.  The proof cache is the port's copy of
``tests/test_proof_cache.py``; the registry returns the port's provers; a
config that asks for the seal, and a request with EVM frames, reach the
prover, and ``verify_payload`` rejects a garbage ``seal`` slot.  The ``slow`` test
proves the golden's 10-tx block on the CPU and the ``cuda`` test on a card,
each in a subprocess under the golden's ``PYTHONHASHSEED``; each payload
must hash as the JAX golden's (``stark_block_10tx.json``).
"""

import copy
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from raiko_tpu.provers import tpu_stark as jts
from raiko_tpu.stark.airs import containment as jct
from raiko_tpu.stark.airs import keccak_air as jka
from raiko_tpu.utils import keccak256
from raiko_tpu_torch.core.interfaces import Proof, ProofType
from raiko_tpu_torch.fields import babybear as bb
from raiko_tpu_torch.provers import base, proof_cache
from raiko_tpu_torch.provers import tpu_stark as ts
from raiko_tpu_torch.stark.airs import containment as ct
from raiko_tpu_torch.stark.airs import keccak_air as ka

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
BLOCK_ARGS = {"evm_statement": False, "proof_cache": False}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs files in parallel workers: torch's own thread pool per
    # worker would oversubscribe the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _golden(case: str) -> dict:
    with open(os.path.join(GOLDEN, f"stark_{case}.json")) as f:
        return json.load(f)


def _sha(obj) -> str:
    return hashlib.sha256(json.dumps(obj, sort_keys=True).encode()).hexdigest()


def _challenges(rng) -> list[tuple]:
    return [tuple(int(v) for v in rng.integers(1, bb.P, 4)) for _ in range(ct.NUM_CHALLENGES)]


def _chain(rng, sizes: list[int]) -> tuple[list[bytes], list, dict]:
    """Messages of the given sizes, each but the last holding the keccak
    digest of the next at a seeded offset; the containment claims and
    byte-triple multiplicities of ``_prove_containment``."""
    msgs = [bytes(rng.integers(0, 256, sizes[-1], dtype=np.uint8))]
    for size in reversed(sizes[:-1]):
        assert size >= 32
        off = int(rng.integers(0, size - 31))
        body = bytearray(rng.integers(0, 256, size, dtype=np.uint8))
        body[off : off + 32] = keccak256(msgs[0])
        msgs.insert(0, bytes(body))
    claims, mults = [], {}
    for k in range(1, len(msgs)):
        digest = keccak256(msgs[k])
        off = msgs[k - 1].find(digest)
        claims.append((digest, k - 1, off))
        for j in range(32):
            mults[(k - 1, off + j)] = mults.get((k - 1, off + j), 0) + 1
    return msgs, claims, mults


def _assert_air_arrays(port_air, jax_air, port_trace, jax_trace, chal):
    np.testing.assert_array_equal(port_trace, jax_trace)
    n = port_trace.shape[0]
    assert port_air.width == jax_air.width and port_air.aux_width == jax_air.aux_width
    np.testing.assert_array_equal(port_air.fixed_columns(n), jax_air.fixed_columns(n))
    np.testing.assert_array_equal(port_air.aux_trace(port_trace, chal), jax_air.aux_trace(jax_trace, chal))
    assert port_air.bus_values(port_trace, chal) == jax_air.bus_values(jax_trace, chal)


# seeded message sizes: 1 byte, either side of the 136-byte rate, and one
# message of MAX_BLOCKS (64) rate blocks
SPONGE_SIZES = {
    "one_byte": [1],
    "rate_edges": [135, 136, 137],
    "max_blocks": [ct.MAX_BLOCKS * ct.RATE_BYTES - 1, 40],
}


@pytest.mark.parametrize("offset, bind_root", [(0, True), (5, False)])
@pytest.mark.parametrize("case", sorted(SPONGE_SIZES))
def test_sponge_v2_air_equals_jax(case, offset, bind_root):
    rng = np.random.default_rng(sorted(SPONGE_SIZES).index(case) + 100 * offset)
    msgs = [bytes(rng.integers(0, 256, s, dtype=np.uint8)) for s in SPONGE_SIZES[case]]
    air = ka.KeccakSpongeV2Air.from_messages(msgs, msg_id_offset=offset, bind_root=bind_root)
    jair = jka.KeccakSpongeV2Air.from_messages(msgs, msg_id_offset=offset, bind_root=bind_root)
    assert air.block_counts == jair.block_counts and air.num_perms == jair.num_perms
    assert air.digests == jair.digests and air.publics() == jair.publics()
    _assert_air_arrays(air, jair, air.trace(), jair.trace(), _challenges(rng))
    # the verifier's construction: public block counts (and root) only
    root = air.digests[0] if bind_root else None
    vair = ka.KeccakSpongeV2Air(air.block_counts, msg_id_offset=offset, root_digest=root)
    jvair = jka.KeccakSpongeV2Air(air.block_counts, msg_id_offset=offset, root_digest=root)
    assert vair.publics() == jvair.publics() == air.publics()
    n = ka.ROWS * vair.num_perms
    np.testing.assert_array_equal(vair.fixed_columns(n), jvair.fixed_columns(n))
    np.testing.assert_array_equal(vair.fixed_columns(n), air.fixed_columns(n))


def test_sponge_v2_refuses_more_than_max_blocks():
    for mod in (ka, jka):
        with pytest.raises(AssertionError):
            mod.KeccakSpongeV2Air([ct.MAX_BLOCKS + 1])


@pytest.mark.parametrize("sizes", [[200, 136, 135, 137, 1], [40, 32], [ct.RATE_BYTES * 3, 300, 64]])
def test_bytecode_and_contain_airs_equal_jax(sizes):
    rng = np.random.default_rng(len(sizes) * 1000 + sizes[0])
    msgs, claims, mults = _chain(rng, sizes)
    chal = _challenges(rng)
    lens = [len(ct.pad_keccak(m)) for m in msgs]
    air, jair = ct.ByteCodeAir(lens), jct.ByteCodeAir(lens)
    _assert_air_arrays(air, jair, air.trace(msgs, mults), jair.trace(msgs, mults), chal)
    cair, jcair = ct.ContainAir(len(claims)), jct.ContainAir(len(claims))
    _assert_air_arrays(cair, jcair, cair.trace(claims), jcair.trace(claims), chal)


def test_codes_equal_jax():
    rng = np.random.default_rng(7)
    chi = tuple(int(v) for v in rng.integers(0, bb.P, 4))
    for size in (0, 1, 135, 136, 137, 271, 272):
        m = bytes(rng.integers(0, 256, size, dtype=np.uint8))
        padded = ct.pad_keccak(m)
        assert padded == jct.pad_keccak(m) and len(padded) % ct.RATE_BYTES == 0
        block = padded[: ct.RATE_BYTES]
        assert ct.block_code(size, block, chi) == jct.block_code(size, block, chi)
        assert ct.digest_code(size, keccak256(m), chi) == jct.digest_code(size, keccak256(m), chi)
        assert ct.triple_code(size, 3, 255, chi) == jct.triple_code(size, 3, 255, chi)


def test_collect_preimages_skips_past_max_blocks(monkeypatch):
    """A preimage of more than MAX_BLOCKS rate blocks is skipped, and so is
    the subtree that only it references; both packages keep the same
    messages and count the same total."""
    from raiko_tpu.mpt import trie as jtrie
    from raiko_tpu_torch.mpt import trie as ptrie

    rng = np.random.default_rng(3)
    orphan = bytes(rng.integers(0, 256, 50, dtype=np.uint8))
    big = keccak256(orphan) + bytes(rng.integers(0, 256, ct.MAX_BLOCKS * ct.RATE_BYTES, dtype=np.uint8))
    small = bytes(rng.integers(0, 256, 70, dtype=np.uint8))
    root_msg = keccak256(big) + keccak256(small)
    all_msgs = [root_msg, big, orphan, small]
    for mod in (jtrie, ptrie):
        monkeypatch.setattr(mod, "hashed_preimages", lambda _trie: list(all_msgs))
    root = keccak256(root_msg)
    got = ts._collect_preimages(None, root)
    assert got == jts._collect_preimages(None, root)
    assert got == ([root_msg, small], 4)


# --- the containment chain payload against its JAX golden


@pytest.fixture(scope="module")
def chain_payload():
    g = _golden("containment_chain")
    inp = g["inputs"]
    msgs = [bytes.fromhex(m) for m in inp["messages"]]
    root = bytes.fromhex(inp["root"])
    assert keccak256(msgs[0]) == root
    payload = ts._prove_containment(msgs, len(msgs), root, inp["perms_per_chunk"], "cpu")
    return payload, g


def test_chain_payload_equals_jax_golden(chain_payload):
    payload, g = chain_payload
    assert len(payload["starks"]) == g["tables"] == 3
    for i, (got, want) in enumerate(zip(payload["starks"], g["payload"]["starks"])):
        assert _sha(got) == _sha(want), f"table {i} differs from the JAX golden"
    assert json.dumps(payload, sort_keys=True) == json.dumps(g["payload"], sort_keys=True)
    assert _sha(payload) == g["sha256"]


def test_chain_payload_verifies_and_rejects_tampering(chain_payload):
    payload, g = chain_payload
    root = bytes.fromhex(g["inputs"]["root"])
    assert ts.verify_mpt_v2_payload(payload, "cpu", root)
    assert not ts.verify_mpt_v2_payload(payload, "cpu", keccak256(b"another root"))
    bad_root = dict(payload, state_root=keccak256(b"another root").hex())
    assert not ts.verify_mpt_v2_payload(bad_root, "cpu")
    bad_counts = copy.deepcopy(payload)
    bad_counts["block_counts"][0][-1] += 1
    assert not ts.verify_mpt_v2_payload(bad_counts, "cpu")


# --- the proof cache (the port's copy of tests/test_proof_cache.py)

IH = keccak256(b"instance")


def _cfg(tmp_path, **kw):
    return {"proof_cache": str(tmp_path), **kw}


def test_cache_roundtrip_and_config_invalidation(tmp_path):
    cfg = _cfg(tmp_path, max_evm_frames=2)
    payload = {"kind": "x", "stark": [1, 2, 3]}
    assert proof_cache.load_proof(cfg, "tpu_stark", IH) is None
    proof_cache.save_proof(cfg, "tpu_stark", IH, payload)
    assert proof_cache.load_proof(cfg, "tpu_stark", IH) == payload
    # statement-shaping config change -> different label -> miss
    assert proof_cache.load_proof(_cfg(tmp_path, max_evm_frames=8), "tpu_stark", IH) is None
    # different proof system -> miss
    assert proof_cache.load_proof(cfg, "tpu_shard", IH) is None
    # different instance -> miss
    assert proof_cache.load_proof(cfg, "tpu_stark", keccak256(b"other")) is None


def test_cache_label_equals_jax():
    from raiko_tpu.provers import proof_cache as jpc

    cfg = {"mpt_version": 2, "evm_statement": False, "proof_cache": True, "endpoint": "x"}
    assert proof_cache.STATEMENT_VERSION == jpc.STATEMENT_VERSION
    assert proof_cache._STATEMENT_KEYS == jpc._STATEMENT_KEYS
    assert proof_cache.proof_label("tpu_stark", IH, cfg) == jpc.proof_label("tpu_stark", IH, cfg)


def test_cache_disabled_without_config(tmp_path):
    proof_cache.save_proof({}, "tpu_stark", IH, {"a": 1})
    assert proof_cache.load_proof({}, "tpu_stark", IH) is None


def test_cache_wrong_instance_binding_rejected(tmp_path):
    cfg = _cfg(tmp_path)
    proof_cache.save_proof(cfg, "tpu_stark", IH, {"a": 1})
    path = tmp_path / (proof_cache.proof_label("tpu_stark", IH, cfg) + ".json")
    entry = json.loads(path.read_text())
    entry["instance_hash"] = keccak256(b"mallory").hex()
    path.write_text(json.dumps(entry))
    assert proof_cache.load_proof(cfg, "tpu_stark", IH) is None


def test_cache_corrupt_entry_is_miss(tmp_path):
    cfg = _cfg(tmp_path)
    proof_cache.save_proof(cfg, "tpu_stark", IH, {"a": 1})
    (tmp_path / (proof_cache.proof_label("tpu_stark", IH, cfg) + ".json")).write_text("{not json")
    assert proof_cache.load_proof(cfg, "tpu_stark", IH) is None


def _stub_instance(monkeypatch, collect_extra=None):
    """Stub the re-execution so run() reaches its checks without a block."""

    def header(gi, collect=None, device=None):
        collect.update(collect_extra or {})
        return "H"

    class _PI:
        def instance_hash(self):
            return IH

    monkeypatch.setattr(ts, "calculate_block_header", header)
    monkeypatch.setattr(ts.ProtocolInstance, "new", staticmethod(lambda gi, h, v, d: _PI()))

    def _boom(*a, **k):
        raise AssertionError("the prover ran")

    monkeypatch.setattr(ts, "prove_transcript", _boom)


class _Out:
    hash = IH


def test_prover_short_circuits_on_cache_hit(tmp_path, monkeypatch):
    cfg = {"proof_cache": str(tmp_path), "evm_statement": False}
    proof_cache.save_proof(cfg, "tpu_stark", IH, {"kind": "poseidon2-transcript-v1", "seeded": True})
    _stub_instance(monkeypatch)
    proof = ts.TpuStarkProver().run(object(), _Out(), cfg, base.ProverCtx(device=None))
    assert isinstance(proof, Proof)
    assert json.loads(proof.proof)["seeded"] is True
    assert proof.input_hash == "0x" + IH.hex()


# --- the registry and the statements once refused


def test_registry_returns_the_port_prover():
    from raiko_tpu_torch.provers import tee, tpu_shard

    assert isinstance(base.get_prover(ProofType.TPU_STARK), ts.TpuStarkProver)
    assert base.get_prover(ProofType.NATIVE).proof_type == ProofType.NATIVE
    assert isinstance(base.get_prover(ProofType.TPU_SHARD), tpu_shard.TpuShardProver)
    assert isinstance(base.get_prover(ProofType.TEE), tee.TeeProver)


@pytest.mark.parametrize(
    "config, frames, sealed",
    [
        ({}, [{"code": b""}], False),
        ({"evm_statement": True}, [{"code": b""}], False),
        ({"evm_statement": False, "seal": True}, [], True),
    ],
)
def test_unported_statements_are_refused(monkeypatch, config, frames, sealed):
    """No statement is refused: a request with frames, under the default
    config or with the EVM statement asked for, reaches the prover (the
    stubbed transcript prover raises that it ran), and a sealed request
    reaches the seal on the context's device with its ``seal_max_tables``."""
    from raiko_tpu_torch.provers import seal

    _stub_instance(monkeypatch, {"frames": frames})
    if not sealed:
        with pytest.raises(AssertionError, match="the prover ran"):
            ts.TpuStarkProver().run(object(), _Out(), config, base.ProverCtx(device=None))
        return
    monkeypatch.setattr(ts, "prove_transcript", lambda ih, device: {"kind": "poseidon2-transcript-v1"})
    monkeypatch.setattr(seal, "prove_block_seal",
                        lambda payload, device, max_tables=None: {"device": device, "max_tables": max_tables})
    config = {**config, "seal_max_tables": 1}
    proof = ts.TpuStarkProver().run(object(), _Out(), config, base.ProverCtx(device="cpu"))
    assert json.loads(proof.proof)["seal"] == {"device": "cpu", "max_tables": 1}


def test_no_frames_needs_no_evm_statement(monkeypatch):
    """With no frames the default config proves what the reference would:
    the refusal does not fire (the stubbed transcript prover is reached)."""
    _stub_instance(monkeypatch, {"frames": []})
    with pytest.raises(AssertionError, match="the prover ran"):
        ts.TpuStarkProver().run(object(), _Out(), {}, base.ProverCtx(device=None))


def test_verify_payload_rejects_unported_slots():
    """A valid transcript payload with a garbage ``seal`` slot is rejected."""
    payload = ts.prove_transcript(IH, "cpu")
    assert ts.verify_payload(payload, "cpu")
    for garbage in ({}, {"kind": "seal-v2"}, {"kind": "seal-v2", "shapes": [[5]], "outer": []}):
        assert not ts.verify_payload({**payload, "seal": garbage}, "cpu")
    assert not ts.verify_payload({"kind": "something-else"}, "cpu")


def test_transcript_blocks_equal_jax():
    ih = keccak256(b"transcript")
    assert ts.transcript_blocks(ih) == jts.transcript_blocks(ih)
    for name in ("DOMAIN_TAG", "NUM_BLOCKS", "MAX_MPT_PERMS", "PERMS_PER_CHUNK"):
        assert getattr(ts, name) == getattr(jts, name)


# --- the 10-tx block against its JAX golden

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
from raiko_tpu_torch.provers import tpu_stark
from raiko_tpu_torch.testing.workload import build_chain

inp, device = json.loads(sys.argv[2]), sys.argv[3]
sha = lambda o: hashlib.sha256(json.dumps(o, sort_keys=True).encode()).hexdigest()
build_chain(1, inp["txs"], None)
req = ProofRequest(block_number=inp["block_number"], network=inp["network"],
                   proof_type=ProofType.TPU_STARK, prover_args=dict(inp["prover_args"]))
raiko = Raiko(SupportedChainSpecs(), req, device)
gi = raiko.generate_input()
out = raiko.get_output(gi)
proof = raiko.prove(gi, out)
payload = json.loads(proof.proof)
print(json.dumps({
    "block_hash": gi.block_header.hash().hex(), "instance_hash": out.hash.hex(),
    "input": proof.input_hash, "kzg_proof": proof.kzg_proof, "sha256": sha(payload),
    "statements": {slot: sha(payload[slot]) for slot in sorted(payload)},
    "verified": tpu_stark.verify_payload(payload, device)}))
"""


def _check_block_10tx(device: str, threads: int) -> None:
    import subprocess
    import sys

    g = _golden("block_10tx")
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
def test_block_10tx_on_cpu_equals_jax_golden():
    _check_block_10tx("cpu", 4)


@pytest.mark.cuda
def test_block_10tx_on_card_equals_jax_golden():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    _check_block_10tx("cuda", 4)
