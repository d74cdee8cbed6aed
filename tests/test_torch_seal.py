"""The port's recursion circuit and seal on the CPU, against the JAX package.

``CircuitBuilder`` (stark/circuit.py) builds the same gate and call tables
as the JAX package's: on the builder of tests/test_circuit.py and on the
fib recursion's verifier circuit, the four arrays (``gate_fixed``,
``call_fixed``, ``gate_trace``, ``call_trace``) are equal (tolerance 0).
Whole proofs are compared as canonical JSON (``json.dumps(...,
sort_keys=True)``), byte for byte, against the goldens that
``tools/make_stark_goldens.py`` wrote with the JAX package:

- ``recursion_fib``: a fib proof (log_n 4) aggregated by
  ``recursion.prove_recursion`` with ``NUM_QUERIES`` 4, as
  tests/test_recursion.py does; a different statement and a tampered
  outer proof are rejected, an invalid inner proof refused;
- ``seal_transcript``: the seal of ``prove_transcript(bytes(range(32)))``
  at production parameters, proven once for the module; it verifies whole
  and stripped, a changed instance hash or shape vector is rejected, and
  its artifact passes the port's on-chain verifier (``ChainSim`` with
  ``install_proof_verifier``) under its journal and fails under another.

The ``slow`` test seals a payload with an EVM call-tree group (as
tests/test_seal.py's does); the ``cuda`` tests prove the goldens on a card.
"""

import contextlib
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from raiko_tpu.fields import babybear_ext as jef
from raiko_tpu.ops import poseidon2 as jp2
from raiko_tpu.stark import circuit as jcircuit
from raiko_tpu.stark import prover as jprover
from raiko_tpu.stark import recursion as jrecursion
from raiko_tpu.stark import serde as jserde
from raiko_tpu.stark.airs.fib import FibAir as JFibAir
from raiko_tpu_torch.core.provider import SimBlockDataProvider
from raiko_tpu_torch.fields import babybear as bb
from raiko_tpu_torch.fields import babybear_ext as ef
from raiko_tpu_torch.ops import poseidon2 as p2
from raiko_tpu_torch.provers import onchain
from raiko_tpu_torch.provers import seal as seal_mod
from raiko_tpu_torch.provers.tpu_stark import prove_transcript
from raiko_tpu_torch.stark import circuit, prover, recursion, serde, verifier
from raiko_tpu_torch.stark.airs.fib import FibAir
from raiko_tpu_torch.testing.chainsim import ChainSim, install_proof_verifier

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
SEAL_IH = bytes(range(32))


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


def _outer_sha(outer) -> str:
    return _sha([serde.proof_to_dict(p) for p in outer])


# --- the circuit builder against JAX's


def _build(cb, lanes_cls, h_one, permute, with_values: bool):
    """The builder of tests/test_circuit.py on either package's modules."""
    b = cb(with_values)
    x = b.input_base(5 if with_values else None)
    y = b.input_base(7 if with_values else None)
    z = b.mul(x, y)
    w = b.axpy(z, (3, 0, 0, 0), y)
    b.assert_eq(w, (56, 0, 0, 0))
    inv = b.inv(w)
    b.assert_eq(b.mul(w, inv), h_one)
    bit = b.bit_input(1 if with_values else None)
    b.assert_eq(b.select(bit, x, y), (5, 0, 0, 0))
    lanes = [x, y, z, w] + [b.const_wire(i) for i in range(4)]
    lanes += [lanes_cls((100 + i if with_values else None)) for i in range(8)]
    out = b.perm_call(lanes, swap=bit)
    if with_values:
        assert [o.val[0] for o in out] == permute([100 + i for i in range(8)] + [5, 7, 35, 56, 0, 1, 2, 3])
    b.assert_eq(b.add(out[0], out[1]), b.add(out[1], out[0]))
    folded = b.perm_call([(i, 0, 0, 0) for i in range(16)])
    assert [v[0] for v in folded] == permute(list(range(16)))
    out2 = b.perm_call(out, swap=None)
    b.assert_eq(out2[3], out2[3])
    return b.finalize()


ARRAYS = ("gate_fixed", "call_fixed", "gate_trace", "call_trace")


@pytest.mark.parametrize("with_values", [True, False])
def test_circuit_builder_equals_jax(with_values):
    got = _build(circuit.CircuitBuilder, circuit.FreeLane, ef.H_ONE, p2.host_permute, with_values)
    want = _build(jcircuit.CircuitBuilder, jcircuit.FreeLane, jef.H_ONE, jp2.host_permute, with_values)
    for name in ARRAYS:
        g, w = getattr(got, name), getattr(want, name)
        if not with_values and name.endswith("trace"):
            assert g is None and w is None
        else:
            assert g.dtype == w.dtype and np.array_equal(g, w), name


# --- the fib recursion at NUM_QUERIES = 4 (tests/test_recursion.py)


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


@pytest.fixture
def small_queries():
    with _num_queries(_golden("recursion_fib")["inputs"]["num_queries"]):
        yield


def _prove_fib_recursion(device):
    inp = _golden("recursion_fib")["inputs"]
    air = FibAir()
    trace, publics = FibAir.trace(inp["log_n"], inp["a"], inp["b"])
    inner = prover.prove(air, trace, publics, device)
    table = recursion.InnerTable(air, inp["log_n"], publics)
    return table, inner, recursion.prove_recursion([[table]], [[inner]], device)


@pytest.fixture(scope="module")
def fib_recursion():
    with _num_queries(_golden("recursion_fib")["inputs"]["num_queries"]):
        return _prove_fib_recursion("cpu")


def test_recursion_circuit_equals_jax(fib_recursion, small_queries, monkeypatch):
    """The fib recursion's verifier circuit, with the witness and as the
    statement alone, equals the JAX package's array for array."""
    monkeypatch.setattr(jprover, "NUM_QUERIES", prover.NUM_QUERIES)
    table, inner, _ = fib_recursion
    jtable = jrecursion.InnerTable(JFibAir(), table.log_n, list(table.publics))
    jinner = jserde.proof_from_dict(serde.proof_to_dict(inner))
    for proofs, jproofs in (([[inner]], [[jinner]]), (None, None)):
        *_, got = recursion.build_recursion([[table]], proofs, "cpu")
        *_, want = jrecursion.build_recursion([[jtable]], jproofs)
        for name in ARRAYS:
            g, w = getattr(got, name), getattr(want, name)
            assert (g is None and w is None) or np.array_equal(g, w), name


def test_recursive_fib_equals_jax_golden(fib_recursion, small_queries):
    table, inner, outer = fib_recursion
    g = _golden("recursion_fib")
    assert _sha(serde.proof_to_dict(inner)) == g["inner_sha256"]
    assert [[p.log_n, p.width] for p in outer] == g["outer_tables"]
    assert _outer_sha(outer) == g["sha256"]
    assert recursion.verify_recursion([[table]], outer, "cpu")
    # the outer proof against a different statement fails
    _, other_publics = FibAir.trace(table.log_n, a=2, b=3)
    other = recursion.InnerTable(table.air, table.log_n, other_publics)
    assert not recursion.verify_recursion([[other]], outer, "cpu")


def test_recursion_refuses_invalid_inner(fib_recursion, small_queries):
    table, inner, _ = fib_recursion
    bad = recursion.StarkProof(**{**inner.__dict__})
    bad.trace_at_zeta = [tuple((v + 1) % bb.P for v in t) for t in inner.trace_at_zeta]
    with pytest.raises((ValueError, AssertionError)):
        recursion.prove_recursion([[table]], [[bad]], "cpu")


def test_recursion_rejects_tampered_outer(fib_recursion, small_queries):
    table, _, outer = fib_recursion
    bad0 = recursion.StarkProof(**{**outer[0].__dict__})
    bad0.trace_root = [(v + 1) % bb.P for v in outer[0].trace_root]
    assert not recursion.verify_recursion([[table]], [bad0, outer[1]], "cpu")


# --- the transcript seal at production parameters (tests/test_seal.py)


@pytest.fixture(scope="module")
def transcript_seal():
    payload = prove_transcript(SEAL_IH, "cpu")
    return payload, seal_mod.prove_block_seal(payload, "cpu")


def test_seal_equals_jax_golden(transcript_seal):
    payload, s = transcript_seal
    g = _golden("seal_transcript")
    assert _sha(payload) == g["payload_sha256"]
    assert s["kind"] == "seal-v2" and s["n_groups"] == 1 and s["unsealed"] == 0
    assert s["shapes"] == g["shapes"]
    assert [[d["log_n"], d["width"]] for d in s["outer"]] == g["outer_tables"]
    assert _sha(s) == g["sha256"]


def test_seal_verifies_and_rejects_tampering(transcript_seal):
    payload, s = transcript_seal
    assert seal_mod.verify_block_seal(payload, s, "cpu")
    # the stripped descriptor (no inner proof bodies) verifies too
    stripped = seal_mod.strip_payload(payload)
    assert "stark" not in stripped
    assert seal_mod.verify_block_seal(stripped, s, "cpu")
    # a different instance hash, a different shape vector: rejected
    assert not seal_mod.verify_block_seal(dict(payload, instance_hash=bytes(32).hex()), s, "cpu")
    bad_seal = dict(s, shapes=[[x + 1 for x in grp] for grp in s["shapes"]])
    assert not seal_mod.verify_block_seal(payload, bad_seal, "cpu")
    assert not seal_mod.verify_block_seal(payload, dict(s, kind="seal-v1"), "cpu")


def test_seal_artifact_onchain(transcript_seal):
    payload, s = transcript_seal
    art = seal_mod.seal_artifact(payload, s)
    sim = ChainSim("ethereum", device=None)
    addr = b"\x53" * 20
    install_proof_verifier(sim, addr, "cpu")
    provider = SimBlockDataProvider(sim)
    assert onchain.verify_proof_onchain(provider, addr, SEAL_IH, art)
    assert not onchain.verify_proof_onchain(provider, addr, bytes(32), art)
    # a partial seal is refused as a standalone artifact (the shape vector
    # must cover every group the payload declares)
    partial = dict(payload, mpt={"kind": "keccak-mpt-v2"})
    assert not seal_mod.verify_seal_artifact(SEAL_IH, seal_mod.seal_artifact(partial, s), "cpu")


def _check_evm_frame_group_seal(device) -> None:
    """A payload carrying an EVM call-tree group: the transcript table and
    every table of one covered frame collapse into one outer proof."""
    from raiko_tpu_torch.stark.airs import evm_air as ea

    payload = prove_transcript(SEAL_IH, device)
    frame = ea.prove_frame(bytes([0x60, 5, 0x60, 7, 0x01, 0x50, 0x00]), ea.FrameEnv(codesize=7), 100000, device)
    payload["evm"] = {"kind": "evm-frames-v1", "total": 1, "covered": 1, "frames": [frame]}
    s = seal_mod.prove_block_seal(payload, device)
    assert s["n_groups"] == 2 and s["unsealed"] == 0
    assert seal_mod.verify_block_seal(payload, s, device)
    bad_frame = json.loads(json.dumps(frame))
    bad_frame["frames"][0]["gas_f"] = int(bad_frame["frames"][0]["gas_f"]) - 1
    bad = dict(payload, evm=dict(payload["evm"], frames=[bad_frame]))
    assert not seal_mod.verify_block_seal(bad, s, device)


@pytest.mark.slow
def test_seal_evm_frame_group():
    _check_evm_frame_group_seal("cpu")


@pytest.mark.cuda
def test_cuda_recursive_fib_equals_jax_golden(cuda_device, small_queries):
    table, _, outer = _prove_fib_recursion(cuda_device)
    assert _outer_sha(outer) == _golden("recursion_fib")["sha256"]
    assert recursion.verify_recursion([[table]], outer, cuda_device)


@pytest.mark.cuda
def test_cuda_seal_equals_jax_golden(cuda_device):
    payload = prove_transcript(SEAL_IH, cuda_device)
    s = seal_mod.prove_block_seal(payload, cuda_device)
    assert _sha(s) == _golden("seal_transcript")["sha256"]
    assert seal_mod.verify_block_seal(payload, s, cuda_device)
    assert not seal_mod.verify_block_seal(dict(payload, instance_hash=bytes(32).hex()), s, cuda_device)


@pytest.mark.cuda
def test_cuda_seal_evm_frame_group(cuda_device):
    _check_evm_frame_group_seal(cuda_device)
