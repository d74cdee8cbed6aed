#!/usr/bin/env python3
"""Write the STARK proof goldens under tests/golden/ with the JAX package.

    JAX_PLATFORMS=cpu python tools/make_stark_goldens.py            # every case
    JAX_PLATFORMS=cpu python tools/make_stark_goldens.py fib affine # some
    JAX_PLATFORMS=cpu python tools/make_stark_goldens.py block_10tx # minutes
    JAX_PLATFORMS=cpu python tools/make_stark_goldens.py block_10tx_evm  # half an hour
    JAX_PLATFORMS=cpu python tools/make_stark_goldens.py recursion_fib seal_transcript
    JAX_PLATFORMS=cpu python tools/make_stark_goldens.py shard_block_10tx  # half an hour

Each case proves one AIR with ``raiko_tpu.stark.prover`` on the CPU, checks
the proof with ``raiko_tpu.stark.verifier.verify_tables`` (a golden that
does not verify is not written), and writes ``tests/golden/stark_<case>.json``:
the case's inputs (AIR parameters, messages or blocks, trace parameters,
publics), the sha256 of the canonical proof JSON
(``json.dumps(proof_to_dict(p), sort_keys=True)``), the proof's roots and,
for the small cases, the whole proof.  The port's tests and ``chip_smoke.py``
prove the same inputs and compare against these files, since big JAX
proofs are not recomputed on every run.

The keccak cases evaluate the quotient with the JAX package's host-numpy
path (``RAIKO_EAGER_QUOTIENT=1``, the same proof bytes as the jitted path):
XLA:CPU compiles the 4,160-column AIR's jitted quotient far too slowly.
The golden records which path made it (``eager_quotient``).

Four cases prove payloads instead of one AIR, with the keccak cases'
host quotient (the EVM tables evaluate theirs on the host anyway), and
are written only if the JAX package's verifier accepts them:

- ``containment_chain``: three messages, each holding the keccak digest
  of the next, as one ``_prove_containment`` payload (the sponge, byte and
  claim tables in one transcript), kept whole;
- ``block_10tx``: a 10-tx taiko_a7 blob block of the port's bench mix
  (``raiko_tpu_torch/testing/workload.py``; 80% storage churn, 10%
  transfers, 10% nested CALLs),
  built with the JAX package's chain simulator (``tests/chainsim.py``)
  from the same recipe, and proven by the JAX ``tpu_stark`` backend with
  prover args ``BLOCK_ARGS``.  The golden keeps the block's hash (a recipe
  that drifts shows there before any proof is compared), the instance
  hash, the KZG proof, the sha256 of ``json.dumps(payload,
  sort_keys=True)`` and of each statement, each statement's table count,
  and the JAX CPU seconds;
- ``evm_call_tree``: the call tree of
  ``test_call_tree_prove_verify_roundtrip`` (tests/test_evm_call.py: a
  caller that CALLs a callee and the identity precompile, 17 tables)
  through ``evm_air.prove_call_tree``; the golden keeps its inputs, the
  sha256 of ``json.dumps(payload, sort_keys=True)``, each table's width,
  size and trace root;
- ``block_10tx_evm``: the same 10-tx block under the default config
  (prover args ``BLOCK_EVM_ARGS``: the EVM frame statement and the
  prestate binding on), kept as ``block_10tx`` is, with the EVM
  statement's covered and total frame candidates.

Five cases aggregate proofs through the recursion circuit
(``stark/recursion.py``) or prove the sharded backend, and are written
only if the JAX package's verifier accepts them:

- ``recursion_fib``: a fib proof (log_n ``RECURSION_FIB_LOG_N``) proven
  and aggregated by ``recursion.prove_recursion`` with ``NUM_QUERIES``
  set to ``SMALL_QUERIES`` in the prover and the verifier (as
  tests/test_recursion.py does); the golden keeps the inner and the outer
  proof's sha256 (the outer proof as ``json.dumps([proof_to_dict(p) for p
  in outer], sort_keys=True)``) and the outer tables' shapes;
- ``seal_transcript``: the seal (``seal.prove_block_seal``) of the
  transcript payload ``prove_transcript(bytes(range(32)))`` at production
  parameters, its sha256 as ``json.dumps(seal, sort_keys=True)``;
- ``shard_recursive_q4`` and ``shard_recursive``:
  ``tpu_shard.prove_sharded_recursive(bytes(range(32)))`` at
  ``SMALL_QUERIES`` and at production parameters, the sha256 of
  ``json.dumps(payload, sort_keys=True)``;
- ``shard_block_10tx``: the 10-tx block of ``block_10tx_evm`` proven by
  the JAX ``tpu_shard`` backend with prover args ``SHARD_BLOCK_ARGS``,
  kept as ``block_10tx`` is.

The state-trie statement's message order follows the reference
preflight's set of accessed accounts (``ProviderDb.accessed_accounts``),
whose iteration order follows Python's string hashing; so the tool runs
under ``PYTHONHASHSEED=0`` (it re-executes itself so), and the port's
runs that compare against ``block_10tx`` do too.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
SEED = 20240613
FIB_LOG_N = 6
PERM_LOG_N = 4
AFFINE_LOG_N = 4
AFFINE_START = 7
AFFINE_FIXED_SEED = 1234
KECCAK_CHUNK_PERMS = 23  # MAX_MPT_PERMS of provers/tpu_stark.py: n = 1,024
KECCAK_SMALL = (3, 4)  # 3 messages, 4 blocks: n = 256
CHAIN_SEED = 11
BLOCK_TXS = 10
BLOCK_ARGS = {"evm_statement": False, "proof_cache": False}
BLOCK_EVM_ARGS = {"proof_cache": False}  # the default config: EVM frames and prestate on
SHARD_BLOCK_ARGS = {"proof_cache": False}  # the default config: recursion off, 4 shard workers
RECURSION_FIB_LOG_N = 4
SMALL_QUERIES = 4  # NUM_QUERIES of the small-parameter recursion cases
SHARD_IH = bytes(range(32))  # the instance hash of the seal and shard cases
HASH_SEED = "0"  # PYTHONHASHSEED of every run compared against block_10tx
# the payload slots that hold a STARK statement, in the order run() proves them
STATEMENTS = ("stark", "mpt", "tx_mpt", "receipts_mpt", "chain", "evm", "prestate")
# the call tree of tests/test_evm_call.py: a caller that CALLs a callee and
# the identity precompile (two frames and their composition tables)
TREE_CALLEE_ADDR = 0xBB
TREE_CALLEE = bytes([
    0x60, 0x00, 0x35, 0x60, 0x01, 0x01,
    0x60, 0x00, 0x52, 0x60, 0x20, 0x60, 0x00, 0xF3,
])
TREE_CALLER = bytes([
    0x60, 41, 0x60, 0x00, 0x52,
    0x60, 0x20, 0x60, 0x20, 0x60, 0x20, 0x60, 0x00, 0x60, 0x00,
    0x60, TREE_CALLEE_ADDR, 0x61, 0xFF, 0xFF, 0xF1,
    0x60, 0x20, 0x51, 0x01,
    0x60, 0x20, 0x60, 0x40, 0x60, 0x20, 0x60, 0x00, 0x60, 0x00,
    0x60, 0x04, 0x61, 0xFF, 0xFF, 0xF1,
    0x00,
])
TREE_ENV = {"address": 0xAA, "caller": 0x99, "origin": 0x99}
TREE_GAS = 100_000


def keccak_messages(seed: int, n_msgs: int | None, n_blocks: int) -> list[bytes]:
    """Seeded random messages whose padded keccak blocks (len // 136 + 1
    each) sum to `n_blocks`; with `n_msgs`, exactly that many messages."""
    rng = np.random.default_rng(seed)
    if n_msgs is None:
        sizes = []
        left = n_blocks
        while left:
            sizes.append(int(min(left, rng.integers(1, 5))))
            left -= sizes[-1]
    else:
        sizes = [1] * n_msgs
        for i in rng.integers(0, n_msgs, n_blocks - n_msgs):
            sizes[int(i)] += 1
    return [rng.bytes(int(rng.integers(136 * (b - 1), 136 * b))) for b in sizes]


def affine_fixed(n: int) -> np.ndarray:
    """The committed fixed columns (f0, f1) of the affine-chain AIR."""
    rng = np.random.default_rng(AFFINE_FIXED_SEED)
    f = rng.integers(0, 2013265921, size=(2, n), dtype=np.uint64).astype(np.uint32)
    f[1] = np.maximum(f[1], 1)  # multiplicative column nonzero
    return f


def affine_trace(log_n: int, start: int) -> tuple[np.ndarray, list[int]]:
    p = 2013265921
    n = 1 << log_n
    f = affine_fixed(n)
    rows = np.zeros((n, 1), dtype=np.uint32)
    t = start % p
    for i in range(n):
        rows[i, 0] = t
        t = (t * int(f[1, i]) + int(f[0, i])) % p
    return rows, [start % p, int(rows[n - 1, 0])]


def _cases():
    """name -> (make(): (air, trace, publics, inputs), keep_whole_proof, eager)."""
    from raiko_tpu.provers.tpu_stark import transcript_blocks
    from raiko_tpu.stark.air import Air, ConstraintBuilder
    from raiko_tpu.stark.airs.fib import FibAir
    from raiko_tpu.stark.airs.keccak_air import KeccakBatchSpongeAir
    from raiko_tpu.stark.airs.permcheck import PermutationAir
    from raiko_tpu.stark.airs.poseidon2_air import Poseidon2TranscriptAir

    class AffineChainAir(Air):
        """t' = t * f1 + f0 with committed fixed columns f0, f1."""

        width = 1
        commit_fixed = True

        def eval(self, b: ConstraintBuilder) -> None:
            t0, t1 = b.local(0), b.next(0)
            f0, f1 = b.fixed(0), b.fixed(1)
            b.transition(b.sub(t1, b.add(b.mul(t0, f1), f0)))
            b.first_row(b.sub(t0, b.public(0)))
            b.last_row(b.sub(t0, b.public(1)))

        def fixed_columns(self, n: int):
            return affine_fixed(n)

    def fib():
        trace, publics = FibAir.trace(FIB_LOG_N)
        return FibAir(), trace, publics, {"log_n": FIB_LOG_N, "a": 1, "b": 1}

    def transcript():
        ih = hashlib.sha256(b"raiko stark transcript golden").digest()
        blocks = transcript_blocks(ih)
        air = Poseidon2TranscriptAir(blocks)
        publics = air.publics_for(air.compute_digest())
        return air, air.trace(), publics, {"instance_hash": ih.hex(), "blocks": blocks}

    def permcheck():
        rng = np.random.default_rng(SEED)
        a = rng.integers(0, 2013265921, 1 << PERM_LOG_N, dtype=np.uint32)
        b = rng.permutation(a)
        trace = PermutationAir.make_trace(a.tolist(), b.tolist())
        return PermutationAir(), trace, [], {"a": a.tolist(), "b": b.tolist()}

    def affine():
        trace, publics = affine_trace(AFFINE_LOG_N, AFFINE_START)
        return AffineChainAir(), trace, publics, {
            "log_n": AFFINE_LOG_N, "start": AFFINE_START, "fixed_seed": AFFINE_FIXED_SEED}

    def keccak(n_msgs, n_blocks, seed):
        def make():
            msgs = keccak_messages(seed, n_msgs, n_blocks)
            air = KeccakBatchSpongeAir(msgs)
            assert air.active_perms == n_blocks
            return air, air.trace(), air.publics(), {
                "messages": [m.hex() for m in msgs], "active_perms": air.active_perms,
                "quotient_chunks": air.quotient_chunks}
        return make

    return {
        "fib": (fib, True, False),
        "transcript": (transcript, True, False),
        "permcheck": (permcheck, True, False),
        "affine": (affine, True, False),
        "keccak_small": (keccak(*KECCAK_SMALL, SEED + 1), False, True),
        "keccak_chunk": (keccak(None, KECCAK_CHUNK_PERMS, SEED), False, True),
    }


def make_golden(name: str, make, whole: bool, eager: bool) -> dict:
    from raiko_tpu.stark import prover, verifier
    from raiko_tpu.stark.serde import proof_to_dict

    air, trace, publics, inputs = make()
    if eager:
        os.environ["RAIKO_EAGER_QUOTIENT"] = "1"
    else:
        os.environ.pop("RAIKO_EAGER_QUOTIENT", None)
    t0 = time.perf_counter()
    proof = prover.prove(air, trace, publics)
    seconds = time.perf_counter() - t0
    if not verifier.verify_tables([air], [proof]):
        raise SystemExit(f"{name}: the JAX package's verifier rejects its own proof")
    d = proof_to_dict(proof)
    canon = json.dumps(d, sort_keys=True)
    out = {
        "case": name,
        "air": type(air).__name__,
        "trace_shape": list(trace.shape),
        "inputs": inputs,
        "publics": [int(v) for v in publics],
        "sha256": hashlib.sha256(canon.encode()).hexdigest(),
        "proof_bytes": len(canon),
        "roots": {
            "trace_root": d["trace_root"],
            "aux_root": d["aux_root"],
            "fixed_root": d["fixed_root"],
            "quotient_root": d["quotient_root"],
            "fri_layer_roots": d["fri"]["layer_roots"],
        },
        "pow_nonce": d["pow_nonce"],
        "eager_quotient": eager,
        "jax_cpu_prove_seconds": seconds,
    }
    if whole:
        out["proof"] = d
    return out


def chain_messages(seed: int) -> list[bytes]:
    """m0 holds keccak(m1), m1 holds keccak(m2) (tests/test_containment.py)."""
    from raiko_tpu.utils import keccak256

    rng = np.random.default_rng(seed)
    m2 = bytes(rng.integers(0, 256, 40, dtype=np.uint8))
    m1 = b"\x01\x02" + keccak256(m2) + bytes(rng.integers(0, 256, 30, dtype=np.uint8))
    m0 = bytes(rng.integers(0, 256, 5, dtype=np.uint8)) + keccak256(m1) + b"\xff"
    return [m0, m1, m2]


def build_jax_chain(n_txs: int) -> None:
    """One taiko_a7 blob block of the port's ``testing.workload.build_chain``
    mix, built by the JAX package's chain simulator from a copy of its
    recipe and registered with the JAX package's provider."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from chainsim import ChainSim, TaikoSim
    from raiko_tpu.core import provider
    from raiko_tpu.proto.types import Transaction
    from raiko_tpu.utils import secp256k1

    keys = [0xBE7C + i for i in range(8)]
    senders = [secp256k1.pubkey_to_address(secp256k1.pubkey(k)) for k in keys]
    provider._SIM_REGISTRY.clear()
    l1 = ChainSim("ethereum")
    for s in senders:
        l1.fund(s, 10**20)
    l1.produce_block([])
    l2 = TaikoSim(l1, "taiko_a7")
    for s in senders:
        l2.fund(s, 10**20)
    n_contracts = max(1, min(20, n_txs // 5))
    churn_code = bytes.fromhex("6001546001016001556002546001016002" + "5500")
    contracts = []
    for i in range(n_contracts):
        addr = bytes([0x95, i]) + b"\x00" * 18
        l2.fund(addr, 0, code=churn_code, storage={1: 5 + i, 2: 9 + i})
        contracts.append(addr)
    callee_b = bytes([0x60, 0x00, 0x35, 0x60, 0x01, 0x01, 0x60, 0x00, 0x52, 0x60, 0x20, 0x60, 0x00, 0xF3])
    addr_b = b"\x97" + b"\x00" * 19
    l2.fund(addr_b, 0, code=callee_b)
    caller_a = bytes([
        0x60, 41, 0x60, 0x00, 0x52,
        0x60, 0x20, 0x60, 0x20, 0x60, 0x20, 0x60, 0x00, 0x60, 0x00,
        0x73, *addr_b, 0x61, 0xFF, 0xFF, 0xF1,
        0x60, 0x20, 0x51, 0x01,
        0x60, 0x20, 0x60, 0x40, 0x60, 0x20, 0x60, 0x00, 0x60, 0x00,
        0x60, 0x04, 0x61, 0xFF, 0xFF, 0xF1,
        0x00,
    ])
    addr_a = b"\x98" + b"\x00" * 19
    l2.fund(addr_a, 0, code=caller_a)
    nonces = [0] * len(keys)

    def mktx(si, to, value=0, gas=200_000):
        tx = Transaction(tx_type=2, chain_id=167009, nonce=nonces[si], max_priority_fee_per_gas=1,
                         max_fee_per_gas=100, gas_limit=gas, to=to, value=value)
        tx.sign(keys[si])
        nonces[si] += 1
        return tx

    blk = 0
    txs = []
    for i in range(n_txs):
        si = i % len(keys)
        if i % 10 == 8:
            txs.append(mktx(si, bytes([0x66, i]) + bytes([blk]) + b"\x00" * 17, value=7, gas=21_000))
        elif i % 10 == 9:
            txs.append(mktx(si, addr_a, gas=150_000))
        else:
            txs.append(mktx(si, contracts[i % n_contracts]))
    l2.produce_taiko_block(txs, use_blob=True)
    provider.register_sim("ethereum", l1)
    provider.register_sim("taiko_a7", l2)


def _sha(obj) -> str:
    return hashlib.sha256(json.dumps(obj, sort_keys=True).encode()).hexdigest()


def statement_tables(payload: dict) -> dict:
    """slot -> number of STARK tables, for each statement in the payload."""
    out = {}
    for slot in STATEMENTS:
        if slot in payload:
            st = payload[slot]
            if slot == "stark":
                out[slot] = 1
            elif slot == "evm":
                out[slot] = sum(len(f["starks"]) for f in st["frames"])
            elif slot == "prestate":
                out[slot] = len(st["keccak"]["stark_chunks"])
            else:
                out[slot] = len(st.get("starks", st.get("stark_chunks", [])))
    return out


def golden_containment_chain() -> dict:
    from raiko_tpu.provers import tpu_stark
    from raiko_tpu.utils import keccak256

    msgs = chain_messages(CHAIN_SEED)
    root = keccak256(msgs[0])
    os.environ["RAIKO_EAGER_QUOTIENT"] = "1"
    t0 = time.perf_counter()
    payload = tpu_stark._prove_containment(msgs, len(msgs), root, tpu_stark.PERMS_PER_CHUNK)
    seconds = time.perf_counter() - t0
    if not tpu_stark.verify_mpt_v2_payload(payload, root):
        raise SystemExit("containment_chain: the JAX package's verifier rejects its own payload")
    return {
        "case": "containment_chain",
        "inputs": {"seed": CHAIN_SEED, "messages": [m.hex() for m in msgs], "root": root.hex(),
                   "perms_per_chunk": tpu_stark.PERMS_PER_CHUNK},
        "sha256": _sha(payload),
        "tables": len(payload["starks"]),
        "eager_quotient": True,
        "jax_cpu_prove_seconds": seconds,
        "payload": payload,
    }


def golden_evm_call_tree() -> dict:
    """The call tree of ``test_call_tree_prove_verify_roundtrip``
    (tests/test_evm_call.py) proven by ``evm_air.prove_call_tree``."""
    from raiko_tpu.stark.airs import evm_air as ea

    root = ea.execute_frame(TREE_CALLER, ea.FrameEnv(**TREE_ENV), TREE_GAS,
                            world={TREE_CALLEE_ADDR: {"code": TREE_CALLEE}}, warm_addresses=set())
    t0 = time.perf_counter()
    payload = ea.prove_call_tree(root)
    seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    if not ea.verify_frame_payload(payload):
        raise SystemExit("evm_call_tree: the JAX package's verifier rejects its own payload")
    verify_seconds = time.perf_counter() - t0
    return {
        "case": "evm_call_tree",
        "inputs": {"caller": TREE_CALLER.hex(), "callee": TREE_CALLEE.hex(),
                   "callee_address": TREE_CALLEE_ADDR, "env": TREE_ENV, "gas": TREE_GAS},
        "sha256": _sha(payload),
        "proof_bytes": len(json.dumps(payload, sort_keys=True)),
        "frames": len(payload["frames"]),
        "tables": [[p["width"], p["log_n"]] for p in payload["starks"]],
        "roots": [p["trace_root"] for p in payload["starks"]],
        "eager_quotient": True,
        "jax_cpu_prove_seconds": seconds,
        "jax_cpu_verify_seconds": verify_seconds,
    }


def golden_block_10tx(case: str = "block_10tx", args: dict = BLOCK_ARGS,
                      proof_type: str = "tpu_stark") -> dict:
    from raiko_tpu.chain import SupportedChainSpecs
    from raiko_tpu.core.interfaces import ProofRequest, ProofType
    from raiko_tpu.core.orchestrator import Raiko
    from raiko_tpu.provers import tpu_stark

    build_jax_chain(BLOCK_TXS)
    req = ProofRequest(block_number=1, network="taiko_a7", proof_type=ProofType(proof_type),
                       prover_args=dict(args))
    raiko = Raiko(SupportedChainSpecs(), req)
    gi = raiko.generate_input()
    out = raiko.get_output(gi)
    os.environ["RAIKO_EAGER_QUOTIENT"] = "1"
    t0 = time.perf_counter()
    proof = raiko.prove(gi, out)
    seconds = time.perf_counter() - t0
    payload = json.loads(proof.proof)
    t0 = time.perf_counter()
    if proof_type == "tpu_shard":
        from raiko_tpu.provers import tpu_shard

        ok = tpu_shard.verify_block_sharded(payload)
    else:
        ok = tpu_stark.verify_payload(payload)
    if not ok:
        raise SystemExit(f"{case}: the JAX package's verifier rejects its own payload")
    verify_seconds = time.perf_counter() - t0
    return {
        "case": case,
        "inputs": {"txs": BLOCK_TXS, "network": "taiko_a7", "block_number": 1, "prover_args": args,
                   "proof_type": proof_type, "python_hash_seed": HASH_SEED},
        "block_hash": gi.block_header.hash().hex(),
        "instance_hash": out.hash.hex(),
        "input": proof.input_hash,
        "kzg_proof": proof.kzg_proof,
        "sha256": _sha(payload),
        "statements": {slot: _sha(payload[slot]) for slot in sorted(payload)},
        **({"tables": statement_tables(payload)} if proof_type == "tpu_stark" else
           {"shards": payload["shards"]}),
        **({"evm_covered": payload["evm"]["covered"], "evm_total": payload["evm"]["total"]}
           if "evm" in payload else {}),
        "eager_quotient": True,
        "jax_cpu_prove_seconds": seconds,
        "jax_cpu_verify_seconds": verify_seconds,
    }


class small_queries:
    """NUM_QUERIES = ``SMALL_QUERIES`` in the JAX prover and verifier for
    the duration of the block (the verifier imports the constant)."""

    def __enter__(self):
        from raiko_tpu.stark import prover, verifier

        self.saved = prover.NUM_QUERIES, verifier.NUM_QUERIES
        prover.NUM_QUERIES = verifier.NUM_QUERIES = SMALL_QUERIES

    def __exit__(self, *exc):
        from raiko_tpu.stark import prover, verifier

        prover.NUM_QUERIES, verifier.NUM_QUERIES = self.saved


def _outer_shapes(outer) -> list:
    return [[int(p.log_n), int(p.width)] for p in outer]


def golden_recursion_fib() -> dict:
    from raiko_tpu.stark import prover, recursion, verifier
    from raiko_tpu.stark.airs.fib import FibAir
    from raiko_tpu.stark.serde import proof_to_dict

    os.environ.pop("RAIKO_EAGER_QUOTIENT", None)
    with small_queries():
        air = FibAir()
        trace, publics = FibAir.trace(RECURSION_FIB_LOG_N)
        inner = prover.prove(air, trace, publics)
        table = recursion.InnerTable(air, RECURSION_FIB_LOG_N, publics)
        t0 = time.perf_counter()
        outer = recursion.prove_recursion([[table]], [[inner]])
        seconds = time.perf_counter() - t0
        if not recursion.verify_recursion([[table]], outer):
            raise SystemExit("recursion_fib: the JAX package's verifier rejects its own proof")
    outer_d = [proof_to_dict(p) for p in outer]
    return {
        "case": "recursion_fib",
        "inputs": {"log_n": RECURSION_FIB_LOG_N, "a": 1, "b": 1, "num_queries": SMALL_QUERIES},
        "inner_sha256": _sha(proof_to_dict(inner)),
        "sha256": _sha(outer_d),
        "proof_bytes": len(json.dumps(outer_d, sort_keys=True)),
        "outer_tables": _outer_shapes(outer),
        "roots": [d["trace_root"] for d in outer_d],
        "jax_cpu_prove_seconds": seconds,
    }


def golden_seal_transcript() -> dict:
    from raiko_tpu.provers import seal
    from raiko_tpu.provers.tpu_stark import prove_transcript

    os.environ.pop("RAIKO_EAGER_QUOTIENT", None)
    payload = prove_transcript(SHARD_IH)
    t0 = time.perf_counter()
    s = seal.prove_block_seal(payload)
    seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    if not seal.verify_block_seal(payload, s):
        raise SystemExit("seal_transcript: the JAX package's verifier rejects its own seal")
    verify_seconds = time.perf_counter() - t0
    return {
        "case": "seal_transcript",
        "inputs": {"instance_hash": SHARD_IH.hex()},
        "payload_sha256": _sha(payload),
        "sha256": _sha(s),
        "proof_bytes": len(json.dumps(s, sort_keys=True)),
        "shapes": s["shapes"],
        "outer_tables": [[d["log_n"], d["width"]] for d in s["outer"]],
        "jax_cpu_prove_seconds": seconds,
        "jax_cpu_verify_seconds": verify_seconds,
    }


def golden_shard_recursive(case: str, small: bool) -> dict:
    import contextlib

    from raiko_tpu.provers import tpu_shard

    os.environ.pop("RAIKO_EAGER_QUOTIENT", None)
    with small_queries() if small else contextlib.nullcontext():
        t0 = time.perf_counter()
        payload = tpu_shard.prove_sharded_recursive(SHARD_IH)
        seconds = time.perf_counter() - t0
        t0 = time.perf_counter()
        if not tpu_shard.verify_sharded_recursive(payload):
            raise SystemExit(f"{case}: the JAX package's verifier rejects its own payload")
        verify_seconds = time.perf_counter() - t0
    return {
        "case": case,
        "inputs": {"instance_hash": SHARD_IH.hex(), "shard_blocks": tpu_shard.SHARD_BLOCKS,
                   "num_queries": SMALL_QUERIES if small else None},
        "sha256": _sha(payload),
        "proof_bytes": len(json.dumps(payload, sort_keys=True)),
        "boundaries": payload["boundaries"],
        "outer_tables": [[d["log_n"], d["width"]] for d in payload["outer"]],
        "jax_cpu_prove_seconds": seconds,
        "jax_cpu_verify_seconds": verify_seconds,
    }


PAYLOAD_CASES = {
    "containment_chain": golden_containment_chain,
    "evm_call_tree": golden_evm_call_tree,
    "block_10tx": golden_block_10tx,
    "block_10tx_evm": lambda: golden_block_10tx("block_10tx_evm", BLOCK_EVM_ARGS),
    "recursion_fib": golden_recursion_fib,
    "seal_transcript": golden_seal_transcript,
    "shard_recursive_q4": lambda: golden_shard_recursive("shard_recursive_q4", True),
    "shard_recursive": lambda: golden_shard_recursive("shard_recursive", False),
    "shard_block_10tx": lambda: golden_block_10tx("shard_block_10tx", SHARD_BLOCK_ARGS, "tpu_shard"),
}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("cases", nargs="*", help="cases to write (default: all)")
    args = parser.parse_args(argv)
    if os.environ.get("PYTHONHASHSEED") != HASH_SEED:
        os.execve(sys.executable, [sys.executable, os.path.abspath(__file__), *(argv or sys.argv[1:])],
                  {**os.environ, "PYTHONHASHSEED": HASH_SEED})
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    cases = _cases()
    names = args.cases or list(cases) + list(PAYLOAD_CASES)
    unknown = sorted(set(names) - set(cases) - set(PAYLOAD_CASES))
    if unknown:
        raise SystemExit(f"unknown cases {unknown}; known: {sorted(cases) + sorted(PAYLOAD_CASES)}")
    os.makedirs(GOLDEN, exist_ok=True)
    for name in names:
        golden = PAYLOAD_CASES[name]() if name in PAYLOAD_CASES else make_golden(name, *cases[name])
        path = os.path.join(GOLDEN, f"stark_{name}.json")
        with open(path, "w") as f:
            json.dump(golden, f, sort_keys=True)
            f.write("\n")
        print(f"{name}: {golden['sha256']} ({golden.get('proof_bytes', '-')} bytes, "
              f"{golden['jax_cpu_prove_seconds']:.1f} s) -> {os.path.relpath(path, ROOT)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
