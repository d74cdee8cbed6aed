#!/usr/bin/env python3
"""Write the STARK proof goldens under tests/golden/ with the JAX package.

    JAX_PLATFORMS=cpu python tools/make_stark_goldens.py            # every case
    JAX_PLATFORMS=cpu python tools/make_stark_goldens.py fib affine # some

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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("cases", nargs="*", help="cases to write (default: all)")
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    cases = _cases()
    names = args.cases or list(cases)
    unknown = sorted(set(names) - set(cases))
    if unknown:
        raise SystemExit(f"unknown cases {unknown}; known: {sorted(cases)}")
    os.makedirs(GOLDEN, exist_ok=True)
    for name in names:
        golden = make_golden(name, *cases[name])
        path = os.path.join(GOLDEN, f"stark_{name}.json")
        with open(path, "w") as f:
            json.dump(golden, f, sort_keys=True)
            f.write("\n")
        print(f"{name}: {golden['sha256']} ({golden['proof_bytes']} bytes, "
              f"{golden['jax_cpu_prove_seconds']:.1f} s) -> {os.path.relpath(path, ROOT)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
