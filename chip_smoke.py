#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``raiko_tpu_torch``).

    python3 chip_smoke.py             # the smoke run below
    python3 chip_smoke.py --profile DIR   # where a commitment's and a request's time goes
    python3 chip_smoke.py --verify KIND PATH   # one payload file's verification (the run starts these)

Needs one CUDA card and the repository checkout around this file.  JAX and
the JAX package (``raiko_tpu``) are refused before anything is imported, so
an import of either anywhere on the port's path fails the run.  Each phase
prints one JSON line; any failure raises and exits non-zero.

1. device: the card's name and power limit, as nvidia-smi reports them;
2. build: compile the CUDA sources under raiko_tpu_torch/csrc with nvcc,
   one process per source, all started together;
3. kernels: each kernel against its plain PyTorch version on the card, bit
   for bit (tolerance 0: field arithmetic is exact), at its path's shapes,
   with both times and the least time the card could take (bound):
   B1 ec_add at M = 131,072 (recorded) and each of its two layouts at the
   served MSM's widths 256 to 131,072 (timed as CUDA graphs of launches)
   and at M = 1, 5, 33, 257 and 16,385, with P + P, P + (-P), P + O, O + Q
   and O + O among the pairs; B2 ec_weighted_fold at J = 256, B = 1 and 4
   (timed, with the microseconds per Horner step), and at J = 1, 2 and
   B = 33, with identities and repeated points; B4 shamir_ladder at
   B = 128 and 101 real signatures (timed, with the microseconds per ladder
   iteration), 1, 33 and 257, with lanes whose indices are all 0, 1 or 2;
   B5 ntt at 4,160 x 4,096
   and intt at 4,160 x 1,024 (the keccak chunk's LDE and interpolation),
   both at 64 x 2^14 and 1 x 2^20, with the round trip, and both at every
   size from 2 to 2^24 and at batches 1, 3 and 4,161 of 2^10 and 2^12, in
   place too; B5 with its coset prologue (ntt_coset) at the keccak chunk's
   4,160 x 1,024 coefficients to 4,096 points (recorded), and at blowups
   1-3 of 2^10, 2^12 and 2^13 coefficients;
   poseidon2_hash_rows at 4,096 rows x 4,160 columns (the LDE's transpose,
   recorded) and the flagship's 1,024 x 48, and at 1, 3, 33 and 4,101 rows
   of widths 1, 7, 8, 9, 48 and 200, contiguous and transposed;
   poseidon2_merkle (the whole tree in one launch) over 4,096 leaves
   (recorded, with the microseconds per level) and over 1, 2, 4, 64, 128,
   256, 2^16 and 2^20; poseidon2_compress at 2,048 pairs.  B5, ntt_coset,
   poseidon2_merkle and poseidon2_compress record the card's time per call
   as a CUDA graph of calls (below about 0.05 ms the host's cost per call
   is longer than the kernel), their CUDA-event means beside it;
4. ops: the ops entry points that reach B3, B6, the Keccak and SHA-256
   kernels, B5 without its prologue and poseidon2_compress, counts reset
   just before and all six positive after: B3
   ec_double at M = 131,072 (affine points, Z != 1, identities), B6
   ntt_mxu and B5's ntt at 64 x 2^14 and on the keccak chunk's LDE input
   (4,160 x 4,096), poseidon2.compress on 2,048 pairs of digests,
   keccak_f1600_batch on 8,192 states, keccak256_batch over 8,192
   messages of 32-532 bytes, sha256_batch over 8,192 48-byte commitments
   and 1,024 messages of 0-299 bytes; then each kernel against its plain
   version, bit for bit, with both times and its bound, and the digests
   against the host's.  Keccak-f (also at 131,072 states) and SHA-256
   (also at 131,072 commitments) are timed as CUDA graphs, event means
   beside them, with the layout each width ran in and the longest
   dependent chain beside the bound; both in every layout at 1 to 40,961
   items, ragged and equal block counts, and at the padding edges (one
   ``kernel_edges`` line each).  B3 also at 256, 4,096, 16,384 and 131,072 points
   (CUDA graphs, event means beside them) and at M = 1, 5, 33 and 4,099;
   B6 also equal to B5's ntt at both shapes, timed as CUDA graphs beside
   B5 and beside torch._int_mm of its two stacked digit products (the
   product half's yardstick), and at every size 2^0 to 2^14 against its
   plain version and B5; then the run fails unless B6's built kernels
   hold IMMA (int8 tensor-core) instructions and no IDP (__dp4a), by
   ``cuobjdump -sass`` (started after the build, beside the phases);
5. kzg: the zero blob's versioned hash against its published value, and a
   random full blob's commitment and opening proof against the host path,
   the proof passing verify_kzg_proof;
6. serve: the port's proof service (``raiko_tpu_torch.host.cli --device
   cuda``) answers a v2 ``native`` proof request for one 100-tx taiko_a7
   blob block from the port's chain simulator (three before the block
   proof of phase 10 took the run's time); the launch counts are reset
   just before the request and B1, B2 and B4 must all be positive after;
7. stark: the STARK trace commitment of the keccak sponge chunk (1,024 rows
   x 4,160 columns, blowup 4) through ``commit_step`` on the card, counts
   reset just before and after them exactly one launch each of B5's intt,
   B5 with its coset prologue and poseidon2_hash_rows, one or two of
   poseidon2_merkle, and none of the per-level compression; its root equal
   to the same step's plain path (CPU tensors); its time by stage, the
   upload apart from the conversion; the flagship (256 x 48) root equal to
   the JAX step's constant;
8. stark_prove: whole STARK proofs through the port's ``prove`` and
   ``verify`` on the card: the fib AIR (log_n 6), the Poseidon2 transcript
   AIR and the keccak sponge chunk (23 permutations of seeded messages,
   1,024 rows x 4,160 columns, 3,461 fixed columns, 4 quotient chunks),
   each from the inputs of its JAX golden (``tests/golden/stark_*.json``,
   written by ``tools/make_stark_goldens.py``); each proof's canonical JSON
   must hash to the golden's sha256 and pass the port's verifier, and the
   counts, reset just before each proof, must show B5's intt and
   ntt_coset, poseidon2_hash_rows and poseidon2_merkle launched; its time by
   stage (each stage ends with a device synchronisation; ``transcript`` is
   the host's hashing of the Fiat-Shamir transcript between stages), its
   launches and its peak device memory; the keccak chunk is proven twice,
   cold and warm, the warm proof checked against the golden only;
9. check: the port's orchestrator proves each served block again on its
   host path (``device=None``: host MSM, per-tx sender recovery, no
   kernel), and each served ``input`` and ``kzg_proof`` must equal its
   result, the proof verifying;
10. block_prove: the ``tpu_stark`` backend under the default config
   (prover args ``proof_cache: false`` only: every statement, the EVM
   frame statement and its prestate binding among them).  First the host
   Poseidon2 that the transcript and the verifier run: the C library
   (``ops/poseidon2_host.py``) must load and equal ``host_permute`` (one
   ``host_poseidon2`` line: which permutation ran, microseconds per
   permutation of each).  Then the 10-tx block of
   ``tests/golden/stark_block_10tx_evm.json`` (``build_chain``'s mix)
   through ``Raiko(..., "cuda").prove``, whose payload's sha256, each
   statement's sha256, ``input`` and ``kzg_proof`` must equal the JAX
   golden's, with all 9 frame candidates covered and a ``prestate`` slot,
   which ``verify_payload(..., "cuda")`` must accept and, with the first
   frame's ``gas_f`` lowered by one, reject, whose proof must launch B5's
   intt and ntt_coset, poseidon2_hash_rows and poseidon2_merkle, and whose
   transcript and verification must call the C library; then a 100-tx
   block served as a v2 ``tpu_stark`` request (its depth cut to
   ``BLOCK_SERVED_FRAMES`` call trees, printed) and as a ``native`` one
   through the port's server, counts reset just before each: the
   ``tpu_stark`` request must end in ``success`` with its ``evm`` and
   ``prestate`` statements, its payload pass ``verify_payload`` (in a
   process of its own, ``chip_smoke.py --verify``, beside phase 11: a
   ``block_verify`` line at the end), its
   ``kzg_proof`` equal the native request's and its ``input`` the
   instance hash of the port's host path (``Raiko(..., None).get_output``),
   and B1, B2, B4, intt, ntt_coset, poseidon2_hash_rows and
   poseidon2_merkle must all have launched; one ``statement`` line per
   statement (tables, wall seconds, the prover's stage times and the
   transcript's, the host time outside them, launches; the ``evm`` line
   its trees, covered/total, its share of the block and its quotient's
   share of its trees' stage time) and one
   ``block_prove`` line per block (seconds, verification seconds, peak
   device memory, payload bytes); no JAX or ``raiko_tpu`` module was
   loaded.  Each statement's device time is ``--profile``'s: the
   profiler's bookkeeping would lengthen this run;
11. seal: the recursion seal and the ``tpu_shard`` backend.  The seal of
   the Poseidon2 transcript payload of ``bytes(range(32))`` (one inner
   group; the outer circuit 65,536 gate rows x 12 columns and 4,096
   Poseidon2 call rows x 705) through ``seal.prove_block_seal(...,
   "cuda")``, whose sha256 must equal the JAX golden's
   (``tests/golden/stark_seal_transcript.json``), which
   ``verify_block_seal(..., "cuda")`` must accept whole and stripped and
   reject with another instance hash or shape vector, and whose artifact
   must pass the port's on-chain verifier (``ChainSim`` with
   ``install_proof_verifier``, ``onchain.verify_proof_onchain``) and fail
   under a zero journal; then ``tpu_shard.prove_sharded_recursive`` of the
   same instance hash at production parameters, equal to its golden
   (``stark_shard_recursive.json``), verified, a changed boundary
   rejected.  Both run under torch.profiler for the outer quotient's
   launches, the counts set to 0 just before each, and must launch B5's
   intt and ntt_coset, poseidon2_hash_rows and poseidon2_merkle.  Then,
   through the port's server: the golden's 10-tx block as a ``tpu_stark``
   request with ``"seal": true, "seal_max_tables": 1`` (its trees cut to
   ``SEALED_FRAMES``, printed), whose payload must carry a seal of one
   group with tables left unsealed and pass ``verify_payload``; a 100-tx
   block as a ``tpu_shard`` request with ``"recursion": true`` (its trees
   cut to ``SHARD_SERVED_FRAMES``, printed; ``shard_workers``
   ``SHARD_WORKERS``, printed), whose payload must pass
   ``verify_block_sharded`` (in a process of its own beside the rest of
   the phase), bind the served instance hash, and whose
   ``kzg_proof`` must equal the ``native`` request's, the counts set to 0
   just before it and B1, B2, B4, intt, ntt_coset, poseidon2_hash_rows and
   poseidon2_merkle all launched; a ``tee`` request, signed by the
   instance it bootstrapped, which then registers through
   ``install_sgx_verifier``; and a ``remote`` request forwarded to a
   second port server, equal to the ``native`` one.  One ``seal`` line
   and one ``tpu_shard`` line: the circuit's, the proof's and the
   verification's seconds, the prover's stages, the outer tables, the
   launches by kernel, the outer quotient's launches and device ms, peak
   device memory, the artifact's bytes, ``shard_workers``; one
   ``sealed_block`` line.

The kernels line gives each kernel's launches per transcript seal and per
served ``tpu_shard`` request beside the earlier paths'.  The two served
100-tx payloads are verified by ``chip_smoke.py --verify KIND PATH``
processes started as each payload arrives (verification is mostly host
work, as long as the proof), whose results the run waits for; the run
stops them if it fails first.

The run re-executes itself under PYTHONHASHSEED=0 first: the state-trie
statement's message order follows Python's string hashing, in the JAX
package as in the port, and the JAX golden was made under that seed.  The
last two lines are the kernels' summary and the device line.

``--profile DIR`` runs phases 1-2, then times the stages of one dense blob
commitment, and puts five commitments, one warm keccak-chunk STARK proof
(device and wall time of each prover stage), each of three
served-path requests (through the port's orchestrator) and the first of
those blocks proven as a ``tpu_stark`` request under the default config
at ``BLOCK_SERVED_FRAMES`` call trees, one tree after another (each
statement's device and wall time; its quotient stage's wall and device
time and kernel launches, per EVM tree too) under
torch.profiler: device time against wall time, launches, the top kernels
and the device time of each of the port's own kernels.  The profiler's tables
go to DIR/profile_*.txt.
"""

from __future__ import annotations

import sys

# The card's machine may have JAX installed, and the checkout holds the JAX
# package.  Refuse both before anything is imported: a None entry makes the
# import raise ModuleNotFoundError (and ``importlib.util.find_spec`` report
# it absent), so nothing on the port's path can reach either unnoticed.
# Only the top-level names: ``raiko_tpu_torch`` still imports.
REFUSED = ("jax", "jaxlib", "raiko_tpu")
for _name in REFUSED:
    sys.modules[_name] = None

import concurrent.futures
import json
import os
import socket
import subprocess
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 20240613
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA's data sheet)
IMAD_PER_SM_PER_CLOCK = 64  # 32-bit integer multiply(-add)s, compute capability 9.0
# 32-bit integer add, shift, funnel shift and bitwise and/or/xor: 64 per SM
# per clock each at compute capability 9.0 (CUDA C++ Programming Guide,
# "Arithmetic Instructions" throughput table)
LOGIC_PER_SM_PER_CLOCK = 64
INT8_MACS_PER_S = 1979e12 / 2  # H100 SXM dense int8 tensor cores: 1,979 TOP/s, 2 per MAC
# the JAX flagship step's root on the (256, 48) default_rng(0) trace
# (__graft_entry__.entry()), Montgomery form
FLAGSHIP_ROOT = [1103079180, 844803899, 311541641, 1509639592,
                 1993886486, 1956685620, 1597694602, 1842386190]
KECCAK_ROWS, KECCAK_COLS = 1024, 4160  # provers/tpu_stark.py:323, stark/airs/keccak_air.py:43-45
# B1's launch widths in a served blob MSM: the bucket sums' tree levels run
# about 63,000 down to 80 pairs, the combine 16,384 down to 256
B1_WIDTHS = (256, 1024, 4096, 16384, 65536, 131072)
# Keccak-f and SHA-256 at a full card: 4,096 warps of one thread an item
HASH_WIDE = 131072
B3_WIDTHS = (256, 4096, 16384, 131072)  # B3's timed widths
SOURCES = {
    "ec_add": ("raiko_tpu_torch/csrc/bls12_381_g1.cu", "raiko_tpu/ops/ec_pallas.py:244"),
    "ec_weighted_fold": ("raiko_tpu_torch/csrc/bls12_381_g1.cu", "raiko_tpu/ops/ec_pallas.py:302"),
    "shamir_ladder": ("raiko_tpu_torch/csrc/secp256k1_ladder.cu", "raiko_tpu/ops/secp_pallas.py:254"),
    "ntt": ("raiko_tpu_torch/csrc/babybear_ntt.cu", "raiko_tpu/ops/ntt_pallas.py:180"),
    "intt": ("raiko_tpu_torch/csrc/babybear_ntt.cu", "raiko_tpu/ops/ntt_pallas.py:194"),
    # B5 with the LDE's coset scaling and zero-pad on load
    "ntt_coset": ("raiko_tpu_torch/csrc/babybear_ntt.cu", "raiko_tpu/ops/ntt_pallas.py:180"),
    # no Pallas kernel: the XLA sponge and compression they replace
    "poseidon2_hash_rows": ("raiko_tpu_torch/csrc/babybear_poseidon2.cu", "raiko_tpu/ops/poseidon2.py:316"),
    "poseidon2_compress": ("raiko_tpu_torch/csrc/babybear_poseidon2.cu", "raiko_tpu/ops/poseidon2.py:177"),
    "poseidon2_merkle": ("raiko_tpu_torch/csrc/babybear_poseidon2.cu", "raiko_tpu/ops/merkle.py:22"),
    "ec_double": ("raiko_tpu_torch/csrc/bls12_381_g1.cu", "raiko_tpu/ops/ec_pallas.py:334"),
    "ntt_mxu": ("raiko_tpu_torch/csrc/babybear_ntt_mxu.cu", "raiko_tpu/ops/ntt_mxu.py:183"),
    # XLA in the JAX package
    "keccak_f1600": ("raiko_tpu_torch/csrc/keccak_f1600.cu", "raiko_tpu/ops/keccak.py:65"),
    "sha256_compress": ("raiko_tpu_torch/csrc/sha256.cu", "raiko_tpu/ops/sha256.py:54"),
}
SERVED = ("ec_add", "ec_weighted_fold", "shamir_ladder")
STARK = ("intt", "ntt_coset", "poseidon2_hash_rows", "poseidon2_merkle")
OPS = ("ec_double", "ntt_mxu", "keccak_f1600", "sha256_compress", "ntt", "poseidon2_compress")
# the proofs of phase stark_prove, each against its JAX golden
PROOF_CASES = ("fib", "transcript", "keccak_chunk")
# phase block_prove: the tpu_stark backend under the default config (every
# statement, the EVM frames and their prestate binding among them), on the
# golden's 10-tx block and a served 100-tx block; the served block must
# launch every kernel here
BLOCK_GOLDEN = "block_10tx_evm"
BLOCK_ARGS = {"proof_cache": False}
BLOCK_SERVED_TXS = 100
# a cut of depth: the served block proves its first BLOCK_SERVED_FRAMES
# covered call trees (the default max_evm_frames is 64; the block has 90
# candidates), so that the run, phase seal included, stays inside its
# time: at 64 trees the request took 369 s and its verification 391 s
# (NVIDIA H100 80GB HBM3, 700 W), about 4.7 s and 5.2 s a tree
BLOCK_SERVED_FRAMES = 2
BLOCK_SERVED_ARGS = {**BLOCK_ARGS, "max_evm_frames": BLOCK_SERVED_FRAMES}
BLOCK = SERVED + STARK
# phase seal: the recursion seal of the transcript payload and the
# recursively aggregated transcript shards, each against its JAX golden,
# then a served tpu_shard block (recursion on), a sealed tpu_stark block,
# a tee and a remote request
SEAL_IH = bytes(range(32))  # the instance hash of both goldens' payloads
SEAL_GOLDEN = "seal_transcript"
SHARD_GOLDEN = "shard_recursive"
# a cut of depth: the served tpu_shard block proves its first
# SHARD_SERVED_FRAMES covered call trees as shards; on one worker
# (SHARD_WORKERS), which proved this block in 0.72x the time of the
# default pool of 4 and the same payload (tools/time_shard_workers.py on
# an NVIDIA H100 80GB HBM3 at 700 W: 131.5-132.3 s against 174.6-192.8 s)
SHARD_SERVED_FRAMES = 1
SHARD_WORKERS = 1
SHARD_SERVED_ARGS = {"proof_cache": False, "recursion": True, "max_evm_frames": SHARD_SERVED_FRAMES,
                     "shard_workers": SHARD_WORKERS}
# the sealed tpu_stark block: the golden's 10-tx block, its trees cut to
# SEALED_FRAMES, only the transcript group sealed (seal_max_tables 1: a
# wide keccak group's seal takes far longer than the run has)
SEALED_TXS = 10
SEALED_FRAMES = 1
SEALED_ARGS = {"proof_cache": False, "seal": True, "seal_max_tables": 1, "max_evm_frames": SEALED_FRAMES}
# The state-trie statement's message order follows the reference
# preflight's set of accessed accounts, whose order follows Python's string
# hashing: the run re-executes itself under the golden's PYTHONHASHSEED
# (tools/make_stark_goldens.py), so the 10-tx payload can equal the JAX one.
HASH_SEED = "0"


def pin_hash_seed(argv: list[str]) -> None:
    """Re-execute `argv` under PYTHONHASHSEED=HASH_SEED unless already so."""
    if os.environ.get("PYTHONHASHSEED") != HASH_SEED:
        os.execve(sys.executable, [sys.executable, *argv], {**os.environ, "PYTHONHASHSEED": HASH_SEED})


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card over `reps` calls, after one
    warm-up call, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card when `reps` calls replay as one
    CUDA graph (best of three replays): back-to-back launches without the
    host's cost per call, for kernels shorter than that cost."""
    import torch

    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def once_ms(fn):
    """(result, milliseconds) of one synchronised call."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def max_abs_err(a, b) -> int:
    """Largest difference between two int32 tensors of u32 words."""
    return int(((a.long() & 0xFFFFFFFF) - (b.long() & 0xFFFFFFFF)).abs().max().item())


class Card:
    """The card's peak rates, for the least time a kernel's work could take:
    the largest of its bytes (each input read once, each output written
    once) over the device-memory rate, its 32-bit integer multiplies over
    the IMAD rate and its 32-bit logic/add operations over their rate, both
    at the card's maximum SM clock, and its int8 multiply-adds over the
    dense int8 tensor-core rate."""

    def __init__(self, smi: str, max_sm_mhz: float):
        import torch

        self.smi = smi
        self.sms = torch.cuda.get_device_properties(0).multi_processor_count
        self.imad_per_s = self.sms * IMAD_PER_SM_PER_CLOCK * max_sm_mhz * 1e6
        self.logic_per_s = self.sms * LOGIC_PER_SM_PER_CLOCK * max_sm_mhz * 1e6
        self.hz = max_sm_mhz * 1e6

    def chain_ms(self, dependent: float, exchanges: float = 0.0) -> float:
        """Milliseconds of a dependent chain of `dependent` integer
        instructions and `exchanges` warp shuffles at the maximum SM clock."""
        return (dependent * DEPENDENT_CLOCKS + exchanges * SHFL_CLOCKS) / self.hz * 1e3

    def bound(self, nbytes: float, mults: float, int8_macs: float = 0.0,
              logic: float = 0.0) -> tuple[float, str]:
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = max(mults / self.imad_per_s, int8_macs / INT8_MACS_PER_S, logic / self.logic_per_s) * 1e3
        return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def phase_device() -> Card:
    import torch

    def smi(query: str) -> str:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]

    name_power = smi("name,power.limit")
    print(name_power, flush=True)
    max_sm_mhz = float(smi("clocks.max.sm").split()[0])
    card = Card(name_power, max_sm_mhz)
    emit("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda, nvidia_smi=name_power,
         max_sm_mhz=max_sm_mhz, sms=card.sms, imad_per_s=card.imad_per_s)
    return card


def mxu_sass(lib_path: str) -> dict:
    """{B6 kernel: its counts of IMMA (int8 tensor-core) and IDP (__dp4a)
    instructions} in the built library, from ``cuobjdump -sass``."""
    from raiko_tpu_torch import kernels

    cuobjdump = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True, check=True).stdout
    counts: dict[str, dict[str, int]] = {}
    name = None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
        elif name is not None and "mxu" in name:
            c = counts.setdefault(name, {"IMMA": 0, "IDP": 0})
            c["IMMA"] += "IMMA" in line
            c["IDP"] += "IDP" in line
    return counts


def phase_build():
    from raiko_tpu_torch import kernels

    t0 = time.perf_counter()
    kernels.library()
    with open(kernels.BUILD_INFO["log"]) as f:
        ptxas = [ln.strip() for ln in f if "entry function" in ln or "registers" in ln or "spill" in ln]
    emit("build", seconds=time.perf_counter() - t0, nvcc_seconds=kernels.BUILD_INFO["seconds"],
         ptxas=ptxas)
    # cuobjdump takes about 10 s of the host: it runs beside the phases that
    # follow, and check_mxu_sass waits for it
    pool = concurrent.futures.ThreadPoolExecutor(1)
    pending = pool.submit(mxu_sass, kernels.BUILD_INFO["path"])
    pool.shutdown(wait=False)
    return pending


def check_mxu_sass(pending) -> None:
    """Fail unless B6's built kernels hold IMMA and no IDP instructions."""
    sass = pending.result()
    emit("mxu_sass", kernels=sass)
    if not sass or any(c["IMMA"] == 0 or c["IDP"] for c in sass.values()):
        raise AssertionError(f"B6's kernels must run on the int8 tensor cores (IMMA) and not __dp4a: {sass}")


def check_kernel(card: Card, results: dict, name: str, shape, got, want, plain_ms: float, ms: float | None,
                 nbytes: float, mults: float, record: bool = True, int8_macs: float = 0.0,
                 logic: float = 0.0, **extra) -> None:
    """Emit one kernel's comparison; raise unless it equals its plain version."""
    import torch

    equal = bool(torch.equal(got, want))
    err = max_abs_err(got, want) if got.numel() else 0
    bound_ms, bound_by = card.bound(nbytes, mults, int8_macs, logic)
    emit("kernel", name=name, shape=list(shape), equal=equal, max_abs_err=err, ms=ms, plain_ms=plain_ms,
         bound_ms=bound_ms, bound_by=bound_by, **extra)
    if not equal:
        raise AssertionError(f"{name} at {list(shape)} differs from its plain version")
    if record:
        # `ms` is the card's time per call from a CUDA graph where the caller
        # also gives `events_ms` (the CUDA-event mean, the host's cost per
        # call included), else that event mean itself
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "timing": "graph" if "events_ms" in extra else "events",
                         "events_ms": extra.get("events_ms", ms)}


def check_edges(name: str, cases) -> None:
    """Emit one line for a kernel's edge shapes, (label, got, want) each;
    raise unless every one equals its plain version."""
    import torch

    bad = [label for label, got, want in cases if not torch.equal(got, want)]
    err = max((max_abs_err(got, want) for _, got, want in cases if got.numel()), default=0)
    emit("kernel_edges", name=name, cases=len(cases), equal=not bad, max_abs_err=err, differ=bad)
    if bad:
        raise AssertionError(f"{name} differs from its plain version at {bad}")


def with_special_sums(p, q, upto: int) -> None:
    """Make pair i < upto of p + q, by i mod 6: a general sum (0), P + P,
    P + (-P), P + O, O + Q or O + O (O the identity)."""
    import torch

    from raiko_tpu_torch import convert
    from raiko_tpu_torch.fields.limbs import FP
    from raiko_tpu_torch.kzg import curve

    kind = torch.arange(min(upto, p.shape[0]), device=p.device) % 6
    at = lambda k: torch.nonzero(kind == k).squeeze(1)
    inf = convert.pack32(curve.identity((), p.device))
    q[at(1)] = p[at(1)]
    if at(2).numel():
        neg = convert.unpack32(p[at(2)])
        neg[:, 1] = FP.neg(neg[:, 1])
        q[at(2)] = convert.pack32(neg)
    q[at(3)] = inf
    p[at(4)] = inf
    p[at(5)] = inf
    q[at(5)] = inf


# 32-bit multiplies of one CIOS product of N-limb Montgomery values:
# per limb of b, N 64-bit products a_j b_i, one m, N 64-bit products m p_j.
def _fmul(n: int) -> int:
    return n * (4 * n + 1)


ADD_FMULS, DOUBLE_FMULS = 12, 8  # RCB15 Alg. 7 / Alg. 9 as csrc/field32.cuh runs them
BB_MUL = 4  # BabyBear Montgomery product: lo, hi, m, umulhi(m, p)
PERM_MULS = BB_MUL * ((8 * 16 * 4) + 13 * (4 + 16))  # Poseidon2: 772 products
# The fewest 32-bit instructions a function needs at compute capability 9.0,
# where LOP3 (any boolean function of three inputs) and IADD3 (a sum of
# three) are one instruction each at the logic rate, a 32-bit rotation is
# one funnel shift and a 64-bit one two.
# Keccak-f, per round on the two 32-bit halves of each lane: theta's 5
# column parities 2 LOP3 each (20), the 5 rotations of a parity by 1 (10),
# a ^ c[x-1] ^ rot(c[x+1]) one LOP3 per lane (50); rho's 24 rotations (48;
# no offset is 32); chi's a ^ (~b & c) one LOP3 per lane (50); iota (2):
# 180 a round, 90 per 64-bit lane word.
KECCAK_PERM_OPS = 24 * (2 * 2 * 5 + 2 * 5 + 2 * 25 + 2 * 24 + 2 * 25 + 2)
# Clocks from one instruction to the next that depends on it, on an NVIDIA
# H100 80GB HBM3 at 700 W (tools/time_hashes.py's probe): LOP3, SHF
# and IADD3 about 4.6, SHFL 24.5
DEPENDENT_CLOCKS, SHFL_CLOCKS = 4.56, 24.5
# A permutation's longest dependent path: per round theta's column parity
# (2 LOP3), its rotation by 1 (SHF), the XOR with D (LOP3), rho (SHF), chi
# (LOP3) and iota (LOP3); the pair layout adds two exchanges a round
# (theta's rotation and an odd rho offset swap the halves)
KECCAK_CHAIN, KECCAK_PAIR_EXCHANGES = 24 * 7, 24 * 2
# SHA-256 per block, the e-path of each round: Σ1's rotations (SHF) and
# their LOP3, t1 (IADD3), e = d + t1
SHA_CHAIN = 64 * 4
# SHA-256 per block: 64 rounds of 14 (Σ1 and Σ0 each 3 rotations and a
# LOP3, Ch and Maj a LOP3 each, t1 = h + Σ1 + Ch + K + W two IADD3,
# e = d + t1 and a = t1 + Σ0 + Maj one each), 48 schedule words of 10 (σ0
# and σ1 each 3 shifts and a LOP3, their sum with w16 and w7 two IADD3),
# and the 8 adds of the chaining value
SHA_BLOCK_OPS = 64 * 14 + 48 * 10 + 8
# B6's mod-p recombination of one output of one pass, at its fewest: the
# seven diagonal sums S_s + 2^23 (each < 2^24) add, shifted by 8s, into one
# integer V < 2^73 by shifts and adds alone; V's three 32-bit words v_i fold
# with the constants 2^(32(i+1)) mod p (three 32 x 32 -> 64-bit products of
# two multiplies each) into T < 2^65, and one Montgomery step (two
# multiplies) gives T / 2^32 = V mod p
MXU_RECOMB_MULS = 3 * 2 + 2


def phase_kernels(card: Card, setup32) -> dict:
    import numpy as np
    import torch

    from raiko_tpu_torch import convert
    from raiko_tpu_torch.kzg import curve
    from raiko_tpu_torch.ops import ec_cuda, secp, secp_cuda
    from raiko_tpu_torch.utils import secp256k1 as host

    rng = np.random.default_rng(SEED)
    pick = lambda k: setup32[torch.as_tensor(rng.integers(0, setup32.shape[0], k), device="cuda")]
    results = {}

    # B1 at the blob MSM's width (recorded, through ec_add): p affine
    # (Z = 1), q general projective, with runs of the special sums
    m = 131_072
    p = pick(m)
    q = ec_cuda.ec_add_plain(pick(m), pick(m))
    with_special_sums(p, q, 384)
    got = ec_cuda.ec_add(p, q)
    want, plain_ms = once_ms(lambda: ec_cuda.ec_add_plain(p, q))
    ms = cuda_ms(lambda: ec_cuda.ec_add(p, q), 20)
    add_work = lambda k: dict(nbytes=3 * k * 144, mults=k * ADD_FMULS * _fmul(12))
    check_kernel(card, results, "ec_add", [m, 3, 12], got, want, plain_ms, ms, lanes=ec_cuda.add_lanes(m),
                 **add_work(m))
    # each layout at the widths the served MSM launches (prefixes of the same
    # pairs), timed as CUDA graphs: below one wave a launch is shorter than
    # the host's cost per call
    for k in B1_WIDTHS:
        pk, qk = p[:k], q[:k]
        for lanes in ec_cuda.ADD_LANE_CHOICES:
            got = ec_cuda.ec_add_lanes(pk, qk, lanes)
            ms = graph_ms(lambda: ec_cuda.ec_add_lanes(pk, qk, lanes), 20 if k <= 16384 else 5)
            check_kernel(card, results, "ec_add", [k, 3, 12], got, want[:k], None, ms, record=False, lanes=lanes,
                         taken_by_ec_add=lanes == ec_cuda.add_lanes(k), **add_work(k))
    # both layouts at widths that leave warps and blocks part-filled, on
    # points with Z != 1 and every sixth pair one of the special sums
    cases = []
    for k in (1, 5, 33, 257, 16_385):
        pk = ec_cuda.ec_add_plain(pick(k), pick(k))
        qk = ec_cuda.ec_add_plain(pick(k), pick(k))
        with_special_sums(pk, qk, k)
        want_k = ec_cuda.ec_add_plain(pk, qk)
        cases += [(f"M={k} lanes={lanes}", ec_cuda.ec_add_lanes(pk, qk, lanes), want_k)
                  for lanes in ec_cuda.ADD_LANE_CHOICES]
    check_edges("ec_add", cases)

    # B2: the MSM's J = 256 at batch 1 (one blob; recorded) and 4
    # (msm_multi), both timed, and the edge shapes J = 1 (the input
    # unchanged) and 2, and batch 33 (more blocks than a wave of one SM);
    # every input holds identities (as empty buckets give) and a point twice
    ident = convert.pack32(curve.identity((), "cuda"))
    for j in (256, 1, 2):
        for bsz in (1, 4, 33):
            v = pick(bsz * j).reshape(bsz, j, 3, 12).contiguous()
            v[bsz // 2, 0] = ident
            if j >= 2:
                v[0, j - 1] = v[0, j - 2]
                v[bsz - 1, j // 2] = ident
            got = ec_cuda.ec_weighted_fold(v)
            want, plain_ms = once_ms(lambda: ec_cuda.ec_weighted_fold_plain(v))
            timed = j == 256 and bsz in (1, 4)
            ms = cuda_ms(lambda: ec_cuda.ec_weighted_fold(v), 10) if timed else None
            extra = dict(product_layers=4 * (j - 1), us_per_step=ms * 1e3 / (j - 1)) if timed else {}
            check_kernel(card, results, "ec_weighted_fold", [bsz, j, 3, 12], got, want, plain_ms, ms,
                         nbytes=bsz * (j + 1) * 144, mults=bsz * (j - 1) * (ADD_FMULS + DOUBLE_FMULS) * _fmul(12),
                         record=j == 256 and bsz == 1, **extra)

    # B4: 128 real signatures (recorded; public keys against the host's) and
    # 101, the served block's lane count, both timed; 1, 33 and 257 lanes,
    # the last two with lanes whose indices are all 0, all 1 and all 2
    items = []
    for i in range(257):
        msg = rng.bytes(32)
        r, s, rec = host.sign(msg, int.from_bytes(rng.bytes(31), "big") + 1)
        items.append((msg, r, s, rec))
    _, base_np, idx_np = secp.ladder_inputs(items)
    for bsz in (128, 101, 1, 33, 257):
        base = convert.pack32(torch.as_tensor(base_np[:bsz], device="cuda"))
        idx = torch.as_tensor(np.ascontiguousarray(idx_np[:, :bsz]), device="cuda")
        if bsz in (33, 257):
            idx[:, :3] = torch.arange(3, dtype=torch.int32, device="cuda")
        got = secp_cuda.shamir_ladder(base, idx)
        want, plain_ms = once_ms(lambda: secp_cuda.shamir_ladder_plain(base, idx))
        timed = bsz in (128, 101)
        ms = cuda_ms(lambda: secp_cuda.shamir_ladder(base, idx), 10) if timed else None
        extra = dict(product_layers=2 + 4 * 256, us_per_step=ms * 1e3 / 256) if timed else {}
        if bsz == 128:
            pubs = [secp.to_affine(pt) for pt in convert.unpack32(got).cpu().numpy()]
            extra["pubkeys_match_host"] = pubs == [host.recover_pubkey(*it) for it in items[:128]]
            if not extra["pubkeys_match_host"]:
                raise AssertionError("B4 shamir_ladder's public keys differ from the host's")
        check_kernel(card, results, "shamir_ladder", [bsz, 2, 3, 8], got, want, plain_ms, ms,
                     nbytes=bsz * (192 + 1024 + 96),
                     mults=bsz * (ADD_FMULS + 256 * (ADD_FMULS + DOUBLE_FMULS)) * _fmul(8),
                     record=bsz == 128, **extra)
    return results


def _ntt_work(bsz: int, log_n: int, inverse: bool) -> tuple[float, float]:
    """(bytes, 32-bit multiplies) of one B5 launch on (bsz, 2^log_n): each
    element read once and written once (the twiddle tables are constants,
    not the transform's inputs)."""
    from raiko_tpu_torch.ops import ntt_cuda

    n = 1 << log_n
    prods = bsz * (n // 2) * log_n + (bsz * n if inverse else 0)  # butterflies, 1/N scale
    if log_n > ntt_cuda.ROW_PASS_MAX_LOG_N:
        prods += bsz * n  # cross twiddles
    return 8 * bsz * n, BB_MUL * prods


def phase_stark_kernels(card: Card) -> dict:
    """B5 (with and without its coset prologue) and the Poseidon2 kernels
    against their plain versions."""
    import numpy as np
    import torch

    from raiko_tpu_torch import convert
    from raiko_tpu_torch.fields import babybear as bb
    from raiko_tpu_torch.ops import ntt_cuda, poseidon2 as p2, poseidon2_cuda

    rng = np.random.default_rng(SEED + 2)

    def mont(shape) -> torch.Tensor:
        return convert.words_from_numpy(bb.np_to_mont(rng.integers(0, bb.P, shape, dtype=np.uint32)), "cuda")

    results = {}
    cases = [  # (name, shape, record): the keccak chunk's shapes are recorded
        ("ntt", (KECCAK_COLS, 4 * KECCAK_ROWS), True),
        ("intt", (KECCAK_COLS, KECCAK_ROWS), True),
        ("ntt", (64, 1 << 14), False), ("intt", (64, 1 << 14), False),
        ("ntt", (1, 1 << 20), False), ("intt", (1, 1 << 20), False),
    ]
    for name, shape, record in cases:
        x = mont(shape)
        kernel = getattr(ntt_cuda, name)
        plain = getattr(ntt_cuda, f"{name}_plain")
        got = kernel(x)
        want, plain_ms = once_ms(lambda: plain(x))
        ms = graph_ms(lambda: kernel(x), 10)
        events_ms = cuda_ms(lambda: kernel(x), 10)
        back = (ntt_cuda.intt if name == "ntt" else ntt_cuda.ntt)(got)
        round_trip = bool(torch.equal(back, x))
        nbytes, mults = _ntt_work(shape[0], shape[1].bit_length() - 1, name == "intt")
        check_kernel(card, results, name, shape, got, want, plain_ms, ms, nbytes, mults, record=record,
                     round_trip=round_trip, events_ms=events_ms)
        if not round_trip:
            raise AssertionError(f"{name} at {list(shape)}: the round trip does not return its input")
    # every size at batch 1, and the commitment's sizes at batches around a
    # block's rows, through the wrappers and in place (the C entry with
    # x == out)
    cases = []
    for log_n in range(1, ntt_cuda.MAX_LOG_N + 1):
        x = mont((1, 1 << log_n))
        cases.append((f"ntt 1x2^{log_n}", ntt_cuda.ntt(x), ntt_cuda.ntt_plain(x)))
        cases.append((f"intt 1x2^{log_n}", ntt_cuda.intt(x), ntt_cuda.intt_plain(x)))
    for log_n in (10, 12):
        for bsz in (1, 3, 4161):
            x = mont((bsz, 1 << log_n))
            for inverse, plain in ((False, ntt_cuda.ntt_plain), (True, ntt_cuda.intt_plain)):
                want = plain(x)
                y = x.clone()
                ntt_cuda._launch(y, y, log_n, inverse, "in place")
                cases.append((f"{'intt' if inverse else 'ntt'} {bsz}x2^{log_n}",
                              (ntt_cuda.intt if inverse else ntt_cuda.ntt)(x), want))
                cases.append((f"{'intt' if inverse else 'ntt'} {bsz}x2^{log_n} in place", y, want))
    check_edges("ntt", cases)

    # B5 with the coset prologue: the keccak chunk's LDE (recorded), then
    # blowups 1-3 of coefficient rows below, at and above one block's 2^12
    coeffs = mont((KECCAK_COLS, KECCAK_ROWS))
    got = ntt_cuda.ntt_coset(coeffs, 2, bb.GENERATOR)
    want, plain_ms = once_ms(lambda: ntt_cuda.ntt_coset_plain(coeffs, 2, bb.GENERATOR))
    ms = graph_ms(lambda: ntt_cuda.ntt_coset(coeffs, 2, bb.GENERATOR), 10)
    lde_n = KECCAK_ROWS << 2
    check_kernel(card, results, "ntt_coset", (KECCAK_COLS, KECCAK_ROWS, lde_n), got, want, plain_ms, ms,
                 nbytes=4 * KECCAK_COLS * (KECCAK_ROWS + lde_n),
                 mults=BB_MUL * KECCAK_COLS * (KECCAK_ROWS + lde_n // 2 * (lde_n.bit_length() - 1)),
                 events_ms=cuda_ms(lambda: ntt_cuda.ntt_coset(coeffs, 2, bb.GENERATOR), 10))
    cases = []
    for log_in in (10, 12, 13):
        for blowup in (1, 2, 3):
            x = mont((3, 1 << log_in))
            cases.append((f"3x2^{log_in} blowup {blowup}", ntt_cuda.ntt_coset(x, blowup, bb.GENERATOR),
                          ntt_cuda.ntt_coset_plain(x, blowup, bb.GENERATOR)))
    check_edges("ntt_coset", cases)

    # the commitment hashes the rows of the LDE's transpose: a strided view
    lde = mont((KECCAK_COLS, 4 * KECCAK_ROWS))
    rows = lde.T
    got = poseidon2_cuda.poseidon2_hash_rows(rows)
    want, plain_ms = once_ms(lambda: p2.hash_rows_plain(rows))
    ms = cuda_ms(lambda: poseidon2_cuda.poseidon2_hash_rows(rows), 5)
    nrows, width = rows.shape
    hash_work = lambda n, w: dict(nbytes=4 * (n * w + n * p2.OUT), mults=n * max(1, -(-w // p2.RATE)) * PERM_MULS)
    check_kernel(card, results, "poseidon2_hash_rows", (nrows, width), got, want, plain_ms, ms,
                 **hash_work(nrows, width))
    # the flagship's LDE transpose (1,024 x 48), timed; then row counts that
    # are no multiple of a block's 16 rows, at widths around one rate chunk,
    # contiguous and transposed
    rows = mont((48, 1024)).T
    got = poseidon2_cuda.poseidon2_hash_rows(rows)
    want, plain_ms = once_ms(lambda: p2.hash_rows_plain(rows))
    ms = cuda_ms(lambda: poseidon2_cuda.poseidon2_hash_rows(rows), 20)
    check_kernel(card, results, "poseidon2_hash_rows", (1024, 48), got, want, plain_ms, ms, record=False,
                 **hash_work(1024, 48))
    cases = []
    for nrows in (1, 3, 33, 4101):
        for width in (1, 7, 8, 9, 48, 200):
            x = mont((nrows, width))
            want = p2.hash_rows_plain(x)
            cases.append((f"{nrows}x{width}", poseidon2_cuda.poseidon2_hash_rows(x), want))
            cases.append((f"{nrows}x{width} transposed", poseidon2_cuda.poseidon2_hash_rows(x.T.contiguous().T), want))
    check_edges("poseidon2_hash_rows", cases)

    # the Merkle tree in one launch over the commitment's 4,096 leaves
    # (recorded: 4,095 permutations, a chain of 12), then at the sizes where
    # its tasks change: 1 leaf, one level, a task's 2^7 leaves and one
    # level either side, and trees of two and three chunks of tasks
    leaves = mont((lde_n, p2.OUT))
    got = poseidon2_cuda.poseidon2_merkle(leaves)
    want, plain_ms = once_ms(lambda: poseidon2_cuda.poseidon2_merkle_plain(leaves))
    ms = graph_ms(lambda: poseidon2_cuda.poseidon2_merkle(leaves), 20)
    chain = lde_n.bit_length() - 1
    check_kernel(card, results, "poseidon2_merkle", (lde_n, p2.OUT), got, want, plain_ms, ms,
                 nbytes=4 * p2.OUT * (2 * lde_n - 1), mults=(lde_n - 1) * PERM_MULS, chain_permutations=chain,
                 us_per_level=ms * 1e3 / chain, events_ms=cuda_ms(lambda: poseidon2_cuda.poseidon2_merkle(leaves), 20))
    cases = []
    for log_n in (0, 1, 2, 6, 7, 8, 16, 20):
        x = mont((1 << log_n, p2.OUT))
        cases.append((f"2^{log_n} leaves", poseidon2_cuda.poseidon2_merkle(x),
                      poseidon2_cuda.poseidon2_merkle_plain(x)))
    check_edges("poseidon2_merkle", cases)

    pairs = mont((2048, 2 * p2.OUT))
    got = poseidon2_cuda.poseidon2_compress(pairs)
    want, plain_ms = once_ms(lambda: p2.compress_plain(pairs))
    ms = graph_ms(lambda: poseidon2_cuda.poseidon2_compress(pairs), 20)
    check_kernel(card, results, "poseidon2_compress", (2048, 16), got, want, plain_ms, ms,
                 nbytes=4 * 2048 * (16 + 8), mults=2048 * PERM_MULS,
                 events_ms=cuda_ms(lambda: poseidon2_cuda.poseidon2_compress(pairs), 20))
    return results


def int_mm_ms(bsz: int, r: int, c: int) -> float:
    """Milliseconds of torch._int_mm (cuBLAS int8 x int8 -> int32) for B6's
    two stacked digit products on `bsz` rows of R x C: (4R, R) x (R, 4C
    bsz) and (4C, C) x (C, 4R bsz), on random digits (the time does not
    depend on them).  A yardstick for the product half: no PyTorch call
    computes B6 and the port calls none of this."""
    import torch

    total = 0.0
    for m, lanes in ((r, c), (c, r)):
        a = torch.randint(-128, 128, (4 * m, m), dtype=torch.int8, device="cuda")
        bt = torch.randint(-128, 128, (4 * lanes * bsz, m), dtype=torch.int8, device="cuda")
        total += cuda_ms(lambda: torch._int_mm(a, bt.t()), 10)
        del a, bt
    return total


def phase_ops(card: Card, setup32) -> tuple[dict, dict]:
    """B3, B6, Keccak-256 and SHA-256 through the port's ops entry points
    (``ec_cuda.ec_double``, ``ntt_mxu.ntt_mxu``, ``keccak.keccak_f1600_batch``
    and ``keccak256_batch``, ``sha256.sha256_batch``), counts reset just
    before and read just after; then each kernel against its plain version
    and the hashes against the host's.  Returns (results, launches)."""
    import hashlib

    import numpy as np
    import torch

    from raiko_tpu_torch import convert, kernels
    from raiko_tpu_torch.fields import babybear as bb
    from raiko_tpu_torch.kzg import curve
    from raiko_tpu_torch.ops import ec_cuda, keccak, keccak_cuda, ntt, ntt_cuda, ntt_mxu, sha256, sha256_cuda
    from raiko_tpu_torch.ops import poseidon2 as p2
    from raiko_tpu_torch.stark.prover import BLOWUP_LOG
    from raiko_tpu_torch.utils import native

    rng = np.random.default_rng(SEED + 4)
    pick = lambda k: setup32[torch.as_tensor(rng.integers(0, setup32.shape[0], k), device="cuda")]

    # B3 at B1's width: affine points, points with Z != 1, identities
    m = 131_072
    pts = pick(m)
    pts[m // 2 :] = ec_cuda.ec_add(pick(m // 2), pick(m // 2))
    pts[:64] = convert.pack32(curve.identity((64,), "cuda"))
    # B6 at the NTT bench's 64 x 2^14, and on the keccak chunk's LDE input:
    # the coset-scaled, zero-padded coefficients that phase stark's B5 takes
    ntt64 = convert.words_from_numpy(bb.np_to_mont(rng.integers(0, bb.P, (64, 1 << 14), dtype=np.uint32)), "cuda")
    trace = rng.integers(0, bb.P, (KECCAK_ROWS, KECCAK_COLS), dtype=np.uint32)
    coeffs = ntt.interpolate(bb.to_mont(convert.words_from_numpy(trace, "cuda").T.contiguous()))
    lde_in = ntt.coset_pad(coeffs, BLOWUP_LOG, bb.GENERATOR)
    # Keccak: 8,192 states; 8,192 MPT-node-sized messages (32-532 bytes, one
    # to four rate blocks).  SHA-256: 8,192 48-byte commitments (to their
    # versioned hashes) and 1,024 messages of 0-299 bytes (one to five blocks)
    kstate = convert.words_from_numpy(rng.integers(0, 1 << 32, (8192, 25, 2), dtype=np.uint32), "cuda")
    nodes = [rng.bytes(int(n)) for n in rng.integers(32, 533, 8192)]
    commitments = [rng.bytes(48) for _ in range(8192)]
    mixed = [rng.bytes(int(n)) for n in rng.integers(0, 300, 1024)]
    # 2,048 pairs of digests
    left, right = (convert.words_from_numpy(bb.np_to_mont(rng.integers(0, bb.P, (2048, p2.OUT), dtype=np.uint32)),
                                            "cuda") for _ in range(2))
    # the full card's widths, timed after the counted run: 131,072 states and
    # 131,072 48-byte commitments
    kstate_wide = convert.words_from_numpy(rng.integers(0, 1 << 32, (HASH_WIDE, 25, 2), dtype=np.uint32), "cuda")
    commitments_wide = [rng.bytes(48) for _ in range(HASH_WIDE)]

    torch.cuda.synchronize()
    kernels.LAUNCHES.reset()
    doubled = ec_cuda.ec_double(pts)
    mxu64 = ntt_mxu.ntt_mxu(ntt64)
    b5_64 = ntt.ntt(ntt64)
    mxu_lde = ntt_mxu.ntt_mxu(lde_in)
    compressed = p2.compress(left, right)
    permuted = keccak.keccak_f1600_batch(kstate)
    node_digests = keccak.keccak256_batch(nodes, "cuda")
    versioned = sha256.sha256_batch(commitments, "cuda")
    mixed_digests = sha256.sha256_batch(mixed, "cuda")
    torch.cuda.synchronize()
    launches = kernels.LAUNCHES.snapshot()
    emit("ops", launches=launches)
    missing = [k for k in OPS if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the ops path: {missing}")

    results = {}
    # B3: the recorded width (CUDA events, as before), then the widths of
    # B1's served MSM (prefixes of the same points) as CUDA graphs, event
    # means beside them; then widths that are no multiple of a warp's 8
    # points, with Z != 1 and identities
    double_work = lambda k: dict(nbytes=2 * k * 144, mults=k * DOUBLE_FMULS * _fmul(12))
    want, plain_ms = once_ms(lambda: ec_cuda.ec_double_plain(pts))
    ms = cuda_ms(lambda: ec_cuda.ec_double(pts), 20)
    check_kernel(card, results, "ec_double", [m, 3, 12], doubled, want, plain_ms, ms, **double_work(m))
    for k in B3_WIDTHS:
        pk = pts[:k]
        fn = lambda: ec_cuda.ec_double(pk)
        check_kernel(card, results, "ec_double", [k, 3, 12], fn(), want[:k], None, graph_ms(fn, 20 if k <= 16384 else 5),
                     record=False, events_ms=cuda_ms(fn, 20), **double_work(k))
    cases = []
    for k in (1, 5, 33, 4099):
        pk = ec_cuda.ec_add_plain(pick(k), pick(k))
        pk[::7] = convert.pack32(curve.identity((), "cuda"))
        cases.append((f"M={k}", ec_cuda.ec_double(pk), ec_cuda.ec_double_plain(pk)))
    check_edges("ec_double", cases)

    if not torch.equal(compressed, p2.compress_plain(torch.cat([left, right], dim=1))):
        raise AssertionError("poseidon2.compress on the card differs from its plain version")
    if not torch.equal(b5_64, ntt_cuda.ntt_plain(ntt64)):
        raise AssertionError("ntt.ntt on the card differs from its plain version")

    # B6 at the two recorded shapes: the card's time per call (CUDA graph),
    # the event mean beside it, B5's ntt on the same rows, and the yardstick
    # of its product half, torch._int_mm (cuBLAS int8) of both passes'
    # stacked digit products
    for x, got, record in ((ntt64, mxu64, True), (lde_in, mxu_lde, False)):
        bsz, n = x.shape
        log_n = n.bit_length() - 1
        r, c = 1 << (log_n // 2), 1 << (log_n - log_n // 2)
        want, plain_ms = once_ms(lambda: ntt_mxu.ntt_mxu_plain(x))
        fn = lambda: ntt_mxu.ntt_mxu(x)
        ms = graph_ms(fn, 10)
        b5 = ntt_cuda.ntt(x)
        b5_ms = graph_ms(lambda: ntt_cuda.ntt(x), 10)
        ntt_bound_ms, ntt_bound_by = card.bound(*_ntt_work(bsz, log_n, False))
        equal_b5 = bool(torch.equal(got, b5))
        # own work: the int8 MACs of both passes, each element in and out
        # once, per output and pass one recombination, and one cross twiddle
        check_kernel(card, results, "ntt_mxu", [bsz, n], got, want, plain_ms, ms, nbytes=8 * bsz * n,
                     mults=bsz * n * (2 * MXU_RECOMB_MULS + BB_MUL), int8_macs=16 * n * (r + c) * bsz,
                     record=record, equal_b5=equal_b5, b5_ms=b5_ms, ntt_bound_ms=ntt_bound_ms,
                     ntt_bound_by=ntt_bound_by, events_ms=cuda_ms(fn, 10), int_mm_ms=int_mm_ms(bsz, r, c))
        if not equal_b5:
            raise AssertionError(f"ntt_mxu at {[bsz, n]} differs from B5's ntt")
    # every size 2^0 to 2^14, three rows each, against the plain version and
    # (from 2^1, B5's smallest) B5's ntt
    cases = []
    for log_n in range(ntt_mxu.MAX_LOG_M * 2 + 1):
        x = convert.words_from_numpy(bb.np_to_mont(rng.integers(0, bb.P, (3, 1 << log_n), dtype=np.uint32)), "cuda")
        got = ntt_mxu.ntt_mxu(x)
        cases.append((f"3x2^{log_n}", got, ntt_mxu.ntt_mxu_plain(x)))
        if log_n:
            cases.append((f"3x2^{log_n} B5", got, ntt_cuda.ntt(x)))
    check_edges("ntt_mxu", cases)

    # Keccak-f and SHA-256: the card's time per call as a CUDA graph (their
    # launches are shorter than the host's cost per call), the event mean
    # beside it, the layout the width ran in and the longest dependent chain
    # beside the bound
    def perm_case(st, got, record):
        b = st.shape[0]
        want, plain_ms = once_ms(lambda: keccak.keccak_f1600_plain(st))
        fn = lambda: keccak.keccak_f1600_batch(st)
        # one permutation runs on a pair of lanes at every width
        check_kernel(card, results, "keccak_f1600", [b, 25, 2], got, want, plain_ms, graph_ms(fn, 20),
                     nbytes=2 * b * 200, mults=0, logic=b * KECCAK_PERM_OPS, record=record,
                     events_ms=cuda_ms(fn, 20), lanes=2, chain_ms=card.chain_ms(KECCAK_CHAIN, KECCAK_PAIR_EXCHANGES))

    perm_case(kstate, permuted, True)
    perm_case(kstate_wide, keccak.keccak_f1600_batch(kstate_wide), False)

    def hash_case(name, msgs, digests, host, pack, blocks_fn, plain_fn, block_bytes, block_ops, record, **extra):
        """The kernel behind a batch hash on the batch's own blocks, against
        the plain version; the entry point's digests against the host's."""
        words, counts = pack(msgs)
        w = convert.words_from_numpy(words, "cuda")
        cnt = torch.as_tensor(counts, device="cuda")
        got = blocks_fn(w, cnt)
        want, plain_ms = once_ms(lambda: plain_fn(w, cnt))
        fn = lambda: blocks_fn(w, cnt)
        host_equal = digests == [host(msg) for msg in msgs]
        nblocks = int(counts.sum())
        check_kernel(card, results, name, [len(msgs), words.shape[1]], got, want, plain_ms, graph_ms(fn, 20),
                     nbytes=nblocks * block_bytes + len(msgs) * (4 + 32), mults=0,
                     logic=nblocks * block_ops, record=record, events_ms=cuda_ms(fn, 20), blocks=nblocks,
                     host_equal=host_equal, **{k: v(int(counts.max())) for k, v in extra.items()})
        if not host_equal:
            raise AssertionError(f"{name}: the card's digests differ from the host's")

    lanes = keccak_cuda.absorb_lanes(len(nodes))
    hash_case("keccak_f1600", nodes, node_digests, native.keccak256, keccak.pack_ragged,
              keccak_cuda.keccak256_blocks, keccak.keccak256_blocks_plain, keccak.RATE, KECCAK_PERM_OPS + 34,
              record=False, lanes=lambda _: lanes,
              chain_ms=lambda most: most * card.chain_ms(KECCAK_CHAIN, KECCAK_PAIR_EXCHANGES * (lanes == 2)))
    sha_blocks = lambda w, cnt: sha256_cuda.sha256_compress(None, w, cnt)
    sha_plain = lambda w, cnt: sha256.sha256_blocks_plain(None, w, cnt)
    sha_host = lambda msg: hashlib.sha256(msg).digest()
    for msgs, digests, record in ((commitments, versioned, True),
                                  (commitments_wide, sha256.sha256_batch(commitments_wide, "cuda"), False),
                                  (mixed, mixed_digests, False)):
        hash_case("sha256_compress", msgs, digests, sha_host, sha256.pack_ragged, sha_blocks, sha_plain,
                  64, SHA_BLOCK_OPS, record=record,
                  layout=lambda most, b=len(msgs): sha256_cuda.compress_layout(b, most),
                  chain_ms=lambda most: most * card.chain_ms(SHA_CHAIN))
    check_hash_edges(rng)
    return results, {k: launches[k] for k in OPS}


def check_hash_edges(rng) -> None:
    """Keccak-f (one permutation on its pair of lanes, absorbing in both
    layouts) and SHA-256 in every layout at widths that are no multiple of a
    warp or a pair (1 to 16,385, and 40,961, where one thread a message
    orders by block count): absorbing ragged
    counts (0, T and above T, which the kernels clamp, among them) and
    equal counts, against their plain versions; and messages at the padding
    edges (Keccak 0-543 bytes about the 136-byte rate, SHA-256 0-299 about
    55, 56 and 64) against the host's hashes."""
    import hashlib

    import numpy as np
    import torch

    from raiko_tpu_torch import convert
    from raiko_tpu_torch.ops import keccak, keccak_cuda, sha256, sha256_cuda
    from raiko_tpu_torch.utils import native

    words = lambda shape: convert.words_from_numpy(rng.integers(0, 1 << 32, shape, dtype=np.uint32), "cuda")

    def ragged(b: int, most: int, t: int) -> torch.Tensor:
        counts = rng.integers(1, most + 1, b).astype(np.int32)
        counts[::7], counts[3::11], counts[5::13] = 0, t, t + 3
        return torch.as_tensor(counts, device="cuda")

    kcases, scases = [], []
    for b in (1, 2, 31, 33, 4099, 16385, 40961):
        st, kblk, sblk, sst = words((b, 25, 2)), words((b, 5, 34)), words((b, 6, 16)), words((b, 8))
        kcnt, scnt = ragged(b, 4, 5), ragged(b, 5, 6)
        equal = torch.full((b,), 3, dtype=torch.int32, device="cuda")
        kwant = (keccak.keccak_f1600_plain(st), keccak.keccak256_blocks_plain(kblk, kcnt),
                 keccak.keccak256_blocks_plain(kblk, equal))
        kcases.append((f"B={b}", keccak_cuda.keccak_f1600(st), kwant[0]))
        for lanes in keccak_cuda.LANE_CHOICES:
            kcases += [(f"B={b} lanes={lanes} ragged", keccak_cuda.keccak256_blocks_lanes(kblk, kcnt, lanes), kwant[1]),
                       (f"B={b} lanes={lanes} equal", keccak_cuda.keccak256_blocks_lanes(kblk, equal, lanes), kwant[2])]
        swant = (sha256.sha256_blocks_plain(None, sblk, scnt), sha256.sha256_blocks_plain(sst, sblk, scnt),
                 sha256.sha256_blocks_plain(None, sblk, equal))
        for layout in sha256_cuda.LAYOUTS:
            scases += [(f"B={b} {layout} ragged", sha256_cuda.sha256_compress_layout(None, sblk, scnt, layout), swant[0]),
                       (f"B={b} {layout} state", sha256_cuda.sha256_compress_layout(sst, sblk, scnt, layout), swant[1]),
                       (f"B={b} {layout} equal", sha256_cuda.sha256_compress_layout(None, sblk, equal, layout),
                        swant[2])]
    kmsgs = [rng.bytes(n) for n in (0, 1, 135, 136, 137, 271, 272, 407, 408, 543)]
    smsgs = [rng.bytes(n) for n in (0, 1, 55, 56, 63, 64, 119, 120, 183, 184, 247, 248, 299)]
    kw, kc = keccak.pack_ragged(kmsgs)
    sw, sc = sha256.pack_ragged(smsgs)
    kw, kc = convert.words_from_numpy(kw, "cuda"), torch.as_tensor(kc, device="cuda")
    sw, sc = convert.words_from_numpy(sw, "cuda"), torch.as_tensor(sc, device="cuda")
    for lanes in keccak_cuda.LANE_CHOICES:
        got = keccak_cuda.keccak256_blocks_lanes(kw, kc, lanes)
        kcases.append((f"padding lanes={lanes}", got, keccak.keccak256_blocks_plain(kw, kc)))
        raw = got.cpu().numpy().astype("<i4").tobytes()
        if [raw[32 * i : 32 * i + 32] for i in range(len(kmsgs))] != [native.keccak256(m) for m in kmsgs]:
            raise AssertionError(f"keccak_f1600 ({lanes} lanes) differs from the host's Keccak-256 at the padding edges")
    for layout in sha256_cuda.LAYOUTS:
        got = sha256_cuda.sha256_compress_layout(None, sw, sc, layout)
        scases.append((f"padding {layout}", got, sha256.sha256_blocks_plain(None, sw, sc)))
        raw = got.cpu().numpy().view(np.uint32).astype(">u4").tobytes()
        if [raw[32 * i : 32 * i + 32] for i in range(len(smsgs))] != [hashlib.sha256(m).digest() for m in smsgs]:
            raise AssertionError(f"sha256_compress ({layout}) differs from hashlib at the padding edges")
    check_edges("keccak_f1600", kcases)
    check_edges("sha256_compress", scases)


def phase_stark() -> dict:
    """The STARK trace commitment at the keccak chunk's shape, through the
    port's entry point; returns the launches of that run."""
    import numpy as np
    import torch

    from raiko_tpu_torch import convert, kernels
    from raiko_tpu_torch.fields import babybear as bb
    from raiko_tpu_torch.ops import merkle, ntt, poseidon2 as p2
    from raiko_tpu_torch.stark.commit_step import commit_step
    from raiko_tpu_torch.stark.prover import BLOWUP_LOG

    rng = np.random.default_rng(SEED + 3)
    trace = rng.integers(0, bb.P, (KECCAK_ROWS, KECCAK_COLS), dtype=np.uint32)
    torch.cuda.synchronize()
    kernels.LAUNCHES.reset()
    root, cold_ms = once_ms(lambda: commit_step(trace, "cuda"))
    launches = kernels.LAUNCHES.snapshot()
    _, warm_ms = once_ms(lambda: commit_step(trace, "cuda"))
    t0 = time.perf_counter()
    plain_root = commit_step(trace, "cpu")
    plain_s = time.perf_counter() - t0
    same = convert.bb_to_numpy(root).tolist() == convert.bb_to_numpy(plain_root).tolist()

    # by stage, CUDA events, on the card
    tm = bb.to_mont(convert.words_from_numpy(trace, "cuda").T.contiguous())
    coeffs = ntt.interpolate(tm)
    lde = ntt.lde_from_coeffs(coeffs, BLOWUP_LOG, bb.GENERATOR)
    leaves = p2.hash_rows(lde.T)
    up = convert.words_from_numpy(trace, "cuda")
    stages = {
        "upload_to_mont_ms": cuda_ms(lambda: bb.to_mont(convert.words_from_numpy(trace, "cuda").T.contiguous()),
                                     5),
        "upload_ms": cuda_ms(lambda: convert.words_from_numpy(trace, "cuda"), 5),
        "to_mont_ms": cuda_ms(lambda: bb.to_mont(up.T.contiguous()), 5),
        "interpolate_ms": cuda_ms(lambda: ntt.interpolate(tm), 5),
        "lde_ms": cuda_ms(lambda: ntt.lde_from_coeffs(coeffs, BLOWUP_LOG, bb.GENERATOR), 5),
        "hash_rows_ms": cuda_ms(lambda: p2.hash_rows(lde.T), 5),
        "merkle_ms": cuda_ms(lambda: merkle.commit(leaves), 5),
    }
    flagship = commit_step(np.random.default_rng(0).integers(0, bb.P, (256, 48), np.uint32), "cuda")
    flagship_ok = convert.bb_to_numpy(flagship).tolist() == FLAGSHIP_ROOT
    emit("stark", trace=[KECCAK_ROWS, KECCAK_COLS], lde=[KECCAK_COLS, KECCAK_ROWS << BLOWUP_LOG],
         root=convert.bb_to_numpy(root).tolist(), equal_plain_path=same, commit_cold_ms=cold_ms,
         commit_warm_ms=warm_ms, plain_path_s=plain_s, launches=launches, flagship_root_ok=flagship_ok,
         **stages)
    if not same:
        raise AssertionError("the card's commitment root differs from the plain path's")
    if not flagship_ok:
        raise AssertionError(f"the flagship root {convert.bb_to_numpy(flagship).tolist()} differs from JAX's")
    # one launch each of intt, the LDE and the row hash, the tree in one or
    # two, and nothing else
    expected = {"intt": (1, 1), "ntt_coset": (1, 1), "poseidon2_hash_rows": (1, 1), "poseidon2_merkle": (1, 2)}
    if set(launches) != set(expected) or any(not lo <= launches[k] <= hi for k, (lo, hi) in expected.items()):
        raise AssertionError(f"the commitment's launches {launches}, expected {expected}")
    return launches


def golden_case(case: str):
    """(AIR, trace, publics, golden) of a JAX golden, built by the port from
    the golden's inputs."""
    from raiko_tpu_torch.stark.airs.fib import FibAir
    from raiko_tpu_torch.stark.airs.keccak_air import KeccakBatchSpongeAir
    from raiko_tpu_torch.stark.airs.poseidon2_air import Poseidon2TranscriptAir

    with open(os.path.join(ROOT, "tests", "golden", f"stark_{case}.json")) as f:
        g = json.load(f)
    inp = g["inputs"]
    if case == "fib":
        trace, publics = FibAir.trace(inp["log_n"], inp["a"], inp["b"])
        return FibAir(), trace, publics, g
    if case == "transcript":
        air = Poseidon2TranscriptAir(inp["blocks"])
        return air, air.trace(), air.publics_for(air.compute_digest()), g
    air = KeccakBatchSpongeAir([bytes.fromhex(m) for m in inp["messages"]])
    return air, air.trace(), air.publics(), g


def phase_stark_prove() -> dict:
    """Whole proofs on the card against the JAX goldens; returns the
    launches of one keccak-chunk proof."""
    import hashlib

    import torch

    from raiko_tpu_torch import kernels
    from raiko_tpu_torch.stark import prover, serde, verifier
    from raiko_tpu_torch.utils.measurement import Measurement

    per_proof = {}
    for case in PROOF_CASES:
        air, trace, publics, g = golden_case(case)
        fixed = air.fixed_columns(trace.shape[0])
        for run in ("cold", "warm") if case == "keccak_chunk" else ("cold",):
            stages: dict = {}

            def record(title: str, seconds: float) -> None:
                key = title.removeprefix("stark.") + "_ms"
                stages[key] = stages.get(key, 0.0) + seconds * 1e3

            token = Measurement.subscribe(record)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.LAUNCHES.reset()
            try:
                proof, ms = once_ms(lambda: prover.prove(air, trace, publics, device="cuda"))
            finally:
                Measurement.unsubscribe(token)
            launches = kernels.LAUNCHES.snapshot()
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            canon = json.dumps(serde.proof_to_dict(proof), sort_keys=True)
            sha = hashlib.sha256(canon.encode()).hexdigest()
            verified, verify_ms = True, None
            if run == "cold":
                verified, verify_ms = once_ms(lambda: verifier.verify(air, proof, device="cuda"))
            emit("stark_prove", case=case, run=run, air=type(air).__name__, trace=list(trace.shape),
                 fixed_columns=0 if fixed is None else int(fixed.shape[0]),
                 quotient_chunks=air.quotient_chunks, prove_s=ms / 1e3, stages_ms=stages,
                 between_stages_ms=ms - sum(stages.values()), launches=launches, peak_device_gb=peak_gb,
                 sha256=sha, golden_sha256=g["sha256"], equal_golden=sha == g["sha256"], verified=verified,
                 verify_s=None if verify_ms is None else verify_ms / 1e3,
                 jax_cpu_prove_s=g["jax_cpu_prove_seconds"])
            if sha != g["sha256"]:
                d = serde.proof_to_dict(proof)
                roots = {k: d[k] for k in ("trace_root", "aux_root", "fixed_root", "quotient_root")}
                roots["fri_layer_roots"] = d["fri"]["layer_roots"]
                differ = [k for k, v in roots.items() if g["roots"][k] != v]
                raise AssertionError(f"{case}: the proof differs from the JAX golden (roots that differ: {differ})")
            if not verified:
                raise AssertionError(f"{case}: the port's verifier rejects the card's proof")
            missing = [k for k in STARK if launches.get(k, 0) <= 0]
            if missing:
                raise AssertionError(f"{case}: kernels not launched by the proof: {missing}")
        per_proof[case] = launches
    return per_proof["keccak_chunk"]


def random_blob(seed: int) -> bytes:
    """A full blob of random field elements."""
    import numpy as np

    from raiko_tpu_torch.kzg import eip4844

    rng = np.random.default_rng(seed)
    words = rng.integers(0, 256, (eip4844.FIELD_ELEMENTS_PER_BLOB, 32), dtype=np.uint8)
    words[:, 0] &= 0x3F  # < 2^254 < the BLS12-381 scalar modulus
    return words.tobytes()


def phase_kzg():
    import torch

    from raiko_tpu_torch.kzg import eip4844

    cuda = torch.device("cuda")
    zero = eip4844.blob_to_kzg_commitment(bytes(eip4844.BYTES_PER_BLOB), cuda)
    zero_vh = eip4844.commitment_to_version_hash(zero).hex()
    if zero_vh != "010657f37554c781402a22917dee2f75def7ab966d7b770905398eba3c444014":
        raise AssertionError(f"zero-blob versioned hash {zero_vh}")

    blob = random_blob(SEED + 1)
    t0 = time.perf_counter()
    commit = eip4844.blob_to_kzg_commitment(blob, cuda)
    commit_s = time.perf_counter() - t0
    z = eip4844.get_evaluation_point(blob, eip4844.commitment_to_version_hash(commit))
    t0 = time.perf_counter()
    proof, y = eip4844.compute_kzg_proof(blob, z, cuda)
    proof_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_commit = eip4844.blob_to_kzg_commitment(blob, None)
    host_proof, host_y = eip4844.compute_kzg_proof(blob, z, None)
    host_s = time.perf_counter() - t0
    verified = eip4844.verify_kzg_proof(commit, z, y, proof)
    emit("kzg", zero_blob_versioned_hash="0x" + zero_vh, commitment_equal=commit == host_commit,
         proof_equal=(proof, y) == (host_proof, host_y), proof_verifies=verified,
         device_commit_s=commit_s, device_proof_s=proof_s, host_commit_and_proof_s=host_s)
    if commit != host_commit or (proof, y) != (host_proof, host_y) or not verified:
        raise AssertionError("device KZG differs from the host path or does not verify")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(url: str, body: dict) -> dict:
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"content-type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def phase_serve(device: str, n_blocks: int, n_txs: int):
    """Serve v2 ``native`` requests for blocks 1..n_blocks; returns the
    seconds per request, the kernels' launches during the requests and each
    block's served proof (``input``, ``kzg_proof``)."""
    from raiko_tpu_torch import kernels
    from raiko_tpu_torch.host.cli import BackgroundServer
    from raiko_tpu_torch.testing.workload import build_chain

    port = _free_port()
    argv = ["--device", device, "--address", "127.0.0.1", "--port", str(port), "--log-level", "warning"]
    with BackgroundServer(argv) as srv:
        t0 = time.perf_counter()
        build_chain(n_blocks, n_txs, srv.device)
        emit("chain", blocks=n_blocks, txs_per_block=n_txs, seconds=time.perf_counter() - t0,
             device=str(srv.device))
        base = f"http://127.0.0.1:{port}"
        kernels.LAUNCHES.reset()
        per_request, served = [], []
        for blk in range(1, n_blocks + 1):
            body = {"block_number": blk, "network": "taiko_a7", "proof_type": "native"}
            t0 = time.perf_counter()
            r = _post(f"{base}/v2/proof", body)
            while r["status"] == "ok" and r["data"].get("status") in ("registered", "work_in_progress"):
                if time.perf_counter() - t0 > 600:
                    raise TimeoutError(f"block {blk}: no proof after 600 s")
                time.sleep(0.2)
                r = _post(f"{base}/v2/proof", body)
            per_request.append(time.perf_counter() - t0)
            if r["status"] != "ok" or r["data"].get("status") != "success":
                raise AssertionError(f"block {blk}: proof request ended as {r}")
            served.append(r["data"]["proof"])
            emit("request", block=blk, seconds=per_request[-1], input=served[-1]["input"],
                 kzg_proof=served[-1]["kzg_proof"])
        launches = kernels.LAUNCHES.snapshot()
    return per_request, launches, served


def check_requests(served: list[dict]) -> None:
    """Prove each served block again with the port's orchestrator on its
    host path (device None: host MSM, per-tx recovery, no kernel); the
    served instance hash and KZG proof must equal its own, and the proof
    must verify."""
    from raiko_tpu_torch.chain import SupportedChainSpecs
    from raiko_tpu_torch.core.interfaces import ProofRequest, ProofType
    from raiko_tpu_torch.core.orchestrator import Raiko
    from raiko_tpu_torch.kzg import eip4844 as kzg

    for blk, proof in enumerate(served, start=1):
        req = ProofRequest(block_number=blk, network="taiko_a7", proof_type=ProofType.NATIVE)
        raiko = Raiko(SupportedChainSpecs(), req, None)
        t0 = time.perf_counter()
        gi = raiko.generate_input()
        out = raiko.get_output(gi)
        want = raiko.prove(gi, out)
        host_s = time.perf_counter() - t0
        tx_data, commitment = gi.taiko.tx_data, bytes(gi.taiko.blob_commitment)
        z = kzg.get_evaluation_point(tx_data, kzg.commitment_to_version_hash(commitment))
        y = kzg.evaluate_polynomial_in_evaluation_form(kzg.blob_to_field_elements(tx_data), z)
        got = bytes.fromhex(proof["kzg_proof"][2:])
        checks = {
            "input_equal_host": proof["input"] == want.input_hash,
            "kzg_proof_equal_host": proof["kzg_proof"] == want.kzg_proof,
            "verifies": kzg.verify_kzg_proof(commitment, z, y, got),
        }
        emit("request_check", block=blk, txs=len(gi.transactions), host_path_s=host_s, **checks)
        if not all(checks.values()):
            raise AssertionError(f"block {blk}: the served proof differs from the host path's: {checks}")


class StatementMeter:
    """Per statement of a ``tpu_stark`` proof (its ``tpu_stark.*`` spans,
    from any thread): wall seconds, the prover's stage spans inside it in
    ms (``stark.*``; ``transcript``: the Fiat-Shamir hashing between the
    stages), the host time outside those stages (building the tables'
    traces, serialising), and the kernels' launches since the previous
    statement ended (the first, ``reexecute``, since the meter started: a
    served request's preflight and output check too)."""

    def __enter__(self):
        from raiko_tpu_torch import kernels
        from raiko_tpu_torch.utils.measurement import Measurement

        self._launches = kernels.LAUNCHES
        self._mark = self._launches.snapshot()
        self._stages: dict = {}
        self.rows: dict = {}
        self._token = Measurement.subscribe(self._record)
        return self

    def __exit__(self, *exc):
        from raiko_tpu_torch.utils.measurement import Measurement

        Measurement.unsubscribe(self._token)

    def _record(self, title: str, seconds: float) -> None:
        if title.startswith("stark."):
            key = title.removeprefix("stark.") + "_ms"
            self._stages[key] = self._stages.get(key, 0.0) + seconds * 1e3
        elif title.startswith("tpu_stark."):
            snap = self._launches.snapshot()
            self.rows[title.removeprefix("tpu_stark.")] = {
                "wall_s": seconds, "transcript_s": self._stages.get("transcript_ms", 0.0) / 1e3,
                "stages_ms": self._stages, "outside_stages_s": seconds - sum(self._stages.values()) / 1e3,
                "launches": {k: v - self._mark.get(k, 0) for k, v in snap.items() if v != self._mark.get(k, 0)}}
            self._mark, self._stages = snap, {}


def statement_tables(payload: dict) -> dict:
    """slot -> the number of STARK tables of each statement in a payload
    (``evm``: every table of every call tree; ``prestate``: its keccak
    batches)."""
    out = {"stark": 1}
    for slot in ("mpt", "tx_mpt", "receipts_mpt", "chain"):
        if slot in payload:
            out[slot] = len(payload[slot].get("starks", payload[slot].get("stark_chunks", [])))
    if "evm" in payload:
        out["evm"] = sum(len(tree["starks"]) for tree in payload["evm"]["frames"])
    if "prestate" in payload:
        out["prestate"] = len(payload["prestate"]["keccak"]["stark_chunks"])
    return out


def emit_statements(block: str, payload: dict, meter: StatementMeter, device_ms: dict | None) -> None:
    """One ``statement`` line per statement; the ``evm`` line also gives
    its call trees, covered and total candidates, its share of the block's
    statements' wall time, and its quotient stage's share of its trees'
    stage time.  The trees prove on a thread pool, so the stage spans of
    two trees overlap and sum to more than the statement's wall time:
    the two shares multiply to the quotient's share of the block."""
    tables = statement_tables(payload)
    block_s = sum(row["wall_s"] for row in meter.rows.values())
    for slot, row in meter.rows.items():
        extra = {}
        if slot == "evm" and "evm" in payload:
            evm = payload["evm"]
            extra = {"trees": len(evm["frames"]), "covered": evm["covered"], "total": evm["total"],
                     "share_of_block": row["wall_s"] / block_s,
                     "quotient_share_of_stages": row["stages_ms"].get("quotient_ms", 0.0)
                     / sum(row["stages_ms"].values())}
        emit("statement", block=block, statement=slot, tables=tables.get(slot, 0), **row, **extra,
             device_ms=None if device_ms is None else device_ms.get(slot, 0.0))


def statement_device_ms(prof) -> dict:
    """Device ms under each ``tpu_stark.*`` range of a profile (ranges of
    the profiling thread only)."""
    from torch.autograd import DeviceType

    out: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name.startswith("tpu_stark."):
            slot = e.name.removeprefix("tpu_stark.")
            out[slot] = out.get(slot, 0.0) + e.device_time_total / 1e3
    return out


def statement_quotient(prof, prefix: str = "tpu_stark.") -> dict:
    """Per range of a profile whose name starts with `prefix`: the wall ms,
    device ms and CUDA kernel launches (the runtime's launch calls, counted
    on the host) inside its ``stark.quotient`` ranges (the profiling thread
    only)."""
    import bisect

    from torch.autograd import DeviceType

    cpu = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    launches = sorted(e.time_range.start for e in cpu if "LaunchKernel" in e.name)
    quotients = [e for e in cpu if e.name == "stark.quotient"]
    out: dict = {}
    for st in (e for e in cpu if e.name.startswith(prefix)):
        row = out.setdefault(st.name.removeprefix(prefix), {"wall_ms": 0.0, "device_ms": 0.0, "launches": 0})
        for q in quotients:
            if st.time_range.start <= q.time_range.start and q.time_range.end <= st.time_range.end:
                row["wall_ms"] += q.cpu_time_total / 1e3
                row["device_ms"] += q.device_time_total / 1e3
                row["launches"] += (bisect.bisect_right(launches, q.time_range.end)
                                    - bisect.bisect_left(launches, q.time_range.start))
    return out


def block_request(device, args: dict) -> tuple:
    """(Raiko, guest input, output) of block 1 as a ``tpu_stark`` request
    with prover args `args`."""
    from raiko_tpu_torch.chain import SupportedChainSpecs
    from raiko_tpu_torch.core.interfaces import ProofRequest, ProofType
    from raiko_tpu_torch.core.orchestrator import Raiko

    req = ProofRequest(block_number=1, network="taiko_a7", proof_type=ProofType.TPU_STARK,
                       prover_args=dict(args))
    raiko = Raiko(SupportedChainSpecs(), req, device)
    gi = raiko.generate_input()
    return raiko, gi, raiko.get_output(gi)


def phase_host_poseidon2() -> dict:
    """The host Poseidon2 that the transcript and the verifier run: the C
    library (``ops/poseidon2_host.py``), which must load (no fallback),
    against ``host_permute`` on 200 seeded states and the edge states,
    with both times per permutation on this machine's host."""
    import numpy as np

    from raiko_tpu_torch.fields import babybear as bb
    from raiko_tpu_torch.ops import poseidon2 as p2
    from raiko_tpu_torch.ops import poseidon2_host as p2h

    implementation = p2h.implementation()
    states = np.random.default_rng(SEED).integers(0, bb.P, (200, 16)).tolist() + [[0] * 16, [bb.P - 1] * 16]
    equal = all(p2h.permute(st) == p2.host_permute(st) for st in states)
    t0 = time.perf_counter()
    for st in states:
        p2h.permute(st)
    c_us = (time.perf_counter() - t0) / len(states) * 1e6
    t0 = time.perf_counter()
    for st in states[:50]:
        p2.host_permute(st)
    python_us = (time.perf_counter() - t0) / 50 * 1e6
    row = {"implementation": implementation, "equal_python": equal, "c_us_per_permutation": c_us,
           "python_us_per_permutation": python_us}
    emit("host_poseidon2", **row)
    if not equal:
        raise AssertionError("the C host Poseidon2 differs from host_permute")
    return row


def phase_block_prove() -> dict:
    """The tpu_stark backend on the card under the default config: the
    golden's 10-tx block through ``Raiko(..., "cuda").prove`` against the
    JAX payload, then a 100-tx block served as a v2 ``tpu_stark`` request;
    the transcript and the verifier must run the C host Poseidon2.
    Returns the served request's launches and its payload's verification,
    started in the background (``BackgroundVerify``)."""
    import copy
    import hashlib

    import torch

    from raiko_tpu_torch import kernels
    from raiko_tpu_torch.host.cli import BackgroundServer
    from raiko_tpu_torch.ops import poseidon2_host as p2h
    from raiko_tpu_torch.provers import tpu_stark
    from raiko_tpu_torch.testing.workload import build_chain

    def sha(obj) -> str:
        return hashlib.sha256(json.dumps(obj, sort_keys=True).encode()).hexdigest()

    t_phase = time.perf_counter()
    host_p2 = phase_host_poseidon2()
    p2h.CALLS.reset()
    with open(os.path.join(ROOT, "tests", "golden", f"stark_{BLOCK_GOLDEN}.json")) as f:
        g = json.load(f)
    cuda = torch.device("cuda")
    build_chain(1, g["inputs"]["txs"], cuda)
    raiko, gi, out = block_request(cuda, BLOCK_ARGS)
    if gi.block_header.hash().hex() != g["block_hash"] or out.hash.hex() != g["instance_hash"]:
        raise AssertionError("the 10-tx block or its instance hash differs from the JAX golden's")
    torch.cuda.synchronize()
    kernels.LAUNCHES.reset()
    with StatementMeter() as meter:
        proof, ms = once_ms(lambda: raiko.prove(gi, out))
    launches = kernels.LAUNCHES.snapshot()
    payload = json.loads(proof.proof)
    verified, verify_ms = once_ms(lambda: tpu_stark.verify_payload(payload, cuda))
    # the first covered frame claims one gas less than it has left
    bad = copy.deepcopy(payload)
    bad["evm"]["frames"][0]["frames"][0]["gas_f"] -= 1
    evm = payload.get("evm", {})
    checks = {
        "equal_golden": sha(payload) == g["sha256"],
        "statements_equal_golden": {slot: sha(payload[slot]) for slot in sorted(payload)} == g["statements"],
        "evm_covered": evm.get("covered") == g["evm_covered"] == 9,
        "prestate": "prestate" in payload,
        "input_equal_golden": proof.input_hash == g["input"],
        "kzg_proof_equal_golden": proof.kzg_proof == g["kzg_proof"],
        "verified": verified,
        "tampered_gas_rejected": not tpu_stark.verify_payload(bad, cuda),
    }
    p2_calls = p2h.CALLS.snapshot()
    emit_statements("10tx", payload, meter, None)
    emit("block_prove", block="10tx", txs=len(gi.transactions), prover_args=BLOCK_ARGS, prove_s=ms / 1e3,
         verify_s=verify_ms / 1e3, tables=sum(statement_tables(payload).values()),
         evm_trees=len(evm.get("frames", [])), launches=launches, payload_bytes=len(proof.proof),
         host_poseidon2=host_p2["implementation"], host_poseidon2_calls=sum(p2_calls.values()),
         sha256=sha(payload), golden_sha256=g["sha256"], jax_cpu_prove_s=g["jax_cpu_prove_seconds"], **checks)
    if not all(checks.values()):
        differ = [slot for slot, want in g["statements"].items() if sha(payload.get(slot)) != want]
        raise AssertionError(f"10-tx block: {checks}; statements that differ from the JAX golden: {differ}")
    missing = [k for k in STARK if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"10-tx block: kernels not launched by the proof: {missing}")
    if not p2_calls.get("raiko_p2_absorb") or not p2_calls.get("raiko_p2_row_path_ok"):
        raise AssertionError(f"the transcript or the verifier did not run the C host Poseidon2: {p2_calls}")

    # the 100-tx block served as a v2 tpu_stark request, then as native
    port = _free_port()
    argv = ["--device", "cuda", "--address", "127.0.0.1", "--port", str(port), "--log-level", "warning"]
    base = f"http://127.0.0.1:{port}"
    served = {}
    with BackgroundServer(argv) as srv:
        build_chain(1, BLOCK_SERVED_TXS, srv.device)
        for proof_type in ("tpu_stark", "native"):
            # the request's prover args sit beside its fields (ProofRequest.from_opt)
            body = {"block_number": 1, "network": "taiko_a7", "proof_type": proof_type}
            if proof_type == "tpu_stark":
                body.update(BLOCK_SERVED_ARGS)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.LAUNCHES.reset()
            with StatementMeter() as meter:
                t0 = time.perf_counter()
                r = _post(f"{base}/v2/proof", body)
                while r["status"] == "ok" and r["data"].get("status") in ("registered", "work_in_progress"):
                    if time.perf_counter() - t0 > 900:
                        raise TimeoutError(f"{proof_type}: no proof after 900 s")
                    time.sleep(0.2)
                    r = _post(f"{base}/v2/proof", body)
                seconds = time.perf_counter() - t0
            if r["status"] != "ok" or r["data"].get("status") != "success":
                raise AssertionError(f"100-tx {proof_type} request ended as {r}")
            served[proof_type] = (r["data"]["proof"], seconds, kernels.LAUNCHES.snapshot(),
                                  torch.cuda.max_memory_allocated() / 1e9, meter)
    stark_proof, seconds, launches, peak_gb, meter = served["tpu_stark"]
    payload = json.loads(stark_proof["proof"])
    pending = BackgroundVerify("tpu_stark", payload)
    _, _, host_out = block_request(None, BLOCK_SERVED_ARGS)
    evm = payload.get("evm", {})
    checks = {
        "evm": 0 < len(evm.get("frames", [])) == evm.get("covered") <= BLOCK_SERVED_FRAMES,
        "prestate": "prestate" in payload,
        "kzg_proof_equal_native": stark_proof["kzg_proof"] == served["native"][0]["kzg_proof"],
        "input_equal_host": stark_proof["input"] == "0x" + host_out.hash.hex(),
    }
    emit_statements("100tx", payload, meter, None)
    emit("block_prove", block="100tx", served=True, prover_args=BLOCK_SERVED_ARGS,
         max_evm_frames=BLOCK_SERVED_FRAMES, seconds_per_request=seconds, tables=sum(statement_tables(payload).values()), evm_trees=len(evm.get("frames", [])),
         evm_covered=evm.get("covered"), evm_total=evm.get("total"), launches=launches, peak_device_gb=peak_gb,
         payload_bytes=len(stark_proof["proof"]), native_seconds=served["native"][1],
         host_poseidon2_calls=sum(p2h.CALLS.snapshot().values()), phase_s=time.perf_counter() - t_phase,
         **checks)
    if not all(checks.values()):
        raise AssertionError(f"served 100-tx tpu_stark block: {checks}")
    missing = [k for k in BLOCK if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the served tpu_stark block: {missing}")
    return launches, pending


class SpanMeter:
    """Seconds of the ``recursion.circuit`` spans and of the prover's
    stages (``stark.*``) while it is entered, from any thread."""

    def __enter__(self):
        from raiko_tpu_torch.utils.measurement import Measurement

        self.seconds: dict = {}
        self._token = Measurement.subscribe(self._record)
        return self

    def __exit__(self, *exc):
        from raiko_tpu_torch.utils.measurement import Measurement

        Measurement.unsubscribe(self._token)

    def _record(self, title: str, seconds: float) -> None:
        if title == "recursion.circuit" or title.startswith("stark."):
            self.seconds[title] = self.seconds.get(title, 0.0) + seconds

    def take(self) -> dict:
        out, self.seconds = self.seconds, {}
        return out


def outer_run(fn):
    """(result, seconds, launches, peak device GB, spans, profile) of one
    synchronised call of `fn` under torch.profiler, the counts set to 0
    just before it; the profile's fields are the whole call's device ms and
    its ``stark.quotient`` ranges' wall ms, device ms and launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from raiko_tpu_torch import kernels

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.LAUNCHES.reset()
    with SpanMeter() as spans, profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("outer_run"):
            out, ms = once_ms(fn)
    launches = kernels.LAUNCHES.snapshot()
    quotient = statement_quotient(prof, "outer_run")[""]
    row = {"device_ms": sum(e.self_device_time_total for e in prof.events()) / 1e3,
           **{f"quotient_{k}": v for k, v in quotient.items()}}
    return out, ms / 1e3, launches, torch.cuda.max_memory_allocated() / 1e9, spans.take(), row


def serve_request(base: str, body: dict, limit_s: float) -> tuple[dict, float, dict]:
    """(proof, seconds, launches) of one v2 request polled to its end, the
    counts set to 0 just before it; raises unless it ends in success."""
    import torch

    from raiko_tpu_torch import kernels

    torch.cuda.synchronize()
    kernels.LAUNCHES.reset()
    t0 = time.perf_counter()
    r = _post(f"{base}/v2/proof", body)
    while r["status"] == "ok" and r["data"].get("status") in ("registered", "work_in_progress"):
        if time.perf_counter() - t0 > limit_s:
            raise TimeoutError(f"{body['proof_type']}: no proof after {limit_s} s")
        time.sleep(0.2)
        r = _post(f"{base}/v2/proof", body)
    seconds = time.perf_counter() - t0
    if r["status"] != "ok" or r["data"].get("status") != "success":
        raise AssertionError(f"{body['proof_type']} request ended as {r}")
    return r["data"]["proof"], seconds, kernels.LAUNCHES.snapshot()


def payload_sha(obj) -> str:
    """sha256 of ``json.dumps(obj, sort_keys=True)``, as the goldens keep it."""
    import hashlib

    return hashlib.sha256(json.dumps(obj, sort_keys=True).encode()).hexdigest()


def load_golden(case: str) -> dict:
    with open(os.path.join(ROOT, "tests", "golden", f"stark_{case}.json")) as f:
        return json.load(f)


def stage_ms(spans: dict) -> dict:
    """The prover's stage spans of a ``SpanMeter`` in ms, by stage."""
    return {k.removeprefix("stark.") + "_ms": v * 1e3 for k, v in spans.items() if k.startswith("stark.")}


def seal_transcript() -> dict:
    """The transcript payload's seal against the JAX golden, its
    verification and its artifact through the on-chain verifier; emits the
    ``seal`` line and returns the seal's launches."""
    import torch

    from raiko_tpu_torch.core.provider import SimBlockDataProvider
    from raiko_tpu_torch.provers import onchain, seal, tpu_stark
    from raiko_tpu_torch.testing.chainsim import ChainSim, install_proof_verifier

    cuda = torch.device("cuda")
    g = load_golden(SEAL_GOLDEN)
    payload = tpu_stark.prove_transcript(SEAL_IH, cuda)
    if payload_sha(payload) != g["payload_sha256"]:
        raise AssertionError("the transcript payload differs from the seal golden's")
    s, prove_s, launches, peak_gb, spans, quotient = outer_run(lambda: seal.prove_block_seal(payload, cuda))
    with SpanMeter() as vspans:
        verified, verify_ms = once_ms(lambda: seal.verify_block_seal(payload, s, cuda))
    artifact = seal.seal_artifact(payload, s)
    chain = ChainSim("ethereum", device=None)
    verifier_addr = b"\x53" * 20
    install_proof_verifier(chain, verifier_addr, cuda)
    provider = SimBlockDataProvider(chain)
    checks = {
        "equal_golden": payload_sha(s) == g["sha256"],
        "verified": verified,
        "stripped_verified": seal.verify_block_seal(seal.strip_payload(payload), s, cuda),
        "other_instance_rejected": not seal.verify_block_seal(dict(payload, instance_hash=bytes(32).hex()), s, cuda),
        "other_shapes_rejected": not seal.verify_block_seal(
            payload, dict(s, shapes=[[x + 1 for x in grp] for grp in s["shapes"]]), cuda),
        "onchain_verified": onchain.verify_proof_onchain(provider, verifier_addr, SEAL_IH, artifact),
        "onchain_zero_journal_rejected": not onchain.verify_proof_onchain(provider, verifier_addr, bytes(32),
                                                                          artifact),
    }
    emit("seal", case=SEAL_GOLDEN, circuit_s=spans.get("recursion.circuit", 0.0), prove_s=prove_s,
         verify_s=verify_ms / 1e3, verify_circuit_s=vspans.take().get("recursion.circuit", 0.0),
         stages_ms=stage_ms(spans), outer_tables=[[d["log_n"], d["width"]] for d in s["outer"]],
         shapes=s["shapes"], launches=launches, **quotient, peak_device_gb=peak_gb,
         seal_bytes=len(json.dumps(s)), artifact_bytes=len(artifact), profiled=True, sha256=payload_sha(s),
         golden_sha256=g["sha256"], jax_cpu_prove_s=g["jax_cpu_prove_seconds"], **checks)
    if not all(checks.values()):
        raise AssertionError(f"the transcript seal: {checks}")
    missing = [k for k in STARK if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"the transcript seal: kernels not launched: {missing}")
    return launches


def recursive_shards() -> dict:
    """The recursively aggregated transcript shards against the JAX golden;
    returns the ``tpu_shard`` line's fields for them."""
    import torch

    from raiko_tpu_torch.provers import tpu_shard

    cuda = torch.device("cuda")
    g = load_golden(SHARD_GOLDEN)
    shards, prove_s, launches, peak_gb, spans, quotient = outer_run(
        lambda: tpu_shard.prove_sharded_recursive(SEAL_IH, cuda))
    with SpanMeter() as vspans:
        verified, verify_ms = once_ms(lambda: tpu_shard.verify_sharded_recursive(shards, cuda))
    bad = dict(shards, boundaries=[list(b) for b in shards["boundaries"]])
    bad["boundaries"][1][0] = (bad["boundaries"][1][0] + 1) % 2013265921
    checks = {"equal_golden": payload_sha(shards) == g["sha256"], "verified": verified,
              "other_boundary_rejected": not tpu_shard.verify_sharded_recursive(bad, cuda)}
    if not all(checks.values()):
        raise AssertionError(f"the recursive shards: {checks}")
    missing = [k for k in STARK if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"the recursive shards: kernels not launched: {missing}")
    return {"circuit_s": spans.get("recursion.circuit", 0.0), "prove_s": prove_s, "verify_s": verify_ms / 1e3,
            "verify_circuit_s": vspans.take().get("recursion.circuit", 0.0), "stages_ms": stage_ms(spans),
            "outer_tables": [[d["log_n"], d["width"]] for d in shards["outer"]], "launches": launches, **quotient,
            "peak_device_gb": peak_gb, "payload_bytes": len(json.dumps(shards)), "profiled": True,
            "sha256": payload_sha(shards), "golden_sha256": g["sha256"],
            "jax_cpu_prove_s": g["jax_cpu_prove_seconds"], **checks}


def serve_sealed_block() -> None:
    """The golden's 10-tx block as a sealed ``tpu_stark`` request through
    the port's server; emits the ``sealed_block`` line."""
    import torch

    from raiko_tpu_torch.host.cli import BackgroundServer
    from raiko_tpu_torch.provers import tpu_stark
    from raiko_tpu_torch.testing.workload import build_chain

    port = _free_port()
    argv = ["--device", "cuda", "--address", "127.0.0.1", "--log-level", "warning", "--port", str(port)]
    with BackgroundServer(argv) as srv:
        build_chain(1, SEALED_TXS, srv.device)
        body = {"block_number": 1, "network": "taiko_a7", "proof_type": "tpu_stark", **SEALED_ARGS}
        sealed, seconds, launches = serve_request(f"http://127.0.0.1:{port}", body, 900)
    payload = json.loads(sealed["proof"])
    verified, verify_ms = once_ms(lambda: tpu_stark.verify_payload(payload, torch.device("cuda")))
    slot = payload.get("seal", {})
    checks = {"seal_slot": "seal" in payload, "n_groups": slot.get("n_groups") == 1,
              "unsealed": slot.get("unsealed", 0) > 0, "verified": verified,
              "evm": 0 < len(payload.get("evm", {}).get("frames", [])) <= SEALED_FRAMES}
    emit("sealed_block", block=f"{SEALED_TXS}tx", prover_args=SEALED_ARGS, max_evm_frames=SEALED_FRAMES,
         seconds_per_request=seconds, verify_s=verify_ms / 1e3, launches=launches,
         sealed_groups=slot.get("n_groups"), unsealed_tables=slot.get("unsealed"),
         seal_bytes=len(json.dumps(slot)), payload_bytes=len(sealed["proof"]), **checks)
    if not all(checks.values()):
        raise AssertionError(f"the sealed {SEALED_TXS}-tx tpu_stark block: {checks}")


def serve_shard_block() -> dict:
    """Through the port's server: a 100-tx block as ``tpu_shard`` (recursion
    on), ``native``, ``tee`` and ``remote`` (to a second port server).
    Returns the ``tpu_shard`` line's fields for them, its launches under
    ``served_launches`` and the payload's verification, started in the
    background, under ``pending``."""
    import tempfile

    import torch

    from raiko_tpu_torch.core.interfaces import ProofType
    from raiko_tpu_torch.core.provider import SimBlockDataProvider
    from raiko_tpu_torch.host.cli import BackgroundServer
    from raiko_tpu_torch.provers import base as provers_base
    from raiko_tpu_torch.provers.tee import TeeProver
    from raiko_tpu_torch.testing.chainsim import ChainSim, install_sgx_verifier
    from raiko_tpu_torch.testing.workload import build_chain
    from raiko_tpu_torch.utils import secp256k1

    provers_base.get_prover(ProofType.TEE)  # the registry's own tee prover is loaded first
    port, worker_port = _free_port(), _free_port()
    argv = ["--device", "cuda", "--address", "127.0.0.1", "--log-level", "warning", "--port"]
    base = f"http://127.0.0.1:{port}"
    with tempfile.TemporaryDirectory() as key_dir, BackgroundServer(argv + [str(port)]) as srv, \
            BackgroundServer(argv + [str(worker_port)]):
        tee = TeeProver(key_dir=key_dir)
        tee_info = tee.bootstrap()
        provers_base.register(tee)
        build_chain(1, BLOCK_SERVED_TXS, srv.device)
        body = {"block_number": 1, "network": "taiko_a7"}
        torch.cuda.reset_peak_memory_stats()
        with SpanMeter() as spans:
            shard, served_s, launches = serve_request(base, {**body, "proof_type": "tpu_shard", **SHARD_SERVED_ARGS},
                                                      900)
        served_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        native, native_s, _ = serve_request(base, {**body, "proof_type": "native"}, 300)
        tee_proof, tee_s, _ = serve_request(base, {**body, "proof_type": "tee"}, 300)
        remote, remote_s, _ = serve_request(
            base, {**body, "proof_type": "remote", "endpoint": f"http://127.0.0.1:{worker_port}",
                   "remote_proof_type": "native", "poll_interval": 0.2}, 300)
        # the tee instance registers with the chain's SGX verifier (its key
        # lives in key_dir)
        sgx_chain = ChainSim("ethereum", device=None)
        sgx_addr = b"\x51" * 20
        registry = install_sgx_verifier(sgx_chain, sgx_addr)
        instance_id = tee.register_instance(SimBlockDataProvider(sgx_chain), sgx_addr)
    served_spans = spans.take()
    payload = json.loads(shard["proof"])
    pending = BackgroundVerify("tpu_shard", payload)
    raw = bytes.fromhex(tee_proof["proof"][2:])
    ih = bytes.fromhex(tee_proof["input"][2:])
    sig_r, sig_s, sig_v = int.from_bytes(raw[24:56], "big"), int.from_bytes(raw[56:88], "big"), raw[88]
    evm = payload.get("evm", {})
    checks = {
        "recursive_transcript": payload["transcript"]["kind"] == "poseidon2-transcript-sharded-recursive-v1",
        "evm": 0 < len(evm.get("frames", [])) == evm.get("covered") <= SHARD_SERVED_FRAMES,
        "kzg_proof_equal_native": shard["kzg_proof"] == native["kzg_proof"],
        "input_bound": shard["input"] == "0x" + payload["instance_hash"],
        "tee_signed_by_instance": len(raw) == 89 and "0x" + raw[4:24].hex() == tee_info["new_instance"]
        and secp256k1.ecrecover(ih, sig_v, sig_r, sig_s) == raw[4:24],
        "tee_registered": instance_id == 1 and "0x" + registry["instances"][1].hex() == tee_info["new_instance"],
        "remote_equal_native": remote["input"] == native["input"] and remote["kzg_proof"] == native["kzg_proof"],
    }
    if not all(checks.values()):
        raise AssertionError(f"the served tpu_shard, tee and remote requests: {checks}")
    missing = [k for k in BLOCK if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the served tpu_shard block: {missing}")
    return {"served_block": f"{BLOCK_SERVED_TXS}tx", "served_prover_args": SHARD_SERVED_ARGS,
            "max_evm_frames": SHARD_SERVED_FRAMES, "shard_workers": SHARD_WORKERS, "served_seconds": served_s,
            "served_circuit_s": served_spans.get("recursion.circuit", 0.0),
            "served_stages_ms": stage_ms(served_spans), "served_launches": launches,
            "served_peak_device_gb": served_peak_gb, "served_payload_bytes": len(shard["proof"]),
            "shards": payload.get("shards"), "evm_trees": len(evm.get("frames", [])), "evm_total": evm.get("total"),
            "native_seconds": native_s, "tee_seconds": tee_s, "remote_seconds": remote_s, **checks,
            "pending": pending}


def phase_seal() -> dict:
    """The recursion seal and the tpu_shard backend on the card: the served
    ``tpu_shard``, ``native``, ``tee`` and ``remote`` requests, the seal of
    the transcript payload and the recursive shards of the same instance
    hash against their JAX goldens, the sealed ``tpu_stark`` block, then
    the served ``tpu_shard`` payload's verification, which ran in the
    background meanwhile.  Returns the launches of the seal and of the
    served ``tpu_shard`` request."""
    t0 = time.perf_counter()
    served = serve_shard_block()
    pending = served.pop("pending")
    seal_launches = seal_transcript()
    shard_row = recursive_shards()
    serve_sealed_block()
    verified, verify_s = pending.result()
    emit("tpu_shard", case=SHARD_GOLDEN, **shard_row, **served, served_verify_s=verify_s,
         served_verify_background=True, served_verified=verified, phase_s=time.perf_counter() - t0)
    if not verified:
        raise AssertionError("the served tpu_shard payload does not verify")
    return {"seal": seal_launches, "tpu_shard": served["served_launches"]}


# the payload verifiers a BackgroundVerify process runs, by kind
VERIFIERS = {"tpu_stark": ("raiko_tpu_torch.provers.tpu_stark", "verify_payload"),
             "tpu_shard": ("raiko_tpu_torch.provers.tpu_shard", "verify_block_sharded")}
_BACKGROUND: list = []  # BackgroundVerify processes not yet collected, stopped when main() ends


class BackgroundVerify:
    """A served payload's verification on the card in a process of its own
    (``chip_smoke.py --verify KIND PATH``), started as soon as the payload
    is in: verification is mostly host work, as long as the proof, and in a
    process of its own it overlaps the run's next phases."""

    def __init__(self, kind: str, payload: dict):
        import tempfile

        fd, self.path = tempfile.mkstemp(prefix=f"chip_smoke_{kind}_", suffix=".json")
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f)
        self.kind = kind
        self.proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--verify", kind, self.path],
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)
        _BACKGROUND.append(self)

    def result(self) -> tuple[bool, float]:
        """(verified, the verification's seconds in its process); raises if
        the process failed."""
        try:
            out, err = self.proc.communicate(timeout=900)
        finally:
            self.close()
            _BACKGROUND.remove(self)
        if self.proc.returncode != 0:
            raise AssertionError(f"the {self.kind} verification process failed "
                                 f"(rc {self.proc.returncode}): {err[-3000:]}")
        row = json.loads(out.strip().splitlines()[-1])
        return row["verified"], row["seconds"]

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        if os.path.exists(self.path):
            os.remove(self.path)


def verify_payload_file(kind: str, path: str, device) -> dict:
    """The ``--verify`` process: one payload file through its verifier."""
    import importlib

    module, name = VERIFIERS[kind]
    verify = getattr(importlib.import_module(module), name)
    with open(path) as f:
        payload = json.load(f)
    verified, ms = once_ms(lambda: verify(payload, device))
    return {"kind": kind, "verified": verified, "seconds": ms / 1e3}


def refused_modules() -> list[str]:
    """Modules of JAX or of the JAX package loaded in this process (the
    refusal above lets none)."""
    return sorted(m for m, mod in sys.modules.items() if m.split(".")[0] in REFUSED and mod is not None)


def phase_profile(out_dir: str, n_blocks: int, n_txs: int) -> None:
    """Where the time of a dense blob commitment, of a keccak-chunk STARK
    proof and of a served request goes: synchronised stage times, then
    torch.profiler's device time against wall time (the busy share), for
    the proof by stage.  Tables go to `out_dir`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from raiko_tpu_torch import convert, kernels
    from raiko_tpu_torch.chain import SupportedChainSpecs
    from raiko_tpu_torch.core.interfaces import ProofRequest, ProofType
    from raiko_tpu_torch.core.orchestrator import Raiko
    from raiko_tpu_torch.kzg import eip4844
    from raiko_tpu_torch.ops import ec_cuda, msm
    from raiko_tpu_torch.testing.workload import build_chain

    cuda = torch.device("cuda")
    os.makedirs(out_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def device_ms(prof) -> tuple[float, dict, dict]:
        """Total device time of the run, the four largest kernels, and the
        time of each of the port's own kernels (namespace raiko).  The
        prover's stage ranges (``stark.*``) also appear on the device's
        timeline; they are spans, not work, and are left out, as are the
        statements' ranges (``tpu_stark.*``)."""
        per_name: dict[str, float] = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and not e.name.startswith(("stark.", "tpu_stark.")):
                per_name[e.name[:60]] = per_name.get(e.name[:60], 0.0) + e.time_range.elapsed_us() / 1e3
        top = dict(sorted(per_name.items(), key=lambda kv: -kv[1])[:4])
        ours = {name: ms for name, ms in per_name.items() if "raiko" in name}
        return sum(per_name.values()), top, ours

    def save(prof, name: str) -> None:
        with open(os.path.join(out_dir, name), "w") as f:
            f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=25))

    blob = random_blob(SEED + 1)
    points32 = convert.pack32(eip4844._device_setup(cuda))
    limbs = torch.as_tensor(eip4844.blob_to_limbs(blob).astype("int64"), device=cuda).unsqueeze(0)
    fold_in = points32[:256].reshape(1, 256, 3, ec_cuda.NLIMBS32).contiguous()
    eip4844.blob_to_kzg_commitment(blob, cuda)  # warm-up
    for rep in range(3):
        _, commit_ms = once_ms(lambda: eip4844.blob_to_kzg_commitment(blob, cuda))
        buckets, bucket_ms = once_ms(lambda: msm.bucket_matrix(points32, limbs))
        _, combine_ms = once_ms(lambda: msm.combine_buckets(buckets))
        _, fold_ms = once_ms(lambda: ec_cuda.ec_weighted_fold(fold_in))
        emit("profile_msm", rep=rep, commit_ms=commit_ms, bucket_matrix_ms=bucket_ms,
             combine_ms=combine_ms, fold_ms=fold_ms)

    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            eip4844.blob_to_kzg_commitment(blob, cuda)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_ms, top, ours = device_ms(prof)
    emit("profile_commit", commits=5, wall_ms=wall_ms, device_ms=dev_ms, busy_share=dev_ms / wall_ms,
         top_device_ms=top, kernels_device_ms=ours)
    save(prof, "profile_commit.txt")

    # a warm keccak-chunk STARK proof: the device time of each stage (its
    # torch.profiler range, kernels launched inside it) against its wall time
    from raiko_tpu_torch.stark import prover

    air, trace, publics, _ = golden_case("keccak_chunk")
    prover.prove(air, trace, publics, device="cuda")  # warm-up
    torch.cuda.synchronize()
    kernels.LAUNCHES.reset()
    with profile(activities=activities) as prof:
        _, wall_ms = once_ms(lambda: prover.prove(air, trace, publics, device="cuda"))
    dev_ms, top, ours = device_ms(prof)
    stage_wall, stage_dev = {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name.startswith("stark."):
            stage_wall[e.name] = stage_wall.get(e.name, 0.0) + e.cpu_time_total / 1e3
            stage_dev[e.name] = stage_dev.get(e.name, 0.0) + e.device_time_total / 1e3
    emit("profile_prove", case="keccak_chunk", wall_ms=wall_ms, device_ms=dev_ms, busy_share=dev_ms / wall_ms,
         stage_wall_ms=stage_wall, stage_device_ms=stage_dev, launches=kernels.LAUNCHES.snapshot(),
         top_device_ms=top, kernels_device_ms=ours)
    save(prof, "profile_prove.txt")

    build_chain(n_blocks, n_txs, cuda)
    for blk in range(1, n_blocks + 1):
        req = ProofRequest(block_number=blk, network="taiko_a7", proof_type=ProofType.NATIVE)
        raiko = Raiko(SupportedChainSpecs(), req, cuda)
        kernels.LAUNCHES.reset()
        with profile(activities=activities) as prof:
            gi, pre_ms = once_ms(raiko.generate_input)
            out, out_ms = once_ms(lambda: raiko.get_output(gi))
            _, prove_ms = once_ms(lambda: raiko.prove(gi, out))
        wall_ms = pre_ms + out_ms + prove_ms
        dev_ms, top, ours = device_ms(prof)
        emit("profile_request", block=blk, preflight_ms=pre_ms, get_output_ms=out_ms, prove_ms=prove_ms,
             wall_ms=wall_ms, device_ms=dev_ms, busy_share=dev_ms / wall_ms,
             launches=kernels.LAUNCHES.snapshot(), top_device_ms=top, kernels_device_ms=ours)
        save(prof, f"profile_request{blk}.txt")

    # block 1 as a tpu_stark request (phase block_prove serves it): the
    # device and wall time of each statement.  The profiler sees the ranges
    # of this thread only, so the EVM statement proves its trees here, one
    # after another, instead of on its thread pool.
    raiko, gi, out = block_request(cuda, BLOCK_SERVED_ARGS)
    kernels.LAUNCHES.reset()
    workers = os.environ.get("RAIKO_FRAME_WORKERS")
    os.environ["RAIKO_FRAME_WORKERS"] = "1"
    try:
        with StatementMeter() as meter, profile(activities=activities) as prof:
            proof, wall_ms = once_ms(lambda: raiko.prove(gi, out))
    finally:
        if workers is None:
            os.environ.pop("RAIKO_FRAME_WORKERS")
        else:
            os.environ["RAIKO_FRAME_WORKERS"] = workers
    dev_ms, top, ours = device_ms(prof)
    payload = json.loads(proof.proof)
    emit_statements("100tx", payload, meter, statement_device_ms(prof))
    quotient = statement_quotient(prof)
    trees = len(payload.get("evm", {}).get("frames", []))
    emit("profile_block_prove", block=1, txs=len(gi.transactions), wall_ms=wall_ms, device_ms=dev_ms,
         busy_share=dev_ms / wall_ms, tables=sum(statement_tables(payload).values()),
         launches=kernels.LAUNCHES.snapshot(), top_device_ms=top, kernels_device_ms=ours,
         quotient=quotient, evm_trees=trees,
         evm_quotient_launches_per_tree=quotient.get("evm", {}).get("launches", 0) / max(trees, 1),
         evm_quotient_share_of_block=quotient.get("evm", {}).get("wall_ms", 0.0) / wall_ms)
    save(prof, "profile_block_prove.txt")


def main(argv=None) -> int:
    import argparse

    pin_hash_seed([os.path.abspath(__file__), *sys.argv[1:]])
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="DIR",
                        help="profile a commitment and three served-path requests instead, "
                             "writing torch.profiler's tables into DIR")
    parser.add_argument("--verify", nargs=2, metavar=("KIND", "PATH"),
                        help="verify one payload file on the card and print the result as JSON "
                             "(the run's background verifications)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device")
    sys.path.insert(0, ROOT)
    if args.verify:
        print(json.dumps(verify_payload_file(*args.verify, torch.device("cuda"))), flush=True)
        return 0
    from raiko_tpu_torch import convert

    t_start = time.perf_counter()
    card = phase_device()
    pending_sass = phase_build()
    if args.profile:
        phase_profile(os.path.abspath(args.profile), n_blocks=3, n_txs=100)
        check_mxu_sass(pending_sass)
        emit("refused", loaded=refused_modules())
        return 0
    setup32 = convert.pack32(convert.setup_points(torch.device("cuda")))
    kres = phase_kernels(card, setup32)
    kres.update(phase_stark_kernels(card))
    ops_results, ops_launches = phase_ops(card, setup32)
    kres.update(ops_results)
    check_mxu_sass(pending_sass)
    phase_kzg()
    per_request, launches, served = phase_serve("cuda", n_blocks=1, n_txs=100)
    emit("serve", requests=len(per_request), seconds_per_request=per_request, launches=launches)
    missing = [k for k in SERVED if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the served path: {missing}")
    stark_launches = phase_stark()
    missing = [k for k in STARK if stark_launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the commitment path: {missing}")
    launches.update({k: stark_launches[k] for k in STARK})
    proof_launches = phase_stark_prove()
    launches.update(ops_launches)
    check_requests(served)
    block_launches, pending = phase_block_prove()
    seal_launches = phase_seal()
    verified, verify_s = pending.result()
    emit("block_verify", block="100tx", verify_s=verify_s, background=True, verified=verified)
    if not verified:
        raise AssertionError("the served 100-tx tpu_stark payload does not verify")
    loaded = refused_modules()
    emit("refused", loaded=loaded, seconds=time.perf_counter() - t_start)
    if loaded:
        raise AssertionError(f"JAX or the JAX package was loaded: {loaded}")
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCES[k][0], "replaces": SOURCES[k][1],
         "launches": launches[k], "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None, "timing": r["timing"],
         "events_ms": r["events_ms"], "launches_per_keccak_proof": proof_launches.get(k, 0),
         "launches_per_block_proof": block_launches.get(k, 0),
         "launches_per_transcript_seal": seal_launches["seal"].get(k, 0),
         "launches_per_shard_request": seal_launches["tpu_shard"].get(k, 0)}
        for k, r in kres.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        for _proc in _BACKGROUND:
            _proc.close()
