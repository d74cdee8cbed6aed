"""Multi-rank dry run: the port's counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``.

``dryrun_multichip(n_ranks, device, backend)`` spawns ``n_ranks`` ranks
(``mesh.start_ranks``), runs the distributed layer on them and holds every
result against the single-device path.  The calling process computes the
single-device results while the ranks start; the ranks wait for them to
finish before their timed checks, so no check shares the card with them:

- the sharded trace commitment (``stark_dist.make_trace_commit_dist``)
  against ``commit_step``'s root of the same trace;
- the distributed NTT (``ntt_dist``), its slices gathered, against ``ntt``;
- the prover's sharded ``commit_cols`` against ``commit_cols``;
- the distributed MSM against ``msm``, as affine points;
- proofs of the JAX goldens' inputs under ``stark.prover.set_mesh``
  against the single-device proofs and the goldens' sha256, verified;
- the small block statements meshed (the reference dry run's transcript
  payload, an MPT containment, a prestate keccak batch, two EVM frames on
  the frame pool, and a ``tpu_shard`` block of a sharded transcript and
  the first frame on the shard pool; both pools must run one worker
  under the mesh) against their single-device payloads, verified.

Unlike the reference's dry run, whose meshed proofs stayed under the
sharding cutoff, the ranks set ``RAIKO_DIST_MIN_CELLS`` to 0 so that every
commitment of these proofs takes the sharded path, and the run fails
unless every rank counted sharded commitments.  Inputs are made from a
seed, alike on every rank and in the caller.  On CUDA the kernel checks
(trace commitment, NTT, ``commit_cols``, MSM) are timed after a warm-up
call, ``REPS`` times each.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

from .. import convert
from ..fields import babybear as bb
from . import mesh as meshmod

SEED = 0
FRAME_CODES = (
    bytes([0x60, 5, 0x60, 7, 0x01, 0x50, 0x00]),  # PUSH1 5, PUSH1 7, ADD, POP, STOP
    bytes([0x60, 9, 0x60, 3, 0x01, 0x50, 0x00]),
)
FRAME_GAS = 30_000
FRAME_WORKERS = 2  # the pool size asked for: two frames, two items in the pool
# the tpu_shard block: a transcript of NUM_BLOCKS / SHARD_BLOCKS shards and
# the first frame, two items in a pool that asks for SHARD_WORKERS
SHARD_WORKERS = 4
SHARD_CONFIG = {"shard_workers": SHARD_WORKERS, "mpt_statement": False, "body_statement": False,
                "chain_statement": False}
STATEMENTS = ("transcript_payload", "mpt", "prestate", "evm_frames", "shard_block")
TRANSCRIPT_IH = b"dryrun block statement"  # hashed into the transcript's instance hash, as the reference's dry run
REPS = 5  # timed calls of each kernel check on CUDA, after one warm-up call

# the reference's dry run, with the cutoff lowered so its proofs shard
DEFAULT_SPEC = {
    "trace_commit": [(64, 16)],  # (rows, columns per rank)
    "ntt": [12],
    "commit_cols": [(10, 64)],
    "msm": [16],
    "proofs": {},  # case -> the golden's inputs
    "statements": list(STATEMENTS),  # names of STATEMENTS to prove
}


def _rng(*key: int) -> np.random.Generator:
    return np.random.default_rng([SEED, *key])


def trace_input(n: int, w: int) -> np.ndarray:
    """(n, w) uint32 standard-form trace."""
    return _rng(1, n, w).integers(0, bb.P, (n, w), dtype=np.uint32)


def ntt_input(log_n: int) -> np.ndarray:
    """(2^log_n,) uint32 standard-form values."""
    return _rng(2, log_n).integers(0, bb.P, 1 << log_n, dtype=np.uint32)


def cols_input(k: int, n: int) -> np.ndarray:
    """(k, n) uint32 standard-form columns."""
    return _rng(3, k, n).integers(0, bb.P, (k, n), dtype=np.uint32)


def msm_scalars(n: int) -> list[int]:
    from ..kzg import host_curve as hc

    rng = _rng(4, n)
    return [int.from_bytes(rng.bytes(32), "big") % hc.R for _ in range(n)]


def _msm_inputs(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The trusted setup's first n points, (n, 3, 24), and seeded scalars'
    limbs, (n, 16), on `device`."""
    from ..ops import msm

    points = convert.setup_points(device)[:n]
    limbs = torch.as_tensor(msm.scalars_to_limbs(msm_scalars(n)).astype(np.int64), device=device)
    return points, limbs


def canonical_proof(proof) -> str:
    from ..stark import serde

    return json.dumps(serde.proof_to_dict(proof), sort_keys=True)


def sha256(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()


def frame_candidates() -> list[dict]:
    """Two covered top-level frames, as ``prove_evm_frames`` takes them."""
    from ..stark.airs import evm_air as ea

    env = {"address": 0xA1, "caller": 0x99, "origin": 0x99}
    out = []
    for i, code in enumerate(FRAME_CODES):
        ft = ea.execute_frame(code, ea.FrameEnv(codesize=len(code), **env), FRAME_GAS)
        out.append({"tx_index": i, "success": True, "code": code, "gas": FRAME_GAS, "gas_left": ft.gas_f, **env})
    return out


def _small_trie():
    from ..mpt import MptNode, to_nibs
    from ..utils import keccak256

    trie = MptNode.null()
    for k in range(3):
        trie.insert(to_nibs(keccak256(bytes([k]))), b"\x55" * 40)
    return trie


def prove_statements(device, names=STATEMENTS) -> dict:
    """The dry run's small block statements `names` on `device` (meshed when
    the caller has set a mesh), as canonical JSON."""
    from ..provers import tpu_shard
    from ..provers import tpu_stark as ts
    from ..utils import keccak256

    trie = _small_trie()
    node0 = trie.encode()
    provers = {
        "transcript_payload": lambda: ts.prove_transcript(keccak256(TRANSCRIPT_IH), device),
        "mpt": lambda: ts.prove_mpt_containment(trie, trie.hash(), device),
        "prestate": lambda: ts.prove_keccak_batch_public([node0], keccak256(node0), device),
        "evm_frames": lambda: ts.prove_evm_frames(frame_candidates(), device, workers=FRAME_WORKERS),
        # no header: SHARD_CONFIG proves no statement that reads one
        "shard_block": lambda: tpu_shard.prove_block_sharded(keccak256(TRANSCRIPT_IH), None,
                                                             {"frames": frame_candidates()[:1]}, SHARD_CONFIG,
                                                             device),
    }
    return {k: json.dumps(provers[k](), sort_keys=True) for k in names}


def verify_statement(name: str, payload: str, device) -> bool:
    from ..provers import tpu_shard
    from ..provers import tpu_stark as ts

    obj = json.loads(payload)
    if name == "transcript_payload":
        return ts.verify_payload(obj, device)
    if name == "mpt":
        return ts.verify_mpt_v2_payload(obj, device)
    if name == "prestate":
        return ts.verify_mpt_payload(obj, device)
    if name == "shard_block":
        return tpu_shard.verify_block_sharded(obj, device)
    return ts.verify_evm_frames_payload(obj, device)


def _numpy(t: torch.Tensor) -> np.ndarray:
    return convert.bb_to_numpy(t)


def rank_checks(mesh: meshmod.Mesh, spec: dict, go=None) -> dict:
    """One rank's part of the dry run: every check of `spec` on `mesh`,
    each after a barrier and timed to a device synchronisation (a kernel
    check on CUDA after a warm-up call, ``REPS`` times: its median in
    ``ms``, every time in ``reps_ms``).  With `go` (an event of the spawn
    context) the rank waits for it before its first check.  Returns plain
    data: the results, the times, this rank's kernel launches and sharded
    commitments, which refused modules it loaded, and the wall clock
    (``time.time()``) when it was ready and when it was done."""
    from .. import kernels
    from ..kzg import curve
    from ..stark import prover
    from ..testing.goldens import golden_air
    from .msm_dist import make_msm_dist
    from .ntt_dist import gather_ntt, make_ntt_dist
    from .stark_dist import make_commit_cols_dist, make_trace_commit_dist

    # every commitment of the meshed proofs sharded (the reference's dry
    # run stayed under the cutoff)
    os.environ["RAIKO_DIST_MIN_CELLS"] = "0"
    dev = mesh.device
    out: dict = {"rank": mesh.rank, "size": mesh.size, "backend": mesh.backend, "device": str(dev),
                 "ms": {}, "reps_ms": {}}
    if dev.type == "cuda":
        kernels.library()  # loaded (built by the caller) before the clock starts
    out["t_ready"] = time.time()
    if go is not None and not go.wait(meshmod.DEFAULT_TIMEOUT_S):
        raise TimeoutError("the dry run's references did not finish")
    kernels.LAUNCHES.reset()
    prover.SHARDED.reset()
    reps = REPS if dev.type == "cuda" else 1

    def timed(name: str, fn, reps: int = 1):
        if reps > 1:
            meshmod.barrier(mesh)
            fn()  # warm-up
        times = []
        for _ in range(reps):
            meshmod.barrier(mesh)
            t0 = time.perf_counter()
            res = fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            times.append((time.perf_counter() - t0) * 1e3)
        out["ms"][name] = float(np.median(times))
        out["reps_ms"][name] = times
        return res

    for n, wr in spec.get("trace_commit", ()):
        trace, run = trace_input(n, wr * mesh.size), make_trace_commit_dist(mesh)
        root = timed(f"trace_commit_{n}x{wr * mesh.size}", lambda: run(trace), reps)
        out.setdefault("trace_commit", {})[(n, wr * mesh.size)] = _numpy(root)
    for log_n in spec.get("ntt", ()):
        x = bb.to_mont(convert.words_from_numpy(ntt_input(log_n), dev))
        run = make_ntt_dist(mesh, log_n)
        part = timed(f"ntt_2^{log_n}", lambda: run(x), reps)
        out.setdefault("ntt", {})[log_n] = _numpy(gather_ntt(mesh, part))
    commit = make_commit_cols_dist(mesh)
    for k, n in spec.get("commit_cols", ()):
        cols = bb.to_mont(convert.words_from_numpy(cols_input(k, n), dev))
        coeffs, lde, levels = timed(f"commit_cols_{k}x{n}", lambda: commit(cols, bb.GENERATOR), reps)
        out.setdefault("commit_cols", {})[(k, n)] = (_numpy(coeffs), _numpy(lde), [_numpy(v) for v in levels])
    for n in spec.get("msm", ()):
        points, limbs = _msm_inputs(n, dev)
        run = make_msm_dist(mesh)
        pt = timed(f"msm_{n}", lambda: run(points, limbs), reps)
        out.setdefault("msm", {})[n] = curve.to_affine(pt)
    prover.set_mesh(mesh)
    try:
        for case, inputs in spec.get("proofs", {}).items():
            air, trace, publics = golden_air(case, inputs)
            proof = timed(f"prove_{case}", lambda: prover.prove(air, trace, publics, dev))
            out.setdefault("proofs", {})[case] = canonical_proof(proof)
        if spec.get("statements"):
            out["pool_workers"] = {"evm_frames": prover.pool_workers(FRAME_WORKERS),
                                   "shard_block": prover.pool_workers(SHARD_WORKERS)}
            out["statements"] = timed("statements", lambda: prove_statements(dev, spec["statements"]))
    finally:
        prover.set_mesh(None)
    out["t_done"] = time.time()
    out["sharded"] = prover.SHARDED.snapshot().get("commit_cols", 0)
    out["launches"] = kernels.LAUNCHES.snapshot()
    out["routing"] = _routing(mesh)
    out["loaded"] = sorted(m for m, mod in sys.modules.items()
                           if m.split(".")[0] in spec.get("refuse", ()) and mod is not None)
    return out


def _routing(mesh: meshmod.Mesh) -> dict:
    """Sharded commitments counted by one 4 x 16 ``commit_cols``: with the
    mesh set under the default cutoff and at cutoff 0, and after
    ``set_mesh(None)``."""
    from ..stark import prover

    cols = bb.to_mont(convert.words_from_numpy(cols_input(4, 16), mesh.device))
    saved = os.environ.get("RAIKO_DIST_MIN_CELLS")
    out = {}
    try:
        for label, m, cells in (("below_cutoff", mesh, 1 << 18), ("cutoff_0", mesh, 0), ("unset", None, 0)):
            prover.set_mesh(m)
            os.environ["RAIKO_DIST_MIN_CELLS"] = str(cells)
            before = prover.SHARDED.snapshot().get("commit_cols", 0)
            prover.commit_cols(cols, bb.GENERATOR)
            out[label] = prover.SHARDED.snapshot().get("commit_cols", 0) - before
    finally:
        prover.set_mesh(None)
        if saved is None:
            os.environ.pop("RAIKO_DIST_MIN_CELLS", None)
        else:
            os.environ["RAIKO_DIST_MIN_CELLS"] = saved
    return out


def backend_for(n_ranks: int, device: str, backend: str | None = None) -> tuple[str, list[str]]:
    """The backend and each rank's device.  On the CPU: gloo.  On CUDA,
    unless `backend` names one, from the device count alone: NCCL with one
    GPU a rank when there are enough GPUs, else gloo with every rank on
    cuda:0 (NCCL refuses two ranks on one GPU)."""
    if torch.device(device).type == "cpu":
        return "gloo", ["cpu"] * n_ranks
    if backend is None:
        backend = "nccl" if torch.cuda.device_count() >= n_ranks else "gloo"
    return backend, [f"cuda:{r}" for r in range(n_ranks)] if backend == "nccl" else ["cuda:0"] * n_ranks


def start(n_ranks: int, device: str, spec: dict, backend: str | None = None,
          timeout_s: float = meshmod.DEFAULT_TIMEOUT_S, go=None) -> meshmod.Ranks:
    """Spawn the dry run's ranks and return at once (``Ranks.wait()``);
    with `go`, the ranks wait for that event before their checks."""
    backend, devices = backend_for(n_ranks, device, backend)
    return meshmod.start_ranks(rank_checks, n_ranks, backend, devices, timeout_s, args=(spec, go),
                               refuse=tuple(spec.get("refuse", ())))


def references(device, spec: dict, sizes: tuple) -> dict:
    """The single-device results `spec` is held against, on `device`, for
    dry runs of each world size in `sizes` (only the trace commitment's
    width depends on it)."""
    from ..kzg import curve
    from ..ops import msm, ntt
    from ..stark import prover
    from ..stark.commit_step import commit_step
    from ..testing.goldens import golden_air

    dev = torch.device(device)
    refs: dict = {}
    for n, wr in spec.get("trace_commit", ()):
        for w in sorted({wr * d for d in sizes}):
            refs[("trace_commit", n, w)] = _numpy(commit_step(trace_input(n, w), dev))
    for log_n in spec.get("ntt", ()):
        refs[("ntt", log_n)] = _numpy(ntt.ntt(bb.to_mont(convert.words_from_numpy(ntt_input(log_n), dev))))
    for k, n in spec.get("commit_cols", ()):
        c, lde, levels = prover.commit_cols(bb.to_mont(convert.words_from_numpy(cols_input(k, n), dev)),
                                            bb.GENERATOR)
        refs[("commit_cols", k, n)] = (_numpy(c), _numpy(lde), [_numpy(v) for v in levels])
    for n in spec.get("msm", ()):
        refs[("msm", n)] = curve.to_affine(msm.msm(*_msm_inputs(n, dev)))
    for case, inputs in spec.get("proofs", {}).items():
        refs[("proof", case)] = canonical_proof(prover.prove(*golden_air(case, inputs), dev))
    if spec.get("statements"):
        refs["statements"] = prove_statements(dev, spec["statements"])
        # the meshed payloads must equal these bytes, so these verifications
        # are theirs
        refs["statements_verified"] = {name: verify_statement(name, payload, dev)
                                       for name, payload in refs["statements"].items()}
    return refs


def reference_rank(mesh: meshmod.Mesh, spec: dict, sizes: tuple) -> dict:
    """``references`` computed by a rank of its own (a one-rank
    ``run_ranks``) on its device, beside the dry run's ranks; the mesh is
    not set, so it is the single-device path."""
    return references(mesh.device, spec, sizes)


def check(results: list[dict], refs: dict, spec: dict, device) -> dict:
    """Hold every rank's results against the single-device ones and the
    goldens; raise AssertionError on the first difference.  Returns the
    summary the caller prints."""
    from ..stark import serde, verifier
    from ..testing.goldens import golden_air

    dev = torch.device(device)
    n_ranks = len(results)
    r0 = results[0]

    def same_on_ranks(key):
        for r in results[1:]:
            a, b = r0.get(key), r.get(key)
            if json.dumps(_plain(a), sort_keys=True) != json.dumps(_plain(b), sort_keys=True):
                raise AssertionError(f"ranks 0 and {r['rank']} differ in {key}")

    for key in ("trace_commit", "ntt", "commit_cols", "msm", "proofs", "statements"):
        same_on_ranks(key)
    for (n, w), root in r0.get("trace_commit", {}).items():
        if not np.array_equal(root, refs[("trace_commit", n, w)]):
            raise AssertionError(f"the sharded trace commitment of {n} x {w} differs from commit_step's root")
    for log_n, got in r0.get("ntt", {}).items():
        if not np.array_equal(got, refs[("ntt", log_n)]):
            raise AssertionError(f"ntt_dist at 2^{log_n} differs from ntt")
    for (k, n), (c, lde, levels) in r0.get("commit_cols", {}).items():
        c1, lde1, levels1 = refs[("commit_cols", k, n)]
        if not (np.array_equal(c, c1) and np.array_equal(lde, lde1) and len(levels) == len(levels1)
                and all(np.array_equal(a, b) for a, b in zip(levels, levels1))):
            raise AssertionError(f"commit_cols_dist of {k} x {n} differs from commit_cols")
    for n, pt in r0.get("msm", {}).items():
        if pt != refs[("msm", n)]:
            raise AssertionError(f"msm_dist of {n} points differs from msm")
    verified = {}
    for case, canon in r0.get("proofs", {}).items():
        if canon != refs[("proof", case)]:
            raise AssertionError(f"the meshed {case} proof differs from the single-device proof")
        want = spec["golden_sha256"][case]
        if sha256(canon) != want:
            raise AssertionError(f"the meshed {case} proof hashes as {sha256(canon)}, its golden as {want}")
        air, _, _ = golden_air(case, spec["proofs"][case])
        verified[case] = verifier.verify(air, serde.proof_from_dict(json.loads(canon)), dev)
        if not verified[case]:
            raise AssertionError(f"the port's verifier rejects the meshed {case} proof")
    if spec.get("statements"):
        if any(set(r["pool_workers"].values()) != {1} for r in results):
            raise AssertionError(f"the pools ran {[r['pool_workers'] for r in results]} workers under the mesh")
        for name, payload in r0["statements"].items():
            if payload != refs["statements"][name]:
                raise AssertionError(f"the meshed {name} statement differs from the single-device payload")
            verified[name] = refs["statements_verified"][name]
            if not verified[name]:
                raise AssertionError(f"the meshed {name} statement does not verify")
    routing = [r["routing"] for r in results]
    if any(r != {"below_cutoff": 0, "cutoff_0": 1, "unset": 0} for r in routing):
        raise AssertionError(f"commit_cols routed {routing} (sharded commitments per case)")
    sharded = [r["sharded"] for r in results]
    if (spec.get("proofs") or spec.get("statements")) and min(sharded) <= 0:
        raise AssertionError(f"sharded commitments per rank {sharded}: the meshed proofs did not shard")
    loaded = sorted({m for r in results for m in r["loaded"]})
    if loaded:
        raise AssertionError(f"a rank loaded refused modules: {loaded}")
    launches: dict = {}
    for r in results:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return {"backend": r0["backend"], "ranks": n_ranks, "devices": [r["device"] for r in results],
            "ms": r0["ms"], "ms_max": {k: max(r["ms"][k] for r in results) for k in r0["ms"]},
            "reps_ms": r0["reps_ms"],
            "sharded_per_rank": sharded, "launches_per_rank": [r["launches"] for r in results],
            "launches": launches, "verified": verified}


def _plain(obj):
    """Results as JSON-able data, to compare ranks (an array by its dtype,
    shape and the sha256 of its bytes)."""
    if isinstance(obj, np.ndarray):
        return [str(obj.dtype), list(obj.shape), hashlib.sha256(obj.tobytes()).hexdigest()]
    if isinstance(obj, dict):
        return {str(k): _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    return obj


def dryrun_multichip(n_ranks: int, device: str = "cuda", backend: str | None = None, spec: dict | None = None,
                     timeout_s: float = meshmod.DEFAULT_TIMEOUT_S) -> dict:
    """Run the dry run on `n_ranks` ranks of `device` ("cuda" or "cpu") and
    hold it against the single-device path; returns the summary (backend,
    devices, each check's ms, sharded commitments and kernel launches per
    rank), or raises.  `backend` None chooses by ``backend_for``."""
    import multiprocessing

    spec = dict(DEFAULT_SPEC if spec is None else spec)
    go = multiprocessing.get_context("spawn").Event()
    t0 = time.time()
    ranks = start(n_ranks, device, spec, backend, timeout_s, go)
    try:
        refs = references(device, spec, (n_ranks,))  # while the ranks start
    except BaseException:
        ranks.stop()
        raise
    t_refs = time.time()
    go.set()
    results = ranks.wait()
    t_wait = time.time()
    rep = check(results, refs, spec, device)
    ready = max(r["t_ready"] for r in results)
    # where the dry run's wall time went: the references (in this process)
    # beside the ranks' start, the checks after both, then this check
    rep["seconds"] = {"ranks_ready": ready - t0, "references": t_refs - t0,
                      "checks": max(r["t_done"] for r in results) - max(ready, t_refs),
                      "stop": t_wait - max(r["t_done"] for r in results), "check": time.time() - t_wait}
    return rep


def main(argv=None) -> int:
    """``python -m raiko_tpu_torch.parallel.dryrun --ranks N --device cuda|cpu``:
    the dry run at ``DEFAULT_SPEC``'s sizes, its summary as one JSON line."""
    import argparse

    parser = argparse.ArgumentParser(description="the distributed layer against the single-device path")
    parser.add_argument("--ranks", type=int, default=2)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--backend", choices=("nccl", "gloo"), help="default: by the GPU count")
    parser.add_argument("--timeout", type=float, default=meshmod.DEFAULT_TIMEOUT_S)
    args = parser.parse_args(argv)
    if args.device == "cuda":
        from .. import device as device_mod, kernels

        device_mod.get("cuda")  # raises without a card
        kernels.library()  # built once here, loaded by the ranks
    t0 = time.perf_counter()
    rep = dryrun_multichip(args.ranks, args.device, args.backend, timeout_s=args.timeout)
    print(json.dumps({"dryrun": "ok", "seconds": time.perf_counter() - t0, **rep}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
