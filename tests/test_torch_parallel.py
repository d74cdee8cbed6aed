"""The port's distributed layer (``raiko_tpu_torch.parallel``) on the CPU,
D ranks of a gloo process group, against the JAX package's
``raiko_tpu.parallel`` and the single-device path.

The ranks are spawned once per world size, D = 2 and D = 4, both at
once, in a module-scoped fixture (``parallel.dryrun.start``); each rank
runs every check (``dryrun.rank_checks``) and returns plain numpy data,
and the JAX side and the port's single-device references are computed in
this process while the ranks run.  Inputs are made from a seed with numpy;
the tolerance is 0: BabyBear results bit for bit, EC results as affine
points.

1. ``ntt_dist`` at log_n 12 and 11 (R != C), its slices gathered, against
   the JAX ``make_ntt_dist`` on D virtual CPU devices and ``ops.ntt.ntt``;
2. ``make_trace_commit_dist``'s root (n = 64, W = 16·D) against JAX's;
3. ``make_commit_cols_dist`` against JAX's ``_commit_cols_local``: coeffs,
   LDE and every level, with column counts D does not divide;
4. ``make_msm_dist`` over 16 setup points against ``host_curve.g1_msm``;
5. the transcript AIR proven under ``set_mesh`` with every commitment
   sharded (``RAIKO_DIST_MIN_CELLS=0`` in the ranks): equals the
   single-device proof, hashes as its JAX golden, verifies, and every rank
   counted sharded commitments;
   ``commit_cols`` routes by the cutoff and ``set_mesh(None)`` restores
   the single-device path;
6. the dry run's small statements (the reference dry run's transcript
   payload, an MPT containment, a prestate keccak batch, two EVM frames, a
   ``tpu_shard`` block) meshed equal their single-device payloads and
   verify;
7. the frame pool and the shard pool run one worker under the mesh and
   give the unmeshed payload;
8. ``run_ranks`` raises within its timeout when a rank raises or hangs,
   and returns nothing partial.

The tests marked ``cuda`` run cases 1-5 with D = 2 ranks on the card
(gloo, both on cuda:0 where there is one card) against the port's
single-device path there and the goldens, and check that gloo takes CUDA
tensors in the two collectives the mesh uses.
"""

import json
import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from raiko_tpu.fields import babybear as jbb
from raiko_tpu.ops import ntt as jntt
from raiko_tpu.parallel.ntt_dist import make_ntt_dist as jmake_ntt_dist
from raiko_tpu.parallel.stark_dist import make_trace_commit_dist as jmake_trace_commit_dist
from raiko_tpu.stark import prover as jprover
from raiko_tpu_torch.kzg import eip4844, host_curve as hc
from raiko_tpu_torch.parallel import dryrun, mesh as meshmod
from raiko_tpu_torch.stark import prover

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
WORLDS = (2, 4)
NTT_LOGS = (12, 11)
COMMIT_SHAPES = ((10, 64), (16, 32), (3, 128))
TRACE = (64, 16)  # rows, columns per rank
MSM_N = 16
TIMEOUT_S = 240.0
REFUSED = ("jax", "jaxlib", "raiko_tpu")


def _golden(case: str) -> dict:
    with open(os.path.join(GOLDEN, f"stark_{case}.json")) as f:
        return json.load(f)


def _spec(proof_cases: tuple, statements: list) -> dict:
    goldens = {c: _golden(c) for c in proof_cases}
    return {
        "trace_commit": [TRACE],
        "ntt": list(NTT_LOGS),
        "commit_cols": list(COMMIT_SHAPES),
        "msm": [MSM_N],
        "proofs": {c: g["inputs"] for c, g in goldens.items()},
        "golden_sha256": {c: g["sha256"] for c, g in goldens.items()},
        "statements": statements,
        "refuse": REFUSED,
    }


def _jax_mesh_refs() -> dict:
    """The JAX ``parallel/`` functions on D of conftest's virtual devices."""
    refs = {}
    for d in WORLDS:
        jmesh = JMesh(np.array(jax.devices()[:d]), ("d",))
        for log_n in NTT_LOGS:
            xm = jbb.to_mont(jnp.asarray(dryrun.ntt_input(log_n)))
            refs[("ntt_dist", d, log_n)] = np.asarray(jmake_ntt_dist(jmesh, log_n)(xm))
        n, wr = TRACE
        refs[("trace_commit", d)] = np.asarray(jmake_trace_commit_dist(jmesh)(jnp.asarray(
            dryrun.trace_input(n, wr * d))))
    refs["msm"] = hc.g1_msm(eip4844.setup()["g1_lagrange"][:MSM_N], dryrun.msm_scalars(MSM_N))
    return refs


def _jax_single_refs() -> dict:
    """The JAX single-device functions (run in a process of their own)."""
    refs = {}
    for log_n in NTT_LOGS:
        refs[("ntt", log_n)] = np.asarray(jax.jit(jntt.ntt)(jbb.to_mont(jnp.asarray(dryrun.ntt_input(log_n)))))
    for k, n in COMMIT_SHAPES:
        c, lde, levels = jprover._commit_cols_local(jbb.to_mont(jnp.asarray(dryrun.cols_input(k, n))),
                                                    jbb.GENERATOR)
        refs[("commit_cols", k, n)] = (np.asarray(c), np.asarray(lde), [np.asarray(v) for v in levels])
    return refs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs files in parallel workers, and this file's ranks run
    # beside this process: one torch thread each
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def worlds():
    """Both worlds' rank results, the single-device references, the JAX
    side and the dry run's own check of each world."""
    spec = _spec(("transcript",), statements=list(dryrun.STATEMENTS))
    jobs = {}
    try:
        for d in WORLDS:
            jobs[d] = dryrun.start(d, "cpu", spec, timeout_s=TIMEOUT_S)
        # while the ranks run: the single-device references, one process a
        # statement and one for the rest, and the JAX side, half of it in a
        # process of its own
        parts = [{"statements": [name]} for name in spec["statements"]] + [dict(spec, statements=[])]
        for i, part in enumerate(parts):
            jobs[f"refs{i}"] = meshmod.start_ranks(dryrun.reference_rank, 1, "gloo", ["cpu"], timeout_s=TIMEOUT_S,
                                                   args=(part, WORLDS))
        with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as pool:
            single = pool.submit(_jax_single_refs)
            jax_refs = _jax_mesh_refs()
            jax_refs.update(single.result(timeout=TIMEOUT_S))
        with ThreadPoolExecutor(len(jobs)) as waiter:  # the processes end together
            done = dict(zip(jobs, waiter.map(lambda job: job.wait(), jobs.values())))
        refs = {"statements": {}, "statements_verified": {}}
        for i in range(len(parts)):
            for key, val in done[f"refs{i}"][0].items():
                if key in ("statements", "statements_verified"):
                    refs[key].update(val)
                else:
                    refs[key] = val
        results = {d: done[d] for d in WORLDS}
    finally:
        for job in jobs.values():
            job.stop()
    return {"spec": spec, "results": results, "refs": refs, "jax": jax_refs}


@pytest.mark.parametrize("d", WORLDS)
@pytest.mark.parametrize("log_n", NTT_LOGS)
def test_ntt_dist_equals_jax(worlds, d, log_n):
    for r in worlds["results"][d]:
        got = r["ntt"][log_n]
        np.testing.assert_array_equal(got, worlds["jax"][("ntt_dist", d, log_n)])
        np.testing.assert_array_equal(got, worlds["jax"][("ntt", log_n)])


@pytest.mark.parametrize("d", WORLDS)
def test_trace_commit_dist_equals_jax(worlds, d):
    want = worlds["jax"][("trace_commit", d)]
    assert want.shape == (8,) and want.any()
    for r in worlds["results"][d]:
        np.testing.assert_array_equal(r["trace_commit"][(TRACE[0], TRACE[1] * d)], want)


@pytest.mark.parametrize("d", WORLDS)
@pytest.mark.parametrize("shape", COMMIT_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_commit_cols_dist_equals_jax(worlds, d, shape):
    c1, lde1, levels1 = worlds["jax"][("commit_cols",) + shape]
    for r in worlds["results"][d]:
        c, lde, levels = r["commit_cols"][shape]
        np.testing.assert_array_equal(c, c1)
        np.testing.assert_array_equal(lde, lde1)
        assert len(levels) == len(levels1)
        for a, b in zip(levels, levels1):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("d", WORLDS)
def test_msm_dist_equals_host_oracle(worlds, d):
    want = worlds["jax"]["msm"]
    assert want is not None
    for r in worlds["results"][d]:
        assert r["msm"][MSM_N] == want


@pytest.mark.parametrize("d", WORLDS)
def test_meshed_transcript_proof_hashes_as_golden(worlds, d):
    want = worlds["spec"]["golden_sha256"]["transcript"]
    assert want.startswith("98d56f35")
    for r in worlds["results"][d]:
        assert dryrun.sha256(r["proofs"]["transcript"]) == want
        assert r["sharded"] >= 1  # the reference's meshed proof never sharded
        assert r["routing"] == {"below_cutoff": 0, "cutoff_0": 1, "unset": 0}


@pytest.mark.parametrize("d", WORLDS)
def test_dryrun_check_passes(worlds, d):
    """The dry run's own check: every rank alike and equal to the
    single-device path, the proof and the statements verified, every rank
    sharded, no refused module loaded."""
    rep = dryrun.check(worlds["results"][d], worlds["refs"], worlds["spec"], "cpu")
    assert rep["backend"] == "gloo" and rep["ranks"] == d
    assert rep["verified"] == {"transcript": True, **{name: True for name in dryrun.STATEMENTS}}
    assert min(rep["sharded_per_rank"]) >= 1


@pytest.mark.parametrize("d", WORLDS)
@pytest.mark.parametrize("name", dryrun.STATEMENTS)
def test_meshed_statements_equal_single(worlds, d, name):
    single = worlds["refs"]["statements"][name]
    assert json.loads(single)["kind"] in ("poseidon2-transcript-v1", "keccak-mpt-v2", "keccak-mpt-v1", "evm-frames-v1",
                                          "block-sharded-v1")
    for r in worlds["results"][d]:
        assert r["statements"][name] == single


@pytest.mark.parametrize("d", WORLDS)
def test_frame_pool_one_worker_under_mesh(worlds, d):
    """Two frames in a pool that asks for two workers: under the mesh every
    rank runs one, finishes and gives the unmeshed payload."""
    assert prover.pool_workers(dryrun.FRAME_WORKERS) == dryrun.FRAME_WORKERS  # no mesh here
    single = json.loads(worlds["refs"]["statements"]["evm_frames"])
    assert single["covered"] == len(dryrun.FRAME_CODES) == 2
    for r in worlds["results"][d]:
        assert r["pool_workers"]["evm_frames"] == 1
        assert json.loads(r["statements"]["evm_frames"]) == single


@pytest.mark.parametrize("d", WORLDS)
def test_shard_pool_one_worker_under_mesh(worlds, d):
    """A tpu_shard block of two items (a transcript of two shards and a
    frame) in a pool that asks for four workers: under the mesh every rank
    proves them in the caller's thread, one at a time, and gives the
    unmeshed payload."""
    assert prover.pool_workers(dryrun.SHARD_WORKERS) == dryrun.SHARD_WORKERS > 1  # no mesh here
    single = json.loads(worlds["refs"]["statements"]["shard_block"])
    assert single["shards"] == 2 and len(single["transcript"]["shards"]) == 2
    for r in worlds["results"][d]:
        assert r["pool_workers"]["shard_block"] == 1
        assert json.loads(r["statements"]["shard_block"]) == single


def _fails_on_rank_1(mesh):
    if mesh.rank == 1:
        raise ValueError("rank 1 fails")
    return meshmod.all_gather(mesh, torch.zeros(1))  # waits for rank 1


def _hangs(mesh):
    time.sleep(3600)


@pytest.mark.parametrize("fn, error", [(_fails_on_rank_1, "rank 1 fails"), (_hangs, "gave no result")],
                         ids=["raises", "hangs"])
def test_run_ranks_raises_within_timeout(fn, error):
    timeout_s = 30.0 if fn is _fails_on_rank_1 else 3.0
    t0 = time.monotonic()
    with pytest.raises((RuntimeError, TimeoutError), match=error):
        meshmod.run_ranks(fn, 2, "gloo", ["cpu"] * 2, timeout_s=timeout_s)
    assert time.monotonic() - t0 < timeout_s + 15


# --- the same on the card -------------------------------------------------


@pytest.fixture(scope="module")
def card_world():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    from raiko_tpu_torch import kernels

    kernels.library()  # build once, before the ranks load it
    spec = _spec(("transcript",), statements=[])
    job = dryrun.start(2, "cuda", spec, timeout_s=TIMEOUT_S)
    try:
        refs = dryrun.references("cuda", spec, (2,))
        results = job.wait()
    finally:
        job.stop()
    return {"spec": spec, "results": results, "refs": refs}


def _collectives(mesh):
    """The mesh's two collectives on int32 tensors of the rank's device."""
    x = torch.arange(8, dtype=torch.int32, device=mesh.device).reshape(4, 2) + 100 * mesh.rank
    return (meshmod.all_to_all(mesh, x, 0, 1).cpu().numpy(), meshmod.all_gather(mesh, x).cpu().numpy(),
            str(x.device))


@pytest.mark.cuda
def test_cuda_gloo_takes_cuda_tensors():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    got = meshmod.run_ranks(_collectives, 2, "gloo", ["cuda:0"] * 2, timeout_s=TIMEOUT_S)
    x = [np.arange(8, dtype=np.int32).reshape(4, 2) + 100 * r for r in range(2)]
    for r, (a2a, gathered, dev) in enumerate(got):
        assert dev == "cuda:0"
        np.testing.assert_array_equal(a2a, np.concatenate([x[0][2 * r:2 * r + 2], x[1][2 * r:2 * r + 2]], 1))
        np.testing.assert_array_equal(gathered, np.concatenate(x, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("log_n", NTT_LOGS)
def test_cuda_ntt_dist(card_world, log_n):
    for r in card_world["results"]:
        np.testing.assert_array_equal(r["ntt"][log_n], card_world["refs"][("ntt", log_n)])
        assert r["launches"].get("ntt", 0) > 0


@pytest.mark.cuda
def test_cuda_trace_commit_dist(card_world):
    n, wr = TRACE
    for r in card_world["results"]:
        np.testing.assert_array_equal(r["trace_commit"][(n, wr * 2)], card_world["refs"][("trace_commit", n, wr * 2)])
        assert r["launches"].get("poseidon2_compress", 0) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", COMMIT_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_cuda_commit_cols_dist(card_world, shape):
    c1, lde1, levels1 = card_world["refs"][("commit_cols",) + shape]
    for r in card_world["results"]:
        c, lde, levels = r["commit_cols"][shape]
        np.testing.assert_array_equal(c, c1)
        np.testing.assert_array_equal(lde, lde1)
        assert all(np.array_equal(a, b) for a, b in zip(levels, levels1)) and len(levels) == len(levels1)


@pytest.mark.cuda
def test_cuda_msm_dist(card_world):
    want = hc.g1_msm(eip4844.setup()["g1_lagrange"][:MSM_N], dryrun.msm_scalars(MSM_N))
    for r in card_world["results"]:
        assert r["msm"][MSM_N] == want == card_world["refs"][("msm", MSM_N)]
        assert r["launches"].get("ec_add", 0) > 0 and r["launches"].get("ec_weighted_fold", 0) > 0


@pytest.mark.cuda
def test_cuda_meshed_transcript_proof(card_world):
    rep = dryrun.check(card_world["results"], card_world["refs"], card_world["spec"], "cuda")
    assert rep["verified"] == {"transcript": True}
    for r in card_world["results"]:
        assert dryrun.sha256(r["proofs"]["transcript"]) == card_world["spec"]["golden_sha256"]["transcript"]
        assert r["sharded"] >= 1
