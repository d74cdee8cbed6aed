#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``raiko_tpu_torch``).

    python3 chip_smoke.py             # the smoke run below
    python3 chip_smoke.py --profile DIR   # where a commitment's and a request's time goes

Needs one CUDA card and the repository checkout around this file.  JAX is
refused before anything is imported, so an import of it anywhere on the
port's path fails the run.  Each phase prints one JSON line; any failure
raises and exits non-zero.

1. device: the card's name and power limit, as nvidia-smi reports them;
2. build: compile the CUDA sources under raiko_tpu_torch/csrc with nvcc;
3. kernels: each kernel of the served path against its plain PyTorch
   version on the card, bit for bit, at the path's shapes, with both times:
   B1 ec_add at M = 131,072, B2 ec_weighted_fold at B = 1 and 4 (J = 256),
   B4 shamir_ladder at B = 128 real signatures;
4. kzg: the zero blob's versioned hash against its published value, and a
   random full blob's commitment and opening proof against the host
   reference, the proof passing verify_kzg_proof;
5. serve: the port's proof service (``raiko_tpu_torch.host.cli --device
   cuda``) answers v2 ``native`` proof requests for three 100-tx taiko_a7
   blob blocks from the chain simulator; the kernels' launch counts are
   reset just before the requests and must all be positive after them;
6. check: the reference orchestrator proves each block again on its host
   path (host MSM, per-tx sender recovery; ``seams.host_path``), and each
   served ``input`` and ``kzg_proof`` must equal its result, the proof
   verifying; no JAX module was loaded.

The last two lines are the kernels' summary and the device line.

``--profile DIR`` runs phases 1-2, then times the stages of one dense blob
commitment, and puts five commitments and each of three served-path
requests (through the port's orchestrator) under torch.profiler: device
time against wall time, launches, the top kernels.  The profiler's tables
go to DIR/profile_*.txt.
"""

from __future__ import annotations

import sys

# The card's machine may have JAX installed.  Refuse it before anything is
# imported: a None entry makes ``import jax`` raise ModuleNotFoundError
# (and ``importlib.util.find_spec`` report it absent), so nothing on the
# port's path can reach JAX unnoticed.
for _name in ("jax", "jaxlib"):
    sys.modules[_name] = None

import json
import os
import socket
import subprocess
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 20240613


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


def once_ms(fn):
    """(result, milliseconds) of one synchronised call."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def max_abs_err(a, b) -> int:
    """Largest difference between two int32 tensors of u32 limbs."""
    return int(((a.long() & 0xFFFFFFFF) - (b.long() & 0xFFFFFFFF)).abs().max().item())


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda, nvidia_smi=smi)
    return smi


def phase_build():
    from raiko_tpu_torch import kernels

    t0 = time.perf_counter()
    kernels.library()
    with open(kernels.BUILD_INFO["log"]) as f:
        ptxas = [ln.strip() for ln in f if "registers" in ln or "spill" in ln]
    emit("build", seconds=time.perf_counter() - t0, nvcc_seconds=kernels.BUILD_INFO["seconds"],
         ptxas=ptxas)


def phase_kernels(setup32):
    import numpy as np
    import torch

    from raiko_tpu_torch import convert
    from raiko_tpu_torch.host.reference import secp256k1 as host
    from raiko_tpu_torch.kzg import curve
    from raiko_tpu_torch.ops import ec_cuda, secp, secp_cuda

    rng = np.random.default_rng(SEED)
    pick = lambda k: setup32[torch.as_tensor(rng.integers(0, setup32.shape[0], k), device="cuda")]
    results = {}

    # B1 at the blob MSM's width: p affine (Z = 1), q general projective
    m = 131_072
    p = pick(m)
    q = ec_cuda.ec_add_plain(pick(m), pick(m))
    inf = convert.pack32(curve.identity((64,), "cuda"))
    q[:64] = p[:64]  # P + P: doubling through the complete formula
    q[64:128] = inf  # P + infinity
    p[128:192] = inf  # infinity + Q
    p[192:256] = inf  # infinity + infinity
    q[192:256] = inf
    got = ec_cuda.ec_add(p, q)
    want, plain_ms = once_ms(lambda: ec_cuda.ec_add_plain(p, q))
    err = max_abs_err(got, want)
    ms = cuda_ms(lambda: ec_cuda.ec_add(p, q), 20)
    emit("kernel", name="ec_add", shape=[m, 3, 12], equal=bool(torch.equal(got, want)),
         max_abs_err=err, ms=ms, plain_ms=plain_ms)
    if not torch.equal(got, want):
        raise AssertionError("B1 ec_add differs from its plain version")
    results["ec_add"] = (err, ms, plain_ms)

    # B2 at the MSM's J = 256, batch 1 (one blob) and 4 (msm_multi)
    for bsz in (1, 4):
        v = pick(bsz * 256).reshape(bsz, 256, 3, 12).contiguous()
        got = ec_cuda.ec_weighted_fold(v)
        want, plain_ms = once_ms(lambda: ec_cuda.ec_weighted_fold_plain(v))
        err = max_abs_err(got, want)
        ms = cuda_ms(lambda: ec_cuda.ec_weighted_fold(v), 5)
        emit("kernel", name="ec_weighted_fold", shape=[bsz, 256, 3, 12],
             equal=bool(torch.equal(got, want)), max_abs_err=err, ms=ms, plain_ms=plain_ms)
        if not torch.equal(got, want):
            raise AssertionError(f"B2 ec_weighted_fold differs from its plain version at B={bsz}")
        if bsz == 1:
            results["ec_weighted_fold"] = (err, ms, plain_ms)

    # B4 at 128 real signatures
    items = []
    for i in range(128):
        msg = rng.bytes(32)
        r, s, rec = host.sign(msg, int.from_bytes(rng.bytes(31), "big") + 1)
        items.append((msg, r, s, rec))
    _, base_np, idx_np = secp.ladder_inputs(items)
    base = convert.pack32(torch.as_tensor(base_np, device="cuda"))
    idx = torch.as_tensor(idx_np, device="cuda")
    got = secp_cuda.shamir_ladder(base, idx)
    want, plain_ms = once_ms(lambda: secp_cuda.shamir_ladder_plain(base, idx))
    err = max_abs_err(got, want)
    ms = cuda_ms(lambda: secp_cuda.shamir_ladder(base, idx), 5)
    pubs = [secp.to_affine(pt) for pt in convert.unpack32(got).cpu().numpy()]
    ok_pubs = pubs == [host.recover_pubkey(*it) for it in items]
    emit("kernel", name="shamir_ladder", shape=[128, 2, 3, 8], equal=bool(torch.equal(got, want)),
         max_abs_err=err, ms=ms, plain_ms=plain_ms, pubkeys_match_host=ok_pubs)
    if not torch.equal(got, want) or not ok_pubs:
        raise AssertionError("B4 shamir_ladder differs from its plain version or the host")
    results["shamir_ladder"] = (err, ms, plain_ms)
    return results


def random_blob(seed: int) -> bytes:
    """A full blob of random field elements."""
    import numpy as np

    from raiko_tpu_torch.host.reference import kzg

    rng = np.random.default_rng(seed)
    words = rng.integers(0, 256, (kzg.FIELD_ELEMENTS_PER_BLOB, 32), dtype=np.uint8)
    words[:, 0] &= 0x3F  # < 2^254 < the BLS12-381 scalar modulus
    return words.tobytes()


def phase_kzg():
    import torch

    from raiko_tpu_torch import seams
    from raiko_tpu_torch.host.reference import kzg as ref
    from raiko_tpu_torch.kzg import eip4844

    cuda = torch.device("cuda")
    zero = eip4844.blob_to_kzg_commitment(bytes(ref.BYTES_PER_BLOB), device=cuda)
    zero_vh = ref.commitment_to_version_hash(zero).hex()
    if zero_vh != "010657f37554c781402a22917dee2f75def7ab966d7b770905398eba3c444014":
        raise AssertionError(f"zero-blob versioned hash {zero_vh}")

    blob = random_blob(SEED + 1)
    t0 = time.perf_counter()
    commit = eip4844.blob_to_kzg_commitment(blob, device=cuda)
    commit_s = time.perf_counter() - t0
    z = ref.get_evaluation_point(blob, ref.commitment_to_version_hash(commit))
    with seams.bound(cuda):
        t0 = time.perf_counter()
        proof, y = ref.compute_kzg_proof(blob, z, use_tpu=None)
        proof_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_commit = ref.blob_to_kzg_commitment(blob, use_tpu=False)
    host_proof, host_y = ref.compute_kzg_proof(blob, z, use_tpu=False)
    host_s = time.perf_counter() - t0
    verified = ref.verify_kzg_proof(commit, z, y, proof)
    emit("kzg", zero_blob_versioned_hash="0x" + zero_vh, commitment_equal=commit == host_commit,
         proof_equal=(proof, y) == (host_proof, host_y), proof_verifies=verified,
         device_commit_s=commit_s, device_proof_s=proof_s, host_commit_and_proof_s=host_s)
    if commit != host_commit or (proof, y) != (host_proof, host_y) or not verified:
        raise AssertionError("device KZG differs from the host reference or does not verify")


def build_chain(n_blocks: int, n_txs: int):
    """The 100-tx taiko_a7 blob-block workload of tools/bench_block.py
    (80% storage churn over 20 contracts, 10% transfers, 10% calls into a
    contract that CALLs another and the identity precompile), n_blocks
    times, registered with the provider.  Returns the L2 sim."""
    from chainsim import ChainSim, TaikoSim
    from raiko_tpu_torch.host import reference as ref

    keys = [0xBE7C + i for i in range(8)]
    senders = [ref.secp256k1.pubkey_to_address(ref.secp256k1.pubkey(k)) for k in keys]
    ref.clear_sims()
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
        tx = ref.Transaction(tx_type=2, chain_id=167009, nonce=nonces[si], max_priority_fee_per_gas=1,
                         max_fee_per_gas=100, gas_limit=gas, to=to, value=value)
        tx.sign(keys[si])
        nonces[si] += 1
        return tx

    for blk in range(n_blocks):
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
    ref.register_sim("ethereum", l1)
    ref.register_sim("taiko_a7", l2)
    return l2


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

    port = _free_port()
    argv = ["--device", device, "--address", "127.0.0.1", "--port", str(port), "--log-level", "warning"]
    with BackgroundServer(argv) as srv:
        t0 = time.perf_counter()
        build_chain(n_blocks, n_txs)
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
    """Prove each served block again with the reference orchestrator on its
    host path; the served instance hash and KZG proof must equal its own,
    and the proof must verify."""
    from raiko_tpu_torch import seams
    from raiko_tpu_torch.host import reference as ref

    kzg = ref.kzg
    for blk, proof in enumerate(served, start=1):
        req = ref.ProofRequest(block_number=blk, network="taiko_a7", proof_type=ref.ProofType.NATIVE)
        raiko = ref.Raiko(ref.SupportedChainSpecs(), req)
        t0 = time.perf_counter()
        with seams.host_path():
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


def jax_modules() -> list[str]:
    """JAX modules loaded in this process (the refusal above lets none)."""
    return sorted(m for m, mod in sys.modules.items()
                  if m.split(".")[0] in ("jax", "jaxlib") and mod is not None)


def phase_profile(out_dir: str, n_blocks: int, n_txs: int) -> None:
    """Where the time of a dense blob commitment and of a served request
    goes: synchronised stage times, then torch.profiler's device time
    against wall time (the busy share).  Tables go to `out_dir`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from raiko_tpu_torch import convert, kernels, seams
    from raiko_tpu_torch.core.orchestrator import Raiko
    from raiko_tpu_torch.host import reference as ref
    from raiko_tpu_torch.kzg import eip4844
    from raiko_tpu_torch.ops import ec_cuda, msm

    cuda = torch.device("cuda")
    os.makedirs(out_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def device_ms(prof) -> tuple[float, dict]:
        """Total device time of the run, and the four largest kernels."""
        per_name: dict[str, float] = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                per_name[e.name[:60]] = per_name.get(e.name[:60], 0.0) + e.time_range.elapsed_us() / 1e3
        top = dict(sorted(per_name.items(), key=lambda kv: -kv[1])[:4])
        return sum(per_name.values()), top

    def save(prof, name: str) -> None:
        with open(os.path.join(out_dir, name), "w") as f:
            f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=25))

    blob = random_blob(SEED + 1)
    points32 = convert.pack32(eip4844._device_setup(cuda))
    limbs = torch.as_tensor(ref.kzg.blob_to_limbs(blob).astype("int64"), device=cuda).unsqueeze(0)
    fold_in = points32[:256].reshape(1, 256, 3, ec_cuda.NLIMBS32).contiguous()
    eip4844.blob_to_kzg_commitment(blob, device=cuda)  # warm-up
    for rep in range(3):
        _, commit_ms = once_ms(lambda: eip4844.blob_to_kzg_commitment(blob, device=cuda))
        buckets, bucket_ms = once_ms(lambda: msm.bucket_matrix(points32, limbs))
        _, combine_ms = once_ms(lambda: msm.combine_buckets(buckets))
        _, fold_ms = once_ms(lambda: ec_cuda.ec_weighted_fold(fold_in))
        emit("profile_msm", rep=rep, commit_ms=commit_ms, bucket_matrix_ms=bucket_ms,
             combine_ms=combine_ms, fold_ms=fold_ms)

    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            eip4844.blob_to_kzg_commitment(blob, device=cuda)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_ms, top = device_ms(prof)
    emit("profile_commit", commits=5, wall_ms=wall_ms, device_ms=dev_ms, busy_share=dev_ms / wall_ms,
         top_device_ms=top)
    save(prof, "profile_commit.txt")

    with seams.bound(cuda):  # block production re-executes the txs
        build_chain(n_blocks, n_txs)
    for blk in range(1, n_blocks + 1):
        req = ref.ProofRequest(block_number=blk, network="taiko_a7", proof_type=ref.ProofType.NATIVE)
        raiko = Raiko(ref.SupportedChainSpecs(), req, cuda)
        kernels.LAUNCHES.reset()
        with profile(activities=activities) as prof:
            gi, pre_ms = once_ms(raiko.generate_input)
            out, out_ms = once_ms(lambda: raiko.get_output(gi))
            _, prove_ms = once_ms(lambda: raiko.prove(gi, out))
        wall_ms = pre_ms + out_ms + prove_ms
        dev_ms, top = device_ms(prof)
        emit("profile_request", block=blk, preflight_ms=pre_ms, get_output_ms=out_ms, prove_ms=prove_ms,
             wall_ms=wall_ms, device_ms=dev_ms, busy_share=dev_ms / wall_ms,
             launches=kernels.LAUNCHES.snapshot(), top_device_ms=top)
        save(prof, f"profile_request{blk}.txt")


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="DIR",
                        help="profile a commitment and three served-path requests instead, "
                             "writing torch.profiler's tables into DIR")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device")
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from raiko_tpu_torch import convert

    phase_device()
    phase_build()
    if args.profile:
        phase_profile(os.path.abspath(args.profile), n_blocks=3, n_txs=100)
        emit("nojax", jax_modules=jax_modules())
        return 0
    setup32 = convert.pack32(convert.setup_points(torch.device("cuda")))
    kres = phase_kernels(setup32)
    phase_kzg()
    per_request, launches, served = phase_serve("cuda", n_blocks=3, n_txs=100)
    emit("serve", requests=len(per_request), seconds_per_request=per_request, launches=launches)
    missing = [k for k in kres if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the served path: {missing}")
    check_requests(served)
    loaded = jax_modules()
    emit("nojax", jax_modules=loaded)
    if loaded:
        raise AssertionError(f"JAX was loaded: {loaded}")
    sources = {
        "ec_add": ("raiko_tpu_torch/csrc/bls12_381_g1.cu", "raiko_tpu/ops/ec_pallas.py:244"),
        "ec_weighted_fold": ("raiko_tpu_torch/csrc/bls12_381_g1.cu", "raiko_tpu/ops/ec_pallas.py:302"),
        "shamir_ladder": ("raiko_tpu_torch/csrc/secp256k1_ladder.cu", "raiko_tpu/ops/secp_pallas.py:254"),
    }
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": sources[k][0], "replaces": sources[k][1],
         "launches": launches[k], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        for k, (err, ms, plain_ms) in kres.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
