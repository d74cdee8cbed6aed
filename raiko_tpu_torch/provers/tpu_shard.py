"""Shard-parallel TPU-STARK backend (the SP1-analog).

Round 3: the shards carry the REAL block statement.  The block proof
decomposes into independent prove_tables workloads — the SP1 shard model
(reference docs/README_Sp1.md SHARD_SIZE semantics, SURVEY.md §2.3(d)):

  - the Poseidon2 transcript binding of the instance hash, itself split
    at permutation boundaries into continuity-chained sub-shards (full
    16-lane boundary publics), optionally collapsed by recursive
    aggregation (stark/recursion.py);
  - each trie-containment DAG (post-state, tx, receipts) and the
    ancestor-chain statement;
  - each covered EVM execution frame (the dominant parallel axis on
    real blocks: one shard per transaction frame);
  - the pre-state binding's keccak-path statement.

Shards are dispatched concurrently (config ``shard_workers``); each is a
self-contained device workload, so on a multi-chip system shards map to
chips — and ``stark.prover.set_mesh`` additionally shards every
commitment INSIDE a shard across the mesh (parallel/stark_dist.py).
Verification = per-shard verification + the same cross-slot bindings as
the tpu_stark payload.

Port of raiko_tpu/provers/tpu_shard.py, copied but for the device:
``TpuShardProver.run`` takes ``ctx.device``, and every prove and verify
function here takes a ``device`` argument with no default (None: the
host path, the STARKs in torch on the CPU), which it passes to every
shard's prover or verifier.  The thread pool and the order in which its
futures are read are the reference's, so the payload is deterministic."""

from __future__ import annotations

import json
from concurrent.futures import Future

from ..core.interfaces import GuestError, Proof, ProofType
from ..evm.builder import calculate_block_header
from ..proto.instance import ProtocolInstance
from ..stark import prover as stark_prover
from ..stark import verifier as stark_verifier
from ..stark.airs.poseidon2_air import WIDTH, Poseidon2TranscriptAir
from ..stark.serde import proof_from_dict, proof_to_dict
from . import proof_cache
from .base import Prover, register
from .tpu_stark import NUM_BLOCKS, _stark_device, transcript_blocks

SHARD_BLOCKS = 2  # permutations per shard (power of two)


class TpuShardProver(Prover):
    proof_type = ProofType.TPU_SHARD

    def run(self, guest_input, output, config: dict, ctx) -> Proof:
        device = ctx.device
        collect: dict = {}
        header = calculate_block_header(guest_input, collect, device=device)
        pi = ProtocolInstance.new(guest_input, header, "SP1", device)
        ih = pi.instance_hash()
        if ih != output.hash:
            raise GuestError("instance hash mismatch in tpu_shard guest")
        config = config or {}
        cached = proof_cache.load_proof(config, "tpu_shard", ih)
        if cached is not None:
            return Proof(proof=json.dumps(cached), input_hash="0x" + ih.hex())
        payload = prove_block_sharded(ih, header, collect, config, device)
        proof_cache.save_proof(config, "tpu_shard", ih, payload)
        return Proof(proof=json.dumps(payload), input_hash="0x" + ih.hex())

    def cancel(self, key, id_store=None) -> None:
        pass


def prove_sharded(instance_hash: bytes, device, shard_blocks: int = SHARD_BLOCKS) -> dict:
    blocks = transcript_blocks(instance_hash)
    assert len(blocks) % shard_blocks == 0
    shards = []
    state = [0] * WIDTH
    boundaries = [list(state)]
    for off in range(0, len(blocks), shard_blocks):
        shard_blk = blocks[off : off + shard_blocks]
        air = Poseidon2TranscriptAir(
            shard_blk, initial_state=state, expose_full_state=True
        )
        final_state = air.compute_final_state()
        publics = air.publics_for(final_state)
        sp = stark_prover.prove(air, air.trace(), publics, _stark_device(device))
        shards.append({"blocks": shard_blk, "stark": proof_to_dict(sp)})
        state = final_state
        boundaries.append(list(state))
    return {
        "kind": "poseidon2-transcript-sharded-v1",
        "instance_hash": instance_hash.hex(),
        "shard_blocks": shard_blocks,
        "boundaries": boundaries,
        "digest": boundaries[-1][:8],
        "shards": shards,
    }


def _shard_tables(
    ih: bytes, shard_blocks: int, boundaries: list[list[int]]
) -> list:
    """The shard statement as recursion InnerTables: one Poseidon2
    transcript AIR per shard, publics chaining through the boundary
    states (SP1-style shard continuity, now enforced INSIDE one proof)."""
    from ..stark import recursion

    blocks = transcript_blocks(ih)
    log_n = (32 * shard_blocks).bit_length() - 1
    tables = []
    for i in range(len(blocks) // shard_blocks):
        air = Poseidon2TranscriptAir(
            blocks[i * shard_blocks : (i + 1) * shard_blocks],
            initial_state=boundaries[i],
            expose_full_state=True,
        )
        tables.append(
            recursion.InnerTable(air, log_n, air.publics_for(boundaries[i + 1]))
        )
    return tables


def prove_sharded_recursive(
    instance_hash: bytes, device, shard_blocks: int = SHARD_BLOCKS
) -> dict:
    """Shard proving + recursive aggregation: the S shard STARKs are
    verified inside ONE outer proof (stark/recursion.py), so the final
    artifact carries two STARKs regardless of shard count — the risc0/SP1
    aggregation model (SURVEY.md §7 step 6)."""
    from ..stark import recursion

    base = prove_sharded(instance_hash, device, shard_blocks)
    boundaries = base["boundaries"]
    tables = _shard_tables(instance_hash, shard_blocks, boundaries)
    inner = [proof_from_dict(s["stark"]) for s in base["shards"]]
    outer = recursion.prove_recursion(
        [[t] for t in tables], [[p] for p in inner], _stark_device(device)
    )
    return {
        "kind": "poseidon2-transcript-sharded-recursive-v1",
        "instance_hash": instance_hash.hex(),
        "shard_blocks": shard_blocks,
        "boundaries": boundaries,
        "digest": boundaries[-1][:8],
        "outer": [proof_to_dict(p) for p in outer],
    }


def verify_sharded_recursive(payload: dict, device) -> bool:
    if payload.get("kind") != "poseidon2-transcript-sharded-recursive-v1":
        return False
    from ..stark import recursion

    ih = bytes.fromhex(payload["instance_hash"])
    blocks = transcript_blocks(ih)
    sb = payload["shard_blocks"]
    nshards = len(blocks) // sb
    boundaries = payload["boundaries"]
    if len(boundaries) != nshards + 1:
        return False
    if boundaries[0] != [0] * WIDTH:
        return False
    if payload["digest"] != boundaries[-1][:8]:
        return False
    tables = _shard_tables(ih, sb, boundaries)
    outer = [proof_from_dict(d) for d in payload["outer"]]
    return recursion.verify_recursion([[t] for t in tables], outer, _stark_device(device))


def verify_sharded(payload: dict, device) -> bool:
    if payload.get("kind") != "poseidon2-transcript-sharded-v1":
        return False
    ih = bytes.fromhex(payload["instance_hash"])
    blocks = transcript_blocks(ih)
    sb = payload["shard_blocks"]
    nshards = len(blocks) // sb
    boundaries = payload["boundaries"]
    if len(payload["shards"]) != nshards or len(boundaries) != nshards + 1:
        return False
    if boundaries[0] != [0] * WIDTH:
        return False
    if payload["digest"] != boundaries[-1][:8]:
        return False
    for i, shard in enumerate(payload["shards"]):
        expect_blocks = blocks[i * sb : (i + 1) * sb]
        if [list(b) for b in shard["blocks"]] != expect_blocks:
            return False
        air = Poseidon2TranscriptAir(
            expect_blocks,
            initial_state=boundaries[i],
            expose_full_state=True,
        )
        sp = proof_from_dict(shard["stark"])
        # publics must chain: init = boundary[i] path, out = boundary[i+1]
        if sp.publics != air.publics_for(boundaries[i + 1]):
            return False
        if not stark_verifier.verify(air, sp, _stark_device(device)):
            return False
    return True


class _InlinePool:
    """A pool of one that runs each call when it is submitted, in the
    caller's thread."""

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def submit(self, fn, *args) -> Future:
        fut: Future = Future()
        try:
            fut.set_result(fn(*args))
        except BaseException as exc:  # delivered through the future, as a pool's
            fut.set_exception(exc)
        return fut


def prove_block_sharded(
    ih: bytes, header, collect: dict, config: dict, device
) -> dict:
    """Prove the block statement as independent shards dispatched over a
    thread pool (each shard = one prove_tables workload on ``device``)."""
    from concurrent.futures import ThreadPoolExecutor

    from ..stark.airs import evm_air as ea
    from . import tpu_stark as ts

    # under a mesh (stark.prover.set_mesh) the pool proves one shard at a
    # time: threads would enter the mesh's collectives in an order that
    # differs from rank to rank.  One worker runs the shards in submission
    # order in the caller's thread (on its CUDA device), and the payload
    # reads the results by key, so it is the same
    workers = stark_prover.pool_workers(max(1, int(config.get("shard_workers", 4))))
    recursion = bool(config.get("recursion"))

    tasks: dict = {}
    if recursion:
        tasks["transcript"] = lambda: prove_sharded_recursive(ih, device)
    else:
        tasks["transcript"] = lambda: prove_sharded(ih, device)
    if config.get("mpt_statement", True) and "state_trie" in collect:
        tasks["mpt"] = lambda: ts.prove_mpt_containment(
            collect["state_trie"],
            header.state_root,
            device,
            storage_tries=collect.get("storage_tries"),
        )
    if config.get("body_statement", True) and "tx_trie" in collect:
        from ..mpt.trie import hashed_preimages

        if hashed_preimages(collect["tx_trie"]):
            tasks["tx_mpt"] = lambda: ts.prove_mpt_containment(
                collect["tx_trie"], header.transactions_root, device
            )
        if hashed_preimages(collect["receipts_trie"]):
            tasks["receipts_mpt"] = lambda: ts.prove_mpt_containment(
                collect["receipts_trie"], header.receipts_root, device
            )
    if config.get("chain_statement", True) and collect.get("header_chain"):
        tasks["chain"] = lambda: ts.prove_header_chain(collect["header_chain"], device)

    # EVM frames: replay serially (host work), prove each as a shard
    frame_traces = []
    candidates = collect.get("frames") or []
    max_frames = int(config.get("max_evm_frames", 64))
    max_steps = int(config.get("max_evm_steps", 65536))
    if config.get("evm_statement", True):
        for cand in candidates:
            if len(frame_traces) == max_frames:
                break
            if not cand.get("success") or cand["gas"] >= 1 << 28:
                continue
            code = cand["code"]
            env = ea.FrameEnv(
                codesize=len(code),
                **{
                    k: int(cand.get(k, 0))
                    for k in ea.ENV_OPS
                    if k != "codesize"
                },
            )
            try:
                ft = ea.execute_frame(
                    code,
                    env,
                    int(cand["gas"]),
                    max_steps,
                    calldata=cand.get("calldata"),
                    storage=cand.get("storage"),
                    warm_slots=set(cand.get("warm_slots", ())),
                    world=cand.get("world") or {},
                    warm_addresses=set(cand.get("warm_addresses", ())),
                    acct_ctx=cand.get("acct_ctx") or {},
                )
            except ea.UncoveredFrame:
                continue
            if ft.gas_f != cand["gas_left"]:
                continue
            frame_traces.append(ft)

    with ThreadPoolExecutor(max_workers=workers) if workers > 1 else _InlinePool() as ex:
        futs = {k: ex.submit(fn) for k, fn in tasks.items()}
        frame_futs = [
            ex.submit(ea.prove_frame_trace, ft, _stark_device(device)) for ft in frame_traces
        ]
        payload: dict = {
            "kind": "block-sharded-v1",
            "instance_hash": ih.hex(),
            "transcript": futs.pop("transcript").result(),
        }
        for k, fut in futs.items():
            payload[k] = fut.result()
        frames = [f.result() for f in frame_futs]
    if frames:
        payload["evm"] = {
            "kind": "evm-frames-v1",
            "total": len(candidates),
            "covered": len(frames),
            "frames": frames,
        }
        if "chain" in payload and any(
            fr.get("storage")
            for grp in frames
            for fr in grp.get("frames", [])
        ):
            from .prestate import prove_prestate

            pre = prove_prestate(collect, device)
            if pre is not None:
                payload["prestate"] = pre
    payload["shards"] = 1 + len(futs) + len(frames)
    return payload


def verify_block_sharded(payload: dict, device) -> bool:
    """Per-shard verification + the tpu_stark cross-slot bindings, on
    ``device``."""
    from . import tpu_stark as ts

    if payload.get("kind") != "block-sharded-v1":
        return False
    ts_payload = payload.get("transcript") or {}
    ih_hex = payload.get("instance_hash")
    if ts_payload.get("instance_hash") != ih_hex:
        return False
    if ts_payload.get("kind") == "poseidon2-transcript-sharded-recursive-v1":
        if not verify_sharded_recursive(ts_payload, device):
            return False
    elif not verify_sharded(ts_payload, device):
        return False
    for slot in ("mpt", "tx_mpt", "receipts_mpt", "chain"):
        if slot in payload and not ts.verify_mpt_v2_payload(payload[slot], device):
            return False
    if "evm" in payload:
        if not ts.verify_evm_frames_payload(payload["evm"], device):
            return False
        from .prestate import verify_prestate_binding

        if not verify_prestate_binding(payload, device):
            return False
    return True


register(TpuShardProver())
