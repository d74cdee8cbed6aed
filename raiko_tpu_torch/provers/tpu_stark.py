"""TPU-STARK prover backend: bind the guest output into a STARK.

Port of raiko_tpu/provers/tpu_stark.py.  Block re-execution runs on the
host (like preflight), and the proving work (trace LDE, Merkle
commitments, DEEP quotient, FRI) runs through the port's STARK pipeline
(raiko_tpu_torch.stark) on the device the caller names.

The device is explicit: ``TpuStarkProver.run`` takes ``ctx.device``, and
every prove and verify function here takes a ``device`` argument with no
default.  ``None`` is the host path, as for the KZG: the re-execution's
sender recovery and the instance's blob commitment run on the host, and
the STARK runs in torch on ``"cpu"`` (the kernels' plain versions).  A
CUDA device runs every table's NTTs, row hashes and Merkle trees in the
hand-written kernels.

The statements are the reference's: the Poseidon2 transcript STARK over
the public message

    [DOMAIN_TAG, n_blocks, instance_hash as 16 x 16-bit chunks, 0-pad]

(a STARK-bound commitment to the protocol instance hash), then the
keccak-DAG statements that ``calculate_block_header`` feeds: the state and
storage tries (keccak-mpt-v2 containment, or the v1 preimage batches),
the tx and receipts tries, the receipts link and the ancestor chain.  The
payload and its keys are the reference's, byte for byte.

The EVM frame statement proves the block's covered call trees with the
EVM execution tables (stark/airs/evm_air.py), and the prestate binding
(provers/prestate.py) ties their storage originals and account records
to the parent state.

With ``"seal": true`` the whole payload is sealed into one outer proof
(provers/seal.py), as the reference does: a seal that fails is logged and
its slot left out, and ``verify_payload`` checks a ``seal`` slot against
the payload.

Each statement is a ``Measurement`` span (``tpu_stark.reexecute``,
``tpu_stark.stark``, ``tpu_stark.mpt``, ``tpu_stark.tx_mpt``,
``tpu_stark.receipts_mpt``, ``tpu_stark.chain``, ``tpu_stark.evm``,
``tpu_stark.prestate``, ``tpu_stark.seal``) and a ``torch.profiler`` range
of the same name.
The EVM statement proves its trees on a thread pool, so the spans of the
prover's stages inside it overlap, and each stage's closing
``torch.cuda.synchronize`` waits for the other tree's work too.
"""

from __future__ import annotations

import contextlib
import json

import torch

from ..core.interfaces import GuestError, Proof, ProofType
from ..evm.builder import calculate_block_header
from ..proto.instance import ProtocolInstance
from ..stark import prover as stark_prover
from ..stark import verifier as stark_verifier
from ..stark.airs.poseidon2_air import RATE, Poseidon2TranscriptAir
from ..stark.serde import proof_from_dict, proof_to_dict
from ..utils.measurement import Measurement
from . import proof_cache
from .base import Prover, register

DOMAIN_TAG = 0x52545031  # "RTP1"
NUM_BLOCKS = 4

def transcript_blocks(instance_hash: bytes, num_blocks: int = NUM_BLOCKS):
    """[tag, nblocks, hash chunks...] packed into RATE-wide blocks."""
    chunks = [
        int.from_bytes(instance_hash[2 * i : 2 * i + 2], "big") for i in range(16)
    ]
    elems = [DOMAIN_TAG, num_blocks] + chunks
    blocks = []
    for i in range(num_blocks):
        blk = elems[RATE * i : RATE * (i + 1)]
        blocks.append(blk + [0] * (RATE - len(blk)))
    return blocks


MAX_MPT_PERMS = 23  # keccak-batch trace budget: num_perms <= 32 (n = 1024)


def _stark_device(device):
    """The STARK's device: the caller's, or the CPU on the host path."""
    return "cpu" if device is None else device


@contextlib.contextmanager
def _statement(slot: str):
    with Measurement(f"tpu_stark.{slot}"), torch.profiler.record_function(f"tpu_stark.{slot}"):
        yield


class TpuStarkProver(Prover):
    proof_type = ProofType.TPU_STARK

    def run(self, guest_input, output, config: dict, ctx) -> Proof:
        device = ctx.device
        collect: dict = {}
        with _statement("reexecute"):
            header = calculate_block_header(guest_input, collect, device=device)
            pi = ProtocolInstance.new(guest_input, header, "RISC0", device)
            ih = pi.instance_hash()
        if ih != output.hash:
            raise GuestError("instance hash mismatch in tpu_stark guest")
        # receipt cache (reference bonsai.rs:104-151): a prior proof of
        # the same statement under the same config short-circuits proving
        cached = proof_cache.load_proof(config, "tpu_stark", ih)
        if cached is not None:
            return Proof(proof=json.dumps(cached), input_hash="0x" + ih.hex())
        with _statement("stark"):
            payload = prove_transcript(ih, device)
        v2 = int(config.get("mpt_version", 2)) >= 2
        if config.get("mpt_statement", True) and "state_trie" in collect:
            with _statement("mpt"):
                if v2:
                    payload["mpt"] = prove_mpt_containment(
                        collect["state_trie"],
                        header.state_root,
                        device,
                        storage_tries=collect.get("storage_tries"),
                    )
                else:
                    payload["mpt"] = prove_mpt_preimages(
                        collect["state_trie"],
                        header.state_root,
                        device,
                        storage_tries=collect.get("storage_tries"),
                    )
        # block-body tries + ancestor chain: the same succinct containment
        # system over the other keccak DAGs calculate_block_header checks
        # (reference builder.rs:191-264 roots, :350-372 ancestor chain)
        if v2 and config.get("body_statement", True) and "tx_trie" in collect:
            from ..mpt.trie import hashed_preimages

            for slot, trie, root in (
                ("tx_mpt", collect["tx_trie"], header.transactions_root),
                (
                    "receipts_mpt",
                    collect["receipts_trie"],
                    header.receipts_root,
                ),
            ):
                if hashed_preimages(trie):  # empty trie: nothing keccak'd
                    with _statement(slot):
                        payload[slot] = prove_mpt_containment(trie, root, device)
        # receipts-root linkage: publish the raw receipt fields so the
        # verifier can RE-DERIVE the receipts trie from them and compare
        # its root against the containment statement's.
        # Ref: builder.rs:191-264.
        if "receipts_mpt" in payload and collect.get("receipts"):
            payload["receipts"] = {
                "kind": "receipts-link-v1",
                "txs": [
                    {
                        "type": r.tx_type,
                        "status": r.status,
                        "cumulative_gas": r.cumulative_gas_used,
                        "logs": [
                            [
                                lg.address.hex(),
                                [bytes(t).hex() for t in lg.topics],
                                bytes(lg.data).hex(),
                            ]
                            for lg in r.logs
                        ],
                    }
                    for r in collect["receipts"]
                ],
            }
        if v2 and config.get("chain_statement", True) and collect.get(
            "header_chain"
        ):
            with _statement("chain"):
                payload["chain"] = prove_header_chain(collect["header_chain"], device)
        # EVM execution statement: prove covered top-level call frames
        # with the zkEVM tables (stark/airs/evm_air.py), the analog of
        # the zkVM guests' re-execution proof (reference
        # provers/risc0/guest/src/main.rs:15-29)
        if config.get("evm_statement", True) and collect.get("frames"):
            with _statement("evm"):
                evm = prove_evm_frames(
                    collect["frames"],
                    device,
                    max_frames=int(config.get("max_evm_frames", 64)),
                    max_steps=int(config.get("max_evm_steps", 65536)),
                )
            if evm is not None:
                payload["evm"] = evm
                # bind the frames' storage originals AND code/account
                # records to the parent state (provers/prestate.py);
                # requires the chain statement for the parent-header
                # anchor; produced for every covered frame set (code
                # binding), not just storage-touching ones.
                if "chain" in payload:
                    from .prestate import prove_prestate

                    try:
                        with _statement("prestate"):
                            pre = prove_prestate(collect, device)
                    except Exception as e:  # pragma: no cover
                        # a prestate failure must not kill the block
                        # proof; the payload stays verifiable-as-absent
                        # (verify_prestate_binding rejects it if frames
                        # touch storage, so this is visible, not silent)
                        import logging

                        logging.getLogger(__name__).warning(
                            "prestate binding failed: %s", e
                        )
                        pre = None
                    if pre is not None:
                        payload["prestate"] = pre
        # whole-payload recursion seal (reference snarks.rs:92-157
        # stark2snark): opt-in — the outer circuit pays O(width) gates
        # per inner query, so sealing multiplies proving time
        if config.get("seal"):
            from .seal import prove_block_seal

            try:
                with _statement("seal"):
                    payload["seal"] = prove_block_seal(
                        payload, device, max_tables=config.get("seal_max_tables")
                    )
            except Exception as e:  # pragma: no cover
                # an unsealable payload (e.g. mpt_version 1) must not
                # kill the block proof; absence of the slot is visible
                import logging

                logging.getLogger(__name__).warning("sealing failed: %s", e)
        proof_cache.save_proof(config, "tpu_stark", ih, payload)
        return Proof(
            proof=json.dumps(payload),
            input_hash="0x" + ih.hex(),
        )

    def cancel(self, key, id_store=None) -> None:  # local proving
        pass


def prove_transcript(instance_hash: bytes, device) -> dict:
    blocks = transcript_blocks(instance_hash)
    air = Poseidon2TranscriptAir(blocks)
    digest = air.compute_digest()
    publics = air.publics_for(digest)
    trace = air.trace()
    sp = stark_prover.prove(air, trace, publics, _stark_device(device))
    return {
        "kind": "poseidon2-transcript-v1",
        "instance_hash": instance_hash.hex(),
        "blocks": blocks,
        "digest": digest,
        "stark": proof_to_dict(sp),
    }


def prove_mpt_preimages(
    state_trie, state_root: bytes, device, storage_tries=None, max_chunks: int | None = None
) -> dict:
    """Batched keccak-sponge STARKs over the post-state tries' hashed node
    preimages (reference analog: the keccak calls of calculate_state_root,
    lib/src/primitives/mpt.rs:117-121 / builder.rs:191-264).

    The statement: digest_k = keccak256(preimage_k) for every covered
    node, with preimage 0 = the root node (digest 0 = the block's state
    root).  Storage-trie preimages follow the state trie's: each storage
    root digest is embedded in its account leaf's RLP, so the verifier's
    DFS-containment check chains them to the state root with no extra
    machinery.  Preimages are packed into chunks of <= MAX_MPT_PERMS
    sponge permutations (trace n = 1024 each) and each chunk gets its own
    STARK, so coverage scales with the trie instead of being capped by
    one trace; `max_chunks` bounds prover work, and the payload records
    covered vs total so any remaining truncation is explicit, never
    silent."""
    from ..mpt.trie import hashed_preimages
    from ..stark.airs.keccak_air import RATE_BYTES, KeccakBatchSpongeAir

    from ..utils import keccak256

    all_msgs = hashed_preimages(state_trie)
    for st in (storage_tries or {}).values():
        all_msgs.extend(hashed_preimages(st))
    chunks: list[list[bytes]] = []
    cur: list[bytes] = []
    perms = 0
    blob = b""  # containment-aware packing: never emit an unverifiable
    # payload — a message is included only if earlier kept messages
    # reference its digest (budget cuts drop whole orphaned subtrees)
    for m in all_msgs:
        if blob and keccak256(m) not in blob:
            continue
        need = len(m) // RATE_BYTES + 1
        if cur and perms + need > MAX_MPT_PERMS:
            chunks.append(cur)
            cur, perms = [], 0
            if max_chunks is not None and len(chunks) == max_chunks:
                break
        cur.append(m)
        perms += need
        blob += m
    if cur and (max_chunks is None or len(chunks) < max_chunks):
        chunks.append(cur)
    covered = sum(len(c) for c in chunks)
    msgs = [m for c in chunks for m in c]
    starks = []
    digests: list[bytes] = []
    for chunk in chunks:
        air = KeccakBatchSpongeAir(chunk)
        digests.extend(air.digests)
        starks.append(
            proof_to_dict(stark_prover.prove(air, air.trace(), air.publics(), _stark_device(device)))
        )
    assert digests[0] == state_root, "root preimage must hash to state root"
    return {
        "kind": "keccak-mpt-v1",
        "state_root": state_root.hex(),
        "messages": [m.hex() for m in msgs],
        "digests": [d.hex() for d in digests],
        "chunk_sizes": [len(c) for c in chunks],
        "covered": covered,
        "total": len(all_msgs),
        "stark_chunks": starks,
    }


def prove_keccak_batch_public(msgs: list[bytes], root: bytes, device) -> dict:
    """keccak-mpt-v1 proof over an EXPLICIT containment-ordered message
    list (no budget drops): digest 0 must equal `root` and every later
    digest must appear in an earlier message.  The reference's prestate
    binding (provers/prestate.py) proves its MPT path nodes with it."""
    from ..stark.airs.keccak_air import RATE_BYTES, KeccakBatchSpongeAir
    from ..utils import keccak256

    assert msgs and keccak256(msgs[0]) == root
    blob = b""
    for m in msgs:
        assert not blob or keccak256(m) in blob, "messages not containment-ordered"
        blob += m
    chunks: list[list[bytes]] = []
    cur: list[bytes] = []
    perms = 0
    for m in msgs:
        need = len(m) // RATE_BYTES + 1
        if cur and perms + need > MAX_MPT_PERMS:
            chunks.append(cur)
            cur, perms = [], 0
        cur.append(m)
        perms += need
    if cur:
        chunks.append(cur)
    starks = []
    digests: list[bytes] = []
    for chunk in chunks:
        air = KeccakBatchSpongeAir(chunk)
        digests.extend(air.digests)
        starks.append(
            proof_to_dict(stark_prover.prove(air, air.trace(), air.publics(), _stark_device(device)))
        )
    return {
        "kind": "keccak-mpt-v1",
        "state_root": root.hex(),
        "messages": [m.hex() for m in msgs],
        "digests": [d.hex() for d in digests],
        "chunk_sizes": [len(c) for c in chunks],
        "covered": len(msgs),
        "total": len(msgs),
        "stark_chunks": starks,
    }


PERMS_PER_CHUNK = 23  # sponge trace n = 1024 per chunk


def _collect_preimages(state_trie, state_root, storage_tries=None):
    """DFS-ordered keccak preimages with containment-aware packing.
    UNCAPPED message count (the chi-tuple triple code has no 256-message
    packing limit; MAX_MSGS is 2^16, far above any real block's trie
    slice).  Only pathological >8704-byte preimages (beyond any legal MPT
    node) are skipped, explicitly counted by the covered/total fields."""
    from ..mpt.trie import hashed_preimages
    from ..stark.airs.containment import MAX_BLOCKS, MAX_MSGS, RATE_BYTES
    from ..utils import keccak256

    all_msgs = hashed_preimages(state_trie)
    for st in (storage_tries or {}).values():
        all_msgs.extend(hashed_preimages(st))
    msgs: list[bytes] = []
    blob = b""
    for m in all_msgs:
        if len(m) // RATE_BYTES + 1 > MAX_BLOCKS:
            continue
        if blob and keccak256(m) not in blob:
            continue
        if len(msgs) == MAX_MSGS:
            break
        msgs.append(m)
        blob += m
    assert msgs and keccak256(msgs[0]) == state_root
    return msgs, len(all_msgs)


def prove_mpt_containment(
    state_trie,
    state_root: bytes,
    device,
    storage_tries=None,
    perms_per_chunk: int = PERMS_PER_CHUNK,
) -> dict:
    """The SUCCINCT batched keccak/MPT statement (keccak-mpt-v2): the
    payload carries NO preimage bytes and NO digests — just the table
    structure and the multi-table STARK.  See airs/containment.py for
    the three bus channels that bind the sponge, byte, and claim tables;
    the public input is the state root alone.

    Reference analog: the keccak calls of calculate_state_root
    (lib/src/primitives/mpt.rs:117-121, builder.rs:191-264)."""
    msgs, total = _collect_preimages(state_trie, state_root, storage_tries)
    return _prove_containment(msgs, total, state_root, perms_per_chunk, device)


def prove_header_chain(
    headers, device, perms_per_chunk: int = PERMS_PER_CHUNK
) -> dict:
    """Ancestor-hash-chain statement: the same containment system over
    header RLP preimages.  headers = [parent_header, ancestor_1, ...]
    newest first (as create_mem_db receives them); for a valid chain
    keccak(header_{k}) IS header_{k-1}.parent_hash, a 32-byte substring
    of its RLP — so "digests chain to keccak(parent_header)" proves the
    hash links of the ancestor chain (reference builder.rs:350-372).
    The root digest equals the proven block's parent_hash, which the
    instance hash binds via the block header."""
    from ..stark.airs.containment import MAX_BLOCKS, MAX_MSGS, RATE_BYTES
    from ..utils import keccak256

    msgs: list[bytes] = []
    prev = None
    for h in headers:
        m = h.encode()
        if len(m) // RATE_BYTES + 1 > MAX_BLOCKS or len(msgs) == MAX_MSGS:
            break
        if prev is not None and keccak256(m) != prev.parent_hash:
            break  # chain link broken: stop at verified prefix
        msgs.append(m)
        prev = h
    assert msgs
    return _prove_containment(
        msgs, len(headers), keccak256(msgs[0]), perms_per_chunk, device
    )


def _prove_containment(
    msgs: list[bytes], total: int, root: bytes, perms_per_chunk: int, device
) -> dict:
    """Multi-table containment STARK over a DFS-ordered preimage list
    (digest 0 = root; every later digest contained in an earlier kept
    preimage)."""
    from ..stark import prover as sp
    from ..stark.airs.containment import ByteCodeAir, ContainAir, pad_keccak
    from ..stark.airs.keccak_air import KeccakSpongeV2Air
    from ..utils import keccak256

    padded = [pad_keccak(m) for m in msgs]
    # containment claims + triple multiplicities
    claims = []
    mults: dict = {}
    for k in range(1, len(msgs)):
        digest = keccak256(msgs[k])
        parent = off = None
        for p in range(k):
            idx = msgs[p].find(digest)
            if idx >= 0:
                parent, off = p, idx
                break
        assert parent is not None, "collection guarantees containment"
        claims.append((digest, parent, off))
        for j in range(32):
            key = (parent, off + j)
            mults[key] = mults.get(key, 0) + 1
    # chunk messages into sponge tables by permutation budget
    chunks: list[list[int]] = [[]]
    perms = 0
    for mi, p in enumerate(padded):
        need = len(p) // 136
        if chunks[-1] and perms + need > perms_per_chunk:
            chunks.append([])
            perms = 0
        chunks[-1].append(mi)
        perms += need
    tables = []
    block_counts_per_chunk = []
    for ci, idxs in enumerate(chunks):
        air = KeccakSpongeV2Air.from_messages(
            [msgs[i] for i in idxs], msg_id_offset=idxs[0], bind_root=(ci == 0)
        )
        tables.append((air, air.trace(), air.publics()))
        block_counts_per_chunk.append(air.block_counts)
    bytetab = ByteCodeAir([len(p) for p in padded])
    tables.append((bytetab, bytetab.trace(msgs, mults), []))
    if len(msgs) > 1:
        claimt = ContainAir(len(msgs) - 1)
        tables.append((claimt, claimt.trace(claims), []))
    proofs = sp.prove_tables(tables, _stark_device(device))
    return {
        "kind": "keccak-mpt-v2",
        # the bound root digest (state root / tx root / receipts root /
        # parent hash — whichever DAG this statement covers)
        "state_root": root.hex(),
        "block_counts": block_counts_per_chunk,
        "covered": len(msgs),
        "total": total,
        "starks": [proof_to_dict(p) for p in proofs],
    }


def prove_evm_frames(
    candidates: list[dict],
    device,
    max_frames: int = 64,
    max_steps: int = 65536,
    workers: int | None = None,
) -> dict | None:
    """Prove the block's covered top-level call frames with the EVM
    execution tables.  A candidate is provable when the covered stack
    machine replays it exactly (same halt, same gas left); coverage is
    reported explicitly (covered/total), mirroring the MPT statement's
    truncation discipline — frames outside coverage are skipped, never
    mis-proven.

    Each tx's call tree is an independent proof, proven on ``device``
    (None: the CPU), so trees prove on a thread pool (``workers``,
    default ``RAIKO_FRAME_WORKERS`` or 2): one tree's host-side work
    (trace building, Fiat-Shamir) overlaps another's device launches.
    ``pool.map`` keeps the candidates' order, so the payload's frame
    order is deterministic."""
    import os as _os
    from concurrent.futures import ThreadPoolExecutor

    from ..stark.airs import evm_air as ea

    fts = []  # (tx_index, FrameTrace)
    for cand in candidates:
        if len(fts) == max_frames:
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
                balances=dict(cand.get("balances") or {}),
                nonces=dict(cand.get("nonces") or {}),
            )
        except ea.UncoveredFrame:
            continue
        if ft.gas_f != cand["gas_left"]:
            continue  # replay diverged from the interpreter: not covered
        fts.append((int(cand.get("tx_index", -1)), ft))
    if not fts:
        return None
    if workers is None:
        workers = int(_os.environ.get("RAIKO_FRAME_WORKERS", "2"))

    def _prove(item):
        txi, ft = item
        p = ea.prove_frame_trace(ft, _stark_device(device))
        if txi >= 0:
            p["tx_index"] = txi
        return p

    if workers > 1 and len(fts) > 1:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            frames = list(pool.map(_prove, fts))
    else:
        frames = [_prove(item) for item in fts]
    return {
        "kind": "evm-frames-v1",
        "total": len(candidates),
        "covered": len(frames),
        "frames": frames,
    }


def verify_receipts_link(payload: dict) -> bool:
    """Receipts-root linkage: re-derive every receipt (status, cumulative
    gas, bloom, logs) from the published fields, rebuild the index trie,
    and require its root to equal the receipts containment statement's
    public root; then cross-check that each COVERED tx's receipt logs
    are exactly the execution-bound log records its proven frame group
    emitted (address from the frame's in-circuit-bound env, topics and
    data from the EvmLogAir publics, ordered by tree emission sequence).
    Tampering a log record therefore breaks the receipts root, and
    tampering the frame records breaks the STARK.  Gas values and
    uncovered txs' fields remain relativized publics.
    Ref: lib/src/builder.rs:191-264."""
    rl = payload.get("receipts")
    mpt = payload.get("receipts_mpt")
    if rl is None:
        return True  # optional component; absence is visible in payload
    if rl.get("kind") != "receipts-link-v1" or mpt is None:
        return False
    from ..evm.builder import _index_trie
    from ..proto.types import Log, Receipt

    try:
        receipts = []
        for t in rl["txs"]:
            logs = [
                Log(
                    address=bytes.fromhex(a),
                    topics=[bytes.fromhex(x) for x in tp],
                    data=bytes.fromhex(d),
                )
                for a, tp, d in t["logs"]
            ]
            receipts.append(
                Receipt(
                    int(t["type"]), int(t["status"]),
                    int(t["cumulative_gas"]), logs,
                )
            )
        root = _index_trie([r.encode() for r in receipts]).hash()
        if root != bytes.fromhex(mpt["state_root"]):
            return False
        evm = payload.get("evm") or {}
        for grp in evm.get("frames", []):
            txi = grp.get("tx_index")
            if txi is None or not (0 <= int(txi) < len(rl["txs"])):
                # when the link is published, every proven frame group
                # must align with a receipt (no prover opt-out)
                return False
            expected = rl["txs"][int(txi)]
            ev_logs = []
            for fr in grp.get("frames", []):
                addr = int(fr["env"]["address"], 16)
                for clk, fam, offw, size, topics, words, *s in fr.get(
                    "logs", []
                ):
                    seq = int(s[0]) if s else 0
                    data = b"".join(
                        int(w, 16).to_bytes(32, "big") for w in words
                    )[: int(size)]
                    tvals = [int(t, 16) for t in topics][: int(fam) - 1]
                    ev_logs.append((seq, addr, tvals, data))
            ev_logs.sort()
            if len(ev_logs) != len(expected["logs"]):
                return False
            for (seq, addr, tvals, data), (a, tp, d) in zip(
                ev_logs, expected["logs"]
            ):
                if int(a, 16) != addr:
                    return False
                if [int.from_bytes(bytes.fromhex(x), "big") for x in tp] != tvals:
                    return False
                if bytes.fromhex(d) != data:
                    return False
            if int(expected["status"]) != 1:
                return False  # covered frames halt successfully
    except (KeyError, ValueError, TypeError):
        return False
    return True


def verify_evm_frames_payload(evm: dict, device) -> bool:
    from ..stark.airs import evm_air as ea

    if evm.get("kind") != "evm-frames-v1":
        return False
    frames = evm.get("frames", [])
    if not frames or len(frames) != evm.get("covered"):
        return False
    return all(ea.verify_frame_payload(f, _stark_device(device)) for f in frames)


def mpt_v2_group(mpt: dict, state_root: bytes | None = None):
    """Rebuild a keccak-mpt-v2 statement's (airs, publics, proofs) from
    the payload STRUCTURE alone; None when the structure is invalid.
    Shared by the host verifier and the recursion seal (provers/seal.py)."""
    from ..stark.airs.containment import (
        ByteCodeAir,
        ContainAir,
        MAX_MSGS,
        RATE_BYTES,
    )
    from ..stark.airs.keccak_air import KeccakSpongeV2Air, _digest_bits

    if mpt.get("kind") != "keccak-mpt-v2":
        return None
    root = bytes.fromhex(mpt["state_root"])
    if state_root is not None and root != state_root:
        return None
    bc_chunks = mpt.get("block_counts")
    if not bc_chunks or not all(c for c in bc_chunks):
        return None
    flat = [c for chunk in bc_chunks for c in chunk]
    if not (0 < len(flat) <= MAX_MSGS):
        return None
    airs = []
    offset = 0
    for ci, counts in enumerate(bc_chunks):
        airs.append(
            KeccakSpongeV2Air(
                counts, msg_id_offset=offset, root_digest=root if ci == 0 else None
            )
        )
        offset += len(counts)
    airs.append(ByteCodeAir([c * RATE_BYTES for c in flat]))
    if len(flat) > 1:
        airs.append(ContainAir(len(flat) - 1))
    starks = mpt.get("starks", [])
    if len(starks) != len(airs):
        return None
    proofs = [proof_from_dict(d) for d in starks]
    pubs = [_digest_bits(root)] + [[] for _ in proofs[1:]]
    return airs, pubs, proofs


def verify_mpt_v2_payload(mpt: dict, device, state_root: bytes | None = None) -> bool:
    """Verify the succinct statement from STRUCTURE + state root alone;
    the query rows are hashed on `device` (None: the CPU)."""
    from ..stark import verifier as sv

    grp = mpt_v2_group(mpt, state_root)
    if grp is None:
        return False
    airs, pubs, proofs = grp
    for p, expect in zip(proofs, pubs):
        if p.publics != expect:
            return False
    return sv.verify_tables(airs, proofs, _stark_device(device))


def verify_mpt_payload(mpt: dict, device, state_root: bytes | None = None) -> bool:
    """Check the batched keccak MPT statement from public data alone:
    (a) each chunk's STARK attests digest_k = keccak256(message_k);
    (b) digest 0 equals the claimed state root;
    (c) every other digest is referenced by an earlier preimage (the
        nodes form a DAG hanging off the state root, not a loose set)."""
    from ..stark.airs.keccak_air import KeccakBatchSpongeAir

    if mpt.get("kind") != "keccak-mpt-v1":
        return False
    msgs = [bytes.fromhex(m) for m in mpt["messages"]]
    digests = [bytes.fromhex(d) for d in mpt["digests"]]
    sizes = list(mpt.get("chunk_sizes", [len(msgs)]))
    if len(msgs) != len(digests) or not msgs or sum(sizes) != len(msgs):
        return False
    root = bytes.fromhex(mpt["state_root"])
    if state_root is not None and root != state_root:
        return False
    if digests[0] != root:
        return False
    # containment in DFS order: every non-root digest must be referenced
    # by some earlier preimage (child appears after its parent)
    blob = b""
    for m, d in zip(msgs, digests):
        if blob and d not in blob:
            return False
        blob += m
    starks = mpt.get("stark_chunks", [])
    if len(starks) != len(sizes):
        return False
    off = 0
    for size, sd in zip(sizes, starks):
        air = KeccakBatchSpongeAir(
            msgs[off : off + size], digests=digests[off : off + size]
        )
        sp = proof_from_dict(sd)
        if sp.publics != air.publics():
            return False
        if not stark_verifier.verify(air, sp, _stark_device(device)):
            return False
        off += size
    return True


def verify_payload(payload: dict, device) -> bool:
    """Reconstruct the AIR(s) from public data and verify the STARK(s) on
    `device` (None: the CPU)."""
    if payload.get("kind") != "poseidon2-transcript-v1":
        return False
    ih = bytes.fromhex(payload["instance_hash"])
    blocks = transcript_blocks(ih)
    if blocks != [list(b) for b in payload["blocks"]]:
        return False  # message does not bind the claimed instance hash
    air = Poseidon2TranscriptAir(blocks)
    digest = air.compute_digest()
    if digest != list(payload["digest"]):
        return False
    sp = proof_from_dict(payload["stark"])
    if sp.publics != air.publics_for(digest):
        return False
    if not stark_verifier.verify(air, sp, _stark_device(device)):
        return False
    if "mpt" in payload:
        ok = (
            verify_mpt_v2_payload(payload["mpt"], device)
            if payload["mpt"].get("kind") == "keccak-mpt-v2"
            else verify_mpt_payload(payload["mpt"], device)
        )
        if not ok:
            return False
    # body-trie and ancestor-chain statements are the same containment
    # system bound to their own roots (tx root / receipts root / the
    # proven block's parent hash)
    for slot in ("tx_mpt", "receipts_mpt", "chain"):
        if slot in payload and not verify_mpt_v2_payload(payload[slot], device):
            return False
    if not verify_receipts_link(payload):
        return False
    if "evm" in payload:
        if not verify_evm_frames_payload(payload["evm"], device):
            return False
        # storage originals must be bound to the proven pre-state
        from .prestate import verify_prestate_binding

        if not verify_prestate_binding(payload, device):
            return False
    if "seal" in payload:
        from .seal import verify_block_seal

        if not verify_block_seal(payload, payload["seal"], device):
            return False
    return True


register(TpuStarkProver())
