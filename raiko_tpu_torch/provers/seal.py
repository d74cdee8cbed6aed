"""Whole-payload recursion seal (seal-v2): ONE constant-shape outer
artifact attesting that EVERY STARK in a tpu_stark block payload
verifies.

The reference wraps its zkVM receipt into a single on-chain-verifiable
Groth16 seal (/root/reference/provers/risc0/driver/src/snarks.rs:92-157
stark2snark); the TPU-native analog is the recursion circuit
(stark/recursion.py): all inner multi-table proof groups of the payload
— the Poseidon2 transcript, every keccak-mpt-v2 containment statement
(state/tx/receipts/chain), every EVM call-tree group, and the prestate
keccak chunks — are verified INSIDE one outer two-table STARK whose
shape is set by the verifier circuit, not by the block.

Split of public data vs proof data (mirrors the reference): the *seal*
carries only the outer proof + the inner shape vector (log_n per inner
table); the *statement* (AIR structures + publics) is rebuilt from the
payload's public part, exactly as the reference's journal digest is
checked against publicly recovered block data.  ``strip_payload``
produces that public descriptor: the payload minus every inner STARK
body.

Port of raiko_tpu/provers/seal.py, copied but for the device: the outer
proof is proven and verified on the device the caller names
(``prove_block_seal``, ``verify_block_seal``, ``verify_seal_artifact``;
None is the CPU, as for the rest of the ``tpu_stark`` backend).  The
reference's two faults stay as they are: a standalone artifact skips the
prestate and receipts checks (``verify_seal_artifact``), and a partial
seal is not restricted to a prefix of the groups (``prove_block_seal``).

Cost note (measured, 2-core host): the outer circuit pays ~O(width)
gates per inner-table query, so wide sponge tables dominate; sealing is
an OPT-IN post-processing step (``prover_args["seal"]``), not part of
the default proving path.  See docs/SOUNDNESS.md "seal-v2".
"""

from __future__ import annotations

import json
import zlib

from ..stark import recursion
from ..stark.serde import proof_from_dict, proof_to_dict
from .tpu_stark import _stark_device


def _inner(air, proof, publics):
    return recursion.InnerTable(
        air=air, log_n=int(proof.log_n), publics=list(publics)
    )


def payload_groups(payload: dict):
    """[(tables, proofs)] for every inner multi-table proof group of a
    tpu_stark payload, rebuilt from PUBLIC data + the embedded proofs.
    Raises ValueError on structural mismatch."""
    from ..stark.airs import evm_air
    from ..stark.airs.poseidon2_air import Poseidon2TranscriptAir
    from . import tpu_stark as ts

    groups = []
    # 1. the Poseidon2 transcript table
    if payload.get("kind") != "poseidon2-transcript-v1":
        raise ValueError("not a tpu_stark payload")
    ih = bytes.fromhex(payload["instance_hash"])
    blocks = ts.transcript_blocks(ih)
    if blocks != [list(b) for b in payload["blocks"]]:
        raise ValueError("transcript blocks do not bind the instance hash")
    air = Poseidon2TranscriptAir(blocks)
    digest = air.compute_digest()
    if digest != list(payload["digest"]):
        raise ValueError("transcript digest mismatch")
    sp = proof_from_dict(payload["stark"])
    pubs = air.publics_for(digest)
    if sp.publics != pubs:
        raise ValueError("transcript publics mismatch")
    groups.append(([_inner(air, sp, pubs)], [sp]))
    # 2. containment statements (state/tx/receipts tries, ancestor chain)
    for slot in ("mpt", "tx_mpt", "receipts_mpt", "chain"):
        obj = payload.get(slot)
        if obj is None:
            continue
        if obj.get("kind") != "keccak-mpt-v2":
            raise ValueError(f"{slot}: only keccak-mpt-v2 is sealable")
        grp = ts.mpt_v2_group(obj)
        if grp is None:
            raise ValueError(f"{slot}: invalid containment structure")
        airs, pubs, proofs = grp
        for p, expect in zip(proofs, pubs):
            if p.publics != expect:
                raise ValueError(f"{slot}: containment publics mismatch")
        groups.append(
            (
                [_inner(a, p, pb) for a, p, pb in zip(airs, proofs, pubs)],
                proofs,
            )
        )
    # 3. EVM call-tree groups
    for gi, grp_payload in enumerate(
        (payload.get("evm") or {}).get("frames", [])
    ):
        grp = evm_air.frame_group_airs(grp_payload)
        if grp is None:
            raise ValueError(f"evm group {gi}: invalid structure")
        airs, pubs, proofs = grp
        for p, expect in zip(proofs, pubs):
            if p.publics != expect:
                raise ValueError(f"evm group {gi}: publics mismatch")
        groups.append(
            (
                [_inner(a, p, pb) for a, p, pb in zip(airs, proofs, pubs)],
                proofs,
            )
        )
    # 4. prestate keccak chunks (keccak-mpt-v1: one table per chunk)
    kec = (payload.get("prestate") or {}).get("keccak")
    if kec is not None:
        from ..stark.airs.keccak_air import KeccakBatchSpongeAir

        if kec.get("kind") != "keccak-mpt-v1":
            raise ValueError("prestate keccak: unexpected kind")
        msgs = [bytes.fromhex(m) for m in kec["messages"]]
        digests = [bytes.fromhex(d) for d in kec["digests"]]
        sizes = list(kec.get("chunk_sizes", [len(msgs)]))
        starks = kec.get("stark_chunks", [])
        if len(starks) != len(sizes):
            raise ValueError("prestate keccak: chunk count mismatch")
        off = 0
        for size, sd in zip(sizes, starks):
            air = KeccakBatchSpongeAir(
                msgs[off : off + size], digests=digests[off : off + size]
            )
            sp = proof_from_dict(sd)
            pubs = air.publics()
            if sp.publics != pubs:
                raise ValueError("prestate keccak: publics mismatch")
            groups.append(([_inner(air, sp, pubs)], [sp]))
            off += size
    return groups


def prove_block_seal(payload: dict, device, max_tables: int | None = None) -> dict:
    """Aggregate EVERY inner proof of the payload into one outer
    two-table proof on ``device``.  ``max_tables`` optionally bounds the
    sealed scope (remaining groups are reported in ``unsealed`` —
    explicit, never silent)."""
    groups = payload_groups(payload)
    sealed = groups
    unsealed = 0
    if max_tables is not None:
        sealed, count = [], 0
        for tables, proofs in groups:
            if count + len(tables) > max_tables and sealed:
                unsealed += len(tables)
                continue
            sealed.append((tables, proofs))
            count += len(tables)
    outer = recursion.prove_recursion(
        [t for t, _ in sealed], [p for _, p in sealed], _stark_device(device)
    )
    return {
        "kind": "seal-v2",
        "shapes": [[t.log_n for t in tables] for tables, _ in sealed],
        "n_groups": len(sealed),
        "unsealed": unsealed,
        "outer": [proof_to_dict(p) for p in outer],
    }


def strip_payload(payload: dict) -> dict:
    """The PUBLIC statement descriptor: the payload minus every inner
    STARK body (what a constant-shape verifier needs besides the seal)."""

    def strip(obj):
        if isinstance(obj, dict):
            return {
                k: strip(v)
                for k, v in obj.items()
                if k not in ("stark", "starks", "stark_chunks")
            }
        if isinstance(obj, list):
            return [strip(v) for v in obj]
        return obj

    return strip(payload)


def verify_block_seal(payload: dict, seal: dict, device) -> bool:
    """Check the outer proof, on ``device``, against the statement
    rebuilt from the payload's PUBLIC part + the seal's shape vector.
    The inner proof bodies in `payload` are ignored (callers may pass a
    stripped payload whose groups carry shapes from the seal)."""
    if seal.get("kind") != "seal-v2":
        return False
    try:
        groups = _statement_groups(payload, seal["shapes"])
        outer = [proof_from_dict(d) for d in seal["outer"]]
        return recursion.verify_recursion(groups, outer, _stark_device(device))
    except (KeyError, ValueError, TypeError, AssertionError):
        return False


def _group_count(payload: dict) -> int:
    """Number of inner proof groups a payload declares (the sealed-seal
    completeness check for standalone artifacts)."""
    n = 1  # the transcript table
    for slot in ("mpt", "tx_mpt", "receipts_mpt", "chain"):
        if payload.get(slot) is not None:
            n += 1
    n += len((payload.get("evm") or {}).get("frames", []))
    kec = (payload.get("prestate") or {}).get("keccak")
    if kec is not None:
        n += len(kec.get("chunk_sizes", [1]))
    return n


def _statement_groups(payload: dict, shapes: list):
    """Statement-only groups (no proof values): AIRs + publics from the
    payload's public part, log_n from the seal's shape vector."""
    from ..stark.airs import evm_air
    from ..stark.airs.poseidon2_air import Poseidon2TranscriptAir
    from . import tpu_stark as ts

    out = []

    def add(tables):
        gi = len(out)
        if gi >= len(shapes):
            return  # partial seal: groups beyond the sealed prefix are
            # covered by the ordinary per-group verifiers instead
        if len(shapes[gi]) != len(tables):
            raise ValueError("seal shape vector mismatch")
        out.append(
            [
                recursion.InnerTable(air=a, log_n=int(ln), publics=list(p))
                for (a, p), ln in zip(tables, shapes[gi])
            ]
        )

    if payload.get("kind") != "poseidon2-transcript-v1":
        raise ValueError("not a tpu_stark payload")
    ih = bytes.fromhex(payload["instance_hash"])
    blocks = ts.transcript_blocks(ih)
    if blocks != [list(b) for b in payload["blocks"]]:
        raise ValueError("transcript blocks do not bind the instance hash")
    air = Poseidon2TranscriptAir(blocks)
    digest = air.compute_digest()
    if digest != list(payload["digest"]):
        raise ValueError("transcript digest mismatch")
    add([(air, air.publics_for(digest))])
    from ..stark.airs.containment import ByteCodeAir, ContainAir, RATE_BYTES
    from ..stark.airs.keccak_air import (
        KeccakBatchSpongeAir,
        KeccakSpongeV2Air,
        _digest_bits,
    )

    for slot in ("mpt", "tx_mpt", "receipts_mpt", "chain"):
        obj = payload.get(slot)
        if obj is None:
            continue
        root = bytes.fromhex(obj["state_root"])
        bc_chunks = obj["block_counts"]
        flat = [c for chunk in bc_chunks for c in chunk]
        tables = []
        offset = 0
        for ci, counts in enumerate(bc_chunks):
            a = KeccakSpongeV2Air(
                counts,
                msg_id_offset=offset,
                root_digest=root if ci == 0 else None,
            )
            tables.append((a, _digest_bits(root) if ci == 0 else []))
            offset += len(counts)
        tables.append((ByteCodeAir([c * RATE_BYTES for c in flat]), []))
        if len(flat) > 1:
            tables.append((ContainAir(len(flat) - 1), []))
        add(tables)
    for grp_payload in (payload.get("evm") or {}).get("frames", []):
        grp = evm_air.frame_group_airs(grp_payload, with_proofs=False)
        if grp is None:
            raise ValueError("evm group: invalid structure")
        airs, pubs, _ = grp
        add(list(zip(airs, pubs)))
    kec = (payload.get("prestate") or {}).get("keccak")
    if kec is not None:
        msgs = [bytes.fromhex(m) for m in kec["messages"]]
        digests = [bytes.fromhex(d) for d in kec["digests"]]
        sizes = list(kec.get("chunk_sizes", [len(msgs)]))
        off = 0
        for size in sizes:
            a = KeccakBatchSpongeAir(
                msgs[off : off + size], digests=digests[off : off + size]
            )
            add([(a, a.publics())])
            off += size
    return out


def seal_artifact(payload: dict, seal: dict) -> bytes:
    """Wire form for the on-chain verifier analog: statement descriptor
    (public part) + seal, zlib'd canonical JSON.  The PROOF portion
    (seal["outer"]) is constant-shape; the descriptor is the public
    statement the reference recovers from L1 data."""
    return zlib.compress(
        json.dumps(
            {
                "kind": "seal-v2-artifact",
                "payload": strip_payload(payload),
                "seal": seal,
            },
            sort_keys=True,
        ).encode()
    )


def verify_seal_artifact(journal: bytes, artifact: bytes, device) -> bool:
    """The verifier-contract analog for seal-v2: journal must equal the
    instance hash the transcript table binds; the outer proof must
    verify, on ``device``, against the descriptor-rebuilt statement."""
    try:
        obj = json.loads(zlib.decompress(artifact))
        if obj.get("kind") != "seal-v2-artifact":
            return False
        payload, seal = obj["payload"], obj["seal"]
        if bytes.fromhex(payload["instance_hash"]) != journal:
            return False
        # the standalone artifact carries no inner proofs, so a partial
        # seal would leave the unsealed groups UNVERIFIED — require the
        # shape vector to cover EVERY group the payload declares (the
        # prover-supplied `unsealed` field is not trusted); partial
        # seals are only meaningful inside a full payload where the
        # per-group verifiers cover the remainder
        if len(seal["shapes"]) != _group_count(payload):
            return False
    except (KeyError, ValueError, TypeError, zlib.error):
        return False
    return verify_block_seal(payload, seal, device)
