"""GuestInput / GuestOutput: the self-contained proving input
(reference lib/src/input.rs:28-45,63-72,125-128).

A GuestInput captures everything block re-execution touches: the block to
prove, the parent header + sparse state/storage tries, contract bytecodes,
256 ancestor headers, and the Taiko-specific data (L1 header, raw tx data,
anchor tx, BlockProposed metadata, blob commitment/proof).  It must be
fully serializable so the host can cache it per (network, block) and ship
it to guests (our format: msgpack of a canonical dict; the reference uses
bincode)."""

from __future__ import annotations

from dataclasses import dataclass, field

import msgpack

from ..chain import ChainSpec
from ..mpt import MptNode
from ..mpt.trie import decode_node
from .instance import BlockMetadata
from .types import BlockHeader, Transaction, Withdrawal


@dataclass
class TaikoGuestInput:
    """reference TaikoGuestInput (input.rs:63-72)."""

    l1_header: BlockHeader = field(default_factory=BlockHeader)
    tx_data: bytes = b""
    anchor_tx: Transaction | None = None
    block_proposed_meta: BlockMetadata = field(default_factory=BlockMetadata)
    prover_data_prover: bytes = b"\x00" * 20
    prover_data_graffiti: bytes = b"\x00" * 32
    blob_commitment: bytes | None = None
    blob_proof: bytes | None = None
    blob_proof_type: str = "proof_of_commitment"


@dataclass
class GuestInput:
    chain_spec: ChainSpec = None
    block_header: BlockHeader = field(default_factory=BlockHeader)
    transactions: list = field(default_factory=list)
    withdrawals: list = field(default_factory=list)
    parent_header: BlockHeader = field(default_factory=BlockHeader)
    parent_state_trie: MptNode = field(default_factory=MptNode.null)
    parent_storage: dict = field(default_factory=dict)  # addr -> (trie, [slots])
    contracts: list = field(default_factory=list)
    ancestor_headers: list = field(default_factory=list)
    taiko: TaikoGuestInput = field(default_factory=TaikoGuestInput)

    # -- serialization -------------------------------------------------
    def to_bytes(self) -> bytes:
        return msgpack.packb(self._to_dict(), use_bin_type=True)

    @classmethod
    def from_bytes(cls, data: bytes) -> "GuestInput":
        return cls._from_dict(msgpack.unpackb(data, raw=False, strict_map_key=False))

    def _to_dict(self) -> dict:
        return {
            "chain_spec": _spec_to_dict(self.chain_spec),
            "block_header": self.block_header.encode(),
            "transactions": [tx.encode() for tx in self.transactions],
            "withdrawals": [
                [w.index, w.validator_index, w.address, w.amount]
                for w in self.withdrawals
            ],
            "parent_header": self.parent_header.encode(),
            "parent_state_trie": _trie_to_obj(self.parent_state_trie),
            "parent_storage": {
                addr: [_trie_to_obj(t), slots]
                for addr, (t, slots) in self.parent_storage.items()
            },
            "contracts": list(self.contracts),
            "ancestor_headers": [h.encode() for h in self.ancestor_headers],
            "taiko": {
                "l1_header": self.taiko.l1_header.encode(),
                "tx_data": self.taiko.tx_data,
                "anchor_tx": self.taiko.anchor_tx.encode()
                if self.taiko.anchor_tx
                else None,
                "meta": [
                    v if not isinstance(v, bool) else v
                    for v in self.taiko.block_proposed_meta.values()
                ],
                "prover": self.taiko.prover_data_prover,
                "graffiti": self.taiko.prover_data_graffiti,
                "blob_commitment": self.taiko.blob_commitment,
                "blob_proof": self.taiko.blob_proof,
                "blob_proof_type": self.taiko.blob_proof_type,
            },
        }

    @classmethod
    def _from_dict(cls, d: dict) -> "GuestInput":
        t = d["taiko"]
        meta_vals = t["meta"]
        return cls(
            chain_spec=_spec_from_dict(d["chain_spec"]),
            block_header=BlockHeader.decode(d["block_header"]),
            transactions=[Transaction.decode(x) for x in d["transactions"]],
            withdrawals=[Withdrawal(*w) for w in d["withdrawals"]],
            parent_header=BlockHeader.decode(d["parent_header"]),
            parent_state_trie=_trie_from_obj(d["parent_state_trie"]),
            parent_storage={
                addr: (_trie_from_obj(o[0]), list(o[1]))
                for addr, o in d["parent_storage"].items()
            },
            contracts=list(d["contracts"]),
            ancestor_headers=[BlockHeader.decode(x) for x in d["ancestor_headers"]],
            taiko=TaikoGuestInput(
                l1_header=BlockHeader.decode(t["l1_header"]),
                tx_data=t["tx_data"],
                anchor_tx=Transaction.decode(t["anchor_tx"])
                if t["anchor_tx"]
                else None,
                block_proposed_meta=BlockMetadata(*meta_vals),
                prover_data_prover=t["prover"],
                prover_data_graffiti=t["graffiti"],
                blob_commitment=t["blob_commitment"],
                blob_proof=t["blob_proof"],
                blob_proof_type=t["blob_proof_type"],
            ),
        )


@dataclass
class GuestOutput:
    header: BlockHeader
    hash: bytes  # instance hash


# -- trie serialization (digest-preserving) ---------------------------------


def _trie_to_obj(node: MptNode):
    """Serialize a sparse trie preserving digest truncation: standalone
    nodes as RLP plus child placeholders."""
    from ..mpt.trie import BRANCH, DIGEST, EXTENSION, LEAF, NULL

    if node.kind == NULL:
        return None
    if node.kind == DIGEST:
        return {"d": node.digest}
    if node.kind == LEAF:
        return {"l": [bytes(bytearray(node.nibbles)), node.value]}
    if node.kind == EXTENSION:
        return {"e": [bytes(bytearray(node.nibbles)), _trie_to_obj(node.children[0])]}
    return {"b": [_trie_to_obj(c) for c in node.children]}


def _trie_from_obj(obj) -> MptNode:
    if obj is None:
        return MptNode.null()
    if "d" in obj:
        return MptNode.from_digest(obj["d"])
    if "l" in obj:
        return MptNode.leaf(tuple(obj["l"][0]), obj["l"][1])
    if "e" in obj:
        return MptNode.extension(tuple(obj["e"][0]), _trie_from_obj(obj["e"][1]))
    return MptNode.branch([_trie_from_obj(c) for c in obj["b"]])


def _spec_to_dict(spec: ChainSpec) -> dict:
    from ..chain.specs import ForkCondition

    def cond(c: ForkCondition):
        if c.tbd:
            return "TBD"
        if c.block is not None:
            return {"Block": c.block}
        return {"Timestamp": c.timestamp}

    return {
        "name": spec.name,
        "chain_id": spec.chain_id,
        "max_spec_id": spec.max_spec_id,
        "hard_forks": {k: cond(v) for k, v in spec.hard_forks.items()},
        "eip_1559_constants": {
            "base_fee_change_denominator": spec.eip_1559_constants.base_fee_change_denominator,
            "base_fee_max_increase_denominator": spec.eip_1559_constants.base_fee_max_increase_denominator,
            "base_fee_max_decrease_denominator": spec.eip_1559_constants.base_fee_max_decrease_denominator,
            "elasticity_multiplier": spec.eip_1559_constants.elasticity_multiplier,
        },
        "l1_contract": spec.l1_contract,
        "l2_contract": spec.l2_contract,
        "rpc": spec.rpc,
        "beacon_rpc": spec.beacon_rpc,
        "verifier_address": spec.verifier_address,
        "genesis_time": spec.genesis_time,
        "seconds_per_slot": spec.seconds_per_slot,
        "is_taiko": spec.is_taiko,
    }


def _spec_from_dict(d: dict) -> ChainSpec:
    return ChainSpec.from_json(d)
