"""ProtocolInstance: the on-chain public input (reference
lib/src/protocol_instance.rs).

Builds the Transition + BlockMetadata binding and the 32-byte
``instance_hash`` = keccak(abi.encode("VERIFY_PROOF", chain_id, verifier,
transition, sgx_instance, prover, meta_hash, proof_of_equivalence)[32:]),
bit-exact with the reference's golden vectors (test_calc_eip712_pi_hash,
ref :236-268)."""

from __future__ import annotations

from dataclasses import dataclass, field

from ..chain import SupportedChainSpecs
from ..kzg import eip4844
from ..utils import keccak256
from . import abi

# sol! BlockMetadata (reference input.rs:138-154)
BLOCK_METADATA_SPEC = (
    "tuple",
    [
        "bytes32",  # l1Hash
        "bytes32",  # difficulty
        "bytes32",  # blobHash
        "bytes32",  # extraData
        "bytes32",  # depositsHash
        "address",  # coinbase
        "uint64",  # id
        "uint32",  # gasLimit
        "uint64",  # timestamp
        "uint64",  # l1Height
        "uint16",  # minTier
        "bool",  # blobUsed
        "bytes32",  # parentMetaHash
        "address",  # sender
    ],
)
TRANSITION_SPEC = ("tuple", ["bytes32", "bytes32", "bytes32", "bytes32"])
ETH_DEPOSIT_SPEC = ("tuple", ["address", "uint96", "uint64"])


@dataclass
class Transition:
    parent_hash: bytes = b"\x00" * 32
    block_hash: bytes = b"\x00" * 32
    state_root: bytes = b"\x00" * 32
    graffiti: bytes = b"\x00" * 32

    def values(self):
        return [self.parent_hash, self.block_hash, self.state_root, self.graffiti]


@dataclass
class BlockMetadata:
    l1_hash: bytes = b"\x00" * 32
    difficulty: bytes = b"\x00" * 32
    blob_hash: bytes = b"\x00" * 32
    extra_data: bytes = b"\x00" * 32
    deposits_hash: bytes = b"\x00" * 32
    coinbase: bytes = b"\x00" * 20
    block_id: int = 0
    gas_limit: int = 0
    timestamp: int = 0
    l1_height: int = 0
    min_tier: int = 0
    blob_used: bool = False
    parent_meta_hash: bytes = b"\x00" * 32
    sender: bytes = b"\x00" * 20

    def values(self):
        return [
            self.l1_hash,
            self.difficulty,
            self.blob_hash,
            self.extra_data,
            self.deposits_hash,
            self.coinbase,
            self.block_id,
            self.gas_limit,
            self.timestamp,
            self.l1_height,
            self.min_tier,
            self.blob_used,
            self.parent_meta_hash,
            self.sender,
        ]

    def abi_encode(self) -> bytes:
        """alloy .abi_encode() of a static struct = its inline encoding."""
        return abi.encode([BLOCK_METADATA_SPEC], [self.values()])


class ProtocolInstanceError(ValueError):
    pass


VERIFIER_NONE = "None"
VERIFIER_SGX = "SGX"
VERIFIER_SP1 = "SP1"
VERIFIER_RISC0 = "RISC0"

PROOF_OF_COMMITMENT = "proof_of_commitment"
PROOF_OF_EQUIVALENCE = "proof_of_equivalence"


def get_blob_proof_type(verifier: str, hint: str) -> str:
    """Per-verifier blob proof policy (ref :189-203, with the
    proof_of_equivalence feature enabled)."""
    return {
        VERIFIER_NONE: hint,
        VERIFIER_SGX: PROOF_OF_COMMITMENT,
        VERIFIER_SP1: PROOF_OF_EQUIVALENCE,
        VERIFIER_RISC0: PROOF_OF_EQUIVALENCE,
    }[verifier]


@dataclass
class ProtocolInstance:
    transition: Transition
    block_metadata: BlockMetadata
    prover: bytes = b"\x00" * 20
    sgx_instance: bytes = b"\x00" * 20
    chain_id: int = 0
    verifier_address: bytes = b"\x00" * 20
    proof_of_equivalence: tuple = (0, 0)

    @classmethod
    def new(cls, guest_input, header, verifier: str, device) -> "ProtocolInstance":
        """Build + validate against the GuestInput (ref :30-153); the blob
        commitment's MSM runs on `device` (None: the host)."""
        taiko = guest_input.taiko
        meta = taiko.block_proposed_meta
        blob_used = meta.blob_used
        poe = (0, 0)
        if blob_used:
            commitment = taiko.blob_commitment
            if commitment is None:
                raise ProtocolInstanceError("no blob commitment")
            versioned_hash = eip4844.commitment_to_version_hash(bytes(commitment))
            policy = get_blob_proof_type(verifier, taiko.blob_proof_type)
            if policy == PROOF_OF_EQUIVALENCE:
                x, y = eip4844.proof_of_equivalence(taiko.tx_data, versioned_hash)
                # reference packs as U256::from_le_bytes of the BE buffers
                poe = (
                    int.from_bytes(x, "little"),
                    int.from_bytes(y, "little"),
                )
            else:
                expect = eip4844.blob_to_kzg_commitment(taiko.tx_data, device)
                if bytes(commitment) != expect:
                    raise ProtocolInstanceError("blob commitment mismatch")
            tx_list_hash = versioned_hash
        else:
            tx_list_hash = keccak256(taiko.tx_data)

        # chain spec consistency (ref :70-97)
        verified = SupportedChainSpecs().get_chain_spec_with_chain_id(
            guest_input.chain_spec.chain_id
        )
        if verified is not None:
            cs = guest_input.chain_spec
            for attr in ("max_spec_id", "l1_contract", "l2_contract", "is_taiko"):
                if getattr(cs, attr) != getattr(verified, attr):
                    raise ProtocolInstanceError(f"unexpected {attr}")
            if {k: (c.block, c.timestamp, c.tbd) for k, c in cs.hard_forks.items()} != {
                k: (c.block, c.timestamp, c.tbd) for k, c in verified.hard_forks.items()
            }:
                raise ProtocolInstanceError("unexpected hard_forks")

        # metadata rebuilt from the re-executed header; for taiko chains it
        # must equal the proposal event's metadata (ref :100-150)
        meta2 = BlockMetadata(
            l1_hash=taiko.l1_header.hash(),
            difficulty=meta.difficulty,
            blob_hash=tx_list_hash,
            extra_data=_bytes_to_bytes32(header.extra_data),
            deposits_hash=keccak256(abi.encode([("array", ETH_DEPOSIT_SPEC)], [[]])),
            coinbase=header.beneficiary,
            block_id=header.number,
            gas_limit=header.gas_limit - (250_000 if guest_input.chain_spec.is_taiko else 0),
            timestamp=header.timestamp,
            l1_height=taiko.l1_header.number,
            min_tier=meta.min_tier,
            blob_used=blob_used,
            parent_meta_hash=meta.parent_meta_hash,
            sender=meta.sender,
        )
        if guest_input.chain_spec.is_taiko and meta2.values() != meta.values():
            diffs = [
                i for i, (a, b) in enumerate(zip(meta2.values(), meta.values())) if a != b
            ]
            raise ProtocolInstanceError(f"block metadata mismatch at fields {diffs}")

        verifier_addr = guest_input.chain_spec.verifier_address.get(verifier)
        addr = (
            bytes.fromhex(verifier_addr[2:]) if verifier_addr else b"\x00" * 20
        )
        return cls(
            transition=Transition(
                parent_hash=header.parent_hash,
                block_hash=header.hash(),
                state_root=header.state_root,
                graffiti=taiko.prover_data_graffiti,
            ),
            block_metadata=meta2,
            prover=taiko.prover_data_prover,
            chain_id=guest_input.chain_spec.chain_id,
            verifier_address=addr,
            proof_of_equivalence=poe,
        )

    def meta_hash(self) -> bytes:
        return keccak256(self.block_metadata.abi_encode())

    def instance_hash(self) -> bytes:
        """keccak of the LibPublicInput encoding (ref :165-185).

        The reference calls alloy ``.abi_encode()`` on the tuple (which,
        being dynamic, prepends an offset word) then ``skip(32)``; our
        encoder emits the component head/tail directly, which is the same
        byte string."""
        data = abi.encode(
            [
                "string",
                "uint64",
                "address",
                TRANSITION_SPEC,
                "address",
                "address",
                "bytes32",
                ("tuple", ["uint256", "uint256"]),
            ],
            [
                "VERIFY_PROOF",
                self.chain_id,
                self.verifier_address,
                self.transition.values(),
                self.sgx_instance,
                self.prover,
                self.meta_hash(),
                list(self.proof_of_equivalence),
            ],
        )
        return keccak256(data)


def _bytes_to_bytes32(b: bytes) -> bytes:
    return (b[:32]).ljust(32, b"\x00")
