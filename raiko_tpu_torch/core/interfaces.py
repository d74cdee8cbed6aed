"""Proof request/response model + error taxonomy
(reference core/src/interfaces.rs)."""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum


class ProofType(str, Enum):
    """Backends (reference ProofType :98-116): NATIVE re-executes with no
    proof; TEE signs the instance hash (SGX-analog); TPU_STARK is the
    TPU-native STARK backend (risc0/sp1-analog); TPU_SHARD is its
    shard-parallel multi-chip variant."""

    NATIVE = "native"
    TEE = "tee"
    TPU_STARK = "tpu_stark"
    TPU_SHARD = "tpu_shard"
    # dispatch to another raiko-tpu host over the v2 API (the analog of
    # the reference's Bonsai / SP1-network remote proving,
    # provers/risc0/driver/src/bonsai.rs:195-226)
    REMOTE = "remote"

    @classmethod
    def parse(cls, v: str) -> "ProofType":
        try:
            return cls(v.lower())
        except ValueError:
            raise RaikoError(f"unknown proof type: {v}") from None


class RaikoError(Exception):
    """Reference RaikoError taxonomy (:17-72)."""

    kind = "unspecified"


class InvalidRequestConfig(RaikoError):
    kind = "invalid_request_config"


class RpcError(RaikoError):
    kind = "rpc"


class GuestError(RaikoError):
    kind = "guest"


class PreflightError(RaikoError):
    kind = "preflight"


@dataclass
class ProofRequest:
    """reference ProofRequest (:265-284)."""

    block_number: int
    network: str
    proof_type: ProofType
    l1_network: str = "ethereum"
    prover: str = "0x" + "00" * 20
    graffiti: str = "0x" + "00" * 32
    blob_proof_type: str = "proof_of_commitment"
    prover_args: dict = field(default_factory=dict)

    @classmethod
    def from_opt(cls, opt: dict) -> "ProofRequest":
        """Build from a partial JSON config, validating required fields
        (reference ProofRequestOpt -> ProofRequest TryFrom)."""
        missing = [
            k for k in ("block_number", "network", "proof_type") if opt.get(k) is None
        ]
        if missing:
            raise InvalidRequestConfig(f"missing fields: {', '.join(missing)}")
        return cls(
            block_number=int(opt["block_number"]),
            network=str(opt["network"]),
            proof_type=ProofType.parse(str(opt["proof_type"])),
            l1_network=str(opt.get("l1_network") or "ethereum"),
            prover=str(opt.get("prover") or "0x" + "00" * 20),
            graffiti=str(opt.get("graffiti") or "0x" + "00" * 32),
            blob_proof_type=str(opt.get("blob_proof_type") or "proof_of_commitment"),
            prover_args={
                k: v
                for k, v in opt.items()
                if k
                not in (
                    "block_number",
                    "network",
                    "proof_type",
                    "l1_network",
                    "prover",
                    "graffiti",
                    "blob_proof_type",
                )
            },
        )


@dataclass
class Proof:
    """Unified proof artifact (reference Proof struct)."""

    proof: str | None = None  # hex payload
    input_hash: str | None = None  # instance hash hex
    quote: str | None = None  # TEE attestation
    kzg_proof: str | None = None  # appended blob proof (ref :207-219)
    uuid: str | None = None  # remote session id
    meta: dict = field(default_factory=dict)

    def to_json(self) -> dict:
        return {
            "proof": self.proof,
            "input": self.input_hash,
            "quote": self.quote,
            "kzg_proof": self.kzg_proof,
            "uuid": self.uuid,
            **({"meta": self.meta} if self.meta else {}),
        }


def merge_json(a: dict, b: dict) -> dict:
    """Recursive JSON merge, b wins, null-preserving
    (reference core/src/lib.rs:199-210)."""
    out = dict(a)
    for k, v in b.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge_json(out[k], v)
        elif v is not None or k not in out:
            out[k] = v
    return out
