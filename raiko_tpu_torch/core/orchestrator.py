"""Raiko orchestrator (reference core/src/lib.rs:31-121).

generate_input -> get_output -> prove: preflight, host-side re-execution
with field-by-field header diffing (check_header, ref :123-172), and
backend dispatch.

The device is explicit and has no default: ``Raiko(..., device)`` runs
every step's device work (the KZG MSMs, batched sender recovery) on that
torch device, and a caller that passes ``None`` chooses the reference's
host path (host MSM, per-tx recovery)."""

from __future__ import annotations

from dataclasses import dataclass

from .. import device as device_mod
from ..chain import SupportedChainSpecs
from ..evm.builder import calculate_block_header
from ..proto.input import GuestInput, GuestOutput
from ..proto.instance import ProtocolInstance
from .interfaces import GuestError, Proof, ProofRequest
from .preflight import preflight

_VERIFIER_OF = {
    "native": "None",
    "tee": "SGX",
    "tpu_stark": "RISC0",
    "tpu_shard": "SP1",
}


def _verifier_for(request: ProofRequest) -> str:
    """Verifier address selector for the instance hash.  The remote
    dispatcher proves with whatever backend the remote host runs, so its
    local output check must use the INNER proof type's verifier."""
    pt = request.proof_type.value
    if pt == "remote":
        inner = str(request.prover_args.get("remote_proof_type", "native"))
        return _VERIFIER_OF.get(inner, "None")
    return _VERIFIER_OF[pt]


class Raiko:
    def __init__(
        self,
        chain_specs: SupportedChainSpecs,
        request: ProofRequest,
        device,
    ):
        self.chain_specs = chain_specs
        self.request = request
        self.device = None if device is None else device_mod.get(device)

    def generate_input(self) -> GuestInput:
        return preflight(self.request, self.chain_specs, self.device)

    def get_output(self, guest_input: GuestInput) -> GuestOutput:
        header = calculate_block_header(guest_input, device=self.device)
        check_header(guest_input.block_header, header)
        pi = ProtocolInstance.new(
            guest_input, header, _verifier_for(self.request), self.device
        )
        return GuestOutput(header=header, hash=pi.instance_hash())

    def prove(
        self, guest_input: GuestInput, output: GuestOutput, config=None, ctx=None
    ) -> Proof:
        from ..provers import ProverCtx, run_prover

        ctx = ctx or ProverCtx()
        ctx.request = ctx.request or self.request
        ctx.device = self.device
        return run_prover(
            self.request.proof_type,
            guest_input,
            output,
            config or {**self.request.prover_args},
            ctx,
        )

    def cancel(self, key, id_store=None) -> None:
        from ..provers import cancel_proof

        cancel_proof(self.request.proof_type, key, id_store)


_HEADER_FIELDS = [
    "parent_hash",
    "ommers_hash",
    "beneficiary",
    "state_root",
    "transactions_root",
    "receipts_root",
    "logs_bloom",
    "difficulty",
    "number",
    "gas_limit",
    "gas_used",
    "timestamp",
    "extra_data",
    "mix_hash",
    "nonce",
    "base_fee_per_gas",
    "withdrawals_root",
    "blob_gas_used",
    "excess_blob_gas",
    "parent_beacon_block_root",
]


def check_header(expected, actual) -> None:
    """Field-by-field diff so mismatches are debuggable
    (reference check_header, core/src/lib.rs:123-172)."""
    diffs = []
    for f in _HEADER_FIELDS:
        e, a = getattr(expected, f), getattr(actual, f)
        if e != a:
            diffs.append(f"{f}: expected {e!r}, got {a!r}")
    if diffs:
        raise GuestError("header mismatch:\n  " + "\n  ".join(diffs))
    if expected.hash() != actual.hash():
        raise GuestError("header hash mismatch with equal fields (encoding bug)")
