"""Proof backends (reference provers/ crates).

Registry-dispatched (reference run_prover, core/src/interfaces.rs:168-222).
The port registers every backend the reference serves: ``native``
(re-execute + check, no proof; reference NativeProver), ``tpu_stark``
(the STARK backend, with the recursion seal on request), ``tpu_shard``
(the shard-parallel backend, with recursive aggregation on request),
``tee`` (a signed instance hash with a mock quote) and ``remote``
(forwarded to another server over v2).
"""

from ..core.interfaces import ProofType
from .base import Prover, ProverCtx, get_prover  # noqa: F401


def run_prover(
    proof_type: ProofType, guest_input, output, config: dict, ctx
):
    """Dispatch + append the KZG blob proof (ref interfaces.rs:170-222).
    The opening proof's MSM runs on ``ctx.device`` (None: the host)."""
    prover = get_prover(proof_type)
    proof = prover.run(guest_input, output, config, ctx)
    # append blob KZG data for on-chain blob verification (ref :207-219)
    taiko = guest_input.taiko
    if taiko.blob_commitment is not None and guest_input.chain_spec.is_taiko:
        from ..kzg import eip4844

        vh = eip4844.commitment_to_version_hash(bytes(taiko.blob_commitment))
        kzg_proof = eip4844.calc_kzg_proof(taiko.tx_data, vh, ctx.device)
        proof.kzg_proof = "0x" + kzg_proof.hex()
    return proof


def cancel_proof(proof_type: ProofType, key, id_store=None):
    prover = get_prover(proof_type)
    prover.cancel(key, id_store)
