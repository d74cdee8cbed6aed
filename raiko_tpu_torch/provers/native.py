"""Native prover: re-execute, recompute the protocol instance, check it
matches the claimed output, return no proof payload
(reference core/src/prover.rs:27-65)."""

from __future__ import annotations

import json
import os

from ..core.interfaces import GuestError, Proof, ProofType
from ..evm.builder import calculate_block_header
from ..proto.instance import ProtocolInstance
from .base import Prover, register


class NativeProver(Prover):
    proof_type = ProofType.NATIVE

    def run(self, guest_input, output, config: dict, ctx) -> Proof:
        write_path = (config or {}).get("native", {}).get("write_guest_input_path")
        if write_path:
            os.makedirs(os.path.dirname(write_path) or ".", exist_ok=True)
            with open(write_path, "wb") as f:
                f.write(guest_input.to_bytes())
        header = calculate_block_header(guest_input, device=ctx.device)
        pi = ProtocolInstance.new(guest_input, header, "None", ctx.device)
        if pi.instance_hash() != output.hash:
            raise GuestError(
                "protocol instance hash mismatch: "
                f"{pi.instance_hash().hex()} vs {output.hash.hex()}"
            )
        return Proof(input_hash="0x" + output.hash.hex())


register(NativeProver())
