"""TEE-style prover: sign the instance hash with a sealed secp256k1 key
and attach a mock attestation quote.

Mirrors the reference SGX backend's proof shape (provers/sgx/guest/src/
one_shot.rs:117-172): proof = 4-byte instance_id ‖ 20-byte new-instance
address ‖ 65-byte ECDSA signature; plus a quote blob.  Real SGX hardware
is out of scope on TPU hosts (SURVEY.md §2.2) — the interface and
signing semantics are kept so the host/API surface is identical; the
attestation quote is explicitly a mock.

Modes (reference SgxParam :32-37): setup / bootstrap / prove.

Port of raiko_tpu/provers/tee.py, copied but for the device: ``run``
re-executes the block with ``ctx.device`` (None: the host), as every
backend of the port does.
"""

from __future__ import annotations

import hashlib
import json
import os
import secrets

from ..core.interfaces import GuestError, Proof, ProofType
from ..evm.builder import calculate_block_header
from ..proto.instance import ProtocolInstance
from ..utils import secp256k1
from .base import Prover, register

DEFAULT_KEY_DIR = os.path.expanduser("~/.config/raiko-tpu/secrets")
KEY_FILE = "priv.key"


class TeeProver(Prover):
    proof_type = ProofType.TEE

    def __init__(self, key_dir: str | None = None):
        self.key_dir = key_dir or DEFAULT_KEY_DIR

    # -- key lifecycle (ref one_shot bootstrap) --------------------------
    def bootstrap(self) -> dict:
        os.makedirs(self.key_dir, exist_ok=True)
        secret = secrets.randbelow(secp256k1.N - 1) + 1
        with open(os.path.join(self.key_dir, KEY_FILE), "w") as f:
            f.write(hex(secret))
        addr = secp256k1.pubkey_to_address(secp256k1.pubkey(secret))
        quote = self._mock_quote(addr)
        return {"new_instance": "0x" + addr.hex(), "quote": quote.hex()}

    def _load_key(self) -> int:
        path = os.path.join(self.key_dir, KEY_FILE)
        if not os.path.exists(path):
            raise GuestError("tee prover not bootstrapped (no sealed key)")
        with open(path) as f:
            return int(f.read().strip(), 16)

    def _mock_quote(self, addr: bytes) -> bytes:
        # explicitly a mock: binds the instance address into a fake quote
        # body with a recognizable header (NOT a real DCAP quote)
        body = b"RAIKO-TPU-MOCK-QUOTE" + addr
        return body + hashlib.sha256(body).digest()

    def register_instance(self, provider, verifier_addr: bytes) -> int:
        """Self-register the bootstrapped instance with the chain's SGX
        verifier contract and return the assigned instance id — the
        reference's one-command docker bootstrap flow
        (provers/sgx/setup/src/setup_bootstrap.rs +
        sgx_register_utils.rs:263 register_sgx_instance)."""
        from .onchain import register_sgx_instance

        secret = self._load_key()
        addr = secp256k1.pubkey_to_address(secp256k1.pubkey(secret))
        quote = self._mock_quote(addr)
        return register_sgx_instance(provider, verifier_addr, quote, addr)

    # -- proving ----------------------------------------------------------
    def run(self, guest_input, output, config: dict, ctx) -> Proof:
        params = (config or {}).get("tee", (config or {}).get("sgx", {})) or {}
        if params.get("bootstrap"):
            info = self.bootstrap()
            return Proof(quote=info["quote"], meta=info)
        instance_id = int(params.get("instance_id", 0))
        secret = self._load_key()
        addr = secp256k1.pubkey_to_address(secp256k1.pubkey(secret))
        header = calculate_block_header(guest_input, device=ctx.device)
        pi = ProtocolInstance.new(guest_input, header, "SGX", ctx.device)
        pi.sgx_instance = addr  # ref sgx_instance builder (:155-158)
        ih = pi.instance_hash()
        r, s, rec = secp256k1.sign(ih, secret)
        sig = r.to_bytes(32, "big") + s.to_bytes(32, "big") + bytes([27 + rec])
        proof_bytes = instance_id.to_bytes(4, "big") + addr + sig
        return Proof(
            proof="0x" + proof_bytes.hex(),
            input_hash="0x" + ih.hex(),
            quote=self._mock_quote(addr).hex(),
        )


register(TeeProver())
