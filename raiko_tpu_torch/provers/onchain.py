"""On-chain registration + verifier-call analogs.

Two reference flows terminate in contract calls this module mirrors with
REAL wire encodings over the provider surface (the chain simulator
services them like precompiles; a live RPC provider sends the same
bytes):

1. **SGX instance registration**
   (/root/reference/provers/sgx/prover/src/sgx_register_utils.rs,
   setup tool setup_bootstrap.rs): after bootstrap, the new instance
   address + mock quote are submitted to the chain's SGX-verifier
   contract as ``registerInstance(bytes quote, address instance)``
   calldata; the assigned uint32 instance id comes back and prefixes
   every TEE proof.

2. **On-chain proof verification**
   (/root/reference/provers/risc0/driver/src/snarks.rs:159-205: an
   eth_call to the RiscZeroVerifier with the Groth16 seal): the
   TPU-native constant-shape final artifact is the RECURSIVE outer
   proof (provers/tpu_shard.py prove_sharded_recursive — its size is
   independent of the block), submitted as
   ``verifyProof(bytes32 journal, bytes seal)`` where journal = the
   instance hash and seal = the serialized outer artifact.  The
   simulator's verifier contract runs the actual STARK verification on
   the seal; a live chain would run the equivalent verifier.

Quotes are explicitly mock (see provers/tee.py); what this module makes
real is the CALL SHAPE and the round trip, so the host code path is the
reference's.

Port of raiko_tpu/provers/onchain.py, copied whole: it has no device work
(the port's ``testing.chainsim.install_proof_verifier`` verifies the
seals it carries on the device it is given).
"""

from __future__ import annotations

import json
import zlib

from ..proto import abi
from ..utils import keccak256

REGISTER_SELECTOR = keccak256(b"registerInstance(bytes,address)")[:4]
VERIFY_SELECTOR = keccak256(b"verifyProof(bytes32,bytes)")[:4]


def encode_register_instance(quote: bytes, instance: bytes) -> bytes:
    return REGISTER_SELECTOR + abi.encode(
        ["bytes", "address"], [quote, instance]
    )


def decode_register_instance(data: bytes) -> tuple[bytes, bytes]:
    if data[:4] != REGISTER_SELECTOR:
        raise ValueError("not a registerInstance call")
    quote, instance = abi.decode(["bytes", "address"], data[4:])
    return quote, instance


def encode_verify_proof(journal: bytes, seal: bytes) -> bytes:
    return VERIFY_SELECTOR + abi.encode(["bytes32", "bytes"], [journal, seal])


def decode_verify_proof(data: bytes) -> tuple[bytes, bytes]:
    if data[:4] != VERIFY_SELECTOR:
        raise ValueError("not a verifyProof call")
    journal, seal = abi.decode(["bytes32", "bytes"], data[4:])
    return journal, seal


def seal_from_payload(payload: dict) -> bytes:
    """The constant-shape final artifact: the recursive outer proof's
    serialized form (zlib'd JSON — size set by the outer STARK, not the
    block)."""
    return zlib.compress(json.dumps(payload, sort_keys=True).encode())


def payload_from_seal(seal: bytes) -> dict:
    return json.loads(zlib.decompress(seal))


def register_sgx_instance(provider, verifier_addr: bytes, quote: bytes,
                          instance: bytes) -> int:
    """Submit the registration call; -> assigned instance id
    (ref sgx_register_utils.rs:263 register_sgx_instance)."""
    data = encode_register_instance(quote, instance)
    out = provider.call_contract(verifier_addr, data)
    (instance_id,) = abi.decode(["uint32"], out)
    return int(instance_id)


def verify_proof_onchain(provider, verifier_addr: bytes, journal: bytes,
                         seal: bytes) -> bool:
    """eth_call the verifier contract; True iff it returns success
    (ref snarks.rs:159-205 verify_groth16_snark)."""
    data = encode_verify_proof(journal, seal)
    try:
        out = provider.call_contract(verifier_addr, data)
    except Exception:
        return False
    return bool(out) and abi.decode(["bool"], out)[0]
