"""The reference package's host code, for callers of the port.

The port reuses ``raiko_tpu``'s framework-free host code unchanged (the
service, orchestrator, EVM, KZG host arithmetic) and replaces
only its device code (``seams``).  Scripts that drive the port reach that
host code through this module, not through ``raiko_tpu`` itself.  Nothing
named here imports JAX at load, and none of it reaches JAX on the host
path (``seams.host_path``).
"""

from __future__ import annotations

from raiko_tpu.chain import SupportedChainSpecs
from raiko_tpu.core.interfaces import ProofRequest, ProofType
from raiko_tpu.core.orchestrator import Raiko
from raiko_tpu.core.provider import _SIM_REGISTRY, register_sim
from raiko_tpu.kzg import eip4844 as kzg
from raiko_tpu.proto.types import Transaction
from raiko_tpu.utils import secp256k1

__all__ = [
    "ProofRequest",
    "ProofType",
    "Raiko",
    "SupportedChainSpecs",
    "Transaction",
    "clear_sims",
    "kzg",
    "register_sim",
    "secp256k1",
]


def clear_sims() -> None:
    """Forget every chain simulator registered with the provider."""
    _SIM_REGISTRY.clear()
