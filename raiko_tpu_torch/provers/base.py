"""Prover interface + registry (reference lib/src/prover.rs:41-62).

``ProverCtx`` is the analog of the reference's ``id_store: Option<&mut
dyn IdWrite>`` run parameter (lib/src/prover.rs:53-62) plus the task's
CancellationToken: it threads the task key, the session-id store, and a
cooperative cancel event from the scheduler down to backends that manage
remote sessions (provers/remote.py)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from ..core.interfaces import GuestError, Proof, ProofType


@dataclass
class ProverCtx:
    key: Any = None  # TaskDescriptor of the task being proven
    id_store: Any = None  # tasks.TaskManager (implements IdStore)
    cancel_ev: Any = None  # threading.Event set on cancellation
    request: Any = None  # the originating ProofRequest
    device: Any = None  # torch device of the proof's device work; None = host


class Prover:
    proof_type: ProofType

    def run(
        self, guest_input, output, config: dict, ctx: ProverCtx
    ) -> Proof:
        raise NotImplementedError

    def cancel(self, key, id_store=None) -> None:
        """Best-effort cancellation of a running/remote session."""


_REGISTRY: dict[ProofType, Prover] = {}


def register(prover: Prover) -> None:
    _REGISTRY[prover.proof_type] = prover


def get_prover(proof_type: ProofType) -> Prover:
    if proof_type not in _REGISTRY:
        _autoload()
    if proof_type not in _REGISTRY:
        raise GuestError(f"no prover registered for {proof_type}")
    return _REGISTRY[proof_type]


def _autoload() -> None:
    # plain imports: a broken backend module raises here rather than
    # reading as "no prover registered"
    from . import native, remote, tee, tpu_shard, tpu_stark  # noqa: F401
