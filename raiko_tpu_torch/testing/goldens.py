"""The STARK goldens' statements, built by the port from their inputs.

``tests/golden/stark_<case>.json`` (written by
``tools/make_stark_goldens.py`` with the JAX package) keeps each case's
inputs beside the proof's sha256; ``golden_air`` rebuilds the case's AIR,
trace and publics from those inputs, so ``chip_smoke.py`` and the
distributed dry run prove the same statements the goldens hash.
"""

from __future__ import annotations


def golden_air(case: str, inputs: dict):
    """(AIR, trace, publics) of a STARK golden's inputs
    (``tests/golden/stark_<case>.json``)."""
    from ..stark.airs.fib import FibAir
    from ..stark.airs.keccak_air import KeccakBatchSpongeAir
    from ..stark.airs.poseidon2_air import Poseidon2TranscriptAir

    if case == "fib":
        trace, publics = FibAir.trace(inputs["log_n"], inputs["a"], inputs["b"])
        return FibAir(), trace, publics
    if case == "transcript":
        air = Poseidon2TranscriptAir(inputs["blocks"])
        return air, air.trace(), air.publics_for(air.compute_digest())
    if case == "keccak_chunk":
        air = KeccakBatchSpongeAir([bytes.fromhex(m) for m in inputs["messages"]])
        return air, air.trace(), air.publics()
    raise ValueError(f"no golden case {case!r}")
