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


def call_tree_tables(inputs: dict) -> list:
    """(AIR, trace, publics) of every table of the EVM call tree of
    ``tests/golden/stark_evm_call_tree.json``'s inputs, in the order
    ``evm_air.prove_call_tree`` proves them."""
    from ..stark.airs import evm_air as ea
    from ..stark.airs import evm_call as ec

    root = ea.execute_frame(bytes.fromhex(inputs["caller"]), ea.FrameEnv(**inputs["env"]), inputs["gas"],
                            world={inputs["callee_address"]: {"code": bytes.fromhex(inputs["callee"])}},
                            warm_addresses=set())
    fts = ea.flatten_call_tree(root)
    tables = []
    for ft in fts:
        tables.extend(ea.frame_tables(ft))
        tables.extend(ea._frame_extra_tables(ft))
    groups, events = ea.balance_journal(fts)
    if groups:
        bal = ec.EvmBalanceAir(groups)
        tables.append((bal, bal.trace(events), bal.publics()))
    return tables
