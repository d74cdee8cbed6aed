"""What the two call-tree units share: the blocks, their call trees, and
the plain reference's verdict on a tree's proof.

The trees are the top-level call frames that the port's re-execution of
each block collects for the EVM frame statement
(``calculate_block_header(..., collect)``, as ``TpuStarkProver.run``
does); they are the inputs both sides get.  The reference is the frozen
copy of the port's verifier in ``frozen_verifier/`` on the CPU, with the
proof's statement held against the tree it was asked to prove.
"""

from __future__ import annotations

import random

from chain_mix import build_chain


def collect_trees(seed: int, traffic: dict, settings: dict, device: str) -> tuple[list, list, list]:
    """(call-tree candidates in cycle order, each block's hash, what the
    seed drew).  Each candidate is the port's frame record of one
    transaction, with ``block`` and ``group`` (its code: the trees of one
    group have the same tables) added.  The cycle spreads each group
    evenly, so that every seed puts the same mix in any stretch of it."""
    from raiko_tpu_torch.chain import SupportedChainSpecs
    from raiko_tpu_torch.core.interfaces import ProofRequest, ProofType
    from raiko_tpu_torch.core.orchestrator import Raiko
    from raiko_tpu_torch.evm.builder import calculate_block_header

    l2, drawn = build_chain(seed, traffic["blocks"], traffic["txs_per_block"], traffic["mix"],
                            traffic["contracts"], device, l1_network=settings["l1_network"])
    cands, hashes = [], []
    for blk in range(1, traffic["blocks"] + 1):
        hashes.append("0x" + l2.headers[blk].hash().hex())
        req = ProofRequest(block_number=blk, network=settings["network"], l1_network=settings["l1_network"],
                           proof_type=ProofType.TPU_STARK, prover_args=dict(settings["prover"]))
        raiko = Raiko(SupportedChainSpecs(), req, device)
        collect: dict = {}
        calculate_block_header(raiko.generate_input(), collect, device=device)
        for cand in collect.get("frames") or []:
            cands.append({**cand, "block": blk})
    groups: dict = {}
    for cand in cands:
        groups.setdefault(cand["code"], []).append(cand)
    keyed = []
    for g, (_, members) in enumerate(sorted(groups.items(), key=lambda kv: (-len(kv[1]), kv[0]))):
        for j, cand in enumerate(members):
            cand["group"] = g
            keyed.append(((j + 0.5) / len(members), g, cand))
    keyed.sort(key=lambda k: (k[0], k[1]))
    return [k[2] for k in keyed], hashes, drawn


def sample(seed: int, cands: list, k: int) -> list[int]:
    """Indices of `k` candidates drawn from the seed: one of every group
    first (the largest tree among them), then the rest at random."""
    rng = random.Random(seed ^ 0x5EED)
    firsts = {}
    for i, c in enumerate(cands):
        firsts.setdefault(c["group"], i)
    picked = list(firsts.values())
    rest = [i for i in range(len(cands)) if i not in picked]
    rng.shuffle(rest)
    return sorted(picked + rest[: max(0, k - len(picked))])


def statement_matches(tree: dict, cand: dict) -> bool:
    """The proof's public statement is the tree it was asked for: the top
    frame's code, calldata, gas, gas left and addresses."""
    top = tree["frames"][0]
    env = top["env"]
    return (top["code"] == bytes(cand["code"]).hex() and top["calldata"] == bytes(cand["calldata"]).hex()
            and int(top["gas0"]) == cand["gas"] and int(top["gas_f"]) == cand["gas_left"]
            and int(env["address"], 16) == cand["address"] and int(env["caller"], 16) == cand["caller"]
            and int(env["callvalue"], 16) == cand["callvalue"])


def reference_accepts(evm: dict) -> bool:
    """The frozen verifier's verdict on an ``evm-frames-v1`` payload, on
    the CPU: the shape ``verify_evm_frames_payload`` checks, then every
    tree's multi-table proof."""
    from frozen_verifier.stark.airs import evm_air as frozen

    frames = evm.get("frames", [])
    if evm.get("kind") != "evm-frames-v1" or not frames or len(frames) != evm.get("covered"):
        return False
    return all(frozen.verify_frame_payload(tree, "cpu") for tree in frames)
