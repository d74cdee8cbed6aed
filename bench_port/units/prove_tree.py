"""Unit ``prove_tree``: one EVM call tree proven by the port's frame
statement, ``provers.tpu_stark.prove_evm_frames`` on one top-level frame.

Set-up builds the seed's blocks, collects their call trees and proves one
tree of each group (its code), so that the window finds every table's
constraint tape recorded, as a long-running prover does.  The window
proves the trees in turn.  The check: every proof's statement is the tree
asked for, and the frozen verifier on the CPU accepts each proof of a
sample of the trees drawn from the seed (with every group in it); every
proof of one tree must be the same bytes.
"""

from __future__ import annotations

import json
import random

from trees import collect_trees, reference_accepts, sample, statement_matches
from unit_base import UnitBase

P = 2**31 - 2**27 + 1


class Unit(UnitBase):
    # control: fewer FRI queries than the configuration's 45 (a proof of
    # lower soundness); stale: the previous proof returned again; half:
    # half of the tree's tables left out; altered: one opened value changed
    faults = ("control", "stale", "half", "altered")

    def setup(self) -> None:
        from raiko_tpu_torch.provers import tpu_stark

        self.prove_evm_frames = tpu_stark.prove_evm_frames
        self.cands, self.hashes, _ = collect_trees(self.seed, self.traffic, self.settings, self.device)
        self.cycle = len(self.cands)
        self.sampled = set(sample(self.seed, self.cands, self.traffic["check_trees"]))
        self.proofs: dict = {}  # candidate index -> its payloads in the window (sampled ones)
        self.records: list = []  # (candidate index, covered, top frame's statement check)
        self.restore = None
        if self.inject == "control":
            from raiko_tpu_torch.stark import prover

            kept = prover.NUM_QUERIES
            prover.NUM_QUERIES = self.settings["prover"]["num_queries"] - 1
            self.restore = lambda: setattr(prover, "NUM_QUERIES", kept)
        warmed = set()
        for cand in self.cands:
            if cand["group"] not in warmed:
                self.prove(cand)
                warmed.add(cand["group"])
        self.last = None

    def describe(self) -> dict:
        groups = sorted({c["group"] for c in self.cands})
        return {"blocks": self.hashes, "trees": len(self.cands),
                "groups": {g: sum(c["group"] == g for c in self.cands) for g in groups},
                "sampled": sorted(self.sampled)}

    def prove(self, cand: dict) -> dict:
        prover = self.settings["prover"]
        return self.prove_evm_frames([cand], self.device, max_frames=1, max_steps=int(prover["max_evm_steps"]),
                                     workers=1)

    def run(self, i: int) -> None:
        k = i % len(self.cands)
        evm = self.prove(self.cands[k])
        if self.inject == "stale" and self.last is not None:
            evm, self.last = self.last, evm
        else:
            self.last = evm
        if evm is not None and self.inject == "half":
            tree = evm["frames"][0]
            evm = {**evm, "frames": [{**tree, "starks": tree["starks"][: len(tree["starks"]) // 2]}]}
        if evm is not None and self.inject == "altered":
            tree = json.loads(json.dumps(evm["frames"][0]))
            row = tree["starks"][0]["queries"][0]["trace_row"]
            row[0] = (row[0] + 1) % P
            evm = {**evm, "frames": [tree]}
        covered = evm is not None and evm.get("covered") == 1
        self.records.append((k, covered, covered and statement_matches(evm["frames"][0], self.cands[k])))
        if k in self.sampled and evm is not None:
            self.proofs.setdefault(k, []).append(evm)

    def close(self) -> None:
        import torch

        self.last = None
        if getattr(self, "restore", None) is not None:
            self.restore()
        if self.device == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        uncovered = sum(not covered for _, covered, _ in self.records)
        wrong_statement = sum(covered and not ok for _, covered, ok in self.records)
        rejected = differing = 0
        for k in sorted(self.proofs):
            texts = {json.dumps(p, sort_keys=True) for p in self.proofs[k]}
            differing += len(texts) - 1
            rejected += sum(not reference_accepts(json.loads(t)) for t in texts)
        return {
            "trees_not_proven": {"value": uncovered, "limit": 0},
            "statements_not_asked": {"value": wrong_statement, "limit": 0},
            "proofs_rejected": {"value": rejected, "limit": 0},
            "proofs_differing": {"value": differing, "limit": 0},
            "sample_empty": {"value": int(not self.proofs), "limit": 0},
        }
