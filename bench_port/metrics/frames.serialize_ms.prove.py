"""Milliseconds per tree of the ``frames.serialize`` spans: the tree's
proofs turned into the payload's dictionaries (``serde.proof_to_dict``)."""


def read(run):
    s = run.spans.total_s("frames.serialize")
    return s / run.units * 1e3 if run.units and s else None
