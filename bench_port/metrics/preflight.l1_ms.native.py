"""Milliseconds per request of the ``preflight.l1`` spans: the L1 data of
the block (anchor, proposal event, blob and its KZG commitment)."""


def read(run):
    s = run.spans.total_s("preflight.l1")
    return s / run.units * 1e3 if run.units and s else None
