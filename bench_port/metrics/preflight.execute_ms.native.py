"""Milliseconds per request of the ``preflight.execute`` spans: decoding
the block's transactions and the optimistic execution loop."""


def read(run):
    s = run.spans.total_s("preflight.execute")
    return s / run.units * 1e3 if run.units and s else None
