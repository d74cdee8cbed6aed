"""Milliseconds per request of the ``preflight.witness`` spans: the
state proofs turned into tries, the ancestors and the contracts."""


def read(run):
    s = run.spans.total_s("preflight.witness")
    return s / run.units * 1e3 if run.units and s else None
