"""Milliseconds per tree of ``stark.transcript`` spans: the host hashing
the Fiat-Shamir transcript between the stages."""


def read(run):
    if not run.units:
        return None
    return run.spans.total_s("stark.transcript") / run.units * 1e3
