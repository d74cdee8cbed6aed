"""Milliseconds per tree of the ``frames.replay`` spans: the covered stack
machine replaying the tree's frames (``evm_air.execute_frame``)."""


def read(run):
    s = run.spans.total_s("frames.replay")
    return s / run.units * 1e3 if run.units and s else None
