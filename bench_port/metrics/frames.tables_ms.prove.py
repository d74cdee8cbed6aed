"""Milliseconds per tree of the ``frames.tables`` spans: flattening the
call tree and building its frame records, its tables' traces and its
balance journal (``evm_air.prove_call_tree``)."""


def read(run):
    s = run.spans.total_s("frames.tables")
    return s / run.units * 1e3 if run.units and s else None
