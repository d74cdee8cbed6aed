"""Milliseconds per tree of the STARK prover's own time outside its stages:
the ``prover.tables`` spans less every ``stark.*`` span (the stages and
the transcript), i.e. each AIR's fixed columns, bus values and per-table
set-up between the stages."""


def read(run):
    s = run.spans.total_s("prover.tables")
    return (s - run.spans.total_s("stark.")) / run.units * 1e3 if run.units and s else None
