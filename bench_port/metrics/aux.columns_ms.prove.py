"""Milliseconds per tree of the ``aux.columns`` spans: the host building
each table's LogUp columns (``air.aux_trace``), inside ``stark.aux_commit``."""


def read(run):
    s = run.spans.total_s("aux.columns")
    return s / run.units * 1e3 if run.units and s else None
