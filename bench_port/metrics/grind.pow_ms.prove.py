"""Milliseconds per tree of the ``grind.pow`` spans: the proof-of-work
grind (``channel.grind``), inside ``stark.grind_queries``."""


def read(run):
    s = run.spans.total_s("grind.pow")
    return s / run.units * 1e3 if run.units and s else None
