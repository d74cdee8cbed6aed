"""Milliseconds per tree in the STARK prover's stage spans (trace and aux
commitments, quotient, OOD, DEEP, FRI, grinding and queries), summed."""

STAGES = ("stark.trace_commit", "stark.aux_commit", "stark.quotient", "stark.ood", "stark.deep", "stark.fri",
          "stark.grind_queries")


def read(run):
    if not run.units:
        return None
    return sum(run.spans.total_s(s) for s in STAGES) / run.units * 1e3
