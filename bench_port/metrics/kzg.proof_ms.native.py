"""Milliseconds per request of the ``kzg.proof`` spans: the blob's KZG
opening proof (``calc_kzg_proof``) that every answer carries."""


def read(run):
    s = run.spans.total_s("kzg.proof")
    return s / run.units * 1e3 if run.units and s else None
