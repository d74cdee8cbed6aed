"""Milliseconds per request of the service's ``service.guest_execution``
spans: ``Raiko.get_output``, which re-executes the block and computes its
protocol instance before the prover runs."""


def read(run):
    s = run.spans.total_s("service.guest_execution")
    return s / run.units * 1e3 if run.units and s else None
