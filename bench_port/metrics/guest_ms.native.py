"""Milliseconds per request of the service's proving step (the native
prover's re-execution, instance and KZG proof), from its
``guest_proof_time_histogram`` observations in the window."""


def read(run):
    n = run.counters.get("guest_n")
    return run.counters["guest_s"] / n * 1e3 if n else None
