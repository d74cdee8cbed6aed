"""Calls into the port's host Keccak-256 library per request (its
``CALLS`` counter over the window)."""


def read(run):
    n = run.units
    return run.counters["host_keccak_calls"] / n if n and "host_keccak_calls" in run.counters else None
