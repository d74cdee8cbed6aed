"""Milliseconds per request of the service's preflight, from its
``prepare_input_time_histogram`` observations in the window."""


def read(run):
    n = run.counters.get("preflight_n")
    return run.counters["preflight_s"] / n * 1e3 if n else None
