"""Device milliseconds per tree of the work launched inside the
``stark.quotient`` profiler ranges (kernel Q1, the quotient's NTTs and
its commitment)."""


def read(run):
    if run.trace is None or not run.units:
        return None
    return run.trace.device_s_in("stark.quotient") / run.units * 1e3
