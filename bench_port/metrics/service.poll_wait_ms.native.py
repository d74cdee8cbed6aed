"""Milliseconds a poll waits outside its answer: the client's round trips
(``poll_s``) less the service's ``service.poll`` spans, over the polls."""


def read(run):
    n, s = run.counters.get("polls"), run.spans.total_s("service.poll")
    return (run.counters["poll_s"] - s) / n * 1e3 if n and s else None
