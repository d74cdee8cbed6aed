"""Milliseconds per tree outside every ``stark.*`` span: replaying the
frame, building its tables' traces, serialising the proof."""


def read(run):
    if not run.units:
        return None
    return (run.window_s - run.spans.total_s("stark.")) / run.units * 1e3
