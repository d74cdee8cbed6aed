"""Seconds per served request, from the client's side: the window over
the requests it completed."""


def read(run):
    return run.seconds_per_unit()
