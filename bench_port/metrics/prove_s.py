"""Seconds per proven call tree: the window over the trees it proved."""


def read(run):
    return run.seconds_per_unit()
