"""The 95th percentile of the window's request seconds, client side, over
all its requests."""


def read(run):
    return run.percentile(95)
