"""Kernel ``poseidon2_merkle``'s share of its roofline, in percent: the least time of
its calls in the window (``roofline.py``), summed, over their device time."""

import roofline


def read(run):
    return roofline.share(run, ("poseidon2_merkle",))
