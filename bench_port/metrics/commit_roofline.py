"""The commitment kernels' share of their roofline, in percent: the least
time of every ``intt``, ``ntt_coset``, ``poseidon2_hash_rows`` and
``poseidon2_merkle`` call of the window (``roofline.py``), summed, over
their device time summed."""

import roofline


def read(run):
    return roofline.share(run, roofline.KERNELS)
