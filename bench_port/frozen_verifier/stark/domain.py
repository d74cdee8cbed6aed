"""Cached per-domain precomputes for the STARK pipeline.

Everything indexed in **bit-reversed order** over the coset shift*H_m
(matching ops/ntt.py LDE output).  Computed once per (log_n, blowup_log)
with Python ints (exact), stored as Montgomery numpy arrays.
"""

from __future__ import annotations

import functools

import numpy as np

from ..fields import babybear as bb
from ..ops import ntt


def batch_inverse_ints(vals: list[int]) -> list[int]:
    prefix = [1] * (len(vals) + 1)
    for i, v in enumerate(vals):
        prefix[i + 1] = prefix[i] * v % bb.P
    inv = pow(prefix[-1], bb.P - 2, bb.P)
    out = [0] * len(vals)
    for i in range(len(vals) - 1, -1, -1):
        out[i] = prefix[i] * inv % bb.P
        inv = inv * vals[i] % bb.P
    return out


@functools.lru_cache(maxsize=16)
class Domain:
    """STARK evaluation domain: trace group H_n extended to coset shift*H_m."""

    def __init__(self, log_n: int, blowup_log: int = 2, shift: int = bb.GENERATOR):
        self.log_n = log_n
        self.blowup_log = blowup_log
        self.n = 1 << log_n
        self.m = self.n << blowup_log
        self.shift = shift
        self.g = bb.two_adic_generator(log_n)  # trace domain generator
        w = bb.two_adic_generator(log_n + blowup_log)
        rev = ntt.bit_reverse_indices(self.m)
        self.rev = rev
        # x values over the coset, bitrev order
        xs_nat = [1] * self.m
        for j in range(1, self.m):
            xs_nat[j] = xs_nat[j - 1] * w % bb.P
        xs_nat = [shift * v % bb.P for v in xs_nat]
        self.xs_int = [xs_nat[int(rev[i])] for i in range(self.m)]
        g_last = pow(self.g, self.n - 1, bb.P)
        self.g_last = g_last
        # vanishing / selector tables
        zh = [(pow(x, self.n, bb.P) - 1) % bb.P for x in self.xs_int]
        zh_inv = batch_inverse_ints(zh)
        first = [(x - 1) % bb.P for x in self.xs_int]
        last = [(x - g_last) % bb.P for x in self.xs_int]
        first_inv = batch_inverse_ints(first)
        last_inv = batch_inverse_ints(last)
        self.trans_sel = bb.np_to_mont(
            np.array(
                [last[i] * zh_inv[i] % bb.P for i in range(self.m)],
                dtype=np.uint32,
            )
        )
        self.all_inv = bb.np_to_mont(np.array(zh_inv, dtype=np.uint32))
        self.first_inv = bb.np_to_mont(np.array(first_inv, dtype=np.uint32))
        self.last_inv = bb.np_to_mont(np.array(last_inv, dtype=np.uint32))
        self.xs_mont = bb.np_to_mont(np.array(self.xs_int, dtype=np.uint32))
        # bitrev "next row" gather: T(g*x) at bitrev index i
        blowup = 1 << blowup_log
        self.next_perm = np.array(
            [int(rev[(int(rev[i]) + blowup) % self.m]) for i in range(self.m)],
            dtype=np.int32,
        )

    # verifier-side scalar selector values at an EF point -----------------
    def sel_at(self, z: tuple) -> dict:
        from ..fields import babybear_ext as ef

        zn = ef.h_pow(z, self.n)
        zh = ef.h_sub(zn, ef.H_ONE)
        zh_inv = ef.h_inv(zh)
        z_last = ef.h_sub(z, ef.h_from_base(self.g_last))
        z_first = ef.h_sub(z, ef.H_ONE)
        return {
            "transition": ef.h_mul(z_last, zh_inv),
            "first_row": ef.h_inv(z_first),
            "last_row": ef.h_inv(z_last),
            "all_rows": zh_inv,
        }
