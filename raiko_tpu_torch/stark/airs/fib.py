"""Fibonacci AIR — the canonical smoke-test AIR for the STARK pipeline.

Trace: two columns (a, b); transition a' = b, b' = a + b.
Boundary: a[0] = public[0], b[0] = public[1], b[n-1] = public[2].
"""

from __future__ import annotations

import numpy as np

from ...fields import babybear as bb
from ..air import Air, ConstraintBuilder


class FibAir(Air):
    width = 2

    def eval(self, b: ConstraintBuilder) -> None:
        a0 = b.local(0)
        b0 = b.local(1)
        a1 = b.next(0)
        b1 = b.next(1)
        b.transition(b.sub(a1, b0))
        b.transition(b.sub(b1, b.add(a0, b0)))
        b.first_row(b.sub(a0, b.public(0)))
        b.first_row(b.sub(b0, b.public(1)))
        b.last_row(b.sub(b0, b.public(2)))

    @staticmethod
    def trace(log_n: int, a: int = 1, b: int = 1):
        n = 1 << log_n
        rows = np.zeros((n, 2), dtype=np.uint32)
        x, y = a % bb.P, b % bb.P
        for i in range(n):
            rows[i] = (x, y)
            x, y = y, (x + y) % bb.P
        publics = [a % bb.P, b % bb.P, int(rows[n - 1, 1])]
        return rows, publics
