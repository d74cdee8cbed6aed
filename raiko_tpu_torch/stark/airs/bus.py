"""Global LogUp-bus table AIR — cross-table lookups.

A `BusTableAir` contributes  direction * sum_i M_i / (gamma - V_i)  to the
shared bus (V = value column, M = multiplicity column, gamma = the shared
transcript challenge).  A "send" table (+1) publishes values; a "receive"
table (-1) consumes them; prover.prove_tables / verifier.verify_tables
enforce that all tables' contributions cancel — i.e. every received
(value, multiplicity) multiset is exactly what was sent, across tables
of DIFFERENT sizes in one proof.

This is the cross-table wiring ("interactions" in the vendored
sp1/plonky3 provers, SURVEY.md §2.2) that the succinct keccak-MPT
statement and EVM trace tables compose over: e.g. a byte-window table
sends (position, byte) codes, the digest table receives child-digest
codes.

Constraints (degree 2):
    first row:   acc*(g - V) = dir*M
    transition:  (acc' - acc)*(g - V') = dir*M'
    last row:    acc = bus_value_0

Port of raiko_tpu/stark/airs/bus.py, copied whole: host work with no
device code.
"""

from __future__ import annotations

import numpy as np

from ...fields import babybear as bb
from ...fields import babybear_ext as ef
from ..air import Air, ConstraintBuilder

COL_V = 0
COL_M = 1


class BusTableAir(Air):
    width = 2
    aux_width = 4  # one EF running sum
    num_aux_challenges = 1
    num_bus_values = 1
    quotient_chunks = 2

    def __init__(self, direction: int):
        assert direction in (1, -1)
        self.direction = direction

    def structure_key(self) -> tuple:
        return (self.direction,)  # baked into eval()'s dir constant

    @staticmethod
    def make_trace(values: list[int], mults: list[int]) -> np.ndarray:
        n = len(values)
        assert len(mults) == n and n & (n - 1) == 0
        t = np.zeros((n, 2), dtype=np.uint32)
        t[:, COL_V] = np.array(values, dtype=np.uint64) % bb.P
        t[:, COL_M] = np.array(mults, dtype=np.uint64) % bb.P
        return t

    def _terms(self, trace: np.ndarray, gamma: tuple) -> list[tuple]:
        n = trace.shape[0]
        invs = ef.h_batch_inv(
            [ef.h_sub(gamma, ef.h_from_base(int(trace[i, COL_V]))) for i in range(n)]
        )
        sign = 1 if self.direction == 1 else bb.P - 1
        return [
            ef.h_mul(ef.h_from_base(int(trace[i, COL_M]) * sign % bb.P), invs[i])
            for i in range(n)
        ]

    def aux_trace(self, trace: np.ndarray, challenges: list[tuple]) -> np.ndarray:
        (gamma,) = challenges
        terms = self._terms(trace, gamma)
        aux = np.zeros((trace.shape[0], 4), dtype=np.uint32)
        acc = ef.H_ZERO
        for i, t in enumerate(terms):
            acc = ef.h_add(acc, t)
            aux[i] = acc
        return aux

    def bus_values(self, trace: np.ndarray, challenges: list[tuple]) -> list[tuple]:
        (gamma,) = challenges
        acc = ef.H_ZERO
        for t in self._terms(trace, gamma):
            acc = ef.h_add(acc, t)
        return [acc]

    def eval(self, b: ConstraintBuilder) -> None:
        gamma = b.challenge_ef(0)
        acc = [b.aux(c) for c in range(4)]
        acc_n = [b.aux_next(c) for c in range(4)]
        dirc = b.constant(1 if self.direction == 1 else bb.P - 1)

        def row(v, m):
            gv = b.ef_sub4(gamma, b.ef_from_base4(v))
            rhs = b.ef_from_base4(b.mul(dirc, m))
            return gv, rhs

        gv0, rhs0 = row(b.local(COL_V), b.local(COL_M))
        for e in b.ef_sub4(b.ef_mul4(acc, gv0), rhs0):
            b.first_row(e)
        gvn, rhsn = row(b.next(COL_V), b.next(COL_M))
        for e in b.ef_sub4(b.ef_mul4(b.ef_sub4(acc_n, acc), gvn), rhsn):
            b.transition(e)
        for e in b.ef_sub4(acc, b.bus_ef(0)):
            b.last_row(e)
