"""LogUp (log-derivative) lookup AIR — the second aux-segment argument.

Statement: every value in column C appears in the table column T, where
the witness multiplicity column M says how often each table row is used:

    sum_i 1/(gamma - C_i)  ==  sum_j M_j / (gamma - T_j)

for a transcript challenge gamma (Haböck's LogUp identity: two rational
functions of gamma agree at a random point iff the lookups are covered,
up to ~(2n)/|EF| soundness error).

The auxiliary segment carries the EF running sum

    acc_i = sum_{k<=i} [ 1/(gamma - C_k) - M_k/(gamma - T_k) ]

and the constraints clear denominators (degree 3):

    first row:   acc*(g-C)*(g-T) - [(g-T) - M*(g-C)] = 0
    transition:  (acc' - acc)*(g-C')*(g-T') - [(g-T') - M'*(g-C')] = 0
    last row:    acc = 0

This is the building block for in-AIR containment of the keccak-MPT
statement (child digests looked up inside parent preimages) and for
range checks in the EVM trace AIRs (reference analog: the lookup
arguments inside the vendored risc0/sp1 provers, SURVEY.md §2.2).

Port of raiko_tpu/stark/airs/lookup.py, copied whole: host work with no
device code.
"""

from __future__ import annotations

import numpy as np

from ...fields import babybear as bb
from ...fields import babybear_ext as ef
from ..air import Air, ConstraintBuilder

COL_C = 0  # looked-up values
COL_T = 1  # table values
COL_M = 2  # multiplicities (witness)


class LookupAir(Air):
    width = 3
    aux_width = 4  # one EF running sum
    num_aux_challenges = 1
    # degree-3 first-row constraint divides only (x - 1): quotient degree
    # reaches ~3n, so 4 chunks (2 would only capture < 2n)
    quotient_chunks = 4

    @staticmethod
    def make_trace(
        looked: list[int], table: list[int], mult: list[int] | None = None
    ) -> np.ndarray:
        """mult defaults to the true multiset count of each table row."""
        n = len(looked)
        assert len(table) == n and n & (n - 1) == 0
        if mult is None:
            from collections import Counter

            counts = Counter(looked)
            mult = []
            seen: dict[int, int] = {}
            for t in table:
                # distribute count over duplicate table rows: first row of a
                # value takes the whole count
                if t in seen:
                    mult.append(0)
                else:
                    seen[t] = 1
                    mult.append(counts.get(t, 0))
        t = np.zeros((n, 3), dtype=np.uint32)
        t[:, COL_C] = np.array(looked, dtype=np.uint64) % bb.P
        t[:, COL_T] = np.array(table, dtype=np.uint64) % bb.P
        t[:, COL_M] = np.array(mult, dtype=np.uint64) % bb.P
        return t

    def aux_trace(self, trace: np.ndarray, challenges: list[tuple]) -> np.ndarray:
        (gamma,) = challenges
        n = trace.shape[0]
        denoms = []
        for i in range(n):
            denoms.append(ef.h_sub(gamma, ef.h_from_base(int(trace[i, COL_C]))))
            denoms.append(ef.h_sub(gamma, ef.h_from_base(int(trace[i, COL_T]))))
        invs = ef.h_batch_inv(denoms)
        aux = np.zeros((n, 4), dtype=np.uint32)
        acc = ef.H_ZERO
        for i in range(n):
            m = ef.h_from_base(int(trace[i, COL_M]))
            acc = ef.h_add(acc, ef.h_sub(invs[2 * i], ef.h_mul(m, invs[2 * i + 1])))
            aux[i] = acc
        return aux

    def eval(self, b: ConstraintBuilder) -> None:
        gamma = b.challenge_ef(0)
        acc = [b.aux(c) for c in range(4)]
        acc_n = [b.aux_next(c) for c in range(4)]

        def row_terms(val_c, val_t, val_m):
            """(g-C)(g-T) and (g-T) - M*(g-C) for one row's values."""
            gc = b.ef_sub4(gamma, b.ef_from_base4(val_c))
            gt = b.ef_sub4(gamma, b.ef_from_base4(val_t))
            prod = b.ef_mul4(gc, gt)
            rhs = b.ef_sub4(gt, b.ef_mul4(b.ef_from_base4(val_m), gc))
            return prod, rhs

        # first row: acc * (g-C)(g-T) = (g-T) - M(g-C)
        prod0, rhs0 = row_terms(b.local(COL_C), b.local(COL_T), b.local(COL_M))
        for e in b.ef_sub4(b.ef_mul4(acc, prod0), rhs0):
            b.first_row(e)
        # transition: (acc' - acc) * (g-C')(g-T') = (g-T') - M'(g-C')
        prod_n, rhs_n = row_terms(b.next(COL_C), b.next(COL_T), b.next(COL_M))
        for e in b.ef_sub4(b.ef_mul4(b.ef_sub4(acc_n, acc), prod_n), rhs_n):
            b.transition(e)
        # last row: the signed sums cancel
        for e in acc:
            b.last_row(e)
