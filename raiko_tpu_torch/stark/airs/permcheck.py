"""Multiset-equality AIR — the canonical auxiliary-segment argument.

Statement: column B is a permutation of column A.  After the main trace
(A, B) is committed, the transcript yields a random EF challenge gamma;
the prover commits running grand products

    accA_i = prod_{j<=i} (gamma - A_j),   accB_i = prod_{j<=i} (gamma - B_j)

as 4-column EF accumulators in the auxiliary segment and the constraints
force accA_last == accB_last.  Equality of the two degree-n polynomials
prod(X - A_j) and prod(X - B_j) at a random EF point implies multiset
equality except with probability n / |EF| ~ 2^-114.

This is the machinery (not the final statement) for the execution-proof
roadmap: LogUp lookups and RAM/permutation arguments against the keccak
and EVM trace AIRs all reduce to challenge-dependent committed
accumulators exactly like this one (reference analog: the permutation
arguments inside the vendored risc0/sp1 provers, SURVEY.md §2.2).
"""

from __future__ import annotations

import numpy as np

from ...fields import babybear as bb
from ...fields import babybear_ext as ef
from ..air import Air, ConstraintBuilder

COL_A = 0
COL_B = 1
ACC_A = 0  # aux cols 0..3
ACC_B = 4  # aux cols 4..7


class PermutationAir(Air):
    width = 2
    aux_width = 8
    num_aux_challenges = 1
    quotient_chunks = 2  # degree-2 accumulator transitions

    @staticmethod
    def make_trace(a_vals: list[int], b_vals: list[int]) -> np.ndarray:
        assert len(a_vals) == len(b_vals)
        n = len(a_vals)
        assert n & (n - 1) == 0
        t = np.zeros((n, 2), dtype=np.uint32)
        t[:, COL_A] = np.array(a_vals, dtype=np.uint32) % bb.P
        t[:, COL_B] = np.array(b_vals, dtype=np.uint32) % bb.P
        return t

    def aux_trace(self, trace: np.ndarray, challenges: list[tuple]) -> np.ndarray:
        (gamma,) = challenges
        n = trace.shape[0]
        aux = np.zeros((n, self.aux_width), dtype=np.uint32)
        acc_a = acc_b = ef.H_ONE
        for i in range(n):
            acc_a = ef.h_mul(acc_a, ef.h_sub(gamma, ef.h_from_base(int(trace[i, COL_A]))))
            acc_b = ef.h_mul(acc_b, ef.h_sub(gamma, ef.h_from_base(int(trace[i, COL_B]))))
            aux[i, ACC_A : ACC_A + 4] = acc_a
            aux[i, ACC_B : ACC_B + 4] = acc_b
        return aux

    def eval(self, b: ConstraintBuilder) -> None:
        gamma = b.challenge_ef(0)
        for col, acc0 in ((COL_A, ACC_A), (COL_B, ACC_B)):
            acc = [b.aux(acc0 + c) for c in range(4)]
            acc_n = [b.aux_next(acc0 + c) for c in range(4)]
            term0 = b.ef_sub4(gamma, b.ef_from_base4(b.local(col)))
            term_n = b.ef_sub4(gamma, b.ef_from_base4(b.next(col)))
            # acc_0 = gamma - v_0
            for e in b.ef_sub4(acc, term0):
                b.first_row(e)
            # acc' = acc * (gamma - v')
            for e in b.ef_sub4(acc_n, b.ef_mul4(acc, term_n)):
                b.transition(e)
        # grand products agree on the last row
        accA = [b.aux(ACC_A + c) for c in range(4)]
        accB = [b.aux(ACC_B + c) for c in range(4)]
        for e in b.ef_sub4(accA, accB):
            b.last_row(e)
