"""Gate-table AIR: proves satisfaction of a CircuitBuilder gate list.

One row per gate.  Trace: the three EF4 ports a, b, out (12 base columns).
Fixed columns (the circuit structure = the statement): gate selectors,
port enables, wire ids, output multiplicity, and the EF constants coef /
cadd.  Gate equations (combined into 4 per-coordinate all_rows
constraints, max degree 3):

    LIN:    out = m_a*a + coef (x) b + cadd     (covers add/sub/axpy/const)
    MUL:    out = a (x) b                       (EF tower product)
    ASSERT: m_a*a - coef (x) b - cadd = 0       (no output)
    BIT:    out0^2 = out0, out1..3 = 0          (boolean witness)
    (no selector set: free witness INPUT gate / padding)

Wire bus (LogUp, shared challenge gamma = chal0, fingerprint challenge
delta = chal1, bus channel 0): each row *receives* ports a and b (enabled
by m_a/m_b) and *sends* its output with multiplicity = fan-out, terms

    t_port * (gamma - f_port) = m_port,   f = id + sum_k delta^{k+1} v_k

accumulated by one running-sum aux column; the table's net contribution
is bound to bus value 0 and cancels against the Poseidon2 call table's
(stark/airs/poseidon2_calls.py) in verify_tables' global balance.

Reference analog: the "interactions" wiring of the vendored sp1/plonky3
recursion circuits (SURVEY.md §2.2).

Port of raiko_tpu/stark/airs/circuit_air.py, copied whole: host work
with no device code.
"""

from __future__ import annotations

import numpy as np

from ...fields import babybear as bb
from ...fields import babybear_ext as ef
from ..air import Air, ConstraintBuilder
from ..circuit import SEL_ASSERT, SEL_BIT, SEL_INPUT, SEL_LIN, SEL_MUL

# trace columns
COL_A = 0
COL_B = 4
COL_O = 8
WIDTH = 12

# fixed columns
F_SEL_LIN = 0
F_SEL_MUL = 1
F_SEL_ASSERT = 2
F_SEL_BIT = 3
F_M_A = 4
F_M_B = 5
F_IDA = 6
F_IDB = 7
F_IDO = 8
F_MULT = 9
F_COEF = 10
F_CADD = 14
N_FIXED = 18

# aux columns
AUX_TA = 0
AUX_TB = 4
AUX_TO = 8
AUX_ACC = 12
AUX_WIDTH = 16

_MIN_ROWS = 8  # keeps the FRI base domain at >= FINAL_SIZE


def _pad_pow2(k: int) -> int:
    n = max(_MIN_ROWS, k)
    return 1 << (n - 1).bit_length()


def gate_fixed_columns(gates: list[dict], uses: dict[int, int]):
    n = _pad_pow2(len(gates))
    fx = np.zeros((N_FIXED, n), dtype=np.uint32)
    for r, g in enumerate(gates):
        sel = g["sel"]
        if sel == SEL_LIN:
            fx[F_SEL_LIN, r] = 1
        elif sel == SEL_MUL:
            fx[F_SEL_MUL, r] = 1
        elif sel == SEL_ASSERT:
            fx[F_SEL_ASSERT, r] = 1
        elif sel == SEL_BIT:
            fx[F_SEL_BIT, r] = 1
        else:
            assert sel == SEL_INPUT
        fx[F_M_A, r] = 1 if g["a"] else 0
        fx[F_M_B, r] = 1 if g["b"] else 0
        fx[F_IDA, r] = g["a"]
        fx[F_IDB, r] = g["b"]
        fx[F_IDO, r] = g["o"]
        fx[F_MULT, r] = uses.get(g["o"], 0) if g["o"] else 0
        for c in range(4):
            fx[F_COEF + c, r] = g["coef"][c]
            fx[F_CADD + c, r] = g["cadd"][c]
    return fx, n


def gate_trace(gates: list[dict], n: int) -> np.ndarray:
    tr = np.zeros((n, WIDTH), dtype=np.uint32)
    for r, g in enumerate(gates):
        for c in range(4):
            if g["aw"] is not None:
                tr[r, COL_A + c] = g["aw"].val[c]
            if g["bw"] is not None:
                tr[r, COL_B + c] = g["bw"].val[c]
            if g["ow"] is not None:
                tr[r, COL_O + c] = g["ow"].val[c]
    return tr


class CircuitAir(Air):
    width = WIDTH
    aux_width = AUX_WIDTH
    num_aux_challenges = 2  # gamma (bus), delta (fingerprint)
    num_bus_values = 1
    quotient_chunks = 2

    def __init__(self, fixed: np.ndarray):
        assert fixed.shape[0] == N_FIXED
        self._fixed = fixed

    def fixed_columns(self, n: int):
        assert n == self._fixed.shape[1], (n, self._fixed.shape)
        return self._fixed

    # -- constraints ------------------------------------------------------
    def eval(self, b: ConstraintBuilder) -> None:
        gam = b.challenge_ef(0)
        dl = b.challenge_ef(1)
        dpow = [dl]
        for _ in range(3):
            dpow.append(b.ef_mul4(dpow[-1], dl))  # delta^1..delta^4
        a = [b.local(COL_A + c) for c in range(4)]
        bv = [b.local(COL_B + c) for c in range(4)]
        o = [b.local(COL_O + c) for c in range(4)]
        sel_lin = b.fixed(F_SEL_LIN)
        sel_mul = b.fixed(F_SEL_MUL)
        sel_ass = b.fixed(F_SEL_ASSERT)
        sel_bit = b.fixed(F_SEL_BIT)
        m_a = b.fixed(F_M_A)
        m_b = b.fixed(F_M_B)
        coef = [b.fixed(F_COEF + c) for c in range(4)]
        cadd = [b.fixed(F_CADD + c) for c in range(4)]

        ma_a = [b.mul(m_a, a[c]) for c in range(4)]
        coef_b = b.ef_mul4(coef, bv)  # degree 2
        lin_rhs = b.ef_add4(b.ef_add4(ma_a, coef_b), cadd)
        mul_rhs = b.ef_mul4(a, bv)  # degree 2
        for c in range(4):
            lin_c = b.sub(o[c], lin_rhs[c])
            mul_c = b.sub(o[c], mul_rhs[c])
            ass_c = b.sub(b.sub(ma_a[c], coef_b[c]), cadd[c])
            if c == 0:
                bit_c = b.sub(b.mul(o[0], o[0]), o[0])
            else:
                bit_c = o[c]
            b.all_rows(
                b.add(
                    b.add(b.mul(sel_lin, lin_c), b.mul(sel_mul, mul_c)),
                    b.add(b.mul(sel_ass, ass_c), b.mul(sel_bit, bit_c)),
                )
            )

        # -- wire-bus LogUp helpers --------------------------------------
        def fingerprint(id_col, vec):
            f = b.ef_from_base4(id_col)
            for k in range(4):
                f = b.ef_add4(f, [b.mul(dpow[k][c], vec[k]) for c in range(4)])
            return f

        ports = [
            (AUX_TA, b.fixed(F_IDA), a, m_a),
            (AUX_TB, b.fixed(F_IDB), bv, m_b),
            (AUX_TO, b.fixed(F_IDO), o, b.fixed(F_MULT)),
        ]
        for aux0, id_col, vec, mult in ports:
            t = [b.aux(aux0 + c) for c in range(4)]
            prod = b.ef_mul4(t, b.ef_sub4(gam, fingerprint(id_col, vec)))
            rhs = b.ef_from_base4(mult)
            for c in range(4):
                b.all_rows(b.sub(prod[c], rhs[c]))

        def term(acc_fn):
            to = [acc_fn(AUX_TO + c) for c in range(4)]
            ta = [acc_fn(AUX_TA + c) for c in range(4)]
            tb = [acc_fn(AUX_TB + c) for c in range(4)]
            return b.ef_sub4(b.ef_sub4(to, ta), tb)

        acc = [b.aux(AUX_ACC + c) for c in range(4)]
        acc_n = [b.aux_next(AUX_ACC + c) for c in range(4)]
        for e in b.ef_sub4(acc, term(b.aux)):
            b.first_row(e)
        for e in b.ef_sub4(b.ef_sub4(acc_n, acc), term(b.aux_next)):
            b.transition(e)
        for e in b.ef_sub4(acc, b.bus_ef(0)):
            b.last_row(e)

    # -- aux trace (vectorized host EF math) ------------------------------
    def _port_terms(self, trace: np.ndarray, gam4, dpows, id_col, col0, m):
        """t = m / (gamma - f) per row; vec = trace[:, col0:col0+4]."""
        vec = trace[:, col0 : col0 + 4].astype(np.uint64)
        f = ef.npef_from_base(self._fixed[id_col].astype(np.uint64))
        for k in range(4):
            f = ef.npef_add(f, (dpows[k][None, :] * vec[:, k, None]) % np.uint64(bb.P))
        t = ef.npef_inv(ef.npef_sub(gam4[None, :], f))
        return (t * m[:, None]) % np.uint64(bb.P)

    def _terms(self, trace: np.ndarray, challenges: list[tuple]) -> np.ndarray:
        gam, dl = challenges
        gam4 = np.array(gam, dtype=np.uint64)
        dl4 = np.array(dl, dtype=np.uint64)[None, :]
        dpows = [dl4[0]]
        for _ in range(3):
            dpows.append(ef.npef_mul(dpows[-1], dl4[0]))
        fx = self._fixed.astype(np.uint64)
        t_a = self._port_terms(trace, gam4, dpows, F_IDA, COL_A, fx[F_M_A])
        t_b = self._port_terms(trace, gam4, dpows, F_IDB, COL_B, fx[F_M_B])
        t_o = self._port_terms(trace, gam4, dpows, F_IDO, COL_O, fx[F_MULT])
        return t_a, t_b, t_o

    def aux_trace(self, trace: np.ndarray, challenges: list[tuple]) -> np.ndarray:
        t_a, t_b, t_o = self._terms(trace, challenges)
        term = ef.npef_sub(ef.npef_sub(t_o, t_a), t_b)
        acc = np.cumsum(term, axis=0, dtype=np.uint64) % np.uint64(bb.P)
        aux = np.concatenate([t_a, t_b, t_o, acc], axis=1)
        return aux.astype(np.uint32)

    def bus_values(self, trace: np.ndarray, challenges: list[tuple]) -> list[tuple]:
        t_a, t_b, t_o = self._terms(trace, challenges)
        term = ef.npef_sub(ef.npef_sub(t_o, t_a), t_b)
        total = term.sum(axis=0) % np.uint64(bb.P)
        return [tuple(int(v) for v in total)]
