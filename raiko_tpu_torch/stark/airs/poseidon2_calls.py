"""Poseidon2 call-table AIR: batch-proves independent permutations for
the recursion circuit (stark/circuit.py), one permutation per row with
all 21 rounds unrolled across columns.

Trace row (705 columns): raw input x[16] | half-swapped input xs[16] |
swap bit | per round r: sbox helpers t_r[16] (= u^3), s_r[16] (= t^2 u)
with u = state + rc.  Round *states* are never stored: each round's input
is a linear expression of the previous round's stored s (external linear
layer) or the nested internal-linear chain — the expression DAG stays
degree 1, so the t/s helper constraints are degree 3.

The in-row half swap (xs_i = x_i + swap*(x_{i xor 8} - x_i)) lets one
call express a Merkle 2-to-1 compression in EITHER child order, with the
order bit delivered over the wire bus — the circuit pays zero gates per
Merkle level (see stark/recursion.py).

Wire bus (channel 0, same gamma/delta as the gate table): per row,
receives each enabled input lane (m_in_i) with base-lane fingerprint
id + delta*x_i, receives the swap bit (m_swap), and sends each output
lane with multiplicity = fan-out.  Disabled input lanes are free
witnesses of this table (Merkle siblings that nothing else consumes).

Reference analog: the Poseidon2 circuits inside the vendored risc0
recursion prover (SURVEY.md §2.2 "risc0-zkvm prover core").

Port of raiko_tpu/stark/airs/poseidon2_calls.py, copied whole: host work
with no device code.
"""

from __future__ import annotations

import functools

import numpy as np

from ...fields import babybear as bb
from ...fields import babybear_ext as ef
from ...ops import poseidon2 as p2
from ..air import Air, ConstraintBuilder
from .poseidon2_air import _ext_linear_expr, _int_linear_expr

WIDTH16 = 16
N_ROUNDS = 21

# trace columns
COL_X = 0
COL_XS = 16
COL_SWAP = 32
COL_R0 = 33  # round r: t at COL_R0+32r, s at COL_R0+32r+16
TRACE_WIDTH = COL_R0 + 32 * N_ROUNDS  # 705

# fixed columns
F_IN_ID = 0
F_M_IN = 16
F_OUT_ID = 32
F_OUT_MULT = 48
F_SWAP_ID = 64
F_M_SWAP = 65
N_FIXED = 66

# aux columns
AUX_TIN = 0
AUX_TSWAP = 64
AUX_TOUT = 68
AUX_ACC = 132
AUX_WIDTH = 136

_MIN_ROWS = 8  # keeps the FRI base domain at >= FINAL_SIZE


@functools.lru_cache(maxsize=1)
def _int_matrix() -> tuple:
    """(16, 17) integer matrix computing host_int_linear([s0]+x[1:]) from
    the stacked block [s0; x0..x15] (x0 unused, column 1 zero)."""
    _, _, mu = p2.host_constants()
    mat = [[0] * 17 for _ in range(16)]
    for i in range(16):
        mat[i][0] = 1 + (mu[0] if i == 0 else 0)
        for j in range(1, 16):
            mat[i][1 + j] = (1 + (mu[i] if i == j else 0)) % bb.P
    return tuple(tuple(r) for r in mat)


@functools.lru_cache(maxsize=1)
def _ext_matrix() -> np.ndarray:
    """M_E as a dense (16, 16) matrix (columns = images of unit vectors)."""
    m = np.zeros((16, 16), dtype=np.uint64)
    for j in range(16):
        unit = [0] * 16
        unit[j] = 1
        m[:, j] = p2.host_ext_linear(unit)
    return m


def _wide_row(x16: list[int], swap: int) -> tuple[np.ndarray, list[int]]:
    """Trace row for one call: (705,) uint32 and the 16 output lanes."""
    row = np.zeros(TRACE_WIDTH, dtype=np.uint32)
    row[COL_X : COL_X + 16] = x16
    xs = x16[8:] + x16[:8] if swap else list(x16)
    row[COL_XS : COL_XS + 16] = xs
    row[COL_SWAP] = swap
    _, _, mu = p2.host_constants()
    state = p2.host_ext_linear(xs)
    for r, (kind, rc) in enumerate(p2.host_round_sequence()):
        u = [(state[c] + rc[c]) % bb.P for c in range(16)]
        t = [pow(v, 3, bb.P) for v in u]
        s = [t[c] * t[c] % bb.P * u[c] % bb.P for c in range(16)]
        base = COL_R0 + 32 * r
        row[base : base + 16] = t
        row[base + 16 : base + 32] = s
        if kind == "ext":
            state = p2.host_ext_linear(s)
        else:
            state = p2.host_int_linear([s[0]] + state[1:], mu)
    return row, state


def _pad_pow2(k: int) -> int:
    n = max(_MIN_ROWS, k)
    return 1 << (n - 1).bit_length()


def calls_fixed_columns(calls: list[dict], uses: dict[int, int]):
    n = _pad_pow2(len(calls))
    fx = np.zeros((N_FIXED, n), dtype=np.uint32)
    for r, call in enumerate(calls):
        for i, w in enumerate(call["in"]):
            if w is not None:
                fx[F_IN_ID + i, r] = w.wid
                fx[F_M_IN + i, r] = 1
        for i, w in enumerate(call["out"]):
            fx[F_OUT_ID + i, r] = w.wid
            fx[F_OUT_MULT + i, r] = uses.get(w.wid, 0)
        if call["swap"] is not None:
            fx[F_SWAP_ID, r] = call["swap"].wid
            fx[F_M_SWAP, r] = 1
    return fx, n


def calls_trace(calls: list[dict], n: int) -> np.ndarray:
    tr = np.zeros((n, TRACE_WIDTH), dtype=np.uint32)
    dummy, _ = _wide_row([0] * 16, 0)
    for r in range(n):
        if r >= len(calls):
            tr[r] = dummy
            continue
        call = calls[r]
        lanes = []
        for w, fv in zip(call["in"], call["free"]):
            lanes.append(w.val[0] if w is not None else fv)
        swap = call["swap"].val[0] if call["swap"] is not None else 0
        row, out = _wide_row(lanes, swap)
        tr[r] = row
        assert [w.val[0] for w in call["out"]] == out
    return tr


class Poseidon2CallsAir(Air):
    width = TRACE_WIDTH
    aux_width = AUX_WIDTH
    num_aux_challenges = 2  # shared with CircuitAir: gamma, delta
    num_bus_values = 1
    quotient_chunks = 2

    def __init__(self, fixed: np.ndarray):
        assert fixed.shape[0] == N_FIXED
        self._fixed = fixed
        _, _, mu = p2.host_constants()
        self._mu = mu

    def fixed_columns(self, n: int):
        assert n == self._fixed.shape[1], (n, self._fixed.shape)
        return self._fixed

    def eval(self, b: ConstraintBuilder) -> None:
        """Block-vectorized: every 16-lane group is ONE stacked constraint
        and every linear layer ONE integer matmul (algebra fast path), so
        the compiled quotient graph stays small."""
        X = b.local_block(range(COL_X, COL_X + 16))
        XS = b.local_block(range(COL_XS, COL_XS + 16))
        XSWP = b.local_block([COL_X + (i ^ 8) for i in range(16)])
        swap = b.local(COL_SWAP)
        m_swap = b.fixed(F_M_SWAP)
        # half swap + gating of an unsourced swap bit
        sel = b.add(X, b.mul(swap, b.sub(XSWP, X)))
        b.all_rows_block(b.stack_block(b.sub(XS, sel)), 16)
        b.all_rows(b.mul(b.sub(b.constant(1), m_swap), swap))

        ext_mat = tuple(tuple(int(v) for v in row) for row in _ext_matrix())
        state = b.linmap(ext_mat, XS)
        for r, (kind, rc) in enumerate(p2.host_round_sequence()):
            base = COL_R0 + 32 * r
            T = b.local_block(range(base, base + 16))
            S = b.local_block(range(base + 16, base + 32))
            u = b.add(state, b.const_vec(rc))
            tcon = b.sub(T, b.mul(u, b.mul(u, u)))
            scon = b.sub(S, b.mul(T, b.mul(T, u)))
            b.all_rows_block(b.stack_block(tcon), 16)
            b.all_rows_block(b.stack_block(scon), 16)
            if kind == "ext":
                state = b.linmap(ext_mat, S)
            else:
                state = b.linmap(_int_matrix(), b.concat_rows([S[0:1], state]))
        out = state  # degree-1 block: the 16 output lanes

        # -- wire bus ------------------------------------------------------
        gam = b.challenge_ef(0)
        dl = b.challenge_ef(1)

        def fp_block(ids, V):
            # base-lane fingerprints id + delta * v, per EF coordinate
            return [
                b.add(ids, b.mul(dl[0], V)) if c == 0 else b.mul(dl[c], V)
                for c in range(4)
            ]

        def helper_block(aux0, ids, V, mults, k):
            if k == 1:
                T = [b.aux(aux0 + c) for c in range(4)]
            else:
                T = [
                    b.aux_block([aux0 + 4 * i + c for i in range(k)])
                    for c in range(4)
                ]
            prod = b.ef_mul4(T, b.ef_sub4(gam, fp_block(ids, V)))
            for c in range(4):
                e = b.sub(prod[c], mults) if c == 0 else prod[c]
                if k == 1:
                    b.all_rows(e)
                else:
                    b.all_rows_block(b.stack_block(e), k)

        in_ids = b.fixed_block(range(F_IN_ID, F_IN_ID + 16))
        m_in = b.fixed_block(range(F_M_IN, F_M_IN + 16))
        out_ids = b.fixed_block(range(F_OUT_ID, F_OUT_ID + 16))
        out_mults = b.fixed_block(range(F_OUT_MULT, F_OUT_MULT + 16))
        helper_block(AUX_TIN, in_ids, X, m_in, 16)
        helper_block(AUX_TSWAP, b.fixed(F_SWAP_ID), swap, m_swap, 1)
        helper_block(AUX_TOUT, out_ids, out, out_mults, 16)

        def term(row_fn, block_fn):
            coords = []
            for c in range(4):
                tout = b.block_rowsum(
                    block_fn([AUX_TOUT + 4 * i + c for i in range(16)])
                )
                tin = b.block_rowsum(
                    block_fn([AUX_TIN + 4 * i + c for i in range(16)])
                )
                coords.append(
                    b.sub(b.sub(tout, tin), row_fn(AUX_TSWAP + c))
                )
            return coords

        acc = [b.aux(AUX_ACC + c) for c in range(4)]
        acc_n = [b.aux_next(AUX_ACC + c) for c in range(4)]
        for e in b.ef_sub4(acc, term(b.aux, b.aux_block)):
            b.first_row(e)
        for e in b.ef_sub4(
            b.ef_sub4(acc_n, acc), term(b.aux_next, b.aux_next_block)
        ):
            b.transition(e)
        for e in b.ef_sub4(acc, b.bus_ef(0)):
            b.last_row(e)

    # -- aux trace ---------------------------------------------------------
    def _lane_terms(self, gam4, dl4, ids, vals, mults):
        """t = mult / (gamma - (id + delta*v)) vectorized; all (n,) inputs."""
        pu = np.uint64(bb.P)
        f = (dl4[None, :] * vals[:, None]) % pu
        f[:, 0] = (f[:, 0] + ids) % pu
        t = ef.npef_inv(ef.npef_sub(gam4[None, :], f))
        return (t * mults[:, None]) % pu

    def _terms(self, trace: np.ndarray, challenges: list[tuple]):
        gam, dl = challenges
        gam4 = np.array(gam, dtype=np.uint64)
        dl4 = np.array(dl, dtype=np.uint64)
        fx = self._fixed.astype(np.uint64)
        tr = trace.astype(np.uint64)
        n = trace.shape[0]
        outs = (tr[:, COL_R0 + 32 * 20 + 16 : COL_R0 + 32 * 20 + 32] @ _ext_matrix().T) % np.uint64(bb.P)
        t_in = [
            self._lane_terms(gam4, dl4, fx[F_IN_ID + i], tr[:, COL_X + i], fx[F_M_IN + i])
            for i in range(16)
        ]
        t_swap = self._lane_terms(
            gam4, dl4, fx[F_SWAP_ID], tr[:, COL_SWAP], fx[F_M_SWAP]
        )
        t_out = [
            self._lane_terms(gam4, dl4, fx[F_OUT_ID + i], outs[:, i], fx[F_OUT_MULT + i])
            for i in range(16)
        ]
        return t_in, t_swap, t_out

    def aux_trace(self, trace: np.ndarray, challenges: list[tuple]) -> np.ndarray:
        t_in, t_swap, t_out = self._terms(trace, challenges)
        pu = np.uint64(bb.P)
        term = np.zeros_like(t_swap)
        for t in t_out:
            term = (term + t) % pu
        for t in t_in:
            term = (term + pu - t) % pu
        term = (term + pu - t_swap) % pu
        acc = np.cumsum(term, axis=0, dtype=np.uint64) % pu
        aux = np.concatenate(t_in + [t_swap] + t_out + [acc], axis=1)
        return aux.astype(np.uint32)

    def bus_values(self, trace: np.ndarray, challenges: list[tuple]) -> list[tuple]:
        t_in, t_swap, t_out = self._terms(trace, challenges)
        pu = np.uint64(bb.P)
        total = np.zeros(4, dtype=np.uint64)
        for t in t_out:
            total = (total + t.sum(axis=0)) % pu
        for t in t_in:
            total = (total + pu - (t.sum(axis=0) % pu)) % pu
        total = (total + pu - (t_swap.sum(axis=0) % pu)) % pu
        return [tuple(int(v) for v in total)]
