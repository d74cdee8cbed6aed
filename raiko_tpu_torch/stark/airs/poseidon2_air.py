"""Poseidon2 sponge-transcript AIR.

Proves: "the Poseidon2 sponge (width 16, rate 8) absorbing the public
message blocks produces the public digest" — the flagship AIR of the
tpu_stark backend, binding a block's instance hash into a STARK
(provers/tpu_stark.py; the role hashing AIRs play inside the reference's
vendored zkVM provers).

Layout (32 rows per permutation, trace n = 32 * num_perms):
  rows 0..20   round inputs (rounds: 4 ext, 13 int, 4 ext)
  rows 21..30  copy rows (pad the permutation to a power-of-two stride)
  row  31      permutation output; transition to the next permutation's
               row 0 absorbs the next message block through M_E

Columns: 16 state + 16 cube helpers (t = u^3) + 16 seventh-power helpers
(s = t^2 * u), with u = state + rc.  Helper constraints are degree 3 and
the selector-guarded transition is degree 2, inside the framework budget.

Fixed (public, uncommitted) columns: 16 round constants, 4 selectors, 8
message lanes.  Public values: row-0 state (16) and the digest (8).
"""

from __future__ import annotations

import numpy as np

from ...fields import babybear as bb
from ...ops import poseidon2 as p2
from ...ops import poseidon2_host as p2h
from ..air import Air, ConstraintBuilder

ROWS_PER_PERM = 32
N_ROUNDS = 21
WIDTH = 16
RATE = 8
TRACE_WIDTH = 48  # x[16] | t[16] | s[16]
N_FIXED = 28  # rc[16] | sel_ext | sel_int | sel_copy | sel_absorb | msg[8]

COL_X = 0
COL_T = 16
COL_S = 32
F_RC = 0
F_EXT = 16
F_INT = 17
F_COPY = 18
F_ABSORB = 19
F_MSG = 20


class Poseidon2TranscriptAir(Air):
    width = TRACE_WIDTH

    def __init__(
        self,
        blocks: list[list[int]],
        initial_state: list[int] | None = None,
        expose_full_state: bool = False,
    ):
        """blocks: message blocks of RATE field elements each; count must
        be a power of two (pad with zero blocks).

        ``initial_state``/``expose_full_state`` support shard-parallel
        proving (provers/tpu_shard.py): a shard starts from the sponge
        state left by its predecessor and exposes its full 16-lane final
        state for the continuity check."""
        nperm = len(blocks)
        assert nperm & (nperm - 1) == 0 and nperm > 0
        assert all(len(b) == RATE for b in blocks)
        self.blocks = [[v % bb.P for v in b] for b in blocks]
        self.num_perms = nperm
        self.initial_state = [v % bb.P for v in (initial_state or [0] * WIDTH)]
        self.expose_full_state = expose_full_state
        _, _, mu = p2.host_constants()
        self.mu = mu

    def structure_key(self) -> tuple:
        """eval's last-row constraints cover the whole state of a shard and
        the rate of a transcript: two graphs at one width and size (``mu``
        is the permutation's constant)."""
        return (self.expose_full_state,)

    # -- public values ----------------------------------------------------
    def publics_for(self, digest: list[int]) -> list[int]:
        first = p2.host_ext_linear(
            [
                (self.initial_state[c] + (self.blocks[0][c] if c < RATE else 0))
                % bb.P
                for c in range(WIDTH)
            ]
        )
        return first + [v % bb.P for v in digest]

    def compute_digest(self) -> list[int]:
        """Sponge output: the rate lanes (or full state when sharded)."""
        state = self.compute_final_state()
        return state if self.expose_full_state else state[:RATE]

    def compute_final_state(self) -> list[int]:
        state = list(self.initial_state)
        for blk in self.blocks:
            state = [
                (state[c] + (blk[c] if c < RATE else 0)) % bb.P
                for c in range(WIDTH)
            ]
            state = p2h.permute(state)
        return state

    # -- fixed columns ----------------------------------------------------
    def fixed_columns(self, n: int):
        assert n == ROWS_PER_PERM * self.num_perms
        cols = np.zeros((N_FIXED, n), dtype=np.uint32)
        seq = p2.host_round_sequence()
        for perm in range(self.num_perms):
            base = ROWS_PER_PERM * perm
            for r, (kind, rc) in enumerate(seq):
                cols[F_RC : F_RC + WIDTH, base + r] = rc
                cols[F_EXT if kind == "ext" else F_INT, base + r] = 1
            for r in range(N_ROUNDS, ROWS_PER_PERM - 1):
                cols[F_COPY, base + r] = 1
            cols[F_ABSORB, base + ROWS_PER_PERM - 1] = 1
            if perm + 1 < self.num_perms:
                for c in range(RATE):
                    cols[F_MSG + c, base + ROWS_PER_PERM - 1] = self.blocks[
                        perm + 1
                    ][c]
        return cols

    # -- trace ------------------------------------------------------------
    def trace(self) -> np.ndarray:
        n = ROWS_PER_PERM * self.num_perms
        rows = np.zeros((n, TRACE_WIDTH), dtype=np.uint32)
        seq = p2.host_round_sequence()
        state = list(self.initial_state)
        fixed = self.fixed_columns(n)
        for perm in range(self.num_perms):
            base = ROWS_PER_PERM * perm
            state = [
                (state[c] + (self.blocks[perm][c] if c < RATE else 0)) % bb.P
                for c in range(WIDTH)
            ]
            state = p2.host_ext_linear(state)
            for r in range(ROWS_PER_PERM):
                rows[base + r, COL_X : COL_X + WIDTH] = state
                rc = fixed[F_RC : F_RC + WIDTH, base + r]
                u = [(state[c] + int(rc[c])) % bb.P for c in range(WIDTH)]
                t = [pow(v, 3, bb.P) for v in u]
                s = [t[c] * t[c] % bb.P * u[c] % bb.P for c in range(WIDTH)]
                rows[base + r, COL_T : COL_T + WIDTH] = t
                rows[base + r, COL_S : COL_S + WIDTH] = s
                # advance
                if r < N_ROUNDS:
                    kind, _ = seq[r]
                    if kind == "ext":
                        state = p2.host_ext_linear(s)
                    else:
                        state = p2.host_int_linear([s[0]] + state[1:], self.mu)
                # copy rows: state unchanged
        return rows

    # -- constraints ------------------------------------------------------
    def eval(self, b: ConstraintBuilder) -> None:
        x = [b.local(COL_X + c) for c in range(WIDTH)]
        t = [b.local(COL_T + c) for c in range(WIDTH)]
        s = [b.local(COL_S + c) for c in range(WIDTH)]
        nx = [b.next(COL_X + c) for c in range(WIDTH)]
        rc = [b.fixed(F_RC + c) for c in range(WIDTH)]
        sel_ext = b.fixed(F_EXT)
        sel_int = b.fixed(F_INT)
        sel_copy = b.fixed(F_COPY)
        sel_absorb = b.fixed(F_ABSORB)
        msg = [b.fixed(F_MSG + c) for c in range(RATE)]

        u = [b.add(x[c], rc[c]) for c in range(WIDTH)]
        # helper constraints: t = u^3, s = t^2 * u  (degree 3)
        for c in range(WIDTH):
            b.transition(b.sub(t[c], b.mul(u[c], b.mul(u[c], u[c]))))
            b.transition(b.sub(s[c], b.mul(t[c], b.mul(t[c], u[c]))))

        ext_next = _ext_linear_expr(b, s)
        int_vec = [s[0]] + x[1:]
        int_next = _int_linear_expr(b, int_vec, self.mu)
        absorbed = [
            b.add(x[c], msg[c]) if c < RATE else x[c] for c in range(WIDTH)
        ]
        absorb_next = _ext_linear_expr(b, absorbed)
        for c in range(WIDTH):
            expr = b.add(
                b.add(
                    b.mul(sel_ext, b.sub(nx[c], ext_next[c])),
                    b.mul(sel_int, b.sub(nx[c], int_next[c])),
                ),
                b.add(
                    b.mul(sel_copy, b.sub(nx[c], x[c])),
                    b.mul(sel_absorb, b.sub(nx[c], absorb_next[c])),
                ),
            )
            b.transition(expr)
        # boundaries: first row = public initial state; last row digest
        # (full 16-lane state when shard-exposed)
        for c in range(WIDTH):
            b.first_row(b.sub(x[c], b.public(c)))
        out_lanes = WIDTH if self.expose_full_state else RATE
        for c in range(out_lanes):
            b.last_row(b.sub(x[c], b.public(WIDTH + c)))


def _ext_linear_expr(b: ConstraintBuilder, xs: list):
    """M_E = circ(2*M4, M4, M4, M4) over expressions (adds only)."""
    groups = []
    for g in range(4):
        a, bb_, c, d = xs[4 * g : 4 * g + 4]
        t0 = b.add(a, bb_)
        t1 = b.add(c, d)
        t2 = b.add(b.add(bb_, bb_), t1)
        t3 = b.add(b.add(d, d), t0)
        t4 = b.add(b.add(b.add(t1, t1), b.add(t1, t1)), t3)
        t5 = b.add(b.add(b.add(t0, t0), b.add(t0, t0)), t2)
        groups.append([b.add(t3, t5), t5, b.add(t2, t4), t4])
    sums = []
    for i in range(4):
        acc = groups[0][i]
        for g in range(1, 4):
            acc = b.add(acc, groups[g][i])
        sums.append(acc)
    return [b.add(groups[g][i], sums[i]) for g in range(4) for i in range(4)]


def _int_linear_expr(b: ConstraintBuilder, v: list, mu: list[int]):
    tot = v[0]
    for c in range(1, WIDTH):
        tot = b.add(tot, v[c])
    return [
        b.add(tot, b.mul(b.constant(mu[c]), v[c])) for c in range(WIDTH)
    ]
