"""AIR (algebraic intermediate representation) interface.

An AIR describes a computation as a trace matrix (n rows x width columns
over BabyBear) plus polynomial constraints.  Constraints are written once
against an abstract algebra and evaluated twice:

- by the **prover**, vectorized over the whole LDE domain with base-field
  jnp arrays (raiko_tpu.stark.prover), and
- by the **verifier**, at the single out-of-domain point with host
  extension-field scalars (raiko_tpu.stark.verifier).

Constraint kinds and their divisors (SURVEY.md §7 step 6 quotient scheme):

- ``transition(expr)``: must vanish on every row except the last
  (divisor Z_H(x) / (x - g^{n-1})).
- ``first_row(expr)``: must vanish on row 0 (divisor x - 1).
- ``last_row(expr)``: must vanish on row n-1 (divisor x - g^{n-1}).
- ``all_rows(expr)``: must vanish on every row (divisor Z_H(x)) — for
  per-row constraints that don't reference ``next`` (gate equations,
  LogUp helper bindings).  Degree-d exprs quotient to degree dn-n, so
  degree 3 fits quotient_chunks=2 here (unlike a last_row duplicate,
  whose divisor is only linear).

Max constraint degree 3 (blowup 4 leaves quotient degree < 2n < m).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable


@dataclass
class Constraint:
    kind: str  # "transition" | "first_row" | "last_row"
    expr: Any
    count: int = 1  # >1 for block constraints (expr stacks `count` rows)


class ConstraintBuilder:
    """Collects constraints during Air.eval.

    ``algebra`` supplies add/sub/mul/constant plus row accessors; the same
    Air.eval drives both vectorized prover evaluation and scalar verifier
    evaluation.
    """

    def __init__(self, algebra):
        self.alg = algebra
        self.constraints: list[Constraint] = []

    # row access -------------------------------------------------------
    def local(self, col: int):
        return self.alg.local(col)

    def next(self, col: int):
        return self.alg.next(col)

    def fixed(self, col: int):
        """Public preprocessed column (selectors, round constants,
        absorbed-message lanes).  Both sides know its values: the prover
        extends it alongside the trace, the verifier evaluates it at the
        OOD point directly — no commitment or opening needed."""
        return self.alg.fixed(col)

    def public(self, i: int):
        return self.alg.public(i)

    def constant(self, v: int):
        return self.alg.constant(v)

    # auxiliary (second committed segment) access ------------------------
    def aux(self, col: int):
        """Column of the auxiliary trace segment: committed by the prover
        AFTER the main trace, so it may depend on transcript challenges
        (permutation / lookup accumulators)."""
        return self.alg.aux(col)

    def aux_next(self, col: int):
        return self.alg.aux_next(col)

    def aux_block(self, cols) -> Any:
        return self.alg.aux_block(list(cols))

    def aux_next_block(self, cols) -> Any:
        return self.alg.aux_next_block(list(cols))

    def challenge_coord(self, k: int):
        """Base-field coordinate k of the aux challenges (challenge i's
        EF coordinates are k = 4i .. 4i+3).  Squeezed from the channel
        after the main-trace commitment."""
        return self.alg.challenge_coord(k)

    def challenge_ef(self, i: int) -> list:
        return [self.challenge_coord(4 * i + c) for c in range(4)]

    def bus_coord(self, k: int):
        """Base-field coordinate k of this table's bus values —
        challenge-dependent public EF scalars (Air.bus_values) absorbed
        into the transcript after the aux commitments; verify_tables
        checks the global sum over all tables vanishes."""
        return self.alg.bus_coord(k)

    def bus_ef(self, i: int) -> list:
        return [self.bus_coord(4 * i + c) for c in range(4)]

    # EF-as-4-columns helpers (x^4 = 11 tower, fields/babybear_ext) ------
    def ef_add4(self, a: list, b: list) -> list:
        return [self.add(x, y) for x, y in zip(a, b)]

    def ef_sub4(self, a: list, b: list) -> list:
        return [self.sub(x, y) for x, y in zip(a, b)]

    def ef_mul4(self, a: list, b: list) -> list:
        """Schoolbook quartic product of two 4-coordinate values; degree
        adds.  Works identically under both algebras (pure add/mul/scale
        composition)."""
        c: list = [None] * 7
        for i in range(4):
            for j in range(4):
                t = self.mul(a[i], b[j])
                c[i + j] = t if c[i + j] is None else self.add(c[i + j], t)
        return [
            self.add(c[0], self.scale(11, c[4])),
            self.add(c[1], self.scale(11, c[5])),
            self.add(c[2], self.scale(11, c[6])),
            c[3],
        ]

    def ef_from_base4(self, x) -> list:
        z = self.constant(0)
        return [x, z, z, z]

    def bit_block_code(self, bits_block, chi4: list, key, nbytes: int) -> list:
        """Geometric byte code of a bit block (little-endian bits):

            key + sum_{j<nbytes} byte_j * chi^{j+1},
            byte_j = sum_{b<8} bits[8j+b] * 2^b

        as a 4-coordinate EF value.  The prover algebra overrides this
        with a stacked-weight contraction (a handful of device ops); the
        generic path below loops per byte (verifier/debug evaluate it
        once per proof, not per LDE point)."""
        if hasattr(self.alg, "bit_block_code"):
            res = self.alg.bit_block_code(bits_block, chi4, key, nbytes)
            # probe algebras answer every method with a scalar sentinel
            return res if isinstance(res, list) else [res] * 4
        acc = self.ef_from_base4(key)
        pw = list(chi4)
        for j in range(nbytes):
            byte_e = None
            for bit in range(8):
                t = self.scale(1 << bit, bits_block[8 * j + bit])
                byte_e = t if byte_e is None else self.add(byte_e, t)
            acc = self.ef_add4(acc, [self.mul(pw[c], byte_e) for c in range(4)])
            if j + 1 < nbytes:
                pw = self.ef_mul4(pw, chi4)
        return acc

    # algebra ----------------------------------------------------------
    def add(self, a, b):
        return self.alg.add(a, b)

    def sub(self, a, b):
        return self.alg.sub(a, b)

    def mul(self, a, b):
        return self.alg.mul(a, b)

    # block row access (vectorized AIRs: keccak etc.) -------------------
    def local_block(self, cols) -> Any:
        """Stacked columns: cols is a list of column indices; returns a
        block value (prover: (k, m) array; verifier: list of EF scalars)."""
        return self.alg.local_block(list(cols))

    def next_block(self, cols) -> Any:
        return self.alg.next_block(list(cols))

    def fixed_block(self, cols) -> Any:
        return self.alg.fixed_block(list(cols))

    def public_block(self, idxs) -> Any:
        return self.alg.public_block(list(idxs))

    def scale(self, k: int, a):
        """Multiply by a small integer constant (degree-preserving)."""
        return self.alg.scale(k, a)

    # block-vectorization helpers ---------------------------------------
    # Each dispatches to an algebra fast path when present (the prover
    # stacks jnp arrays / does one integer matmul) and otherwise runs a
    # generic scale/add composition (verifier EF lists, circuit wires).
    def stack_block(self, exprs):
        """Stack k row expressions into one block for *_block registration.
        Pass-through when the value is already a stacked array (prover
        block ops return arrays, generic algebras lists)."""
        if not isinstance(exprs, list):
            return exprs
        if hasattr(self.alg, "stack"):
            return self.alg.stack(list(exprs))
        return list(exprs)

    def linmap(self, mat, blk):
        """out_i = sum_j mat[i][j] * blk[j] for a small integer matrix.
        Prover: ONE u64 matmul + mod (Montgomery-transparent).  Rows with
        entries up to p must keep sum_j mat[i][j]*(p-1) < 2^64."""
        if hasattr(self.alg, "linmap"):
            return self.alg.linmap(mat, blk)
        out = []
        for row in mat:
            acc = None
            for j, mij in enumerate(row):
                if mij == 0:
                    continue
                term = blk[j] if mij == 1 else self.scale(int(mij), blk[j])
                acc = term if acc is None else self.add(acc, term)
            out.append(acc if acc is not None else self.constant(0))
        return out

    def const_vec(self, vals: list):
        """Per-row constant column vector, broadcastable against a block."""
        if hasattr(self.alg, "const_vec"):
            return self.alg.const_vec(list(vals))
        return [self.constant(int(v)) for v in vals]

    def block_rowsum(self, blk):
        """Sum of a block's rows (one row value)."""
        if hasattr(self.alg, "block_rowsum"):
            return self.alg.block_rowsum(blk)
        acc = blk[0]
        for r in blk[1:]:
            acc = self.add(acc, r)
        return acc

    def concat_rows(self, parts: list):
        """Concatenate blocks/row-lists along the row axis."""
        if hasattr(self.alg, "concat_rows"):
            return self.alg.concat_rows(list(parts))
        out = []
        for p in parts:
            out.extend(p)
        return out

    # constraint registration ------------------------------------------
    def transition(self, expr) -> None:
        self.constraints.append(Constraint("transition", expr))

    def first_row(self, expr) -> None:
        self.constraints.append(Constraint("first_row", expr))

    def last_row(self, expr) -> None:
        self.constraints.append(Constraint("last_row", expr))

    def all_rows(self, expr) -> None:
        self.constraints.append(Constraint("all_rows", expr))

    def transition_block(self, expr, count: int) -> None:
        self.constraints.append(Constraint("transition", expr, count))

    def first_row_block(self, expr, count: int) -> None:
        self.constraints.append(Constraint("first_row", expr, count))

    def last_row_block(self, expr, count: int) -> None:
        self.constraints.append(Constraint("last_row", expr, count))

    def all_rows_block(self, expr, count: int) -> None:
        self.constraints.append(Constraint("all_rows", expr, count))


class Air:
    """Base class.  Subclasses set ``width`` and implement ``eval`` (and
    typically a trace generator used by the calling prover pipeline).
    ``fixed_columns(n)`` optionally returns an (F, n) uint32 array of
    public preprocessed columns.  ``quotient_chunks`` = max constraint
    degree - 1 (2 supports degree <= 3, 4 supports degree <= 5).

    Auxiliary segment (permutation / lookup arguments): set ``aux_width``
    and ``num_aux_challenges`` > 0 and implement ``aux_trace``.  The
    prover commits the main trace, squeezes ``num_aux_challenges`` EF
    challenges from the transcript, calls ``aux_trace``, and commits the
    result as a second segment with its own Merkle root, OOD openings
    and query openings.  EF-valued accumulators are laid out as 4
    consecutive base columns (builder.ef_mul4 et al. do the tower math).
    """

    width: int = 0
    quotient_chunks: int = 2
    aux_width: int = 0
    num_aux_challenges: int = 0
    num_bus_values: int = 0
    # When True (and fixed_columns is not None), the prover Merkle-commits
    # the fixed columns and opens them at zeta + every query; the verifier
    # recomputes the (deterministic) root from the statement and uses the
    # openings instead of evaluating fixed polynomials itself.  Required
    # for AIRs that appear as INNER statements of the recursive verifier
    # with large fixed tables (stark/recursion.py).
    commit_fixed: bool = False

    def eval(self, b: ConstraintBuilder) -> None:
        raise NotImplementedError

    def fixed_columns(self, n: int):
        return None

    def aux_trace(self, trace, challenges: list[tuple]):
        """(n, aux_width) uint32 standard-form aux segment; ``challenges``
        is a list of EF 4-tuples (standard-form ints)."""
        raise NotImplementedError

    def structure_key(self) -> tuple:
        """Hashable key for everything INSTANCE-specific that changes the
        constraint GRAPH (not just its inputs) — e.g. a direction constant
        baked into eval().  The prover caches jitted quotient stages per
        (class, shapes, structure_key); forgetting to override this when
        eval() bakes instance data produces wrong proofs via stage reuse."""
        return ()

    def bus_values(self, trace, challenges: list[tuple]) -> list[tuple]:
        """num_bus_values EF tuples: this table's net contributions to the
        global LogUp bus.  Must be bound by this table's constraints (via
        bus_coord/bus_ef, e.g. last-row accumulator equality); the
        multi-table verifier checks sum over all tables == 0."""
        raise NotImplementedError

    def num_constraints(self) -> int:
        b = ConstraintBuilder(Probe())
        self.eval(b)
        return sum(c.count for c in b.constraints)


class _ProbeVal:
    """Inert value returned by Probe algebras: survives indexing/slicing
    so structure-only eval passes (counts/kinds) never touch real math."""

    def __getitem__(self, k):
        return self


_PROBE_VAL = _ProbeVal()


class Probe:
    """Algebra stub answering every method with an inert value — used to
    enumerate an AIR's constraints without evaluating them."""

    def __getattr__(self, name):
        return lambda *a, **k: _PROBE_VAL
