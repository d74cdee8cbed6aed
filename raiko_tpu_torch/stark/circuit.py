"""Arithmetic-circuit builder for recursive STARK verification.

Role: the reference's zkVM backends prove *recursion* — a verifier runs
inside the next proof so shard/segment proofs aggregate into one
(risc0's recursion circuit, SP1's shard-aggregation; SURVEY.md §2.2
"risc0-zkvm prover core", §7 step 6 "then recursion/aggregation").  This
module is the TPU-native substrate for that: a static arithmetic circuit
over BabyBear's quartic extension whose satisfaction is proved by the
two-table STARK in stark/airs/circuit_air.py:

- a **gate table** (one row per gate: out = a + coef*b + cadd, out = a*b,
  assertions, boolean witnesses, free inputs), and
- a **Poseidon2 call table** (one row per permutation, all 21 rounds
  unrolled across columns, with an in-row half-swap for Merkle ordering),

wired together by a single LogUp *wire bus*: every gate receives its
operand wires and sends its output wire with multiplicity = fan-out, so
the global bus balance (stark/prover.py prove_tables) enforces circuit
consistency across both tables.  Wire values are EF4 elements; base-field
wires are EF values with zero high coordinates, which makes the gate
table's 4-coordinate fingerprint and the call table's base-only lane
fingerprint agree exactly on honest wires (and differ — breaking the bus
balance — on dishonest ones).

The builder runs in two modes sharing one code path:
- **witness mode** (``proofs`` present): wires carry concrete values and
  every emitted structure doubles as the trace; assertion gates are also
  checked eagerly so an invalid inner proof fails at build time;
- **structure mode** (values absent): only the gate/call skeleton (the
  fixed columns = the *statement*) is produced, which is what the outer
  verifier rebuilds to check an aggregated proof.

Constants are folded: arithmetic on constant values never emits a gate,
and a Poseidon2 call whose inputs are all constants is evaluated on the
host — so e.g. the transcript's constant preamble costs nothing.

Port of raiko_tpu/stark/circuit.py: host work with no device code.  The
one change: the permutations (the witness's and the folded constant
calls') run the C host Poseidon2 (``ops/poseidon2_host.permute``, bit for
bit ``poseidon2.host_permute``, which the reference calls), since the
circuit's build is more than a tenth of a seal on the card.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..fields import babybear as bb
from ..fields import babybear_ext as ef
from ..ops import poseidon2_host as p2h

# gate selector encoding (fixed columns of the gate table)
SEL_LIN = 0  # out = m_a*a + coef*b + cadd
SEL_MUL = 1  # out = a * b (EF tower product)
SEL_ASSERT = 2  # m_a*a - coef*b - cadd == 0 (no output)
SEL_BIT = 3  # out boolean witness: out0^2 = out0, out1..3 = 0
SEL_INPUT = 4  # out free witness (no constraint)
N_SEL = 5

EF_X = (0, 1, 0, 0)  # the tower generator X as an EF constant
EF_X2 = (0, 0, 1, 0)


def _is_const(v) -> bool:
    return isinstance(v, tuple)


def _as_ef(v) -> tuple:
    if isinstance(v, tuple):
        assert len(v) == 4
        return tuple(int(x) % bb.P for x in v)
    return (int(v) % bb.P, 0, 0, 0)


@dataclass
class Wire:
    """A circuit wire.  ``val`` is its EF4 value (standard-form ints) in
    witness mode, None in structure mode."""

    wid: int
    val: tuple | None


class FreeLane:
    """Marker for a Poseidon2 input lane that is a free witness of the
    call table (not wired to the bus) — e.g. Merkle sibling digests that
    no other gate consumes."""

    __slots__ = ("val",)

    def __init__(self, val: int | None):
        self.val = None if val is None else int(val) % bb.P


class CircuitBuilder:
    def __init__(self, with_values: bool):
        self.with_values = with_values
        self.gates: list[dict] = []
        self.calls: list[dict] = []
        self.uses: dict[int, int] = {}
        self._next_wid = 1  # 0 = disabled port
        self._const_cache: dict[tuple, Wire] = {}

    # -- wires ----------------------------------------------------------
    def _new_wire(self, val) -> Wire:
        w = Wire(self._next_wid, val)
        self._next_wid += 1
        return w

    def _use(self, w: Wire) -> int:
        self.uses[w.wid] = self.uses.get(w.wid, 0) + 1
        return w.wid

    def const_wire(self, v) -> Wire:
        """Materialize a constant as a wire (needed when a constant feeds
        a Poseidon2 lane).  Shared per distinct value."""
        v = _as_ef(v)
        w = self._const_cache.get(v)
        if w is None:
            w = self._emit(SEL_LIN, None, None, cadd=v, out_val=v)
            self._const_cache[v] = w
        return w

    # -- gate emission ---------------------------------------------------
    def _emit(
        self,
        sel: int,
        a: Wire | None,
        b: Wire | None,
        coef=(0, 0, 0, 0),
        cadd=(0, 0, 0, 0),
        out_val="compute",
        has_out: bool = True,
    ) -> Wire | None:
        coef = _as_ef(coef)
        cadd = _as_ef(cadd)
        if out_val == "compute" and self.with_values and has_out:
            if sel == SEL_LIN:
                av = a.val if a is not None else ef.H_ZERO
                bv = b.val if b is not None else ef.H_ZERO
                out_val = ef.h_add(ef.h_add(av, ef.h_mul(coef, bv)), cadd)
            elif sel == SEL_MUL:
                out_val = ef.h_mul(a.val, b.val)
            else:
                raise AssertionError("compute only for LIN/MUL")
        out = None
        if has_out:
            out = self._new_wire(out_val if self.with_values else None)
        if sel == SEL_ASSERT and self.with_values:
            av = a.val if a is not None else ef.H_ZERO
            bv = b.val if b is not None else ef.H_ZERO
            lhs = ef.h_sub(ef.h_sub(av, ef.h_mul(coef, bv)), cadd)
            if lhs != ef.H_ZERO:
                raise ValueError("circuit assertion failed (invalid witness)")
        self.gates.append(
            {
                "sel": sel,
                "a": self._use(a) if a is not None else 0,
                "b": self._use(b) if b is not None else 0,
                "o": out.wid if out is not None else 0,
                "coef": coef,
                "cadd": cadd,
                "aw": a,
                "bw": b,
                "ow": out,
            }
        )
        return out

    # -- public ops (operands: Wire or EF-tuple constant) -----------------
    def add(self, x, y):
        if _is_const(x) and _is_const(y):
            return ef.h_add(_as_ef(x), _as_ef(y))
        if _is_const(y):
            x, y = y, x
        if _is_const(x):  # const + wire
            return self._emit(SEL_LIN, None, y, coef=ef.H_ONE, cadd=_as_ef(x))
        return self._emit(SEL_LIN, x, y, coef=ef.H_ONE)

    def sub(self, x, y):
        if _is_const(x) and _is_const(y):
            return ef.h_sub(_as_ef(x), _as_ef(y))
        if _is_const(y):
            return self.add(x, ef.h_neg(_as_ef(y)))
        # x - y = (-1)*y + x
        neg1 = ef.h_neg(ef.H_ONE)
        if _is_const(x):
            return self._emit(SEL_LIN, None, y, coef=neg1, cadd=_as_ef(x))
        return self._emit(SEL_LIN, x, y, coef=neg1)

    def mul(self, x, y):
        if _is_const(x) and _is_const(y):
            return ef.h_mul(_as_ef(x), _as_ef(y))
        if _is_const(y):
            x, y = y, x
        if _is_const(x):
            c = _as_ef(x)
            if c == ef.H_ZERO:
                return ef.H_ZERO
            return self._emit(SEL_LIN, None, y, coef=c)
        return self._emit(SEL_MUL, x, y)

    def axpy(self, x, c, y):
        """x + c*y with c constant — one gate."""
        c = _as_ef(c)
        if _is_const(y):
            return self.add(x, ef.h_mul(c, _as_ef(y)))
        if _is_const(x):
            return self._emit(SEL_LIN, None, y, coef=c, cadd=_as_ef(x))
        return self._emit(SEL_LIN, x, y, coef=c)

    def assert_eq(self, x, y) -> None:
        if _is_const(x) and _is_const(y):
            if self.with_values and _as_ef(x) != _as_ef(y):
                raise ValueError("constant assertion failed")
            return
        if _is_const(x):
            x, y = y, x
        if _is_const(y):
            self._emit(SEL_ASSERT, x, None, cadd=_as_ef(y), has_out=False)
        else:
            self._emit(SEL_ASSERT, x, y, coef=ef.H_ONE, has_out=False)

    def assert_zero(self, x) -> None:
        self.assert_eq(x, ef.H_ZERO)

    def input_ef(self, val: tuple | None) -> Wire:
        return self._emit(
            SEL_INPUT, None, None,
            out_val=_as_ef(val) if val is not None else None,
        )

    def input_base(self, val: int | None) -> Wire:
        """Free witness known to be base-field.  The zero high coordinates
        are NOT separately constrained: every base input feeds either a
        Poseidon2 lane (whose base-only bus fingerprint forces the high
        coordinates to zero) or a canonical bit decomposition."""
        return self.input_ef(None if val is None else (int(val) % bb.P, 0, 0, 0))

    def bit_input(self, val: int | None) -> Wire:
        if self.with_values:
            assert val in (0, 1)
        return self._emit(
            SEL_BIT, None, None,
            out_val=(val, 0, 0, 0) if self.with_values else None,
        )

    def bits_of(self, x: Wire, nbits: int = 31, canonical: bool = True) -> list[Wire]:
        """Decompose a base-field wire into ``nbits`` boolean wires
        (little-endian) and constrain the recomposition to equal ``x``.
        With ``canonical`` (required whenever the bits themselves carry
        meaning — query indices, grinding) the decomposition of value v is
        forced to be v itself rather than v + p: since
        p = 2^31 - 2^27 + 1, v >= p iff bits 30..27 are all set and some
        lower bit is set, so hi4 * (sum of low-27 recomposition) == 0."""
        assert nbits == 31 or not canonical
        xv = x.val[0] if self.with_values else None
        bits = [
            self.bit_input(None if xv is None else (xv >> i) & 1)
            for i in range(nbits)
        ]
        acc = bits[0]
        low27 = None
        for i in range(1, nbits):
            acc = self.axpy(acc, (1 << i, 0, 0, 0), bits[i])
            if i == 26:
                low27 = acc
        self.assert_eq(acc, x)
        if canonical:
            hi = self.mul(self.mul(bits[30], bits[29]), self.mul(bits[28], bits[27]))
            self.assert_zero(self.mul(hi, low27))
        return bits

    def select(self, bit, x, y):
        """bit ? x : y  (bit boolean wire or 0/1 constant)."""
        if _is_const(bit):
            return x if _as_ef(bit)[0] else y
        d = self.sub(x, y)
        return self.add(y, self.mul(bit, d))

    def inv(self, x):
        """1/x via a witness hint: w with x*w == 1."""
        if _is_const(x):
            return ef.h_inv(_as_ef(x))
        w = self.input_ef(ef.h_inv(x.val) if self.with_values else None)
        self.assert_eq(self.mul(x, w), ef.H_ONE)
        return w

    def pack4(self, coords: list) -> "Wire | tuple":
        """4 base values (wires/consts, high coords zero) -> one EF value
        with those coordinates: c0 + X*c1 + X^2*(c2 + X*c3)."""
        assert len(coords) == 4
        lo = self.axpy(coords[0], EF_X, coords[1])
        hi = self.axpy(coords[2], EF_X, coords[3])
        return self.axpy(lo, EF_X2, hi)

    # -- Poseidon2 delegation ---------------------------------------------
    def perm_call(self, lanes: list, swap=None) -> list:
        """One Poseidon2 permutation row in the call table.

        lanes: 16 inputs, each a Wire, an int/EF constant, or a FreeLane.
        swap: optional boolean Wire/const; when 1 the two 8-lane halves
        are exchanged before permuting (Merkle left/right ordering).
        Returns 16 output Wires (or constants when fully folded)."""
        assert len(lanes) == 16
        swap_const = swap is None or _is_const(swap)
        if swap_const and all(_is_const(l) or isinstance(l, int) for l in lanes):
            vals = [_as_ef(l)[0] for l in lanes]
            if swap is not None and _as_ef(swap)[0]:
                vals = vals[8:] + vals[:8]
            out = p2h.permute(vals)
            return [(v, 0, 0, 0) for v in out]
        in_wires: list[Wire | None] = []
        in_free: list[int | None] = []
        for l in lanes:
            if isinstance(l, FreeLane):
                in_wires.append(None)
                in_free.append(l.val)
            else:
                if _is_const(l) or isinstance(l, int):
                    l = self.const_wire(l)
                in_wires.append(l)
                in_free.append(None)
        if swap is not None and _is_const(swap):
            if _as_ef(swap)[0]:
                in_wires = in_wires[8:] + in_wires[:8]
                in_free = in_free[8:] + in_free[:8]
            swap = None
        for w in in_wires:
            if w is not None:
                self._use(w)
        if swap is not None:
            self._use(swap)
        out_vals: list[int | None] = [None] * 16
        if self.with_values:
            xs = []
            for w, fv in zip(in_wires, in_free):
                if w is not None:
                    assert w.val is not None and w.val[1:] == (0, 0, 0), (
                        "poseidon2 lane wires must be base-field"
                    )
                    xs.append(w.val[0])
                else:
                    xs.append(fv)
            if swap is not None and swap.val[0]:
                xs = xs[8:] + xs[:8]
            out_vals = p2h.permute(xs)
        outs = [
            self._new_wire((v, 0, 0, 0) if self.with_values else None)
            for v in out_vals
        ]
        self.calls.append(
            {
                "in": in_wires,
                "free": in_free,
                "swap": swap,
                "out": outs,
            }
        )
        return outs

    # -- finalization ------------------------------------------------------
    def finalize(self) -> "CircuitBundle":
        from .airs.circuit_air import gate_fixed_columns, gate_trace
        from .airs.poseidon2_calls import calls_fixed_columns, calls_trace

        # output multiplicities (fan-out counts) for every producing wire
        g_fixed, n_g = gate_fixed_columns(self.gates, self.uses)
        c_fixed, n_p = calls_fixed_columns(self.calls, self.uses)
        g_trace = gate_trace(self.gates, n_g) if self.with_values else None
        c_trace = calls_trace(self.calls, n_p) if self.with_values else None
        return CircuitBundle(
            gate_fixed=g_fixed,
            call_fixed=c_fixed,
            gate_trace=g_trace,
            call_trace=c_trace,
            n_gates=len(self.gates),
            n_calls=len(self.calls),
        )


@dataclass
class CircuitBundle:
    gate_fixed: np.ndarray  # (F_G, n_g) uint32
    call_fixed: np.ndarray  # (F_P, n_p) uint32
    gate_trace: np.ndarray | None  # (n_g, 12) uint32
    call_trace: np.ndarray | None  # (n_p, 705) uint32
    n_gates: int
    n_calls: int
