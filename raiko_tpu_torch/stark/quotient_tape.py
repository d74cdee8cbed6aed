"""Each AIR's constraint evaluation recorded once as a flat instruction tape.

The reference compiles an AIR's whole constraint evaluation into one XLA
program (``jax.jit`` in raiko_tpu/stark/prover.py ``_quotient_stage_for``)
or, for the widest AIRs (``eager_quotient``), evaluates it in host numpy.
Here ``Air.eval`` runs once against a recording algebra, ``_TapeAlgebra``,
whose values are nodes of a graph instead of tensors.  The graph becomes a
``Tape``: a program of ``(op, dst, a, b)`` int32 instructions that one
kernel (Q1, ``ops/quotient_cuda.py``) interprets over every LDE row,
folding each constraint row into the quotient numerator with its power of
alpha.  The tape is data, so no AIR needs a compile of its own.

Recording:

* Every method of ``ConstraintBuilder``'s algebra that the op-by-op
  ``ProverAlgebra`` (``testing/quotient.py``, the reference's
  ``_ProverAlgebra``) answers is answered here.  A row value is a
  ``_Row`` (one node); a block is a ``_Block``, a list of row nodes that
  indexes, slices and iterates as the AIRs use it.  Broadcasting follows ``ProverAlgebra``: a block
  against a row, a ``(k, 1)`` public block or ``const_vec``, a challenge
  coordinate or a constant.
* Nodes are hash-consed (common subexpressions recorded once; add and mul
  are commutative), constants are folded, and ``x + 0``, ``x - 0``,
  ``x - x``, ``x * 1`` and ``x * 0`` are simplified: the field arithmetic
  is exact, so none of this changes a bit of the result.  ``linmap`` drops
  zero entries and multiplies no entry of 1; ``bit_block_code`` lowers to
  the builder's generic arithmetic (stark/air.py ``bit_block_code``).
* Nodes that depend only on constants, publics, challenges and bus
  coordinates are uniform: they are computed once per call from the
  table's values (``Tape.uniform``: Q1's ``quotient_uniform`` launch,
  ``Tape.scalars`` on the host for the plain version), never once per
  row.
* An AIR that uses anything else raises ``TapeError`` with the AIR's name
  and the method; nothing falls back to another evaluation.

The tape (``Tape``), walked by a group of L lanes per LDE row:

* Segments: the constraint rows cut into G contiguous ranges, each with
  its own dependency closure.  A segment closes before a row that would
  take it past ``segment_target`` instructions (SEGMENT_STEPS steps of L
  lanes, or fewer segments where m * L * G would pass TARGET_LANES), so a
  row that alone needs more (the EVM CPU table's LogUp transitions, some
  17,000 instructions each) has a segment of its own.  Within a segment
  the instructions come depth first from each constraint row, after
  dead-code removal; a product of two columns or scalars is recomputed for
  each constraint row that reads it rather than held live.  Each segment
  writes a partial numerator; Q1 adds the G partials in a further launch.
* Steps: each segment is scheduled as steps of L instructions
  (``program`` (N, 4) int32, segment by segment, step by step; NOP where a
  step has fewer), no instruction of a step reading what another
  computes: each step takes the lowest-numbered instructions whose
  operands earlier steps computed, which keeps the live values near the
  depth-first walk's (at L = 1 it is that walk).  ``op`` is ``ADD``,
  ``SUB`` or ``MUL`` (``slot[dst] = a op b``), ``ACC + kind`` (the
  constraint row's value ``a`` times alpha power ``dst`` added to its
  kind's sum) or ``NOP``.  An operand word holds its kind in the top four
  bits and its index below: ``COLUMN`` (entry j of the segment's column
  list: place j of a row's tile), ``SLOT`` (a value slot: place C_g + s of
  the row's tile, after the segment's C_g columns; ``dst`` likewise) or
  ``SCALAR`` (the constant pool, the publics, challenge and bus
  coordinates the tape reads, then the uniform values).
* Slots are allocated by liveness at step granularity: a value's slot is
  free for the steps after the step of its last reader, so no step writes
  a slot that one of its instructions reads or another writes, and its L
  lanes may run it in any order.  ``seg_slots`` holds the most values each
  segment keeps live at once.
* Columns: each segment's list of the (kind, column) pairs it reads
  (``seg_cols``: ``LOCAL``, ``NEXT``, ``AUX``, ``AUX_NEXT`` or ``FIXED``
  and the column), which Q1 stages for a block's rows in shared memory
  before the walk, with the segment's alpha powers (``seg_rows``: its
  constraint rows).
* Caps: a segment keeps at most MAX_SEGMENT_SLOTS slots live, stages at
  most MAX_SEGMENT_COLUMNS columns, folds at most MAX_SEGMENT_ROWS rows,
  and one warp's rows of it (``warp_rows``) fit a block's shared memory
  (``Tape.fits``); besides, a segment of several rows closes before its
  columns pass ``column_budget`` (a warp's tile near WARP_TILE_WORDS, so
  that an SM holds many warps).  Where a segment does not fit,
  ``tape_of`` doubles L (the widest constraint row first) or cuts the
  segments smaller; a tape that fits nowhere is kept for the plain
  version, and Q1's launch refuses it.
* Per constraint row its kind and its alpha-power index; per constraint
  its count (``counts``, what ``prover._finish_table`` sizes alpha's
  powers by) and kind.

``tape_for`` caches tapes under the reference's stage key (AIR type,
``structure_key()``, widths, ``log_n``, ``quotient_chunks``, fixed or
not; the reference's env flag has no counterpart), and the recorded graph
(``Graph``) under that key less ``log_n``: only the segments and the
steps depend on the table's size.  The reference keys both its routes on that key and keeps
the first instance's ``air`` in the closure, so reusing a tape is as safe
as reusing the reference's stage.

``quotient_numerator_plain`` interprets a tape in torch on int64
Montgomery, walking each segment's steps in order, vectorised over rows
and over each dependency level of the walk: the kernel's plain version.
"""

from __future__ import annotations

import heapq
import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from ..fields import babybear as bb
from .air import Air, ConstraintBuilder

# operand kinds: the top four bits of an operand word, the index below them.
# A column's kinds (LOCAL..FIXED) name it in a segment's column list; the
# program's operands are a value slot, a column of that list (COLUMN) or
# a scalar
SLOT, LOCAL, NEXT, AUX, AUX_NEXT, FIXED, SCALAR, COLUMN = range(8)
KIND_SHIFT = 28
INDEX_MASK = (1 << KIND_SHIFT) - 1
# opcodes: slot[dst] = a op b; ACC + k folds a constraint row of kind k;
# NOP pads a step to its lanes
ADD, SUB, MUL, ACC = range(4)
KINDS = ("transition", "first_row", "last_row", "all_rows")
NOP = ACC + len(KINDS)
# graph leaves: a column of an operand kind is node op _LEAF + kind; a
# public, challenge or bus coordinate, or a constant, is a uniform leaf
_LEAF = 8
_PUB, _CHAL, _BUS, _CONST = 16, 17, 18, 19
# L, the lanes of a row: the least power of two with m * L >= LANE_ROWS,
# at most 32 (a warp a row).  In one sweep on an H100 (700 W;
# tools/time_quotient.py --lanes --warp-tile --block-lanes) the EVM CPU
# table (m = 128) took 0.21-0.30 ms at L = 32 (22-33 segments), 0.26-0.41
# at 16 and 0.40-0.51 at 8; the keccak chunk (m = 4,096) 0.78-1.38 ms at
# L = 1, 0.87-1.72 at 2, 0.96-1.98 at 4 and 1.5-2.9 at 16-32
LANE_ROWS = 4096
# a segment holds about SEGMENT_STEPS steps of L instructions, and a table
# is cut into no more segments than give m * L * G = TARGET_LANES lanes.
# The EVM CPU table's longest segment, a LogUp row alone, is 564 steps at
# L = 32; at 256 steps (33 segments) Q1 took 0.21 ms there, at 512 (18-22)
# 0.30-0.31 ms (H100, 700 W)
SEGMENT_STEPS = 256
TARGET_LANES = 1 << 17
# a segment keeps at most this many slots live at once, stages at most this
# many columns and folds at most this many constraint rows (more segments,
# or more lanes, where a tape would need more), and one warp's rows of it
# fit a block's shared memory
MAX_SEGMENT_SLOTS = 1024
MAX_SEGMENT_COLUMNS = 4096
MAX_SEGMENT_ROWS = 1024
# a segment closes before its columns pass three quarters of this over the
# rows of a warp (32 / L), so that a warp's tile stays near 8 KB and an SM
# holds many warps.  At 1,024 / 2,048 / 3,072 words Q1 took 0.22 / 0.21 /
# 0.21 ms on the EVM CPU table (76 / 33 / 31 segments) and 0.64 / 0.58-
# 0.59 / 0.64-0.65 ms on the keccak chunk (1,371 / 552 / 368 segments);
# with no such cap the keccak chunk's 71 segments staged 976 columns a row
# and took 9.2 ms (H100, 700 W; --warp-tile)
WARP_TILE_WORDS = 2048
# unless L is asked for, L doubles while the segments would compute more
# than this many times what the tape computes as one segment: at L = 1 the
# column budget cut Poseidon2CallsAir (16,384 LDE rows) into 245 segments
# of 35 times the instructions, and its quotient took 3.3 s to record and
# 0.74 ms on an H100 against 0.11 ms before; the EVM CPU table at 128 rows
# (L = 32) computes 1.9 times
MAX_RECOMPUTE = 2.0
SMEM_BYTES = 232448  # shared memory a block can use on the H100 (227 KB)
RING_STAGES = 4  # Q1's tape ring: stages of RING_CHUNK instructions
RING_CHUNK = 128
UNIFORM_LANES = 32  # the uniform program's step: one warp


class TapeError(AttributeError):
    """An AIR's eval used something the recorder does not take."""


def _mont(v: int) -> int:
    return (int(v) % bb.P) * bb.R % bb.P


def _mmul(a: int, b: int) -> int:
    return a * b % bb.P * bb.RINV % bb.P


class _Row:
    """One value per LDE row (one for every row, where uniform): a node."""

    __slots__ = ("id",)

    def __init__(self, node: int):
        self.id = node


class _Block(list):
    """A block of row values (the (k, m) tensor of ``ProverAlgebra``)."""

    def __getitem__(self, i):
        if isinstance(i, slice):
            return _Block(list.__getitem__(self, i))
        if isinstance(i, (list, tuple, np.ndarray)):
            if isinstance(i, tuple) or (isinstance(i, np.ndarray) and i.dtype == bool):
                raise TapeError(f"block index {type(i).__name__} is not recorded")
            return _Block(list.__getitem__(self, int(j)) for j in i)
        return list.__getitem__(self, i)

    def _refuse(self, *_):
        raise TapeError("arithmetic on a block outside the algebra is not recorded")

    __add__ = __radd__ = __iadd__ = __mul__ = __rmul__ = __imul__ = _refuse


class _TapeAlgebra:
    """The recording algebra: ``ProverAlgebra``'s methods on graph nodes."""

    def __init__(self, name: str):
        self.name = name
        self.nodes: list[tuple[int, int, int]] = []  # (op, a, b); leaves: (leaf, index, 0)
        self.uniform: list[bool] = []
        self._ids: dict[tuple[int, int, int], int] = {}
        self.const: dict[int, int] = {}  # node -> Montgomery value

    def __getattr__(self, attr):
        raise TapeError(f"{self.name}: the tape recorder has no method {attr!r}")

    # nodes ------------------------------------------------------------
    def _intern(self, key: tuple[int, int, int], uniform: bool) -> int:
        node = self._ids.get(key)
        if node is None:
            node = len(self.nodes)
            self.nodes.append(key)
            self.uniform.append(uniform)
            self._ids[key] = node
            if key[0] == _CONST:
                self.const[node] = key[1]
        return node

    def _const_id(self, v: int) -> int:
        return self._intern((_CONST, v, 0), True)

    def _leaf(self, kind: int, i: int) -> _Row:
        if kind in (_PUB, _CHAL, _BUS):
            return _Row(self._intern((kind, int(i), 0), True))
        return _Row(self._intern((_LEAF + kind, int(i), 0), False))

    def _id(self, v, method: str) -> int:
        if isinstance(v, _Row):
            return v.id
        if isinstance(v, (int, np.integer)) and not isinstance(v, bool):
            return self._const_id(int(v) % bb.P)  # a raw int is Montgomery, as in ProverAlgebra
        raise TapeError(f"{self.name}: {method} of a {type(v).__name__} is not recorded")

    def _node(self, op: int, x: int, y: int) -> int:
        cx, cy = self.const.get(x), self.const.get(y)
        if cx is not None and cy is not None:
            v = (cx + cy) % bb.P if op == ADD else (cx - cy) % bb.P if op == SUB else _mmul(cx, cy)
            return self._const_id(v)
        one = _mont(1)
        if op == ADD:
            if cx == 0:
                return y
            if cy == 0:
                return x
        elif op == SUB:
            if cy == 0:
                return x
            if x == y:
                return self._const_id(0)
        else:
            if cx == 0 or cy == 0:
                return self._const_id(0)
            if cx == one:
                return y
            if cy == one:
                return x
        if op != SUB and x > y:
            x, y = y, x
        return self._intern((op, x, y), self.uniform[x] and self.uniform[y])

    def _bin(self, op: int, a, b, method: str):
        ba, bb_ = isinstance(a, _Block), isinstance(b, _Block)
        if not ba and not bb_:
            return _Row(self._node(op, self._id(a, method), self._id(b, method)))
        if ba and bb_:
            if len(a) == len(b):
                pairs = zip(a, b)
            elif len(a) == 1:
                pairs = ((a[0], y) for y in b)
            elif len(b) == 1:
                pairs = ((x, b[0]) for x in a)
            else:
                raise TapeError(f"{self.name}: {method} of blocks of {len(a)} and {len(b)} rows")
        elif ba:
            pairs = ((x, b) for x in a)
        else:
            pairs = ((a, y) for y in b)
        return _Block(_Row(self._node(op, self._id(x, method), self._id(y, method))) for x, y in pairs)

    # the algebra ------------------------------------------------------
    def local(self, c: int):
        return self._leaf(LOCAL, c)

    def next(self, c: int):
        return self._leaf(NEXT, c)

    def fixed(self, c: int):
        return self._leaf(FIXED, c)

    def aux(self, c: int):
        return self._leaf(AUX, c)

    def aux_next(self, c: int):
        return self._leaf(AUX_NEXT, c)

    def challenge_coord(self, k: int):
        return self._leaf(_CHAL, k)

    def bus_coord(self, k: int):
        return self._leaf(_BUS, k)

    def public(self, i: int):
        return self._leaf(_PUB, i)

    def constant(self, v: int):
        return _Row(self._const_id(_mont(v)))

    def local_block(self, cols):
        return _Block(self._leaf(LOCAL, c) for c in cols)

    def next_block(self, cols):
        return _Block(self._leaf(NEXT, c) for c in cols)

    def fixed_block(self, cols):
        return _Block(self._leaf(FIXED, c) for c in cols)

    def aux_block(self, cols):
        return _Block(self._leaf(AUX, c) for c in cols)

    def aux_next_block(self, cols):
        return _Block(self._leaf(AUX_NEXT, c) for c in cols)

    def public_block(self, idxs):
        return _Block(self._leaf(_PUB, i) for i in idxs)

    def scale(self, k: int, a):
        return self._bin(MUL, a, self.constant(int(k)), "scale")

    def add(self, a, b):
        return self._bin(ADD, a, b, "add")

    def sub(self, a, b):
        return self._bin(SUB, a, b, "sub")

    def mul(self, a, b):
        return self._bin(MUL, a, b, "mul")

    def stack(self, exprs):
        return _Block(_Row(self._id(e, "stack")) for e in exprs)

    def linmap(self, mat, blk):
        rows = []
        for row in mat:
            acc = None
            for j, mij in enumerate(row):
                mij = int(mij) % bb.P
                if mij == 0:
                    continue
                term = blk[j] if mij == 1 else self.scale(mij, blk[j])
                acc = term if acc is None else self.add(acc, term)
            rows.append(acc if acc is not None else self.constant(0))
        return _Block(rows)

    def const_vec(self, vals):
        return _Block(self.constant(v) for v in vals)

    def block_rowsum(self, blk):
        acc = blk[0]
        for r in blk[1:]:
            acc = self.add(acc, r)
        return acc

    def concat_rows(self, parts):
        out = _Block()
        for p in parts:
            if isinstance(p, _Block):
                out.extend(p)
            else:
                out.append(_Row(self._id(p, "concat_rows")))
        return out

    def _ef_mul4(self, a: list, b: list) -> list:
        c: list = [None] * 7
        for i in range(4):
            for j in range(4):
                t = self.mul(a[i], b[j])
                c[i + j] = t if c[i + j] is None else self.add(c[i + j], t)
        return [self.add(c[0], self.scale(11, c[4])), self.add(c[1], self.scale(11, c[5])),
                self.add(c[2], self.scale(11, c[6])), c[3]]

    def bit_block_code(self, bits_block, chi4: list, key, nbytes: int) -> list:
        """The builder's generic geometric byte code (stark/air.py)."""
        zero = self.constant(0)
        acc = [key, zero, zero, zero]
        pw = list(chi4)
        for j in range(nbytes):
            byte_e = None
            for bit in range(8):
                t = self.scale(1 << bit, bits_block[8 * j + bit])
                byte_e = t if byte_e is None else self.add(byte_e, t)
            acc = [self.add(x, self.mul(pw[c], byte_e)) for c, x in enumerate(acc)]
            if j + 1 < nbytes:
                pw = self._ef_mul4(pw, chi4)
        return acc


@dataclass
class Tape:
    """One AIR's recorded constraint evaluation (see the module note)."""

    air: str
    lanes: int  # L: the lanes of a row; a step is L instructions
    program: np.ndarray  # (N, 4) int32: op, dst, a, b; segment by segment, step by step
    seg_offsets: np.ndarray  # (G + 1,) int32, multiples of L
    seg_slots: np.ndarray  # (G,) int32: each segment's value slots
    seg_cols: np.ndarray  # (sum of C_g,) int32: each segment's column list, (kind, column) words
    seg_col_offsets: np.ndarray  # (G + 1,) int32 into seg_cols
    seg_rows: np.ndarray  # (G + 1,) int32: segment g folds constraint rows seg_rows[g]..seg_rows[g + 1] - 1
    consts: np.ndarray  # (C,) Montgomery constant pool, scalars 0..C-1
    inputs: list  # (leaf, index) of scalars C..C+I-1: a public, challenge or bus coordinate
    uniform: np.ndarray  # (U, 4) int32 (op, dst, a, b) over scalar indices, steps of UNIFORM_LANES by level
    n_scalars: int
    row_kinds: np.ndarray  # (rows,) kind index of each constraint row
    counts: list  # rows of each constraint
    kinds: list  # kind of each constraint
    widths: dict  # kind -> columns the program reads (highest index + 1)
    stats: dict = field(default_factory=dict)
    # device -> the kernel's tape arrays; ("launch_shape", m, cap) -> Q1's launch shape
    device_arrays: dict = field(default_factory=dict, repr=False)

    @property
    def segments(self) -> int:
        return len(self.seg_offsets) - 1

    @property
    def rows(self) -> int:
        return len(self.row_kinds)

    def segment(self, g: int) -> tuple[np.ndarray, np.ndarray]:
        """Segment g's (steps, L, 4) uint32 program and its column list."""
        prog = self.program[self.seg_offsets[g]:self.seg_offsets[g + 1]].view(np.uint32)
        return (prog.reshape(-1, self.lanes, 4),
                self.seg_cols[self.seg_col_offsets[g]:self.seg_col_offsets[g + 1]].view(np.uint32))

    def row_words(self) -> np.ndarray:
        """Each segment's words a row: its staged columns, then its value
        slots, rounded up to odd (the tile's row stride: lanes of a warp
        on 32 rows read one word of each row in 32 banks)."""
        return (np.diff(self.seg_col_offsets).astype(np.int64) + self.seg_slots) | 1

    def segment_words(self, rows_per_block: int) -> np.ndarray:
        """The words each segment stages beside the scalars: its alpha
        powers (4 a constraint row), then a [row][column + slot] tile of
        `rows_per_block` rows."""
        return 4 * np.diff(self.seg_rows).astype(np.int64) + rows_per_block * self.row_words()

    def smem_bytes(self, rows_per_block: int) -> int:
        """Q1's dynamic shared memory a block of `rows_per_block` rows:
        the tape ring and its barriers, the scalars, then the most
        ``segment_words``."""
        fixed = 16 * RING_STAGES * RING_CHUNK + 16 * RING_STAGES + 4 * (-(-self.n_scalars // 4) * 4)
        return fixed + 4 * int(self.segment_words(rows_per_block).max())

    def fits(self) -> bool:
        """Whether every segment keeps within the slot and column caps and
        one warp's rows (``warp_rows``) fit a block's shared memory."""
        return (int(self.seg_slots.max()) <= MAX_SEGMENT_SLOTS
                and int(np.diff(self.seg_col_offsets).max()) <= MAX_SEGMENT_COLUMNS
                and self.smem_bytes(warp_rows(self.lanes)) <= SMEM_BYTES)

    def scalar_inputs(self, publics, chal, bus) -> np.ndarray:
        """The scalars a launch starts from, Montgomery u32: the constant
        pool, then this table's publics, challenge and bus coordinates as
        the tape reads them (standard-form ints)."""
        src = {_PUB: publics, _CHAL: chal, _BUS: bus}
        vals = [int(v) for v in self.consts] + [_mont(src[leaf][i]) for leaf, i in self.inputs]
        return np.asarray(vals, dtype=np.uint32)

    def scalars(self, publics, chal, bus) -> np.ndarray:
        """Every scalar operand of one launch: ``scalar_inputs``, then the
        uniform nodes, computed here on the host (Q1's ``quotient_uniform``
        launch computes them on the card)."""
        vals = self.scalar_inputs(publics, chal, bus).tolist()
        vals.extend([0] * (self.n_scalars - len(vals)))
        for op, d, a, b in self.uniform.tolist():
            if op == NOP:
                continue
            x, y = vals[a], vals[b]
            vals[d] = (x + y) % bb.P if op == ADD else (x - y) % bb.P if op == SUB else _mmul(x, y)
        return np.asarray(vals, dtype=np.uint32)


def _operand(kind: int, index: int) -> int:
    if index > INDEX_MASK:
        raise ValueError(f"operand index {index} does not fit the tape's {KIND_SHIFT} bits")
    return (kind << KIND_SHIFT) | index


def lanes_for(m: int) -> int:
    """L for a table of `m` LDE rows: the least power of two with m * L >=
    LANE_ROWS, at most 32."""
    lanes = 1
    while lanes < 32 and m * lanes < LANE_ROWS:
        lanes *= 2
    return lanes


def warp_rows(lanes: int) -> int:
    """The rows one warp of Q1 walks at L lanes a row."""
    return 32 // lanes


def column_budget(lanes: int) -> float:
    """The columns a segment of several rows stages at most, so that with
    its slots one warp's rows (32 / L) stay near WARP_TILE_WORDS: three
    quarters of a row's share."""
    return 0.75 * WARP_TILE_WORDS * lanes / 32


def segment_target(whole: int, m: int, lanes: int, segments: int | None = None) -> float:
    """The instructions a segment holds about, of a tape that needs `whole`
    as one segment: SEGMENT_STEPS steps of L lanes, or whole * m * L /
    TARGET_LANES where that is more (no more lanes than TARGET_LANES);
    `segments` asks for about that many segments instead."""
    if segments:
        return whole / segments
    return max(lanes * SEGMENT_STEPS, whole * m * lanes / TARGET_LANES)


@dataclass
class Graph:
    """An AIR's recorded constraint graph, before segmentation: the
    recording algebra's nodes, each constraint row's (node, kind index) in
    alpha order, and each constraint's count and kind.  It does not depend
    on the table's size; only the segments of a ``Tape`` do."""

    alg: _TapeAlgebra
    outs: list
    counts: list
    kinds: list
    widest: int | None = None  # the most columns one constraint row reads, once asked


def record_graph(air: Air) -> Graph:
    """Run `air`'s eval once against the recording algebra."""
    name = type(air).__name__
    alg = _TapeAlgebra(name)
    builder = ConstraintBuilder(alg)
    air.eval(builder)
    outs: list[tuple[int, int]] = []  # (node, kind index) per constraint row, in alpha order
    counts, kinds = [], []
    for ci, con in enumerate(builder.constraints):
        if con.kind not in KINDS:
            raise TapeError(f"{name}: constraint {ci} has kind {con.kind!r}")
        k = KINDS.index(con.kind)
        if con.count == 1 and not isinstance(con.expr, _Block):
            rows = [con.expr]
        elif isinstance(con.expr, _Block) and len(con.expr) == con.count:
            rows = list(con.expr)
        else:
            raise TapeError(f"{name}: constraint {ci} ({con.kind}, count {con.count}) is not a block of "
                            f"{con.count} rows")
        outs.extend((alg._id(r, con.kind), k) for r in rows)
        counts.append(con.count)
        kinds.append(con.kind)
    return Graph(alg, outs, counts, kinds)


def tape_of(graph: Graph, m: int, segments: int | None = None, lanes: int | None = None) -> Tape:
    """`graph` as a tape for a table of `m` LDE rows: L lanes a row
    (``lanes_for`` unless `lanes` says) and segments of about
    ``segment_target`` instructions, L first doubled while the widest
    constraint row's columns would not fit one warp's rows.  While a
    segment does not fit (``Tape.fits``), one of a single constraint row
    doubles L (fewer rows a warp), else one of several rows halves the
    target; a tape that still does not fit is returned as it is (its plain
    version takes any layout; Q1's launch refuses it)."""
    nodes, uniform = graph.alg.nodes, graph.alg.uniform
    row = [not u and node[0] <= MUL for node, u in zip(nodes, uniform)]  # computed per row
    cheap = [r and not row[node[1]] and not row[node[2]] for node, r in zip(nodes, row)]
    column = [not u and _LEAF <= node[0] < _PUB for node, u in zip(nodes, uniform)]
    whole = _segment(nodes, row, cheap, graph.outs)
    forced = lanes is not None
    lanes = lanes or lanes_for(m)
    target = segment_target(len(whole), m, lanes, segments)
    while not forced and lanes < 32:
        # more lanes (a larger column budget a row, fewer segments) while
        # the segments would recompute more than MAX_RECOMPUTE times what
        # one segment computes
        if _segments(nodes, row, cheap, column, graph.outs, target, column_budget(lanes),
                     limit=MAX_RECOMPUTE * len(whole)) is not None:
            break
        lanes *= 2
        target = segment_target(len(whole), m, lanes, segments)
    if lanes < 32:
        # the fewest lanes at which the widest constraint row's columns fit
        # one warp's rows beside the ring and the scalars
        if graph.widest is None:
            graph.widest = max(_columns_of(nodes, row, v) for v, _ in graph.outs)
        widest = graph.widest
        fixed = 16 * RING_STAGES * RING_CHUNK + 16 * RING_STAGES + 4 * sum(uniform)
        while lanes < 32 and fixed + 4 * warp_rows(lanes) * widest > SMEM_BYTES:
            lanes *= 2
    scale = 1.0  # halved while a segment of several rows does not fit
    while True:
        segs = _segments(nodes, row, cheap, column, graph.outs, target * scale, scale * column_budget(lanes))
        tape = _build(graph, segs, whole, lanes)
        if tape.fits():
            return tape
        words = tape.segment_words(warp_rows(lanes))
        over = (tape.seg_slots > MAX_SEGMENT_SLOTS) | (np.diff(tape.seg_col_offsets) > MAX_SEGMENT_COLUMNS) | (
            tape.smem_bytes(warp_rows(lanes)) - 4 * (words.max() - words) > SMEM_BYTES)
        single = [end - lo == 1 for (lo, end, _), o in zip(segs, over) if o]
        if any(single) and lanes < 32:
            lanes *= 2
        elif not all(single):
            scale /= 2
        else:
            return tape


def record(air: Air, m: int, segments: int | None = None, lanes: int | None = None) -> Tape:
    """Record `air`'s constraints into a tape for a table of `m` LDE rows
    (``record_graph``, then ``tape_of``)."""
    return tape_of(record_graph(air), m, segments, lanes)


def _emit(nodes, row: list, cheap: list, root: int, memo: dict, seq: list, added=None) -> int:
    """Append to `seq`, operands first, the instructions that compute
    `root` and are not in `memo` (the segment's values); return `root`'s
    operand: the entry -1 - p of `seq` that computes it, or the node of a
    column or scalar.  Depth first, so a value is computed close to its
    readers; a product of two columns or scalars (`cheap`) is recomputed
    for each constraint row that reads it instead of held live between rows
    far apart: it stays in `memo` only while this row is emitted.  The
    nodes put in `memo` for good are appended to `added` where given."""
    if not row[root]:
        return root
    local = []
    stack = [root]
    while stack:
        v = stack[-1]
        if v in memo:
            stack.pop()
            continue
        _, a, b = node = nodes[v]
        wait_a = row[a] and a not in memo
        wait_b = row[b] and b not in memo
        if wait_a or wait_b:
            if wait_b:
                stack.append(b)
            if wait_a:
                stack.append(a)
            continue
        stack.pop()
        memo[v] = len(seq)
        if cheap[v]:
            local.append(v)
        elif added is not None:
            added.append(v)
        pa, pb = memo.get(a), memo.get(b)
        seq.append((node[0], None, a if pa is None else -1 - pa, b if pb is None else -1 - pb))
    p = memo[root]
    for v in local:
        del memo[v]
    return -1 - p


def _segment(nodes, row, cheap, outs: list) -> list:
    """The entries of every constraint row as one segment: (op, None, a, b)
    computes a value, (ACC + kind, row, a, None) folds constraint row
    `row`."""
    seq: list = []
    memo: dict = {}
    for r, (v, k) in enumerate(outs):
        a = _emit(nodes, row, cheap, v, memo, seq)
        seq.append((ACC + k, r, a, None))
    return seq


def _columns_of(nodes, row: list, root: int) -> int:
    """The columns `root` reads, through its per-row nodes."""
    seen: set = set()
    cols = 0
    stack = [root]
    while stack:
        v = stack.pop()
        if v in seen:
            continue
        seen.add(v)
        if row[v]:
            stack.extend(nodes[v][1:])
        elif _LEAF <= nodes[v][0] < _PUB:
            cols += 1
    return cols


def _segments(nodes, row, cheap, column: list, outs: list, target: float, col_budget: float,
              limit: float | None = None) -> list[tuple[int, int, list]] | None:
    """Contiguous ranges of the constraint rows, each with its own
    dependency closure: (first row, end row, the range's entries).  A
    segment at least half full, in instructions (of `target`) or in
    columns (of `col_budget`), closes before a row that would take it past
    either, so a row that alone needs more (the EVM CPU table's LogUp
    transitions, some 17,000 nodes each, most of them shared) starts a
    segment of its own, and a row that needs little joins the next; a
    segment folds at most MAX_SEGMENT_ROWS rows (their alpha powers are
    staged).  A row is emitted, then taken back where it closes the
    segment.  `column[v]`: whether node v is a column.  None once the
    segments' entries pass `limit`, where given."""
    segs: list = []
    lo, seq, memo, cols = 0, [], {}, set()
    done = 0  # the entries of the closed segments
    for i, (v, k) in enumerate(outs):
        if limit is not None and done + len(seq) > limit:
            return None
        while True:
            start, added = len(seq), []
            a = _emit(nodes, row, cheap, v, memo, seq, added)
            new = {x for e in seq[start:] for x in e[2:] if x >= 0 and column[x]}
            if a >= 0 and column[a]:
                new.add(a)
            new -= cols
            if start and (i - lo >= MAX_SEGMENT_ROWS or (start >= target / 2 or len(cols) >= col_budget / 2) and (
                    len(seq) + 1 > target or len(cols) + len(new) > col_budget)):
                del seq[start:]
                for u in added:
                    del memo[u]
                segs.append((lo, i, seq))
                done += len(seq)
                lo, seq, memo, cols = i, [], {}, set()
                continue
            break
        seq.append((ACC + k, i, a, None))
        cols |= new
    segs.append((lo, len(outs), seq))
    if limit is not None and done + len(seq) > limit:
        return None
    return segs


def _schedule(seq: list, lanes: int) -> list[list[int]]:
    """A segment's entries as steps of at most `lanes` entries, none of
    which reads another of its step: each step takes the lowest-numbered
    entries whose operands earlier steps computed.  The entries are in
    depth-first order, so that keeps the live values near the depth-first
    walk's; at one lane it is that walk."""
    if lanes == 1:
        return [[p] for p in range(len(seq))]
    n = len(seq)
    readers: list = [[] for _ in range(n)]
    waiting = [0] * n
    for p, (_, _, a, b) in enumerate(seq):
        deps = {-1 - x for x in (a, b) if x is not None and x < 0}
        waiting[p] = len(deps)
        for d in deps:
            readers[d].append(p)
    ready = [p for p in range(n) if not waiting[p]]  # sorted: a heap
    steps = []
    while ready:
        step = [heapq.heappop(ready) for _ in range(min(lanes, len(ready)))]
        for p in step:
            for q in readers[p]:
                waiting[q] -= 1
                if not waiting[q]:
                    heapq.heappush(ready, q)
        steps.append(step)
    return steps


def _distinct_ops(nodes, uniform, outs: list) -> list[int]:
    """The op of every distinct per-row arithmetic node the constraint rows
    reach (hash-consed, so each common subexpression counts once)."""
    seen: set = set()
    stack = [v for v, _ in outs]
    while stack:
        v = stack.pop()
        if v in seen or uniform[v] or nodes[v][0] > MUL:
            continue
        seen.add(v)
        stack.extend(nodes[v][1:])
    return [nodes[v][0] for v in seen]


def _build(graph: Graph, segs: list, whole: list, lanes: int) -> Tape:
    alg, outs = graph.alg, graph.outs
    nodes, uniform = alg.nodes, alg.uniform
    # scalars: the constant pool, the inputs the uniform nodes read, then
    # the uniform nodes that rows read and what those need
    consts = sorted(alg.const)
    scalar_of = {v: i for i, v in enumerate(consts)}
    uni_nodes: set = set()
    stack = [x for _, _, seq in segs for e in seq for x in e[2:] if x is not None and x >= 0 and uniform[x]]
    while stack:
        v = stack.pop()
        if v in uni_nodes:
            continue
        uni_nodes.add(v)
        op, a, b = nodes[v]
        if op <= MUL:
            stack.extend((a, b))
    inputs = []
    for v in sorted(u for u in uni_nodes if nodes[u][0] in (_PUB, _CHAL, _BUS)):
        scalar_of[v] = len(scalar_of)
        inputs.append(nodes[v][:2])
    # the uniform nodes by dependency level, each level in steps of
    # UNIFORM_LANES instructions (NOP where a step has fewer): a step reads
    # only earlier levels, so one warp computes a step, then the next
    level: dict[int, int] = {}
    for v in sorted(u for u in uni_nodes if nodes[u][0] <= MUL):
        _, a, b = nodes[v]
        level[v] = 1 + max(level.get(a, 0), level.get(b, 0))
    order = sorted(level, key=lambda u: (level[u], u))
    for v in order:
        scalar_of[v] = len(scalar_of)
    uni_prog: list = []
    for i, v in enumerate(order):
        if i and level[v] != level[order[i - 1]]:
            uni_prog.extend([(NOP, 0, 0, 0)] * (-len(uni_prog) % UNIFORM_LANES))
        op, a, b = nodes[v]
        uni_prog.append((op, scalar_of[v], scalar_of[a], scalar_of[b]))
    uni_prog.extend([(NOP, 0, 0, 0)] * (-len(uni_prog) % UNIFORM_LANES))

    widths = {"trace": 0, "aux": 0, "fixed": 0}
    read_cols: set = set()
    words: dict[int, int] = {}  # column node -> its (kind, column) word

    def column(v: int) -> int:
        got = words.get(v)
        if got is None:
            op, i, _ = nodes[v]
            kind = op - _LEAF
            seg = "trace" if kind in (LOCAL, NEXT) else "aux" if kind in (AUX, AUX_NEXT) else "fixed"
            widths[seg] = max(widths[seg], i + 1)
            read_cols.add((seg, i))
            got = words[v] = _operand(kind, i)
        return got

    nop = (NOP, 0, 0, 0)
    program: list[tuple[int, int, int, int]] = []
    seg_offsets, seg_col_offsets, seg_rows = [0], [0], [0]
    seg_slots, seg_cols, seg_steps = [], [], []
    for _, end, seq in segs:
        steps = _schedule(seq, lanes)
        # the segment's column list, by kind and column: operand COLUMN j
        # reads its entry j, staged for the block's rows before the walk
        leaves = {x for e in seq for x in e[2:] if x is not None and x >= 0}
        cols = sorted({column(x) for x in leaves if not uniform[x]})
        col_of = {w: j for j, w in enumerate(cols)}
        word = {x: _operand(SCALAR, scalar_of[x]) if uniform[x] else _operand(COLUMN, col_of[column(x)])
                for x in leaves}
        slot_word = _operand(SLOT, len(cols))  # slot s is place C_g + s of a row's tile
        # slots by liveness at step granularity: a value's slot is free for
        # the steps after the step of its last reader, so no step writes a
        # slot that one of its entries reads or another writes
        last: dict[int, int] = {}
        for t, step in enumerate(steps):
            for p in step:
                _, _, a, b = seq[p]
                if a < 0:
                    last[-1 - a] = t
                if b is not None and b < 0:
                    last[-1 - b] = t
        frees: list = [[] for _ in steps]
        for v, t in last.items():
            frees[t].append(v)
        slot: dict[int, int] = {}
        free: list[int] = []
        n_slots = 0

        for t, step in enumerate(steps):
            for p in step:
                op, r, a, b = seq[p]
                wa = slot_word + slot[~a] if a < 0 else word[a]
                if op >= ACC:
                    program.append((op, r, wa, 0))
                    continue
                wb = slot_word + slot[~b] if b < 0 else word[b]
                if free:
                    s = free.pop()
                else:
                    s, n_slots = n_slots, n_slots + 1
                slot[p] = s
                program.append((op, len(cols) + s, wa, wb))
            program.extend([nop] * (lanes - len(step)))
            free.extend(slot[v] for v in frees[t])
        seg_slots.append(max(n_slots, 1))
        seg_offsets.append(len(program))
        seg_cols.extend(cols)
        seg_col_offsets.append(len(seg_cols))
        seg_rows.append(end)
        seg_steps.append(len(steps))

    prog = np.asarray(program, dtype=np.int64).reshape(-1, 4).astype(np.uint32).view(np.int32)
    ops = prog[:, 0]
    whole_ops = [e[0] for e in whole if e[0] < ACC]
    distinct_ops = _distinct_ops(nodes, uniform, outs)
    n_cols = np.diff(seg_col_offsets)
    stats = {
        "constraints": len(graph.counts), "rows": len(outs), "nodes": len(nodes), "lanes": lanes,
        "instructions": int((ops != NOP).sum()), "nops": int((ops == NOP).sum()), "segments": len(segs),
        "steps": sum(seg_steps), "max_steps": max(seg_steps),
        "arith": int((ops < ACC).sum()), "mul": int((ops == MUL).sum()),
        "add_sub": int(((ops == ADD) | (ops == SUB)).sum()),
        # the work the numerator needs: each distinct per-row node once
        "arith_distinct": len(distinct_ops), "mul_distinct": distinct_ops.count(MUL),
        # what one segment computes: the distinct nodes and the products of
        # two columns or scalars recomputed for each constraint row that
        # reads them, without the copies that several segments' closures
        # repeat
        "arith_one_segment": len(whole_ops), "mul_one_segment": whole_ops.count(MUL),
        "max_slots": max(seg_slots), "slots": sum(seg_slots), "columns_read": len(read_cols),
        "max_columns": int(n_cols.max()), "columns_staged": int(n_cols.sum()),
        "max_segment_rows": int(np.diff(seg_rows).max()),
        "consts": len(consts), "inputs": len(inputs), "uniform": len(order),
        "uniform_levels": max(level.values(), default=0), "uniform_steps": len(uni_prog) // UNIFORM_LANES,
    }
    return Tape(
        air=alg.name, lanes=lanes, program=np.ascontiguousarray(prog),
        seg_offsets=np.asarray(seg_offsets, dtype=np.int32), seg_slots=np.asarray(seg_slots, dtype=np.int32),
        seg_cols=np.asarray(seg_cols, dtype=np.int64).astype(np.uint32).view(np.int32),
        seg_col_offsets=np.asarray(seg_col_offsets, dtype=np.int32), seg_rows=np.asarray(seg_rows, dtype=np.int32),
        consts=np.asarray([alg.const[v] for v in consts], dtype=np.uint32),
        inputs=inputs, uniform=np.asarray(uni_prog, dtype=np.int32).reshape(-1, 4), n_scalars=len(scalar_of),
        row_kinds=np.asarray([k for _, k in outs], dtype=np.int32), counts=graph.counts, kinds=graph.kinds,
        widths=widths, stats=stats,
    )


_GRAPHS: dict = {}  # stage key less log_n -> Graph
_TAPES: dict = {}  # stage key -> Tape
_LOCKS: dict = {}  # either key (they differ in length) -> the lock its first recording holds
_LOCKS_LOCK = threading.Lock()


def stage_key(air: Air, log_n: int, has_fixed: bool) -> tuple:
    """The reference's quotient-stage key, less its env flag."""
    return (type(air), air.structure_key(), air.width, air.aux_width, log_n, air.quotient_chunks, has_fixed)


def _cached(cache: dict, key: tuple, make):
    """cache[key], made once: a lookup of a cached value takes no lock, and
    a recording blocks only the callers that want the same key."""
    got = cache.get(key)
    if got is not None:
        return got
    with _LOCKS_LOCK:
        lock = _LOCKS.setdefault(key, threading.Lock())
    with lock:
        got = cache.get(key)
        if got is None:
            got = cache[key] = make()
    return got


def tape_for(air: Air, log_n: int, m: int, has_fixed: bool) -> Tape:
    """The cached tape of `air`'s stage key.  The graph is recorded once
    for the key less ``log_n`` (``air.eval`` and CSE do not depend on the
    table's size) and segmented once for each ``log_n``."""
    key = stage_key(air, log_n, has_fixed)
    graph_key = key[:4] + key[5:]
    return _cached(_TAPES, key, lambda: tape_of(_cached(_GRAPHS, graph_key, lambda: record_graph(air)), m))


# the plain version's value table stays under about this many int64 words
# per segment: its rows are evaluated in chunks of columns that fit
_PLAIN_WORDS = 1 << 23


def _plan(rows, cols) -> tuple[dict, list, list]:
    """A segment's instructions, walked in order, in single-assignment form
    by dependency level: (column or scalar operand word -> value, per level
    {op: (dst, a, b) value lists}, ACC rows (kind, alpha index, value)).
    Values 0.. are the segment's leaves (its columns, as their entries of
    `cols`, and scalars), then one per instruction.  A slot operand is the
    value its slot holds at that point of the walk, so the walk's order
    is the program's meaning."""
    leaves: dict[int, int] = {}
    cur: dict[int, int] = {}
    level: list[int] = []
    by_level: list[dict] = []
    accs = []

    def resolve(ref: int) -> int:
        kind = ref >> KIND_SHIFT
        if kind == SLOT:
            return cur[ref & INDEX_MASK]
        if kind == COLUMN:
            ref = int(cols[ref & INDEX_MASK])
        v = leaves.get(ref)
        if v is None:
            v = leaves[ref] = len(level)
            level.append(0)
        return v

    for op, d, a, b in rows:
        if op == NOP:
            continue
        x = resolve(a)
        if op >= ACC:
            accs.append((op - ACC, d, x))
            continue
        y = resolve(b)
        lv = 1 + max(level[x], level[y])
        v = cur[d] = len(level)
        level.append(lv)
        while len(by_level) < lv:
            by_level.append({})
        by_level[lv - 1].setdefault(op, ([], [], []))
        for lst, val in zip(by_level[lv - 1][op], (v, x, y)):
            lst.append(val)
    return leaves, by_level, accs


def quotient_numerator_plain(tape: Tape, t_lde, aux_lde, fixed_lde, next_perm, publics, chal, bus,
                             alpha_pows, sels, reverse_steps: bool = False) -> torch.Tensor:
    """Q1's plain version: the tape interpreted in torch on int64
    Montgomery, segment by segment and step by step (``_plan``: each slot
    operand read as the walk leaves it), vectorised over rows and over the
    instructions of one dependency level (a gather, one op, a scatter).
    `reverse_steps` walks each step's instructions in reverse order: the
    same numerator, since no step reads or overwrites what it writes.

    t_lde, aux_lde, fixed_lde: (W, m) Montgomery LDE columns (aux and fixed
    None where the AIR has none); next_perm: (m,) the next row's index;
    publics, chal, bus: the table's publics, challenge and bus coordinates,
    standard-form ints; alpha_pows: (rows, 4) Montgomery alpha^0..; sels:
    (4, m) Montgomery selectors in ``KINDS`` order.  Returns the (m, 4)
    int32 numerator sum_i alpha^i · c_i · sel_kind(i), a view of its (4, m)
    transpose (the layout the quotient's iNTT reads)."""
    dev = t_lde.device
    m = t_lde.shape[1]
    scal = torch.as_tensor(tape.scalars(publics, chal, bus).astype(np.int64), device=dev)
    cols = {LOCAL: t_lde, NEXT: t_lde, AUX: aux_lde, AUX_NEXT: aux_lde, FIXED: fixed_lde}
    nxt = next_perm.long()
    apow = alpha_pows.long()
    sel = sels.long()
    num = torch.zeros((4, m), dtype=torch.int64, device=dev)
    ops = {ADD: bb.add, SUB: bb.sub, MUL: bb.mont_mul}

    def idx(vals) -> torch.Tensor:
        return torch.as_tensor(vals, dtype=torch.int64, device=dev)

    for g in range(tape.segments):
        steps, col_list = tape.segment(g)
        walk = (steps[:, ::-1] if reverse_steps else steps).reshape(-1, 4).tolist()
        leaves, by_level, accs = _plan(walk, col_list)
        n_values = len(leaves) + sum(len(d) for lv in by_level for d, _, _ in lv.values())
        loads: dict[int, tuple[list, list]] = {}
        for ref, v in leaves.items():
            dst, src = loads.setdefault(ref >> KIND_SHIFT, ([], []))
            dst.append(v)
            src.append(ref & INDEX_MASK)
        loads = {k: (idx(d), idx(s)) for k, (d, s) in loads.items()}
        levels = [{op: tuple(idx(x) for x in lists) for op, lists in lv.items()} for lv in by_level]
        fold = {}
        for k in range(len(KINDS)):
            rows = [(a, v) for kk, a, v in accs if kk == k]
            if rows:
                fold[k] = (apow.index_select(0, idx([a for a, _ in rows])), idx([v for _, v in rows]))
        chunk = max(1, min(m, _PLAIN_WORDS // max(1, n_values + 4 * len(accs))))
        for r0 in range(0, m, chunk):
            r1 = min(m, r0 + chunk)
            vals = torch.empty((n_values, r1 - r0), dtype=torch.int64, device=dev)
            for kind, (dst, src) in loads.items():
                if kind == SCALAR:
                    got = scal.index_select(0, src)[:, None].expand(-1, r1 - r0)
                else:
                    got = cols[kind].index_select(0, src).long()
                    got = got[:, nxt[r0:r1]] if kind in (NEXT, AUX_NEXT) else got[:, r0:r1]
                vals.index_copy_(0, dst, got)
            for lv in levels:
                for op, (dst, a, b) in lv.items():
                    vals.index_copy_(0, dst, ops[op](vals.index_select(0, a), vals.index_select(0, b)))
            for k, (ap, src) in fold.items():
                # sum over the kind's rows of alpha^i · c_i: < rows · p < 2^63
                terms = bb.mont_mul(ap[:, :, None], vals.index_select(0, src)[:, None, :])
                acc = terms.sum(0) % bb.P
                num[:, r0:r1] = bb.add(num[:, r0:r1], bb.mont_mul(acc, sel[k, r0:r1][None, :]))
    return num.to(torch.int32).T
