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
  coordinates are uniform: they are computed once per launch from the
  table's values (``Tape.uniform``, by dependency level: Q1 in its
  prologue, ``Tape.scalars`` on the host for the plain version), never
  once per row.
* An AIR that uses anything else raises ``TapeError`` with the AIR's name
  and the method; nothing falls back to another evaluation.

The tape (``Tape``):

* ``program`` (N, 4) int32: ``(op, dst, a, b)`` in topological order,
  depth first from each constraint row, after dead-code removal to the
  constraint outputs; a product of two columns or scalars is recomputed
  for each constraint row that reads it rather than held live.  ``op``
  is ``ADD``, ``SUB`` or ``MUL`` (``slot[dst] = a op b``) or ``ACC +
  kind`` (the constraint row's value ``a`` times alpha power ``dst``
  added to its kind's accumulator).  An operand word holds its kind in
  the top four bits (``SLOT``, ``LOCAL``, ``NEXT``, ``AUX``,
  ``AUX_NEXT``, ``FIXED``, ``SCALAR``) and its index below: a slot, a
  column (loaded from the LDE, the next row's through ``next_perm``) or
  a scalar (the constant pool, the publics, challenge and bus coordinates
  the tape reads, then the uniform values).
* Slots are allocated by liveness: a node's slot is free again after its
  last reader, so ``seg_slots`` holds the most values each segment keeps
  live at once (at most MAX_SEGMENT_SLOTS: more segments where a tape
  would need more).
* ``segments``: the constraint rows split into G contiguous groups, each
  with its own dependency closure (``seg_offsets`` into ``program``), so
  a table with few LDE rows still gives the card G times as many threads;
  the kernel adds the G partial numerators in a second launch.
* Per constraint row its kind and its alpha-power index; per constraint
  its count (``counts``, what ``prover._finish_table`` sizes alpha's
  powers by) and kind.

``tape_for`` caches tapes under the reference's stage key (AIR type,
``structure_key()``, widths, ``log_n``, ``quotient_chunks``, fixed or
not; the reference's env flag has no counterpart), and the recorded graph
(``Graph``) under that key less ``log_n``: only the segments depend on the
table's size.  The reference keys both its routes on that key and keeps
the first instance's ``air`` in the closure, so reusing a tape is as safe
as reusing the reference's stage.

``quotient_numerator_plain`` interprets a tape in torch on int64
Montgomery, vectorised over rows and over each dependency level of a
segment: the kernel's plain version.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from ..fields import babybear as bb
from .air import Air, ConstraintBuilder

# operand kinds: the top four bits of an operand word, the index below them
SLOT, LOCAL, NEXT, AUX, AUX_NEXT, FIXED, SCALAR = range(7)
KIND_SHIFT = 28
INDEX_MASK = (1 << KIND_SHIFT) - 1
# opcodes: slot[dst] = a op b; ACC + k folds a constraint row of kind k
ADD, SUB, MUL, ACC = range(4)
KINDS = ("transition", "first_row", "last_row", "all_rows")
# graph leaves: a column of an operand kind is node op _LEAF + kind; a
# public, challenge or bus coordinate, or a constant, is a uniform leaf
_LEAF = 8
_PUB, _CHAL, _BUS, _CONST = 16, 17, 18, 19
# a table gets G = ceil(TARGET_THREADS / m) segments, at most MAX_SEGMENTS
# and at most its constraint rows: on an H100 (700 W) Q1 took 8.4, 8.7,
# 5.3, 4.0 and 3.5 ms on the EVM CPU table (m = 128) at G = 16-256, and
# 2.9, 1.0, 0.85, 0.71 and 0.66 ms on the keccak chunk (m = 4,096)
# (tools/time_quotient.py --segments); the G x 4 x m partials stay under
# 16 MB
TARGET_THREADS = 1 << 20
MAX_SEGMENTS = 256
# at most this many slots live at once in a segment (more segments where a
# tape would need more): Q1 keeps them in shared memory, [slot][thread]
MAX_SEGMENT_SLOTS = 1024


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
    program: np.ndarray  # (N, 4) int32: op, dst, a, b
    seg_offsets: np.ndarray  # (G + 1,) int32
    seg_slots: np.ndarray  # (G,) int32: each segment's slots
    consts: np.ndarray  # (C,) Montgomery constant pool, scalars 0..C-1
    inputs: list  # (leaf, index) of scalars C..C+I-1: a public, challenge or bus coordinate
    uniform: np.ndarray  # (U, 4) int32 (op, dst, a, b) over scalar indices, by dependency level
    uniform_levels: np.ndarray  # (L + 1,) int32: level l is uniform[levels[l]:levels[l + 1]]
    n_scalars: int
    row_kinds: np.ndarray  # (rows,) kind index of each constraint row
    counts: list  # rows of each constraint
    kinds: list  # kind of each constraint
    widths: dict  # kind -> columns the program reads (highest index + 1)
    stats: dict = field(default_factory=dict)
    device_arrays: dict = field(default_factory=dict, repr=False)  # device -> the kernel's tape arrays

    @property
    def segments(self) -> int:
        return len(self.seg_offsets) - 1

    @property
    def rows(self) -> int:
        return len(self.row_kinds)

    def scalar_inputs(self, publics, chal, bus) -> np.ndarray:
        """The scalars a launch starts from, Montgomery u32: the constant
        pool, then this table's publics, challenge and bus coordinates as
        the tape reads them (standard-form ints)."""
        src = {_PUB: publics, _CHAL: chal, _BUS: bus}
        vals = [int(v) for v in self.consts] + [_mont(src[leaf][i]) for leaf, i in self.inputs]
        return np.asarray(vals, dtype=np.uint32)

    def scalars(self, publics, chal, bus) -> np.ndarray:
        """Every scalar operand of one launch: ``scalar_inputs``, then the
        uniform nodes, computed here on the host (Q1 computes them in its
        prologue)."""
        vals = self.scalar_inputs(publics, chal, bus).tolist()
        vals.extend([0] * (self.n_scalars - len(vals)))
        for op, d, a, b in self.uniform.tolist():
            x, y = vals[a], vals[b]
            vals[d] = (x + y) % bb.P if op == ADD else (x - y) % bb.P if op == SUB else _mmul(x, y)
        return np.asarray(vals, dtype=np.uint32)


def _operand(kind: int, index: int) -> int:
    if index > INDEX_MASK:
        raise ValueError(f"operand index {index} does not fit the tape's {KIND_SHIFT} bits")
    return (kind << KIND_SHIFT) | index


def segments_for(m: int, rows: int) -> int:
    """G for a table of `m` LDE rows and `rows` constraint rows."""
    return max(1, min(MAX_SEGMENTS, rows, math.ceil(TARGET_THREADS / m)))


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


def tape_of(graph: Graph, m: int, segments: int | None = None) -> Tape:
    """`graph` as a tape for a table of `m` LDE rows, which sets the number
    of segments (``segments_for``) unless `segments` does; G doubles while
    a segment would hold more than MAX_SEGMENT_SLOTS slots."""
    outs = graph.outs
    g = segments or segments_for(m, len(outs))
    tape = _build(graph.alg, outs, graph.counts, graph.kinds, g)
    while tape.seg_slots.max() > MAX_SEGMENT_SLOTS and g < len(outs):
        g = min(2 * g, len(outs))
        tape = _build(graph.alg, outs, graph.counts, graph.kinds, g)
    return tape


def record(air: Air, m: int, segments: int | None = None) -> Tape:
    """Record `air`'s constraints into a tape for a table of `m` LDE rows
    (``record_graph``, then ``tape_of``)."""
    return tape_of(record_graph(air), m, segments)


def _emit(nodes, row: list, cheap: list, root: int, memo: dict, local: dict, seq: list) -> int:
    """Append to `seq`, operands first, the instructions that compute
    `root` and are not in `memo` (the segment's values) or `local` (this
    constraint row's recomputed products); return `root`'s operand: the
    entry -1 - p of `seq` that computes it, or the node of a column or
    scalar.  Depth first, so a value is computed close to its readers; a
    product of two columns or scalars is recomputed for each constraint row
    that reads it instead of held live between rows far apart."""

    def ref(v: int) -> int:
        p = memo.get(v)
        if p is None:
            p = local.get(v)
        return v if p is None else -1 - p

    if not row[root]:
        return root
    stack = [root]
    while stack:
        v = stack[-1]
        if v in memo or v in local:
            stack.pop()
            continue
        op, a, b = nodes[v]
        pending = [u for u in (b, a) if row[u] and u not in memo and u not in local]
        if pending:
            stack.extend(pending)
            continue
        stack.pop()
        (local if cheap[v] else memo)[v] = len(seq)
        seq.append((op, None, ref(a), ref(b)))
    return ref(root)


def _segment(nodes, row, cheap, outs: list) -> tuple[list, list[int]]:
    """The entries of every constraint row as one segment: (op, None, a, b)
    computes a value, (ACC + kind, row, a, None) folds constraint row
    `row`; and the number of entries after each row's."""
    seq: list = []
    memo: dict = {}
    ends = []
    for r, (v, k) in enumerate(outs):
        a = _emit(nodes, row, cheap, v, memo, {}, seq)
        seq.append((ACC + k, r, a, None))
        ends.append(len(seq))
    return seq, ends


def _at_least(nodes, row: list, root: int, size: float) -> bool:
    """Whether `root` alone needs at least `size` computed nodes."""
    seen: set = set()
    stack = [root]
    while stack:
        v = stack.pop()
        if v in seen or not row[v]:
            continue
        seen.add(v)
        if len(seen) >= size:
            return True
        stack.extend(nodes[v][1:])
    return False


def _segments(alg: _TapeAlgebra, outs: list, g: int) -> tuple[list[tuple[int, int, list]], list]:
    """G contiguous ranges of the constraint rows, balanced by their
    instructions: (first row, end row, the range's entries) each, and the
    entries of all rows as one segment.  A row that alone needs a G-th of
    the whole (the EVM CPU table's LogUp transitions, some 17,000 nodes
    each, most of them shared) gets a segment of its own, so no thread
    walks two of them; the other rows share the segments left, each an
    equal part of what they need as one segment."""
    nodes, uniform = alg.nodes, alg.uniform
    row = [not u and node[0] <= MUL for node, u in zip(nodes, uniform)]  # computed per row
    cheap = [r and not row[node[1]] and not row[node[2]] for node, r in zip(nodes, row)]
    whole, ends = _segment(nodes, row, cheap, outs)
    n = len(outs)
    if g == 1:
        return [(0, n, whole)], whole
    heavy = [_at_least(nodes, row, v, len(whole) / g) for v, _ in outs]
    light_after = [0] * (n + 1)  # from row r on: the light rows' share of `whole`, the heavy rows
    heavy_after = [0] * (n + 1)
    for r in range(n - 1, -1, -1):
        light_after[r] = light_after[r + 1] + (0 if heavy[r] else ends[r] - (ends[r - 1] if r else 0))
        heavy_after[r] = heavy_after[r + 1] + heavy[r]
    segs: list = []
    lo, seq, memo = 0, [], {}

    def close(end: int) -> float:
        nonlocal lo, seq, memo
        segs.append((lo, end, seq))
        lo, seq, memo = end, [], {}
        return light_after[lo] / max(1, g - len(segs) - heavy_after[lo])

    share = light_after[0] / max(1, g - heavy_after[0])
    for i, (v, k) in enumerate(outs):
        if heavy[i] and seq and len(segs) < g - 1:
            share = close(i)
        a = _emit(nodes, row, cheap, v, memo, {}, seq)
        seq.append((ACC + k, i, a, None))
        if i + 1 < n and len(segs) < g - 1 and (heavy[i] or len(seq) >= share):
            share = close(i + 1)
    segs.append((lo, n, seq))
    return segs, whole


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


def _build(alg: _TapeAlgebra, outs: list, counts: list, kinds: list, g: int) -> Tape:
    nodes, uniform = alg.nodes, alg.uniform
    segs, whole = _segments(alg, outs, g)
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
    # the uniform nodes by dependency level: a level's instructions read
    # only earlier levels, so a block computes one level at a time
    level: dict[int, int] = {}
    for v in sorted(u for u in uni_nodes if nodes[u][0] <= MUL):
        _, a, b = nodes[v]
        level[v] = 1 + max(level.get(a, 0), level.get(b, 0))
    order = sorted(level, key=lambda u: (level[u], u))
    for v in order:
        scalar_of[v] = len(scalar_of)
    uni_prog, uni_levels = [], []
    for i, v in enumerate(order):
        if not i or level[v] != level[order[i - 1]]:
            uni_levels.append(i)
        op, a, b = nodes[v]
        uni_prog.append((op, scalar_of[v], scalar_of[a], scalar_of[b]))
    uni_levels.append(len(uni_prog))

    widths = {"trace": 0, "aux": 0, "fixed": 0}
    read_cols: set = set()
    leaf_refs: dict[int, int] = {}

    def leaf_ref(v: int) -> int:
        got = leaf_refs.get(v)
        if got is not None:
            return got
        if uniform[v]:
            got = _operand(SCALAR, scalar_of[v])
        else:
            op, i, _ = nodes[v]
            kind = op - _LEAF
            seg = "trace" if kind in (LOCAL, NEXT) else "aux" if kind in (AUX, AUX_NEXT) else "fixed"
            widths[seg] = max(widths[seg], i + 1)
            read_cols.add((seg, i))
            got = _operand(kind, i)
        leaf_refs[v] = got
        return got

    program: list[tuple[int, int, int, int]] = []
    seg_offsets = [0]
    seg_slots = []
    for _, _, seq in segs:
        last: dict[int, int] = {}  # entry -> the position of its last reader
        for p, (_, _, a, b) in enumerate(seq):
            for x in (a, b):
                if x is not None and x < 0:
                    last[-1 - x] = p
        slot: dict[int, int] = {}
        free: list[int] = []
        n_slots = 0

        def ref(x: int) -> int:
            return _operand(SLOT, slot[-1 - x]) if x < 0 else leaf_ref(x)

        for p, (op, r, a, b) in enumerate(seq):
            ra = ref(a)
            rb = ref(b) if b is not None else 0
            for x in {a, b}:
                if x is not None and x < 0 and last[-1 - x] == p:
                    free.append(slot[-1 - x])  # dst may take it: the kernel reads a and b first
            if op >= ACC:
                program.append((op, r, ra, 0))
                continue
            if free:
                s = free.pop()
            else:
                s, n_slots = n_slots, n_slots + 1
            slot[p] = s
            program.append((op, s, ra, rb))
        seg_slots.append(max(n_slots, 1))
        seg_offsets.append(len(program))

    prog = np.asarray(program, dtype=np.int64).reshape(-1, 4).astype(np.uint32).view(np.int32)
    ops = prog[:, 0]
    whole_ops = [e[0] for e in whole if e[0] < ACC]
    distinct_ops = _distinct_ops(nodes, uniform, outs)
    stats = {
        "constraints": len(counts), "rows": len(outs), "nodes": len(nodes),
        "instructions": int(len(prog)), "segments": len(segs),
        "arith": int((ops < ACC).sum()), "mul": int((ops == MUL).sum()),
        "add_sub": int(((ops == ADD) | (ops == SUB)).sum()),
        # the work the numerator needs: each distinct per-row node once
        "arith_distinct": len(distinct_ops), "mul_distinct": distinct_ops.count(MUL),
        # what one segment computes: the distinct nodes and the products of
        # two columns or scalars recomputed for each constraint row that
        # reads them, without the copies that G segments' closures repeat
        "arith_one_segment": len(whole_ops), "mul_one_segment": whole_ops.count(MUL),
        "max_slots": max(seg_slots), "slots": sum(seg_slots), "columns_read": len(read_cols),
        "consts": len(consts), "inputs": len(inputs), "uniform": len(uni_prog),
        "uniform_levels": len(uni_levels) - 1,
    }
    return Tape(
        air=alg.name, program=np.ascontiguousarray(prog), seg_offsets=np.asarray(seg_offsets, dtype=np.int32),
        seg_slots=np.asarray(seg_slots, dtype=np.int32),
        consts=np.asarray([alg.const[v] for v in consts], dtype=np.uint32),
        inputs=inputs, uniform=np.asarray(uni_prog, dtype=np.int32).reshape(-1, 4),
        uniform_levels=np.asarray(uni_levels, dtype=np.int32), n_scalars=len(scalar_of),
        row_kinds=np.asarray([k for _, k in outs], dtype=np.int32), counts=counts, kinds=kinds,
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


def _plan(rows: list) -> tuple[dict, list, list]:
    """A segment's instructions in single-assignment form, by dependency
    level: (leaf operand word -> value, per level {op: (dst, a, b) value
    lists}, ACC rows (kind, alpha index, value)).  Values 0.. are the
    segment's leaves (columns, scalars), then one per instruction."""
    leaves: dict[int, int] = {}
    cur: dict[int, int] = {}
    level: list[int] = []
    by_level: list[dict] = []
    accs = []

    def resolve(ref: int) -> int:
        if ref >> KIND_SHIFT == SLOT:
            return cur[ref & INDEX_MASK]
        v = leaves.get(ref)
        if v is None:
            v = leaves[ref] = len(level)
            level.append(0)
        return v

    for op, d, a, b in rows:
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
                             alpha_pows, sels) -> torch.Tensor:
    """Q1's plain version: the tape interpreted in torch on int64
    Montgomery, vectorised over rows and, within a segment, over the
    instructions of one dependency level (a gather, one op, a scatter).

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

    prog = tape.program.view(np.uint32).tolist()
    offs = tape.seg_offsets.tolist()
    for g in range(tape.segments):
        leaves, by_level, accs = _plan(prog[offs[g]:offs[g + 1]])
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
