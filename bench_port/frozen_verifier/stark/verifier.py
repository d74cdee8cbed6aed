"""STARK verifier: host code, with the wide rows' leaf hashes on a device.

Port of raiko_tpu/stark/verifier.py, copied but for the device calls.
Replays the Fiat-Shamir transcript, checks the DEEP-ALI identity at the
out-of-domain point, recomputes the DEEP composition value at every query
from Merkle-opened rows, and delegates the low-degree argument to
stark/fri.py.  All arithmetic is exact host math (ints + EF tuples).  The
device the caller names (``"cuda"`` unless it asks for ``"cpu"``) hashes
the queried rows wider than 64 columns, one ``hash_rows`` call each, and
recomputes a committed fixed segment's root."""

from __future__ import annotations

import numpy as np
import torch

from .. import convert
from .. import device as device_mod
from ..fields import babybear as bb
from ..fields import babybear_ext as ef
from ..ops import poseidon2 as p2
from ..ops import poseidon2_host as p2h
from . import fri
from .air import Air, ConstraintBuilder
from ..utils.measurement import Measurement
from .channel import Channel
from .domain import Domain
from .prover import BLOWUP_LOG, GRIND_BITS, NUM_QUERIES, StarkProof


class _VerifierAlgebra:
    """Scalar EF evaluation of constraints at the OOD point."""

    def __init__(
        self,
        at_zeta,
        at_zeta_g,
        publics,
        fixed_at_zeta=None,
        aux_at_zeta=None,
        aux_at_zeta_g=None,
        chal=None,
        bus=None,
    ):
        self._z = at_zeta
        self._zg = at_zeta_g
        self._publics = publics
        self._fixed = fixed_at_zeta
        self._aux_z = aux_at_zeta
        self._aux_zg = aux_at_zeta_g
        self._chal = chal  # flat list of base-field challenge coords
        self._bus = bus  # flat list of base-field bus-value coords

    def local(self, c):
        return tuple(self._z[c])

    def next(self, c):
        return tuple(self._zg[c])

    def fixed(self, c):
        return tuple(self._fixed[c])

    def aux(self, c):
        return tuple(self._aux_z[c])

    def aux_next(self, c):
        return tuple(self._aux_zg[c])

    def challenge_coord(self, k):
        return ef.h_from_base(self._chal[k])

    def bus_coord(self, k):
        return ef.h_from_base(self._bus[k])

    def public(self, i):
        return ef.h_from_base(self._publics[i])

    def constant(self, v):
        return ef.h_from_base(v)

    # block access: lists of EF scalars
    def local_block(self, cols):
        return [tuple(self._z[c]) for c in cols]

    def next_block(self, cols):
        return [tuple(self._zg[c]) for c in cols]

    def fixed_block(self, cols):
        return [tuple(self._fixed[c]) for c in cols]

    def aux_block(self, cols):
        return [tuple(self._aux_z[c]) for c in cols]

    def aux_next_block(self, cols):
        return [tuple(self._aux_zg[c]) for c in cols]

    def public_block(self, idxs):
        return [ef.h_from_base(self._publics[i]) for i in idxs]

    def scale(self, k, a):
        c = ef.h_from_base(k)
        if isinstance(a, list):
            return [ef.h_mul(c, v) for v in a]
        return ef.h_mul(c, a)

    def add(self, a, b):
        if isinstance(a, list) or isinstance(b, list):
            return [ef.h_add(x, y) for x, y in _zip_bc(a, b)]
        return ef.h_add(a, b)

    def sub(self, a, b):
        if isinstance(a, list) or isinstance(b, list):
            return [ef.h_sub(x, y) for x, y in _zip_bc(a, b)]
        return ef.h_sub(a, b)

    def mul(self, a, b):
        if isinstance(a, list) or isinstance(b, list):
            return [ef.h_mul(x, y) for x, y in _zip_bc(a, b)]
        return ef.h_mul(a, b)


def _zip_bc(a, b):
    """Zip with scalar broadcasting for block ops."""
    if isinstance(a, list) and isinstance(b, list):
        assert len(a) == len(b)
        return zip(a, b)
    if isinstance(a, list):
        return ((x, b) for x in a)
    return ((a, y) for y in b)


def _row_to_mont(row: list[int]) -> np.ndarray:
    return ((np.array(row, dtype=np.uint64) * bb.R) % bb.P).astype(np.uint32)


def _hash_rows_batch(rows: list[list[int]], device: torch.device) -> list[list[int]]:
    """Leaf digests (standard form) for many rows: ONE card call for wide
    rows (a 4160-wide row is ~520 host permutations), the host library
    for narrow ones and wherever the device is the CPU (where it is faster
    than the torch sponge, and bit-equal to it)."""
    w = len(rows[0])
    if w <= 64 or device.type == "cpu":
        return [p2h.hash_row(r) for r in rows]
    arr = ((np.array(rows, dtype=np.uint64) * bb.R) % bb.P).astype(np.uint32)
    dig = convert.bb_to_numpy(bb.from_mont(p2.hash_rows(convert.words_from_numpy(arr, device))))
    return [d.tolist() for d in dig]


def _host_path_ok(leaf_std, index: int, path, root) -> bool:
    """Merkle path walk on standard-form ints (host Poseidon2 in C)."""
    return p2h.path_ok(leaf_std, index, path, root)


def _check_merkle(row, index, path, root) -> bool:
    return p2h.row_path_ok(list(row), index, path, root)


def verify(air: Air, proof: StarkProof, device="cuda") -> bool:
    return verify_tables([air], [proof], device)


def verify_tables(airs: list[Air], proofs: list[StarkProof], device="cuda") -> bool:
    """Verify a shared-transcript multi-table proof (prover.prove_tables):
    per-table STARK checks plus the global LogUp-bus balance — the sum of
    every table's bus values must vanish, which (with the shared
    challenge squeezed after all trace roots) makes cross-table lookups
    sound.  The device (``"cuda"`` or ``"cpu"``) hashes the wide query rows
    and recomputes committed fixed roots."""
    dev = device_mod.get(device)
    if len(airs) != len(proofs) or not proofs:
        return False
    channel = Channel()
    channel.absorb_elems([len(airs)])
    fixeds = []
    for air, proof in zip(airs, proofs):
        if proof.width != air.width:
            return False
        aux_w = air.aux_width
        if len(proof.aux_at_zeta) != aux_w or len(proof.aux_at_zeta_g) != aux_w:
            return False
        if aux_w and len(proof.aux_root) != 8:
            return False
        if len(proof.bus) != air.num_bus_values:
            return False
        try:
            fixed = air.fixed_columns(1 << proof.log_n)
        except AssertionError:
            return False  # statement/proof shape mismatch
        committed = bool(getattr(air, "commit_fixed", False)) and fixed is not None
        fixeds.append((fixed, committed))
        if committed and len(proof.fixed_at_zeta) != fixed.shape[0]:
            return False
        if not committed and (proof.fixed_root or proof.fixed_at_zeta):
            return False
        channel.absorb_elems(
            [
                proof.log_n,
                proof.width,
                aux_w,
                air.num_bus_values,
                len(proof.publics),
                int(committed),
            ]
        )
        channel.absorb_elems(proof.publics)
    for (fixed, committed), proof in zip(fixeds, proofs):
        channel.absorb_elems(proof.trace_root)
        if committed:
            # the fixed commitment is deterministic: recompute from the
            # statement and demand equality before trusting any opening
            from .prover import fixed_commit_root

            if list(proof.fixed_root) != fixed_commit_root(fixed, bb.GENERATOR, dev):
                return False
            channel.absorb_elems(proof.fixed_root)
    nchal = max((air.num_aux_challenges for air in airs), default=0)
    shared = [channel.challenge_ef() for _ in range(nchal)]
    for air, proof in zip(airs, proofs):
        if air.aux_width:
            channel.absorb_elems(proof.aux_root)
    # global balance PER BUS INDEX: index i is its own channel (tables
    # with fewer bus values simply don't contribute to higher channels)
    bus_totals: list[tuple] = []
    for air, proof in zip(airs, proofs):
        for i, v in enumerate(proof.bus):
            channel.absorb_ef(tuple(v))
            while len(bus_totals) <= i:
                bus_totals.append(ef.H_ZERO)
            bus_totals[i] = ef.h_add(bus_totals[i], tuple(v))
    if any(t != ef.H_ZERO for t in bus_totals):
        return False
    for air, proof in zip(airs, proofs):
        chal = [x for t in shared[: air.num_aux_challenges] for x in t]
        if not _verify_table(air, proof, channel, chal, dev):
            return False
    return True


def _verify_table(
    air: Air, proof: StarkProof, channel: Channel, chal: list[int], device: torch.device
) -> bool:
    publics = proof.publics
    log_n = proof.log_n
    width = proof.width
    aux_w = air.aux_width
    dom = Domain(log_n, BLOWUP_LOG)
    m = dom.m
    fixed = air.fixed_columns(dom.n)
    committed = bool(getattr(air, "commit_fixed", False)) and fixed is not None
    fw = fixed.shape[0] if committed else 0
    alpha = channel.challenge_ef()
    channel.absorb_elems(proof.quotient_root)
    zeta = channel.challenge_ef()
    zeta_g = ef.h_mul(zeta, ef.h_from_base(dom.g))
    opened_at_zeta = list(proof.trace_at_zeta) + list(proof.aux_at_zeta)
    opened_at_zeta_g = list(proof.trace_at_zeta_g) + list(proof.aux_at_zeta_g)
    fixed_opened = [tuple(v) for v in proof.fixed_at_zeta] if committed else []
    for v in opened_at_zeta + opened_at_zeta_g + proof.quotient_at_zeta + fixed_opened:
        channel.absorb_ef(tuple(v))

    # DEEP-ALI identity at zeta: sum alpha^i c_i(zeta) sel_i(zeta) == Q(zeta)
    _t = Measurement("verify.fixed_eval")
    fixed_at_zeta = None
    if committed:
        # committed fixed segment: the openings are DEEP-bound witnesses,
        # no dense statement-sized evaluation needed
        fixed_at_zeta = fixed_opened
    elif fixed is not None:
        fixed_at_zeta = _eval_fixed_at(fixed, zeta, dom)
    _t.stop()
    _t = Measurement("verify.constraints")
    alg = _VerifierAlgebra(
        proof.trace_at_zeta,
        proof.trace_at_zeta_g,
        publics,
        fixed_at_zeta,
        proof.aux_at_zeta,
        proof.aux_at_zeta_g,
        chal,
        [x for v in proof.bus for x in v],
    )
    builder = ConstraintBuilder(alg)
    air.eval(builder)
    sels = dom.sel_at(zeta)
    acc = ef.H_ZERO
    apow = ef.H_ONE
    for con in builder.constraints:
        exprs = con.expr if isinstance(con.expr, list) else [con.expr]
        assert len(exprs) == con.count
        for e in exprs:
            acc = ef.h_add(acc, ef.h_mul(apow, ef.h_mul(e, sels[con.kind])))
            apow = ef.h_mul(apow, alpha)
    nq = air.quotient_chunks
    if len(proof.quotient_at_zeta) != 4 * nq:
        return False
    zn = ef.h_pow(zeta, dom.n)
    q_at_zeta = ef.H_ZERO
    znj = ef.H_ONE
    for j in range(nq):
        chunk = _chunk_at(proof.quotient_at_zeta[4 * j : 4 * j + 4])
        q_at_zeta = ef.h_add(q_at_zeta, ef.h_mul(znj, chunk))
        znj = ef.h_mul(znj, zn)
    _t.stop()
    if acc != q_at_zeta:
        return False

    # DEEP composition coefficients (opened at zeta = trace ++ aux ++
    # committed-fixed; at zeta*g = trace ++ aux)
    gamma = channel.challenge_ef()
    nq4 = 4 * nq
    ow = width + aux_w
    n_open = 2 * ow + fw + nq4
    gammas = [ef.H_ONE]
    for _ in range(n_open - 1):
        gammas.append(ef.h_mul(gammas[-1], gamma))
    c1 = ef.H_ZERO
    for k, v in enumerate(opened_at_zeta + fixed_opened):
        c1 = ef.h_add(c1, ef.h_mul(gammas[k], tuple(v)))
    for j in range(nq4):
        c1 = ef.h_add(
            c1,
            ef.h_mul(gammas[2 * ow + fw + j], tuple(proof.quotient_at_zeta[j])),
        )
    c2 = ef.H_ZERO
    for k in range(ow):
        c2 = ef.h_add(
            c2, ef.h_mul(gammas[ow + fw + k], tuple(opened_at_zeta_g[k]))
        )

    # FRI transcript replay, then query indices
    betas = fri.replay_commit(proof.fri_proof, log_n + BLOWUP_LOG, dom.shift, channel)
    if betas is None:
        return False
    if not channel.check_grind(proof.pow_nonce, GRIND_BITS):
        return False
    indices = channel.challenge_indices(NUM_QUERIES, m)
    if len(proof.queries) != len(indices) or len(proof.fri_proof.query_proofs) != len(indices):
        return False

    # per-query: Merkle rows + recompute DEEP value.  Leaf hashing for the
    # (possibly very wide) trace/quotient rows is batched into one device
    # call each; path walks run on the host.
    if len(proof.queries) == 0:
        return False
    _t = Measurement("verify.queries")
    t_leaves = _hash_rows_batch([list(q["trace_row"]) for q in proof.queries], device)
    q_leaves = _hash_rows_batch([list(q["quot_row"]) for q in proof.queries], device)
    if aux_w:
        if any(len(q.get("aux_row", [])) != aux_w for q in proof.queries):
            return False
        a_leaves = _hash_rows_batch([list(q["aux_row"]) for q in proof.queries], device)
    if committed:
        if any(len(q.get("fixed_row", [])) != fw for q in proof.queries):
            return False
        f_leaves = _hash_rows_batch([list(q["fixed_row"]) for q in proof.queries], device)
    pairs = []
    for qi, (idx, q) in enumerate(zip(indices, proof.queries)):
        if not _host_path_ok(t_leaves[qi], idx, q["trace_path"], proof.trace_root):
            return False
        if not _host_path_ok(q_leaves[qi], idx, q["quot_path"], proof.quotient_root):
            return False
        if aux_w and not _host_path_ok(
            a_leaves[qi], idx, q["aux_path"], proof.aux_root
        ):
            return False
        if committed and not _host_path_ok(
            f_leaves[qi], idx, q["fixed_path"], proof.fixed_root
        ):
            return False
        x = dom.xs_int[idx]
        opened_row = list(q["trace_row"]) + (list(q["aux_row"]) if aux_w else [])
        opened_row += list(q["fixed_row"]) if committed else []
        s1 = ef.H_ZERO
        for k in range(ow + fw):
            s1 = ef.h_add(
                s1, ef.h_mul(gammas[k], ef.h_from_base(opened_row[k]))
            )
        if len(q["quot_row"]) != nq4:
            return False
        for j in range(nq4):
            s1 = ef.h_add(
                s1,
                ef.h_mul(gammas[2 * ow + fw + j], ef.h_from_base(q["quot_row"][j])),
            )
        s2 = ef.H_ZERO
        for k in range(ow):
            s2 = ef.h_add(
                s2, ef.h_mul(gammas[ow + fw + k], ef.h_from_base(opened_row[k]))
            )
        inv_z = ef.h_inv(ef.h_sub(ef.h_from_base(x), zeta))
        inv_zg = ef.h_inv(ef.h_sub(ef.h_from_base(x), zeta_g))
        h_val = ef.h_add(
            ef.h_mul(ef.h_sub(s1, c1), inv_z), ef.h_mul(ef.h_sub(s2, c2), inv_zg)
        )
        pairs.append((idx, h_val))
    _t.stop()

    _t = Measurement("verify.fri_queries")
    try:
        return fri.check_queries(
            proof.fri_proof, betas, log_n + BLOWUP_LOG, dom.shift, pairs
        )
    finally:
        _t.stop()


def _eval_fixed_at(fixed: np.ndarray, zeta: tuple, dom: Domain) -> list[tuple]:
    """Evaluate public fixed columns at the OOD point via the sparse
    Lagrange basis: f_c(zeta) = sum_r fixed[c, r] * L_r(zeta) with
    L_r(zeta) = (zeta^n - 1)/n * g^r / (zeta - g^r).

    Cost is O(nnz) numpy mod-mul-adds plus one batched EF inversion over
    the distinct nonzero rows — device-free and, for the selector-style
    fixed columns of the shipped AIRs (keccak sponge: bit-valued absorb/
    RC/message lanes), far below the dense O(F·n log n) interpolation the
    prover pays."""
    F, n = fixed.shape
    assert n == dom.n
    cols_nz, rows_nz = np.nonzero(fixed)
    if cols_nz.size == 0:
        return [ef.H_ZERO] * F
    uniq_rows, row_idx = np.unique(rows_nz, return_inverse=True)
    zn = ef.h_pow(zeta, n)
    n_inv = pow(n, bb.P - 2, bb.P)
    zh_over_n = tuple(c * n_inv % bb.P for c in ef.h_sub(zn, ef.H_ONE))
    g_pows = [pow(dom.g, int(r), bb.P) for r in uniq_rows]
    denom_invs = ef.h_batch_inv(
        [ef.h_sub(zeta, ef.h_from_base(gr)) for gr in g_pows]
    )
    lag = np.empty((len(uniq_rows), 4), dtype=np.uint64)
    for i, (gr, inv) in enumerate(zip(g_pows, denom_invs)):
        lag[i] = ef.h_mul(zh_over_n, tuple(c * gr % bb.P for c in inv))
    vals = fixed[cols_nz, rows_nz].astype(np.uint64)
    acc = np.zeros((F, 4), dtype=np.uint64)
    for c in range(4):
        terms = (vals * lag[row_idx, c]) % bb.P  # < 2^31 each
        np.add.at(acc[:, c], cols_nz, terms)  # <= n terms/col: < 2^51 sum
    acc %= bb.P
    return [tuple(int(v) for v in row) for row in acc]


def _chunk_at(coords) -> tuple:
    """Chunk value from its 4 opened coordinate values: sum_c e_c * v_c
    where e_c is the EF basis element x^c."""
    acc = ef.H_ZERO
    for c, v in enumerate(coords):
        basis = tuple(1 if i == c else 0 for i in range(4))
        acc = ef.h_add(acc, ef.h_mul(basis, tuple(v)))
    return acc
