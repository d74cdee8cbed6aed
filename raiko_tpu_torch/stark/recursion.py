"""Recursive STARK verification — the host verifier as a static circuit.

Aggregation: K inner proofs (each a shared-transcript multi-table proof,
stark/prover.py prove_tables) are verified *inside* one outer proof: the
complete verifier — Fiat-Shamir transcript replay over a Poseidon2
sponge, DEEP-ALI identity at the out-of-domain point, Merkle openings,
FRI fold consistency, final-polynomial degree check, grinding check —
is traced into the gate/call circuit of stark/circuit.py, and the outer
proof is a two-table STARK over that circuit
(CircuitAir + Poseidon2CallsAir).  This is the TPU-native analog of the
reference's vendored recursion provers (risc0 recursion circuit, SP1
shard aggregation; SURVEY.md §2.2, §7 step 6 "recursion/aggregation"):
shard proofs from provers/tpu_shard.py collapse into one proof whose
verification cost is independent of the number of shards.

The outer *statement* is the circuit structure itself (the fixed columns
of both tables): it embeds the inner AIRs' constraint systems, trace
shapes, and public values.  verify_recursion rebuilds that structure
from the statement alone (no proof values) and runs the ordinary host
verifier on the outer proof.

Inner AIRs with public fixed columns are supported via in-circuit
sparse Lagrange evaluation (the circuit analog of
verifier._eval_fixed_at): the fixed VALUES are statement constants, so
each distinct nonzero row costs one in-circuit inversion and each
nonzero entry one axpy gate — O(n + nnz) gates, intended for the small
per-shard tables (Poseidon2 transcript shards).  Large fixed tables
(the keccak/MPT statement) want a committed fixed segment instead —
roadmap.

Port of raiko_tpu/stark/recursion.py, copied but for the device: the
statement's committed fixed roots (``_verify_tables_circuit``), the outer
proof (``prove_recursion``) and its verification (``verify_recursion``)
run on the device the caller names ("cuda" or "cpu"), and
``build_recursion`` takes it to rebuild the statement.  The circuit
itself (its trace and fixed columns) is host work, as in the reference;
its build is a ``Measurement`` span, ``recursion.circuit``.

Every transcript rule here mirrors stark/verifier.py + stark/fri.py
line by line; any drift makes honest witness generation fail its own
assertion gates, never a soundness gap (soundness comes from the gate
constraints + wire bus, not from the builder).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..fields import babybear as bb
from ..fields import babybear_ext as ef
from ..ops.ntt import bit_reverse_indices
from ..utils.measurement import Measurement
from . import prover as prover_mod
from .air import Air, ConstraintBuilder
from .airs.circuit_air import CircuitAir
from .airs.poseidon2_calls import Poseidon2CallsAir
from .circuit import CircuitBuilder, FreeLane
from .fri import FINAL_SIZE
from .prover import BLOWUP_LOG, StarkProof


@dataclass
class InnerTable:
    """One table of an inner multi-table proof, as statement data."""

    air: Air
    log_n: int
    publics: list[int]


class _Sponge:
    """Circuit mirror of stark/channel.py Channel (duplex Poseidon2,
    rate 8).  State lanes are CVals; constant-only permutations fold to
    host evaluations inside CircuitBuilder.perm_call."""

    def __init__(self, b: CircuitBuilder):
        self.b = b
        self.state: list = [(0, 0, 0, 0)] * 16
        self.pending: list = []

    def absorb(self, vals: list) -> None:
        self.pending.extend(vals)

    def absorb_consts(self, ints: list[int]) -> None:
        self.pending.extend((int(v) % bb.P, 0, 0, 0) for v in ints)

    def _flush(self) -> None:
        pend, self.pending = self.pending, []
        for off in range(0, len(pend), 8):
            chunk = pend[off : off + 8]
            st = list(self.state)
            for i, v in enumerate(chunk):
                st[i] = self.b.add(st[i], v)
            self.state = self.b.perm_call(st)

    def challenge(self):
        if self.pending:
            self._flush()
        out = self.state[0]
        self.state = self.b.perm_call(self.state)
        return out

    def challenge_ef(self):
        """Returns (coords, packed): 4 base CVals and their EF packing."""
        if self.pending:
            self._flush()
        coords = list(self.state[:4])
        self.state = self.b.perm_call(self.state)
        return coords, self.b.pack4(coords)


class _CircuitAlgebra:
    """Verifier algebra over circuit values (mirror of
    verifier._VerifierAlgebra; every value is a CVal holding an EF4)."""

    def __init__(self, b, at_z, at_zg, publics, aux_z, aux_zg, chal, bus, fixed=None):
        self.b = b
        self._z = at_z
        self._zg = at_zg
        self._publics = publics
        self._aux_z = aux_z
        self._aux_zg = aux_zg
        self._chal = chal  # flat base CVals
        self._bus = bus
        self._fixed = fixed  # fixed-column values at zeta (CVals)

    def local(self, c):
        return self._z[c]

    def next(self, c):
        return self._zg[c]

    def aux(self, c):
        return self._aux_z[c]

    def aux_next(self, c):
        return self._aux_zg[c]

    def challenge_coord(self, k):
        return self._chal[k]

    def bus_coord(self, k):
        return self._bus[k]

    def public(self, i):
        return (int(self._publics[i]) % bb.P, 0, 0, 0)

    def constant(self, v):
        return (int(v) % bb.P, 0, 0, 0)

    def fixed(self, c):
        return self._fixed[c]

    def local_block(self, cols):
        return [self._z[c] for c in cols]

    def next_block(self, cols):
        return [self._zg[c] for c in cols]

    def aux_block(self, cols):
        return [self._aux_z[c] for c in cols]

    def aux_next_block(self, cols):
        return [self._aux_zg[c] for c in cols]

    def public_block(self, idxs):
        return [self.public(i) for i in idxs]

    def fixed_block(self, cols):
        return [self._fixed[c] for c in cols]

    def scale(self, k, a):
        if isinstance(a, list):
            return [self.b.mul((k % bb.P, 0, 0, 0), v) for v in a]
        return self.b.mul((k % bb.P, 0, 0, 0), a)

    def add(self, a, b_):
        return self._zip(self.b.add, a, b_)

    def sub(self, a, b_):
        return self._zip(self.b.sub, a, b_)

    def mul(self, a, b_):
        return self._zip(self.b.mul, a, b_)

    def _zip(self, op, a, b_):
        if isinstance(a, list) or isinstance(b_, list):
            if not isinstance(a, list):
                a = [a] * len(b_)
            if not isinstance(b_, list):
                b_ = [b_] * len(a)
            return [op(x, y) for x, y in zip(a, b_)]
        return op(a, b_)


def _verify_tables_circuit(
    b: CircuitBuilder, tables: list[InnerTable], proofs: list[StarkProof] | None, device
) -> None:
    """Trace one full verify_tables run into the circuit."""
    if proofs is not None:
        assert len(proofs) == len(tables)
        for t, p in zip(tables, proofs):
            if p.width != t.air.width or p.log_n != t.log_n:
                raise ValueError("inner proof shape mismatch")
            if list(p.publics) != [v % bb.P for v in t.publics]:
                raise ValueError("inner proof publics mismatch")
            if len(p.aux_at_zeta) != t.air.aux_width or len(p.bus) != t.air.num_bus_values:
                raise ValueError("inner proof aux/bus shape mismatch")

    def inp(fn):
        return b.input_base(fn(proofs) if proofs is not None else None)

    def inp_vec(fn, k):
        return [inp(lambda p, j=j: fn(p)[j]) for j in range(k)]

    ch = _Sponge(b)
    ch.absorb_consts([len(tables)])
    committed_flags = []
    for t in tables:
        fixed = t.air.fixed_columns(1 << t.log_n)
        committed = bool(getattr(t.air, "commit_fixed", False)) and fixed is not None
        committed_flags.append(committed)
        ch.absorb_consts(
            [
                t.log_n,
                t.air.width,
                t.air.aux_width,
                t.air.num_bus_values,
                len(t.publics),
                int(committed),
            ]
        )
        ch.absorb_consts(t.publics)
    troots = []
    froots = []
    for ti, t in enumerate(tables):
        root = inp_vec(lambda p, ti=ti: p[ti].trace_root, 8)
        troots.append(root)
        ch.absorb(root)
        if committed_flags[ti]:
            # deterministic statement value: recompute, absorb as constants
            froot = prover_mod.fixed_commit_root(
                t.air.fixed_columns(1 << t.log_n), bb.GENERATOR, device
            )
            if proofs is not None and list(proofs[ti].fixed_root) != froot:
                raise ValueError("inner fixed commitment mismatch")
            ch.absorb_consts(froot)
            froots.append([(v, 0, 0, 0) for v in froot])
        else:
            froots.append(None)
    nchal = max((t.air.num_aux_challenges for t in tables), default=0)
    shared = [ch.challenge_ef() for _ in range(nchal)]
    aroots = []
    for ti, t in enumerate(tables):
        if t.air.aux_width:
            ar = inp_vec(lambda p, ti=ti: p[ti].aux_root, 8)
            ch.absorb(ar)
            aroots.append(ar)
        else:
            aroots.append(None)
    # bus values: absorbed in table order, then global per-channel balance
    bus_all = []
    channel_totals: list = []
    for ti, t in enumerate(tables):
        per = []
        for i in range(t.air.num_bus_values):
            coords = inp_vec(lambda p, ti=ti, i=i: p[ti].bus[i], 4)
            ch.absorb(coords)
            packed = b.pack4(coords)
            per.append((coords, packed))
            while len(channel_totals) <= i:
                channel_totals.append((0, 0, 0, 0))
            channel_totals[i] = b.add(channel_totals[i], packed)
        bus_all.append(per)
    for tot in channel_totals:
        b.assert_zero(tot)
    for ti, t in enumerate(tables):
        chal_coords = [c for coords, _ in shared[: t.air.num_aux_challenges] for c in coords]
        _verify_table_circuit(
            b, ch, t, None if proofs is None else proofs[ti],
            chal_coords, bus_all[ti], troots[ti], aroots[ti], froots[ti],
        )


def _sponge_hash_row(b: CircuitBuilder, wires: list) -> list:
    """Circuit mirror of poseidon2.host_hash_row (width-tagged sponge)."""
    w = len(wires)
    nchunks = max(1, -(-w // 8))
    padded = list(wires) + [(0, 0, 0, 0)] * (nchunks * 8 - w)
    state: list = [(0, 0, 0, 0)] * 15 + [(w % bb.P, 0, 0, 0)]
    for c in range(nchunks):
        st = list(state)
        for i in range(8):
            st[i] = b.add(st[i], padded[c * 8 + i])
        state = b.perm_call(st)
    return state[:8]


def _merkle_check(b, leaf8, path_bits, root, path_fn, proofs):
    """Walk a Merkle path: one swapped Poseidon2 call per level; sibling
    digests are free witness lanes of the call table."""
    cur = list(leaf8)
    for lvl, bit in enumerate(path_bits):
        sib = [
            FreeLane(path_fn(proofs, lvl)[k] if proofs is not None else None)
            for k in range(8)
        ]
        cur = b.perm_call(cur + sib, swap=bit)[:8]
    for k in range(8):
        b.assert_eq(cur[k], root[k])


def _verify_table_circuit(b, ch, t, proof, chal_coords, bus_pairs, troot, aroot, froot):
    air = t.air
    log_n = t.log_n
    n = 1 << log_n
    log_m = log_n + BLOWUP_LOG
    m = 1 << log_m
    g = bb.two_adic_generator(log_n)
    g_last = pow(g, n - 1, bb.P)
    shift = bb.GENERATOR
    width = air.width
    aux_w = air.aux_width
    nq = air.quotient_chunks
    nq4 = 4 * nq
    ow = width + aux_w
    committed = froot is not None
    fixed_cols = air.fixed_columns(n)
    fw = fixed_cols.shape[0] if committed else 0
    num_queries = prover_mod.NUM_QUERIES
    grind_bits = prover_mod.GRIND_BITS

    def inp(fn):
        return b.input_base(fn(proof) if proof is not None else None)

    def inp_ef_absorbed(fn):
        coords = [inp(lambda p, c=c: fn(p)[c]) for c in range(4)]
        ch.absorb(coords)
        return b.pack4(coords)

    _, alpha = ch.challenge_ef()
    qroot = [inp(lambda p, k=k: p.quotient_root[k]) for k in range(8)]
    ch.absorb(qroot)
    zeta_coords, zeta = ch.challenge_ef()
    zeta_g = b.mul(zeta, (g, 0, 0, 0))
    tz = [inp_ef_absorbed(lambda p, k=k: p.trace_at_zeta[k]) for k in range(width)]
    az = [inp_ef_absorbed(lambda p, k=k: p.aux_at_zeta[k]) for k in range(aux_w)]
    tzg = [inp_ef_absorbed(lambda p, k=k: p.trace_at_zeta_g[k]) for k in range(width)]
    azg = [inp_ef_absorbed(lambda p, k=k: p.aux_at_zeta_g[k]) for k in range(aux_w)]
    qz = [inp_ef_absorbed(lambda p, k=k: p.quotient_at_zeta[k]) for k in range(nq4)]
    fz = [inp_ef_absorbed(lambda p, k=k: p.fixed_at_zeta[k]) for k in range(fw)]
    opened_z = tz + az
    opened_zg = tzg + azg

    # -- DEEP-ALI identity at zeta --------------------------------------
    zn = zeta
    for _ in range(log_n):
        zn = b.mul(zn, zn)
    if committed:
        # committed fixed segment: the openings (DEEP-bound below) stand
        # in for the statement-sized dense evaluation
        fixed_at = fz
    elif fixed_cols is not None:
        fixed_at = _fixed_at_zeta_circuit(b, fixed_cols, n, zeta, zn, g)
    else:
        fixed_at = None
    bus_coords = [c for coords, _ in bus_pairs for c in coords]
    alg = _CircuitAlgebra(
        b, opened_z, opened_zg, t.publics, az, azg, chal_coords, bus_coords,
        fixed_at,
    )
    builder = ConstraintBuilder(alg)
    air.eval(builder)
    zh_inv = b.inv(b.sub(zn, ef.H_ONE))
    z_last = b.sub(zeta, (g_last, 0, 0, 0))
    sels = {
        "transition": b.mul(z_last, zh_inv),
        "first_row": b.inv(b.sub(zeta, ef.H_ONE)),
        "last_row": b.inv(z_last),
        "all_rows": zh_inv,
    }
    acc = (0, 0, 0, 0)
    apow = ef.H_ONE
    for con in builder.constraints:
        exprs = con.expr if isinstance(con.expr, list) else [con.expr]
        assert len(exprs) == con.count
        for e in exprs:
            acc = b.add(acc, b.mul(apow, b.mul(e, sels[con.kind])))
            apow = b.mul(apow, alpha)
    # quotient recombination: sum_j zeta^(n j) * (sum_c X^c * q_{4j+c})
    zn_j = ef.H_ONE
    q_at_zeta = (0, 0, 0, 0)
    x_basis = [(1, 0, 0, 0), (0, 1, 0, 0), (0, 0, 1, 0), (0, 0, 0, 1)]
    for j in range(nq):
        chunk = (0, 0, 0, 0)
        for c in range(4):
            chunk = b.add(chunk, b.mul(x_basis[c], qz[4 * j + c]))
        q_at_zeta = b.add(q_at_zeta, b.mul(zn_j, chunk))
        zn_j = b.mul(zn_j, zn)
    b.assert_eq(acc, q_at_zeta)

    # -- DEEP composition coefficients ------------------------------------
    _, gamma = ch.challenge_ef()
    n_open = 2 * ow + fw + nq4
    gammas = [ef.H_ONE]
    for _ in range(n_open - 1):
        gammas.append(b.mul(gammas[-1], gamma))
    c1 = (0, 0, 0, 0)
    for k, v in enumerate(opened_z + fz):
        c1 = b.add(c1, b.mul(gammas[k], v))
    for j in range(nq4):
        c1 = b.add(c1, b.mul(gammas[2 * ow + fw + j], qz[j]))
    c2 = (0, 0, 0, 0)
    for k in range(ow):
        c2 = b.add(c2, b.mul(gammas[ow + fw + k], opened_zg[k]))

    # -- FRI commit replay -------------------------------------------------
    n_layers = max(0, log_m - (FINAL_SIZE.bit_length() - 1))
    if proof is not None and len(proof.fri_proof.layer_roots) != n_layers:
        raise ValueError("inner FRI layer count mismatch")
    lroots = []
    betas = []
    for l in range(n_layers):
        root = [inp(lambda p, l=l, k=k: p.fri_proof.layer_roots[l][k]) for k in range(8)]
        ch.absorb(root)
        lroots.append(root)
        betas.append(ch.challenge_ef()[1])
    nfin = 1 << (log_m - n_layers)
    if proof is not None and len(proof.fri_proof.final_values) != nfin:
        raise ValueError("inner FRI final size mismatch")
    finals = []
    for j in range(nfin):
        finals.append(inp_ef_absorbed(lambda p, j=j: p.fri_proof.final_values[j]))
    _final_poly_check(b, finals, n_layers, shift)

    # -- grinding ----------------------------------------------------------
    nonce = inp(lambda p: p.pow_nonce)
    ch.absorb([nonce])
    gbits = b.bits_of(ch.challenge(), 31, canonical=True)
    for i in range(31 - grind_bits, 31):
        b.assert_zero(gbits[i])

    # -- queries -------------------------------------------------------------
    if proof is not None and (
        len(proof.queries) != num_queries
        or len(proof.fri_proof.query_proofs) != num_queries
    ):
        raise ValueError("inner query count mismatch")
    for qi in range(num_queries):
        bits = b.bits_of(ch.challenge(), 31, canonical=True)[:log_m]
        _query_circuit(
            b, t, proof, qi, bits, log_m, shift,
            zeta, zeta_g, gammas, c1, c2, betas, lroots, finals,
            troot, qroot, aroot, froot, fw,
        )


def _fixed_at_zeta_circuit(b, fixed, n: int, zeta, zn, g: int):
    """Circuit mirror of verifier._eval_fixed_at: fixed-column values are
    statement constants, so f_c(zeta) = sum_r fixed[c,r] * L_r(zeta) costs
    one inversion per distinct nonzero row + one axpy per nonzero entry:

        L_r(zeta) = (zeta^n - 1)/n * g^r / (zeta - g^r)."""
    import numpy as np

    F = fixed.shape[0]
    cols_nz, rows_nz = np.nonzero(fixed)
    if cols_nz.size == 0:
        return [(0, 0, 0, 0)] * F
    n_inv = pow(n, bb.P - 2, bb.P)
    zh_over_n = b.mul(b.sub(zn, ef.H_ONE), (n_inv, 0, 0, 0))
    lag = {}
    for r in sorted(set(int(r) for r in rows_nz)):
        gr = pow(g, r, bb.P)
        inv = b.inv(b.sub(zeta, (gr, 0, 0, 0)))
        lag[r] = b.mul(zh_over_n, b.mul((gr, 0, 0, 0), inv))
    out = []
    for c in range(F):
        acc = (0, 0, 0, 0)
        for r in rows_nz[cols_nz == c]:
            acc = b.axpy(acc, (int(fixed[c, r]) % bb.P, 0, 0, 0), lag[int(r)])
        out.append(acc)
    return out


def _final_poly_check(b, finals, n_layers, shift):
    """Circuit mirror of fri._final_poly_ok: interpolate the final layer
    (constant-coefficient linear maps) and force the top 3/4 of the
    coefficients to zero."""
    mf = len(finals)
    logf = mf.bit_length() - 1
    rev = bit_reverse_indices(mf)
    w = bb.two_adic_generator(logf)
    final_shift = shift
    for _ in range(n_layers):
        final_shift = final_shift * final_shift % bb.P
    m_inv = pow(mf, bb.P - 2, bb.P)
    winv = pow(w, bb.P - 2, bb.P)
    shift_inv = pow(final_shift, bb.P - 2, bb.P)
    nat = [None] * mf
    for i in range(mf):
        nat[int(rev[i])] = finals[i]
    for k in range(mf // 4, mf):
        sk = pow(shift_inv, k, bb.P)
        coeff = (0, 0, 0, 0)
        for j in range(mf):
            cjk = m_inv * pow(winv, j * k, bb.P) % bb.P * sk % bb.P
            coeff = b.axpy(coeff, (cjk, 0, 0, 0), nat[j])
        b.assert_zero(coeff)


def _query_circuit(
    b, t, proof, qi, bits, log_m, shift,
    zeta, zeta_g, gammas, c1, c2, betas, lroots, finals,
    troot, qroot, aroot, froot, fw,
):
    air = t.air
    width = air.width
    aux_w = air.aux_width
    nq4 = 4 * air.quotient_chunks
    ow = width + aux_w

    def inp(fn):
        return b.input_base(fn(proof) if proof is not None else None)

    # opened rows (witness) + their Merkle paths
    trow = [inp(lambda p, k=k: p.queries[qi]["trace_row"][k]) for k in range(width)]
    qrow = [inp(lambda p, k=k: p.queries[qi]["quot_row"][k]) for k in range(nq4)]
    arow = [inp(lambda p, k=k: p.queries[qi]["aux_row"][k]) for k in range(aux_w)]
    frow = [inp(lambda p, k=k: p.queries[qi]["fixed_row"][k]) for k in range(fw)]
    _merkle_check(
        b, _sponge_hash_row(b, trow), bits, troot,
        lambda p, lvl: p.queries[qi]["trace_path"][lvl], proof,
    )
    _merkle_check(
        b, _sponge_hash_row(b, qrow), bits, qroot,
        lambda p, lvl: p.queries[qi]["quot_path"][lvl], proof,
    )
    if aux_w:
        _merkle_check(
            b, _sponge_hash_row(b, arow), bits, aroot,
            lambda p, lvl: p.queries[qi]["aux_path"][lvl], proof,
        )
    if fw:
        _merkle_check(
            b, _sponge_hash_row(b, frow), bits, froot,
            lambda p, lvl: p.queries[qi]["fixed_path"][lvl], proof,
        )

    # DEEP composition value at the query point (zeta segment = trace ++
    # aux ++ committed-fixed; zeta*g segment = trace ++ aux)
    opened = trow + arow + frow
    s1 = (0, 0, 0, 0)
    for k in range(ow + fw):
        s1 = b.add(s1, b.mul(gammas[k], opened[k]))
    for j in range(nq4):
        s1 = b.add(s1, b.mul(gammas[2 * ow + fw + j], qrow[j]))
    s2 = (0, 0, 0, 0)
    for k in range(ow):
        s2 = b.add(s2, b.mul(gammas[ow + fw + k], opened[k]))
    # x = shift * w^bitrev(idx): product of per-bit selects
    x = (shift, 0, 0, 0)
    wgen = bb.two_adic_generator(log_m)
    for i, bit in enumerate(bits):
        wp = pow(wgen, 1 << (log_m - 1 - i), bb.P)
        x = b.mul(x, b.select(bit, (wp, 0, 0, 0), ef.H_ONE))
    inv_z = b.inv(b.sub(x, zeta))
    inv_zg = b.inv(b.sub(x, zeta_g))
    expected = b.add(
        b.mul(b.sub(s1, c1), inv_z), b.mul(b.sub(s2, c2), inv_zg)
    )

    # FRI fold walk
    half = pow(2, bb.P - 2, bb.P)
    xcur = x
    cur_bits = bits
    for l in range(len(betas)):
        pair0c = [
            inp(lambda p, c=c: p.fri_proof.query_proofs[qi][l]["pair"][0][c])
            for c in range(4)
        ]
        pair1c = [
            inp(lambda p, c=c: p.fri_proof.query_proofs[qi][l]["pair"][1][c])
            for c in range(4)
        ]
        pair0 = b.pack4(pair0c)
        pair1 = b.pack4(pair1c)
        b.assert_eq(b.select(cur_bits[0], pair1, pair0), expected)
        _merkle_check(
            b, _sponge_hash_row(b, pair0c + pair1c),
            cur_bits[1:], lroots[l],
            lambda p, lvl, l=l: p.fri_proof.query_proofs[qi][l]["path"][lvl],
            proof,
        )
        xi = b.select(cur_bits[0], b.mul((bb.P - 1, 0, 0, 0), xcur), xcur)
        inv2x = b.inv(b.mul((2, 0, 0, 0), xi))
        s = b.mul(b.add(pair0, pair1), (half, 0, 0, 0))
        d = b.mul(b.sub(pair0, pair1), inv2x)
        expected = b.add(s, b.mul(d, betas[l]))
        xcur = b.mul(xi, xi)
        cur_bits = cur_bits[1:]
    # final-layer lookup: binary mux over the remaining index bits
    vals = list(finals)
    for bit in cur_bits:
        vals = [
            b.select(bit, vals[2 * i + 1], vals[2 * i])
            for i in range(len(vals) // 2)
        ]
    assert len(vals) == 1
    b.assert_eq(vals[0], expected)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def build_recursion(
    groups: list[list[InnerTable]],
    proofs: list[list[StarkProof]] | None,
    device,
):
    """Build the aggregation circuit verifying every proof group (each
    group = one shared-transcript multi-table proof); committed fixed
    roots are computed on ``device``.  Returns (CircuitAir,
    Poseidon2CallsAir, bundle).  The build is the ``recursion.circuit``
    span."""
    with Measurement("recursion.circuit"):
        b = CircuitBuilder(with_values=proofs is not None)
        for gi, tables in enumerate(groups):
            _verify_tables_circuit(b, tables, None if proofs is None else proofs[gi], device)
        bundle = b.finalize()
    return CircuitAir(bundle.gate_fixed), Poseidon2CallsAir(bundle.call_fixed), bundle


def prove_recursion(
    groups: list[list[InnerTable]], proofs: list[list[StarkProof]], device
) -> list[StarkProof]:
    """Aggregate: one outer two-table proof, proven on ``device``,
    attesting that every inner proof verifies.  Raises if an inner proof
    is invalid (its verifier assertion fails during witness generation)."""
    cair, pair, bundle = build_recursion(groups, proofs, device)
    return prover_mod.prove_tables(
        [(cair, bundle.gate_trace, []), (pair, bundle.call_trace, [])], device
    )


def verify_recursion(
    groups: list[list[InnerTable]], outer: list[StarkProof], device
) -> bool:
    """Check an aggregated proof against the statement (the inner AIRs,
    shapes, and publics).  Rebuilds the circuit structure without any
    proof values and verifies the outer proof against it."""
    from . import verifier

    if len(outer) != 2:
        return False
    cair, pair, _ = build_recursion(groups, None, device)
    exp_ng = cair._fixed.shape[1]
    exp_np = pair._fixed.shape[1]
    if (1 << outer[0].log_n) != exp_ng or (1 << outer[1].log_n) != exp_np:
        return False
    return verifier.verify_tables([cair, pair], outer, device)
