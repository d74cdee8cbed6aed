"""STARK prover on torch tensors, on the device the caller names.

Port of raiko_tpu/stark/prover.py.  Pipeline:

  trace (n x W)
    -> column iNTT (interpolation) + coset LDE       [B5: intt, ntt_coset]
    -> row hashing + Merkle commit                    [poseidon2_hash_rows,
                                                       poseidon2_merkle]
    -> constraint evaluation over the LDE domain      [torch]
    -> quotient: coset iNTT, chunks, LDE, commit      [B5, Poseidon2]
    -> out-of-domain openings at zeta, zeta*g         [torch]
    -> DEEP composition polynomial                    [torch]
    -> FRI commit/fold (stark/fri.py)                 [torch, Poseidon2]
    -> grinding, query openings                       [host, gathers]

On a CUDA device every NTT, row hash and Merkle tree is one launch of its
kernel; on the CPU the wrappers run the kernels' plain versions.  The
quotient, OOD, DEEP and fold arithmetic are torch ops in int64 (the
reference's XLA fusions).  Field arithmetic is exact, so the reference's
log-depth modular add trees become one int64 sum and one reduction
(k·(p - 1) < 2^63 for every sum here): the bits are the same, and a proof
equals the reference's byte for byte as
``json.dumps(serde.proof_to_dict(p), sort_keys=True)``.

All committed data stays in bit-reversed coset order end to end, so no
bit-reversal gather ever materializes.  Every stage runs on one device: the
tensors' own, which ``prove``/``prove_tables`` take from the caller
(``"cuda"`` unless the caller asks for ``"cpu"``), with no fallback.
Each stage is a ``Measurement`` span (``stark.trace_commit``,
``stark.aux_commit``, ``stark.quotient``, ``stark.ood``, ``stark.deep``,
``stark.fri``, ``stark.grind_queries``) that ends after a device
synchronisation, so a listener reads the device's time with the host's;
``stark.transcript`` spans the challenge squeezes between them, where the
host hashes the transcript.  Each span is also a ``torch.profiler`` range
of the same name, so a profile attributes the kernels to their stage.

Degree budget: per-Air via ``quotient_chunks`` = max constraint degree
minus 1 (2 chunks for degree <= 3, 4 for degree <= 5; blowup 4).
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import convert
from .. import device as device_mod
from ..fields import babybear as bb
from ..fields import babybear_ext as ef
from ..ops import merkle, ntt
from ..ops import poseidon2 as p2
from ..utils.measurement import Measurement
from . import fri
from .air import Air, ConstraintBuilder, Probe
from .channel import Channel
from .domain import Domain

BLOWUP_LOG = 2
# 45 queries * 2 bits/query (rate 1/4, capacity conjecture) + 10 grind
# bits = ~100-bit conjectured query soundness
NUM_QUERIES = 45
GRIND_BITS = 10  # FRI proof-of-work (channel.grind)


@dataclass
class StarkProof:
    log_n: int
    width: int
    pow_nonce: int
    publics: list
    trace_root: list
    quotient_root: list
    trace_at_zeta: list  # W EF tuples
    trace_at_zeta_g: list  # W EF tuples
    quotient_at_zeta: list  # 4 * quotient_chunks EF tuples
    fri_proof: fri.FriProof
    queries: list  # per query: trace_row, trace_path, quot_row, quot_path
    # auxiliary segment (permutation/lookup arguments); empty when unused.
    # queries additionally carry aux_row/aux_path.
    aux_root: list = field(default_factory=list)
    aux_at_zeta: list = field(default_factory=list)
    aux_at_zeta_g: list = field(default_factory=list)
    # challenge-dependent public EF scalars (global LogUp bus contributions)
    bus: list = field(default_factory=list)
    # committed fixed segment (Air.commit_fixed): deterministic
    # preprocessed-column commitment whose root the verifier recomputes
    # from the statement; queries additionally carry fixed_row/fixed_path.
    fixed_root: list = field(default_factory=list)
    fixed_at_zeta: list = field(default_factory=list)


def _mont_const(v: int) -> int:
    return (int(v) % bb.P) * bb.R % bb.P


def _mont_tensor(vals, device) -> torch.Tensor:
    """Standard-form ints -> int64 Montgomery tensor on `device`."""
    return torch.as_tensor([_mont_const(v) for v in vals], dtype=torch.int64, device=device)


def _modsum(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Modular sum over `dim` (the reference's log-depth add tree): one
    int64 sum, exact while x.shape[dim]·(p - 1) < 2^63, and one reduction."""
    return bb._i64(x).sum(dim) % bb.P


class _ProverAlgebra:
    """Vectorized base-field constraint evaluation over the LDE domain.
    Every tensor lives on one device; values are int64 Montgomery, and
    constants are Python ints, which broadcast on any device."""

    def __init__(
        self,
        lde: torch.Tensor,
        next_perm: torch.Tensor,
        publics: torch.Tensor,
        fixed_lde: torch.Tensor | None = None,
        aux_lde: torch.Tensor | None = None,
        chal: torch.Tensor | None = None,
        bus: torch.Tensor | None = None,
    ):
        self._dev = lde.device
        self._lde = lde  # (W, m) Montgomery
        self._next = next_perm  # (m,) int64
        self._publics = publics  # (k,) Montgomery
        self._fixed = fixed_lde
        self._aux = aux_lde  # (aux_W, m) Montgomery
        self._chal = chal  # (4 * num_challenges,) Montgomery
        self._bus = bus  # (4 * num_bus_values,) Montgomery

    def _idx(self, cols) -> torch.Tensor:
        return torch.as_tensor(list(cols), dtype=torch.int64, device=self._dev)

    def local(self, c: int):
        return self._lde[c]

    def next(self, c: int):
        return self._lde[c].index_select(0, self._next)

    def fixed(self, c: int):
        return self._fixed[c]

    def aux(self, c: int):
        return self._aux[c]

    def aux_next(self, c: int):
        return self._aux[c].index_select(0, self._next)

    def challenge_coord(self, k: int):
        return self._chal[k]

    def bus_coord(self, k: int):
        return self._bus[k]

    def public(self, i: int):
        return self._publics[i]

    def constant(self, v: int):
        return _mont_const(v)

    # block access (vectorized AIRs): (k, m) tensors
    def local_block(self, cols):
        return self._lde.index_select(0, self._idx(cols))

    def next_block(self, cols):
        return self.local_block(cols).index_select(1, self._next)

    def fixed_block(self, cols):
        return self._fixed.index_select(0, self._idx(cols))

    def aux_block(self, cols):
        return self._aux.index_select(0, self._idx(cols))

    def aux_next_block(self, cols):
        return self.aux_block(cols).index_select(1, self._next)

    def public_block(self, idxs):
        return self._publics.index_select(0, self._idx(idxs))[:, None]  # (k, 1) broadcast

    def scale(self, k: int, a):
        """Small-integer scaling via Montgomery constant multiply."""
        return bb.mont_mul(a, self.constant(k))

    def bit_block_code(self, bits_block, chi4: list, key, nbytes: int) -> list:
        """Fast path for ConstraintBuilder.bit_block_code: one stacked
        weight tensor and one modular sum.

        bits_block: (8*nbytes, m); chi4: 4 scalar values; key: (m,) or
        scalar.  Returns 4 (m,)-coordinate tensors."""
        chi = torch.stack([bb._i64(c).to(self._dev).reshape(()) for c in chi4])  # (4,)
        # chi^1..chi^nbytes via doubling on growing (j, 4) tensors
        pows = chi[None, :]  # pows[i] = chi^(i+1)
        while pows.shape[0] < nbytes:
            top = pows[-1]  # chi^L
            ext = ef.ef_mul(pows, top[None, :])  # chi^(L+1) .. chi^(2L)
            pows = torch.cat([pows, ext], dim=0)
        pows = pows[:nbytes]  # (nbytes, 4) Montgomery
        scales = _mont_tensor([1 << b for b in range(8)], self._dev)
        w = bb.mont_mul(pows[:, None, :], scales[None, :, None])  # (nb, 8, 4)
        w = w.reshape(8 * nbytes, 4)
        s = _modsum(bb.mont_mul(bits_block[:, :, None], w[:, None, :]))  # (m, 4)
        out = [s[:, c] for c in range(4)]
        out[0] = bb.add(out[0], key)
        return out

    def add(self, a, b):
        return bb.add(a, b)

    def sub(self, a, b):
        return bb.sub(a, b)

    def mul(self, a, b):
        return bb.mont_mul(a, b)

    # block fast paths (ConstraintBuilder.stack_block/linmap/...) --------
    def stack(self, exprs):
        return torch.stack([bb._i64(e) for e in exprs])

    def linmap(self, mat, blk):
        """Integer linear map of block rows: one broadcast Montgomery
        multiply against the (k_out, k_in) constant matrix and one modular
        sum."""
        w = np.asarray(mat, dtype=np.uint64) % bb.P
        w_mont = torch.as_tensor(((w * bb.R) % bb.P).astype(np.int64), device=self._dev)
        return _modsum(bb.mont_mul(w_mont[:, :, None], blk[None, :, :]), 1)

    def const_vec(self, vals):
        return _mont_tensor(vals, self._dev)[:, None]

    def block_rowsum(self, blk):
        return _modsum(blk)

    def concat_rows(self, parts):
        return torch.cat([bb._i64(p) if p.dim() == 2 else bb._i64(p)[None, :] for p in parts], dim=0)


def _ef_powers_device(z: tuple, count: int, device) -> torch.Tensor:
    """(count, 4) Montgomery tensor of z^0..z^{count-1} via doubling."""
    pows = ef.to_device([ef.H_ONE, z], device)
    while pows.shape[0] < count:
        top = ef.h_pow(z, pows.shape[0])
        scaled = ef.ef_mul(pows, ef.to_device([top], device))
        pows = torch.cat([pows, scaled], dim=0)
    return pows[:count]


def _ef_dot(coeffs: torch.Tensor, zpows: torch.Tensor) -> torch.Tensor:
    """sum_i coeffs[..., i] * z^i.  coeffs: (K, n) base; zpows: (n, 4).
    Returns (K, 4) EF."""
    return _modsum(bb.mont_mul(coeffs[:, :, None], zpows[None, :, :]), 1)


def commit_cols(cols_m: torch.Tensor, shift: int) -> tuple[torch.Tensor, torch.Tensor, list[torch.Tensor]]:
    """Commit (W, n) columns in Montgomery form on their device, the
    counterpart of ``_commit_cols_local``.  Returns (coeffs (W, n),
    lde (W, n·4) in bit-reversed coset order, Merkle levels of the LDE's
    rows)."""
    coeffs = ntt.interpolate(cols_m)
    lde = ntt.lde_from_coeffs(coeffs, BLOWUP_LOG, shift)
    levels = merkle.commit(p2.hash_rows(lde.T))
    return coeffs, lde, levels


_FIXED_ROOT_CACHE: dict = {}


def fixed_commit_root(fixed: np.ndarray, shift: int, device) -> list[int]:
    """Commitment root (standard form) of a fixed-column matrix (W, n),
    uint32 standard form, committed on `device`; cached by content, since
    statements repeat."""
    fixed = np.ascontiguousarray(fixed)
    key = (hashlib.sha256(fixed.tobytes()).digest(), fixed.shape, shift)
    r = _FIXED_ROOT_CACHE.get(key)
    if r is None:
        fixed_m = bb.to_mont(convert.words_from_numpy(fixed, device))
        _, _, levels = commit_cols(fixed_m, shift)
        r = convert.bb_to_numpy(bb.from_mont(merkle.root(levels))).tolist()
        _FIXED_ROOT_CACHE[key] = r
    return r


@functools.lru_cache(maxsize=16)
def _sinv_pows(shift: int, m: int) -> np.ndarray:
    sinv = pow(shift, -1, bb.P)
    out = np.empty(m, dtype=np.uint32)
    cur = 1
    for k in range(m):
        out[k] = cur
        cur = cur * sinv % bb.P
    return bb.np_to_mont(out)


def _constraint_counts(air: Air) -> list[int]:
    b = ConstraintBuilder(Probe())
    air.eval(b)
    return [c.count for c in b.constraints]


def _inv_linear_consts(z: tuple, device):
    """Host part of 1/(x - z) for an EF scalar z, by the norm trick:
    N(x) = prod_sigma (x - sigma(z)) is a base-field quartic, so one
    vectorized base inversion and a cubic EF polynomial evaluation suffice.
    Returns (norm-poly base coeffs (5,), conj-poly EF coeffs (4, 4)) as
    Montgomery tensors on `device`."""
    conjs = []
    c = z
    for _ in range(3):
        c = ef.h_pow(c, bb.P)
        conjs.append(c)
    coeffs = [ef.H_ONE]
    for r in conjs:
        new = [ef.H_ZERO] * (len(coeffs) + 1)
        for i, cf in enumerate(coeffs):
            new[i] = ef.h_sub(new[i], ef.h_mul(cf, r))
            new[i + 1] = ef.h_add(new[i + 1], cf)
        coeffs = new
    norm = [ef.H_ZERO] * 5
    for i, cf in enumerate(coeffs):
        norm[i] = ef.h_sub(norm[i], ef.h_mul(cf, z))
        norm[i + 1] = ef.h_add(norm[i + 1], cf)
    assert all(c[1] == c[2] == c[3] == 0 for c in norm)
    return _mont_tensor([c[0] for c in norm], device), ef.to_device(coeffs, device)


def _inv_linear_dev(xs: torch.Tensor, nb: torch.Tensor, cdev: torch.Tensor) -> torch.Tensor:
    """Device part of 1/(x - z) (see _inv_linear_consts)."""
    acc = nb[4].expand(xs.shape)
    for k in range(3, -1, -1):
        acc = bb.add(bb.mont_mul(acc, xs), nb[k])
    n_inv = bb.mont_inv(acc)
    ef_acc = bb._i64(cdev[3]).expand(xs.shape + (4,))
    for k in range(2, -1, -1):
        ef_acc = ef.ef_add(bb.mont_mul(ef_acc, xs[:, None]), cdev[k][None, :])
    return bb.mont_mul(ef_acc, n_inv[:, None])


def _quotient_stage(air: Air, dom: Domain, t_lde, aux_lde, chal, bus, fixed_m, apows, sinvp, publics_dev):
    """Constraint evaluation over the LDE domain, the quotient's coset iNTT,
    its chunks' LDE and their commitment, on the LDE's device.  Returns
    (chunks (4·nq, n), chunk LDE (4·nq, m), Merkle levels).

    The reference jits this stage per AIR shape, or runs the evaluation in
    host numpy for AIRs with ``eager_quotient``; with no compile step here,
    every AIR takes this one path."""
    dev = t_lde.device
    n, m, nq = dom.n, dom.m, air.quotient_chunks
    fixed_lde = (
        ntt.lde_from_coeffs(ntt.interpolate(fixed_m), BLOWUP_LOG, dom.shift).long()
        if fixed_m is not None
        else None
    )
    next_perm = torch.as_tensor(dom.next_perm.astype(np.int64), device=dev)
    alg = _ProverAlgebra(
        t_lde.long(), next_perm, publics_dev, fixed_lde,
        aux_lde.long() if aux_lde is not None else None, chal, bus,
    )
    builder = ConstraintBuilder(alg)
    air.eval(builder)
    sels = {
        kind: torch.as_tensor(v.astype(np.int64), device=dev)
        for kind, v in (
            ("transition", dom.trans_sel),
            ("first_row", dom.first_inv),
            ("last_row", dom.last_inv),
            ("all_rows", dom.all_inv),
        )
    }
    q_ef = torch.zeros((m, 4), dtype=torch.int64, device=dev)
    for con, pd in zip(builder.constraints, apows):
        if con.count == 1:
            base_val = bb.mont_mul(con.expr, sels[con.kind])  # (m,)
            q_ef = ef.ef_add(q_ef, bb.mont_mul(pd[0][None, :], base_val[:, None]))
        else:
            blk = bb.mont_mul(con.expr, sels[con.kind][None, :])  # (k, m)
            q_ef = ef.ef_add(q_ef, _modsum(bb.mont_mul(pd[:, None, :], blk[:, :, None])))
    del builder, alg
    # chunking: intt over the coset -> unshift -> nq chunks -> LDE + commit
    q_coeffs = bb.mont_mul(ntt.intt(q_ef.T.contiguous().to(torch.int32)), sinvp)
    chunks = torch.cat([q_coeffs[:, j * n : (j + 1) * n] for j in range(nq)], dim=0)  # (4*nq, n)
    q_lde = ntt.lde_from_coeffs(chunks, BLOWUP_LOG, dom.shift)
    q_levels = merkle.commit(p2.hash_rows(q_lde.T))
    return chunks, q_lde, q_levels


def _ood_stage(t_coeffs_, chunks_, zp_, zgp_):
    return (
        _ef_dot(t_coeffs_, zp_),
        _ef_dot(t_coeffs_, zgp_),
        _ef_dot(chunks_, zp_),
    )


def _deep_stage(t_lde_, q_lde_, g1d, g2d, c1d, c2d, xs_, nbz, cdz, nbzg, cdzg):
    """The DEEP composition over the LDE domain: (m, 4) int32 Montgomery."""
    p1 = torch.cat([t_lde_, q_lde_], dim=0)
    s1 = _modsum(bb.mont_mul(g1d[:, None, :], p1[:, :, None]))
    s2 = _modsum(bb.mont_mul(g2d[:, None, :], t_lde_[:, :, None]))
    inv_z = _inv_linear_dev(xs_, nbz, cdz)
    inv_zg = _inv_linear_dev(xs_, nbzg, cdzg)
    h1 = ef.ef_mul(ef.ef_sub(s1, c1d), inv_z)
    h2 = ef.ef_mul(ef.ef_sub(s2, c2d), inv_zg)
    return ef.ef_add(h1, h2).to(torch.int32)


@contextlib.contextmanager
def _stage(title: str, dev: torch.device):
    """A stage's ``Measurement`` span, ended once the device has finished
    the stage's work, and a ``torch.profiler`` range of the same name, so
    a profile attributes the stage's kernels to it."""
    span = Measurement(title)
    with torch.profiler.record_function(title):
        yield
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    span.stop()


def _challenge_ef(channel: Channel) -> tuple:
    """Squeeze one EF challenge in a ``stark.transcript`` span: the squeeze
    first hashes every pending absorption (publics, roots, openings) with
    the host Poseidon2, which for a wide table costs as much as a stage."""
    with Measurement("stark.transcript"), torch.profiler.record_function("stark.transcript"):
        return channel.challenge_ef()


def _std_list(t: torch.Tensor) -> list[int]:
    """Montgomery tensor -> standard-form Python ints (the proof's form)."""
    return convert.bb_to_numpy(bb.from_mont(t)).tolist()


def prove(air: Air, trace: np.ndarray, publics: list[int] | None = None, device="cuda") -> StarkProof:
    """Prove one AIR execution.  trace: (n, W) uint32 standard-form."""
    return prove_tables([(air, trace, publics or [])], device)[0]


def prove_tables(
    tables: list[tuple[Air, np.ndarray, list[int]]],
    device="cuda",
) -> list[StarkProof]:
    """Prove several AIR tables in ONE Fiat-Shamir transcript with SHARED
    aux challenges and a global LogUp bus, on `device` (``"cuda"`` or
    ``"cpu"``).

    The transcript absorbs every table's preamble + publics, then every
    main-trace root, and only THEN squeezes the shared challenges — so no
    table's committed data can be chosen adaptively against the bus
    challenge.  Each table's net bus contribution (Air.bus_values) is
    absorbed and bound by that table's own constraints; verify_tables
    checks the global sum vanishes."""
    dev = device_mod.get(device)
    channel = Channel()
    channel.absorb_elems([len(tables)])
    ctxs = []
    for air, trace, publics in tables:
        publics = publics or []
        n, width = trace.shape
        log_n = n.bit_length() - 1
        assert 1 << log_n == n and width == air.width
        fixed = air.fixed_columns(n)
        committed_fixed = bool(getattr(air, "commit_fixed", False)) and fixed is not None
        channel.absorb_elems(
            [
                log_n,
                width,
                air.aux_width,
                air.num_bus_values,
                len(publics),
                int(committed_fixed),
            ]
        )
        channel.absorb_elems(publics)
        ctxs.append(
            {
                "air": air,
                "trace": trace,
                "publics": publics,
                "dom": Domain(log_n, BLOWUP_LOG),
                "log_n": log_n,
                "width": width,
                "fixed": fixed,
                "committed_fixed": committed_fixed,
            }
        )

    # 1. every table's trace LDE + commit, roots absorbed in order; a
    # committed fixed segment's (deterministic) root follows its trace root
    with _stage("stark.trace_commit", dev):
        for c in ctxs:
            trace_m = bb.to_mont(convert.words_from_numpy(c["trace"].T, dev))  # (W, n)
            c["t_coeffs"], c["t_lde"], c["t_levels"] = commit_cols(trace_m, c["dom"].shift)
            c["t_root"] = merkle.root(c["t_levels"])
            channel.absorb_digest(c["t_root"])
            c["fixed_m"] = (
                bb.to_mont(convert.words_from_numpy(c["fixed"], dev)) if c["fixed"] is not None else None
            )
            c["f_coeffs"] = c["f_lde"] = c["f_levels"] = None
            c["fixed_root_std"] = []
            if c["committed_fixed"]:
                c["f_coeffs"], c["f_lde"], c["f_levels"] = commit_cols(c["fixed_m"], c["dom"].shift)
                f_root = merkle.root(c["f_levels"])
                channel.absorb_digest(f_root)
                c["fixed_root_std"] = _std_list(f_root)

    # 2. shared challenges (AFTER all trace roots), then aux commitments
    nchal = max((c["air"].num_aux_challenges for c in ctxs), default=0)
    challenges = [_challenge_ef(channel) for _ in range(nchal)]
    for c in ctxs:
        air = c["air"]
        c["a_coeffs"] = c["a_lde"] = c["a_levels"] = None
        c["chal_dev"] = None
        c["aux_root_std"] = []
        if air.aux_width:
            with _stage("stark.aux_commit", dev):
                chal_t = challenges[: air.num_aux_challenges]
                aux = air.aux_trace(c["trace"], chal_t)
                assert aux.shape == (c["trace"].shape[0], air.aux_width)
                aux_m = bb.to_mont(convert.words_from_numpy(aux.T, dev))
                c["a_coeffs"], c["a_lde"], c["a_levels"] = commit_cols(aux_m, c["dom"].shift)
                a_root = merkle.root(c["a_levels"])
                channel.absorb_digest(a_root)
                c["aux_root_std"] = _std_list(a_root)
                c["chal_dev"] = _mont_tensor([x for ch in chal_t for x in ch], dev)

    # 3. bus values (challenge-dependent public EF scalars), absorbed
    for c in ctxs:
        air = c["air"]
        c["bus"] = []
        if air.num_bus_values:
            chal_t = challenges[: air.num_aux_challenges]
            c["bus"] = [tuple(v) for v in air.bus_values(c["trace"], chal_t)]
            assert len(c["bus"]) == air.num_bus_values
            for v in c["bus"]:
                channel.absorb_ef(v)

    # 4+. per-table quotient / OOD / DEEP / FRI / queries on the shared
    # channel, in table order
    return [_finish_table(c, channel, dev) for c in ctxs]


def _finish_table(c: dict, channel: Channel, dev: torch.device) -> StarkProof:
    air = c["air"]
    dom = c["dom"]
    publics = c["publics"]
    log_n, width = c["log_n"], c["width"]
    m = dom.m
    aux_w = air.aux_width
    t_coeffs, t_lde, t_levels, t_root = c["t_coeffs"], c["t_lde"], c["t_levels"], c["t_root"]
    a_coeffs, a_lde, a_levels = c["a_coeffs"], c["a_lde"], c["a_levels"]
    bus = c["bus"]
    bus_dev = _mont_tensor([x for v in bus for x in v], dev) if bus else None

    committed_fixed = c["committed_fixed"]
    f_coeffs, f_lde = c["f_coeffs"], c["f_lde"]
    fw = c["fixed"].shape[0] if committed_fixed else 0

    # 2+3. constraint evaluation + quotient + chunk commit (one stage)
    alpha = _challenge_ef(channel)
    counts = _constraint_counts(air)
    apows = []
    apow = ef.H_ONE
    for count in counts:
        pows = []
        for _ in range(count):
            pows.append(apow)
            apow = ef.h_mul(apow, alpha)
        apows.append(ef.to_device(pows, dev))
    nq = air.quotient_chunks
    sinvp = torch.as_tensor(_sinv_pows(dom.shift, m).astype(np.int32), device=dev)
    publics_dev = _mont_tensor(publics, dev)

    with _stage("stark.quotient", dev):
        chunks, q_lde, q_levels = _quotient_stage(
            air, dom, t_lde, a_lde, c["chal_dev"], bus_dev, c["fixed_m"], apows, sinvp, publics_dev
        )
        q_root = merkle.root(q_levels)
        channel.absorb_digest(q_root)

    # 4. out-of-domain openings (one stage)
    zeta = _challenge_ef(channel)
    zeta_g = ef.h_mul(zeta, ef.h_from_base(dom.g))
    with _stage("stark.ood", dev):
        zp = _ef_powers_device(zeta, dom.n, dev)
        zgp = _ef_powers_device(zeta_g, dom.n, dev)
        o_coeffs = torch.cat([t_coeffs, a_coeffs], dim=0) if aux_w else t_coeffs
        tz, tzg, qz = _ood_stage(o_coeffs, chunks, zp, zgp)
        opened_at_zeta = ef.from_device(tz)
        opened_at_zeta_g = ef.from_device(tzg)
        quotient_at_zeta = ef.from_device(qz)
        fixed_at_zeta = ef.from_device(_ef_dot(f_coeffs, zp)) if committed_fixed else []
        trace_at_zeta, aux_at_zeta = opened_at_zeta[:width], opened_at_zeta[width:]
        trace_at_zeta_g, aux_at_zeta_g = opened_at_zeta_g[:width], opened_at_zeta_g[width:]
    for v in opened_at_zeta + opened_at_zeta_g + quotient_at_zeta + fixed_at_zeta:
        channel.absorb_ef(v)

    # 5. DEEP composition (one stage).  The opened segment at zeta =
    # trace ++ aux ++ committed-fixed; at zeta*g = trace ++ aux.
    gamma = _challenge_ef(channel)
    with _stage("stark.deep", dev):
        nq4 = 4 * nq
        ow = width + aux_w
        n_open = 2 * ow + fw + nq4
        gammas = [ef.H_ONE]
        for _ in range(n_open - 1):
            gammas.append(ef.h_mul(gammas[-1], gamma))
        g1 = [gammas[k] for k in range(ow + fw)] + [gammas[2 * ow + fw + j] for j in range(nq4)]
        g2 = [gammas[ow + fw + k] for k in range(ow)]
        c1 = ef.H_ZERO
        for g, v in zip(g1, opened_at_zeta + fixed_at_zeta + quotient_at_zeta):
            c1 = ef.h_add(c1, ef.h_mul(g, v))
        c2 = ef.H_ZERO
        for g, v in zip(g2, opened_at_zeta_g):
            c2 = ef.h_add(c2, ef.h_mul(g, v))
        nb_z, cdev_z = _inv_linear_consts(zeta, dev)
        nb_zg, cdev_zg = _inv_linear_consts(zeta_g, dev)
        xs = torch.as_tensor(dom.xs_mont.astype(np.int64), device=dev)

        o_lde = torch.cat([t_lde, a_lde], dim=0) if aux_w else t_lde
        extra_lde = torch.cat([f_lde, q_lde], dim=0) if committed_fixed else q_lde
        h = _deep_stage(
            o_lde,
            extra_lde,
            ef.to_device(g1, dev),
            ef.to_device(g2, dev),
            ef.to_device([c1], dev)[0],
            ef.to_device([c2], dev)[0],
            xs,
            nb_z,
            cdev_z,
            nb_zg,
            cdev_zg,
        )

    # 6. FRI
    with _stage("stark.fri", dev):
        layers, roots_dev, final_values = fri.commit(h, log_n + BLOWUP_LOG, dom.shift, channel)
        layer_roots = [_std_list(r) for r in roots_dev]

    # 7. grinding + queries (one gather and one transfer per segment)
    with _stage("stark.grind_queries", dev):
        pow_nonce = channel.grind(GRIND_BITS)
        indices = channel.challenge_indices(NUM_QUERIES, m)
        idx_dev = torch.as_tensor(indices, dtype=torch.int64, device=dev)

        def rows_at(lde: torch.Tensor) -> np.ndarray:
            return convert.bb_to_numpy(bb.from_mont(lde.index_select(1, idx_dev).T))

        t_sel = rows_at(t_lde)
        q_sel = rows_at(q_lde)
        t_paths = merkle.open_paths(t_levels, indices)
        q_paths = merkle.open_paths(q_levels, indices)
        if aux_w:
            a_sel = rows_at(a_lde)
            a_paths = merkle.open_paths(a_levels, indices)
        if committed_fixed:
            f_sel = rows_at(f_lde)
            f_paths = merkle.open_paths(c["f_levels"], indices)
        queries = []
        for qi in range(len(indices)):
            q = {
                "trace_row": t_sel[qi].tolist(),
                "trace_path": [p.tolist() for p in t_paths[qi]],
                "quot_row": q_sel[qi].tolist(),
                "quot_path": [p.tolist() for p in q_paths[qi]],
            }
            if aux_w:
                q["aux_row"] = a_sel[qi].tolist()
                q["aux_path"] = [p.tolist() for p in a_paths[qi]]
            if committed_fixed:
                q["fixed_row"] = f_sel[qi].tolist()
                q["fixed_path"] = [p.tolist() for p in f_paths[qi]]
            queries.append(q)
        fri_proof = fri.FriProof(
            layer_roots=layer_roots,
            final_values=final_values,
            query_proofs=fri.open_queries(layers, indices),
        )
    return StarkProof(
        log_n=log_n,
        width=width,
        pow_nonce=pow_nonce,
        publics=publics,
        trace_root=_std_list(t_root),
        quotient_root=_std_list(q_root),
        trace_at_zeta=trace_at_zeta,
        trace_at_zeta_g=trace_at_zeta_g,
        quotient_at_zeta=quotient_at_zeta,
        fri_proof=fri_proof,
        queries=queries,
        aux_root=c["aux_root_std"],
        aux_at_zeta=aux_at_zeta,
        aux_at_zeta_g=aux_at_zeta_g,
        bus=bus,
        fixed_root=c["fixed_root_std"],
        fixed_at_zeta=fixed_at_zeta,
    )
