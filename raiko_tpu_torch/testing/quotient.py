"""One table's quotient numerator, by each of its three routes.

``numerator_case`` builds what the prover hands the numerator for a table
(its trace's LDE, its aux segment and bus values under seeded challenges,
its fixed columns' LDE, a seeded alpha) on a device, so the tests,
``chip_smoke.py`` and ``tools/time_quotient.py`` can hold Q1
(``ops/quotient_cuda.py``) against the tape's plain version and the
op-by-op evaluation on the same inputs.

The op-by-op evaluation (``ProverAlgebra``, ``numerator_op_by_op``) is the
reference's route, ``air.eval`` over tensors, one torch op per algebra
call: independent of the tape, it is what the tape is held to.  The
prover itself takes the tape on every device.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from .. import convert
from .. import device as device_mod
from ..fields import babybear as bb
from ..ops import ntt, quotient_cuda
from ..fields import babybear_ext as ef
from ..stark import prover, quotient_tape
from ..stark.air import Air, ConstraintBuilder
from ..stark.domain import Domain


@dataclass
class NumeratorCase:
    air: Air
    dom: Domain
    t_lde: torch.Tensor
    aux_lde: torch.Tensor | None
    fixed_lde: torch.Tensor | None
    publics: list
    chal: list
    bus: list
    alpha: tuple

    def tape(self) -> quotient_tape.Tape:
        return quotient_tape.tape_for(self.air, self.dom.log_n, self.dom.m, self.fixed_lde is not None)

    def _args(self) -> tuple:
        next_perm, sels = prover._domain_tensors(self.dom.log_n, self.t_lde.device)
        return (self.t_lde, self.aux_lde, self.fixed_lde, next_perm, self.publics, self.chal, self.bus), sels

    def _tape_args(self, tape: quotient_tape.Tape | None = None) -> tuple:
        tape = tape or self.tape()
        cols, sels = self._args()
        return (tape, *cols, _alpha_powers(self.alpha, tape.rows, self.t_lde.device), sels)

    def kernel(self, tape: quotient_tape.Tape | None = None) -> torch.Tensor:
        """Q1 on a CUDA case (its plain version on a CPU one), over the
        AIR's cached tape or `tape` (another recording of it)."""
        return quotient_cuda.quotient_numerator(*self._tape_args(tape))

    def launches(self, tape: quotient_tape.Tape | None = None):
        """Q1's launches alone on a CUDA case, its host half done once
        (``quotient_cuda.prepare``)."""
        return quotient_cuda.prepare(*self._tape_args(tape))

    def plain(self, tape: quotient_tape.Tape | None = None, reverse_steps: bool = False) -> torch.Tensor:
        """The tape's plain version over the AIR's cached tape or `tape`,
        each step's instructions walked in reverse where asked."""
        return quotient_tape.quotient_numerator_plain(*self._tape_args(tape), reverse_steps=reverse_steps)

    def op_by_op(self) -> torch.Tensor:
        cols, sels = self._args()
        return numerator_op_by_op(self.air, *cols, self.alpha, sels)


@functools.lru_cache(maxsize=8)
def _alpha_powers(alpha: tuple, rows: int, device: torch.device) -> torch.Tensor:
    """The prover's alpha powers, made once per case and tape size."""
    return prover._alpha_powers(alpha, rows, device)


def numerator_case(air: Air, trace: np.ndarray, publics, device, seed: int = 0) -> NumeratorCase:
    """The numerator's inputs for `air`'s table `trace` (n, W) on `device`,
    its challenges and alpha drawn from `seed`."""
    dev = device_mod.get(device)
    rng = np.random.default_rng(seed)
    n = trace.shape[0]
    dom = Domain(n.bit_length() - 1, prover.BLOWUP_LOG)

    def lde(cols: np.ndarray) -> torch.Tensor:
        m = bb.to_mont(convert.words_from_numpy(np.ascontiguousarray(cols), dev))
        return ntt.lde_from_coeffs(ntt.interpolate(m), prover.BLOWUP_LOG, dom.shift)

    challenges = [tuple(int(v) for v in rng.integers(1, bb.P, 4)) for _ in range(air.num_aux_challenges)]
    aux_lde = lde(air.aux_trace(trace, challenges).T) if air.aux_width else None
    bus = [x for v in air.bus_values(trace, challenges) for x in v] if air.num_bus_values else []
    fixed = air.fixed_columns(n)
    return NumeratorCase(
        air=air, dom=dom, t_lde=lde(trace.T), aux_lde=aux_lde, fixed_lde=lde(fixed) if fixed is not None else None,
        publics=[int(v) for v in publics], chal=[x for ch in challenges for x in ch] if air.aux_width else [],
        bus=bus, alpha=tuple(int(v) for v in rng.integers(1, bb.P, 4)),
    )


class ProverAlgebra:
    """Vectorized base-field constraint evaluation over the LDE domain, one
    torch op per algebra call (the reference's ``_ProverAlgebra``).  Every
    tensor lives on one device; values are int64 Montgomery, and constants
    are Python ints, which broadcast on any device."""

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
        return prover._mont_const(v)

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
        scales = prover._mont_tensor([1 << b for b in range(8)], self._dev)
        w = bb.mont_mul(pows[:, None, :], scales[None, :, None])  # (nb, 8, 4)
        w = w.reshape(8 * nbytes, 4)
        s = prover._modsum(bb.mont_mul(bits_block[:, :, None], w[:, None, :]))  # (m, 4)
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
        return prover._modsum(bb.mont_mul(w_mont[:, :, None], blk[None, :, :]), 1)

    def const_vec(self, vals):
        return prover._mont_tensor(vals, self._dev)[:, None]

    def block_rowsum(self, blk):
        return prover._modsum(blk)

    def concat_rows(self, parts):
        return torch.cat([bb._i64(p) if p.dim() == 2 else bb._i64(p)[None, :] for p in parts], dim=0)




def numerator_op_by_op(air: Air, t_lde, aux_lde, fixed_lde, next_perm, publics, chal, bus, alpha,
                       sels) -> torch.Tensor:
    """The (m, 4) quotient numerator sum_i alpha^i · c_i · sel_kind(i) by
    ``air.eval`` over ``ProverAlgebra``: one torch op per algebra call.
    publics, chal, bus: standard-form ints (chal and bus flat)."""
    dev = t_lde.device
    m = t_lde.shape[1]
    alg = ProverAlgebra(
        t_lde.long(), next_perm, prover._mont_tensor(publics, dev), fixed_lde.long() if fixed_lde is not None else None,
        aux_lde.long() if aux_lde is not None else None, prover._mont_tensor(chal, dev) if chal else None,
        prover._mont_tensor(bus, dev) if bus else None,
    )
    builder = ConstraintBuilder(alg)
    air.eval(builder)
    counts = [con.count for con in builder.constraints]
    apows = prover._alpha_powers(alpha, sum(counts), dev)
    sel = {kind: sels[k].long() for k, kind in enumerate(quotient_tape.KINDS)}
    q_ef = torch.zeros((m, 4), dtype=torch.int64, device=dev)
    off = 0
    for con, count in zip(builder.constraints, counts):
        pd = apows[off : off + count]
        off += count
        if count == 1:
            base_val = bb.mont_mul(con.expr, sel[con.kind])  # (m,)
            q_ef = ef.ef_add(q_ef, bb.mont_mul(pd[0][None, :], base_val[:, None]))
        else:
            blk = bb.mont_mul(con.expr, sel[con.kind][None, :])  # (k, m)
            q_ef = ef.ef_add(q_ef, prover._modsum(bb.mont_mul(pd[:, None, :], blk[:, :, None])))
    return q_ef
