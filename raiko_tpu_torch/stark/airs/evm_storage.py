"""EvmStorageAir — the storage journal for SLOAD/SSTORE coverage.

Statement: given the PUBLIC per-slot groups [(slot, original, count,
prewarm, final)] (sorted by slot, published in the frame payload), every
storage access the CPU claims happened is consistent.  The `original`
and `final` publics are what the pre-state binding chains on
(provers/tpu_stark.py prestate slot): original_k+1 == final_k across
frames touching the same (address, slot), and the first original ==
the value proven in the parent state trie.  Consistency here means:

- accesses at one slot form one contiguous group, clk-ordered (strictly
  increasing, 22-bit diff witness);
- a read returns the previous access's value, or the ORIGINAL on the
  group's first access;
- the first access is cold unless the group is pre-warmed (fixed
  column, from the tx access list);
- SSTORE's EIP-2200 gas case flags are enforced from reality: g1/g2
  (clean nonzero / clean zero write) are recomputed via two 16-limb
  nonzero gadgets ([new != current] and [current != original]) and the
  fixed original-is-zero flag;
- the group's LAST access carries the public `final` value (reads echo
  the current value, so the last row's value is the end-of-frame value
  for every access kind).

The CPU sends one tuple per SLOAD/SSTORE on the storage channel
(evm_air.CHAL_ST / BUS_STOR):

    4*clk + iw*chi + cold*chi^2 + g1*chi^3 + g2*chi^4
        + sum_j slot_byte_j * chi^{j+5} + sum_j value_byte_j * chi^{j+37}

and this table receives each exactly once — so the CPU's witness
cold/g1/g2 bits (which price the gas) must equal the journal's truth.

Reference analog: revm's journaled sload/sstore inside the zkVM guests
(SURVEY.md §3.5); same multi-table "interactions" composition as the
other EVM tables.
"""

from __future__ import annotations

import numpy as np

from ...fields import babybear as bb
from ...fields import babybear_ext as ef
from ..air import Air, ConstraintBuilder
from .evm_air import (
    BUS_STOR,
    CHAL_CHI,
    CHAL_ST,
    NUM_BUS,
    NUM_CHALLENGES,
    _np_chi_pows,
    _np_tuple_code,
    _pow2_atleast,
    _word_bits,
)

_PU = np.uint64(bb.P)

# witness columns
ST_CLKB = 0  # 22 clk4 bits
ST_DB = 22  # 22 strictly-increasing clk diff bits
ST_IW = 44
ST_G1 = 45
ST_G2 = 46
ST_GCW = 47  # t1 * (1 - t2): clean-write indicator
ST_V0 = 48  # 256 value bits
ST_NZ1 = ST_V0 + 256  # gadget 1: [new != current]
ST_IV1 = ST_NZ1 + 16
ST_S1INV = ST_IV1 + 16
ST_T1 = ST_S1INV + 1
ST_NZ2 = ST_T1 + 1  # gadget 2: [current != original]
ST_IV2 = ST_NZ2 + 16
ST_S2INV = ST_IV2 + 16
ST_T2 = ST_S2INV + 1
ST_WIDTH = ST_T2 + 1

# fixed columns (public group layout)
SF_ACTIVE = 0
SF_FIRST = 1
SF_SA = 2  # same group as previous row
SF_SA_N = 3  # SA of the NEXT row (fixed cols have no next view)
SF_COLD = 4  # first * (1 - prewarm)
SF_EZO = 5  # original == 0
SF_LAST = 6  # last access of its group
SF_SLOT0 = 7  # 32 little-endian slot bytes
SF_ORIG0 = SF_SLOT0 + 32  # 32 little-endian original bytes
SF_FIN0 = SF_ORIG0 + 32  # 32 little-endian final-value bytes
ST_NFIXED = SF_FIN0 + 32

# limb i = byte_{2i} + 256*byte_{2i+1}
_V_LIMB_MAT = [[0] * 256 for _ in range(16)]
for _i in range(16):
    for _b in range(16):
        _V_LIMB_MAT[_i][16 * _i + _b] = 1 << _b


def _nz_witness_limbs(diff_limbs: list[int]):
    nz, inv = [], []
    for x in diff_limbs:
        x %= bb.P
        if x == 0:
            nz.append(0)
            inv.append(0)
        else:
            nz.append(1)
            inv.append(pow(x, bb.P - 2, bb.P))
    s = sum(nz)
    sinv = pow(s, bb.P - 2, bb.P) if s else 0
    return nz, inv, sinv, 1 if s else 0


class EvmStorageAir(Air):
    """One row per storage access, grouped by slot in sorted order."""

    width = ST_WIDTH
    aux_width = 4
    num_aux_challenges = NUM_CHALLENGES
    num_bus_values = NUM_BUS
    quotient_chunks = 2
    commit_fixed = True
    eager_quotient = True

    def __init__(
        self, groups: list[tuple[int, int, int, int, int]], fid: int = 0
    ):
        """groups: PUBLIC (slot, original, count, prewarm, final),
        slot-sorted."""
        self.fid = int(fid)
        assert groups
        prev = -1
        total = 0
        for slot, orig, count, prewarm, final in groups:
            assert 0 <= slot < (1 << 256) and 0 <= orig < (1 << 256)
            assert 0 <= final < (1 << 256)
            assert slot > prev, "groups must be strictly slot-sorted"
            assert count >= 1 and prewarm in (0, 1)
            prev = slot
            total += count
        self.groups = [
            (int(s), int(o), int(c), int(w), int(f))
            for s, o, c, w, f in groups
        ]
        self.total = total
        self.n = _pow2_atleast(total + 1)

    def structure_key(self) -> tuple:
        return ()

    def _layout(self):
        out = []
        for g, (slot, orig, count, prewarm, final) in enumerate(self.groups):
            for k in range(count):
                out.append((g, k == 0, k == count - 1))
        return out

    def fixed_columns(self, n: int):
        assert n == self.n
        cols = np.zeros((ST_NFIXED, n), dtype=np.uint32)
        layout = self._layout()
        for r, (g, first, last) in enumerate(layout):
            slot, orig, count, prewarm, final = self.groups[g]
            cols[SF_ACTIVE, r] = 1
            cols[SF_FIRST, r] = int(first)
            cols[SF_SA, r] = int(not first)
            cols[SF_COLD, r] = int(first and not prewarm)
            cols[SF_EZO, r] = int(orig == 0)
            cols[SF_LAST, r] = int(last)
            for j in range(32):
                cols[SF_SLOT0 + j, r] = (slot >> (8 * j)) & 0xFF
                cols[SF_ORIG0 + j, r] = (orig >> (8 * j)) & 0xFF
                cols[SF_FIN0 + j, r] = (final >> (8 * j)) & 0xFF
        for r in range(n - 1):
            if r + 1 < len(layout) and not layout[r + 1][1]:
                cols[SF_SA_N, r] = 1
        return cols

    def trace(self, accesses: list[tuple]) -> np.ndarray:
        """accesses: (slot, clk4, iw, value, cold, g1, g2), any order."""
        assert len(accesses) == self.total
        acc = sorted(accesses, key=lambda a: (a[0], a[1]))
        tr = np.zeros((self.n, ST_WIDTH), dtype=np.uint32)
        origs = {slot: orig for slot, orig, _, _, _ in self.groups}
        prev_slot = None
        prev_clk = None
        prev_val = None
        for r, (slot, clk4, iw, value, cold, g1, g2) in enumerate(acc):
            first = slot != prev_slot
            assert 0 <= clk4 < (1 << 22)
            for i in range(22):
                tr[r, ST_CLKB + i] = (clk4 >> i) & 1
            d = 0 if first else clk4 - prev_clk - 1
            assert 0 <= d < (1 << 22)
            for i in range(22):
                tr[r, ST_DB + i] = (d >> i) & 1
            tr[r, ST_IW] = iw
            tr[r, ST_G1] = g1
            tr[r, ST_G2] = g2
            tr[r, ST_V0 : ST_V0 + 256] = _word_bits(value)
            cur = origs[slot] if first else prev_val
            d1 = [
                ((value >> (16 * i)) & 0xFFFF) - ((cur >> (16 * i)) & 0xFFFF)
                for i in range(16)
            ]
            nz1, iv1, s1, t1 = _nz_witness_limbs(d1)
            d2 = [
                ((cur >> (16 * i)) & 0xFFFF)
                - ((origs[slot] >> (16 * i)) & 0xFFFF)
                for i in range(16)
            ]
            nz2, iv2, s2, t2 = _nz_witness_limbs(d2)
            for i in range(16):
                tr[r, ST_NZ1 + i] = nz1[i]
                tr[r, ST_IV1 + i] = iv1[i]
                tr[r, ST_NZ2 + i] = nz2[i]
                tr[r, ST_IV2 + i] = iv2[i]
            tr[r, ST_S1INV] = s1
            tr[r, ST_T1] = t1
            tr[r, ST_S2INV] = s2
            tr[r, ST_T2] = t2
            tr[r, ST_GCW] = t1 * (1 - t2)
            prev_slot, prev_clk, prev_val = slot, clk4, value
        return tr

    # ---------------- host-side channel terms ----------------
    def _terms(self, trace: np.ndarray, challenges) -> np.ndarray:
        from .evm_air import fid_challenges

        challenges = fid_challenges(challenges, self.fid)
        chi = challenges[CHAL_CHI]
        gamma_st = challenges[CHAL_ST]
        pows = _np_chi_pows(chi, 68)
        n = trace.shape[0]
        t = trace.astype(np.uint64)
        fx = self.fixed_columns(n).astype(np.uint64)
        clk4 = sum(t[:, ST_CLKB + i] << np.uint64(i) for i in range(22))
        vbytes = np.zeros((n, 32), dtype=np.uint64)
        for j in range(32):
            vbytes[:, j] = sum(
                t[:, ST_V0 + 8 * j + bit] << np.uint64(bit) for bit in range(8)
            )
        code = _np_tuple_code(
            clk4,
            [
                (t[:, ST_IW], 1),
                (fx[SF_COLD], 2),
                (t[:, ST_G1], 3),
                (t[:, ST_G2], 4),
            ]
            + [(fx[SF_SLOT0 + j], j + 5) for j in range(32)]
            + [(vbytes[:, j], j + 37) for j in range(32)],
            pows,
        )
        gst = np.array([x % bb.P for x in gamma_st], dtype=np.uint64)
        inv = ef.npef_inv(ef.npef_sub(gst[None, :], code))
        active = np.zeros(n, dtype=np.uint64)
        active[: self.total] = _PU - np.uint64(1)  # receive: -1
        return ef.npef_mul(ef.npef_from_base(active), inv)

    def aux_trace(self, trace: np.ndarray, challenges) -> np.ndarray:
        aux = np.zeros((trace.shape[0], 4), dtype=np.uint32)
        c = np.cumsum(self._terms(trace, challenges), axis=0) % _PU
        aux[:] = ef.npef_sub(c, self._terms(trace, challenges))
        return aux

    def bus_values(self, trace: np.ndarray, challenges) -> list[tuple]:
        terms = self._terms(trace, challenges)
        out = [ef.H_ZERO] * NUM_BUS
        out[BUS_STOR] = tuple(int(v) for v in terms.sum(axis=0) % _PU)
        return out

    # ---------------- constraints ----------------
    def eval(self, b: ConstraintBuilder) -> None:  # noqa: C901
        from .evm_air import fid_gamma

        one = b.constant(1)
        chi = b.challenge_ef(CHAL_CHI)
        g_st = fid_gamma(b, chi, b.challenge_ef(CHAL_ST), b.public(0))
        active = b.fixed(SF_ACTIVE)
        first = b.fixed(SF_FIRST)
        sa_n = b.fixed(SF_SA_N)
        cold = b.fixed(SF_COLD)
        ezo = b.fixed(SF_EZO)
        lastg = b.fixed(SF_LAST)

        iw = b.local(ST_IW)
        iw_n = b.next(ST_IW)
        g1 = b.local(ST_G1)
        g2 = b.local(ST_G2)
        gcw = b.local(ST_GCW)
        t1 = b.local(ST_T1)
        t2 = b.local(ST_T2)
        s1inv = b.local(ST_S1INV)
        s2inv = b.local(ST_S2INV)

        def val(nx: bool, base: int, nbits: int):
            g = b.next if nx else b.local
            acc = None
            for i in range(nbits):
                e = b.scale(1 << i, g(base + i))
                acc = e if acc is None else b.add(acc, e)
            return acc

        clk4 = val(False, ST_CLKB, 22)
        clk4_n = val(True, ST_CLKB, 22)
        d_n = val(True, ST_DB, 22)

        # booleanity (inverse and sum-inverse columns are raw)
        bit_cols = (
            list(range(ST_CLKB, ST_CLKB + 22))
            + list(range(ST_DB, ST_DB + 22))
            + [ST_IW, ST_G1, ST_G2, ST_GCW]
            + list(range(ST_V0, ST_V0 + 256))
            + list(range(ST_NZ1, ST_NZ1 + 16))
            + [ST_T1]
            + list(range(ST_NZ2, ST_NZ2 + 16))
            + [ST_T2]
        )
        bits = b.local_block(bit_cols)
        b.all_rows_block(b.mul(bits, b.sub(bits, one)), len(bit_cols))
        b.all_rows(b.mul(b.sub(one, active), iw))

        # clk strictly increases within a group
        b.transition(
            b.mul(sa_n, b.sub(d_n, b.sub(b.sub(clk4_n, clk4), one)))
        )

        vblk = b.local_block(range(ST_V0, ST_V0 + 256))
        vblk_n = b.next_block(range(ST_V0, ST_V0 + 256))
        vlimb = b.linmap(_V_LIMB_MAT, vblk)
        olimb = [
            b.add(
                b.fixed(SF_ORIG0 + 2 * i),
                b.scale(256, b.fixed(SF_ORIG0 + 2 * i + 1)),
            )
            for i in range(16)
        ]

        # reads return the current value
        for i in range(16):
            b.all_rows(
                b.mul(
                    b.mul(first, b.sub(one, iw)), b.sub(vlimb[i], olimb[i])
                )
            )
        # the group's last access carries the public final value (the
        # cross-frame chaining anchor for the pre-state binding)
        flimb = [
            b.add(
                b.fixed(SF_FIN0 + 2 * i),
                b.scale(256, b.fixed(SF_FIN0 + 2 * i + 1)),
            )
            for i in range(16)
        ]
        for i in range(16):
            b.all_rows(b.mul(lastg, b.sub(vlimb[i], flimb[i])))
        b.transition_block(
            b.mul(b.mul(sa_n, b.sub(one, iw_n)), b.sub(vblk_n, vblk)), 256
        )

        # gadget 1: t1 = [value != current]
        nz1 = [b.local(ST_NZ1 + i) for i in range(16)]
        iv1 = [b.local(ST_IV1 + i) for i in range(16)]
        nz1_n = [b.next(ST_NZ1 + i) for i in range(16)]
        iv1_n = [b.next(ST_IV1 + i) for i in range(16)]
        vlimb_n = b.linmap(_V_LIMB_MAT, vblk_n)
        for i in range(16):
            inp_f = b.sub(vlimb[i], olimb[i])
            b.all_rows(b.mul(first, b.sub(nz1[i], b.mul(inp_f, iv1[i]))))
            b.all_rows(b.mul(first, b.mul(inp_f, b.sub(one, nz1[i]))))
            inp_s = b.sub(vlimb_n[i], vlimb[i])
            b.transition(b.mul(sa_n, b.sub(nz1_n[i], b.mul(inp_s, iv1_n[i]))))
            b.transition(b.mul(sa_n, b.mul(inp_s, b.sub(one, nz1_n[i]))))
        s1 = nz1[0]
        for i in range(1, 16):
            s1 = b.add(s1, nz1[i])
        b.all_rows(b.mul(active, b.sub(t1, b.mul(s1, s1inv))))
        b.all_rows(b.mul(active, b.mul(s1, b.sub(one, t1))))

        # gadget 2: t2 = [current != original]
        nz2 = [b.local(ST_NZ2 + i) for i in range(16)]
        iv2 = [b.local(ST_IV2 + i) for i in range(16)]
        nz2_n = [b.next(ST_NZ2 + i) for i in range(16)]
        iv2_n = [b.next(ST_IV2 + i) for i in range(16)]
        for i in range(16):
            b.all_rows(b.mul(first, nz2[i]))
            inp_s = b.sub(vlimb[i], olimb[i])  # previous row's value
            b.transition(b.mul(sa_n, b.sub(nz2_n[i], b.mul(inp_s, iv2_n[i]))))
            b.transition(b.mul(sa_n, b.mul(inp_s, b.sub(one, nz2_n[i]))))
        s2 = nz2[0]
        for i in range(1, 16):
            s2 = b.add(s2, nz2[i])
        b.all_rows(b.mul(active, b.sub(t2, b.mul(s2, s2inv))))
        b.all_rows(b.mul(active, b.mul(s2, b.sub(one, t2))))

        # gas-case flags (writes only; reads carry zeros)
        b.all_rows(b.sub(gcw, b.mul(t1, b.sub(one, t2))))
        b.all_rows(b.mul(iw, b.sub(g1, b.sub(gcw, b.mul(gcw, ezo)))))
        b.all_rows(b.mul(iw, b.sub(g2, b.mul(gcw, ezo))))
        b.all_rows(b.mul(b.sub(one, iw), g1))
        b.all_rows(b.mul(b.sub(one, iw), g2))

        # receive channel
        slotcode = b.ef_from_base4(b.constant(0))
        pw = list(chi)
        for j in range(32):
            sb = b.fixed(SF_SLOT0 + j)
            slotcode = b.ef_add4(slotcode, [b.mul(sb, pw[c]) for c in range(4)])
            if j < 31:
                pw = b.ef_mul4(pw, chi)
        vcode = b.bit_block_code(vblk, chi, b.constant(0), 32)
        chi2 = b.ef_mul4(chi, chi)
        chi3 = b.ef_mul4(chi2, chi)
        chi4 = b.ef_mul4(chi2, chi2)
        chi8 = b.ef_mul4(chi4, chi4)
        chi16 = b.ef_mul4(chi8, chi8)
        chi32 = b.ef_mul4(chi16, chi16)
        chi36 = b.ef_mul4(chi32, chi4)
        code = b.ef_from_base4(clk4)
        code = b.ef_add4(code, [b.mul(iw, chi[c]) for c in range(4)])
        code = b.ef_add4(code, [b.mul(cold, chi2[c]) for c in range(4)])
        code = b.ef_add4(code, [b.mul(g1, chi3[c]) for c in range(4)])
        code = b.ef_add4(code, [b.mul(g2, chi4[c]) for c in range(4)])
        code = b.ef_add4(code, b.ef_mul4(chi4, slotcode))
        code = b.ef_add4(code, b.ef_mul4(chi36, vcode))
        acc = [b.aux(c) for c in range(4)]
        acc_n = [b.aux_next(c) for c in range(4)]
        prod = b.ef_mul4(b.ef_sub4(acc_n, acc), b.ef_sub4(g_st, code))
        act4 = b.ef_from_base4(active)
        for c in range(4):
            b.transition(b.add(prod[c], act4[c]))
            b.first_row(acc[c])
        for i in range(NUM_BUS):
            for c in range(4):
                if i == BUS_STOR:
                    b.last_row(b.sub(acc[c], b.bus_coord(4 * i + c)))
                else:
                    b.last_row(b.bus_coord(4 * i + c))
