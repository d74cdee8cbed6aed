"""ArithAir — the arithmetic table (SDIV / SMOD / EXP).

Rather than widening every CPU row with the ~800 witness columns signed
division needs, the CPU sends one tuple per SDIV/SMOD on the BUS_AR
channel (evm_air.py section 14h):

    kind + sum_j a_j chi^{1+j} + b_j chi^{33+j} + c_j chi^{65+j}

(kind 1 = SDIV, 2 = SMOD, 3 = EXP; a, b operands; c the pushed result)
and THIS table receives each tuple once, proving the semantics on its
own rows — the "arithmetic table" pattern of production zkEVMs.
SDIV/SMOD use one wide row per call; EXP uses a 256-row square-and-
multiply block (LSB-first: acc' = acc * (bit ? pw : 1), pw' = pw^2, one
schoolbook mod-2^256 multiply pair per row), with the operands/result
held across the block and the call tuple received on the block's last
row.  The exponent bit for row j is selected by a fixed 256-wide
one-hot, materialized into a witness bit column to keep constraint
degree <= 3.

Statement per row:  c = SDIV(a, b) resp. SMOD(a, b) with EVM truncated
division semantics (rounds toward zero, x/0 = 0, SDIV(-2^255, -1) =
-2^255).  Proven via absolute values:

  |a|, |b| witnesses bound by two's-complement negation chains
      (sign bit 255 selects  X + |X| = 2^256  vs  |X| = X; the 16-limb
      carry chain makes the relation exact over the integers);
  q', r' (abs quotient/remainder) bound by the UNSIGNED division
      machinery of the CPU's DIV/MOD (schoolbook convolution with 13-bit
      carries, zero high half, byte borrow chain r' <= |b| - 1,
      b = 0 => q' = r' = 0 through the nonzero gadget);
  the result sign condition SDC ( = sa XOR sb for SDIV, sa for SMOD)
      selects  c + (q'|r') = 2^256 * carry  vs  c = (q'|r') — the chain
      has a unique solution, so c is forced, including the overflow case
      (|-2^255| = 2^255 wraps back to -2^255 exactly as the EVM does).

Reference analog: revm's i256_div/i256_mod inside the zkVM guests
(SURVEY.md §3.5); table composition mirrors the vendored provers'
"interactions" (SURVEY.md §2.2).
"""

from __future__ import annotations

import numpy as np

from ...fields import babybear as bb
from ...fields import babybear_ext as ef
from ..air import Air, ConstraintBuilder
from .evm_air import (
    BUS_AR,
    CHAL_AR,
    CHAL_CHI,
    NUM_BUS,
    NUM_CHALLENGES,
    _BYTE_MAT,
    _LIMB_MAT,
    _bits_to_bytes,
    _divmod_witness,
    _np_chi_pows,
    _np_tuple_code,
    _pow2_atleast,
    _word_bits,
)

_PU = np.uint64(bb.P)

# witness columns
ARF_SDIV = 0
ARF_SMOD = 1
AR_A0 = 2  # 256: operand a bits
AR_B0 = AR_A0 + 256  # operand b
AR_C0 = AR_B0 + 256  # result
AR_Q0 = AR_C0 + 256  # abs quotient q'
AR_R0 = AR_Q0 + 256  # abs remainder r'
AR_AA0 = AR_R0 + 256  # |a|
AR_BA0 = AR_AA0 + 256  # |b|
AR_NCA0 = AR_BA0 + 256  # 16 negation carries: a + |a|
AR_NCB0 = AR_NCA0 + 16  # b + |b|
AR_NCC0 = AR_NCB0 + 16  # c + (q' | r')
AR_SDC = AR_NCC0 + 16  # result-negation condition
AR_MULC0 = AR_SDC + 1  # 13*32 schoolbook carries
AR_DMB0 = AR_MULC0 + 13 * 32  # 32 borrow bits
AR_DMT0 = AR_DMB0 + 32  # 256 t-byte bits
AR_NZ0 = AR_DMT0 + 256  # 16 nonzero indicators (|b| limbs)
AR_INV0 = AR_NZ0 + 16  # 16 inverses (raw)
AR_SINV = AR_INV0 + 16  # raw
AR_TAKEN = AR_SINV + 1
AR_FEXP = AR_TAKEN + 1  # EXP-kind flag
AR_BIT = AR_FEXP + 1  # selected exponent bit (witness copy)
AR_WIDTH = AR_BIT + 1

# EXP-row overlays (regions unused by the divmod machinery on exp rows):
#   AR_AA0  : acc_j bits        AR_BA0 : pw_j bits
#   AR_MULC0: acc-multiply carries (13x32)
#   AR_Q0 + AR_R0[:160]: pw-square carries (13x32)
#   AR_DMT0 : sel bits (bit ? pw : 1)
XC_ACC0 = AR_AA0
XC_PW0 = AR_BA0
XC_MC1 = AR_MULC0
XC_SEL0 = AR_DMT0

# fixed
ARF_ACTIVE = 0
XF_START = 1  # first row of an exp block
XF_END = 2  # last row of an exp block
XF_CONT_N = 3  # next row continues this exp block
XF_ACT = 4  # row belongs to an exp block
XF_BITSEL = 5  # 256 one-hot columns: exponent bit index of this row
AR_NFIXED = XF_BITSEL + 256
EXP_ROWS = 256

_MULC_MAT = [[0] * (13 * 32) for _ in range(32)]
for _k in range(32):
    for _t in range(13):
        _MULC_MAT[_k][13 * _k + _t] = 1 << _t
_DMT_MAT = [[0] * 256 for _ in range(32)]
for _k in range(32):
    for _t in range(8):
        _DMT_MAT[_k][8 * _k + _t] = 1 << _t

_M256 = (1 << 256) - 1


def _mul_carries_mod(x: int, y: int) -> list[int]:
    """Schoolbook byte-product carries mod 2^256 (same bound argument as
    evm_air._mul_carries: every carry < 2^13)."""
    xb = [(x >> (8 * i)) & 0xFF for i in range(32)]
    yb = [(y >> (8 * j)) & 0xFF for j in range(32)]
    out = []
    cprev = 0
    for k in range(32):
        t = sum(xb[i] * yb[k - i] for i in range(k + 1)) + cprev
        cprev = t >> 8
        assert cprev < (1 << 13)
        out.append(cprev)
    return out


def _signed(v: int) -> int:
    return v - (1 << 256) if v >> 255 else v


class ArithAir(Air):
    """One row per SDIV/SMOD call; receives BUS_AR tuples."""

    width = AR_WIDTH
    aux_width = 4
    num_aux_challenges = NUM_CHALLENGES
    num_bus_values = NUM_BUS
    quotient_chunks = 2
    eager_quotient = True

    def __init__(self, kinds, fid: int = 0):
        """kinds: per-call kind sequence (1 = SDIV, 2 = SMOD, 3 = EXP);
        a plain int keeps the round-3 call-count form (all divmod)."""
        self.fid = int(fid)
        if isinstance(kinds, int):
            kinds = [1] * kinds
        kinds = [int(k) for k in kinds]
        assert kinds and all(k in (1, 2, 3) for k in kinds)
        self.kinds = kinds
        self.num_calls = len(kinds)
        total = sum(EXP_ROWS if k == 3 else 1 for k in kinds)
        self.n = _pow2_atleast(total + 1)

    def structure_key(self) -> tuple:
        return tuple(self.kinds)

    def _layout(self):
        """[(call_idx, kind, j)] per active row (j = exp row index)."""
        out = []
        for ci, k in enumerate(self.kinds):
            if k == 3:
                for j in range(EXP_ROWS):
                    out.append((ci, k, j))
            else:
                out.append((ci, k, 0))
        return out

    def fixed_columns(self, n: int):
        assert n == self.n
        cols = np.zeros((AR_NFIXED, n), dtype=np.uint32)
        layout = self._layout()
        for r, (ci, k, j) in enumerate(layout):
            cols[ARF_ACTIVE, r] = 1
            if k == 3:
                cols[XF_ACT, r] = 1
                cols[XF_BITSEL + j, r] = 1
                if j == 0:
                    cols[XF_START, r] = 1
                if j == EXP_ROWS - 1:
                    cols[XF_END, r] = 1
        for r in range(n - 1):
            if (
                r + 1 < len(layout)
                and layout[r][1] == 3
                and layout[r + 1][1] == 3
                and layout[r + 1][2] == layout[r][2] + 1
                and layout[r + 1][0] == layout[r][0]
            ):
                cols[XF_CONT_N, r] = 1
        return cols

    def trace(self, calls: list[tuple[int, int, int, int]]) -> np.ndarray:
        """calls: (kind, a, b, c); kinds must match the constructor."""
        assert len(calls) == self.num_calls
        assert [k for k, *_ in calls] == self.kinds
        tr = np.zeros((self.n, AR_WIDTH), dtype=np.uint32)
        r = 0
        for kind, a, bv, c in calls:
            if kind == 3:
                r = self._fill_exp_rows(tr, r, a, bv, c)
                continue
            self._fill_divmod_row(tr, r, kind, a, bv, c)
            r += 1
        return tr

    def _fill_exp_rows(self, tr, r0, a, bv, c) -> int:
        """256 square-and-multiply rows (LSB-first)."""
        assert pow(a, bv, 1 << 256) == c, "exp call result mismatch"
        acc, pw = 1, a
        for j in range(EXP_ROWS):
            r = r0 + j
            bit = (bv >> j) & 1
            sel = pw if bit else 1
            tr[r, ARF_SDIV] = 0
            tr[r, AR_FEXP] = 1
            tr[r, AR_BIT] = bit
            tr[r, AR_A0 : AR_A0 + 256] = _word_bits(a)
            tr[r, AR_B0 : AR_B0 + 256] = _word_bits(bv)
            tr[r, AR_C0 : AR_C0 + 256] = _word_bits(c)
            tr[r, XC_ACC0 : XC_ACC0 + 256] = _word_bits(acc)
            tr[r, XC_PW0 : XC_PW0 + 256] = _word_bits(pw)
            tr[r, XC_SEL0 : XC_SEL0 + 256] = _word_bits(sel)
            mc1 = _mul_carries_mod(acc, sel)
            mc2 = _mul_carries_mod(pw, pw)
            for k in range(32):
                for t in range(13):
                    tr[r, XC_MC1 + 13 * k + t] = (mc1[k] >> t) & 1
                    bitv = (mc2[k] >> t) & 1
                    pos = 13 * k + t
                    col = AR_Q0 + pos if pos < 256 else AR_R0 + pos - 256
                    tr[r, col] = bitv
            acc = acc * sel % (1 << 256)
            pw = pw * pw % (1 << 256)
        assert acc == c
        return r0 + EXP_ROWS

    def _fill_divmod_row(self, tr, r, kind, a, bv, c) -> None:
            sa_, sb_ = _signed(a), _signed(bv)
            aa, ba = abs(sa_), abs(sb_)
            q = aa // ba if ba else 0
            rr = aa % ba if ba else 0
            # recompute + cross-check the claimed result
            if kind == 1:
                res = -q if (sa_ < 0) != (sb_ < 0) else q
                sdc = 1 if (sa_ < 0) != (sb_ < 0) else 0
            else:
                res = -rr if sa_ < 0 else rr
                sdc = 1 if sa_ < 0 else 0
            assert (res & _M256) == c, "arith call result mismatch"
            tr[r, ARF_SDIV if kind == 1 else ARF_SMOD] = 1
            tr[r, AR_A0 : AR_A0 + 256] = _word_bits(a)
            tr[r, AR_B0 : AR_B0 + 256] = _word_bits(bv)
            tr[r, AR_C0 : AR_C0 + 256] = _word_bits(c)
            tr[r, AR_Q0 : AR_Q0 + 256] = _word_bits(q)
            tr[r, AR_R0 : AR_R0 + 256] = _word_bits(rr)
            tr[r, AR_AA0 : AR_AA0 + 256] = _word_bits(aa & _M256)
            tr[r, AR_BA0 : AR_BA0 + 256] = _word_bits(ba & _M256)
            tr[r, AR_SDC] = sdc
            # negation carry chains (limb-level: x + |x| = 2^256)
            for base, x, xa in (
                (AR_NCA0, a, aa & _M256),
                (AR_NCB0, bv, ba & _M256),
                (AR_NCC0, c, (q if kind == 1 else rr) & _M256),
            ):
                cprev = 0
                for i in range(16):
                    t = (
                        ((x >> (16 * i)) & 0xFFFF)
                        + (((xa) >> (16 * i)) & 0xFFFF)
                        + cprev
                    )
                    cprev = t >> 16
                    tr[r, base + i] = cprev
            # unsigned divmod witnesses on (|a|, |b|, q, r)
            mulc, tb, brs = _divmod_witness(q, ba & _M256, rr, aa & _M256)
            for k in range(32):
                for t in range(13):
                    tr[r, AR_MULC0 + 13 * k + t] = (mulc[k] >> t) & 1
                tr[r, AR_DMB0 + k] = brs[k]
                for t in range(8):
                    tr[r, AR_DMT0 + 8 * k + t] = (tb[k] >> t) & 1
            # divisor nonzero gadget on |b| limbs
            s = 0
            for i in range(16):
                limb = (ba >> (16 * i)) & 0xFFFF
                if limb:
                    tr[r, AR_NZ0 + i] = 1
                    tr[r, AR_INV0 + i] = pow(limb, bb.P - 2, bb.P)
                    s += 1
            tr[r, AR_SINV] = pow(s, bb.P - 2, bb.P) if s else 0
            tr[r, AR_TAKEN] = 1 if s else 0

    # ---------------- host-side channel terms ----------------
    def _terms(self, trace: np.ndarray, challenges) -> np.ndarray:
        from .evm_air import fid_challenges

        challenges = fid_challenges(challenges, self.fid)
        chi = challenges[CHAL_CHI]
        gar = np.array(
            [x % bb.P for x in challenges[CHAL_AR]], dtype=np.uint64
        )
        pows = _np_chi_pows(chi, 97)
        t = trace.astype(np.uint64)
        bytesA = _bits_to_bytes(trace[:, AR_A0 : AR_A0 + 256])
        bytesB = _bits_to_bytes(trace[:, AR_B0 : AR_B0 + 256])
        bytesC = _bits_to_bytes(trace[:, AR_C0 : AR_C0 + 256])
        kind = (
            t[:, ARF_SDIV] + 2 * t[:, ARF_SMOD] + 3 * t[:, AR_FEXP]
        ) % _PU
        code = _np_tuple_code(
            kind,
            [(bytesA[:, j], 1 + j) for j in range(32)]
            + [(bytesB[:, j], 33 + j) for j in range(32)]
            + [(bytesC[:, j], 65 + j) for j in range(32)],
            pows,
        )
        inv = ef.npef_inv(ef.npef_sub(gar[None, :], code))
        n = trace.shape[0]
        act = np.zeros(n, dtype=np.uint64)
        # one receive per call: divmod rows + exp-block END rows
        for r, (ci, k, j) in enumerate(self._layout()):
            if k != 3 or j == EXP_ROWS - 1:
                act[r] = _PU - np.uint64(1)
        return ef.npef_mul(ef.npef_from_base(act), inv)

    def aux_trace(self, trace: np.ndarray, challenges) -> np.ndarray:
        aux = np.zeros((trace.shape[0], 4), dtype=np.uint32)
        terms = self._terms(trace, challenges)
        c = np.cumsum(terms, axis=0) % _PU
        aux[:] = ef.npef_sub(c, terms)
        return aux

    def bus_values(self, trace: np.ndarray, challenges) -> list[tuple]:
        terms = self._terms(trace, challenges)
        out = [ef.H_ZERO] * NUM_BUS
        out[BUS_AR] = tuple(int(v) for v in terms.sum(axis=0) % _PU)
        return out

    # ---------------- constraints ----------------
    def eval(self, b: ConstraintBuilder) -> None:  # noqa: C901
        one = b.constant(1)
        chi = b.challenge_ef(CHAL_CHI)
        from .evm_air import fid_gamma

        g_ar = fid_gamma(
            b, b.challenge_ef(CHAL_CHI), b.challenge_ef(CHAL_AR), b.public(0)
        )
        active = b.fixed(ARF_ACTIVE)
        xf_start = b.fixed(XF_START)
        xf_end = b.fixed(XF_END)
        xf_cont = b.fixed(XF_CONT_N)
        xf_act = b.fixed(XF_ACT)
        f_sdv = b.local(ARF_SDIV)
        f_smd = b.local(ARF_SMOD)
        f_exp = b.local(AR_FEXP)
        bitc = b.local(AR_BIT)
        sdc = b.local(AR_SDC)
        taken = b.local(AR_TAKEN)
        sinv = b.local(AR_SINV)
        f_dm = b.add(f_sdv, f_smd)

        # booleanity (all but the raw inverse columns)
        bit_cols = (
            [ARF_SDIV, ARF_SMOD, AR_FEXP, AR_BIT]
            + list(range(AR_A0, AR_NCA0))  # the seven 256-bit words
            + list(range(AR_NCA0, AR_SDC + 1))  # carries + SDC
            + list(range(AR_MULC0, AR_NZ0 + 16))  # mulc + dmb + dmt + nz
            + [AR_TAKEN]
        )
        bits = b.local_block(bit_cols)
        b.all_rows_block(b.mul(bits, b.sub(bits, one)), len(bit_cols))

        # exactly one kind on active rows, none elsewhere; the EXP flag
        # must match the fixed block layout
        b.all_rows(b.sub(b.add(f_dm, f_exp), active))
        b.all_rows(b.sub(f_exp, xf_act))

        Ablk = b.local_block(range(AR_A0, AR_A0 + 256))
        Bblk = b.local_block(range(AR_B0, AR_B0 + 256))
        Cblk = b.local_block(range(AR_C0, AR_C0 + 256))
        Qblk = b.local_block(range(AR_Q0, AR_Q0 + 256))
        Rblk = b.local_block(range(AR_R0, AR_R0 + 256))
        AAblk = b.local_block(range(AR_AA0, AR_AA0 + 256))
        BAblk = b.local_block(range(AR_BA0, AR_BA0 + 256))
        lA = b.linmap(_LIMB_MAT, Ablk)
        lB = b.linmap(_LIMB_MAT, Bblk)
        lC = b.linmap(_LIMB_MAT, Cblk)
        lQ = b.linmap(_LIMB_MAT, Qblk)
        lR = b.linmap(_LIMB_MAT, Rblk)
        lAA = b.linmap(_LIMB_MAT, AAblk)
        lBA = b.linmap(_LIMB_MAT, BAblk)
        sa = b.local(AR_A0 + 255)
        sb_ = b.local(AR_B0 + 255)

        # 1. |a| / |b| bindings: sign-selected negation chain or copy
        for sx, lX, lXA, XAblk, Xblk, nc0 in (
            (sa, lA, lAA, AAblk, Ablk, AR_NCA0),
            (sb_, lB, lBA, BAblk, Bblk, AR_NCB0),
        ):
            gate = b.mul(f_dm, sx)
            cprev = b.constant(0)
            for i in range(16):
                ci = b.local(nc0 + i)
                b.all_rows(
                    b.mul(
                        gate,
                        b.sub(
                            b.add(b.add(lX[i], lXA[i]), cprev),
                            b.scale(1 << 16, ci),
                        ),
                    )
                )
                cprev = ci
            b.all_rows(b.mul(gate, b.sub(cprev, one)))  # carry-out = 1
            b.all_rows_block(
                b.mul(b.mul(f_dm, b.sub(one, sx)), b.sub(XAblk, Xblk)), 256
            )

        # 2. result-sign condition + negation/copy of the result
        b.all_rows(
            b.mul(
                f_sdv,
                b.sub(sdc, b.sub(b.add(sa, sb_), b.scale(2, b.mul(sa, sb_)))),
            )
        )
        b.all_rows(b.mul(f_smd, b.sub(sdc, sa)))
        for fg, lX, Xblk in ((f_sdv, lQ, Qblk), (f_smd, lR, Rblk)):
            gate = b.mul(fg, sdc)
            cprev = b.constant(0)
            for i in range(16):
                ci = b.local(AR_NCC0 + i)
                b.all_rows(
                    b.mul(
                        gate,
                        b.sub(
                            b.add(b.add(lC[i], lX[i]), cprev),
                            b.scale(1 << 16, ci),
                        ),
                    )
                )
                cprev = ci
            # no carry-out pin: C + X = 2^256*c15 already has a unique
            # solution (c15 = 1 unless X = 0, which forces C = 0)
            b.all_rows_block(
                b.mul(b.mul(fg, b.sub(one, sdc)), b.sub(Cblk, Xblk)), 256
            )

        # 3. divisor-nonzero gadget on |b| limbs
        nzs = [b.local(AR_NZ0 + i) for i in range(16)]
        invs = [b.local(AR_INV0 + i) for i in range(16)]
        s_acc = None
        for i in range(16):
            b.all_rows(b.mul(f_dm, b.sub(nzs[i], b.mul(lBA[i], invs[i]))))
            b.all_rows(b.mul(f_dm, b.mul(lBA[i], b.sub(one, nzs[i]))))
            s_acc = nzs[i] if s_acc is None else b.add(s_acc, nzs[i])
        b.all_rows(b.mul(f_dm, b.sub(taken, b.mul(s_acc, sinv))))
        b.all_rows(b.mul(f_dm, b.mul(s_acc, b.sub(one, taken))))

        # 4. unsigned divmod:  q'*|b| + r' = taken*|a|  (schoolbook, zero
        # high half, borrow chain r' <= |b| - 1); q' = r' = 0 when b = 0
        qbytes = b.linmap(_BYTE_MAT, Qblk)
        rbytes = b.linmap(_BYTE_MAT, Rblk)
        aabytes = b.linmap(_BYTE_MAT, AAblk)
        babytes = b.linmap(_BYTE_MAT, BAblk)
        scratch = b.local_block(range(AR_MULC0, AR_MULC0 + 13 * 32))
        mulc = b.linmap(_MULC_MAT, scratch)
        mulc_prev = b.concat_rows([b.scale(0, mulc[:1]), mulc[:31]])

        def shift32_down(blk, k):
            if k == 0:
                return blk
            return b.concat_rows([b.scale(0, blk[:k]), blk[: 32 - k]])

        conv = None
        for i in range(32):
            t = b.mul(qbytes[i], shift32_down(babytes, i))
            conv = t if conv is None else b.add(conv, t)
        b.all_rows_block(
            b.mul(
                f_dm,
                b.sub(
                    b.add(b.add(conv, rbytes), mulc_prev),
                    b.add(b.mul(taken, aabytes), b.scale(256, mulc)),
                ),
            ),
            32,
        )
        _SUF = [[1 if j > 31 - i else 0 for j in range(32)] for i in range(32)]
        basuffix = b.linmap(_SUF, babytes)
        hi = None
        for i in range(1, 32):
            t = b.mul(qbytes[i], basuffix[i])
            hi = t if hi is None else b.add(hi, t)
        b.all_rows(b.mul(f_dm, b.add(hi, mulc[31])))
        dmbr = b.local_block(range(AR_DMB0, AR_DMB0 + 32))
        dmbr_prev = b.concat_rows([b.scale(0, dmbr[:1]), dmbr[:31]])
        tbytes = b.linmap(_DMT_MAT, b.local_block(range(AR_DMT0, AR_DMT0 + 256)))
        sub1 = b.const_vec([1] + [0] * 31)
        chain = b.sub(
            b.add(b.sub(babytes, rbytes), b.scale(256, dmbr)),
            b.add(b.add(sub1, dmbr_prev), tbytes),
        )
        b.all_rows_block(b.mul(f_dm, chain), 32)
        b.all_rows(b.mul(b.mul(f_dm, taken), dmbr[31]))
        ntk = b.mul(f_dm, b.sub(one, taken))
        b.all_rows_block(b.mul(ntk, Qblk), 256)
        b.all_rows_block(b.mul(ntk, Rblk), 256)

        # 4b. EXP blocks: square-and-multiply, LSB-first
        ACCblk = b.local_block(range(XC_ACC0, XC_ACC0 + 256))
        ACCblk_n = b.next_block(range(XC_ACC0, XC_ACC0 + 256))
        PWblk = b.local_block(range(XC_PW0, XC_PW0 + 256))
        PWblk_n = b.next_block(range(XC_PW0, XC_PW0 + 256))
        SELblk = b.local_block(range(XC_SEL0, XC_SEL0 + 256))
        accbytes = b.linmap(_BYTE_MAT, ACCblk)
        accbytes_n = b.linmap(_BYTE_MAT, ACCblk_n)
        pwbytes = b.linmap(_BYTE_MAT, PWblk)
        pwbytes_n = b.linmap(_BYTE_MAT, PWblk_n)
        selbytes = b.linmap(_BYTE_MAT, SELblk)
        cbytes = b.linmap(_BYTE_MAT, Cblk)
        # selected exponent bit: fixed one-hot over the held B word
        bsel = None
        for j in range(256):
            t = b.mul(b.fixed(XF_BITSEL + j), b.local(AR_B0 + j))
            bsel = t if bsel is None else b.add(bsel, t)
        b.all_rows(b.mul(xf_act, b.sub(bitc, bsel)))
        # sel = bit ? pw : 1  (bitwise; byte 0 gets the +1 of the "1")
        b.all_rows_block(
            b.mul(xf_act, b.sub(SELblk[1:], b.mul(bitc, PWblk[1:]))), 255
        )
        b.all_rows(
            b.mul(
                xf_act,
                b.sub(
                    b.local(XC_SEL0),
                    b.add(
                        b.mul(bitc, b.local(XC_PW0)),
                        b.sub(one, bitc),
                    ),
                ),
            )
        )
        # block start: acc = 1, pw = a
        b.all_rows(b.mul(xf_start, b.sub(b.local(XC_ACC0), one)))
        b.all_rows_block(b.mul(xf_start, ACCblk[1:]), 255)
        b.all_rows_block(b.mul(xf_start, b.sub(PWblk, Ablk)), 256)
        # held words across the block
        for blk, blk_n in (
            (Ablk, b.next_block(range(AR_A0, AR_A0 + 256))),
            (Bblk, b.next_block(range(AR_B0, AR_B0 + 256))),
            (Cblk, b.next_block(range(AR_C0, AR_C0 + 256))),
        ):
            b.transition_block(b.mul(xf_cont, b.sub(blk_n, blk)), 256)
        # acc multiply: conv(acc, sel) with 13-bit carries; target is the
        # NEXT row's acc (continuation) or the held result C (block end)
        xscr1 = b.local_block(range(XC_MC1, XC_MC1 + 13 * 32))
        mc1 = b.linmap(_MULC_MAT, xscr1)
        mc1_prev = b.concat_rows([b.scale(0, mc1[:1]), mc1[:31]])
        conv_as = None
        for i in range(32):
            t = b.mul(accbytes[i], shift32_down(selbytes, i))
            conv_as = t if conv_as is None else b.add(conv_as, t)
        lhs_as = b.add(conv_as, mc1_prev)
        b.transition_block(
            b.mul(
                xf_cont,
                b.sub(lhs_as, b.add(accbytes_n, b.scale(256, mc1))),
            ),
            32,
        )
        b.all_rows_block(
            b.mul(
                xf_end,
                b.sub(lhs_as, b.add(cbytes, b.scale(256, mc1))),
            ),
            32,
        )
        # pw squaring: conv(pw, pw) -> next pw
        _XM2 = [[0] * 416 for _ in range(32)]
        for _k in range(32):
            for _t in range(13):
                _XM2[_k][13 * _k + _t] = 1 << _t
        xscr2 = b.local_block(
            list(range(AR_Q0, AR_Q0 + 256)) + list(range(AR_R0, AR_R0 + 160))
        )
        mc2 = b.linmap(_XM2, xscr2)
        mc2_prev = b.concat_rows([b.scale(0, mc2[:1]), mc2[:31]])
        conv_pp = None
        for i in range(32):
            t = b.mul(pwbytes[i], shift32_down(pwbytes, i))
            conv_pp = t if conv_pp is None else b.add(conv_pp, t)
        b.transition_block(
            b.mul(
                xf_cont,
                b.sub(
                    b.add(conv_pp, mc2_prev),
                    b.add(pwbytes_n, b.scale(256, mc2)),
                ),
            ),
            32,
        )

        # 5. receive channel
        kind_expr = b.add(
            b.add(f_sdv, b.scale(2, f_smd)), b.scale(3, f_exp)
        )
        chi2 = b.ef_mul4(chi, chi)
        chi4 = b.ef_mul4(chi2, chi2)
        chi8 = b.ef_mul4(chi4, chi4)
        chi16 = b.ef_mul4(chi8, chi8)
        chi32 = b.ef_mul4(chi16, chi16)
        chi64 = b.ef_mul4(chi32, chi32)
        code = b.bit_block_code(Ablk, chi, kind_expr, 32)
        code = b.ef_add4(
            code, b.ef_mul4(chi32, b.bit_block_code(Bblk, chi, b.constant(0), 32))
        )
        code = b.ef_add4(
            code, b.ef_mul4(chi64, b.bit_block_code(Cblk, chi, b.constant(0), 32))
        )
        acc = [b.aux(c) for c in range(4)]
        acc_n = [b.aux_next(c) for c in range(4)]
        prod = b.ef_mul4(b.ef_sub4(acc_n, acc), b.ef_sub4(g_ar, code))
        # one receive per CALL: 1-row divmod rows, exp blocks on their
        # END row (operands/result are held, so the code is well-defined)
        recv = b.add(f_dm, xf_end)
        act4 = b.ef_from_base4(recv)
        for c in range(4):
            b.transition(b.add(prod[c], act4[c]))
            b.first_row(acc[c])
        for i in range(NUM_BUS):
            for c in range(4):
                if i == BUS_AR:
                    b.last_row(b.sub(acc[c], b.bus_coord(4 * i + c)))
                else:
                    b.last_row(b.bus_coord(4 * i + c))
