"""EvmCopyAir — the CALLDATACOPY bridge.

One row per copied 32-byte word.  The CPU sends one call tuple per
CALLDATACOPY (channel BUS_CP: clk + destw*chi + offset*chi^2 +
sw*chi^3); this table RECEIVES it on the call's first row (binding its
witness clk to a real CPU row with these PUBLIC parameters), then per
word j:

  - when the source offset is in calldata bounds (a FIXED flag — the
    public structure knows offset and calldatasize), SENDS the
    (offset + 32j, word) tuple on the calldata channel (BUS_CD), so the
    copied word IS the public calldata's zero-padded word at that
    offset (EvmCalldataAir receives it through its multiplicity);
  - out-of-bounds words are constrained to zero (EVM zero-fill);
  - SENDS the RAM write (destw + j, 4*clk + 2, 1, word) on BUS_MEM —
    distinct word addresses make the shared sub-clock unambiguous.

Covered scope (documented in evm_air.py): dest 32-byte aligned and size
a word multiple — the shape Solidity's abi-decode copies take; byte-tail
splicing joins with the general copy path later.

Same accumulator/bus conventions as the keccak bridge (evm_keccak.py).
"""

from __future__ import annotations

import numpy as np

from ...fields import babybear as bb
from ...fields import babybear_ext as ef
from ..air import Air, ConstraintBuilder
from .evm_air import (
    BUS_CD,
    BUS_CP,
    BUS_MEM,
    CHAL_C,
    CHAL_CHI,
    CHAL_CP,
    CHAL_M,
    NUM_BUS,
    NUM_CHALLENGES,
    _bits_to_bytes,
    _np_chi_pows,
    _np_tuple_code,
    _pow2_atleast,
    _word_bits,
)

_PU = np.uint64(bb.P)

# witness columns
CP_CLK = 0  # raw clk (held across a call's rows)
CP_W0 = 1  # 256 source-word bits (zero-padded calldata word)
CP_OLD0 = CP_W0 + 256  # 256 old-word bits (tail rows only)
CP_WIDTH = CP_OLD0 + 256

# aux (EF x4): call receives, calldata sends, RAM writes, tail reads
CPA_CALL = 0
CPA_CD = 4
CPA_MEM = 8
CPA_OLD = 12
CP_AUX_W = 16

# fixed
CPF_ACTIVE = 0
CPF_START = 1
CPF_CONT_N = 2
CPF_DEST = 3  # destw + j of this row
CPF_OFF = 4  # offset + 32*j of this row
CPF_INB = 5  # source offset within calldata bounds
CPF_CDEST = 6  # the call's destw (constant per block)
CPF_COFF = 7  # the call's offset
CPF_CSW = 8  # the call's word count
CPF_CSLACK = 9  # the call's slack (32*sw - size)
CPF_TAIL = 10  # last word of a call with slack != 0 (RMW row)
CPF_TS = 11  # 32 one-hot columns selecting the slack byte count
CP_NFIXED = CPF_TS + 32


def _splice_patterns(b, SRC, OLD):
    """pattern[t] (t = slack 1..31): keep OLD's low 8t bits, SRC above
    (big-endian: the copied size%32 = 32-t head bytes come from SRC)."""
    pats = {}
    for t in range(1, 32):
        pats[t] = b.concat_rows([OLD[: 8 * t], SRC[8 * t :]])
    return pats


class EvmCopyAir(Air):
    """One row per CALLDATACOPY'd word (see module docstring)."""

    width = CP_WIDTH
    aux_width = CP_AUX_W
    num_aux_challenges = NUM_CHALLENGES
    num_bus_values = NUM_BUS
    quotient_chunks = 2
    eager_quotient = True

    def __init__(self, calls, calldatasize: int, fid: int = 0):
        """calls: PUBLIC (destw, offset, sw[, slack]) per CALLDATACOPY;
        calldatasize: the frame's public CALLDATASIZE."""
        self.fid = int(fid)
        norm = []
        for c in calls:
            d, o, w = c[0], c[1], c[2]
            sl = c[3] if len(c) > 3 else 0
            assert w >= 1 and 0 <= sl < 32
            norm.append((int(d), int(o), int(w), int(sl)))
        assert norm
        self.calls = norm
        self.cds = int(calldatasize)
        total = sum(sw for _, _, sw, _ in self.calls)
        self.n = max(32, _pow2_atleast(total + 1))

    def structure_key(self) -> tuple:
        return ()

    def _layout(self):
        out = []
        for ci, (destw, off, sw, sl) in enumerate(self.calls):
            for j in range(sw):
                out.append((ci, j))
        return out

    def fixed_columns(self, n: int):
        assert n == self.n
        cols = np.zeros((CP_NFIXED, n), dtype=np.uint32)
        layout = self._layout()
        for r, (ci, j) in enumerate(layout):
            destw, off, sw, sl = self.calls[ci]
            cols[CPF_ACTIVE, r] = 1
            if j == 0:
                cols[CPF_START, r] = 1
            cols[CPF_DEST, r] = destw + j
            cols[CPF_OFF, r] = off + 32 * j
            cols[CPF_INB, r] = 1 if off + 32 * j < self.cds else 0
            cols[CPF_CDEST, r] = destw
            cols[CPF_COFF, r] = off
            cols[CPF_CSW, r] = sw
            cols[CPF_CSLACK, r] = sl
            if sl and j == sw - 1:
                cols[CPF_TAIL, r] = 1
                cols[CPF_TS + sl, r] = 1
        for r in range(n - 1):
            if r + 1 < len(layout) and layout[r + 1][1] != 0:
                cols[CPF_CONT_N, r] = 1
        return cols

    def trace(self, witness) -> np.ndarray:
        """witness: per call (clk, src_words[, tail_old]): the SOURCE
        words (zero-padded calldata words — what the calldata channel
        serves) plus the tail row's old memory word."""
        assert len(witness) == len(self.calls)
        tr = np.zeros((self.n, CP_WIDTH), dtype=np.uint32)
        r = 0
        for (destw, off, sw, sl), wit in zip(self.calls, witness):
            clk, srcs = wit[0], wit[1]
            told = wit[2] if len(wit) > 2 else None
            assert len(srcs) == sw
            for j in range(sw):
                tr[r, CP_CLK] = clk
                tr[r, CP_W0 : CP_W0 + 256] = _word_bits(srcs[j])
                if sl and j == sw - 1:
                    tr[r, CP_OLD0 : CP_OLD0 + 256] = _word_bits(told or 0)
                r += 1
        return tr

    # ---------------- host-side channel terms ----------------
    def _terms(self, trace: np.ndarray, challenges):
        from .evm_air import fid_challenges

        challenges = fid_challenges(challenges, self.fid)
        chi = challenges[CHAL_CHI]
        pows = _np_chi_pows(chi, 40)
        n = trace.shape[0]
        t = trace.astype(np.uint64)
        fx = self.fixed_columns(n).astype(np.uint64)
        wbytes = _bits_to_bytes(trace[:, CP_W0 : CP_W0 + 256])
        clk = t[:, CP_CLK]
        # call receives (start rows, -1)
        gcp = np.array([x % bb.P for x in challenges[CHAL_CP]], dtype=np.uint64)
        code_call = _np_tuple_code(
            clk,
            [
                (fx[CPF_CDEST], 1),
                (fx[CPF_COFF], 2),
                (fx[CPF_CSW], 3),
                (fx[CPF_CSLACK], 5),
            ],
            pows,
        )
        inv_call = ef.npef_inv(ef.npef_sub(gcp[None, :], code_call))
        call_terms = ef.npef_mul(
            ef.npef_from_base((_PU - 1) * fx[CPF_START] % _PU), inv_call
        )
        # calldata sends (in-bounds rows, +1)
        gc = np.array([x % bb.P for x in challenges[CHAL_C]], dtype=np.uint64)
        code_cd = _np_tuple_code(
            fx[CPF_OFF], [(wbytes[:, j], j + 1) for j in range(32)], pows
        )
        inv_cd = ef.npef_inv(ef.npef_sub(gc[None, :], code_cd))
        cd_terms = ef.npef_mul(
            ef.npef_from_base(fx[CPF_INB] * fx[CPF_ACTIVE] % _PU), inv_cd
        )
        # RAM write sends (every active row, +1): tail rows write the
        # SPLICE of (source head bytes, old low bytes)
        gm = np.array([x % bb.P for x in challenges[CHAL_M]], dtype=np.uint64)
        obytes = _bits_to_bytes(trace[:, CP_OLD0 : CP_OLD0 + 256])
        slack_arr = np.zeros(n, dtype=np.int64)
        for t in range(1, 32):
            slack_arr += t * fx[CPF_TS + t].astype(np.int64)
        keepmask = np.arange(32)[None, :] < slack_arr[:, None]
        wrbytes = np.where(
            (fx[CPF_TAIL] == 1)[:, None] & keepmask, obytes, wbytes
        )
        code_m = _np_tuple_code(
            fx[CPF_DEST],
            [(4 * clk + 2, 1), (np.ones(n, dtype=np.uint64), 2)]
            + [(wrbytes[:, j], j + 3) for j in range(32)],
            pows,
        )
        inv_m = ef.npef_inv(ef.npef_sub(gm[None, :], code_m))
        mem_terms = ef.npef_mul(ef.npef_from_base(fx[CPF_ACTIVE]), inv_m)
        # tail-old READ sends at sub-clock +1
        code_o = _np_tuple_code(
            fx[CPF_DEST],
            [(4 * clk + 1, 1)]
            + [(obytes[:, j], j + 3) for j in range(32)],
            pows,
        )
        inv_o = ef.npef_inv(ef.npef_sub(gm[None, :], code_o))
        old_terms = ef.npef_mul(ef.npef_from_base(fx[CPF_TAIL]), inv_o)
        return call_terms, cd_terms, mem_terms, old_terms

    @staticmethod
    def _excl(terms):
        c = np.cumsum(terms, axis=0) % _PU
        return ef.npef_sub(c, terms)

    def aux_trace(self, trace: np.ndarray, challenges) -> np.ndarray:
        call_t, cd_t, mem_t, old_t = self._terms(trace, challenges)
        aux = np.zeros((trace.shape[0], CP_AUX_W), dtype=np.uint32)
        aux[:, CPA_CALL : CPA_CALL + 4] = self._excl(call_t)
        aux[:, CPA_CD : CPA_CD + 4] = self._excl(cd_t)
        aux[:, CPA_MEM : CPA_MEM + 4] = self._excl(mem_t)
        aux[:, CPA_OLD : CPA_OLD + 4] = self._excl(old_t)
        return aux

    def bus_values(self, trace: np.ndarray, challenges) -> list[tuple]:
        call_t, cd_t, mem_t, old_t = self._terms(trace, challenges)
        out = [ef.H_ZERO] * NUM_BUS
        out[BUS_CP] = tuple(int(v) for v in call_t.sum(axis=0) % _PU)
        out[BUS_CD] = tuple(int(v) for v in cd_t.sum(axis=0) % _PU)
        out[BUS_MEM] = tuple(
            int(v) for v in (mem_t.sum(axis=0) + old_t.sum(axis=0)) % _PU
        )
        return out

    # ---------------- constraints ----------------
    def eval(self, b: ConstraintBuilder) -> None:
        one = b.constant(1)
        chi = b.challenge_ef(CHAL_CHI)
        from .evm_air import _eval_chi97

        _c97 = _eval_chi97(b, chi)
        _fs = [b.mul(b.public(0), _c97[c]) for c in range(4)]
        g_cp = b.ef_sub4(b.challenge_ef(CHAL_CP), _fs)
        g_c = b.ef_sub4(b.challenge_ef(CHAL_C), _fs)
        g_m = b.ef_sub4(b.challenge_ef(CHAL_M), _fs)
        active = b.fixed(CPF_ACTIVE)
        start = b.fixed(CPF_START)
        cont = b.fixed(CPF_CONT_N)
        destf = b.fixed(CPF_DEST)
        offf = b.fixed(CPF_OFF)
        inb = b.fixed(CPF_INB)
        cdest = b.fixed(CPF_CDEST)
        coff = b.fixed(CPF_COFF)
        csw = b.fixed(CPF_CSW)
        clk = b.local(CP_CLK)
        clk_n = b.next(CP_CLK)
        Wblk = b.local_block(range(CP_W0, CP_W0 + 256))

        # word-bit booleanity; OOB rows are zero; inactive rows zero
        b.all_rows_block(b.mul(Wblk, b.sub(Wblk, one)), 256)
        b.all_rows_block(b.mul(b.sub(one, b.mul(active, inb)), Wblk), 256)
        # clk held within a call
        b.transition(b.mul(cont, b.sub(clk_n, clk)))
        b.all_rows(b.mul(b.sub(one, active), clk))

        chi2 = b.ef_mul4(chi, chi)
        chi3 = b.ef_mul4(chi2, chi)

        # call receives on start rows
        cslack = b.fixed(CPF_CSLACK)
        chi4 = b.ef_mul4(chi2, chi2)
        chi5 = b.ef_mul4(chi4, chi)
        code_call = b.ef_add4(
            b.ef_from_base4(clk),
            b.ef_add4(
                b.ef_add4(
                    b.ef_mul4(chi, b.ef_from_base4(cdest)),
                    b.ef_mul4(chi2, b.ef_from_base4(coff)),
                ),
                b.ef_add4(
                    b.ef_mul4(chi3, b.ef_from_base4(csw)),
                    b.ef_mul4(chi5, b.ef_from_base4(cslack)),
                ),
            ),
        )
        accC = [b.aux(CPA_CALL + c) for c in range(4)]
        accC_n = [b.aux_next(CPA_CALL + c) for c in range(4)]
        prodC = b.ef_mul4(b.ef_sub4(accC_n, accC), b.ef_sub4(g_cp, code_call))
        start4 = b.ef_from_base4(start)
        for c in range(4):
            b.transition(b.add(prodC[c], start4[c]))
            b.first_row(accC[c])

        # calldata sends on in-bounds rows
        code_cd = b.bit_block_code(Wblk, chi, offf, 32)
        accD = [b.aux(CPA_CD + c) for c in range(4)]
        accD_n = [b.aux_next(CPA_CD + c) for c in range(4)]
        prodD = b.ef_mul4(b.ef_sub4(accD_n, accD), b.ef_sub4(g_c, code_cd))
        actD = b.ef_from_base4(b.mul(active, inb))
        for c in range(4):
            b.transition(b.sub(prodD[c], actD[c]))
            b.first_row(accD[c])

        # RAM write sends on every active row; tail rows write the
        # splice (FIXED one-hot selects the slack byte count)
        Oblk = b.local_block(range(CP_OLD0, CP_OLD0 + 256))
        tailf = b.fixed(CPF_TAIL)
        spl = b.mul(b.sub(one, tailf), Wblk)
        for t in range(1, 32):
            pat = b.concat_rows([Oblk[: 8 * t], Wblk[8 * t :]])
            spl = b.add(spl, b.mul(b.fixed(CPF_TS + t), pat))
        wcode = b.bit_block_code(spl, chi, b.constant(0), 32)
        inner = b.ef_add4(b.ef_from_base4(one), wcode)
        code_m = b.ef_add4(
            b.ef_from_base4(destf),
            b.ef_mul4(
                chi,
                b.ef_add4(
                    b.ef_from_base4(
                        b.add(b.scale(4, clk), b.constant(2))
                    ),
                    b.ef_mul4(chi, inner),
                ),
            ),
        )
        accM = [b.aux(CPA_MEM + c) for c in range(4)]
        accM_n = [b.aux_next(CPA_MEM + c) for c in range(4)]
        prodM = b.ef_mul4(b.ef_sub4(accM_n, accM), b.ef_sub4(g_m, code_m))
        act4 = b.ef_from_base4(active)
        for c in range(4):
            b.transition(b.sub(prodM[c], act4[c]))
            b.first_row(accM[c])
        # tail-old READ at sub-clock +1; non-tail rows keep OLD zero
        b.all_rows_block(b.mul(b.sub(one, tailf), Oblk), 256)
        b.all_rows_block(b.mul(Oblk, b.sub(Oblk, one)), 256)
        ocode = b.bit_block_code(Oblk, chi, b.constant(0), 32)
        code_o = b.ef_add4(
            b.ef_from_base4(destf),
            b.ef_mul4(
                chi,
                b.ef_add4(
                    b.ef_from_base4(b.add(b.scale(4, clk), one)),
                    b.ef_mul4(chi, ocode),
                ),
            ),
        )
        accO = [b.aux(CPA_OLD + c) for c in range(4)]
        accO_n = [b.aux_next(CPA_OLD + c) for c in range(4)]
        prodO = b.ef_mul4(b.ef_sub4(accO_n, accO), b.ef_sub4(g_m, code_o))
        tact = b.ef_from_base4(tailf)
        for c in range(4):
            b.transition(b.sub(prodO[c], tact[c]))
            b.first_row(accO[c])

        # bus pins
        for i in range(NUM_BUS):
            for c in range(4):
                if i == BUS_CP:
                    b.last_row(b.sub(accC[c], b.bus_coord(4 * i + c)))
                elif i == BUS_CD:
                    b.last_row(b.sub(accD[c], b.bus_coord(4 * i + c)))
                elif i == BUS_MEM:
                    b.last_row(
                        b.sub(
                            b.add(accM[c], accO[c]), b.bus_coord(4 * i + c)
                        )
                    )
                else:
                    b.last_row(b.bus_coord(4 * i + c))


# --------------------------------------------------------------------------
# CodeCopyAir — CODECOPY bridge: source words are FIXED (public bytecode)
# --------------------------------------------------------------------------

CC_CLK = 0  # raw clk (held across a call's rows)
CC_OLD0 = 1  # 256 old-word bits (tail rows only)
CC_WIDTH = CC_OLD0 + 256

CCF_ACTIVE = 0
CCF_START = 1
CCF_CONT_N = 2
CCF_DEST = 3
CCF_CDEST = 4
CCF_COFF = 5
CCF_CSW = 6
CCF_CSLACK = 7
CCF_TAIL = 8
CCF_TS = 9  # 32 one-hot slack selectors
CCF_W0 = CCF_TS + 32  # 256 fixed word bits (public bytecode, zero-padded)
CC_NFIXED = CCF_W0 + 256


class CodeCopyAir(Air):
    """One row per CODECOPY'd word.  The copied words are derived from
    the PUBLIC bytecode at construction, so they live entirely in fixed
    columns — the bridge only binds the witness clk to a CPU call tuple
    (kind 1 on BUS_CP) and sends the RAM writes."""

    width = CC_WIDTH
    aux_width = 12  # call receives + RAM writes + tail reads
    num_aux_challenges = NUM_CHALLENGES
    num_bus_values = NUM_BUS
    quotient_chunks = 2
    eager_quotient = True

    def __init__(self, calls, code: bytes, fid: int = 0):
        self.fid = int(fid)
        norm = []
        for c in calls:
            d, o, w = c[0], c[1], c[2]
            sl = c[3] if len(c) > 3 else 0
            assert w >= 1 and 0 <= sl < 32
            norm.append((int(d), int(o), int(w), int(sl)))
        assert norm
        self.calls = norm
        self.code = bytes(code)
        total = sum(sw for _, _, sw, _ in self.calls)
        self.n = max(32, _pow2_atleast(total + 1))

    def structure_key(self) -> tuple:
        return ()

    def _layout(self):
        out = []
        for ci, (destw, off, sw, sl) in enumerate(self.calls):
            for j in range(sw):
                out.append((ci, j))
        return out

    def _word(self, off: int) -> int:
        chunk = self.code[off : off + 32]
        return int.from_bytes(chunk.ljust(32, b"\x00"), "big")

    def fixed_columns(self, n: int):
        assert n == self.n
        cols = np.zeros((CC_NFIXED, n), dtype=np.uint32)
        layout = self._layout()
        for r, (ci, j) in enumerate(layout):
            destw, off, sw, sl = self.calls[ci]
            cols[CCF_ACTIVE, r] = 1
            if j == 0:
                cols[CCF_START, r] = 1
            cols[CCF_DEST, r] = destw + j
            cols[CCF_CDEST, r] = destw
            cols[CCF_COFF, r] = off
            cols[CCF_CSW, r] = sw
            cols[CCF_CSLACK, r] = sl
            if sl and j == sw - 1:
                cols[CCF_TAIL, r] = 1
                cols[CCF_TS + sl, r] = 1
            wv = self._word(off + 32 * j)
            for bit in range(256):
                if (wv >> bit) & 1:
                    cols[CCF_W0 + bit, r] = 1
        for r in range(n - 1):
            if r + 1 < len(layout) and layout[r + 1][1] != 0:
                cols[CCF_CONT_N, r] = 1
        return cols

    def trace(self, witness) -> np.ndarray:
        """witness: per call (clk[, tail_old])."""
        assert len(witness) == len(self.calls)
        tr = np.zeros((self.n, CC_WIDTH), dtype=np.uint32)
        r = 0
        for (destw, off, sw, sl), wit in zip(self.calls, witness):
            clk = wit[0] if isinstance(wit, (tuple, list)) else wit
            told = (
                wit[1] if isinstance(wit, (tuple, list)) and len(wit) > 1 else None
            )
            for j in range(sw):
                tr[r, CC_CLK] = clk
                if sl and j == sw - 1:
                    tr[r, CC_OLD0 : CC_OLD0 + 256] = _word_bits(told or 0)
                r += 1
        return tr

    def _terms(self, trace: np.ndarray, challenges):
        from .evm_air import fid_challenges

        challenges = fid_challenges(challenges, self.fid)
        chi = challenges[CHAL_CHI]
        pows = _np_chi_pows(chi, 40)
        n = trace.shape[0]
        t = trace.astype(np.uint64)
        fx = self.fixed_columns(n).astype(np.uint64)
        clk = t[:, CC_CLK]
        wbytes = np.zeros((n, 32), dtype=np.uint64)
        for j in range(32):
            wbytes[:, j] = sum(
                fx[CCF_W0 + 8 * j + bit] << np.uint64(bit) for bit in range(8)
            )
        gcp = np.array([x % bb.P for x in challenges[CHAL_CP]], dtype=np.uint64)
        code_call = _np_tuple_code(
            clk,
            [
                (fx[CCF_CDEST], 1),
                (fx[CCF_COFF], 2),
                (fx[CCF_CSW], 3),
                (np.ones(n, dtype=np.uint64), 4),  # kind 1 = code
                (fx[CCF_CSLACK], 5),
            ],
            pows,
        )
        inv_call = ef.npef_inv(ef.npef_sub(gcp[None, :], code_call))
        call_terms = ef.npef_mul(
            ef.npef_from_base((_PU - 1) * fx[CCF_START] % _PU), inv_call
        )
        gm = np.array([x % bb.P for x in challenges[CHAL_M]], dtype=np.uint64)
        obytes = _bits_to_bytes(trace[:, CC_OLD0 : CC_OLD0 + 256])
        slack_arr = np.zeros(n, dtype=np.int64)
        for tt in range(1, 32):
            slack_arr += tt * fx[CCF_TS + tt].astype(np.int64)
        keepmask = np.arange(32)[None, :] < slack_arr[:, None]
        wrbytes = np.where(
            (fx[CCF_TAIL] == 1)[:, None] & keepmask, obytes, wbytes
        )
        code_m = _np_tuple_code(
            fx[CCF_DEST],
            [(4 * clk + 2, 1), (np.ones(n, dtype=np.uint64), 2)]
            + [(wrbytes[:, j], j + 3) for j in range(32)],
            pows,
        )
        inv_m = ef.npef_inv(ef.npef_sub(gm[None, :], code_m))
        mem_terms = ef.npef_mul(ef.npef_from_base(fx[CCF_ACTIVE]), inv_m)
        code_o = _np_tuple_code(
            fx[CCF_DEST],
            [(4 * clk + 1, 1)]
            + [(obytes[:, j], j + 3) for j in range(32)],
            pows,
        )
        inv_o = ef.npef_inv(ef.npef_sub(gm[None, :], code_o))
        old_terms = ef.npef_mul(ef.npef_from_base(fx[CCF_TAIL]), inv_o)
        return call_terms, mem_terms, old_terms

    def aux_trace(self, trace: np.ndarray, challenges) -> np.ndarray:
        call_t, mem_t, old_t = self._terms(trace, challenges)
        aux = np.zeros((trace.shape[0], 12), dtype=np.uint32)
        aux[:, 0:4] = EvmCopyAir._excl(call_t)
        aux[:, 4:8] = EvmCopyAir._excl(mem_t)
        aux[:, 8:12] = EvmCopyAir._excl(old_t)
        return aux

    def bus_values(self, trace: np.ndarray, challenges) -> list[tuple]:
        call_t, mem_t, old_t = self._terms(trace, challenges)
        out = [ef.H_ZERO] * NUM_BUS
        out[BUS_CP] = tuple(int(v) for v in call_t.sum(axis=0) % _PU)
        out[BUS_MEM] = tuple(
            int(v) for v in (mem_t.sum(axis=0) + old_t.sum(axis=0)) % _PU
        )
        return out

    def eval(self, b: ConstraintBuilder) -> None:
        one = b.constant(1)
        chi = b.challenge_ef(CHAL_CHI)
        from .evm_air import _eval_chi97

        _c97 = _eval_chi97(b, chi)
        _fs = [b.mul(b.public(0), _c97[c]) for c in range(4)]
        g_cp = b.ef_sub4(b.challenge_ef(CHAL_CP), _fs)
        g_m = b.ef_sub4(b.challenge_ef(CHAL_M), _fs)
        active = b.fixed(CCF_ACTIVE)
        start = b.fixed(CCF_START)
        cont = b.fixed(CCF_CONT_N)
        destf = b.fixed(CCF_DEST)
        cdest = b.fixed(CCF_CDEST)
        coff = b.fixed(CCF_COFF)
        csw = b.fixed(CCF_CSW)
        clk = b.local(CC_CLK)
        clk_n = b.next(CC_CLK)
        Wfix = b.fixed_block(range(CCF_W0, CCF_W0 + 256))

        b.transition(b.mul(cont, b.sub(clk_n, clk)))
        b.all_rows(b.mul(b.sub(one, active), clk))

        chi2 = b.ef_mul4(chi, chi)
        chi3 = b.ef_mul4(chi2, chi)
        chi4 = b.ef_mul4(chi2, chi2)

        cslack = b.fixed(CCF_CSLACK)
        chi5 = b.ef_mul4(chi4, chi)
        code_call = b.ef_add4(
            b.ef_from_base4(clk),
            b.ef_add4(
                b.ef_add4(
                    b.ef_mul4(chi, b.ef_from_base4(cdest)),
                    b.ef_mul4(chi2, b.ef_from_base4(coff)),
                ),
                b.ef_add4(
                    b.ef_add4(
                        b.ef_mul4(chi3, b.ef_from_base4(csw)),
                        list(chi4),  # kind 1
                    ),
                    b.ef_mul4(chi5, b.ef_from_base4(cslack)),
                ),
            ),
        )
        accC = [b.aux(c) for c in range(4)]
        accC_n = [b.aux_next(c) for c in range(4)]
        prodC = b.ef_mul4(b.ef_sub4(accC_n, accC), b.ef_sub4(g_cp, code_call))
        start4 = b.ef_from_base4(start)
        for c in range(4):
            b.transition(b.add(prodC[c], start4[c]))
            b.first_row(accC[c])

        Oblk = b.local_block(range(CC_OLD0, CC_OLD0 + 256))
        tailf = b.fixed(CCF_TAIL)
        b.all_rows_block(b.mul(Oblk, b.sub(Oblk, one)), 256)
        b.all_rows_block(b.mul(b.sub(one, tailf), Oblk), 256)
        spl = b.mul(b.sub(one, tailf), Wfix)
        for t in range(1, 32):
            pat = b.concat_rows([Oblk[: 8 * t], Wfix[8 * t :]])
            spl = b.add(spl, b.mul(b.fixed(CCF_TS + t), pat))
        wcode = b.bit_block_code(spl, chi, b.constant(0), 32)
        inner = b.ef_add4(b.ef_from_base4(one), wcode)
        code_m = b.ef_add4(
            b.ef_from_base4(destf),
            b.ef_mul4(
                chi,
                b.ef_add4(
                    b.ef_from_base4(b.add(b.scale(4, clk), b.constant(2))),
                    b.ef_mul4(chi, inner),
                ),
            ),
        )
        accM = [b.aux(4 + c) for c in range(4)]
        accM_n = [b.aux_next(4 + c) for c in range(4)]
        prodM = b.ef_mul4(b.ef_sub4(accM_n, accM), b.ef_sub4(g_m, code_m))
        act4 = b.ef_from_base4(active)
        for c in range(4):
            b.transition(b.sub(prodM[c], act4[c]))
            b.first_row(accM[c])
        # tail-old READ at sub-clock +1
        ocode = b.bit_block_code(Oblk, chi, b.constant(0), 32)
        code_o = b.ef_add4(
            b.ef_from_base4(destf),
            b.ef_mul4(
                chi,
                b.ef_add4(
                    b.ef_from_base4(b.add(b.scale(4, clk), one)),
                    b.ef_mul4(chi, ocode),
                ),
            ),
        )
        accO = [b.aux(8 + c) for c in range(4)]
        accO_n = [b.aux_next(8 + c) for c in range(4)]
        prodO = b.ef_mul4(b.ef_sub4(accO_n, accO), b.ef_sub4(g_m, code_o))
        tact = b.ef_from_base4(tailf)
        for c in range(4):
            b.transition(b.sub(prodO[c], tact[c]))
            b.first_row(accO[c])

        for i in range(NUM_BUS):
            for c in range(4):
                if i == BUS_CP:
                    b.last_row(b.sub(accC[c], b.bus_coord(4 * i + c)))
                elif i == BUS_MEM:
                    b.last_row(
                        b.sub(
                            b.add(accM[c], accO[c]), b.bus_coord(4 * i + c)
                        )
                    )
                else:
                    b.last_row(b.bus_coord(4 * i + c))
