"""Call-composition tables (docs/EVM_COMPOSITION.md).

Three small AIRs close the cross-frame channels the CPU opens on its
call/callret rows:

  MemSpanBridgeAir   the ARGS/RET data bridges: one row per 32-byte word
      of a call's argument or returndata span.  The word values are
      FIXED columns built by the verifier from the counterpart frame's
      PUBLIC calldata/returndata, so "callee calldata == caller memory"
      reduces to RAM-channel consistency: each row sends one RAM tuple
      (read or write) into the OWNER frame's memory channel at the call
      row's side sub-clock, and the instance parameters (owner fid,
      sub-clock, kind, base word address, word count, counterpart fid)
      are bound in-circuit by receiving the caller CPU's bridge
      instancing tuple on BUS_BR.

  EvmAddrAir         the EIP-2929 address-access journal: per-frame
      PUBLIC groups [(address, count, prewarm)]; the first access of a
      group is cold unless prewarmed, later accesses warm — receiving
      the CPU's (4clk, cold, address) tuples makes the CALL rows' cold
      surcharges truthful (same journal discipline as EvmStorageAir).

  PrecompileCallAir  a precompile callee: receives the caller's CALLREQ
      and answers the CALLRET, entirely from instance publics (the gas
      formula is recomputed by the verifier when it rebuilds the
      publics).  Data movement for identity (0x04) is the two caller-
      side bridges sharing the same public words.

Reference analog: the callee frames the vendored zkVM guests execute
inline within calculate_block_header
(reference provers/risc0/guest/src/main.rs:15-29); the channel
shapes mirror the "interactions" composition used throughout the EVM
table group.
"""

from __future__ import annotations

import numpy as np

from ...fields import babybear as bb
from ...fields import babybear_ext as ef
from ..air import Air, ConstraintBuilder
from .evm_air import (
    BUS_AD,
    BUS_BL,
    BUS_BR,
    BUS_CQ,
    BUS_CR,
    BUS_MEM,
    CHAL_AD,
    CHAL_BL,
    CHAL_BR,
    CHAL_CHI,
    CHAL_CQ,
    CHAL_CR,
    CHAL_M,
    NUM_BUS,
    NUM_CHALLENGES,
    _np_chi_pows,
    _np_tuple_code,
    _pow2_atleast,
    fid_challenges,
    fid_gamma,
)

_PU = np.uint64(bb.P)

# bridge kinds (the BR tuple's chi^2 coefficient)
KIND_ARGS = 0
KIND_RETWRITE = 1
KIND_RETREAD = 2
KIND_LOGDATA = 3
KIND_INITCODE = 4  # CREATE: caller-memory span == the child's CODE

# publics layout of MemSpanBridgeAir
MB_FID = 0
MB_CLK4 = 1
MB_KIND = 2
MB_BASE = 3
MB_WC = 4
MB_OTHER = 5
MB_IW = 6
MB_NPUB = 7

# fixed: active + row index + 32 little-endian word bytes
BF_ACTIVE = 0
BF_ROW = 1
BF_B0 = 2
MB_NFIXED = BF_B0 + 32

# aux: BR-receive inverse witness + RAM-send accumulator
BA_INV = 0
BA_MEM = 4
MB_AUX_W = 8


class MemSpanBridgeAir(Air):
    """One row per word of a call-site args/returndata span."""

    width = 1  # single always-zero witness column
    aux_width = MB_AUX_W
    num_aux_challenges = NUM_CHALLENGES
    num_bus_values = NUM_BUS
    quotient_chunks = 2
    commit_fixed = True
    eager_quotient = True  # host-numpy constraint eval (tiny tables;
    # avoids a fresh multi-minute XLA:CPU compile per instance shape)

    def __init__(
        self,
        fid: int,
        clk4: int,
        kind: int,
        base_waddr: int,
        words: list[int],
        iw: int,
        other_fid: int,
    ):
        assert words and kind in (
            KIND_ARGS, KIND_RETWRITE, KIND_RETREAD, KIND_LOGDATA,
            KIND_INITCODE,
        )
        assert iw in (0, 1) and 0 <= base_waddr < (1 << 13)
        self.fid = int(fid)
        self.clk4 = int(clk4)
        self.kind = int(kind)
        self.base = int(base_waddr)
        self.words = [int(w) for w in words]
        self.iw = int(iw)
        self.other = int(other_fid)
        self.n = _pow2_atleast(len(words) + 1)  # floor 32: FRI shape

    def publics(self) -> list[int]:
        return [
            self.fid, self.clk4, self.kind, self.base, len(self.words),
            self.other, self.iw,
        ]

    def structure_key(self) -> tuple:
        return ()

    def fixed_columns(self, n: int):
        assert n == self.n
        cols = np.zeros((MB_NFIXED, n), dtype=np.uint32)
        for r, w in enumerate(self.words):
            cols[BF_ACTIVE, r] = 1
            cols[BF_ROW, r] = r
            for j in range(32):
                cols[BF_B0 + j, r] = (w >> (8 * j)) & 0xFF
        return cols

    def trace(self) -> np.ndarray:
        return np.zeros((self.n, 1), dtype=np.uint32)

    # ---------------- host-side channels ----------------
    def _inst_code(self, chi) -> tuple:
        pows = [ef.H_ONE]
        for _ in range(6):
            pows.append(ef.h_mul(pows[-1], chi))
        acc = ef.h_from_base(self.fid % bb.P)
        for v, e in (
            (self.clk4, 1),
            (self.kind, 2),
            (self.base, 3),
            (len(self.words), 4),
            (self.other, 5),
        ):
            if v:
                acc = ef.h_add(acc, ef.h_mul(ef.h_from_base(v % bb.P), pows[e]))
        return acc

    def _mem_terms(self, challenges) -> np.ndarray:
        ch = fid_challenges(challenges, self.fid)
        chi, g_m = ch[CHAL_CHI], ch[CHAL_M]
        pows = _np_chi_pows(chi, 36)
        n = self.n
        fx = self.fixed_columns(n).astype(np.uint64)
        waddr = (self.base + fx[BF_ROW]) * fx[BF_ACTIVE]
        vals = [(np.full(n, self.clk4, dtype=np.uint64), 1)]
        if self.iw:
            vals.append((fx[BF_ACTIVE], 2))
        vals += [(fx[BF_B0 + j], j + 3) for j in range(32)]
        code = _np_tuple_code(waddr, vals, pows)
        gm = np.array([x % bb.P for x in g_m], dtype=np.uint64)
        inv = ef.npef_inv(ef.npef_sub(gm[None, :], code))
        return ef.npef_mul(ef.npef_from_base(fx[BF_ACTIVE]), inv)

    def aux_trace(self, trace: np.ndarray, challenges) -> np.ndarray:
        from .evm_air import EvmCpuAir

        aux = np.zeros((self.n, MB_AUX_W), dtype=np.uint32)
        chi, g_br = challenges[CHAL_CHI], challenges[CHAL_BR]
        dinv = ef.h_batch_inv([ef.h_sub(g_br, self._inst_code(chi))])[0]
        aux[:, BA_INV : BA_INV + 4] = np.array(
            ef.h_neg(dinv), dtype=np.uint64
        )[None, :]
        aux[:, BA_MEM : BA_MEM + 4] = EvmCpuAir._excl_prefix(
            self._mem_terms(challenges)
        )
        return aux

    def bus_values(self, trace: np.ndarray, challenges) -> list[tuple]:
        chi, g_br = challenges[CHAL_CHI], challenges[CHAL_BR]
        dinv = ef.h_batch_inv([ef.h_sub(g_br, self._inst_code(chi))])[0]
        out = [ef.H_ZERO] * NUM_BUS
        out[BUS_BR] = ef.h_neg(dinv)
        out[BUS_MEM] = tuple(
            int(v) for v in self._mem_terms(challenges).sum(axis=0) % _PU
        )
        return out

    # ---------------- constraints ----------------
    def eval(self, b: ConstraintBuilder) -> None:
        one = b.constant(1)
        chi = b.challenge_ef(CHAL_CHI)
        g_m = fid_gamma(b, chi, b.challenge_ef(CHAL_M), b.public(MB_FID))
        g_br = b.challenge_ef(CHAL_BR)
        active = b.fixed(BF_ACTIVE)
        rowi = b.fixed(BF_ROW)
        # witness column is unused; pin to zero
        b.all_rows(b.local(0))
        # instancing tuple receive (-1) via the inverse witness
        chip = [b.ef_from_base4(one), list(chi)]
        for _ in range(4):
            chip.append(b.ef_mul4(chip[-1], chi))
        code_inst = b.ef_from_base4(b.public(MB_FID))
        for pub, e in (
            (MB_CLK4, 1), (MB_KIND, 2), (MB_BASE, 3), (MB_WC, 4), (MB_OTHER, 5),
        ):
            code_inst = b.ef_add4(
                code_inst,
                [b.mul(b.public(pub), chip[e][c]) for c in range(4)],
            )
        inv = [b.aux(BA_INV + c) for c in range(4)]
        prod = b.ef_mul4(inv, b.ef_sub4(g_br, code_inst))
        for c in range(4):
            b.last_row(b.add(prod[c], one if c == 0 else b.constant(0)))
        # RAM sends: waddr = base + row, value from the fixed bytes
        vcode = b.ef_from_base4(b.constant(0))
        pw = b.ef_mul4(b.ef_mul4(chi, chi), chi)  # chi^3
        for j in range(32):
            byt = b.fixed(BF_B0 + j)
            vcode = b.ef_add4(vcode, [b.mul(byt, pw[c]) for c in range(4)])
            if j < 31:
                pw = b.ef_mul4(pw, chi)
        code_m = b.ef_from_base4(b.add(b.mul(active, b.public(MB_BASE)), rowi))
        code_m = b.ef_add4(
            code_m,
            [
                b.mul(b.mul(active, b.public(MB_CLK4)), chi[c])
                for c in range(4)
            ],
        )
        code_m = b.ef_add4(
            code_m,
            [
                b.mul(b.mul(active, b.public(MB_IW)), chip[2][c])
                for c in range(4)
            ],
        )
        code_m = b.ef_add4(code_m, vcode)
        acc = [b.aux(BA_MEM + c) for c in range(4)]
        acc_n = [b.aux_next(BA_MEM + c) for c in range(4)]
        prodm = b.ef_mul4(b.ef_sub4(acc_n, acc), b.ef_sub4(g_m, code_m))
        act4 = b.ef_from_base4(active)
        for c in range(4):
            b.transition(b.sub(prodm[c], act4[c]))
            b.first_row(acc[c])
        for i in range(NUM_BUS):
            for c in range(4):
                if i == BUS_BR:
                    b.last_row(b.sub(inv[c], b.bus_coord(4 * i + c)))
                elif i == BUS_MEM:
                    b.last_row(b.sub(acc[c], b.bus_coord(4 * i + c)))
                else:
                    b.last_row(b.bus_coord(4 * i + c))


# --------------------------------------------------------------------------
# address-access journal
# --------------------------------------------------------------------------

# witness columns
AD_CLKB = 0  # 22 clk4 bits
AD_DB = 22  # 22 diff bits
AD_WIDTH = 44
# fixed
ADF_ACTIVE = 0
ADF_FIRST = 1
ADF_SA_N = 2
ADF_COLD = 3
ADF_L0 = 4  # 10 address limbs (16-bit)
AD_NFIXED = ADF_L0 + 10


class EvmAddrAir(Air):
    """One row per CALL-row address access, grouped by address."""

    width = AD_WIDTH
    aux_width = 4
    num_aux_challenges = NUM_CHALLENGES
    num_bus_values = NUM_BUS
    quotient_chunks = 2
    commit_fixed = True
    eager_quotient = True  # host-numpy constraint eval (tiny tables;
    # avoids a fresh multi-minute XLA:CPU compile per instance shape)

    def __init__(self, groups: list[tuple[int, int, int]], fid: int = 0):
        """groups: PUBLIC (address, count, prewarm), address-sorted."""
        assert groups
        prev = -1
        total = 0
        for a, count, prewarm in groups:
            assert 0 <= a < (1 << 160) and a > prev
            assert count >= 1 and prewarm in (0, 1)
            prev = a
            total += count
        self.groups = [(int(a), int(c), int(w)) for a, c, w in groups]
        self.fid = int(fid)
        self.total = total
        self.n = _pow2_atleast(total + 1)

    def structure_key(self) -> tuple:
        return ()

    def _layout(self):
        out = []
        for g, (a, count, w) in enumerate(self.groups):
            for k in range(count):
                out.append((g, k == 0))
        return out

    def fixed_columns(self, n: int):
        assert n == self.n
        cols = np.zeros((AD_NFIXED, n), dtype=np.uint32)
        layout = self._layout()
        for r, (g, first) in enumerate(layout):
            a, count, prewarm = self.groups[g]
            cols[ADF_ACTIVE, r] = 1
            cols[ADF_FIRST, r] = int(first)
            cols[ADF_COLD, r] = int(first and not prewarm)
            for i in range(10):
                cols[ADF_L0 + i, r] = (a >> (16 * i)) & 0xFFFF
        for r in range(n - 1):
            if r + 1 < len(layout) and not layout[r + 1][1]:
                cols[ADF_SA_N, r] = 1
        return cols

    def trace(self, accesses: list[tuple[int, int, int]]) -> np.ndarray:
        """accesses: (address, clk4, cold), any order."""
        assert len(accesses) == self.total
        acc = sorted(accesses, key=lambda a: (a[0], a[1]))
        tr = np.zeros((self.n, AD_WIDTH), dtype=np.uint32)
        prev_a = prev_c = None
        for r, (a, clk4, cold) in enumerate(acc):
            assert 0 <= clk4 < (1 << 22)
            for i in range(22):
                tr[r, AD_CLKB + i] = (clk4 >> i) & 1
            d = 0 if a != prev_a else clk4 - prev_c - 1
            assert 0 <= d < (1 << 22)
            for i in range(22):
                tr[r, AD_DB + i] = (d >> i) & 1
            prev_a, prev_c = a, clk4
        return tr

    def _terms(self, trace: np.ndarray, challenges) -> np.ndarray:
        ch = fid_challenges(challenges, self.fid)
        chi, g_ad = ch[CHAL_CHI], ch[CHAL_AD]
        pows = _np_chi_pows(chi, 12)
        n = self.n
        t = trace.astype(np.uint64)
        fx = self.fixed_columns(n).astype(np.uint64)
        clk4 = sum(t[:, AD_CLKB + i] << np.uint64(i) for i in range(22))
        code = _np_tuple_code(
            clk4,
            [(fx[ADF_COLD], 1)]
            + [(fx[ADF_L0 + i], 2 + i) for i in range(10)],
            pows,
        )
        gad = np.array([x % bb.P for x in g_ad], dtype=np.uint64)
        inv = ef.npef_inv(ef.npef_sub(gad[None, :], code))
        active = np.zeros(n, dtype=np.uint64)
        active[: self.total] = _PU - np.uint64(1)
        return ef.npef_mul(ef.npef_from_base(active), inv)

    def aux_trace(self, trace: np.ndarray, challenges) -> np.ndarray:
        from .evm_air import EvmCpuAir

        aux = np.zeros((self.n, 4), dtype=np.uint32)
        aux[:] = EvmCpuAir._excl_prefix(self._terms(trace, challenges))
        return aux

    def bus_values(self, trace: np.ndarray, challenges) -> list[tuple]:
        out = [ef.H_ZERO] * NUM_BUS
        out[BUS_AD] = tuple(
            int(v) for v in self._terms(trace, challenges).sum(axis=0) % _PU
        )
        return out

    def eval(self, b: ConstraintBuilder) -> None:
        one = b.constant(1)
        chi = b.challenge_ef(CHAL_CHI)
        g_ad = fid_gamma(b, chi, b.challenge_ef(CHAL_AD), b.public(0))
        active = b.fixed(ADF_ACTIVE)
        sa_n = b.fixed(ADF_SA_N)
        cold = b.fixed(ADF_COLD)

        def val(nx, base, nb):
            g = b.next if nx else b.local
            acc = None
            for i in range(nb):
                t = b.scale(1 << i, g(base + i))
                acc = t if acc is None else b.add(acc, t)
            return acc

        clk4 = val(False, AD_CLKB, 22)
        clk4_n = val(True, AD_CLKB, 22)
        d_n = val(True, AD_DB, 22)
        bits = b.local_block(list(range(AD_WIDTH)))
        b.all_rows_block(b.mul(bits, b.sub(bits, one)), AD_WIDTH)
        # strict clk ordering within a group
        b.transition(
            b.mul(sa_n, b.sub(d_n, b.sub(b.sub(clk4_n, clk4), one)))
        )
        # receive channel
        code = b.ef_from_base4(clk4)
        code = b.ef_add4(code, [b.mul(cold, chi[c]) for c in range(4)])
        pw = b.ef_mul4(chi, chi)
        for i in range(10):
            li = b.fixed(ADF_L0 + i)
            code = b.ef_add4(code, [b.mul(li, pw[c]) for c in range(4)])
            if i < 9:
                pw = b.ef_mul4(pw, chi)
        acc = [b.aux(c) for c in range(4)]
        acc_n = [b.aux_next(c) for c in range(4)]
        prod = b.ef_mul4(b.ef_sub4(acc_n, acc), b.ef_sub4(g_ad, code))
        act4 = b.ef_from_base4(active)
        for c in range(4):
            b.transition(b.add(prod[c], act4[c]))
            b.first_row(acc[c])
        for i in range(NUM_BUS):
            for c in range(4):
                if i == BUS_AD:
                    b.last_row(b.sub(acc[c], b.bus_coord(4 * i + c)))
                else:
                    b.last_row(b.bus_coord(4 * i + c))


# --------------------------------------------------------------------------
# precompile callee
# --------------------------------------------------------------------------

PRECOMPILE_ADDR = {"identity": 4}


def precompile_gas(kind: str, cds: int) -> int:
    if kind == "identity":
        return 15 + 3 * ((cds + 31) // 32)
    raise ValueError(kind)


# publics layout
PC_FID = 0  # this precompile instance's frame id
PC_CALLER_FID = 1
PC_CLK = 2
PC_GASIN_LO = 3
PC_GASIN_HI = 4
PC_GASRET_LO = 5
PC_GASRET_HI = 6
PC_CDS = 7
PC_ADDR = 8  # the precompile address (< 2^16)
PC_CALLER0 = 9  # 10 caller-address limbs
PC_STATIC = 19  # called from a static context (CALLREQ exp 42)
PC_NPUB = PC_STATIC + 1


class PrecompileCallAir(Air):
    """A precompile call: CALLREQ in, CALLRET out, all from publics."""

    width = 1
    aux_width = 8  # two inverse witnesses
    num_aux_challenges = NUM_CHALLENGES
    num_bus_values = NUM_BUS
    quotient_chunks = 2
    eager_quotient = True

    n = 32  # minimum FRI-friendly trace

    def __init__(
        self,
        fid: int,
        caller_fid: int,
        clk: int,
        gas_in: int,
        gas_ret: int,
        cds: int,
        addr: int,
        caller_addr: int,
        static: int = 0,
    ):
        self.fid = int(fid)
        self.caller_fid = int(caller_fid)
        self.clk = int(clk)
        self.gas_in = int(gas_in)
        self.gas_ret = int(gas_ret)
        self.cds = int(cds)
        self.addr = int(addr)
        self.caller_addr = int(caller_addr)
        self.static = int(static)

    def publics(self) -> list[int]:
        return [
            self.fid,
            self.caller_fid,
            self.clk,
            self.gas_in & 0xFFFF,
            self.gas_in >> 16,
            self.gas_ret & 0xFFFF,
            self.gas_ret >> 16,
            self.cds,
            self.addr,
        ] + [(self.caller_addr >> (16 * i)) & 0xFFFF for i in range(10)] + [
            self.static
        ]

    def structure_key(self) -> tuple:
        return ()

    def trace(self) -> np.ndarray:
        return np.zeros((self.n, 1), dtype=np.uint32)

    def _codes(self, challenges):
        chi = challenges[CHAL_CHI]
        pows = [ef.H_ONE]
        for _ in range(44):
            pows.append(ef.h_mul(pows[-1], chi))

        def hc(base, terms):
            acc = ef.h_from_base(base % bb.P)
            for v, e in terms:
                v = int(v) % bb.P
                if v:
                    acc = ef.h_add(acc, ef.h_mul(ef.h_from_base(v), pows[e]))
            return acc

        code_req = hc(
            self.caller_fid,
            [
                (self.clk, 1),
                (self.gas_in & 0xFFFF, 2),
                (self.gas_in >> 16, 3),
                (self.addr, 4),  # limb 0; limbs 1..9 zero
                (self.cds, 30),
            ]
            + [
                ((self.caller_addr >> (16 * i)) & 0xFFFF, 31 + i)
                for i in range(10)
            ]
            + [(self.fid, 41), (self.static, 42), (self.addr, 43)],
        )
        code_ret = hc(
            self.caller_fid,
            [
                (self.clk, 1),
                (self.gas_ret & 0xFFFF, 2),
                (self.gas_ret >> 16, 3),
                (1, 4),
                (self.cds, 5),  # rds == cds for identity
            ],
        )
        return code_req, code_ret

    def aux_trace(self, trace: np.ndarray, challenges) -> np.ndarray:
        code_req, code_ret = self._codes(challenges)
        g_cq, g_cr = challenges[CHAL_CQ], challenges[CHAL_CR]
        iq, ir = ef.h_batch_inv(
            [ef.h_sub(g_cq, code_req), ef.h_sub(g_cr, code_ret)]
        )
        aux = np.zeros((self.n, 8), dtype=np.uint32)
        aux[:, 0:4] = np.array(ef.h_neg(iq), dtype=np.uint64)[None, :]
        aux[:, 4:8] = np.array(ir, dtype=np.uint64)[None, :]
        return aux

    def bus_values(self, trace: np.ndarray, challenges) -> list[tuple]:
        code_req, code_ret = self._codes(challenges)
        g_cq, g_cr = challenges[CHAL_CQ], challenges[CHAL_CR]
        iq, ir = ef.h_batch_inv(
            [ef.h_sub(g_cq, code_req), ef.h_sub(g_cr, code_ret)]
        )
        out = [ef.H_ZERO] * NUM_BUS
        out[BUS_CQ] = ef.h_neg(iq)
        out[BUS_CR] = ir
        return out

    def eval(self, b: ConstraintBuilder) -> None:
        one = b.constant(1)
        chi = b.challenge_ef(CHAL_CHI)
        g_cq = b.challenge_ef(CHAL_CQ)
        g_cr = b.challenge_ef(CHAL_CR)
        b.all_rows(b.local(0))
        chip = [b.ef_from_base4(one), list(chi)]
        for _ in range(42):
            chip.append(b.ef_mul4(chip[-1], chi))

        def lincode(base, terms):
            acc = b.ef_from_base4(base)
            for ex, e in terms:
                acc = b.ef_add4(acc, [b.mul(ex, chip[e][c]) for c in range(4)])
            return acc

        code_req = lincode(
            b.public(PC_CALLER_FID),
            [
                (b.public(PC_CLK), 1),
                (b.public(PC_GASIN_LO), 2),
                (b.public(PC_GASIN_HI), 3),
                (b.public(PC_ADDR), 4),
                (b.public(PC_CDS), 30),
            ]
            + [(b.public(PC_CALLER0 + i), 31 + i) for i in range(10)]
            + [
                (b.public(PC_FID), 41),
                (b.public(PC_STATIC), 42),
                (b.public(PC_ADDR), 43),
            ],
        )
        code_ret = lincode(
            b.public(PC_CALLER_FID),
            [
                (b.public(PC_CLK), 1),
                (b.public(PC_GASRET_LO), 2),
                (b.public(PC_GASRET_HI), 3),
                (one, 4),
                (b.public(PC_CDS), 5),
            ],
        )
        iq = [b.aux(c) for c in range(4)]
        ir = [b.aux(4 + c) for c in range(4)]
        prodq = b.ef_mul4(iq, b.ef_sub4(g_cq, code_req))
        prodr = b.ef_mul4(ir, b.ef_sub4(g_cr, code_ret))
        for c in range(4):
            b.last_row(b.add(prodq[c], one if c == 0 else b.constant(0)))
            b.last_row(b.sub(prodr[c], one if c == 0 else b.constant(0)))
        for i in range(NUM_BUS):
            for c in range(4):
                if i == BUS_CQ:
                    b.last_row(b.sub(iq[c], b.bus_coord(4 * i + c)))
                elif i == BUS_CR:
                    b.last_row(b.sub(ir[c], b.bus_coord(4 * i + c)))
                else:
                    b.last_row(b.bus_coord(4 * i + c))


# --------------------------------------------------------------------------
# account-context table (BALANCE / EXTCODESIZE / EXTCODEHASH / BLOCKHASH)
# --------------------------------------------------------------------------

# fixed columns
ACF_ACTIVE = 0
ACF_KIND = 1
ACF_K0 = 2  # 10 key limbs (address / block number, 16-bit LE)
ACF_V0 = ACF_K0 + 10  # 32 little-endian value bytes
AC_NFIXED = ACF_V0 + 32
AC_MULT = 0
AC_WIDTH = 1


class AcctCtxAir(Air):
    """PUBLIC account-context rows (kind, key, value) with a witness
    multiplicity: kind 1 = balance, 2 = code size, 3 = code hash,
    4 = block hash (key = block number, incl. (n, 0) out-of-range rows).
    Receives the CPU's BUS_AC tuples, so every account-state opcode's
    pushed value is exactly the public record's.

    Trust scope: like the storage journal's prewarm flags, the record
    VALUES are payload publics — bound to the chain by the native
    re-execution path (and, for balances/code, by the same pre-state
    trie the prestate slot proves paths into)."""

    width = AC_WIDTH
    aux_width = 4
    num_aux_challenges = NUM_CHALLENGES
    num_bus_values = NUM_BUS
    quotient_chunks = 2
    commit_fixed = True
    eager_quotient = True

    def __init__(self, rows: list[tuple[int, int, int]], fid: int = 0):
        """rows: sorted unique (kind, key, value)."""
        assert rows
        prev = None
        for kind, key, value in rows:
            assert kind in (1, 2, 3, 4)
            assert 0 <= key < (1 << 160) and 0 <= value < (1 << 256)
            cur = (kind, key, value)
            assert prev is None or cur > prev, "rows must be sorted unique"
            prev = cur
        self.rows = [(int(k), int(a), int(v)) for k, a, v in rows]
        self.fid = int(fid)
        self.n = _pow2_atleast(len(rows) + 1)

    def structure_key(self) -> tuple:
        return ()

    def fixed_columns(self, n: int):
        assert n == self.n
        cols = np.zeros((AC_NFIXED, n), dtype=np.uint32)
        for r, (kind, key, value) in enumerate(self.rows):
            cols[ACF_ACTIVE, r] = 1
            cols[ACF_KIND, r] = kind
            for i in range(10):
                cols[ACF_K0 + i, r] = (key >> (16 * i)) & 0xFFFF
            for j in range(32):
                cols[ACF_V0 + j, r] = (value >> (8 * j)) & 0xFF
        return cols

    def trace(self, counts: list[int]) -> np.ndarray:
        assert len(counts) == len(self.rows)
        tr = np.zeros((self.n, AC_WIDTH), dtype=np.uint32)
        for r, c in enumerate(counts):
            tr[r, AC_MULT] = c % bb.P
        return tr

    def _terms(self, trace: np.ndarray, challenges) -> np.ndarray:
        from .evm_air import CHAL_AC

        ch = fid_challenges(challenges, self.fid)
        chi, g_ac = ch[CHAL_CHI], ch[CHAL_AC]
        pows = _np_chi_pows(chi, 44)
        n = self.n
        fx = self.fixed_columns(n).astype(np.uint64)
        code = _np_tuple_code(
            fx[ACF_KIND],
            [(fx[ACF_K0 + i], 1 + i) for i in range(10)]
            + [(fx[ACF_V0 + j], 11 + j) for j in range(32)],
            pows,
        )
        gac = np.array([x % bb.P for x in g_ac], dtype=np.uint64)
        inv = ef.npef_inv(ef.npef_sub(gac[None, :], code))
        mult = (
            (_PU - trace[:, AC_MULT].astype(np.uint64)) * fx[ACF_ACTIVE]
        ) % _PU
        return ef.npef_mul(ef.npef_from_base(mult), inv)

    def aux_trace(self, trace: np.ndarray, challenges) -> np.ndarray:
        from .evm_air import EvmCpuAir

        aux = np.zeros((self.n, 4), dtype=np.uint32)
        aux[:] = EvmCpuAir._excl_prefix(self._terms(trace, challenges))
        return aux

    def bus_values(self, trace: np.ndarray, challenges) -> list[tuple]:
        from .evm_air import BUS_AC

        out = [ef.H_ZERO] * NUM_BUS
        out[BUS_AC] = tuple(
            int(v) for v in self._terms(trace, challenges).sum(axis=0) % _PU
        )
        return out

    def eval(self, b: ConstraintBuilder) -> None:
        from .evm_air import BUS_AC, CHAL_AC

        chi = b.challenge_ef(CHAL_CHI)
        g_ac = fid_gamma(b, chi, b.challenge_ef(CHAL_AC), b.public(0))
        active = b.fixed(ACF_ACTIVE)
        mult = b.local(AC_MULT)
        code = b.ef_from_base4(b.fixed(ACF_KIND))
        pw = list(chi)
        for i in range(10):
            ki = b.fixed(ACF_K0 + i)
            code = b.ef_add4(code, [b.mul(ki, pw[c]) for c in range(4)])
            pw = b.ef_mul4(pw, chi)
        for j in range(32):
            vj = b.fixed(ACF_V0 + j)
            code = b.ef_add4(code, [b.mul(vj, pw[c]) for c in range(4)])
            if j < 31:
                pw = b.ef_mul4(pw, chi)
        acc = [b.aux(c) for c in range(4)]
        acc_n = [b.aux_next(c) for c in range(4)]
        prod = b.ef_mul4(b.ef_sub4(acc_n, acc), b.ef_sub4(g_ac, code))
        recv = b.ef_from_base4(b.mul(active, mult))
        for c in range(4):
            b.transition(b.add(prod[c], recv[c]))
            b.first_row(acc[c])
        for i in range(NUM_BUS):
            for c in range(4):
                if i == BUS_AC:
                    b.last_row(b.sub(acc[c], b.bus_coord(4 * i + c)))
                else:
                    b.last_row(b.bus_coord(4 * i + c))


# --------------------------------------------------------------------------
# log-record table (LOGn topics + data span, execution-bound)
# --------------------------------------------------------------------------

LGF_ACTIVE = 0
LGF_FAM = 1
LGF_OFFW = 2
LGF_SIZE = 3
LGF_T0 = 4  # 4 topics x 16 limbs (16-bit LE)
LG_NFIXED = LGF_T0 + 64
LG_CLK = 0
LG_WIDTH = 1


class EvmLogAir(Air):
    """PUBLIC per-LOG records (fam_n, data span, topic words), received
    once each from the CPU's BUS_LG channel — so every published topic
    word was REALLY read from the executing frame's stack, and the data
    span points at RAM words a kind-3 MemSpanBridgeAir read from the
    frame's memory.  The round-4 half of the execution<->receipt
    binding: the receipts-trie linkage (re-deriving the receipts root
    from these records) additionally needs the tx bodies public and
    remains on the roadmap."""

    width = LG_WIDTH
    aux_width = 4
    num_aux_challenges = NUM_CHALLENGES
    num_bus_values = NUM_BUS
    quotient_chunks = 2
    commit_fixed = True
    eager_quotient = True

    def __init__(self, records: list[tuple[int, int, int, list[int]]],
                 fid: int = 0):
        """records: (fam_n, offw, size, topics[4]) in execution order."""
        assert records
        for fam, offw, size, topics in records:
            assert 1 <= fam <= 5 and 0 <= offw < (1 << 13)
            assert 0 <= size < (1 << 13) and len(topics) == 4
            for ti in range(4):
                # absent topics are pinned zero (canonical form)
                assert ti < fam - 1 or topics[ti] == 0
        self.records = [
            (int(f), int(o), int(sz), [int(t) for t in tp])
            for f, o, sz, tp in records
        ]
        self.fid = int(fid)
        self.n = _pow2_atleast(len(records) + 1)

    def structure_key(self) -> tuple:
        return ()

    def fixed_columns(self, n: int):
        assert n == self.n
        cols = np.zeros((LG_NFIXED, n), dtype=np.uint32)
        for r, (fam, offw, size, topics) in enumerate(self.records):
            cols[LGF_ACTIVE, r] = 1
            cols[LGF_FAM, r] = fam
            cols[LGF_OFFW, r] = offw
            cols[LGF_SIZE, r] = size
            for ti in range(4):
                for i in range(16):
                    cols[LGF_T0 + 16 * ti + i, r] = (
                        topics[ti] >> (16 * i)
                    ) & 0xFFFF
        return cols

    def trace(self, clks: list[int]) -> np.ndarray:
        assert len(clks) == len(self.records)
        tr = np.zeros((self.n, LG_WIDTH), dtype=np.uint32)
        for r, c in enumerate(clks):
            tr[r, LG_CLK] = c
        return tr

    def _terms(self, trace: np.ndarray, challenges) -> np.ndarray:
        from .evm_air import CHAL_LG

        ch = fid_challenges(challenges, self.fid)
        chi, g_lg = ch[CHAL_CHI], ch[CHAL_LG]
        pows = _np_chi_pows(chi, 68)
        n = self.n
        fx = self.fixed_columns(n).astype(np.uint64)
        code = _np_tuple_code(
            trace[:, LG_CLK].astype(np.uint64),
            [(fx[LGF_FAM], 1), (fx[LGF_OFFW], 2), (fx[LGF_SIZE], 3)]
            + [(fx[LGF_T0 + j], 4 + j) for j in range(64)],
            pows,
        )
        glg = np.array([x % bb.P for x in g_lg], dtype=np.uint64)
        inv = ef.npef_inv(ef.npef_sub(glg[None, :], code))
        active = np.zeros(n, dtype=np.uint64)
        active[: len(self.records)] = _PU - np.uint64(1)
        return ef.npef_mul(ef.npef_from_base(active), inv)

    def aux_trace(self, trace: np.ndarray, challenges) -> np.ndarray:
        from .evm_air import EvmCpuAir

        aux = np.zeros((self.n, 4), dtype=np.uint32)
        aux[:] = EvmCpuAir._excl_prefix(self._terms(trace, challenges))
        return aux

    def bus_values(self, trace: np.ndarray, challenges) -> list[tuple]:
        from .evm_air import BUS_LG

        out = [ef.H_ZERO] * NUM_BUS
        out[BUS_LG] = tuple(
            int(v) for v in self._terms(trace, challenges).sum(axis=0) % _PU
        )
        return out

    def eval(self, b: ConstraintBuilder) -> None:
        from .evm_air import BUS_LG, CHAL_LG

        chi = b.challenge_ef(CHAL_CHI)
        g_lg = fid_gamma(b, chi, b.challenge_ef(CHAL_LG), b.public(0))
        active = b.fixed(LGF_ACTIVE)
        clk = b.local(LG_CLK)
        code = b.ef_from_base4(clk)
        pw = list(chi)
        for col, e in ((LGF_FAM, 1), (LGF_OFFW, 2), (LGF_SIZE, 3)):
            code = b.ef_add4(
                code, [b.mul(b.fixed(col), pw[c]) for c in range(4)]
            )
            pw = b.ef_mul4(pw, chi)
        for j in range(64):
            vj = b.fixed(LGF_T0 + j)
            code = b.ef_add4(code, [b.mul(vj, pw[c]) for c in range(4)])
            if j < 63:
                pw = b.ef_mul4(pw, chi)
        acc = [b.aux(c) for c in range(4)]
        acc_n = [b.aux_next(c) for c in range(4)]
        prod = b.ef_mul4(b.ef_sub4(acc_n, acc), b.ef_sub4(g_lg, code))
        act4 = b.ef_from_base4(active)
        for c in range(4):
            b.transition(b.add(prod[c], act4[c]))
            b.first_row(acc[c])
        for i in range(NUM_BUS):
            for c in range(4):
                if i == BUS_LG:
                    b.last_row(b.sub(acc[c], b.bus_coord(4 * i + c)))
                else:
                    b.last_row(b.bus_coord(4 * i + c))


# --------------------------------------------------------------------------
# balance journal (value-bearing CALL + BALANCE/SELFBALANCE, round 5)
# --------------------------------------------------------------------------

# fixed columns
BLF_ACTIVE = 0
BLF_FIRST = 1  # first row of an address group (running = original)
BLF_LASTG = 2  # last row of an address group (post-event = final)
BLF_A0 = 3  # 10 address limbs (16-bit LE)
BLF_ORIG0 = BLF_A0 + 10  # 32 LE original-balance bytes (first row)
BLF_FIN0 = BLF_ORIG0 + 32  # 32 LE final-balance bytes (last row)
BL_NFIXED = BLF_FIN0 + 32
# witness columns (all bits)
BL_KD = 0  # debit
BL_KC = 1  # credit (read = active & !kd & !kc)
BL_FID0 = 2  # 6 frame-id bits
BL_CLK0 = 8  # 22 clk4 bits
BL_V0 = 30  # 256 value bits
BL_B0 = BL_V0 + 256  # 256 running-balance-before bits
BL_C0 = BL_B0 + 256  # 16 adder carry bits
BL_WIDTH = BL_C0 + 16


class EvmBalanceAir(Air):
    """The TREE-level read-write balance journal (reference analog: the
    revm balance state the vendored guests mutate inline,
    reference lib/src/builder.rs:113-128).

    PUBLIC per-address groups (address, original, final, count); one
    witness row per event, grouped by address.  Every event tuple
    (fid, clk4, kind, addr, value) is RECEIVED once from some frame's
    CPU over BUS_BL (gamma unshifted; the frame id rides inside the
    tuple), so the event multiset is exactly what the executions sent:

      read   (kind 1): value == running balance, running unchanged
      debit  (kind 2): running -= value, with a no-borrow carry chain
                       (insufficient balance is unsatisfiable)
      credit (kind 3): running += value, no 2^256 wrap

    The first row of a group pins running = original; the last row pins
    post-event running = final.  Ordering WITHIN a group is
    prover-chosen (no global cross-frame clock exists; the same
    documented scope as the prestate group order, docs/SOUNDNESS.md) —
    originals/finals are payload publics anchored by the outer
    statement the way storage originals are."""

    width = BL_WIDTH
    aux_width = 4
    num_aux_challenges = NUM_CHALLENGES
    num_bus_values = NUM_BUS
    quotient_chunks = 2
    commit_fixed = True
    eager_quotient = True

    def __init__(self, groups: list[tuple[int, int, int, int]]):
        """groups: (address, original, final, count), address-sorted."""
        assert groups
        prev = -1
        total = 0
        for a, orig, fin, count in groups:
            assert 0 <= a < (1 << 160) and a > prev
            assert 0 <= orig < (1 << 256) and 0 <= fin < (1 << 256)
            assert count >= 1
            prev = a
            total += count
        self.groups = [
            (int(a), int(o), int(f), int(c)) for a, o, f, c in groups
        ]
        self.total = total
        self.n = _pow2_atleast(total + 1)

    def publics(self) -> list[int]:
        out = [len(self.groups)]
        for a, o, f, c in self.groups:
            out.extend([(a >> (16 * i)) & 0xFFFF for i in range(10)])
            out.extend([(o >> (16 * i)) & 0xFFFF for i in range(16)])
            out.extend([(f >> (16 * i)) & 0xFFFF for i in range(16)])
            out.append(c)
        return out

    def structure_key(self) -> tuple:
        return ()

    def fixed_columns(self, n: int):
        assert n == self.n
        cols = np.zeros((BL_NFIXED, n), dtype=np.uint32)
        r = 0
        for a, orig, fin, count in self.groups:
            for k in range(count):
                cols[BLF_ACTIVE, r] = 1
                cols[BLF_FIRST, r] = int(k == 0)
                cols[BLF_LASTG, r] = int(k == count - 1)
                for i in range(10):
                    cols[BLF_A0 + i, r] = (a >> (16 * i)) & 0xFFFF
                for j in range(32):
                    cols[BLF_ORIG0 + j, r] = (orig >> (8 * j)) & 0xFF
                    cols[BLF_FIN0 + j, r] = (fin >> (8 * j)) & 0xFF
                r += 1
        return cols

    def trace(self, events: list[list[tuple[int, int, int, int]]]) -> np.ndarray:
        """events: per group, ordered (fid, clk4, kind, value); the
        running balance chain is recomputed here."""
        assert len(events) == len(self.groups)
        tr = np.zeros((self.n, BL_WIDTH), dtype=np.uint32)
        r = 0
        for (a, orig, fin, count), evs in zip(self.groups, events):
            assert len(evs) == count
            run = orig
            for fid, clk4, kind, value in evs:
                assert kind in (1, 2, 3) and 0 <= value < (1 << 256)
                assert 0 <= fid < (1 << 6) and 0 <= clk4 < (1 << 22)
                row = tr[r]
                if kind == 2:
                    row[BL_KD] = 1
                elif kind == 3:
                    row[BL_KC] = 1
                for i in range(6):
                    row[BL_FID0 + i] = (fid >> i) & 1
                for i in range(22):
                    row[BL_CLK0 + i] = (clk4 >> i) & 1
                for i in range(256):
                    row[BL_V0 + i] = (value >> i) & 1
                    row[BL_B0 + i] = (run >> i) & 1
                if kind == 1:
                    assert value == run, "read must see the running balance"
                    after = run
                elif kind == 2:
                    assert run >= value, "debit underflow"
                    after = run - value
                else:
                    after = run + value
                    assert after < (1 << 256), "credit overflow"
                # carry chain of the 16-bit limb adder (debit: after +
                # value = before; credit: before + value = after)
                x = after if kind == 2 else run
                z = run if kind == 2 else after
                c = 0
                for i in range(16):
                    if kind == 1:
                        break
                    s = ((x >> (16 * i)) & 0xFFFF) + (
                        (value >> (16 * i)) & 0xFFFF
                    ) + c
                    c = s >> 16
                    assert (s & 0xFFFF) == (z >> (16 * i)) & 0xFFFF
                    tr[r, BL_C0 + i] = c
                assert kind == 1 or c == 0
                run = after
                r += 1
            assert run == fin, "group final mismatch"
        return tr

    def _terms(self, trace: np.ndarray, challenges) -> np.ndarray:
        chi, g_bl = challenges[CHAL_CHI], challenges[CHAL_BL]
        pows = _np_chi_pows(chi, 46)
        n = self.n
        t = trace.astype(np.uint64)
        fx = self.fixed_columns(n).astype(np.uint64)
        fid = sum(t[:, BL_FID0 + i] << np.uint64(i) for i in range(6))
        clk4 = sum(t[:, BL_CLK0 + i] << np.uint64(i) for i in range(22))
        kind = 1 + t[:, BL_KD] + 2 * t[:, BL_KC]
        vbytes = [
            sum(
                t[:, BL_V0 + 8 * j + bit] << np.uint64(bit)
                for bit in range(8)
            )
            for j in range(32)
        ]
        code = _np_tuple_code(
            fid,
            [(clk4, 1), (kind, 2)]
            + [(fx[BLF_A0 + i], 3 + i) for i in range(10)]
            + [(vbytes[j], 13 + j) for j in range(32)],
            pows,
        )
        gbl = np.array([x % bb.P for x in g_bl], dtype=np.uint64)
        inv = ef.npef_inv(ef.npef_sub(gbl[None, :], code))
        active = np.zeros(n, dtype=np.uint64)
        active[: self.total] = _PU - np.uint64(1)  # receive: -1
        return ef.npef_mul(ef.npef_from_base(active), inv)

    def aux_trace(self, trace: np.ndarray, challenges) -> np.ndarray:
        from .evm_air import EvmCpuAir

        aux = np.zeros((self.n, 4), dtype=np.uint32)
        aux[:] = EvmCpuAir._excl_prefix(self._terms(trace, challenges))
        return aux

    def bus_values(self, trace: np.ndarray, challenges) -> list[tuple]:
        out = [ef.H_ZERO] * NUM_BUS
        out[BUS_BL] = tuple(
            int(v) for v in self._terms(trace, challenges).sum(axis=0) % _PU
        )
        return out

    def eval(self, b: ConstraintBuilder) -> None:
        one = b.constant(1)
        chi = b.challenge_ef(CHAL_CHI)
        g_bl = b.challenge_ef(CHAL_BL)
        active = b.fixed(BLF_ACTIVE)
        first = b.fixed(BLF_FIRST)
        lastg = b.fixed(BLF_LASTG)
        kd = b.local(BL_KD)
        kc = b.local(BL_KC)
        kr = b.sub(active, b.add(kd, kc))
        # booleanity + gating
        bits = b.local_block(range(BL_WIDTH))
        b.all_rows_block(b.mul(bits, b.sub(bits, one)), BL_WIDTH)
        b.all_rows(b.mul(kd, kc))
        b.all_rows(b.mul(b.add(kd, kc), b.sub(one, active)))

        def limbs(base, nx=False):
            g = b.next if nx else b.local
            out = []
            for i in range(16):
                acc = None
                for bit in range(16):
                    tv = b.scale(1 << bit, g(base + 16 * i + bit))
                    acc = tv if acc is None else b.add(acc, tv)
                out.append(acc)
            return out

        def fixed_limbs(base):
            out = []
            for i in range(16):
                lo = b.fixed(base + 2 * i)
                hi = b.fixed(base + 2 * i + 1)
                out.append(b.add(lo, b.scale(256, hi)))
            return out

        val_l = limbs(BL_V0)
        bal_l = limbs(BL_B0)
        bal_ln = limbs(BL_B0, nx=True)
        orig_l = fixed_limbs(BLF_ORIG0)
        fin_l = fixed_limbs(BLF_FIN0)
        # first row of a group: running = original
        for i in range(16):
            b.all_rows(b.mul(first, b.sub(bal_l[i], orig_l[i])))
        # reads: value == running
        for i in range(16):
            b.all_rows(b.mul(kr, b.sub(val_l[i], bal_l[i])))
        # post-event running ("after"): final on the group's last row,
        # the next row's running otherwise; adders per event kind
        for i in range(16):
            aft = b.add(
                b.mul(lastg, fin_l[i]),
                b.mul(b.sub(active, lastg), bal_ln[i]),
            )
            cprev = b.local(BL_C0 + i - 1) if i else b.constant(0)
            ci = b.local(BL_C0 + i)
            # debit: after + value + c_prev = before + 2^16 c
            b.transition(
                b.mul(
                    kd,
                    b.sub(
                        b.add(b.add(aft, val_l[i]), cprev),
                        b.add(bal_l[i], b.scale(1 << 16, ci)),
                    ),
                )
            )
            # credit: before + value + c_prev = after + 2^16 c
            b.transition(
                b.mul(
                    kc,
                    b.sub(
                        b.add(b.add(bal_l[i], val_l[i]), cprev),
                        b.add(aft, b.scale(1 << 16, ci)),
                    ),
                )
            )
            # read: after == before
            b.transition(b.mul(kr, b.sub(aft, bal_l[i])))
        # no borrow on debit / no wrap on credit: final carry must clear
        b.all_rows(b.mul(b.add(kd, kc), b.local(BL_C0 + 15)))
        # receive channel: code(fid, clk4, kind, addr, value bytes)
        fid_v = None
        for i in range(6):
            tv = b.scale(1 << i, b.local(BL_FID0 + i))
            fid_v = tv if fid_v is None else b.add(fid_v, tv)
        clk4_v = None
        for i in range(22):
            tv = b.scale(1 << i, b.local(BL_CLK0 + i))
            clk4_v = tv if clk4_v is None else b.add(clk4_v, tv)
        kind_v = b.add(b.add(active, kd), b.scale(2, kc))
        code = b.ef_from_base4(fid_v)
        code = b.ef_add4(code, [b.mul(clk4_v, chi[c]) for c in range(4)])
        chi2 = b.ef_mul4(chi, chi)
        code = b.ef_add4(code, [b.mul(kind_v, chi2[c]) for c in range(4)])
        pw = b.ef_mul4(chi2, chi)
        for i in range(10):
            ai = b.fixed(BLF_A0 + i)
            code = b.ef_add4(code, [b.mul(ai, pw[c]) for c in range(4)])
            if i < 9:
                pw = b.ef_mul4(pw, chi)
        # pw == chi^12 here; bit_block_code emits byte j at chi^{j+1},
        # so the value bytes land at chi^{13+j} as in the CPU's send
        vblk = b.local_block(range(BL_V0, BL_V0 + 256))
        vcode = b.bit_block_code(vblk, chi, b.constant(0), 32)
        code = b.ef_add4(code, b.ef_mul4(pw, vcode))
        acc = [b.aux(c) for c in range(4)]
        acc_n = [b.aux_next(c) for c in range(4)]
        prod = b.ef_mul4(b.ef_sub4(acc_n, acc), b.ef_sub4(g_bl, code))
        act4 = b.ef_from_base4(active)
        for c in range(4):
            b.transition(b.add(prod[c], act4[c]))
            b.first_row(acc[c])
        for i in range(NUM_BUS):
            for c in range(4):
                if i == BUS_BL:
                    b.last_row(b.sub(acc[c], b.bus_coord(4 * i + c)))
                else:
                    b.last_row(b.bus_coord(4 * i + c))
