"""KECCAK256 bridge: binds EVM hash calls to the keccak sponge tables.

The zkEVM statement's KECCAK256 coverage (PARITY roadmap #1 "KECCAK256
bridged to the sponge table") spans three tables inside ONE multi-table
proof (prover.prove_tables) with the EVM execution tables
(stark/airs/evm_air.py):

  EvmKeccakCallAir (this file)  the bridge: one row per byte of every
      hashed (and padded) memory range.  It RECEIVES one hash-call tuple
      per KECCAK256 from the CPU (channel BUS_KCALL), SENDS one word-read
      tuple per 32-byte group to the RAM table (channel BUS_MEM — so the
      hashed bytes ARE the committed memory), SENDS one rate-block code
      per 136-byte keccak block (channel BUS_BLOCKS), and RECEIVES one
      digest code per message from the sponge (channel BUS_DIG) — closing
      the loop digest == keccak(memory[offset:offset+size]).
  EvmSpongeAir                  KeccakSpongeV2Air (keccak_air.py) with
      the challenge/bus indices remapped into the EVM group's layout:
      it absorbs the bridge's rate blocks and emits digest codes.

Public structure: the per-call (word_offset, size) list — published in
the frame payload; byte content and digests remain witness, bound by the
channels.  Keccak padding bytes are FIXED columns (derived from size);
"slack" rows (tail bytes of the last 32-byte word beyond size) are read
from RAM but skipped by the block-code accumulation via hold selectors.

Accumulator conventions follow containment.py: Horner word/block codes
as inclusive per-row aux registers, channel accumulators as EXCLUSIVE
prefixes bound to the bus on the (always inactive) last row.

Reference analog: the KECCAK256 interpreter opcode proven inside the
vendored zkVM guests (revm interpreter under provers/risc0/guest,
SURVEY.md §3.5); the bridge/sponge split mirrors the "interactions"
composition of the vendored sp1/plonky3 provers (SURVEY.md §2.2).
"""

from __future__ import annotations

import numpy as np

from ...fields import babybear as bb
from ...fields import babybear_ext as ef
from ..air import Air, ConstraintBuilder
from .containment import RATE_BYTES, pad_keccak
from .keccak_air import KeccakSpongeV2Air
from .evm_air import (
    BUS_BLOCKS,
    BUS_CD,
    BUS_DIG,
    BUS_FETCH,
    BUS_KCALL,
    BUS_MEM,
    BUS_STACK,
    CHAL_B,
    CHAL_CHI,
    CHAL_D,
    CHAL_K,
    CHAL_M,
    NUM_BUS,
    NUM_CHALLENGES,
    _np_chi_pows,
    _pow2_atleast,
)

_PU = np.uint64(bb.P)

# sponge block key stride (must match containment.block_code keys)
from .containment import MAX_BLOCKS  # noqa: E402


class EvmSpongeAir(KeccakSpongeV2Air):
    """The keccak sponge embedded in the EVM group's channel layout."""

    CH_B = CHAL_B
    CH_CHI = CHAL_CHI
    CH_D = CHAL_D
    CH_T = CHAL_D  # gamma_T is unused by the sponge; any valid index
    BUS_B = BUS_BLOCKS
    BUS_D = BUS_DIG
    num_aux_challenges = NUM_CHALLENGES
    num_bus_values = BUS_DIG + 1


# --------------------------------------------------------------------------
# bridge layout
# --------------------------------------------------------------------------

# witness columns
KC_BYTE = 0
KC_BITS = 1  # 8 bit columns
KC_CLK = 9  # raw clk column (constant within a call)
KC_DGST = 10  # 256 digest bits (meaningful on call-end rows)
KC_WIDTH = KC_DGST + 256

# aux columns (EF x4 each)
KA_WACC = 0  # word Horner code (big-endian byte order)
KA_BPOW = 4  # chi power within the current rate block
KA_BCODE = 8  # running rate-block code
KA_BUS_M = 12  # RAM sends (exclusive prefix)
KA_BUS_B = 16  # rate-block sends
KA_BUS_D = 20  # digest receives
KA_BUS_K = 24  # hash-call receives
KC_AUX_W = 28

# fixed columns (public layout from the (offw, size) call list)
KF_ACTIVE = 0
KF_WORDROW = 1
KF_WSTART = 2
KF_WEND = 3
KF_WCONT_N = 4  # next row continues this 32-byte word group
KF_OFFW = 5  # RAM word address of this row's word
KF_HASH = 6  # row's byte is part of the padded message (not slack)
KF_HSTART = 7  # padded position % 136 == 0
KF_HEND = 8  # padded position % 136 == 135
KF_STEP_N = 9  # next row is a hashed in-block continuation
KF_HOLD_N = 10  # next row is slack: block accumulators hold
KF_CCONT_N = 11  # next row belongs to the same call
KF_PAD = 12
KF_PADV = 13
KF_CEND = 14  # last row of the call (digest + call-tuple bindings)
KF_MSGID = 15
KF_SIZEF = 16
KF_OFFC = 17
KF_BKEY = 18  # sponge block key: msg_id * MAX_BLOCKS + block_idx
KC_NFIXED = 19

_DGST_NAT = [KC_DGST + i for i in range(256)]  # digest natural byte order
# reversed byte order: the CPU pushes the digest as a big-endian word, so
# its little-endian byte j is digest[31 - j]
_DGST_REV = [
    KC_DGST + 8 * (31 - j) + bit for j in range(32) for bit in range(8)
]


def call_padded_len(size: int) -> int:
    return (size // RATE_BYTES + 1) * RATE_BYTES


def call_rows(size: int) -> int:
    """32*ceil(size/32) word rows + the pad rows."""
    sw = (size + 31) // 32
    return 32 * sw + (call_padded_len(size) - size)


class EvmKeccakCallAir(Air):
    """One row per byte of every KECCAK256'd (padded) memory range."""

    width = KC_WIDTH
    aux_width = KC_AUX_W
    num_aux_challenges = NUM_CHALLENGES
    num_bus_values = NUM_BUS
    quotient_chunks = 2
    commit_fixed = True
    eager_quotient = True

    def __init__(self, calls: list[tuple[int, int]], fid: int = 0):
        """calls: PUBLIC (word_offset, size) per KECCAK256, call order.

        ``fid`` instances the per-frame channels (RAM reads, hash-call
        receives) by the gamma shift, and strides the sponge message ids
        by fid * MAX_KECCAK_CALLS so block/digest tuples of different
        frames never alias (docs/EVM_COMPOSITION.md instancing)."""
        assert calls, "bridge table requires at least one call"
        from .evm_air import MAX_KECCAK_CALLS

        assert len(calls) <= MAX_KECCAK_CALLS
        for offw, size in calls:
            assert 0 <= offw < (1 << 13) and 0 <= size < (1 << 13)
        self.fid = int(fid)
        self.msg_base = self.fid * MAX_KECCAK_CALLS
        self.calls = [(int(o), int(s)) for o, s in calls]
        self.total_rows = sum(call_rows(s) for _, s in self.calls)
        self.n = _pow2_atleast(self.total_rows + 1)

    def structure_key(self) -> tuple:
        return ()

    def block_counts(self) -> list[int]:
        return [call_padded_len(s) // RATE_BYTES for _, s in self.calls]

    # ---------------- row enumeration ----------------
    def _layout(self):
        """Per active row: dict of layout facts."""
        rows = []
        for m, (offw, size) in enumerate(self.calls):
            sw = (size + 31) // 32
            plen = call_padded_len(size)
            pad = pad_keccak(bytes(size))[size:]  # pad byte values
            nrows = call_rows(size)
            start = len(rows)
            for wi in range(sw):
                for j in range(32):
                    pos = 32 * wi + j
                    hashed = pos < size
                    rows.append(
                        {
                            "m": m,
                            "word": True,
                            "wstart": j == 0,
                            "wend": j == 31,
                            "offw": offw + wi,
                            "hash": hashed,
                            "hpos": pos if hashed else None,
                            "pad": False,
                            "padv": 0,
                            "cend": False,
                        }
                    )
            for k in range(plen - size):
                rows.append(
                    {
                        "m": m,
                        "word": False,
                        "wstart": False,
                        "wend": False,
                        "offw": 0,
                        "hash": True,
                        "hpos": size + k,
                        "pad": True,
                        "padv": pad[k],
                        "cend": k == plen - size - 1,
                    }
                )
            assert len(rows) - start == nrows
        return rows

    def fixed_columns(self, n: int):
        assert n == self.n
        cols = np.zeros((KC_NFIXED, n), dtype=np.uint32)
        layout = self._layout()
        for r, row in enumerate(layout):
            m = row["m"]
            cols[KF_ACTIVE, r] = 1
            if row["word"]:
                cols[KF_WORDROW, r] = 1
                cols[KF_WSTART, r] = row["wstart"]
                cols[KF_WEND, r] = row["wend"]
                cols[KF_OFFW, r] = row["offw"]
            if row["hash"]:
                cols[KF_HASH, r] = 1
                cols[KF_HSTART, r] = row["hpos"] % RATE_BYTES == 0
                cols[KF_HEND, r] = row["hpos"] % RATE_BYTES == RATE_BYTES - 1
                cols[KF_BKEY, r] = (
                    (self.msg_base + m) * MAX_BLOCKS
                    + row["hpos"] // RATE_BYTES
                )
            if row["pad"]:
                cols[KF_PAD, r] = 1
                cols[KF_PADV, r] = row["padv"]
            if row["cend"]:
                cols[KF_CEND, r] = 1
                cols[KF_MSGID, r] = self.msg_base + m
                cols[KF_SIZEF, r] = self.calls[m][1]
                cols[KF_OFFC, r] = self.calls[m][0]
        for r, row in enumerate(layout):
            nxt = layout[r + 1] if r + 1 < len(layout) else None
            if nxt is None:
                continue
            if row["word"] and nxt["word"] and not nxt["wstart"]:
                cols[KF_WCONT_N, r] = 1
            if nxt["hash"] and nxt["hpos"] % RATE_BYTES != 0:
                cols[KF_STEP_N, r] = 1
            if not nxt["hash"]:  # next row is slack
                cols[KF_HOLD_N, r] = 1
            if nxt["m"] == row["m"]:
                cols[KF_CCONT_N, r] = 1
        return cols

    # ---------------- trace ----------------
    def trace(self, witness: list[tuple[int, list[int], bytes]]) -> np.ndarray:
        """witness[m] = (clk, words, digest) for call m."""
        assert len(witness) == len(self.calls)
        tr = np.zeros((self.n, KC_WIDTH), dtype=np.uint32)
        layout = self._layout()
        # per-call byte streams
        streams = []
        for (offw, size), (clk, words, digest) in zip(self.calls, witness):
            sw = (size + 31) // 32
            assert len(words) == sw
            data = b"".join(w.to_bytes(32, "big") for w in words)
            pad = pad_keccak(data[:size])[size:]
            streams.append((clk, data, pad, digest))
        idx = {m: 0 for m in range(len(self.calls))}
        for r, row in enumerate(layout):
            m = row["m"]
            clk, data, pad, digest = streams[m]
            i = idx[m]
            if row["word"]:
                byt = data[i]
            else:
                byt = pad[i - len(data)]
            idx[m] = i + 1
            tr[r, KC_BYTE] = byt
            for bit in range(8):
                tr[r, KC_BITS + bit] = (byt >> bit) & 1
            tr[r, KC_CLK] = clk
            if row["cend"]:
                for bi in range(32):
                    for bit in range(8):
                        tr[r, KC_DGST + 8 * bi + bit] = (digest[bi] >> bit) & 1
        return tr

    # ---------------- host-side channel terms / aux ----------------
    def _aux_and_bus(self, trace: np.ndarray, challenges):
        from .evm_air import fid_challenges

        challenges = fid_challenges(challenges, self.fid)
        chi = challenges[CHAL_CHI]
        g_m = challenges[CHAL_M]
        g_b = challenges[CHAL_B]
        g_d = challenges[CHAL_D]
        g_k = challenges[CHAL_K]
        layout = self._layout()
        n = self.n
        aux = np.zeros((n, KC_AUX_W), dtype=np.uint32)
        chi3 = ef.h_mul(ef.h_mul(chi, chi), chi)

        def scale(v, x):
            return ef.h_mul(ef.h_from_base(v % bb.P), x)

        # inclusive word/block registers
        wacc = ef.H_ZERO
        bpow = ef.H_ONE
        bcode = ef.H_ZERO
        denoms = []
        meta = []  # (row, channel-acc offset, sign)
        for r, row in enumerate(layout):
            byt = int(trace[r, KC_BYTE])
            clk = int(trace[r, KC_CLK])
            if row["word"]:
                wacc = (
                    ef.h_from_base(byt)
                    if row["wstart"]
                    else ef.h_add(ef.h_mul(wacc, chi), ef.h_from_base(byt))
                )
            if row["hash"]:
                m = row["m"]
                blk = row["hpos"] // RATE_BYTES
                if row["hpos"] % RATE_BYTES == 0:
                    bpow = chi
                    bcode = ef.h_add(
                        ef.h_from_base((self.msg_base + m) * MAX_BLOCKS + blk),
                        scale(byt, bpow),
                    )
                else:
                    bpow = ef.h_mul(bpow, chi)
                    bcode = ef.h_add(bcode, scale(byt, bpow))
            aux[r, KA_WACC : KA_WACC + 4] = wacc
            aux[r, KA_BPOW : KA_BPOW + 4] = bpow
            aux[r, KA_BCODE : KA_BCODE + 4] = bcode
            if row["word"] and row["wend"]:
                code = ef.h_add(
                    ef.h_from_base(row["offw"]),
                    ef.h_add(
                        scale(4 * clk + 1, chi), ef.h_mul(chi3, wacc)
                    ),
                )
                denoms.append(ef.h_sub(g_m, code))
                meta.append((r, KA_BUS_M, +1))
            if row["hash"] and row["hpos"] % RATE_BYTES == RATE_BYTES - 1:
                denoms.append(ef.h_sub(g_b, bcode))
                meta.append((r, KA_BUS_B, +1))
            if row["cend"]:
                m = row["m"]
                digest = bytes(
                    int(
                        sum(
                            int(trace[r, KC_DGST + 8 * bi + bit]) << bit
                            for bit in range(8)
                        )
                    )
                    for bi in range(32)
                )
                from .containment import digest_code

                denoms.append(
                    ef.h_sub(g_d, digest_code(self.msg_base + m, digest, chi))
                )
                meta.append((r, KA_BUS_D, -1))
                offw, size = self.calls[m]
                # clk + chi*offw + chi^2*size + sum_j d[31-j]*chi^{j+3}
                kcode = ef.h_add(
                    ef.h_from_base(clk),
                    ef.h_mul(
                        chi,
                        ef.h_add(
                            ef.h_from_base(offw),
                            ef.h_mul(
                                chi,
                                ef.h_add(
                                    ef.h_from_base(size),
                                    _rev_digest_code(digest, chi),
                                ),
                            ),
                        ),
                    ),
                )
                denoms.append(ef.h_sub(g_k, kcode))
                meta.append((r, KA_BUS_K, -1))
        invs = ef.h_batch_inv(denoms)
        accs = {
            KA_BUS_M: ef.H_ZERO,
            KA_BUS_B: ef.H_ZERO,
            KA_BUS_D: ef.H_ZERO,
            KA_BUS_K: ef.H_ZERO,
        }
        per_row: dict[int, list] = {}
        for (r, off, sign), iv in zip(meta, invs):
            per_row.setdefault(r, []).append(
                (off, iv if sign > 0 else ef.h_neg(iv))
            )
        for r in range(n):
            for off, acc in accs.items():
                aux[r, off : off + 4] = acc
            for off, term in per_row.get(r, []):
                accs[off] = ef.h_add(accs[off], term)
        return aux, accs

    def aux_trace(self, trace: np.ndarray, challenges) -> np.ndarray:
        aux, _ = self._aux_and_bus(trace, challenges)
        return aux

    def bus_values(self, trace: np.ndarray, challenges) -> list[tuple]:
        _, accs = self._aux_and_bus(trace, challenges)
        out = [ef.H_ZERO] * NUM_BUS
        out[BUS_MEM] = accs[KA_BUS_M]
        out[BUS_BLOCKS] = accs[KA_BUS_B]
        out[BUS_DIG] = accs[KA_BUS_D]
        out[BUS_KCALL] = accs[KA_BUS_K]
        return out

    # ---------------- constraints ----------------
    def eval(self, b: ConstraintBuilder) -> None:  # noqa: C901
        from .evm_air import _eval_chi97

        one = b.constant(1)
        chi = b.challenge_ef(CHAL_CHI)
        _c97 = _eval_chi97(b, chi)
        _fs = [b.mul(b.public(0), _c97[c]) for c in range(4)]
        g_m = b.ef_sub4(b.challenge_ef(CHAL_M), _fs)
        g_b = b.challenge_ef(CHAL_B)
        g_d = b.challenge_ef(CHAL_D)
        g_k = b.ef_sub4(b.challenge_ef(CHAL_K), _fs)

        byte = b.local(KC_BYTE)
        byte_n = b.next(KC_BYTE)
        clk = b.local(KC_CLK)
        clk_n = b.next(KC_CLK)
        active = b.fixed(KF_ACTIVE)
        wstart = b.fixed(KF_WSTART)
        wend = b.fixed(KF_WEND)
        wcont_n = b.fixed(KF_WCONT_N)
        offw = b.fixed(KF_OFFW)
        hstart = b.fixed(KF_HSTART)
        hend = b.fixed(KF_HEND)
        step_n = b.fixed(KF_STEP_N)
        hold_n = b.fixed(KF_HOLD_N)
        ccont_n = b.fixed(KF_CCONT_N)
        padf = b.fixed(KF_PAD)
        padv = b.fixed(KF_PADV)
        cend = b.fixed(KF_CEND)
        msgid = b.fixed(KF_MSGID)
        sizef = b.fixed(KF_SIZEF)
        offc = b.fixed(KF_OFFC)

        # booleanity: byte bits + digest bits; byte recomposition
        bit_cols = [KC_BITS + i for i in range(8)] + _DGST_NAT
        bits = b.local_block(bit_cols)
        b.all_rows_block(b.mul(bits, b.sub(bits, one)), len(bit_cols))
        recomb = None
        for i in range(8):
            t = b.scale(1 << i, b.local(KC_BITS + i))
            recomb = t if recomb is None else b.add(recomb, t)
        b.all_rows(b.sub(byte, recomb))
        # inactive rows carry byte 0 (keeps dead rows out of the codes)
        b.all_rows(b.mul(b.sub(one, active), byte))
        # pad rows carry the fixed pad byte
        b.all_rows(b.mul(padf, b.sub(byte, padv)))
        # clk constant within a call
        b.transition(b.mul(ccont_n, b.sub(clk_n, clk)))

        wacc = [b.aux(KA_WACC + c) for c in range(4)]
        wacc_n = [b.aux_next(KA_WACC + c) for c in range(4)]
        bpow = [b.aux(KA_BPOW + c) for c in range(4)]
        bpow_n = [b.aux_next(KA_BPOW + c) for c in range(4)]
        bcode = [b.aux(KA_BCODE + c) for c in range(4)]
        bcode_n = [b.aux_next(KA_BCODE + c) for c in range(4)]

        byte4 = b.ef_from_base4(byte)
        byte4_n = b.ef_from_base4(byte_n)

        # word Horner: start rows init, continuation rows step
        for c, e in enumerate(b.ef_sub4(wacc, byte4)):
            b.all_rows(b.mul(wstart, e))
        wstep = b.ef_sub4(
            wacc_n, b.ef_add4(b.ef_mul4(wacc, chi), byte4_n)
        )
        for e in wstep:
            b.transition(b.mul(wcont_n, e))

        # block code: start rows init pow=chi, code=key+byte*pow; in-block
        # continuations step; slack rows hold
        bkey = b.fixed(KF_BKEY)
        for e in b.ef_sub4(bpow, chi):
            b.all_rows(b.mul(hstart, e))
        init_code = b.ef_add4(
            b.ef_from_base4(bkey), b.ef_mul4(byte4, bpow)
        )
        for e in b.ef_sub4(bcode, init_code):
            b.all_rows(b.mul(hstart, e))
        for e in b.ef_sub4(bpow_n, b.ef_mul4(bpow, chi)):
            b.transition(b.mul(step_n, e))
        for e in b.ef_sub4(
            bcode_n, b.ef_add4(bcode, b.ef_mul4(byte4_n, bpow_n))
        ):
            b.transition(b.mul(step_n, e))
        for e in b.ef_sub4(bpow_n, bpow):
            b.transition(b.mul(hold_n, e))
        for e in b.ef_sub4(bcode_n, bcode):
            b.transition(b.mul(hold_n, e))

        # ---- channel accumulators (exclusive prefixes) ----
        def channel(off: int, gamma: list, code: list, sel, sign: int):
            acc = [b.aux(off + c) for c in range(4)]
            acc_n = [b.aux_next(off + c) for c in range(4)]
            prod = b.ef_mul4(b.ef_sub4(acc_n, acc), b.ef_sub4(gamma, code))
            sel4 = b.ef_from_base4(sel)
            for c in range(4):
                if sign > 0:
                    b.transition(b.sub(prod[c], sel4[c]))
                else:
                    b.transition(b.add(prod[c], sel4[c]))
                b.first_row(acc[c])
            return acc

        chi3 = b.ef_mul4(b.ef_mul4(chi, chi), chi)
        clk4 = b.add(b.scale(4, clk), one)
        code_m = b.ef_add4(
            b.ef_from_base4(offw),
            b.ef_add4(
                [b.mul(clk4, chi[c]) for c in range(4)],
                b.ef_mul4(chi3, wacc),
            ),
        )
        accM = channel(KA_BUS_M, g_m, code_m, wend, +1)

        accB = channel(KA_BUS_B, g_b, bcode, hend, +1)

        code_d = b.bit_block_code(b.local_block(_DGST_NAT), chi, msgid, 32)
        accD = channel(KA_BUS_D, g_d, code_d, cend, -1)

        dcode_rev = b.bit_block_code(
            b.local_block(_DGST_REV), chi, b.constant(0), 32
        )
        code_k = b.ef_add4(
            b.ef_from_base4(clk),
            b.ef_mul4(
                chi,
                b.ef_add4(
                    b.ef_from_base4(offc),
                    b.ef_mul4(
                        chi, b.ef_add4(b.ef_from_base4(sizef), dcode_rev)
                    ),
                ),
            ),
        )
        accK = channel(KA_BUS_K, g_k, code_k, cend, -1)

        # bus bindings on the (always inactive) last row
        for i in range(NUM_BUS):
            for c in range(4):
                if i == BUS_MEM:
                    b.last_row(b.sub(accM[c], b.bus_coord(4 * i + c)))
                elif i == BUS_BLOCKS:
                    b.last_row(b.sub(accB[c], b.bus_coord(4 * i + c)))
                elif i == BUS_DIG:
                    b.last_row(b.sub(accD[c], b.bus_coord(4 * i + c)))
                elif i == BUS_KCALL:
                    b.last_row(b.sub(accK[c], b.bus_coord(4 * i + c)))
                else:
                    b.last_row(b.bus_coord(4 * i + c))


def _rev_digest_code(digest: bytes, chi: tuple) -> tuple:
    """sum_j digest[31 - j] * chi^{j+1} (the CPU's little-endian word
    byte order)."""
    acc = ef.H_ZERO
    p = chi
    for j in range(32):
        acc = ef.h_add(
            acc, ef.h_mul(ef.h_from_base(digest[31 - j]), p)
        )
        p = ef.h_mul(p, chi)
    return acc

