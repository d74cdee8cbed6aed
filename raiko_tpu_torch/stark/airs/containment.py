"""Containment tables for the succinct keccak-MPT statement.

Together with KeccakSpongeV2Air (keccak_air.py) these tables prove, with
NO preimage bytes in the payload:

    "K preimages exist whose keccak digests chain to the public state
     root: digest_0 = state_root, and every digest_k (k>0) appears as a
     32-byte substring of an earlier preimage."

Three bus channels tie the tables together (prover.prove_tables /
verifier.verify_tables global balance; challenges shared by index):

  channel 0 (gamma_B): rate-block codes.  ByteCodeAir SENDS one code per
      136-byte block:  key + sum_j byte_j * chi^{j+1}  with
      key = msg_id * MAX_BLOCKS + block_idx; the sponge RECEIVES one per
      absorb — so the sponge's absorbed bits equal the byte table's
      range-checked bytes, block by block and in order.
  channel 1 (gamma_D): digest codes.  The sponge SENDS
      msg_id + sum_{j<32} digest_byte_j * chi^{j+1} per message;
      ContainAir RECEIVES one per child — pinning its claimed digest
      bytes to the sponge's computed digests.
  channel 2 (gamma_T): byte triples, chi-tuple coded
      msg + pos*chi + byte*chi^2 (an EF code, so the message-id space is
      NOT capped by base-field packing — round 2 packed msg*2^22 which
      limited a statement to 256 messages; real tries need thousands).
      ByteCodeAir SENDS each byte position with a witness multiplicity;
      ContainAir RECEIVES (parent, off+j, digest_byte_j) for j = 0..31 —
      i.e. the digest appears at offset `off` of `parent`, with
      parent < child enforced by a bit-decomposed range check.

Challenge indices: 0 = gamma_B, 1 = chi, 2 = gamma_D, 3 = gamma_T.

Accumulator convention (all three tables): bus accumulators are
EXCLUSIVE prefixes — aux[i] = sum of contributions of rows < i — so the
step constraint (acc' - acc) * D_i = S_i reads only row i's values, the
first row pins acc = 0, and the last (always-dead) row equals the
table's bus value.

Reference analog: the keccak-256 calls of the MPT state-root
recomputation (lib/src/primitives/mpt.rs:117-121, builder.rs:191-264);
the cross-table construction mirrors the "interactions" of the vendored
sp1/plonky3 provers (SURVEY.md §2.2).
"""

from __future__ import annotations

import numpy as np

from ...fields import babybear as bb
from ...fields import babybear_ext as ef
from ..air import Air, ConstraintBuilder

RATE_BYTES = 136
MAX_BLOCKS = 64  # blocks per message cap (8704-byte preimages)
# msg-id cap: 16-bit parent/diff decompositions in ContainAir; the
# chi-tuple triple code itself imposes no packing limit.  The remaining
# structural bound is BF_KEY = msg*MAX_BLOCKS < P, i.e. msg < 2^25.
MAX_MSGS = 1 << 16

CHAL_GAMMA_B = 0
CHAL_CHI = 1
CHAL_GAMMA_D = 2
CHAL_GAMMA_T = 3
NUM_CHALLENGES = 4

BUS_BLOCKS = 0
BUS_DIGESTS = 1
BUS_TRIPLES = 2


def pad_keccak(message: bytes) -> bytes:
    """keccak256 0x01 padding to a multiple of RATE_BYTES."""
    padded = bytearray(message)
    pad_len = RATE_BYTES - (len(padded) % RATE_BYTES)
    if pad_len == 1:
        padded += b"\x81"
    else:
        padded += b"\x01" + b"\x00" * (pad_len - 2) + b"\x80"
    return bytes(padded)


def _h_scale(v: int, x: tuple) -> tuple:
    return ef.h_mul(ef.h_from_base(v % bb.P), x)


def block_code(key: int, block: bytes, chi: tuple) -> tuple:
    """key + sum_j block[j] * chi^(j+1) (host reference)."""
    acc = ef.h_from_base(key)
    p = chi
    for byt in block:
        acc = ef.h_add(acc, _h_scale(byt, p))
        p = ef.h_mul(p, chi)
    return acc


def digest_code(msg_id: int, digest: bytes, chi: tuple) -> tuple:
    return block_code(msg_id, digest, chi)


def triple_code(msg_id: int, pos: int, byte: int, chi: tuple) -> tuple:
    """msg + pos*chi + byte*chi^2 (host reference for the EF-coded
    byte-triple channel)."""
    assert msg_id < MAX_MSGS and pos < (1 << 14) and 0 <= byte < 256
    acc = ef.h_add(ef.h_from_base(msg_id), _h_scale(pos, chi))
    return ef.h_add(acc, _h_scale(byte, ef.h_mul(chi, chi)))


# --------------------------------------------------------------------------
# ByteCodeAir — one byte per row; sends block codes + byte triples
# --------------------------------------------------------------------------

# main columns
BC_BYTE = 0
BC_BITS = 1  # 8 columns
BC_MULT = 9
BC_WIDTH = 10
# aux columns (EF x4 each)
BCA_POW = 0  # chi^(j+1) at this row
BCA_CODE = 4  # running block code including this row
BCA_BUS_B = 8  # EXCLUSIVE block-code send accumulator
BCA_BUS_T = 12  # EXCLUSIVE triple send accumulator
BC_AUX_W = 16
# fixed columns (public layout only)
BF_ACTIVE = 0
BF_START = 1  # block start row
BF_END = 2  # block end row (active)
BF_CONT_N = 3  # next row continues this block
BF_KEY = 4  # msg*MAX_BLOCKS + blk
BF_MSG = 5
BF_POS = 6
BC_NFIXED = 7


class ByteCodeAir(Air):
    """One row per (padded) preimage byte.

    Fixed columns carry only the LAYOUT (message count and padded
    lengths — public structure); byte VALUES are committed witness
    columns, range-checked by an 8-bit decomposition, and exported on
    the block-code and byte-triple bus channels."""

    width = BC_WIDTH
    aux_width = BC_AUX_W
    num_aux_challenges = NUM_CHALLENGES
    num_bus_values = 3
    quotient_chunks = 4
    # the layout columns are statement-sized and DENSE (one active row per
    # preimage byte): commit them (Air.commit_fixed) so verification reads
    # 7 openings per query instead of an O(total_bytes) Lagrange sum —
    # the enabler for recursing over this table (stark/recursion.py)
    commit_fixed = True

    def __init__(self, padded_lens: list[int]):
        """padded_lens[m] = padded byte length of message m (multiple of
        RATE_BYTES)."""
        assert padded_lens and len(padded_lens) <= MAX_MSGS
        for ln in padded_lens:
            assert ln % RATE_BYTES == 0 and 0 < ln <= RATE_BYTES * MAX_BLOCKS
        self.padded_lens = list(padded_lens)
        total = sum(padded_lens)
        self.total_bytes = total
        # strictly more rows than bytes: the last row must be dead (its
        # contribution would have no transition to account it)
        self.n = max(256, 1 << total.bit_length())

    def _layout(self):
        out = []
        for m, ln in enumerate(self.padded_lens):
            for pos in range(ln):
                out.append((m, pos))
        return out

    def fixed_columns(self, n: int):
        assert n == self.n
        cols = np.zeros((BC_NFIXED, n), dtype=np.uint32)
        layout = self._layout()
        assert len(layout) < n
        for row, (m, pos) in enumerate(layout):
            cols[BF_ACTIVE, row] = 1
            if pos % RATE_BYTES == 0:
                cols[BF_START, row] = 1
            if (pos + 1) % RATE_BYTES == 0:
                cols[BF_END, row] = 1
            cols[BF_KEY, row] = m * MAX_BLOCKS + pos // RATE_BYTES
            cols[BF_MSG, row] = m
            cols[BF_POS, row] = pos
        for row in range(n - 1):
            if (
                row + 1 < len(layout)
                and cols[BF_ACTIVE, row] == 1
                and cols[BF_START, row + 1] == 0
            ):
                cols[BF_CONT_N, row] = 1
        return cols

    def trace(
        self, messages: list[bytes], triple_mults: dict | None = None
    ) -> np.ndarray:
        """messages: UNPADDED preimages; triple_mults: (msg, pos) ->
        multiplicity of that byte position on the triple channel."""
        assert len(messages) == len(self.padded_lens)
        triple_mults = triple_mults or {}
        rows = np.zeros((self.n, BC_WIDTH), dtype=np.uint32)
        row = 0
        for m, msg in enumerate(messages):
            padded = pad_keccak(msg)
            assert len(padded) == self.padded_lens[m]
            for pos, byt in enumerate(padded):
                rows[row, BC_BYTE] = byt
                for b in range(8):
                    rows[row, BC_BITS + b] = (byt >> b) & 1
                rows[row, BC_MULT] = triple_mults.get((m, pos), 0)
                row += 1
        return rows

    def aux_trace(self, trace: np.ndarray, challenges: list[tuple]) -> np.ndarray:
        gamma_b = challenges[CHAL_GAMMA_B]
        chi = challenges[CHAL_CHI]
        gamma_t = challenges[CHAL_GAMMA_T]
        n = trace.shape[0]
        aux = np.zeros((n, BC_AUX_W), dtype=np.uint32)
        layout = self._layout()
        # per-row pow/code (inclusive)
        pow_chi = ef.H_ONE
        code = ef.H_ZERO
        codes = [ef.H_ZERO] * n
        for row, (m, pos) in enumerate(layout):
            byt = int(trace[row, BC_BYTE])
            if pos % RATE_BYTES == 0:
                pow_chi = chi
                code = ef.h_add(
                    ef.h_from_base(m * MAX_BLOCKS + pos // RATE_BYTES),
                    _h_scale(byt, pow_chi),
                )
            else:
                pow_chi = ef.h_mul(pow_chi, chi)
                code = ef.h_add(code, _h_scale(byt, pow_chi))
            aux[row, BCA_POW : BCA_POW + 4] = pow_chi
            aux[row, BCA_CODE : BCA_CODE + 4] = code
            codes[row] = code
        # denominators for contributions
        denoms = []
        for row, (m, pos) in enumerate(layout):
            denoms.append(
                ef.h_sub(
                    gamma_t,
                    triple_code(m, pos, int(trace[row, BC_BYTE]), chi),
                )
            )
            if (pos + 1) % RATE_BYTES == 0:
                denoms.append(ef.h_sub(gamma_b, codes[row]))
        invs = ef.h_batch_inv(denoms)
        # exclusive prefixes
        bus_b = ef.H_ZERO
        bus_t = ef.H_ZERO
        di = 0
        for row, (m, pos) in enumerate(layout):
            aux[row, BCA_BUS_B : BCA_BUS_B + 4] = bus_b
            aux[row, BCA_BUS_T : BCA_BUS_T + 4] = bus_t
            mult = int(trace[row, BC_MULT])
            bus_t = ef.h_add(bus_t, _h_scale(mult, invs[di]))
            di += 1
            if (pos + 1) % RATE_BYTES == 0:
                bus_b = ef.h_add(bus_b, invs[di])
                di += 1
        for row in range(len(layout), n):
            aux[row, BCA_BUS_B : BCA_BUS_B + 4] = bus_b
            aux[row, BCA_BUS_T : BCA_BUS_T + 4] = bus_t
        return aux

    def bus_values(self, trace: np.ndarray, challenges: list[tuple]) -> list[tuple]:
        aux = self.aux_trace(trace, challenges)
        last = trace.shape[0] - 1
        return [
            tuple(int(v) for v in aux[last, BCA_BUS_B : BCA_BUS_B + 4]),
            ef.H_ZERO,
            tuple(int(v) for v in aux[last, BCA_BUS_T : BCA_BUS_T + 4]),
        ]

    def eval(self, b: ConstraintBuilder) -> None:  # noqa: C901
        chi = b.challenge_ef(CHAL_CHI)
        gamma_b = b.challenge_ef(CHAL_GAMMA_B)
        gamma_t = b.challenge_ef(CHAL_GAMMA_T)
        one = b.constant(1)

        byte = b.local(BC_BYTE)
        byte_n = b.next(BC_BYTE)
        bits = [b.local(BC_BITS + i) for i in range(8)]
        mult = b.local(BC_MULT)
        active = b.fixed(BF_ACTIVE)
        start = b.fixed(BF_START)
        end = b.fixed(BF_END)
        cont_n = b.fixed(BF_CONT_N)
        key = b.fixed(BF_KEY)
        msgf = b.fixed(BF_MSG)
        posf = b.fixed(BF_POS)

        powx = [b.aux(BCA_POW + c) for c in range(4)]
        powx_n = [b.aux_next(BCA_POW + c) for c in range(4)]
        code = [b.aux(BCA_CODE + c) for c in range(4)]
        code_n = [b.aux_next(BCA_CODE + c) for c in range(4)]
        bus_bb = [b.aux(BCA_BUS_B + c) for c in range(4)]
        bus_bb_n = [b.aux_next(BCA_BUS_B + c) for c in range(4)]
        bus_t = [b.aux(BCA_BUS_T + c) for c in range(4)]
        bus_t_n = [b.aux_next(BCA_BUS_T + c) for c in range(4)]

        def gate_t(sel, exprs):
            for e in exprs:
                b.transition(b.mul(sel, e))

        def both(expr):
            b.transition(expr)
            b.last_row(expr)

        # 1. bit booleanity + byte = sum 2^i b_i (every row; dead rows 0)
        for bit in bits:
            both(b.mul(bit, b.sub(bit, one)))
        recomb = None
        for i, bit in enumerate(bits):
            t = b.scale(1 << i, bit)
            recomb = t if recomb is None else b.add(recomb, t)
        both(b.sub(byte, recomb))

        # 2. block starts: powx = chi, code = key + byte*powx
        start_pow = b.ef_sub4(powx, chi)
        gate_t(start, start_pow)
        key4 = b.ef_from_base4(key)
        byte4 = b.ef_from_base4(byte)
        start_code = b.ef_sub4(code, b.ef_add4(key4, b.ef_mul4(byte4, powx)))
        gate_t(start, start_code)
        for e in start_pow + start_code:
            b.first_row(e)  # row 0 is a block start

        # 3. in-block continuation: powx' = powx*chi, code' = code + byte'*powx'
        gate_t(cont_n, b.ef_sub4(powx_n, b.ef_mul4(powx, chi)))
        byte_n4 = b.ef_from_base4(byte_n)
        gate_t(
            cont_n,
            b.ef_sub4(code_n, b.ef_add4(code, b.ef_mul4(byte_n4, powx_n))),
        )

        # 4. block-code sends (exclusive prefix): on block-end rows the
        # accumulator steps by 1/(gamma_b - code); otherwise it holds.
        delta_b = b.ef_sub4(bus_bb_n, bus_bb)
        gb_code = b.ef_sub4(gamma_b, code)
        prod_b = b.ef_mul4(delta_b, gb_code)
        end4 = b.ef_from_base4(end)
        for c in range(4):
            expr = b.add(
                b.mul(end, b.sub(prod_b[c], end4[c])),
                b.mul(b.sub(one, end), delta_b[c]),
            )
            b.transition(expr)
        for c in range(4):
            b.first_row(bus_bb[c])

        # 5. triple sends: every row contributes mult/(gamma_t - triple)
        # with triple = msg + pos*chi + byte*chi^2 (dead rows: mult = 0)
        chi2 = b.ef_mul4(chi, chi)
        tval4 = b.ef_add4(
            b.ef_from_base4(msgf),
            b.ef_add4(
                b.ef_mul4(b.ef_from_base4(posf), chi),
                b.ef_mul4(b.ef_from_base4(byte), chi2),
            ),
        )
        delta_t = b.ef_sub4(bus_t_n, bus_t)
        gt_t = b.ef_sub4(gamma_t, tval4)
        prod_t = b.ef_mul4(delta_t, gt_t)
        mult4 = b.ef_from_base4(b.mul(active, mult))
        for c in range(4):
            b.transition(b.sub(prod_t[c], mult4[c]))
        for c in range(4):
            b.first_row(bus_t[c])

        # 6. bus bindings on the (dead) last row
        for c in range(4):
            b.last_row(b.sub(bus_bb[c], b.bus_coord(4 * BUS_BLOCKS + c)))
            b.last_row(b.sub(bus_t[c], b.bus_coord(4 * BUS_TRIPLES + c)))
            b.last_row(b.bus_coord(4 * BUS_DIGESTS + c))  # unused channel = 0


# --------------------------------------------------------------------------
# ContainAir — 32 rows per child: digest-code receive + triple receives
# --------------------------------------------------------------------------

CLAIM_ROWS = 32

# main columns
CT_DBYTE = 0
CT_DBITS = 1  # 8
CT_PARENT = 9
CT_PBITS = 10  # 16 (parent < 2^16)
CT_OFF = 26
CT_OBITS = 27  # 14 (off < 2^14)
CT_DIFF = 41  # child - 1 - parent
CT_FBITS = 42  # 16 (diff < 2^16  =>  parent < child)
CT_WIDTH = 58
# aux
CTA_POW = 0
CTA_CODE = 4
CTA_BUS_D = 8  # EXCLUSIVE digest receive accumulator
CTA_BUS_T = 12  # EXCLUSIVE triple receive accumulator
CT_AUX_W = 16
# fixed
CF_ACTIVE = 0
CF_START = 1
CF_END = 2
CF_CONT_N = 3
CF_CHILD = 4
CF_J = 5
CT_NFIXED = 6


class ContainAir(Air):
    """One 32-row block per child message k = 1..K-1.

    Receives child k's digest code (channel 1) — forcing the block's
    dbyte column to spell keccak(m_k) — and, per row j, the triple
    (parent, off + j, dbyte_j) (channel 2) — forcing those bytes to
    appear consecutively at offset `off` of message `parent`.  An 8-bit
    decomposition of child - 1 - parent enforces parent < child, so the
    claims form a DAG rooted at message 0 (whose digest the sponge binds
    to the public state root)."""

    width = CT_WIDTH
    aux_width = CT_AUX_W
    num_aux_challenges = NUM_CHALLENGES
    num_bus_values = 3
    quotient_chunks = 4
    commit_fixed = True  # dense statement-sized layout (see ByteCodeAir)

    def __init__(self, num_children: int):
        assert 1 <= num_children < MAX_MSGS
        self.num_children = num_children
        total = num_children * CLAIM_ROWS
        self.n = max(64, 1 << total.bit_length())  # last row always dead

    def _layout(self):
        out = []
        for k in range(self.num_children):
            for j in range(CLAIM_ROWS):
                out.append((k + 1, j))  # children are msg ids 1..K-1
        return out

    def fixed_columns(self, n: int):
        assert n == self.n
        cols = np.zeros((CT_NFIXED, n), dtype=np.uint32)
        layout = self._layout()
        assert len(layout) < n
        for row, (child, j) in enumerate(layout):
            cols[CF_ACTIVE, row] = 1
            if j == 0:
                cols[CF_START, row] = 1
            if j == CLAIM_ROWS - 1:
                cols[CF_END, row] = 1
            cols[CF_CHILD, row] = child
            cols[CF_J, row] = j
        for row in range(n - 1):
            if row + 1 < len(layout) and layout[row + 1][1] != 0:
                cols[CF_CONT_N, row] = 1
        return cols

    def trace(self, claims: list[tuple[bytes, int, int]]) -> np.ndarray:
        """claims[k] = (digest_bytes, parent_msg_id, offset) for child
        k+1 (parent < k+1, digest appears at `offset` in the PADDED
        parent preimage)."""
        assert len(claims) == self.num_children
        rows = np.zeros((self.n, CT_WIDTH), dtype=np.uint32)
        row = 0
        for k, (digest, parent, off) in enumerate(claims):
            child = k + 1
            assert 0 <= parent < child and len(digest) == 32
            diff = child - 1 - parent
            assert 0 <= diff < (1 << 16) and 0 <= off < (1 << 14)
            for j in range(CLAIM_ROWS):
                byt = digest[j]
                rows[row, CT_DBYTE] = byt
                for i in range(8):
                    rows[row, CT_DBITS + i] = (byt >> i) & 1
                rows[row, CT_PARENT] = parent
                for i in range(16):
                    rows[row, CT_PBITS + i] = (parent >> i) & 1
                rows[row, CT_OFF] = off
                for i in range(14):
                    rows[row, CT_OBITS + i] = (off >> i) & 1
                rows[row, CT_DIFF] = diff
                for i in range(16):
                    rows[row, CT_FBITS + i] = (diff >> i) & 1
                row += 1
        return rows

    def aux_trace(self, trace: np.ndarray, challenges: list[tuple]) -> np.ndarray:
        chi = challenges[CHAL_CHI]
        gamma_d = challenges[CHAL_GAMMA_D]
        gamma_t = challenges[CHAL_GAMMA_T]
        n = trace.shape[0]
        aux = np.zeros((n, CT_AUX_W), dtype=np.uint32)
        layout = self._layout()
        pow_chi = ef.H_ONE
        code = ef.H_ZERO
        denoms = []
        codes = [ef.H_ZERO] * n
        for row, (child, j) in enumerate(layout):
            byt = int(trace[row, CT_DBYTE])
            if j == 0:
                pow_chi = chi
                code = ef.h_add(ef.h_from_base(child), _h_scale(byt, pow_chi))
            else:
                pow_chi = ef.h_mul(pow_chi, chi)
                code = ef.h_add(code, _h_scale(byt, pow_chi))
            aux[row, CTA_POW : CTA_POW + 4] = pow_chi
            aux[row, CTA_CODE : CTA_CODE + 4] = code
            codes[row] = code
            parent = int(trace[row, CT_PARENT])
            off = int(trace[row, CT_OFF])
            denoms.append(
                ef.h_sub(gamma_t, triple_code(parent, off + j, byt, chi))
            )
            if j == CLAIM_ROWS - 1:
                denoms.append(ef.h_sub(gamma_d, code))
        invs = ef.h_batch_inv(denoms)
        bus_d = ef.H_ZERO
        bus_t = ef.H_ZERO
        di = 0
        for row, (child, j) in enumerate(layout):
            aux[row, CTA_BUS_D : CTA_BUS_D + 4] = bus_d
            aux[row, CTA_BUS_T : CTA_BUS_T + 4] = bus_t
            bus_t = ef.h_sub(bus_t, invs[di])
            di += 1
            if j == CLAIM_ROWS - 1:
                bus_d = ef.h_sub(bus_d, invs[di])
                di += 1
        for row in range(len(layout), n):
            aux[row, CTA_BUS_D : CTA_BUS_D + 4] = bus_d
            aux[row, CTA_BUS_T : CTA_BUS_T + 4] = bus_t
        return aux

    def bus_values(self, trace: np.ndarray, challenges: list[tuple]) -> list[tuple]:
        aux = self.aux_trace(trace, challenges)
        last = trace.shape[0] - 1
        return [
            ef.H_ZERO,
            tuple(int(v) for v in aux[last, CTA_BUS_D : CTA_BUS_D + 4]),
            tuple(int(v) for v in aux[last, CTA_BUS_T : CTA_BUS_T + 4]),
        ]

    def eval(self, b: ConstraintBuilder) -> None:  # noqa: C901
        chi = b.challenge_ef(CHAL_CHI)
        gamma_d = b.challenge_ef(CHAL_GAMMA_D)
        gamma_t = b.challenge_ef(CHAL_GAMMA_T)
        one = b.constant(1)

        dbyte = b.local(CT_DBYTE)
        dbyte_n = b.next(CT_DBYTE)
        parent = b.local(CT_PARENT)
        parent_n = b.next(CT_PARENT)
        off = b.local(CT_OFF)
        off_n = b.next(CT_OFF)
        diff = b.local(CT_DIFF)
        active = b.fixed(CF_ACTIVE)
        start = b.fixed(CF_START)
        end = b.fixed(CF_END)
        cont_n = b.fixed(CF_CONT_N)
        childf = b.fixed(CF_CHILD)
        jf = b.fixed(CF_J)

        powx = [b.aux(CTA_POW + c) for c in range(4)]
        powx_n = [b.aux_next(CTA_POW + c) for c in range(4)]
        code = [b.aux(CTA_CODE + c) for c in range(4)]
        code_n = [b.aux_next(CTA_CODE + c) for c in range(4)]
        bus_d = [b.aux(CTA_BUS_D + c) for c in range(4)]
        bus_d_n = [b.aux_next(CTA_BUS_D + c) for c in range(4)]
        bus_t = [b.aux(CTA_BUS_T + c) for c in range(4)]
        bus_t_n = [b.aux_next(CTA_BUS_T + c) for c in range(4)]

        def gate_t(sel, exprs):
            for e in exprs:
                b.transition(b.mul(sel, e))

        def both(expr):
            b.transition(expr)
            b.last_row(expr)

        # 1. bit decompositions (booleanity + recomposition, all rows)
        for base_col, nbits, target in (
            (CT_DBITS, 8, dbyte),
            (CT_PBITS, 16, parent),
            (CT_OBITS, 14, off),
            (CT_FBITS, 16, diff),
        ):
            recomb = None
            for i in range(nbits):
                bit = b.local(base_col + i)
                both(b.mul(bit, b.sub(bit, one)))
                t = b.scale(1 << i, bit)
                recomb = t if recomb is None else b.add(recomb, t)
            both(b.sub(target, recomb))

        # 2. parent/off constant within a claim block; diff defined at start
        gate_t(cont_n, [b.sub(parent_n, parent), b.sub(off_n, off)])
        start_diff = b.mul(
            start, b.sub(b.sub(b.sub(childf, one), parent), diff)
        )
        b.transition(start_diff)
        b.first_row(b.sub(b.sub(b.sub(childf, one), parent), diff))

        # 3. digest-code recurrences (key = child id)
        start_pow = b.ef_sub4(powx, chi)
        gate_t(start, start_pow)
        child4 = b.ef_from_base4(childf)
        dbyte4 = b.ef_from_base4(dbyte)
        start_code = b.ef_sub4(code, b.ef_add4(child4, b.ef_mul4(dbyte4, powx)))
        gate_t(start, start_code)
        for e in start_pow + start_code:
            b.first_row(e)
        gate_t(cont_n, b.ef_sub4(powx_n, b.ef_mul4(powx, chi)))
        dbyte_n4 = b.ef_from_base4(dbyte_n)
        gate_t(
            cont_n,
            b.ef_sub4(code_n, b.ef_add4(code, b.ef_mul4(dbyte_n4, powx_n))),
        )

        # 4. digest receives: (acc' - acc)*(gamma_d - code) = -end
        delta_d = b.ef_sub4(bus_d_n, bus_d)
        prod_d = b.ef_mul4(delta_d, b.ef_sub4(gamma_d, code))
        end4 = b.ef_from_base4(end)
        for c in range(4):
            b.transition(b.add(prod_d[c], end4[c]))
            b.first_row(bus_d[c])

        # 5. triple receives: every active row, -1/(gamma_t - triple)
        # with triple = parent + (off + j)*chi + dbyte*chi^2
        chi2 = b.ef_mul4(chi, chi)
        tval4 = b.ef_add4(
            b.ef_from_base4(parent),
            b.ef_add4(
                b.ef_mul4(b.ef_from_base4(b.add(off, jf)), chi),
                b.ef_mul4(b.ef_from_base4(dbyte), chi2),
            ),
        )
        delta_t = b.ef_sub4(bus_t_n, bus_t)
        prod_t = b.ef_mul4(delta_t, b.ef_sub4(gamma_t, tval4))
        act4 = b.ef_from_base4(active)
        for c in range(4):
            b.transition(b.add(prod_t[c], act4[c]))
            b.first_row(bus_t[c])

        # 6. bus bindings on the (dead) last row
        for c in range(4):
            b.last_row(b.bus_coord(4 * BUS_BLOCKS + c))  # unused channel
            b.last_row(b.sub(bus_d[c], b.bus_coord(4 * BUS_DIGESTS + c)))
            b.last_row(b.sub(bus_t[c], b.bus_coord(4 * BUS_TRIPLES + c)))
