"""Keccak-f[1600] AIR — proving Ethereum's hash permutation.

Statement: "keccak-f(input_state) = output_state" for public 1600-bit
input/output vectors.  This is the hashing workload behind every MPT node
reference and block hash (SURVEY.md §2.2 "vectorized Keccak permutation
kernel"), here as a STARK — the building block for proving the state-root
recomputation in later rounds (sponge chaining + MPT transcript).

Layout (32 rows per permutation; rows 0..23 apply rounds, 24..30 copy,
row 31 carries the output):

  trace columns (width 4160):
    A[1600]      state bits a[x][y][z]           (cols 0..1599)
    C[320]       theta column parities c[x][z]   (cols 1600..1919)
    H0[320]      parity helper bit 0             (cols 1920..2239)
    H1[320]      parity helper bit 1             (cols 2240..2559)
    AMID[1600]   post-theta state bits           (cols 2560..4159)

  fixed columns (1602): sel_round, sel_copy, RC[1600] (round constant
  bits, nonzero only on lane (0,0))

Constraints (all registered as vectorized blocks):
  parity    (320, deg 1):  sum_y A[x][y][z] = C + 2*H0 + 4*H1
  boolean   (3x320, deg 2): C, H0, H1 in {0,1}
  theta     (1600, deg 3): AMID = A xor D,  D = C[x-1][z] xor C[x+1][z-1]
  round/copy transition (1600, deg 5):
      sel_round * (A' - chi_iota(rho_pi(AMID))) + sel_copy * (A' - A)
  boundaries (2x1600, deg 1): first row = input bits, last row = output

The degree-5 transition (chi: cubic in AMID bits, xor with the fixed RC
bit, times the selector) uses the framework's 4-chunk quotient support.
"""

from __future__ import annotations

import numpy as np

from ...fields import babybear as bb
from ...fields import babybear_ext as ef
from ...utils.keccak_py import RHO_OFFSETS, ROUND_CONSTANTS, keccak_f1600
from ..air import Air, ConstraintBuilder

ROWS = 32
N_ROUNDS = 24
WIDTH = 4160
N_FIXED = 1602

A0 = 0
C0 = 1600
H0_0 = 1920
H1_0 = 2240
AMID0 = 2560
F_ROUND = 0
F_COPY = 1
F_RC = 2


def a_col(x: int, y: int, z: int) -> int:
    return A0 + (x + 5 * y) * 64 + z


def c_col(x: int, z: int) -> int:
    return C0 + x * 64 + z


def amid_col(x: int, y: int, z: int) -> int:
    return AMID0 + (x + 5 * y) * 64 + z


def _build_index_maps():
    """Static gather maps for the theta neighbors and rho+pi permutation."""
    # theta: for each A position, its two C neighbors
    d_c1 = np.zeros(1600, dtype=np.int32)  # C[(x-1)%5][z]
    d_c2 = np.zeros(1600, dtype=np.int32)  # C[(x+1)%5][(z-1)%64]
    for x in range(5):
        for y in range(5):
            for z in range(64):
                i = (x + 5 * y) * 64 + z
                d_c1[i] = c_col((x - 1) % 5, z)
                d_c2[i] = c_col((x + 1) % 5, (z - 1) % 64)
    # rho+pi: B[dst] = AMID[src]; chi neighbors B[x+1], B[x+2] at same y,z
    b_src = np.zeros(1600, dtype=np.int32)
    for x in range(5):
        for y in range(5):
            dst_x, dst_y = y, (2 * x + 3 * y) % 5
            for z in range(64):
                b_src[(dst_x + 5 * dst_y) * 64 + z] = amid_col(
                    x, y, (z - RHO_OFFSETS[x][y]) % 64
                )
    b1_of = np.zeros(1600, dtype=np.int32)  # B[(x+1)%5][y][z] as index into B
    b2_of = np.zeros(1600, dtype=np.int32)
    for x in range(5):
        for y in range(5):
            for z in range(64):
                i = (x + 5 * y) * 64 + z
                b1_of[i] = ((x + 1) % 5 + 5 * y) * 64 + z
                b2_of[i] = ((x + 2) % 5 + 5 * y) * 64 + z
    return d_c1, d_c2, b_src, b1_of, b2_of


_D_C1, _D_C2, _B_SRC, _B1, _B2 = _build_index_maps()


def state_to_bits(state: list[int]) -> np.ndarray:
    """25 u64 lanes -> (1600,) bit vector in column order."""
    out = np.zeros(1600, dtype=np.uint32)
    for lane in range(25):
        for z in range(64):
            out[lane * 64 + z] = (state[lane] >> z) & 1
    return out


def bits_to_state(bits) -> list[int]:
    out = []
    for lane in range(25):
        v = 0
        for z in range(64):
            v |= int(bits[lane * 64 + z]) << z
        out.append(v)
    return out


class KeccakFAir(Air):
    width = WIDTH
    quotient_chunks = 4  # degree-5 transition

    def __init__(self, input_state: list[int]):
        """input_state: 25 u64 lanes."""
        self.input_state = list(input_state)
        self.output_state = keccak_f1600(self.input_state)

    def publics(self) -> list[int]:
        return (
            state_to_bits(self.input_state).tolist()
            + state_to_bits(self.output_state).tolist()
        )

    # -- fixed columns ----------------------------------------------------
    def fixed_columns(self, n: int):
        assert n == ROWS
        cols = np.zeros((N_FIXED, n), dtype=np.uint32)
        cols[F_ROUND, :N_ROUNDS] = 1
        cols[F_COPY, N_ROUNDS : ROWS - 1] = 1
        for r in range(N_ROUNDS):
            rc = ROUND_CONSTANTS[r]
            for z in range(64):
                cols[F_RC + a_col(0, 0, z), r] = (rc >> z) & 1
        return cols

    # -- trace ------------------------------------------------------------
    def trace(self) -> np.ndarray:
        rows = np.zeros((ROWS, WIDTH), dtype=np.uint32)
        state = state_to_bits(self.input_state)
        round_states = [state]
        # round-by-round bit simulation
        cur = list(self.input_state)
        for r in range(N_ROUNDS):
            cur = _one_round(cur, r)
            round_states.append(state_to_bits(cur))
        for row in range(ROWS):
            a = round_states[min(row, N_ROUNDS)]
            rows[row, A0:C0] = a
            # helpers from the CURRENT row's state
            s = np.zeros(320, dtype=np.uint32)
            for x in range(5):
                for y in range(5):
                    s[x * 64 : x * 64 + 64] += a[(x + 5 * y) * 64 : (x + 5 * y) * 64 + 64]
            c = s & 1
            h = s >> 1
            rows[row, C0:H0_0] = c
            rows[row, H0_0:H1_0] = h & 1
            rows[row, H1_0:AMID0] = h >> 1
            # a_mid = a xor d
            d = rows[row, _D_C1] ^ rows[row, _D_C2]
            rows[row, AMID0:] = a ^ d
        return rows

    # -- constraints ------------------------------------------------------
    def eval(self, b: ConstraintBuilder) -> None:
        a_cols = list(range(A0, A0 + 1600))
        A = b.local_block(a_cols)
        nA = b.next_block(a_cols)
        C = b.local_block(range(C0, C0 + 320))
        H0 = b.local_block(range(H0_0, H0_0 + 320))
        H1 = b.local_block(range(H1_0, H1_0 + 320))
        AMID = b.local_block(range(AMID0, AMID0 + 1600))
        sel_round = b.fixed(F_ROUND)
        sel_copy = b.fixed(F_COPY)
        RC = b.fixed_block([F_RC + i for i in range(1600)])

        one = b.constant(1)

        def xor(p, q):
            # p ^ q = p + q - 2pq for boolean p, q
            return b.sub(b.add(p, q), b.scale(2, b.mul(p, q)))

        # parity: sum_y A = C + 2 H0 + 4 H1 (degree 1)
        s = None
        for y in range(5):
            blk = b.local_block([a_col(x, y, z) for x in range(5) for z in range(64)])
            s = blk if s is None else b.add(s, blk)
        rhs = b.add(b.add(C, b.scale(2, H0)), b.scale(4, H1))
        b.transition_block(b.sub(s, rhs), 320)

        # booleanity of helpers (degree 2)
        for blk in (C, H0, H1):
            b.transition_block(b.mul(blk, b.sub(blk, one)), 320)

        # theta: AMID = A xor D (degree 3)
        c1 = b.local_block(_D_C1.tolist())
        c2 = b.local_block(_D_C2.tolist())
        d = xor(c1, c2)
        b.transition_block(b.sub(AMID, xor(A, d)), 1600)

        # rho+pi+chi+iota transition (degree 5 with selector)
        B_blk = b.local_block(_B_SRC.tolist())
        B1 = b.local_block(_B_SRC[_B1].tolist())
        B2 = b.local_block(_B_SRC[_B2].tolist())
        t = b.mul(b.sub(one, B1), B2)
        chi = xor(B_blk, t)
        chi_iota = xor(chi, RC)
        round_expr = b.mul(sel_round, b.sub(nA, chi_iota))
        copy_expr = b.mul(sel_copy, b.sub(nA, A))
        b.transition_block(b.add(round_expr, copy_expr), 1600)

        # boundaries
        b.first_row_block(b.sub(A, b.public_block(range(1600))), 1600)
        b.last_row_block(b.sub(A, b.public_block(range(1600, 3200))), 1600)


def _one_round(state: list[int], round_idx: int) -> list[int]:
    """One keccak round on u64 lanes (host reference, mirrors keccak_py)."""
    from ...utils.keccak_py import MASK64, _rotl64

    a = list(state)
    c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
    d = [c[(x - 1) % 5] ^ _rotl64(c[(x + 1) % 5], 1) for x in range(5)]
    for x in range(5):
        for y in range(5):
            a[x + 5 * y] ^= d[x]
    bmat = [0] * 25
    for x in range(5):
        for y in range(5):
            bmat[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl64(
                a[x + 5 * y], RHO_OFFSETS[x][y]
            )
    for x in range(5):
        for y in range(5):
            a[x + 5 * y] = bmat[x + 5 * y] ^ (
                (~bmat[(x + 1) % 5 + 5 * y] & MASK64) & bmat[(x + 2) % 5 + 5 * y]
            )
    a[0] ^= ROUND_CONSTANTS[round_idx]
    return a


# ---------------------------------------------------------------------------
# Sponge chaining: keccak256(message) = digest
# ---------------------------------------------------------------------------

RATE_BYTES = 136
F_ABSORB = N_FIXED  # extra fixed selector column
F_MSG = N_FIXED + 1  # 1600 message-bit columns (row-indexed)
N_FIXED_SPONGE = N_FIXED + 1 + 1600


def _pad_message(message: bytes) -> list[np.ndarray]:
    """keccak256 0x01 padding -> list of 1600-bit block vectors (rate lanes
    carry the data, capacity lanes zero)."""
    padded = bytearray(message)
    pad_len = RATE_BYTES - (len(padded) % RATE_BYTES)
    if pad_len == 1:
        padded += b"\x81"
    else:
        padded += b"\x01" + b"\x00" * (pad_len - 2) + b"\x80"
    blocks = []
    for off in range(0, len(padded), RATE_BYTES):
        chunk = padded[off : off + RATE_BYTES]
        bits = np.zeros(1600, dtype=np.uint32)
        for i, byte in enumerate(chunk):
            lane, byte_in_lane = divmod(i, 8)
            for bit in range(8):
                bits[lane * 64 + byte_in_lane * 8 + bit] = (byte >> bit) & 1
        blocks.append(bits)
    return blocks


class KeccakSpongeAir(Air):
    """keccak256(message) = digest, for an arbitrary public message.

    Per permutation: rows 0..23 rounds, 24..30 copy, row 31 -> next
    permutation's row 0 absorbs the next block (A' = A xor MSG, with the
    block bits as fixed columns).  The first row is bound to block 0
    directly (initial state is zero); the digest (256 bits = lanes 0..3)
    is bound on the last row as publics."""

    width = WIDTH
    quotient_chunks = 4

    def __init__(self, message: bytes):
        self.message = bytes(message)
        self.blocks = _pad_message(self.message)
        nperm = len(self.blocks)
        p2 = 1 << (nperm - 1).bit_length()
        # pad with zero blocks (absorbing zeros changes the hash, so pad
        # perms COPY instead: we extend with no-absorb permutations is not
        # the sponge; instead require pow2 by padding the message domain:
        # simplest sound option: require nperm already pow2 or chain with
        # explicit zero-absorb marked by sel_absorb=0 (pure permutation
        # rounds would change the state). We pad with EXTRA COPY perms:
        # sel_round=0 for all their rows, so state rides through unchanged.
        self.num_perms = p2
        self.active_perms = nperm
        from ...utils.keccak_py import keccak256

        self.digest = keccak256(self.message)

    def digest_bits(self) -> list[int]:
        out = []
        for i, byte in enumerate(self.digest):
            lane, byte_in_lane = divmod(i, 8)
            for bit in range(8):
                out.append((byte >> bit) & 1)
        return out

    def publics(self) -> list[int]:
        return self.digest_bits()

    def fixed_columns(self, n: int):
        assert n == ROWS * self.num_perms
        cols = np.zeros((N_FIXED_SPONGE, n), dtype=np.uint32)
        for perm in range(self.num_perms):
            base = ROWS * perm
            active = perm < self.active_perms
            if active:
                cols[F_ROUND, base : base + N_ROUNDS] = 1
                cols[F_COPY, base + N_ROUNDS : base + ROWS - 1] = 1
                for r in range(N_ROUNDS):
                    rc = ROUND_CONSTANTS[r]
                    for z in range(64):
                        cols[F_RC + a_col(0, 0, z), base + r] = (rc >> z) & 1
            else:
                # padding permutation: all rows copy
                cols[F_COPY, base : base + ROWS - 1] = 1
            # absorb transition into the NEXT active permutation
            if perm + 1 < self.active_perms:
                cols[F_ABSORB, base + ROWS - 1] = 1
                cols[F_COPY, base + ROWS - 1] = 0
                cols[F_MSG : F_MSG + 1600, base + ROWS - 1] = self.blocks[perm + 1]
            elif perm + 1 < self.num_perms:
                cols[F_COPY, base + ROWS - 1] = 1
        # block 0 on row 0 for the first-row binding
        cols[F_MSG : F_MSG + 1600, 0] = self.blocks[0]
        return cols

    def trace(self) -> np.ndarray:
        n = ROWS * self.num_perms
        rows = np.zeros((n, WIDTH), dtype=np.uint32)
        fixed = self.fixed_columns(n)
        state = [0] * 25
        for perm in range(self.num_perms):
            base = ROWS * perm
            if perm < self.active_perms:
                blk = bits_to_state(self.blocks[perm])
                state = [state[i] ^ blk[i] for i in range(25)]
            cur = list(state)
            for row in range(ROWS):
                active = perm < self.active_perms and row <= N_ROUNDS
                a = state_to_bits(cur)
                rows[base + row, A0:C0] = a
                s = np.zeros(320, dtype=np.uint32)
                for x in range(5):
                    for y in range(5):
                        s[x * 64 : x * 64 + 64] += a[
                            (x + 5 * y) * 64 : (x + 5 * y) * 64 + 64
                        ]
                rows[base + row, C0:H0_0] = s & 1
                rows[base + row, H0_0:H1_0] = (s >> 1) & 1
                rows[base + row, H1_0:AMID0] = s >> 2
                d = rows[base + row, _D_C1] ^ rows[base + row, _D_C2]
                rows[base + row, AMID0:] = a ^ d
                if perm < self.active_perms and row < N_ROUNDS:
                    cur = _one_round(cur, row)
            state = cur
        return rows

    def eval(self, b: ConstraintBuilder) -> None:
        a_cols = list(range(A0, A0 + 1600))
        A = b.local_block(a_cols)
        nA = b.next_block(a_cols)
        C = b.local_block(range(C0, C0 + 320))
        H0 = b.local_block(range(H0_0, H0_0 + 320))
        H1 = b.local_block(range(H1_0, H1_0 + 320))
        AMID = b.local_block(range(AMID0, AMID0 + 1600))
        sel_round = b.fixed(F_ROUND)
        sel_copy = b.fixed(F_COPY)
        sel_absorb = b.fixed(F_ABSORB)
        RC = b.fixed_block([F_RC + i for i in range(1600)])
        MSG = b.fixed_block([F_MSG + i for i in range(1600)])
        one = b.constant(1)

        def xor(p, q):
            return b.sub(b.add(p, q), b.scale(2, b.mul(p, q)))

        s = None
        for y in range(5):
            blk = b.local_block([a_col(x, y, z) for x in range(5) for z in range(64)])
            s = blk if s is None else b.add(s, blk)
        rhs = b.add(b.add(C, b.scale(2, H0)), b.scale(4, H1))
        b.transition_block(b.sub(s, rhs), 320)
        for blk in (C, H0, H1):
            b.transition_block(b.mul(blk, b.sub(blk, one)), 320)
        c1 = b.local_block(_D_C1.tolist())
        c2 = b.local_block(_D_C2.tolist())
        b.transition_block(b.sub(AMID, xor(A, xor(c1, c2))), 1600)

        B_blk = b.local_block(_B_SRC.tolist())
        B1 = b.local_block(_B_SRC[_B1].tolist())
        B2 = b.local_block(_B_SRC[_B2].tolist())
        chi = xor(B_blk, b.mul(b.sub(one, B1), B2))
        chi_iota = xor(chi, RC)
        expr = b.add(
            b.add(
                b.mul(sel_round, b.sub(nA, chi_iota)),
                b.mul(sel_copy, b.sub(nA, A)),
            ),
            b.mul(sel_absorb, b.sub(nA, xor(A, MSG))),
        )
        b.transition_block(expr, 1600)

        # boundaries: row 0 = block0 bits; last row lanes 0..3 = digest
        b.first_row_block(b.sub(A, MSG), 1600)
        digest_cols = [a_col(lane % 5, lane // 5, z) for lane in range(4) for z in range(64)]
        b.last_row_block(
            b.sub(b.local_block(digest_cols), b.public_block(range(256))), 256
        )


# ---------------------------------------------------------------------------
# Batched sponge: keccak256(message_k) = digest_k for K messages in one trace
# ---------------------------------------------------------------------------

F_RESTART = N_FIXED_SPONGE  # selector: next row re-absorbs from zero state
F_DIGSEL = N_FIXED_SPONGE + 1  # selector: this row carries a bound digest
F_DGST = N_FIXED_SPONGE + 2  # 256 digest-bit columns
N_FIXED_BATCH = N_FIXED_SPONGE + 2 + 256

_DIGEST_COLS = [
    a_col(lane % 5, lane // 5, z) for lane in range(4) for z in range(64)
]


def _digest_bits(digest: bytes) -> list[int]:
    out = []
    for i, byte in enumerate(digest):
        for bit in range(8):
            out.append((byte >> bit) & 1)
    return out


class KeccakSpongeV2Air(Air):
    """Batched sponge with NO message/digest data in fixed columns — the
    succinct form (PARITY roadmap #1).

    Same 4160-wide trace as KeccakBatchSpongeAir; the instance-specific
    fixed columns shrink to layout selectors + per-row keys.  Message
    content is bound through the containment bus (airs/containment.py):

    - absorbed rate bits are DERIVED in-constraint (absorb: A' xor A;
      restart/first: A' resp. A directly) and exported as one rate-block
      code receive per absorb (channel 0, balancing ByteCodeAir's sends);
    - each message's digest bytes are exported as one digest-code send
      (channel 1, consumed by ContainAir);
    - message 0's digest bits are bound to the publics (the state root).

    Trace layout matches KeccakBatchSpongeAir: messages' permutations
    back to back, >= 1 trailing all-copy pad perm, power-of-two total.
    """

    width = WIDTH
    quotient_chunks = 4
    aux_width = 8  # busacc_B (4), busacc_D (4) — exclusive prefixes
    num_aux_challenges = 4  # gamma_B, chi, gamma_D, gamma_T (shared set)
    num_bus_values = 3
    # channel indices as class attributes so the sponge can be embedded
    # in OTHER multi-table groups (the EVM keccak bridge, evm_air.py)
    # under a remapped challenge/bus layout
    CH_B = 0  # rate-block codes challenge (gamma_B)
    CH_CHI = 1  # tuple-code geometric challenge
    CH_D = 2  # digest codes challenge (gamma_D)
    CH_T = 3  # byte-triple challenge (unused here; kept in the set)
    BUS_B = 0  # bus index of the rate-block channel
    BUS_D = 1  # bus index of the digest channel

    # fixed column indices (beyond the shared N_FIXED selector/RC set)
    F2_ABSORB = N_FIXED
    F2_RESTART = N_FIXED + 1
    F2_FIRST = N_FIXED + 2  # row 0 (first block absorbed from zero state)
    F2_DIGEST = N_FIXED + 3
    F2_KEY = N_FIXED + 4  # key of the block absorbed on this transition
    F2_MSGID = N_FIXED + 5  # msg id of the digest sent on this row
    F2_ROOT = N_FIXED + 6  # digest row of the root message (publics bind)
    N_FIXED_V2 = N_FIXED + 7

    RATE_BITS = 1088  # 136 bytes = lanes 0..16 (A columns 0..1087)

    def __init__(
        self,
        block_counts: list[int],
        msg_id_offset: int = 0,
        root_digest: bytes | None = None,
    ):
        """Verifier-side construction: PUBLIC structure only — per-message
        rate-block counts, the global msg-id offset of this chunk, and
        (for the root chunk) the public root digest.  Use from_messages()
        on the prover side (adds trace/aux capability)."""
        from .containment import MAX_BLOCKS

        assert block_counts
        for c in block_counts:
            assert 0 < c <= MAX_BLOCKS
        self.block_counts = list(block_counts)
        self.msg_id_offset = msg_id_offset
        self.root_digest = bytes(root_digest) if root_digest else None
        self.bind_root = root_digest is not None
        self.messages: list[bytes] | None = None
        self.msg_blocks = None
        self.digests = None
        self.active_perms = sum(block_counts)
        self.num_perms = 1 << (self.active_perms + 1 - 1).bit_length()

    @classmethod
    def from_messages(
        cls, messages: list[bytes], msg_id_offset: int = 0, bind_root: bool = False
    ) -> "KeccakSpongeV2Air":
        from ...utils.keccak_py import keccak256

        assert messages
        msg_blocks = [_pad_message(m) for m in messages]
        digests = [keccak256(m) for m in messages]
        air = cls(
            [len(b) for b in msg_blocks],
            msg_id_offset,
            root_digest=digests[0] if bind_root else None,
        )
        air.messages = [bytes(m) for m in messages]
        air.msg_blocks = msg_blocks
        air.digests = digests
        return air

    def structure_key(self) -> tuple:
        return (self.bind_root,)

    def _layout(self):
        out = []
        for mi, count in enumerate(self.block_counts):
            for bi in range(count):
                out.append((mi, bi))
        return out

    def publics(self) -> list[int]:
        if not self.bind_root:
            return []
        return _digest_bits(self.root_digest)

    def fixed_columns(self, n: int):
        assert n == ROWS * self.num_perms
        cols = np.zeros((self.N_FIXED_V2, n), dtype=np.uint32)
        layout = self._layout()
        from .containment import MAX_BLOCKS

        for perm in range(self.num_perms):
            base = ROWS * perm
            if perm < self.active_perms:
                cols[F_ROUND, base : base + N_ROUNDS] = 1
                cols[F_COPY, base + N_ROUNDS : base + ROWS - 1] = 1
                for r in range(N_ROUNDS):
                    rc = ROUND_CONSTANTS[r]
                    for z in range(64):
                        cols[F_RC + a_col(0, 0, z), base + r] = (rc >> z) & 1
            else:
                cols[F_COPY, base : base + ROWS - 1] = 1
            end = base + ROWS - 1
            if perm + 1 < self.active_perms:
                mi, bi = layout[perm]
                nmi, nbi = layout[perm + 1]
                key = (self.msg_id_offset + nmi) * MAX_BLOCKS + nbi
                if nmi == mi:
                    cols[self.F2_ABSORB, end] = 1
                else:
                    cols[self.F2_RESTART, end] = 1
                cols[self.F2_KEY, end] = key
                if nmi != mi:
                    if mi == 0 and self.bind_root:
                        # the root's digest binds via publics, not the bus
                        cols[self.F2_ROOT, end] = 1
                    else:
                        cols[self.F2_DIGEST, end] = 1
                        cols[self.F2_MSGID, end] = self.msg_id_offset + mi
            else:
                cols[F_COPY, end] = 1
                if perm + 1 == self.active_perms:
                    mi, _ = layout[perm]
                    if mi == 0 and self.bind_root:
                        cols[self.F2_ROOT, end] = 1
                    else:
                        cols[self.F2_DIGEST, end] = 1
                        cols[self.F2_MSGID, end] = self.msg_id_offset + mi
        cols[self.F2_FIRST, 0] = 1
        cols[self.F2_KEY, 0] = self.msg_id_offset * MAX_BLOCKS
        cols[F_COPY, n - 1] = 0
        return cols

    def trace(self) -> np.ndarray:
        # identical state evolution to KeccakBatchSpongeAir.trace
        assert self.messages is not None, "prover-side only (from_messages)"
        helper = KeccakBatchSpongeAir(self.messages, digests=self.digests)
        assert helper.num_perms == self.num_perms
        return helper.trace()

    # -- bus contributions ------------------------------------------------
    def _contributions(self, challenges: list[tuple]):
        """[(row, channel, term)] with EXCLUSIVE-prefix accounting: the
        term is added to the accumulator AFTER `row`."""
        from .containment import MAX_BLOCKS, block_code, digest_code

        gamma_b = challenges[self.CH_B]
        chi = challenges[self.CH_CHI]
        gamma_d = challenges[self.CH_D]
        layout = self._layout()
        denoms = []
        meta = []
        for perm in range(self.active_perms):
            end = ROWS * perm + ROWS - 1
            mi, bi = layout[perm]
            if perm + 1 < self.active_perms:
                nmi, nbi = layout[perm + 1]
                key = (self.msg_id_offset + nmi) * MAX_BLOCKS + nbi
                blk = _block_bytes(self.msg_blocks[nmi][nbi])
                denoms.append(ef.h_sub(gamma_b, block_code(key, blk, chi)))
                meta.append((end, 0, -1))
            if perm + 1 >= self.active_perms or layout[perm + 1][0] != mi:
                if not (mi == 0 and self.bind_root):
                    code = digest_code(
                        self.msg_id_offset + mi, self.digests[mi], chi
                    )
                    denoms.append(ef.h_sub(gamma_d, code))
                    meta.append((end, 1, +1))
        # row 0: first block of message 0
        key0 = self.msg_id_offset * MAX_BLOCKS
        blk0 = _block_bytes(self.msg_blocks[0][0])
        denoms.append(ef.h_sub(gamma_b, block_code(key0, blk0, chi)))
        meta.append((0, 0, -1))
        invs = ef.h_batch_inv(denoms)
        out = []
        for (row, chan, sign), iv in zip(meta, invs):
            term = iv if sign > 0 else ef.h_neg(iv)
            out.append((row, chan, term))
        return out

    def aux_trace(self, trace: np.ndarray, challenges: list[tuple]) -> np.ndarray:
        n = trace.shape[0]
        aux = np.zeros((n, 8), dtype=np.uint32)
        per_row: dict[int, list] = {}
        for row, chan, term in self._contributions(challenges):
            per_row.setdefault(row, []).append((chan, term))
        acc = [ef.H_ZERO, ef.H_ZERO]  # channels 0 (blocks), 1 (digests)
        for row in range(n):
            aux[row, 0:4] = acc[0]
            aux[row, 4:8] = acc[1]
            for chan, term in per_row.get(row, []):
                acc[chan] = ef.h_add(acc[chan], term)
        return aux

    def bus_values(self, trace: np.ndarray, challenges: list[tuple]) -> list[tuple]:
        acc = [ef.H_ZERO, ef.H_ZERO]
        for _, chan, term in self._contributions(challenges):
            acc[chan] = ef.h_add(acc[chan], term)
        out = [ef.H_ZERO] * self.num_bus_values
        out[self.BUS_B] = acc[0]
        out[self.BUS_D] = acc[1]
        return out

    def eval(self, b: ConstraintBuilder) -> None:
        from .containment import MAX_BLOCKS  # noqa: F401 (doc anchor)

        a_cols = list(range(A0, A0 + 1600))
        A = b.local_block(a_cols)
        nA = b.next_block(a_cols)
        C = b.local_block(range(C0, C0 + 320))
        H0 = b.local_block(range(H0_0, H0_0 + 320))
        H1 = b.local_block(range(H1_0, H1_0 + 320))
        AMID = b.local_block(range(AMID0, AMID0 + 1600))
        sel_round = b.fixed(F_ROUND)
        sel_copy = b.fixed(F_COPY)
        s_abs = b.fixed(self.F2_ABSORB)
        s_res = b.fixed(self.F2_RESTART)
        s_first = b.fixed(self.F2_FIRST)
        s_dig = b.fixed(self.F2_DIGEST)
        f_key = b.fixed(self.F2_KEY)
        f_msgid = b.fixed(self.F2_MSGID)
        s_root = b.fixed(self.F2_ROOT)
        RC = b.fixed_block([F_RC + i for i in range(1600)])
        one = b.constant(1)

        def xor(p, q):
            return b.sub(b.add(p, q), b.scale(2, b.mul(p, q)))

        # -- keccak permutation constraints (identical to v1) -----------
        s = None
        for y in range(5):
            blk = b.local_block(
                [a_col(x, y, z) for x in range(5) for z in range(64)]
            )
            s = blk if s is None else b.add(s, blk)
        rhs = b.add(b.add(C, b.scale(2, H0)), b.scale(4, H1))
        b.transition_block(b.sub(s, rhs), 320)
        for blk in (C, H0, H1):
            b.transition_block(b.mul(blk, b.sub(blk, one)), 320)
        c1 = b.local_block(_D_C1.tolist())
        c2 = b.local_block(_D_C2.tolist())
        b.transition_block(b.sub(AMID, xor(A, xor(c1, c2))), 1600)
        B_blk = b.local_block(_B_SRC.tolist())
        B1 = b.local_block(_B_SRC[_B1].tolist())
        B2 = b.local_block(_B_SRC[_B2].tolist())
        chi_blk = xor(B_blk, b.mul(b.sub(one, B1), B2))
        chi_iota = xor(chi_blk, RC)
        b.transition_block(
            b.add(
                b.mul(sel_round, b.sub(nA, chi_iota)),
                b.mul(sel_copy, b.sub(nA, A)),
            ),
            1600,
        )

        # -- absorb structure (v2: no MSG columns) -----------------------
        RB = self.RATE_BITS
        A_rate = b.local_block(range(A0, A0 + RB))
        nA_rate = b.next_block(range(A0, A0 + RB))
        A_capv = b.local_block(range(A0 + RB, A0 + 1600))
        nA_cap = b.next_block(range(A0 + RB, A0 + 1600))
        s_ar = b.add(s_abs, s_res)
        # capacity: absorb preserves, restart zeroes
        b.transition_block(b.mul(s_abs, b.sub(nA_cap, A_capv)), 1600 - RB)
        b.transition_block(b.mul(s_res, nA_cap), 1600 - RB)
        # absorbed rate bits boolean (they are otherwise unconstrained)
        b.transition_block(
            b.mul(s_ar, b.mul(nA_rate, b.sub(nA_rate, one))), RB
        )
        # row 0: capacity zero, rate bits boolean
        b.first_row_block(A_capv, 1600 - RB)
        b.first_row_block(b.mul(A_rate, b.sub(A_rate, one)), RB)

        # -- rate-block / digest codes (vectorized bit_block_code) -------
        chi_c = b.challenge_ef(self.CH_CHI)
        gamma_b = b.challenge_ef(self.CH_B)
        gamma_d = b.challenge_ef(self.CH_D)
        gamma_t = b.challenge_ef(self.CH_T)

        # absorbed-block bits: first -> A, absorb -> A xor A', restart -> A'
        xorb = xor(A_rate, nA_rate)
        mb = b.add(
            b.mul(s_first, A_rate),
            b.add(b.mul(s_abs, xorb), b.mul(s_res, nA_rate)),
        )
        code_b = b.bit_block_code(mb, chi_c, f_key, 136)

        # digest bytes from A at digest rows (lanes 0..3 = 32 bytes)
        code_d = b.bit_block_code(
            b.local_block(_DIGEST_COLS), chi_c, f_msgid, 32
        )

        # -- bus accumulators (exclusive prefixes) -----------------------
        accB = [b.aux(c) for c in range(4)]
        accB_n = [b.aux_next(c) for c in range(4)]
        accD = [b.aux(4 + c) for c in range(4)]
        accD_n = [b.aux_next(4 + c) for c in range(4)]
        s_any = b.add(s_ar, s_first)
        # receive: (acc' - acc)*(gamma_b - code_b) = -s_any
        dB = b.ef_sub4(accB_n, accB)
        prodB = b.ef_mul4(dB, b.ef_sub4(gamma_b, code_b))
        sany4 = b.ef_from_base4(s_any)
        for c in range(4):
            b.transition(b.add(prodB[c], sany4[c]))
            b.first_row(accB[c])
        # send: (acc' - acc)*(gamma_d - code_d) = s_dig
        dD = b.ef_sub4(accD_n, accD)
        prodD = b.ef_mul4(dD, b.ef_sub4(gamma_d, code_d))
        sdig4 = b.ef_from_base4(s_dig)
        for c in range(4):
            b.transition(b.sub(prodD[c], sdig4[c]))
            b.first_row(accD[c])
        # bindings on the (pad-perm) last row
        for i in range(self.num_bus_values):
            for c in range(4):
                if i == self.BUS_B:
                    b.last_row(b.sub(accB[c], b.bus_coord(4 * i + c)))
                elif i == self.BUS_D:
                    b.last_row(b.sub(accD[c], b.bus_coord(4 * i + c)))
                else:
                    b.last_row(b.bus_coord(4 * i + c))
        # keep gamma_t in the challenge set (shared indices across tables)
        _ = gamma_t

        # -- root binding: message 0's digest bits are the publics -------
        if self.bind_root:
            b.transition_block(
                b.mul(s_root, b.sub(b.local_block(_DIGEST_COLS), b.public_block(range(256)))),
                256,
            )


def _block_bytes(bits: np.ndarray) -> bytes:
    """(1600,) bit vector -> 136 rate bytes."""
    out = bytearray(136)
    for i in range(136):
        v = 0
        for bit in range(8):
            v |= int(bits[8 * i + bit]) << bit
        out[i] = v
    return bytes(out)


class KeccakBatchSpongeAir(Air):
    """keccak256(message_k) = digest_k for K public messages, one trace.

    Generalizes KeccakSpongeAir (reference workload: the keccak-256 calls
    of the MPT state-root recomputation, lib/src/primitives/mpt.rs:117-121
    — one batch proof covers every node preimage).  Message k's
    permutations run back to back; on the last row of its final
    permutation the `restart` selector forces the NEXT row to equal the
    next message's first block (a fresh absorb from the zero sponge
    state), and the `digsel` selector binds lanes 0..3 to message k's
    digest bits (carried in fixed columns).  A trailing all-copy padding
    permutation guarantees every digest row is interior, so digest
    binding needs no last-row special case.

    ``digests`` may be supplied by a verifier (claimed values to check);
    the prover leaves it None and computes them.  Soundness of the
    digest claims comes from the constraints, not from recomputation.
    """

    width = WIDTH
    quotient_chunks = 4

    def __init__(self, messages: list[bytes], digests: list[bytes] | None = None):
        assert messages, "at least one message"
        self.messages = [bytes(m) for m in messages]
        self.msg_blocks = [_pad_message(m) for m in self.messages]
        if digests is None:
            from ...utils.keccak_py import keccak256

            digests = [keccak256(m) for m in self.messages]
        assert len(digests) == len(self.messages)
        self.digests = [bytes(d) for d in digests]
        self.active_perms = sum(len(b) for b in self.msg_blocks)
        # +1 pad perm so every digest row has a successor row
        self.num_perms = 1 << (self.active_perms + 1 - 1).bit_length()

    # perm index -> (message, block) map ---------------------------------
    def _layout(self):
        out = []
        for mi, blocks in enumerate(self.msg_blocks):
            for bi in range(len(blocks)):
                out.append((mi, bi))
        return out

    def publics(self) -> list[int]:
        """Digest bits of every message (Fiat-Shamir statement binding;
        the row-level binding itself rides in the fixed columns)."""
        out = [len(self.messages)]
        for d in self.digests:
            out.extend(_digest_bits(d))
        return out

    def fixed_columns(self, n: int):
        assert n == ROWS * self.num_perms
        cols = np.zeros((N_FIXED_BATCH, n), dtype=np.uint32)
        layout = self._layout()
        for perm in range(self.num_perms):
            base = ROWS * perm
            if perm < self.active_perms:
                cols[F_ROUND, base : base + N_ROUNDS] = 1
                cols[F_COPY, base + N_ROUNDS : base + ROWS - 1] = 1
                for r in range(N_ROUNDS):
                    rc = ROUND_CONSTANTS[r]
                    for z in range(64):
                        cols[F_RC + a_col(0, 0, z), base + r] = (rc >> z) & 1
            else:
                cols[F_COPY, base : base + ROWS - 1] = 1
            # boundary row base+ROWS-1: absorb / restart / copy
            if perm + 1 < self.active_perms:
                mi, bi = layout[perm]
                nmi, nbi = layout[perm + 1]
                if nmi == mi:  # next block of the same message
                    cols[F_ABSORB, base + ROWS - 1] = 1
                    cols[F_MSG : F_MSG + 1600, base + ROWS - 1] = self.msg_blocks[
                        nmi
                    ][nbi]
                else:  # new message: fresh absorb from zero state
                    cols[F_RESTART, base + ROWS - 1] = 1
                    cols[F_MSG : F_MSG + 1600, base + ROWS - 1] = self.msg_blocks[
                        nmi
                    ][0]
                    cols[F_DIGSEL, base + ROWS - 1] = 1
                    cols[F_DGST : F_DGST + 256, base + ROWS - 1] = _digest_bits(
                        self.digests[mi]
                    )
            else:
                # last active perm (digest row) or padding: state rides on
                cols[F_COPY, base + ROWS - 1] = 1
                if perm + 1 == self.active_perms:
                    mi, _ = layout[perm]
                    cols[F_DIGSEL, base + ROWS - 1] = 1
                    cols[F_DGST : F_DGST + 256, base + ROWS - 1] = _digest_bits(
                        self.digests[mi]
                    )
        # the very last trace row has no transition; clear its selectors
        cols[F_COPY, n - 1] = 0
        cols[F_MSG : F_MSG + 1600, 0] = self.msg_blocks[0][0]
        return cols

    def trace(self) -> np.ndarray:
        n = ROWS * self.num_perms
        rows = np.zeros((n, WIDTH), dtype=np.uint32)
        layout = self._layout()
        state = [0] * 25
        for perm in range(self.num_perms):
            base = ROWS * perm
            if perm < self.active_perms:
                mi, bi = layout[perm]
                if bi == 0:
                    state = [0] * 25  # new message: sponge restarts
                blk = bits_to_state(self.msg_blocks[mi][bi])
                state = [state[i] ^ blk[i] for i in range(25)]
            cur = list(state)
            for row in range(ROWS):
                a = state_to_bits(cur)
                rows[base + row, A0:C0] = a
                s = np.zeros(320, dtype=np.uint32)
                for x in range(5):
                    for y in range(5):
                        s[x * 64 : x * 64 + 64] += a[
                            (x + 5 * y) * 64 : (x + 5 * y) * 64 + 64
                        ]
                rows[base + row, C0:H0_0] = s & 1
                rows[base + row, H0_0:H1_0] = (s >> 1) & 1
                rows[base + row, H1_0:AMID0] = s >> 2
                d = rows[base + row, _D_C1] ^ rows[base + row, _D_C2]
                rows[base + row, AMID0:] = a ^ d
                if perm < self.active_perms and row < N_ROUNDS:
                    cur = _one_round(cur, row)
            state = cur
        return rows

    def eval(self, b: ConstraintBuilder) -> None:
        a_cols = list(range(A0, A0 + 1600))
        A = b.local_block(a_cols)
        nA = b.next_block(a_cols)
        C = b.local_block(range(C0, C0 + 320))
        H0 = b.local_block(range(H0_0, H0_0 + 320))
        H1 = b.local_block(range(H1_0, H1_0 + 320))
        AMID = b.local_block(range(AMID0, AMID0 + 1600))
        sel_round = b.fixed(F_ROUND)
        sel_copy = b.fixed(F_COPY)
        sel_absorb = b.fixed(F_ABSORB)
        sel_restart = b.fixed(F_RESTART)
        sel_dig = b.fixed(F_DIGSEL)
        RC = b.fixed_block([F_RC + i for i in range(1600)])
        MSG = b.fixed_block([F_MSG + i for i in range(1600)])
        DGST = b.fixed_block([F_DGST + i for i in range(256)])
        one = b.constant(1)

        def xor(p, q):
            return b.sub(b.add(p, q), b.scale(2, b.mul(p, q)))

        s = None
        for y in range(5):
            blk = b.local_block(
                [a_col(x, y, z) for x in range(5) for z in range(64)]
            )
            s = blk if s is None else b.add(s, blk)
        rhs = b.add(b.add(C, b.scale(2, H0)), b.scale(4, H1))
        b.transition_block(b.sub(s, rhs), 320)
        for blk in (C, H0, H1):
            b.transition_block(b.mul(blk, b.sub(blk, one)), 320)
        c1 = b.local_block(_D_C1.tolist())
        c2 = b.local_block(_D_C2.tolist())
        b.transition_block(b.sub(AMID, xor(A, xor(c1, c2))), 1600)

        B_blk = b.local_block(_B_SRC.tolist())
        B1 = b.local_block(_B_SRC[_B1].tolist())
        B2 = b.local_block(_B_SRC[_B2].tolist())
        chi = xor(B_blk, b.mul(b.sub(one, B1), B2))
        chi_iota = xor(chi, RC)
        expr = b.add(
            b.add(
                b.add(
                    b.mul(sel_round, b.sub(nA, chi_iota)),
                    b.mul(sel_copy, b.sub(nA, A)),
                ),
                b.mul(sel_absorb, b.sub(nA, xor(A, MSG))),
            ),
            b.mul(sel_restart, b.sub(nA, MSG)),  # fresh absorb: A' = 0 ^ MSG
        )
        b.transition_block(expr, 1600)

        # digest binding at interior rows selected by sel_dig
        b.transition_block(
            b.mul(sel_dig, b.sub(b.local_block(_DIGEST_COLS), DGST)), 256
        )

        # boundary: row 0 = first message's first block
        b.first_row_block(b.sub(A, MSG), 1600)
