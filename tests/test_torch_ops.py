"""The port's remaining ops entry points on the CPU, against the JAX package.

B3 ``ec_double`` (against the Pallas kernel in its interpret mode), B6
``ntt_mxu`` (against JAX's ``ntt_mxu`` and ``ntt.ntt``), and the batched
Keccak-256 and SHA-256 (against JAX and the host hashes).  The same
numpy-seeded inputs go through raiko_tpu (JAX on the CPU) and
raiko_tpu_torch, whose wrappers run their kernels' plain versions on CPU
tensors.  Every comparison is exact (tolerance 0).  The JAX side is
computed once per module.  The tests marked ``cuda`` hold the kernels
against their plain versions on a card.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raiko_tpu.fields import babybear as jbb
from raiko_tpu.kzg import host_curve as hc
from raiko_tpu.ops import ec_pallas as jec
from raiko_tpu.ops import keccak as jkeccak
from raiko_tpu.ops import ntt as jntt
from raiko_tpu.ops import ntt_mxu as jmxu
from raiko_tpu.ops import sha256 as jsha
from raiko_tpu_torch import convert
from raiko_tpu_torch.fields.limbs import FP
from raiko_tpu_torch.kzg import curve as tcurve
from raiko_tpu_torch.ops import ec_cuda, keccak, keccak_cuda, ntt_mxu, ntt_mxu_cuda, sha256, sha256_cuda
from raiko_tpu_torch.utils.keccak_py import keccak256 as keccak_host


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs files in parallel workers: torch's own thread pool per
    # worker would oversubscribe the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    return torch.device("cuda")


def _mont(seed: int, shape) -> np.ndarray:
    return jbb.np_to_mont(np.random.default_rng(seed).integers(0, jbb.P, shape, dtype=np.uint32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# B3 ec_double
# ---------------------------------------------------------------------------


def _g1_points(seed: int) -> tuple[np.ndarray, list]:
    """(40, 3, 24) Montgomery points, 16-bit limbs: 16 affine (Z = 1), 16
    with a random Z, 8 identities; and their affine values (None for the
    identity)."""
    rng = np.random.default_rng(seed)
    affine = [hc.g1_mul(hc.G1_GEN, int(rng.integers(1, 1 << 62))) for _ in range(32)]
    rows = []
    for i, (x, y) in enumerate(affine):
        lam = 1 if i < 16 else int.from_bytes(rng.bytes(48), "big") % (hc.P - 1) + 1
        rows.append(np.stack([FP.to_mont_int(x * lam % hc.P), FP.to_mont_int(y * lam % hc.P),
                              FP.to_mont_int(lam)]))
    ident = np.stack([np.zeros(24), FP.to_mont_int(1), np.zeros(24)])
    rows += [ident] * 8
    return np.stack(rows).astype(np.int64), affine + [None] * 8


@pytest.fixture(scope="module")
def doubled():
    """(points, affine values, the Pallas ec_double of the points)."""
    pts, affine = _g1_points(31)
    want = np.asarray(jec.ec_double(jnp.asarray(pts.astype(np.uint32))))
    return pts, affine, want


def test_ec_double_plain_matches_pallas_interpret(doubled):
    pts, affine, want = doubled
    got = ec_cuda.ec_double(convert.pack32(torch.as_tensor(pts)))
    assert got.dtype == torch.int32 and got.shape == (40, 3, 12)
    np.testing.assert_array_equal(convert.unpack32(got).numpy(), want.astype(np.int64))
    for i in (0, 17, 39):
        expect = None if affine[i] is None else hc.g1_add(affine[i], affine[i])
        assert tcurve.to_affine(want[i].astype(np.int64)) == expect


def test_ec_double_plain_chunks_like_one_call(doubled):
    pts, _, want = doubled
    many = np.concatenate([pts] * 7)  # 280 rows: two plain chunks
    got = ec_cuda.ec_double(convert.pack32(torch.as_tensor(many)))
    np.testing.assert_array_equal(convert.unpack32(got).numpy(), np.concatenate([want] * 7).astype(np.int64))


# ---------------------------------------------------------------------------
# B6 ntt_mxu
# ---------------------------------------------------------------------------

_jntt = jax.jit(jntt.ntt)
_jmxu = jax.jit(jmxu.ntt_mxu)


@pytest.mark.parametrize("log_n,batch", [(2, 3), (7, 3), (10, 2), (13, 2), (14, 2)])
def test_ntt_mxu_matches_jax(log_n, batch):
    x = _mont(log_n, (batch, 1 << log_n))
    got = ntt_mxu.ntt_mxu(convert.words_from_numpy(x, "cpu"))
    assert got.dtype == torch.int32
    want = np.asarray(_jmxu(jnp.asarray(x)))
    np.testing.assert_array_equal(_u32(got), want)
    np.testing.assert_array_equal(want, np.asarray(_jntt(jnp.asarray(x))))


def test_ntt_mxu_keeps_leading_dims():
    x = _mont(3, (2, 3, 64))
    got = ntt_mxu.ntt_mxu(convert.words_from_numpy(x, "cpu"))
    want = ntt_mxu.ntt_mxu(convert.words_from_numpy(x.reshape(6, 64), "cpu"))
    assert got.shape == (2, 3, 64)
    assert torch.equal(got.reshape(6, 64), want)


@pytest.mark.parametrize("log_m", range(8))
def test_ntt_mxu_tables_match_jax(log_m):
    mine = ntt_mxu._dft_matrix_limbs(log_m)
    assert mine.dtype == np.int8
    np.testing.assert_array_equal(mine, jmxu._dft_matrix_limbs(log_m))
    assert ntt_mxu._recombine_consts(1 << log_m) == jmxu._recombine_consts(1 << log_m)
    assert ntt_mxu._OFFSET == jmxu._OFFSET
    # the kernel's packed A fragments hold the same digits
    np.testing.assert_array_equal(_unpack_fragments(ntt_mxu_cuda._packed_matrix(log_m))[:, :1 << log_m, :1 << log_m],
                                  mine)


def _unpack_fragments(packed: np.ndarray) -> np.ndarray:
    """(4, 16 KB, 32 KC) int8 digit matrices from the (KB, KC, 4, 32, 4)
    int32 A fragments, by the layout csrc/babybear_ntt_mxu.cu documents
    (the m16n8k32 s8 A operand of the PTX ISA): word [kb, kc, i, lane, r],
    lane = 4 g + t, holds W_i[16 kb + g + 8 (r & 1), 32 kc + 16 (r >> 1) +
    4 t + b] in byte b."""
    kbs, kcs = packed.shape[:2]
    out = np.full((4, 16 * kbs, 32 * kcs), 99, dtype=np.int8)
    for (kb, kc, i, lane, r), word in np.ndenumerate(packed):
        g, t = lane >> 2, lane & 3
        col = 32 * kc + 16 * (r >> 1) + 4 * t
        out[i, 16 * kb + g + 8 * (r & 1), col : col + 4] = np.array([word], dtype="<i4").view(np.int8)
    return out


@pytest.mark.parametrize("log_m", range(1, 8))
def test_ntt_mxu_packed_fragments_unpack_to_the_digits(log_m):
    m = 1 << log_m
    packed = ntt_mxu_cuda._packed_matrix(log_m)
    assert packed.dtype == np.int32 and packed.shape == (-(-m // 16), -(-m // 32), 4, 32, 4)
    full = _unpack_fragments(packed)
    np.testing.assert_array_equal(full[:, :m, :m], jmxu._dft_matrix_limbs(log_m))
    full[:, :m, :m] = 0
    assert not full.any()  # zero past M x M, every byte written once


def _recombine_model(sums: torch.Tensor) -> torch.Tensor:
    """csrc/babybear_ntt_mxu.cu's reduction of the seven diagonal sums, in
    torch: (7, ...) int64 S_s, |S_s| <= 2^23 -> sum_s S_s 2^(8s) mod p,
    canonical, by one Montgomery step on V = p 2^26 + sum_s S_s b_s with
    b_s = 2^(8s) 2^32 mod p (0 < V < p 2^32)."""
    p = jbb.P
    v = (p << 26) + sum(sums[s] * pow(2, 32 + 8 * s, p) for s in range(7))
    m = ((v & 0xFFFFFFFF) * ((-pow(p, -1, 1 << 32)) % (1 << 32))) & 0xFFFFFFFF
    t = (v + m * p) >> 32  # < 2p; v + m p < 2^63
    return torch.where(t >= p, t - p, t)


def test_ntt_mxu_recombine_model_matches_formula():
    """The kernel's reduction (one Montgomery step on p 2^26 + sum_s S_s b_s)
    equals the reference's sum_s mont_mul(S_s + 2^23, 2^(8s) R) - K over
    random sums and at the edges +-2^23."""
    edge = 1 << 23
    rng = np.random.default_rng(12)
    sums = rng.integers(-edge, edge + 1, (7, 4000))
    # every S_s at +-2^23 or 0, alternating in sign, and one extreme at a time
    for col, v in enumerate((edge, -edge, 0, edge - 1, -edge + 1)):
        sums[:, col] = v
    sums[:, 5] = [edge, -edge] * 3 + [edge]
    sums[:, 6] = [-edge, edge] * 3 + [-edge]
    for s in range(7):
        sums[:, 7 + 2 * s : 9 + 2 * s] = 0
        sums[s, 7 + 2 * s], sums[s, 8 + 2 * s] = edge, -edge
    sums = torch.as_tensor(sums)
    got = _recombine_model(sums)
    bs, k_const = jmxu._recombine_consts(64)
    want = None
    for s in range(7):
        term = jbb.mont_mul(jnp.asarray((sums[s] + ntt_mxu._OFFSET).numpy().astype(np.uint32)), jnp.uint32(bs[s]))
        want = term if want is None else jbb.add(want, term)
    want = np.asarray(jbb.sub(want, jnp.uint32(k_const)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    direct = [sum(int(v) << (8 * s) for s, v in enumerate(col)) % jbb.P for col in sums.T.tolist()[:50]]
    assert got[:50].tolist() == direct


def test_ntt_mxu_kernel_digit_words_are_balanced_limbs():
    """The kernel's digits of v < p, the bytes of (v + 0x80808080) ^
    0x80808080 read as int8, are the reference's balanced limbs."""
    vals = [0, 1, 127, 128, 255, 256, 0x7F7F7F, 0x7780FF80, jbb.P - 1]
    vals += np.random.default_rng(13).integers(0, jbb.P, 500).tolist()
    words = ((np.array(vals, dtype=np.uint64) + 0x80808080) & 0xFFFFFFFF).astype(np.uint32) ^ np.uint32(0x80808080)
    digits = words.astype("<u4").view(np.int8).reshape(-1, 4)
    np.testing.assert_array_equal(digits, [jmxu._balanced_limbs_int(v) for v in vals])


def test_balanced_limbs_match_jax():
    vals = [0, 1, 127, 128, 255, 256, 0x7F7F7F, 0x7780FF80, jbb.P - 1]
    vals += np.random.default_rng(5).integers(0, jbb.P, 200).tolist()
    for v in vals:
        assert ntt_mxu._balanced_limbs_int(v) == jmxu._balanced_limbs_int(v)
        assert sum(d << (8 * i) for i, d in enumerate(ntt_mxu._balanced_limbs_int(v))) == v
    with pytest.raises(ValueError):  # the top digit overflows, as the reference asserts
        ntt_mxu._balanced_limbs_int((1 << 31) - 1)
    digits = torch.stack(ntt_mxu._balanced_limbs(torch.as_tensor(vals, dtype=torch.int64)), dim=1)
    np.testing.assert_array_equal(digits.numpy(), [jmxu._balanced_limbs_int(v) for v in vals])


# ---------------------------------------------------------------------------
# Keccak-256
# ---------------------------------------------------------------------------

_RNG_MSGS = np.random.default_rng(7)
KECCAK_MSGS = [b"", b"abc", b"a" * 135, b"b" * 136, b"c" * 137, _RNG_MSGS.bytes(500), b"x" * 32,
               b"y" * 64, _RNG_MSGS.bytes(271), _RNG_MSGS.bytes(272)]
SHA_MSGS = [b"", b"abc", b"a" * 55, b"b" * 56, b"c" * 64, _RNG_MSGS.bytes(130), _RNG_MSGS.bytes(48),
            _RNG_MSGS.bytes(119), _RNG_MSGS.bytes(120)]


def test_keccak_f1600_matches_jax():
    state = np.random.default_rng(8).integers(0, 1 << 32, (5, 25, 2), dtype=np.uint32)
    state[0] = 0
    want = np.asarray(jax.jit(jkeccak.keccak_f1600_batch)(jnp.asarray(state)))
    got = keccak.keccak_f1600_batch(convert.words_from_numpy(state, "cpu"))
    assert got.dtype == torch.int32 and got.shape == (5, 25, 2)
    np.testing.assert_array_equal(_u32(got), want)


def test_keccak256_batch_matches_jax_and_host():
    got = keccak.keccak256_batch(KECCAK_MSGS, "cpu")
    assert got == jkeccak.keccak256_tpu(KECCAK_MSGS)
    assert got == [keccak_host(m) for m in KECCAK_MSGS]
    assert keccak.keccak256_batch([], "cpu") == []


@pytest.mark.parametrize("length", [0, 32, 64, 135])
def test_keccak256_fixed_matches_jax_and_host(length):
    data = np.random.default_rng(length).integers(0, 256, (4, length), dtype=np.uint8)
    got = keccak.keccak256_fixed(torch.as_tensor(data))
    want = np.asarray(jkeccak.keccak256_fixed(jnp.asarray(data)))
    np.testing.assert_array_equal(_u32(got), want)
    raw = got.numpy().astype("<i4").tobytes()
    assert [raw[32 * i : 32 * i + 32] for i in range(4)] == [keccak_host(r.tobytes()) for r in data]


def test_keccak_pack_messages_matches_jax():
    for group in ([b"", b"abc", b"a" * 135], [b"b" * 136, b"c" * 137]):
        words, nb = keccak.pack_messages(group)
        jwords, jnb = jkeccak.pack_messages(group)
        assert nb == jnb
        np.testing.assert_array_equal(words, jwords)
    with pytest.raises(ValueError):
        keccak.pack_messages([b"", b"b" * 136])
    words, counts = keccak.pack_ragged(KECCAK_MSGS)
    assert counts.tolist() == [len(m) // keccak.RATE + 1 for m in KECCAK_MSGS]
    for i, m in enumerate(KECCAK_MSGS):
        one, nb = keccak.pack_messages([m])
        np.testing.assert_array_equal(words[i, :nb], one[0])
        assert not words[i, nb:].any()


# ---------------------------------------------------------------------------
# SHA-256
# ---------------------------------------------------------------------------


def test_sha256_constants_match_jax():
    np.testing.assert_array_equal(sha256.K, jsha.K)
    np.testing.assert_array_equal(sha256.H0, jsha.H0)
    assert int(sha256.K[0]) == 0x428A2F98 and int(sha256.H0[7]) == 0x5BE0CD19


def test_sha256_batch_matches_jax_and_hashlib():
    got = sha256.sha256_batch(SHA_MSGS, "cpu")
    assert got == jsha.sha256_tpu(SHA_MSGS)
    assert got == [hashlib.sha256(m).digest() for m in SHA_MSGS]
    assert sha256.sha256_batch([], "cpu") == []


def test_sha256_compress_batch_matches_jax():
    rng = np.random.default_rng(9)
    state = rng.integers(0, 1 << 32, (6, 8), dtype=np.uint32)
    block = rng.integers(0, 1 << 32, (6, 16), dtype=np.uint32)
    want = np.asarray(jax.jit(jsha.sha256_compress_batch)(jnp.asarray(state), jnp.asarray(block)))
    got = sha256.sha256_compress_batch(convert.words_from_numpy(state, "cpu"),
                                       convert.words_from_numpy(block, "cpu"))
    np.testing.assert_array_equal(_u32(got), want)


def test_sha256_pack_messages_matches_jax():
    for group in ([b"", b"abc", b"a" * 55], [b"b" * 56, b"c" * 64]):
        words, nb = sha256.pack_messages(group)
        jwords, jnb = jsha.pack_messages(group)
        assert nb == jnb
        np.testing.assert_array_equal(words, jwords)
    with pytest.raises(ValueError):
        sha256.pack_messages([b"", b"b" * 56])


# ---------------------------------------------------------------------------
# models of the hash kernels' designs (csrc/keccak_f1600.cu, csrc/sha256.cu)
# ---------------------------------------------------------------------------

M32 = 0xFFFFFFFF


def _byte_perm(a: torch.Tensor, b, sel: int) -> torch.Tensor:
    """__byte_perm(a, b, sel) on int64 tensors holding u32 words."""
    b = torch.as_tensor(b, dtype=torch.int64).expand_as(a)
    out = torch.zeros_like(a)
    for k in range(4):
        idx = (sel >> (4 * k)) & 7
        src = a if idx < 4 else b
        out |= ((src >> (8 * (idx & 3))) & 0xFF) << (8 * k)
    return out


def _unzip(x: torch.Tensor) -> torch.Tensor:
    """The kernel's unzip: even bits to the low half, odd to the high."""
    for s, m in ((1, 0x22222222), (2, 0x0C0C0C0C), (4, 0x00F000F0)):
        t = (x ^ (x >> s)) & m
        x = x ^ t ^ ((t << s) & M32)
    return _byte_perm(x, 0, 0x3120)


def _zip(x: torch.Tensor) -> torch.Tensor:
    x = _byte_perm(x, 0, 0x3120)
    for s, m in ((4, 0x00F000F0), (2, 0x0C0C0C0C), (1, 0x22222222)):
        t = (x ^ (x >> s)) & m
        x = x ^ t ^ ((t << s) & M32)
    return x


def _interleave(lo: torch.Tensor, hi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A pair's load: the even lane holds lo, the odd lane hi; each unzips
    its word and joins it with its partner's by its selector."""
    u_even, u_odd = _unzip(lo), _unzip(hi)
    return _byte_perm(u_even, u_odd, 0x5410), _byte_perm(u_odd, u_even, 0x3276)


def _deinterleave(even: torch.Tensor, odd: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return _zip(_byte_perm(even, odd, 0x5410)), _zip(_byte_perm(odd, even, 0x3276))


def _rotl32(x: torch.Tensor, n: int) -> torch.Tensor:
    n %= 32  # the funnel shift's amount wraps
    return x if n == 0 else ((x << n) & M32) | (x >> (32 - n))


def _rot_pair(even: torch.Tensor, odd: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """rotl64 by n on interleaved halves: by 2k each half by k; by 2k + 1
    the halves swap, the even lane taking rotl32(odd, k + 1)."""
    if n % 2 == 0:
        return _rotl32(even, n // 2), _rotl32(odd, n // 2)
    return _rotl32(odd, n // 2 + 1), _rotl32(even, n // 2)


def _pair_rc() -> tuple[list, list]:
    rc = torch.as_tensor(keccak._RC_ARR)
    even, odd = _interleave(rc[:, 0], rc[:, 1])
    return even.tolist(), odd.tolist()


def _keccak_pair_model(even: list, odd: list) -> tuple[list, list]:
    """Keccak-f[1600] as the pair layout runs it: 25 (B,) int64 words a
    lane of the pair, 24 rounds on interleaved halves."""
    rc_even, rc_odd = _pair_rc()
    rho = keccak._RHO_VEC.tolist()
    for r in range(24):
        ce = [even[x] ^ even[x + 5] ^ even[x + 10] ^ even[x + 15] ^ even[x + 20] for x in range(5)]
        co = [odd[x] ^ odd[x + 5] ^ odd[x + 10] ^ odd[x + 15] ^ odd[x + 20] for x in range(5)]
        for x in range(5):
            de, do = _rot_pair(ce[(x + 1) % 5], co[(x + 1) % 5], 1)
            for y in range(5):
                even[x + 5 * y] = even[x + 5 * y] ^ ce[(x + 4) % 5] ^ de
                odd[x + 5 * y] = odd[x + 5 * y] ^ co[(x + 4) % 5] ^ do
        be, bo = [None] * 25, [None] * 25
        for x in range(5):
            for y in range(5):
                j = y + 5 * ((2 * x + 3 * y) % 5)
                be[j], bo[j] = _rot_pair(even[x + 5 * y], odd[x + 5 * y], rho[x + 5 * y])
        for y in range(5):
            for x in range(5):
                i1, i2 = (x + 1) % 5 + 5 * y, (x + 2) % 5 + 5 * y
                even[x + 5 * y] = be[x + 5 * y] ^ (~be[i1] & be[i2] & M32)
                odd[x + 5 * y] = bo[x + 5 * y] ^ (~bo[i1] & bo[i2] & M32)
        even[0] = even[0] ^ rc_even[r]
        odd[0] = odd[0] ^ rc_odd[r]
    return even, odd


def _pair_permute(words: np.ndarray) -> np.ndarray:
    """(B, 25, 2) u32 lo/hi words through the pair model -> the same layout."""
    u = torch.as_tensor(words.astype(np.int64))
    pairs = [_interleave(u[:, q, 0], u[:, q, 1]) for q in range(25)]
    even, odd = _keccak_pair_model([p[0] for p in pairs], [p[1] for p in pairs])
    out = [_deinterleave(e, o) for e, o in zip(even, odd)]
    return torch.stack([torch.stack(p, dim=1) for p in out], dim=1).numpy().astype(np.uint32)


def test_keccak_pair_model_matches_plain_and_jax():
    state = np.random.default_rng(12).integers(0, 1 << 32, (8, 25, 2), dtype=np.uint32)
    state[0] = 0
    state[1] = M32
    got = _pair_permute(state)
    np.testing.assert_array_equal(got, _u32(keccak.keccak_f1600_plain(convert.words_from_numpy(state, "cpu"))))
    np.testing.assert_array_equal(got, np.asarray(jax.jit(jkeccak.keccak_f1600_batch)(jnp.asarray(state))))


def test_keccak_pair_model_absorbs_like_the_host():
    """The pair layout's absorb: each rate block interleaved and XORed into
    the state, then the permutation; the digest de-interleaved."""
    words, counts = keccak.pack_ragged(KECCAK_MSGS)
    w = torch.as_tensor(words.astype(np.int64)).reshape(len(KECCAK_MSGS), -1, 17, 2)
    zero = torch.zeros(len(KECCAK_MSGS), dtype=torch.int64)
    even, odd = [zero] * 25, [zero] * 25
    for t in range(words.shape[1]):
        ne, no = list(even), list(odd)
        for q in range(17):
            be, bo = _interleave(w[:, t, q, 0], w[:, t, q, 1])
            ne[q], no[q] = ne[q] ^ be, no[q] ^ bo
        ne, no = _keccak_pair_model(ne, no)
        live = torch.as_tensor(counts) > t
        even = [torch.where(live, n, c) for n, c in zip(ne, even)]
        odd = [torch.where(live, n, c) for n, c in zip(no, odd)]
    lanes = [torch.stack(_deinterleave(even[q], odd[q]), dim=1) for q in range(4)]
    raw = torch.cat(lanes, dim=1).numpy().astype("<u4").tobytes()
    assert [raw[32 * i : 32 * i + 32] for i in range(len(KECCAK_MSGS))] == [keccak_host(m) for m in KECCAK_MSGS]


def test_keccak_pair_round_constants_are_the_models():
    even, odd = _pair_rc()
    table = keccak_cuda._round_constants(torch.device("cpu"), 2)
    np.testing.assert_array_equal(_u32(table), np.array([even, odd], dtype=np.uint32).T)
    np.testing.assert_array_equal(_u32(keccak_cuda._round_constants(torch.device("cpu"), 1)),
                                  keccak._RC_ARR.astype(np.uint32))


@pytest.mark.parametrize("kind", ["random", "single_bit"])
def test_keccak_interleave_round_trip(kind):
    if kind == "random":
        v = np.random.default_rng(13).integers(0, 1 << 64, 4096, dtype=np.uint64)
    else:
        v = np.uint64(1) << np.arange(64, dtype=np.uint64)
    lo = torch.as_tensor((v & np.uint64(M32)).astype(np.int64))
    hi = torch.as_tensor((v >> np.uint64(32)).astype(np.int64))
    even, odd = _interleave(lo, hi)
    bits = (v[:, None] >> np.arange(64, dtype=np.uint64)) & np.uint64(1)
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)
    np.testing.assert_array_equal(even.numpy(), (bits[:, 0::2] * weights).sum(axis=1).astype(np.int64))
    np.testing.assert_array_equal(odd.numpy(), (bits[:, 1::2] * weights).sum(axis=1).astype(np.int64))
    back_lo, back_hi = _deinterleave(even, odd)
    assert torch.equal(back_lo, lo) and torch.equal(back_hi, hi)
    assert torch.equal(_zip(_unzip(lo)), lo)


SHA_EDGE_LENGTHS = [0, 1, 55, 56, 63, 64, 119, 120, 183, 184, 247, 248, 299]


def _sha_schedule_first_model(blocks: np.ndarray, counts: np.ndarray) -> torch.Tensor:
    """SHA-256 as the split layout runs it: every block's K + W computed
    first (the schedule warp), then the rounds on K + W alone (the round
    warp), each message over its own count of blocks -> (B, 8) int32."""
    rotr = lambda x, n: (x >> n) | ((x << (32 - n)) & M32)
    w = [torch.as_tensor(blocks[:, :, q].astype(np.int64)) for q in range(16)]  # (B, T) each
    for r in range(16, 64):
        s0 = rotr(w[r - 15], 7) ^ rotr(w[r - 15], 18) ^ (w[r - 15] >> 3)
        s1 = rotr(w[r - 2], 17) ^ rotr(w[r - 2], 19) ^ (w[r - 2] >> 10)
        w.append((w[r - 16] + s0 + w[r - 7] + s1) & M32)
    kw = [(int(k) + wr) & M32 for k, wr in zip(sha256.K, w)]
    state = [torch.full((blocks.shape[0],), int(h), dtype=torch.int64) for h in sha256.H0]
    for t in range(blocks.shape[1]):
        a, b, c, d, e, f, g, h = state
        for r in range(64):
            t1 = h + (rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)) + ((e & f) ^ (~e & g & M32)) + kw[r][:, t]
            t2 = (rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)) + ((a & b) ^ (a & c) ^ (b & c))
            a, b, c, d, e, f, g, h = (t1 + t2) & M32, a, b, c, (d + t1) & M32, e, f, g
        live = torch.as_tensor(counts) > t
        state = [torch.where(live, (s + v) & M32, s) for s, v in zip(state, (a, b, c, d, e, f, g, h))]
    return convert.int32_bits(torch.stack(state, dim=1))


def test_sha256_schedule_first_model_matches_plain_and_hashlib():
    rng = np.random.default_rng(14)
    msgs = [rng.bytes(n) for n in SHA_EDGE_LENGTHS]
    words, counts = sha256.pack_ragged(msgs)
    assert sorted(set(counts.tolist())) == [1, 2, 3, 4, 5]
    got = _sha_schedule_first_model(words, counts)
    w, c = convert.words_from_numpy(words, "cpu"), torch.as_tensor(counts)
    assert torch.equal(got, sha256.sha256_blocks_plain(None, w, c))
    raw = got.numpy().view(np.uint32).astype(">u4").tobytes()
    assert [raw[32 * i : 32 * i + 32] for i in range(len(msgs))] == [hashlib.sha256(m).digest() for m in msgs]


# ---------------------------------------------------------------------------
# wrappers: bad input, and the kernels on a card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b", [1, 1024, 8192, 8193, 131072])
def test_hash_layout_choice(b):
    """The wrappers' choices by width (and block count) are layouts the
    kernels take: a pair for every permutation, the pair absorbing up to
    PAIR_MAX_MESSAGES; split SHA-256 only for narrow multi-block batches."""
    assert keccak_cuda.absorb_lanes(b) == (2 if b <= keccak_cuda.PAIR_MAX_MESSAGES else 1)
    assert keccak_cuda.absorb_lanes(b) in keccak_cuda.LANE_CHOICES
    for t in (1, 2, 5):
        layout = sha256_cuda.compress_layout(b, t)
        assert layout in sha256_cuda.LAYOUTS
        assert (layout == "split") == (b <= sha256_cuda.SPLIT_MAX_B and t > 1)


@pytest.mark.parametrize("call", [
    lambda: ec_cuda.ec_double(torch.zeros((4, 3, 24), dtype=torch.int32)),
    lambda: ec_cuda.ec_double(torch.zeros((4, 3, 12), dtype=torch.int64)),
    lambda: ntt_mxu.ntt_mxu(torch.zeros((2, 48), dtype=torch.int32)),
    lambda: ntt_mxu.ntt_mxu(torch.zeros((2, 1 << 15), dtype=torch.int32)),
    lambda: ntt_mxu.ntt_mxu(torch.zeros((2, 64), dtype=torch.int64)),
    lambda: keccak.keccak_f1600_batch(torch.zeros((2, 25), dtype=torch.int32)),
    lambda: keccak.keccak_f1600_batch(torch.zeros((2, 25, 2), dtype=torch.int64)),
    lambda: keccak.keccak256_fixed(torch.zeros((2, 136), dtype=torch.uint8)),
    lambda: keccak_cuda.keccak256_blocks(torch.zeros((2, 1, 34), dtype=torch.int32),
                                         torch.ones(3, dtype=torch.int32)),
    lambda: sha256.sha256_compress_batch(torch.zeros((2, 8), dtype=torch.int32),
                                         torch.zeros((2, 15), dtype=torch.int32)),
    lambda: sha256_cuda.sha256_compress(torch.zeros((2, 7), dtype=torch.int32),
                                        torch.zeros((2, 1, 16), dtype=torch.int32),
                                        torch.ones(2, dtype=torch.int32)),
    lambda: sha256_cuda.sha256_compress(None, torch.zeros((2, 1, 16), dtype=torch.int32),
                                        torch.ones(2, dtype=torch.int64)),
], ids=["ec_double-shape", "ec_double-dtype", "ntt_mxu-size", "ntt_mxu-2^15", "ntt_mxu-dtype",
        "keccak-shape", "keccak-dtype", "keccak_fixed-length", "keccak-counts", "sha256-block",
        "sha256-state", "sha256-counts"])
def test_kernel_wrappers_refuse_bad_input(call):
    with pytest.raises(ValueError):
        call()


@pytest.mark.cuda
def test_ec_double_kernel_matches_plain_on_card(cuda_device):
    pts = convert.pack32(torch.as_tensor(np.concatenate([_g1_points(32)[0]] * 5)))
    got = ec_cuda.ec_double(pts.to(cuda_device))
    assert torch.equal(got.cpu(), ec_cuda.ec_double_plain(pts))
    with pytest.raises(ValueError):
        ec_cuda.ec_double(pts.to(cuda_device).transpose(0, 1).contiguous().transpose(0, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 5, 33, 4099, 8192, 8193, 16389])
def test_ec_double_widths_match_plain_on_card(cuda_device, m):
    """Widths that are no multiple of a warp's 8 points or a block's 32, and
    8,192 and one past it: Z = 1, Z != 1 and identities (_g1_points' rows
    repeated)."""
    base = convert.pack32(torch.as_tensor(_g1_points(33)[0]))
    pts = base[torch.as_tensor(np.random.default_rng(m).integers(0, base.shape[0], m))].contiguous()
    assert torch.equal(ec_cuda.ec_double(pts.to(cuda_device)).cpu(), ec_cuda.ec_double_plain(pts))


@pytest.mark.cuda
@pytest.mark.parametrize("log_n", range(15))
def test_ntt_mxu_kernel_matches_plain_on_card(cuda_device, log_n):
    """Every size, against the plain version and (from 2^1) B5's ntt."""
    from raiko_tpu_torch.ops import ntt_cuda

    x = convert.words_from_numpy(_mont(log_n, (5, 1 << log_n)), "cpu")
    got = ntt_mxu.ntt_mxu(x.to(cuda_device))
    assert torch.equal(got.cpu(), ntt_mxu.ntt_mxu_plain(x))
    if log_n:
        assert torch.equal(got, ntt_cuda.ntt(x.to(cuda_device)))
        with pytest.raises(ValueError):
            ntt_mxu.ntt_mxu(x.to(cuda_device).T.contiguous().T)


@pytest.mark.cuda
def test_keccak_kernel_matches_plain_on_card(cuda_device):
    state = convert.words_from_numpy(np.random.default_rng(10).integers(0, 1 << 32, (300, 25, 2), np.uint32),
                                     "cpu")
    assert torch.equal(keccak.keccak_f1600_batch(state.to(cuda_device)).cpu(), keccak.keccak_f1600_plain(state))
    assert keccak.keccak256_batch(KECCAK_MSGS, cuda_device) == [keccak_host(m) for m in KECCAK_MSGS]
    with pytest.raises(ValueError):
        odd = torch.zeros(101, dtype=torch.int32, device=cuda_device)[1:].reshape(2, 25, 2)
        keccak.keccak_f1600_batch(odd)  # 4-byte aligned only
    with pytest.raises(ValueError):
        keccak.keccak_f1600_batch(state.to(cuda_device).transpose(1, 2).contiguous().transpose(1, 2))


@pytest.mark.cuda
def test_sha256_kernel_matches_plain_on_card(cuda_device):
    assert sha256.sha256_batch(SHA_MSGS, cuda_device) == [hashlib.sha256(m).digest() for m in SHA_MSGS]
    rng = np.random.default_rng(11)
    state = convert.words_from_numpy(rng.integers(0, 1 << 32, (300, 8), np.uint32), "cpu")
    block = convert.words_from_numpy(rng.integers(0, 1 << 32, (300, 16), np.uint32), "cpu")
    got = sha256.sha256_compress_batch(state.to(cuda_device), block.to(cuda_device))
    assert torch.equal(got.cpu(), sha256.sha256_compress_batch(state, block))
    with pytest.raises(ValueError):
        sha256.sha256_compress_batch(state.to(cuda_device).T.contiguous().T, block.to(cuda_device))


# widths that are no multiple of a warp or a pair, a batch of one, and the
# widths chip_smoke.py records
CARD_WIDTHS = [1, 2, 31, 33, 4099, 8192, 16385, 131072]


def _ragged_counts(rng, b: int, most: int, t: int) -> np.ndarray:
    """Counts 1 to `most`, with 0, T and more than T (the kernel clamps to T)
    among them."""
    counts = rng.integers(1, most + 1, b).astype(np.int32)
    counts[::7] = 0
    counts[3::11] = t
    counts[5::13] = t + 3
    return counts


@pytest.mark.cuda
@pytest.mark.parametrize("b", CARD_WIDTHS)
def test_keccak_layouts_match_plain_on_card(cuda_device, b):
    """One permutation (a pair of lanes a state), and absorbing in every
    layout (ragged counts, equal counts), against the plain version on the
    card."""
    rng = np.random.default_rng(b)
    state = convert.words_from_numpy(rng.integers(0, 1 << 32, (b, 25, 2), np.uint32), cuda_device)
    want = keccak.keccak_f1600_plain(state)
    assert torch.equal(keccak.keccak_f1600_batch(state), want)
    assert torch.equal(keccak_cuda.keccak_f1600(state), want)
    blocks = convert.words_from_numpy(rng.integers(0, 1 << 32, (b, 5, 34), np.uint32), cuda_device)
    ragged = torch.as_tensor(_ragged_counts(rng, b, 4, 5), device=cuda_device)
    equal = torch.full((b,), 3, dtype=torch.int32, device=cuda_device)
    want_ragged = keccak.keccak256_blocks_plain(blocks, ragged)
    want_equal = keccak.keccak256_blocks_plain(blocks, equal)
    assert torch.equal(keccak_cuda.keccak256_blocks(blocks, ragged), want_ragged)
    for lanes in keccak_cuda.LANE_CHOICES:
        assert torch.equal(keccak_cuda.keccak256_blocks_lanes(blocks, ragged, lanes), want_ragged)
        assert torch.equal(keccak_cuda.keccak256_blocks_lanes(blocks, equal, lanes), want_equal)


@pytest.mark.cuda
@pytest.mark.parametrize("b", CARD_WIDTHS)
def test_sha256_layouts_match_plain_on_card(cuda_device, b):
    """Every layout, from H0 and from a given state, ragged and equal
    counts, against the plain version on the card."""
    rng = np.random.default_rng(b + 1)
    blocks = convert.words_from_numpy(rng.integers(0, 1 << 32, (b, 6, 16), np.uint32), cuda_device)
    state = convert.words_from_numpy(rng.integers(0, 1 << 32, (b, 8), np.uint32), cuda_device)
    ragged = torch.as_tensor(_ragged_counts(rng, b, 5, 6), device=cuda_device)
    one = torch.ones((b,), dtype=torch.int32, device=cuda_device)
    cases = [(None, blocks, ragged), (state, blocks, ragged), (None, blocks[:, :1].contiguous(), one),
             (state, blocks, torch.full_like(one, 6))]
    for st, blk, cnt in cases:
        want = sha256.sha256_blocks_plain(st, blk, cnt)
        assert torch.equal(sha256_cuda.sha256_compress(st, blk, cnt), want)
        for layout in sha256_cuda.LAYOUTS:
            assert torch.equal(sha256_cuda.sha256_compress_layout(st, blk, cnt, layout), want)


@pytest.mark.cuda
def test_hash_padding_edges_on_card(cuda_device):
    """Messages at the padding edges in every layout against the host's
    hashes; a Keccak tensor only 4-byte aligned is refused, a SHA-256 one
    is not."""
    rng = np.random.default_rng(16)
    msgs = [rng.bytes(n) for n in SHA_EDGE_LENGTHS]
    words, counts = sha256.pack_ragged(msgs)
    w, c = convert.words_from_numpy(words, cuda_device), torch.as_tensor(counts, device=cuda_device)
    for layout in sha256_cuda.LAYOUTS:
        raw = sha256_cuda.sha256_compress_layout(None, w, c, layout).cpu().numpy().view(np.uint32)
        assert [raw[i].astype(">u4").tobytes() for i in range(len(msgs))] == [hashlib.sha256(m).digest() for m in msgs]
    msgs = [rng.bytes(n) for n in (0, 1, 135, 136, 137, 271, 272, 407, 408, 543)]
    words, counts = keccak.pack_ragged(msgs)
    w, c = convert.words_from_numpy(words, cuda_device), torch.as_tensor(counts, device=cuda_device)
    for lanes in keccak_cuda.LANE_CHOICES:
        raw = keccak_cuda.keccak256_blocks_lanes(w, c, lanes).cpu().numpy().astype("<i4").tobytes()
        assert [raw[32 * i : 32 * i + 32] for i in range(len(msgs))] == [keccak_host(m) for m in msgs]
    data = np.random.default_rng(17).integers(0, 256, (3, 135), dtype=np.uint8)
    raw = keccak.keccak256_fixed(torch.as_tensor(data, device=cuda_device)).cpu().numpy().astype("<i4").tobytes()
    assert [raw[32 * i : 32 * i + 32] for i in range(3)] == [keccak_host(r.tobytes()) for r in data]
    with pytest.raises(ValueError):
        odd = torch.zeros(2 * 34 + 1, dtype=torch.int32, device=cuda_device)[1:].reshape(2, 1, 34)
        keccak_cuda.keccak256_blocks(odd, torch.ones(2, dtype=torch.int32, device=cuda_device))
    odd = torch.zeros(3 * 16 + 1, dtype=torch.int32, device=cuda_device)[1:].reshape(3, 1, 16)
    odd.copy_(w.new_tensor(rng.integers(-(1 << 31), 1 << 31, (3, 1, 16))))
    one = torch.ones(3, dtype=torch.int32, device=cuda_device)
    for layout in sha256_cuda.LAYOUTS:
        assert torch.equal(sha256_cuda.sha256_compress_layout(None, odd, one, layout),
                           sha256.sha256_blocks_plain(None, odd, one))
