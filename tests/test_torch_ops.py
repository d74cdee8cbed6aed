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
# wrappers: bad input, and the kernels on a card
# ---------------------------------------------------------------------------


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
