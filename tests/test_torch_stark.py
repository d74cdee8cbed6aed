"""The port's STARK column commitment on the CPU, against the JAX package.

The same numpy-seeded inputs go through raiko_tpu (JAX on the CPU; its
Pallas NTT in interpret mode, as tests/test_babybear.py runs it) and
through raiko_tpu_torch, whose wrappers run their kernels' plain versions
on CPU tensors.  Field arithmetic is exact, so every comparison is bit for
bit.  The tests marked ``cuda`` hold the kernels against their plain
versions on a card.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raiko_tpu.fields import babybear as jbb
from raiko_tpu.fields import babybear_ext as jef
from raiko_tpu.ops import merkle as jmerkle
from raiko_tpu.ops import ntt as jntt
from raiko_tpu.ops import ntt_pallas as jntp
from raiko_tpu.ops import poseidon2 as jp2
from raiko_tpu.stark import prover as jprover
from raiko_tpu_torch import convert
from raiko_tpu_torch.fields import babybear as bb
from raiko_tpu_torch.fields import babybear_ext as ef
from raiko_tpu_torch.ops import merkle, ntt, ntt_cuda, poseidon2 as p2, poseidon2_cuda
from raiko_tpu_torch.stark import prover
from raiko_tpu_torch.stark.commit_step import commit_step

# the JAX flagship step's root on the (256, 48) default_rng(0) trace,
# Montgomery form (__graft_entry__.entry())
FLAGSHIP_ROOT = [1103079180, 844803899, 311541641, 1509639592,
                 1993886486, 1956685620, 1597694602, 1842386190]


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


# the JAX functions jitted: op-by-op dispatch compiles every stage's shapes
_jntt = jax.jit(jntt.ntt)
_jintt = jax.jit(jntt.intt)


def _elems(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, jbb.P, shape, dtype=np.uint32)


def _mont(seed: int, shape) -> np.ndarray:
    return jbb.np_to_mont(_elems(seed, shape))


def _t(arr: np.ndarray) -> torch.Tensor:
    return convert.words_from_numpy(arr, "cpu")


def _np(t: torch.Tensor) -> np.ndarray:
    return convert.bb_to_numpy(t)


@pytest.mark.parametrize("op", ["add", "sub", "mont_mul", "neg", "to_mont", "from_mont", "pow", "inv"])
def test_babybear_ops_match_jax(op):
    a, b = _elems(1, 4096), _elems(2, 4096)
    a[:3] = [0, 1, jbb.P - 1]
    b[:3] = [jbb.P - 1, 0, jbb.P - 1]
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    cases = {
        "add": (jbb.add(ja, jb), bb.add(_t(a), _t(b))),
        "sub": (jbb.sub(ja, jb), bb.sub(_t(a), _t(b))),
        "mont_mul": (jbb.mont_mul(ja, jb), bb.mont_mul(_t(a), _t(b))),
        "neg": (jbb.neg(ja), bb.neg(_t(a))),
        "to_mont": (jbb.to_mont(ja), bb.to_mont(_t(a))),
        "from_mont": (jbb.from_mont(ja), bb.from_mont(_t(a))),
        "pow": (jbb.mont_pow(ja, 1_000_003), bb.mont_pow(_t(a), 1_000_003)),
        "inv": (jbb.mont_inv(ja[3:67]), bb.mont_inv(_t(a[3:67]))),
    }
    want, got = cases[op]
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_babybear_host_helpers_match_jax():
    x = _elems(3, 1000)
    np.testing.assert_array_equal(bb.np_to_mont(x), jbb.np_to_mont(x))
    np.testing.assert_array_equal(bb.np_from_mont(x), jbb.np_from_mont(x))
    assert [bb.two_adic_generator(k) for k in range(28)] == [jbb.two_adic_generator(k) for k in range(28)]
    assert bb.h_inv(12345) == jbb.h_inv(12345) and bb.NPRIME == jbb.NPRIME
    w = bb.two_adic_generator(10)
    np.testing.assert_array_equal(bb.np_powers(w, 777), [pow(w, j, bb.P) for j in range(777)])


def _ef_elems(seed: int, shape, kind: str) -> np.ndarray:
    """(..., 4) standard-form EF elements, none zero: random, base-field
    (a_1 = a_2 = a_3 = 0), or one non-zero coefficient at a random place."""
    rng = np.random.default_rng(seed)
    a = rng.integers(1, jbb.P, tuple(shape) + (4,), dtype=np.uint64)
    if kind == "base":
        a[..., 1:] = 0
    elif kind == "one_coeff":
        keep = rng.integers(0, 4, shape)
        a[np.arange(4) != keep[..., None]] = 0
    return a


@pytest.mark.parametrize("kind", ["random", "base", "one_coeff"])
@pytest.mark.parametrize("shape", [(1,), (32,), (2048,), (3, 32)], ids=["1", "32", "2048", "3x32"])
def test_ef_inverse_matches_jax(shape, kind):
    """The extension inverse by the Frobenius constants (npef_inv, h_inv,
    h_batch_inv) against the JAX package's by exponentiations to p."""
    a = _ef_elems(sum(shape) * 7 + len(kind), shape, kind)
    got = ef.npef_inv(a)
    np.testing.assert_array_equal(got, jef.npef_inv(a))
    one = np.zeros_like(a)
    one[..., 0] = 1
    np.testing.assert_array_equal(ef.npef_mul(a, got), one)
    rows = [tuple(int(v) for v in r) for r in a.reshape(-1, 4)]
    assert [ef.h_inv(r) for r in rows] == [tuple(int(v) for v in r) for r in got.reshape(-1, 4)]
    assert [ef.h_inv(r) for r in rows[:48]] == [jef.h_inv(r) for r in rows[:48]]
    assert ef.h_batch_inv(rows[:48]) == jef.h_batch_inv(rows[:48])


@pytest.mark.parametrize("k", [1, 2, 3])
def test_ef_frobenius_constants(k):
    """npef_frobenius / h_frobenius are a -> a^(p^k), and k applications of
    the map composed with 4 - k give a^(p^4) = a."""
    a = _ef_elems(k, (24,), "random")
    a[0] = [1, 0, 0, 0]
    a[1] = [0, 1, 0, 0]
    rows = [tuple(int(v) for v in r) for r in a]
    want = [ef.h_pow(r, bb.P**k) for r in rows]
    assert [ef.h_frobenius(r, k) for r in rows] == want
    assert [tuple(int(v) for v in r) for r in ef.npef_frobenius(a, k)] == want
    np.testing.assert_array_equal(ef.npef_frobenius(ef.npef_frobenius(a, k), 4 - k), a)
    assert [ef.h_frobenius(ef.h_frobenius(r, k), 4 - k) for r in rows] == rows
    b = a
    for _ in range(4):
        b = ef.npef_frobenius(b, 1)
    np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("log_n", [4, 7, 10, 12])
def test_ntt_intt_match_jax(log_n):
    x = _mont(log_n, (3, 1 << log_n))
    got = ntt.ntt(_t(x))
    np.testing.assert_array_equal(_np(got), np.asarray(_jntt(jnp.asarray(x))))
    back = ntt.intt(got)
    np.testing.assert_array_equal(_np(back), np.asarray(_jintt(jnp.asarray(_np(got)))))
    np.testing.assert_array_equal(_np(back), x)
    # the reference's per-stage tables, rebuilt by the port
    for mine, ref in zip(ntt._twiddles(log_n, True), jntt._twiddles(log_n, True)):
        np.testing.assert_array_equal(mine, ref)


def test_ntt_matches_pallas_fused_at_2_14():
    """Kernel B5's plain version against the Pallas kernel it replaces
    (interpret mode on the CPU), forward and inverse, at 2 x 2^14."""
    x = _mont(14, (2, 1 << 14))
    fwd = np.asarray(jntp.ntt_fused(jnp.asarray(x)))
    got = ntt_cuda.ntt(_t(x))
    np.testing.assert_array_equal(_np(got), fwd)
    np.testing.assert_array_equal(_np(ntt.ntt_fourstep(_t(x))), fwd)
    back = ntt_cuda.intt(got)
    np.testing.assert_array_equal(_np(back), np.asarray(jntp.intt_fused(jnp.asarray(fwd))))
    np.testing.assert_array_equal(_np(back), x)


def test_fourstep_tables_match_jax():
    np.testing.assert_array_equal(ntt._fourstep_twiddles(3, 4), jntt._fourstep_twiddles(3, 4))
    np.testing.assert_array_equal(ntt._fourstep_twiddles(7, 7, True), jntp._fourstep_itwiddles(7, 7))
    np.testing.assert_array_equal(ntt.bit_reverse_indices(64), jntt.bit_reverse_indices(64))


def test_lde_and_interpolate_match_jax():
    x = _mont(5, (4, 64))
    jx = jnp.asarray(x)
    np.testing.assert_array_equal(_np(ntt.interpolate(_t(x))), np.asarray(jax.jit(jntt.interpolate)(jx)))
    np.testing.assert_array_equal(_np(ntt.lde(_t(x), 2)), np.asarray(jax.jit(lambda v: jntt.lde(v, 2))(jx)))
    np.testing.assert_array_equal(_np(ntt.lde_from_coeffs(_t(x), 1, 7)),
                                  np.asarray(jax.jit(lambda v: jntt.lde_from_coeffs(v, 1, 7))(jx)))


def test_permute_matches_jax_and_golden():
    states = _mont(6, (16, 16))
    states[0] = 0
    got = p2.permute(_t(states))
    np.testing.assert_array_equal(_np(got), np.asarray(jp2.permute(jnp.asarray(states))))
    with open(os.path.join(os.path.dirname(__file__), "golden", "poseidon2_zero.json")) as f:
        assert _np(bb.from_mont(got[0])).tolist() == json.load(f)
    std = bb.np_from_mont(states).astype(np.uint64)
    np.testing.assert_array_equal(p2.host_permute_batch(std), jp2.host_permute_batch(std))
    assert p2.host_permute(std[1].tolist()) == jp2.host_permute(std[1].tolist())


@pytest.mark.parametrize("width", [1, 7, 8, 9, 48, 200])
def test_hash_rows_matches_jax(width):
    # 1-9 columns: a part-filled chunk, exactly one, one and one element;
    # 200 columns is 25 chunks: the reference's scan branch (nchunks > 8)
    rows = _mont(width, (16, width))
    want = np.asarray(jp2.hash_rows(jnp.asarray(rows)))
    got = p2.hash_rows(_t(rows))
    assert got.shape == (16, 8) and got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), want)
    # a transposed view hashes as its contiguous copy
    np.testing.assert_array_equal(_np(p2.hash_rows(_t(rows.T.copy()).T)), want)
    assert jp2.host_hash_row(bb.np_from_mont(rows[0]).tolist()) == _np(bb.from_mont(got[0])).tolist()


def test_compress_matches_jax():
    a, b = _mont(7, (9, 8)), _mont(8, (9, 8))
    want = np.asarray(jp2.compress(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(_np(p2.compress(_t(a), _t(b))), want)
    np.testing.assert_array_equal(_np(poseidon2_cuda.poseidon2_compress(_t(np.concatenate([a, b], 1)))), want)


def test_merkle_commit_and_open_paths_match_jax():
    leaves = _mont(9, (32, 8))
    jlevels = jmerkle.commit(jnp.asarray(leaves))
    levels = merkle.commit(_t(leaves))
    assert len(levels) == len(jlevels) == 6
    for mine, ref in zip(levels, jlevels):
        np.testing.assert_array_equal(_np(mine), np.asarray(ref))
    idx = [0, 5, 31, 17]
    want = jmerkle.open_paths(jlevels, idx)
    got = merkle.open_paths(levels, idx)
    for gp, wp in zip(got, want):
        for g, w in zip(gp, wp):
            np.testing.assert_array_equal(g, w)
    root = _np(merkle.root(levels))
    path = merkle.open_path(levels, 5)
    assert merkle.verify_path(leaves[5], 5, path, root)
    assert not merkle.verify_path(leaves[4], 5, path, root)


def test_commit_cols_matches_jax_at_keccak_width():
    """The keccak chunk's 4,160 columns at 32 rows (128 LDE rows)."""
    cols = _mont(10, (4160, 32))
    jc, jl, jlev = jprover._commit_cols_local(jnp.asarray(cols), jbb.GENERATOR)
    c, lde, levels = prover.commit_cols(_t(cols), bb.GENERATOR)
    np.testing.assert_array_equal(_np(c), np.asarray(jc))
    np.testing.assert_array_equal(_np(lde), np.asarray(jl))
    assert len(levels) == len(jlev) == 8
    for mine, ref in zip(levels, jlev):
        np.testing.assert_array_equal(_np(mine), np.asarray(ref))


def test_fixed_commit_root_matches_jax():
    fixed = _elems(11, (3, 16))
    assert prover.fixed_commit_root(fixed, 7, "cpu") == jprover.fixed_commit_root(fixed, 7)


def test_commit_step_matches_flagship_root():
    from __graft_entry__ import entry

    step, (trace,) = entry()
    want = np.asarray(step(trace)).tolist()
    assert want == FLAGSHIP_ROOT
    got = commit_step(np.asarray(trace), "cpu")
    assert _np(got).tolist() == FLAGSHIP_ROOT
    rng = np.random.default_rng(0)
    assert _np(commit_step(rng.integers(0, jbb.P, (256, 48), np.uint32), "cpu")).tolist() == FLAGSHIP_ROOT


def test_kernel_wrappers_refuse_bad_input():
    with pytest.raises(ValueError):
        ntt.ntt(_t(_mont(1, (2, 48))))
    with pytest.raises(ValueError):
        poseidon2_cuda.poseidon2_compress(_t(_mont(1, (2, 8))))
    with pytest.raises(ValueError):
        merkle.commit(_t(_mont(1, (6, 8))))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5, 1 << 10), (3, 1 << 12), (2, 1 << 14), (1, 1 << 17)])
def test_ntt_kernel_matches_plain_on_card(cuda_device, shape):
    x = _t(_mont(shape[1], shape))
    got = ntt_cuda.ntt(x.to(cuda_device))
    assert torch.equal(got.cpu(), ntt_cuda.ntt_plain(x))
    assert torch.equal(ntt_cuda.intt(got).cpu(), x)


@pytest.mark.cuda
def test_poseidon2_kernels_match_plain_on_card(cuda_device):
    rows = _t(_mont(12, (64, 200)))
    got = poseidon2_cuda.poseidon2_hash_rows(rows.to(cuda_device).T.contiguous().T)
    assert torch.equal(got.cpu(), p2.hash_rows_plain(rows))
    pairs = _t(_mont(13, (100, 16)))
    assert torch.equal(poseidon2_cuda.poseidon2_compress(pairs.to(cuda_device)).cpu(), p2.compress_plain(pairs))


@pytest.mark.cuda
@pytest.mark.parametrize("nrows", [1, 3, 33, 4101])
@pytest.mark.parametrize("width", [1, 7, 8, 9, 48, 200])
def test_hash_rows_kernel_edges_match_plain_on_card(cuda_device, nrows, width):
    # the kernel runs each row's sponge on a group of lanes: row counts that
    # fill no whole warp or block, widths around one rate chunk, and both
    # the contiguous layout and a transposed view
    rows = _t(_mont(nrows * 1000 + width, (nrows, width)))
    want = p2.hash_rows_plain(rows)
    on_card = rows.to(cuda_device)
    assert torch.equal(poseidon2_cuda.poseidon2_hash_rows(on_card).cpu(), want)
    assert torch.equal(poseidon2_cuda.poseidon2_hash_rows(on_card.T.contiguous().T).cpu(), want)


@pytest.mark.cuda
def test_commit_step_on_card(cuda_device):
    trace = np.random.default_rng(0).integers(0, jbb.P, (256, 48), np.uint32)
    assert _np(commit_step(trace, cuda_device)).tolist() == FLAGSHIP_ROOT
