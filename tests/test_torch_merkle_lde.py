"""The port's coset LDE and Merkle tree, against the JAX package and on a card.

On the CPU the same numpy-seeded inputs go through raiko_tpu (JAX on the
CPU) and raiko_tpu_torch, whose wrappers run their kernels' plain versions
on CPU tensors: ``lde_from_coeffs`` (kernel B5 with its coset prologue on
the card) and ``merkle.commit`` with ``open_paths`` (the one-launch tree on
the card).  Field arithmetic is exact, so every comparison is bit for bit.
The tests marked ``cuda`` hold the kernels against their plain versions on
a card, at the sizes where their layouts change.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raiko_tpu.fields import babybear as jbb
from raiko_tpu.ops import merkle as jmerkle
from raiko_tpu.ops import ntt as jntt
from raiko_tpu_torch import convert
from raiko_tpu_torch.fields import babybear as bb
from raiko_tpu_torch.ops import merkle, ntt, ntt_cuda, poseidon2_cuda


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


def _t(arr: np.ndarray) -> torch.Tensor:
    return convert.words_from_numpy(arr, "cpu")


def _np(t: torch.Tensor) -> np.ndarray:
    return convert.bb_to_numpy(t)


@pytest.mark.parametrize("log_n", [4, 10])
@pytest.mark.parametrize("shift", [jbb.GENERATOR, 1_000_003])
@pytest.mark.parametrize("blowup_log", [1, 2, 3])
def test_lde_from_coeffs_matches_jax(log_n, shift, blowup_log):
    coeffs = _mont(100 * log_n + blowup_log, (2, 1 << log_n))
    want = jax.jit(lambda c: jntt.lde_from_coeffs(c, blowup_log, shift))(jnp.asarray(coeffs))
    got = ntt.lde_from_coeffs(_t(coeffs), blowup_log, shift)
    assert got.shape == (2, 1 << (log_n + blowup_log)) and got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    # the prologue's plain version is the reference's composition
    assert torch.equal(got, ntt_cuda.ntt(ntt.coset_pad(_t(coeffs), blowup_log, shift)))


@pytest.mark.parametrize("n", [1, 2, 8, 256])
def test_merkle_levels_and_paths_match_jax(n):
    leaves = _mont(n, (n, 8))
    jlevels = jmerkle.commit(jnp.asarray(leaves))
    levels = merkle.commit(_t(leaves))
    assert len(levels) == len(jlevels) == n.bit_length()
    for mine, ref in zip(levels, jlevels):
        np.testing.assert_array_equal(_np(mine), np.asarray(ref))
    idx = sorted({0, n // 3, n - 1})
    for gp, wp in zip(merkle.open_paths(levels, idx), jmerkle.open_paths(jlevels, idx)):
        assert len(gp) == len(wp) == n.bit_length() - 1
        for g, w in zip(gp, wp):
            np.testing.assert_array_equal(g, w)
    # the internal nodes come out as one buffer, the levels as its views
    nodes = poseidon2_cuda.poseidon2_merkle(_t(leaves))
    assert nodes.shape == (n - 1, 8)
    np.testing.assert_array_equal(_np(nodes), np.concatenate([_np(lv) for lv in levels], 0)[n:])


def test_merkle_wrapper_refuses_bad_leaves():
    with pytest.raises(ValueError):
        poseidon2_cuda.poseidon2_merkle(_t(_mont(1, (6, 8))))
    with pytest.raises(ValueError):
        poseidon2_cuda.poseidon2_merkle(_t(_mont(1, (8, 16))))
    with pytest.raises(ValueError):
        ntt_cuda.ntt_coset(_t(_mont(1, (2, 12))), 2, bb.GENERATOR)


# ---- on the card ----------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("log_n", [0, 1, 2, 6, 7, 8, 12, 14, 16, 20])
def test_merkle_kernel_matches_plain_on_card(cuda_device, log_n):
    # one task's 2^7 leaves and one level either side, two and three
    # chunks of tasks (2^14, 2^16, 2^20: tickets at one and two levels)
    leaves = _t(_mont(log_n, (1 << log_n, 8))).to(cuda_device)
    want = poseidon2_cuda.poseidon2_merkle_plain(leaves)
    got = poseidon2_cuda.poseidon2_merkle(leaves)
    assert torch.equal(got, want)
    levels = merkle.commit(leaves)
    assert len(levels) == log_n + 1 and levels[-1].shape == (1, 8)
    # a second launch on the same tickets' sizes gives the same tree
    assert torch.equal(poseidon2_cuda.poseidon2_merkle(leaves), want)


@pytest.mark.cuda
@pytest.mark.parametrize("log_n", range(1, 25))
def test_ntt_kernel_every_size_on_card(cuda_device, log_n):
    x = _t(_mont(log_n, (1, 1 << log_n))).to(cuda_device)
    fwd = ntt_cuda.ntt(x)
    assert torch.equal(fwd, ntt_cuda.ntt_plain(x))
    assert torch.equal(ntt_cuda.intt(fwd), ntt_cuda.intt_plain(fwd))
    assert torch.equal(ntt_cuda.intt(fwd), x)


@pytest.mark.cuda
@pytest.mark.parametrize("log_n", [10, 12])
@pytest.mark.parametrize("batch", [1, 3, 4161])
def test_ntt_kernel_batches_in_place_on_card(cuda_device, log_n, batch):
    x = _t(_mont(batch + log_n, (batch, 1 << log_n))).to(cuda_device)
    for inverse, plain in ((False, ntt_cuda.ntt_plain), (True, ntt_cuda.intt_plain)):
        want = plain(x)
        assert torch.equal(ntt_cuda.intt(x) if inverse else ntt_cuda.ntt(x), want)
        y = x.clone()
        ntt_cuda._launch(y, y, log_n, inverse, "test")  # the C entry with x == out
        assert torch.equal(y, want)
    # a view that does not start on 16 bytes
    flat = _t(_mont(7, (batch * (1 << log_n) + 1,))).to(cuda_device)
    view = flat[1:].view(batch, 1 << log_n)
    assert torch.equal(ntt_cuda.intt(view), ntt_cuda.intt_plain(view))


@pytest.mark.cuda
@pytest.mark.parametrize("log_in", [10, 12, 13])
@pytest.mark.parametrize("blowup_log", [1, 2, 3])
def test_ntt_coset_matches_plain_on_card(cuda_device, log_in, blowup_log):
    coeffs = _t(_mont(log_in + blowup_log, (3, 1 << log_in))).to(cuda_device)
    want = ntt_cuda.ntt_coset_plain(coeffs, blowup_log, bb.GENERATOR)
    assert torch.equal(ntt_cuda.ntt_coset(coeffs, blowup_log, bb.GENERATOR), want)
    assert torch.equal(ntt.lde_from_coeffs(coeffs, blowup_log), want)


@pytest.mark.cuda
def test_wrappers_refuse_bad_input_on_card(cuda_device):
    leaves = _t(_mont(1, (16, 8))).to(cuda_device)
    with pytest.raises(ValueError):
        poseidon2_cuda.poseidon2_merkle(leaves[:6])
    with pytest.raises(ValueError):
        poseidon2_cuda.poseidon2_merkle(leaves.long())
    with pytest.raises(ValueError):
        poseidon2_cuda.poseidon2_merkle(_t(_mont(2, (16, 16))).to(cuda_device)[:, ::2])
    coeffs = _t(_mont(3, (4, 64))).to(cuda_device)
    with pytest.raises(ValueError):
        ntt_cuda.ntt_coset(coeffs.long(), 2, bb.GENERATOR)
    with pytest.raises(ValueError):
        ntt_cuda.ntt_coset(coeffs.T, 2, bb.GENERATOR)
    with pytest.raises(ValueError):
        ntt_cuda.ntt_coset(coeffs[:, :48], 2, bb.GENERATOR)
