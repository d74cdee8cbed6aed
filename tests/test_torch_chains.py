"""What the serial-chain kernels B2 and B4 must equal, pinned on the CPU.

B2 ``ec_weighted_fold`` and B4 ``shamir_ladder`` run one chain of point
operations per batch entry.  Their kernels spread each chain over a warp,
and stay bit-exact only because they run the same sequence of field
operations as the plain versions.  These tests hold those plain versions
against the JAX package bit for bit, on the projective output:

* ``ec_weighted_fold_plain`` against the Pallas ``ec_weighted_fold`` in its
  interpret mode, with an identity and a repeated point among the inputs;
* ``shamir_ladder_plain`` against ``raiko_tpu.ops.secp._shamir`` (XLA) on
  the table the kernel completes, with real signatures and a lane whose
  window indices are all 0.

The same numpy-seeded inputs go to both packages; tolerance 0.  The
``cuda``-marked tests beside the kernels' other checks
(``test_torch_msm_kzg.py``, ``test_torch_secp.py``) hold the kernels against
these plain versions on a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raiko_tpu.kzg import host_curve as hc
from raiko_tpu.ops import ec_pallas as jec
from raiko_tpu.ops import secp as jsecp
from raiko_tpu_torch import convert
from raiko_tpu_torch.fields.limbs import FP
from raiko_tpu_torch.kzg import curve as tcurve
from raiko_tpu_torch.ops import ec_cuda, secp, secp_cuda
from raiko_tpu_torch.utils import secp256k1 as host


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs files in parallel workers: torch's own thread pool per
    # worker would oversubscribe the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fold_inputs() -> tuple[np.ndarray, list]:
    """(2, 4, 3, 24) Montgomery points, 16-bit limbs, and their affine
    values (None for the identity): entry 0 holds an identity, entry 1 a
    point twice; some points have Z != 1."""
    rng = np.random.default_rng(41)
    affine = [hc.g1_mul(hc.G1_GEN, int(rng.integers(1, 1 << 62))) for _ in range(8)]
    affine[2] = None
    affine[6] = affine[4]
    rows = []
    for i, pt in enumerate(affine):
        if pt is None:
            rows.append(np.stack([np.zeros(24), FP.to_mont_int(1), np.zeros(24)]))
            continue
        lam = 1 if i % 2 else int.from_bytes(rng.bytes(48), "big") % (hc.P - 1) + 1
        rows.append(np.stack([FP.to_mont_int(pt[0] * lam % hc.P), FP.to_mont_int(pt[1] * lam % hc.P),
                              FP.to_mont_int(lam)]))
    return np.stack(rows).astype(np.int64).reshape(2, 4, 3, 24), affine


def _host_fold(affine: list) -> tuple[int, int] | None:
    acc = None
    for pt in reversed(affine):
        acc = hc.g1_add(hc.g1_add(acc, acc), pt)
    return acc


@pytest.fixture(scope="module")
def folded():
    """(inputs, affine values, the Pallas fold of the inputs)."""
    v, affine = _fold_inputs()
    want = np.asarray(jec.ec_weighted_fold(jnp.asarray(v.astype(np.uint32))))
    return v, affine, want.astype(np.int64)


def test_weighted_fold_plain_matches_pallas_interpret(folded):
    v, _, want = folded
    got = ec_cuda.ec_weighted_fold(convert.pack32(torch.as_tensor(v)))
    assert got.dtype == torch.int32 and got.shape == (2, 3, 12)
    np.testing.assert_array_equal(convert.unpack32(got).numpy(), want)


@pytest.mark.parametrize("entry", [0, 1])
def test_weighted_fold_pallas_is_the_weighted_sum(folded, entry):
    # Σ_j 2^j v_j on the host curve, the identity and the repeated point included
    _, affine, want = folded
    assert tcurve.to_affine(want[entry]) == _host_fold(affine[4 * entry : 4 * entry + 4])


def test_weighted_fold_plain_of_one_point_is_the_point(folded):
    # J = 1: the fold is its input, unchanged
    v, _, _ = folded
    one = convert.pack32(torch.as_tensor(v[:, :1]))
    assert torch.equal(ec_cuda.ec_weighted_fold(one), one[:, 0])


def _ladder_inputs() -> tuple[np.ndarray, np.ndarray, list]:
    """Four real signatures and a fifth lane (the first's base points) whose
    indices are all 0: (base (5, 2, 3, 16) int64, idx (256, 5) int32, the
    four public keys)."""
    rng = np.random.default_rng(43)
    items = []
    for _ in range(4):
        msg = rng.bytes(32)
        r, s, rec = host.sign(msg, int.from_bytes(rng.bytes(31), "big") + 1)
        items.append((msg, r, s, rec))
    _, base, idx = secp.ladder_inputs(items)
    base = np.concatenate([base, base[:1]])
    idx = np.concatenate([idx, np.zeros((256, 1), np.int32)], axis=1)
    return base, np.ascontiguousarray(idx), [host.recover_pubkey(*it) for it in items]


@pytest.fixture(scope="module")
def laddered():
    """(base, idx, public keys, XLA's _shamir on the completed table)."""
    base, idx, pubs = _ladder_inputs()
    b = jnp.asarray(base.astype(np.uint32))
    table = jnp.stack([jsecp.identity((b.shape[0],)), b[:, 0], b[:, 1], jsecp.add(b[:, 0], b[:, 1])], axis=1)
    i = jnp.asarray(idx.astype(np.uint32))
    want = np.asarray(jsecp._shamir(table, i & 1, i >> 1)).astype(np.int64)
    return base, idx, pubs, want


def test_shamir_ladder_plain_matches_xla(laddered):
    base, idx, _, want = laddered
    got = secp_cuda.shamir_ladder(convert.pack32(torch.as_tensor(base)), torch.as_tensor(idx))
    assert got.dtype == torch.int32 and got.shape == (5, 3, 8)
    np.testing.assert_array_equal(convert.unpack32(got).numpy(), want)


def test_shamir_ladder_xla_gives_the_keys(laddered):
    # the four signatures' keys, and the identity for the all-0 lane
    _, _, pubs, want = laddered
    assert [secp.to_affine(pt) for pt in want] == pubs + [None]
