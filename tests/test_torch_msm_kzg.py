"""The port's MSM and KZG commitments on the CPU.

The plain weighted fold (kernel B2's CPU version) is held against a Horner
chain of the JAX formulas in test_torch_limbs_curve.py.  The JAX MSM itself is ``slow``-marked on the CPU, so, as the JAX tests do,
the host reference ``host_curve.g1_msm`` stands in for it: MSM results are
compared as affine points or compressed bytes, exactly (tolerance 0).
Tests marked ``cuda`` hold the kernels against their plain versions on a
card and skip where torch sees none.
"""

import numpy as np
import pytest
import torch

from raiko_tpu.kzg import eip4844 as jeip
from raiko_tpu.kzg import host_curve as hc
from raiko_tpu_torch import convert
from raiko_tpu_torch.fields.limbs import FP
from raiko_tpu_torch.kzg import curve as tcurve
from raiko_tpu_torch.kzg import eip4844 as teip
from raiko_tpu_torch.ops import ec_cuda, msm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs files in parallel workers: torch's own thread pool per
    # worker would oversubscribe the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU = torch.device("cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def setup_points():
    return convert.setup_points(CPU)


def _scalars(seed: int, n: int, zero_share: float = 0.1) -> list[int]:
    rng = np.random.default_rng(seed)
    out = [int.from_bytes(rng.bytes(32), "big") % hc.R for _ in range(n)]
    # zero scalars and small ones exercise dropped digits and sparse windows
    for i in rng.choice(n, int(n * zero_share), replace=False):
        out[i] = 0
    out[0] = 1
    return out


def _limbs(scalars) -> torch.Tensor:
    return torch.as_tensor(msm.scalars_to_limbs(scalars).astype(np.int64))


def _projective(seed: int, shape) -> np.ndarray:
    """Random curve points with general Z, (..., 3, 24) Montgomery."""
    rng = np.random.default_rng(seed)
    k = int(np.prod(shape))
    pts = []
    for _ in range(k):
        x, y = hc.g1_mul(hc.G1_GEN, int(rng.integers(1, 1 << 62)))
        lam = int.from_bytes(rng.bytes(48), "big") % (hc.P - 1) + 1
        pts.append(np.stack([FP.to_mont_int(x * lam % hc.P), FP.to_mont_int(y * lam % hc.P),
                             FP.to_mont_int(lam)]))
    return np.stack(pts).reshape(tuple(shape) + (3, 24)).astype(np.int64)


def test_ec_add_plain_is_packed_curve_add():
    p = torch.as_tensor(_projective(2, (6,)))
    q = torch.as_tensor(_projective(3, (6,)))
    got = ec_cuda.ec_add(convert.pack32(p), convert.pack32(q))
    assert torch.equal(convert.unpack32(got), tcurve.add(p, q))


@pytest.mark.parametrize("n", [64, 256])
def test_msm_matches_host(setup_points, n):
    scalars = _scalars(n, n)
    got = tcurve.to_affine(msm.msm(setup_points[:n], _limbs(scalars)))
    assert got == hc.g1_msm(jeip.setup()["g1_lagrange"][:n], scalars)


def test_msm_multi_matches_host(setup_points):
    n = 48
    batch = [_scalars(10 + b, n, zero_share=0.3) for b in range(2)]
    limbs = torch.stack([_limbs(s) for s in batch])
    got = msm.msm_multi(setup_points[:n], limbs)
    pts = jeip.setup()["g1_lagrange"][:n]
    assert [tcurve.to_affine(r) for r in got] == [hc.g1_msm(pts, s) for s in batch]


def test_zero_blob_versioned_hash_golden():
    c = teip.blob_to_kzg_commitment(bytes(jeip.BYTES_PER_BLOB), device=CPU)
    vh = jeip.commitment_to_version_hash(c)
    assert vh.hex() == "010657f37554c781402a22917dee2f75def7ab966d7b770905398eba3c444014"


def test_all_ones_blob_commits_to_generator():
    # evaluation form all-1 => p(X) = 1 => commitment = G1 generator
    blob = (1).to_bytes(32, "big") * jeip.FIELD_ELEMENTS_PER_BLOB
    c = teip.blob_to_kzg_commitment(blob, device=CPU)
    assert hc.g1_decompress(c) == hc.G1_GEN


def test_blobs_to_kzg_commitments_match_host():
    rng = np.random.default_rng(4)
    blobs = []
    for _ in range(2):
        blob = bytearray(jeip.BYTES_PER_BLOB)
        for i in rng.choice(jeip.FIELD_ELEMENTS_PER_BLOB, 24, replace=False):
            blob[32 * i + 1 : 32 * i + 32] = rng.bytes(31)
        blobs.append(bytes(blob))
    got = teip.blobs_to_kzg_commitments(blobs, device=CPU)
    assert got == [jeip.blob_to_kzg_commitment(b, use_tpu=False) for b in blobs]
    assert teip.blobs_to_kzg_commitments([], device=CPU) == []


@pytest.mark.cuda
def test_g1_kernels_match_plain_on_card(cuda_device):
    p = convert.pack32(torch.as_tensor(_projective(5, (300,))))
    q = convert.pack32(torch.as_tensor(_projective(6, (300,))))
    got = ec_cuda.ec_add(p.to(cuda_device), q.to(cuda_device))
    assert torch.equal(got.cpu(), ec_cuda.ec_add_plain(p, q))
    v = p[:256].reshape(1, 256, 3, 12).contiguous()
    got = ec_cuda.ec_weighted_fold(v.to(cuda_device))
    assert torch.equal(got.cpu(), ec_cuda.ec_weighted_fold_plain(v))


def _with_special_sums(p: torch.Tensor, q: torch.Tensor) -> None:
    """Pair i of p + q becomes, by i mod 6: a general sum (0), P + P,
    P + (-P), P + O, O + Q or O + O (O the identity); packed layout."""
    kind = torch.arange(p.shape[0], device=p.device) % 6
    inf = convert.pack32(tcurve.identity((), p.device))
    q[kind == 1] = p[kind == 1]
    if (kind == 2).any():
        neg = convert.unpack32(p[kind == 2])
        neg[:, 1] = FP.neg(neg[:, 1])
        q[kind == 2] = convert.pack32(neg)
    q[kind == 3] = inf
    p[kind == 4] = inf
    p[kind == 5] = inf
    q[kind == 5] = inf


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 5, 33, 257, 16385])
def test_ec_add_layouts_match_plain_on_card(cuda_device, setup_points, m):
    # B1 runs a pair on a group of lanes, 8 or 2 by the width: widths that
    # fill no whole warp or block, on both sides of the cutoff (8,192), in
    # both layouts and through ec_add; points with Z != 1 (sums of setup
    # points) and every special case of the complete formula
    pool = convert.pack32(setup_points[:512]).to(cuda_device)
    rng = np.random.default_rng(m)
    pick = lambda: pool[torch.as_tensor(rng.integers(0, 512, m), device=cuda_device)]
    p = ec_cuda.ec_add_plain(pick(), pick())
    q = ec_cuda.ec_add_plain(pick(), pick())
    _with_special_sums(p, q)
    want = ec_cuda.ec_add_plain(p, q)
    for lanes in ec_cuda.ADD_LANE_CHOICES:
        assert torch.equal(ec_cuda.ec_add_lanes(p, q, lanes), want), lanes
    assert torch.equal(ec_cuda.ec_add(p, q), want)


@pytest.mark.cuda
@pytest.mark.parametrize("j", [1, 2, 256])
@pytest.mark.parametrize("bsz", [1, 4, 33])
def test_weighted_fold_edges_match_plain_on_card(cuda_device, setup_points, j, bsz):
    # B2 spreads each entry's chain over a warp: J = 1 is the input
    # unchanged; identities (empty buckets), repeated points and points
    # with Z != 1 among the inputs; batch 33 runs more blocks than SMs hold
    # in one wave of one warp each
    ident = convert.pack32(tcurve.identity((1,)))
    pool = torch.cat([convert.pack32(setup_points[:512]), convert.pack32(torch.as_tensor(_projective(7, (32,)))),
                      ident])
    rng = np.random.default_rng(100 * j + bsz)
    v = pool[torch.as_tensor(rng.integers(0, pool.shape[0], bsz * j))].reshape(bsz, j, 3, 12).contiguous()
    v[bsz // 2, 0] = ident[0]
    if j >= 2:
        v[0, j - 1] = v[0, j - 2]
        v[bsz - 1, j // 2] = ident[0]
    got = ec_cuda.ec_weighted_fold(v.to(cuda_device))
    assert torch.equal(got.cpu(), ec_cuda.ec_weighted_fold_plain(v))
