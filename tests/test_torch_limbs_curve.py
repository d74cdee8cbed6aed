"""The port's limb fields and curve formulas against the JAX package.

The same numpy-seeded inputs go through raiko_tpu (JAX on the CPU) and
raiko_tpu_torch (PyTorch on the CPU).  Field arithmetic is exact, so every
comparison is bit for bit (tolerance 0): Montgomery limbs, projective
coordinates, and affine points after ``to_affine``.  The plain weighted
fold (kernel B2's CPU version) is held against a Horner chain of the JAX
formulas here too: at the curve tests' batch shape it reuses their
compiled JAX operations.
"""

import jax
import numpy as np
import pytest
import torch

from raiko_tpu.fields import limbs as jlimbs
from raiko_tpu.kzg import curve as jcurve
from raiko_tpu.kzg import eip4844 as jeip
from raiko_tpu.kzg import host_curve as hc
from raiko_tpu.ops import secp as jsecp
from raiko_tpu.utils import secp256k1 as shost
from raiko_tpu_torch import convert
from raiko_tpu_torch.fields import limbs as tlimbs
from raiko_tpu_torch.kzg import curve as tcurve
from raiko_tpu_torch.ops import ec_cuda
from raiko_tpu_torch.ops import secp as tsecp


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs files in parallel workers: torch's own thread pool per
    # worker would oversubscribe the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FIELDS = {"fp": (jlimbs.FP, tlimbs.FP), "fr": (jlimbs.FR, tlimbs.FR)}


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a).astype(np.int64))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.int64)


def _field_inputs(F, seed: int, k: int = 20):
    rng = np.random.default_rng(seed)
    xs = [int.from_bytes(rng.bytes(48), "big") % F.modulus for _ in range(k)]
    xs += [0, 1, F.modulus - 1]
    a = np.stack([F.to_mont_int(v) for v in xs])
    return a, np.roll(a, 1, axis=0)


@pytest.mark.parametrize("op", ["add", "sub", "mont_mul", "neg", "to_mont", "from_mont"])
@pytest.mark.parametrize("field", sorted(FIELDS))
def test_field_op_matches_jax(field, op):
    jf, tf = FIELDS[field]
    a, b = _field_inputs(jf, seed=len(op) * 7 + len(field))
    args = (a, b) if op in ("add", "sub", "mont_mul") else (a,)
    want = np.asarray(jax.jit(getattr(jf, op))(*args)).astype(np.int64)
    got = _np(getattr(tf, op)(*map(_t, args)))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("field", sorted(FIELDS))
def test_field_pow_inv_exact(field):
    jf, tf = FIELDS[field]
    a, _ = _field_inputs(jf, seed=3, k=6)
    vals = [jf.from_mont_limbs(r) for r in a]
    inv = [tf.from_mont_limbs(r) for r in _np(tf.mont_inv(_t(a)))]
    assert inv == [pow(v, -1, jf.modulus) if v else 0 for v in vals]
    pw = [tf.from_mont_limbs(r) for r in _np(tf.mont_pow(_t(a), 5))]
    assert pw == [pow(v, 5, jf.modulus) for v in vals]


def _g1_batch(seed: int):
    """16 (p, q) projective pairs with general Z: generic sums, P == Q,
    P + O, O + Q, O + O and P + (-P)."""
    rng = np.random.default_rng(seed)
    P = hc.P
    ks = [int(k) for k in rng.integers(1, 1 << 62, 18)]
    pts = [hc.g1_mul(hc.G1_GEN, k) for k in ks]

    def proj(pt):
        if pt is None:
            return np.asarray(jcurve.identity(()))
        lam = int.from_bytes(rng.bytes(48), "big") % (P - 1) + 1
        x, y = pt
        return np.stack([jlimbs.FP.to_mont_int(x * lam % P), jlimbs.FP.to_mont_int(y * lam % P),
                         jlimbs.FP.to_mont_int(lam)])

    ps = [pts[i] for i in range(10)] + [pts[10], pts[11], None, None, pts[12], pts[13]]
    qs = [pts[i + 1] for i in range(10)] + [pts[10], None, pts[14], None, hc.g1_neg(pts[12]), pts[13]]
    return np.stack([proj(p) for p in ps]), np.stack([proj(q) for q in qs]), ps, qs


def test_curve_add_matches_jax():
    p, q, ps, qs = _g1_batch(5)
    want = np.asarray(jcurve.add(p, q)).astype(np.int64)
    got = _np(tcurve.add(_t(p), _t(q)))
    assert np.array_equal(got, want)
    for row, a, b in zip(got, ps, qs):
        assert tcurve.to_affine(row) == hc.g1_add(a, b)


SPECIAL_SUMS = ["P+P", "P+(-P)", "P+O", "O+Q", "O+O"]


@pytest.mark.parametrize("kind", SPECIAL_SUMS)
def test_ec_add_plain_special_sums_match_jax(kind):
    # kernel B1's plain version (packed 32-bit limbs) on the complete
    # formula's special cases, with general Z, against JAX's add; the same
    # batch shape as test_curve_add_matches_jax, so JAX reuses its kernels
    rng = np.random.default_rng(SPECIAL_SUMS.index(kind) + 20)
    pts = [hc.g1_mul(hc.G1_GEN, int(k)) for k in rng.integers(1, 1 << 62, 16)]

    def proj(pt):
        if pt is None:
            return np.asarray(jcurve.identity(()))
        lam = int.from_bytes(rng.bytes(48), "big") % (hc.P - 1) + 1
        return np.stack([jlimbs.FP.to_mont_int(pt[0] * lam % hc.P), jlimbs.FP.to_mont_int(pt[1] * lam % hc.P),
                         jlimbs.FP.to_mont_int(lam)])

    ps, qs = {"P+P": (pts, pts), "P+(-P)": (pts, [hc.g1_neg(pt) for pt in pts]),
              "P+O": (pts, [None] * 16), "O+Q": ([None] * 16, pts), "O+O": ([None] * 16, [None] * 16)}[kind]
    p, q = np.stack([proj(a) for a in ps]), np.stack([proj(b) for b in qs])
    want = np.asarray(jcurve.add(p, q)).astype(np.int64)
    got = _np(convert.unpack32(ec_cuda.ec_add(convert.pack32(_t(p)), convert.pack32(_t(q)))))
    assert np.array_equal(got, want)
    for row, a, b in zip(got, ps, qs):
        assert tcurve.to_affine(row) == hc.g1_add(a, b)


def test_curve_double_matches_jax():
    p, _, ps, _ = _g1_batch(6)
    want = np.asarray(jcurve.double(p)).astype(np.int64)
    got = _np(tcurve.double(_t(p)))
    assert np.array_equal(got, want)
    for row, a in zip(got, ps):
        assert tcurve.to_affine(row) == hc.g1_add(a, a)


def test_weighted_fold_plain_matches_jax_horner():
    # (16, 4) points, infinity among them: Σ_j 2^j v_j by Horner in JAX
    p, q, _, _ = _g1_batch(8)
    p2, q2, _, _ = _g1_batch(9)
    v = np.stack([p, q, p2, q2], axis=1)
    acc = v[:, -1]
    for j in range(v.shape[1] - 2, -1, -1):
        acc = jcurve.add(jcurve.double(acc), v[:, j])
    want = np.asarray(acc).astype(np.int64)
    got = convert.unpack32(ec_cuda.ec_weighted_fold_plain(convert.pack32(_t(v))))
    assert np.array_equal(_np(got), want)


def _secp_batch(seed: int):
    rng = np.random.default_rng(seed)
    P = shost.P
    pts = [shost._mul(shost.G, int.from_bytes(rng.bytes(31), "big") + 1) for _ in range(15)]

    def proj(pt):
        if pt is None:
            return np.asarray(jsecp.identity(()))
        lam = int.from_bytes(rng.bytes(32), "big") % (P - 1) + 1
        x, y = pt
        return np.stack([jsecp.FP.to_mont_int(x * lam % P), jsecp.FP.to_mont_int(y * lam % P),
                         jsecp.FP.to_mont_int(lam)])

    ps = pts[:10] + [pts[10], pts[11], None, None, pts[12], pts[13]]
    neg = (pts[12][0], P - pts[12][1])
    qs = pts[1:11] + [pts[10], None, pts[14], None, neg, pts[13]]
    return np.stack([proj(p) for p in ps]), np.stack([proj(q) for q in qs]), ps, qs


def test_secp_add_double_match_jax():
    p, q, ps, qs = _secp_batch(7)
    want_add = np.asarray(jsecp.add(p, q)).astype(np.int64)
    got_add = _np(tsecp.add(_t(p), _t(q)))
    assert np.array_equal(got_add, want_add)
    want_dbl = np.asarray(jsecp.double(p)).astype(np.int64)
    got_dbl = _np(tsecp.double(_t(p)))
    assert np.array_equal(got_dbl, want_dbl)
    for row, a, b in zip(got_add, ps, qs):
        assert tsecp.to_affine(row) == shost._add(a, b)
    for row, a in zip(got_dbl, ps):
        assert tsecp.to_affine(row) == shost._add(a, a)


def test_setup_points_match_reference():
    got = _np(convert.setup_points("cpu")[:64])
    want = jcurve.points_from_affine(jeip.setup()["g1_lagrange"][:64]).astype(np.int64)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("nlimbs16", [24, 16])
def test_pack32_roundtrip(nlimbs16):
    rng = np.random.default_rng(nlimbs16)
    limbs = _t(rng.integers(0, 1 << 16, (5, 3, nlimbs16)))
    packed = convert.pack32(limbs)
    assert packed.dtype == torch.int32 and packed.shape == (5, 3, nlimbs16 // 2)
    assert torch.equal(convert.unpack32(packed), limbs)
    # 32-bit limb k holds 16-bit limbs 2k (low half) and 2k+1 (high half)
    u32 = packed.long() & 0xFFFFFFFF
    assert torch.equal(u32, limbs[..., 0::2] | (limbs[..., 1::2] << 16))
