"""The port's host Poseidon2 in C (``ops/poseidon2_host.py``,
``csrc/poseidon2_host.cpp``) against its plain Python versions.

The C permutation, the channel's absorb and squeeze, ``hash_row`` (widths
0-17 and 1,995), ``compress`` and the Merkle path check must equal
``ops/poseidon2.py``'s ``host_permute``, ``host_hash_row`` and
``host_compress`` bit for bit (tolerance 0) on seeded random states and
the edge states (all 0, all p - 1), and the batch permutation
``host_permute_batch``.  The Python versions equal the JAX package's, so
the library equals those too (checked on a few states).  The library
builds with g++ at first use; a build failure fails these tests.
"""

import numpy as np
import pytest

from raiko_tpu.ops import poseidon2 as jp2
from raiko_tpu_torch.fields import babybear as bb
from raiko_tpu_torch.ops import poseidon2 as p2
from raiko_tpu_torch.ops import poseidon2_host as p2h
from raiko_tpu_torch.stark.channel import Channel

P = bb.P
SEED = 20261017


def _states(n: int, seed: int = SEED) -> list[list[int]]:
    rng = np.random.default_rng(seed)
    return rng.integers(0, P, (n, 16)).tolist() + [[0] * 16, [P - 1] * 16]


def _py_absorb(state, elems):
    """The channel's absorb, one ``host_permute`` per chunk of 8."""
    st = list(state)
    for off in range(0, len(elems), 8):
        for i, v in enumerate(elems[off : off + 8]):
            st[i] = (st[i] + v) % P
        st = p2.host_permute(st)
    return st


def _py_path(leaf, index, path):
    cur = list(leaf)
    for sib in path:
        cur = p2.host_compress(sib, cur) if index & 1 else p2.host_compress(cur, sib)
        index >>= 1
    return cur


def test_library_loads():
    assert p2h.implementation().startswith(p2h.NAME)


def test_permute_matches_python():
    """1,000 random states and the edge states."""
    for s in _states(1000):
        assert p2h.permute(s) == p2.host_permute(s)


def test_permute_matches_jax_host():
    for s in _states(5, SEED + 1):
        assert p2h.permute(s) == jp2.host_permute(s)


def test_permute_reduces_its_input():
    """Words at or above p, and negative ints, are taken mod p as the
    Python version takes them."""
    s = [P, P + 1, 2**32 - 1, -1, 2**70] + list(range(11))
    assert p2h.permute(s) == p2.host_permute(s)
    with pytest.raises(ValueError):
        p2h.permute([0] * 15)


def test_permute_batch_matches_numpy():
    st = np.array(_states(300, SEED + 2), dtype=np.uint64)
    assert np.array_equal(p2h.permute_batch(st), p2.host_permute_batch(st))


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 16, 17, 100])
def test_absorb_matches_python(n):
    rng = np.random.default_rng(SEED + n)
    state = rng.integers(0, P, 16).tolist()
    elems = rng.integers(0, P, n).tolist()
    assert p2h.absorb(state, elems) == _py_absorb(state, elems)


@pytest.mark.parametrize("n", [1, 4, 8, 9, 20])
def test_squeeze_matches_python(n):
    state = _states(1, SEED + 3)[0]
    out, after = p2h.squeeze(state, n)
    want, st = [], list(state)
    while len(want) < n:
        want.extend(st[:8])
        st = p2.host_permute(st)
    assert out == want[:n] and after == st


@pytest.mark.parametrize("w", list(range(18)) + [1995])
def test_hash_row_matches_python(w):
    rng = np.random.default_rng(SEED + 100 + w)
    for row in (rng.integers(0, P, w).tolist(), [P - 1] * w, [0] * w):
        want = p2.host_hash_row(row)
        assert p2h.hash_row(row) == want
        assert p2h.hash_row(np.array(row, dtype=np.uint64)) == want


def test_compress_matches_python():
    for s in _states(200, SEED + 4):
        assert p2h.compress(s[:8], s[8:]) == p2.host_compress(s[:8], s[8:])


@pytest.mark.parametrize("depth", [0, 1, 5, 12])
def test_path_check_good_and_bad(depth):
    rng = np.random.default_rng(SEED + 200 + depth)
    row = rng.integers(0, P, 37).tolist()
    leaf = p2.host_hash_row(row)
    path = rng.integers(0, P, (depth, 8)).tolist()
    index = int(rng.integers(0, 1 << depth)) if depth else 0
    root = _py_path(leaf, index, path)
    assert p2h.path_ok(leaf, index, path, root)
    assert p2h.row_path_ok(row, index, path, root)
    bad_root = list(root)
    bad_root[3] = (bad_root[3] + 1) % P
    assert not p2h.path_ok(leaf, index, path, bad_root)
    bad_row = list(row)
    bad_row[0] = (bad_row[0] + 1) % P
    assert not p2h.row_path_ok(bad_row, index, path, root)
    if depth:
        bad_path = [list(d) for d in path]
        bad_path[-1][0] = (bad_path[-1][0] + 1) % P
        assert not p2h.path_ok(leaf, index, bad_path, root)
        assert not p2h.path_ok(leaf, index ^ 1, path, root)  # the wrong side
        short = [list(d) for d in path]
        short[0] = short[0][:7]
        assert not p2h.path_ok(leaf, index, short, root)


def test_channel_matches_python_transcript():
    """A transcript through the library equals one replayed with
    ``host_permute``: absorbs, squeezes and the grind."""
    rng = np.random.default_rng(SEED + 5)
    ch = Channel()
    state = [0] * 16
    pending = []
    for k in range(20):
        elems = rng.integers(0, P, int(rng.integers(0, 30))).tolist()
        ch.absorb_elems(elems)
        pending.extend(elems)
        got = ch.challenge_ef()
        state = _py_absorb(state, pending)
        pending = []
        want = state[:4]
        state = p2.host_permute(state)
        assert got == tuple(want), k
    ch.absorb_elems([7, 8, 9])
    nonce = ch.grind(6)
    # the scalar search: the first nonce whose challenge has 6 leading zeros
    for n in range(nonce + 1):
        st = _py_absorb(state, [7, 8, 9, n])
        if st[0] >> (31 - 6) == 0:
            break
    assert n == nonce
