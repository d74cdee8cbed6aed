"""The roofline's counts against counts made by hand, and its share."""

import pytest

import roofline


def test_intt_work_by_hand():
    # (2, 8): 2 rows of 8; each row 4 butterflies x 3 stages and 8 scalings
    nbytes, mults = roofline.intt_work(2, 8)
    assert nbytes == 2 * 8 * 4 * 2  # read and written once, 4 bytes each
    assert mults == 4 * (2 * 12 + 2 * 8)


def test_ntt_coset_work_by_hand():
    # (3, 4) coefficients onto 16 points: 4 coset products, 8 x 4 butterflies
    nbytes, mults = roofline.ntt_coset_work(3, 4, 2)
    assert nbytes == 4 * 3 * (4 + 16)
    assert mults == 4 * 3 * (4 + 32)


def test_hash_rows_and_merkle_work_by_hand():
    # a Poseidon2 permutation: 8 full rounds of 16 S-boxes (4 products each)
    # and 13 partial rounds of one S-box and the 16 internal products
    assert roofline.PERM_MULS == 4 * (8 * 16 * 4 + 13 * (4 + 16)) == 3088
    nbytes, mults = roofline.hash_rows_work(5, 17)  # 17 words: 3 absorptions of 8
    assert nbytes == 4 * (5 * 17 + 5 * 8)
    assert mults == 5 * 3 * 3088
    assert roofline.hash_rows_work(5, 8)[1] == 5 * 3088
    nbytes, mults = roofline.merkle_work(8)  # 7 compressions, 15 digests
    assert nbytes == 4 * 8 * 15
    assert mults == 7 * 3088


def test_least_time_is_the_larger_bound():
    imad = 132 * 64 * 1980e6
    assert roofline.least_s(3.35e12, 0.0, imad) == pytest.approx(1.0)
    assert roofline.least_s(0.0, imad * 2, imad) == pytest.approx(2.0)
    assert roofline.least_s(3.35e12, imad * 2, imad) == pytest.approx(2.0)


class FakeTrace:
    def __init__(self, calls):
        self.calls = calls

    def kernel_calls(self):
        return self.calls


class FakeRun:
    card = {"sms": 132, "max_sm_mhz": 1980.0}

    def __init__(self, calls):
        self.trace = FakeTrace(calls) if calls is not None else None


def test_share_sums_least_times_over_device_times():
    imad = 132 * 64 * 1980e6
    calls = [("intt", (64, 1024), 1e-4), ("poseidon2_merkle", (4096,), 5e-5), ("poseidon2_merkle", (4096,), 5e-5)]
    want = (roofline.least_s(*roofline.intt_work(64, 1024), imad)
            + 2 * roofline.least_s(*roofline.merkle_work(4096), imad)) / 2e-4 * 100
    assert roofline.share(FakeRun(calls), roofline.KERNELS) == pytest.approx(want)
    only = roofline.share(FakeRun(calls), ("poseidon2_merkle",))
    assert only == pytest.approx(roofline.least_s(*roofline.merkle_work(4096), imad) / 5e-5 * 100)
    assert 0 < only < 100


def test_share_is_silent_without_calls():
    assert roofline.share(FakeRun(None), roofline.KERNELS) is None
    assert roofline.share(FakeRun([]), roofline.KERNELS) is None
    assert roofline.share(FakeRun([("intt", (1, 8), 1e-6)]), ("ntt_coset",)) is None
