"""The trace's arithmetic on a hand-made chrome trace: the window's clip,
the union of device time, attribution to every enclosing range, the
commitment kernels' calls and the idle gaps."""

import pytest

from profile_trace import Trace, enclosing, union_us


def test_union_of_intervals():
    assert union_us([(0, 10), (5, 15), (20, 25)]) == 20
    assert union_us([(0, 10), (2, 3)]) == 10
    assert union_us([]) == 0


def test_enclosing_nested_ranges():
    ranges = [(0, 100, "a"), (10, 40, "b"), (20, 30, "c"), (50, 60, "d")]
    got = enclosing(ranges, [5, 25, 35, 55, 70])
    assert [[r[2] for r in g] for g in got] == [["a"], ["a", "b", "c"], ["a", "b"], ["a", "d"], ["a"]]


def ann(name, ts, dur, tid=1):
    return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": tid}


def launch(ts, corr, tid=1):
    return {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1, "tid": tid,
            "args": {"correlation": corr}}


def kernel(ts, dur, corr, name="k"):
    return {"cat": "kernel", "name": name, "ts": ts, "dur": dur, "tid": 7, "args": {"correlation": corr}}


def make_trace():
    return Trace([
        ann("bench.window", 100, 1000),
        ann("stark.quotient", 150, 300),
        ann("bench.kernel intt 4x1024", 160, 20),
        launch(165, 1), kernel(170, 50, 1, "ntt_rows_kernel"),
        launch(200, 2), kernel(230, 40, 2, "quotient"),
        ann("stark.fri", 500, 200),
        ann("bench.kernel poseidon2_merkle 4096", 510, 10),
        launch(512, 3), kernel(600, 20, 3, "merkle_kernel"),
        launch(50, 4), kernel(60, 60, 4, "before"),  # half before the window
        launch(900, 5), kernel(1080, 100, 5, "after"),  # runs past the window's end
    ])


def test_window_clip_and_busy():
    t = make_trace()
    assert t.window_s == pytest.approx(1000e-6)
    # 170-220, 230-270, 600-620, 100-120 (clipped), 1080-1100 (clipped)
    assert t.busy_s == pytest.approx((50 + 40 + 20 + 20 + 20) * 1e-6)


def test_attribution_to_every_enclosing_range():
    t = make_trace()
    assert t.device_s_in("stark.quotient") == pytest.approx(90e-6)  # the intt's kernel too
    assert t.device_s_in("stark.fri") == pytest.approx(20e-6)
    assert t.device_s_in("stark.") == pytest.approx(110e-6)
    calls = sorted(t.kernel_calls())
    assert calls == [("intt", (4, 1024), pytest.approx(50e-6)), ("poseidon2_merkle", (4096,), pytest.approx(20e-6))]


def test_breakdown_names_stages():
    t = make_trace()
    ops = dict(t.top_device_ops())
    assert ops["stark.quotient | ntt_rows_kernel"] == pytest.approx(50e-6)
    assert ops["stark.fri | merkle_kernel"] == pytest.approx(20e-6)
    assert ops["outside | before"] == pytest.approx(20e-6)
    gaps = dict(t.idle_gaps())
    # idle: 120-170 (its middle 145: no range), 220-230 and 270-600 (their
    # middles 225 and 435: the quotient's range), 620-1080 (no range)
    assert gaps["stark.quotient"] == pytest.approx((10 + 330) * 1e-6)
    assert gaps["outside every range"] == pytest.approx((50 + 460) * 1e-6)
    assert "stark.fri" not in gaps
    assert sum(gaps.values()) == pytest.approx(t.window_s - t.busy_s)
