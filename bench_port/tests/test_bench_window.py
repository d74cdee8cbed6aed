"""The window's arithmetic: a rate over every unit and all the window's
time, and percentiles over every unit."""

import statistics
import time

import pytest

import run


def make_run(unit_s, window_s):
    r = run.Run({"name": "x"}, {}, {}, device="cpu")
    r.unit_s, r.window_s = list(unit_s), window_s
    return r


def test_seconds_per_unit_is_the_window_over_every_unit():
    r = make_run([0.5, 1.5, 1.0, 1.0], 4.25)
    assert r.seconds_per_unit() == pytest.approx(4.25 / 4)
    assert make_run([], 1.0).seconds_per_unit() is None


def test_percentile_is_over_every_unit():
    vals = [0.1 * k for k in range(1, 201)]
    r = make_run(vals, sum(vals))
    assert r.percentile(95) == pytest.approx(statistics.quantiles(vals, n=100)[94])
    assert r.percentile(50) == pytest.approx(statistics.median(vals))
    assert make_run([1.0], 1.0).percentile(95) is None


class SleepUnit:
    """Units of a fixed length; one raises."""

    cycle = 1

    def __init__(self, length, fail_at=None):
        self.length, self.fail_at, self.calls = length, fail_at, 0
        self.started = self.ended = False

    def window_start(self):
        self.started = True

    def window_end(self):
        self.ended = True

    def run(self, i):
        self.calls += 1
        time.sleep(self.length)
        if i == self.fail_at:
            raise RuntimeError("no answer")


def test_window_runs_the_last_unit_to_its_end_and_counts_every_unit():
    r = make_run([], 0.0)
    unit = SleepUnit(0.05, fail_at=2)
    run.run_window(r, unit, 0.22, traced=False)
    assert unit.started and unit.ended
    assert r.units == unit.calls >= 4
    # every unit started inside the window, and none after it
    assert sum(r.unit_s[:-1]) < 0.22 <= r.window_s
    assert r.window_s >= sum(r.unit_s)
    assert r.failed == 1
    assert r.seconds_per_unit() == pytest.approx(r.window_s / r.units)


def test_spans_listen_only_inside_the_window():
    from raiko_tpu_torch.utils.measurement import Measurement

    r = make_run([], 0.0)
    token = Measurement.subscribe(r.spans)
    try:
        Measurement("stark.quotient").stop()

        class SpanUnit(SleepUnit):
            def run(self, i):
                Measurement("stark.quotient").stop()
                Measurement("stark.transcript").stop()

        run.run_window(r, SpanUnit(0.0), 0.01, traced=False)
    finally:
        Measurement.unsubscribe(token)
    assert len(r.spans.items) == 2 * r.units
    assert {t for t, _ in r.spans.items} == {"stark.quotient", "stark.transcript"}
    assert r.spans.total_s("stark.transcript") == pytest.approx(sum(s for t, s in r.spans.items if t == "stark.transcript"))


def test_window_closes_on_a_whole_cycle():
    r = make_run([], 0.0)
    unit = SleepUnit(0.02)
    unit.cycle = 7
    run.run_window(r, unit, 0.05, traced=False)
    assert r.units == 7  # the time ran out after about 3 units; the cycle takes 7
    r = make_run([], 0.0)
    unit = SleepUnit(0.02)
    unit.cycle = 7
    run.run_window(r, unit, 10.0, traced=False, units=3)
    assert r.units == 3  # a test's fixed count, whatever the time and the cycle
