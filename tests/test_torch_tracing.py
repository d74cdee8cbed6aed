"""The port's spans (``utils.measurement.Measurement``), on the CPU.

A span is the host clock and, while torch.profiler records, a profiler
range of the same name on the same thread.  Checked here: a span puts one
``user_annotation`` event of its title into an exported trace, nested
under the span around it; with no profiler it opens no range; a span on a
pool thread reaches the listeners, and a trace that records every thread;
one EVM call tree of the bench mix proven by ``prove_evm_frames`` emits
the frame statement's and the prover's spans, nested as the readers
expect, none of the new ones under the ``stark.`` prefix that the stage
readers sum; one served ``native`` request emits the service's, the
preflight's, the re-execution's and the KZG proof's spans; and each of the
benchmark's readers of these spans gives its milliseconds per unit on a
hand-made run, and nothing on a run without the spans.
"""

import json
import os
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from raiko_tpu_torch.utils.measurement import Measurement

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "bench_port")
# the frame statement's and the prover's spans that the benchmark reads
FRAME_SPANS = ("frames.replay", "frames.tables", "prover.tables", "aux.columns", "grind.pow", "frames.serialize")
SERVICE_SPANS = ("service.prepare_input", "service.guest_execution", "service.prove", "service.task_key",
                 "service.submit", "service.poll", "preflight.l1", "preflight.execute", "preflight.witness",
                 "evm.block_header", "kzg.proof", "kzg.commit")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs files in parallel workers: torch's own thread pool per
    # worker would oversubscribe the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Listener:
    """(title, seconds) of every span that stops while it is subscribed."""

    def __init__(self):
        self.items, self._lock = [], threading.Lock()

    def __call__(self, title, seconds):
        with self._lock:
            self.items.append((title, seconds))

    def __enter__(self):
        self.token = Measurement.subscribe(self)
        return self

    def __exit__(self, *exc):
        Measurement.unsubscribe(self.token)

    def titles(self) -> set:
        return {t for t, _ in self.items}


def annotations(prof) -> list:
    """(start, end, name, thread) of every profiler range of the trace."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"], e.get("tid")) for e in events
                  if e.get("cat") == "user_annotation" and "dur" in e)


def inside(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1] and inner[3] == outer[3]


def all_threads_config():
    """The profiler's option to record every thread, where this torch has it."""
    from torch._C._profiler import _ExperimentalConfig

    try:
        return _ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        return None


# --- the span itself


def test_span_is_one_profiler_range_nested_under_its_parent():
    with Listener() as heard, profile(activities=[ProfilerActivity.CPU]) as prof:
        with Measurement("outer.span"):
            with Measurement("inner.span"):
                time.sleep(0.002)
    ranges = annotations(prof)
    outer = [r for r in ranges if r[2] == "outer.span"]
    inner = [r for r in ranges if r[2] == "inner.span"]
    assert len(outer) == 1 and len(inner) == 1
    assert inside(inner[0], outer[0])
    assert [t for t, _ in heard.items] == ["inner.span", "outer.span"]
    assert all(s > 0 for _, s in heard.items)


def test_span_without_profiler_opens_no_range(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a range was opened with no profiler on")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with Listener() as heard:
        span = Measurement("quiet.span")
        assert span._range is None
        seconds = span.stop()
    assert heard.items == [("quiet.span", seconds)]


def test_span_stops_on_the_thread_that_started_it():
    with profile(activities=[ProfilerActivity.CPU]):
        span = Measurement("moved.span")
        with ThreadPoolExecutor(1) as pool:
            with pytest.raises(RuntimeError, match="another thread"):
                pool.submit(span.stop).result(timeout=30)
        span.stop()


def test_span_on_a_pool_thread_reaches_the_listener_and_an_all_threads_trace():
    def work():
        with Measurement("pool.span"):
            time.sleep(0.002)
        return threading.get_ident()

    config = all_threads_config()
    kwargs = {} if config is None else {"experimental_config": config}
    with ThreadPoolExecutor(1) as pool:
        pool.submit(lambda: None).result(timeout=30)  # the thread exists before the profiler starts
        with Listener() as heard, profile(activities=[ProfilerActivity.CPU], **kwargs) as prof:
            with Measurement("main.span"):
                pool.submit(work).result(timeout=30)
    assert sorted(t for t, _ in heard.items) == ["main.span", "pool.span"]
    if config is None:
        pytest.skip("this torch's profiler has no profile_all_threads: the trace check needs it")
    ranges = {r[2]: r for r in annotations(prof)}
    assert {"main.span", "pool.span"} <= set(ranges)
    assert ranges["pool.span"][3] != ranges["main.span"][3]


# --- where the port puts its spans


@pytest.fixture(scope="module")
def chain():
    """One taiko_a7 blob block of the bench mix's recipe, two txs (a storage
    churn call first), built on the host."""
    from raiko_tpu_torch.core import provider
    from raiko_tpu_torch.testing.workload import build_chain

    build_chain(1, 2, None)
    yield
    provider._SIM_REGISTRY.clear()


def test_frame_statement_spans_nest_as_the_readers_expect(chain):
    from raiko_tpu_torch.chain import SupportedChainSpecs
    from raiko_tpu_torch.core.interfaces import ProofRequest, ProofType
    from raiko_tpu_torch.core.orchestrator import Raiko
    from raiko_tpu_torch.evm.builder import calculate_block_header
    from raiko_tpu_torch.provers import tpu_stark

    req = ProofRequest(block_number=1, network="taiko_a7", proof_type=ProofType.TPU_STARK)
    collect: dict = {}
    calculate_block_header(Raiko(SupportedChainSpecs(), req, None).generate_input(), collect, device=None)
    smallest = min(collect["frames"], key=lambda c: (len(c["code"]), c["gas"] - c["gas_left"]))
    with Listener() as heard, profile(activities=[ProfilerActivity.CPU]) as prof:
        evm = tpu_stark.prove_evm_frames([smallest], "cpu", max_frames=1, workers=1)
    assert evm is not None and evm["covered"] == 1
    assert set(FRAME_SPANS) <= heard.titles()
    assert not [t for t in FRAME_SPANS if t.startswith("stark.")]
    ranges = annotations(prof)
    named = {name: [r for r in ranges if r[2] == name] for name in {r[2] for r in ranges}}
    (replay,), (tables,), (prover,), (serialize,) = (named[n] for n in ("frames.replay", "frames.tables",
                                                                          "prover.tables", "frames.serialize"))
    # the frame statement's spans one after another, the prover between
    assert replay[1] <= tables[0] and tables[1] <= prover[0] and prover[1] <= serialize[0]
    for r in ranges:  # every stage and every transcript squeeze inside the prover
        if r[2].startswith("stark."):
            assert inside(r, prover), r
    for span, stage in (("aux.columns", "stark.aux_commit"), ("grind.pow", "stark.grind_queries")):
        assert named[span] and len(named[span]) == len(named[stage])
        assert all(any(inside(r, s) for s in named[stage]) for r in named[span])
    # no span doubles a stage: every title under the stage readers' prefix
    # is a stage's or the transcript's
    assert {t for t in heard.titles() if t.startswith("stark.")} <= {
        "stark.trace_commit", "stark.aux_commit", "stark.quotient", "stark.ood", "stark.deep", "stark.fri",
        "stark.grind_queries", "stark.transcript"}


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(), headers={"content-type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def test_served_native_request_emits_every_span(chain):
    import socket

    from raiko_tpu_torch.host import cli

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    argv = ["--device", "cpu", "--address", "127.0.0.1", "--port", str(port), "--log-level", "warning"]
    body = {"block_number": 1, "network": "taiko_a7", "proof_type": "native"}
    with cli.BackgroundServer(argv), Listener() as heard:
        url = f"http://127.0.0.1:{port}/v2/proof"
        r = _post(url, body)
        for _ in range(480):
            if r["data"]["status"] == "success":
                break
            assert r["data"]["status"] in ("registered", "work_in_progress"), r
            time.sleep(0.1)
            r = _post(url, body)
    assert r["data"]["status"] == "success", r
    assert r["data"]["proof"]["kzg_proof"] is not None
    titles = [t for t, _ in heard.items]
    assert set(SERVICE_SPANS) <= set(titles), set(SERVICE_SPANS) - set(titles)
    # the output's re-execution and the native prover's
    assert titles.count("evm.block_header") == 2
    assert titles.count("service.submit") == 1 and titles.count("service.poll") >= 1
    assert titles.count("service.task_key") == titles.count("service.submit") + titles.count("service.poll")


# --- the benchmark's readers of the spans


def _run(spans, counters=None, units=4):
    if BENCH not in sys.path:
        sys.path.insert(0, BENCH)
    import run

    r = run.Run({"name": "x"}, {}, {}, device="cpu")
    r.unit_s, r.window_s = [0.5] * units, 0.5 * units
    r.spans.items = list(spans)
    r.counters = dict(counters or {})
    return r


def _reader(name):
    if BENCH not in sys.path:
        sys.path.insert(0, BENCH)
    import run

    return run.load_module(os.path.join(BENCH, "metrics", name + ".py"), "t_" + name.replace(".", "_"))


TREE_SPANS = [("frames.replay", 0.004), ("frames.replay", 0.002), ("frames.tables", 0.04), ("prover.tables", 1.2),
              ("stark.trace_commit", 0.2), ("stark.aux_commit", 0.3), ("aux.columns", 0.25),
              ("stark.grind_queries", 0.1), ("grind.pow", 0.06), ("stark.transcript", 0.02),
              ("frames.serialize", 0.08), ("tpu_stark.evm", 9.0)]
REQUEST_SPANS = [("service.prepare_input", 0.4), ("preflight.l1", 0.1), ("kzg.commit", 0.05),
                 ("preflight.execute", 0.2), ("evm.senders", 0.01), ("preflight.witness", 0.06),
                 ("service.guest_execution", 0.16), ("evm.block_header", 0.15), ("service.prove", 0.14),
                 ("evm.block_header", 0.12), ("kzg.proof", 0.02), ("service.task_key", 0.001),
                 ("service.submit", 0.002), ("service.poll", 0.003), ("service.poll", 0.005)]
READERS = [
    ("frames.replay_ms.prove", TREE_SPANS, {}, 0.006 / 4 * 1e3),
    ("frames.tables_ms.prove", TREE_SPANS, {}, 0.04 / 4 * 1e3),
    ("frames.serialize_ms.prove", TREE_SPANS, {}, 0.08 / 4 * 1e3),
    ("prover.unstaged_ms.prove", TREE_SPANS, {}, (1.2 - 0.2 - 0.3 - 0.1 - 0.02) / 4 * 1e3),
    ("aux.columns_ms.prove", TREE_SPANS, {}, 0.25 / 4 * 1e3),
    ("grind.pow_ms.prove", TREE_SPANS, {}, 0.06 / 4 * 1e3),
    ("service.output_ms.native", REQUEST_SPANS, {}, 0.16 / 4 * 1e3),
    ("preflight.l1_ms.native", REQUEST_SPANS, {}, 0.1 / 4 * 1e3),
    ("preflight.execute_ms.native", REQUEST_SPANS, {}, 0.2 / 4 * 1e3),
    ("preflight.witness_ms.native", REQUEST_SPANS, {}, 0.06 / 4 * 1e3),
    ("evm.block_header_ms.native", REQUEST_SPANS, {}, 0.27 / 4 * 1e3),
    ("kzg.proof_ms.native", REQUEST_SPANS, {}, 0.02 / 4 * 1e3),
    ("service.poll_wait_ms.native", REQUEST_SPANS, {"polls": 2, "poll_s": 0.05}, (0.05 - 0.008) / 2 * 1e3),
]


@pytest.mark.parametrize("name,spans,counters,want", READERS, ids=[r[0] for r in READERS])
def test_reader_gives_ms_per_unit(name, spans, counters, want):
    assert _reader(name).read(_run(spans, counters)) == pytest.approx(want)


@pytest.mark.parametrize("name", [r[0] for r in READERS])
def test_reader_gives_nothing_where_the_program_has_no_span(name):
    # a program without these spans, its unit's counters kept as they are
    reader = _reader(name)
    assert reader.read(_run([("stark.quotient", 0.5)], {"polls": 3, "poll_s": 0.09})) is None
    assert reader.read(_run(TREE_SPANS + REQUEST_SPANS, {"polls": 0, "poll_s": 0.0}, units=0)) is None
