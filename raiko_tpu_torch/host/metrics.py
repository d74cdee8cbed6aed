"""Prometheus metrics with the reference's exact metric names
(host/src/metrics.rs:10-64), exposed at GET /v1/metrics."""

from __future__ import annotations

from prometheus_client import (
    CollectorRegistry,
    Counter,
    Gauge,
    Histogram,
    generate_latest,
)

registry = CollectorRegistry()

# process_* metrics (cpu seconds, RSS, fds) — the reference enables the
# prometheus crate's "process" feature for the same series
# (host/Cargo.toml feature list; host/src/metrics.rs)
try:  # /proc-based; absent on non-Linux
    from prometheus_client import process_collector

    process_collector.ProcessCollector(registry=registry)
except Exception:  # pragma: no cover
    pass

HOST_REQ_COUNT = Counter(
    "host_request_count",
    "the number of requests sent to the host",
    ["block_id"],
    registry=registry,
)
HOST_ERROR_COUNT = Counter(
    "host_error_count",
    "the number of failed requests produced by the host",
    ["block_id"],
    registry=registry,
)
GUEST_PROOF_REQ_COUNT = Counter(
    "guest_proof_request_count",
    "the number of requests sent to this guest",
    ["guest", "block_id"],
    registry=registry,
)
GUEST_PROOF_SUCCESS_COUNT = Counter(
    "guest_proof_success_count",
    "the number of successful proofs generated by this guest",
    ["guest", "block_id"],
    registry=registry,
)
GUEST_PROOF_ERROR_COUNT = Counter(
    "guest_proof_error_count",
    "the number of failed proofs generated by this guest",
    ["guest", "block_id"],
    registry=registry,
)
GUEST_PROOF_TIME = Histogram(
    "guest_proof_time_histogram",
    "time taken for proof generation by this guest",
    ["guest", "block_id", "success"],
    registry=registry,
)
PREPARE_INPUT_TIME = Histogram(
    "prepare_input_time_histogram",
    "time taken for prepare input",
    ["block_id", "success"],
    registry=registry,
)
TOTAL_TIME = Histogram(
    "total_time_histogram",
    "time taken for the whole request",
    ["block_id", "success"],
    registry=registry,
)
CONCURRENT_REQUESTS = Gauge(
    "concurrent_requests",
    "number of requests currently being processed",
    registry=registry,
)


def render() -> bytes:
    return generate_latest(registry)
