"""ProofActor: the host's proof scheduler (reference host/src/proof.rs).

An asyncio single-receiver loop with a semaphore capping concurrent proof
tasks (:120-139), a per-task cancellation registry keyed by TaskDescriptor
(:32-117), status transitions persisted in the task DB (:141-174), and the
cache -> preflight -> output -> prove pipeline with stage metrics
(:177-273).  CPU-bound proving runs in a thread executor; cancellation is
cooperative between pipeline stages (the same granularity the reference's
CancellationToken achieves around its await points)."""

from __future__ import annotations

import asyncio
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Any

from ..chain import SupportedChainSpecs
from ..core.interfaces import ProofRequest, RaikoError, RpcError
from ..core.orchestrator import Raiko
from ..core.provider import get_task_data, provider_for
from ..tasks import TaskDescriptor, TaskManager, TaskStatus
from ..utils.measurement import Measurement
from . import cache, metrics
from .logs import MemStage


@dataclass
class HostConfig:
    device: Any  # torch device of the requests' device work; None = host
    concurrency_limit: int = 16
    cache_dir: str | None = None
    chain_spec_path: str | None = None
    sqlite_path: str | None = None
    max_db_size: int = 1_073_741_824
    jwt_secret: str | None = None
    address: str = "0.0.0.0"
    port: int = 8080
    default_request: dict = field(default_factory=dict)


class ProofActor:
    def __init__(
        self,
        config: HostConfig,
        task_manager: TaskManager,
        chain_specs: SupportedChainSpecs,
    ):
        self.config = config
        self.tasks = task_manager
        self.chain_specs = chain_specs
        self.queue: asyncio.Queue = asyncio.Queue()
        self.semaphore = asyncio.Semaphore(config.concurrency_limit)
        self.running: dict[TaskDescriptor, dict] = {}
        self._loop_task: asyncio.Task | None = None

    # -- lifecycle -------------------------------------------------------
    def start(self) -> None:
        self._loop_task = asyncio.get_event_loop().create_task(self.run())

    async def run(self) -> None:
        """Single receiver loop (ref :120-139)."""
        while True:
            key, request = await self.queue.get()
            await self.semaphore.acquire()
            task = asyncio.get_event_loop().create_task(
                self._run_task(key, request)
            )
            self.running[key] = {"task": task, "cancel": threading.Event()}
            task.add_done_callback(lambda _t: self.semaphore.release())

    def submit(self, key: TaskDescriptor, request: ProofRequest) -> None:
        self.queue.put_nowait((key, request))

    def cancel(self, key: TaskDescriptor) -> bool:
        # backend-specific cancel first (remote sessions via the IdStore,
        # reference host/src/proof.rs Cancel message -> Raiko::cancel)
        try:
            from ..core.interfaces import ProofType
            from ..provers import cancel_proof

            cancel_proof(ProofType.parse(key.proof_system), key, self.tasks)
        except Exception:
            pass
        entry = self.running.get(key)
        if entry:
            entry["cancel"].set()
            entry["task"].cancel()
            self.tasks.update_task_progress(key, TaskStatus.CANCELLED)
            return True
        self.tasks.update_task_progress(key, TaskStatus.CANCELLED_NEVER_STARTED)
        return True

    # -- task execution ---------------------------------------------------
    async def _run_task(self, key: TaskDescriptor, request: ProofRequest) -> None:
        try:
            status = [s for s, _, _ in self.tasks.get_task_proving_status(key)]
            if status and status[-1] not in (
                TaskStatus.REGISTERED,
                TaskStatus.WORK_IN_PROGRESS,
            ):
                return
            self.tasks.update_task_progress(key, TaskStatus.WORK_IN_PROGRESS)
            cancel_ev = self.running[key]["cancel"]
            loop = asyncio.get_event_loop()
            proof = await loop.run_in_executor(
                None, self._handle_proof, request, cancel_ev, key
            )
            self.tasks.update_task_progress(
                key, TaskStatus.SUCCESS, proof=proof
            )
        except asyncio.CancelledError:
            self.tasks.update_task_progress(key, TaskStatus.CANCELLED_ABORTED)
        except _Cancelled:
            self.tasks.update_task_progress(key, TaskStatus.CANCELLED_ABORTED)
        except RpcError:
            self.tasks.update_task_progress(key, TaskStatus.NETWORK_FAILURE)
        except RaikoError:
            self.tasks.update_task_progress(key, TaskStatus.PROOF_FAILURE_GENERIC)
        except Exception:
            traceback.print_exc()
            self.tasks.update_task_progress(
                key, TaskStatus.UNSPECIFIED_FAILURE_REASON
            )
        finally:
            self.running.pop(key, None)

    def _handle_proof(self, request: ProofRequest, cancel_ev, key=None) -> bytes:
        """cache -> preflight -> output -> prove (ref :177-273); each stage
        is a ``MemStage`` and a ``service.<stage>`` span."""
        import json

        from ..provers import ProverCtx

        ctx = ProverCtx(
            key=key, id_store=self.tasks, cancel_ev=cancel_ev, request=request
        )

        t_total = time.perf_counter()
        block = str(request.block_number)
        metrics.CONCURRENT_REQUESTS.inc()
        try:
            raiko = Raiko(self.chain_specs, request, self.config.device)
            spec = self.chain_specs.get(request.network)
            provider = provider_for(spec)
            gi = cache.get_input(
                self.config.cache_dir, request.block_number, request.network
            )
            if gi is not None and not cache.validate_input(gi, provider):
                gi = None
            t0 = time.perf_counter()
            if gi is None:
                with MemStage("prepare_input"), Measurement("service.prepare_input"):
                    gi = raiko.generate_input()
                cache.set_input(
                    self.config.cache_dir, request.block_number, request.network, gi
                )
            metrics.PREPARE_INPUT_TIME.labels(block, "true").observe(
                time.perf_counter() - t0
            )
            if cancel_ev.is_set():
                raise _Cancelled()
            with MemStage("guest_execution"), Measurement("service.guest_execution"):
                output = raiko.get_output(gi)
            if cancel_ev.is_set():
                raise _Cancelled()
            guest = request.proof_type.value
            metrics.GUEST_PROOF_REQ_COUNT.labels(guest, block).inc()
            t0 = time.perf_counter()
            try:
                with MemStage("prove"), Measurement("service.prove"):
                    proof = raiko.prove(gi, output, ctx=ctx)
                metrics.GUEST_PROOF_SUCCESS_COUNT.labels(guest, block).inc()
                metrics.GUEST_PROOF_TIME.labels(guest, block, "true").observe(
                    time.perf_counter() - t0
                )
            except Exception:
                metrics.GUEST_PROOF_ERROR_COUNT.labels(guest, block).inc()
                metrics.GUEST_PROOF_TIME.labels(guest, block, "false").observe(
                    time.perf_counter() - t0
                )
                raise
            metrics.TOTAL_TIME.labels(block, "true").observe(
                time.perf_counter() - t_total
            )
            return json.dumps(proof.to_json()).encode()
        finally:
            metrics.CONCURRENT_REQUESTS.dec()


class _Cancelled(Exception):
    pass


def make_task_descriptor(
    request: ProofRequest, chain_specs: SupportedChainSpecs
) -> TaskDescriptor:
    """The request's task key, in a ``service.task_key`` span (the server
    calls it on its executor for every v2 request, each poll too)."""
    with Measurement("service.task_key"):
        chain_id, blockhash = get_task_data(
            request.network, request.block_number, chain_specs
        )
    return TaskDescriptor(
        chain_id=chain_id,
        blockhash=blockhash,
        proof_system=request.proof_type.value,
        prover=request.prover,
    )
