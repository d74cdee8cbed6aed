"""Task manager: status state machine, descriptors, backend selection
(reference tasks/src/lib.rs).

Status codes mirror the reference exactly (:60-80): Success=0,
Registered=1000, WorkInProgress=2000, failures negative.  Status history
is append-only and only appended on change (mem_db.rs:60-77).  The
manager doubles as the IdStore for external prover-session ids
(ref :182-207)."""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from enum import IntEnum


class TaskStatus(IntEnum):
    SUCCESS = 0
    REGISTERED = 1000
    WORK_IN_PROGRESS = 2000
    PROOF_FAILURE_GENERIC = -1000
    PROOF_FAILURE_OUT_OF_MEMORY = -1100
    NETWORK_FAILURE = -2000
    CANCELLED = -3000
    CANCELLED_NEVER_STARTED = -3100
    CANCELLED_ABORTED = -3200
    CANCELLATION_IN_PROGRESS = -3210
    INVALID_OR_UNSUPPORTED_BLOCK = -4000
    UNSPECIFIED_FAILURE_REASON = -9999
    SQL_DB_CORRUPTION = -99999

    @property
    def wire(self) -> str:
        return self.name.lower()


@dataclass(frozen=True)
class TaskDescriptor:
    chain_id: int
    blockhash: bytes
    proof_system: str
    prover: str


class TaskManager:
    """Abstract API (reference TaskManager trait :129-164)."""

    def enqueue_task(self, key: TaskDescriptor) -> list:
        raise NotImplementedError

    def update_task_progress(
        self, key: TaskDescriptor, status: TaskStatus, proof: bytes | None = None
    ) -> None:
        raise NotImplementedError

    def get_task_proving_status(self, key: TaskDescriptor) -> list:
        """-> [(status, proof_or_None, timestamp)] oldest first."""
        raise NotImplementedError

    def get_task_proof(self, key: TaskDescriptor) -> bytes:
        raise NotImplementedError

    def get_db_size(self) -> int:
        raise NotImplementedError

    def prune_db(self) -> None:
        raise NotImplementedError

    def list_all_tasks(self) -> list:
        raise NotImplementedError

    # IdStore / IdWrite (ref :182-207)
    def store_id(self, key, id_: str) -> None:
        raise NotImplementedError

    def read_id(self, key) -> str | None:
        raise NotImplementedError

    def remove_id(self, key) -> None:
        raise NotImplementedError


class InMemoryTaskManager(TaskManager):
    """HashMap-backed (reference tasks/src/mem_db.rs)."""

    def __init__(self):
        self._tasks: dict[TaskDescriptor, list] = {}
        self._ids: dict = {}
        self._lock = threading.RLock()

    def enqueue_task(self, key):
        with self._lock:
            if key not in self._tasks:
                self._tasks[key] = [
                    (TaskStatus.REGISTERED, None, int(time.time()))
                ]
            return list(self._tasks[key])

    def update_task_progress(self, key, status, proof=None):
        with self._lock:
            history = self._tasks.setdefault(key, [])
            if history and history[-1][0] == status:
                return  # append only on change (ref mem_db.rs:60-77)
            history.append((status, proof, int(time.time())))

    def get_task_proving_status(self, key):
        with self._lock:
            return list(self._tasks.get(key, []))

    def get_task_proof(self, key):
        with self._lock:
            for status, proof, _ in reversed(self._tasks.get(key, [])):
                if status == TaskStatus.SUCCESS and proof is not None:
                    return proof
            raise KeyError("no proof for task")

    def get_db_size(self) -> int:
        with self._lock:
            return sum(
                len(p or b"") for h in self._tasks.values() for _, p, _ in h
            )

    def prune_db(self):
        with self._lock:
            self._tasks.clear()
            self._ids.clear()

    def list_all_tasks(self):
        with self._lock:
            out = []
            for key, history in self._tasks.items():
                if history:
                    out.append((key, history[-1][0]))
            return out

    def store_id(self, key, id_):
        with self._lock:
            self._ids[key] = id_

    def read_id(self, key):
        with self._lock:
            return self._ids.get(key)

    def remove_id(self, key):
        with self._lock:
            self._ids.pop(key, None)


def get_task_manager(sqlite_path: str | None = None, max_db_size: int = 0) -> TaskManager:
    """Backend selection (reference TaskManagerWrapper :210-219):
    sqlite when a path is configured, in-memory otherwise."""
    if sqlite_path:
        from .sqlite_db import SqliteTaskManager

        return SqliteTaskManager(sqlite_path, max_db_size)
    return InMemoryTaskManager()
