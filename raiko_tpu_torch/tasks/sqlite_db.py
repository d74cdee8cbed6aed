"""SQLite task-DB backend (reference tasks/src/adv_sqlite.rs).

Schema modeled on the reference (:230-330): normalized tasks /
task_status / task_proofs tables keyed by (chain_id, blockhash,
proof_system, prover), append-only status history, stored prover-session
ids, plus a db-size guard."""

from __future__ import annotations

import os
import sqlite3
import threading
import time

from .manager import TaskDescriptor, TaskManager, TaskStatus

_SCHEMA = """
CREATE TABLE IF NOT EXISTS tasks (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  chain_id INTEGER NOT NULL,
  blockhash BLOB NOT NULL,
  proofsys TEXT NOT NULL,
  prover TEXT NOT NULL,
  UNIQUE (chain_id, blockhash, proofsys, prover)
);
CREATE TABLE IF NOT EXISTS task_status (
  task_id INTEGER NOT NULL REFERENCES tasks(id),
  status INTEGER NOT NULL,
  created_at INTEGER NOT NULL
);
CREATE TABLE IF NOT EXISTS task_proofs (
  task_id INTEGER NOT NULL UNIQUE REFERENCES tasks(id),
  proof BLOB NOT NULL
);
CREATE TABLE IF NOT EXISTS store_ids (
  chain_id INTEGER NOT NULL,
  blockhash BLOB NOT NULL,
  proofsys TEXT NOT NULL,
  session_id TEXT NOT NULL,
  UNIQUE (chain_id, blockhash, proofsys)
);
CREATE INDEX IF NOT EXISTS idx_status_task ON task_status(task_id);
"""


class SqliteTaskManager(TaskManager):
    def __init__(self, path: str, max_db_size: int = 0):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self.max_db_size = max_db_size
        self._lock = threading.RLock()
        self._conn = sqlite3.connect(path, check_same_thread=False)
        with self._lock:
            self._conn.executescript(_SCHEMA)
            self._conn.commit()

    def _task_id(self, key: TaskDescriptor, create: bool = False):
        cur = self._conn.execute(
            "SELECT id FROM tasks WHERE chain_id=? AND blockhash=? AND proofsys=? AND prover=?",
            (key.chain_id, key.blockhash, key.proof_system, key.prover),
        )
        row = cur.fetchone()
        if row:
            return row[0]
        if not create:
            return None
        cur = self._conn.execute(
            "INSERT INTO tasks (chain_id, blockhash, proofsys, prover) VALUES (?,?,?,?)",
            (key.chain_id, key.blockhash, key.proof_system, key.prover),
        )
        return cur.lastrowid

    def enqueue_task(self, key):
        with self._lock:
            tid = self._task_id(key, create=True)
            cur = self._conn.execute(
                "SELECT status, created_at FROM task_status WHERE task_id=? ORDER BY rowid",
                (tid,),
            )
            history = cur.fetchall()
            if not history:
                now = int(time.time())
                self._conn.execute(
                    "INSERT INTO task_status VALUES (?,?,?)",
                    (tid, int(TaskStatus.REGISTERED), now),
                )
                self._conn.commit()
                return [(TaskStatus.REGISTERED, None, now)]
            return [(TaskStatus(s), None, t) for s, t in history]

    def update_task_progress(self, key, status, proof=None):
        with self._lock:
            tid = self._task_id(key, create=True)
            cur = self._conn.execute(
                "SELECT status FROM task_status WHERE task_id=? ORDER BY rowid DESC LIMIT 1",
                (tid,),
            )
            row = cur.fetchone()
            if row is None or row[0] != int(status):
                self._conn.execute(
                    "INSERT INTO task_status VALUES (?,?,?)",
                    (tid, int(status), int(time.time())),
                )
            if proof is not None:
                self._conn.execute(
                    "INSERT OR REPLACE INTO task_proofs VALUES (?,?)", (tid, proof)
                )
            self._conn.commit()

    def get_task_proving_status(self, key):
        with self._lock:
            tid = self._task_id(key)
            if tid is None:
                return []
            cur = self._conn.execute(
                "SELECT status, created_at FROM task_status WHERE task_id=? ORDER BY rowid",
                (tid,),
            )
            return [(TaskStatus(s), None, t) for s, t in cur.fetchall()]

    def get_task_proof(self, key):
        with self._lock:
            tid = self._task_id(key)
            if tid is not None:
                cur = self._conn.execute(
                    "SELECT proof FROM task_proofs WHERE task_id=?", (tid,)
                )
                row = cur.fetchone()
                if row:
                    return row[0]
            raise KeyError("no proof for task")

    def get_db_size(self) -> int:
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0

    def prune_db(self):
        with self._lock:
            for t in ("task_status", "task_proofs", "tasks", "store_ids"):
                self._conn.execute(f"DELETE FROM {t}")
            self._conn.commit()

    def list_all_tasks(self):
        with self._lock:
            cur = self._conn.execute(
                """SELECT t.chain_id, t.blockhash, t.proofsys, t.prover, s.status
                   FROM tasks t JOIN task_status s ON s.task_id = t.id
                   WHERE s.rowid = (SELECT MAX(rowid) FROM task_status WHERE task_id = t.id)"""
            )
            return [
                (TaskDescriptor(c, b, ps, pr), TaskStatus(st))
                for c, b, ps, pr, st in cur.fetchall()
            ]

    def store_id(self, key, id_):
        with self._lock:
            chain_id, blockhash, proofsys = key
            self._conn.execute(
                "INSERT OR REPLACE INTO store_ids VALUES (?,?,?,?)",
                (chain_id, blockhash, proofsys, id_),
            )
            self._conn.commit()

    def read_id(self, key):
        with self._lock:
            chain_id, blockhash, proofsys = key
            cur = self._conn.execute(
                "SELECT session_id FROM store_ids WHERE chain_id=? AND blockhash=? AND proofsys=?",
                (chain_id, blockhash, proofsys),
            )
            row = cur.fetchone()
            return row[0] if row else None

    def remove_id(self, key):
        with self._lock:
            chain_id, blockhash, proofsys = key
            self._conn.execute(
                "DELETE FROM store_ids WHERE chain_id=? AND blockhash=? AND proofsys=?",
                (chain_id, blockhash, proofsys),
            )
            self._conn.commit()
