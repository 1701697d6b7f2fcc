"""Client state persistence (reference: client/state + helper/boltdd).

Upstream persists alloc/task-runner state in boltdb so a restarted agent
re-adopts live tasks. Here: one sqlite3 file per client data dir with the
same contract — `put_allocation`, `put_task_handle`, `get_all`, pruning on
alloc GC.
"""

from __future__ import annotations

import json
import os
import sqlite3
import threading
from typing import Dict, List, Tuple

from .drivers.base import TaskHandle


class StateDB:
    def __init__(self, data_dir: str = "") -> None:
        self._lock = threading.Lock()
        self._closed = False
        if data_dir:
            os.makedirs(data_dir, exist_ok=True)
            path = os.path.join(data_dir, "client_state.db")
        else:
            path = ":memory:"
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS allocs "
            "(id TEXT PRIMARY KEY, body TEXT)")
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS task_handles "
            "(alloc_id TEXT, task TEXT, body TEXT, "
            "PRIMARY KEY (alloc_id, task))")
        self._db.commit()

    def put_allocation(self, alloc) -> None:
        body = json.dumps({
            "id": alloc.id, "job_id": alloc.job_id,
            "namespace": alloc.namespace,
            "task_group": alloc.task_group,
            "desired_status": alloc.desired_status,
            "client_status": alloc.client_status,
        })
        with self._lock:
            if self._closed:
                return
            self._db.execute(
                "INSERT OR REPLACE INTO allocs VALUES (?, ?)",
                (alloc.id, body))
            self._db.commit()

    def put_task_handle(self, alloc_id: str, task: str,
                        handle: TaskHandle) -> None:
        body = json.dumps({
            "task_id": handle.task_id, "driver": handle.driver,
            "pid": handle.pid, "started_at": handle.started_at,
            "driver_state": handle.driver_state,
        })
        with self._lock:
            if self._closed:
                return
            self._db.execute(
                "INSERT OR REPLACE INTO task_handles VALUES (?, ?, ?)",
                (alloc_id, task, body))
            self._db.commit()

    def get_allocations(self) -> List[Dict]:
        with self._lock:
            if self._closed:
                return []
            rows = self._db.execute("SELECT body FROM allocs").fetchall()
        return [json.loads(r[0]) for r in rows]

    def get_task_handles(self, alloc_id: str) -> Dict[str, TaskHandle]:
        with self._lock:
            if self._closed:
                return {}
            rows = self._db.execute(
                "SELECT task, body FROM task_handles WHERE alloc_id=?",
                (alloc_id,)).fetchall()
        out = {}
        for task, body in rows:
            d = json.loads(body)
            out[task] = TaskHandle(task_id=d["task_id"], driver=d["driver"],
                                   pid=d["pid"], started_at=d["started_at"],
                                   driver_state=d["driver_state"])
        return out

    def delete_allocation(self, alloc_id: str) -> None:
        with self._lock:
            if self._closed:
                return
            self._db.execute("DELETE FROM allocs WHERE id=?", (alloc_id,))
            self._db.execute(
                "DELETE FROM task_handles WHERE alloc_id=?", (alloc_id,))
            self._db.commit()

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._db.close()
