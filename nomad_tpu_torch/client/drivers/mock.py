"""Mock driver (reference: drivers/mock) — configurable fake task
lifecycles for tests and fault injection, no processes involved.

Task config keys (all optional):
  run_for_s        how long the task "runs" before exiting (default 0)
  exit_code        exit code on completion (default 0)
  start_error      string -> start_task raises DriverError
  start_block_s    delay before start returns
  kill_after_s     task kills itself with `signal` after this long
  signal           signal number reported when kill_after fires
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from .base import Driver, DriverCapabilities, DriverError, TaskHandle, TaskResult


class _MockTask:
    def __init__(self, cfg: Dict):
        self.cfg = cfg
        self.done = threading.Event()
        self.result: Optional[TaskResult] = None
        self.timer: Optional[threading.Timer] = None

    def start(self):
        run_for = float(self.cfg.get("run_for_s", 0))
        kill_after = self.cfg.get("kill_after_s")
        if kill_after is not None and float(kill_after) < run_for:
            delay, res = float(kill_after), TaskResult(
                exit_code=0, signal=int(self.cfg.get("signal", 9)),
                err="killed")
        else:
            delay, res = run_for, TaskResult(
                exit_code=int(self.cfg.get("exit_code", 0)))
        self.timer = threading.Timer(delay, self._finish, args=(res,))
        self.timer.daemon = True
        self.timer.start()

    def _finish(self, res: TaskResult):
        self.result = res
        self.done.set()

    def kill(self, signal_num: int = 9):
        if self.timer:
            self.timer.cancel()
        if not self.done.is_set():
            self._finish(TaskResult(exit_code=137, signal=signal_num))


class MockDriver(Driver):
    name = "mock"

    def __init__(self):
        self._tasks: Dict[str, _MockTask] = {}
        self._lock = threading.Lock()

    def capabilities(self) -> DriverCapabilities:
        return DriverCapabilities(send_signals=True, exec_=True)

    def start_task(self, task_id, task, env, task_dir) -> TaskHandle:
        cfg = task.config or {}
        if cfg.get("start_error"):
            raise DriverError(str(cfg["start_error"]))
        if cfg.get("start_block_s"):
            time.sleep(float(cfg["start_block_s"]))
        mt = _MockTask(cfg)
        with self._lock:
            self._tasks[task_id] = mt
        mt.start()
        return TaskHandle(task_id=task_id, driver=self.name,
                          driver_state={"config": dict(cfg)})

    def exec_task(self, handle, cmd, timeout: float = 30.0):
        """Deterministic fake exec: echoes the argv (tests drive the
        alloc-exec plumbing without real processes)."""
        return ("exec:" + " ".join(cmd)).encode() + b"\n", 0

    def open_exec(self, handle, cmd):
        """Fake interactive shell: prompts, echoes each stdin line back
        as `you said: <line>`, exits 0 on `exit` (tests drive the full
        bidirectional session plumbing without real processes)."""
        from nomad_tpu_torch.client.exec_session import ExecStream

        class _FakeShell(ExecStream):
            def __init__(self):
                import queue
                self._out = queue.Queue()
                self._out.put(b"mock-shell$ ")
                self._pending = b""
                self._code = None

            def read(self, max_bytes: int = 4096) -> bytes:
                import queue
                while True:
                    try:
                        item = self._out.get(timeout=0.5)
                    except queue.Empty:
                        if self._code is not None:
                            return b""
                        continue
                    if item is None:
                        return b""
                    return item

            def write_stdin(self, data: bytes) -> None:
                self._pending += data
                while b"\n" in self._pending:
                    line, self._pending = self._pending.split(b"\n", 1)
                    line = line.strip()
                    if line == b"exit":
                        self._code = 0
                        self._out.put(None)
                    elif line:
                        self._out.put(b"you said: " + line
                                      + b"\nmock-shell$ ")

            def close_stdin(self) -> None:
                if self._code is None:
                    self._code = 0
                self._out.put(None)

            def exit_code(self):
                return self._code

            def terminate(self) -> None:
                self._code = 137 if self._code is None else self._code
                self._out.put(None)

        return _FakeShell()

    def wait_task(self, handle, timeout=None) -> Optional[TaskResult]:
        mt = self._tasks.get(handle.task_id)
        if mt is None:
            return TaskResult(err="unknown task")
        if not mt.done.wait(timeout):
            return None
        return mt.result

    def stop_task(self, handle, kill_timeout: float = 5.0) -> None:
        mt = self._tasks.get(handle.task_id)
        if mt is not None:
            mt.kill()

    def signal_task(self, handle, signal_num: int) -> None:
        mt = self._tasks.get(handle.task_id)
        if mt is not None:
            mt.kill(signal_num)

    def recover_task(self, handle) -> bool:
        # mock tasks don't survive process restarts; restart them
        task_cfg = handle.driver_state.get("config", {})
        mt = _MockTask(task_cfg)
        with self._lock:
            self._tasks[handle.task_id] = mt
        mt.start()
        return True
