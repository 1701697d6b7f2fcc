"""Driver plugin contract (reference: plugins/drivers/driver.go
DriverPlugin interface)."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class DriverCapabilities:
    send_signals: bool = True
    exec_: bool = False
    fs_isolation: str = "none"     # none | chroot | image


@dataclass
class TaskResult:
    """reference: drivers.ExitResult"""
    exit_code: int = 0
    signal: int = 0
    oom_killed: bool = False
    err: Optional[str] = None

    def successful(self) -> bool:
        return self.exit_code == 0 and self.signal == 0 and self.err is None


@dataclass
class TaskHandle:
    """Opaque reattachable handle (reference: drivers.TaskHandle) —
    serializable so a restarted agent can re-adopt live tasks."""
    task_id: str
    driver: str
    pid: int = 0
    started_at: float = field(default_factory=time.time)
    driver_state: Dict = field(default_factory=dict)


class DriverError(Exception):
    pass


class Driver:
    """reference: drivers.DriverPlugin"""

    name = "base"

    def fingerprint(self) -> Dict[str, str]:
        """Attribute map merged into Node.attributes (driver.<name> = 1)."""
        return {f"driver.{self.name}": "1"}

    def capabilities(self) -> DriverCapabilities:
        return DriverCapabilities()

    def start_task(self, task_id: str, task, env: Dict[str, str],
                   task_dir: str) -> TaskHandle:
        raise NotImplementedError

    def wait_task(self, handle: TaskHandle,
                  timeout: Optional[float] = None) -> Optional[TaskResult]:
        """Block until the task exits (None on timeout)."""
        raise NotImplementedError

    def stop_task(self, handle: TaskHandle, kill_timeout: float = 5.0) -> None:
        raise NotImplementedError

    def destroy_task(self, handle: TaskHandle) -> None:
        self.stop_task(handle, 0)

    def inspect_task(self, handle: TaskHandle) -> Dict:
        return {"task_id": handle.task_id, "pid": handle.pid}

    def signal_task(self, handle: TaskHandle, signal_num: int) -> None:
        raise DriverError(f"driver {self.name} does not support signals")

    def exec_task(self, handle: TaskHandle, cmd, timeout: float = 30.0):
        """Run `cmd` (argv list) inside the task's context and return
        (combined output bytes, exit code) — the non-interactive form of
        the reference's DriverPlugin.ExecTask (`nomad alloc exec`)."""
        raise DriverError(f"driver {self.name} does not support exec")

    def open_exec(self, handle: TaskHandle, cmd):
        """Start `cmd` interactively inside the task's context and
        return an ExecStream (client/exec_session.py) carrying streamed
        combined output and writable stdin — the streaming form of the
        reference's ExecTaskStreaming behind `nomad alloc exec -i`."""
        raise DriverError(
            f"driver {self.name} does not support interactive exec")

    def recover_task(self, handle: TaskHandle) -> bool:
        """Reattach after agent restart. True if the task is still live."""
        return False
