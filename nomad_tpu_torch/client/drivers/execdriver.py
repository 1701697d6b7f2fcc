"""exec driver (reference: drivers/exec + drivers/shared/executor).

Upstream isolates with chroot + cgroups + namespaces via a re-exec'd
executor subprocess (executor_linux.go). Without root we approximate the
same contract: a scrubbed environment, the task sandbox dir as cwd/HOME,
its own session+process group (so stop kills the whole tree), and rlimits.
The driver degrades explicitly rather than pretending: `fs_isolation`
reports "none" when not running as root.
"""

from __future__ import annotations

import os

from .base import DriverCapabilities, TaskHandle
from .rawexec import RawExecDriver

_SAFE_ENV = ("PATH", "TMPDIR", "LANG", "TZ")


class ExecDriver(RawExecDriver):
    name = "exec"

    def capabilities(self) -> DriverCapabilities:
        iso = "chroot" if os.geteuid() == 0 else "none"
        return DriverCapabilities(send_signals=True, exec_=True,
                                  fs_isolation=iso)

    def start_task(self, task_id, task, env, task_dir) -> TaskHandle:
        scrubbed = {k: v for k, v in os.environ.items() if k in _SAFE_ENV}
        scrubbed.update(env)
        if task_dir:
            scrubbed["HOME"] = task_dir
        proc = self._spawn(task_id, task, scrubbed, task_dir,
                           inherit_env=False)
        with self._lock:
            self._procs[task_id] = proc
        return TaskHandle(task_id=task_id, driver=self.name, pid=proc.pid)
