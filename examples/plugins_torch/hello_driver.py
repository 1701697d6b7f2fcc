#!/usr/bin/env python
"""Example external task driver plugin.

Drop this file in the agent's plugin_dir; the client discovers and
launches it as a subprocess (reference: an external driver binary built
against plugins/drivers).  Tasks run as plain subprocesses of THIS
process — the plugin owns its task lifecycles, the agent only speaks the
plugin protocol.

Jobspec usage:
    task "greet" {
      driver = "hello"
      config { message = "hi from an external plugin" }
    }
"""

import os
import signal
import subprocess
import time

from nomad_tpu_torch.client.drivers.base import (
    Driver,
    DriverError,
    TaskHandle,
    TaskResult,
)
from nomad_tpu_torch.plugins import serve_driver


class HelloDriver(Driver):
    name = "hello"

    def __init__(self):
        self.procs = {}

    def fingerprint(self):
        return {"driver.hello": "1", "driver.hello.version": "1.0"}

    def start_task(self, task_id, task, env, task_dir):
        msg = str(task.config.get("message", "hello"))
        secs = float(task.config.get("run_for_s", 0.2))
        proc = subprocess.Popen(
            ["/bin/sh", "-c",
             f"echo {msg!r}; sleep {secs}"],
            env={**os.environ, **env},
            cwd=task_dir or None,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        self.procs[task_id] = proc
        return TaskHandle(task_id=task_id, driver=self.name, pid=proc.pid)

    def wait_task(self, handle, timeout=None):
        proc = self.procs.get(handle.task_id)
        if proc is None:
            return TaskResult(err="unknown task")
        try:
            code = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            return None
        return TaskResult(exit_code=code if code >= 0 else 0,
                          signal=-code if code < 0 else 0)

    def stop_task(self, handle, kill_timeout=5.0):
        proc = self.procs.get(handle.task_id)
        if proc is None or proc.poll() is not None:
            return
        proc.terminate()
        try:
            proc.wait(timeout=kill_timeout)
        except subprocess.TimeoutExpired:
            proc.kill()

    def signal_task(self, handle, signal_num):
        proc = self.procs.get(handle.task_id)
        if proc is None or proc.poll() is not None:
            raise DriverError("task not running")
        proc.send_signal(signal_num)

    def recover_task(self, handle):
        return handle.task_id in self.procs \
            and self.procs[handle.task_id].poll() is None


if __name__ == "__main__":
    serve_driver(HelloDriver())
