"""raw_exec driver (reference: drivers/rawexec) — fork/exec with no
isolation. Task config: {"command": str, "args": [str, ...]}."""

from __future__ import annotations

import os
import signal as _signal
import subprocess
import threading
from typing import Dict, Optional

from .base import Driver, DriverCapabilities, DriverError, TaskHandle, TaskResult


def _proc_stat(pid: int):
    """(state, start_ticks) from /proc/<pid>/stat; (None, None) if gone.
    start_ticks (field 22) is the pid-reuse discriminator; state 'Z'/'X'
    means the process is dead even though the pid still answers kill(0)
    (zombies awaiting a reap)."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            stat = f.read()
        # comm can contain spaces/parens: fields resume after the last ')'
        fields = stat[stat.rfind(b")") + 2:].split()
        return fields[0].decode(), int(fields[19])
    except (OSError, IndexError, ValueError):
        return None, None


def _proc_start_ticks(pid: int):
    return _proc_stat(pid)[1]


class RawExecDriver(Driver):
    name = "raw_exec"

    def __init__(self):
        self._procs: Dict[str, subprocess.Popen] = {}
        self._lock = threading.Lock()

    def open_exec(self, handle, cmd):
        """Interactive exec: `cmd` spawned in the task's live working
        directory with piped stdio (the streaming form of exec_task
        above; same sandbox/pid-reuse guards)."""
        from nomad_tpu_torch.client.exec_session import PopenExecStream
        if not self._same_process(handle):
            raise DriverError("task process not available for exec")
        try:
            cwd = os.readlink(f"/proc/{handle.pid}/cwd")
        except OSError:
            raise DriverError("task process not available for exec")
        try:
            proc = subprocess.Popen(
                list(cmd), cwd=cwd, stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                start_new_session=True)
        except OSError as e:
            raise DriverError(f"exec failed: {e}")
        return PopenExecStream(proc)

    def capabilities(self) -> DriverCapabilities:
        return DriverCapabilities(send_signals=True, exec_=True)

    def _spawn(self, task_id, task, env, task_dir,
               inherit_env: bool = True) -> subprocess.Popen:
        cfg = task.config or {}
        command = cfg.get("command")
        if not command:
            raise DriverError(f"{self.name}: config.command required")
        args = [command] + list(cfg.get("args", []))
        final_env = {**os.environ, **env} if inherit_env else env
        stdout = open(os.path.join(task_dir, f"{task.name}.stdout"), "ab") \
            if task_dir else subprocess.DEVNULL
        stderr = open(os.path.join(task_dir, f"{task.name}.stderr"), "ab") \
            if task_dir else subprocess.DEVNULL
        try:
            return subprocess.Popen(
                args, env=final_env, cwd=task_dir or None,
                stdout=stdout, stderr=stderr,
                start_new_session=True)
        except OSError as e:
            raise DriverError(f"{self.name}: {e}") from e
        finally:
            for fh in (stdout, stderr):
                if hasattr(fh, "close"):
                    fh.close()

    def start_task(self, task_id, task, env, task_dir) -> TaskHandle:
        proc = self._spawn(task_id, task, env, task_dir)
        with self._lock:
            self._procs[task_id] = proc
        return TaskHandle(task_id=task_id, driver=self.name, pid=proc.pid,
                          driver_state={
                              "proc_start": _proc_start_ticks(proc.pid)})

    def exec_task(self, handle, cmd, timeout: float = 30.0):
        """Non-interactive exec inside the live task's working directory
        (its sandbox) — reference: DriverPlugin.ExecTask backing
        `nomad alloc exec`."""
        # the task's live working directory IS the sandbox: refusing on
        # an unreadable cwd (exited task) beats silently running the
        # command in the agent's own cwd — and the pid-reuse check keeps
        # a RECYCLED pid (whose /proc entry is readable but belongs to a
        # stranger) from leaking an arbitrary directory
        if not self._same_process(handle):
            raise DriverError("task process not available for exec")
        try:
            cwd = os.readlink(f"/proc/{handle.pid}/cwd")
        except OSError:
            raise DriverError("task process not available for exec")
        try:
            r = subprocess.run(list(cmd), cwd=cwd, capture_output=True,
                               timeout=timeout)
        except subprocess.TimeoutExpired as e:
            partial = ((e.stdout or b"") + (e.stderr or b""))[-2048:]
            raise DriverError(
                "exec timed out; partial output: "
                + partial.decode(errors="replace"))
        except OSError as e:
            raise DriverError(f"exec failed: {e}")
        return r.stdout + r.stderr, r.returncode

    def wait_task(self, handle, timeout=None) -> Optional[TaskResult]:
        proc = self._procs.get(handle.task_id)
        if proc is None:
            if handle.pid:
                # reattached after agent restart: the pid is not our
                # child, so poll liveness instead of wait() (reference:
                # executor reattach).  PermissionError means the pid was
                # recycled to another user's process: OUR task is gone.
                # The exit code is unknowable for a non-child; report it
                # via `err` so restart/reschedule policy treats the exit
                # as a failure rather than silently as success.
                import time as _time
                deadline = (None if timeout is None
                            else _time.time() + timeout)
                while True:
                    if not self._same_process(handle):
                        return TaskResult(
                            exit_code=0,
                            err="exit status unknown (reattached task)")
                    if deadline is not None and _time.time() >= deadline:
                        return None
                    _time.sleep(0.1)
            return TaskResult(err="unknown task")
        try:
            rc = proc.wait(timeout)
        except subprocess.TimeoutExpired:
            return None
        if rc < 0:
            return TaskResult(exit_code=128 - rc, signal=-rc)
        return TaskResult(exit_code=rc)

    def stop_task(self, handle, kill_timeout: float = 5.0) -> None:
        proc = self._procs.get(handle.task_id)
        if proc is None:
            # reattached task: TERM the group, wait out kill_timeout,
            # escalate to KILL — same guarantee as the child path
            if handle.pid and self._same_process(handle):
                import time as _time
                try:
                    os.killpg(os.getpgid(handle.pid), _signal.SIGTERM)
                except (ProcessLookupError, PermissionError):
                    return
                deadline = _time.time() + kill_timeout
                while _time.time() < deadline:
                    if not self._same_process(handle):
                        return
                    _time.sleep(0.05)
                try:
                    os.killpg(os.getpgid(handle.pid), _signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pass
            return
        if proc.poll() is not None:
            return
        try:
            os.killpg(os.getpgid(proc.pid), _signal.SIGTERM)
            proc.wait(kill_timeout)
        except (subprocess.TimeoutExpired, ProcessLookupError):
            try:
                os.killpg(os.getpgid(proc.pid), _signal.SIGKILL)
            except ProcessLookupError:
                pass

    def signal_task(self, handle, signal_num: int) -> None:
        proc = self._procs.get(handle.task_id)
        if proc is not None and proc.poll() is None:
            proc.send_signal(signal_num)

    def _same_process(self, handle) -> bool:
        """The persisted pid still refers to OUR live process: running
        (not a zombie) AND the kernel start time matches what start_task
        recorded (a recycled pid has a different start tick)."""
        state, ticks = _proc_stat(handle.pid)
        if state is None or state in ("Z", "X"):
            return False
        recorded = handle.driver_state.get("proc_start")
        if recorded is None:
            return True           # pre-upgrade handle: best effort
        return ticks == recorded

    def recover_task(self, handle) -> bool:
        """Re-adopt a live pid after agent restart (reference: executor
        reattach).  Rejects recycled pids via the recorded process start
        time — adopting (and later killing) an unrelated process would be
        far worse than restarting the task."""
        return self._same_process(handle)
