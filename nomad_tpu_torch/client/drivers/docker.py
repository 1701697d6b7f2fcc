"""Docker driver (reference: drivers/docker) — containers via the docker
CLI (the reference uses the docker SDK against the same daemon).

Task config: {"image": str, "command": str?, "args": [...],
"ports": {"label": container_port}?, "network_mode": str?}.
Fingerprints absent when no docker binary/daemon is reachable, exactly
like the reference's fingerprint loop."""

from __future__ import annotations

import json
import shutil
import subprocess
import time
from typing import Dict, Optional

from .base import (
    Driver,
    DriverCapabilities,
    DriverError,
    TaskHandle,
    TaskResult,
)


def _docker(*args, timeout: float = 30.0) -> subprocess.CompletedProcess:
    return subprocess.run(["docker", *args], capture_output=True,
                          text=True, timeout=timeout)


class DockerDriver(Driver):
    name = "docker"

    def __init__(self) -> None:
        self._available: Optional[bool] = None
        self._server_version = ""
        self._last_poll: Dict[str, float] = {}

    def available(self) -> bool:
        if self._available is None:
            ok = shutil.which("docker") is not None
            if ok:
                try:
                    v = _docker("version", "--format",
                                "{{.Server.Version}}", timeout=5)
                    ok = v.returncode == 0
                    if ok:
                        self._server_version = v.stdout.strip()
                except (subprocess.TimeoutExpired, OSError):
                    ok = False
            self._available = ok
        return self._available

    def fingerprint(self) -> Dict[str, str]:
        if not self.available():
            return {}
        out = {"driver.docker": "1"}
        if self._server_version:       # cached by available()'s probe
            out["driver.docker.version"] = self._server_version
        return out

    def capabilities(self) -> DriverCapabilities:
        return DriverCapabilities(send_signals=True, exec_=True,
                                  fs_isolation="image")

    def start_task(self, task_id, task, env, task_dir) -> TaskHandle:
        cfg = task.config or {}
        image = cfg.get("image")
        if not image:
            raise DriverError("docker: config.image required")
        import uuid
        # unique suffix: task restarts reuse the task_id, and a name
        # collision with the previous (exited) container would fail every
        # restart attempt
        name = f"nomad-{task_id}-{uuid.uuid4().hex[:8]}"
        cmd = ["run", "-d", "--name", name]
        if task_dir:
            # the prestart hooks (artifacts/templates) populate task_dir
            # on the host; mount it at the same path so NOMAD_TASK_DIR
            # resolves inside the container
            cmd += ["-v", f"{task_dir}:{task_dir}"]
        for k, v in env.items():
            cmd += ["-e", f"{k}={v}"]
        if task.resources.cpu:
            cmd += ["--cpu-shares", str(task.resources.cpu)]
        if task.resources.memory_mb:
            cmd += ["--memory", f"{task.resources.memory_mb}m"]
        if cfg.get("network_mode"):
            cmd += ["--network", str(cfg["network_mode"])]
        for label, cport in (cfg.get("ports") or {}).items():
            hport = env.get(f"NOMAD_HOST_PORT_{label}", "")
            if hport:
                cmd += ["-p", f"{hport}:{cport}"]
        cmd.append(image)
        if cfg.get("command"):
            cmd.append(str(cfg["command"]))
        cmd += [str(a) for a in cfg.get("args", [])]
        try:
            r = _docker(*cmd, timeout=120)
        except (subprocess.TimeoutExpired, OSError) as e:
            raise DriverError(f"docker run: {e}") from e
        if r.returncode != 0:
            raise DriverError(f"docker run: {r.stderr.strip()}")
        cid = r.stdout.strip()
        return TaskHandle(task_id=task_id, driver=self.name,
                          driver_state={"container_id": cid})

    def _inspect(self, cid: str) -> Optional[Dict]:
        try:
            r = _docker("inspect", cid, timeout=10)
        except (subprocess.TimeoutExpired, OSError):
            return None
        if r.returncode != 0:
            return None
        data = json.loads(r.stdout)
        return data[0] if data else None

    def exec_task(self, handle, cmd, timeout: float = 30.0):
        cid = handle.driver_state.get("container_id", "")
        if not cid:
            raise DriverError("no container for exec")
        try:
            r = subprocess.run(["docker", "exec", cid] + list(cmd),
                               capture_output=True, timeout=timeout)
        except subprocess.TimeoutExpired as e:
            partial = ((e.stdout or b"") + (e.stderr or b""))[-2048:]
            # killing the local docker-exec client does NOT reap the
            # in-container process; say so instead of pretending
            raise DriverError(
                "exec timed out (the in-container process may still be "
                "running); partial output: "
                + partial.decode(errors="replace"))
        except OSError as e:
            raise DriverError(f"docker exec failed: {e}")
        return r.stdout + r.stderr, r.returncode

    def wait_task(self, handle, timeout=None) -> Optional[TaskResult]:
        cid = handle.driver_state.get("container_id", "")
        deadline = None if timeout is None else time.time() + timeout
        while True:
            # throttle: the runner polls wait_task(0.25) in a tight loop;
            # one `docker inspect` subprocess per ~1s per task is plenty
            last = self._last_poll.get(cid, 0.0)
            now = time.time()
            if now - last < 1.0:
                if deadline is not None and now >= deadline:
                    return None
                time.sleep(min(0.25, max(deadline - now, 0.01))
                           if deadline is not None else 0.25)
                continue
            self._last_poll[cid] = now
            info = self._inspect(cid)
            if info is None:
                self._last_poll.pop(cid, None)
                return TaskResult(err="container not found")
            state = info.get("State", {})
            if not state.get("Running", False):
                self._last_poll.pop(cid, None)
                return TaskResult(exit_code=int(state.get("ExitCode", 0)))
            if deadline is not None and time.time() >= deadline:
                return None

    def stop_task(self, handle, kill_timeout: float = 5.0) -> None:
        cid = handle.driver_state.get("container_id", "")
        try:
            _docker("stop", "-t", str(int(max(kill_timeout, 0))), cid,
                    timeout=kill_timeout + 30)
        except (subprocess.TimeoutExpired, OSError):
            pass

    def destroy_task(self, handle) -> None:
        cid = handle.driver_state.get("container_id", "")
        try:
            _docker("rm", "-f", cid, timeout=30)
        except (subprocess.TimeoutExpired, OSError):
            pass

    def signal_task(self, handle, signal_num: int) -> None:
        cid = handle.driver_state.get("container_id", "")
        try:
            r = _docker("kill", "--signal", str(signal_num), cid,
                        timeout=10)
        except (subprocess.TimeoutExpired, OSError) as e:
            raise DriverError(f"docker kill: {e}") from e
        if r.returncode != 0:
            raise DriverError(f"docker kill: {r.stderr.strip()}")

    def recover_task(self, handle) -> bool:
        info = self._inspect(handle.driver_state.get("container_id", ""))
        return bool(info and info.get("State", {}).get("Running"))
