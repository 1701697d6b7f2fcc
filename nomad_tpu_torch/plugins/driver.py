"""External task-driver plugins
(reference: plugins/drivers/ DriverPlugin gRPC service + client shim).

Two halves:

  * `serve_driver(driver)` — plugin-process side: wraps any object
    implementing the `client.drivers.base.Driver` contract and serves it
    over the plugin protocol (the analog of drivers.Serve).
  * `ExternalDriver` — host side: implements the same `Driver` contract
    backed by a PluginClient, so the client's task runners use external
    plugin drivers exactly like built-ins (the analog of the
    drivers.driverPluginClient shim).

Wire mapping: Task objects cross the boundary as their API-JSON wire form
(structs.codec), TaskHandle/TaskResult as flat dicts.
"""

from __future__ import annotations

from typing import Dict, Optional

from nomad_tpu_torch.client.drivers.base import (
    Driver,
    DriverCapabilities,
    DriverError,
    TaskHandle,
    TaskResult,
)
from nomad_tpu_torch.structs import Task, codec

from .base import PluginClient, serve


def _handle_to_wire(h: TaskHandle) -> Dict:
    return {"task_id": h.task_id, "driver": h.driver, "pid": h.pid,
            "started_at": h.started_at, "driver_state": h.driver_state}


def _handle_from_wire(d: Dict) -> TaskHandle:
    return TaskHandle(task_id=d["task_id"], driver=d["driver"],
                      pid=d.get("pid", 0),
                      started_at=d.get("started_at", 0.0),
                      driver_state=d.get("driver_state") or {})


def _result_to_wire(r: Optional[TaskResult]) -> Optional[Dict]:
    if r is None:
        return None
    return {"exit_code": r.exit_code, "signal": r.signal,
            "oom_killed": r.oom_killed, "err": r.err}


def _result_from_wire(d: Optional[Dict]) -> Optional[TaskResult]:
    if d is None:
        return None
    return TaskResult(exit_code=d.get("exit_code", 0),
                      signal=d.get("signal", 0),
                      oom_killed=d.get("oom_killed", False),
                      err=d.get("err"))


def serve_driver(driver: Driver) -> None:
    """Plugin-process entry point: serve `driver` over the protocol."""

    def start_task(task_id: str, task: Dict, env: Dict, task_dir: str):
        t = codec.decode(Task, task)
        return _handle_to_wire(driver.start_task(task_id, t, env, task_dir))

    def wait_task(handle: Dict, timeout_s: Optional[float] = None):
        return _result_to_wire(
            driver.wait_task(_handle_from_wire(handle), timeout_s))

    handlers = {
        "fingerprint": lambda: driver.fingerprint(),
        "capabilities": lambda: {
            "send_signals": driver.capabilities().send_signals,
            "exec": driver.capabilities().exec_,
            "fs_isolation": driver.capabilities().fs_isolation,
        },
        "start_task": start_task,
        "wait_task": wait_task,
        "stop_task": lambda handle, kill_timeout=5.0: driver.stop_task(
            _handle_from_wire(handle), kill_timeout),
        "destroy_task": lambda handle: driver.destroy_task(
            _handle_from_wire(handle)),
        "inspect_task": lambda handle: driver.inspect_task(
            _handle_from_wire(handle)),
        "signal_task": lambda handle, signal_num: driver.signal_task(
            _handle_from_wire(handle), signal_num),
        "recover_task": lambda handle: driver.recover_task(
            _handle_from_wire(handle)),
    }
    serve(handlers, {"type": "driver", "name": driver.name, "version": "1"})


class ExternalDriver(Driver):
    """Host-side Driver backed by a plugin process."""

    def __init__(self, client: PluginClient) -> None:
        self.client = client
        self.name = client.info.get("name", "external")

    def _call(self, method: str, timeout="__default__", **params):
        """timeout omitted -> the client's 60s default; timeout=None ->
        block until the plugin answers (wait_task only)."""
        try:
            return self.client.call(method, timeout=timeout, **params)
        except Exception as e:  # noqa: BLE001 - uniform driver errors
            raise DriverError(f"plugin driver {self.name}: {e}") from e

    def fingerprint(self) -> Dict[str, str]:
        if not self.client.alive():
            return {}
        try:
            fp = self._call("fingerprint", timeout=5.0)
        except DriverError:
            return {}
        return {str(k): str(v) for k, v in (fp or {}).items()}

    def capabilities(self) -> DriverCapabilities:
        c = self._call("capabilities", timeout=5.0) or {}
        return DriverCapabilities(
            send_signals=c.get("send_signals", False),
            exec_=c.get("exec", False),
            fs_isolation=c.get("fs_isolation", "none"))

    def start_task(self, task_id: str, task, env: Dict[str, str],
                   task_dir: str) -> TaskHandle:
        wire = codec.encode(task)
        return _handle_from_wire(self._call(
            "start_task", task_id=task_id, task=wire, env=env,
            task_dir=task_dir))

    def wait_task(self, handle: TaskHandle,
                  timeout: Optional[float] = None) -> Optional[TaskResult]:
        budget = None if timeout is None else timeout + 5.0
        return _result_from_wire(self._call(
            "wait_task", timeout=budget,
            handle=_handle_to_wire(handle), **(
                {"timeout_s": timeout} if timeout is not None else {})))

    def stop_task(self, handle: TaskHandle,
                  kill_timeout: float = 5.0) -> None:
        self._call("stop_task", timeout=kill_timeout + 5.0,
                   handle=_handle_to_wire(handle),
                   kill_timeout=kill_timeout)

    def destroy_task(self, handle: TaskHandle) -> None:
        self._call("destroy_task", handle=_handle_to_wire(handle))

    def inspect_task(self, handle: TaskHandle) -> Dict:
        return self._call("inspect_task", handle=_handle_to_wire(handle))

    def signal_task(self, handle: TaskHandle, signal_num: int) -> None:
        self._call("signal_task", handle=_handle_to_wire(handle),
                   signal_num=signal_num)

    def recover_task(self, handle: TaskHandle) -> bool:
        return bool(self._call("recover_task",
                               handle=_handle_to_wire(handle)))
