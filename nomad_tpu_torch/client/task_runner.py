"""Task runner (reference: client/allocrunner/taskrunner/task_runner.go).

Per-task lifecycle state machine: prestart hooks → driver StartTask → wait →
restart decision loop → dead. Emits TaskEvents into a TaskState that the
alloc runner aggregates and ships to the server.
"""

from __future__ import annotations

import os
import re
import threading
import time
from typing import Callable, Dict, List, Optional

from nomad_tpu_torch.structs import (
    Task,
    TaskEvent,
    TaskState,
    TASK_DRIVER_FAILURE,
    TASK_KILLED,
    TASK_KILLING,
    TASK_NOT_RESTARTING,
    TASK_RECEIVED,
    TASK_RESTARTING,
    TASK_SETUP,
    TASK_STARTED,
    TASK_STATE_DEAD,
    TASK_STATE_PENDING,
    TASK_STATE_RUNNING,
    TASK_TERMINATED,
)

from .drivers.base import Driver, DriverError, TaskHandle
from .restarts import KILL, RESTART, RestartTracker, WAIT
from .taskenv import build_task_env


class TaskHook:
    """reference: taskrunner hooks (artifact, template, logmon, …)."""
    name = "hook"

    def prestart(self, runner: "TaskRunner") -> None:  # may raise
        pass

    def poststart(self, runner: "TaskRunner") -> None:
        pass

    def stop(self, runner: "TaskRunner") -> None:
        pass


class ArtifactHook(TaskHook):
    """reference: taskrunner/artifact_hook.go — fetches task.artifacts.
    Only file:// sources are supported offline; anything else errors the
    same way a failed download would."""
    name = "artifact"

    def prestart(self, runner: "TaskRunner") -> None:
        import shutil
        for art in runner.task.artifacts:
            src = art.get("source", "") if isinstance(art, dict) else art
            if src.startswith("file://"):
                path = src[len("file://"):]
                dest = os.path.join(runner.task_dir,
                                    os.path.basename(path))
                shutil.copyfile(path, dest)
            elif src:
                raise DriverError(f"artifact fetch unsupported: {src}")


class SecretsHook(TaskHook):
    """The Vault-analog secrets plane (reference: vault_hook.go + the
    template runner's secret renders): template data may reference
    secrets as ``${nomad_var.<path>#<key>}``; this hook resolves every
    referenced path through the client's SecretsProvider using the
    task's WORKLOAD IDENTITY (NOMAD_TOKEN) and injects the values into
    the task env so TemplateHook's interpolation substitutes them.  A
    missing or denied secret fails the task setup — exactly like a
    failed Vault token derivation in the reference — so a task never
    starts with an unrendered secret."""
    name = "secrets"
    PATTERN = re.compile(r"\$\{nomad_var\.([^}#]+)#([^}]+)\}")

    def prestart(self, runner: "TaskRunner") -> None:
        provider = runner.secrets_provider
        refs = {}
        for tpl in runner.task.templates:
            for m in self.PATTERN.finditer(tpl.get("data", "")):
                refs.setdefault(m.group(1), set()).add(m.group(2))
        if not refs:
            return
        if provider is None:
            raise DriverError(
                "template references nomad_var secrets but the client "
                "has no secrets provider")
        token = runner.env.get("NOMAD_TOKEN", "")
        ns = runner.alloc.namespace
        for path, keys in refs.items():
            items = provider.fetch(ns, path, token)
            if items is None:
                raise DriverError(f"secret {path!r} does not exist")
            for key in keys:
                if key not in items:
                    raise DriverError(
                        f"secret {path!r} has no key {key!r}")
                # secret_env, NOT env: the task env is handed verbatim to
                # drivers (docker argv, /proc/<pid>/environ) — secrets
                # exist only for the template render
                runner.secret_env[f"nomad_var.{path}#{key}"] = items[key]


class TemplateHook(TaskHook):
    """reference: taskrunner/template_hook.go — renders task.templates
    with ${...} interpolation against the task env."""
    name = "template"

    def prestart(self, runner: "TaskRunner") -> None:
        from .taskenv import interpolate
        # secrets join the render context only — never the driver env
        ctx = ({**runner.env, **runner.secret_env}
               if runner.secret_env else runner.env)
        for tpl in runner.task.templates:
            data = tpl.get("data", "")
            dest = tpl.get("destination", "")
            if not dest:
                continue
            path = os.path.join(runner.task_dir, dest)
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "w") as f:
                f.write(interpolate(data, ctx, runner.node))


class DispatchPayloadHook(TaskHook):
    """reference: taskrunner/dispatch_hook.go — writes the dispatch
    payload of parameterized jobs into the task dir."""
    name = "dispatch_payload"

    def prestart(self, runner: "TaskRunner") -> None:
        job = runner.alloc.job
        payload = getattr(job, "payload", None) if job else None
        dest_file = getattr(runner.task, "dispatch_payload_file", "")
        if payload and dest_file:
            path = os.path.join(runner.task_dir, dest_file)
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            mode = "wb" if isinstance(payload, bytes) else "w"
            with open(path, mode) as f:
                f.write(payload)


DEFAULT_HOOKS = (ArtifactHook, SecretsHook, TemplateHook,
                 DispatchPayloadHook)


class TaskRunner:
    def __init__(self, alloc, task: Task, driver: Driver, node,
                 task_dir: str = "", is_batch: bool = False,
                 on_state_change: Optional[Callable] = None,
                 update_interval: float = 0.0,
                 restore_handle: Optional[TaskHandle] = None,
                 on_handle: Optional[Callable] = None,
                 device_reserver: Optional[Callable] = None,
                 identity_fetcher: Optional[Callable] = None,
                 secrets_provider=None) -> None:
        self.alloc = alloc
        self.task = task
        self.driver = driver
        self.node = node
        self.task_dir = task_dir
        self.state = TaskState()
        self.restart_tracker = RestartTracker(
            self._policy(), is_batch=is_batch)
        self.on_state_change = on_state_change
        # agent-restart adoption: a persisted handle to recover instead of
        # starting a fresh task (reference: task runner handle reattach)
        self.restore_handle = restore_handle
        self.on_handle = on_handle
        self.device_reserver = device_reserver
        self.identity_fetcher = identity_fetcher
        self.secrets_provider = secrets_provider
        self.handle: Optional[TaskHandle] = None
        self.env: Dict[str, str] = {}
        # template-render-only values (secrets); never reaches drivers
        self.secret_env: Dict[str, str] = {}
        self.hooks: List[TaskHook] = [h() for h in DEFAULT_HOOKS]
        self._kill = threading.Event()
        self._restart_requested = False
        self._skip_delay = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.dead = threading.Event()

    def _policy(self):
        from nomad_tpu_torch.structs import RestartPolicy
        tg = None
        if self.alloc.job is not None:
            tg = self.alloc.job.lookup_task_group(self.alloc.task_group)
        if tg is not None and tg.restart_policy is not None:
            return tg.restart_policy
        return RestartPolicy()

    # ------------------------------------------------------------- events

    def _event(self, type_: str, **kw) -> None:
        self.state.events.append(TaskEvent(type=type_, time=time.time(), **kw))
        if self.on_state_change:
            self.on_state_change(self)

    def _set_state(self, state: str, failed: Optional[bool] = None) -> None:
        self.state.state = state
        if failed is not None:
            self.state.failed = failed
        if state == TASK_STATE_RUNNING and self.state.started_at == 0:
            self.state.started_at = time.time()
        if state == TASK_STATE_DEAD:
            self.state.finished_at = time.time()
            self.dead.set()
        if self.on_state_change:
            self.on_state_change(self)

    # -------------------------------------------------------------- run

    def start(self) -> None:
        self._thread = threading.Thread(target=self.run, daemon=True,
                                        name=f"task-{self.task.name}")
        self._thread.start()

    def abandon(self) -> None:
        """Exit the runner WITHOUT touching the workload (agent going
        down while tasks keep running, to be re-adopted on restart —
        reference: the restore path's counterpart)."""
        self.handle = None
        self._kill.set()

    def run(self) -> None:
        self._event(TASK_RECEIVED)
        try:
            if self.task_dir:
                os.makedirs(self.task_dir, exist_ok=True)
            self.env = build_task_env(self.alloc, self.task, self.node,
                                      self.task_dir)
            if self.identity_fetcher is not None:
                # workload identity (reference: identity_hook.go): the
                # task's signed identity rides NOMAD_TOKEN; failures
                # degrade to no token, never a dead task
                try:
                    tok = self.identity_fetcher(
                        self.alloc.id).get(self.task.name)
                    if tok:
                        self.env["NOMAD_TOKEN"] = tok
                except Exception:  # noqa: BLE001 - best-effort
                    pass
            if self.device_reserver and self.alloc.allocated_devices:
                # device plugin reserve(): plugin-specific env (e.g.
                # ACME_VISIBLE_DEVICES) layered over the generic
                # NOMAD_DEVICE_* exposure (reference: device_hook.go)
                self.env.update(self.device_reserver(
                    self.alloc.allocated_devices, self.task.name))
            self._event(TASK_SETUP)
            for hook in self.hooks:
                hook.prestart(self)
        except Exception as e:
            self._event(TASK_DRIVER_FAILURE, message=str(e))
            self._set_state(TASK_STATE_DEAD, failed=True)
            return

        try:
            self._run_loop()
        except Exception as e:
            # anything a driver leaks past DriverError (bad config types,
            # fs errors opening log files, …) must still land the task in
            # a terminal state or the alloc hangs non-terminal forever —
            # and a live workload must not be orphaned on the way down
            if self.handle is not None:
                try:
                    self.driver.stop_task(self.handle,
                                          self.task.kill_timeout_s)
                except Exception:
                    pass
            for hook in self.hooks:
                try:
                    hook.stop(self)
                except Exception:
                    pass
            self._event(TASK_DRIVER_FAILURE, message=str(e))
            self._set_state(TASK_STATE_DEAD, failed=True)

    def _run_loop(self) -> None:
        while not self._kill.is_set():
            reattached = False
            if self.restore_handle is not None:
                h, self.restore_handle = self.restore_handle, None
                try:
                    if self.driver.recover_task(h):
                        self.handle = h
                        reattached = True
                except Exception:  # noqa: BLE001 - fall through to start
                    pass
            if not reattached:
                try:
                    task_id = f"{self.alloc.id[:8]}-{self.task.name}"
                    self.handle = self.driver.start_task(
                        task_id, self.task, self.env, self.task_dir)
                except DriverError as e:
                    self._event(TASK_DRIVER_FAILURE, message=str(e))
                    decision, delay = self.restart_tracker.next(-1, True)
                    if decision == KILL or self._delay_wait(delay):
                        self._set_state(TASK_STATE_DEAD, failed=True)
                        return
                    self._event(TASK_RESTARTING, restart_reason=str(e))
                    continue
            if self.on_handle:
                try:
                    self.on_handle(self)
                except Exception:  # noqa: BLE001 - persistence best-effort
                    pass

            self._event(TASK_STARTED,
                        message="reattached" if reattached else "")
            self._set_state(TASK_STATE_RUNNING)
            for hook in self.hooks:
                hook.poststart(self)

            result = None
            while result is None and not self._kill.is_set():
                result = self.driver.wait_task(self.handle, timeout=0.25)
            if self._kill.is_set():
                break
            failed = not result.successful()
            self._event(TASK_TERMINATED, exit_code=result.exit_code,
                        signal=result.signal, message=result.err or "")
            # release driver resources of the EXITED instance (docker
            # removes the container; process drivers no-op on a dead pid)
            self._destroy_handle()
            if self._restart_requested:
                # operator-requested restart (alloc restart endpoint):
                # unconditional, never consumes the restart-policy budget
                self._restart_requested = False
                self.state.restarts += 1
                self.state.last_restart = time.time()
                self._set_state(TASK_STATE_PENDING)
                self._event(TASK_RESTARTING,
                            restart_reason="User requested restart")
                continue
            decision, delay = self.restart_tracker.next(result.exit_code,
                                                        failed)
            if decision == KILL:
                self._set_state(TASK_STATE_DEAD, failed=failed)
                if failed:
                    self._event(TASK_NOT_RESTARTING,
                                message="Exceeded allowed attempts")
                return
            self.state.restarts += 1
            self.state.last_restart = time.time()
            # drop out of `running` between exit and restart so deployment
            # health watchers see crash loops (reference: health_hook.go
            # resets the healthy timer on task state changes)
            self._set_state(TASK_STATE_PENDING)
            self._event(TASK_RESTARTING,
                        restart_reason="Restart within policy")
            if decision in (RESTART, WAIT) and self._delay_wait(delay):
                break

        # killed
        if self.handle is not None:
            self._event(TASK_KILLING)
            self.driver.stop_task(self.handle, self.task.kill_timeout_s)
            self._event(TASK_KILLED)
            self._destroy_handle()
        for hook in self.hooks:
            hook.stop(self)
        self._set_state(TASK_STATE_DEAD)

    def _destroy_handle(self) -> None:
        if self.handle is None:
            return
        try:
            self.driver.destroy_task(self.handle)
        except Exception:  # noqa: BLE001 - cleanup is best-effort
            pass
        self.handle = None

    def restart(self) -> None:
        """Operator-requested restart (reference: Allocations.Restart RPC →
        task runner Restart): stop the live instance and start a fresh one
        unconditionally — bypasses the RestartTracker so it never burns the
        policy's attempt budget or kills the task.  With no live instance
        (runner sleeping out a restart-policy delay) it skips the delay and
        starts now — the flag is NOT left set, or a much later natural exit
        would wrongly restart against policy."""
        h = self.handle
        if h is not None:
            self._restart_requested = True
            try:
                self.driver.stop_task(h, self.task.kill_timeout_s)
            except Exception:  # noqa: BLE001 - the wait loop handles exit
                pass
        else:
            self._skip_delay.set()

    def _delay_wait(self, delay: float) -> bool:
        """Sleep out a restart delay; True = killed.  An operator restart
        (skip_delay) ends the sleep early without killing."""
        end = time.time() + delay
        while True:
            remaining = end - time.time()
            if remaining <= 0:
                return False
            if self._kill.wait(min(remaining, 0.1)):
                return True
            if self._skip_delay.is_set():
                self._skip_delay.clear()
                return False

    def kill(self, wait: bool = True, timeout: float = 10.0,
             reason: str = "") -> None:
        if reason and not self._kill.is_set():
            self._event(reason)
        self._kill.set()
        if self.handle is not None:
            self.driver.stop_task(self.handle, self.task.kill_timeout_s)
        if wait and self._thread is not None:
            self._thread.join(timeout)
