"""Alloc runner (reference: client/allocrunner/alloc_runner.go).

Per-allocation lifecycle: builds the alloc dir, runs one TaskRunner per
task (leader-kill semantics: leader death kills the rest), aggregates task
states into the alloc client status, and watches health for deployments
(health_hook.go semantics: all tasks running for min_healthy_time ⇒
healthy).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, List, Optional

from nomad_tpu_torch.core.logging import log
from nomad_tpu_torch.core.telemetry import REGISTRY, TRACER, span_id

from nomad_tpu_torch.structs import (
    ALLOC_CLIENT_COMPLETE,
    ALLOC_CLIENT_FAILED,
    ALLOC_CLIENT_PENDING,
    ALLOC_CLIENT_RUNNING,
    Allocation,
    TASK_LEADER_DEAD,
    TASK_SIBLING_FAILED,
    TASK_STATE_DEAD,
    TASK_STATE_RUNNING,
)

from .task_runner import TaskRunner


class AllocRunner:
    def __init__(self, alloc: Allocation, drivers: Dict, node,
                 alloc_dir: str = "",
                 on_update: Optional[Callable] = None,
                 checks_healthy: Optional[Callable] = None,
                 restore_handles: Optional[Dict] = None,
                 on_handle: Optional[Callable] = None,
                 device_reserver: Optional[Callable] = None,
                 identity_fetcher: Optional[Callable] = None,
                 secrets_provider=None) -> None:
        self.alloc = alloc
        self.node = node
        self.drivers = drivers
        self.alloc_dir = alloc_dir
        self.on_update = on_update
        self.checks_healthy = checks_healthy
        self.restore_handles = restore_handles or {}
        self._persist_handle = on_handle
        self.device_reserver = device_reserver
        self.secrets_provider = secrets_provider
        # one derive RPC per ALLOC, shared by every task runner (the
        # server mints all task tokens in one call)
        self._identity_raw = identity_fetcher
        self._identity_cache: Optional[Dict] = None
        self._identity_lock = threading.Lock()
        self.identity_fetcher = (self._fetch_identities
                                 if identity_fetcher else None)
        self.task_runners: List[TaskRunner] = []
        self._lock = threading.Lock()
        self._done = threading.Event()
        self._destroyed = False
        self.health: Optional[bool] = None
        # eval-lifecycle trace (core/telemetry.py): run() stamps the
        # start; the first transition to client_status=running records
        # the alloc-start span that closes the server->client span tree
        self._trace_t0: Optional[float] = None
        self._run_span_done = False
        self._build_runners()

    def _fetch_identities(self, alloc_id: str) -> Dict:
        # dedicated lock: the derive RPC can block for the socket timeout
        # and must not stall status sync / supervision on self._lock
        with self._identity_lock:
            if self._identity_cache is None:
                fetched = self._identity_raw(alloc_id)
                if not fetched:
                    # transient failure (leader election, server down):
                    # leave the cache unset so a task restart retries
                    return {}
                self._identity_cache = fetched
            return self._identity_cache

    # ------------------------------------------------------------- build

    def _tg(self):
        return self.alloc.job.lookup_task_group(self.alloc.task_group) \
            if self.alloc.job else None

    def _build_runners(self) -> None:
        tg = self._tg()
        if tg is None:
            return
        is_batch = bool(self.alloc.job and
                        self.alloc.job.type in ("batch", "sysbatch"))
        for task in tg.tasks:
            driver = self.drivers.get(task.driver)
            if driver is None:
                # fail the alloc up front (reference: driver not found is a
                # terminal setup error, not a silent skip)
                from nomad_tpu_torch.structs import (
                    TASK_DRIVER_FAILURE, TaskEvent, TaskState)
                self.alloc.task_states[task.name] = TaskState(
                    state=TASK_STATE_DEAD, failed=True,
                    events=[TaskEvent(
                        type=TASK_DRIVER_FAILURE, time=time.time(),
                        message=f"driver {task.driver!r} not found")])
                self.alloc.client_status = ALLOC_CLIENT_FAILED
                self._done.set()
                continue
            tdir = os.path.join(self.alloc_dir, self.alloc.id, task.name) \
                if self.alloc_dir else ""
            self.task_runners.append(TaskRunner(
                self.alloc, task, driver, self.node, task_dir=tdir,
                is_batch=is_batch, on_state_change=self._on_task_change,
                restore_handle=self.restore_handles.get(task.name),
                on_handle=self._on_task_handle,
                device_reserver=self.device_reserver,
                identity_fetcher=self.identity_fetcher,
                secrets_provider=self.secrets_provider))

    # ------------------------------------------------------------ status

    def _on_task_handle(self, runner: TaskRunner) -> None:
        if self._persist_handle and runner.handle is not None:
            self._persist_handle(self.alloc.id, runner.task.name,
                                 runner.handle)

    def _on_task_change(self, runner: TaskRunner) -> None:
        with self._lock:
            self.alloc.task_states[runner.task.name] = runner.state
            terminal = self._recompute_status()
        self._maybe_record_run_span()
        if self.on_update:
            self.on_update(self)
        if terminal:
            # set AFTER on_update: a wait()-er acting on "idle" must see
            # the terminal status already queued for sync, or a final
            # sync ships a stale running/pending status
            self._done.set()

    def _recompute_status(self) -> bool:
        """reference: alloc_runner.go clientStatus derivation.
        Returns True when the alloc reached a terminal client status."""
        states = [tr.state for tr in self.task_runners]
        if not states:
            return False
        if any(s.state == TASK_STATE_DEAD and s.failed for s in states):
            self.alloc.client_status = ALLOC_CLIENT_FAILED
        elif all(s.state == TASK_STATE_DEAD for s in states):
            self.alloc.client_status = ALLOC_CLIENT_COMPLETE
        elif any(s.state == TASK_STATE_RUNNING for s in states):
            self.alloc.client_status = ALLOC_CLIENT_RUNNING
        else:
            self.alloc.client_status = ALLOC_CLIENT_PENDING
        return self.alloc.client_status in (ALLOC_CLIENT_FAILED,
                                            ALLOC_CLIENT_COMPLETE)

    def client_update(self):
        """Consistent copy of (client_status, deployment_status,
        task_states) for shipping to the server — deep-copied under the
        runner lock so task threads can keep mutating their TaskStates."""
        import copy
        with self._lock:
            return (self.alloc.client_status,
                    copy.deepcopy(self.alloc.deployment_status),
                    copy.deepcopy(self.alloc.task_states))

    # ------------------------------------------------------------- run

    def _maybe_record_run_span(self) -> None:
        """First transition to running closes the trace's client leg:
        span `client.alloc_start` = runner start -> tasks running,
        parented under the plan-apply span that committed the alloc."""
        if (self._run_span_done or not self.alloc.trace_id
                or self.alloc.client_status != ALLOC_CLIENT_RUNNING):
            return
        self._run_span_done = True
        t1 = TRACER.clock.monotonic()
        t0 = self._trace_t0 if self._trace_t0 is not None else t1
        TRACER.record("client.alloc_start", self.alloc.trace_id, t0, t1,
                      parent=span_id(self.alloc.trace_id, "plan.apply"),
                      alloc_id=self.alloc.id, node_id=self.alloc.node_id,
                      task_group=self.alloc.task_group)
        REGISTRY.observe("nomad.client.alloc_start_s", t1 - t0)

    def run(self) -> None:
        self._trace_t0 = TRACER.clock.monotonic()
        if self._done.is_set():
            # failed during build (e.g. missing driver): ship the terminal
            # status instead of starting anything
            if self.on_update:
                self.on_update(self)
            return
        for tr in self.task_runners:
            tr.start()
        threading.Thread(target=self._supervise, daemon=True,
                         name=f"alloc-{self.alloc.id[:8]}").start()

    def _supervise(self) -> None:
        """Leader-kill + sibling-failure semantics + health watching.
        Daemon-thread entry: an escape from the watch loop must not kill
        the supervisor silently (tasks would run unsupervised and the
        deployment health would never settle)."""
        try:
            self._watch_tasks()
        except Exception as exc:  # noqa: BLE001 - daemon thread
            log("client", "warn", "alloc supervisor died",
                alloc=self.alloc.id, error=repr(exc))

    def _watch_tasks(self) -> None:
        tg = self._tg()
        min_healthy = 10.0
        if tg is not None and tg.update is not None:
            min_healthy = tg.update.min_healthy_time_s
        healthy_since: Optional[float] = None
        while not self._done.is_set() and not self._destroyed:
            time.sleep(0.05)
            with self._lock:
                leaders_dead = any(
                    tr.task.leader and tr.state.state == TASK_STATE_DEAD
                    for tr in self.task_runners)
                any_failed = any(
                    tr.state.state == TASK_STATE_DEAD and tr.state.failed
                    for tr in self.task_runners)
                all_running = all(
                    tr.state.state == TASK_STATE_RUNNING
                    for tr in self.task_runners) and self.task_runners
            if leaders_dead or any_failed:
                reason = TASK_SIBLING_FAILED if any_failed else \
                    TASK_LEADER_DEAD
                for tr in self.task_runners:
                    if tr.state.state != TASK_STATE_DEAD:
                        tr.kill(wait=False, reason=reason)
                if leaders_dead and not any_failed:
                    # leader completing is a normal completion
                    for tr in self.task_runners:
                        tr.dead.wait(5)
            # deployment health; with `health_check = "checks"` the
            # service checks must also pass (reference: health_hook.go's
            # checks watcher)
            if self.alloc.deployment_id and self.health is None:
                healthy_now = all_running
                if (healthy_now and tg is not None and tg.update is not None
                        and tg.update.health_check == "checks"
                        and self.checks_healthy is not None):
                    healthy_now = self.checks_healthy(self.alloc.id)
                if healthy_now:
                    if healthy_since is None:
                        healthy_since = time.time()
                    elif time.time() - healthy_since >= min_healthy:
                        self._set_health(True)
                elif any_failed:
                    self._set_health(False)
                else:
                    healthy_since = None
        if self.alloc.deployment_id and self.health is None:
            # terminal before becoming healthy
            self._set_health(
                self.alloc.client_status == ALLOC_CLIENT_COMPLETE)

    def _set_health(self, healthy: bool) -> None:
        self.health = healthy
        self.alloc.deployment_status = {"healthy": healthy,
                                        "ts": time.time()}
        if self.on_update:
            self.on_update(self)

    # ----------------------------------------------------------- control

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def update(self, alloc: Allocation) -> None:
        """Server pushed a new version of this alloc (e.g. desired=stop)."""
        self.alloc.desired_status = alloc.desired_status
        self.alloc.desired_description = alloc.desired_description
        if alloc.desired_status != "run":
            self.destroy()

    def abandon(self) -> None:
        """Stop supervising without killing tasks (see TaskRunner.abandon)."""
        self._destroyed = True
        for tr in self.task_runners:
            tr.abandon()

    def destroy(self) -> None:
        self._destroyed = True
        for tr in self.task_runners:
            tr.kill(wait=False)
        with self._lock:
            self._recompute_status()
        self._done.set()
