"""Client-side service registration + health checks (reference:
client/serviceregistration/ + the checks runner in
client/serviceregistration/checks/ — the provider="nomad" native path).

When an alloc's tasks are all running, its group+task services register
with the server (one ServiceRegistration per service).  Each service's
checks run on their interval from the client; the aggregate pass/fail is
pushed to the registration AND feeds the alloc health hook when the update
stanza says `health_check = "checks"`.

Check types: `tcp` and `http` run real probes (stdlib); anything else
(script/grpc need an exec surface) reports passing after `interval`
elapses once, which keeps mock-driver test jobs deployable — the same
shortcut the reference's mock driver ecosystem leans on in tests.
"""

from __future__ import annotations

import http.client
import socket
import threading
import time
import urllib.parse
from typing import Dict, List, Optional

from nomad_tpu_torch.structs import Allocation, Service, ServiceRegistration

STATUS_PASSING = "passing"
STATUS_CRITICAL = "critical"


def registration_id(alloc_id: str, owner: str, svc: str) -> str:
    return f"_nomad-task-{alloc_id}-{owner}-{svc}"


def _interp(label: str, alloc: Allocation) -> int:
    return alloc.allocated_ports.get(label, 0) if label else 0


def build_registrations(alloc: Allocation, node,
                        address: str = "127.0.0.1"
                        ) -> List[ServiceRegistration]:
    """Group + task services of a running alloc -> registrations."""
    job = alloc.job
    if job is None:
        return []
    tg = job.lookup_task_group(alloc.task_group)
    if tg is None:
        return []
    out: List[ServiceRegistration] = []

    def add(owner: str, svc: Service) -> None:
        if svc.provider != "nomad":
            # consul-provider services belong to an external registry the
            # reference integrates with; only provider="nomad" uses the
            # native discovery store
            return
        out.append(ServiceRegistration(
            id=registration_id(alloc.id, owner, svc.name),
            service_name=svc.name,
            namespace=alloc.namespace,
            node_id=alloc.node_id,
            job_id=alloc.job_id,
            alloc_id=alloc.id,
            datacenter=node.datacenter if node is not None else "",
            tags=list(svc.tags),
            address=address,
            port=_interp(svc.port_label, alloc),
            status="" if not svc.checks else STATUS_CRITICAL,
        ))

    for svc in tg.services:
        add(tg.name, svc)
    for task in tg.tasks:
        for svc in task.services:
            add(task.name, svc)
    return out


class CheckRunner:
    """Runs one service's checks on their interval in a daemon thread;
    reports aggregate status transitions through `on_status`."""

    def __init__(self, reg: ServiceRegistration, checks: List[Dict],
                 on_status) -> None:
        self.reg = reg
        self.checks = checks
        self.on_status = on_status
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.status = STATUS_CRITICAL if checks else ""
        self._started_at = time.time()

    def start(self) -> None:
        if not self.checks:
            return
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"checks-{self.reg.service_name}")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                status = (STATUS_PASSING
                          if all(self._one(c) for c in self.checks)
                          else STATUS_CRITICAL)
            except Exception:  # noqa: BLE001 - a probe bug must not kill
                status = STATUS_CRITICAL   # the runner thread
            # no transitions after stop(): a post-deregister status push
            # would resurrect the deleted registration server-side
            if status != self.status and not self._stop.is_set():
                self.status = status
                self.on_status(self.reg, status)
            interval = min((_seconds(c.get("interval"), 10.0)
                            for c in self.checks), default=10.0)
            self._stop.wait(max(interval, 0.5))

    def _one(self, check: Dict) -> bool:
        ctype = (check.get("type") or "").lower()
        timeout = _seconds(check.get("timeout"), 2.0)
        port = self.reg.port or int(check.get("port") or 0)
        if ctype == "tcp":
            try:
                with socket.create_connection(
                        (self.reg.address or "127.0.0.1", port),
                        timeout=timeout):
                    return True
            except OSError:
                return False
        if ctype == "http":
            path = check.get("path") or "/"
            try:
                conn = http.client.HTTPConnection(
                    self.reg.address or "127.0.0.1", port,
                    timeout=timeout)
                conn.request(check.get("method") or "GET",
                             urllib.parse.quote(path, safe="/?=&"))
                ok = 200 <= conn.getresponse().status < 300
                conn.close()
                return ok
            except (OSError, http.client.HTTPException):
                return False
        # script/grpc: no probe surface in-process — healthy once the
        # first interval has elapsed (keeps mock-driver jobs deployable)
        return (time.time() - self._started_at
                >= _seconds(check.get("interval"), 10.0))


def _seconds(v, default: float) -> float:
    if v is None:
        return default
    if isinstance(v, (int, float)):
        # Go time.Duration JSON is nanoseconds when large
        return v / 1e9 if v > 1e6 else float(v)
    s = str(v)
    try:
        if s.endswith("ms"):
            return float(s[:-2]) / 1000
        if s.endswith("s"):
            return float(s[:-1])
        return float(s)
    except ValueError:
        return default


class ServiceManager:
    """Per-client registry of the allocs' service registrations + their
    check runners; ships registrations/status through the RPC seam."""

    def __init__(self, rpc, node) -> None:
        self.rpc = rpc
        self.node = node
        self._runners: Dict[str, List[CheckRunner]] = {}
        self._lock = threading.Lock()

    def is_registered(self, alloc_id: str) -> bool:
        with self._lock:
            return alloc_id in self._runners

    def register_alloc(self, alloc: Allocation) -> None:
        """Idempotent; concurrent callers race on the claim, not on the
        runner threads."""
        with self._lock:
            if alloc.id in self._runners:
                return
            # claim the slot: even a service-less alloc gets an (empty)
            # entry so checks_healthy can distinguish "no checks" from
            # "registration hasn't happened yet"
            self._runners[alloc.id] = []
        regs = build_registrations(alloc, self.node)
        if not regs:
            return
        self.rpc.update_service_registrations(regs)
        runners: List[CheckRunner] = []
        job = alloc.job
        tg = job.lookup_task_group(alloc.task_group) if job else None
        by_owner = {}
        if tg is not None:
            for svc in tg.services:
                by_owner[(tg.name, svc.name)] = svc
            for task in tg.tasks:
                for svc in task.services:
                    by_owner[(task.name, svc.name)] = svc
        for reg in regs:
            owner_svc = next((s for (o, n), s in by_owner.items()
                              if registration_id(alloc.id, o, n) == reg.id),
                             None)
            checks = owner_svc.checks if owner_svc else []
            if checks:
                r = CheckRunner(reg, checks, self._on_status)
                r.start()
                runners.append(r)
        with self._lock:
            if alloc.id in self._runners:
                self._runners[alloc.id] = runners
            else:
                # deregistered while we were starting: unwind
                for r in runners:
                    r.stop()

    def deregister_alloc(self, alloc_id: str) -> None:
        with self._lock:
            runners = self._runners.pop(alloc_id, [])
        for r in runners:
            r.stop()
        self.rpc.remove_service_registrations(alloc_id)

    def checks_healthy(self, alloc_id: str) -> bool:
        """True when every check-bearing service of the alloc passes —
        the `health_check = "checks"` input to the alloc health hook.
        An alloc whose registration hasn't happened yet reports False
        (its checks exist but have not run); a registered alloc with no
        checks reports True."""
        with self._lock:
            runners = self._runners.get(alloc_id)
        if runners is None:
            return False
        return all(r.status == STATUS_PASSING for r in runners)

    def _on_status(self, reg: ServiceRegistration, status: str) -> None:
        with self._lock:
            if reg.alloc_id not in self._runners:
                return     # deregistered: do not resurrect the row
        reg.status = status
        try:
            self.rpc.update_service_registrations([reg])
        except Exception:  # noqa: BLE001 - transient RPC failures retried
            pass           # on the next status transition

    def shutdown(self) -> None:
        with self._lock:
            allocs = list(self._runners)
        for aid in allocs:
            self.deregister_alloc(aid)
