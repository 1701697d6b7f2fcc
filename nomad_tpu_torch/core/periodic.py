"""Periodic job dispatch + parameterized job dispatch
(reference: nomad/periodic.go, nomad/job_endpoint.go Job.Dispatch).

Periodic parent jobs are never scheduled themselves; the leader-side
dispatcher launches CHILD jobs (`<id>/periodic-<epoch>`) on the cron
schedule, honoring `prohibit_overlap` (skip a launch while the previous
child is still live).  Parameterized parents likewise only run via
`dispatch` (`<id>/dispatch-<epoch>-<rand>`), which merges payload + meta
into the child.

The cron evaluator implements the 5-field subset (minute hour dom month
dow; `*`, `*/n`, ranges, lists) plus the @hourly/@daily/@weekly/@monthly
shortcuts — the reference uses gorhill/cronexpr; jobs needing its seconds
field or symbolic names should spell fields numerically.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from nomad_tpu_torch.structs import (
    Job,
    JOB_STATUS_DEAD,
    new_id,
)

_SHORTCUTS = {
    "@hourly": "0 * * * *",
    "@daily": "0 0 * * *",
    "@midnight": "0 0 * * *",
    "@weekly": "0 0 * * 0",
    "@monthly": "0 0 1 * *",
}


def _parse_field(field: str, lo: int, hi: int,
                 wrap7: bool = False) -> frozenset:
    out = set()
    for part in field.split(","):
        step = 1
        if "/" in part:
            part, step_s = part.split("/", 1)
            step = int(step_s)
            if step <= 0:
                raise ValueError(f"cron step must be positive: {field!r}")
        if part in ("*", ""):
            lo2, hi2 = lo, hi
        elif "-" in part:
            a, b = part.split("-", 1)
            lo2, hi2 = int(a), int(b)
        else:
            lo2 = hi2 = int(part)
        vals = range(lo2, hi2 + 1, step)
        if wrap7:
            # day-of-week: 7 is an alias for Sunday (0) — mapped per
            # VALUE, never by string surgery (which would corrupt '0-7',
            # '*/7', '17', ...)
            vals = (0 if v == 7 else v for v in vals)
        out.update(vals)
    vals = frozenset(v for v in out if lo <= v <= hi)
    if not vals:
        raise ValueError(f"cron field matches nothing: {field!r}")
    return vals


class CronSpec:
    """Parsed 5-field cron expression; `next(after)` = first matching
    minute strictly after `after` (epoch seconds, UTC)."""

    def __init__(self, spec: str) -> None:
        spec = _SHORTCUTS.get(spec.strip(), spec.strip())
        parts = spec.split()
        if len(parts) != 5:
            raise ValueError(f"cron spec must have 5 fields: {spec!r}")
        self.minute = _parse_field(parts[0], 0, 59)
        self.hour = _parse_field(parts[1], 0, 23)
        self.dom = _parse_field(parts[2], 1, 31)
        self.month = _parse_field(parts[3], 1, 12)
        # cron dow: 0 and 7 are both Sunday; Python tm_wday: Monday=0
        self.dow = _parse_field(parts[4], 0, 7, wrap7=True)
        self.dom_any = len(self.dom) == 31
        self.dow_any = len(self.dow) == 7

    def next(self, after: float) -> Optional[float]:
        t = (int(after) // 60 + 1) * 60     # next whole minute
        for _ in range(366 * 24 * 60):      # one-year horizon
            tm = time.gmtime(t)
            if (tm.tm_mon in self.month
                    and tm.tm_hour in self.hour
                    and tm.tm_min in self.minute
                    and self._day_ok(tm)):
                return float(t)
            t += 60
        return None

    def _day_ok(self, tm) -> bool:
        # standard cron: dom and dow are OR'd when both are restricted
        cron_dow = (tm.tm_wday + 1) % 7     # Monday=0 -> Sunday=0 base
        dom_ok = tm.tm_mday in self.dom
        dow_ok = cron_dow in self.dow
        if self.dom_any and self.dow_any:
            return True
        if self.dom_any:
            return dow_ok
        if self.dow_any:
            return dom_ok
        return dom_ok or dow_ok


class PeriodicDispatch:
    """Leader-side periodic launcher (reference: PeriodicDispatch)."""

    def __init__(self, server) -> None:
        self.server = server
        self._tracked: Dict[Tuple[str, str], CronSpec] = {}
        # (namespace, id) -> cached next fire time (None = never fires);
        # CronSpec.next is a minute scan, far too hot to recompute per tick
        self._next: Dict[Tuple[str, str], Optional[float]] = {}

    def add(self, job: Job, now: Optional[float] = None) -> None:
        key = job.ns_id()
        if (job.periodic is None or not job.periodic.enabled
                or job.stopped()):
            self.remove(*key)
            return
        spec = CronSpec(job.periodic.spec)
        self._tracked[key] = spec
        if key not in self._next:
            self._next[key] = spec.next(
                now if now is not None else self.server.clock.time())

    def remove(self, namespace: str, job_id: str) -> None:
        self._tracked.pop((namespace, job_id), None)
        self._next.pop((namespace, job_id), None)

    def tick(self, now: Optional[float] = None) -> List[Job]:
        t = now if now is not None else self.server.clock.time()
        launched: List[Job] = []
        for key, spec in list(self._tracked.items()):
            nxt = self._next.get(key)
            if nxt is None or nxt > t:
                continue
            self._next[key] = spec.next(t)   # missed launches are skipped
            child = self._launch(key, nxt)
            if child is not None:
                launched.append(child)
        return launched

    def force_run(self, namespace: str, job_id: str,
                  now: Optional[float] = None) -> Optional[Job]:
        """reference: PeriodicDispatch.ForceRun / `nomad job periodic force`"""
        t = now if now is not None else self.server.clock.time()
        job = self.server.state.job_by_id(namespace, job_id)
        if job is None or job.periodic is None:
            return None
        return self._spawn_child(
            job, f"{job.id}/periodic-{int(t)}", t)

    def _launch(self, key: Tuple[str, str], launch_time: float
                ) -> Optional[Job]:
        job = self.server.state.job_by_id(*key)
        if job is None or job.periodic is None or job.stopped():
            self.remove(*key)
            return None
        if job.periodic.prohibit_overlap and self._has_live_child(job):
            return None
        return self._spawn_child(
            job, f"{job.id}/periodic-{int(launch_time)}", launch_time)

    def _has_live_child(self, parent: Job) -> bool:
        for j in self.server.state.snapshot().jobs():
            if (j.parent_id == parent.id and j.namespace == parent.namespace
                    and j.status != JOB_STATUS_DEAD and not j.stopped()):
                return True
        return False

    def _spawn_child(self, parent: Job, child_id: str, now: float
                     ) -> Optional[Job]:
        if self.server.state.job_by_id(parent.namespace, child_id):
            return None        # this launch already happened
        child = parent.copy()
        child.id = child_id
        child.name = child_id
        child.parent_id = parent.id
        child.periodic = None
        child.status = ""
        self.server.register_job(child, now=now)
        return child


def dispatch_job(server, namespace: str, job_id: str,
                 payload: bytes = b"",
                 meta: Optional[Dict[str, str]] = None,
                 now: Optional[float] = None) -> Tuple[Optional[Job], str]:
    """Dispatch a parameterized job (reference: Job.Dispatch RPC).
    Returns (child, error)."""
    t = now if now is not None else server.clock.time()
    meta = meta or {}
    parent = server.state.job_by_id(namespace, job_id)
    if parent is None:
        return None, "job not found"
    cfg = parent.parameterized
    if cfg is None:
        return None, "job is not parameterized"
    if parent.stopped():
        return None, "job is stopped"
    if cfg.payload == "required" and not payload:
        return None, "payload is required"
    if cfg.payload == "forbidden" and payload:
        return None, "payload is forbidden"
    for k in cfg.meta_required:
        if k not in meta:
            return None, f"missing required meta key: {k}"
    allowed = set(cfg.meta_required) | set(cfg.meta_optional)
    for k in meta:
        if k not in allowed:
            return None, f"unexpected meta key: {k}"

    child = parent.copy()
    child.id = f"{parent.id}/dispatch-{int(t)}-{new_id()[:8]}"
    child.name = child.id
    child.parent_id = parent.id
    child.parameterized = None
    child.dispatched = True
    child.payload = payload
    child.meta = {**parent.meta, **meta}
    child.status = ""
    server.register_job(child, now=t)
    return child, ""
