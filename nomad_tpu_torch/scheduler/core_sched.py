"""Core scheduler — internal GC evals (reference: nomad/core_sched.go).

Processes `_core` evaluations whose job_id names the GC task, mirroring the
reference's convention (CoreJobEvalGC, CoreJobJobGC, CoreJobNodeGC,
CoreJobDeploymentGC, CoreJobForceGC via `nomad system gc`).  Thresholds are
simplified to "strictly older than threshold seconds before now"; force-GC
ignores thresholds.
"""

from __future__ import annotations

from typing import Optional

from nomad_tpu_torch.chaos.clock import SystemClock
from nomad_tpu_torch.structs import (
    EVAL_STATUS_COMPLETE,
    Evaluation,
    JOB_STATUS_DEAD,
)

from .base import Planner, Scheduler

# wall fallback when the driver passes no `now` (one-shot CLI paths);
# server paths always inject now from the bound chaos Clock
_WALL = SystemClock()

CORE_JOB_EVAL_GC = "eval-gc"
CORE_JOB_JOB_GC = "job-gc"
CORE_JOB_NODE_GC = "node-gc"
CORE_JOB_DEPLOYMENT_GC = "deployment-gc"
CORE_JOB_FORCE_GC = "force-gc"

# default GC thresholds (reference: config defaults, simplified)
EVAL_GC_THRESHOLD = 3600.0
JOB_GC_THRESHOLD = 4 * 3600.0
NODE_GC_THRESHOLD = 24 * 3600.0
DEPLOYMENT_GC_THRESHOLD = 3600.0


class CoreScheduler(Scheduler):
    """reference: CoreScheduler.Process — GC is a scheduler so it rides the
    same broker/worker machinery as placement evals."""

    def __init__(self, state, planner: Planner, store=None,
                 now: Optional[float] = None, **_kwargs) -> None:
        self.state = state      # snapshot (read)
        self.store = store      # live StateStore (delete operations)
        self.planner = planner
        self.now = now if now is not None else _WALL.time()

    def process(self, evaluation: Evaluation) -> Optional[Exception]:
        kind = evaluation.job_id
        force = kind == CORE_JOB_FORCE_GC
        if self.store is not None:
            if kind in (CORE_JOB_EVAL_GC, CORE_JOB_FORCE_GC):
                self._eval_gc(force)
            if kind in (CORE_JOB_JOB_GC, CORE_JOB_FORCE_GC):
                self._job_gc(force)
            if kind in (CORE_JOB_NODE_GC, CORE_JOB_FORCE_GC):
                self._node_gc(force)
            if kind in (CORE_JOB_DEPLOYMENT_GC, CORE_JOB_FORCE_GC):
                self._deployment_gc(force)
            if kind in (CORE_JOB_EVAL_GC, CORE_JOB_FORCE_GC):
                self._token_gc()
        done = evaluation.copy()
        done.status = EVAL_STATUS_COMPLETE
        self.planner.update_eval(done)
        return None

    # ------------------------------------------------------------ passes

    def _old(self, ts: float, threshold: float, force: bool) -> bool:
        if force:
            return True
        if ts <= 0:
            # objects without a wall-clock stamp are never threshold-GC'd;
            # `nomad system gc` (force) still collects them
            return False
        return (self.now - ts) > threshold

    def _eval_gc(self, force: bool) -> None:
        snap = self.store.snapshot()
        dead = []
        for ev in snap.evals():
            if not ev.terminal_status():
                continue
            if not self._old(ev.modify_time or 0.0, EVAL_GC_THRESHOLD, force):
                continue
            allocs = snap.allocs_by_job(ev.namespace, ev.job_id)
            mine = [a for a in allocs if a.eval_id == ev.id]
            if all(a.terminal_status() for a in mine):
                dead.append(ev.id)
        if dead:
            self.store.delete_evals(dead)

    def _token_gc(self) -> None:
        """Reap EXPIRED login-minted ACL tokens (reference: the token
        expiration GC added with auth methods).  Rides the eval-GC core
        job; expiry itself is enforced at resolve time — this just keeps
        the table from growing forever."""
        dead = [t.accessor_id for t in self.store.acl_tokens()
                if t.expired(self.now)]
        for accessor in dead:
            self.store.delete_acl_token(accessor)

    def _job_gc(self, force: bool) -> None:
        snap = self.store.snapshot()
        for job in snap.jobs():
            if job.status != JOB_STATUS_DEAD and not job.stop:
                continue
            allocs = snap.allocs_by_job(job.namespace, job.id)
            if not all(a.terminal_status() for a in allocs):
                continue
            newest = max((a.modify_time for a in allocs), default=0.0)
            if not self._old(newest, JOB_GC_THRESHOLD, force):
                continue
            self.store.delete_job(job.namespace, job.id)

    def _node_gc(self, force: bool) -> None:
        snap = self.store.snapshot()
        for node in snap.nodes():
            if node.status != "down":
                continue
            live = [a for a in snap.allocs_by_node(node.id)
                    if not a.terminal_status()]
            if live:
                continue
            if not force:
                continue   # nodes carry no down-timestamp yet; force-only
            self.store.delete_node(node.id)

    def _deployment_gc(self, force: bool) -> None:
        snap = self.store.snapshot()
        for dep in snap.deployments():
            if dep.active():
                continue
            if not force:
                continue   # terminal deployments carry no timestamp; force-only
            self.store.delete_deployment(dep.id)


def new_core_scheduler(state, planner, **kwargs) -> CoreScheduler:
    return CoreScheduler(state, planner, **kwargs)
