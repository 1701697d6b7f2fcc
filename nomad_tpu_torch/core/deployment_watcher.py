"""Deployment watcher (reference: nomad/deploymentwatcher/).

Watches active deployments and drives their lifecycle from alloc health:

  - recompute per-group placed/healthy/unhealthy counts from the allocs
    carrying this deployment's id;
  - an unhealthy alloc fails the deployment (auto_revert ⇒ the job is
    reverted to the last stable version and re-evaluated);
  - auto_promote promotes once every group's canaries are placed+healthy;
  - a group making no healthy progress past its progress_deadline fails
    the deployment;
  - all groups promoted (or canary-less) with healthy ≥ desired marks the
    deployment successful and the job version stable.

Manual operations mirror the reference's Deployment RPC endpoints:
promote / fail / pause / unpause (deploymentwatcher/deployment_watcher.go
PromoteDeployment, FailDeployment, PauseDeployment).

Driven by Server.tick in threaded mode and explicitly in dev mode; the
deadline bookkeeping is wall-clock based, like the heartbeat timers.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from nomad_tpu_torch.core.logging import log

from nomad_tpu_torch.structs import (
    DEPLOYMENT_STATUS_FAILED,
    DEPLOYMENT_STATUS_PAUSED,
    DEPLOYMENT_STATUS_RUNNING,
    DEPLOYMENT_STATUS_SUCCESSFUL,
    Deployment,
    Evaluation,
    TRIGGER_DEPLOYMENT_WATCHER,
)

DESC_PROGRESS_DEADLINE = "Failed due to progress deadline"
DESC_UNHEALTHY_ALLOCS = "Failed due to unhealthy allocation(s)"
DESC_PROMOTED = "Deployment promoted"
DESC_SUCCESSFUL = "Deployment completed successfully"
DESC_FAILED_MANUAL = "Deployment marked as failed"
DESC_PAUSED = "Deployment is paused"
DESC_RESUMED = "Deployment is resuming"
DESC_REVERTING = " - rolling back to job version %d"


class DeploymentWatcher:
    """One watcher for all deployments of a server (the reference runs one
    goroutine per deployment; alloc health lives in the state store here,
    so a single pass over active deployments per tick is simpler and
    equivalent)."""

    def __init__(self, server) -> None:
        self.server = server
        # deployment id -> wall-clock deadline for next required progress
        self._progress_by: Dict[str, float] = {}

    # ---------------------------------------------------------------- tick

    def tick(self, now: Optional[float] = None) -> None:
        t = now if now is not None else self.server.clock.time()
        snap = self.server.state.snapshot()
        for dep in snap.deployments():
            if dep.status != DEPLOYMENT_STATUS_RUNNING:
                self._progress_by.pop(dep.id, None)
                continue
            self._check_one(snap, dep, t)

    def _check_one(self, snap, dep: Deployment, now: float) -> None:
        allocs = [a for a in snap.allocs_by_job(dep.namespace, dep.job_id)
                  if a.deployment_id == dep.id]
        updated = dep.copy()
        unhealthy = any((a.deployment_status or {}).get("healthy") is False
                        for a in allocs
                        if a.task_group in updated.task_groups)
        self._recount(updated, allocs)

        if unhealthy:
            self._fail(updated, DESC_UNHEALTHY_ALLOCS, now)
            return

        # progress deadline: armed at first sight, re-armed whenever the
        # healthy count grows (reference: deployment_watcher.go
        # watch/getDeploymentProgressCutoff)
        deadline = self._progress_by.get(dep.id)
        key = dep.id
        prev_healthy = sum(s.healthy_allocs
                           for s in dep.task_groups.values())
        cur_healthy = sum(s.healthy_allocs
                          for s in updated.task_groups.values())
        longest = max((s.progress_deadline_s
                       for s in updated.task_groups.values()), default=0.0)
        if longest > 0:
            if deadline is None or cur_healthy > prev_healthy:
                deadline = now + longest
                self._progress_by[key] = deadline
            elif now >= deadline and not self._complete(updated):
                self._fail(updated, DESC_PROGRESS_DEADLINE, now)
                return

        # auto-promote once every canary group has its canaries healthy
        if (updated.requires_promotion()
                and all(not s.desired_canaries or s.auto_promote
                        for s in updated.task_groups.values())
                and self._canaries_healthy(updated, allocs)):
            self._do_promote(updated, None, now)
            return

        if self._complete(updated):
            updated.status = DEPLOYMENT_STATUS_SUCCESSFUL
            updated.status_description = DESC_SUCCESSFUL
            log("deployment", "info", "deployment successful",
                deployment_id=updated.id, job_id=updated.job_id)
            self.server.state.upsert_deployment(updated)
            self._progress_by.pop(dep.id, None)
            self._mark_stable(updated)
            return

        if self._counts_changed(dep, updated):
            self.server.state.upsert_deployment(updated)
        if cur_healthy > prev_healthy:
            # health progressed: re-evaluate so the scheduler can release
            # the next rolling wave (the reference's watcher creates an
            # eval on alloc health transitions)
            self._create_eval(updated, now)

    # ------------------------------------------------------------- helpers

    def _recount(self, dep: Deployment, allocs) -> None:
        for st in dep.task_groups.values():
            st.placed_allocs = 0
            st.healthy_allocs = 0
            st.unhealthy_allocs = 0
        for a in allocs:
            st = dep.task_groups.get(a.task_group)
            if st is None:
                continue
            if a.terminal_status():
                # a healthy-then-crashed alloc must not keep counting: its
                # replacement carries the same deployment_id and earns the
                # slot's health itself
                continue
            st.placed_allocs += 1
            ds = a.deployment_status or {}
            if ds.get("healthy") is True:
                st.healthy_allocs += 1
            elif ds.get("healthy") is False:
                st.unhealthy_allocs += 1

    @staticmethod
    def _counts_changed(a: Deployment, b: Deployment) -> bool:
        for name, sa in a.task_groups.items():
            sb = b.task_groups.get(name)
            if sb is None:
                return True
            if (sa.placed_allocs, sa.healthy_allocs, sa.unhealthy_allocs) != \
                    (sb.placed_allocs, sb.healthy_allocs, sb.unhealthy_allocs):
                return True
        return False

    @staticmethod
    def _complete(dep: Deployment) -> bool:
        for st in dep.task_groups.values():
            if st.desired_canaries > 0 and not st.promoted:
                return False
            if st.healthy_allocs < st.desired_total:
                return False
        return True

    @staticmethod
    def _canaries_healthy(dep: Deployment, allocs,
                          groups: Optional[List[str]] = None) -> bool:
        by_id = {a.id: a for a in allocs}
        for name, st in dep.task_groups.items():
            if groups is not None and name not in groups:
                continue
            if st.desired_canaries <= 0 or st.promoted:
                continue
            healthy = sum(
                1 for cid in st.placed_canaries
                if (cand := by_id.get(cid)) is not None
                and (cand.deployment_status or {}).get("healthy") is True)
            if healthy < st.desired_canaries:
                return False
        return True

    def _mark_stable(self, dep: Deployment) -> None:
        job = self.server.state.job_by_id(dep.namespace, dep.job_id)
        if job is not None and job.version == dep.job_version:
            stable = job.copy()
            stable.stable = True
            self.server.state.upsert_job(stable, preserve_version=True)

    def _create_eval(self, dep: Deployment, now: float) -> None:
        job = self.server.state.job_by_id(dep.namespace, dep.job_id)
        if job is None:
            return
        self.server.apply_eval_update([Evaluation(
            namespace=dep.namespace,
            priority=job.priority,
            type=job.type,
            triggered_by=TRIGGER_DEPLOYMENT_WATCHER,
            job_id=dep.job_id,
            deployment_id=dep.id,
        )], now=now)

    def _fail(self, dep: Deployment, desc: str, now: float) -> None:
        log("deployment", "error", "deployment failed",
            deployment_id=dep.id, job_id=dep.job_id, reason=desc)
        dep.status = DEPLOYMENT_STATUS_FAILED
        dep.status_description = desc
        self._progress_by.pop(dep.id, None)
        reverted = False
        if any(s.auto_revert for s in dep.task_groups.values()):
            version = self._revert_job(dep, now)
            if version is not None:
                dep.status_description = desc + (DESC_REVERTING % version)
                reverted = True
        self.server.state.upsert_deployment(dep)
        if not reverted:
            # no revert: still re-evaluate so the scheduler observes the
            # failed deployment (halts further rollout)
            self._create_eval(dep, now)

    def _revert_job(self, dep: Deployment, now: float) -> Optional[int]:
        """Re-register the last stable version below the deployment's
        (reference: allocUpdateFnRollback / Job.Revert semantics)."""
        state = self.server.state
        job = state.job_by_id(dep.namespace, dep.job_id)
        if job is None or job.version != dep.job_version:
            return None
        for v in range(dep.job_version - 1, -1, -1):
            prior = state.job_by_id_and_version(dep.namespace, dep.job_id, v)
            if prior is not None and prior.stable:
                reverted = prior.copy()
                reverted.stable = True
                self.server.register_job(reverted, now=now)
                return v
        return None

    # ------------------------------------------------- manual operations

    def promote(self, dep_id: str, groups: Optional[List[str]] = None,
                now: Optional[float] = None) -> Optional[str]:
        """reference: Deployment.Promote RPC.  Returns an error string or
        None."""
        t = now if now is not None else self.server.clock.time()
        dep = self.server.state.deployment_by_id(dep_id)
        if dep is None:
            return "deployment not found"
        if not dep.active():
            return f"can't promote terminal deployment: {dep.status}"
        snap = self.server.state.snapshot()
        allocs = [a for a in snap.allocs_by_job(dep.namespace, dep.job_id)
                  if a.deployment_id == dep.id]
        updated = dep.copy()
        if not self._canaries_healthy(updated, allocs, groups):
            return "canaries are not healthy"
        return self._do_promote(updated, groups, t)

    def _do_promote(self, updated: Deployment,
                        groups: Optional[List[str]], now: float
                        ) -> Optional[str]:
        hit = False
        for name, st in updated.task_groups.items():
            if groups is not None and name not in groups:
                continue
            if st.desired_canaries > 0:
                st.promoted = True
                hit = True
        if groups is None and not hit:
            return "deployment has no canaries to promote"
        updated.status_description = DESC_PROMOTED
        self.server.state.upsert_deployment(updated)
        self._create_eval(updated, now)
        return None

    def fail(self, dep_id: str, now: Optional[float] = None) -> Optional[str]:
        t = now if now is not None else self.server.clock.time()
        dep = self.server.state.deployment_by_id(dep_id)
        if dep is None:
            return "deployment not found"
        if not dep.active():
            return f"can't fail terminal deployment: {dep.status}"
        self._fail(dep.copy(), DESC_FAILED_MANUAL, t)
        return None

    def pause(self, dep_id: str, pause: bool,
              now: Optional[float] = None) -> Optional[str]:
        dep = self.server.state.deployment_by_id(dep_id)
        if dep is None:
            return "deployment not found"
        if not dep.active():
            return f"can't pause terminal deployment: {dep.status}"
        updated = dep.copy()
        if pause:
            updated.status = DEPLOYMENT_STATUS_PAUSED
            updated.status_description = DESC_PAUSED
        else:
            updated.status = DEPLOYMENT_STATUS_RUNNING
            updated.status_description = DESC_RESUMED
        self.server.state.upsert_deployment(updated)
        if not pause:
            self._create_eval(updated, now if now is not None else self.server.clock.time())
        return None
