"""System / sysbatch scheduler (reference: scheduler/system_sched.go,
scheduler/scheduler_sysbatch.go).

One alloc per eligible feasible node (daemonset-style).  The node axis is
still evaluated on device — one feasibility-mask launch (kernel K8,
ops/feasibility.feasible_mask) covers every node × every task group — but
selection is trivial (each feasible node hosts one alloc), so no scan is
needed; capacity is checked host-side per node.
"""

from __future__ import annotations

from typing import Dict, Optional

from nomad_tpu_torch.chaos.clock import SystemClock
from nomad_tpu_torch.ops import PlacementEngine
from nomad_tpu_torch.ops.feasibility import feasible_mask
from nomad_tpu_torch.structs import (
    ALLOC_CLIENT_LOST,
    Allocation,
    AllocMetric,
    EVAL_STATUS_COMPLETE,
    Evaluation,
    Job,
    Plan,
    allocs_fit,
)

from .base import Planner, Scheduler
from .generic import _engine
from .util import ALLOC_LOST, ALLOC_NOT_NEEDED, tainted_nodes, tasks_updated

# wall fallback when the driver passes no `now` (one-shot CLI paths);
# server paths always inject now from the bound chaos Clock
_WALL = SystemClock()

MAX_SYSTEM_ATTEMPTS = 5


class SystemScheduler(Scheduler):
    """reference: scheduler.SystemScheduler"""

    def __init__(self, state, planner: Planner, sysbatch: bool = False,
                 engine: Optional[PlacementEngine] = None,
                 now: Optional[float] = None) -> None:
        self.state = state
        self.planner = planner
        self.sysbatch = sysbatch
        self.engine = _engine(engine, state)
        self.now = now if now is not None else _WALL.time()
        self.failed_tg_allocs: Dict[str, AllocMetric] = {}
        # decision-record capture (core/explain.py)
        self._tg_stats: Dict[str, dict] = {}

    def process(self, evaluation: Evaluation) -> Optional[Exception]:
        state = self.state
        job = state.job_by_id(evaluation.namespace, evaluation.job_id)
        allocs = state.allocs_by_job(evaluation.namespace, evaluation.job_id)
        tainted = tainted_nodes(state, allocs)
        stopped = job is None or job.stopped()

        plan = Plan(eval_id=evaluation.id, priority=evaluation.priority,
                    job=job)
        self.failed_tg_allocs = {}
        self._tg_stats = {}

        live = [a for a in allocs if not a.terminal_status()]
        if stopped:
            for a in live:
                plan.append_stopped_alloc(a, ALLOC_NOT_NEEDED)
            return self._submit(plan, evaluation)

        # nodes the job can run in: ready + right dc/pool; restrict to a
        # single node for node-update triggered evals
        all_nodes = state.ready_nodes_in_pool(job.datacenters, job.node_pool)
        nodes = all_nodes
        if evaluation.node_id:
            nodes = [n for n in all_nodes if n.id == evaluation.node_id]

        # existing allocs per (node, tg)
        by_node_tg: Dict[tuple, Allocation] = {}
        for a in live:
            by_node_tg[(a.node_id, a.task_group)] = a

        # stops: allocs on tainted/ineligible nodes or for removed TGs
        all_eligible = {n.id for n in all_nodes}
        known_tgs = {tg.name for tg in job.task_groups}
        for a in live:
            if a.task_group not in known_tgs:
                plan.append_stopped_alloc(a, ALLOC_NOT_NEEDED)
                continue
            if a.node_id in tainted:
                node = tainted[a.node_id]
                if node is None or node.status in ("down", "disconnected"):
                    plan.append_stopped_alloc(a, ALLOC_LOST,
                                              client_status=ALLOC_CLIENT_LOST)
                elif a.desired_transition.migrate:
                    # draining system allocs wait for the drainer to flag
                    # them (they drain LAST, after the node's service
                    # allocs are gone)
                    plan.append_stopped_alloc(a, ALLOC_NOT_NEEDED)
                continue
            if a.node_id not in all_eligible:
                # stop only when the node left the job's placement domain;
                # a merely-ineligible node (drain finished with
                # ignore_system_jobs, manual eligibility -disable) keeps
                # its system allocs running
                node = state.node_by_id(a.node_id)
                if node is None:
                    plan.append_stopped_alloc(a, ALLOC_LOST,
                                              client_status=ALLOC_CLIENT_LOST)
                elif (node.datacenter not in job.datacenters
                        or node.node_pool != job.node_pool):
                    plan.append_stopped_alloc(a, ALLOC_NOT_NEEDED)

        # device feasibility over all nodes x TGs
        if nodes:
            self._place(plan, job, nodes, by_node_tg, evaluation)

        return self._submit(plan, evaluation)

    # ------------------------------------------------------------ placing

    def _place(self, plan: Plan, job: Job, nodes, by_node_tg, evaluation):
        packer = self.engine.packer
        t = packer.update(self.state)
        tgt = packer.lower_task_groups(job, job.task_groups,
                                       snapshot=self.state)
        ctx = packer.job_context(job, self.state, t)
        eng = self.engine
        # the engine's node arrays have npad rows on a mesh; the job's
        # masks pad alike (padding rows ineligible, so never placed)
        dev = eng._node_arrays(t)
        dcm, pm = eng.job_masks(t, job, ctx)
        mask = feasible_mask(
            dev["attrs"], dev["elig"], dcm, pm, eng._to_dev(tgt.con),
            eng._to_dev(tgt.luts)).cpu().numpy()          # [G, npad]

        for gi, tg in enumerate(job.task_groups):
            metric = AllocMetric(nodes_evaluated=len(nodes))
            placed_or_kept = 0
            for n in nodes:
                row = t.id_to_row.get(n.id)
                existing = by_node_tg.get((n.id, tg.name))
                if existing is not None:
                    # update-in-place/destructive if job version changed
                    if existing.job is not None and existing.job_version != job.version:
                        if tasks_updated(existing.job, job, tg.name):
                            plan.append_stopped_alloc(
                                existing,
                                "alloc is being updated due to job update")
                        else:
                            upd = existing.copy_skip_job()
                            upd.job = job
                            upd.job_version = job.version
                            plan.append_alloc(upd)
                            placed_or_kept += 1
                            continue
                    else:
                        placed_or_kept += 1
                        continue
                if row is None or not mask[gi, row]:
                    metric.filter_node("feasibility")
                    continue
                ask = tg.combined_resources()
                # proposed view: state allocs minus this plan's stops,
                # overlaid with this plan's placements/updates (same-id
                # in-place updates replace, not double-count)
                proposed = {a.id: a
                            for a in self.state.allocs_by_node(n.id)
                            if not a.terminal_status()}
                for a in plan.node_update.get(n.id, []):
                    proposed.pop(a.id, None)
                for a in plan.node_allocation.get(n.id, []):
                    proposed[a.id] = a
                probe = Allocation(resources=ask)
                ok, dim, _ = allocs_fit(n, list(proposed.values()) + [probe])
                if not ok:
                    metric.exhausted_node(dim)
                    continue
                # device instance assignment (scheduler/device.py): the
                # proposed view's assignments are visible via the index
                assigned = []
                from .device import (InUseIndex, assign_devices,
                                     tg_device_requests)
                if tg_device_requests(tg):
                    idx = InUseIndex()
                    for a in proposed.values():
                        idx.add_alloc(n.id, a)
                    assigned, _why = assign_devices(n, tg, idx)
                    if assigned is None:
                        metric.exhausted_node("devices")
                        continue
                alloc = Allocation(
                    namespace=job.namespace,
                    eval_id=evaluation.id,
                    name=f"{job.id}.{tg.name}[0]",
                    node_id=n.id,
                    job_id=job.id,
                    job=job,
                    task_group=tg.name,
                    resources=ask,
                    allocated_devices=assigned,
                    desired_status="run",
                    client_status="pending",
                    job_version=job.version,
                    metrics=metric,
                    create_time=self.now,
                    modify_time=self.now,
                )
                plan.append_alloc(alloc)
                placed_or_kept += 1
            if metric.nodes_exhausted or (placed_or_kept == 0
                                          and metric.nodes_filtered == len(nodes)):
                self.failed_tg_allocs[tg.name] = metric
            if placed_or_kept:
                # decision record: a system group's "desired" is its
                # eligible-node count; selection is trivial so there is
                # no top-k table, just the rollup
                self._tg_stats[tg.name] = {
                    "placed": placed_or_kept, "desired": len(nodes),
                    "metric": metric}

    def _submit(self, plan: Plan, evaluation: Evaluation):
        if not plan.is_no_op():
            # chain-of-1 fence tag (see generic._process_once): this
            # scheduler ran allocs_fit per node itself against this
            # snapshot, so the applier's re-fit is redundant while the
            # fence holds
            fence = getattr(self.state, "placement_fence", None)
            if fence is not None:
                plan.coupled_batch = (evaluation.id, fence)
            _, _, err = self.planner.submit_plan(plan)
            if err is not None:
                self._update_eval(evaluation, "failed", str(err))
                return err
        self._update_eval(evaluation, EVAL_STATUS_COMPLETE, "")
        return None

    def _update_eval(self, evaluation, status, desc):
        e = evaluation.copy()
        e.status = status
        e.status_description = desc
        e.failed_tg_allocs = dict(self.failed_tg_allocs)
        self.planner.update_eval(e)
        from nomad_tpu_torch.core.explain import record_decision
        record_decision(self.planner, e, self._tg_stats, now=self.now,
                        snapshot_index=getattr(self.state, "index", 0))


def new_system_scheduler(state, planner, **kwargs) -> SystemScheduler:
    return SystemScheduler(state, planner, sysbatch=False, **kwargs)


def new_sysbatch_scheduler(state, planner, **kwargs) -> SystemScheduler:
    return SystemScheduler(state, planner, sysbatch=True, **kwargs)
