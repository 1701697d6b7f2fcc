"""Node drainer (reference: nomad/drainer/).

Orchestrates node drains end to end:

  - `drain_node` records the DrainStrategy (marking the node ineligible)
    and immediately releases the first migration batch;
  - each tick, per draining node, allocs are released for migration in
    `migrate.max_parallel`-sized batches per task group by flagging
    `DesiredTransition.migrate` — the reconciler only migrates flagged
    allocs (reference: drainer/drain_heap + drainingJobWatcher batching);
    a flagged alloc counts against its group's budget until its old copy
    reaches a terminal client state;
  - system-job allocs drain LAST, once every non-system alloc is off the
    node, and not at all when `ignore_system_jobs` is set;
  - at the drain deadline every remaining alloc is force-released
    (deadline_s < 0 forces immediately, reference's `-deadline -1`);
  - when nothing drainable remains, the drain marker is cleared (the node
    stays ineligible) — `nomad node drain -disable` maps to
    `drain_node(node_id, None)`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from nomad_tpu_torch.core.logging import log
from nomad_tpu_torch.core.timeline import TIMELINE
from nomad_tpu_torch.structs import (
    DesiredTransition,
    DrainStrategy,
    JOB_TYPE_SERVICE,
    JOB_TYPE_SYSBATCH,
    JOB_TYPE_SYSTEM,
)

SYSTEM_TYPES = (JOB_TYPE_SYSTEM, JOB_TYPE_SYSBATCH)


class NodeDrainer:
    def __init__(self, server) -> None:
        self.server = server

    # ------------------------------------------------------------ control

    def drain_node(self, node_id: str, strategy: Optional[DrainStrategy],
                   now: Optional[float] = None) -> None:
        """Start (or cancel, with strategy=None) a drain.
        reference: Node.UpdateDrain RPC."""
        t = now if now is not None else self.server.clock.time()
        if strategy is not None:
            # own copy: stamping force_deadline on the caller's object
            # would leak into reuses of the same strategy (and into
            # snapshots, which alias what the store keeps)
            strategy = DrainStrategy(
                deadline_s=strategy.deadline_s,
                ignore_system_jobs=strategy.ignore_system_jobs,
                force_deadline=strategy.force_deadline)
            if strategy.deadline_s > 0 and not strategy.force_deadline:
                strategy.force_deadline = t + strategy.deadline_s
        self.server.state.update_node_drain(node_id, strategy)
        log("drain", "info",
            "drain started" if strategy is not None else "drain cancelled",
            node_id=node_id)
        TIMELINE.annotate(
            "drain.begin" if strategy is not None else "drain.cancel",
            node=node_id)
        if strategy is not None:
            self.tick(t)   # release the first batch immediately

    # --------------------------------------------------------------- tick

    def tick(self, now: Optional[float] = None) -> None:
        t = now if now is not None else self.server.clock.time()
        snap = self.server.state.snapshot()
        for node in snap.nodes():
            if node.drain is not None:
                self._drain_one(snap, node, t)

    def _drain_one(self, snap, node, now: float) -> None:
        drain: DrainStrategy = node.drain
        allocs = [a for a in snap.allocs_by_node(node.id)
                  if not a.client_terminal_status()]
        service: List = []
        system: List = []
        for a in allocs:
            jt = a.job.type if a.job is not None else JOB_TYPE_SERVICE
            (system if jt in SYSTEM_TYPES else service).append(a)

        force = (drain.deadline_s < 0
                 or (drain.force_deadline > 0 and now >= drain.force_deadline))

        to_flag: List[str] = []
        if force:
            pending = service + ([] if drain.ignore_system_jobs else system)
            to_flag = [a.id for a in pending
                       if a.desired_status == "run"
                       and not a.desired_transition.migrate]
        else:
            by_group: Dict[Tuple[str, str, str], List] = {}
            for a in service:
                by_group.setdefault(
                    (a.namespace, a.job_id, a.task_group), []).append(a)
            for (ns, job_id, tg_name), group in by_group.items():
                job = snap.job_by_id(ns, job_id)
                tg = job.lookup_task_group(tg_name) if job else None
                mp = tg.migrate.max_parallel if tg is not None else 1
                # a flagged alloc consumes budget until its old copy is
                # client-terminal (slightly stricter than the reference,
                # which waits for the REPLACEMENT's health)
                in_flight = sum(1 for a in group
                                if a.desired_transition.migrate)
                quota = mp - in_flight
                for a in group:
                    if quota <= 0:
                        break
                    if (a.desired_status == "run"
                            and not a.desired_transition.migrate):
                        to_flag.append(a.id)
                        quota -= 1
            if not service and not drain.ignore_system_jobs:
                to_flag = [a.id for a in system
                           if a.desired_status == "run"
                           and not a.desired_transition.migrate]

        if to_flag:
            self.server.update_alloc_desired_transition(
                to_flag, DesiredTransition(migrate=True), now=now)

        remaining = service + ([] if drain.ignore_system_jobs else system)
        if not remaining:
            # drain complete: clear the marker, keep the node ineligible
            log("drain", "info", "drain complete", node_id=node.id)
            TIMELINE.annotate("drain.complete", node=node.id)
            self.server.state.update_node_drain(node.id, None)
