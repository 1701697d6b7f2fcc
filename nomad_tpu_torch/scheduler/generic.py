"""Generic (service/batch) scheduler (reference: scheduler/generic_sched.go).

`process(eval)` = snapshot → reconcile → batched device placement → plan →
submit, with the reference's retry-on-partial-commit loop, blocked-eval
creation for failed placements, and follow-up evals for delayed reschedules.

The hot-loop difference vs the reference: computePlacements there walks
candidates one placement at a time through the iterator stack; here ALL
placements of the eval go to the device kernels as one batch
(nomad_tpu_torch.ops.PlacementEngine) and come back as node picks +
AllocMetrics in a single device round-trip.
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Optional

from nomad_tpu_torch.chaos.clock import SystemClock
from nomad_tpu_torch.ops import PlacementEngine, PlacementRequest
from nomad_tpu_torch.ops.engine import BulkDecisions
from nomad_tpu_torch.structs import (
    Allocation,
    AllocMetric,
    EVAL_STATUS_COMPLETE,
    Evaluation,
    Job,
    NetworkIndex,
    Plan,
    PlanAnnotations,
    TRIGGER_PLAN_REFUTE,
    TRIGGER_QUEUED_ALLOCS,
    new_id,
    new_ids,
)

from .base import Planner, Scheduler
from .reconcile import PlaceRequest as RPlace
from .reconcile import ReconcileResults, _name, reconcile
from .util import ALLOC_RESCHEDULED, tainted_nodes

# wall fallback when the driver passes no `now` (one-shot CLI paths);
# server paths always inject now from the bound chaos Clock
_WALL = SystemClock()

# reference: maxServiceScheduleAttempts / maxBatchScheduleAttempts
MAX_SERVICE_ATTEMPTS = 5
MAX_BATCH_ATTEMPTS = 2

# Batched port assignment (ISSUE 8): when True, networked fresh blocks
# ride the columnar path with a per-node bulk port carve; False forces
# the sequential per-alloc NetworkIndex loop — the PARITY ORACLE the
# bench gate and tests compare against (bit-for-bit (node, port)
# equality is the promotion contract, like PR 7's sharded-vs-single).
PORT_BATCHED = True

# Shared engines so packed node tensors + jit caches persist across evals
# of one in-process scheduler session (the worker wires its own).  Keyed
# by the backing store's identity: two Harness/Server instances in one
# process must never share packed tensors — an engine caching one store's
# rows would serve the other stale state (ADVICE r2 #4 pattern).  Bounded
# LRU-ish: old stores' engines are dropped, not leaked.
_engines: Dict[str, PlacementEngine] = {}


def _engine(explicit: Optional[PlacementEngine],
            state) -> PlacementEngine:
    if explicit is not None:
        return explicit
    key = getattr(state, "store_id", "") or "<unkeyed>"
    eng = _engines.get(key)
    if eng is None:
        if len(_engines) > 8:
            for old in list(_engines)[:4]:
                _engines.pop(old, None)
        _engines[key] = eng = PlacementEngine()
    return eng


class GenericScheduler(Scheduler):
    """reference: scheduler.GenericScheduler"""

    def __init__(self, state, planner: Planner, is_batch: bool = False,
                 engine: Optional[PlacementEngine] = None,
                 now: Optional[float] = None) -> None:
        self.state = state
        self.planner = planner
        self.is_batch = is_batch
        self.engine = _engine(engine, state)
        self.now = now if now is not None else _WALL.time()
        self.max_attempts = (MAX_BATCH_ATTEMPTS if is_batch
                             else MAX_SERVICE_ATTEMPTS)
        # replica-fed planners (pool worker processes) see the head
        # later than a thread worker reading the shared store, so their
        # optimistic-concurrency retries need more headroom
        self.max_attempts += getattr(planner, "schedule_attempt_boost", 0)
        self.failed_tg_allocs: Dict[str, AllocMetric] = {}
        self.queued_allocs: Dict[str, int] = {}
        # decision-record capture (core/explain.py): per-TG placed
        # counts, the winning metric/top-k, and preemption choices —
        # all host-resident already, so capture costs dict writes only
        self._tg_stats: Dict[str, dict] = {}
        # rows whose ports the last _materialize_bulk carved COLUMNAR
        # (the worker mirrors it into the wave pipeline's stats)
        self.last_port_carve = 0

    # ------------------------------------------------------------- process

    def process(self, evaluation: Evaluation) -> Optional[Exception]:
        for attempt in range(self.max_attempts):
            # per-(eval, attempt) tie-break seed: concurrent workers (and
            # their refutation retries) must diverge on equal-score nodes
            # or they re-collide every attempt (see select._tiebreak_noise)
            self._seed = ((zlib.crc32(evaluation.id.encode())
                           + attempt * 0x9E3779B9) & 0xFFFFFFFF) or 1
            done, err = self._process_once(evaluation)
            if err is not None:
                self._update_eval_status(evaluation, "failed", str(err))
                return err
            if done:
                break
        else:
            self._update_eval_status(
                evaluation, "failed",
                f"maximum attempts reached ({self.max_attempts})")
            return None
        self._finalize(evaluation)
        return None

    def _finalize(self, evaluation: Evaluation) -> None:
        # blocked eval for unplaced allocs (reference: ensureBlockedEval)
        if self.failed_tg_allocs and evaluation.triggered_by != TRIGGER_QUEUED_ALLOCS:
            blocked = evaluation.create_blocked_eval(
                class_eligibility={}, escaped=True,
                failed_tg_allocs=self.failed_tg_allocs)
            # the state index this scheduling pass saw: the blocked-evals
            # tracker re-enqueues instead of parking when capacity
            # changed after it (block-time race guard)
            blocked.snapshot_index = getattr(self.state, "index", 0)
            self.planner.create_eval(blocked)
            evaluation.blocked_eval = blocked.id
        self._update_eval_status(evaluation, EVAL_STATUS_COMPLETE, "")

    def _update_eval_status(self, evaluation: Evaluation, status: str,
                            desc: str) -> None:
        e = evaluation.copy()
        e.status = status
        e.status_description = desc
        e.queued_allocations = dict(self.queued_allocs)
        e.failed_tg_allocs = dict(self.failed_tg_allocs)
        self.planner.update_eval(e)
        if status in (EVAL_STATUS_COMPLETE, "failed"):
            from nomad_tpu_torch.core.explain import record_decision
            record_decision(self.planner, e, self._tg_stats, now=self.now,
                            snapshot_index=getattr(self.state, "index", 0))

    def _note_placed(self, tg_name: str, metric: AllocMetric, n: int = 1,
                     evictions=()) -> None:
        """Decision-record capture for successful placements: counts,
        the first (representative) metric + its interned top-k table,
        and a bounded sample of preemption victims."""
        st = self._tg_stats.get(tg_name)
        if st is None:
            self._tg_stats[tg_name] = st = {
                "placed": 0, "preempted": 0, "preempted_ids": [],
                "metric": None, "score_meta": ()}
        st["placed"] += n
        if st["metric"] is None:
            st["metric"] = metric
            st["score_meta"] = metric.score_meta_data
        if evictions:
            st["preempted"] += len(evictions)
            ids = st["preempted_ids"]
            if len(ids) < 16:
                ids.extend(v.id for v in evictions[:16 - len(ids)])

    # ------------------------------------------------------- batched path

    class BatchPrep:
        """One batch-eligible eval's reconcile output: `count` fresh
        placements of `tg` — either a compact PlaceBlock (count >= 64)
        or a list of fresh PlaceRequests (small evals, THE case the
        multi-eval launch amortizes)."""
        __slots__ = ("job", "tg", "count", "block", "places", "results")

        def __init__(self, job, tg, count, block, places, results):
            self.job = job
            self.tg = tg
            self.count = count
            self.block = block
            self.places = places
            self.results = results

    def prepare_batch(self, evaluation: Evaluation):
        """Phase 1 of the multi-eval batched path (reference contrast:
        nomad/worker.go runs one eval per goroutine; here compatible
        evals share ONE device launch): run the reconcile phase only and
        decide whether this eval is the batchable shape — ONLY fresh
        placements of one task group and nothing else (no stops, updates,
        reschedules, deployment activity), with no spread /
        distinct_property / device asks (those need the exact scan
        kernel's per-placement state).  Returns a BatchPrep or None
        (caller processes the eval through the normal path)."""
        if evaluation.annotate_plan:
            return None          # dry-run diffs ride the normal path
        state = self.state
        job = state.job_by_id(evaluation.namespace, evaluation.job_id)
        if job is None or job.stopped():
            return None
        allocs = state.allocs_by_job(evaluation.namespace, evaluation.job_id)
        tainted = tainted_nodes(state, allocs)
        deployment = state.latest_deployment_by_job(
            evaluation.namespace, evaluation.job_id)
        results = reconcile(job, False, allocs, tainted, self.now,
                            existing_deployment=deployment)
        if (results.stop or results.inplace_update
                or results.destructive_update or results.reschedule_later
                or results.deployment is not None
                or results.deployment_updates):
            return None
        block = None
        places = None
        if len(results.place_blocks) == 1 and not results.place:
            block = results.place_blocks[0]
            tg = block.tg
            count = len(block.indexes)
        elif results.place and not results.place_blocks:
            places = results.place
            tg = places[0].tg
            if any(p.tg is not tg or p.previous_alloc is not None
                   or p.canary for p in places):
                return None      # reschedules/canaries: exact path
            count = len(places)
        else:
            return None
        if count < 1:
            return None
        if job.spreads or tg.spreads:
            return None
        from nomad_tpu_torch.structs import OP_DISTINCT_PROPERTY
        cons = (list(job.constraints) + list(tg.constraints)
                + [c for task in tg.tasks for c in task.constraints])
        if any(c.operand == OP_DISTINCT_PROPERTY for c in cons):
            return None
        from .device import tg_device_requests
        if tg_device_requests(tg):
            return None
        # Networked groups RIDE the batch (round-5 verdict #6), and
        # since ISSUE 8 they ride the COLUMNAR block path too: the
        # worker threads ONE NetworkIndex cache through every batch
        # mate's materialize pass (materialization is sequential in the
        # worker thread), and each mate's dynamic ports are carved in a
        # single batched per-node pass (_carve_ports_batch) that lands
        # as port columns on the AllocBlock — batch-mates landing on one
        # node commit disjoint ports without per-alloc index round
        # trips.  Safety net: port-carrying plans are demoted from the
        # applier's skip-fit to the full re-check, which audits block
        # ports per node (plan_apply._carries_host_assigned /
        # _eval_blocks).
        return self.BatchPrep(job, tg, count, block, places, results)

    def submit_batched(self, evaluation: Evaluation, prep, bd,
                       coupled_batch=None, net_index_cache=None):
        """Phase 2a of the batched path: materialize + ENQUEUE the plan
        without waiting for the applier — the worker submits a whole
        coupled chain first, so plan apply overlaps the next plan's
        materialization.  Returns an opaque handle for finalize_batched,
        or None when the eval needs the solo path (no decisions, or
        preemption could still place failed picks — the batch kernel
        never preempts)."""
        from nomad_tpu_torch.ops.preempt import preemption_enabled
        job, results = prep.job, prep.results
        if bd is None:
            return None
        if ((bd.picks < 0).any()
                and preemption_enabled(self.state.scheduler_config(),
                                       job.type)):
            return None
        self.failed_tg_allocs = {}
        self.queued_allocs = {tg.name: 0 for tg in job.task_groups}
        self._tg_stats = {}
        plan = Plan(eval_id=evaluation.id, priority=evaluation.priority,
                    job=job, coupled_batch=coupled_batch)
        self._materialize_bulk(plan, job, prep.places, bd, evaluation,
                               results, block=prep.block,
                               net_idx=net_index_cache)
        if plan.is_no_op():
            self._finalize(evaluation)
            return ("done", None)
        submit = getattr(self.planner, "submit_plan_async", None)
        if submit is None:          # planner without the async surface
            result, refreshed, err = self.planner.submit_plan(plan)
            return ("sync", (plan, result, refreshed, err))
        return ("pending", (plan, submit(plan)))

    def finalize_batched(self, evaluation: Evaluation, handle,
                         pipeline=None) -> Optional[Exception]:
        """Phase 2b: collect the applier's verdict and finish the eval.
        On partial commit, the wavepipe refute-repair path
        (_repair_refuted) masks the refuted nodes into the pipeline and
        re-queues ONLY the refuted rows as a fresh eval for a later wave
        — the committed remainder stays committed and the wave is never
        re-run.  Without a pipeline (solo/sync callers) the original
        full process() retry loop runs instead."""
        kind, payload = handle
        if kind == "done":
            return None
        if kind == "sync":
            plan, result, refreshed_state, err = payload
        else:
            plan, pending = payload
            result, err = pending.wait()
            refreshed_state = None
        if err is not None:
            self._update_eval_status(evaluation, "failed", str(err))
            return err
        if result is not None:
            full, expected, actual = result.full_commit(plan)
            if not full:
                if (pipeline is not None and result.refuted_nodes
                        and plan.alloc_blocks
                        and not plan.node_allocation
                        and evaluation.triggered_by != TRIGGER_PLAN_REFUTE):
                    return self._repair_refuted(
                        evaluation, plan, result, expected - actual,
                        pipeline)
                # partial commit: some nodes were refuted against newer
                # state — re-run the normal retry loop, which reconciles
                # the committed remainder on a fresh snapshot
                if refreshed_state is None:
                    refresh = getattr(self.planner, "refreshed_snapshot",
                                      None)
                    refreshed_state = refresh() if refresh else None
                if refreshed_state is not None:
                    self.state = refreshed_state
                return self.process(evaluation)
        self._finalize(evaluation)
        return None

    def _repair_refuted(self, evaluation: Evaluation, plan: Plan,
                        result, missing: int, pipeline
                        ) -> Optional[Exception]:
        """Refute-repair (core/wavepipe.py): the applier refuted rows of
        this eval's block against newer state.  Instead of re-running
        the whole device launch, (1) the refuted nodes join the
        pipeline's mask so subsequent CHAINED dispatches — whose usage
        buffers predate the refuting write — cannot re-pick them, and
        (2) a fresh pending eval re-places only the `missing` rows in a
        later wave (its reconcile counts the committed remainder, so
        nothing double-commits).  Repair evals that refute AGAIN fall
        back to the normal retry loop (the TRIGGER_PLAN_REFUTE guard in
        finalize_batched) — the repair never recurses."""
        pipeline.note_refuted(result.refuted_nodes)
        tg_name = plan.alloc_blocks[0].template.task_group
        self.queued_allocs[tg_name] = (
            self.queued_allocs.get(tg_name, 0) + missing)
        follow = Evaluation(
            namespace=evaluation.namespace,
            priority=evaluation.priority,
            type=evaluation.type,
            triggered_by=TRIGGER_PLAN_REFUTE,
            job_id=evaluation.job_id,
            previous_eval=evaluation.id,
        )
        self.planner.create_eval(follow)
        self._update_eval_status(
            evaluation, EVAL_STATUS_COMPLETE,
            f"{missing} refuted placement(s) re-queued as {follow.id}")
        return None

    def process_batched(self, evaluation: Evaluation, prep, bd,
                        coupled_batch=None) -> Optional[Exception]:
        """Phase 2, synchronous form: submit + finalize in one call."""
        handle = self.submit_batched(evaluation, prep, bd,
                                     coupled_batch=coupled_batch)
        if handle is None:
            return self.process(evaluation)
        return self.finalize_batched(evaluation, handle)

    # -------------------------------------------------------- single pass

    def _process_once(self, evaluation: Evaluation):
        state = self.state
        job = state.job_by_id(evaluation.namespace, evaluation.job_id)
        allocs = state.allocs_by_job(evaluation.namespace, evaluation.job_id)
        tainted = tainted_nodes(state, allocs)
        stopped = job is None or job.stopped()
        deployment = (state.latest_deployment_by_job(
            evaluation.namespace, evaluation.job_id) if job else None)

        results = reconcile(job, stopped, allocs, tainted, self.now,
                            existing_deployment=deployment)

        plan = Plan(eval_id=evaluation.id, priority=evaluation.priority,
                    job=job)
        if evaluation.annotate_plan:
            plan.annotations = PlanAnnotations(
                desired_tg_updates=results.desired_tg_updates)

        self.failed_tg_allocs = {}
        self.queued_allocs = {tg.name: 0 for tg in job.task_groups} if job else {}
        self._tg_stats = {}

        # ---- stops ----
        for s in results.stop:
            plan.append_stopped_alloc(s.alloc, s.status_description,
                                      client_status=s.client_status)

        # ---- in-place updates ----
        for a in results.inplace_update:
            upd = a.copy_skip_job()
            upd.job = job
            upd.job_version = job.version
            if results.deployment is not None:
                # a running alloc updated in place (count/meta change)
                # joins the deployment already healthy — its tasks never
                # restarted, so there is nothing to re-check, and without
                # this the deployment's desired_total can never be met
                upd.deployment_id = results.deployment.id
                upd.deployment_status = {"healthy": True, "ts": self.now}
            plan.append_alloc(upd)

        # ---- destructive updates: stop old + place new ----
        destructive_places: List[RPlace] = []
        for a in results.destructive_update:
            plan.append_stopped_alloc(
                a, "alloc is being updated due to job update")
            tg = job.lookup_task_group(a.task_group)
            destructive_places.append(RPlace(
                tg=tg, name=a.name, index=a.index(), previous_alloc=a))

        # ---- reschedule-later: follow-up evals + alloc annotations ----
        if results.reschedule_later:
            by_time: Dict[float, List[Allocation]] = {}
            for a, ready_at in results.reschedule_later:
                by_time.setdefault(ready_at, []).append(a)
            for ready_at, late_allocs in sorted(by_time.items()):
                follow = evaluation.create_failed_follow_up_eval(ready_at)
                self.planner.create_eval(follow)
                for a in late_allocs:
                    upd = a.copy_skip_job()
                    upd.job = job
                    upd.followup_eval_id = follow.id
                    plan.append_alloc(upd)

        # ---- placements: one batched device call for the whole eval ----
        all_places = results.place + destructive_places
        blocks = results.place_blocks
        if blocks and (all_places or len(blocks) > 1):
            # mixed placement kinds in one eval: expand the compact blocks
            # so capacity stays coupled in a SINGLE engine call (two calls
            # would each see only state usage, not each other's picks)
            for b in blocks:
                all_places.extend(
                    RPlace(tg=b.tg, name=_name(job, b.tg, ix), index=ix)
                    for ix in b.indexes)
            blocks = []
        if all_places and job is not None:
            self._compute_placements(plan, job, all_places, evaluation,
                                     results)
        elif blocks and job is not None:
            self._compute_placements_block(plan, job, blocks[0],
                                           evaluation, results)

        plan.deployment = results.deployment
        plan.deployment_updates = results.deployment_updates

        if plan.is_no_op():
            return True, None

        # fence-tag from THE snapshot this pass computed against (a chain
        # of length 1): while the applier's placement fence proves no
        # foreign write intervened, its per-node re-fit is provably
        # redundant — the kernels enforced capacity against this exact
        # state.  The re-check exists for optimistic concurrency, which
        # the fence detects precisely.
        fence = getattr(self.state, "placement_fence", None)
        if fence is not None and not plan.host_redirected:
            plan.coupled_batch = (evaluation.id, fence)
        result, refreshed_state, err = self.planner.submit_plan(plan)
        if err is not None:
            return False, err
        if result is not None:
            full, expected, actual = result.full_commit(plan)
            if not full:
                if refreshed_state is not None:
                    self.state = refreshed_state
                return False, None
        return True, None

    # ---------------------------------------------------------- placement

    def _compute_placements(self, plan: Plan, job: Job,
                            places: List[RPlace],
                            evaluation: Evaluation,
                            results: ReconcileResults) -> None:
        tgs = job.task_groups
        reqs = []
        for p in places:
            prev_node = ""
            if p.previous_alloc is not None and p.reschedule:
                prev_node = p.previous_alloc.node_id
            reqs.append(PlacementRequest(tg_name=p.tg.name,
                                         prev_node_id=prev_node))
        # allocs this plan is stopping free their capacity for placement
        stopped = [a for allocs in plan.node_update.values() for a in allocs]
        decisions = self.engine.place(self.state, job, tgs, reqs,
                                      stopped_allocs=stopped, bulk_api=True,
                                      seed=getattr(self, "_seed", 0))
        if isinstance(decisions, BulkDecisions):
            self._materialize_bulk(plan, job, places, decisions,
                                   evaluation, results)
            return
        self._materialize_decisions(plan, job, places, reqs, decisions,
                                    evaluation, results, stopped)

    def _materialize_decisions(self, plan: Plan, job: Job,
                               places: List[RPlace], reqs,
                               decisions, evaluation: Evaluation,
                               results: ReconcileResults,
                               stopped) -> None:
        """Per-decision alloc construction (ports, devices, reschedule
        trackers) — the tail of `_compute_placements`, shared with the
        block fallback path."""
        tgs = job.task_groups
        # concrete device-instance assignment for groups that ask for
        # devices (reference: scheduler/device.go AllocateDevice); may
        # re-place a subset when a node's instances run out mid-plan
        dev_assign = self._assign_devices(job, tgs, places, reqs,
                                          decisions, stopped)

        # host-side port assignment per chosen node (reference: AllocsFit's
        # NetworkIndex, kept off-device per SURVEY §7 P1).  Preemption
        # victims' ports are freed: exclude them from the index.
        net_idx: Dict[str, NetworkIndex] = {}
        victim_ids = {v.id for d in decisions for v in d.evictions}

        # one combined-resources template per task group.  When the group
        # asks for no ports the template is shared by every alloc of the
        # group (immutable once inserted, the store's ownership convention);
        # with networks each alloc gets a copy carrying its port assignment.
        ask_templates: Dict[str, object] = {}
        # alloc construction is the host-side hot path at bench scale
        # (100k placements/plan): build one fully-initialized template
        # alloc per task group and clone via dict copy instead of running
        # the 40-field dataclass constructor per placement.
        alloc_templates: Dict[str, Allocation] = {}

        for i, (p, d) in enumerate(zip(places, decisions)):
            tg = p.tg
            if d.node_id is None:
                self._record_failure(tg.name, d.metric)
                continue
            ports = None
            ask = ask_templates.get(tg.name)
            if ask is None:
                ask_templates[tg.name] = ask = tg.combined_resources()
            has_net = bool(ask.networks)
            if has_net:
                ask = ask.copy()
            if ask.networks:
                ni = self._net_index(d.node_id, net_idx, victim_ids)
                ports, fail = ni.assign_ports(ask.networks)
                if ports is None:
                    # stock moves to the NEXT candidate when the picked
                    # node can't satisfy the ask (rank.go iterator pull);
                    # the kernel returned its runner-ups in the metric's
                    # top-k — retry them before declaring failure.
                    # Never redirect a placement bound to its node by
                    # evictions or device instances.
                    alt_ports = alt = None
                    if not d.evictions and i not in dev_assign:
                        alt_ports, alt = self._ports_from_runner_up(
                            plan, d.node_id, d.metric.score_meta_data,
                            ask, net_idx, victim_ids, job, tg)
                    if alt_ports is None:
                        d.metric.exhausted_node(fail)
                        self._record_failure(tg.name, d.metric)
                        continue
                    ports = alt_ports
                    d.node_id = alt
                else:
                    ni.commit(ports)

            tmpl = alloc_templates.get(tg.name)
            if tmpl is None:
                alloc_templates[tg.name] = tmpl = Allocation(
                    namespace=job.namespace,
                    eval_id=evaluation.id,
                    job_id=job.id,
                    job=job,
                    task_group=tg.name,
                    desired_status="run",
                    client_status="pending",
                    job_version=job.version,
                    create_time=self.now,
                    modify_time=self.now,
                )
            alloc = Allocation.__new__(Allocation)
            ad = dict(tmpl.__dict__)
            alloc.__dict__ = ad
            ad["id"] = new_id()
            ad["name"] = p.name
            ad["node_id"] = d.node_id
            ad["resources"] = ask
            ad["allocated_ports"] = ports or {}
            ad["allocated_devices"] = dev_assign.get(i, [])
            ad["metrics"] = d.metric
            # per-alloc mutable state: runners write task_states in place
            ad["task_states"] = {}
            if d.evictions:
                for victim in d.evictions:
                    plan.append_preempted_alloc(victim, alloc.id)
                alloc.preempted_allocations = [v.id for v in d.evictions]
            if results.deployment is not None:
                alloc.deployment_id = results.deployment.id
                if p.canary:
                    dstate = results.deployment.task_groups.get(tg.name)
                    if dstate is not None:
                        dstate.placed_canaries.append(alloc.id)
            if p.previous_alloc is not None:
                alloc.previous_allocation = p.previous_alloc.id
                if p.reschedule:
                    from .util import append_reschedule_tracker
                    append_reschedule_tracker(alloc, p.previous_alloc, self.now)
                    alloc.desired_description = ALLOC_RESCHEDULED
            plan.append_alloc(alloc)
            self._note_placed(tg.name, d.metric, evictions=d.evictions)

    @staticmethod
    def _net_columnar_labels(ask) -> Optional[List[str]]:
        """The batched-carve-eligible network shape: ONE host network,
        no static (reserved) ports, uniquely-labeled dynamic ports.
        Anything else — static asks, multi-network, unlabeled or
        duplicate labels — rides the sequential per-alloc path, which
        doubles as the parity oracle (ISSUE 8)."""
        if len(ask.networks) != 1:
            return None
        net = ask.networks[0]
        if net.reserved_ports or not net.dynamic_ports:
            return None
        labels = [p.label for p in net.dynamic_ports]
        if not all(labels) or len(set(labels)) != len(labels):
            return None
        return labels

    def _carve_ports_batch(self, picks_ok, node_ids, n_labels: int,
                           net_idx, victim_ids):
        """Vectorized per-node offset scheme (ISSUE 8): group the wave's
        placements by node, pre-check every node's free dynamic pool
        against its cumulative demand, then carve each node's ports in
        ONE cursor pass and scatter them back to rows in row order.
        Bit-for-bit the sequential per-alloc result — mates landing on
        one node take ascending first-fit ports in row order, exactly as
        N ordered assign_ports calls would — without the N sequential
        index round-trips.  Returns an [n_ok, n_labels] int32 array, or
        None when any node is short (NOTHING committed — the feasibility
        pass runs before any claim, so a mid-wave shortfall cannot leak
        partial claims into the batch-shared index)."""
        import numpy as np
        uniq, inv = np.unique(picks_ok, return_inverse=True)
        counts = np.bincount(inv, minlength=len(uniq)).tolist()
        indexes = []
        for r, k in zip(uniq.tolist(), counts):
            ni = self._net_index(node_ids[int(r)], net_idx, victim_ids)
            if ni.dyn_free_count() < k * n_labels:
                return None
            indexes.append(ni)
        out = np.empty((len(picks_ok), n_labels), np.int32)
        order = np.argsort(inv, kind="stable")
        pos = 0
        for ni, k in zip(indexes, counts):
            got = ni.claim_dynamic_block(k * n_labels)
            out[order[pos:pos + k]] = np.asarray(
                got, np.int32).reshape(k, n_labels)
            pos += k
        return out

    def _net_index(self, node_id: str, cache: Dict[str, NetworkIndex],
                   victim_ids) -> NetworkIndex:
        """Per-node port bookkeeping for this plan, built lazily
        (preemption victims' ports count as free)."""
        ni = cache.get(node_id)
        if ni is None:
            ni = NetworkIndex()
            node = self.state.node_by_id(node_id)
            if node is not None:
                ni.set_node(node)
            ni.add_allocs(a for a in self.state.allocs_by_node(node_id)
                          if a.id not in victim_ids)
            cache[node_id] = ni
        return ni

    def _ports_from_runner_up(self, plan: Plan, picked_node: str,
                              score_meta, ask, net_idx, victim_ids,
                              job, tg):
        """Port exhaustion on the picked node: try the top-k runner-up
        rows (reference: the rank iterator simply pulls the next
        candidate).  Returns (ports, runner_up_node_id) or (None, None).
        On success the PLAN loses its fence — the kernel's capacity
        accounting assumed the original pick, so the applier must run
        the full AllocsFit re-check; the caller moves the placement.
        The candidate must also pass a host-side capacity check against
        existing + in-plan allocs (the kernel verified the ORIGINAL
        node, not this one).

        Callers must NOT redirect placements that carry preemption
        victims or device-instance assignments: both are bound to the
        ORIGINAL node (victims evicted there; instances exist there) and
        would be orphaned by the move.  distinct_hosts groups never
        redirect either — the kernel enforced the one-per-node limit for
        the original pick only."""
        from nomad_tpu_torch.structs import (OP_DISTINCT_HOSTS,
                                       OP_DISTINCT_PROPERTY)
        cons = (list(job.constraints) + list(tg.constraints)
                + [c for task in tg.tasks for c in task.constraints])
        if any(c.operand in (OP_DISTINCT_HOSTS, OP_DISTINCT_PROPERTY)
               for c in cons):
            # the kernel enforced per-node/per-property limits for the
            # ORIGINAL pick only; a host-side move could violate them
            # invisibly (allocs_fit checks neither)
            return None, None
        # ALL top-k entries are candidates: for round-shared bulk
        # metrics, entry 0 is the round's best node, not necessarily
        # this placement's pick (the picked-node filter below covers
        # the per-decision case where entry 0 IS the pick)
        for meta in score_meta:
            alt = meta.node_id
            if not alt or alt == picked_node:
                continue
            if not self._alt_fits(plan, alt, ask):
                continue
            ni = self._net_index(alt, net_idx, victim_ids)
            ports, _ = ni.assign_ports(ask.networks)
            if ports is None:
                continue
            ni.commit(ports)
            # host-side redirection invalidates the device's coupled
            # capacity view (the flag also blocks the fence-tag step)
            plan.coupled_batch = None
            plan.host_redirected = True
            return ports, alt
        return None, None

    def _alt_fits(self, plan: Plan, node_id: str, ask) -> bool:
        """Capacity check for a redirect candidate: existing live allocs
        + this plan's placements on the node + the ask must fit (the
        applier re-checks too — this avoids redirecting into a
        guaranteed refute)."""
        node = self.state.node_by_id(node_id)
        if node is None or node.status == "down":
            return False
        cpu = mem = disk = 0
        for a in self.state.allocs_by_node(node_id):
            if a.terminal_status():
                continue
            cpu += a.resources.cpu
            mem += a.resources.memory_mb
            disk += a.resources.disk_mb
        for a in plan.node_allocation.get(node_id, ()):
            cpu += a.resources.cpu
            mem += a.resources.memory_mb
            disk += a.resources.disk_mb
        # columnar blocks bypass node_allocation: count their load too
        for block in plan.alloc_blocks:
            i = block.node_table.index(node_id) \
                if node_id in block.node_table else -1
            if i >= 0:
                k = int(block.node_counts()[i])
                r = block.template.resources
                cpu += k * r.cpu
                mem += k * r.memory_mb
                disk += k * r.disk_mb
        return (cpu + ask.cpu <= node.resources.cpu - node.reserved.cpu
                and mem + ask.memory_mb
                <= node.resources.memory_mb - node.reserved.memory_mb
                and disk + ask.disk_mb
                <= node.resources.disk_mb - node.reserved.disk_mb)

    def _compute_placements_block(self, plan: Plan, job: Job, block,
                                  evaluation: Evaluation,
                                  results: ReconcileResults) -> None:
        """Compact twin of `_compute_placements` for one PlaceBlock: no
        per-placement request objects anywhere — the engine gets
        (task group, count) and the bulk decisions materialize with names
        derived from the block's index list."""
        stopped = [a for allocs in plan.node_update.values() for a in allocs]
        decisions = self.engine.place(
            self.state, job, job.task_groups, None,
            stopped_allocs=stopped, bulk_api=True,
            seed=getattr(self, "_seed", 0),
            block=(block.tg.name, len(block.indexes)))
        if isinstance(decisions, BulkDecisions):
            self._materialize_bulk(plan, job, None, decisions,
                                   evaluation, results, block=block)
            return
        # engine fell back (spread/devices/small count): expand and run
        # the general path with the decisions it already computed
        places = [RPlace(tg=block.tg, name=_name(job, block.tg, ix),
                         index=ix) for ix in block.indexes]
        reqs = [PlacementRequest(tg_name=block.tg.name)] * len(places)
        self._materialize_decisions(plan, job, places, reqs, decisions,
                                    evaluation, results, stopped)

    def _assign_devices(self, job, tgs, places, reqs, decisions, stopped):
        """Pick concrete device instances for every placement whose task
        group requests devices (reference: scheduler/device.go
        AllocateDevice called from BinPackIterator).

        The kernel's [G, N] device mask was computed against the snapshot,
        so a node can run out of instances mid-plan (several placements
        landing on it).  Failed assignments are re-placed through the
        engine with the in-plan usage overlay visible (up to 3 rounds —
        the host-side twin of the kernel's sequential-capacity scan);
        still-failing placements become normal placement failures with the
        exhausted dimension recorded.  Mutates `decisions` in place and
        returns {placement_index: [AllocatedDeviceResource]}."""
        from .device import InUseIndex, assign_devices, tg_device_requests

        tg_has_dev = {tg.name: bool(tg_device_requests(tg)) for tg in tgs}
        if not any(tg_has_dev.values()):
            return {}
        dev_assign: Dict[int, list] = {}
        stopped_ids = {a.id for a in stopped}
        dev_index = InUseIndex()
        seeded = set()

        def seed(node_id: str) -> None:
            # preemption victims are conservatively NOT excluded: their
            # instances stay unavailable within this plan
            if node_id in seeded:
                return
            seeded.add(node_id)
            for a in self.state.allocs_by_node(node_id):
                if a.terminal_status() or a.id in stopped_ids:
                    continue
                dev_index.add_alloc(node_id, a)

        pending = [i for i, p in enumerate(places)
                   if tg_has_dev[p.tg.name]]
        for round_no in range(3):
            failed = []
            for i in pending:
                d = decisions[i]
                if d.node_id is None:
                    continue
                node = self.state.node_by_id(d.node_id)
                if node is None:
                    failed.append(i)
                    continue
                seed(d.node_id)
                assigned, why = assign_devices(node, places[i].tg, dev_index)
                if assigned is None:
                    failed.append(i)
                else:
                    dev_assign[i] = assigned
            if not failed:
                return dev_assign
            if round_no == 2:
                break
            redo = self.engine.place(
                self.state, job, tgs, [reqs[i] for i in failed],
                stopped_allocs=stopped, seed=getattr(self, "_seed", 0),
                device_in_use=dev_index)
            for i, d_new in zip(failed, redo):
                if d_new.node_id is None:
                    # the first pass found a device node; the re-place
                    # lost it to in-plan instance consumption — that is
                    # exhaustion, not filtering (reference: AllocMetric
                    # DimensionExhausted["devices"])
                    d_new.metric.exhausted_node("devices")
                decisions[i] = d_new
            pending = failed
        for i in failed:
            d = decisions[i]
            if d.node_id is not None:
                d.metric.exhausted_node("devices")
                d.node_id = None
                d.evictions = []
        return dev_assign

    def _materialize_bulk(self, plan: Plan, job: Job,
                          places: Optional[List[RPlace]], bd,
                          evaluation: Evaluation,
                          results: ReconcileResults,
                          block=None, net_idx=None) -> None:
        """Materialize allocations straight from a BulkDecisions array —
        the per-placement twin loop of `_compute_placements`, with every
        per-alloc object cost stripped: template-dict clones, batched ids,
        a shared per-round AllocMetric, and a shared resources object when
        the group asks for no ports.  With `block` (compact path) names
        come straight from the index list — no RPlace objects exist."""
        tg = block.tg if block is not None else places[0].tg
        ask = tg.combined_resources()
        has_net = bool(ask.networks)
        tmpl = Allocation(
            namespace=job.namespace,
            eval_id=evaluation.id,
            job_id=job.id,
            job=job,
            task_group=tg.name,
            resources=ask,
            desired_status="run",
            client_status="pending",
            job_version=job.version,
            create_time=self.now,
            modify_time=self.now,
        )
        if results.deployment is not None:
            tmpl.deployment_id = results.deployment.id
        tmpl_d = tmpl.__dict__
        count = len(block.indexes) if block is not None else len(places)
        ids = new_ids(count)
        node_ids = bd.node_ids
        metrics = bd.metrics
        rs = bd.round_size
        node_alloc = plan.node_allocation
        victim_ids = {v.id for vs in bd.evictions.values() for v in vs}
        # `net_idx` may be the BATCH-SHARED port cache (see prepare_batch:
        # batch mates materialize sequentially and must see each other's
        # in-plan port commitments); coupled batches never carry
        # evictions, so the victim set is empty whenever the cache is
        # shared and the per-plan victim semantics cannot diverge
        if net_idx is None:
            net_idx = {}
        last_nid = None
        last_list = None
        if block is not None:
            prefix = f"{job.id}.{tg.name}["     # matches reconcile._name
            indexes = block.indexes

        net_labels = (self._net_columnar_labels(ask)
                      if has_net and PORT_BATCHED and block is not None
                      else None)
        if (block is not None and not bd.evictions
                and results.deployment is None
                and (not has_net or net_labels is not None)):
            # hottest shape (the bench/batch pattern): fresh block, no
            # preemptions — stays COLUMNAR end-to-end: the picks array +
            # shared template become one AllocBlock on the plan;
            # per-alloc objects never exist on this path (the store
            # materializes them lazily on first read).  Networked groups
            # now ride it too (ISSUE 8): dynamic ports are carved per
            # node in ONE batched pass (bit-for-bit the sequential
            # result) and land as port COLUMNS on the block.
            import numpy as np

            from nomad_tpu_torch.structs import AllocBlock
            picks = bd.picks
            ok_mask = picks >= 0
            n_ok = int(ok_mask.sum())
            n_fail = count - n_ok
            picks_ok = (picks[ok_mask] if n_fail else picks) if n_ok \
                else picks[:0]
            ports_arr = None
            if has_net and n_ok:
                # carve BEFORE any failure accounting: a short node
                # falls the whole eval back to the sequential per-alloc
                # oracle below, which keeps its own failure counters
                ports_arr = self._carve_ports_batch(
                    picks_ok, node_ids, len(net_labels), net_idx,
                    victim_ids)
            if not has_net or n_ok == 0 or ports_arr is not None:
                if n_fail:
                    # aggregate failure accounting: one stored metric
                    # (the first failing round's), coalesced + queued
                    # counters match the per-pick loop's totals
                    tg_name = tg.name
                    first_fail = int(np.argmin(ok_mask))
                    m = metrics[min(first_fail // rs, len(metrics) - 1)]
                    self._record_failure_shared(tg_name, m)
                    if n_fail > 1:
                        self.failed_tg_allocs[tg_name].coalesced_failures \
                            += n_fail - 1
                        self.queued_allocs[tg_name] = \
                            self.queued_allocs.get(tg_name, 0) + n_fail - 1
                if n_ok == 0:
                    return
                if n_fail:
                    import itertools
                    sel = ok_mask.tolist()
                    ids_ok = list(itertools.compress(ids, sel))
                    idx_ok = list(itertools.compress(indexes, sel))
                else:
                    ids_ok = ids
                    idx_ok = list(indexes)
                self._note_placed(tg.name, metrics[0], n=n_ok)
                if ports_arr is not None:
                    self.last_port_carve = n_ok
                    from nomad_tpu_torch.core.telemetry import REGISTRY
                    REGISTRY.inc("nomad.ports.batched_rows", n_ok)
                # block-local node table: unique picked rows only
                # (hundreds), never the full cluster table
                uniq, inv = np.unique(picks_ok, return_inverse=True)
                plan.alloc_blocks.append(AllocBlock(
                    id=new_id(),
                    template=tmpl,
                    ids=ids_ok,
                    name_prefix=prefix,
                    indexes=idx_ok,
                    picks=inv.astype(np.int32),
                    node_table=[node_ids[int(r)] for r in uniq],
                    metrics=list(metrics),
                    round_size=rs,
                    port_labels=(list(net_labels)
                                 if ports_arr is not None else []),
                    ports=ports_arr,
                ))
                return
            # a node's dynamic pool was short of the wave's demand:
            # sequential per-alloc oracle below (runner-up redirects,
            # per-port exhaustion dimensions)

        picks_l = bd.picks.tolist()
        placed_n = 0          # decision-record capture, noted ONCE below
        victims_sample: List = []
        victims_n = 0
        for i in range(count):
            p = places[i] if block is None else None
            pick = picks_l[i]
            m = metrics[i // rs]
            if pick < 0:
                self._record_failure_shared(tg.name, m)
                continue
            nid = node_ids[pick]
            alloc = Allocation.__new__(Allocation)
            d2 = dict(tmpl_d)
            alloc.__dict__ = d2
            d2["id"] = ids[i]
            d2["name"] = (prefix + str(indexes[i]) + "]"
                          if block is not None else p.name)
            d2["node_id"] = nid
            d2["metrics"] = m
            d2["task_states"] = {}
            if has_net:
                a2 = ask.copy()
                ni = self._net_index(nid, net_idx, victim_ids)
                ports, fail = ni.assign_ports(a2.networks)
                if ports is not None:
                    ni.commit(ports)
                elif not bd.evictions.get(i):
                    # retry the round's top-k runner-ups (stock pulls the
                    # next candidate on exhaustion — rank.go iterator);
                    # eviction-backed placements stay put (victims are
                    # bound to the original node)
                    ports, alt = self._ports_from_runner_up(
                        plan, nid, m.score_meta_data, a2, net_idx,
                        victim_ids, job, tg)
                    if ports is not None:
                        nid = alt
                        d2["node_id"] = alt
                if ports is None:
                    # never mutate the round-shared metric: exhausted_node
                    # writes dimension_exhausted on a private copy
                    fm = m.copy()
                    fm.exhausted_node(fail)
                    self._record_failure_shared(tg.name, fm, copied=True)
                    continue
                d2["resources"] = a2
                d2["allocated_ports"] = ports
            ev = bd.evictions.get(i)
            if ev:
                for victim in ev:
                    plan.append_preempted_alloc(victim, alloc.id)
                d2["preempted_allocations"] = [v.id for v in ev]
                victims_n += len(ev)
                if len(victims_sample) < 16:
                    victims_sample.extend(ev[:16 - len(victims_sample)])
            if p is not None and p.canary and results.deployment is not None:
                dstate = results.deployment.task_groups.get(tg.name)
                if dstate is not None:
                    dstate.placed_canaries.append(alloc.id)
            if p is not None and p.previous_alloc is not None:
                d2["previous_allocation"] = p.previous_alloc.id
                if p.reschedule:
                    from .util import append_reschedule_tracker
                    append_reschedule_tracker(alloc, p.previous_alloc,
                                              self.now)
                    d2["desired_description"] = ALLOC_RESCHEDULED
            if nid is last_nid:
                last_list.append(alloc)
            else:
                last_nid = nid
                last_list = node_alloc.get(nid)
                if last_list is None:
                    node_alloc[nid] = last_list = []
                last_list.append(alloc)
            placed_n += 1
        if placed_n:
            self._note_placed(tg.name, metrics[0], n=placed_n,
                              evictions=victims_sample)
            if victims_n > len(victims_sample):
                self._tg_stats[tg.name]["preempted"] += (
                    victims_n - len(victims_sample))
            if has_net:
                # the sequential oracle ran (ineligible shape, pool
                # shortfall, or PORT_BATCHED off): meter it so the
                # batched-vs-sequential split is visible in /v1/metrics
                from nomad_tpu_torch.core.telemetry import REGISTRY
                REGISTRY.inc("nomad.ports.sequential_rows", placed_n)

    def _record_failure_shared(self, tg_name: str, metric: AllocMetric,
                               copied: bool = False) -> None:
        """_record_failure for metrics shared across a bulk round: the
        stored (mutated) instance must not be the one attached to placed
        allocs, so the first failure stores a copy with its own mutable
        counter dicts."""
        if tg_name in self.failed_tg_allocs:
            # only the coalesced counter is bumped; skip the dict copies
            # (a full-cluster 100k-placement failure calls this per pick)
            self._record_failure(tg_name, metric)
        else:
            self._record_failure(
                tg_name, metric if copied else metric.copy())

    def _record_failure(self, tg_name: str, metric: AllocMetric) -> None:
        prev = self.failed_tg_allocs.get(tg_name)
        if prev is not None:
            prev.coalesced_failures += 1
        else:
            self.failed_tg_allocs[tg_name] = metric
        self.queued_allocs[tg_name] = self.queued_allocs.get(tg_name, 0) + 1


def new_service_scheduler(state, planner, **kwargs) -> GenericScheduler:
    return GenericScheduler(state, planner, is_batch=False, **kwargs)


def new_batch_scheduler(state, planner, **kwargs) -> GenericScheduler:
    return GenericScheduler(state, planner, is_batch=True, **kwargs)
