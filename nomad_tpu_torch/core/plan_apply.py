"""Plan queue + serialized plan applier
(reference: nomad/plan_queue.go, nomad/plan_apply.go).

THE serialization point of the whole system: workers submit plans built
against possibly-stale snapshots; the applier pops them in priority order,
re-checks every touched node against the *latest* state (AllocsFit with the
plan's own stops folded in), drops refuted nodes (partial commit), and
commits the remainder atomically.  Optimistic concurrency between parallel
eval workers becomes refuted plans, never corrupted state — the reference's
"races are tested, not prevented" posture (SURVEY.md §6.2).
"""

from __future__ import annotations

import contextlib
import heapq
import itertools
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from nomad_tpu_torch.chaos.clock import Clock, SystemClock
from nomad_tpu_torch.core import profiling
from nomad_tpu_torch.core.flightrec import FLIGHT
from nomad_tpu_torch.core.logging import log, trace_scope
from nomad_tpu_torch.core.telemetry import (
    REGISTRY,
    TRACER,
    StatCounters,
    span_id,
)
from nomad_tpu_torch.state import StateStore
from nomad_tpu_torch.structs import (
    Allocation,
    NetworkIndex,
    Plan,
    PlanResult,
    allocs_fit,
)

# _node_plan_ok verdicts: claim refusals are RETRIABLE within the plan's
# fixpoint pass (a later node's accepted release can clear them); node-down
# and fit failures are final.
NODE_OK = 0
NODE_REFUSED = 1
NODE_CLAIM_REFUSED = 2


class StaleDeliveryError(Exception):
    """The plan's eval delivery token was superseded by a redelivery."""

_NULL_GUARD = contextlib.nullcontext()


def publish_quality(state, registry=REGISTRY) -> None:
    """Feed the live scheduling-quality gauges (the runtime counterpart
    of bench.py's quality_* keys) from the store's incremental ledger:
    nodes-in-use, per-zone alloc balance, and mean bin-pack fill per
    dimension.  Called throttled from the plan applier after commits and
    from the agent's metrics scrape."""
    summary = getattr(state, "quality_summary", None)
    if summary is None:
        return
    q = summary()
    registry.set_gauge("nomad.quality.nodes_in_use", q["nodes_in_use"])
    registry.set_gauge("nomad.quality.zone_allocs_max",
                       q["zone_allocs_max"])
    registry.set_gauge("nomad.quality.zone_allocs_min",
                       q["zone_allocs_min"])
    registry.set_gauge("nomad.quality.zone_balance_max_over_min",
                       round(q["zone_balance_max_over_min"], 6))
    for dim in ("cpu", "memory", "disk"):
        registry.set_gauge("nomad.quality.binpack_fill",
                           round(q[f"fill_{dim}"], 6), dimension=dim)


@dataclass
class PendingPlan:
    plan: Plan
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[PlanResult] = None
    error: Optional[Exception] = None
    # plan-queue latency (enqueue -> responded), the north-star's second
    # metric (BASELINE.json: p99 plan-queue latency; reference telemetry:
    # nomad.plan.queue_depth / nomad.plan.submit)
    enqueue_t: float = 0.0
    queue: Optional["PlanQueue"] = None

    def respond(self, result: Optional[PlanResult],
                error: Optional[Exception]) -> None:
        self.result = result
        self.error = error
        if self.queue is not None and self.enqueue_t:
            self.queue.record_latency(
                self.queue.clock.monotonic() - self.enqueue_t)
        self.done.set()

    def wait(self, timeout: float = 30.0
             ) -> Tuple[Optional[PlanResult], Optional[Exception]]:
        if not self.done.wait(timeout):
            return None, TimeoutError("plan apply timed out")
        return self.result, self.error


class PlanQueue:
    """Leader-side priority heap of submitted plans."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._enabled = False
        self._seq = itertools.count()
        self._heap: List[Tuple[int, int, PendingPlan]] = []
        # queue-latency timebase, replaced by the Server with its
        # injected clock so virtual-time runs measure virtual waits
        self.clock: Clock = SystemClock()
        self.stats = StatCounters("nomad.plan.queue",
                                  ("depth_peak", "submitted"))
        # ring of recent enqueue->respond latencies (seconds); feeds the
        # /v1/metrics p50/p99 gauges and the bench's p99 measurement
        self.latencies: deque = deque(maxlen=16384)

    def record_latency(self, seconds: float) -> None:
        self.latencies.append(seconds)

    def latency_quantiles(self, qs=(0.5, 0.99)) -> Dict[str, float]:
        """Quantiles (seconds) over the recent-latency ring."""
        lat = sorted(self.latencies)
        if not lat:
            return {f"p{int(q * 100)}": 0.0 for q in qs}
        return {f"p{int(q * 100)}":
                lat[min(int(q * (len(lat) - 1) + 0.5), len(lat) - 1)]
                for q in qs}

    def set_enabled(self, enabled: bool) -> None:
        with self._lock:
            self._enabled = enabled
            if not enabled:
                for _, _, p in self._heap:
                    p.respond(None, RuntimeError("plan queue disabled"))
                self._heap.clear()
            self._cv.notify_all()

    def enqueue(self, plan: Plan) -> PendingPlan:
        with self._lock:
            if not self._enabled:
                p = PendingPlan(plan)
                p.respond(None, RuntimeError("plan queue disabled"))
                return p
            pending = PendingPlan(plan, enqueue_t=self.clock.monotonic(),
                                  queue=self)
            heapq.heappush(self._heap,
                           (-plan.priority, next(self._seq), pending))
            self.stats["depth_peak"] = max(self.stats["depth_peak"],
                                           len(self._heap))
            self._cv.notify()
        self.stats.inc("submitted")
        return pending

    def dequeue(self, timeout: Optional[float] = None) -> Optional[PendingPlan]:
        with self._cv:
            if not self._heap:
                self._cv.wait(timeout=timeout)
            if not self._heap:
                return None
            return heapq.heappop(self._heap)[2]

    def depth(self) -> int:
        with self._lock:
            return len(self._heap)


class PlanApplier:
    """Serialized plan evaluation + commit (reference: planApply loop)."""

    def __init__(self, state: StateStore, queue: PlanQueue) -> None:
        self.state = state
        self.queue = queue
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Coupled-batch fast path, fenced PER NODE: a fenced plan's
        # AllocsFit re-check is provably redundant while each of its
        # placement nodes was last written either BEFORE the plan's
        # snapshot or BY the plan's own chain — chain plans were
        # co-computed on device against shared proposed capacity and
        # cannot oversubscribe a node collectively.  A foreign write to
        # one of the plan's nodes restores the full re-check for that
        # plan only; disjoint concurrent workers (zone-partitioned
        # batches) never demote each other (optimistic-concurrency safety
        # exactly as the reference's evaluatePlan, at the reference's own
        # per-node granularity).
        self.stats = StatCounters("nomad.plan", (
            "fast_path", "full_check", "stale_token",
            "plans", "plans_refuted"))
        # queue-wait/apply timebase (Server injects its clock)
        self.clock: Clock = SystemClock()
        # optional (eval_id, token) -> bool gate, wired by the Server to
        # the eval broker: plans from a SUPERSEDED delivery (the eval was
        # redelivered while this worker sat in a device compile) are
        # rejected instead of double-committing (reference: the EvalToken
        # check at plan submission)
        self.token_check = None
        # optional wavepipe.StageTimers (wired by the Server): each
        # apply records one "commit" interval so the pipeline's overlap
        # of host commit under device compute is measurable
        self.timers = None
        # optional DeviceExecutor (wired by the Server): every committed
        # plan reports its origin so a resident usage chain the commit
        # is FOREIGN to gets invalidated (ops/executor.py)
        self.executor = None
        # optional hook (wired by the Server): allocs this commit
        # preempted belong to OTHER jobs, which now run below their
        # desired count — they need follow-up evals or the evicted work
        # is never replaced (reference: planApply's preemption evals)
        self.on_preempted = None
        # scheduling-quality gauge refresh, throttled: the summary walk
        # is O(nodes in use), so a 100-plan/s wave refreshes once per
        # interval instead of per plan (PERF.md §11: soak budget)
        self.quality_interval = 1.0
        self._quality_next = 0.0

    # ------------------------------------------------------------ running

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, name="plan-applier",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self.queue.set_enabled(False)
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _run(self) -> None:
        while not self._stop.is_set():
            # apply_one responds errors to the submitter; an exception
            # escaping the dequeue/timer path would silently kill THE
            # serialization point of the whole system — log and continue
            try:
                # profiling marker: the dequeue is the applier's park
                # point — without it a sampled Condition.wait frame is
                # heuristically classified; the marker makes the
                # applier's idle share exact (core/profiling.py)
                with profiling.activity("idle"):
                    pending = self.queue.dequeue(timeout=0.1)
                if pending is None:
                    continue
                self.apply_one(pending)
            except Exception as exc:  # noqa: BLE001 - keep the loop alive
                log("plan", "warn", "applier iteration failed",
                    error=repr(exc))

    # ------------------------------------------------------------- apply

    @staticmethod
    def _plan_nodes(plan: Plan):
        """The plan's placement nodes — what the per-node fence covers."""
        nodes = set(plan.node_allocation)
        for block in plan.alloc_blocks:
            nodes.update(block.node_table)
        return nodes

    def apply_one(self, pending: PendingPlan) -> None:
        plan = pending.plan
        t0 = self.clock.monotonic()
        wait = 0.0
        if pending.enqueue_t:
            wait = max(0.0, t0 - pending.enqueue_t)
            # windowed: the p99 plan-queue SLO (core/flightrec.py) reads
            # the rolling view of this series, not the lifetime one
            REGISTRY.observe_windowed("nomad.plan.queue_wait_s", wait)
            if plan.trace_id:
                TRACER.record("plan.queue_wait", plan.trace_id,
                              t0 - wait, t0,
                              parent=span_id(plan.trace_id,
                                             "worker.schedule"),
                              eval_id=plan.eval_id)
        with trace_scope(plan.trace_id):
            if self.timers is not None:
                with self.timers.time("commit"):
                    self._apply_one(pending)
            else:
                self._apply_one(pending)
        t1 = self.clock.monotonic()
        REGISTRY.observe("nomad.plan.apply_s", t1 - t0)
        refuted = (len(pending.result.refuted_nodes)
                   if pending.result is not None else 0)
        # eval tail record: merges with the worker's settle stamps under
        # the same eval id (a multi-plan eval accumulates)
        FLIGHT.record_eval(plan.eval_id, queue_wait_s=round(wait, 9),
                           apply_s=round(t1 - t0, 9),
                           refuted_nodes=refuted)
        if plan.trace_id:
            TRACER.record("plan.apply", plan.trace_id, t0, t1,
                          parent=span_id(plan.trace_id, "worker.schedule"),
                          eval_id=plan.eval_id,
                          error=type(pending.error).__name__
                          if pending.error is not None else "",
                          refuted=refuted)

    def _apply_one(self, pending: PendingPlan) -> None:
        plan = pending.plan
        try:
            if (self.token_check is not None and plan.eval_token
                    and not self.token_check(plan.eval_id,
                                             plan.eval_token)):
                self.stats.inc("stale_token")
                pending.respond(None, StaleDeliveryError(
                    f"eval {plan.eval_id} was redelivered; this "
                    "worker's delivery is superseded"))
                return
            # per-node fence decision; the commit re-verifies it under
            # the store lock (upsert_plan_results returns -1 when a
            # foreign write to one of the plan's nodes slipped between
            # the decision and the commit)
            fast = False
            fenced_first = False
            touched = None
            bid = seq0 = None
            if plan.coupled_batch is not None:
                bid, seq0 = plan.coupled_batch
                touched = self._plan_nodes(plan)
                fast = self.state.nodes_unchanged_since(touched, seq0, bid)
                # "first" = not even the plan's own chain has written these
                # nodes: that is where batch-mate port collisions hide, so
                # the port/device demotion keys off it
                fenced_first = fast and self.state.nodes_unchanged_since(
                    touched, seq0, bid, own_chain_ok=False)
            result = self.evaluate_plan(plan, skip_fit=fast,
                                        fenced_first=fenced_first)
            self._stamp_trace(plan, result)
            idx = self.state.upsert_plan_results(
                plan, result,
                expected_nodes=(touched, seq0, bid,
                                getattr(result, "volume_seq", None))
                if fast else None)
            if idx == -1:
                # a foreign write landed on one of the plan's nodes between
                # the fence read and the commit: redo with the full check
                result = self.evaluate_plan(plan, skip_fit=False)
                self._stamp_trace(plan, result)
                self.state.upsert_plan_results(plan, result)
            self.stats.inc("plans")
            if self.executor is not None:
                # chain-coupled plans carry their chain id; solo plans
                # are their own origin — foreign to any resident chain
                self.executor.note_plan_commit(
                    plan.coupled_batch[0] if plan.coupled_batch
                    else plan.eval_id)
            if result.refuted_nodes:
                self.stats.inc("plans_refuted")
                REGISTRY.inc("nomad.plan.refuted_nodes",
                             len(result.refuted_nodes))
                log("plan", "warn", "plan partially refuted",
                    eval_id=plan.eval_id,
                    refuted=len(result.refuted_nodes))
            if result.node_preemptions:
                REGISTRY.inc("nomad.quality.preemptions",
                             sum(len(v) for v in
                                 result.node_preemptions.values()))
                if self.on_preempted is not None:
                    self.on_preempted(
                        [a for allocs in result.node_preemptions.values()
                         for a in allocs])
            now = self.clock.monotonic()
            if now >= self._quality_next:
                self._quality_next = now + self.quality_interval
                publish_quality(self.state)
            result.alloc_index = self.state.latest_index()
            pending.respond(result, None)
        except Exception as e:  # noqa: BLE001
            pending.respond(None, e)

    @staticmethod
    def _stamp_trace(plan: Plan, result: PlanResult) -> None:
        """Carry the eval's trace onto every alloc this commit creates:
        the client's alloc runner closes the span tree with the
        alloc-start span (block rows inherit via their template)."""
        if not plan.trace_id:
            return
        for allocs in result.node_allocation.values():
            for a in allocs:
                if not a.trace_id:
                    a.trace_id = plan.trace_id
        for block in result.alloc_blocks:
            tmpl = getattr(block, "template", None)
            if tmpl is not None and not tmpl.trace_id:
                tmpl.trace_id = plan.trace_id

    def evaluate_plan(self, plan: Plan, skip_fit: bool = False,
                      fenced_first: bool = False) -> PlanResult:
        """Re-check each touched node against the latest snapshot; refuted
        nodes are dropped from the result (partial commit).
        reference: evaluatePlan / evaluateNodePlan.  `skip_fit` is the
        coupled-batch fast path (see apply_one): node existence/status and
        CSI claims are still checked, only AllocsFit is skipped.
        `fenced_first`: the plan sits at its chain's FIRST position (no
        prior chain commit exists), so host-assigned ports/devices cannot
        collide with a batch-mate and need not demote the skip."""
        if (skip_fit and not fenced_first
                and self._carries_host_assigned(plan)):
            # Ports and device instances are HOST-assigned state the device
            # fence does not couple: plans of one batch assign from private
            # indexes over the same snapshot and can collide even behind an
            # intact fence — the fit re-check (which carries the collision
            # detection) must run for such plans.  Exception: at the FIRST
            # chain position (placement_seq still equals the plan's own
            # snapshot fence) no batch-mate has committed, so there is no
            # counterpart to collide with and the skip stays safe — this
            # keeps the fence optimization for solo fenced plans (the
            # system scheduler's chain-of-1) and the head of every batch.
            skip_fit = False
        # The fast path reads the LIVE head, not a snapshot: it needs only
        # point reads (node existence/status, volume lookups) plus claim
        # dicts guarded by the store lock below.  A snapshot per plan
        # would mark the alloc tables COW-shared, forcing the commit right
        # after it to re-copy the outer tables — at bench scale that copy
        # (100k-entry dicts, per plan) WAS the plan pipeline's largest
        # host cost.  The full-check path keeps the snapshot: allocs_fit
        # iterates alloc buckets, which may mutate under the head.
        snap = self.state if skip_fit else self.state.snapshot()
        result = PlanResult(
            node_update=dict(plan.node_update),
            node_preemptions=dict(plan.node_preemptions),
            deployment=plan.deployment,
            deployment_updates=plan.deployment_updates,
        )
        self.stats.inc("fast_path" if skip_fit else "full_check")
        # write claims accumulated by ALREADY-ACCEPTED nodes of THIS plan:
        # without it two writers to a single-writer volume inside one plan
        # are each checked against the pre-plan claim set and both commit
        plan_claims: Dict[Tuple[str, str], int] = {}
        # node pinned per single-node volume by THIS plan's accepted
        # claims (readers included): a later node of the same plan
        # claiming the same single-node volume elsewhere must refuse
        # (reference: csi.go single-node access modes; round-5 verdict #7)
        plan_claim_nodes: Dict[Tuple[str, str], str] = {}
        # Alloc removals whose commit is certain so far: stops/preemptions
        # on nodes with no placements always commit (only placement nodes
        # refute), and a placement node's removals join once it is
        # ACCEPTED.  Crediting the whole plan's removals up front would let
        # a writer admitted on the strength of a release commit while the
        # releasing node refutes and the release is withheld.
        committed_releases: set = set()
        for removals in (plan.node_update, plan.node_preemptions):
            for node_id, allocs in removals.items():
                if node_id not in plan.node_allocation:
                    committed_releases.update(a.id for a in allocs)
        # Releasing nodes first (fewer passes), then iterate to a
        # FIXPOINT: a node refused on a claim may become admissible once a
        # later node accepts and its releases join the credit — without
        # the loop, acceptance would depend on dict insertion order.
        # Release CYCLES (a two-node writer swap) still refute both sides:
        # per-node partial commit cannot guarantee both halves land, and
        # admitting one on a credit that may be withheld is the exact bug
        # this accounting exists to prevent.  Plans without volume claims
        # accept every node in pass one — no extra cost.
        # Columnar blocks stay COLUMNAR on every path (wavepipe): the
        # fenced fast path accepts them wholesale (_blocks_ok); the
        # full-check path re-checks per node ON THE PICK ARRAYS
        # (_eval_blocks: node status, volume schedulability, vectorized
        # cpu/mem/disk fit from block.demand_by_node) and refutes by
        # masking rows out of the block — per-alloc materialization only
        # happens for shapes the arrays cannot express.
        final_refused: List[str] = []
        fit_cleared: set = set()      # claim-deferred nodes already fit-checked
        # live-head claim dicts can mutate in place between snapshots;
        # the fast-path loop holds the store lock while it reads them
        # (short: point reads + claim set math, no allocs_fit)
        guard = (self.state.locked() if snap is self.state
                 else _NULL_GUARD)
        with guard:
            # volume-mutation counter AT the guarded claim checks: the
            # commit re-verifies it (expected_nodes) so a volume write
            # landing after the guard releases forces a full redo
            result.volume_seq = (self.state.volume_seq()
                                 if snap is self.state else None)
            if plan.alloc_blocks:
                if skip_fit and self._blocks_ok(snap, plan):
                    result.alloc_blocks = list(plan.alloc_blocks)
                else:
                    self._eval_blocks(snap, plan, result, final_refused,
                                      skip_fit)
            pending_nodes = sorted(
                plan.node_allocation,
                key=lambda nid: not (nid in plan.node_update
                                     or nid in plan.node_preemptions))
            self._eval_nodes(snap, plan, result, skip_fit,
                             (plan_claims, plan_claim_nodes),
                             committed_releases, pending_nodes,
                             final_refused, fit_cleared)
        for node_id in final_refused:
            result.refuted_nodes.append(node_id)
            # stops/preemptions for a refuted node are withheld too
            result.node_update.pop(node_id, None)
            result.node_preemptions.pop(node_id, None)
        return result

    def _eval_nodes(self, snap, plan, result, skip_fit, claim_state,
                    committed_releases, pending_nodes, final_refused,
                    fit_cleared) -> None:
        # per-reason refute counts (logged below): a refuted node's
        # cause — port collision vs capacity vs claim — decides the
        # operator's next move and is invisible from the count alone
        why: Dict[str, int] = {}
        refused0 = len(final_refused)
        while pending_nodes:
            progressed = False
            deferred = []
            for node_id in pending_nodes:
                new_allocs = plan.node_allocation[node_id]
                verdict = self._node_plan_ok(snap, plan, node_id, new_allocs,
                                             skip_fit=skip_fit or
                                             node_id in fit_cleared,
                                             claim_state=claim_state,
                                             released=committed_releases,
                                             why=why)
                if verdict == NODE_OK:
                    result.node_allocation[node_id] = new_allocs
                    committed_releases.update(
                        a.id for a in plan.node_update.get(node_id, ()))
                    committed_releases.update(
                        a.id for a in plan.node_preemptions.get(node_id, ()))
                    progressed = True
                elif verdict == NODE_CLAIM_REFUSED:
                    # may clear on a later credit; its fit verdict (already
                    # passed — fit failure is final) need not be redone
                    fit_cleared.add(node_id)
                    deferred.append(node_id)
                else:
                    final_refused.append(node_id)   # down/fit: won't change
            if not progressed:
                final_refused.extend(deferred)
                break
            pending_nodes = deferred
        if len(final_refused) > refused0:
            log("plan", "warn", "plan nodes refuted",
                eval_id=plan.eval_id,
                nodes=len(final_refused) - refused0, reasons=dict(why))

    @staticmethod
    def _blocks_ok(snap, plan: Plan) -> bool:
        """Whole-block admission on the fenced fast path: every touched
        node up, volumes present + schedulable, and nothing the columnar
        form cannot express safely (ports, write claims) — else the
        caller expands to the per-node path."""
        for block in plan.alloc_blocks:
            tmpl = block.template
            if tmpl.allocated_ports or tmpl.allocated_devices:
                return False
            if tmpl.resources.networks and block.ports is None:
                # a networked block must CARRY its columnar port
                # assignment to ride any block path; with it,
                # the fenced fast path is as sound as for per-alloc port
                # plans — evaluate_plan only keeps skip_fit for port
                # carriers at the chain head (fenced_first), where the
                # scheduler's NetworkIndex provably saw every live port
                return False
            for nid in block.node_table:
                node = snap.node_by_id(nid)
                if node is None or node.status == "down":
                    return False
            job = tmpl.job
            tg = job.lookup_task_group(tmpl.task_group) if job else None
            if tg is not None and tg.volumes:
                for vreq in tg.volumes.values():
                    if vreq.type != "csi" or not vreq.source:
                        continue
                    if not vreq.read_only:
                        # write-claim accounting is per node; buy it
                        return False
                    vol = snap.csi_volume_by_id(tmpl.namespace,
                                                vreq.source)
                    if vol is None or not vol.schedulable:
                        return False
                    if vol.single_node():
                        # node-pinned modes need the per-node path even
                        # for readers (a block can span nodes)
                        return False
        return True

    @staticmethod
    def _block_demotes(snap, block, pa_nodes) -> bool:
        """Shapes whose re-check the columnar path cannot express — the
        same demotions _blocks_ok applies (devices, write claims,
        node-pinned volume modes), plus nodes shared with per-alloc
        placements (their fit must be checked TOGETHER, which only the
        expanded per-node path does).  Networked blocks CARRYING their
        columnar port assignment stay columnar: _eval_blocks audits
        their ports per node straight off the array."""
        tmpl = block.template
        if (tmpl.allocated_ports or tmpl.allocated_devices
                or (tmpl.resources.networks and block.ports is None)):
            return True
        if pa_nodes and not pa_nodes.isdisjoint(block.node_table):
            return True
        job = tmpl.job
        tg = job.lookup_task_group(tmpl.task_group) if job else None
        if tg is not None and tg.volumes:
            for vreq in tg.volumes.values():
                if vreq.type != "csi" or not vreq.source:
                    continue
                if not vreq.read_only:
                    return True         # per-alloc writer accounting
                vol = snap.csi_volume_by_id(tmpl.namespace, vreq.source)
                if vol is not None and vol.single_node():
                    return True         # node-pinned modes: per-node path
        return False

    def _eval_blocks(self, snap, plan: Plan, result: PlanResult,
                     final_refused: List[str], skip_fit: bool) -> None:
        """Per-node re-check of columnar blocks ON THE PICK ARRAYS (the
        wavepipe commit stage): node existence/status, whole-block
        volume presence + schedulability, and — unless the fence proved
        it redundant — a cpu/mem/disk fit per touched node, with block
        demand from `AllocBlock.demand_by_node` and existing usage
        summed once per node.  Failing nodes refute COLUMNAR: their
        rows are masked out (`AllocBlock.without_nodes`) and the node
        ids join `final_refused`; blocks the arrays cannot express
        expand into node_allocation and ride the per-node loop."""
        columnar = []
        pa_nodes = set(plan.node_allocation)
        for block in list(plan.alloc_blocks):
            if self._block_demotes(snap, block, pa_nodes):
                plan.alloc_blocks.remove(block)
                for a in block.materialize_all():
                    plan.node_allocation.setdefault(a.node_id,
                                                    []).append(a)
            else:
                columnar.append(block)
        # expansion may land rows on a columnar block's nodes: demote
        # those too, to a fixpoint (plans carry O(1) blocks in practice)
        changed = bool(columnar)
        while changed:
            changed = False
            pa_nodes = set(plan.node_allocation)
            for block in list(columnar):
                if pa_nodes and not pa_nodes.isdisjoint(block.node_table):
                    columnar.remove(block)
                    for a in block.materialize_all():
                        plan.node_allocation.setdefault(a.node_id,
                                                        []).append(a)
                    changed = True
        if not columnar:
            return
        bad: set = set()
        # per-reason refute counts for the log line below: a mass
        # refute's cause (volume gone vs port collision vs fit) decides
        # the operator's next move and is invisible from the count alone
        why: Dict[str, int] = {}

        def _mark(nids, reason: str) -> None:
            fresh = set(nids) - bad
            if fresh:
                why[reason] = why.get(reason, 0) + len(fresh)
                bad.update(fresh)

        # whole-block volume verdicts (uniform across a block's rows:
        # only read-only multi-node claims reach this path)
        for b in columnar:
            tmpl = b.template
            job = tmpl.job
            tg = job.lookup_task_group(tmpl.task_group) if job else None
            if tg is None or not tg.volumes:
                continue
            for vreq in tg.volumes.values():
                if vreq.type != "csi" or not vreq.source:
                    continue
                vol = snap.csi_volume_by_id(tmpl.namespace, vreq.source)
                if vol is None or not vol.schedulable:
                    _mark(b.node_table, "volume")
                    break
        # batched per-node PORT audit input: the plan's port
        # claims per node, aggregated ACROSS port-carrying blocks
        # straight off the arrays.  A (node, port) claimed twice within
        # the plan refutes the node outright — no state read needed.
        plan_ports: Dict[str, set] = {}
        for b in columnar:
            for nid, plist in b.ports_by_node().items():
                claimed = plan_ports.setdefault(nid, set())
                for port in plist:
                    if port in claimed:
                        _mark((nid,), "in-plan-dup-port")
                    claimed.add(port)
        # per-node demand aggregated ACROSS blocks (two blocks on one
        # node were fit-checked together on the expanded path)
        total: Dict[str, List[int]] = {}
        for b in columnar:
            for nid, (_, cpu, mem, disk) in b.demand_by_node().items():
                acc = total.get(nid)
                if acc is None:
                    total[nid] = [cpu, mem, disk]
                else:
                    acc[0] += cpu
                    acc[1] += mem
                    acc[2] += disk
        for nid, (cpu, mem, disk) in total.items():
            if nid in bad:
                continue
            node = snap.node_by_id(nid)
            if node is None or node.status == "down":
                _mark((nid,), "node-down")
                continue
            if skip_fit:
                continue
            removals = {a.id for a in plan.node_update.get(nid, ())}
            removals.update(
                a.id for a in plan.node_preemptions.get(nid, ()))
            # port-carrying nodes: existing used ports collected on the
            # SAME alloc walk as the capacity sums (the "re-check
            # batches per node" half of the columnar ports — one set build per
            # node, never a per-alloc allocs_fit materialization)
            claimed = plan_ports.get(nid) if not skip_fit else None
            used_ports: Optional[NetworkIndex] = None
            if claimed:
                used_ports = NetworkIndex()
                used_ports.set_node(node)
            for a in snap.allocs_by_node(nid):
                if a.terminal_status() or a.id in removals:
                    continue
                cpu += a.resources.cpu
                mem += a.resources.memory_mb
                disk += a.resources.disk_mb
                if used_ports is not None:
                    used_ports.add_allocs((a,))
            if used_ports is not None and not claimed.isdisjoint(
                    used_ports.used_ports):
                _mark((nid,), "port-collision")
                continue
            res, rsv = node.resources, node.reserved
            if (cpu > res.cpu - rsv.cpu
                    or mem > res.memory_mb - rsv.memory_mb
                    or disk > res.disk_mb - rsv.disk_mb):
                _mark((nid,), "fit")
        refused: set = set()
        for b in columnar:
            bad_b = bad.intersection(b.node_table)
            if not bad_b:
                result.alloc_blocks.append(b)
                continue
            refused |= bad_b
            kept = b.without_nodes(bad_b)
            if kept is not None:
                result.alloc_blocks.append(kept)
        if refused:
            log("plan", "warn", "block nodes refuted",
                nodes=len(refused), reasons=dict(why))
        final_refused.extend(sorted(refused))

    @staticmethod
    def _carries_host_assigned(plan: Plan) -> bool:
        """Any placement carrying a port/device assignment — or even just
        a network ask (allocs_fit counts reserved-port asks too).  Block
        TEMPLATES are inspected too: networked blocks carry their port
        columns and must demote off the skip — their port
        values were host-assigned against a snapshot a batch-mate's
        commit may have invalidated; the re-check (columnar per-node
        port audit in _eval_blocks) only runs when skip_fit is off."""
        for allocs in plan.node_allocation.values():
            for a in allocs:
                if (a.allocated_ports or a.allocated_devices
                        or a.resources.networks):
                    return True
        for block in plan.alloc_blocks:
            tmpl = block.template
            if (tmpl.allocated_ports or tmpl.allocated_devices
                    or tmpl.resources.networks):
                return True
        return False

    def _node_plan_ok(self, snap, plan: Plan, node_id: str,
                      new_allocs: List[Allocation],
                      skip_fit: bool = False,
                      claim_state: Optional[tuple] = None,
                      released: frozenset = frozenset(),
                      why: Optional[Dict[str, int]] = None) -> int:
        def _why(reason: str) -> None:
            if why is not None:
                why[reason] = why.get(reason, 0) + 1
        plan_claims, plan_claim_nodes = claim_state or (None, None)
        node = snap.node_by_id(node_id)
        if node is None:
            _why("node-missing")
            return NODE_REFUSED
        if node.status == "down":
            # only stops are allowed on down nodes
            _why("node-down")
            return NODE_REFUSED
        if not skip_fit:
            existing = {a.id: a for a in snap.allocs_by_node(node_id)
                        if not a.terminal_status()}
            for a in plan.node_update.get(node_id, []):
                existing.pop(a.id, None)
            for a in plan.node_preemptions.get(node_id, []):
                existing.pop(a.id, None)
            for a in new_allocs:
                existing[a.id] = a   # same-id update replaces
            # check_devices: a concurrent worker may have assigned the same
            # device instances against its own stale snapshot — the refute
            # here is what makes host-side device assignment race-safe
            ok, dim, _ = allocs_fit(node, list(existing.values()),
                                    check_devices=True)
            if not ok:
                _why(f"fit:{dim}")
                return NODE_REFUSED
        # CSI claim re-check (reference: CSIVolumeChecker claim_ok at the
        # serialization point): access-mode limits and schedulable=false
        # refute here — the device mask only checks plugin presence.
        # Released claims credited: removals whose commit is already
        # certain (`released` — non-placement nodes + accepted nodes,
        # maintained by evaluate_plan), THIS node's own stops/preemptions
        # (they commit iff this node is accepted — consistent either way),
        # and same-id replacements.  Removals on not-yet-accepted OTHER
        # nodes are NOT credited: that node may refute and keep its
        # claim-holder running.  Write claims accepted by earlier nodes of
        # this plan count via `plan_claims` (merged only after this node
        # passes every check — a refuted node's claims never commit, so
        # they must not block later nodes).
        releasing = set(released)
        releasing.update(a.id for a in plan.node_update.get(node_id, ()))
        releasing.update(
            a.id for a in plan.node_preemptions.get(node_id, ()))
        releasing |= {a.id for a in new_allocs}
        local_claims: Dict = {}
        local_nodes: Dict = {}
        for a in new_allocs:
            tg = a.job.lookup_task_group(a.task_group) \
                if a.job is not None else None
            if tg is None or not tg.volumes:
                continue
            for vreq in tg.volumes.values():
                if vreq.type != "csi" or not vreq.source:
                    continue
                key = (a.namespace, vreq.source)
                vol = snap.csi_volume_by_id(a.namespace, vreq.source)
                if vol is None or not vol.schedulable:
                    _why("volume-gone")
                    return NODE_REFUSED      # can never clear in-plan
                if not vreq.read_only and vol.reader_only():
                    _why("volume-mode")
                    return NODE_REFUSED      # mode mismatch: also final
                if not vol.claim_ok(vreq.read_only, releasing,
                                    node_id=node_id):
                    _why("volume-claim")
                    return NODE_CLAIM_REFUSED
                if vol.single_node():
                    # single-node access modes pin READERS too: a claim
                    # accepted on another node earlier in THIS plan is
                    # final (in-plan claims only grow)
                    pinned = (plan_claim_nodes or {}).get(key, "")
                    if pinned and pinned != node_id:
                        _why("volume-node-pin")
                        return NODE_REFUSED
                    local_nodes[key] = node_id
                if not vreq.read_only:
                    # in-plan claims only grow — refusal here is final
                    if (vol.writer_limited()
                            and plan_claims is not None
                            and (plan_claims.get(key, 0)
                                 + local_claims.get(key, 0))):
                        _why("volume-writer-limit")
                        return NODE_REFUSED
                    local_claims[key] = local_claims.get(key, 0) + 1
        if plan_claims is not None:
            for key, cnt in local_claims.items():
                plan_claims[key] = plan_claims.get(key, 0) + cnt
        if plan_claim_nodes is not None:
            for key, nd in local_nodes.items():
                plan_claim_nodes.setdefault(key, nd)
        return NODE_OK
