"""Evaluation broker (reference: nomad/eval_broker.go).

Priority + FIFO queue of evaluations by scheduler type with:
  - per-job serialization: only one eval per (namespace, job) outstanding;
    later evals for the same job wait until the current one is acked
  - dequeue with a token; ack/nack protocol; nack re-enqueues with a
    requeue penalty until the delivery limit is reached, then the eval is
    routed to the failed queue
  - wait_until (delayed) evals held until their time arrives

Timebase is injected (`now` arguments) so tests are deterministic; the
server's tick loop supplies wall-clock time.

A copy of the reference's nomad_tpu/core/eval_broker.py with its imports
rewritten and one difference: `dequeue` with a non-zero timeout on a
DISABLED broker waits out the timeout (set_enabled wakes it) before it
returns (None, ""), where the reference's returns at once.  A worker's
loop polls with a 0.1 s timeout, so on a follower, whose broker stays
disabled, the reference's worker spins on the interpreter lock; in a
three-server cluster in one process two such followers slow every Raft
round trip of the leader by tens of times
(tests/test_torch_broker.py holds the difference).
"""

from __future__ import annotations

import heapq
import itertools
import threading
from typing import Dict, List, Optional, Tuple

from nomad_tpu_torch.core.telemetry import REGISTRY, TRACER, StatCounters, span_id
from nomad_tpu_torch.structs import Evaluation, new_id

DEFAULT_NACK_TIMEOUT = 60.0
DEFAULT_DELIVERY_LIMIT = 3
# requeue penalty (reference: eval_broker.go initialNackDelay /
# subsequentNackDelay): the first nack redelivers immediately — a
# transient plan-queue refusal usually clears by the next attempt — but
# repeat nacks park the eval in the delayed heap so a persistently
# failing eval cannot hot-loop a worker while the cluster churns
DEFAULT_INITIAL_NACK_DELAY = 0.0
DEFAULT_SUBSEQUENT_NACK_DELAY = 20.0


class EvalBroker:
    def __init__(self, nack_timeout: float = DEFAULT_NACK_TIMEOUT,
                 delivery_limit: int = DEFAULT_DELIVERY_LIMIT,
                 initial_nack_delay: float = DEFAULT_INITIAL_NACK_DELAY,
                 subsequent_nack_delay: float =
                 DEFAULT_SUBSEQUENT_NACK_DELAY) -> None:
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._enabled = False
        self.nack_timeout = nack_timeout
        self.delivery_limit = delivery_limit
        self.initial_nack_delay = initial_nack_delay
        self.subsequent_nack_delay = subsequent_nack_delay
        self._seq = itertools.count()
        # ready heaps per scheduler type: (-priority, seq, eval)
        self._ready: Dict[str, List[Tuple[int, int, Evaluation]]] = {}
        # evals waiting on an earlier eval of the same job
        self._pending_by_job: Dict[Tuple[str, str], List[Evaluation]] = {}
        self._in_flight_jobs: set = set()
        # delayed evals: (wait_until, seq, eval)
        self._delayed: List[Tuple[float, int, Evaluation]] = []
        # outstanding: eval_id -> (token, deadline, eval)
        self._outstanding: Dict[str, Tuple[str, float, Evaluation]] = {}
        self._dequeues: Dict[str, int] = {}       # delivery attempts
        self._failed: List[Evaluation] = []
        # optional batch-partition callback (eval -> hashable key): when
        # set, dequeue_batch hands out SINGLE-KEY batches — evals whose
        # key differs from the batch head's stay queued for another
        # worker.  The server wires this with >1 worker so concurrent
        # batches operate on (probably) disjoint node sets: jobs sharing
        # a placement-domain signature (datacenters, pool, CSI volume
        # topologies) contend for the same nodes; distinct signatures
        # mostly do not, so the per-node fence keeps every worker on the
        # applier fast path.  (reference contrast: nomad's num_schedulers
        # workers dequeue blindly and resolve collisions at plan apply.)
        self.partition_of = None
        self.stats = StatCounters("nomad.broker", (
            "enqueued", "dequeued", "acked", "nacked", "nack_delayed",
            "failed"))
        # telemetry bookkeeping (core/telemetry.py), both guarded by
        # self._lock: when each eval last became READY (feeds the
        # enqueue->dequeue wait histogram + broker.wait span), and each
        # traced eval's FIRST enqueue stamp (feeds the root `eval` span
        # recorded at ack / delivery-limit failure)
        self._ready_t: Dict[str, float] = {}
        self._trace_t0: Dict[str, Tuple[str, float]] = {}

    # ------------------------------------------------------------ control

    def set_enabled(self, enabled: bool) -> None:
        with self._lock:
            self._enabled = enabled
            if not enabled:
                self._ready.clear()
                self._pending_by_job.clear()
                self._in_flight_jobs.clear()
                self._delayed.clear()
                self._outstanding.clear()
                self._dequeues.clear()
                self._ready_t.clear()
                self._trace_t0.clear()
            self._cv.notify_all()

    @property
    def enabled(self) -> bool:
        return self._enabled

    # ------------------------------------------------------------ enqueue

    def enqueue(self, evaluation: Evaluation, now: float = 0.0) -> None:
        with self._lock:
            if not self._enabled:
                return
            self.stats.inc("enqueued")
            if evaluation.trace_id and evaluation.id not in self._trace_t0:
                self._trace_t0[evaluation.id] = (
                    evaluation.trace_id, TRACER.clock.monotonic())
            if evaluation.wait_until and evaluation.wait_until > now:
                heapq.heappush(self._delayed,
                               (evaluation.wait_until, next(self._seq),
                                evaluation))
                return
            self._enqueue_locked(evaluation)
            self._cv.notify()

    def _enqueue_locked(self, evaluation: Evaluation) -> None:
        self._ready_t.setdefault(evaluation.id, TRACER.clock.monotonic())
        key = (evaluation.namespace, evaluation.job_id)
        if key in self._in_flight_jobs:
            self._pending_by_job.setdefault(key, []).append(evaluation)
            return
        heap = self._ready.setdefault(evaluation.type, [])
        heapq.heappush(heap, (-evaluation.priority, next(self._seq),
                              evaluation))

    # ------------------------------------------------------------ dequeue

    def dequeue(self, schedulers: List[str], now: float,
                timeout: Optional[float] = None,
                ) -> Tuple[Optional[Evaluation], str]:
        """Pop the highest-priority ready eval for any of `schedulers`.
        Returns (eval, token) or (None, "") on timeout/disabled."""
        deadline = None if timeout is None else now + timeout
        parked = False
        with self._cv:
            while True:
                if not self._enabled:
                    # a blocking caller on a disabled broker (a worker on
                    # a follower) waits out its timeout, woken early by
                    # set_enabled, instead of returning at once
                    if timeout != 0.0 and not parked:
                        parked = True
                        self._cv.wait(timeout=timeout)
                        continue
                    return None, ""
                self._tick_locked(now)
                ev = self._pop_ready_locked(schedulers)
                if ev is not None:
                    return ev, self._issue_locked(ev, now)
                if timeout == 0.0 or (deadline is not None and now >= deadline):
                    return None, ""
                if not self._cv.wait(timeout=0.05):
                    now += 0.05
                else:
                    now += 0.001

    def dequeue_batch(self, schedulers: List[str], max_n: int, now: float,
                      timeout: Optional[float] = None,
                      ) -> List[Tuple[Evaluation, str]]:
        """Pop up to `max_n` ready evals (each with its own token) for a
        single batched worker pass.  Blocks like dequeue() for the FIRST
        eval; the rest are taken only if immediately ready — a batch
        never waits for stragglers.  Per-job serialization holds across
        the batch (distinct jobs by construction)."""
        out: List[Tuple[Evaluation, str]] = []
        ev, token = self.dequeue(schedulers, now, timeout)
        if ev is None:
            return out
        out.append((ev, token))
        part = self.partition_of
        want_key = part(ev) if part is not None else None
        with self._cv:
            self._tick_locked(now)     # expired redeliveries join the batch
            skipped: List[Evaluation] = []
            while len(out) < max_n and self._enabled:
                nxt = self._pop_ready_locked(schedulers)
                if nxt is None:
                    break
                if part is not None and part(nxt) != want_key:
                    skipped.append(nxt)    # another partition's work
                    continue
                out.append((nxt, self._issue_locked(nxt, now)))
            # put other partitions' evals back for the next worker
            for ev2 in skipped:
                heap = self._ready.setdefault(ev2.type, [])
                heapq.heappush(heap, (-ev2.priority, next(self._seq), ev2))
            if skipped:
                self._cv.notify()
        return out

    def token_valid(self, eval_id: str, token: str) -> bool:
        """Is `token` the CURRENT delivery of `eval_id`?  The plan
        applier rejects plans carrying a superseded token — a worker that
        held a batch past the redelivery deadline (device compile, GC
        pause) must not commit concurrently with the redelivery's worker
        (reference: the Evaluation.EvalToken check at plan submission)."""
        with self._lock:
            rec = self._outstanding.get(eval_id)
            return rec is not None and rec[0] == token

    def extend_outstanding(self, pairs, now: float) -> None:
        """Restart the nack deadline for deliveries a worker is about to
        process after holding them (the cross-batch prefetch window) —
        prevents the tick loop from redelivering evals mid-processing."""
        with self._lock:
            for eval_id, token in pairs:
                rec = self._outstanding.get(eval_id)
                if rec is not None and rec[0] == token:
                    self._outstanding[eval_id] = (
                        token, now + self.nack_timeout, rec[2])

    def _issue_locked(self, ev: Evaluation, now: float) -> str:
        """Mint a delivery token + outstanding/redelivery bookkeeping —
        the single definition both dequeue paths share (nack/timeout
        accounting must never diverge between them)."""
        token = new_id()
        self._outstanding[ev.id] = (token, now + self.nack_timeout, ev)
        self._dequeues[ev.id] = self._dequeues.get(ev.id, 0) + 1
        self._in_flight_jobs.add((ev.namespace, ev.job_id))
        self.stats.inc("dequeued")
        t1 = TRACER.clock.monotonic()
        t0 = self._ready_t.pop(ev.id, t1)
        REGISTRY.observe("nomad.broker.wait_s", t1 - t0)
        if ev.trace_id:
            TRACER.record("broker.wait", ev.trace_id, t0, t1,
                          parent=span_id(ev.trace_id, "eval"),
                          eval_id=ev.id,
                          attempt=self._dequeues[ev.id])
        return token

    def _pop_ready_locked(self, schedulers: List[str]) -> Optional[Evaluation]:
        """Pop the best ready eval whose job has no eval in flight; evals
        for busy jobs are stashed in the per-job waiting list."""
        while True:
            best_type, best = None, None
            for st in schedulers:
                heap = self._ready.get(st)
                while heap and heap[0][2].id in self._outstanding:
                    heapq.heappop(heap)    # stale entry
                if heap and (best is None or heap[0] < best):
                    best_type, best = st, heap[0]
            if best is None:
                return None
            heapq.heappop(self._ready[best_type])
            ev = best[2]
            key = (ev.namespace, ev.job_id)
            if key in self._in_flight_jobs:
                self._pending_by_job.setdefault(key, []).append(ev)
                continue
            return ev

    # ----------------------------------------------------------- ack/nack

    def ack(self, eval_id: str, token: str) -> Optional[str]:
        with self._lock:
            rec = self._outstanding.get(eval_id)
            if rec is None or rec[0] != token:
                return "token mismatch"
            ev = rec[2]
            del self._outstanding[eval_id]
            self._dequeues.pop(eval_id, None)
            self.stats.inc("acked")
            self._finish_trace_locked(ev, "ack")
            self._release_job_locked((ev.namespace, ev.job_id))
            return None

    def _finish_trace_locked(self, ev: Evaluation, outcome: str) -> None:
        """Close the eval's ROOT span: its delivery cycle ended (acked or
        failed out).  Nacked redeliveries keep the root open."""
        rec = self._trace_t0.pop(ev.id, None)
        if rec is None:
            return
        tid, t0 = rec
        TRACER.record("eval", tid, t0, TRACER.clock.monotonic(),
                      eval_id=ev.id, job_id=ev.job_id, type=ev.type,
                      triggered_by=ev.triggered_by, outcome=outcome)

    def _release_job_locked(self, key: Tuple[str, str]) -> None:
        """Job no longer has an eval in flight (acked, failed, or expired):
        promote the next waiting eval for it, if any."""
        self._in_flight_jobs.discard(key)
        waiting = self._pending_by_job.get(key)
        if waiting:
            nxt = waiting.pop(0)
            if not waiting:
                del self._pending_by_job[key]
            self._enqueue_locked(nxt)
            self._cv.notify()

    def nack(self, eval_id: str, token: str, now: float = 0.0) -> Optional[str]:
        with self._lock:
            rec = self._outstanding.get(eval_id)
            if rec is None or rec[0] != token:
                return "token mismatch"
            ev = rec[2]
            del self._outstanding[eval_id]
            self.stats.inc("nacked")
            key = (ev.namespace, ev.job_id)
            if self._dequeues.get(eval_id, 0) >= self.delivery_limit:
                self._failed.append(ev)
                self.stats.inc("failed")
                self._finish_trace_locked(ev, "failed")
                self._dequeues.pop(eval_id, None)
                # waiters for this job must not strand behind a failed eval
                self._release_job_locked(key)
            else:
                self._in_flight_jobs.discard(key)
                attempts = self._dequeues.get(eval_id, 0)
                delay = (self.initial_nack_delay if attempts <= 1
                         else self.subsequent_nack_delay)
                if delay > 0.0:
                    self.stats.inc("nack_delayed")
                    heapq.heappush(self._delayed,
                                   (now + delay, next(self._seq), ev))
                else:
                    self._enqueue_locked(ev)
            self._cv.notify()
            return None

    # --------------------------------------------------------------- tick

    def tick(self, now: float) -> None:
        """Promote delayed evals whose time arrived and requeue expired
        (nack-timeout) outstanding evals."""
        with self._lock:
            self._tick_locked(now)
            self._cv.notify_all()

    def _tick_locked(self, now: float) -> None:
        while self._delayed and self._delayed[0][0] <= now:
            _, _, ev = heapq.heappop(self._delayed)
            self._enqueue_locked(ev)
        expired = [eid for eid, (tok, deadline, ev) in self._outstanding.items()
                   if deadline <= now]
        for eid in expired:
            tok, _, ev = self._outstanding.pop(eid)
            key = (ev.namespace, ev.job_id)
            if self._dequeues.get(eid, 0) >= self.delivery_limit:
                self._failed.append(ev)
                self.stats.inc("failed")
                self._finish_trace_locked(ev, "failed")
                self._release_job_locked(key)
            else:
                self._in_flight_jobs.discard(key)
                self._enqueue_locked(ev)

    # -------------------------------------------------------------- stats

    def pending_evals(self) -> int:
        with self._lock:
            n = sum(len(h) for h in self._ready.values())
            n += sum(len(v) for v in self._pending_by_job.values())
            n += len(self._delayed)
            return n

    def failed_evals(self) -> List[Evaluation]:
        with self._lock:
            return list(self._failed)

    def drain_failed(self) -> List[Evaluation]:
        """Pop all delivery-limit-failed evals (the leader's reap loop marks
        them failed in state and creates follow-up evals;
        reference: leader.go reapFailedEvaluations)."""
        with self._lock:
            out = self._failed
            self._failed = []
            return out
