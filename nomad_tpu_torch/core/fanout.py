"""Read-path fanout plane: coalesced blocking-query watches, the
cursor-based event ring, and the journal-tailing read follower
(ROADMAP open item: serve the read path to 10k+ watchers).

Three legs, all feeding the same goal — a read-dominated production
workload must not cost O(clients) per store write:

  WatchHub       ONE store wait per watched-set *shape* (table + key
                 filter fingerprint).  The first blocked client for a
                 shape becomes the shape's leader and runs the single
                 `state.wait_for_index` re-arm loop; every other client
                 parks on the shape's condition.  On a commit-batch wake
                 the leader re-evaluates the shape's result index ONCE
                 and wakes all same-shape waiters together.  `_block` in
                 api/http_server.py is a thin client of this hub instead
                 of running its own 1s re-arm loop per connection.

  EventRing      a single append-only ring of expanded-event batches
                 with per-subscriber cursors (reference:
                 nomad/stream/event_buffer.go's one-buffer design).  A
                 commit is O(ring append + wake); per-subscriber
                 topic-match/offer work moved to the CONSUMER side.
                 Slow consumers fall behind on their own cursor —
                 counted (`nomad.stream.dropped`), never blocking the
                 publisher — and late subscribers replay by cursor seek.

  ReadFollower   promotes the export_since/apply_export journal
                 replica (core/workerpool.py "pull" op) to a public
                 agent role: tail a leader's `/v1/operator/export`
                 journal over HTTP and serve stale-bounded reads
                 locally with X-Nomad-KnownLeader / X-Nomad-LastContact
                 headers.  A follower NEVER applies an export whose
                 head index is behind what it already served (failing
                 over to a lagging upstream must not un-happen reads).

Timebase: everything here rides the injected Clock seam (chaos/clock.py)
— deadlines in clock time, parking via conditions the clock can wake.
One deliberate exception, documented inline: blocking HTTP clients also
get a real-time liveness cap (time.perf_counter, the legal raw-time
primitive) because the transport is real even when time is simulated —
a VirtualClock that never advances must not park a TCP connection
forever.

Differences from the reference (nomad_tpu/core/fanout.py):
  - `ReadFollower` is not ported yet: its pull reads the journal
    through `core/wire.py`, which belongs to the cluster plane (ROADMAP
    queue 1 item 4).  `WatchHub` and `EventRing` are copies.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from nomad_tpu_torch.core import telemetry

# ---------------------------------------------------------------------------
# WatchHub — coalesced blocking-query watches
# ---------------------------------------------------------------------------


class _Shape:
    """One watched-set shape: the shared evaluation cache + the parked
    clients.  `leader` is True while ONE waiter runs the store wait on
    everyone's behalf; `result`/`evaluated_at` memoize the shape's
    result index per commit batch so K waiters cost one evaluation."""

    __slots__ = ("cond", "result", "evaluated_at", "waiters", "leader",
                 "touched")

    def __init__(self, lock: threading.Lock) -> None:
        self.cond = threading.Condition(lock)
        self.result = -1          # last evaluated result index
        self.evaluated_at = -1    # store index at evaluation time
        self.waiters = 0
        self.leader = False
        self.touched = 0.0        # clock.monotonic() of last activity


class WatchHub:
    """Coalesced watch registration (reference: blockingRPC +
    state.WatchSet, folded to one wait per shape instead of one per
    RPC).  `block()` is the whole client API."""

    def __init__(self, state, clock) -> None:
        self._state = state
        self._clock = clock
        self._lock = threading.Lock()
        self._shapes: Dict[object, _Shape] = {}
        # stats (read under the hub lock via stats())
        self._evals = 0           # result_index evaluations
        self._wakes = 0           # clients returned "changed"
        self._timeouts = 0        # clients returned "unchanged"
        self._coalesced = 0       # follower wakes served by a leader eval
        self.shapes_reaped = 0    # idle-shape GC victims (reap_idle)

    # ----------------------------------------------------------- client

    def block(self, key: object, result_index: Callable[[], int],
              index: int, wait: float) -> bool:
        """Park until the shape's result index passes `index` or `wait`
        expires; True iff the result changed.  `key` fingerprints the
        watched set (same key == same result_index semantics); callers
        with different ?index= values share one shape.

        A deletion can't raise the result's max index, so pure-removal
        changes ride the wait timeout (reference blockingRPC behaves
        the same way); blocking clients re-poll on timeout anyway."""
        clock = self._clock
        deadline = clock.monotonic() + wait
        # real-time liveness cap: the HTTP connection under this call is
        # real even when the timebase is virtual — never park past the
        # requested wait in wall seconds (perf_counter is the sanctioned
        # raw primitive; see module docstring)
        cap = time.perf_counter() + wait
        state = self._state
        with self._lock:
            shape = self._shapes.get(key)
            if shape is None:
                shape = self._shapes[key] = _Shape(self._lock)
                clock.register(shape.cond)
                telemetry.REGISTRY.set_gauge("nomad.fanout.shapes",
                                             len(self._shapes))
            shape.touched = clock.monotonic()
            shape.waiters += 1
        am_leader = False
        try:
            while True:
                with self._lock:
                    latest = state.latest_index()
                    if shape.evaluated_at < latest:
                        # once per commit batch, for ALL same-shape
                        # waiters: whoever notices staleness first (under
                        # the hub lock) evaluates; the rest reuse it
                        shape.evaluated_at = latest
                        new = int(result_index())
                        changed = new != shape.result
                        shape.result = new
                        self._evals += 1
                        if changed and shape.waiters > 1:
                            # broadcast ONLY when the shape's result
                            # moved: unrelated store churn (another
                            # table committing at 10k writes/s) costs
                            # one leader wake + one memoized eval, not a
                            # whole-fleet GIL storm
                            self._coalesced += shape.waiters - 1
                            shape.cond.notify_all()
                    if shape.result > index:
                        self._wakes += 1
                        return True
                    remaining = min(deadline - clock.monotonic(),
                                    cap - time.perf_counter())
                    if remaining <= 0:
                        self._timeouts += 1
                        return False
                    if not am_leader and not shape.leader:
                        # leadership is sticky until this client exits:
                        # handing it off per re-arm slice would broadcast
                        # every slice just to re-elect
                        shape.leader = am_leader = True
                    if not am_leader:
                        # park for the FULL remaining wait; result
                        # changes arrive by notify, virtual-clock
                        # advances wake the registered cond, and the
                        # timeout lands on this client's own deadline —
                        # a parked 10k-follower fleet costs ZERO
                        # periodic wakes.  (cond wraps the hub lock, so
                        # wait() RELEASES it while parked — not a
                        # blocking-under-lock stall)
                        shape.cond.wait(timeout=remaining + 0.05)  # analyze: ok lockorder
                        continue
                # the shape's SINGLE store wait (outside the hub lock);
                # bounded re-arm slice keeps liveness under clocks whose
                # store condition never fires
                if (state.wait_for_index(latest + 1,
                                         timeout=min(remaining, 1.0))
                        and shape.waiters >= 64):
                    # debounce, fleet-scale shapes only: a commit BURST
                    # (the scheduler applying plans back-to-back) must
                    # cost one evaluation at its tail, not one leader
                    # wake per write — and while the leader is off the
                    # store condition, the writer's notify_all finds no
                    # waiter at all.  Wall sleep, deliberately NOT
                    # clock.sleep: this paces the host thread, it must
                    # not advance a virtual cluster timeline (2ms
                    # against a >=100ms-scale wake path).  The bare
                    # waiters read is a GIL-atomic int; staleness just
                    # shifts the threshold by one client.
                    time.sleep(0.002)  # analyze: ok rawtime
        finally:
            with self._lock:
                if am_leader:
                    # handoff: a follower must be able to take the store
                    # wait over, or the shape would go deaf until a
                    # deadline slice fires
                    shape.leader = False
                    shape.cond.notify_all()
                shape.touched = clock.monotonic()
                shape.waiters -= 1
                if shape.waiters <= 0:
                    self._shapes.pop(key, None)
                    clock.unregister(shape.cond)
                    telemetry.REGISTRY.set_gauge("nomad.fanout.shapes",
                                                 len(self._shapes))

    # --------------------------------------------------------------- gc

    def reap_idle(self, now: float, idle_s: float) -> int:
        """Defensive idle-shape GC: drop any shape
        that has sat with ZERO parked waiters for longer than `idle_s`
        (one max_query_time).  The finally-block in block() already
        pops shapes as their last waiter exits, so a reaped shape means
        a client path died without unwinding — reaping it unpins the
        condition from the clock's registry and keeps the table from
        growing forever.  Driven from Server.tick; counted as
        nomad.fanout.shapes_reaped."""
        reaped = 0
        with self._lock:
            for key, shape in list(self._shapes.items()):
                if shape.waiters <= 0 and now - shape.touched > idle_s:
                    self._shapes.pop(key)
                    self._clock.unregister(shape.cond)
                    reaped += 1
            if reaped:
                self.shapes_reaped += reaped
                telemetry.REGISTRY.set_gauge("nomad.fanout.shapes",
                                             len(self._shapes))
        if reaped:
            telemetry.REGISTRY.inc("nomad.fanout.shapes_reaped", reaped)
        return reaped

    # ------------------------------------------------------------ intro

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "shapes": len(self._shapes),
                "waiters": sum(s.waiters for s in self._shapes.values()),
                "evals": self._evals,
                "wakes": self._wakes,
                "timeouts": self._timeouts,
                "coalesced": self._coalesced,
                "shapes_reaped": self.shapes_reaped,
            }

    def mem_stats(self) -> Dict[str, int]:
        """Ledger sizer (core/memledger): live shape table + parked
        waiters at a fixed per-entry estimate (a _Shape is a condition
        + four scalars; waiters are parked frames we do not own)."""
        with self._lock:
            shapes = len(self._shapes)
            waiters = sum(s.waiters for s in self._shapes.values())
            reaped = self.shapes_reaped
        return {"bytes": 96 + shapes * 512 + waiters * 64,
                "entries": shapes, "cap": 0, "evictions": reaped,
                "waiters": waiters}


# ---------------------------------------------------------------------------
# EventRing — append-only expanded-event ring + per-subscriber cursors
# ---------------------------------------------------------------------------


class _RingEntry:
    """One commit batch.  `payload` is the raw buffered form (alloc
    batches compressed to id stubs — see stream._AllocIds); `expanded`
    is the lazily-cached Event list, filled once by the first reader
    OUTSIDE the ring lock (idempotent; the GIL makes the single
    attribute store safe).  `count` is the exact expanded event count,
    known at append time; `cum_end` the absolute event count through
    this entry since broker birth — the basis for drop accounting."""

    __slots__ = ("seq", "topic", "index", "payload", "count", "cum_end",
                 "expanded")

    def __init__(self, seq: int, topic: str, index: int, payload,
                 count: int, cum_end: int) -> None:
        self.seq = seq
        self.topic = topic
        self.index = index
        self.payload = payload
        self.count = count
        self.cum_end = cum_end
        self.expanded: Optional[List] = None


class EventRing:
    """The single shared buffer behind stream.EventBroker.  Publishers
    append O(1) (the store commit callback runs under the store write
    lock); consumers hold (seq, intra) cursors and pull at their own
    pace.  Falling off the tail is counted, never publisher-blocking."""

    def __init__(self, capacity: int = 4096) -> None:
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._entries: List[_RingEntry] = []
        self._base_seq = 0           # seq of _entries[0]
        self._next_seq = 0
        self._cum_base = 0           # events trimmed off the tail, total
        self._capacity = capacity
        self._approx_bytes = 0       # shallow payload estimate, O(1)/append
        self.dropped_total = 0       # events skipped by lagging cursors
        self.closed = False

    # -------------------------------------------------------- publisher

    def append(self, topic: str, index: int, payload, count: int) -> None:
        """O(ring append + wake): no per-subscriber matching here."""
        with self._cond:
            cum = (self._entries[-1].cum_end if self._entries
                   else self._cum_base)
            self._entries.append(_RingEntry(self._next_seq, topic, index,
                                            payload, count, cum + count))
            self._approx_bytes += 128 + sys.getsizeof(payload)
            self._next_seq += 1
            excess = len(self._entries) - self._capacity
            if excess > 0:
                self._cum_base = self._entries[excess - 1].cum_end
                for e in self._entries[:excess]:
                    self._approx_bytes -= 128 + sys.getsizeof(e.payload)
                del self._entries[:excess]
                self._base_seq += excess
            self._cond.notify_all()

    def close(self) -> None:
        with self._cond:
            self.closed = True
            self._cond.notify_all()

    def wake(self) -> None:
        """Wake parked consumers without publishing (a subscription was
        closed; its parked next() must observe that promptly)."""
        with self._cond:
            self._cond.notify_all()

    # --------------------------------------------------------- consumer

    def seek(self, from_index: int) -> Tuple[int, int]:
        """(seq, abs_pos) at the first entry with index > from_index
        (late-subscriber replay: a seek, not a re-expansion walk).
        `abs_pos` is the cursor's absolute event position — the
        subscriber's lag ledger differences it against the cum ledger."""
        with self._lock:
            lo, hi = 0, len(self._entries)
            while lo < hi:
                mid = (lo + hi) // 2
                if self._entries[mid].index <= from_index:
                    lo = mid + 1
                else:
                    hi = mid
            abs_pos = (self._entries[lo - 1].cum_end if lo > 0
                       else self._cum_base)
            return self._base_seq + lo, abs_pos

    def head(self) -> Tuple[int, int]:
        """(seq, abs_pos) just past the newest entry (live-only sub)."""
        with self._lock:
            abs_pos = (self._entries[-1].cum_end if self._entries
                       else self._cum_base)
            return self._next_seq, abs_pos

    def fetch(self, seq: int):
        """One cursor probe: ("behind", base_seq, cum_base) when the
        cursor fell off the tail (caller snaps forward and counts
        cum_base - its abs_pos as dropped), ("head", next_seq) at the
        head, or ("entry", entry)."""
        with self._lock:
            if seq < self._base_seq:
                return ("behind", self._base_seq, self._cum_base)
            if seq >= self._next_seq:
                return ("head", self._next_seq)
            return ("entry", self._entries[seq - self._base_seq])

    def note_dropped(self, n: int) -> None:
        """A lagging cursor skipped `n` events (slow-consumer ledger)."""
        with self._lock:
            self.dropped_total += n
        telemetry.REGISTRY.inc("nomad.stream.dropped", n)

    def wait_for(self, seq: int, timeout: float,
                 closed_fn: Callable[[], bool]) -> None:
        """Park until the ring grows past `seq`, closes, or `timeout`.
        The condition wraps the ring lock, so wait_for RELEASES it while
        parked; `closed_fn` is a plain flag read (no lock acquisition)."""
        with self._cond:
            self._cond.wait_for(  # analyze: ok lockorder
                lambda: self._next_seq > seq or self.closed or closed_fn(),
                timeout=timeout)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "entries": len(self._entries),
                "events": ((self._entries[-1].cum_end - self._cum_base)
                           if self._entries else 0),
                "base_seq": self._base_seq,
                "next_seq": self._next_seq,
                "dropped_total": self.dropped_total,
                "bytes": self._approx_bytes,
                "capacity": self._capacity,
            }
