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

A copy of the reference's nomad_tpu/core/fanout.py with its imports
rewritten; nothing else differs.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from nomad_tpu_torch.core import telemetry
from nomad_tpu_torch.core.logging import log

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


# ---------------------------------------------------------------------------
# ReadFollower — journal-tailing read replica over HTTP
# ---------------------------------------------------------------------------


class ReadFollower:
    """Tails a leader's `/v1/operator/export` journal into a local
    StateStore (apply_export notifies the store's index condition, so
    local blocking queries and the WatchHub work unchanged on the
    replica).  `upstreams` is an ordered candidate list — on pull
    failure the tail rotates to the next candidate (leader failover).

    Staleness contract: the applied index NEVER regresses.  An upstream
    behind our head (a lagging server right after failover) is skipped
    until it catches up — reads served by this follower are
    stale-bounded but monotonic."""

    def __init__(self, state, clock, upstreams: List[str],
                 token: str = "", poll_wait: float = 2.0,
                 backoff: float = 0.5) -> None:
        if not upstreams:
            raise ValueError("ReadFollower needs at least one upstream URL")
        self.state = state
        self.clock = clock
        # accept bare host:port (the CLI/HCL form) as well as full URLs
        self.upstreams = [u if "://" in u else f"http://{u}"
                          for u in (s.rstrip("/") for s in upstreams)]
        self.token = token
        self.poll_wait = poll_wait
        self.backoff = backoff
        self.known_leader = False
        self._active = 0                # index into upstreams
        self._last_contact = None       # clock.monotonic() of last pull
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.pulls = 0
        self.failures = 0
        self.skipped_regressions = 0
        # metric-federation registration (core/federation.py): when the
        # Agent sets `announce = (origin, own-http-url)`, each upstream
        # this follower successfully pulls from is told where to scrape
        # it (PUT /v1/operator/federation/register).  Re-announced after
        # every upstream rotation, so a failover re-registers with the
        # new leader on the first successful pull.
        self.announce: Optional[Tuple[str, str]] = None
        self._announced_to = ""

    # ---------------------------------------------------------- control

    def start(self) -> "ReadFollower":
        self._thread = threading.Thread(target=self._run,
                                        name="read-follower", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # ------------------------------------------------------------- tail

    @property
    def upstream(self) -> str:
        return self.upstreams[self._active]

    def last_contact_s(self) -> Optional[float]:
        """Seconds since the last successful pull (clock time)."""
        if self._last_contact is None:
            return None
        return max(self.clock.monotonic() - self._last_contact, 0.0)

    def publish_gauges(self) -> None:
        """Registry gauges for applied index + staleness, so federation
        and the soak verdict gate follower lag without scraping the
        X-Nomad-* HTTP headers.  Refreshed on every pull outcome (the
        staleness gauge must keep growing while the upstream is dark)
        and on demand from stats()/the agent snapshot."""
        telemetry.REGISTRY.set_gauge("nomad.follower.applied_index",
                                     float(self.state.latest_index()))
        last = self.last_contact_s()
        if last is not None:
            telemetry.REGISTRY.set_gauge("nomad.follower.last_contact_s",
                                         round(last, 6))

    def _fetch(self, url: str) -> bytes:
        import urllib.request
        req = urllib.request.Request(url)
        if self.token:
            req.add_header("X-Nomad-Token", self.token)
        with urllib.request.urlopen(req,
                                    timeout=self.poll_wait + 5.0) as resp:
            return resp.read()

    def _pull_once(self) -> bool:
        from nomad_tpu_torch.core import wire
        since = self.state.latest_index()
        url = (f"{self.upstream}/v1/operator/export"
               f"?since={since}&wait={self.poll_wait}")
        try:
            export = wire.unpackb(self._fetch(url))
        except Exception as exc:  # noqa: BLE001 - any transport/codec fail
            self.failures += 1
            if self.known_leader:
                log("follower", "warn", "export pull failed",
                    upstream=self.upstream, error=repr(exc))
            self.known_leader = False
            self._active = (self._active + 1) % len(self.upstreams)
            telemetry.REGISTRY.inc("nomad.follower.pull_failures")
            self.publish_gauges()
            return False
        head = int(export.get("index", 0))
        if head < since:
            # lagging upstream (fresh follower of a deposed leader):
            # applying would regress reads we already served — skip and
            # rotate until someone has caught up past our head
            self.skipped_regressions += 1
            telemetry.REGISTRY.inc("nomad.follower.regressions_skipped")
            self._active = (self._active + 1) % len(self.upstreams)
            return False
        if export.get("kind") != "empty":
            self.state.apply_export(export)
            telemetry.REGISTRY.inc("nomad.follower.applied_exports")
        self.pulls += 1
        self.known_leader = True
        self._last_contact = self.clock.monotonic()
        self.publish_gauges()
        if self.announce is not None and self._announced_to != self.upstream:
            self._announce_once()
        return True

    def _announce_once(self) -> None:
        """Register this follower as a federation scrape target with the
        active upstream.  Best-effort: a failed announce retries on the
        next successful pull (the flag only latches on success)."""
        import json
        import urllib.request
        origin, url = self.announce
        req = urllib.request.Request(
            f"{self.upstream}/v1/operator/federation/register",
            data=json.dumps({"Origin": origin, "Url": url}).encode(),
            method="PUT")
        req.add_header("Content-Type", "application/json")
        if self.token:
            req.add_header("X-Nomad-Token", self.token)
        try:
            with urllib.request.urlopen(req, timeout=5.0) as resp:
                resp.read()
            self._announced_to = self.upstream
        except Exception as exc:  # noqa: BLE001 - best-effort registration
            log("follower", "debug", "federation announce failed",
                upstream=self.upstream, error=repr(exc))

    def _run(self) -> None:
        from nomad_tpu_torch.core.flightrec import FLIGHT
        FLIGHT.record_event("follower.start", upstream=self.upstream)
        try:
            while not self._stop.is_set():
                ok = self._pull_once()
                if self._stop.is_set():
                    break
                if not ok:
                    # real-time pacing for a real HTTP upstream: the
                    # clock seam still gates the wait so virtual soaks
                    # can park it
                    self.clock.wait(self._stop, self.backoff)
        except Exception as exc:  # noqa: BLE001 - daemon must not die mute
            log("follower", "error", "tail loop died", error=repr(exc))
            FLIGHT.record_event("follower.crash", error=repr(exc))
            raise
        finally:
            FLIGHT.record_event("follower.stop",
                                applied_index=self.state.latest_index())

    # ------------------------------------------------------------ proxy

    def proxy(self, method: str, path: str, qs: str, body: Optional[bytes],
              token: str = "") -> Tuple[int, bytes]:
        """Forward a write (or consistent read) verbatim to the active
        upstream — the follower serves stale-bounded reads itself and
        proxies everything that must see the leader."""
        import urllib.error
        import urllib.request
        url = self.upstream + path + (f"?{qs}" if qs else "")
        req = urllib.request.Request(url, data=body, method=method)
        req.add_header("Content-Type", "application/json")
        if token:
            req.add_header("X-Nomad-Token", token)
        try:
            with urllib.request.urlopen(req, timeout=15.0) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    def stats(self) -> Dict:
        self.publish_gauges()
        return {
            "upstream": self.upstream,
            "known_leader": self.known_leader,
            "last_contact_s": self.last_contact_s(),
            "applied_index": self.state.latest_index(),
            "pulls": self.pulls,
            "failures": self.failures,
            "regressions_skipped": self.skipped_regressions,
        }
