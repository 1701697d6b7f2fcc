"""Cluster-scope metric federation: the leader's pull plane
(reference: the agent-info/operator-debug cluster semantics of
nomad/command/agent — every server answers for itself, the operator
tooling joins the answers).

Each agent serves a compact wire-codec snapshot of its own
observability planes (`GET /v1/agent/self?compact=1`: selected registry
series, flight-ring occupancy, memory-ledger summary, read-follower
lag, and a timeline delta).  The Raft LEADER pulls every gossip peer
plus every registered read follower from its tick loop and publishes
the results as origin-labeled `nomad.cluster.*` gauges — so one
exposition endpoint answers "what is the whole cluster doing" — and
folds the per-origin timeline deltas into the local TIMELINE through
the existing `col@origin` merge path.

Cadence discipline is MEMLEDGER's, verbatim: throttled on the INJECTED
clock (VirtualClock soaks scrape at deterministic virtual instants)
with a wall floor (a compressed virtual hour must not turn into
hundreds of wall scrapes), and the scrape self-meters with
time.perf_counter — host-side cost measurement, the sanctioned raw
primitive.  Scrape VALUES from a live cluster are wall facts and stay
out of every canonical dump; the determinism tests inject a fake
transport, under which the published gauge sequences are byte-identical
run-to-run.

A dead peer is a counted failure (`nomad.cluster.scrape_failures`,
feeding the `cluster_scrape_failures` SLO rule), never an exception:
the tick loop must survive any peer state.

A copy of the reference's nomad_tpu/core/federation.py with its imports
rewritten; nothing else differs (the schema string is the reference's,
so either package's puller reads the other's snapshots).
"""

from __future__ import annotations

import threading
import time
import urllib.error
import urllib.request
from typing import Callable, Dict, List, Optional, Tuple

from nomad_tpu_torch.chaos.clock import Clock, SystemClock
from nomad_tpu_torch.core import wire
from nomad_tpu_torch.core.flightrec import FLIGHT
from nomad_tpu_torch.core.logging import log
from nomad_tpu_torch.core.memledger import MEMLEDGER
from nomad_tpu_torch.core.telemetry import REGISTRY, TRACER
from nomad_tpu_torch.core.timeline import TIMELINE

SCHEMA = "nomad-tpu.federation.v1"

# registry series each snapshot ships (kept to a fixed allowlist so the
# snapshot stays compact no matter how many series a node accumulates)
SNAP_COUNTERS = ("nomad.heartbeat.missed", "nomad.plan.plans",
                 "nomad.plan.plans_refuted", "nomad.health.breaches")
SNAP_GAUGES = ("nomad.health.healthy", "nomad.health.breached_rules",
               "nomad.mem.rss_bytes")


def agent_snapshot(origin: str, state=None, follower=None,
                   since_seq: int = 0) -> Dict:
    """The compact self-snapshot one agent serves (the body of
    `GET /v1/agent/self?compact=1&since_seq=N`, wire-codec packed by
    the HTTP layer).  Pure reads of the process-global planes."""
    counters = {name: REGISTRY.counter_sum(name) for name in SNAP_COUNTERS}
    gauges = {name: REGISTRY.gauge(name) for name in SNAP_GAUGES}
    doc = {
        "Schema": SCHEMA,
        "Origin": origin,
        "At": REGISTRY.clock.monotonic(),
        "Counters": counters,
        "Gauges": gauges,
        "Flight": FLIGHT.mem_stats(),
        "Memory": MEMLEDGER.stats(),
        "AppliedIndex": (int(state.latest_index())
                         if state is not None else 0),
        "Follower": (follower.stats() if follower is not None else None),
        "Timeline": TIMELINE.export_delta(since_seq),
    }
    return doc


def http_transport(timeout: float = 5.0,
                   token: Optional[str] = None) -> Callable:
    """Default peer transport: GET the compact snapshot over HTTP and
    unpack it.  Returns a callable (origin, url, since_seq) -> doc that
    raises on any failure — the puller counts, it never propagates."""

    def fetch(origin: str, url: str, since_seq: int) -> Dict:
        req = urllib.request.Request(
            f"{url}/v1/agent/self?compact=1&since_seq={int(since_seq)}")
        if token:
            req.add_header("X-Nomad-Token", token)
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return wire.unpackb(resp.read())

    return fetch


class FederationPuller:
    """Leader-side scrape loop state.  `sample(now)` is the Server.tick
    hook (injected-clock throttle + wall floor, the MEMLEDGER
    discipline); `scrape()` is the on-demand path the cluster-health
    endpoint can force.  Thread-safe; target fetches run OUTSIDE the
    lock."""

    def __init__(self, origin: str,
                 targets: Callable[[], List[Tuple[str, str]]],
                 transport: Optional[Callable] = None,
                 clock: Optional[Clock] = None,
                 state=None,
                 interval_s: float = 5.0,
                 min_wall_s: float = 0.5) -> None:
        self.origin = origin
        # gossip-derived (origin, url) list; explicit registrations
        # (read followers announcing themselves) merge on top
        self._targets = targets
        self.transport = transport if transport is not None \
            else http_transport()
        self.clock: Clock = clock if clock is not None else SystemClock()
        self.state = state
        self.interval_s = interval_s
        self.min_wall_s = min_wall_s
        self._lock = threading.Lock()
        self._extra: Dict[str, str] = {}      # origin -> url (followers)
        self._since: Dict[str, int] = {}      # origin -> timeline seq
        self._last_at: Optional[float] = None
        self._last_wall = 0.0
        self._origins: Dict[str, Dict] = {}   # origin -> last result row
        self._scrapes = 0
        self._failures = 0
        self._scrape_total_s = 0.0
        self._scrape_cpu_s = 0.0
        self._last_scrape_us = 0.0

    # ---------------------------------------------------------- control

    def register_target(self, origin: str, url: str) -> None:
        """Explicitly add a scrape target (read followers are not gossip
        members, so they announce themselves through this seam — over
        HTTP via PUT /v1/operator/federation/register)."""
        with self._lock:
            self._extra[origin] = url

    def unregister_target(self, origin: str) -> None:
        with self._lock:
            self._extra.pop(origin, None)
            self._since.pop(origin, None)
            self._origins.pop(origin, None)

    def targets(self) -> List[Tuple[str, str]]:
        """Deterministic (origin, url) scrape order: gossip peers plus
        registered followers, self excluded, sorted by origin."""
        rows: Dict[str, str] = {}
        try:
            for origin, url in self._targets():
                if origin and url:
                    rows[origin] = url
        except Exception as exc:  # noqa: BLE001 - membership isolation
            log("federation", "warn", "target enumeration failed",
                error=repr(exc))
        with self._lock:
            rows.update(self._extra)
        rows.pop(self.origin, None)
        return sorted(rows.items())

    # ----------------------------------------------------------- scrape

    def sample(self, now: float) -> bool:
        """Tick-cadence scraping, throttled to `interval_s` of the
        injected clock with a `min_wall_s` wall floor; returns True
        when a scrape ran (same discipline as MemLedger.sample)."""
        with self._lock:
            if (self._last_at is not None
                    and 0 <= now - self._last_at < self.interval_s):
                return False   # negative delta = rebound timebase: due
            w = time.perf_counter()
            if w - self._last_wall < self.min_wall_s:
                return False
            self._last_at = now
            self._last_wall = w
        self.scrape()
        return True

    def scrape(self) -> Dict:
        """Pull every target once, publish `nomad.cluster.*` gauges,
        fold timeline deltas.  Never raises: a failing peer is a
        counted failure row."""
        t0 = time.perf_counter()
        # wall vs CPU ledgers are separate verdicts: wall time is
        # dominated by peer socket waits (GIL released, nothing else
        # stalls — the tick calls this outside its lock), so the
        # overhead budget gates on the CPU this thread actually burns
        c0 = time.thread_time()
        rows: Dict[str, Dict] = {}
        failures = 0
        hb_sum = REGISTRY.counter("nomad.heartbeat.missed")  # self
        lag_max = 0
        self_index = (int(self.state.latest_index())
                      if self.state is not None else 0)
        for origin, url in self.targets():
            with self._lock:
                since = self._since.get(origin, 0)
            p0 = time.perf_counter()
            try:
                doc = self.transport(origin, url, since)
            except Exception as exc:  # noqa: BLE001 - peer isolation
                failures += 1
                REGISTRY.inc("nomad.cluster.scrape_failures",
                             origin=origin)
                rows[origin] = {"Url": url, "Ok": False,
                                "Error": repr(exc)}
                continue
            dt = time.perf_counter() - p0
            REGISTRY.observe_windowed("nomad.cluster.scrape_s", dt,
                                      origin=origin)
            rows[origin] = self._publish(origin, url, doc)
            hb_sum += float(doc.get("Counters", {})
                            .get("nomad.heartbeat.missed", 0.0))
            fol = doc.get("Follower")
            if fol and fol.get("applied_index") is not None:
                lag_max = max(lag_max,
                              max(0, self_index
                                  - int(fol["applied_index"])))
            elif doc.get("AppliedIndex"):
                lag_max = max(lag_max,
                              max(0, self_index
                                  - int(doc["AppliedIndex"])))
            delta = doc.get("Timeline")
            if delta:
                try:
                    TIMELINE.merge_delta(delta, origin)
                    with self._lock:
                        self._since[origin] = int(delta.get("Seq", since))
                except Exception as exc:  # noqa: BLE001 - fold isolation
                    log("federation", "warn", "timeline merge failed",
                        origin=origin, error=repr(exc))
        ok = sum(1 for r in rows.values() if r.get("Ok"))
        REGISTRY.set_gauge("nomad.cluster.peers", float(len(rows)))
        REGISTRY.set_gauge("nomad.cluster.peers_ok", float(ok))
        REGISTRY.set_gauge("nomad.cluster.heartbeat_misses_total",
                           float(hb_sum))
        REGISTRY.set_gauge("nomad.cluster.follower_lag_max",
                           float(lag_max))
        REGISTRY.inc("nomad.cluster.scrapes")
        dt_all = time.perf_counter() - t0
        REGISTRY.set_gauge("nomad.cluster.scrape_us",
                           round(dt_all * 1e6, 2))
        with self._lock:
            self._origins = rows
            self._scrapes += 1
            self._failures += failures
            self._scrape_total_s += dt_all
            self._scrape_cpu_s += time.thread_time() - c0
            self._last_scrape_us = dt_all * 1e6
        return self.doc()

    def _publish(self, origin: str, url: str, doc: Dict) -> Dict:
        """Per-origin gauge fanout for one successful scrape; returns
        the operator-doc row."""
        g = REGISTRY.set_gauge
        counters = doc.get("Counters", {})
        gauges = doc.get("Gauges", {})
        g("nomad.cluster.heartbeat_misses",
          float(counters.get("nomad.heartbeat.missed", 0.0)),
          origin=origin)
        g("nomad.cluster.plans",
          float(counters.get("nomad.plan.plans", 0.0)), origin=origin)
        g("nomad.cluster.healthy",
          float(gauges.get("nomad.health.healthy", 0.0)), origin=origin)
        g("nomad.cluster.breached_rules",
          float(gauges.get("nomad.health.breached_rules", 0.0)),
          origin=origin)
        g("nomad.cluster.rss_bytes",
          float(gauges.get("nomad.mem.rss_bytes", 0.0)), origin=origin)
        g("nomad.cluster.applied_index",
          float(doc.get("AppliedIndex", 0)), origin=origin)
        flight = doc.get("Flight") or {}
        g("nomad.cluster.flight_entries",
          float(flight.get("entries", 0)), origin=origin)
        row = {"Url": url, "Ok": True, "At": doc.get("At"),
               "AppliedIndex": doc.get("AppliedIndex", 0),
               "Healthy": bool(gauges.get("nomad.health.healthy", 0.0)),
               "BreachedRules":
                   int(gauges.get("nomad.health.breached_rules", 0.0)),
               "HeartbeatMisses":
                   int(counters.get("nomad.heartbeat.missed", 0.0)),
               "RSSBytes": int(gauges.get("nomad.mem.rss_bytes", 0.0))}
        fol = doc.get("Follower")
        if fol:
            row["Follower"] = {"AppliedIndex": fol.get("applied_index"),
                               "LastContactS": fol.get("last_contact_s"),
                               "Failures": fol.get("failures")}
        return row

    # -------------------------------------------------------- documents

    def doc(self) -> Dict:
        """The operator document (`GET /v1/operator/cluster-health`'s
        Federation section, the debug bundle's Cluster section)."""
        with self._lock:
            origins = {k: dict(v)
                       for k, v in sorted(self._origins.items())}
            out = {
                "Schema": SCHEMA,
                "Origin": self.origin,
                "Origins": origins,
                "Scrapes": self._scrapes,
                "Failures": self._failures,
                "ScrapeMicros": round(self._last_scrape_us, 2),
                "ScrapeTotalSeconds": round(self._scrape_total_s, 6),
                "ScrapeCPUSeconds": round(self._scrape_cpu_s, 6),
            }
        out["FollowerLagMax"] = REGISTRY.gauge(
            "nomad.cluster.follower_lag_max")
        return out

    def stats(self) -> Dict:
        with self._lock:
            return {"scrapes": self._scrapes,
                    "failures": self._failures,
                    "targets": sorted(set(self._extra)),
                    "scrape_total_s": round(self._scrape_total_s, 6),
                    "scrape_cpu_s": round(self._scrape_cpu_s, 6),
                    "last_scrape_us": round(self._last_scrape_us, 2)}


# ---------------------------------------------------------------------------
# cross-node trace stitching
# ---------------------------------------------------------------------------


def stitch_trace(trace_id: str,
                 spans_by_origin: Dict[str, List[Dict]]) -> Dict:
    """Join per-origin span lists into one cluster-wide trace tree.

    Span IDs are `span_id(trace_id, name)` — deterministic per name —
    so the same logical hop recorded on two nodes collides by SpanID
    alone; stitching therefore keys spans by (Origin, SpanID) and
    resolves ParentID preferentially to a same-origin span, falling
    back to any origin (that cross-origin edge IS the forwarded-RPC →
    leader-commit seam the stitched view exists to show)."""
    spans: List[Dict] = []
    seen = set()
    for origin in sorted(spans_by_origin):
        for s in spans_by_origin[origin]:
            key = (origin, s.get("SpanID"))
            if key in seen:
                continue
            seen.add(key)
            row = dict(s)
            row["Origin"] = origin
            spans.append(row)
    spans.sort(key=lambda s: (s.get("Start", 0.0), s.get("Seq", 0),
                              s["Origin"]))
    by_id: Dict[str, List[Dict]] = {}
    for s in spans:
        by_id.setdefault(s.get("SpanID", ""), []).append(s)

    children: Dict[Tuple[str, str], List[Dict]] = {}
    roots: List[Dict] = []
    for s in spans:
        pid = s.get("ParentID") or ""
        parents = by_id.get(pid, [])
        if not parents:
            roots.append(s)
            continue
        parent = next((p for p in parents
                       if p["Origin"] == s["Origin"]), parents[0])
        if parent is s:
            roots.append(s)
            continue
        children.setdefault((parent["Origin"], parent["SpanID"]),
                            []).append(s)

    def node(s: Dict) -> Dict:
        kids = children.get((s["Origin"], s["SpanID"]), [])
        return {"Span": s, "Children": [node(k) for k in kids]}

    return {
        "TraceID": trace_id,
        # only origins that CONTRIBUTED spans — a polled-but-empty peer
        # is absent, so len(Origins) >= 2 means a genuinely cross-node
        # trace, not just a wide poll
        "Origins": sorted({s["Origin"] for s in spans}),
        "SpanCount": len(spans),
        "Spans": spans,
        "Tree": [node(r) for r in roots],
    }


def local_trace(trace_id: str) -> List[Dict]:
    """This node's spans for one trace (the per-origin unit the
    stitched view scatter-gathers)."""
    return TRACER.trace(trace_id)
