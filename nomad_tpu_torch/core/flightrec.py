"""Flight recorder + dump-on-anomaly health plane.

The cumulative metrics plane (core/telemetry.py) answers "how has this
process behaved since boot"; an operator debugging a live incident needs
"what happened in the last few seconds of the hot path".  This module is
that bounded recent-history view, plus the watchdog that turns it into a
diagnosis automatically:

  - `FlightRecorder` — a process-wide ring of per-WAVE records (stage
    intervals from wavepipe's StageTimers, executor chain residency,
    engine shard-upload/collective bytes, applier refuted rows, port
    batch counts) and per-EVAL tail records (schedule latency,
    queue-wait, apply time, outcome, trace id), fed from the wave hot
    path through one cheap `record_wave`/`record_eval` seam.  Records
    merge by key: numeric fields accumulate (a wave's several commit
    intervals sum), everything else overwrites.
  - `HealthWatchdog` — declarative SLO rules (agent_config
    `server.slo.*`) evaluated each server tick against the rolling-
    window histograms (telemetry.observe_windowed) and counter deltas.
    On a rule's ok→breach transition it emits a `HealthBreach`
    event-stream topic and snapshots the flight ring + windowed
    summaries + recent traces/logs into a JSON dump bundle — the
    operator gets a diagnosis, not just a gauge.

Everything reads the injectable chaos Clock, so a seeded scenario on a
`VirtualClock` produces byte-identical windowed summaries, verdicts, and
dump bundles — the soak simulator (ROADMAP item 4) asserts against this
plane.  Like `REGISTRY`/`TRACER`/`RING`, the `FLIGHT` singleton is
process-global (one agent per process in practice).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Dict, List, Optional

from nomad_tpu_torch.chaos.clock import Clock, SystemClock
from nomad_tpu_torch.core.profiling import PROFILER
from nomad_tpu_torch.core.telemetry import (
    REGISTRY, TRACER, MetricsRegistry, Tracer)
from nomad_tpu_torch.core.timeline import TIMELINE, Timeline


class FlightRecorder:
    """Bounded rings of recent hot-path records.  Thread-safe; every
    record call is a dict merge under one lock — cheap enough for the
    per-wave path (PERF.md §14 measures it)."""

    def __init__(self, clock: Optional[Clock] = None,
                 max_waves: int = 512, max_evals: int = 2048,
                 max_events: int = 256) -> None:
        self._lock = threading.Lock()
        self.clock: Clock = clock if clock is not None else SystemClock()
        self._waves: deque = deque(maxlen=max_waves)
        self._by_wave: Dict[int, Dict] = {}
        self._evals: deque = deque(maxlen=max_evals)
        self._by_eval: Dict[str, Dict] = {}
        self._events: deque = deque(maxlen=max_events)
        self._seq = 0
        # overflow is COUNTED, never silent (the LogRing posture)
        self.stats = {"wave_evictions": 0, "eval_evictions": 0,
                      "event_evictions": 0}

    def set_clock(self, clock: Clock) -> None:
        self.clock = clock

    # ---------------------------------------------------------- recording

    @staticmethod
    def _merge(rec: Dict, fields: Dict) -> None:
        for k, v in fields.items():
            # numeric fields ACCUMULATE (stage seconds across a wave's
            # plans, refuted-row counts); bools/strings overwrite
            if (isinstance(v, (int, float)) and not isinstance(v, bool)
                    and isinstance(rec.get(k), (int, float))
                    and not isinstance(rec.get(k), bool)):
                rec[k] = rec[k] + v
            else:
                rec[k] = v

    def _open(self, ring: deque, by_key: Dict, key, key_field: str,
              evict_stat: str) -> Dict:
        rec = by_key.get(key)
        if rec is None:
            if len(ring) == ring.maxlen:
                by_key.pop(ring[0][key_field], None)
                self.stats[evict_stat] += 1
            self._seq += 1
            rec = {key_field: key, "Seq": self._seq,
                   "T": round(self.clock.monotonic(), 9)}
            ring.append(rec)
            by_key[key] = rec
        return rec

    def record_wave(self, wave: int, **fields) -> None:
        """Merge fields into wave `wave`'s record (creating it on first
        sight).  Wave ids are process-unique (wavepipe's global wave
        counter), so records from every worker's pipeline, the shared
        StageTimers, and the applier land in one place."""
        if wave is None or wave < 0:
            return
        with self._lock:
            self._merge(self._open(self._waves, self._by_wave, wave,
                                   "Wave", "wave_evictions"), fields)

    def record_eval(self, eval_id: str, **fields) -> None:
        """Merge fields into eval `eval_id`'s tail record (worker settle
        stamps schedule latency + outcome; the plan applier stamps
        queue-wait/apply time and refuted rows)."""
        if not eval_id:
            return
        with self._lock:
            self._merge(self._open(self._evals, self._by_eval, eval_id,
                                   "EvalID", "eval_evictions"), fields)

    def record_event(self, kind: str, **fields) -> None:
        """Append one process event (executor chain invalidations,
        health breaches) to the bounded event ring."""
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self.stats["event_evictions"] += 1
            self._seq += 1
            rec = {"Kind": kind, "Seq": self._seq,
                   "T": round(self.clock.monotonic(), 9)}
            rec.update(fields)
            self._events.append(rec)

    # ------------------------------------------------------------ reading

    def waves(self, n: Optional[int] = None) -> List[Dict]:
        with self._lock:
            out = [dict(r) for r in self._waves]
        return out[-n:] if n else out

    def evals(self, n: Optional[int] = None) -> List[Dict]:
        with self._lock:
            out = [dict(r) for r in self._evals]
        return out[-n:] if n else out

    def events(self, n: Optional[int] = None) -> List[Dict]:
        with self._lock:
            out = [dict(r) for r in self._events]
        return out[-n:] if n else out

    def snapshot(self, n_waves: Optional[int] = None,
                 n_evals: Optional[int] = None,
                 n_events: Optional[int] = None) -> Dict:
        """JSON-safe dump of the rings, newest last."""
        waves = self.waves(n_waves)
        evals = self.evals(n_evals)
        events = self.events(n_events)
        # [start, end] on the shared clock across every retained record:
        # `nomad report` cross-links flight dumps into the timeline via
        # this window (None when the rings are empty)
        stamps = [r["T"] for ring in (waves, evals, events)
                  for r in ring if "T" in r]
        return {
            "Waves": waves,
            "Evals": evals,
            "Events": events,
            "TimelineWindow": ([round(min(stamps), 9),
                                round(max(stamps), 9)]
                               if stamps else None),
            "Stats": dict(self.stats),
            "Capacity": {"waves": self._waves.maxlen,
                         "evals": self._evals.maxlen,
                         "events": self._events.maxlen},
        }

    def reset(self) -> None:
        with self._lock:
            self._waves.clear()
            self._by_wave.clear()
            self._evals.clear()
            self._by_eval.clear()
            self._events.clear()
            self._seq = 0
            for k in self.stats:
                self.stats[k] = 0

    def mem_stats(self) -> Dict:
        """Ledger sizer (core/memledger): ring occupancy + a sampled
        byte estimate (one newest record per ring sized per call; the
        records are flat dicts so this stays microseconds)."""
        from nomad_tpu_torch.core.memledger import approx_sizeof
        with self._lock:
            entries = (len(self._waves) + len(self._evals)
                       + len(self._events))
            cap = (self._waves.maxlen + self._evals.maxlen
                   + self._events.maxlen)
            evictions = sum(self.stats.values())
            sample = [ring[-1] for ring in (self._waves, self._evals,
                                            self._events) if ring]
        per = (sum(approx_sizeof(r, depth=2) for r in sample)
               / len(sample)) if sample else 0.0
        return {"bytes": int(per * entries), "entries": entries,
                "cap": cap, "evictions": evictions}


# --------------------------------------------------------------- watchdog

# SLO knobs (agent_config `server { slo { ... } }`).  Ceilings breach when
# observed > threshold, floors when observed < threshold; a rule whose
# interval produced no traffic reads Observed=None and stays Ok.  Any
# threshold set negative disables its rule.
DEFAULT_SLO = {
    # rolling-window p99 of plan enqueue->apply-start wait (the north
    # star's latency metric; BENCH_r05 measured 0.99ms at full scale)
    "p99_plan_queue_ms": 500.0,
    # refuted plans / committed plans over the check interval (measured
    # 0.0 with partitioned workers; sustained refutes mean the fence or
    # the partition is broken)
    "refute_rate": 0.25,
    # resident-chain invalidations per second: a storm means every wave
    # re-uploads node state (foreign writes defeating the chain)
    "invalidations_per_s": 50.0,
    # FLOOR: columnar-carved port rows / all port rows — networked waves
    # demoting to the sequential fallback is the regression to catch
    "networked_ratio": 0.25,
    # missed heartbeat TTLs per check interval (a flap storm)
    "heartbeat_misses": 64.0,
    # process RSS ceiling in MiB (core/memledger's tick-sampled
    # VmRSS).  Disabled by default — a sane ceiling is deployment-
    # sized; the RSS-gated soak (chaos/soak.py rss_ceiling_mb) and
    # agent_config server.slo.rss_mb turn it on
    "rss_mb": -1.0,
    # cluster-federation rules (core/federation.py; Observed=None until
    # the leader's puller has scraped at least once, so followers and
    # standalone servers can never breach them):
    #   failed peer/follower scrapes per check interval (any failure is
    #   a breach — a clean cluster scrapes clean)
    "cluster_scrape_failures": 0.0,
    #   max follower applied-index lag behind the leader's last index
    "cluster_follower_lag": 1024.0,
    #   cross-peer missed-heartbeat sum per check interval (the local
    #   heartbeat_misses rule, widened to the whole cluster)
    "cluster_heartbeat_misses": 64.0,
    # rolling-window span + check throttle (not rules)
    "window_s": 60.0,
    "interval_s": 5.0,
}


def _memory_doc() -> Dict:
    """Memory-ledger operator document for breach dumps (late import:
    memledger imports telemetry only, but keep the edge one-way)."""
    from nomad_tpu_torch.core.memledger import MEMLEDGER
    return MEMLEDGER.doc()

# "log ring not specified" sentinel: None is meaningful (no logs in
# dumps — the deterministic-bundle tests use it)
_UNSET = object()


class HealthWatchdog:
    """Evaluates the SLO rules each tick and snapshots a dump bundle on
    every ok→breach transition.  Counter-delta rules (refute rate,
    invalidation storms, heartbeat misses) measure between consecutive
    checks; window rules read the registry's rolling histograms."""

    def __init__(self, slo: Optional[Dict[str, float]] = None,
                 clock: Optional[Clock] = None,
                 registry: Optional[MetricsRegistry] = None,
                 flight: Optional[FlightRecorder] = None,
                 tracer: Optional[Tracer] = None,
                 log_ring=_UNSET,
                 timeline: Optional[Timeline] = None,
                 max_dumps: int = 8) -> None:
        cfg = dict(DEFAULT_SLO)
        for k, v in (slo or {}).items():
            if k not in DEFAULT_SLO:
                raise ValueError(
                    f"unknown slo setting {k!r} "
                    f"(expected one of {sorted(DEFAULT_SLO)})")
            cfg[k] = float(v)
        self.slo = cfg
        self.clock: Clock = clock if clock is not None else SystemClock()
        self.registry = registry if registry is not None else REGISTRY
        self.flight = flight if flight is not None else FLIGHT
        self.tracer = tracer if tracer is not None else TRACER
        self.timeline = timeline if timeline is not None else TIMELINE
        if log_ring is _UNSET:
            from nomad_tpu_torch.core.logging import RING
            log_ring = RING
        self.log_ring = log_ring
        self.registry.set_window(cfg["window_s"])
        self._lock = threading.Lock()
        self._last_t: Optional[float] = None
        self._last_counters: Optional[Dict[str, float]] = None
        self._breached: set = set()
        self._dumps: deque = deque(maxlen=max_dumps)
        self.stats = {"checks": 0, "breaches": 0}
        # wired by the Server: called with (verdict, bundle) on each
        # newly-breached rule so the HealthBreach event topic fires
        self.on_breach: Optional[Callable] = None

    # --------------------------------------------------------- evaluation

    def _counters(self) -> Dict[str, float]:
        r = self.registry
        return {
            "plans": r.counter("nomad.plan.plans"),
            "plans_refuted": r.counter("nomad.plan.plans_refuted"),
            "invalidations":
                r.counter_sum("nomad.executor.invalidations"),
            "heartbeat_misses": r.counter("nomad.heartbeat.missed"),
            "ports_batched": r.counter("nomad.ports.batched_rows"),
            "ports_sequential": r.counter("nomad.ports.sequential_rows"),
            # federation plane (core/federation.py): scrapes gates the
            # cluster rules on "has the puller ever run here", failures
            # and the cross-peer heartbeat sum are counter-shaped deltas
            "cluster_scrapes": r.counter("nomad.cluster.scrapes"),
            # failures are origin-labeled; the rule sums across origins
            "cluster_scrape_failures":
                r.counter_sum("nomad.cluster.scrape_failures"),
            "cluster_heartbeat_misses":
                r.gauge("nomad.cluster.heartbeat_misses_total"),
        }

    def _verdicts(self, cur: Dict[str, float],
                  last: Optional[Dict[str, float]],
                  dt: Optional[float]) -> List[Dict]:
        def delta(key):
            return cur[key] - last[key] if last is not None else None

        ws = self.registry.window_summary("nomad.plan.queue_wait_s")
        p99_ms = (round(ws["p99"] * 1000, 6)
                  if ws and ws["count"] else None)
        d_plans = delta("plans")
        refute = (round(delta("plans_refuted") / d_plans, 6)
                  if d_plans else None)
        inval = (round(delta("invalidations") / dt, 6)
                 if dt else None)
        d_ports = ((delta("ports_batched") or 0)
                   + (delta("ports_sequential") or 0)
                   if last is not None else 0)
        net = (round(delta("ports_batched") / d_ports, 6)
               if d_ports else None)
        hb = delta("heartbeat_misses")
        # memory plane (core/memledger): last tick-sampled RSS; None
        # before the first scrape so the rule cannot breach during boot
        from nomad_tpu_torch.core.memledger import MEMLEDGER
        rss = round(MEMLEDGER.rss_mb(), 3) or None
        # cluster rules observe None until this node's federation puller
        # has scraped (leaders only): followers/standalone never breach
        fed = cur["cluster_scrapes"] > 0
        c_fail = delta("cluster_scrape_failures") if fed else None
        c_hb = delta("cluster_heartbeat_misses") if fed else None
        c_lag = (self.registry.gauge("nomad.cluster.follower_lag_max")
                 if fed else None)
        rows = (
            ("p99_plan_queue_ms", "ceiling", p99_ms, "ms",
             "rolling-window p99 of nomad.plan.queue_wait_s"),
            ("refute_rate", "ceiling", refute, "ratio",
             "refuted plans / plans since last check"),
            ("invalidations_per_s", "ceiling", inval, "1/s",
             "resident-chain invalidations per second"),
            ("networked_ratio", "floor", net, "ratio",
             "columnar-carved port rows / all port rows"),
            ("heartbeat_misses", "ceiling", hb, "count",
             "missed heartbeat TTLs since last check"),
            ("rss_mb", "ceiling", rss, "MiB",
             "tick-sampled process VmRSS (core/memledger)"),
            ("cluster_scrape_failures", "ceiling", c_fail, "count",
             "failed federation scrapes since last check"),
            ("cluster_follower_lag", "ceiling", c_lag, "index",
             "max follower applied-index lag at last federation scrape"),
            ("cluster_heartbeat_misses", "ceiling", c_hb, "count",
             "cross-peer missed heartbeat TTLs since last check"),
        )
        verdicts = []
        for name, kind, observed, unit, source in rows:
            threshold = self.slo[name]
            if threshold < 0 or observed is None:
                ok = True
            elif kind == "ceiling":
                ok = observed <= threshold
            else:
                ok = observed >= threshold
            verdicts.append({"Rule": name, "Kind": kind,
                             "Threshold": threshold,
                             "Observed": observed, "Ok": ok,
                             "Unit": unit, "Source": source})
        return verdicts

    def check(self, now: Optional[float] = None) -> Dict:
        """Evaluate every rule; on any ok→breach transition snapshot a
        dump bundle, count the breach, and fire `on_breach`.  Returns
        the verdict doc (`GET /v1/operator/health`'s body)."""
        t = now if now is not None else self.clock.monotonic()
        with self._lock:
            cur = self._counters()
            last, self._last_counters = self._last_counters, cur
            dt = (t - self._last_t
                  if self._last_t is not None and t > self._last_t
                  else None)
            self._last_t = t
            verdicts = self._verdicts(cur, last, dt)
            failing = [v for v in verdicts if not v["Ok"]]
            newly = [v for v in failing if v["Rule"] not in self._breached]
            recovered = sorted(self._breached
                               - {v["Rule"] for v in failing})
            self._breached = {v["Rule"] for v in failing}
            self.stats["checks"] += 1
            bundle = None
            if newly:
                self.stats["breaches"] += len(newly)
                bundle = self._build_dump(t, verdicts, failing)
                self._dumps.append(bundle)
            doc = {"Healthy": not failing, "At": round(t, 9),
                   "Rules": verdicts,
                   "Breaches": self.stats["breaches"],
                   "Checks": self.stats["checks"],
                   "Dumps": len(self._dumps),
                   "WindowS": self.slo["window_s"]}
        self.registry.set_gauge("nomad.health.healthy",
                                0.0 if failing else 1.0)
        self.registry.set_gauge("nomad.health.breached_rules",
                                len(failing))
        if newly:
            self.registry.inc("nomad.health.breaches", len(newly))
            self.flight.record_event(
                "health.breach", rules=[v["Rule"] for v in newly])
            for v in newly:
                # the timeline's breach annotations are what `nomad
                # report` attributes to nearby cluster events
                self.timeline.annotate("health.breach", now=t,
                                       rule=v["Rule"],
                                       observed=v["Observed"],
                                       threshold=v["Threshold"])
            cb = self.on_breach
            if cb is not None:
                for v in newly:
                    cb(v, bundle)
        for rule in recovered:
            self.timeline.annotate("health.recover", now=t,
                                   rule=rule)
        return doc

    def rebase(self, now: Optional[float] = None) -> None:
        """Reset the counter-delta baseline without evaluating rules.
        The soak runner calls this after an interleaved chaos scenario
        ran OTHER servers in this process: the shared REGISTRY counters
        jumped for reasons outside this server's SLO, and charging that
        activity to the next check's deltas would fabricate a breach."""
        t = now if now is not None else self.clock.monotonic()
        with self._lock:
            self._last_counters = self._counters()
            self._last_t = t

    def tick(self, now: Optional[float] = None) -> Optional[Dict]:
        """Throttled check (the Server tick calls this every second;
        rules evaluate once per `slo.interval_s`)."""
        t = now if now is not None else self.clock.monotonic()
        with self._lock:
            last = self._last_t
        if last is not None and t - last < self.slo["interval_s"]:
            return None
        return self.check(t)

    # --------------------------------------------------------------- dump

    def _build_dump(self, now: float, verdicts: List[Dict],
                    failing: List[Dict]) -> Dict:
        """One JSON diagnosis: what breached, the flight rings, windowed
        summaries, and the recent traces/logs that cover the window."""
        snap = self.registry.snapshot()
        return {
            "Schema": "nomad-tpu.health-dump.v1",
            "At": round(now, 9),
            "Breaches": [dict(v) for v in failing],
            "Verdicts": [dict(v) for v in verdicts],
            "SLO": dict(self.slo),
            "FlightRecorder": self.flight.snapshot(),
            # where the process was spending time when it breached, and
            # the endpoint to pull a full capture from (sampler reads the
            # real clock, so this section is excluded from soak
            # byte-identity assertions — see tests/test_profiling.py)
            "Profiler": PROFILER.brief(),
            # the surrounding timeline slice (±window around the
            # breach; the future half is whatever history exists by
            # dump time) — "what was the cluster doing when this
            # breached" without a second query
            "Timeline": self.timeline.slice(
                now - self.slo["window_s"],
                now + self.slo["window_s"]),
            "Windows": snap["windows"],
            "Counters": snap["counters"],
            "Traces": self.tracer.traces()[-50:],
            "Spans": self.tracer.spans()[-200:],
            "Logs": (self.log_ring.tail(200)
                     if self.log_ring is not None else []),
            # per-plane footprint at breach time (core/memledger): an
            # OOM-adjacent breach diagnoses itself from the dump
            "Memory": _memory_doc(),
        }

    def dumps(self) -> List[Dict]:
        with self._lock:
            return list(self._dumps)


# ---------------------------------------------------------------- globals

FLIGHT = FlightRecorder()


def configure(clock: Clock) -> None:
    """Bind the process flight recorder to an injected clock (every
    Server calls this with its own, next to telemetry.configure)."""
    FLIGHT.set_clock(clock)


from nomad_tpu_torch.core.obsbus import OBSBUS  # noqa: E402 - after globals

OBSBUS.register("flightrec", configure=FLIGHT.set_clock,
                snapshot=FLIGHT.snapshot, reset=FLIGHT.reset)
