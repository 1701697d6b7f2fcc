"""Retrospective timeline plane: clock-aligned metric history plus a
unified cross-plane annotation stream.

Every other observability surface answers "what is happening NOW" —
registry gauges, windowed histograms, flight rings, watchdog verdicts
are all point-in-time.  After a soak the only artifacts are pass/fail
gates and a fingerprint, and "why did plan-queue p99 spike at
vt=5400s?" is unanswerable.  The TIMELINE singleton retains history:

  - a bounded COLUMNAR time-series of curated registry reads, one row
    per clock-aligned bucket (`int(now // step_s)`), sampled on every
    `Server.tick` off the injected Clock;
  - a bounded ANNOTATION stream fed by every plane: traffic events,
    chaos scenario start/end, rolling deploys, leadership transitions,
    drain begin/restore, HealthWatchdog breach/recover, worker-pool
    child respawns, executor chain invalidations.

Determinism discipline (the whole point of sampling off the injected
clock): a VirtualClock soak replays byte-identical for the same seed,
so the CANONICAL dump — what the soak writes next to its trace and
what `tests/test_timeline.py` double-runs — is restricted to data that
is a pure function of the seeded schedule, and to annotation kinds
stamped from deterministic code paths:

  - canonical series: heartbeat misses — flap/drain/chaos schedules
    are seeded and TTL expiry is clock-driven, so the settled per-step
    deltas replay exactly.  Counter columns store RUN-RELATIVE values
    (raw minus the base captured at `reset()`), because the process
    registry is never reset between runs.
  - volatile series (queries only, never canonical): everything
    downstream of PLACEMENT or worker-thread interleaving.  The soak
    runs concurrent scheduler workers, so which node hosts a replica —
    and therefore evals/s under node chaos, plan-queue p99, the
    scheduling-quality gauges, refute/invalidation/upload rates — is
    thread-timing shaped.  Same doctrine as `coarse_fingerprint`,
    which ignores placement for exactly this reason.
  - wall series: gil-wait rides the real-clock PROFILER and is
    excluded the same way the Profiler section of health dumps is.

Settled-wins buckets: the soak samples once more after each quiesce
with `settled=True`; a settled row can only be replaced by another
settled row, so the async tick thread's mid-step (racy) sample of the
same bucket never survives into the canonical dump.

Both rings evict COUNTED, never silently (`stats["point_evictions"]`,
`stats["annotation_evictions"]`) — same posture as the flight
recorder and the log ring.
"""

from __future__ import annotations

import json
import threading
import time as _time  # perf_counter only: host-side self-metering
from typing import Dict, Iterable, List, Optional, Tuple

from nomad_tpu_torch.chaos.clock import Clock, SystemClock
from nomad_tpu_torch.core.telemetry import REGISTRY, MetricsRegistry

SCHEMA = "nomad-tpu.timeline.v1"
REPORT_SCHEMA = "nomad-tpu.timeline-report.v1"

# Raw columns sampled each tick.  kind: "cum" columns hold run-relative
# monotonic counter values (rates/deltas derive from consecutive
# buckets at query time, so a bucket overwrite never corrupts a rate);
# "gauge" columns are point-in-time.
_CUM_COLS = ("acked", "heartbeat_missed", "plans", "plans_refuted",
             "invalidations", "uploads", "upload_bytes")
_GAUGE_COLS = ("plan_queue_p99_ms", "nodes_in_use",
               "zone_balance_max_over_min", "binpack_fill_cpu",
               "gil_wait_fraction")

# Derived series exposed by query()/report.  Partitioned by
# determinism class (see module docstring).
CANONICAL_SERIES = ("heartbeat_misses",)
VOLATILE_SERIES = ("evals_per_s", "plan_queue_p99_ms", "nodes_in_use",
                   "zone_balance_max_over_min", "binpack_fill_cpu",
                   "refute_rate", "invalidations_per_s",
                   "uploads_per_s", "upload_mb_per_s")
WALL_SERIES = ("gil_wait_fraction",)
ALL_SERIES = CANONICAL_SERIES + VOLATILE_SERIES + WALL_SERIES

# Annotation kinds whose presence/count depends on worker-thread
# interleaving or the wall clock; present in queries, excluded from
# the canonical dump.
VOLATILE_KINDS = ("executor.invalidation", "pool.respawn")


class Timeline:
    """Bounded columnar metric history + annotation stream.  All
    mutators are thread-safe; all timestamps come from the injected
    clock (self-metering alone reads perf_counter)."""

    def __init__(self, clock: Optional[Clock] = None,
                 registry: Optional[MetricsRegistry] = None,
                 step_s: float = 1.0, max_points: int = 8192,
                 max_annotations: int = 4096) -> None:
        self.clock: Clock = clock if clock is not None else SystemClock()
        self.registry = registry if registry is not None else REGISTRY
        self.step_s = float(step_s)
        self.max_points = int(max_points)
        self.max_annotations = int(max_annotations)
        self.enabled = True
        self._lock = threading.Lock()
        self._rows: Dict[int, Dict] = {}      # bucket -> {col: val, ...}
        # two rings, NOT one: a storm of volatile annotations (executor
        # invalidations arrive per-invalidate) must never evict the
        # canonical stream — shared-FIFO eviction would make WHICH
        # deterministic annotations survive depend on thread timing
        self._ann_canon: List[Dict] = []
        self._ann_vol: List[Dict] = []
        self._seq = 0                         # write sequence (deltas)
        self._base: Dict[str, float] = {}     # cum-counter rebase point
        self.stats = {"samples": 0, "sample_s": 0.0, "annotations": 0,
                      "point_evictions": 0, "annotation_evictions": 0,
                      "volatile_evictions": 0,
                      "merges": 0, "merged_points": 0,
                      "merged_annotations": 0}

    # ----------------------------------------------------------- binding

    def set_clock(self, clock: Clock) -> None:
        self.clock = clock

    def reset(self) -> None:
        """Drop all history and capture the current registry counters
        as the rebase point: subsequent cum columns are run-relative,
        which is what makes same-seed soak dumps byte-identical even
        though the process registry is never reset."""
        with self._lock:
            self._rows.clear()
            self._ann_canon.clear()
            self._ann_vol.clear()
            self._seq = 0
            for k in self.stats:
                self.stats[k] = 0 if k != "sample_s" else 0.0
            self._base = self._read_counters()

    # ---------------------------------------------------------- sampling

    def _read_counters(self) -> Dict[str, float]:
        r = self.registry
        return {
            "acked": r.counter("nomad.broker.acked"),
            "heartbeat_missed": r.counter("nomad.heartbeat.missed"),
            "plans": r.counter("nomad.plan.plans"),
            "plans_refuted": r.counter("nomad.plan.plans_refuted"),
            "invalidations":
                r.counter_sum("nomad.executor.invalidations"),
            "uploads": r.counter("nomad.executor.uploads"),
            "upload_bytes": r.counter("nomad.executor.upload_bytes"),
        }

    def _read_gauges(self) -> Dict[str, Optional[float]]:
        r = self.registry
        ws = r.window_summary("nomad.plan.queue_wait_s")
        p99 = (round(ws["p99"] * 1000, 6)
               if ws and ws["count"] else None)
        out: Dict[str, Optional[float]] = {
            "plan_queue_p99_ms": p99,
            "nodes_in_use": r.gauge("nomad.quality.nodes_in_use"),
            "zone_balance_max_over_min":
                r.gauge("nomad.quality.zone_balance_max_over_min"),
            "binpack_fill_cpu":
                r.gauge("nomad.quality.binpack_fill", dimension="cpu"),
        }
        # wall plane: the host sampler reads the real clock (see
        # core/profiling.py) — never part of the canonical dump
        try:
            from nomad_tpu_torch.core.profiling import PROFILER
            out["gil_wait_fraction"] = round(
                PROFILER.gil_fraction("worker"), 6)
        except Exception:  # noqa: BLE001  (sampler absent/stopped)
            out["gil_wait_fraction"] = None
        return out

    def sample(self, now: Optional[float] = None,
               settled: bool = False) -> None:
        """Record one row into the clock-aligned bucket.  `settled=True`
        (the soak's post-quiesce sample) wins over any mid-step sample
        of the same bucket and cannot be displaced by one."""
        if not self.enabled:
            return
        t0 = _time.perf_counter()
        t = now if now is not None else self.clock.monotonic()
        bucket = int(t // self.step_s)
        with self._lock:
            prev = self._rows.get(bucket)
            if prev is not None and prev.get("_settled") \
                    and not settled:
                # bucket already settled: skip before paying for the
                # registry reads (the common case under virtual-time
                # compression, where many ticks land in one bucket)
                self.stats["samples"] += 1
                self.stats["sample_s"] += _time.perf_counter() - t0
                return
        cum = self._read_counters()
        gauges = self._read_gauges()
        base = self._base
        row: Dict = {c: round(cum[c] - base.get(c, 0.0), 9)
                     for c in _CUM_COLS}
        for c in _GAUGE_COLS:
            row[c] = gauges[c]
        row["_settled"] = bool(settled)
        with self._lock:
            prev = self._rows.get(bucket)
            if prev is not None and prev.get("_settled") \
                    and not settled:
                self.stats["samples"] += 1
                self.stats["sample_s"] += _time.perf_counter() - t0
                return
            self._seq += 1
            row["_seq"] = self._seq
            self._rows[bucket] = row
            while len(self._rows) > self.max_points:
                self._rows.pop(min(self._rows))
                self.stats["point_evictions"] += 1
            self.stats["samples"] += 1
            self.stats["sample_s"] += _time.perf_counter() - t0

    # ------------------------------------------------------- annotations

    def annotate(self, kind: str, now: Optional[float] = None,
                 origin: str = "", **fields) -> Dict:
        """Append one annotation to the stream.  Fields must be
        JSON-able; stamps ride the injected clock."""
        t = now if now is not None else self.clock.monotonic()
        ann = {"T": round(t, 9), "Kind": kind}
        if origin:
            ann["Origin"] = origin
        for k in sorted(fields):
            ann[k] = fields[k]
        volatile = kind in VOLATILE_KINDS or bool(origin)
        ring = self._ann_vol if volatile else self._ann_canon
        evict_key = ("volatile_evictions" if volatile
                     else "annotation_evictions")
        with self._lock:
            if not self.enabled:
                return ann
            self._seq += 1
            ann["_seq"] = self._seq
            ring.append(ann)
            while len(ring) > self.max_annotations:
                ring.pop(0)
                self.stats[evict_key] += 1
            self.stats["annotations"] += 1
        return ann

    @staticmethod
    def _pub(ann: Dict) -> Dict:
        return {k: v for k, v in ann.items() if not k.startswith("_")}

    # ----------------------------------------------------------- derived

    @staticmethod
    def _derive(series: str, row: Dict, prev_row: Optional[Dict],
                dt: Optional[float]) -> Optional[float]:
        """One derived value for `series` at one native bucket.  Rates
        and per-step deltas need the previous bucket; the first bucket
        of a series reads None (unknowable, never fabricated as 0)."""
        def rate(col):
            if prev_row is None or dt is None or dt <= 0:
                return None
            return round((row[col] - prev_row[col]) / dt, 9)

        def delta(col):
            if prev_row is None:
                return None
            return round(row[col] - prev_row[col], 9)

        if series == "evals_per_s":
            return rate("acked")
        if series == "heartbeat_misses":
            return delta("heartbeat_missed")
        if series == "refute_rate":
            d = delta("plans")
            if not d:
                return None
            return round((row["plans_refuted"]
                          - prev_row["plans_refuted"]) / d, 9)
        if series == "invalidations_per_s":
            return rate("invalidations")
        if series == "uploads_per_s":
            return rate("uploads")
        if series == "upload_mb_per_s":
            v = rate("upload_bytes")
            return None if v is None else round(v / 1e6, 9)
        # gauge passthrough (canonical gauges + gil-wait)
        return row.get(series)

    def _native(self, names: Iterable[str], settled_only: bool = False
                ) -> Tuple[List[int], Dict[str, List[Optional[float]]]]:
        """Derived values at native bucket resolution, plus any merged
        remote columns (`col@origin`) requested verbatim.
        `settled_only` keeps just the post-quiesce rows — the async
        tick thread's mid-step samples carry whatever the counters
        read at that wall moment, so the canonical dump must never see
        them (rates then derive settled-to-settled)."""
        with self._lock:
            buckets = sorted(b for b, r in self._rows.items()
                             if r.get("_settled") or not settled_only)
            rows = [self._rows[b] for b in buckets]
        cols: Dict[str, List[Optional[float]]] = {}
        for name in names:
            vals: List[Optional[float]] = []
            if "@" in name:                 # merged remote raw column
                for row in rows:
                    vals.append(row.get(name))
            else:
                prev_b = prev_row = None
                for b, row in zip(buckets, rows):
                    dt = ((b - prev_b) * self.step_s
                          if prev_b is not None else None)
                    vals.append(self._derive(name, row, prev_row, dt))
                    prev_b, prev_row = b, row
            cols[name] = vals
        return buckets, cols

    # ------------------------------------------------------------- query

    def query(self, start: Optional[float] = None,
              end: Optional[float] = None,
              step: Optional[float] = None,
              series: Optional[Iterable[str]] = None) -> Dict:
        """Range aggregation: min/max/avg/last/count per query step,
        annotations interleaved.  This is `GET /v1/operator/timeline`'s
        body."""
        names = list(series) if series else list(ALL_SERIES)
        for n in names:
            if n not in ALL_SERIES and "@" not in n:
                raise ValueError(
                    f"unknown timeline series {n!r} "
                    f"(expected one of {sorted(ALL_SERIES)})")
        qstep = self.step_s if step is None else float(step)
        if qstep <= 0:
            raise ValueError("step must be > 0")
        buckets, cols = self._native(names)
        # default bounds cover annotations stamped OUTSIDE any sampled
        # bucket: leadership.established fires before the first tick
        # ever samples a row, and must not vanish from a default query
        with self._lock:
            ann_ts = ([a["T"] for ring in (self._ann_canon,
                                           self._ann_vol)
                       for a in ring]
                      if (start is None or end is None) else [])
        if start is not None:
            lo = float(start)
        else:
            cands = [buckets[0] * self.step_s] if buckets else []
            cands += [min(ann_ts)] if ann_ts else []
            lo = min(cands) if cands else 0.0
        if end is not None:
            hi = float(end)
        else:
            cands = [(buckets[-1] + 1) * self.step_s] if buckets else []
            cands += [max(ann_ts) + self.step_s] if ann_ts else []
            hi = max(cands) if cands else 0.0
        if hi < lo:
            raise ValueError("end must be >= start")
        out_series: Dict[str, List[Dict]] = {n: [] for n in names}
        for name in names:
            agg: Dict[int, List[float]] = {}
            order: List[int] = []
            for b, v in zip(buckets, cols[name]):
                t = b * self.step_s
                if v is None or t < lo or t >= hi:
                    continue
                q = int(t // qstep)
                if q not in agg:
                    agg[q] = []
                    order.append(q)
                agg[q].append(v)
            for q in order:
                vs = agg[q]
                out_series[name].append({
                    "T": round(q * qstep, 9),
                    "Min": round(min(vs), 9),
                    "Max": round(max(vs), 9),
                    "Avg": round(sum(vs) / len(vs), 9),
                    "Last": round(vs[-1], 9),
                    "Count": len(vs)})
        with self._lock:
            anns = [self._pub(a)
                    for ring in (self._ann_canon, self._ann_vol)
                    for a in ring if lo <= a["T"] < hi]
        anns.sort(key=lambda a: (a["T"], a["Kind"]))
        return {"Schema": SCHEMA, "Start": round(lo, 9),
                "End": round(hi, 9), "Step": qstep,
                "Series": out_series, "Annotations": anns,
                "Points": len(buckets), "Stats": self.snapshot_stats()}

    def slice(self, start: float, end: float) -> Dict:
        """Raw window for embedding into dump bundles (health breach
        dumps carry the surrounding slice): every derived series at
        native resolution plus the annotations in range."""
        q = self.query(start=start, end=end, step=self.step_s,
                       series=ALL_SERIES)
        return {"Schema": SCHEMA, "Start": q["Start"], "End": q["End"],
                "Series": {n: [{"T": p["T"], "V": p["Last"]}
                               for p in pts]
                           for n, pts in q["Series"].items()},
                "Annotations": q["Annotations"]}

    def window(self) -> Optional[List[float]]:
        """[start, end] covered by retained history (None when empty) —
        profiling captures and flight dumps stamp this for
        cross-linking from `nomad report`."""
        with self._lock:
            if not self._rows:
                return None
            buckets = sorted(self._rows)
        return [round(buckets[0] * self.step_s, 9),
                round((buckets[-1] + 1) * self.step_s, 9)]

    def snapshot_stats(self) -> Dict:
        with self._lock:
            st = dict(self.stats)
        st["sample_s"] = round(st["sample_s"], 6)
        st["points"] = len(self._rows)
        return st

    def mem_stats(self) -> Dict:
        """Ledger sizer (core/memledger): row/annotation occupancy with
        a sampled byte estimate — one recent row + one annotation per
        ring are deep-sized per call, never the whole history."""
        from nomad_tpu_torch.core.memledger import approx_sizeof
        with self._lock:
            points = len(self._rows)
            ann = len(self._ann_canon) + len(self._ann_vol)
            evictions = (self.stats["point_evictions"]
                         + self.stats["annotation_evictions"]
                         + self.stats["volatile_evictions"])
            row = self._rows[max(self._rows)] if self._rows else None
            anns = [ring[-1] for ring in (self._ann_canon, self._ann_vol)
                    if ring]
        per_row = approx_sizeof(row, depth=2) if row is not None else 0
        per_ann = (sum(approx_sizeof(a, depth=2) for a in anns)
                   / len(anns)) if anns else 128.0
        return {"bytes": int(per_row * points + per_ann * ann),
                "entries": points + ann,
                "cap": self.max_points + 2 * self.max_annotations,
                "evictions": evictions,
                "points": points, "annotations": ann}

    # -------------------------------------------------- canonical dump

    def canonical_dump(self) -> Dict:
        """The determinism-safe dump: canonical series only, volatile
        annotation kinds excluded, annotations sorted by (T, Kind).
        Same seed, same bytes — `json.dumps(..., sort_keys=True)` of
        this doc is what the soak digests next to its trace."""
        buckets, cols = self._native(list(CANONICAL_SERIES),
                                     settled_only=True)
        with self._lock:
            anns = [self._pub(a) for a in self._ann_canon]
        anns.sort(key=lambda a: (a["T"], a["Kind"],
                                 json.dumps(a, sort_keys=True)))
        return {"Schema": SCHEMA, "StepS": self.step_s,
                "Buckets": buckets,
                "Series": {n: cols[n] for n in CANONICAL_SERIES},
                "Annotations": anns}

    def canonical_digest(self) -> str:
        import hashlib
        raw = json.dumps(self.canonical_dump(), sort_keys=True,
                         separators=(",", ":")).encode()
        return hashlib.sha256(raw).hexdigest()

    # --------------------------------------------- multi-process deltas

    def export_delta(self, since_seq: int = 0) -> Dict:
        """Everything written after `since_seq`, for shipping to a
        parent process over the worker-pool RPC channel."""
        with self._lock:
            samples = [[b, {k: v for k, v in row.items()
                            if k != "_seq" and k != "_settled"}]
                       for b, row in sorted(self._rows.items())
                       if row["_seq"] > since_seq]
            anns = [self._pub(a)
                    for ring in (self._ann_canon, self._ann_vol)
                    for a in ring if a["_seq"] > since_seq]
            seq = self._seq
        return {"Seq": seq, "StepS": self.step_s,
                "Samples": samples, "Annotations": anns}

    def merge_delta(self, delta: Dict, origin: str) -> None:
        """Fold a child's delta in: its annotations join the stream
        tagged with `origin`; its raw columns land in the same buckets
        under `col@origin` names (queryable verbatim)."""
        step = float(delta.get("StepS", self.step_s))
        with self._lock:
            if not self.enabled:
                return
            for b, row in delta.get("Samples", ()):
                # re-bucket onto OUR step so merged columns align
                bucket = int((int(b) * step) // self.step_s)
                dst = self._rows.get(bucket)
                if dst is None:
                    self._seq += 1
                    dst = {"_seq": self._seq, "_settled": False}
                    self._rows[bucket] = dst
                for col, val in row.items():
                    if col.startswith("_"):
                        continue
                    dst[f"{col}@{origin}"] = val
                self.stats["merged_points"] += 1
            while len(self._rows) > self.max_points:
                self._rows.pop(min(self._rows))
                self.stats["point_evictions"] += 1
            self.stats["merges"] += 1
        for a in delta.get("Annotations", ()):
            a = dict(a)
            t, kind = a.pop("T"), a.pop("Kind")
            a.pop("Origin", None)
            self.annotate(kind, now=t, origin=origin, **a)
            with self._lock:
                self.stats["merged_annotations"] += 1


# -------------------------------------------------------------- report

# which annotation kinds plausibly CAUSE a breach of each SLO rule /
# a spike of each series — used to rank attribution candidates ahead
# of merely-nearby annotations (keys cover both rule and series names)
_RULE_AFFINITY: Dict[str, Tuple[str, ...]] = {
    "heartbeat_misses": ("traffic.node.", "chaos.", "drain."),
    "p99_plan_queue_ms": ("traffic.job.", "traffic.chaos", "chaos."),
    "plan_queue_p99_ms": ("traffic.job.", "traffic.chaos", "chaos."),
    "refute_rate": ("traffic.job.", "pool.", "chaos."),
    "invalidations_per_s": ("executor.", "pool.", "chaos."),
    "evals_per_s": ("traffic.job.", "chaos.",),
    "nodes_in_use": ("traffic.node.", "drain.", "chaos."),
}


def build_report(dump: Dict, attribution_window_s: float = 60.0,
                 spike_factor: float = 3.0) -> Dict:
    """Post-soak retrospective over a `query()` doc (or live timeline):
    every HealthWatchdog breach annotation and every latency/ rate
    spike gets attributed to its nearest-in-time cluster annotations.
    Pure function of the dump — `nomad report` runs it client-side."""
    series: Dict[str, List[Dict]] = dump.get("Series", {})
    anns: List[Dict] = list(dump.get("Annotations", []))
    causes = [a for a in anns
              if not a["Kind"].startswith("health.")]

    def attribute(t: float, prefer: Tuple[str, ...] = ()) -> List[Dict]:
        near = [a for a in causes
                if abs(a["T"] - t) <= attribution_window_s]
        # nearest-in-time, but kinds mechanistically related to the
        # rule outrank unrelated-but-closer noise: a heartbeat breach
        # fires one TTL AFTER the flap that caused it, by which time a
        # routine job-scale event is usually nearer on the clock
        near.sort(key=lambda a: (
            0 if prefer and a["Kind"].startswith(prefer) else 1,
            abs(a["T"] - t), a["Kind"]))
        return [{"T": a["T"], "Kind": a["Kind"],
                 "DtS": round(a["T"] - t, 9),
                 "Fields": {k: v for k, v in a.items()
                            if k not in ("T", "Kind")}}
                for a in near[:3]]

    incidents: List[Dict] = []
    for a in anns:
        if a["Kind"] != "health.breach":
            continue
        incidents.append({
            "T": a["T"], "Kind": "breach",
            "Rule": a.get("rule"), "Observed": a.get("observed"),
            "Threshold": a.get("threshold"),
            "Attribution": attribute(
                a["T"], _RULE_AFFINITY.get(a.get("rule"), ()))})
    # spike pass: a point whose value exceeds spike_factor x the
    # series median (and a small absolute floor) is an incident too
    for name, pts in sorted(series.items()):
        vals = sorted(p["Avg"] for p in pts)
        if len(vals) < 8:
            continue
        med = vals[len(vals) // 2]
        if med <= 0:
            # no meaningful baseline (series idle most of the window):
            # any activity would read as an infinite-ratio "spike" and
            # drown the real incidents
            continue
        floor = med * spike_factor
        spikes = [p for p in pts if p["Max"] > floor and p["Max"] > 0]
        for p in spikes[:5]:
            incidents.append({
                "T": p["T"], "Kind": "spike", "Series": name,
                "Observed": p["Max"],
                "Baseline": round(med, 9),
                "Attribution": attribute(
                    p["T"], _RULE_AFFINITY.get(name, ()))})
    incidents.sort(key=lambda i: (i["T"], i["Kind"]))
    summary = {name: {
        "Min": round(min(p["Min"] for p in pts), 9),
        "Max": round(max(p["Max"] for p in pts), 9),
        "Avg": round(sum(p["Avg"] for p in pts) / len(pts), 9),
        "Last": pts[-1]["Last"]}
        for name, pts in sorted(series.items()) if pts}
    kinds: Dict[str, int] = {}
    for a in anns:
        kinds[a["Kind"]] = kinds.get(a["Kind"], 0) + 1
    return {"Schema": REPORT_SCHEMA,
            "Window": [dump.get("Start"), dump.get("End")],
            "Points": dump.get("Points",
                               max((len(p) for p in series.values()),
                                   default=0)),
            "Annotations": len(anns),
            "AnnotationKinds": dict(sorted(kinds.items())),
            "Incidents": incidents,
            "Series": summary}


_SPARK = "▁▂▃▄▅▆▇█"


def sparkline(values: List[Optional[float]], width: int = 32) -> str:
    """Render a series as a fixed-width unicode sparkline (CLI)."""
    vs = [v for v in values if v is not None]
    if not vs:
        return "·" * min(width, 1)
    if len(values) > width:                    # downsample by mean
        out: List[Optional[float]] = []
        n = len(values)
        for i in range(width):
            chunk = [v for v in values[i * n // width:
                                       (i + 1) * n // width]
                     if v is not None]
            out.append(sum(chunk) / len(chunk) if chunk else None)
        values = out
    lo, hi = min(vs), max(vs)
    span = hi - lo
    chars = []
    for v in values:
        if v is None:
            chars.append("·")
        elif span <= 0:
            chars.append(_SPARK[0])
        else:
            idx = int((v - lo) / span * (len(_SPARK) - 1))
            chars.append(_SPARK[idx])
    return "".join(chars)


def render_report_md(report: Dict) -> str:
    """The Markdown face of `nomad report`."""
    lines = ["# Timeline retrospective", ""]
    w = report.get("Window") or [None, None]
    lines.append(f"- window: [{w[0]}, {w[1]}] "
                 f"({report.get('Points', 0)} points, "
                 f"{report.get('Annotations', 0)} annotations)")
    kinds = report.get("AnnotationKinds", {})
    if kinds:
        lines.append("- annotations: "
                     + ", ".join(f"{k}×{n}" for k, n in kinds.items()))
    lines.append("")
    incidents = report.get("Incidents", [])
    lines.append(f"## Incidents ({len(incidents)})")
    lines.append("")
    if not incidents:
        lines.append("No breaches or spikes in the window.")
    for inc in incidents:
        what = (f"rule `{inc.get('Rule')}`" if inc["Kind"] == "breach"
                else f"series `{inc.get('Series')}`")
        lines.append(f"- **t={inc['T']}** {inc['Kind']} on {what} "
                     f"(observed {inc.get('Observed')})")
        attr = inc.get("Attribution", [])
        if not attr:
            lines.append("  - no annotation within the window "
                         "(unattributed)")
        for a in attr:
            fields = ", ".join(f"{k}={v}" for k, v in
                               sorted(a.get("Fields", {}).items()))
            lines.append(f"  - `{a['Kind']}` at t={a['T']} "
                         f"(dt={a['DtS']:+.1f}s)"
                         + (f" — {fields}" if fields else ""))
    lines.append("")
    lines.append("## Series")
    lines.append("")
    for name, s in report.get("Series", {}).items():
        lines.append(f"- `{name}`: min {s['Min']} avg {s['Avg']} "
                     f"max {s['Max']} last {s['Last']}")
    return "\n".join(lines) + "\n"


# --------------------------------------------------------------- globals

TIMELINE = Timeline()


def configure(clock: Clock) -> None:
    """Bind the process timeline to an injected clock (every Server
    calls this with its own, next to telemetry/flightrec.configure)."""
    TIMELINE.set_clock(clock)


from nomad_tpu_torch.core.obsbus import OBSBUS  # noqa: E402 - after globals

OBSBUS.register("timeline", configure=TIMELINE.set_clock,
                snapshot=TIMELINE.snapshot_stats, reset=TIMELINE.reset)
