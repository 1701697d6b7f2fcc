"""Virtual-time production soak: replay a day of cluster life in
seconds, gated on live SLOs.

The runner boots a REAL agent (server + HTTP API, in-process) on a
`VirtualClock`, then drives the seeded traffic schedule from
chaos/traffic.py through the public API exactly as production traffic
would arrive — `PUT /v1/jobs`, `PUT /v1/job/:id/scale`, node drains,
heartbeats from a synthetic client fleet, client alloc-status pushes —
never by poking the state store.  Virtual time advances only between
steps, and only once the scheduler plane is quiescent, so hours of
cluster life (heartbeat TTLs, deployment progress deadlines, nack
penalties, follow-up delays) compress into wall seconds without the
thread-handoff jitter of real time leaking into latency windows.

Pass/fail is asserted on BOTH planes:

  - chaos invariants over the converged store (alloc coherence, node
    capacity, port uniqueness, terminal evals, stopped jobs empty,
    every surviving demand placed);
  - the live health plane: zero unexpected HealthWatchdog breaches,
    the rolling-window p99 plan-queue latency under its SLO, and the
    scheduling-quality gauges (zone balance, bin-pack fill) in bounds.

Determinism: the canonical trace (expanded schedule + chaos-scenario
digests + SLO verdict + converged-state fingerprint) is byte-identical
for the same seed — `same seed, same bytes` is the replay test.  The
fingerprint is deliberately COARSER than chaos.trace.state_fingerprint:
per-(job, group) live counts rather than per-node, because which node
a reschedule lands on depends on thread timing while how many replicas
converge does not.

A copy of the reference's nomad_tpu/chaos/soak.py with its imports
rewritten.  One difference: `SoakRunner(..., device=None)` and
`run_soak(..., device=None)` take the device of the port's `Agent`,
and the interleaved chaos scenarios get the same device
(`run_scenario(..., device=...)`) for every `ClusterServer` they boot.
It is CUDA unless given, and raises without CUDA; tests pass
`device="cpu"`.  Nothing else differs: the schedule, the canonical
trace, the fingerprints and the summary's keys are the reference's.
"""

from __future__ import annotations

import hashlib
import json
from typing import Dict, List, Optional

from nomad_tpu_torch.chaos.clock import SystemClock, VirtualClock
from nomad_tpu_torch.chaos.invariants import alloc_coherence
from nomad_tpu_torch.chaos.trace import Trace, _canon
from nomad_tpu_torch.chaos.traffic import (
    TrafficProfile,
    fleet,
    generate_schedule,
    retry_idempotent,
)

# host-side wall pacing (progress deadlines, yield-to-clock-waiters):
# deliberately NOT the injected soak clock — the soak drives a
# VirtualClock for cluster time while these calls meter real host time
_wall = SystemClock()


def _landed(probe) -> bool:
    """verify() adapter for retry_idempotent: a 404 from the probe
    means the effect is NOT visible, not that the probe failed."""
    try:
        return bool(probe())
    except Exception:
        return False

# deterministic wall anchor for VirtualClock.time(): epoch-based
# bookkeeping (identity TTLs, heartbeat deadlines) must not differ
# between two runs of the same seed
_EPOCH = 1_700_000_000.0

# soak SLO: defaults except the networked-ratio floor (the soak's mock
# jobs reserve no ports, so the rule would read None anyway; -1 states
# the intent) and a heartbeat-miss ceiling sized to the flap storms the
# schedule itself injects — a breach then means UNEXPECTED misses
SOAK_SLO = {
    "networked_ratio": -1.0,
    "heartbeat_misses": 64.0,
    "interval_s": 5.0,
}

_MAX_ZONE_IMBALANCE = 4.0     # max/min live allocs across datacenters


def coarse_fingerprint(snap) -> str:
    """Converged-state digest at (job, group) granularity: node
    name/status/eligibility, jobs (id, stopped, type), live alloc
    counts per (job, group).  Excludes ids, timestamps, and per-node
    placement — everything two faithful replays may legitimately
    differ on."""
    nodes = sorted((n.name, n.status, n.scheduling_eligibility)
                   for n in snap.nodes())
    jobs = sorted((j.id, bool(j.stop), j.type) for j in snap.jobs())
    live: Dict[tuple, int] = {}
    for j in snap.jobs():
        for a in snap.allocs_by_job(j.namespace, j.id):
            if a.terminal_status():
                continue
            key = (a.job_id, a.task_group)
            live[key] = live.get(key, 0) + 1
    doc = {"nodes": nodes, "jobs": jobs,
           "live": sorted((list(k), v) for k, v in live.items())}
    blob = json.dumps(_canon(doc), sort_keys=True,
                      separators=(",", ":")).encode()
    return hashlib.sha256(blob).hexdigest()


class SoakResult:
    def __init__(self, ok: bool, violations: List[str], trace: Trace,
                 fingerprint: str, summary: Dict,
                 timeline: Optional[Dict] = None,
                 timeline_canonical: Optional[Dict] = None,
                 report: Optional[Dict] = None) -> None:
        self.ok = ok
        self.violations = violations
        self.trace = trace
        self.fingerprint = fingerprint
        self.summary = summary
        # retrospective timeline plane (core/timeline.py): the full
        # query doc, the determinism-safe canonical dump, and the
        # breach/spike post-mortem — cmd_soak/bench write these next
        # to the trace
        self.timeline = timeline
        self.timeline_canonical = timeline_canonical
        self.report = report

    @property
    def digest(self) -> str:
        return self.trace.digest()


class SoakRunner:
    """One seeded soak run.  `run()` is synchronous and owns the whole
    agent lifecycle; wall cost is dominated by the scheduler work the
    schedule generates, not by the virtual horizon."""

    def __init__(self, seed: int = 0,
                 profile: Optional[TrafficProfile] = None,
                 step_v: float = 2.0,
                 hb_interval: float = 10.0,
                 sweep_interval: float = 8.0,
                 heartbeat_ttl: float = 30.0,
                 converge_budget_v: float = 900.0,
                 slo: Optional[Dict[str, float]] = None,
                 rss_ceiling_mb: float = -1.0,
                 device=None) -> None:
        self.seed = seed
        self.device = device
        self.profile = profile or TrafficProfile()
        self.step_v = step_v
        self.hb_interval = hb_interval
        self.sweep_interval = sweep_interval
        self.heartbeat_ttl = heartbeat_ttl
        self.converge_budget_v = converge_budget_v
        # RSS gate (core/memledger): fail the soak when the process
        # high-water mark crosses this many MiB; < 0 disables.  A wall
        # fact, so it gates the verdict but stays out of the canonical
        # trace/digests (same-seed runs on different hosts still match)
        self.rss_ceiling_mb = float(rss_ceiling_mb)
        self.slo = dict(SOAK_SLO)
        self.slo.update(slo or {})
        # runtime state
        self.schedule = generate_schedule(seed, self.profile)
        self.fleet = fleet(seed, self.profile)
        self.trace = Trace()
        self.violations: List[str] = []
        self._node_id = {s["name"]: s["id"] for s in self.fleet}
        self._flap_until: Dict[str, float] = {}   # node id -> vt
        self._jobs: Dict[str, Dict] = {}          # job id -> facts
        self._chaos_ok = True

    # ------------------------------------------------------------ build

    def _build_job(self, e: Dict):
        """Schedule event -> Job struct (mock factories keep the task
        shapes realistic; the soak overrides identity + size)."""
        from nomad_tpu_torch import mock
        from nomad_tpu_torch.structs import ReschedulePolicy
        p = self.profile
        dcs = [f"dc{z + 1}" for z in range(p.n_zones)]
        jtype = e["jtype"]
        if jtype == "service":
            job = mock.job()
        elif jtype == "batch":
            job = mock.batch_job()
        else:
            job = mock.system_job()
        job.id = e["job"]
        job.name = e["job"]
        job.priority = e["priority"]
        job.datacenters = dcs
        tg = job.task_groups[0]
        if jtype != "system":
            tg.count = e["count"]
        tg.tasks[0].resources.cpu = e["cpu"]
        tg.tasks[0].resources.memory_mb = e["mem"]
        if jtype == "service":
            # flap storms may lose the same job's allocs repeatedly; a
            # bounded reschedule budget would strand the job below its
            # desired count and make convergence timing-dependent
            tg.reschedule_policy = ReschedulePolicy(
                unlimited=True, delay_s=5.0, delay_function="constant")
        if e.get("ports"):
            # networked fleet (TrafficProfile.networked_fraction): the
            # allocs ride the columnar port-assignment path end to end
            from nomad_tpu_torch.structs import NetworkResource, Port
            tg.tasks[0].resources.networks = [NetworkResource(
                dynamic_ports=[Port(label=f"p{k}")
                               for k in range(int(e["ports"]))])]
        if e.get("node_class"):
            from nomad_tpu_torch.structs import Constraint
            job.constraints = list(job.constraints or []) + [Constraint(
                ltarget="${node.class}", operand="=",
                rtarget=e["node_class"])]
        if "rev" in e:
            job.meta = {"rev": str(e["rev"])}
        return job, tg.name

    # ----------------------------------------------------------- events

    def _apply_event(self, c, e: Dict, now: float) -> None:
        from nomad_tpu_torch.core.timeline import TIMELINE
        from nomad_tpu_torch.structs import codec
        kind = e["kind"]
        # every traffic event lands in the annotation stream at its
        # SCHEDULED virtual time (deterministic; `nomad report`
        # attributes breaches/spikes to these)
        TIMELINE.annotate(
            f"traffic.{kind}", now=e["at"],
            **{k: e[k] for k in ("job", "node", "count", "rev",
                                 "duration", "scenario", "jtype")
               if k in e})
        if kind == "job.register":
            job, group = self._build_job(e)
            wire_job = codec.encode(job)
            retry_idempotent(
                lambda: c.jobs.register(wire_job),
                lambda: _landed(lambda: c.jobs.info(job.id)))
            info = self._jobs.setdefault(
                e["job"], {"group": group, "jtype": e["jtype"],
                           "count": e.get("count", 1), "stopped": False,
                           "cpu": e["cpu"], "mem": e["mem"],
                           "priority": e["priority"]})
            info["count"] = e.get("count", 1)
            info["stopped"] = False
            if "runtime_s" in e:
                info["done_at"] = e["at"] + e["runtime_s"]
        elif kind == "job.deploy":
            info = self._jobs.get(e["job"])
            if info is None or info["stopped"]:
                return
            job, _ = self._build_job(
                {"job": e["job"], "jtype": info["jtype"],
                 "count": info["count"], "cpu": info["cpu"],
                 "mem": info["mem"], "priority": info["priority"],
                 "rev": e["rev"]})
            c.jobs.register(codec.encode(job))
        elif kind == "job.scale":
            info = self._jobs.get(e["job"])
            if info is None or info["stopped"]:
                return
            c.jobs.scale(e["job"], info["group"], e["count"])
            info["count"] = e["count"]
        elif kind == "job.stop":
            info = self._jobs.get(e["job"])
            if info is None:
                return
            jid = e["job"]
            retry_idempotent(
                lambda: c.jobs.deregister(jid),
                lambda: _landed(
                    lambda: (c.jobs.info(jid) or {}).get("Stop")))
            info["stopped"] = True
        elif kind == "node.drain":
            c.nodes.drain(self._node_id[e["node"]],
                          deadline_s=e["duration"])
        elif kind == "node.restore":
            c.nodes.eligibility(self._node_id[e["node"]], True)
        elif kind == "node.flap":
            nid = self._node_id[e["node"]]
            self._flap_until[nid] = now + e["duration"]
        elif kind == "chaos":
            self._run_chaos(e)

    def _run_chaos(self, e: Dict) -> None:
        """Interleave a named chaos scenario (its own cluster, its own
        VirtualClock), then re-bind the process-global observability
        planes to the soak's clock and absorb the scenario's counter
        activity so it cannot fabricate a watchdog breach."""
        from nomad_tpu_torch.chaos.scenarios import run_scenario
        from nomad_tpu_torch.core.timeline import TIMELINE
        TIMELINE.annotate("chaos.begin", now=e["at"],
                          scenario=e["scenario"])
        # the scenario boots its own servers on its own VirtualClock;
        # their ticks must not write scenario-time rows into THIS
        # soak's history
        TIMELINE.enabled = False
        try:
            res = run_scenario(e["scenario"], seed=e["seed"],
                               device=self.device)
        finally:
            TIMELINE.enabled = True
            self._rebind_clock()
        self.agent.server.health.rebase()
        TIMELINE.annotate("chaos.end", now=e["at"],
                          scenario=e["scenario"], ok=bool(res.ok))
        self.trace.record(e["at"], "chaos_result",
                          scenario=e["scenario"], ok=bool(res.ok),
                          digest=res.trace.digest(),
                          fingerprint=res.fingerprint)
        if not res.ok:
            self._chaos_ok = False
            self.violations.extend(
                f"chaos {e['scenario']}: {v}"
                for v in (res.violations or ["did not converge"]))

    def _rebind_clock(self) -> None:
        # every plane at once through the ObsBus seam (core/obsbus.py):
        # a scenario that swapped in its own clock hands the soak clock
        # back to all eight planes in one call
        from nomad_tpu_torch.core.obsbus import OBSBUS
        OBSBUS.configure(self.clock)

    # -------------------------------------------------- synthetic fleet

    def _pump_heartbeats(self, c, now: float) -> None:
        for spec in self.fleet:
            nid = spec["id"]
            if self._flap_until.get(nid, 0.0) > now:
                continue              # flapping: withhold the keepalive
            c.nodes.heartbeat(nid)

    def _sweep_allocs(self, c, now: float) -> None:
        """The synthetic client fleet: confirm new placements as
        running+healthy, honor stop/evict decisions, and complete batch
        allocs once their job's virtual runtime elapsed — all through
        the client alloc-update API."""
        by_node: Dict[str, List[Dict]] = {}
        for w in c.allocations.list():
            done_at = self._jobs.get(w.get("JobID", ""),
                                     {}).get("done_at")
            cs, ds = w.get("ClientStatus"), w.get("DesiredStatus")
            if cs in ("complete", "failed", "lost"):
                continue
            if ds in ("stop", "evict"):
                w["ClientStatus"] = "complete"
            elif cs == "pending":
                w["ClientStatus"] = "running"
                w["DeploymentStatus"] = {"healthy": True, "ts": now}
            elif cs == "running" and done_at is not None \
                    and now >= done_at:
                w["ClientStatus"] = "complete"
            else:
                continue
            by_node.setdefault(w["NodeID"], []).append(w)
        for nid, updates in sorted(by_node.items()):
            c.nodes.update_allocs(nid, updates)

    # ------------------------------------------------------ convergence

    def _quiesce(self, budget_s: float = 5.0) -> None:
        """Let in-flight scheduling drain while virtual time is frozen:
        plan-queue waits then measure ~0 virtual seconds, which is what
        'latency' means when the clock only moves between steps."""
        s = self.agent.server
        b = s.eval_broker
        deadline = _wall.monotonic() + budget_s
        while _wall.monotonic() < deadline:
            with b._lock:
                # delayed evals are EXCLUDED: they promote only when
                # time advances, which is exactly what we're about to do
                busy = (any(b._ready.values())
                        or any(b._pending_by_job.values())
                        or bool(b._outstanding))
            if not busy and s.plan_queue.depth() == 0:
                return
            _wall.sleep(0.001)

    def _expected_live(self) -> Dict[str, int]:
        out = {}
        for jid, info in self._jobs.items():
            if info["stopped"]:
                out[jid] = 0
            elif info["jtype"] == "batch":
                out[jid] = 0          # completes by its virtual runtime
            elif info["jtype"] == "system":
                out[jid] = len(self.fleet)
            else:
                out[jid] = info["count"]
        return out

    def _converged(self, snap) -> List[str]:
        out = []
        live: Dict[str, int] = {}
        for j in snap.jobs():
            n = sum(1 for a in snap.allocs_by_job(j.namespace, j.id)
                    if not a.terminal_status())
            live[j.id] = n
        for jid, want in sorted(self._expected_live().items()):
            got = live.get(jid, 0)
            if got != want:
                out.append(f"job {jid}: {got} live allocs, want {want}")
        for n in snap.nodes():
            if n.status != "ready":
                out.append(f"node {n.name} is {n.status} at convergence")
            if n.scheduling_eligibility != "eligible":
                out.append(f"node {n.name} is {n.scheduling_eligibility}"
                           " at convergence")
        return out

    def _invariants(self, snap) -> List[str]:
        out = list(alloc_coherence(snap))
        nodes = {n.id: n for n in snap.nodes()}
        live_by_node: Dict[str, List] = {}
        for nid in nodes:
            for a in snap.allocs_by_node(nid):
                if not a.terminal_status():
                    live_by_node.setdefault(nid, []).append(a)
        for nid, allocs in live_by_node.items():
            n = nodes[nid]
            u_cpu = n.resources.cpu - n.reserved.cpu
            u_mem = n.resources.memory_mb - n.reserved.memory_mb
            cpu = sum(a.resources.cpu for a in allocs)
            mem = sum(a.resources.memory_mb for a in allocs)
            if cpu > u_cpu or mem > u_mem:
                out.append(f"node {n.name} over capacity: "
                           f"cpu {cpu}/{u_cpu} mem {mem}/{u_mem}")
            seen = set()
            for a in allocs:
                for port in (a.allocated_ports or {}).values():
                    if port in seen:
                        out.append(f"node {n.name} port {port} "
                                   "double-booked")
                    seen.add(port)
        for ev in snap.evals():
            if ev.status not in ("complete", "failed", "canceled",
                                 "blocked"):
                out.append(f"eval {ev.id[:8]} non-terminal: {ev.status}")
        return out

    def _health_gates(self) -> List[str]:
        out = []
        s = self.agent.server
        doc = s.health.check(self.clock.monotonic())
        breaches = s.health.stats["breaches"]
        if breaches:
            rules = sorted({b["Rule"] for d in s.health.dumps()
                            for b in d["Breaches"]})
            out.append(f"{breaches} unexpected HealthWatchdog "
                       f"breach(es): {rules}")
        ws = s.health.registry.window_summary("nomad.plan.queue_wait_s")
        p99_ms = round(ws["p99"] * 1000, 6) if ws and ws["count"] else 0.0
        limit = s.health.slo["p99_plan_queue_ms"]
        if limit >= 0 and p99_ms > limit:
            out.append(f"p99 plan-queue {p99_ms}ms > SLO {limit}ms")
        q = s.state.quality_summary()
        if q["nodes_in_use"] == 0:
            out.append("quality: no nodes in use at convergence")
        if (q["zone_allocs_min"] > 0
                and q["zone_balance_max_over_min"] > _MAX_ZONE_IMBALANCE):
            out.append("quality: zone imbalance "
                       f"{q['zone_balance_max_over_min']:.2f} > "
                       f"{_MAX_ZONE_IMBALANCE}")
        if not 0.0 < q["fill_cpu"] <= 1.0 + 1e-9:
            out.append(f"quality: cpu fill {q['fill_cpu']:.4f} "
                       "outside (0, 1]")
        # the SLO verdict is part of the canonical trace: rule -> ok
        self.trace.record(self.clock.monotonic(), "slo",
                          healthy=bool(doc["Healthy"]),
                          breaches=int(breaches),
                          rules=sorted((v["Rule"], bool(v["Ok"]))
                                       for v in doc["Rules"]))
        self._p99_ms = p99_ms
        self._quality = q
        return out

    # --------------------------------------------------------------- run

    def run(self) -> SoakResult:
        from nomad_tpu_torch.agent import Agent
        from nomad_tpu_torch.api.client import APIClient
        from nomad_tpu_torch.core import wire
        from nomad_tpu_torch.structs import (
            PreemptionConfig,
            SchedulerConfiguration,
            codec,
        )
        p = self.profile
        t_wall0 = _wall.monotonic()
        horizon = p.hours * 3600.0
        for e in self.schedule:   # the canonical schedule, up front
            self.trace.record(e["at"], e["kind"],
                              **{k: v for k, v in e.items()
                                 if k not in ("at", "kind")})
        from nomad_tpu_torch.core import telemetry as telemetry_mod
        from nomad_tpu_torch.core import timeline as timeline_mod
        self.clock = VirtualClock(epoch=_EPOCH)
        wire.set_clock(self.clock)
        # run-isolate the retrospective timeline: the registry is
        # process-global, so the rolling windows and quality gauges the
        # timeline samples would otherwise leak one run's residue into
        # the next and break same-seed byte-identity of the canonical
        # dump; counters need no clearing (the timeline rebases them
        # at reset())
        telemetry_mod.REGISTRY.clear_series("nomad.plan.queue_wait_s")
        telemetry_mod.REGISTRY.clear_series("nomad.quality.")
        timeline_mod.TIMELINE.reset()
        # ledger-cost baseline: MEMLEDGER is process-global, so the
        # overhead fraction must charge only THIS run's scrapes
        from nomad_tpu_torch.core.memledger import MEMLEDGER as _ml
        mem_total0 = _ml.stats()["scrape_total_s"]
        self.agent = Agent(client_enabled=False, num_workers=2,
                           heartbeat_ttl=self.heartbeat_ttl,
                           clock=self.clock, slo=self.slo,
                           device=self.device).start()
        try:
            c = APIClient(address=self.agent.address)
            # spread placement (zone balance is a live gate) +
            # preemption for every scheduler (the priority-inversion
            # storms must be able to actually preempt)
            c.operator.set_scheduler_config(codec.encode(
                SchedulerConfiguration(
                    scheduler_algorithm="spread",
                    preemption_config=PreemptionConfig(
                        system_scheduler_enabled=True,
                        batch_scheduler_enabled=True,
                        service_scheduler_enabled=True))))
            from nomad_tpu_torch import mock
            for spec in self.fleet:
                node = mock.node(id=spec["id"], name=spec["name"],
                                 datacenter=spec["datacenter"])
                node.resources.cpu = spec["cpu"]
                node.resources.memory_mb = spec["mem"]
                if spec.get("node_class"):
                    node.node_class = spec["node_class"]
                nw = codec.encode(node)
                retry_idempotent(
                    lambda nw=nw: c.nodes.register(nw),
                    lambda nid=spec["id"]: any(
                        n["ID"] == nid for n in c.nodes.list()))
            ei = 0
            next_hb = 0.0
            next_sweep = self.sweep_interval / 2
            deadline_v = horizon + self.converge_budget_v
            while True:
                now = self.clock.monotonic()
                while ei < len(self.schedule) \
                        and self.schedule[ei]["at"] <= now:
                    self._apply_event(c, self.schedule[ei], now)
                    ei += 1
                if now >= next_hb:
                    self._pump_heartbeats(c, now)
                    next_hb = now + self.hb_interval
                if now >= next_sweep:
                    self._sweep_allocs(c, now)
                    next_sweep = now + self.sweep_interval
                self._quiesce()
                # deterministic tick duties for this virtual instant
                # (heartbeat expiry, delayed-eval promotion, drains)
                # land BEFORE the settled timeline row: the threaded
                # tick loop races the step's work, this one is
                # serialized behind Server._tick_lock and runs against
                # the quiesced plane
                self.agent.server.tick()
                self._quiesce()
                # settled rows win the bucket: whatever mid-step values
                # the async tick sampled are replaced by this
                # post-quiesce row, which is a pure function of the
                # step's converged state — the byte-identity carrier
                timeline_mod.TIMELINE.sample(now, settled=True)
                if now >= horizon and ei >= len(self.schedule):
                    snap = self.agent.server.state.snapshot()
                    if not self._converged(snap) or now >= deadline_v:
                        break
                elif now >= deadline_v:
                    break
                dt = self.step_v
                if ei < len(self.schedule):
                    dt = min(dt, max(0.25,
                                     self.schedule[ei]["at"] - now))
                self.clock.advance(min(dt, max(0.25, deadline_v - now)))
                _wall.sleep(0.0005)   # let clock-waiters observe the step
            # ---- gates ----
            end_v = self.clock.monotonic()
            snap = self.agent.server.state.snapshot()
            self.violations += self._converged(snap)
            self.violations += self._invariants(snap)
            self.violations += self._health_gates()
            # ---- memory gates (core/memledger) ----
            # final fresh scrape so the summary carries end-of-run
            # footprint; all values are volatile wall facts — they gate
            # the verdict, never the canonical trace
            from nomad_tpu_torch.core.memledger import MEMLEDGER
            # overhead charges TICK sampling only (the 0.1% budget is
            # about the cadence riding Server.tick): snapshot the
            # metered total before the explicit end-of-run gate scrape,
            # whose cost is this verdict's to pay, not the soak's
            mem_sampling_s = (MEMLEDGER.stats()["scrape_total_s"]
                              - mem_total0)
            mem_doc = MEMLEDGER.scrape()
            jstats = self.agent.server.state.journal_stats()
            ring_evictions = sum(MEMLEDGER.evictions().values())
            if self.rss_ceiling_mb >= 0:
                peak_mb = mem_doc["RSSPeakBytes"] / (1024.0 * 1024.0)
                if peak_mb > self.rss_ceiling_mb:
                    self.violations.append(
                        f"rss peak {peak_mb:.1f} MiB exceeds ceiling "
                        f"{self.rss_ceiling_mb:g} MiB")
            fingerprint = coarse_fingerprint(snap)
            ok = not self.violations and self._chaos_ok
            self.trace.record(end_v, "verdict", ok=bool(ok),
                              violations=sorted(self.violations),
                              fingerprint=fingerprint)
            wall_s = _wall.monotonic() - t_wall0
            stats = self.agent.server.eval_broker.stats
            # retrospective artifacts, emitted next to the canonical
            # trace: the determinism-safe canonical dump (digested into
            # the summary), the full query doc, and the post-mortem
            # report attributing breaches/spikes to annotations
            tl = timeline_mod.TIMELINE
            tl_stats = tl.snapshot_stats()
            self.timeline = tl.query()
            self.timeline_canonical = tl.canonical_dump()
            self.report = timeline_mod.build_report(self.timeline)
            summary = {
                "seed": self.seed,
                "soak_virtual_hours": round(end_v / 3600.0, 4),
                "soak_evals": int(stats["enqueued"]),
                "soak_breaches":
                    int(self.agent.server.health.stats["breaches"]),
                "converged_fingerprint": fingerprint,
                "trace_digest": self.trace.digest(),
                "schedule_events": len(self.schedule),
                "wall_s": round(wall_s, 3),
                "compression_x":
                    round(end_v / wall_s, 1) if wall_s > 0 else 0.0,
                "p99_plan_queue_ms": self._p99_ms,
                "quality": {k: round(v, 6)
                            for k, v in self._quality.items()},
                "timeline_points": int(tl_stats["points"]),
                "timeline_annotations": int(tl_stats["annotations"]),
                # self-metered sample cost over the run's wall time
                # (perfcheck gates this at <= 0.02)
                "timeline_overhead_fraction":
                    round(tl_stats["sample_s"] / wall_s, 6)
                    if wall_s > 0 else 0.0,
                "timeline_evictions":
                    int(tl_stats["point_evictions"]
                        + tl_stats["annotation_evictions"]
                        + tl_stats["volatile_evictions"]),
                # sha256 of the canonical dump: the same-seed double-run
                # test compares these (and the full bytes)
                "timeline_digest": tl.canonical_digest(),
                # memory & footprint plane (core/memledger): volatile
                # wall facts — reported and gated (rss_ceiling_mb,
                # perfcheck --kind memory), excluded from determinism
                # comparison and the canonical digests above
                "rss_bytes": int(mem_doc["RSSBytes"]),
                "rss_peak_bytes": int(mem_doc["RSSPeakBytes"]),
                "journal_bytes": int(jstats["bytes"]),
                "journal_entries": int(jstats["entries"]),
                "journal_compactions": int(jstats["compactions"]),
                "journal_bytes_reclaimed":
                    int(jstats["bytes_reclaimed"]),
                "journal_floor_fallbacks":
                    int(jstats["floor_fallbacks"]),
                "ring_evictions": int(ring_evictions),
                "mem_scrape_us": float(mem_doc["ScrapeMeanMicros"]),
                # ledger cost over the run's wall time (perfcheck gates
                # this at <= 0.001 — the 0.1% soak-overhead budget)
                "mem_overhead_fraction":
                    round(mem_sampling_s / wall_s, 6)
                    if wall_s > 0 else 0.0,
                "ok": bool(ok),
            }
            return SoakResult(ok, self.violations, self.trace,
                              fingerprint, summary,
                              timeline=self.timeline,
                              timeline_canonical=self.timeline_canonical,
                              report=self.report)
        finally:
            self.agent.shutdown()
            self.clock.close()
            wire.set_clock(SystemClock())
            # hand the process observability planes back to wall time
            # (the next Server to construct re-binds its own anyway)
            self.clock = SystemClock()
            self._rebind_clock()


def run_soak(seed: int = 0, profile: Optional[TrafficProfile] = None,
             **kw) -> SoakResult:
    return SoakRunner(seed=seed, profile=profile, **kw).run()
