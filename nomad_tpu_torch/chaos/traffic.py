"""Seeded traffic generator for the virtual-time production soak.

Expands a `(seed, TrafficProfile)` pair into a deterministic schedule
of cluster-life events — mixed service/batch/system jobs with
heavy-tailed group sizes, rolling deployments, autoscaling churn
(scale-up bursts and scale-to-zero), node drains, heartbeat flap
storms, preemption storms from priority inversion, and the named chaos
scenarios interleaved — the way a day of production traffic arrives,
compressed onto a virtual timeline the soak runner replays in seconds.

This module is PURE data: stdlib only, no cluster imports, every event
a plain dict `{"at": <virtual seconds>, "kind": ..., ...}`.  The soak
runner (chaos/soak.py) turns events into real API calls; tests replay
`generate_schedule` twice and compare byte for byte.

Determinism rules (same discipline as chaos/scenarios.py):
  - one `random.Random(seed)` drives every draw, in a fixed order;
  - event ids ("svc-0003", "soak-n007") are sequence-derived, never
    random;
  - the output is sorted stably by `at`, so generation order breaks
    ties identically on every run.

A capacity ledger keeps standing demand under
`capacity_fraction` of the fleet, so the converged end state is "every
surviving demand placed" — a deterministic target the soak can
fingerprint — rather than an unschedulable pile of blocked evals.

`retry_idempotent()` is the verified-idempotent retry discipline the
runner uses for API calls interrupted by injected faults: an op that
raised may still have LANDED (the fault ate the reply, not the
request), so each retry is preceded by a verify probe.

A copy of the reference's nomad_tpu/chaos/traffic.py; nothing
differs.  Its schedules and fleets are the reference's byte for byte.
"""

from __future__ import annotations

import hashlib
import random
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

# chaos scenarios the generator may interleave (chaos/scenarios.py
# owns the implementations; this module only schedules them by name)
DEFAULT_SCENARIOS = ("leader_partition", "gossip_flap_storm")


@dataclass
class TrafficProfile:
    """Shape knobs for one soak run.  Defaults model a small but busy
    cluster-day; tests shrink `hours` and the per-hour rates."""

    hours: float = 2.0                 # virtual horizon
    n_nodes: int = 12
    n_zones: int = 3                   # datacenters (zone-balance gauge)
    node_cpu: int = 4000
    node_mem: int = 8192
    capacity_fraction: float = 0.6     # standing-demand ceiling
    quiet_tail_frac: float = 0.15      # fault-free convergence window

    # workload mix (events per virtual hour)
    service_per_hour: float = 6.0
    batch_per_hour: float = 10.0
    system_jobs: int = 1

    # heavy-tailed service group sizes: bounded Pareto(alpha, xm)
    pareto_alpha: float = 1.3
    pareto_xm: float = 2.0
    count_cap: int = 16

    # churn
    deploy_frac: float = 0.5           # services that roll a new rev
    scale_frac: float = 0.4            # services that autoscale
    scale_to_zero_frac: float = 0.3    # of the autoscalers
    stop_frac: float = 0.3             # services stopped mid-run

    # faults
    drains_per_hour: float = 1.5
    flap_storms_per_hour: float = 1.0
    flap_storm_nodes: int = 3
    preempt_storms_per_hour: float = 0.5
    storm_priority: int = 90
    filler_priority: int = 20
    chaos_scenarios: Tuple[str, ...] = DEFAULT_SCENARIOS

    # batch runtimes (virtual seconds), heavy-tailed and bounded
    batch_runtime_min: float = 60.0
    batch_runtime_cap: float = 1200.0

    # networked service fleets: this fraction of service registrations
    # request dynamic ports (their job.register events grow a "ports"
    # count, so the soak exercises the columnar port-assignment path);
    # when `node_classes` is non-empty the fleet's nodes get classes
    # round-robin and each networked service pins one class.  Both
    # default OFF, and every extra rng draw is gated behind a nonzero
    # knob, so existing seeded schedules stay byte-identical.
    networked_fraction: float = 0.0
    node_classes: Tuple[str, ...] = ()


def stable_id(*parts) -> str:
    """Deterministic 32-hex id from the seed + a sequence label (node
    ids must not come from uuid4: the double-run fingerprint compares
    runs, and random ids would make every diff noise)."""
    h = hashlib.sha256("/".join(str(p) for p in parts).encode())
    return h.hexdigest()[:32]


def fleet(seed: int, profile: Optional[TrafficProfile] = None
          ) -> List[Dict]:
    """Node specs for the synthetic fleet: name/id/datacenter/resources,
    all sequence-derived."""
    p = profile or TrafficProfile()
    out = []
    for i in range(p.n_nodes):
        spec = {
            "name": f"soak-n{i:03d}",
            "id": stable_id("node", seed, i),
            "datacenter": f"dc{(i % p.n_zones) + 1}",
            "cpu": p.node_cpu,
            "mem": p.node_mem,
        }
        if p.node_classes:
            # round-robin, sequence-derived (no rng: the fleet shape
            # must not perturb the schedule's draw order)
            spec["node_class"] = p.node_classes[i % len(p.node_classes)]
        out.append(spec)
    return out


def _pareto_count(rng: random.Random, p: TrafficProfile) -> int:
    u = rng.random()
    n = int(p.pareto_xm * (max(u, 1e-9) ** (-1.0 / p.pareto_alpha)))
    return max(1, min(p.count_cap, n))


class _Ledger:
    """Standing-demand ledger: cpu booked per live job, capped at the
    capacity fraction so the schedule stays convergeable."""

    def __init__(self, p: TrafficProfile) -> None:
        self.budget = p.n_nodes * p.node_cpu * p.capacity_fraction
        self.booked: Dict[str, float] = {}

    def fit_count(self, job: str, count: int, cpu: int) -> int:
        """Largest count <= requested that fits the remaining budget
        (releasing any prior booking for `job` first)."""
        free = self.budget - sum(v for k, v in self.booked.items()
                                 if k != job)
        n = min(count, int(free // cpu)) if cpu > 0 else count
        return max(0, n)

    def book(self, job: str, count: int, cpu: int) -> None:
        if count <= 0:
            self.booked.pop(job, None)
        else:
            self.booked[job] = float(count * cpu)

    def release(self, job: str) -> None:
        self.booked.pop(job, None)


def generate_schedule(seed: int,
                      profile: Optional[TrafficProfile] = None
                      ) -> List[Dict]:
    """Expand (seed, profile) into the sorted virtual-time event list.

    Event kinds (all times in virtual seconds from soak start):
      job.register  job/jtype/count/cpu/mem/priority[/runtime_s/rev]
      job.deploy    job/rev           (rolling update: new version)
      job.scale     job/group/count   (burst up or scale-to-zero)
      job.stop      job
      node.drain    node/duration     (node.restore is emitted too)
      node.restore  node
      node.flap     node/duration     (heartbeats withheld for the span)
      chaos         scenario/seed     (chaos/scenarios.py interleave)
    """
    p = profile or TrafficProfile()
    rng = random.Random(seed)
    horizon = p.hours * 3600.0
    active_end = horizon * (1.0 - p.quiet_tail_frac)
    ledger = _Ledger(p)
    events: List[Dict] = []

    # -- system jobs: land first, run the whole day -------------------
    for i in range(p.system_jobs):
        events.append({"at": 1.0 + i, "kind": "job.register",
                       "job": f"sys-{i:04d}", "jtype": "system",
                       "count": 1, "cpu": 100, "mem": 64,
                       "priority": 70})

    # -- service fleet: heavy-tailed sizes, deploys, scaling, stops ---
    n_service = max(1, int(p.service_per_hour * p.hours))
    for i in range(n_service):
        job = f"svc-{i:04d}"
        at = rng.uniform(5.0, active_end * 0.5)
        cpu = rng.choice((200, 300, 500))
        count = _pareto_count(rng, p)
        count = ledger.fit_count(job, count, cpu)
        if count == 0:
            continue
        ledger.book(job, count, cpu)
        ev = {"at": at, "kind": "job.register", "job": job,
              "jtype": "service", "count": count, "cpu": cpu,
              "mem": 128, "priority": 50, "rev": 0}
        # gated draws: with the knob at its 0.0 default no rng state is
        # consumed here, so pre-existing seeded schedules replay intact
        if (p.networked_fraction > 0
                and rng.random() < p.networked_fraction):
            ev["ports"] = rng.randint(1, 2)
            if p.node_classes:
                ev["node_class"] = rng.choice(p.node_classes)
        events.append(ev)
        t = at
        if rng.random() < p.deploy_frac:
            t = rng.uniform(t + 30.0, max(t + 31.0, active_end * 0.8))
            events.append({"at": t, "kind": "job.deploy", "job": job,
                           "rev": 1})
        if rng.random() < p.scale_frac:
            t2 = rng.uniform(t + 20.0, max(t + 21.0, active_end * 0.9))
            if rng.random() < p.scale_to_zero_frac:
                burst = 0          # scale-to-zero ...
            else:
                burst = ledger.fit_count(job, count * 2, cpu)
                burst = max(burst, 1)
            ledger.book(job, burst, cpu)
            events.append({"at": t2, "kind": "job.scale", "job": job,
                           "group": "web", "count": burst, "cpu": cpu})
            if burst == 0:         # ... then back up to a small size
                t3 = rng.uniform(t2 + 20.0, max(t2 + 21.0, active_end))
                again = max(1, ledger.fit_count(job, 2, cpu))
                ledger.book(job, again, cpu)
                events.append({"at": t3, "kind": "job.scale",
                               "job": job, "group": "web",
                               "count": again, "cpu": cpu})
        if rng.random() < p.stop_frac:
            t4 = rng.uniform(at + 60.0, max(at + 61.0, active_end))
            ledger.release(job)
            events.append({"at": t4, "kind": "job.stop", "job": job})

    # -- batch arrivals: short-lived, runtime must clear the tail -----
    n_batch = max(1, int(p.batch_per_hour * p.hours))
    for i in range(n_batch):
        job = f"bat-{i:04d}"
        runtime = min(p.batch_runtime_cap,
                      p.batch_runtime_min * (
                          max(rng.random(), 1e-9) ** (-0.5)))
        at = rng.uniform(5.0, max(6.0, active_end - runtime - 30.0))
        events.append({"at": at, "kind": "job.register", "job": job,
                       "jtype": "batch", "count": rng.randint(1, 3),
                       "cpu": 100, "mem": 64, "priority": 40,
                       "runtime_s": round(runtime, 3)})

    # -- node drains (with restores) ----------------------------------
    busy_until = [0.0] * p.n_nodes     # avoid overlapping faults per node
    n_drain = int(p.drains_per_hour * p.hours)
    for i in range(n_drain):
        at = rng.uniform(60.0, active_end * 0.9)
        node_i = rng.randrange(p.n_nodes)
        dur = rng.uniform(40.0, 120.0)
        if at < busy_until[node_i] or at + dur >= active_end:
            continue
        busy_until[node_i] = at + dur + 30.0
        name = f"soak-n{node_i:03d}"
        events.append({"at": at, "kind": "node.drain", "node": name,
                       "duration": round(dur, 3)})
        events.append({"at": at + dur, "kind": "node.restore",
                       "node": name})

    # -- heartbeat flap storms ----------------------------------------
    n_storm = int(p.flap_storms_per_hour * p.hours)
    for i in range(n_storm):
        at = rng.uniform(60.0, active_end * 0.9)
        for k in range(p.flap_storm_nodes):
            node_i = rng.randrange(p.n_nodes)
            dur = rng.uniform(10.0, 45.0)
            t = at + rng.uniform(0.0, 15.0)
            if t < busy_until[node_i] or t + dur >= active_end:
                continue
            busy_until[node_i] = t + dur + 30.0
            events.append({"at": t, "kind": "node.flap",
                           "node": f"soak-n{node_i:03d}",
                           "duration": round(dur, 3)})

    # -- preemption storms: low-prio filler, then a high-prio burst ---
    n_preempt = int(p.preempt_storms_per_hour * p.hours)
    for i in range(n_preempt):
        at = rng.uniform(120.0, active_end * 0.85)
        filler, storm = f"fill-{i:02d}", f"storm-{i:02d}"
        fcount = ledger.fit_count(filler, 6, 300)
        if fcount > 0:
            ledger.book(filler, fcount, 300)
            events.append({"at": at, "kind": "job.register",
                           "job": filler, "jtype": "batch",
                           "count": fcount, "cpu": 300, "mem": 64,
                           "priority": p.filler_priority,
                           "runtime_s": round(active_end - at, 3)})
        scount = max(1, ledger.fit_count(storm, 4, 500))
        ledger.book(storm, scount, 500)
        dur = rng.uniform(60.0, 180.0)
        events.append({"at": at + 20.0, "kind": "job.register",
                       "job": storm, "jtype": "service",
                       "count": scount, "cpu": 500, "mem": 128,
                       "priority": p.storm_priority, "rev": 0})
        ledger.release(storm)
        events.append({"at": min(at + 20.0 + dur, active_end),
                       "kind": "job.stop", "job": storm})
        ledger.release(filler)

    # -- chaos scenario interleave ------------------------------------
    for i, name in enumerate(p.chaos_scenarios):
        frac = (i + 1) / (len(p.chaos_scenarios) + 1)
        events.append({"at": round(active_end * frac, 3),
                       "kind": "chaos", "scenario": name,
                       "seed": seed * 1000 + i})

    for e in events:
        e["at"] = round(float(e["at"]), 3)
    return sorted(events, key=lambda e: e["at"])   # stable: ties keep
    #                                                generation order


# --------------------------------------------------- retry discipline


def retry_idempotent(op: Callable[[], object],
                     verify: Callable[[], bool],
                     attempts: int = 4,
                     on_retry: Optional[Callable[[int, BaseException],
                                                 None]] = None):
    """Issue `op()`; on failure, re-issue ONLY after `verify()` says the
    effect is not already visible.  An API call interrupted by an
    injected fault may have landed server-side (the fault ate the reply,
    not the request) — blind re-issue of a non-idempotent op would
    double-apply it, and blind give-up would drop it.  Returns
    (result, attempts_used); result is None when verify() confirmed a
    landed-but-unacknowledged op.  Raises the last error once the
    attempt budget is spent with the effect still absent."""
    last: Optional[BaseException] = None
    for i in range(1, attempts + 1):
        try:
            return op(), i
        except Exception as e:          # the fault boundary
            last = e
            if verify():
                return None, i
            if on_retry is not None:
                on_retry(i, e)
    assert last is not None
    raise last


@dataclass
class FaultyCall:
    """Test helper: wrap a callable so the first `fail_first` calls
    raise AFTER executing the side effect — the 'reply lost' fault shape
    retry_idempotent exists for."""

    fn: Callable[[], object]
    fail_first: int = 1
    calls: int = field(default=0)

    def __call__(self):
        self.calls += 1
        out = self.fn()
        if self.calls <= self.fail_first:
            raise ConnectionError("injected: reply lost after apply")
        return out
