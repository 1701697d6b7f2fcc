"""Named, seeded fault scenarios executed against real ClusterServers.

A scenario is a deterministic SCHEDULE — a list of virtual-time events
expanded from `random.Random(seed)` before anything runs — plus a small
spec (server count, duration, convergence goals).  The runner builds a
`SimNetwork` + `VirtualClock`, boots real `core.cluster.ClusterServer`s
on them, drives the timeline, applies the schedule, and finally asserts
the chaos invariants (chaos/invariants.py) over what it observed.

Determinism contract (chaos/trace.py): the canonical trace is exactly
the expanded schedule plus the terminal verdict + state fingerprint —
all deterministic functions of (scenario, seed) when the invariants
hold — so two runs with one seed produce byte-identical traces, and a
recorded trace replays without the seed (`schedule=` argument).

Event vocabulary (dicts, so traces round-trip):

  fault:    {"at", "kind": partition|heal|set_drop|set_latency|
             set_reorder|clear_link_faults|crash|restart, ...args}
  workload: {"at", "kind": "workload", "op": register_node|register_job|
             heartbeat|drain, ...args, "via": server index or
             "@leader"/"@follower"}

Group placeholders "@leader" / "@others" / "@follower" resolve at
EXECUTION time against live raft state (the canonical trace keeps the
placeholder, which is what makes leader-relative faults replayable).

A copy of the reference's nomad_tpu/chaos/scenarios.py with its imports
rewritten.  Two differences:

  - `ScenarioRunner(..., device=None)` and `run_scenario(...,
    device=None)` take the device the port's `ClusterServer`s place on,
    and pass it to every one of them.  It is CUDA unless given, and
    raises without CUDA; tests pass `device="cpu"`.
  - The final sample waits for the leader's commit.  The reference
    samples right after convergence holds; a write that commits on the
    leader in between (the last eval's completion) reaches the
    followers one round trip later, and `committed_entries_survive`
    then reports them as having lost it.  The port reads the final
    sample only once every server's applied index in it reaches the
    highest commit index in it (the leader's), advancing the virtual
    clock a step at a time as the convergence loop does, within what
    is left of the convergence budget; past it the run fails liveness,
    naming the lag.  With no write in flight the first reading
    qualifies, so the trace, its digest and the fingerprint are the
    reference's (tests/test_torch_chaos.py
    `test_final_sample_waits_for_the_leaders_commit`).

Nothing else differs: the schedules, traces and fingerprints are the
reference's.
"""

from __future__ import annotations

import hashlib
import random
import threading
from typing import Callable, Dict, List, Optional

from nomad_tpu_torch import mock
from nomad_tpu_torch.core import wire
from nomad_tpu_torch.core.cluster import ClusterServer
from nomad_tpu_torch.structs import DrainStrategy

from . import invariants
from .clock import SystemClock, VirtualClock
from .transport import SimNetwork
from .trace import Trace, state_fingerprint

# host-side wall pacing: real sleeps that let server threads run
# between virtual-clock advances, and real drain deadlines — metered on
# the host wall clock on purpose, never on the scenario's VirtualClock
_wall = SystemClock()

# virtual seconds between timeline steps; real sleep per step lets the
# server threads run between advances.  The RATIO (virtual:real ~13:1)
# is what matters for stability — timers must not race ahead of the
# thread work they trigger; fewer, larger steps at the same ratio cut
# the advance()-notify fan-out that dominates runner real time
# (measured: 0.04/0.003 runs the suite ~36% faster than 0.02/0.0015
# with identical pass rates)
_STEP_V = 0.04
_STEP_REAL = 0.003
_SAMPLE_EVERY_V = 0.1
# extra virtual budget after the schedule for the cluster to converge
# (virtual seconds are nearly free: the loop exits the moment the
# cluster converges, so a generous budget only costs time on failures)
_CONVERGE_BUDGET_V = 60.0
# how often the converge loop re-evaluates convergence (it snapshots
# the state store — per-step checks dominated the runner's real time)
_CONVERGE_CHECK_V = 0.2

# fast raft timings for scenarios (virtual seconds)
_RAFT = dict(heartbeat_interval=0.05, election_timeout=(0.2, 0.4))


def _w(at: float, op: str, **args) -> Dict:
    return {"at": at, "kind": "workload", "op": op, **args}


# ------------------------------------------------------------- scenarios


def _leader_partition(rng: random.Random) -> Dict:
    """Partition the sitting leader away from the majority; the rest
    must elect, keep scheduling, and re-absorb the deposed leader after
    heal without losing a committed entry."""
    return {
        "servers": 3,
        "duration": 9.0,
        "heartbeat_ttl": 120.0,
        "expect_live": {"chaos-j0": 2, "chaos-j1": 2},
        "schedule": [
            _w(0.5, "register_node", node="chaos-n0"),
            _w(1.2, "register_job", job="chaos-j0", count=2),
            {"at": 3.0, "kind": "partition", "a": ["@leader"],
             "b": ["@others"], "bidirectional": True},
            # scheduling must continue on the majority side
            _w(4.5, "register_job", job="chaos-j1", count=2),
            {"at": 7.0, "kind": "heal"},
        ],
    }


def _split_brain_attempt(rng: random.Random) -> Dict:
    """Isolate the leader, then write THROUGH the deposed leader while
    the majority elects a new one: the write must land exactly once (via
    the new leader after retries), never twice."""
    return {
        "servers": 3,
        "duration": 9.5,
        "heartbeat_ttl": 120.0,
        "expect_live": {"chaos-j0": 1, "chaos-j1": 1},
        "schedule": [
            _w(0.5, "register_node", node="chaos-n0"),
            _w(1.2, "register_job", job="chaos-j0", count=1),
            {"at": 3.0, "kind": "partition", "a": ["@leader"],
             "b": ["@others"], "bidirectional": True},
            # the deposed leader is asked first; its apply cannot reach
            # quorum, so the op retries until it lands on the real one
            _w(4.0, "register_job", job="chaos-j1", count=1,
               via="@leader"),
            {"at": 7.5, "kind": "heal"},
        ],
    }


def _gossip_flap_storm(rng: random.Random) -> Dict:
    """Seeded storm of short single-node partitions (flaps); membership
    and leadership must converge once the storm passes."""
    schedule: List[Dict] = [
        _w(0.5, "register_node", node="chaos-n0"),
        _w(1.2, "register_job", job="chaos-j0", count=2),
    ]
    t = 2.5
    for _ in range(5):
        victim = f"cs{rng.randrange(3)}"
        hold = round(rng.uniform(0.3, 0.9), 3)
        schedule.append({"at": round(t, 3), "kind": "partition",
                         "a": [victim], "b": ["@others"],
                         "bidirectional": rng.random() < 0.7})
        schedule.append({"at": round(t + hold, 3), "kind": "heal"})
        t += hold + round(rng.uniform(0.2, 0.6), 3)
    return {
        "servers": 3,
        "duration": max(10.0, t + 2.5),
        "heartbeat_ttl": 120.0,
        "expect_live": {"chaos-j0": 2},
        "schedule": schedule,
    }


def _lossy_link_raft_append(rng: random.Random) -> Dict:
    """15%% loss + latency + reordering on every link while a stream of
    jobs replicates: every append must still commit exactly once, in
    order, on every server."""
    schedule: List[Dict] = [
        _w(0.5, "register_node", node="chaos-n0"),
    ]
    pairs = [("cs0", "cs1"), ("cs0", "cs2"), ("cs1", "cs2")]
    for a, b in pairs:
        schedule.append({"at": 1.0, "kind": "set_drop",
                         "src": a, "dst": b, "p": 0.15})
        schedule.append({"at": 1.0, "kind": "set_latency",
                         "src": a, "dst": b, "lo": 0.002, "hi": 0.02})
        schedule.append({"at": 1.0, "kind": "set_reorder",
                         "src": a, "dst": b, "jitter": 0.015})
    expect = {}
    for k in range(3):
        schedule.append(_w(1.5 + 1.2 * k, "register_job",
                           job=f"chaos-j{k}", count=1))
        expect[f"chaos-j{k}"] = 1
    schedule.append({"at": 6.5, "kind": "clear_link_faults"})
    return {
        "servers": 3,
        "duration": 10.0,
        "heartbeat_ttl": 120.0,
        "expect_live": expect,
        "schedule": schedule,
    }


def _heartbeat_expiry_during_drain(rng: random.Random) -> Dict:
    """A client node goes silent mid-drain: its TTL expires in virtual
    time, the node goes down, and every alloc lands coherently (nothing
    both running and lost) with replacements on the surviving node."""
    schedule: List[Dict] = [
        _w(0.5, "register_node", node="chaos-n0"),
        _w(0.5, "register_node", node="chaos-n1"),
        _w(1.2, "register_job", job="chaos-j0", count=2),
    ]
    # both nodes heartbeat until vt=4; n0 then goes silent while being
    # drained — its TTL (3.0) expires around vt=7
    for t in (2.0, 3.0, 4.0):
        schedule.append(_w(t, "heartbeat", node="chaos-n0"))
    # deadline intentionally LONGER than the TTL window: n0's last beat
    # is at vt=4, so it expires ~vt=7 while the drain (would finish at
    # vt=10.2) is still in flight — expiry strictly DURING drain, not a
    # race between the two (a short deadline made the final state
    # bimodal: drained-then-expired vs expired-mid-drain)
    schedule.append(_w(4.2, "drain", node="chaos-n0", deadline=6.0))
    return {
        "servers": 3,
        "duration": 12.0,
        "heartbeat_ttl": 3.0,
        # n1 is the HEALTHY client: the runner pumps its heartbeat every
        # virtual second for the whole run (scheduled discrete
        # heartbeats would stop at some vt and turn "did we converge
        # within one TTL of the last beat" into a coin flip)
        "keepalive": ["chaos-n1"],
        "expect_live": {"chaos-j0": 2},
        "expect_node_status": {"chaos-n0": "down", "chaos-n1": "ready"},
        "schedule": schedule,
    }


SCENARIOS: Dict[str, Callable[[random.Random], Dict]] = {
    "leader_partition": _leader_partition,
    "split_brain_attempt": _split_brain_attempt,
    "gossip_flap_storm": _gossip_flap_storm,
    "lossy_link_raft_append": _lossy_link_raft_append,
    "heartbeat_expiry_during_drain": _heartbeat_expiry_during_drain,
}


# ---------------------------------------------------------------- result


class ScenarioResult:
    def __init__(self, name: str, seed: int, trace: Trace,
                 violations: List[str], fingerprint: str,
                 schedule: List[Dict], converged: bool,
                 failed_ops: List[str], snapshot=None,
                 spans: Optional[List[Dict]] = None) -> None:
        self.name = name
        self.seed = seed
        self.trace = trace
        self.violations = violations
        self.fingerprint = fingerprint
        self.schedule = schedule
        self.converged = converged
        self.failed_ops = failed_ops
        self.snapshot = snapshot       # final state snapshot (forensics)
        # eval-lifecycle telemetry spans captured during the run
        # (core/telemetry.py): scenario tests assert on TRACE SHAPE —
        # which lifecycle stages each eval passed through — on top of
        # the state/log invariants
        self.spans = spans if spans is not None else []

    def span_names(self, trace_id: Optional[str] = None) -> List[str]:
        """Distinct span names seen (optionally for one trace), sorted —
        the scenario-level trace-shape assertion helper."""
        return sorted({s["Name"] for s in self.spans
                       if trace_id is None or s["TraceID"] == trace_id})

    @property
    def ok(self) -> bool:
        return (not self.violations and self.converged
                and not self.failed_ops)


# ---------------------------------------------------------------- runner


class ScenarioRunner:
    """Execute one scenario (by name+seed, or from a recorded schedule)
    against a fresh simulated cluster."""

    def __init__(self, name: str, seed: int = 0,
                 schedule: Optional[List[Dict]] = None,
                 device=None) -> None:
        if name not in SCENARIOS:
            raise KeyError(f"unknown scenario {name!r} "
                           f"(have: {sorted(SCENARIOS)})")
        self.name = name
        self.seed = seed
        spec = SCENARIOS[name](random.Random(seed))
        if schedule is not None:
            # replay path: the recorded schedule replaces the seed
            # expansion verbatim (spec-level knobs still come from name)
            spec = dict(spec)
            spec["schedule"] = [dict(e) for e in schedule]
        self.spec = spec
        self.device = device

    # ------------------------------------------------------------ helpers

    def _resolve_group(self, token, servers) -> List[str]:
        if isinstance(token, list):
            out: List[str] = []
            for t in token:
                out.extend(self._resolve_group(t, servers))
            return out
        if token == "@leader":
            for s in servers:
                if s.raft.is_leader():
                    return [s.name]
            return [servers[0].name]           # no leader: pick one
        if token == "@others":
            leaders = self._resolve_group("@leader", servers)
            return [s.name for s in servers if s.name not in leaders]
        return [token]

    def _resolve_via(self, via, servers) -> ClusterServer:
        if via in ("@leader", "@follower"):
            names = self._resolve_group(
                "@leader" if via == "@leader" else "@others", servers)
            target = names[0]
            return next(s for s in servers if s.name == target)
        return servers[int(via or 0)]

    # -------------------------------------------------------------- run

    def run(self) -> ScenarioResult:
        spec = self.spec
        n = spec["servers"]
        duration = spec["duration"]
        schedule = sorted((dict(e) for e in spec["schedule"]),
                          key=lambda e: (e["at"], e["kind"], str(sorted(
                              (k, str(v)) for k, v in e.items()))))

        clock = VirtualClock()
        trace = Trace()
        # telemetry hook: spans recorded during this run stamp VIRTUAL
        # time (ClusterServer construction rebinds the process telemetry
        # clock to `clock`); reset first so the captured span set belongs
        # to this run alone
        from nomad_tpu_torch.core import telemetry
        telemetry.TRACER.reset()
        net = SimNetwork(clock=clock, seed=self.seed, trace=trace)
        # the canonical trace IS the schedule (+ terminal verdicts):
        # recorded up front, before execution can interleave anything
        for e in schedule:
            trace.record(e["at"], e["kind"],
                         **{k: v for k, v in e.items()
                            if k not in ("at", "kind")})

        servers = [
            ClusterServer(
                f"cs{i}",
                transport=net.node(f"cs{i}"),
                clock=clock,
                bootstrap_expect=n,
                autopilot_grace=10.0,
                heartbeat_ttl=spec.get("heartbeat_ttl", 120.0),
                num_workers=1,
                device=self.device,
                **_RAFT)
            for i in range(n)
        ]

        # observation hooks (chaos/invariants.py inputs)
        obs_lock = threading.Lock()
        samples: List[dict] = []
        applied: Dict[str, List[tuple]] = {s.name: [] for s in servers}
        installs: Dict[str, List[tuple]] = {s.name: [] for s in servers}
        origins: List[dict] = []

        def _digest(cmd: bytes) -> str:
            return hashlib.sha256(cmd).hexdigest()[:16]

        def _method(cmd: bytes) -> str:
            if not cmd:
                return "noop"
            try:
                return str(wire.unpackb(cmd)[0])
            except Exception:  # noqa: BLE001 - unknown shape, keep going
                return "?"

        def make_fsm_obs(server_name: str):
            def obs(entry):
                with obs_lock:
                    applied[server_name].append(
                        (entry.index, entry.term, _digest(entry.cmd),
                         _method(entry.cmd)))
            return obs

        def make_append_obs(server_name: str):
            def obs(entry):
                with obs_lock:
                    origins.append({
                        "server": server_name, "index": entry.index,
                        "term": entry.term, "digest": _digest(entry.cmd),
                        "method": _method(entry.cmd),
                        "at": clock.monotonic()})
            return obs

        def make_install_obs(server_name: str):
            def obs(snap_index: int, snap_term: int) -> None:
                with obs_lock:
                    installs[server_name].append((snap_index, snap_term))
            return obs

        for s in servers:
            s.raft.fsm_observer = make_fsm_obs(s.name)
            s.raft.append_observer = make_append_obs(s.name)
            s.raft.install_observer = make_install_obs(s.name)
            # virtual seconds: a dropped forward reply must cost a few
            # retries, not half the converge budget (see forward_timeout)
            s.forward_timeout = 3.0

        node_ids: Dict[str, str] = {}        # workload node name -> id
        failed_ops: List[str] = []
        wl_stop = threading.Event()

        def established_leader():
            """The leader whose establishment BARRIER has completed —
            the only server whose state provably contains every entry
            inherited from previous terms (a just-elected leader's
            local state can lag its log, so a landed-check against it
            would miss a predecessor's limbo commit and trigger a
            duplicating re-submit)."""
            return next((s for s in servers
                         if s.raft.is_leader()
                         and getattr(s, "_leader", False)), None)

        def job_landed(leader, job_id: str) -> bool:
            """Authoritative read against the ESTABLISHED leader: did a
            register_job actually commit?  A lost RPC *reply* must not
            trigger a blind re-submit — the duplicate eval races
            leadership flux with a stale snapshot and can over-place
            (what a careful at-least-once client avoids by verifying
            before retrying).  BOTH halves must have landed: the job
            upsert and its evaluation are separate raft entries, and a
            leader deposed between them leaves a job no scheduler will
            ever look at — that shape needs the retry."""
            try:
                snap = leader.state.snapshot()
                if snap.job_by_id("default", job_id) is None:
                    return False
                # a permanently-failed eval schedules nothing ever again
                # — that job needs the re-register too
                return any(ev.job_id == job_id and ev.status != "failed"
                           for ev in snap.evals())
            except Exception:  # noqa: BLE001 - mid-teardown read
                return False

        def node_landed(leader, node_name: str) -> bool:
            """Same verified-retry contract as job_landed: a lost reply
            to register_node must not mint a SECOND node id for the same
            workload node — a duplicate would survive to the final state
            and break the fingerprint's determinism."""
            try:
                for n in leader.state.snapshot().nodes():
                    if n.name == node_name:
                        node_ids[node_name] = n.id
                        return True
            except Exception:  # noqa: BLE001 - mid-teardown read
                return False
            return False

        def run_op(ev: Dict) -> None:
            """Execute one workload op, retrying through leadership flux
            until it lands or the scenario ends."""
            op = ev["op"]
            deadline_v = duration + _CONVERGE_BUDGET_V
            attempt = 0
            while not wl_stop.is_set() and clock.monotonic() < deadline_v:
                if op in ("register_node", "register_job"):
                    # creation ops wait for an ESTABLISHED leader: a
                    # pre-barrier leader can't answer "did my previous
                    # attempt land?", and submitting blind is exactly
                    # how duplicates are minted
                    leader = established_leader()
                    if leader is None:
                        clock.wait(wl_stop, 0.25)
                        continue
                    if op == "register_job" and job_landed(
                            leader, ev["job"]):
                        return
                    if op == "register_node" and node_landed(
                            leader, ev["node"]):
                        return
                via = self._resolve_via(ev.get("via", 0), servers)
                try:
                    if op == "register_node":
                        nd = node_ids.get(ev["node"])
                        node = mock.node(name=ev["node"])
                        if nd is not None:
                            node.id = nd     # re-register, don't duplicate
                        via.register_node(node)
                        node_ids[ev["node"]] = node.id
                    elif op == "register_job":
                        job = mock.job(id=ev["job"])
                        job.task_groups[0].count = int(ev["count"])
                        via.register_job(job)
                    elif op == "heartbeat":
                        nid = node_ids.get(ev["node"])
                        if nid is None:
                            raise RuntimeError(f"node {ev['node']} "
                                               "not registered yet")
                        via.heartbeat_node(nid)
                    elif op == "drain":
                        nid = node_ids.get(ev["node"])
                        if nid is None:
                            raise RuntimeError(f"node {ev['node']} "
                                               "not registered yet")
                        via.drain_node(
                            nid, DrainStrategy(
                                deadline_s=float(ev.get("deadline", 2.0))))
                    else:
                        raise ValueError(f"unknown workload op {op!r}")
                    return
                except Exception as exc:  # noqa: BLE001 - retry through flux
                    attempt += 1
                    trace.debug(clock.monotonic(), "op_retry", op=op,
                                attempt=attempt, error=repr(exc))
                    clock.wait(wl_stop, 0.25)
            failed_ops.append(f"{op} {ev} never succeeded")

        workload = sorted((e for e in schedule if e["kind"] == "workload"),
                          key=lambda e: e["at"])

        def workload_loop() -> None:
            for ev in workload:
                while (clock.monotonic() < ev["at"]
                       and not wl_stop.is_set()):
                    clock.wait(wl_stop, ev["at"] - clock.monotonic())
                if wl_stop.is_set():
                    return
                run_op(ev)

        faults = sorted((e for e in schedule if e["kind"] != "workload"),
                        key=lambda e: e["at"])

        # runner-driven keepalive heartbeats: nodes the scenario spec
        # declares perpetually healthy beat once per virtual second for
        # the WHOLE run (including the converge phase) — a finite
        # scheduled heartbeat list would make "converged within one TTL
        # of the last beat" a race, not a property
        keepalive = list(spec.get("keepalive", ()))
        next_beat = [0.0]

        def pump_keepalive() -> None:
            if not keepalive:
                return
            now_v = clock.monotonic()
            if now_v < next_beat[0]:
                return
            next_beat[0] = now_v + 1.0
            leader = next((s for s in servers if s.raft.is_leader()), None)
            if leader is None:
                return
            for nname in keepalive:
                nid = node_ids.get(nname)
                if nid is None:
                    continue
                try:
                    leader.heartbeat_node(nid)
                except Exception:  # noqa: BLE001 - next beat retries
                    pass

        def apply_fault(ev: Dict) -> None:
            kind = ev["kind"]
            if kind == "partition":
                a = self._resolve_group(ev["a"], servers)
                b = self._resolve_group(ev["b"], servers)
                trace.debug(clock.monotonic(), "partition_resolved",
                            a=a, b=b)
                net.partition(a, b,
                              bidirectional=ev.get("bidirectional", True))
            elif kind == "heal":
                net.heal()
            elif kind == "set_drop":
                net.set_drop(ev["src"], ev["dst"], ev["p"])
            elif kind == "set_latency":
                net.set_latency(ev["src"], ev["dst"], ev["lo"], ev["hi"])
            elif kind == "set_reorder":
                net.set_reorder(ev["src"], ev["dst"], ev["jitter"])
            elif kind == "clear_link_faults":
                net.clear_link_faults()
            elif kind == "crash":
                net.crash(self._resolve_group(ev["node"], servers)[0])
            elif kind == "restart":
                net.restart(self._resolve_group(ev["node"], servers)[0])
            else:
                raise ValueError(f"unknown fault kind {kind!r}")

        def read_rows() -> List[dict]:
            now_v = clock.monotonic()
            rows = []
            for s in servers:
                r = s.raft
                with r._lock:
                    rows.append({"at": now_v, "server": s.name,
                                 "role": r.role, "term": r.term,
                                 "commit_index": r.commit_index,
                                 "applied": r.last_applied})
            return rows

        def sample() -> None:
            rows = read_rows()
            with obs_lock:
                samples.extend(rows)

        conv_reason = [""]          # why the last converged() said no

        def converged() -> bool:
            why = invariants.leadership_converged(servers)
            if why:
                conv_reason[0] = why[0]
                return False
            why = invariants.membership_converged(servers)
            if why:
                conv_reason[0] = why[0]
                return False
            leader = next(s for s in servers if s.raft.is_leader())
            commit = leader.raft.commit_index
            lag = {s.name: s.raft.last_applied for s in servers
                   if s.raft.last_applied != commit}
            if lag:
                conv_reason[0] = f"applied lag vs commit {commit}: {lag}"
                return False
            snap = leader.state.snapshot()
            for nname, want in spec.get("expect_node_status", {}).items():
                nid = node_ids.get(nname)
                node = snap.node_by_id(nid) if nid else None
                got = node.status if node else None
                if got != want:
                    conv_reason[0] = (f"node {nname} status {got!r}, "
                                      f"want {want!r}")
                    return False
            for job_id, want in spec.get("expect_live", {}).items():
                live = [a for a in snap.allocs_by_job("default", job_id)
                        if not a.terminal_status()]
                if len(live) != want:
                    conv_reason[0] = (f"job {job_id}: {len(live)} live "
                                      f"allocs, want {want}")
                    return False
            conv_reason[0] = ""
            return True

        # ------------------------------------------------------- execute
        wl_thread = threading.Thread(target=workload_loop, daemon=True,
                                     name=f"chaos-workload-{self.name}")
        final_ok = False
        try:
            servers[0].start(tick_interval=0.25)
            for s in servers[1:]:
                s._join_seeds = [servers[0].gossip.addr]
                s.start(tick_interval=0.25)
            wl_thread.start()

            fault_i = 0
            next_sample = 0.0
            while clock.monotonic() < duration:
                now_v = clock.monotonic()
                while fault_i < len(faults) and faults[fault_i]["at"] <= now_v:
                    apply_fault(faults[fault_i])
                    fault_i += 1
                if now_v >= next_sample:
                    sample()
                    next_sample = now_v + _SAMPLE_EVERY_V
                pump_keepalive()
                clock.advance(_STEP_V)
                _wall.sleep(_STEP_REAL)
            # any faults scheduled exactly at the end
            while fault_i < len(faults):
                apply_fault(faults[fault_i])
                fault_i += 1
            # everything heals; give the cluster a bounded window to
            # converge (safety invariants were sampled throughout —
            # convergence is the LIVENESS half)
            net.heal()
            net.clear_link_faults()
            for name in net.nodes():
                net.restart(name)
            end_v = clock.monotonic() + _CONVERGE_BUDGET_V
            next_check = 0.0
            while clock.monotonic() < end_v:
                now_v = clock.monotonic()
                if now_v >= next_sample:
                    sample()
                    next_sample = now_v + _SAMPLE_EVERY_V
                if now_v >= next_check:
                    if not wl_thread.is_alive() and converged():
                        final_ok = True
                        break
                    next_check = now_v + _CONVERGE_CHECK_V
                pump_keepalive()
                clock.advance(_STEP_V)
                _wall.sleep(_STEP_REAL)
            wl_stop.set()
            wl_thread.join(timeout=5)
            if not final_ok:
                final_ok = converged() and not wl_thread.is_alive()

            # the final sample: a write may commit on the leader after
            # converged() (the last eval's completion), a round trip
            # ahead of the followers, so read it only once every server
            # has applied the highest commit index in it, moving the
            # timeline on as the loop above does (the network delivers
            # in virtual time) within the budget's rest
            while True:
                final_rows = read_rows()
                commit = max(r["commit_index"] for r in final_rows)
                lag = {r["server"]: r["applied"] for r in final_rows
                       if r["applied"] < commit}
                if not lag or clock.monotonic() >= end_v:
                    break
                pump_keepalive()
                clock.advance(_STEP_V)
                _wall.sleep(_STEP_REAL)
            if lag and final_ok:
                final_ok = False
                conv_reason[0] = (f"applied lag vs commit {commit} at the "
                                  f"final sample: {lag}")

            # let the fsm observers drain: raft advances last_applied
            # under its lock but observers fire after, so the final
            # check could otherwise read an applied list one entry
            # short and misreport a committed entry as lost
            def observers_behind() -> bool:
                with obs_lock:
                    for s in servers:
                        top = applied[s.name][-1][0] \
                            if applied[s.name] else 0
                        if installs[s.name]:
                            top = max(top, max(
                                i for i, _t in installs[s.name]))
                        if top < s.raft.last_applied:
                            return True
                return False

            drain_deadline = _wall.time() + 2.0
            while observers_behind() and _wall.time() < drain_deadline:
                _wall.sleep(0.005)

            with obs_lock:
                samples.extend(final_rows)
            leader = next((s for s in servers if s.raft.is_leader()),
                          servers[0])
            snap = leader.state.snapshot()
            with obs_lock:
                viol = invariants.check_all(
                    samples=list(samples), applied=dict(applied),
                    origins=list(origins), servers=servers, snap=snap,
                    installs=dict(installs))
            if not final_ok:
                viol = viol + ["cluster failed to converge within the "
                               "post-schedule budget: "
                               + (conv_reason[0] or "workload pending")]
            if failed_ops:
                viol = viol + [f"workload op failed: {f}"
                               for f in failed_ops]
            fingerprint = state_fingerprint(snap)
            # terminal canonical events: deterministic whenever the run
            # is healthy (verdict ok + converged fingerprint)
            trace.record(duration, "verdict",
                         ok=not viol, violations=sorted(viol))
            trace.record(duration, "fingerprint", sha256=fingerprint)
            return ScenarioResult(
                self.name, self.seed, trace, viol, fingerprint,
                schedule, final_ok, failed_ops, snapshot=snap,
                spans=telemetry.TRACER.spans())
        finally:
            wl_stop.set()
            # keep the timeline moving while servers tear down: leave
            # goodbyes and forwarded calls block in virtual time
            drv_stop = threading.Event()

            def drive():
                while not drv_stop.is_set():
                    clock.advance(0.05)
                    _wall.sleep(0.002)

            drv = threading.Thread(target=drive, daemon=True,
                                   name="chaos-teardown-drive")
            drv.start()
            for s in servers:
                try:
                    s.shutdown()
                except Exception:  # noqa: BLE001 - teardown best effort
                    pass
            drv_stop.set()
            drv.join(timeout=2)
            clock.close()


def run_scenario(name: str, seed: int = 0,
                 schedule: Optional[List[Dict]] = None,
                 device=None) -> ScenarioResult:
    return ScenarioRunner(name, seed=seed, schedule=schedule,
                          device=device).run()
