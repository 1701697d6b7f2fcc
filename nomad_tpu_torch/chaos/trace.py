"""Event traces + canonical state fingerprints for chaos scenarios.

Two tiers of events:

  - CANONICAL events are deterministic functions of (scenario, seed):
    the expanded fault/workload schedule and the terminal invariant
    verdicts.  `canonical_bytes()` serializes them stably (sorted field
    keys, fixed float formatting), so the same seed yields
    byte-identical traces across runs — every found failure is a
    replayable regression test, and the determinism suite simply
    compares bytes.
  - DEBUG events record what actually happened on the fabric (message
    drops, dial refusals, op retries).  Their order depends on thread
    interleaving, so they are excluded from the canonical form but kept
    for post-mortems.

`schedule_from_trace()` inverts the canonical form back into a fault
schedule, so a recorded trace re-executes without the seed (the replay
path of tests/test_chaos.py).

`state_fingerprint()` hashes the CONVERGED semantic content of a state
store snapshot — node statuses by name, jobs by id, live alloc counts
per (job, group, node) — deliberately excluding randomized ids and
terminal-alloc history, which legitimately differ between two faithful
executions of the same schedule (how many times an alloc was lost and
replaced depends on timing; where the survivors run does not).

A copy of the reference's nomad_tpu/chaos/trace.py; nothing differs.
A port trace and a reference trace of the same events serialize to
the same bytes.
"""

from __future__ import annotations

import hashlib
import json
import threading
from typing import Dict, List, Optional

# canonical-event kinds a schedule is rebuilt from (see
# scenarios.FaultEvent.kind for the vocabulary)
SCHEDULE_KINDS = frozenset({
    "partition", "heal", "set_drop", "set_latency", "set_reorder",
    "clear_link_faults", "crash", "restart", "workload",
})


def _canon(value):
    """JSON-stable projection: floats fixed to 6 decimals, sets sorted,
    tuples listed — so equal schedules always serialize equally."""
    if isinstance(value, float):
        return f"{value:.6f}"
    if isinstance(value, (set, frozenset)):
        return sorted(_canon(v) for v in value)
    if isinstance(value, (list, tuple)):
        return [_canon(v) for v in value]
    if isinstance(value, dict):
        return {str(k): _canon(v) for k, v in value.items()}
    return value


class Trace:
    """Append-only, thread-safe event log for one scenario run."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.events: List[Dict] = []        # canonical
        self.debug_events: List[Dict] = []  # best-effort, nondeterministic

    def record(self, at: float, kind: str, **fields) -> None:
        with self._lock:
            self.events.append({"at": float(at), "kind": kind, **fields})

    def debug(self, at: float, kind: str, **fields) -> None:
        with self._lock:
            self.debug_events.append(
                {"at": float(at), "kind": kind, **fields})

    # ------------------------------------------------------ serialization

    def canonical_lines(self) -> List[str]:
        with self._lock:
            events = list(self.events)
        out = []
        for e in events:
            body = {k: _canon(v) for k, v in e.items() if k != "kind"}
            out.append(f"{e['kind']} "
                       + json.dumps(body, sort_keys=True,
                                    separators=(",", ":")))
        return out

    def canonical_bytes(self) -> bytes:
        return ("\n".join(self.canonical_lines()) + "\n").encode("utf-8")

    def digest(self) -> str:
        return hashlib.sha256(self.canonical_bytes()).hexdigest()


def schedule_from_trace(trace: Trace) -> List[Dict]:
    """Canonical trace -> replayable schedule: the fault/workload events
    in virtual-time order, each as {"at", "kind", ...args}.  Verdict and
    bookkeeping events are dropped."""
    with trace._lock:
        events = list(trace.events)
    sched = [dict(e) for e in events if e["kind"] in SCHEDULE_KINDS]
    sched.sort(key=lambda e: (e["at"], e["kind"]))
    return sched


# ------------------------------------------------------------ fingerprint


def state_fingerprint(snap, node_names: Optional[Dict[str, str]] = None,
                      ) -> str:
    """Canonical digest of a state-store snapshot's converged content.
    `node_names` maps node ids to stable names; when omitted it is
    derived from the snapshot's own nodes (mock names are stable when
    the scenario assigns them explicitly)."""
    names = dict(node_names or {})
    nodes = []
    for n in snap.nodes():
        names.setdefault(n.id, n.name)
        nodes.append((n.name, n.status, n.scheduling_eligibility))
    jobs = sorted((j.id, bool(j.stop), j.type) for j in snap.jobs())
    live: Dict[tuple, int] = {}
    for j in snap.jobs():
        for a in snap.allocs_by_job(j.namespace, j.id):
            if a.terminal_status():
                continue
            key = (a.job_id, a.task_group, names.get(a.node_id, "?"))
            live[key] = live.get(key, 0) + 1
    doc = {
        "nodes": sorted(nodes),
        "jobs": jobs,
        "live_allocs": sorted((list(k), v) for k, v in live.items()),
    }
    blob = json.dumps(_canon(doc), sort_keys=True,
                      separators=(",", ":")).encode("utf-8")
    return hashlib.sha256(blob).hexdigest()
