"""Node heartbeats (reference: nomad/heartbeat.go).

Per-node TTL timers; a missed heartbeat marks the node down and creates
evals for every job with allocs on it (the failure-detection path of
SURVEY.md §6.3).  Deadlines are checked by the server tick loop with an
injected timebase for deterministic tests."""

from __future__ import annotations

import threading
from typing import Dict, List

from nomad_tpu_torch.core.telemetry import REGISTRY
from nomad_tpu_torch.structs import (
    Evaluation,
    NODE_STATUS_DOWN,
    TRIGGER_NODE_UPDATE,
)

DEFAULT_HEARTBEAT_TTL = 30.0


class HeartbeatTimers:
    def __init__(self, ttl: float = DEFAULT_HEARTBEAT_TTL) -> None:
        self._lock = threading.Lock()
        self.ttl = ttl
        self._deadlines: Dict[str, float] = {}

    def reset(self, node_id: str, now: float) -> None:
        """Node registered or heartbeated."""
        with self._lock:
            self._deadlines[node_id] = now + self.ttl
        REGISTRY.inc("nomad.heartbeat.resets")

    def remove(self, node_id: str) -> None:
        with self._lock:
            self._deadlines.pop(node_id, None)

    def has(self, node_id: str) -> bool:
        with self._lock:
            return node_id in self._deadlines

    def expired(self, now: float) -> List[str]:
        with self._lock:
            out = [nid for nid, dl in self._deadlines.items() if dl <= now]
            for nid in out:
                del self._deadlines[nid]
        if out:
            REGISTRY.inc("nomad.heartbeat.expired", len(out))
        return out


def build_node_evals(snap, node_id: str,
                     include_system: bool = False) -> List[Evaluation]:
    """One TRIGGER_NODE_UPDATE eval per job with live allocs on the node
    (shared by heartbeat expiry and explicit status updates).  With
    `include_system`, also one per running system job eligible for the
    node's datacenter — a node coming BACK (down→ready) has no live
    allocs to walk, yet system jobs must regain a placement on it
    (reference: Node.createNodeEvals)."""
    evals = []
    seen = set()
    for a in snap.allocs_by_node(node_id):
        if a.terminal_status():
            continue
        key = (a.namespace, a.job_id)
        if key in seen:
            continue
        seen.add(key)
        job = snap.job_by_id(a.namespace, a.job_id)
        evals.append(Evaluation(
            namespace=a.namespace,
            priority=job.priority if job else 50,
            type=job.type if job else "service",
            triggered_by=TRIGGER_NODE_UPDATE,
            job_id=a.job_id,
            node_id=node_id,
        ))
    if include_system:
        node = snap.node_by_id(node_id)
        for job in snap.jobs():
            if job.type != "system" or job.stop:
                continue
            if (job.namespace, job.id) in seen:
                continue
            if (node is not None and job.datacenters
                    and node.datacenter not in job.datacenters):
                continue
            seen.add((job.namespace, job.id))
            evals.append(Evaluation(
                namespace=job.namespace,
                priority=job.priority,
                type=job.type,
                triggered_by=TRIGGER_NODE_UPDATE,
                job_id=job.id,
                node_id=node_id,
            ))
    return evals


def invalidate_heartbeat(state, node_id: str, now: float) -> List[Evaluation]:
    """Mark the node down and build evals for affected jobs
    (reference: invalidateHeartbeat → Node.UpdateStatus(down))."""
    state.update_node_status(node_id, NODE_STATUS_DOWN)
    return build_node_evals(state.snapshot(), node_id)
