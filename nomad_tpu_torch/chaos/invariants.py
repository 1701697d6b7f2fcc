"""Cluster safety invariants checked after (and during) chaos scenarios.

Inputs are OBSERVATIONS the scenario runner collects from real servers
(chaos/scenarios.py wires the hooks), never log inspection:

  - `samples`: periodic per-server readings of (role, term,
    commit_index, last_applied), each row read under the raft lock so a
    sample can never tear role against term.
  - `applied`: per-server list of FSM-applied entries
    (index, term, digest, method) from RaftNode.fsm_observer.
  - `origins`: per-entry append records (server, index, term, digest,
    method) from RaftNode.append_observer, taken under the raft lock at
    the moment the leader appends — the ground truth of who created an
    entry while holding which term.

The checks:

  single_leader_per_term  — no two servers ever observed as LEADER in
      the same term (election safety).
  log_consistency         — every pair of servers agrees (term, digest)
      on every shared index, and each server's applied indexes are
      gapless (Log Matching: nothing committed is lost or reordered).
  committed_entries_survive — the highest commit index ever observed
      anywhere is <= every live server's final applied index (a healed
      cluster re-converges on everything that ever committed).
  no_deposed_commit       — every committed entry matches exactly one
      append origin with the SAME (index, term, digest), and that
      origin's server was the unique leader of that term.  Combined
      with log_consistency this is precisely "no entry — in particular
      no upsert_plan_results plan commit — from a deposed leader ever
      commits": a stale leader's appends carry its old term, so a
      commit of one would surface as a digest/term mismatch at that
      index or as a second leader for the term.
  membership_converged    — after heal, every server's gossip view has
      every cluster member alive.
  leadership_converged    — exactly one leader; every server's hint
      points at it.
  alloc_coherence         — the state store's alloc indexes agree (an
      alloc is never e.g. "running" under one index and "lost" under
      another) and no (job, group) holds more live allocs than its
      desired count (over-placement is the observable symptom of a
      deposed leader's plan sneaking in).

Each check returns a list of violation strings; empty means the
invariant held.

A copy of the reference's nomad_tpu/chaos/invariants.py; nothing
differs.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

# applied / origin entry tuple layout (kept positional — these records
# are produced on hot raft paths)
#   (index, term, digest, method)

LEADER = "leader"


def single_leader_per_term(samples: Sequence[dict]) -> List[str]:
    leaders: Dict[int, str] = {}
    out = []
    for s in samples:
        if s["role"] != LEADER:
            continue
        prev = leaders.setdefault(s["term"], s["server"])
        if prev != s["server"]:
            out.append(
                f"two leaders in term {s['term']}: {prev} and "
                f"{s['server']} (sampled at vt={s['at']:.3f})")
    return out


def log_consistency(applied: Dict[str, List[Tuple]],
                    installs: Optional[Dict[str, List[Tuple]]] = None,
                    ) -> List[str]:
    installs = installs or {}
    out = []
    for server, entries in applied.items():
        snap_idx = [s for s, _t in installs.get(server, [])]
        for a, b in zip(entries, entries[1:]):
            if b[0] != a[0] + 1:
                # a jump is legitimate exactly when a snapshot install
                # covered the skipped range: the follower's FSM replaced
                # state up to s and resumed per-entry apply at s+1
                if any(s >= a[0] and b[0] == s + 1 for s in snap_idx):
                    continue
                out.append(f"{server}: applied index gap {a[0]} -> {b[0]} "
                           "(committed entry lost or reordered)")
    names = sorted(applied)
    by_index = {s: {e[0]: e for e in applied[s]} for s in names}
    for i, s1 in enumerate(names):
        for s2 in names[i + 1:]:
            shared = by_index[s1].keys() & by_index[s2].keys()
            for idx in sorted(shared):
                e1, e2 = by_index[s1][idx], by_index[s2][idx]
                if (e1[1], e1[2]) != (e2[1], e2[2]):
                    out.append(
                        f"log divergence at index {idx}: {s1} applied "
                        f"term={e1[1]} {e1[3]} but {s2} applied "
                        f"term={e2[1]} {e2[3]}")
    return out


def committed_entries_survive(samples: Sequence[dict],
                              applied: Dict[str, List[Tuple]],
                              live_servers: Sequence[str],
                              installs: Optional[Dict[str, List[Tuple]]]
                              = None) -> List[str]:
    installs = installs or {}
    max_commit = max((s["commit_index"] for s in samples), default=0)
    out = []
    for server in live_servers:
        entries = applied.get(server, [])
        top = entries[-1][0] if entries else 0
        # a snapshot install IS the committed prefix up to its index —
        # the follower holds those entries' effects without having
        # observed them one by one
        top = max([top] + [s for s, _t in installs.get(server, [])])
        if top < max_commit:
            out.append(
                f"{server} converged at applied index {top} but commit "
                f"index {max_commit} was observed during the run "
                "(committed entry lost)")
    return out


def no_deposed_commit(applied: Dict[str, List[Tuple]],
                      origins: Sequence[dict],
                      samples: Sequence[dict]) -> List[str]:
    out = []
    leaders: Dict[int, str] = {}
    for s in samples:
        if s["role"] == LEADER:
            leaders.setdefault(s["term"], s["server"])
    by_key: Dict[Tuple[int, int], List[dict]] = {}
    for o in origins:
        by_key.setdefault((o["index"], o["term"]), []).append(o)
    committed: Dict[Tuple[int, int], Tuple] = {}
    for entries in applied.values():
        for e in entries:
            committed.setdefault((e[0], e[1]), e)
    for (idx, term), entry in sorted(committed.items()):
        origin_list = by_key.get((idx, term), [])
        matching = [o for o in origin_list if o["digest"] == entry[2]]
        if not matching:
            out.append(
                f"committed entry index={idx} term={term} ({entry[3]}) "
                "has no matching append origin — content mutated in "
                "flight or appended by an unobserved path")
            continue
        creators = {o["server"] for o in matching}
        if len(creators) > 1:
            out.append(
                f"entry index={idx} term={term} appended on multiple "
                f"servers {sorted(creators)} (two leaders in one term)")
        creator = next(iter(creators))
        known = leaders.get(term)
        if known is not None and known != creator:
            out.append(
                f"entry index={idx} term={term} ({entry[3]}) was "
                f"appended by {creator} but {known} was the observed "
                f"leader of term {term} — commit from a deposed leader")
    return out


def membership_converged(servers) -> List[str]:
    expected = {s.name for s in servers}
    out = []
    for s in servers:
        alive = set(s.gossip.alive_members())
        if alive != expected:
            out.append(
                f"{s.name} gossip view {sorted(alive)} != cluster "
                f"{sorted(expected)} (membership did not converge)")
    return out


def leadership_converged(servers) -> List[str]:
    leaders = [s.name for s in servers if s.raft.is_leader()]
    out = []
    if len(leaders) != 1:
        out.append(f"expected exactly one leader, found {leaders}")
        return out
    for s in servers:
        hint = s.raft.leader_hint()
        if hint != leaders[0]:
            out.append(f"{s.name} leader hint {hint!r} != actual leader "
                       f"{leaders[0]!r}")
    return out


def alloc_coherence(snap) -> List[str]:
    out = []
    status_by_id: Dict[str, Tuple[str, str]] = {}

    def see(alloc, via: str) -> None:
        cur = (alloc.desired_status, alloc.client_status)
        prev = status_by_id.setdefault(alloc.id, cur)
        if prev != cur:
            out.append(
                f"alloc {alloc.id[:8]} is {prev} under one index but "
                f"{cur} via {via} — an alloc must never be e.g. both "
                "running and lost in the state store")

    for j in snap.jobs():
        group_count = {tg.name: tg.count for tg in j.task_groups}
        live: Dict[str, int] = {}
        for a in snap.allocs_by_job(j.namespace, j.id):
            see(a, "allocs_by_job")
            if not a.terminal_status():
                live[a.task_group] = live.get(a.task_group, 0) + 1
        for tg, n in live.items():
            want = group_count.get(tg)
            if want is not None and j.type != "system" and n > want:
                out.append(
                    f"job {j.id} group {tg} has {n} live allocs for "
                    f"desired count {want} (over-placement)")
    for n in snap.nodes():
        for a in snap.allocs_by_node(n.id):
            see(a, "allocs_by_node")
    return out


def check_all(*, samples, applied, origins, servers, snap,
              installs=None) -> List[str]:
    """Every invariant over one scenario's observations; the runner
    stamps the combined verdict into the canonical trace.  `installs`
    maps server -> [(snap_index, snap_term)] snapshot installs observed
    via RaftNode.install_observer (a lagging follower catching up by
    snapshot legitimately skips per-entry observation)."""
    live = [s.name for s in servers]
    out: List[str] = []
    out += single_leader_per_term(samples)
    out += log_consistency(applied, installs)
    out += committed_entries_survive(samples, applied, live, installs)
    out += no_deposed_commit(applied, origins, samples)
    out += membership_converged(servers)
    out += leadership_converged(servers)
    out += alloc_coherence(snap)
    return out
