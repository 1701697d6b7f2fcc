"""The port's chaos traces, invariants and named scenarios
(nomad_tpu_torch/chaos/{trace,invariants,scenarios}.py) against the
reference's (nomad_tpu/chaos/) on the CPU.

Tolerance: exact.  Fed the same events, both packages' traces serialize
to the same canonical bytes and digest and rebuild the same schedule;
both fingerprint equal stores alike; every invariant check returns the
same violations for the same observation lists; every scenario expands
to the same schedule at seeds 0-4.  The port's one difference, the
`device` its scenario servers place on, is held by a test of its own.

The whole scenarios (three servers on a simulated network and a virtual
clock, paced against the wall) are `slow`, as in the reference
(tests/test_chaos.py): each named scenario at seed 0 through both
packages, with its canonical trace digest and state fingerprint equal.
A run that held every safety invariant and missed only the liveness half
earns one retry, the reference's own discipline (`_liveness_only`)."""

import json
from types import SimpleNamespace

import pytest

from torch_parity import PACKAGES, one_device, pkg  # noqa: F401

PORT, REF = "nomad_tpu_torch", "nomad_tpu"


def both(fn):
    """fn(package name) for each package; asserts the two results equal
    and returns the port's."""
    out = [fn(name) for name in PACKAGES]
    assert out[1] == out[0]
    return out[1]


# --------------------------------------------------------------- traces


def _events(tr):
    tr.record(3.0, "partition", a=["@leader"], b=["@others"],
              bidirectional=True)
    tr.record(0.5, "workload", op="register_node", node="n0")
    tr.record(1.25, "set_latency", src="cs0", dst="cs1", lo=0.002,
              hi=0.02)
    tr.debug(1.1, "msg_dropped", src="s1", dst="s2")
    tr.record(7.0, "heal")
    tr.record(7.0, "crash", node=["@leader"])
    tr.record(12.0, "verdict", ok=True, violations=[])
    tr.record(12.0, "fingerprint", sha256="ab")
    tr.record(12.5, "slo", healthy=True, rules=[("a", True)],
              tags={"z", "y"}, ratio=1 / 3)


def test_trace_bytes_digest_and_schedule_equal_reference():
    def run(name):
        trace = pkg(name, "chaos.trace")
        tr = trace.Trace()
        _events(tr)
        return (tr.canonical_lines(), tr.canonical_bytes(), tr.digest(),
                trace.schedule_from_trace(tr),
                sorted(trace.SCHEDULE_KINDS))
    lines, raw, digest, sched, kinds = both(run)
    assert [e["kind"] for e in sched] == ["workload", "set_latency",
                                         "partition", "crash", "heal"]
    assert not any(ln.startswith("msg_dropped") for ln in lines)
    assert len(digest) == 64 and raw.endswith(b"\n")


def test_canon_equal_reference():
    value = {"f": 0.1 + 0.2, "s": {3, 1, 2}, "t": (1, 2.5),
             3: [{"x": frozenset({"b", "a"})}], "n": None}
    got = both(lambda name: json.dumps(
        pkg(name, "chaos.trace")._canon(value), sort_keys=True))
    assert '"0.300000"' in got


def _store(name, n_allocs=3, node_for=lambda k: k % 2, stop=False,
           statuses=("running", "pending", "complete", "lost")):
    """A store with explicit ids: two nodes, a service job (count 2) and
    `n_allocs` allocs cycling through `statuses`."""
    mock = pkg(name, "mock")
    s = pkg(name, "state").StateStore()
    nodes = [mock.node(id=f"fp-node-{i}", name=f"fp-n{i}")
             for i in range(2)]
    s.upsert_nodes(nodes)
    job = mock.job(id="fp-job")
    job.task_groups[0].count = 2
    job.stop = stop
    s.upsert_job(job)
    for k in range(n_allocs):
        a = mock.alloc()
        a.id = f"fp-alloc-{k}"
        a.job_id = job.id
        a.namespace = job.namespace
        a.task_group = job.task_groups[0].name
        a.node_id = nodes[node_for(k)].id
        a.client_status = statuses[k % len(statuses)]
        s.upsert_allocs([a])
    return s.snapshot()


@pytest.mark.parametrize("case", [
    dict(), dict(n_allocs=5), dict(node_for=lambda k: 0),
    dict(stop=True), dict(statuses=("running",), n_allocs=4)])
def test_state_fingerprint_equal_reference(case):
    def run(name):
        trace = pkg(name, "chaos.trace")
        snap = _store(name, **case)
        names = {"fp-node-0": "alpha"}
        return (trace.state_fingerprint(snap),
                trace.state_fingerprint(snap, node_names=names))
    a, b = both(run)
    assert a != b


# ----------------------------------------------------------- invariants


SAMPLES = [
    {"at": 0.1, "server": "cs0", "role": "leader", "term": 1,
     "commit_index": 3, "applied": 3},
    {"at": 0.1, "server": "cs1", "role": "follower", "term": 1,
     "commit_index": 3, "applied": 2},
    {"at": 0.2, "server": "cs1", "role": "leader", "term": 1,
     "commit_index": 4, "applied": 4},
    {"at": 0.3, "server": "cs2", "role": "leader", "term": 2,
     "commit_index": 6, "applied": 5},
]
APPLIED = {
    "cs0": [(1, 1, "d1", "noop"), (2, 1, "d2", "upsert_node"),
            (3, 1, "d3", "upsert_job"), (4, 1, "d4", "upsert_evals")],
    "cs1": [(1, 1, "d1", "noop"), (2, 1, "d2", "upsert_node"),
            (3, 1, "dX", "upsert_job"), (5, 2, "d5", "upsert_job")],
    "cs2": [(1, 1, "d1", "noop"), (4, 1, "d4", "upsert_evals"),
            (5, 2, "d5", "upsert_job"), (6, 2, "d6", "plan")],
}
INSTALLS = {"cs2": [(3, 1)], "cs1": [(2, 1)]}
ORIGINS = [
    {"server": "cs0", "index": 1, "term": 1, "digest": "d1",
     "method": "noop", "at": 0.0},
    {"server": "cs0", "index": 2, "term": 1, "digest": "d2",
     "method": "upsert_node", "at": 0.0},
    {"server": "cs0", "index": 3, "term": 1, "digest": "d3",
     "method": "upsert_job", "at": 0.0},
    {"server": "cs1", "index": 4, "term": 1, "digest": "d4",
     "method": "upsert_evals", "at": 0.2},
    {"server": "cs0", "index": 4, "term": 1, "digest": "d4",
     "method": "upsert_evals", "at": 0.2},
    {"server": "cs2", "index": 5, "term": 2, "digest": "d5",
     "method": "upsert_job", "at": 0.3},
]


def _servers(leaders, hints, alive):
    return [SimpleNamespace(
        name=n,
        raft=SimpleNamespace(is_leader=lambda n=n: n in leaders,
                             leader_hint=lambda n=n: hints[n]),
        gossip=SimpleNamespace(alive_members=lambda n=n: list(alive[n])))
        for n in ("cs0", "cs1", "cs2")]


SERVER_CASES = [
    (["cs0"], {"cs0": "cs0", "cs1": "cs0", "cs2": "cs0"},
     {n: ["cs0", "cs1", "cs2"] for n in ("cs0", "cs1", "cs2")}),
    (["cs0", "cs2"], {"cs0": "cs0", "cs1": "", "cs2": "cs2"},
     {"cs0": ["cs0", "cs1"], "cs1": ["cs1", "cs2", "cs0"],
      "cs2": ["cs2"]}),
    (["cs1"], {"cs0": "cs1", "cs1": "cs1", "cs2": "cs0"},
     {"cs0": ["cs2", "cs1", "cs0"], "cs1": ["cs0", "cs1", "cs2"],
      "cs2": ["cs1", "cs0", "cs2", "cs3"]}),
    ([], {"cs0": "", "cs1": "", "cs2": ""},
     {n: [] for n in ("cs0", "cs1", "cs2")}),
]


@pytest.mark.parametrize("clean", [False, True])
def test_log_invariants_equal_reference(clean):
    """single_leader_per_term, log_consistency, committed_entries_survive
    and no_deposed_commit on the same samples, applied entries, installs
    and origins: a clean cluster's (a prefix of each list that holds)
    and one that breaks each of them."""
    samples = SAMPLES[:1] if clean else SAMPLES
    applied = ({"cs0": APPLIED["cs0"][:3]} if clean else APPLIED)
    origins = ORIGINS[:3] if clean else ORIGINS
    live = sorted(applied) if clean else ["cs0", "cs1", "cs2"]

    def run(name):
        inv = pkg(name, "chaos.invariants")
        return [inv.single_leader_per_term(samples),
                inv.log_consistency(applied),
                inv.log_consistency(applied, INSTALLS),
                inv.committed_entries_survive(samples, applied,
                                              sorted(applied)),
                inv.committed_entries_survive(samples, applied, live,
                                              INSTALLS),
                inv.no_deposed_commit(applied, origins, samples)]
    got = both(run)
    if clean:
        assert got == [[]] * 6
    else:
        assert all(got[i] for i in (0, 1, 3, 5)), got


@pytest.mark.parametrize("case", range(len(SERVER_CASES)))
def test_server_invariants_equal_reference(case):
    leaders, hints, alive = SERVER_CASES[case]

    def run(name):
        inv = pkg(name, "chaos.invariants")
        servers = _servers(leaders, hints, alive)
        return (inv.membership_converged(servers),
                inv.leadership_converged(servers))
    got = both(run)
    assert (got == ([], [])) == (case == 0)


@pytest.mark.parametrize("case", [
    dict(n_allocs=2, statuses=("running",)),
    dict(n_allocs=4, statuses=("running", "pending")),
    dict(n_allocs=6)])
def test_alloc_coherence_and_check_all_equal_reference(case):
    leaders, hints, alive = SERVER_CASES[1]

    def run(name):
        inv = pkg(name, "chaos.invariants")
        snap = _store(name, **case)
        return (inv.alloc_coherence(snap),
                inv.check_all(samples=SAMPLES, applied=APPLIED,
                              origins=ORIGINS,
                              servers=_servers(leaders, hints, alive),
                              snap=snap, installs=INSTALLS))
    coherence, verdict = both(run)
    assert bool(coherence) == (case["n_allocs"] > 2)
    assert verdict


# ------------------------------------------------------------ scenarios


def test_scenario_names_and_constants_equal_reference():
    def run(name):
        sc = pkg(name, "chaos.scenarios")
        return (sorted(sc.SCENARIOS), sc._STEP_V, sc._STEP_REAL,
                sc._SAMPLE_EVERY_V, sc._CONVERGE_BUDGET_V,
                sc._CONVERGE_CHECK_V, sc._RAFT)
    assert len(both(run)[0]) == 5


@pytest.mark.parametrize("scenario", sorted(
    pkg(REF, "chaos.scenarios").SCENARIOS))
def test_schedule_expansion_equal_reference(scenario):
    """Each scenario's spec (servers, duration, TTL, expectations and the
    expanded schedule) at seeds 0-4, and the replay path: a recorded
    schedule in place of the seed's."""
    for seed in range(5):
        spec = both(lambda name: pkg(name, "chaos.scenarios")
                    .ScenarioRunner(scenario, seed=seed).spec)
        assert spec["schedule"]
    replay = [dict(e, at=e["at"] + 0.5) for e in spec["schedule"]]
    both(lambda name: pkg(name, "chaos.scenarios").ScenarioRunner(
        scenario, seed=9, schedule=replay).spec)


def test_unknown_scenario_raises_alike():
    def run(name):
        with pytest.raises(KeyError) as exc:
            pkg(name, "chaos.scenarios").ScenarioRunner("nosuch")
        return str(exc.value)
    both(run)


class _Stop(Exception):
    pass


def test_scenario_servers_get_the_device(monkeypatch):
    """The port's difference: `run_scenario(..., device=...)` passes the
    device to every ClusterServer it boots; the default is None, which
    the port's Server takes as CUDA."""
    sc = pkg(PORT, "chaos.scenarios")
    seen = []

    def fake(name, **kw):
        seen.append((name, kw["device"]))
        if len(seen) == 3:
            raise _Stop
        return SimpleNamespace(name=name)

    monkeypatch.setattr(sc, "ClusterServer", fake)
    with pytest.raises(_Stop):
        sc.run_scenario("leader_partition", seed=0, device="cpu")
    assert seen == [(f"cs{i}", "cpu") for i in range(3)]
    assert sc.ScenarioRunner("split_brain_attempt").device is None


def test_scenario_default_device_needs_cuda():
    import threading

    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present; chip_smoke.py's scenarios phase "
                    "runs them there")
    threads = threading.active_count()
    with pytest.raises(RuntimeError, match="CUDA"):
        pkg(PORT, "chaos.scenarios").run_scenario("leader_partition")
    assert threading.active_count() == threads


def _liveness_only(result) -> bool:
    return (not result.ok
            and all(v.startswith("cluster failed to converge")
                    or v.startswith("workload op failed")
                    for v in result.violations))


def _run_scenario(name, scenario, seed):
    kw = {"device": "cpu"} if name == PORT else {}
    run = pkg(name, "chaos.scenarios").run_scenario
    r = run(scenario, seed=seed, **kw)
    if _liveness_only(r):
        r = run(scenario, seed=seed, **kw)
    return r


@pytest.mark.slow
@pytest.mark.parametrize("scenario", sorted(
    pkg(REF, "chaos.scenarios").SCENARIOS))
def test_whole_scenario_equals_reference(scenario, one_device):
    """The whole scenario at seed 0 through both packages: both green,
    the canonical trace bytes, their digest and the converged state's
    fingerprint equal."""
    runs = {name: _run_scenario(name, scenario, 0) for name in PACKAGES}
    for name, r in runs.items():
        assert r.ok, (name, r.violations)
    port, ref = runs[PORT], runs[REF]
    assert port.trace.canonical_bytes() == ref.trace.canonical_bytes()
    assert port.trace.digest() == ref.trace.digest()
    assert port.fingerprint == ref.fingerprint
    assert port.schedule == ref.schedule


def test_final_sample_waits_for_the_leaders_commit(monkeypatch):
    """The port's repair of the runner's final check: a write that
    commits on the leader just as convergence holds (here one node
    registration, the moment the live allocs are there, with one
    follower's link a virtual step slow) is applied by every server
    before the final sample, so no committed entry reads as lost.  The
    write goes through the port's `invariants.membership_converged`,
    which the runner calls while it waits for convergence; the final
    sample is the last of the samples the runner hands `check_all`."""
    import random
    import threading

    sc = pkg(PORT, "chaos.scenarios")
    mock = pkg(PORT, "mock")
    inv = sc.invariants
    spec = sc.SCENARIOS["leader_partition"](random.Random(0))
    runner = threading.current_thread()
    wrote, checked = [], []
    membership, check_all = inv.membership_converged, inv.check_all

    def live_as_expected(snap):
        return all(
            sum(not a.terminal_status()
                for a in snap.allocs_by_job("default", job)) == want
            for job, want in spec["expect_live"].items())

    def arm(servers):
        """Once membership holds, make the leader's next snapshot on the
        runner's thread (converged()'s, after its applied-lag check)
        write one node first if the allocs are then all live."""
        leader = next((s for s in servers if s.raft.is_leader()), None)
        if leader is None or "snapshot" in vars(leader.state):
            return
        slow = next(s for s in servers if s is not leader)
        real = leader.state.snapshot

        def snapshot():
            if (not wrote and threading.current_thread() is runner
                    and live_as_expected(real())):
                leader.transport.net.set_latency(
                    leader.name, slow.name, 0.02, 0.02,
                    bidirectional=False)
                leader.register_node(mock.node(name="late-write"))
                wrote.append(leader.raft.commit_index)
            return real()

        leader.state.snapshot = snapshot

    def membership_then_write(servers):
        why = membership(servers)
        if not why and not wrote and threading.current_thread() is runner:
            arm(servers)
        return why

    def check_all_seen(**kw):
        checked.append(list(kw["samples"]))
        return check_all(**kw)

    monkeypatch.setattr(inv, "membership_converged", membership_then_write)
    monkeypatch.setattr(inv, "check_all", check_all_seen)
    r = sc.run_scenario("leader_partition", seed=0, device="cpu")
    assert wrote, "the write never went in"
    assert not [v for v in r.violations if "committed entry lost" in v]
    assert r.ok, r.violations
    final = checked[-1][-3:]
    assert {row["server"] for row in final} == {"cs0", "cs1", "cs2"}
    commit = max(row["commit_index"] for row in final)
    assert commit >= wrote[0]
    assert all(row["applied"] >= commit for row in final), final
