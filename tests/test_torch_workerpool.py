"""The port's multi-process worker plane (nomad_tpu_torch/core/workerpool.py)
against the reference's (tests/test_workerpool.py) on the CPU.

The reference's fast tests are mirrored, each run through both packages
in this process with the results compared: the state export and its
delta bootstrap, an export's wire round trip (across the packages too),
the submission queue, the sharded dynamic-port scan, the replica's
attempt limits, the packer's 20-bit row cap and the traffic knobs of
`chaos.traffic` (networked fraction and node classes).

The port's own difference, the child's `_RemoteEngine`: over a loopback
channel (two threads on a `multiprocessing.Pipe`, no spawn) its
forwarded `place` is held against a direct `engine.place` on the
parent's snapshot and against the reference's `engine.place` on the
same cluster.  Three small spawn tests (one child on 20 nodes; two
children in three zoned waves on 500 nodes, refuting nothing; a child
killed and respawned, the Server still stopping) keep the pool itself
in tier 1; the reference's spawn tests have port twins
marked `slow`, as the reference's are."""

import multiprocessing as mp
import os
import socket
import threading
import time

import numpy as np
import pytest

from torch_parity import PACKAGES, _metric, add_zoned_cluster, engine, pkg

PORT = "nomad_tpu_torch"
REF = "nomad_tpu"


@pytest.fixture(autouse=True)
def _reset_port_scan():
    """Both packages' scan bases back at their default after each test."""
    yield
    for name in PACKAGES:
        structs = pkg(name, "structs.structs")
        pkg(name, "structs.funcs").set_dynamic_port_scan_base(
            structs.MIN_DYNAMIC_PORT, rotate=False)


# =====================================================================
# state export / delta round-trip
# =====================================================================


def _seeded_store(name):
    """tests/test_workerpool.py's store with explicit ids: 4 nodes, a
    job and 6 allocs."""
    mock = pkg(name, "mock")
    s = pkg(name, "state").StateStore()
    nodes = [mock.node(id=f"node-{i}", name=f"n{i}") for i in range(4)]
    s.upsert_nodes(nodes)
    job = mock.job(id="job-0")
    s.upsert_job(job)
    allocs = [mock.alloc(id=f"alloc-{i}", node_id=nodes[i % 4].id,
                         job=job, job_id=job.id)
              for i in range(6)]
    s.upsert_allocs(allocs)
    return s, nodes, job, allocs


def _replica_view(r):
    snap = r.snapshot()
    return (r.latest_index(),
            sorted((n.id, n.status) for n in snap.nodes()),
            sorted((a.id, a.node_id, a.client_status,
                    a.job is not None)
                   for n in snap.nodes() for a in snap.allocs_by_node(n.id)))


def _both(fn):
    out = [fn(name) for name in PACKAGES]
    assert out[1] == out[0]
    return out[1]


def test_full_export_bootstraps_replica():
    def run(name):
        s, nodes, _, _ = _seeded_store(name)
        s._journal_floor = s.latest_index()
        export = s.export_since(0)
        r = pkg(name, "state").StateStore()
        r.apply_export(export)
        assert r.latest_index() == s.latest_index()
        return export["kind"], _replica_view(r)
    kind, view = _both(run)
    assert kind == "full" and len(view[1]) == 4 and len(view[2]) == 6


def test_delta_ships_only_dirtied_keys():
    def run(name):
        s, nodes, job, allocs = _seeded_store(name)
        r = pkg(name, "state").StateStore()
        r.apply_export(s.export_since(0))
        since = r.latest_index()
        n0 = nodes[0].copy()
        n0.status = "down"
        s.upsert_node(n0)
        a0 = allocs[0].copy_skip_job()
        a0.job = job
        a0.client_status = "running"
        s.upsert_allocs([a0])
        export = s.export_since(since)
        shipped = ({n.id for n in export["upserts"]["nodes"]},
                   {a.id for a in export["upserts"]["allocs"]})
        r.apply_export(export)
        assert r.latest_index() == s.latest_index()
        return export["kind"], shipped, _replica_view(r)
    kind, shipped, view = _both(run)
    assert kind == "delta" and shipped == ({"node-0"}, {"alloc-0"})
    assert ("node-0", "down") in view[1]
    # the replica re-attaches the embedded job pointer
    assert ("alloc-0", "node-0", "running", True) in view[2]


def test_delta_carries_deletions_as_tombstones():
    def run(name):
        s, nodes, _, _ = _seeded_store(name)
        r = pkg(name, "state").StateStore()
        r.apply_export(s.export_since(0))
        since = r.latest_index()
        s.delete_node(nodes[3].id)
        export = s.export_since(since)
        r.apply_export(export)
        return (export["kind"], [tuple(d) for d in export["deletes"]],
                r.node_by_id(nodes[3].id) is None)
    kind, deletes, gone = _both(run)
    assert kind == "delta" and ("nodes", "node-3") in deletes and gone


def test_fresh_replica_bootstraps_via_delta():
    def run(name):
        s, _, _, _ = _seeded_store(name)
        export = s.export_since(0)
        r = pkg(name, "state").StateStore()
        r.apply_export(export)
        assert r.latest_index() == s.latest_index()
        return export["kind"], _replica_view(r)
    kind, view = _both(run)
    assert kind == "delta" and len(view[1]) == 4


def test_empty_export_when_caught_up():
    def run(name):
        s, _, _, _ = _seeded_store(name)
        export = s.export_since(s.latest_index())
        return export["kind"], export["index"], export["fence"]
    assert _both(run)[0] == "empty"


def test_codec_decode_plans_resolve_hints_once(monkeypatch):
    """The port's codec keeps each dataclass's decode plan: a full
    export's restore (a child's bootstrap past the journal floor)
    resolves each class's type hints once, and decodes what the
    reference decodes."""
    codec = pkg(PORT, "structs.codec")
    codec._decode_plan.cache_clear()
    seen = []
    real = codec.get_type_hints
    monkeypatch.setattr(codec, "get_type_hints",
                        lambda tp: seen.append(tp) or real(tp))
    views = []
    for name in PACKAGES:
        s, _, _, _ = _seeded_store(name)
        s._journal_floor = s.latest_index()
        r = pkg(name, "state").StateStore()
        r.apply_export(s.export_since(0))
        views.append(_replica_view(r))
    assert views[1] == views[0]
    assert seen and len(seen) == len(set(seen))


def test_export_survives_wire_roundtrip():
    """An export packed by either package's codec decodes in both (the
    class name keys the frame), and every replica reads the same."""
    for name in PACKAGES:
        pkg(name, "core.workerpool")._ensure_wire_types()
    views = []
    for src in PACKAGES:
        s, _, _, _ = _seeded_store(src)
        blob = pkg(src, "core.wire").packb(s.export_since(0))
        for dst in PACKAGES:
            r = pkg(dst, "state").StateStore()
            r.apply_export(pkg(dst, "core.wire").unpackb(blob))
            views.append(_replica_view(r))
    assert all(v == views[0] for v in views)
    assert len(views[0][1]) == 4 and len(views[0][2]) == 6


# =====================================================================
# device submission front-end
# =====================================================================


class _SlowExecutor:
    """Records overlap: submissions must never interleave."""

    def __init__(self):
        self.inside = 0
        self.max_inside = 0
        self.calls = 0
        self._guard = threading.Lock()
        self.engine = self

    def _enter(self):
        with self._guard:
            self.inside += 1
            self.max_inside = max(self.max_inside, self.inside)
        time.sleep(0.01)
        with self._guard:
            self.inside -= 1
            self.calls += 1

    def dispatch_batch(self, snapshot, items, seed=0, used0_dev=None,
                       masked_node_ids=None):
        self._enter()
        return {"ok": True}

    def place(self, *args, **kwargs):
        self._enter()
        return []


def _race(front, calls):
    threads = [threading.Thread(target=call, args=(front,))
               for call in calls]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)


def test_submission_queue_serializes_and_meters_queue_wait():
    out = []
    for name in PACKAGES:
        front = pkg(name, "ops.executor").SubmissionFrontEnd(
            _SlowExecutor())
        _race(front, [lambda f: f.dispatch_batch(None, [])] * 4)
        assert front.stats["queue_waits"] >= 1
        assert front.stats["queue_wait_s"] > 0.0
        out.append((front.executor.calls, front.executor.max_inside,
                    front.stats["submits"]))
    assert out[1] == out[0] == (4, 1, 4)


def test_submission_queue_serializes_forwarded_places_with_waves():
    """The port's `place` op queues with the waves under the same lock."""
    front = pkg(PORT, "ops.executor").SubmissionFrontEnd(_SlowExecutor())
    _race(front, [lambda f: f.dispatch_batch(None, []),
                  lambda f: f.place(None, None, [], [])] * 3)
    assert front.executor.calls == 6 and front.executor.max_inside == 1
    assert front.stats["submits"] == 6


# =====================================================================
# sharded dynamic-port scan
# =====================================================================


def _ports(fn):
    """fn(name, funcs, structs) through both packages, compared."""
    return _both(lambda name: fn(name, pkg(name, "structs.funcs"),
                                 pkg(name, "structs.structs")))


def test_default_base_is_bit_identical_ascending():
    got = _ports(lambda n, f, s: f.NetworkIndex().claim_dynamic_block(3))
    assert got == [20000, 20001, 20002]


def test_offset_base_starts_mid_range_and_wraps():
    def run(name, f, s):
        f.set_dynamic_port_scan_base(s.MAX_DYNAMIC_PORT - 1)
        return f.NetworkIndex().claim_dynamic_block(4)
    got = _ports(run)
    assert got[2:] == [20000, 20001] and got[1] == got[0] + 1


def test_assign_ports_respects_base():
    def run(name, f, s):
        f.set_dynamic_port_scan_base(25000)
        ask = [s.NetworkResource(dynamic_ports=[s.Port(label="http")])]
        return f.NetworkIndex().assign_ports(ask)
    ports, dim = _ports(run)
    assert dim == "" and ports["http"] == 25000


def test_disjoint_shards_never_collide():
    def run(name, f, s):
        f.set_dynamic_port_scan_base(20000)
        a = f.NetworkIndex().claim_dynamic_block(16)
        f.set_dynamic_port_scan_base(26000)
        return a, f.NetworkIndex().claim_dynamic_block(16)
    a, b = _ports(run)
    assert not set(a) & set(b)


def test_rotating_mode_advances_past_commits():
    def run(name, f, s):
        f.set_dynamic_port_scan_base(24000, rotate=True)
        first = f.NetworkIndex().claim_dynamic_block(4)
        return first, f.NetworkIndex().claim_dynamic_block(4)
    first, second = _ports(run)
    assert first[0] == 24000 and second[0] == 24004
    assert not set(first) & set(second)


def test_non_rotating_mode_base_is_stable():
    def run(name, f, s):
        f.set_dynamic_port_scan_base(24000, rotate=False)
        f.NetworkIndex().claim_dynamic_block(4)
        return f.NetworkIndex().claim_dynamic_block(1)
    assert _ports(run) == [24000]


def test_commit_advances_in_rotating_mode():
    def run(name, f, s):
        f.set_dynamic_port_scan_base(24000, rotate=True)
        ni = f.NetworkIndex()
        ports, _ = ni.assign_ports(
            [s.NetworkResource(dynamic_ports=[s.Port(label="http")])])
        ni.commit(ports)
        return f.NetworkIndex().claim_dynamic_block(1)
    assert _ports(run) == [24001]


def test_dyn_free_count_unaffected_by_base():
    def run(name, f, s):
        f.set_dynamic_port_scan_base(29000)
        ni = f.NetworkIndex()
        free0 = ni.dyn_free_count()
        ni.claim_dynamic_block(5)
        return free0, ni.dyn_free_count()
    free0, free1 = _ports(run)
    structs = pkg(PORT, "structs.structs")
    assert free0 == structs.MAX_DYNAMIC_PORT - structs.MIN_DYNAMIC_PORT + 1
    assert free1 == free0 - 5


# =====================================================================
# replica-staleness knobs
# =====================================================================


def test_thread_worker_keeps_reference_attempt_limits():
    def run(name):
        kw = {"device": "cpu"} if name == PORT else {"mesh": False}
        s = pkg(name, "core.server").Server(dev_mode=True, num_workers=1,
                                            profile_hz=0, **kw)
        s.establish_leadership()
        try:
            generic = pkg(name, "scheduler.generic")
            worker = s.workers[0]
            sched = generic.GenericScheduler(s.state.snapshot(), worker,
                                             is_batch=True, engine=s.engine)
            return (getattr(worker, "schedule_attempt_boost", 0),
                    sched.max_attempts, generic.MAX_BATCH_ATTEMPTS)
        finally:
            s.shutdown()
    boost, attempts, limit = _both(run)
    assert boost == 0 and attempts == limit


def test_child_server_shim_boosts_attempts():
    boost = _both(lambda name: pkg(name, "core.workerpool")
                  ._ChildServer.schedule_attempt_boost)
    assert boost > 0


# =====================================================================
# packed-fill cap (pack/packer.py)
# =====================================================================


def test_cap_is_the_20_bit_row_limit():
    assert _both(lambda name: pkg(name, "pack.packer")
                 .PACKED_FILL_CAP) == 1 << 20


def test_oversized_cluster_raises_named_error(monkeypatch):
    def run(name):
        packer_mod = pkg(name, "pack.packer")
        monkeypatch.setattr(packer_mod, "PACKED_FILL_CAP", 4)
        store = pkg(name, "state").StateStore()
        mock = pkg(name, "mock")
        store.upsert_nodes([mock.node(id=f"node-{i}") for i in range(4)])
        with pytest.raises(ValueError) as exc:
            packer_mod.ClusterPacker().build(store.snapshot())
        return "PACKED_FILL_CAP" in str(exc.value)
    assert _both(run)


# =====================================================================
# traffic knobs (chaos/traffic.py)
# =====================================================================


def test_networked_fraction_and_classes_are_deterministic():
    def run(name):
        traffic = pkg(name, "chaos.traffic")
        prof = traffic.TrafficProfile(hours=0.5, networked_fraction=0.7,
                                      node_classes=("edge", "core"))
        a = traffic.generate_schedule(1234, prof)
        assert a == traffic.generate_schedule(1234, prof)
        ported = [e for e in a if e.get("ports")]
        assert ported, "0.7 networked_fraction produced no port asks"
        assert all(e.get("node_class") in ("edge", "core")
                   for e in ported)
        nodes = traffic.fleet(1234, prof)
        assert {n["node_class"] for n in nodes} == {"edge", "core"}
        return a, nodes
    _both(run)


def test_zero_knobs_do_not_consume_rng():
    def run(name):
        traffic = pkg(name, "chaos.traffic")
        base = traffic.TrafficProfile(hours=0.5)
        off = traffic.TrafficProfile(hours=0.5, networked_fraction=0.0,
                                     node_classes=())
        a = traffic.generate_schedule(77, base)
        assert a == traffic.generate_schedule(77, off)
        return a
    _both(run)


# =====================================================================
# the child's engine: `place` forwarded to the parent
# =====================================================================


def _device_nodes(name, state, n=4):
    """n nodes of dc1 with two fake GPUs each (ids gpu-node-i)."""
    mock = pkg(name, "mock")
    structs = pkg(name, "structs")
    nodes = []
    for i in range(n):
        nd = mock.node(id=f"gpu-node-{i}", name=f"gpu-node-{i}")
        nd.datacenter = "dc1"
        nd.resources.devices = [structs.NodeDeviceResource(
            vendor="acme", type="gpu", name="fake100",
            instance_ids=[f"g{i}-0", f"g{i}-1"])]
        nodes.append(nd)
    state.upsert_nodes(nodes)


def _job(name, case):
    """The loopback cases' jobs, alike in both packages."""
    mock = pkg(name, "mock")
    structs = pkg(name, "structs")
    job = mock.batch_job(id=f"job-{case}")
    job.datacenters = ["dc1", "dc2", "dc3"]
    tg = job.task_groups[0]
    tg.tasks[0].resources.cpu = 10
    tg.tasks[0].resources.memory_mb = 10
    if case == "spread":
        tg.count = 12
        job.spreads = [structs.Spread(attribute="${node.datacenter}",
                                      weight=100)]
    elif case == "bulk":
        tg.count = 200
    elif case == "device":
        tg.count = 3
        tg.tasks[0].resources.devices = [
            structs.RequestedDevice(name="gpu", count=1)]
    else:                                   # "stopped": frees a node
        tg.count = 5
        tg.tasks[0].resources.cpu = 3000
    return job


def _setup(name, state):
    add_zoned_cluster(name, state, n_nodes=60, n_zones=3)
    _device_nodes(name, state)
    mock = pkg(name, "mock")
    jobs = {c: _job(name, c) for c in ("spread", "bulk", "device",
                                       "stopped")}
    for job in jobs.values():
        state.upsert_job(job)
    # one running alloc of the stopped case's job, on node-00000
    held = mock.alloc(id="alloc-held", node_id="node-00000",
                      job=jobs["stopped"], job_id="job-stopped")
    held.resources.cpu = state.node_by_id("node-00000").resources.cpu
    state.upsert_allocs([held])
    return jobs


def _call(name, case, jobs, state):
    """(args, kwargs) of the case's engine.place."""
    ops = pkg(name, "ops.engine")
    job = jobs[case]
    tg = job.task_groups[0]
    kw = {"seed": 12345}
    reqs = [ops.PlacementRequest(tg_name=tg.name)] * tg.count
    if case == "bulk":
        reqs = None
        kw.update(bulk_api=True, block=(tg.name, tg.count))
    elif case == "device":
        in_use = pkg(name, "scheduler.device").InUseIndex()
        in_use.add("gpu-node-0", "acme/gpu/fake100", ["g0-0", "g0-1"])
        kw["device_in_use"] = in_use
    elif case == "stopped":
        kw["stopped_allocs"] = [state.snapshot().alloc_by_id("alloc-held")]
    return (job, job.task_groups, reqs), kw


def _decisions(out):
    """What must match: per decision node, score bits and metric; for
    bulk decisions the picks, the rounds and their metrics."""
    if hasattr(out, "picks"):
        return ("bulk", out.tg_name, np.asarray(out.picks).tolist(),
                [out.node_ids[p] if p >= 0 else None for p in out.picks],
                out.round_size, [_metric(m) for m in out.metrics],
                out.nodes_evaluated)
    return [(d.tg_name, d.node_id,
             np.float32(d.score).view(np.int32).item(), _metric(d.metric),
             sorted(a.id for a in d.evictions)) for d in out]


@pytest.fixture
def loopback():
    """A port Server in process mode (never started) whose pool serves
    one channel end on a thread; the other end is a child's
    `_Channel` and `_RemoteEngine`, in this process."""
    wp = pkg(PORT, "core.workerpool")
    s = pkg(PORT, "core.server").Server(
        dev_mode=False, worker_mode="process", num_workers=1,
        heartbeat_ttl=1e9, device="cpu", profile_hz=0)
    jobs = _setup(PORT, s.state)
    wp._ensure_wire_types()
    parent_end, child_end = mp.Pipe()
    child = s.worker_pool._children[0]
    child.conn = parent_end
    server_t = threading.Thread(target=s.worker_pool._serve, args=(child,),
                                daemon=True)
    server_t.start()
    chan = wp._Channel(child_end)
    remote = wp._RemoteEngine(chan, pkg(PORT, "pack.packer").ClusterPacker())
    try:
        yield s, jobs, remote
    finally:
        # EOF on both ends (a close would not wake the blocked readers)
        socket.socket(fileno=os.dup(child_end.fileno())).shutdown(
            socket.SHUT_RDWR)
        server_t.join(timeout=10)
        child_end.close()
        parent_end.close()
        s.shutdown()
    assert not server_t.is_alive() and chan.closed.wait(timeout=10)


@pytest.mark.parametrize("case", ["spread", "bulk", "device", "stopped"])
def test_forwarded_place_matches_parent_and_reference(case, loopback):
    """The child's forwarded place equals the parent engine's own call on
    the parent's snapshot and the reference's engine.place on the same
    cluster: picks, fill counts and metrics exactly, scores to the bit."""
    s, jobs, remote = loopback
    args, kw = _call(PORT, case, jobs, s.state)
    # the replica snapshot the child would pass (ignored by the parent)
    got = _decisions(remote.place(None, *args, **kw))
    assert s.worker_pool.stats["places"] == 1
    direct = _decisions(s.engine.place(s.state.snapshot(), *args, **kw))
    h = pkg(REF, "scheduler").Harness()
    h.engine = engine(REF)
    ref_jobs = _setup(REF, h.state)
    rargs, rkw = _call(REF, case, ref_jobs, h.state)
    want = _decisions(h.engine.place(h.state.snapshot(), *rargs, **rkw))
    assert got == direct
    assert got == want
    if case == "bulk":
        assert got[0] == "bulk" and min(got[2]) >= 0
    else:
        assert all(d[1] is not None for d in got)
    if case == "device":
        # gpu-node-0's two instances are taken in the plan
        assert "gpu-node-0" not in {d[1] for d in got}
    if case == "stopped":
        # the stopped alloc filled node-00000: freeing it changes what
        # the first placement sees
        kw.pop("stopped_allocs")
        held = _decisions(s.engine.place(s.state.snapshot(), *args, **kw))
        assert held[0][3][4] == got[0][3][4] + 1     # nodes_exhausted


def test_child_engine_runs_no_device_work():
    """The documented difference: a child's engine has the packer and
    `place`, and every other device entry raises."""
    wp = pkg(PORT, "core.workerpool")
    remote = wp._RemoteEngine(None, pkg(PORT, "pack.packer").ClusterPacker())
    for entry in ("dispatch_batch", "collect_batch", "place_batch",
                  "build_multi_inputs", "job_masks"):
        with pytest.raises(RuntimeError, match="runs in the parent"):
            getattr(remote, entry)(None, [])
    with pytest.raises(RuntimeError, match="node tensors"):
        remote.place(None, None, [], [], tensors=object())
    assert "_RemoteEngine" in wp.__doc__


# =====================================================================
# spawn: real worker processes
# =====================================================================


def _pool_cluster(name, n):
    mock = pkg(name, "mock")
    nodes = []
    for i in range(n):
        nd = mock.node(id=f"pool-node-{i:03d}", name=f"pool-n{i}")
        nd.datacenter = f"dc{i % 3 + 1}"
        nodes.append(nd)
    return nodes


def _batch_job(name, count, net=False, spread=False):
    mock = pkg(name, "mock")
    structs = pkg(name, "structs")
    job = mock.batch_job()
    job.datacenters = ["dc1", "dc2", "dc3"]
    tg = job.task_groups[0]
    tg.count = count
    tg.tasks[0].resources.cpu = 10
    tg.tasks[0].resources.memory_mb = 10
    if net:
        tg.tasks[0].resources.networks = [
            structs.NetworkResource(dynamic_ports=[structs.Port(
                label="http")])]
    if spread:
        job.spreads = [structs.Spread(attribute="${node.datacenter}",
                                      weight=100)]
    return job


def _drain(server, evs, deadline_s=90.0):
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        sts = [getattr(server.state.eval_by_id(e.id), "status", None)
               for e in evs]
        if all(st in ("complete", "failed", "canceled") for st in sts):
            return sts
        time.sleep(0.05)
    return [getattr(server.state.eval_by_id(e.id), "status", None)
            for e in evs]


def _live_allocs(server):
    snap = server.state.snapshot()
    return [a for n in snap.nodes() for a in snap.allocs_by_node(n.id)
            if not a.terminal_status()]


def _pool_server(workers=2, batch=8):
    s = pkg(PORT, "core.server").Server(
        dev_mode=False, num_workers=workers, eval_batch=batch,
        heartbeat_ttl=1e9, nack_timeout=600.0, worker_mode="process",
        device="cpu", profile_hz=0)
    s.establish_leadership()
    return s


def _children_report(pool, deadline_s=30.0):
    """pool_stats once every child has reported (its report cadence is
    0.5 s)."""
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        stats = pool.pool_stats()
        if all("cuda_initialized" in c for c in stats["children"]):
            return stats
        time.sleep(0.1)
    raise AssertionError(f"children did not report: {stats}")


def test_one_child_places_batch_and_spread_evals():
    """One spawned child, 20 nodes: a batch of three evals goes through
    the remote executor (one dispatch), a spread eval through the
    forwarded place; every placement lands once, the child never
    initializes CUDA nor launches anything, and no child outlives the
    Server's shutdown."""
    s = _pool_server(workers=1)
    procs = []
    try:
        s.state.upsert_nodes(_pool_cluster(PORT, 20))
        jobs = [_batch_job(PORT, 4) for _ in range(3)]
        jobs.append(_batch_job(PORT, 6, spread=True))
        evs = [s.register_job(j, now=time.time()) for j in jobs]
        s.start_scheduling()
        sts = _drain(s, evs)
        s.stop_scheduling()
        assert sts == ["complete"] * len(evs), sts
        allocs = _live_allocs(s)
        assert len(allocs) == 18 and len({a.id for a in allocs}) == 18
        spread = [a for a in allocs if a.job_id == jobs[3].id]
        assert len({s.state.node_by_id(a.node_id).datacenter
                    for a in spread}) == 3
        stats = _children_report(s.worker_pool)
        assert stats["alive"] == 1 and stats["places"] >= 1
        assert stats["dispatches"] + stats["places"] >= 2
        (child,) = stats["children"]
        assert child["cuda_initialized"] is False
        assert child["launches"] == 0 and child["eager_ops"] == 0
        assert child["bootstrap_s"] > 0 and child["bootstrap_bytes"] > 0
        procs = [c.proc for c in s.worker_pool._children]
    finally:
        s.shutdown()
    assert procs and not any(p.is_alive() for p in procs)


def test_zoned_waves_across_two_children_refute_nothing():
    """Config 5's shape, small: zoned batch jobs in three waves through
    two children (the broker gives each a zone's evals), the later waves
    heavier, so that a node's usage decides where the next wave fits.
    A chain that one child retained after the other child's commits
    misses their usage; riding it into a zone the other child filled
    over-packs nodes the applier then refutes.  The executor drops
    such a chain, so no plan is refuted and every placement lands
    once."""
    mock = pkg(PORT, "mock")
    structs = pkg(PORT, "structs")
    s = _pool_server(workers=2, batch=40)
    try:
        add_zoned_cluster(PORT, s.state, n_nodes=500)
        placed = 0
        for wave, size in enumerate((100, 500, 500)):
            evs = []
            for i in range(40):
                job = mock.batch_job(id=f"wave{wave}-{i:02d}")
                job.datacenters = ["dc1", "dc2", "dc3"]
                tg = job.task_groups[0]
                tg.count = 26
                tg.tasks[0].resources.cpu = size
                tg.tasks[0].resources.memory_mb = size
                tg.volumes = {"data": structs.VolumeRequest(
                    name="data", type="csi", source=f"vol-zone{i % 5}",
                    read_only=True)}
                evs.append(s.register_job(job, now=time.time()))
            s.start_scheduling()
            sts = _drain(s, evs)
            s.stop_scheduling()
            assert sts == ["complete"] * len(evs), (wave, sts)
            placed += 40 * 26
            allocs = _live_allocs(s)
            assert len(allocs) == placed == len({a.id for a in allocs})
            assert s.plan_applier.stats["plans_refuted"] == 0, wave
        stats = s.worker_pool.pool_stats()
        assert stats["alive"] == 2 and stats["respawns"] == 0
        assert stats["places"] == 0
    finally:
        s.shutdown()


def test_child_killed_while_waiting_is_respawned_and_shutdown_returns():
    """A child killed while it waits on the pool's stop gate (where an
    idle child spends its time) is respawned, and the Server's
    stop_scheduling and shutdown still return: the gates hold no lock a
    dead child could keep (with the reference's multiprocessing Events
    the next set() waits for the dead sleeper forever)."""
    s = _pool_server(workers=1)
    done = threading.Event()
    try:
        s.state.upsert_nodes(_pool_cluster(PORT, 20))
        s.start_scheduling()
        pool = s.worker_pool
        _children_report(pool)
        time.sleep(1.0)
        victim = pool._children[0].proc
        victim.terminate()
        victim.join(timeout=30)
        deadline = time.time() + 60
        while ((pool.pool_stats()["respawns"] < 1 or pool.alive_workers() < 1)
               and time.time() < deadline):
            time.sleep(0.1)
        assert pool.pool_stats()["respawns"] == 1
        assert pool.alive_workers() == 1
        ev = s.register_job(_batch_job(PORT, 4), now=time.time())
        assert _drain(s, [ev]) == ["complete"]
    finally:
        def stop():
            s.stop_scheduling()
            s.shutdown()
            done.set()
        threading.Thread(target=stop, daemon=True).start()
        assert done.wait(60), "stop_scheduling/shutdown hung"
    assert not any(c.proc.is_alive() for c in s.worker_pool._children)


@pytest.mark.slow
def test_networked_waves_complete_without_refutes():
    s = _pool_server()
    try:
        s.state.upsert_nodes(_pool_cluster(PORT, 60))
        evs = [s.register_job(_batch_job(PORT, 8, net=True),
                              now=time.time())
               for _ in range(6)]
        s.start_scheduling()
        sts = _drain(s, evs)
        s.stop_scheduling()
        assert sts == ["complete"] * len(evs), sts
        allocs = _live_allocs(s)
        assert len(allocs) == 48 and len({a.id for a in allocs}) == 48
        seen = set()
        for a in allocs:
            assert a.allocated_ports, a.id
            for port in a.allocated_ports.values():
                assert (a.node_id, port) not in seen
                seen.add((a.node_id, port))
        assert s.plan_applier.stats["plans_refuted"] == 0
        assert s.worker_pool.pool_stats()["alive"] == 2
    finally:
        s.shutdown()


@pytest.mark.slow
def test_worker_crash_recovers_and_respawns():
    s = _pool_server()
    try:
        s.state.upsert_nodes(_pool_cluster(PORT, 30))
        s.start_scheduling()
        deadline = time.time() + 60
        while (s.worker_pool.alive_workers() < 2
               and time.time() < deadline):
            time.sleep(0.1)
        victim = s.worker_pool._children[0]
        victim.proc.terminate()
        victim.proc.join(timeout=30)
        evs = [s.register_job(_batch_job(PORT, 4), now=time.time())
               for _ in range(4)]
        sts = _drain(s, evs)
        s.stop_scheduling()
        assert sts == ["complete"] * len(evs), sts
        stats = s.worker_pool.pool_stats()
        assert stats["respawns"] >= 1 and stats["alive"] == 2
    finally:
        s.shutdown()


def test_thread_mode_is_the_default_and_poolless():
    def run(name):
        kw = {"device": "cpu"} if name == PORT else {"mesh": False}
        s = pkg(name, "core.server").Server(dev_mode=True, num_workers=2,
                                            profile_hz=0, **kw)
        try:
            return s.worker_mode, s.worker_pool, s.device_front
        finally:
            s.shutdown()
    assert _both(run) == ("thread", None, None)
