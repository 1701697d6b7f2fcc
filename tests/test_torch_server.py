"""The port's single-server loop (nomad_tpu_torch/core/server.py with its
broker, workers, wave pipeline, plan applier, periodic dispatcher,
drainer and deployment and volume watchers) against the reference's on
the CPU: the reference's Server on its single-device engine
(`mesh=False`), the port's on `device="cpu"`, each on its own
VirtualClock, sampler off.

Ids: the reference's tests pin node, job and some eval ids; here every
other id (evals minted by the job endpoint, allocs, plans, tokens, the
workload-identity secret) is pinned too, by a seeded `os.urandom` and
both packages' id pools emptied before each package's run, so the two
runs mint the same ids in the same order and whole store contents are
compared, ids included.  `random` is seeded alike before each run (the
failed-eval follow-up delay draws from it).  The threaded run compares
`(job, name, node, cpu)` fingerprints, since its threads mint ids in
their own order.

The cases: tests/test_core.py's TestServer, TestFailedEvalFollowUp,
TestReviewRegressions and TestBlockedEvalRaceGuard in dev_mode; the
periodic dispatcher, the drainer, a deployment and the volume watcher
driven by ticks; snapshots and ACL resolution; one threaded run; and
the port's device rules."""

import dataclasses
import os
import random
import threading
import time

import pytest
import torch

from torch_parity import PACKAGES, make_node, pkg

PORT = "nomad_tpu_torch"
NOW = 1_700_000_000.0


@pytest.fixture
def pinned(monkeypatch):
    """`reset(seed)` before each package's run: os.urandom draws from
    random.Random(seed), both id pools are emptied and `random` is
    seeded."""
    stream = {}
    monkeypatch.setattr(os, "urandom",
                        lambda n: stream["rng"].randbytes(n))

    def reset(seed: int = 0) -> None:
        stream["rng"] = random.Random(seed)
        for name in PACKAGES:
            pkg(name, "structs.structs")._ID_POOL.clear()
        random.seed(seed)

    return reset


def make_server(name, **kw):
    """A Server of `name` on the CPU, on its own VirtualClock at NOW,
    with the sampler off."""
    clock = pkg(name, "chaos.clock").VirtualClock(start=NOW, epoch=0.0)
    kw.setdefault("profile_hz", 0)
    if name == PORT:
        kw.setdefault("device", "cpu")
    else:
        kw.setdefault("mesh", False)
    return pkg(name, "core.server").Server(clock=clock, **kw)


def store_view(s):
    """Every alloc and eval of the store, ids included, and the nodes'
    status, eligibility and drain."""
    snap = s.state.snapshot()
    allocs, evals = [], []
    for job in snap.jobs():
        for a in snap.allocs_by_job(job.namespace, job.id):
            allocs.append((a.id, a.job_id, a.name, a.node_id,
                           a.resources.cpu, a.desired_status,
                           a.client_status, a.job_version,
                           a.deployment_id, a.previous_allocation))
    for e in snap.evals():
        evals.append((e.id, e.job_id, e.type, e.triggered_by, e.status,
                      e.status_description, e.previous_eval,
                      e.wait_until, e.node_id))
    nodes = [(n.id, n.status, n.scheduling_eligibility, n.drain is None)
             for n in snap.nodes()]
    jobs = [(j.id, j.version, j.stable, j.stop, j.parent_id)
            for j in snap.jobs()]
    return sorted(allocs), sorted(evals, key=repr), sorted(nodes), \
        sorted(jobs, key=repr)


def live(s, job_id, ns="default"):
    return [a for a in s.state.snapshot().allocs_by_job(ns, job_id)
            if not a.terminal_status()]


def nodes(name, s, n, **kw):
    out = [make_node(name, i, **kw) for i in range(n)]
    for node in out:
        s.register_node(node, now=NOW)
    return out


def job(name, jid, count=1, kind="job", **kw):
    j = getattr(pkg(name, "mock"), kind)(id=jid, **kw)
    j.task_groups[0].count = count
    return j


# ------------------------------------------------------------- cases

def case_register_to_running(name, s):
    nodes(name, s, 3)
    s.register_job(job(name, "web", 3), now=NOW)
    return s.process_all(now=NOW), len(live(s, "web"))


def case_blocked_eval_released_on_new_node(name, s):
    s.register_job(job(name, "web", 2), now=NOW)
    s.process_all(now=NOW)
    blocked = s.blocked_evals.num_blocked()
    s.register_node(make_node(name, 0), now=NOW + 1)
    return blocked, s.process_all(now=NOW + 1), len(live(s, "web"))


def case_heartbeat_expiry_reschedules(name, s):
    n1, n2 = nodes(name, s, 2)
    s.register_job(job(name, "web", 1), now=NOW)
    s.process_all(now=NOW)
    victim = live(s, "web")[0].node_id
    other = n2.id if victim == n1.id else n1.id
    s.heartbeat_node(other, now=NOW + 25)
    s.tick(now=NOW + 31)
    down = s.state.node_by_id(victim).status
    s.process_all(now=NOW + 31)
    return down, [a.node_id for a in live(s, "web")], other


def case_deregister_stops_allocs(name, s):
    nodes(name, s, 1)
    s.register_job(job(name, "web", 2), now=NOW)
    s.process_all(now=NOW)
    s.deregister_job("default", "web", now=NOW + 1)
    s.process_all(now=NOW + 1)
    return len(live(s, "web"))


def case_failed_eval_follow_up(name, s):
    ev = pkg(name, "mock").eval(id="eval-stranded", job_id="j-stranded",
                                status="failed")
    ev.status_description = "maximum attempts reached (2)"
    s.apply_eval_update([ev], now=100.0)
    early = s.eval_broker.dequeue(["service"], now=101.0, timeout=0.0)[0]
    s.eval_broker.tick(400.0)
    got = s.eval_broker.dequeue(["service"], now=400.0, timeout=0.0)[0]
    s.apply_eval_update([ev], now=410.0)
    return early, got.id if got else None


def case_delivery_limit_reaped_on_tick(name, s):
    s.eval_broker.delivery_limit = 1
    ev = pkg(name, "mock").eval(id="eval-nacked", job_id="j-nacked")
    s.apply_eval_update([ev], now=100.0)
    got, tok = s.eval_broker.dequeue(["service"], now=100.0, timeout=0.0)
    s.eval_broker.nack(got.id, tok, now=100.0)
    s.tick(now=101.0)
    return s.state.eval_by_id("eval-nacked").status


def case_core_gc_eval(name, s):
    structs = pkg(name, "structs")
    nodes(name, s, 1)
    s.register_job(job(name, "web", 1), now=NOW)
    s.process_all(now=NOW)
    s.deregister_job("default", "web", now=NOW)
    s.process_all(now=NOW)
    s.apply_eval_update([structs.Evaluation(
        id="eval-gc", type="_core", job_id="force-gc", priority=100)],
        now=NOW)
    s.process_all(now=NOW)
    return s.state.job_by_id("default", "web") is None


def _preemption(name, s):
    structs = pkg(name, "structs")
    s.state.set_scheduler_config(structs.SchedulerConfiguration(
        preemption_config=structs.PreemptionConfig(
            service_scheduler_enabled=True)))
    nodes(name, s, 1)


def case_preemption_respects_distinct_hosts(name, s):
    structs = pkg(name, "structs")
    _preemption(name, s)
    low = job(name, "low", 4, "batch_job", priority=10)
    low.task_groups[0].tasks[0].resources = structs.Resources(
        cpu=900, memory_mb=256)
    s.register_job(low, now=NOW)
    s.process_all(now=NOW)
    hi = job(name, "hi", 2, priority=90)
    hi.constraints.append(structs.Constraint("", "distinct_hosts", ""))
    hi.task_groups[0].tasks[0].resources = structs.Resources(
        cpu=1000, memory_mb=128)
    s.register_job(hi, now=NOW)
    s.process_all(now=NOW)
    return len(live(s, "hi"))


def case_heterogeneous_preemption_candidates(name, s):
    structs = pkg(name, "structs")
    _preemption(name, s)
    low = job(name, "low", 1, "batch_job", priority=10)
    low.task_groups = [
        structs.TaskGroup(name="small", count=2, tasks=[structs.Task(
            name="t", driver="exec",
            resources=structs.Resources(cpu=400, memory_mb=3000))]),
        structs.TaskGroup(name="big", count=2, tasks=[structs.Task(
            name="t", driver="exec",
            resources=structs.Resources(cpu=1500, memory_mb=500))])]
    s.register_job(low, now=NOW)
    s.process_all(now=NOW)
    hi = job(name, "hi", 1, priority=90)
    hi.task_groups[0].tasks[0].resources = structs.Resources(
        cpu=1400, memory_mb=200)
    s.register_job(hi, now=NOW)
    s.process_all(now=NOW)
    evicted = [a.task_group for a in s.state.allocs_by_job("default", "low")
               if a.desired_status == "evict"]
    return len(live(s, "hi")), evicted


def case_worker_survives_scheduler_crash(name, s):
    nodes(name, s, 1)
    s.register_job(job(name, "web", 1), now=NOW)
    calls = []

    def boom(*a, **k):
        calls.append(1)
        raise RuntimeError("injected engine failure")

    s.engine.place = boom
    s.process_all(now=NOW)
    return len(calls), s.eval_broker.stats["nacked"], \
        s.workers[0].stats["nacked"]


def case_duplicate_blocked_eval_cancelled(name, s):
    structs = pkg(name, "structs")
    s.register_job(job(name, "web", 1), now=NOW)
    s.process_all(now=NOW)
    s.apply_eval_update([structs.Evaluation(
        id="eval-dup", namespace="default", job_id="web", type="service",
        triggered_by="node-update")], now=NOW)
    s.process_all(now=NOW)
    return s.blocked_evals.num_blocked()


def case_blocked_race_guard(name, s):
    structs = pkg(name, "structs")
    stale = s.state.latest_index()
    s.register_node(make_node(name, 0), now=NOW)
    raced = s.blocked_evals.block(structs.Evaluation(
        id="eval-raced", job_id="raced-job", type="batch",
        status="blocked", snapshot_index=stale))
    parked = s.blocked_evals.block(structs.Evaluation(
        id="eval-parked", job_id="parked-job", type="batch",
        status="blocked", snapshot_index=s.state.latest_index()))
    return raced, parked, s.blocked_evals.num_blocked(), \
        dict(s.blocked_evals.stats), s.eval_broker.pending_evals()


def case_periodic_child_launched(name, s):
    structs = pkg(name, "structs")
    nodes(name, s, 3)
    parent = job(name, "cron", 1, "batch_job")
    parent.periodic = structs.PeriodicConfig(spec="*/5 * * * *",
                                             prohibit_overlap=True)
    ev = s.register_job(parent, now=NOW)
    s.process_all(now=NOW)
    out = [ev]
    for k in (1, 2, 3):
        s.tick(now=NOW + k * 300 + 1)
        out.append(s.process_all(now=NOW + k * 300 + 1))
    forced = s.periodic.force_run("default", "cron", now=NOW + 1000)
    out.append(forced.id if forced else None)
    return out


def case_dispatch_parameterized(name, s):
    structs = pkg(name, "structs")
    nodes(name, s, 2)
    parent = job(name, "param", 1, "batch_job")
    parent.parameterized = structs.ParameterizedJobConfig(
        payload="optional", meta_required=["k"])
    s.register_job(parent, now=NOW)
    child, err = s.dispatch_job("default", "param", b"x", {"k": "v"},
                                now=NOW + 1)
    bad = s.dispatch_job("default", "param", b"", {}, now=NOW + 2)[1]
    s.process_all(now=NOW + 2)
    return child.id if child else None, err, bad


def _finish_stops(s, job_id):
    ups = []
    for a in s.state.allocs_by_job("default", job_id):
        if a.desired_status != "run" and not a.client_terminal_status():
            u = a.copy_skip_job()
            u.client_status = "complete"
            ups.append(u)
    if ups:
        s.state.update_allocs_from_client(ups)


def case_drain_in_max_parallel_batches(name, s):
    structs = pkg(name, "structs")
    nodes(name, s, 4)
    j = job(name, "web", 4)
    j.task_groups[0].migrate = structs.MigrateStrategy(max_parallel=1)
    s.register_job(j, now=NOW)
    s.process_all(now=NOW)
    by_node = {}
    for a in live(s, "web"):
        by_node.setdefault(a.node_id, []).append(a)
    victim = max(sorted(by_node), key=lambda k: len(by_node[k]))
    s.drain_node(victim, structs.DrainStrategy(deadline_s=3600),
                 now=NOW + 1)
    s.process_all(now=NOW + 1)
    steps = []
    for i in range(2, 20):
        _finish_stops(s, "web")
        s.tick(now=NOW + i)
        s.process_all(now=NOW + i)
        on = [a for a in live(s, "web") if a.node_id == victim
              and a.desired_status == "run"]
        steps.append(len(on))
        if not on:
            break
    # deadline forcing on a second drain
    other = next(n for n in sorted(by_node) if n != victim)
    s.drain_node(other, structs.DrainStrategy(deadline_s=10),
                 now=NOW + 30)
    s.process_all(now=NOW + 30)
    s.tick(now=NOW + 50)
    s.process_all(now=NOW + 50)
    return victim, steps


def case_deployment_rolls(name, s):
    structs = pkg(name, "structs")
    nodes(name, s, 6)
    j = job(name, "web", 4)
    j.update = structs.UpdateStrategy(max_parallel=1,
                                      progress_deadline_s=600.0)
    s.register_job(j, now=NOW)
    out = []

    def drive(now):
        for i in range(30):
            s.process_all(now=now + i)
            dep = s.state.latest_deployment_by_job("default", "web")
            if dep is None or dep.status != "running":
                return dep
            ups = []
            for a in live(s, "web"):
                if a.deployment_id == dep.id and not (
                        a.deployment_status or {}).get("healthy"):
                    u = a.copy_skip_job()
                    u.client_status = "running"
                    u.deployment_status = {"healthy": True, "ts": now}
                    ups.append(u)
            s.state.update_allocs_from_client(ups)
            s.deployments.tick(now=now + i)
            out.append(len(ups))
        return s.state.latest_deployment_by_job("default", "web")

    deps = [drive(NOW)]
    v1 = j.copy()
    v1.task_groups[0].tasks[0].config = {"command": "/bin/sleep"}
    s.register_job(v1, now=NOW + 100)
    deps.append(drive(NOW + 100))
    return out, [(d.id, d.status, d.job_version) for d in deps]


def case_volume_watcher(name, s):
    structs = pkg(name, "structs")
    s.heartbeats.ttl = 1e9
    for i in range(2):
        n = make_node(name, i)
        n.csi_node_plugins["ebs0"] = True
        s.register_node(n, now=NOW)
    s.state.upsert_csi_volume(dataclasses.replace(
        structs.CSIVolume(id="vol-reap", plugin_id="ebs0",
                          access_mode="single-node-writer"),
        write_allocs={"ghost-alloc": True}))
    s.state.upsert_csi_volume(dataclasses.replace(
        structs.CSIVolume(id="vol-flaky", plugin_id="ebs0"),
        read_allocs={"ghost": True}))
    calls = []
    real = s.volumes.unpublish

    def flaky(v, alloc_id):
        calls.append((v.id, alloc_id))
        if v.id == "vol-flaky" and len(calls) < 4:
            raise RuntimeError("controller timeout")
        return real(v, alloc_id)

    s.volumes.unpublish = flaky
    j = job(name, "writer", 1)
    j.task_groups[0].volumes = {"data": structs.VolumeRequest(
        name="data", type="csi", source="vol-reap", read_only=False)}
    s.register_job(j, now=NOW)
    s.process_all(now=NOW)
    out = [len(live(s, "writer"))]
    for dt in (1, 1.1, 3, 3.5, 12):
        out.append(s.volumes.tick(NOW + dt))
    s.tick(now=NOW + 400)
    s.process_all(now=NOW + 400)
    snap = s.state.snapshot()
    out.append((len(live(s, "writer")), sorted(calls),
                snap.csi_volume_by_id("default", "vol-flaky").read_allocs,
                dict(s.volumes.stats)))
    return out


def case_snapshot_restore_and_acl(name, s):
    structs = pkg(name, "structs")
    s.acl_enabled = True
    nodes(name, s, 2)
    s.register_job(job(name, "web", 2), now=NOW)
    s.process_all(now=NOW)
    token, err = s.bootstrap_acl()
    again = s.bootstrap_acl()[1]
    s.state.upsert_acl_policy(structs.ACLPolicy(
        name="ro", rules='namespace "default" {\n  policy = "read"\n}'))
    client = structs.ACLToken(accessor_id="acc-1", secret_id="sec-1",
                              name="c", type="client", policies=["ro"])
    s.state.upsert_acl_token(client)
    acl, _ = s.resolve_token("sec-1")
    answers = [acl.allow_namespace_operation("default", c)
               for c in ("read-job", "submit-job")]
    mgmt = s.resolve_token(token.secret_id)[0].is_management()
    unknown = s.resolve_token("nope")
    anon = s.resolve_token("")[0].allow_namespace("default")
    alloc_id = live(s, "web")[0].id
    ids, _ = s.derive_identity_tokens(alloc_id)
    wacl, werr = s.resolve_token(ids["web"])
    wl = (wacl.allow_variable("default", "nomad/jobs/web", False),
          wacl.allow_variable("default", "other", False), werr)
    doc = s.save_snapshot()
    s.register_job(job(name, "later", 1), now=NOW + 5)
    s.restore_snapshot(doc)
    after = s.process_all(now=NOW + 6)
    return (err, again, answers, mgmt, unknown, anon, wl, after,
            s.state.job_by_id("default", "later") is None)


CASES = {f.__name__[5:]: f for f in (
    case_register_to_running, case_blocked_eval_released_on_new_node,
    case_heartbeat_expiry_reschedules, case_deregister_stops_allocs,
    case_failed_eval_follow_up, case_delivery_limit_reaped_on_tick,
    case_core_gc_eval, case_preemption_respects_distinct_hosts,
    case_heterogeneous_preemption_candidates,
    case_worker_survives_scheduler_crash,
    case_duplicate_blocked_eval_cancelled, case_blocked_race_guard,
    case_periodic_child_launched, case_dispatch_parameterized,
    case_drain_in_max_parallel_batches, case_deployment_rolls,
    case_volume_watcher, case_snapshot_restore_and_acl)}

# what each case must show in the reference itself (test_core.py's
# assertions), so that agreement is not agreement on a broken run
EXPECT = {
    "register_to_running": (1, 3),
    "blocked_eval_released_on_new_node": lambda r: r[0] == 1 and r[2] == 2,
    "heartbeat_expiry_reschedules": lambda r: r[0] == "down"
    and r[1] == [r[2]],
    "deregister_stops_allocs": 0,
    "failed_eval_follow_up": lambda r: r[0] is None and r[1] is not None,
    "delivery_limit_reaped_on_tick": "failed",
    "core_gc_eval": True,
    "preemption_respects_distinct_hosts": 1,
    "heterogeneous_preemption_candidates": (1, ["big"]),
    "worker_survives_scheduler_crash": lambda r: r[0] >= 1 and r[1] >= 1,
    "duplicate_blocked_eval_cancelled": 1,
    "blocked_race_guard": lambda r: r[2] == 1 and r[3]["raced"] == 1,
    # the parent gets no eval; the first child runs, the overlapping
    # launches are held back; force_run launches anyway
    "periodic_child_launched": lambda r: r[0] is None and r[1:4] == [1, 0,
                                                                    0]
    and r[-1] is not None,
    "dispatch_parameterized": lambda r: r[0] is not None and r[1] == ""
    and r[2],
    "drain_in_max_parallel_batches": lambda r: r[1][-1] == 0,
    "deployment_rolls": lambda r: [d[1:] for d in r[1]] == [
        ("successful", 0), ("successful", 1)],
    "volume_watcher": lambda r: r[-1][0] == 1,
    "snapshot_restore_and_acl": lambda r: r[0] == "" and r[2] == [True,
                                                                  False]
    and r[3] and r[-1],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_server_case_alike(case, pinned):
    got = []
    for name in PACKAGES:
        pinned(7)
        s = make_server(name, heartbeat_ttl=30.0)
        try:
            s.establish_leadership()
            result = CASES[case](name, s)
            got.append((result, store_view(s),
                        dict(s.eval_broker.stats),
                        s.plan_applier.stats["plans"]))
        finally:
            s.shutdown()
            s.clock.close()
    assert got[0] == got[1]
    want = EXPECT[case]
    result = got[0][0]
    assert want(result) if callable(want) else result == want, result


# ---------------------------------------------------------- threaded

def _threaded_wave(name, dev_mode):
    """Six batch jobs of 8 on ten nodes, their evals pinned, through one
    worker: in dev_mode by process_all, else through the threaded loop
    (applier and worker threads) until every eval settles, with a
    deadline.  Returns the (job, name, node, cpu) fingerprint."""
    mock = pkg(name, "mock")
    s = make_server(name, dev_mode=dev_mode, num_workers=1, eval_batch=8,
                    heartbeat_ttl=1e9)
    try:
        s.establish_leadership()
        for i in range(10):
            s.register_node(make_node(name, i, cpu=2000 + 500 * (i % 3)),
                            now=NOW)
        evals = []
        for i in range(6):
            j = job(name, f"batch-{i}", 8, "batch_job")
            j.task_groups[0].tasks[0].resources.cpu = 150
            j.task_groups[0].tasks[0].resources.memory_mb = 64
            s.state.upsert_job(j)
            evals.append(mock.eval(id=f"eval-batch-{i}", job_id=j.id,
                                   type="batch", priority=j.priority))
        s.apply_eval_update(evals, now=NOW)
        if dev_mode:
            s.process_all(now=NOW)
        else:
            s.start_scheduling()
            try:
                deadline = time.monotonic() + 60
                while time.monotonic() < deadline:
                    if all(s.state.eval_by_id(e.id).status == "complete"
                           for e in evals):
                        break
                    time.sleep(0.01)
            finally:
                s.stop_scheduling()
        assert [s.state.eval_by_id(e.id).status for e in evals] == \
            ["complete"] * 6
        snap = s.state.snapshot()
        return sorted((a.job_id, a.name, a.node_id, a.resources.cpu)
                      for j in snap.jobs()
                      for a in snap.allocs_by_job(j.namespace, j.id)
                      if not a.terminal_status()), \
            s.workers[0].pipeline.stats["waves"], \
            s.stage_timers.counts().get("device", 0)
    finally:
        s.shutdown()
        s.clock.close()


def test_threaded_wave_matches_dev_mode():
    threads0 = set(threading.enumerate())
    ref_dev = _threaded_wave("nomad_tpu", True)
    port_dev = _threaded_wave(PORT, True)
    port_thr = _threaded_wave(PORT, False)
    assert port_dev == ref_dev
    assert port_thr[0] == ref_dev[0]
    assert len(ref_dev[0]) == 48
    # one device interval per dispatched wave, in both modes
    assert port_thr[1] >= 1 and port_thr[2] == port_thr[1]
    assert port_dev[2] == port_dev[1]
    leftover = [t for t in threading.enumerate()
                if t not in threads0 and t.is_alive()]
    assert not leftover, leftover


# -------------------------------------------------------- device rules

def test_server_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pkg(PORT, "core.server").Server(profile_hz=0)


@pytest.mark.parametrize("backend,exc", [
    ("jax", ValueError), ("cuda", ValueError),
    ("bridge", "ExecutorUnavailable")])
def test_server_executor_names(backend, exc):
    if isinstance(exc, str):
        exc = getattr(pkg(PORT, "ops.executor"), exc)
    with pytest.raises(exc):
        make_server(PORT, device_executor=backend)


@pytest.mark.parametrize("backend", ["", None, "torch"])
def test_server_torch_executor(backend):
    s = make_server(PORT, device_executor=backend)
    try:
        assert type(s.executor).__name__ == "TorchExecutor"
        assert s.executor.engine is s.engine
        assert s.workers[0].pipeline.executor is s.executor
        assert s.engine.device == torch.device("cpu")
    finally:
        s.shutdown()


def test_process_worker_mode_refused_before_anything_is_built(
        monkeypatch):
    """A VirtualClock with worker_mode="process" and an unknown mode are
    refused with the reference's ValueError, and in the port before a
    store or a thread exists."""
    for name in PACKAGES:
        clock = pkg(name, "chaos.clock").VirtualClock(start=NOW, epoch=0.0)
        kw = {"device": "cpu"} if name == PORT else {"mesh": False}
        with pytest.raises(ValueError, match="requires the wall clock"):
            pkg(name, "core.server").Server(worker_mode="process",
                                            clock=clock, profile_hz=0, **kw)
    server_mod = pkg(PORT, "core.server")
    built = []
    monkeypatch.setattr(server_mod, "StateStore",
                        lambda *a, **k: built.append(1))
    threads0 = threading.active_count()
    with pytest.raises(ValueError, match="requires the wall clock"):
        server_mod.Server(worker_mode="process", device="cpu",
                          clock=pkg(PORT, "chaos.clock").VirtualClock())
    with pytest.raises(ValueError, match="worker_mode"):
        server_mod.Server(worker_mode="fork", device="cpu")
    assert not built and threading.active_count() == threads0


def test_server_mesh_argument():
    mesh = pkg(PORT, "parallel").make_mesh(4, device="cpu")
    s = make_server(PORT, mesh=mesh)
    try:
        assert s.engine.mesh is mesh and s.engine.n_devices == 4
    finally:
        s.shutdown()
    for off in (None, False):
        s = make_server(PORT, mesh=off)
        try:
            assert s.engine.mesh is None
        finally:
            s.shutdown()
    with pytest.raises(TypeError):
        make_server(PORT, mesh="8")
