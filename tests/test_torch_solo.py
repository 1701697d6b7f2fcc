"""The solo scheduling path end to end: `Harness.process` (and the
batched wave's fall-back to it) in the reference and in the port
(device="cpu", the kernels' plain versions) on clusters built from
explicit ids must commit the same allocs on the same nodes, evict the
same victims, and record the same AllocMetrics and eval outcomes.

Scenarios mirror tests/test_ops.py::TestPlacementEngine and the service,
batch, reschedule, device and preemption scenarios of
tests/test_generic_sched.py, tests/test_devices.py and
tests/test_preemption.py; they reach the exact scan (K5), the bulk rounds
(K6, compact and full layouts), device preemption (K8 + K7) and the
host Preemptor.
"""

import importlib.util
import zlib
from pathlib import Path

import pytest
import torch

from torch_parity import (
    PACKAGES,
    add_nodes,
    eval_for,
    harness,
    pkg,
    view,
)

NOW = 1_700_000_000.0


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def run(h, name, job, tag="0", sched=None, **kw):
    h.state.upsert_job(job)
    err = h.process(sched or job.type, eval_for(name, job, tag, **kw),
                    now=NOW)
    assert err is None, err


ROUTES = ("place_packed", "place_bulk_packed", "preempt_bulk",
          "feasible_mask")


def both(scenario, monkeypatch, want_routes=()):
    """Run `scenario` in both packages and compare their views; in the
    port, count the engine's calls into the kernel wrappers and require
    every route in `want_routes`."""
    import nomad_tpu_torch.ops.engine as E
    calls = {r: 0 for r in ROUTES}
    for r in ROUTES:
        def spy(*a, _f=getattr(E, r), _r=r, **kw):
            calls[_r] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(E, r, spy)
    out = {}
    for name in PACKAGES:
        h = harness(name)
        scenario(name, h)
        out[name] = view(h)
    ref, port = out["nomad_tpu"], out["nomad_tpu_torch"]
    assert ref[0], "the scenario placed nothing"
    assert port == ref
    assert all(calls[r] for r in want_routes), calls
    return ref


# ------------------------------------------------------------- scenarios

def s_spread_affinity(name, h):
    """bench.py config 3 at test size: spread 50/30/20 over 3 DCs and a
    rack affinity (exact scan)."""
    structs = pkg(name, "structs")
    mock = pkg(name, "mock")
    add_nodes(name, h, [(f"dc{1 + i % 3}", 4000 + 4000 * (i % 2), 8192,
                         {"platform.rack": f"r{i % 5}"}) for i in range(30)])
    job = mock.job(id="spread")
    job.datacenters = ["dc1", "dc2", "dc3"]
    tg = job.task_groups[0]
    tg.count = 40
    tg.tasks[0].resources.cpu = 10
    tg.tasks[0].resources.memory_mb = 10
    job.spreads = [structs.Spread(
        attribute="${node.datacenter}", weight=50,
        targets=[structs.SpreadTarget("dc1", 50),
                 structs.SpreadTarget("dc2", 30),
                 structs.SpreadTarget("dc3", 20)])]
    job.affinities = [structs.Affinity("${attr.platform.rack}", "=", "r3",
                                       weight=50)]
    run(h, name, job)


def s_capacity_sequential(name, h):
    """Two nodes fit two 1000 MHz asks each: 4 of 5 place, the fifth
    fails with cpu exhausted and a blocked eval."""
    mock = pkg(name, "mock")
    structs = pkg(name, "structs")
    nodes = add_nodes(name, h, [("dc1", 2100, 99999, {})] * 2)
    for n in nodes:
        n.reserved.cpu = 0
        n.reserved.memory_mb = 0
    h.state.upsert_nodes(nodes)
    job = mock.batch_job(id="seq")
    job.task_groups[0].tasks[0].resources = structs.Resources(
        cpu=1000, memory_mb=10)
    job.task_groups[0].count = 5
    run(h, name, job)


def s_distinct(name, h):
    """distinct_hosts on one job, distinct_property (rack, limit 1) on
    another."""
    mock = pkg(name, "mock")
    structs = pkg(name, "structs")
    add_nodes(name, h, [("dc1", 4000, 8192, {"rack": f"r{i % 3}"})
                        for i in range(6)])
    dh = mock.job(id="hosts")
    dh.constraints.append(structs.Constraint("", "distinct_hosts", ""))
    dh.task_groups[0].count = 8
    run(h, name, dh)
    dp = mock.job(id="prop")
    dp.constraints.append(structs.Constraint("${attr.rack}",
                                             "distinct_property", "1"))
    dp.task_groups[0].count = 4
    run(h, name, dp)


def s_anti_affinity_multi_group(name, h):
    """Two task groups of different sizes on roomy nodes: job
    anti-affinity spreads each group."""
    mock = pkg(name, "mock")
    structs = pkg(name, "structs")
    add_nodes(name, h, [("dc1", 8000, 16384, {})] * 4)
    job = mock.job(id="multi")
    job.task_groups[0].count = 3
    job.task_groups.append(structs.TaskGroup(name="api", count=5, tasks=[
        structs.Task(name="t", driver="exec",
                     resources=structs.Resources(cpu=700, memory_mb=900))]))
    run(h, name, job)


def s_dev_config1(name, h):
    """bench.py config 1: one node, 3 groups x 2 (the scan with N < 3)."""
    mock = pkg(name, "mock")
    structs = pkg(name, "structs")
    add_nodes(name, h, [("dc1", 4000, 8192, {})])
    job = mock.job(id="dev")
    job.task_groups = [structs.TaskGroup(name=f"tg{i}", count=2, tasks=[
        structs.Task(name="t", driver="exec",
                     resources=structs.Resources(cpu=100, memory_mb=64))])
        for i in range(3)]
    run(h, name, job)


def s_batch_bulk(name, h):
    """A 300-placement batch job takes the bulk rounds (compact output,
    PlaceBlock materialisation)."""
    mock = pkg(name, "mock")
    add_nodes(name, h, [("dc1", 4000 * (1 + i % 3), 8192, {})
                        for i in range(40)])
    job = mock.batch_job(id="bulk")
    job.task_groups[0].count = 300
    job.task_groups[0].tasks[0].resources.cpu = 100
    job.task_groups[0].tasks[0].resources.memory_mb = 100
    run(h, name, job)


def s_batch_bulk_spread_algo(name, h):
    """The spread scheduler algorithm keeps the bulk rounds' full layout,
    and over-asks the cluster so rounds report exhaustion."""
    mock = pkg(name, "mock")
    structs = pkg(name, "structs")
    h.state.set_scheduler_config(structs.SchedulerConfiguration(
        scheduler_algorithm=structs.SCHED_ALGO_SPREAD))
    add_nodes(name, h, [("dc1", 2000, 4096, {}) for i in range(20)])
    job = mock.batch_job(id="fan")
    job.task_groups[0].count = 450
    job.task_groups[0].tasks[0].resources.cpu = 100
    job.task_groups[0].tasks[0].resources.memory_mb = 64
    run(h, name, job)


def s_block_with_spread_takes_scan(name, h):
    """A 100-placement block whose job spreads cannot take the bulk
    rounds: the engine expands it and the exact scan's decisions
    materialise through _materialize_decisions."""
    mock = pkg(name, "mock")
    structs = pkg(name, "structs")
    add_nodes(name, h, [(f"dc{1 + i % 2}", 4000, 8192, {})
                        for i in range(16)])
    job = mock.batch_job(id="blockspread")
    job.datacenters = ["dc1", "dc2"]
    job.task_groups[0].count = 100
    job.task_groups[0].tasks[0].resources.cpu = 50
    job.task_groups[0].tasks[0].resources.memory_mb = 50
    job.spreads = [structs.Spread(attribute="${node.datacenter}",
                                  weight=100, targets=[])]
    run(h, name, job)


def s_reschedule(name, h):
    """A failed alloc rescheduled past its delay avoids its previous
    node (reschedule penalty row)."""
    mock = pkg(name, "mock")
    add_nodes(name, h, [("dc1", 4000, 8192, {})] * 3)
    job = mock.job(id="resched")
    job.task_groups[0].count = 1
    run(h, name, job)
    a = h.snapshot().allocs_by_job(job.namespace, job.id)[0]
    fail = a.copy_skip_job()
    fail.client_status = "failed"
    fail.modify_time = NOW
    h.state.upsert_allocs([fail])
    err = h.process("service", eval_for(name, job, "1",
                                        triggered_by="alloc-failure"),
                    now=NOW + 60)
    assert err is None


def s_devices(name, h):
    """GPU groups: four 1-instance asks over two 2-instance nodes spill
    to the second node through the re-place rounds; a 1-instance node
    exhausts on devices."""
    structs = pkg(name, "structs")
    mock = pkg(name, "mock")
    specs = [("dc1", 4000, 8192, {})] * 5
    nodes = add_nodes(name, h, specs)
    for i, n in enumerate(nodes[:3]):
        cnt = 1 if i == 2 else 2
        n.resources.devices = [structs.NodeDeviceResource(
            vendor="nvidia", type="gpu", name="1080ti",
            instance_ids=[f"1080ti-{i}-{k}" for k in range(cnt)],
            attributes={})]
    h.state.upsert_nodes(nodes)
    job = mock.job(id="gpu")
    job.task_groups[0].count = 6
    job.task_groups[0].tasks[0].resources.devices = [
        structs.RequestedDevice(name="gpu", count=1)]
    run(h, name, job)


def _preempt_cluster(name, h, n_nodes, bands=(20,)):
    structs = pkg(name, "structs")
    mock = pkg(name, "mock")
    h.state.set_scheduler_config(structs.SchedulerConfiguration(
        preemption_config=structs.PreemptionConfig(
            system_scheduler_enabled=True, batch_scheduler_enabled=True,
            service_scheduler_enabled=True)))
    nodes = add_nodes(name, h, [("dc1", 4000, 8192, {})] * n_nodes)
    for n in nodes:
        n.reserved = type(n.reserved)()
    h.state.upsert_nodes(nodes)
    cpu = 3000 // len(bands)
    for b, prio in enumerate(bands):
        low = mock.batch_job(id=f"low{b}", priority=prio)
        low.task_groups[0].count = n_nodes
        low.task_groups[0].tasks[0].resources = structs.Resources(
            cpu=cpu, memory_mb=64)
        run(h, name, low)


def s_preempt_scan(name, h):
    """bench.py config 4 at test size: a low-priority fill, then ten
    3000 MHz high-priority placements (exact scan, all fail, K7)."""
    _preempt_cluster(name, h, 24)
    hi = pkg(name, "mock").job(id="hi", priority=80)
    hi.task_groups[0].count = 10
    hi.task_groups[0].tasks[0].resources.cpu = 3000
    hi.task_groups[0].tasks[0].resources.memory_mb = 64
    run(h, name, hi)


def s_preempt_bulk_bands(name, h):
    """Three priority bands and a 70-placement batch ask: bulk rounds,
    then K7 consuming victims in priority order, then the host Preemptor
    for whatever the kernel could not place."""
    _preempt_cluster(name, h, 30, bands=(10, 20, 30))
    hi = pkg(name, "mock").batch_job(id="hi", priority=70)
    hi.task_groups[0].count = 70
    hi.task_groups[0].tasks[0].resources.cpu = 1500
    hi.task_groups[0].tasks[0].resources.memory_mb = 64
    run(h, name, hi)


def s_preempt_few_host(name, h):
    """Three failing placements stay under the device threshold: the
    host Preemptor alone."""
    _preempt_cluster(name, h, 8)
    hi = pkg(name, "mock").job(id="hi", priority=90)
    hi.task_groups[0].count = 3
    hi.task_groups[0].tasks[0].resources.cpu = 2500
    run(h, name, hi)


SCAN, BULK = ("place_packed",), ("place_bulk_packed",)
K7 = ("preempt_bulk", "feasible_mask")
SCENARIOS = {f.__name__[2:]: (f, routes) for f, routes in (
    (s_spread_affinity, SCAN), (s_capacity_sequential, SCAN),
    (s_distinct, SCAN), (s_anti_affinity_multi_group, SCAN),
    (s_dev_config1, SCAN), (s_batch_bulk, BULK),
    (s_batch_bulk_spread_algo, BULK), (s_block_with_spread_takes_scan, SCAN),
    (s_reschedule, SCAN), (s_devices, SCAN), (s_preempt_scan, SCAN + K7),
    (s_preempt_bulk_bands, BULK + K7),
    (s_preempt_few_host, SCAN + ("feasible_mask",)))}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_process_matches_reference(scenario, monkeypatch):
    fn, routes = SCENARIOS[scenario]
    both(fn, monkeypatch, routes)


def test_preemption_evicts_lower_priority_within_capacity():
    """The port's own invariants on the preemption scenario: every
    eviction is of lower priority and no node ends over capacity."""
    h = harness("nomad_tpu_torch")
    s_preempt_bulk_bands("nomad_tpu_torch", h)
    plan = h.plans[-1]
    victims = [a for allocs in plan.node_preemptions.values() for a in allocs]
    assert victims
    assert all(v.job.priority < 70 for v in victims)
    snap = h.snapshot()
    for node in snap.nodes():
        live = [a for a in snap.allocs_by_node(node.id)
                if not a.terminal_status()]
        assert sum(a.resources.cpu for a in live) <= node.resources.cpu


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_config3_spread_matches_reference():
    """chip_smoke.py's spread_eval at its full width (bench.py config 3:
    5,000 nodes in 3 DCs, 3,000 placements spread 50/30/20 with a rack
    affinity) in both packages: every alloc on the same node, so the
    spread the card reaches is the reference algorithm's."""
    C = _chip_smoke()
    views, by_dc = {}, {}
    for name in PACKAGES:
        h = harness(name)
        mock = pkg(name, "mock")
        C.bench_cluster(h, 5000, n_dcs=3, mock=mock)
        job = C.config3_job(mock, pkg(name, "structs"))
        run_at = C.solo_eval(mock, job)
        h.state.upsert_job(job)
        assert h.process("service", run_at, now=C.SOLO_NOW) is None
        counts = {}
        for a in h.state.allocs_by_job(job.namespace, job.id):
            dc = h.state.node_by_id(a.node_id).datacenter
            counts[dc] = counts.get(dc, 0) + 1
        by_dc[name] = counts
        views[name] = view(h)
    print("config 3 placements by datacenter:", by_dc)
    assert sum(by_dc["nomad_tpu"].values()) == 3000
    assert views["nomad_tpu_torch"] == views["nomad_tpu"]


# ------------------------------------------------ the batched fall-back

def _wave(name, h, jobs):
    """The worker's batched flow, each eval finishing through
    process_batched, as the server's worker finishes it."""
    GenericScheduler = pkg(name, "scheduler.generic").GenericScheduler
    BatchItem = pkg(name, "ops.engine").BatchItem
    snap = h.snapshot()
    evs = [eval_for(name, j) for j in jobs]
    scheds, preps = [], []
    for ev in evs:
        s = GenericScheduler(snap, h, is_batch=True, engine=h.engine,
                             now=NOW)
        prep = s.prepare_batch(ev)
        assert prep is not None
        scheds.append(s)
        preps.append(prep)
    items = [BatchItem(job=p.job, tg=p.tg, count=p.count) for p in preps]
    seeds = [(zlib.crc32(ev.id.encode()) & 0xFFFFFFFF) or 1 for ev in evs]
    decisions = h.engine.place_batch(snap, items, seed=seeds)
    for ev, s, prep, bd in zip(evs, scheds, preps, decisions):
        assert s.process_batched(ev, prep, bd) is None
    return decisions


def s_wave_preempt_fallback(name, h):
    """A batched wave over a full cluster: the batch kernel never
    preempts, so evals with failed picks and preemption enabled fall back
    to process(), whose solo path evicts."""
    _preempt_cluster(name, h, 20)
    mock = pkg(name, "mock")
    jobs = []
    for i in range(3):
        j = mock.batch_job(id=f"wave{i}", priority=60)
        j.task_groups[0].count = 6
        j.task_groups[0].tasks[0].resources.cpu = 1500
        j.task_groups[0].tasks[0].resources.memory_mb = 64
        h.state.upsert_job(j)
        jobs.append(j)
    _wave(name, h, jobs)


def s_wave_partial_commit(name, h):
    """A wave whose first plan the applier refutes whole: finalize
    re-runs that eval through process() (the solo path)."""
    mock = pkg(name, "mock")
    structs = pkg(name, "structs")
    add_nodes(name, h, [("dc1", 4000, 8192, {})] * 12)
    jobs = []
    for i in range(3):
        j = mock.batch_job(id=f"part{i}")
        j.task_groups[0].count = 20
        j.task_groups[0].tasks[0].resources.cpu = 100
        j.task_groups[0].tasks[0].resources.memory_mb = 100
        h.state.upsert_job(j)
        jobs.append(j)
    submit = h.submit_plan
    refuted = []

    def refute_first(plan):
        if plan.job.id == "part0" and not refuted:
            refuted.append(plan)
            h.plans.append(plan)
            return structs.PlanResult(), None, None
        return submit(plan)

    h.submit_plan = refute_first
    _wave(name, h, jobs)
    assert refuted


@pytest.mark.parametrize("scenario", [s_wave_preempt_fallback,
                                      s_wave_partial_commit],
                         ids=["preempt_fallback", "partial_commit"])
def test_batched_wave_falls_back_to_process(scenario, monkeypatch):
    """The fault this slice repairs: the fall-back reached a solo path
    that raised."""
    routes = SCAN + (K7 if scenario is s_wave_preempt_fallback else ())
    ref = both(scenario, monkeypatch, routes)
    assert [k for k in ref[0] if k[3] == "run"]
