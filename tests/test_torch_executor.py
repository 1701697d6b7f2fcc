"""The port's device executor seam (nomad_tpu_torch/ops/executor.py) and
the engine meters it reads, on the CPU (device="cpu"): backend
selection, the retained chain slot and its store coupling (the cases
of tests/test_executor.py's TestMakeExecutor and TestChainSlot), the
stats and metric names against the reference's JaxExecutor, a zoned
wave then a chained wave through TorchExecutor against the same waves
through JaxExecutor, the engine's compile-ledger sites, and the
scheduler's nomad.ports.* counters against the reference's."""

import zlib

import numpy as np
import pytest
import torch

from nomad_tpu_torch import mock
from nomad_tpu_torch.core.telemetry import REGISTRY
from nomad_tpu_torch.ops import PlacementEngine
from nomad_tpu_torch.ops.executor import (
    EXECUTOR_BACKENDS,
    DeviceExecutor,
    ExecutorUnavailable,
    SubmissionFrontEnd,
    TorchExecutor,
    make_executor,
)
from nomad_tpu_torch.parallel import make_mesh
from nomad_tpu_torch.state import StateStore
from nomad_tpu_torch.structs import Allocation, Resources
from torch_parity import (
    PACKAGES,
    add_jobs,
    build_flat_cluster,
    build_zoned_cluster,
    make_evals,
    pkg,
)

PORT = "nomad_tpu_torch"
# the reference's backend class per package
EXECUTORS = {"nomad_tpu": "JaxExecutor", PORT: "TorchExecutor"}


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _engine():
    return PlacementEngine(device="cpu")


def _executor(name, engine, **kw):
    return getattr(pkg(name, "ops.executor"), EXECUTORS[name])(engine, **kw)


def _ref_engine():
    from nomad_tpu.ops import PlacementEngine as RefEngine
    return RefEngine(mesh=False)


# ------------------------------------------------------------ make_executor

class TestMakeExecutor:
    @pytest.mark.parametrize("name", ["", None, "torch"])
    def test_default_and_torch(self, name):
        eng = _engine()
        ex = make_executor(name, eng)
        assert isinstance(ex, TorchExecutor)
        assert ex.name == "torch"
        assert ex.engine is eng
        assert eng.h2d_observer == ex._observe_h2d
        assert eng.d2h_observer == ex._observe_d2h

    @pytest.mark.parametrize("name", ["cuda", "jax"])
    def test_unknown_backend_rejected(self, name):
        with pytest.raises(ValueError, match="device_executor"):
            make_executor(name, _engine())

    @pytest.mark.parametrize("mesh", [False, True])
    def test_bridge_is_unavailable(self, mesh):
        """On a CPU engine the native library has no card to drive; a
        mesh engine is a config error, raised before that (the
        reference's rule)."""
        eng = (PlacementEngine(device="cpu", mesh=make_mesh(8, "cpu")) if mesh else _engine())
        if mesh:
            with pytest.raises(ValueError, match="agent_config.*mesh"):
                make_executor("bridge", eng)
            return
        with pytest.raises(ExecutorUnavailable, match="bridge"):
            make_executor("bridge", eng)

    def test_backends_registry(self):
        assert EXECUTOR_BACKENDS == ("torch", "bridge")

    def test_base_class_is_abstract(self):
        ex = DeviceExecutor(_engine())
        with pytest.raises(NotImplementedError):
            ex.dispatch_batch(None, [])
        with pytest.raises(NotImplementedError):
            ex.collect_batch(None)


# -------------------------------------------------------------- chain slot

def _live_alloc():
    return Allocation(id="a-live", namespace="default", job_id="j",
                      task_group="tg", node_id="n1",
                      resources=Resources(cpu=10, memory_mb=10),
                      desired_status="run", client_status="running")


class TestChainSlot:
    def test_claim_pops_single_consumer(self):
        ex = TorchExecutor(_engine())
        triple = (object(), 1, 8)
        ex.retain_chain("bid", 3, triple, masked={"n1"})
        got = ex.claim_chain()
        assert got == ("bid", 3, triple, frozenset({"n1"}))
        assert ex.claim_chain() is None

    def test_chain_disabled_is_inert(self):
        ex = TorchExecutor(_engine(), chain_enabled=False)
        ex.retain_chain("bid", 3, (object(), 1, 8))
        assert ex.claim_chain() is None

    def test_invalidate_counts_only_real_drops(self):
        ex = TorchExecutor(_engine())
        ex.invalidate("noop")
        assert ex.stats["invalidations"] == 0
        ex.retain_chain("bid", 3, (object(), 1, 8))
        ex.invalidate("test")
        assert ex.stats["invalidations"] == 1
        assert ex.claim_chain() is None

    def test_foreign_plan_invalidates_own_does_not(self):
        ex = TorchExecutor(_engine())
        ex.retain_chain("bid", 3, (object(), 1, 8))
        ex.note_plan_commit("bid")            # the chain's own commit
        assert ex.stats["invalidations"] == 0
        ex.note_plan_commit("someone-else")   # foreign plan
        assert ex.stats["invalidations"] == 1
        assert ex.claim_chain() is None

    def test_chain_retained_after_a_foreign_commit_is_dropped(self):
        """A chain in flight while a sibling worker's plan committed
        misses that commit: retained after it, it is dropped (a
        `foreign-plan` invalidation), not parked for a next wave.  Its
        own commits and foreign commits its base saw keep it."""
        ex = TorchExecutor(_engine())
        ex.note_plan_commit("bid", seq=9)     # the chain's own commit
        ex.note_plan_commit("other", seq=4)   # seen by a base at seq 5
        ex.note_plan_commit("bid", seq=12)
        ex.retain_chain("bid", 5, (object(), 1, 8), client="w1")
        assert ex.stats["invalidations"] == 0
        assert ex.claim_chain("w1")[0] == "bid"
        ex.note_plan_commit("other", seq=13)  # after the base at seq 5
        ex.retain_chain("bid", 5, (object(), 1, 8), client="w1")
        assert ex.stats["invalidations"] == 1
        assert ex.claim_chain("w1") is None
        ex.retain_chain("b2", 13, (object(), 1, 8), client="w2")
        ex.retain_chain("other", 12, (object(), 1, 8), client="w3")
        assert ex.stats["invalidations"] == 1
        assert ex.claim_chain("w2")[0] == "b2"
        assert ex.claim_chain("w3")[0] == "other"

    def test_store_writes_invalidate(self):
        store = StateStore()
        ex = TorchExecutor(_engine())
        ex.attach_store(store)

        # node write (register/drain/eligibility)
        ex.retain_chain("bid", 1, (object(), 1, 8))
        store.upsert_node(mock.node())
        assert ex.stats["invalidations"] == 1

        # capacity-freeing (terminal) alloc write
        ex.retain_chain("bid", 2, (object(), 1, 8))
        live = _live_alloc()
        store.upsert_allocs([live])
        assert ex.stats["invalidations"] == 1, \
            "a live placement must NOT invalidate"
        done = live.copy()
        done.client_status = "complete"
        store.upsert_allocs([done])
        assert ex.stats["invalidations"] == 2

        # snapshot restore
        ex.retain_chain("bid", 3, (object(), 1, 8))
        store.snapshot_restore(store.snapshot_save())
        assert ex.stats["invalidations"] == 3

    def test_client_slots_and_close(self):
        ex = TorchExecutor(_engine())
        ex.retain_chain("b1", 1, (object(), 1, 8), client="w1")
        ex.retain_chain("b2", 1, (object(), 1, 8), client="w2")
        ex.retain_chain("b3", 2, (object(), 1, 8), client="w2")
        assert ex.stats["invalidations"] == 0   # a re-retain is no drop
        ex.drop_client("w1")
        ex.drop_client("w1")
        assert ex.stats["invalidations"] == 1
        assert ex.claim_chain("w2")[0] == "b3"
        ex.retain_chain("b4", 1, (object(), 1, 8))
        ex.close()
        assert ex.stats["invalidations"] == 2
        assert ex.claim_chain() is None


def _chain_ops(name):
    """One sequence of chain-slot operations through `name`'s executor
    and store; returns (stats, by-cause, registry counter deltas)."""
    reg = pkg(name, "core.telemetry").REGISTRY
    eng = _ref_engine() if name == "nomad_tpu" else _engine()
    ex = _executor(name, eng)
    store = pkg(name, "state").StateStore()
    ex.attach_store(store)
    keys = ("nomad.executor.invalidations", "nomad.executor.uploads",
            "nomad.executor.upload_bytes",
            "nomad.executor.upload_bytes_by_cause",
            "nomad.executor.d2h_bytes", "nomad.executor.resident_waves")
    before = {k: reg.counter_labels(k) for k in keys}
    ex.retain_chain("bid", 1, (np.zeros((8, 3), np.int32), 1, 8))
    store.upsert_node(pkg(name, "mock").node(id="node-0001"))
    ex.retain_chain("bid", 2, (np.zeros((8, 3), np.int32), 1, 8),
                    client="w")
    ex.note_plan_commit("other")
    ex.retain_chain("bid", 3, (np.zeros((8, 3), np.int32), 1, 8))
    ex.drop_client("")
    ex._observe_h2d(96, 0.001, "initial-upload")
    ex._observe_h2d(32, 0.001, "invalidation-replay")
    ex._observe_d2h(64, 0.002)
    ex._note_dispatch({"chained": True, "collective_bytes": 0}, True)
    ex._note_dispatch({"chained": False}, True)
    after = {k: reg.counter_labels(k) for k in keys}
    delta = {k: {lab: v - before[k].get(lab, 0)
                 for lab, v in after[k].items()
                 if v != before[k].get(lab, 0)} for k in keys}
    ledger = ex.ledger()
    ledger.pop("compile")
    ledger.pop("backend")
    for k in ("hbm_resident_bytes", "hbm_high_watermark_bytes"):
        ledger.pop(k)
    stats = {k: v for k, v in ex.stats.items() if not k.startswith("hbm")}
    return stats, sorted(ex.stats), ex.upload_bytes_by_cause, delta, ledger


def test_stats_and_metric_names_match_reference():
    ref, port = [_chain_ops(name) for name in PACKAGES]
    assert ref == port
    assert port[0]["invalidations"] == 4
    assert port[3]["nomad.executor.invalidations"] == {
        "reason=node-write": 1, "reason=foreign-plan": 1,
        "reason=client-drop": 1, "reason=stale-node-table": 1}


def test_hbm_estimate_counts_engine_and_chain():
    eng = _engine()
    ex = TorchExecutor(eng)
    h = build_zoned_cluster(PORT, n_nodes=60)
    eng.packer.attach(h.state)
    _, items = add_jobs(PORT, h, 4, 5)
    pend = ex.dispatch_batch(h.state.snapshot(), items)
    ex.collect_batch(pend)
    resident = eng.device_resident_bytes()
    assert resident >= (eng._dev_cache["attrs"].nbytes
                        + eng._used_dev.nbytes + eng._base[3].nbytes)
    ex.retain_chain("b", 1, ex.chain_state(pend))
    led = ex.ledger()
    assert led["hbm_resident_bytes"] == resident + pend["used"].nbytes
    assert led["hbm_high_watermark_bytes"] >= led["hbm_resident_bytes"]
    assert REGISTRY.gauge("nomad.executor.hbm_resident_bytes") == \
        led["hbm_resident_bytes"]
    assert ex.chain_state(None) is None


def test_submission_front_end_passes_through():
    ex = TorchExecutor(_engine())
    front = SubmissionFrontEnd(ex)
    h = build_flat_cluster(PORT, n_nodes=40)
    ex.engine.packer.attach(h.state)
    _, items = add_jobs(PORT, h, 2, 3, zones=0)
    pend = front.dispatch_batch(h.state.snapshot(), items, seed=[1, 2])
    got = front.collect_batch(pend)
    assert [len(d.picks) for d in got] == [3, 3]
    front.retain_chain("b", 0, front.chain_state(pend))
    assert front.claim_chain()[2] == ex.chain_state(pend)
    front.retain_chain("b", 0, front.chain_state(pend), client="c")
    front.drop_client("c")
    assert front.stats["submits"] == 1
    assert front.stats["queue_waits"] == 0
    assert ex.stats["dispatches"] == 1


# -------------------------------------------- two waves against reference

def _wave(name, h, ex, evals, used0_dev=None):
    """The worker's batched flow through an executor: prepare_batch per
    eval, one dispatch/collect, submit/finalize per eval."""
    GenericScheduler = pkg(name, "scheduler.generic").GenericScheduler
    BatchItem = pkg(name, "ops.engine").BatchItem
    snap = h.snapshot()
    now = h.clock.time()
    scheds, preps = [], []
    for ev in evals:
        s = GenericScheduler(snap, h, is_batch=True, engine=h.engine,
                             now=now)
        scheds.append(s)
        preps.append(s.prepare_batch(ev))
    items = [BatchItem(job=p.job, tg=p.tg, count=p.count) for p in preps]
    seeds = [(zlib.crc32(ev.id.encode()) & 0xFFFFFFFF) or 1 for ev in evals]
    pending = ex.dispatch_batch(snap, items, seed=seeds,
                                used0_dev=used0_dev)
    decisions = ex.collect_batch(pending)
    for ev, s, prep, bd in zip(evals, scheds, preps, decisions):
        assert s.finalize_batched(ev, s.submit_batched(ev, prep, bd)) is None
    return pending, decisions


def _three_waves(name):
    """A zoned wave, a chained wave claimed from the executor's slot,
    then an unchained wave whose usage replays the first two's plans.
    Returns the decisions, the executor, and the uploads in order."""
    h = build_zoned_cluster(name, n_nodes=300)
    jobs1, _ = add_jobs(name, h, 12, 40)
    jobs2, _ = add_jobs(name, h, 10, 30, prefix="wave2")
    jobs3, _ = add_jobs(name, h, 6, 20, prefix="wave3")
    ex = _executor(name, h.engine)
    ex.attach_store(h.state)
    uploads = []
    meter = ex._observe_h2d

    def observe(nbytes, seconds, cause="initial-upload"):
        uploads.append((cause, int(nbytes)))
        meter(nbytes, seconds, cause)

    h.engine.h2d_observer = observe
    pend1, d1 = _wave(name, h, ex, make_evals(name, jobs1))
    ex.retain_chain("batch-1", 12, ex.chain_state(pend1))
    claimed = ex.claim_chain()
    assert claimed[:2] == ("batch-1", 12)
    pend2, d2 = _wave(name, h, ex, make_evals(name, jobs2, "ev2"),
                      used0_dev=claimed[2])
    assert pend2["chained"]
    stats2 = dict(ex.stats)
    pend3, d3 = _wave(name, h, ex, make_evals(name, jobs3, "ev3"))
    assert not pend3["chained"]
    return d1 + d2 + d3, ex, uploads, stats2


def test_two_waves_through_executor_match_reference():
    (d_r, ex_r, up_r, st_r), (d_p, ex_p, up_p, st_p) = \
        [_three_waves(name) for name in PACKAGES]
    for a, b in zip(d_r, d_p):
        assert np.array_equal(a.picks, b.picks)
        assert [m.nodes_filtered for m in a.metrics] == \
            [m.nodes_filtered for m in b.metrics]
    keys = ("dispatches", "resident_waves", "invalidations", "uploads",
            "upload_bytes", "d2h_fetches", "d2h_bytes")
    # after the two chained waves: every count and byte equal
    assert {k: st_r[k] for k in keys} == {k: st_p[k] for k in keys}
    assert st_p["dispatches"] == 2 and st_p["resident_waves"] == 1
    assert st_p["invalidations"] == 0
    # the same uploads in the same order, with the same bytes, except
    # the third wave's delta replay: the reference pads each chunk to
    # its pad bucket with int64 rows, the port uploads the replayed
    # rows as they are, int32 (ops/engine.py's docstring).  The port's
    # resident base table is no exception here: like both packages'
    # const-cache uploads, it is not a node-state sync and is not
    # metered
    assert [c for c, _ in up_r] == [c for c, _ in up_p]
    assert [c for c, _ in up_p] == ["initial-upload", "initial-upload",
                                    "invalidation-replay"]
    assert up_r[:2] == up_p[:2]
    n_rows = up_p[2][1] // 16
    assert up_p[2][1] == 16 * n_rows
    pad = next(p for p in (512, 2048, 8192, 16384) if n_rows <= p)
    assert up_r[2][1] == 20 * pad
    assert ex_r.stats["dispatches"] == ex_p.stats["dispatches"] == 3
    assert ex_r.stats["d2h_fetches"] == ex_p.stats["d2h_fetches"]
    assert set(ex_p.upload_bytes_by_cause) == \
        set(ex_r.upload_bytes_by_cause)


def test_compile_sites_match_reference(monkeypatch):
    sites = {}
    for name in PACKAGES:
        eng_mod = pkg(name, "ops.engine")
        monkeypatch.setattr(eng_mod, "_KERNEL_SHAPES_SEEN", set())
        led = pkg(name, "core.profiling").COMPILE
        led.reset()
        _three_waves(name)
        snap = led.snapshot()
        sites[name] = {s: (v["hits"], v["misses"], v["steady_calls"])
                       for s, v in snap["sites"].items()
                       if s.startswith("engine.")}
        led.reset()
    assert sites["nomad_tpu"] == sites[PORT]
    kinds = {s.split("/")[0] for s in sites[PORT]}
    assert kinds == {"engine.multi_compact", "engine.multi_compact_chained",
                     "engine.scatter"}


def test_launch_ledger_splits_first_from_steady(monkeypatch):
    from nomad_tpu_torch.core.profiling import CompileLedger
    import nomad_tpu_torch.ops.engine as E
    led = CompileLedger()
    monkeypatch.setattr(E, "_KERNEL_SHAPES_SEEN", set())
    monkeypatch.setattr(E, "_compile_ledger", lambda: led)
    eng = _engine()
    for _ in range(3):
        assert eng._launch("multi", (64, 300, 1), lambda a, b: a + b,
                           1, 2) == 3
    # a second engine in the process shares the seen buckets
    _engine()._launch("multi", (64, 300, 1), lambda: None)
    site = led.snapshot()["sites"]["engine.multi/64x300x1"]
    assert (site["misses"], site["hits"], site["steady_calls"]) == (1, 3, 3)


def test_engine_counters_on_a_mesh():
    """nomad.engine.collective_bytes and .shard_h2d_bytes move with the
    engine's own meters (a dirty-shard patch after a node write)."""
    h = build_zoned_cluster(PORT, n_nodes=96)
    eng = PlacementEngine(device="cpu", mesh=make_mesh(8, "cpu"))
    eng.packer.attach(h.state)
    h.engine = eng
    ex = TorchExecutor(eng)
    jobs, _ = add_jobs(PORT, h, 5, 4)
    c0 = REGISTRY.counter("nomad.engine.collective_bytes")
    s0 = REGISTRY.counter("nomad.engine.shard_h2d_bytes")
    _wave(PORT, h, ex, make_evals(PORT, jobs))
    assert REGISTRY.counter("nomad.engine.collective_bytes") - c0 == \
        eng.collective_bytes > 0
    node = h.state.node_by_id("node-00007").copy()
    node.attributes["platform.rack"] = "r99"
    h.state.upsert_node(node)
    jobs2, _ = add_jobs(PORT, h, 5, 4, prefix="w2")
    _wave(PORT, h, ex, make_evals(PORT, jobs2, "ev2"))
    assert eng.shard_h2d_bytes > 0
    assert REGISTRY.counter("nomad.engine.shard_h2d_bytes") - s0 == \
        eng.shard_h2d_bytes
    assert ex.upload_bytes_by_cause.get("dirty-shard-patch", 0) > 0


def test_fetch_meters_d2h():
    eng = _engine()
    seen = []
    eng.d2h_observer = lambda nbytes, s, cause: seen.append((nbytes, cause))
    out = eng._fetch(torch.arange(12, dtype=torch.int32))
    assert out.tolist() == list(range(12))
    eng._fetch(torch.zeros(0, dtype=torch.int32))   # nothing moved
    assert seen == [(48, "result-fetch")]


# -------------------------------------------------------- nomad.ports.*

def _port_job(name, i, count):
    structs = pkg(name, "structs")
    job = pkg(name, "mock").batch_job(id=f"net-{i:03d}")
    job.task_groups[0].count = count
    job.task_groups[0].networks = [structs.NetworkResource(
        mode="host", dynamic_ports=[structs.Port(label="http")])]
    return job


@pytest.mark.parametrize("batched", [True, False])
def test_port_counters_match_reference(batched, monkeypatch):
    """The same networked evals through both packages' Harness: the
    batched port carve (nomad.ports.batched_rows) and, with
    PORT_BATCHED off, the sequential oracle (.sequential_rows)."""
    got = {}
    for name in PACKAGES:
        monkeypatch.setattr(pkg(name, "scheduler.generic"), "PORT_BATCHED",
                            batched)
        reg = pkg(name, "core.telemetry").REGISTRY
        before = (reg.counter("nomad.ports.batched_rows"),
                  reg.counter("nomad.ports.sequential_rows"))
        h = build_flat_cluster(name, n_nodes=40)
        for i, count in enumerate((70, 5, 90)):
            job = _port_job(name, i, count)
            h.state.upsert_job(job)
            ev = pkg(name, "mock").eval(
                id=f"ev-net-{i:03d}", type="batch", job_id=job.id,
                priority=job.priority, triggered_by="job-register")
            h.process("batch", ev)
        got[name] = (reg.counter("nomad.ports.batched_rows") - before[0],
                     reg.counter("nomad.ports.sequential_rows") - before[1])
    assert got["nomad_tpu"] == got[PORT]
    assert got[PORT][0 if batched else 1] > 0
