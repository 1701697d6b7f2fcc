"""The port's mesh engine against the reference's mesh engine, on the
cases of tests/test_engine_sharded.py, and against the port's own
single-device engine on bench.py's `_sharded_parity_gate` criteria.

Both packages build the same cluster from explicit ids and a seeded RNG.
The reference shards over the 8 virtual CPU devices that
tests/conftest.py sets up (`make_mesh()`); the port runs `make_mesh(8, "cpu")`, its plain
versions of K9-K13.  Tolerance: exact (picks in order, metrics, the
packed buffers byte for byte, f32 scores as bits, and the engines'
`shard_h2d_bytes` and `collective_bytes` meters).
"""

import random

import jax
import numpy as np
import pytest
import torch

from torch_parity import (
    PACKAGES,
    add_jobs,
    build_zoned_cluster,
    eval_for,
    harness,
    pkg,
    view,
)

pytestmark = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs the 8-device virtual mesh")

REF, PORT = PACKAGES


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def mesh_engine(name):
    if name == REF:
        from nomad_tpu.ops import PlacementEngine
        from nomad_tpu.parallel.mesh import make_mesh
        return PlacementEngine(mesh=make_mesh(8))
    from nomad_tpu_torch.ops import PlacementEngine
    from nomad_tpu_torch.parallel import make_mesh
    return PlacementEngine(device="cpu", mesh=make_mesh(8, "cpu"))


def single_engine(name):
    from torch_parity import engine
    return engine(name)


def build(name, n_nodes, seed=0, engine=mesh_engine):
    """tests/test_engine_sharded.py's cluster, with ids node-00000...:
    3 DCs, 20 racks, random node sizes; a Harness whose engine is
    `engine(name)`, attached to the store."""
    mock = pkg(name, "mock")
    rng = random.Random(seed)
    h = harness(name)
    h.engine = engine(name)
    h.engine.packer.attach(h.state)
    nodes = []
    for i in range(n_nodes):
        n = mock.node(id=f"node-{i:05d}")
        n.datacenter = f"dc{1 + i % 3}"
        n.attributes["platform.rack"] = f"r{i % 20}"
        n.resources.cpu = rng.choice([4000, 8000, 16000])
        n.resources.memory_mb = rng.choice([8192, 16384, 32768])
        nodes.append(n)
    h.state.upsert_nodes(nodes)
    return h


def batch_job(name, jid, count, cpu, mem):
    mock = pkg(name, "mock")
    job = mock.batch_job(id=jid)
    job.datacenters = ["dc1", "dc2", "dc3"]
    tg = job.task_groups[0]
    tg.count = count
    tg.tasks[0].resources.cpu = cpu
    tg.tasks[0].resources.memory_mb = mem
    return job


def metric_key(m):
    return (m.nodes_evaluated, m.nodes_filtered, m.nodes_in_pool,
            m.nodes_exhausted, dict(m.dimension_exhausted),
            [(s.node_id, np.float32(s.norm_score).view(np.int32).item())
             for s in m.score_meta_data])


def place_bulk(name, h, count, seed, cpu=100, mem=64, jid="bulk"):
    job = batch_job(name, jid, count, cpu, mem)
    h.state.upsert_job(job)
    snap = h.state.snapshot()
    return h.engine.place(snap, job, job.task_groups, None, bulk_api=True,
                          seed=seed, block=(job.task_groups[0].name, count))


def assert_bulk_equal(a, b):
    assert np.array_equal(np.asarray(a.picks), np.asarray(b.picks))
    assert [metric_key(m) for m in a.metrics] == \
        [metric_key(m) for m in b.metrics]


def test_mesh_engine_rules():
    from nomad_tpu_torch.ops import PlacementEngine
    from nomad_tpu_torch.parallel import make_mesh
    eng = mesh_engine(PORT)
    assert eng.n_devices == 8 and eng.device.type == "cpu"
    assert eng.padded_row_fraction(13) == 3 / 16
    assert PlacementEngine(device="cpu", mesh=False).mesh is None
    assert PlacementEngine(device="cpu").n_devices == 1
    with pytest.raises(TypeError):
        PlacementEngine(device="cpu", mesh=8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            PlacementEngine(mesh=make_mesh(8, "cuda"))
        with pytest.raises(ValueError, match="mesh lies on"):
            PlacementEngine(device="cpu", mesh=make_mesh(8, "meta"))


@pytest.mark.parametrize("n_nodes,count", [(1200, 2000), (13, 400)])
def test_bulk_plan_matches_reference(n_nodes, count):
    """K10 through place(bulk_api=True); 13 nodes pads 3 rows, and the
    batch oversubscribes them: no pick lands on padding and padding is
    not counted as filtered."""
    cpu, mem = (100, 64) if count == 2000 else (2000, 1024)
    got = {name: place_bulk(name, build(name, n_nodes, seed=3), count, 13,
                            cpu, mem) for name in PACKAGES}
    assert_bulk_equal(got[REF], got[PORT])
    picks = got[PORT].picks
    assert picks.max() < n_nodes
    assert got[PORT].metrics[0].nodes_evaluated == n_nodes
    solo = place_bulk(PORT, build(PORT, n_nodes, seed=3,
                                  engine=single_engine), count, 13, cpu, mem)
    assert np.array_equal(np.sort(picks), np.sort(solo.picks))
    assert [m.nodes_filtered for m in got[PORT].metrics] == \
        [m.nodes_filtered for m in solo.metrics]


def _spread_job(name):
    structs = pkg(name, "structs")
    mock = pkg(name, "mock")
    job = mock.job(id="spread")
    job.datacenters = ["dc1", "dc2", "dc3"]
    tg = job.task_groups[0]
    tg.count = 90
    tg.tasks[0].resources.cpu = 50
    tg.tasks[0].resources.memory_mb = 32
    job.spreads = [structs.Spread(
        attribute="${node.datacenter}", weight=50,
        targets=[structs.SpreadTarget("dc1", 50),
                 structs.SpreadTarget("dc2", 30),
                 structs.SpreadTarget("dc3", 20)])]
    job.affinities = [structs.Affinity("${attr.platform.rack}",
                                       structs.OP_EQ, "r3", weight=50)]
    return job


def test_scan_with_spread_matches_reference():
    """K9 through place(): picks in order, scores as bits, metrics."""
    out = {}
    for name in PACKAGES + ("single",):
        pk = PORT if name == "single" else name
        h = build(pk, 1203, seed=7,
                  engine=single_engine if name == "single" else mesh_engine)
        job = _spread_job(pk)
        h.state.upsert_job(job)
        req = pkg(pk, "ops").PlacementRequest
        reqs = [req(tg_name=job.task_groups[0].name)] * 90
        out[name] = (h.engine.place(h.state.snapshot(), job,
                                    job.task_groups, reqs, seed=13),
                     h.engine.collective_bytes)
    ref, port = out[REF][0], out[PORT][0]
    assert [d.node_id for d in ref] == [d.node_id for d in port]
    assert [np.float32(d.score).view(np.int32) for d in ref] == \
        [np.float32(d.score).view(np.int32) for d in port]
    assert [metric_key(d.metric) for d in ref] == \
        [metric_key(d.metric) for d in port]
    assert out[REF][1] == out[PORT][1] > 0
    # the single-device scan picks the same nodes in the same order
    assert [d.node_id for d in out["single"][0]] == \
        [d.node_id for d in port]
    assert [d.metric.nodes_filtered for d in out["single"][0]] == \
        [d.metric.nodes_filtered for d in port]


def _batch(name, h, counts, prefix="job"):
    BatchItem = pkg(name, "ops.engine").BatchItem
    items = []
    for i, c in enumerate(counts):
        job = batch_job(name, f"{prefix}-{i:03d}", c, 80, 48)
        h.state.upsert_job(job)
        items.append(BatchItem(job=job, tg=job.task_groups[0], count=c))
    return items


def _pending_buf(pending):
    b = pending["buf"]
    return b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)


def test_multi_eval_flat_batch_matches_reference():
    """K11 through dispatch/collect: the packed buffer byte for byte,
    per-eval decisions, the collective meter; and the port's single
    device engine on the parity gate's criteria."""
    counts = [150, 40, 700, 5, 260, 90, 1, 330]
    res = {}
    for name in PACKAGES:
        h = build(name, 603, seed=5)
        items = _batch(name, h, counts)
        pend = h.engine.dispatch_batch(h.state.snapshot(), items, seed=21)
        res[name] = (_pending_buf(pend), h.engine.collect_batch(pend),
                     pend["collective_bytes"], h.engine.collective_bytes)
    assert res[REF][0].tobytes() == res[PORT][0].tobytes()
    for a, b in zip(res[REF][1], res[PORT][1]):
        assert_bulk_equal(a, b)
    assert res[REF][2] == res[PORT][2] > 0
    assert res[REF][3] == res[PORT][3]
    h1 = build(PORT, 603, seed=5, engine=single_engine)
    solo = h1.engine.place_batch(h1.state.snapshot(), _batch(PORT, h1,
                                                             counts), seed=21)
    for a, b in zip(solo, res[PORT][1]):
        assert np.array_equal(np.sort(a.picks), np.sort(b.picks))
        assert [m.nodes_filtered for m in a.metrics] == \
            [m.nodes_filtered for m in b.metrics]


def _zoned(name, engine=mesh_engine):
    h = build_zoned_cluster(name, n_nodes=301, n_zones=5)
    h.engine = engine(name)
    h.engine.packer.attach(h.state)
    _, items = add_jobs(name, h, 11, 40, zones=5)
    return h, items


def test_zoned_laned_batch_matches_reference():
    """K12: per-shard frames [8, 5, Nc_loc], the packed buffers byte for
    byte, the frames themselves, decisions and the collective meter; the
    port's single-device engine agrees on the parity gate's criteria."""
    res = {}
    for name in PACKAGES:
        h, items = _zoned(name)
        built = h.engine.build_multi_inputs(h.state.snapshot(), items,
                                            seed=9)
        pend = h.engine.dispatch_batch(h.state.snapshot(), items, seed=9)
        res[name] = (built, _pending_buf(pend), h.engine.collect_batch(pend),
                     pend["collective_bytes"])
    rb, pb = res[REF][0], res[PORT][0]
    assert rb["cand_rows"].shape[:2] == (8, 5)
    assert np.array_equal(rb["cand_rows"], pb["cand_rows"])
    assert np.array_equal(np.asarray(rb["inp"].job_count0),
                          pb["inp"].job_count0.numpy())
    assert res[REF][1].tobytes() == res[PORT][1].tobytes()
    for a, b in zip(res[REF][2], res[PORT][2]):
        assert_bulk_equal(a, b)
    assert res[REF][3] == res[PORT][3] > 0
    h1, items1 = _zoned(PORT, engine=single_engine)
    solo = h1.engine.place_batch(h1.state.snapshot(), items1, seed=9)
    for a, b in zip(solo, res[PORT][2]):
        assert np.array_equal(np.sort(a.picks), np.sort(b.picks))
        assert [m.nodes_filtered for m in a.metrics] == \
            [m.nodes_filtered for m in b.metrics]


@pytest.mark.parametrize("wave", ["flat", "zoned"])
@pytest.mark.parametrize("engine", ["mesh", "single"])
def test_refuted_nodes_match_reference(engine, wave):
    """A wave with refuted nodes (`masked_node_ids`, the wave pipeline's
    refute-repair input): the port ANDs its node_ok row into K1's mask
    (and into the lane prover's masks), the reference into `elig` before
    K1.  The packed buffers byte for byte and the decisions agree, and
    no pick lands on a refuted node."""
    make = mesh_engine if engine == "mesh" else single_engine
    res = {}
    for name in PACKAGES:
        if wave == "flat":
            h = build(name, 603, seed=5, engine=make)
            items = _batch(name, h, [150, 40, 700, 5, 260])
        else:
            h, items = _zoned(name, engine=make)
        masked = [f"node-{i:05d}" for i in range(0, 300, 7)]
        pend = h.engine.dispatch_batch(h.state.snapshot(), items, seed=21,
                                       masked_node_ids=masked)
        if name == PORT:
            assert (pend["cand_rows"] is None) == (wave == "flat")
        res[name] = (_pending_buf(pend), h.engine.collect_batch(pend),
                     h.engine.packer.update(h.state.snapshot()))
    assert res[REF][0].tobytes() == res[PORT][0].tobytes()
    for a, b in zip(res[REF][1], res[PORT][1]):
        assert_bulk_equal(a, b)
    t = res[PORT][2]
    refuted = {t.id_to_row[f"node-{i:05d}"] for i in range(0, 300, 7)}
    picks = np.concatenate([np.asarray(d.picks) for d in res[PORT][1]])
    assert picks.size and not refuted & set(picks.tolist())


def test_padded_rows_after_gc_shrink_across_shard():
    """13 -> 7 nodes on 8 shards (npad 16 -> 8, every row remaps)."""
    hs = {name: build(name, 13, seed=9) for name in PACKAGES}
    first = {name: place_bulk(name, h, 80, 2, 1000, 512, "a")
             for name, h in hs.items()}
    assert_bulk_equal(first[REF], first[PORT])
    for h in hs.values():
        for nd in h.state.snapshot().nodes()[7:]:
            h.state.delete_node(nd.id)
    second = {name: place_bulk(name, h, 80, 4, 1000, 512, "b")
              for name, h in hs.items()}
    assert_bulk_equal(second[REF], second[PORT])
    picks = second[PORT].picks
    assert picks[picks >= 0].max() < 7
    assert second[PORT].metrics[0].nodes_evaluated == 7


def test_dirty_shard_patch_meters_match_reference():
    """One node's eligibility write re-uploads only its shard: the port's
    shard_h2d_bytes equals the reference's, and the patched engines keep
    picking alike (never the drained node)."""
    hs = {name: build(name, 64, seed=11) for name in PACKAGES}
    for name, h in hs.items():
        place_bulk(name, h, 80, 1, jid="one")
    b0 = {name: h.engine.shard_h2d_bytes for name, h in hs.items()}
    assert b0[REF] == b0[PORT] == 0
    for h in hs.values():
        h.state.update_node_eligibility(h.state.snapshot().nodes()[0].id,
                                        "ineligible")
    got = {name: place_bulk(name, h, 80, 2, jid="two")
           for name, h in hs.items()}
    assert_bulk_equal(got[REF], got[PORT])
    sb = {name: h.engine.shard_h2d_bytes for name, h in hs.items()}
    assert sb[REF] == sb[PORT] > 0
    assert 0 not in got[PORT].picks.tolist()


def test_full_scheduler_on_mesh_engine():
    """Harness.process through each package's mesh engine: the same
    allocs, metrics and eval updates."""
    views = {}
    for name in PACKAGES:
        h = build(name, 500, seed=0)
        mock = pkg(name, "mock")
        job = mock.job(id="service")
        job.datacenters = ["dc1", "dc2", "dc3"]
        job.task_groups[0].count = 40
        h.state.upsert_job(job)
        ev = eval_for(name, job)
        h.state.upsert_evals([ev])
        assert h.process("service", ev, now=1.7e9) is None
        placed = sum(len(a) for a in h.plans[-1].node_allocation.values())
        assert placed == 40
        views[name] = view(h)
    assert views[REF] == views[PORT]


@pytest.mark.parametrize("n_nodes", [13, 16])
def test_system_job_on_mesh_engine(n_nodes):
    """A system job through each package's mesh engine (make_mesh(8)):
    one alloc per node, with the same allocs, metrics and eval updates.
    At 13 nodes the engine's node arrays pad to 16 rows, and the job's
    datacenter and pool masks pad with them (K8's [G, npad] mask; no
    alloc on a padding row)."""
    views = {}
    for name in PACKAGES:
        h = build(name, n_nodes, seed=5)
        job = pkg(name, "mock").system_job(id="sys")
        job.datacenters = ["dc1", "dc2", "dc3"]
        h.state.upsert_job(job)
        ev = eval_for(name, job)
        h.state.upsert_evals([ev])
        assert h.process("system", ev, now=1.7e9) is None
        plan = h.plans[-1].node_allocation
        assert sum(len(a) for a in plan.values()) == n_nodes
        assert len(plan) == n_nodes
        views[name] = view(h)
    assert views[REF] == views[PORT]
