"""The mesh across parts (nomad_tpu_torch/parallel/xmesh.py) against the
reference's sharded functions and engine on the 8-device virtual CPU
mesh that tests/conftest.py sets up, and against the port's one-device
8-shard mesh.

The port's mesh here is `make_mesh(8, ["cpu"] * D)`: 8 shards over D
parts of the plain versions, each part holding its npad / D rows; the
plain versions run every part's local step on its own tensors and merge
through an explicit exchange of the parts' posts.  The cases are those
of tests/test_torch_mesh.py (padding, fewer rows a shard than the top 3,
spread and distinct_property, the water-fill rounds) and of
tests/test_torch_engine_sharded.py, for D in {2, 4, 8}.  Tolerance:
exact (every output word, the f32 scores bitcast, the usage and job
counts of every part, the engines' meters).
"""

import random
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_engine_sharded as E
import test_torch_mesh as M
from nomad_tpu.parallel import mesh as rmesh
from nomad_tpu_torch.ops.convert import (
    bulk_inputs_from_numpy,
    frames_from_numpy,
    multi_inputs_from_numpy,
    placement_inputs_from_numpy,
)
from nomad_tpu_torch.parallel import mesh as pmesh
from nomad_tpu_torch.parallel import xmesh
from torch_parity import (
    PACKAGES,
    SCATTER_ROW_CASES,
    make_node,
    pkg,
    reference_bulk_inputs,
    reference_inputs_numpy,
    reference_placement_inputs,
    scatter_case,
)

pytestmark = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs the 8-device virtual mesh")

S = 8
PARTS = [2, 4, 8]
REF, PORT = PACKAGES


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ref_mesh():
    return rmesh.make_mesh(S)


def parts(n_parts):
    return pmesh.make_mesh(S, ["cpu"] * n_parts)


def host(t):
    return t.numpy() if isinstance(t, (torch.Tensor, xmesh.Parts)) \
        else np.asarray(t)


def assert_equal(want, got):
    assert len(want) == len(got)
    for i, (w, g) in enumerate(zip(want, got)):
        w, g = host(w), host(g)
        assert w.dtype == g.dtype and w.shape == g.shape, i
        assert w.tobytes() == g.tobytes(), i


def assert_parts(out, n_parts, npad):
    """Every `Parts` output holds npad / D rows a part."""
    ps = [o for o in out if isinstance(o, xmesh.Parts)]
    assert ps
    for p in ps:
        assert len(p.blocks) == n_parts
        rows = [b.shape[p.axis] for b in p.blocks]
        assert rows == [npad // n_parts] * n_parts


# ------------------------------------------------------------------ K9

@pytest.mark.parametrize("n_parts", PARTS)
@pytest.mark.parametrize("case", sorted(M.SCAN_CASES))
def test_k9_across_parts_matches_reference(case, n_parts, ref_mesh):
    arr = M._scan_arrays(case, 0)
    want = rmesh.place_sharded_packed_fn(ref_mesh)(
        reference_placement_inputs(arr))
    inp = placement_inputs_from_numpy(arr)
    got = pmesh.place_sharded_packed(inp, parts(n_parts))
    assert_equal(want, got)
    assert_equal(got, pmesh.place_sharded_packed(inp,
                                                 pmesh.make_mesh(S, "cpu")))
    assert_parts(got, n_parts, arr["attrs"].shape[0])


@pytest.mark.parametrize("n_parts", PARTS)
def test_k9_place_sharded_across_parts(n_parts, ref_mesh):
    """`place_sharded` over parts: the reference's per-placement outputs,
    the usage and job counts gathered from the parts."""
    arr = M._place_sharded_arrays("fewer_feasible_than_top_k")
    want = rmesh.place_sharded_fn(ref_mesh)(reference_placement_inputs(arr))
    got = pmesh.place_sharded(placement_inputs_from_numpy(arr),
                              parts(n_parts))
    for f in got._fields:
        w, g = np.asarray(getattr(want, f)), host(getattr(got, f))
        assert w.dtype == g.dtype and w.shape == g.shape, f
        assert w.tobytes() == g.tobytes(), f


# ----------------------------------------------------------------- K10

@pytest.mark.parametrize("n_parts", PARTS)
@pytest.mark.parametrize("case", sorted(M.BULK_CASES))
def test_k10_across_parts_matches_reference(case, n_parts, ref_mesh):
    b, rs, rounds = M._bulk_arrays(case)
    want = rmesh.place_bulk_sharded_packed_fn(ref_mesh, rs, rounds)(
        reference_bulk_inputs(b))
    binp = bulk_inputs_from_numpy(b)
    got = pmesh.place_bulk_sharded_packed(binp, parts(n_parts), rs, rounds)
    assert_equal(want, got)
    assert_equal(got, pmesh.place_bulk_sharded_packed(
        binp, pmesh.make_mesh(S, "cpu"), rs, rounds))


# ---------------------------------------------------------- K11 / K12

@pytest.mark.parametrize("n_parts", PARTS)
@pytest.mark.parametrize("case", ["binpack", "spread", "chained",
                                  "few_feasible", "two_signatures"])
def test_k11_across_parts_matches_reference(case, n_parts, ref_mesh):
    kw = {"binpack": (150, 30, False, None),
          "spread": (300, 200, True, None),
          "chained": (150, 30, False, None),
          "few_feasible": (600, 30, True, "few_feasible"),
          "two_signatures": (150, 30, False, "two_signatures")}[case]
    rs, arrs = M._k11_arrays(*kw)
    rinp = M.reference_multi_inputs(arrs)
    inp = multi_inputs_from_numpy(arrs)
    mesh = parts(n_parts)
    if case == "chained":
        want = rmesh.place_multi_sharded_packed_fn(ref_mesh, rs,
                                                   chained=True)(
            jnp.asarray(arrs["used0"]), rinp._replace(used0=None))
        used0 = xmesh.split(inp.used0.clone(), mesh)
        got = pmesh.place_multi_sharded_chained(
            used0, inp._replace(used0=None), mesh, rs)
        assert got[1] is used0
    else:
        want = rmesh.place_multi_sharded_packed_fn(ref_mesh, rs)(rinp)
        got = pmesh.place_multi_sharded_packed(inp, mesh, rs)
        assert np.array_equal(inp.used0.numpy(), arrs["used0"])
    assert_equal(want, got)
    assert_equal(got, pmesh.place_multi_sharded_packed(
        inp, pmesh.make_mesh(S, "cpu"), rs))
    assert_parts(got, n_parts, arrs["attrs"].shape[0])


@pytest.mark.parametrize("n_parts", PARTS)
@pytest.mark.parametrize("case", ["five_lanes", "two_lanes", "chained",
                                  "spread", "round_256"])
def test_k12_across_parts_matches_reference(case, n_parts, ref_mesh):
    built = M._zoned_built(n_zones=2 if case == "two_lanes" else 5,
                           spread=case == "spread",
                           n_nodes=120 if case == "round_256" else 300,
                           count=200 if case == "round_256" else 40)
    arrs = reference_inputs_numpy(built["inp"])
    inp = multi_inputs_from_numpy(arrs)
    rs, lanes = built["rs"], built["n_lanes"]
    cr, cv = frames_from_numpy(built["cand_rows"], built["cand_valid"])
    mesh = parts(n_parts)
    if case == "chained":
        want = rmesh.place_multi_compact_sharded_fn(
            ref_mesh, rs, lanes, chained=True)(
            jnp.asarray(arrs["used0"]), built["inp"]._replace(used0=None),
            jnp.asarray(built["cand_rows"]),
            jnp.asarray(built["cand_valid"]))
        used0 = xmesh.split(inp.used0.clone(), mesh)
        got = pmesh.place_multi_compact_sharded_chained(
            used0, inp._replace(used0=None), cr, cv, mesh, rs, lanes)
        assert got[2] is used0
    else:
        want = rmesh.place_multi_compact_sharded_fn(ref_mesh, rs, lanes)(
            built["inp"], built["cand_rows"], built["cand_valid"])
        got = pmesh.place_multi_compact_sharded(inp, cr, cv, mesh, rs,
                                                lanes)
    assert_equal(want, got)
    assert_equal(got, pmesh.place_multi_compact_sharded(
        inp, cr, cv, pmesh.make_mesh(S, "cpu"), rs, lanes))
    assert_parts(got, n_parts, arrs["attrs"].shape[0])


def test_exchange_is_in_part_order():
    """The decision reads the parts' posts in part order: two parts with
    equal keys give the lower part's slot first, as the reference's
    shard-major concatenation does; only the owner part commits."""
    k = torch.tensor([[2, 2]], dtype=torch.int32)
    sc = torch.tensor([[0.5, 0.5]])
    posts = [xmesh._round_post(k, sc, torch.zeros((1, 2)),
                               torch.tensor([[10 * p, 10 * p + 1]]),
                               torch.ones((1, 2), dtype=torch.bool), 4)
             for p in range(2)]
    rows, cnt, _, c_i, placed, n_feas, _ = xmesh.xmesh_waterfill(
        posts, torch.tensor([5]), False, 4, [2, 2])
    assert rows[0].tolist() == [0, 1, 10, 11]
    assert cnt[0].tolist() == [2, 2, 1, 0]
    assert [c[0].tolist() for c in c_i] == [[2, 2], [1, 0]]
    assert int(placed[0]) == 5 and int(n_feas[0]) == 4


# ----------------------------------------------------------------- K13

@pytest.mark.parametrize("n_parts", PARTS)
@pytest.mark.parametrize("case", SCATTER_ROW_CASES)
def test_k13_across_parts_matches_reference(case, n_parts, ref_mesh):
    rng = np.random.default_rng(len(case))
    npad = 40
    used = rng.integers(0, 1000, (npad, 3)).astype(np.int32)
    rows, vals = scatter_case(case, npad, 512, rng)
    want = M._k13_reference(ref_mesh, used, rows, vals)
    mesh = parts(n_parts)
    got = xmesh.split(torch.tensor(used), mesh)
    out = pmesh.scatter_add_sharded_(got, torch.tensor(rows),
                                     torch.tensor(vals), mesh)
    assert out is got
    assert np.array_equal(want, got.numpy())


# -------------------------------------------------------------- engine

def parts_engine(n_parts):
    def make(name):
        if name == REF:
            return E.mesh_engine(name)
        from nomad_tpu_torch.ops import PlacementEngine
        return PlacementEngine(device="cpu", mesh=parts(n_parts))
    return make


def _node_blocks(engine):
    t = engine._dev_cache
    return {k: [b.shape[0] for b in v.blocks] for k, v in t.items()}


@pytest.mark.parametrize("n_parts", [2, 4])
def test_engine_bulk_and_scan_match_reference(n_parts):
    """place(): the bulk rounds (K10) and the spread scan (K9) through
    the engine on a mesh of parts, against the reference's mesh engine;
    each part holds npad / D rows of every node tensor."""
    make = parts_engine(n_parts)
    got = {name: E.place_bulk(name, E.build(name, 203, seed=3, engine=make),
                              700, 13) for name in PACKAGES}
    E.assert_bulk_equal(got[REF], got[PORT])
    out = {}
    for name in PACKAGES:
        h = E.build(name, 203, seed=7, engine=make)
        job = E._spread_job(name)
        h.state.upsert_job(job)
        req = pkg(name, "ops").PlacementRequest
        reqs = [req(tg_name=job.task_groups[0].name)] * 40
        out[name] = (h.engine.place(h.state.snapshot(), job,
                                    job.task_groups, reqs, seed=13),
                     h.engine.collective_bytes, h.engine)
    ref, port = out[REF][0], out[PORT][0]
    assert [d.node_id for d in ref] == [d.node_id for d in port]
    assert [E.metric_key(d.metric) for d in ref] == \
        [E.metric_key(d.metric) for d in port]
    assert out[REF][1] == out[PORT][1] > 0
    npad = pmesh.pad_nodes(203, S)
    assert set(map(tuple, _node_blocks(out[PORT][2]).values())) == {
        (npad // n_parts,) * n_parts}
    assert [b.shape[0] for b in out[PORT][2]._used_dev.blocks] == \
        [npad // n_parts] * n_parts


@pytest.mark.parametrize("n_parts", [2, 8])
def test_engine_flat_and_zoned_waves_match_reference(n_parts):
    """dispatch/collect of a flat wave (K11), a zoned wave (K12) and a
    zoned wave chained on its usage, against the reference's mesh
    engine: the packed buffers byte for byte, decisions, meters."""
    make = parts_engine(n_parts)
    res = {}
    for name in PACKAGES:
        h = E.build(name, 603, seed=5, engine=make)
        items = E._batch(name, h, [150, 40, 700, 5, 260])
        pend = h.engine.dispatch_batch(h.state.snapshot(), items, seed=21)
        res[name] = [(E._pending_buf(pend), h.engine.collect_batch(pend),
                      pend["collective_bytes"])]
        h, items = E._zoned(name, engine=make)
        ex = pkg(name, "ops.executor").make_executor(
            "jax" if name == REF else "torch", h.engine)
        p1 = ex.dispatch_batch(h.state.snapshot(), items, seed=9)
        d1 = ex.collect_batch(p1)
        p2 = ex.dispatch_batch(h.state.snapshot(), items, seed=10,
                               used0_dev=ex.chain_state(p1))
        d2 = ex.collect_batch(p2)
        assert p2["chained"]
        res[name] += [(E._pending_buf(p), d, p["collective_bytes"])
                      for p, d in ((p1, d1), (p2, d2))]
        if name == PORT:
            used = p2["used"]
            assert isinstance(used, xmesh.Parts)
            assert len(used.blocks) == n_parts
    for (rb, rd, rc), (pb, pd, pc) in zip(res[REF], res[PORT]):
        assert rb.tobytes() == pb.tobytes()
        for a, b in zip(rd, pd):
            E.assert_bulk_equal(a, b)
        assert rc == pc > 0


def test_dirty_shard_patch_uploads_to_owning_part():
    """One node's eligibility write re-uploads only its shard, to the
    part that owns it (the other part's blocks stay the same tensors),
    and shard_h2d_bytes equals the reference's."""
    make = parts_engine(2)
    hs = {name: E.build(name, 64, seed=11, engine=make) for name in PACKAGES}
    for name, h in hs.items():
        E.place_bulk(name, h, 80, 1, jid="one")
    port = hs[PORT].engine
    before = {k: list(v.blocks) for k, v in port._dev_cache.items()}
    for h in hs.values():
        h.state.update_node_eligibility(h.state.snapshot().nodes()[0].id,
                                        "ineligible")
    got = {name: E.place_bulk(name, h, 80, 2, jid="two")
           for name, h in hs.items()}
    E.assert_bulk_equal(got[REF], got[PORT])
    sb = {name: h.engine.shard_h2d_bytes for name, h in hs.items()}
    assert sb[REF] == sb[PORT] > 0
    after = port._dev_cache
    for k, blocks in before.items():
        # node-00000 lies in shard 0, part 0: part 1 keeps its block
        assert after[k].blocks[1] is blocks[1]
        assert after[k].blocks[0] is not blocks[0]
    assert 0 not in got[PORT].picks.tolist()


@pytest.mark.parametrize("n_nodes", [13, 16])
def test_system_and_service_jobs_on_parts(n_nodes):
    """Harness.process (a system job: K8 once a part; a service job:
    K9) through the engine on 2 parts, against the reference's mesh
    engine."""
    make = parts_engine(2)
    views = {}
    for name in PACKAGES:
        h = E.build(name, n_nodes, seed=5, engine=make)
        job = pkg(name, "mock").system_job(id="sys")
        job.datacenters = ["dc1", "dc2", "dc3"]
        h.state.upsert_job(job)
        ev = E.eval_for(name, job)
        h.state.upsert_evals([ev])
        assert h.process("system", ev, now=1.7e9) is None
        svc = pkg(name, "mock").job(id="service")
        svc.datacenters = ["dc1", "dc2", "dc3"]
        svc.task_groups[0].count = 5
        h.state.upsert_job(svc)
        ev = E.eval_for(name, svc)
        h.state.upsert_evals([ev])
        assert h.process("service", ev, now=1.7e9) is None
        views[name] = E.view(h)
    assert views[REF] == views[PORT]


# -------------------------------------------------------------- server

NOW = 1_700_000_000.0


@pytest.fixture
def pinned(monkeypatch):
    import os
    stream = {}
    monkeypatch.setattr(os, "urandom",
                        lambda n: stream["rng"].randbytes(n))

    def reset(seed: int = 0) -> None:
        stream["rng"] = random.Random(seed)
        for name in PACKAGES:
            pkg(name, "structs.structs")._ID_POOL.clear()
        random.seed(seed)

    return reset


def _threaded_server_wave(name, **kw):
    """Six batch jobs of 8 on ten nodes through a threaded Server (one
    worker) until every eval settles: the (job, name, node, cpu)
    fingerprint, and the engine's shard count."""
    mock = pkg(name, "mock")
    clock = pkg(name, "chaos.clock").VirtualClock(start=NOW, epoch=0.0)
    s = pkg(name, "core.server").Server(
        clock=clock, profile_hz=0, dev_mode=False, num_workers=1,
        eval_batch=8, heartbeat_ttl=1e9, **kw)
    try:
        s.establish_leadership()
        for i in range(10):
            s.register_node(make_node(name, i, cpu=2000 + 500 * (i % 3)),
                            now=NOW)
        evals = []
        for i in range(6):
            j = mock.batch_job(id=f"batch-{i}")
            j.task_groups[0].count = 8
            j.task_groups[0].tasks[0].resources.cpu = 150
            j.task_groups[0].tasks[0].resources.memory_mb = 64
            s.state.upsert_job(j)
            evals.append(mock.eval(id=f"eval-batch-{i}", job_id=j.id,
                                   type="batch", priority=j.priority))
        s.apply_eval_update(evals, now=NOW)
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
        snap = s.state.snapshot()
        return sorted((a.job_id, a.name, a.node_id, a.resources.cpu)
                      for j in snap.jobs()
                      for a in snap.allocs_by_job(j.namespace, j.id)
                      if not a.terminal_status()), s.engine.n_devices
    finally:
        s.shutdown()
        clock.close()


def test_threaded_server_on_parts_matches_reference(pinned):
    """A threaded port Server on a 2-part, 8-shard mesh places what the
    reference's auto-sharded Server (mesh=None over the 8 virtual
    devices) places."""
    threads0 = set(threading.enumerate())
    pinned(3)
    ref, ref_n = _threaded_server_wave(REF, mesh=None)
    pinned(3)
    port, port_n = _threaded_server_wave(PORT, device="cpu",
                                         mesh=parts(2))
    assert ref_n == port_n == S
    assert len(ref) == 48 and port == ref
    leftover = [t for t in threading.enumerate()
                if t not in threads0 and t.is_alive()]
    assert not leftover, leftover


# ------------------------------------------------------ automatic mesh

def test_automatic_mesh_rule(monkeypatch):
    """`PlacementEngine(mesh=None)` builds the automatic mesh (one shard
    a card, the engine's card first) when its device is CUDA and more
    than one card is visible, as the reference's engine does over every
    device; a CPU engine builds nothing, and mesh=False stays one
    device."""
    from nomad_tpu_torch.ops import PlacementEngine
    from nomad_tpu_torch.ops import engine as eng_mod
    built = []

    def fake_default(home=None):
        built.append(home)
        return pmesh.make_mesh(4, ["cpu"] * 4)

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(eng_mod.pmesh, "default_mesh", fake_default)
    assert PlacementEngine(device="cpu").mesh is None
    assert PlacementEngine(device="cpu", mesh=False).mesh is None
    assert built == []
    # a CUDA engine: the automatic mesh (refused here only because its
    # stand-in lies on the CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="mesh lies on"):
        PlacementEngine(device="cuda:1")
    assert built == [torch.device("cuda:1")]
    with pytest.raises(ValueError, match="mesh lies on"):
        PlacementEngine(device="cuda:1", mesh=None)
    # one card: no mesh is built, the engine stays one device
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert PlacementEngine(device="cuda:0").mesh is None
    assert len(built) == 2


def test_default_mesh_covers_every_card(monkeypatch):
    """`default_mesh()`: one part a card, one shard a part, the home card
    first; peer access between every pair is read, and with it the parts
    meet in the home card's memory; a pair without it puts the exchange
    in host memory instead of refusing the mesh."""
    checked = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda a, b: checked.append((a, b)) or True)
    m = pmesh.default_mesh("cuda:2")
    assert [d.index for d in m.parts] == [2, 0, 1]
    assert (m.n_shards, m.n_parts, m.shards_per_part) == (3, 3, 1)
    assert sorted(checked) == [(a, b) for a in range(3) for b in range(3)
                               if a != b]
    assert m.exchange == "device"
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda a, b: False)
    assert pmesh.make_mesh(2, ["cuda:0", "cuda:1"]).exchange == "host"


def _no_peer_host(monkeypatch, n_cards, missing):
    """A mocked host of `n_cards` cards where the ordered pairs in
    `missing` (all pairs for None) lack peer access."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n_cards)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(
        torch.cuda, "can_device_access_peer",
        lambda a, b: missing is not None and (a, b) not in missing)


@pytest.mark.parametrize("missing", [None, {(1, 0)}],
                         ids=["no_pair", "one_pair"])
@pytest.mark.parametrize("n_cards", [2, 4])
def test_mesh_without_peer_access_exchanges_in_host_memory(
        monkeypatch, n_cards, missing):
    """Where a pair of the cards lacks peer access, `make_mesh`,
    `default_mesh` and `PlacementEngine()` build a mesh whose parts meet
    in host memory (as the reference shards over every device with no
    such condition); two parts of one card still meet in its memory, and
    the private override forces the host exchange there too."""
    from nomad_tpu_torch.ops import PlacementEngine

    _no_peer_host(monkeypatch, n_cards, missing)
    cards = [f"cuda:{i}" for i in range(n_cards)]
    m = pmesh.make_mesh(8, cards)
    assert m.exchange == "host" and m.parts == [torch.device(c)
                                                for c in cards]
    auto = pmesh.default_mesh()
    assert auto.exchange == "host" and auto.n_parts == n_cards
    eng = PlacementEngine()
    assert eng.mesh.exchange == "host"
    assert eng.mesh.n_parts == eng.mesh.n_shards == n_cards
    assert pmesh.make_mesh(8, ["cuda:1", "cuda:1"]).exchange == "device"
    monkeypatch.setattr(pmesh, "_FORCE_HOST_EXCHANGE", True)
    assert pmesh.make_mesh(8, ["cuda:0", "cuda:0"]).exchange == "host"
    assert pmesh.make_mesh(8, ["cpu", "cpu"]).exchange == "device"


def test_host_exchange_pool_reuses_a_read_buffer(monkeypatch):
    """A "host" mesh's exchange buffers: a call takes a free one and
    keeps it until its error word is read, which the next call's buffer
    then reuses; a larger call gets a larger buffer.  The allocation is
    faked in ordinary host memory (no card here)."""
    import ctypes

    keep = []

    class _Alloc:
        def __call__(self, nbytes, out_ptr):
            a = (ctypes.c_int32 * (nbytes // 4))()
            keep.append(a)
            ctypes.c_int64.from_address(out_ptr).value = ctypes.addressof(a)
            return 0

    class _Fns:
        def fn(self, name):
            return _Alloc() if name == "xmesh_host_alloc" else (lambda p: 0)

    monkeypatch.setattr(xmesh.K, "PLACE_SCAN_XMESH", _Fns())
    mesh = pmesh.make_mesh(S, ["cpu"] * 2)
    a = xmesh._host_buf(mesh, 100)
    a.view[:3] = torch.tensor([1, 2, 3], dtype=torch.int32)
    b = xmesh._host_buf(mesh, 100)
    assert a is not b and a.words == b.words == 4096
    word = xmesh._HostWord(a)
    assert word[0] == 1 and not a.busy      # read: free again
    assert xmesh._host_buf(mesh, 100) is a
    big = xmesh._host_buf(mesh, 5000)
    assert big.words == 5000 and len(mesh._host_bufs) == 3
    assert xmesh._HostWord(b)[0] == 0 and not b.busy
    assert xmesh._host_buf(mesh, 10) is b


def test_default_mesh_takes_at_most_max_parts_cards(monkeypatch):
    """On a host of more cards than a mesh has parts, the automatic mesh
    takes the home card and the next MAX_PARTS - 1 (a plain `Server()`
    there shards rather than raises)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 12)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda a, b: True)
    m = pmesh.default_mesh("cuda:3")
    assert [d.index for d in m.parts] == [3, 0, 1, 2, 4, 5, 6, 7]
    assert (m.n_shards, m.n_parts) == (pmesh.MAX_PARTS, pmesh.MAX_PARTS)


# ------------------------------------------- the error words of launches

class _Done:
    """A launch's completion event as `check` reads it."""

    def __init__(self, done: bool = True):
        self.done = done
        self.waited = 0

    def query(self) -> bool:
        return self.done

    def synchronize(self) -> None:
        self.waited += 1
        self.done = True


def _launch(name, failed, done=True):
    return (name, torch.tensor([int(failed)], dtype=torch.int32),
            _Done(done))


def test_check_reads_the_callers_launches():
    """`check` reads the calling thread's launches across parts, or the
    launches a wave's dispatch handed over (`take`) to its collect: a
    part that ran out its deadline raises in the thread whose launch it
    was, never in another's, and no launch is dropped; `wait=False`
    keeps a launch whose error word is not back yet."""
    mesh = pmesh.make_mesh(S, ["cpu"] * 2)
    seen = {}

    def other():
        xmesh._unchecked(mesh).append(_launch("multi_flat_xmesh", True))
        try:
            xmesh.check(mesh)
        except RuntimeError as e:
            seen["error"] = str(e)

    xmesh._unchecked(mesh).append(_launch("multi_compact_xmesh", False))
    t = threading.Thread(target=other)
    t.start()
    t.join()
    assert "multi_flat_xmesh" in seen["error"]
    xmesh.check(mesh)                   # this thread's launch is clean
    assert xmesh._unchecked(mesh) == []
    # a wave's launches: handed from its dispatch to its collect
    xmesh._unchecked(mesh).append(_launch("multi_compact_xmesh", True))
    wave = xmesh.take(mesh)
    xmesh.check(mesh)                   # nothing left on this thread
    with pytest.raises(RuntimeError, match="multi_compact_xmesh"):
        xmesh.check(mesh, wave)
    # not back yet: kept by wait=False, waited for by the next check
    late = _launch("place_scan_xmesh", True, done=False)
    xmesh._unchecked(mesh).append(late)
    xmesh.check(mesh, wait=False)
    assert xmesh._unchecked(mesh) == [late] and late[2].waited == 0
    with pytest.raises(RuntimeError, match="place_scan_xmesh"):
        xmesh.check(mesh)
    assert late[2].waited == 1 and xmesh._unchecked(mesh) == []


def test_k13_staging_slot_waits_for_its_launches(monkeypatch):
    """K13's staging ring reuses a slot only once each card's last
    launch on it has stored the slot's use number in its done word; a
    word that never comes raises instead of hanging."""
    import numpy as np

    done = np.zeros(xmesh._K13_HEAD, dtype=np.int32)
    xmesh._k13_slot_free(done, 3, 0, 2)          # never used: free
    done[3] = 1
    done[xmesh.K13_SLOTS + 3] = 1
    xmesh._k13_slot_free(done, 3, 1, 2)          # both cards said done
    monkeypatch.setattr(xmesh, "K13_WAIT_S", 0.05)
    done[xmesh.K13_SLOTS + 3] = 0                # card 1 has not
    with pytest.raises(RuntimeError, match="staging slot 3"):
        xmesh._k13_slot_free(done, 3, 1, 2)
