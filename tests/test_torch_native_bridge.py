"""The native CUDA bridge's executor on the CPU (nomad_tpu_torch/native/
bridge.py, ops/executor.py BridgeExecutor), with `PlainBridge` in place
of the library: the same waves through `BridgeExecutor`, `TorchExecutor`
and the reference's `JaxExecutor` on the same cluster and seeds (a zoned
wave, a chained one, two unchained waves with a commit between them, a
node write that drops the chain, refuted-node masks on the laned and
flat programs), the bridge's handle bookkeeping, its programs against
the plain functions and the reference's jitted ones, the `make_executor`
rules beside the reference's, and `server { device_executor = "bridge" }`
from the agent config to a threaded Server.  The library itself is held
against the Python launchers on the card (tests/test_torch_kernels.py,
`-k bridge`)."""

import copy
import gc
import time
import zlib

import numpy as np
import pytest
import torch

from nomad_tpu_torch.native.bridge import (
    BridgeError,
    CudaBridge,
    PlainBridge,
    bulk_program,
    multi_program,
    program_inputs,
)
from nomad_tpu_torch.ops import PlacementEngine
from nomad_tpu_torch.ops.executor import (
    BridgeExecutor,
    ExecutorUnavailable,
    TorchExecutor,
    make_executor,
)
from nomad_tpu_torch.parallel import make_mesh
from torch_parity import (
    add_jobs,
    add_zoned_cluster,
    build_zoned_cluster,
    make_evals,
    pkg,
)

PORT = "nomad_tpu_torch"
REF = "nomad_tpu"
# the three runs of the same waves: the reference, the port's two backends
RUNS = (REF, "torch", "bridge")


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _executor(run, engine):
    if run == REF:
        return pkg(REF, "ops.executor").JaxExecutor(engine)
    if run == "torch":
        return TorchExecutor(engine)
    return BridgeExecutor(engine, bridge=PlainBridge())


def _host(x):
    """A copy on the host (a chained torch wave later updates the usage
    tensor it was handed in place)."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy().copy()
    return np.array(x, copy=True)


def _metrics(m):
    return (m.nodes_filtered, m.nodes_exhausted,
            dict(m.dimension_exhausted),
            [(s.node_id, np.float32(s.norm_score).view(np.int32).item())
             for s in m.score_meta_data])


def _wave(name, h, ex, evals, used0_dev=None, masked=None):
    """The worker's batched flow through an executor (prepare_batch per
    eval, one dispatch/collect, submit/finalize per eval).  Returns
    (pending, what the wave gave: picks, metrics, the packed buffer and
    the usage as host arrays)."""
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
    pending = ex.dispatch_batch(snap, items, seed=seeds, used0_dev=used0_dev,
                                masked_node_ids=masked)
    decisions = ex.collect_batch(pending)
    got = {"picks": [d.picks.tolist() for d in decisions],
           "nodes": {d.node_ids[r] for d in decisions for r in d.picks},
           "metrics": [[_metrics(m) for m in d.metrics] for d in decisions],
           "buf": _host(pending["buf"]), "used": _host(pending["used"]),
           "chained": bool(pending["chained"]),
           "compact": pending.get("fill_k") is not None}
    for ev, s, prep, bd in zip(evals, scheds, preps, decisions):
        assert s.finalize_batched(ev, s.submit_batched(ev, prep, bd)) is None
    return pending, got


# (wave, jobs, placements each, zones: 0 = one signature, the flat
# program)
WAVES = (("zoned", 10, 30, 5), ("chained", 10, 30, 5),
         ("after_commit_1", 10, 30, 5), ("after_commit_2", 10, 30, 5),
         ("after_node_write", 10, 30, 5), ("masked_zoned", 10, 30, 5),
         ("flat", 6, 40, 0), ("masked_flat", 6, 40, 0))


def _run(run):
    """The waves of WAVES through one run's executor on a 200-node zoned
    cluster.  Returns ({wave: what it gave}, the executor, its bridge's
    live buffers after each collect)."""
    name = REF if run == REF else PORT
    h = build_zoned_cluster(name, n_nodes=200)
    jobs = {w: add_jobs(name, h, n, c, zones=z, prefix=w)[0]
            for w, n, c, z in WAVES}
    ex = _executor(run, h.engine)
    ex.attach_store(h.state)
    out, live = {}, []

    def wave(w, **kw):
        pend, out[w] = _wave(name, h, ex, make_evals(name, jobs[w], w), **kw)
        if run == "bridge":
            live.append(ex._bridge.live_buffers())
        return pend

    pend = wave("zoned")
    ex.retain_chain("batch-zoned", 10, ex.chain_state(pend))
    claimed = ex.claim_chain()
    assert claimed[:2] == ("batch-zoned", 10)
    pend = wave("chained", used0_dev=claimed[2])
    # two unchained waves, each after the commit of the last: the usage
    # is replayed into the engine's tensor in place between them
    wave("after_commit_1")
    pend = wave("after_commit_2")
    ex.retain_chain("batch-ac2", 0, ex.chain_state(pend))
    node = copy.deepcopy(h.state.node_by_id("node-00003"))
    node.attributes["kernel.name"] = "linux-rt"
    h.state.upsert_node(node)
    assert ex.claim_chain() is None
    # each mask refutes the nodes the wave before it placed on (binpack
    # would pick them again)
    wave("after_node_write")
    wave("masked_zoned", masked=sorted(out["after_node_write"]["nodes"]))
    wave("flat")
    wave("masked_flat", masked=sorted(out["flat"]["nodes"]))
    del pend, claimed
    return out, ex, live


def _scatter_add_as_on_the_card(used, rows, vals):
    """K4 as it runs on the card: in place through the raw pointer, so
    torch's version counter of `used` does not move (on the CPU the
    plain version's index_put_ would move it, and hide a cache keyed on
    it alone)."""
    from nomad_tpu_torch.ops.engine import scatter_add_plain
    scatter_add_plain(used.data, rows, vals)
    return used


@pytest.fixture(scope="module")
def runs():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pkg(PORT, "ops.engine"), "scatter_add_",
                   _scatter_add_as_on_the_card)
        return {run: _run(run) for run in RUNS}


@pytest.mark.parametrize("wave", [w[0] for w in WAVES])
def test_bridge_waves_match_torch_and_reference(runs, wave):
    ref, torch_, bridge = (runs[r][0][wave] for r in RUNS)
    assert bridge["chained"] == torch_["chained"] == ref["chained"] == \
        (wave == "chained")
    assert bridge["compact"] == torch_["compact"] == (
        not wave.endswith("flat"))
    # integer decisions, fills and usage exact; the score columns of the
    # packed buffer and the metrics' scores to the bit
    for other in (torch_, ref):
        assert bridge["picks"] == other["picks"]
        assert bridge["metrics"] == other["metrics"]
        assert np.array_equal(bridge["used"], other["used"])
    assert np.array_equal(bridge["buf"], torch_["buf"])
    assert np.array_equal(bridge["buf"].view(np.int32),
                          ref["buf"].view(np.int32))


def test_masks_and_commits_moved_the_waves(runs):
    """The cases are not vacuous: a masked wave places on no masked node
    (the wave before it placed on all of them), and each unchained wave
    after a commit starts from more usage."""
    out = runs["bridge"][0]
    for w, before in (("masked_zoned", "after_node_write"),
                      ("masked_flat", "flat")):
        assert out[before]["nodes"] and out[w]["nodes"]
        assert not out[w]["nodes"] & out[before]["nodes"]
    used = [out[w]["used"].sum() for w in ("chained", "after_commit_1",
                                           "after_commit_2")]
    assert used[0] < used[1] < used[2]


def test_bridge_uploads_by_cause(runs):
    """Stable inputs upload once; the usage is uploaded again after each
    commit (the engine replays deltas into the same tensor, which the
    identity cache must not reuse); a node write re-uploads the node
    tensors; every wave uploads its own tensors."""
    _, ex, _ = runs["bridge"]
    by = ex.upload_bytes_by_cause
    assert set(by) == {"initial-upload", "invalidation-replay", "per-wave"}
    assert by["invalidation-replay"] >= 2 * 200 * 3 * 4
    assert ex.stats["dispatches"] == len(WAVES)
    assert ex.stats["resident_waves"] == 1
    assert ex.stats["invalidations"] >= 1


def test_plain_bridge_handles_after_collect_and_close(runs):
    """After each collect only the cached stable inputs and the wave's
    usage (the chain candidate) are live; close() leaves none."""
    _, ex, live = runs["bridge"]
    cached = len(ex._h2d_cache)
    assert all(n <= cached + 2 for n in live)
    gc.collect()
    assert ex._bridge.live_buffers() == cached
    ex.close()
    assert ex._bridge.leaked == 0
    assert ex._bridge.live_buffers() == 0


def test_chain_handle_is_freed_when_consumed_or_dropped():
    h = build_zoned_cluster(PORT, n_nodes=120)
    jobs, _ = add_jobs(PORT, h, 6, 20)
    jobs2, _ = add_jobs(PORT, h, 6, 20, prefix="w2")
    br = PlainBridge()
    ex = BridgeExecutor(h.engine, bridge=br)
    ex.attach_store(h.state)
    pend, _ = _wave(PORT, h, ex, make_evals(PORT, jobs))
    used = pend["used"]
    ex.retain_chain("b1", 0, ex.chain_state(pend))
    del pend
    assert used.handle
    ex.invalidate("explicit")
    assert used.handle == 0
    pend, _ = _wave(PORT, h, ex, make_evals(PORT, jobs2, "w2"))
    ex.retain_chain("b2", 0, ex.chain_state(pend))
    chain = ex.claim_chain()[2]
    jobs3, _ = add_jobs(PORT, h, 6, 20, prefix="w3")
    pend3, got = _wave(PORT, h, ex, make_evals(PORT, jobs3, "w3"),
                       used0_dev=chain)
    assert got["chained"] and chain[0].handle == 0
    del pend, pend3
    gc.collect()
    assert br.live_buffers() == len(ex._h2d_cache)
    ex.close()
    assert br.leaked == 0


def test_identity_cache_under_threads():
    """Worker threads share one BridgeExecutor: leaves looked up and
    re-uploaded (their token moving) from more threads than cores, with
    a short switch interval, each read under the cache lock as a
    dispatch reads it, leave exactly one live handle per cached leaf and
    each cached handle live."""
    import sys
    import threading

    br = PlainBridge()
    ex = BridgeExecutor(PlacementEngine(device="cpu"), bridge=br)
    leaves = [torch.full((64, 3), i, dtype=torch.int32) for i in range(8)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for r in range(200):
                leaf = leaves[(k + r) % len(leaves)]
                with ex._cache_lock:
                    h = ex._leaf_handle(leaf, (r // 50,))
                    assert br.fetch(h)[0, 0] == int(leaf[0, 0])

        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert len(ex._h2d_cache) == len(leaves)
    assert br.live_buffers() == len(leaves)
    assert all(br.buffer_info(h) for _, _, h in ex._h2d_cache.values())
    ex.close()
    assert br.leaked == 0


# --------------------------------------------------- programs, handles

def _bulk_arrays(n=32, p=64, seed=7):
    """The reference bridge test's bulk inputs (tests/test_native_bridge
    .py _bulk_inputs) as numpy arrays by field."""
    rng = np.random.default_rng(seed)
    attrs = rng.integers(0, 4, size=(n, 8)).astype(np.int32)
    return dict(
        attrs=attrs,
        cap=np.tile(np.array([[4000, 8192, 102400]], np.int32), (n, 1)),
        used0=np.zeros((n, 3), np.int32), elig=np.ones(n, bool),
        dc_mask=np.ones(n, bool), pool_mask=np.ones(n, bool),
        luts=np.ones((1, 8), bool),
        con=np.array([[[0, 1, attrs[0, 0]]]], np.int32),
        aff=np.zeros((1, 1, 4), np.int32),
        req=np.array([[500, 256, 300]], np.int32),
        desired=np.array([p], np.int32), dh_limit=np.zeros(1, np.int32),
        job_count0=np.zeros(n, np.int32))


def _port_bulk(arrays, p, seed=0):
    from nomad_tpu_torch.ops.select import BulkInputs
    return BulkInputs(**{k: torch.from_numpy(v) for k, v in arrays.items()},
                      spread_algo=False, g=0, p_real=p, seed=seed)


def test_bulk_program_matches_jax_and_plain():
    """The counterpart of the reference's
    test_placement_kernel_via_bridge_matches_jax: place_bulk_packed
    compiled and executed through the bridge (host in, host out)."""
    from functools import partial

    import jax
    import jax.numpy as jnp

    from nomad_tpu.ops.select import BulkInputs as RefBulk
    from nomad_tpu.ops.select import place_bulk_packed as ref_bulk
    from nomad_tpu_torch.ops.select import place_bulk_packed_plain

    arrays, p, rs = _bulk_arrays(), 64, 64
    inp = _port_bulk(arrays, p)
    program, statics, leaves = bulk_program(inp, rs, 1)
    with PlainBridge() as br:
        ex = br.compile(program, statics)
        assert br.num_outputs(ex) == 3
        want = [o.numpy() for o in place_bulk_packed_plain(inp, rs, 1)]
        got = br.execute(ex, [lf.numpy() for _, lf in leaves],
                         [(w.shape, w.dtype) for w in want])
        assert br.live_buffers() == 0
    ref_inp = RefBulk(**{k: jnp.asarray(v) for k, v in arrays.items()},
                      spread_algo=jnp.asarray(False), g=jnp.asarray(0),
                      p_real=jnp.asarray(p), seed=jnp.asarray(0, jnp.uint32))
    ref = [np.asarray(x) for x in jax.jit(partial(
        ref_bulk, round_size=rs, n_rounds=1, with_scores=False))(ref_inp)]
    for a, b, r in zip(got, want, ref):
        assert np.array_equal(a, b) and np.array_equal(a, r)


def test_resident_buffers_and_state_chain():
    """Upload once, execute on handles, fetch chosen outputs, and chain
    the usage output into the next execute (wave 2's usage strictly
    grows), as the reference's test of the same name."""
    arrays, p, rs = _bulk_arrays(p=8), 8, 64
    program, statics, leaves = bulk_program(_port_bulk(arrays, p), rs, 1)
    br = PlainBridge()
    ex = br.compile(program, statics)
    handles = [br.upload(lf.numpy()) for _, lf in leaves]
    outs = br.execute_resident(ex, handles, 3)
    used = br.fetch(outs[1], (32, 3), np.int32)
    chain = list(handles)
    chain[list(program_inputs(program, statics)).index("used0")] = outs[1]
    outs2 = br.execute_resident(ex, chain, 3)
    used2 = br.fetch(outs2[1], (32, 3), np.int32)
    assert used2.sum() > used.sum() > 0
    for h in handles + outs + outs2:
        br.buffer_free(h)
    assert br.live_buffers() == 0
    assert br.launches()["place_bulk_packed"] == 2


@pytest.mark.parametrize("program,statics,match", [
    ("not a program", (), "unknown program"),
    ("place_multi_packed", (64, 0), "takes 3 static arguments"),
    ("place_bulk_packed", (64, 1, 0, 0, 0, 8), "takes 7"),
    ("place_multi_compact_packed", (2048, 5, 0), "round_size"),
])
def test_compile_error_surfaces(program, statics, match):
    with pytest.raises(BridgeError, match=match):
        PlainBridge().compile(program, statics)


def test_execute_checks_inputs():
    br = PlainBridge()
    ex = br.compile("place_bulk_packed", (64, 1, 0, 0, 0, 8, 0))
    with pytest.raises(BridgeError, match="takes 13 inputs"):
        br.execute_resident(ex, [br.upload(np.zeros(3, np.int32))], 3)
    with pytest.raises(BridgeError, match="not a live buffer"):
        br.execute_resident(ex, [12345] * 13, 3)
    with pytest.raises(BridgeError, match="unsupported dtype"):
        br.upload(np.zeros(2, np.complex64))


def test_multi_program_leaf_order():
    """The flat program takes node_ok (a static flag says whether) and
    the laned one the frames; spread_algo is static."""
    h = build_zoned_cluster(PORT, n_nodes=60)
    _, items = add_jobs(PORT, h, 4, 10)
    built = h.engine.build_multi_inputs(h.state.snapshot(), items, seed=3)
    inp = built["inp"]
    prog, st, leaves = multi_program(inp, built["rs"], built["cand_rows"],
                                     built["cand_valid"], built["n_lanes"])
    assert prog == "place_multi_compact_packed"
    assert st == (built["rs"], built["n_lanes"], 0)
    assert [k for k, _ in leaves][-2:] == ["cand_rows", "cand_valid"]
    assert leaves[-1][1] is built["cand_valid"]
    inp = inp._replace(node_ok=torch.ones(60, dtype=torch.bool),
                       spread_algo=True)
    prog, st, leaves = multi_program(inp, 64)
    assert (prog, st) == ("place_multi_packed", (64, 1, 1))
    assert [k for k, _ in leaves] == list(
        program_inputs(prog, st)) and leaves[-1][0] == "node_ok"


def test_cuda_bridge_needs_the_library(tmp_path):
    """CudaBridge loads a built library by path and raises without one
    (the card cases load the real one)."""
    with pytest.raises(OSError):
        CudaBridge(lib=str(tmp_path / "libnomad_tpu_bridge.so"))


# ------------------------------------------------------ make_executor

class TestMakeExecutorBridge:
    def test_cpu_engine_is_unavailable(self):
        with pytest.raises(ExecutorUnavailable, match="bridge"):
            make_executor("bridge", PlacementEngine(device="cpu"))

    def test_bridge_unavailable_without_a_card(self, monkeypatch):
        from nomad_tpu_torch.native.bridge import bridge_available
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        assert bridge_available() is False

    def test_cpu_engine_is_unavailable_in_the_reference_too(self):
        from nomad_tpu.native.bridge import bridge_available
        from nomad_tpu.ops import PlacementEngine as RefEngine
        from nomad_tpu.ops.executor import ExecutorUnavailable as RefUnav
        from nomad_tpu.ops.executor import make_executor as ref_make
        if bridge_available():
            pytest.skip("the reference's bridge is available here")
        with pytest.raises(RefUnav, match="bridge"):
            ref_make("bridge", RefEngine(mesh=False))

    def test_mesh_engine_is_a_config_error(self):
        eng = PlacementEngine(device="cpu", mesh=make_mesh(8, "cpu"))
        with pytest.raises(ValueError, match="agent_config.*mesh"):
            make_executor("bridge", eng)
        with pytest.raises(ValueError, match="mesh"):
            BridgeExecutor(eng, bridge=PlainBridge())

    def test_mesh_engine_is_a_config_error_in_the_reference_too(self):
        import jax

        from nomad_tpu.ops import PlacementEngine as RefEngine
        from nomad_tpu.ops.executor import make_executor as ref_make
        if jax.device_count() < 2:
            pytest.skip("needs the virtual multi-device mesh")
        eng = RefEngine()
        assert eng.mesh is not None
        with pytest.raises(ValueError, match="agent_config.*mesh"):
            ref_make("bridge", eng)

    def test_nvcc_failure_carries_its_output(self, monkeypatch):
        """A build that fails reaches the caller with nvcc's output, as
        ExecutorUnavailable at construction."""
        from nomad_tpu_torch.ops import kernels as K

        def failed():
            raise RuntimeError("nvcc failed for ['bridge']:\nbridge.cu(1): "
                               "error: expected a declaration")

        class CudaEngine:
            mesh = None
            device = torch.device("cuda", 0)

        monkeypatch.setattr(K, "build_bridge", failed)
        with pytest.raises(ExecutorUnavailable,
                           match="expected a declaration"):
            BridgeExecutor(CudaEngine())


# ---------------------------------------- the agent config to a Server

def test_agent_config_bridge_reaches_make_executor(monkeypatch):
    from nomad_tpu_torch.agent_config import parse_agent_config
    from nomad_tpu_torch.core.server import Server
    from nomad_tpu_torch.ops import executor as exmod

    cfg, fields = parse_agent_config('server { device_executor = "bridge" }')
    assert cfg.device_executor == "bridge" and "device_executor" in fields
    with pytest.raises(ExecutorUnavailable, match="bridge"):
        Server(dev_mode=True, device="cpu", profile_hz=0,
               device_executor=cfg.device_executor)
    seen = []

    def make(name, engine, **kw):
        seen.append(name)
        return BridgeExecutor(engine, bridge=PlainBridge())

    monkeypatch.setattr(exmod, "make_executor", make)
    s = Server(dev_mode=True, device="cpu", profile_hz=0,
               device_executor=cfg.device_executor)
    try:
        assert seen == ["bridge"]
        assert s.executor.name == "bridge"
        assert all(w.pipeline.executor is s.executor for w in s.workers)
    finally:
        s.shutdown()


def _server_run(executor, monkeypatch):
    """A zoned batch (12 x 30) through a threaded port Server on the
    CPU whose executor is `executor` ("torch", or "bridge" over a
    PlainBridge); returns (fingerprint, device intervals, waves, the
    Server's executor)."""
    from nomad_tpu_torch.core.server import Server
    from nomad_tpu_torch.ops import executor as exmod

    real = exmod.make_executor
    monkeypatch.setattr(exmod, "make_executor", lambda name, engine, **kw: (
        BridgeExecutor(engine, bridge=PlainBridge()) if name == "bridge"
        else real(name, engine, **kw)))
    s = Server(dev_mode=False, num_workers=1, eval_batch=16,
               heartbeat_ttl=1e9, profile_hz=0, device="cpu",
               device_executor=executor)
    try:
        s.establish_leadership()
        add_zoned_cluster(PORT, s.state, n_nodes=150)
        jobs, _ = add_jobs(PORT, s, 12, 30)
        evals = make_evals(PORT, jobs)
        s.apply_eval_update(evals)
        s.start_scheduling()
        end = time.monotonic() + 120
        while time.monotonic() < end and not all(
                s.state.eval_by_id(e.id).status == "complete"
                for e in evals):
            time.sleep(0.01)
        s.stop_scheduling()
        snap = s.state.snapshot()
        prints = sorted((a.job_id, a.name, a.node_id)
                        for j in snap.jobs()
                        for a in snap.allocs_by_job(j.namespace, j.id)
                        if not a.terminal_status())
        return (prints, s.stage_timers.counts().get("device", 0),
                s.workers[0].pipeline.stats["waves"], s.executor)
    finally:
        s.shutdown()


def test_threaded_server_on_the_bridge_places_as_torch(monkeypatch):
    """The wave pipeline on the bridge: the same allocs as on the torch
    executor, one `device` interval per wave, and no handle left once
    the Server is shut down."""
    p_t, dev_t, waves_t, _ = _server_run("torch", monkeypatch)
    p_b, dev_b, waves_b, ex = _server_run("bridge", monkeypatch)
    assert len(p_t) == 12 * 30
    assert p_b == p_t
    assert waves_b >= 1 and dev_b == waves_b
    assert dev_t == waves_t
    assert ex._bridge.leaked == 0 and ex._bridge.live_buffers() == 0
