"""The port's wave pipeline (nomad_tpu_torch/core/wavepipe.py) and the
worker's batched path through it, against the reference's, on the CPU:

  - tests/test_wavepipe.py::TestPipelinedSerialParity: one fixed eval
    batch through the fenced, the full-check and the expanded commit
    paths lands the same store in both packages (and the three paths
    agree with each other, and with the Harness's serial path);
  - ::TestExecutorResidentParity: waves riding the executor's retained
    chain against the serial re-sync, with and without a node write in
    the middle, give the same store and the same executor counts in
    both packages; upload bytes are equal per cause except the deltas
    replayed by K4 (the reference pads each chunk to its pad bucket
    with int64 rows, the port uploads the rows as they are, int32:
    ops/engine.py's docstring), and the port's resident base-mask table
    is metered by neither package;
  - the same waves on the reference's automatic 8-device mesh against
    the port's `make_mesh(8, device="cpu")`;
  - StageTimers, the refuted-node mask and the device wait of
    `collect`: on a CPU engine the device interval is recorded at once,
    and a wait that fails raises out of `collect`.

Node, job and eval ids are pinned (as the reference's tests pin them);
alloc ids are random and the stores are compared through
(name, node, cpu) fingerprints."""

import random

import numpy as np
import pytest

from torch_parity import PACKAGES, make_node, pkg

PORT = "nomad_tpu_torch"
NOW = 1.7e9


def make_server(name, **kw):
    kw.setdefault("profile_hz", 0)
    if name == PORT:
        kw.setdefault("device", "cpu")
    elif "mesh" not in kw:
        kw["mesh"] = False
    return pkg(name, "core.server").Server(**kw)


def fixed_nodes(name, n_nodes=16, seed=11):
    rng = random.Random(seed)
    out = []
    for i in range(n_nodes):
        out.append(make_node(name, i, cpu=rng.choice([4000, 8000]),
                             mem=16384))
    return out


def contents(state):
    """Every live alloc's (name, node, cpu)."""
    snap = state.snapshot()
    return sorted((a.name, a.node_id, a.resources.cpu)
                  for job in snap.jobs()
                  for a in snap.allocs_by_job(job.namespace, job.id)
                  if not a.terminal_status())


# ------------------------------------------- pipelined vs serial paths

def _commit_path(name, mode):
    """tests/test_wavepipe.py::TestPipelinedSerialParity._run."""
    mock = pkg(name, "mock")
    s = make_server(name, eval_batch=8)
    try:
        s.establish_leadership()
        for n in fixed_nodes(name):
            s.register_node(n, now=NOW)
        for i in range(3):
            job = mock.batch_job(id=f"parity-{i}")
            tg = job.task_groups[0]
            tg.count = 80
            tg.tasks[0].resources.cpu = 100
            tg.tasks[0].resources.memory_mb = 64
            s.state.upsert_job(job)
            s.apply_eval_update([mock.eval(
                id=f"eval-parity-{i}", job_id=job.id, type=job.type)],
                now=NOW)
        applier = s.plan_applier
        if mode == "full_check":
            s.state.nodes_unchanged_since = lambda *a, **k: False
        elif mode == "expanded":
            orig = applier._apply_one

            def expand_first(pending):
                pending.plan.expand_blocks()
                pending.plan.coupled_batch = None
                return orig(pending)
            applier._apply_one = expand_first
        s.process_all(now=NOW)
        snap = s.state.snapshot()
        for i in range(3):
            live = [a for a in snap.allocs_by_job("default", f"parity-{i}")
                    if not a.terminal_status()]
            assert len(live) == 80, (name, mode, i, len(live))
        return contents(s.state), dict(s.plan_applier.stats), \
            dict(s.workers[0].pipeline.stats)
    finally:
        s.shutdown()


@pytest.mark.parametrize("mode", ["fenced", "full_check", "expanded"])
def test_commit_paths_match_reference(mode):
    ref, port = (_commit_path(name, mode) for name in PACKAGES)
    assert ref == port
    if mode != "fenced":
        assert port[0] == _commit_path(PORT, "fenced")[0]


def test_harness_serial_matches_server_pipeline():
    server = _commit_path(PORT, "fenced")[0]
    for name in PACKAGES:
        mock = pkg(name, "mock")
        from torch_parity import harness
        h = harness(name)
        h.state.upsert_nodes(fixed_nodes(name))
        for i in range(3):
            job = mock.batch_job(id=f"parity-{i}")
            tg = job.task_groups[0]
            tg.count = 80
            tg.tasks[0].resources.cpu = 100
            tg.tasks[0].resources.memory_mb = 64
            h.state.upsert_job(job)
        for i in range(3):
            ev = mock.eval(id=f"eval-parity-{i}", job_id=f"parity-{i}",
                           type="batch")
            h.state.upsert_evals([ev])
            assert h.process("batch", ev, now=NOW) is None
        assert contents(h.state) == server, name


def test_multiwave_pipeline_matches_reference():
    """Small eval_batch: several waves through the pipeline, each pass's
    chain retained for the next."""
    out = []
    for name in PACKAGES:
        mock = pkg(name, "mock")
        s = make_server(name, eval_batch=3)
        try:
            s.establish_leadership()
            for n in fixed_nodes(name, n_nodes=10, seed=4):
                s.register_node(n, now=NOW)
            for i in range(9):
                job = mock.batch_job(id=f"multi-{i}")
                job.task_groups[0].count = 12
                job.task_groups[0].tasks[0].resources.cpu = 50
                job.task_groups[0].tasks[0].resources.memory_mb = 16
                s.state.upsert_job(job)
                s.apply_eval_update([mock.eval(
                    id=f"eval-multi-{i}", job_id=job.id, type="batch")],
                    now=NOW)
            s.process_all(now=NOW)
            assert s.plan_applier.stats["plans_refuted"] == 0
            counts = s.stage_timers.counts()
            out.append((contents(s.state), dict(s.workers[0].pipeline.stats),
                        {k: counts.get(k, 0) for k in
                         ("dispatch", "device", "d2h", "materialize",
                          "commit")},
                        dict(s.executor.stats)))
        finally:
            s.shutdown()
    assert out[0][:3] == out[1][:3]
    keys = ("dispatches", "resident_waves", "invalidations", "uploads",
            "d2h_fetches", "d2h_bytes")
    assert {k: out[0][3][k] for k in keys} == {k: out[1][3][k] for k in keys}
    assert len(out[1][0]) == 9 * 12
    assert out[1][2]["device"] == out[1][2]["dispatch"] >= 2


# ------------------------------------------------ executor residency

def _run_waves(name, resident, drain_mid=False, n_nodes=12, **kw):
    """tests/test_wavepipe.py::TestExecutorResidentParity._run_waves:
    two passes of four batch evals each.  `kw` goes to the Server (a
    `mesh`: the reference's single-device engine otherwise)."""
    mock = pkg(name, "mock")
    s = make_server(name, eval_batch=4, **kw)
    s.executor.chain_enabled = resident
    try:
        s.establish_leadership()
        nodes = fixed_nodes(name, n_nodes=n_nodes, seed=7)
        for n in nodes:
            s.register_node(n, now=NOW)
        causes = []
        meter = s.executor._observe_h2d

        def observe(nbytes, seconds, cause="initial-upload"):
            causes.append((cause, int(nbytes)))
            meter(nbytes, seconds, cause)

        s.engine.h2d_observer = observe

        def wave(tag):
            for i in range(4):
                job = mock.batch_job(id=f"res-{tag}-{i}")
                tg = job.task_groups[0]
                tg.count = 12
                tg.tasks[0].resources.cpu = 100
                tg.tasks[0].resources.memory_mb = 64
                s.state.upsert_job(job)
                s.apply_eval_update([mock.eval(
                    id=f"eval-res-{tag}-{i}", job_id=job.id,
                    type="batch")], now=NOW)
            s.process_all(now=NOW)

        wave("a")
        if drain_mid:
            s.set_node_eligibility(nodes[0].id, False)
        wave("b")
        return (contents(s.state), dict(s.executor.stats), causes,
                s.plan_applier.stats["plans_refuted"],
                dict(s.workers[0].pipeline.stats))
    finally:
        s.shutdown()


COUNTS = ("dispatches", "resident_waves", "invalidations", "uploads",
          "d2h_fetches", "d2h_bytes", "collective_bytes")


def _same_uploads(ref, port):
    """Upload causes in the same order with the same bytes, except the
    K4 replays' (int64 rows padded to the reference's pad bucket
    against the port's int32 rows as they are)."""
    assert [c for c, _ in ref] == [c for c, _ in port]
    for (cause, rb), (_, pb) in zip(ref, port):
        if cause != "invalidation-replay":
            assert rb == pb, (cause, rb, pb)
            continue
        n_rows = pb // 16
        assert pb == 16 * n_rows
        pad = next(p for p in (512, 2048, 8192, 16384) if n_rows <= p)
        assert rb == 20 * pad


@pytest.mark.parametrize("drain_mid", [False, True],
                         ids=["steady", "drain_mid"])
@pytest.mark.parametrize("resident", [False, True],
                         ids=["serial", "resident"])
def test_executor_waves_match_reference(resident, drain_mid):
    ref, port = (_run_waves(name, resident, drain_mid)
                 for name in PACKAGES)
    assert ref[0] == port[0]
    assert {k: ref[1][k] for k in COUNTS} == {k: port[1][k] for k in COUNTS}
    _same_uploads(ref[2], port[2])
    assert ref[3] == port[3] == 0
    assert ref[4] == port[4]
    if not resident:
        assert port[1]["resident_waves"] == 0
    elif drain_mid:
        # the node write dropped the retained chain: wave b re-synced
        assert port[1]["invalidations"] >= 1
    else:
        assert port[1]["resident_waves"] >= 1


@pytest.mark.parametrize("drain_mid", [False, True],
                         ids=["steady", "drain_mid"])
def test_resident_equals_serial(drain_mid):
    serial = _run_waves(PORT, False, drain_mid)
    resident = _run_waves(PORT, True, drain_mid)
    assert resident[0] == serial[0]


def test_mesh_waves_match_reference_auto_mesh():
    """The reference's automatic 8-device mesh (the test session's 8
    virtual CPU devices) against the port's explicit 8-shard mesh, both
    riding the resident chain, and both against the single-device serial
    run; 28 nodes, not a multiple of 8."""
    import jax
    assert jax.device_count() == 8
    ref = _run_waves("nomad_tpu", True, n_nodes=28, mesh=None)
    port = _run_waves(PORT, True, n_nodes=28,
                      mesh=pkg(PORT, "parallel").make_mesh(8, device="cpu"))
    serial = _run_waves(PORT, False, n_nodes=28)
    assert ref[0] == port[0] == serial[0]
    assert {k: ref[1][k] for k in COUNTS} == {k: port[1][k] for k in COUNTS}
    _same_uploads(ref[2], port[2])
    assert port[1]["resident_waves"] >= 1
    # both ran sharded: the top-k exchange's collective bytes
    assert port[1]["collective_bytes"] > 0


# ------------------------------------------------------ pipeline unit

def test_stage_timers_alike():
    out = []
    for name in PACKAGES:
        t = pkg(name, "core.wavepipe").StageTimers()
        t.record("device", 0.0, 3.0, wave=2)
        t.record("commit", 1.0, 2.0, wave=1)
        t.record("commit", 2.5, 4.0, wave=2)
        out.append((t.overlap("device", "commit"), t.totals(), t.counts(),
                    t.intervals("commit"), t.report()))
        t.reset()
        out.append(t.totals())
    assert out[:2] == out[2:]
    assert out[0][0] == 1.5


def _zoned(name, n_nodes=60):
    from torch_parity import add_jobs, build_zoned_cluster
    h = build_zoned_cluster(name, n_nodes=n_nodes)
    return h, add_jobs(name, h, 6, 8)[1]


def test_refuted_mask_and_chain_match_reference():
    """A refuted node is masked out of the next chained dispatch and a
    fresh dispatch clears the mask, alike in both packages."""
    out = []
    for name in PACKAGES:
        h, items = _zoned(name)
        pipe = pkg(name, "core.wavepipe").WavePipeline(h.engine)
        snap = h.state.snapshot()
        w1 = pipe.dispatch(snap, items[:3], seed=1)
        d1 = pipe.collect(w1)
        picked = sorted({bd.node_ids[p] for bd in d1
                         for p in bd.picks.tolist() if p >= 0})
        pipe.note_refuted([picked[0]])
        w2 = pipe.dispatch(snap, items[3:], seed=2,
                           used0_dev=pipe.chain_state(w1))
        d2 = pipe.collect(w2)
        masked = pipe.masked_nodes()
        w3 = pipe.dispatch(snap, items[:2], seed=3)
        pipe.collect(w3)
        out.append(([bd.picks.tolist() for bd in d1 + d2], picked[0],
                    masked, pipe.masked_nodes(), dict(pipe.stats),
                    w2.pending["chained"],
                    pipe.timers.counts()))
    assert out[0] == out[1]
    picks2 = out[1][0][3:]
    assert out[1][1] in out[1][2] and not out[1][3]
    assert out[1][5] and np.all(np.array(picks2) >= 0)


def test_collect_on_cpu_records_the_device_interval():
    h, items = _zoned(PORT)
    pipe = pkg(PORT, "core.wavepipe").WavePipeline(h.engine)
    w = pipe.dispatch(h.state.snapshot(), items, seed=1)
    assert w.pending["ready"] is None
    pipe.collect(w)
    (wave, t0, t1), = pipe.timers.intervals("device")
    assert wave == w.wave and t0 == w.t_dispatch[1] and t1 >= t0
    assert set(pipe.timers.counts()) == {"dispatch", "device", "d2h"}


def test_collect_does_not_swallow_a_failed_wait():
    h, items = _zoned(PORT)
    pipe = pkg(PORT, "core.wavepipe").WavePipeline(h.engine)
    w = pipe.dispatch(h.state.snapshot(), items, seed=1)
    w.pending["ready"] = object()          # no synchronize()
    with pytest.raises(AttributeError):
        pipe.collect(w)

    class Failing:
        def synchronize(self):
            raise RuntimeError("device lost")

    w2 = pipe.dispatch(h.state.snapshot(), items, seed=2)
    w2.pending["ready"] = Failing()
    with pytest.raises(RuntimeError, match="device lost"):
        pipe.collect(w2)
    assert "device" not in pipe.timers.counts()


def test_bare_engine_is_wrapped_in_torch_executor():
    eng = pkg(PORT, "ops").PlacementEngine(device="cpu")
    pipe = pkg(PORT, "core.wavepipe").WavePipeline(eng)
    assert type(pipe.executor).__name__ == "TorchExecutor"
    assert pipe.engine is eng
