"""The system, sysbatch and core schedulers through both packages'
Harnesses (the port's on the CPU), and K8's plain version
(`feasibility.feasible_mask`) against the reference's jnp function.

System placement masks every (group, node) through K8; scenarios mirror
tests/test_generic_sched.py::TestSystemScheduler and the device
scenario of tests/test_devices.py.  The core scheduler's force-GC runs
against each package's own store."""

import jax
import numpy as np
import pytest
import torch

from nomad_tpu.ops.feasibility import feasible_mask as ref_feasible_mask
from nomad_tpu_torch.ops.feasibility import feasible_mask
from torch_parity import (
    PACKAGES,
    add_nodes,
    eval_for,
    harness,
    pkg,
    random_placement_arrays,
    view,
)

NOW = 1_700_000_000.0


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _system_job(name, jid, kind="system", **kw):
    mock = pkg(name, "mock")
    make = mock.system_job if kind == "system" else mock.sysbatch_job
    return make(id=jid, **kw)


def _process(h, name, job, kind, tag="0", **kw):
    h.state.upsert_job(job)
    assert h.process(kind, eval_for(name, job, tag, **kw), now=NOW) is None


def s_one_per_node(name, h):
    """One alloc per eligible node; a dc2 node and a windows node are
    filtered, and a tight node is exhausted."""
    add_nodes(name, h, [("dc1", 4000, 8192, {})] * 5
              + [("dc2", 4000, 8192, {}), ("dc1", 4000, 8192,
                                           {"kernel.name": "windows"}),
                 ("dc1", 300, 8192, {})])
    job = _system_job(name, "sys")
    job.task_groups[0].tasks[0].resources.cpu = 500
    _process(h, name, job, "system")


def s_new_node_and_down_node(name, h):
    nodes = add_nodes(name, h, [("dc1", 4000, 8192, {})] * 3)
    job = _system_job(name, "sys")
    _process(h, name, job, "system")
    extra = add_nodes(name, h, [("dc1", 4000, 8192, {})] * 4)[3]
    _process(h, name, job, "system", "1", triggered_by="node-update",
             node_id=extra.id)
    h.state.update_node_status(nodes[0].id, "down")
    _process(h, name, job, "system", "2", triggered_by="node-update")


def s_sysbatch_multi_group(name, h):
    structs = pkg(name, "structs")
    add_nodes(name, h, [(f"dc{1 + i % 2}", 4000, 8192,
                         {"rack": f"r{i % 3}"}) for i in range(10)])
    job = _system_job(name, "sb", kind="sysbatch")
    job.datacenters = ["dc1", "dc2"]
    job.task_groups.append(structs.TaskGroup(
        name="r1only", count=1,
        constraints=[structs.Constraint("${attr.rack}", "=", "r1")],
        tasks=[structs.Task(name="t", driver="exec",
                            resources=structs.Resources(cpu=100,
                                                        memory_mb=64))]))
    _process(h, name, job, "sysbatch")


def s_system_devices(name, h):
    structs = pkg(name, "structs")
    nodes = add_nodes(name, h, [("dc1", 4000, 8192, {})] * 3)
    nodes[1].resources.devices = [structs.NodeDeviceResource(
        vendor="nvidia", type="gpu", name="1080ti",
        instance_ids=["1080ti-0", "1080ti-1"], attributes={})]
    h.state.upsert_nodes(nodes)
    job = _system_job(name, "gpu")
    job.task_groups[0].tasks[0].resources.devices = [
        structs.RequestedDevice(name="gpu", count=1)]
    _process(h, name, job, "system")


SCENARIOS = {f.__name__[2:]: f for f in (
    s_one_per_node, s_new_node_and_down_node, s_sysbatch_multi_group,
    s_system_devices)}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_system_matches_reference(scenario, monkeypatch):
    import nomad_tpu_torch.scheduler.system as S
    calls = []

    def spy(*a, _f=S.feasible_mask, **kw):
        calls.append(1)
        return _f(*a, **kw)

    monkeypatch.setattr(S, "feasible_mask", spy)
    out = {}
    for name in PACKAGES:
        h = harness(name)
        SCENARIOS[scenario](name, h)
        out[name] = view(h)
    assert out["nomad_tpu"][0]
    assert out["nomad_tpu_torch"] == out["nomad_tpu"]
    assert calls


def test_core_force_gc_matches_reference():
    """A stopped job's terminal allocs and evals are collected by a
    force-GC `_core` eval in both packages alike."""
    out = {}
    for name in PACKAGES:
        h = harness(name)
        structs = pkg(name, "structs")
        mock = pkg(name, "mock")
        add_nodes(name, h, [("dc1", 4000, 8192, {})] * 2)
        keep = mock.job(id="keep")
        _process(h, name, keep, "service")
        gone = mock.job(id="gone")
        _process(h, name, gone, "service")
        for e in h.evals:
            h.state.upsert_evals([e])
        stopped = h.state.job_by_id(gone.namespace, gone.id).copy()
        stopped.stop = True
        h.state.upsert_job(stopped)
        _process(h, name, stopped, "service", "1")
        for a in h.state.allocs_by_job(gone.namespace, gone.id):
            done = a.copy_skip_job()
            done.client_status = "complete"
            h.state.upsert_allocs([done])
        gc = structs.Evaluation(id="eval-gc-0000-0000-000000000000",
                                type="_core", job_id="force-gc",
                                priority=100)
        assert h.process("_core", gc, store=h.state) is None
        snap = h.snapshot()
        out[name] = (sorted(j.id for j in snap.jobs()),
                     sorted((e.job_id, e.status) for e in snap.evals()),
                     h.evals[-1].status)
    assert out["nomad_tpu"][0] == ["keep"]
    assert out["nomad_tpu_torch"] == out["nomad_tpu"]


@pytest.mark.parametrize("seed", range(4))
def test_feasible_mask_matches_reference(seed):
    arr = random_placement_arrays(np.random.default_rng(seed), n=200, g=5)
    args = [arr[k] for k in ("attrs", "elig", "dc_mask", "pool_mask", "con",
                             "luts")]
    want = np.asarray(jax.jit(ref_feasible_mask)(*args))
    got = feasible_mask(*[torch.tensor(a) for a in args]).numpy()
    assert want.any() and not want.all()
    assert np.array_equal(want, got)
