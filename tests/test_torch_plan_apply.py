"""The port's plan queue and serialized applier
(nomad_tpu_torch/core/plan_apply.py) against the reference's: the cases
of tests/test_core.py::TestPlanApplier on both packages, from the same
pinned ids, give the same PlanResults and the same store contents; and
a seeded stream of plans, some racing for one node, refutes and commits
alike."""

import numpy as np
import pytest

from torch_parity import PACKAGES, pkg

NOW = 1_700_000_000.0


def _setup(name):
    state = pkg(name, "state").StateStore()
    pa = pkg(name, "core.plan_apply")
    q = pa.PlanQueue()
    q.set_enabled(True)
    return state, q, pa.PlanApplier(state, q)


def _node(name, i=0, **kw):
    return pkg(name, "mock").node(id=f"node-{i:03d}", **kw)


def _alloc(name, job, node_id, i, cpu, mem=100):
    structs = pkg(name, "structs")
    a = pkg(name, "mock").alloc(job=job, node_id=node_id)
    a.id = f"alloc-{i:04d}"
    a.name = f"{job.id}.web[{i}]"
    a.resources = structs.Resources(cpu=cpu, memory_mb=mem)
    return a


def _result(res, err):
    if res is None:
        return None, repr(err)
    return (sorted(res.node_allocation),
            {n: sorted(a.id for a in v)
             for n, v in res.node_allocation.items()},
            {n: sorted(a.id for a in v)
             for n, v in res.node_update.items()},
            sorted(res.refuted_nodes), res.alloc_index > 0,
            repr(err))


def _store(state):
    snap = state.snapshot()
    out = []
    for job in snap.jobs():
        for a in snap.allocs_by_job(job.namespace, job.id):
            out.append((a.id, a.name, a.node_id, a.desired_status,
                        a.client_status, a.resources.cpu))
    return sorted(out)


def _apply(q, applier, plan):
    p = q.enqueue(plan)
    applier.apply_one(p)
    res, err = p.wait(0.1)
    return res, err


def case_refutes_overcommitted_node(name):
    structs = pkg(name, "structs")
    state, q, applier = _setup(name)
    n = _node(name)
    state.upsert_node(n)
    job = pkg(name, "mock").job(id="web")
    state.upsert_job(job)
    out = []
    plan_a = structs.Plan(eval_id="ea", job=job)
    plan_a.append_alloc(_alloc(name, job, n.id, 1, 3000))
    res_a, err_a = _apply(q, applier, plan_a)
    out.append(_result(res_a, err_a))
    plan_b = structs.Plan(eval_id="eb", job=job)
    plan_b.append_alloc(_alloc(name, job, n.id, 2, 3000))
    res_b, err_b = _apply(q, applier, plan_b)
    out.append(_result(res_b, err_b))
    out.append(res_b.full_commit(plan_b))
    return out, _store(state), dict(applier.stats)


def case_plan_with_stop_frees_capacity(name):
    structs = pkg(name, "structs")
    state, q, applier = _setup(name)
    n = _node(name)
    state.upsert_node(n)
    job = pkg(name, "mock").job(id="web")
    state.upsert_job(job)
    old = _alloc(name, job, n.id, 1, 3500)
    state.upsert_allocs([old])
    stopped = old.copy_skip_job()
    plan = structs.Plan(eval_id="e", job=job)
    plan.append_stopped_alloc(stopped, "update")
    plan.append_alloc(_alloc(name, job, n.id, 2, 3500))
    res, err = _apply(q, applier, plan)
    return [_result(res, err)], _store(state), dict(applier.stats)


def case_down_node_refused(name):
    structs = pkg(name, "structs")
    state, q, applier = _setup(name)
    n = _node(name, status="down")
    state.upsert_node(n)
    job = pkg(name, "mock").job(id="web")
    plan = structs.Plan(eval_id="e", job=job)
    plan.append_alloc(_alloc(name, job, n.id, 1, 500))
    res, err = _apply(q, applier, plan)
    return [_result(res, err)], _store(state), dict(applier.stats)


def case_seeded_race(name, seed=5):
    """Twelve plans of 1-4 allocs each over four nodes, asks drawn so
    that later plans overcommit some nodes: the applier refutes and
    commits the same allocs in both packages."""
    structs = pkg(name, "structs")
    state, q, applier = _setup(name)
    for i in range(4):
        state.upsert_node(_node(name, i))
    job = pkg(name, "mock").job(id="web")
    state.upsert_job(job)
    rng = np.random.default_rng(seed)
    out = []
    k = 0
    for p in range(12):
        plan = structs.Plan(eval_id=f"e{p}", job=job)
        for _ in range(int(rng.integers(1, 5))):
            k += 1
            plan.append_alloc(_alloc(
                name, job, f"node-{int(rng.integers(4)):03d}", k,
                int(rng.choice([200, 900, 1700])),
                int(rng.choice([128, 1024]))))
        res, err = _apply(q, applier, plan)
        out.append(_result(res, err))
        out.append(res.full_commit(plan))
    return out, _store(state), dict(applier.stats)


CASES = {"refutes_overcommitted_node": case_refutes_overcommitted_node,
         "plan_with_stop_frees_capacity": case_plan_with_stop_frees_capacity,
         "down_node_refused": case_down_node_refused,
         "seeded_race": case_seeded_race}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plan_applier_cases_alike(case):
    (r_out, r_store, r_stats), (p_out, p_store, p_stats) = \
        (CASES[case](name) for name in PACKAGES)
    assert r_out == p_out
    assert r_store == p_store
    assert r_stats == p_stats
    if case == "refutes_overcommitted_node":
        assert r_out[1][3] == ["node-000"]
        assert "alloc-0002" not in [a[0] for a in r_store]
    if case == "seeded_race":
        assert r_stats["plans_refuted"] >= 1


def test_queue_orders_and_latency_alike():
    """Priority order out of the queue, the disabled queue's refusal
    and the latency ring's quantile arithmetic, on each package's
    VirtualClock."""
    out = []
    for name in PACKAGES:
        structs = pkg(name, "structs")
        pa = pkg(name, "core.plan_apply")
        clock = pkg(name, "chaos.clock").VirtualClock()
        try:
            q = pa.PlanQueue()
            q.clock = clock
            q.set_enabled(True)
            for i, prio in enumerate((50, 90, 10, 90)):
                plan = structs.Plan(eval_id=f"e{i}", priority=prio)
                q.enqueue(plan)
                clock.advance(1.0)
            order = []
            while True:
                p = q.dequeue(timeout=0.0)
                if p is None:
                    break
                order.append(p.plan.eval_id)
                clock.advance(0.5)
                p.respond(structs.PlanResult(), None)
            q.set_enabled(False)
            refused = q.enqueue(structs.Plan(eval_id="late"))
            out.append((order, sorted(q.latencies),
                        q.latency_quantiles((0.5, 0.9, 0.99)),
                        repr(refused.wait(0.0)[1])))
        finally:
            clock.close()
    assert out[0] == out[1]
