"""An eval whose plan the planner fails to submit stays pending
(nomad_tpu_torch/scheduler/generic.py, scheduler/system.py), as upstream
Nomad leaves it: its server stopped leading, or the broker delivered it
again.  The reference marks it failed and mints a follow-up 60-240 s
later.

Each case runs a dev-mode `Server` on the CPU with its plan applier
thread started and no worker threads: the test thread drives worker 0,
so the sequence is fixed.  A hook on the plan queue's `enqueue` changes
the leadership under the in-flight eval: lost (the queue's refusal, or
NotLeaderError from the Raft write), after which the leadership is
established again, which restores the pending eval from the store; or
lost and at once regained, which redelivers the eval, so the applier
refuses the first delivery's plan as stale and the second delivery
places it.  A plan error that persists fails the eval at the broker's
delivery limit, and the scheduler's own "maximum attempts reached"
stays failed with its follow-up, as in the reference."""

import pytest

from torch_parity import make_node, pkg

PORT = "nomad_tpu_torch"
REF = "nomad_tpu"
NOW = 1_700_000_000.0


def make_server(name, **kw):
    clock = pkg(name, "chaos.clock").VirtualClock(start=NOW, epoch=0.0)
    kw.setdefault("profile_hz", 0)
    if name == PORT:
        kw.setdefault("device", "cpu")
    else:
        kw.setdefault("mesh", False)
    return pkg(name, "core.server").Server(clock=clock, **kw)


def start_applier(s):
    """The applier thread alone (start_scheduling without the workers):
    a refused plan is never applied inline."""
    s.plan_applier.start()
    s._applier_running = True


def lose_leadership_on_submit(s, name, how):
    """Patch the plan queue so the first plan submitted meets a lost
    leadership: the leadership is revoked, then `disabled` lets the
    queue refuse, `not_leader` answers with Raft's NotLeaderError (as a
    Raft write of the lost leader does), and `stale` establishes the
    leadership again first (the broker redelivers the eval with a new
    token, and the applier refuses the plan of the first delivery)."""
    queue = s.plan_queue
    orig = queue.enqueue
    seen = []

    def enqueue(plan):
        if seen:
            return orig(plan)
        seen.append(plan.eval_id)
        s.revoke_leadership()
        if how == "stale":
            s.establish_leadership()
        if how in ("disabled", "stale"):
            return orig(plan)
        pa = pkg(name, "core.plan_apply")
        p = pa.PendingPlan(plan)
        p.respond(None, pkg(name, "core.raft").NotLeaderError(None))
        return p

    queue.enqueue = enqueue
    return seen


def cluster(name, s, n_nodes=3):
    for i in range(n_nodes):
        s.register_node(make_node(name, i))
    job = pkg(name, "mock").job(id="j-lost-leader")
    job.task_groups[0].count = 2
    return s.register_job(job)


def evals_of(s):
    return {e.id: e for e in s.state.snapshot().evals()}


def live_allocs(s, job_id="j-lost-leader"):
    snap = s.state.snapshot()
    return [a for a in snap.allocs_by_job("default", job_id)
            if a.desired_status == "run"]


def no_follow_up(stored):
    return not [e for e in stored.values()
                if e.triggered_by == "failed-follow-up"]


@pytest.mark.parametrize("eval_batch", [1, 64], ids=["solo", "batched"])
def test_stale_delivery_leaves_eval_to_its_redelivery(eval_batch):
    """Leadership lost and regained under the in-flight eval: the first
    delivery's plan is refused as stale, the eval is not marked failed,
    and its redelivery places it (no follow-up minted)."""
    s = make_server(PORT, eval_batch=eval_batch)
    try:
        s.establish_leadership()
        ev = cluster(PORT, s)
        start_applier(s)
        seen = lose_leadership_on_submit(s, PORT, "stale")
        assert s.process_all() == 2
        assert seen == [ev.id]
        assert s.plan_applier.stats["stale_token"] == 1
        stored = evals_of(s)
        assert stored[ev.id].status == "complete"
        assert len(live_allocs(s)) == 2
        assert no_follow_up(stored)
    finally:
        s.shutdown()


@pytest.mark.parametrize("eval_batch", [1, 64], ids=["solo", "batched"])
@pytest.mark.parametrize("how", ["disabled", "not_leader"])
def test_lost_leadership_leaves_eval_pending(how, eval_batch):
    s = make_server(PORT, eval_batch=eval_batch)
    try:
        s.establish_leadership()
        ev = cluster(PORT, s)
        start_applier(s)
        seen = lose_leadership_on_submit(s, PORT, how)
        assert s.process_all() == 1
        assert seen == [ev.id]
        stored = evals_of(s)
        assert stored[ev.id].status == "pending"
        assert not [e for e in stored.values()
                    if e.triggered_by == "failed-follow-up"]
        assert live_allocs(s) == []
        # the next leadership restores the pending eval and places it
        s.revoke_leadership()
        s.establish_leadership()
        assert s.process_all() == 1
        stored = evals_of(s)
        assert stored[ev.id].status == "complete"
        assert len(live_allocs(s)) == 2
        assert not [e for e in stored.values()
                    if e.triggered_by == "failed-follow-up"]
    finally:
        s.shutdown()


def test_reference_fails_the_eval_on_lost_leadership():
    """The difference the port makes: the reference marks the eval
    failed on the queue's refusal and mints its follow-up."""
    s = make_server(REF, eval_batch=1)
    try:
        s.establish_leadership()
        ev = cluster(REF, s)
        start_applier(s)
        lose_leadership_on_submit(s, REF, "disabled")
        assert s.process_all() == 1
        stored = evals_of(s)
        assert stored[ev.id].status == "failed"
        assert stored[ev.id].status_description == "plan queue disabled"
        fus = [e for e in stored.values()
               if e.triggered_by == "failed-follow-up"]
        assert len(fus) == 1 and fus[0].wait_until >= NOW + 60.0
    finally:
        s.shutdown()


@pytest.mark.parametrize("name", [REF, PORT])
def test_max_attempts_still_fails_with_follow_up(name, monkeypatch):
    """The scheduler's own retry exhaustion keeps the reference's
    failed status and delayed follow-up in both packages."""
    generic = pkg(name, "scheduler.generic")
    monkeypatch.setattr(generic.GenericScheduler, "_process_once",
                        lambda self, ev: (False, None))
    s = make_server(name, eval_batch=1, failed_follow_up_delay=(5.0, 5.0))
    try:
        s.establish_leadership()
        ev = cluster(name, s)
        assert s.process_all() == 1
        stored = evals_of(s)
        assert stored[ev.id].status == "failed"
        assert stored[ev.id].status_description == \
            "maximum attempts reached (5)"
        fus = [e for e in stored.values()
               if e.triggered_by == "failed-follow-up"]
        assert len(fus) == 1 and fus[0].previous_eval == ev.id
        assert fus[0].wait_until == NOW + 5.0
    finally:
        s.shutdown()


def test_persistent_plan_error_fails_at_the_delivery_limit():
    """A plan error that is not a lost delivery (here every plan meets
    it) is nacked too; the broker redelivers the eval up to its delivery
    limit, and the leader's tick then reaps it as failed, with its
    follow-up."""
    s = make_server(PORT, eval_batch=1, failed_follow_up_delay=(5.0, 5.0))
    try:
        s.eval_broker.delivery_limit = 2
        s.establish_leadership()
        ev = cluster(PORT, s)
        start_applier(s)
        pa = pkg(PORT, "core.plan_apply")

        def refuse(plan):
            p = pa.PendingPlan(plan)
            p.respond(None, RuntimeError("boom"))
            return p

        s.plan_queue.enqueue = refuse
        assert s.process_all() == 2          # delivered twice, nacked
        stored = evals_of(s)
        assert stored[ev.id].status == "pending"
        assert no_follow_up(stored)
        s.tick(now=NOW + 1.0)
        stored = evals_of(s)
        assert stored[ev.id].status == "failed"
        fus = [e for e in stored.values()
               if e.triggered_by == "failed-follow-up"]
        assert len(fus) == 1 and fus[0].previous_eval == ev.id
        assert live_allocs(s) == []
    finally:
        s.shutdown()
