"""The port's eval broker, blocked-evals tracker and heartbeat timers
(nomad_tpu_torch/core/{eval_broker,blocked_evals,heartbeat}.py) against
the reference's on the same seeded scripts, each package on its own
VirtualClock: the same deliveries, the same order of tokens (by the
order in which they were issued; token values are random ids), the same
failures and stats (after tests/test_eval_broker_virtual.py::
TestDeterministicReplay); blocked evals released alike on a capacity
event; heartbeat expiry marking the same node down with the same
evals."""

import numpy as np
import pytest

from torch_parity import PACKAGES, pkg

JOBS = ("j0", "j1", "j2", "j3", "j4", "j5")
TYPES = ("service", "batch")


def _broker(name, **kw):
    b = pkg(name, "core.eval_broker").EvalBroker(**kw)
    b.set_enabled(True)
    return b


def _script(name, seed, steps=160):
    """A seeded churn of enqueue (some delayed), dequeue, dequeue_batch,
    ack, nack, extend_outstanding and tick, advancing the package's own
    VirtualClock.  Returns the trace of every observable answer."""
    mock = pkg(name, "mock")
    clock = pkg(name, "chaos.clock").VirtualClock()
    rng = np.random.default_rng(seed)
    b = _broker(name, nack_timeout=20.0, delivery_limit=3,
                subsequent_nack_delay=5.0)
    trace = []
    held = []            # (eval id, token) in delivery order
    issued = {}          # token -> its number in delivery order
    n_ev = 0
    try:
        for step in range(steps):
            now = clock.monotonic()
            op = rng.integers(8)
            if op <= 1:
                n_ev += 1
                wait = (now + float(rng.integers(1, 30))
                        if rng.random() < 0.2 else 0.0)
                ev = mock.eval(
                    id=f"e-{n_ev:04d}", job_id=JOBS[rng.integers(len(JOBS))],
                    type=TYPES[rng.integers(2)],
                    priority=int(rng.choice([10, 50, 90])),
                    wait_until=wait)
                b.enqueue(ev, now=now)
                trace.append(("enqueue", ev.id, ev.job_id, ev.type))
            elif op <= 3:
                types = list(TYPES[:rng.integers(1, 3)])
                if op == 2:
                    got = [b.dequeue(types, now=now, timeout=0.0)]
                else:
                    got = b.dequeue_batch(types, int(rng.integers(1, 5)),
                                          now=now, timeout=0.0)
                for ev, tok in got:
                    if ev is None:
                        trace.append(("empty",))
                        continue
                    issued[tok] = len(issued)
                    held.append((ev.id, tok))
                    trace.append(("deliver", ev.id, issued[tok],
                                  b._dequeues.get(ev.id, 0)))
            elif op <= 5 and held:
                eid, tok = held.pop(int(rng.integers(len(held))))
                if op == 4:
                    err = b.ack(eid, tok)
                else:
                    err = b.nack(eid, tok, now=now)
                trace.append(("ack" if op == 4 else "nack", eid,
                              issued[tok], err))
            elif op == 6 and held:
                b.extend_outstanding(held[:2], now=now)
                trace.append(("extend", [e for e, _ in held[:2]],
                              [b.token_valid(e, t) for e, t in held]))
            else:
                b.tick(now)
                trace.append(("tick", b.pending_evals(),
                              [e.id for e in b.drain_failed()]))
            clock.advance(float(rng.integers(0, 4)))
        trace.append(("stats", dict(b.stats), b.pending_evals(),
                      sorted(e.id for e in b.failed_evals())))
    finally:
        clock.close()
    return trace


@pytest.mark.parametrize("seed", range(6))
def test_seeded_broker_script_replays_alike(seed):
    ref, port = (_script(name, seed) for name in PACKAGES)
    assert ref == port
    kinds = {t[0] for t in ref}
    assert {"enqueue", "deliver", "tick"} <= kinds


def test_delivery_limit_and_penalty_paths_alike():
    """The reference's replay script (every path the soak leans on:
    penalty redeliveries, wait_until promotion, nack-timeout expiry,
    delivery-limit failure) on both packages."""
    out = []
    for name in PACKAGES:
        mock = pkg(name, "mock")
        clock = pkg(name, "chaos.clock").VirtualClock()
        b = _broker(name, nack_timeout=30.0, delivery_limit=3,
                    subsequent_nack_delay=10.0)
        trace = []
        try:
            b.enqueue(mock.eval(id="e-flaky", job_id="j-flaky"),
                      now=clock.monotonic())
            b.enqueue(mock.eval(id="e-late", job_id="j-late",
                                wait_until=clock.monotonic() + 25.0),
                      now=clock.monotonic())
            b.enqueue(mock.eval(id="e-slow", job_id="j-slow"),
                      now=clock.monotonic())
            b.enqueue(mock.eval(id="e-good", job_id="j-good"),
                      now=clock.monotonic())
            held = {}
            for _ in range(200):
                now = clock.monotonic()
                b.tick(now)
                while True:
                    ev, tok = b.dequeue(["service"], now=now, timeout=0.0)
                    if ev is None:
                        break
                    attempt = b._dequeues.get(ev.id, 0)
                    trace.append((now, "dequeue", ev.id, attempt))
                    if ev.id == "e-flaky":
                        b.nack(ev.id, tok, now=now)
                        trace.append((now, "nack", ev.id))
                    elif ev.id == "e-slow" and not held:
                        held[ev.id] = tok
                    else:
                        b.ack(ev.id, tok)
                        trace.append((now, "ack", ev.id))
                for ev in b.drain_failed():
                    trace.append((clock.monotonic(), "failed", ev.id))
                clock.advance(1.0)
            trace.append(("stats", dict(b.stats), b.pending_evals()))
        finally:
            clock.close()
        out.append(trace)
    assert out[0] == out[1]
    assert any(t[1:] == ("failed", "e-flaky") for t in out[1])


def _blocked_run(name):
    """Blocked evals of three jobs on two node classes, one escaped: a
    capacity event on class c1 releases its evals and the escaped one,
    a duplicate is refused, a stale snapshot re-enqueues at once, and
    untrack drops a job's eval."""
    mock = pkg(name, "mock")
    b = _broker(name)
    be = pkg(name, "core.blocked_evals").BlockedEvals(b)
    be.set_enabled(True)
    out = []

    def blocked(eid, job, klass=None, snapshot_index=0):
        ev = mock.eval(id=eid, job_id=job)
        ev.status = "blocked"
        ev.snapshot_index = snapshot_index
        if klass is None:
            ev.escaped_computed_class = True
        else:
            ev.class_eligibility = {klass: True, "other": False}
        return ev

    out.append(be.block(blocked("b1", "j1", "c1")))
    out.append(be.block(blocked("b2", "j2", "c2")))
    out.append(be.block(blocked("b3", "j3")))
    out.append(be.block(blocked("b1-dup", "j1", "c1")))
    out.append(be.block(blocked("b1", "j1", "c1")))
    out.append(be.unblock("c1", now=5.0, index=10))
    out.append(be.block(blocked("b4", "j4", "c2", snapshot_index=7)))
    be.untrack("default", "j2")
    out.append(be.unblock("c2", index=11))
    out.append((be.num_blocked(), dict(be.stats)))
    delivered = []
    while True:
        ev, tok = b.dequeue(["service"], now=6.0, timeout=0.0)
        if ev is None:
            break
        delivered.append((ev.id, ev.status, ev.status_description))
        b.ack(ev.id, tok)
    out.append(delivered)
    be.block(blocked("b5", "j5", "c3", snapshot_index=20))
    out.append(be.unblock_all(now=7.0))
    return out


def test_blocked_evals_release_alike():
    ref, port = (_blocked_run(name) for name in PACKAGES)
    assert ref == port
    # c1's eval and the escaped one on the capacity event, the stale
    # snapshot's at once; j2 untracked, the duplicate refused
    assert sorted(d[0] for d in ref[-2]) == ["b1", "b3", "b4"]
    assert ref[3] is False and ref[-3][0] == 0


def _heartbeat_run(name):
    """Three nodes with a service job's allocs: two keep beating, one
    does not; the expired node goes down and yields one node-update
    eval per job with live allocs there (and, for a node back to
    ready, the system job too)."""
    mock = pkg(name, "mock")
    hb_mod = pkg(name, "core.heartbeat")
    state = pkg(name, "state").StateStore()
    clock = pkg(name, "chaos.clock").VirtualClock(start=1000.0)
    try:
        timers = hb_mod.HeartbeatTimers(ttl=30.0)
        nodes = [mock.node(id=f"node-{i}") for i in range(3)]
        for n in nodes:
            state.upsert_node(n)
            timers.reset(n.id, clock.time())
        job = mock.job(id="svc")
        sysjob = mock.system_job(id="sys")
        state.upsert_job(job)
        state.upsert_job(sysjob)
        allocs = []
        for i, n in enumerate(nodes):
            a = mock.alloc(job=job, node_id=n.id)
            a.id = f"alloc-{i}"
            a.name = f"svc.web[{i}]"
            allocs.append(a)
        state.upsert_allocs(allocs)
        out = []
        clock.advance(20.0)
        for n in nodes[:2]:
            timers.reset(n.id, clock.time())
        clock.advance(15.0)
        out.append(timers.expired(clock.time()))
        evals = []
        for nid in out[-1]:
            evals += hb_mod.invalidate_heartbeat(state, nid, clock.time())
        out.append([(e.job_id, e.type, e.triggered_by, e.node_id,
                     e.priority) for e in evals])
        out.append(state.node_by_id("node-2").status)
        state.update_node_status("node-2", "ready")
        back = hb_mod.build_node_evals(state.snapshot(), "node-2",
                                       include_system=True)
        out.append([(e.job_id, e.type, e.triggered_by, e.node_id)
                    for e in back])
        out.append((timers.has("node-2"), timers.has("node-0")))
        clock.advance(40.0)
        out.append(sorted(timers.expired(clock.time())))
        return out
    finally:
        clock.close()


def test_heartbeat_expiry_alike():
    ref, port = (_heartbeat_run(name) for name in PACKAGES)
    assert ref == port
    assert ref[0] == ["node-2"] and ref[2] == "down"


def test_disabled_broker_parks_a_blocking_dequeue():
    """The port's documented difference: a dequeue with a timeout on a
    disabled broker (a follower's worker) waits out its timeout, and
    set_enabled wakes it, where the reference's returns at once.  A
    zero timeout returns at once in both, and the answer is the same."""
    import threading
    import time

    answers = []
    for name in PACKAGES:
        b = pkg(name, "core.eval_broker").EvalBroker()
        t0 = time.monotonic()
        answers.append(b.dequeue(["batch"], now=0.0, timeout=0.3))
        waited = time.monotonic() - t0
        if name == PACKAGES[1]:
            assert waited >= 0.25
        else:
            assert waited < 0.25
        assert b.dequeue(["batch"], now=0.0, timeout=0.0) == (None, "")
    assert answers[0] == answers[1] == (None, "")
    # the port's parked caller is woken by leadership, then dequeues
    mock = pkg(PACKAGES[1], "mock")
    b = pkg(PACKAGES[1], "core.eval_broker").EvalBroker()
    got = []
    t = threading.Thread(target=lambda: got.append(
        b.dequeue(["batch"], now=0.0, timeout=30.0)))
    t.start()
    time.sleep(0.1)
    ev = mock.eval(type="batch")
    b.set_enabled(True)
    b.enqueue(ev, now=0.0)
    t.join(timeout=10)
    assert not t.is_alive()
    assert got and got[0][0] is not None and got[0][0].id == ev.id


def test_follower_worker_does_not_spin():
    """A worker of a server whose broker is disabled polls about ten
    times a second (its 0.1 s timeout), not as fast as it can."""
    import time

    server = pkg(PACKAGES[1], "core.server").Server(
        dev_mode=False, device="cpu", profile_hz=0)
    try:
        worker = server.workers[0]
        calls = []
        orig = server.eval_broker.dequeue_batch

        def counted(*a, **k):
            calls.append(1)
            return orig(*a, **k)

        server.eval_broker.dequeue_batch = counted
        worker.start()
        time.sleep(1.0)
        worker.stop()
    finally:
        server.shutdown()
    assert 1 <= len(calls) <= 30
