"""The port's event stream and read-path fanout
(nomad_tpu_torch/core/{stream,fanout}.py) against the reference's: the
same store writes, from pinned ids on each package's VirtualClock with
one epoch, give the same EventBroker event sequence (topics, types,
keys, indexes and the codec's bytes of every event) to a live
subscriber, a filtered one and a late one replaying by index, the same
drop accounting on a small ring, and the same WatchHub wake-ups."""

import json
import threading

from torch_parity import PACKAGES, make_node, pkg

EPOCH = 1_700_000_000.0


def _store(name):
    state = pkg(name, "state").StateStore()
    state.clock = pkg(name, "chaos.clock").VirtualClock(start=10.0,
                                                        epoch=EPOCH)
    return state


def _writes(name, state):
    """Nodes, jobs, evals (one blocked), allocs, a status change, an
    alloc update and a deregistration, all from pinned ids."""
    mock = pkg(name, "mock")
    structs = pkg(name, "structs")
    # make_node pins the name and unique.hostname, which mock.node draws
    # from a per-package counter
    nodes = [make_node(name, i) for i in range(3)]
    for n in nodes:
        state.upsert_node(n)
        state.clock.advance(1.0)
    job = mock.job(id="web")
    state.upsert_job(job)
    ev = mock.eval(id="eval-1", job_id="web")
    blocked = mock.eval(id="eval-2", job_id="web", status="blocked")
    state.upsert_evals([ev, blocked])
    allocs = []
    for i in range(4):
        a = mock.alloc(job=job, node_id=nodes[i % 3].id)
        a.id = f"alloc-{i}"
        a.name = f"web.web[{i}]"
        allocs.append(a)
    state.upsert_allocs(allocs)
    state.clock.advance(1.0)
    state.update_node_status("node-00001", "down")
    upd = allocs[0].copy()
    upd.client_status = "running"
    state.update_allocs_from_client([upd])
    state.upsert_job(mock.job(id="batch-1", type="batch"))
    state.delete_job("default", "batch-1")
    state.upsert_csi_volume(structs.CSIVolume(id="vol-0", plugin_id="p"))
    state.clock.advance(1.0)


def _wire(ev):
    return (ev.topic, ev.type, ev.key, ev.index,
            json.dumps(ev.wire(), sort_keys=True, default=repr))


def _drain(sub):
    out = []
    while True:
        ev = sub.next(timeout=0.0)
        if ev is None:
            return out
        out.append(_wire(ev))


def _stream_run(name, buffer_size=4096):
    stream = pkg(name, "core.stream")
    state = _store(name)
    broker = stream.EventBroker(buffer_size=buffer_size)
    broker.attach(state)
    live = broker.subscribe()
    allocs_only = broker.subscribe({"Allocation": ["alloc-0", "alloc-2"],
                                    "Node": ["*"]})
    try:
        _writes(name, state)
        late = broker.subscribe({"Evaluation": [], "PlacementFailure":
                                 ["*"], "Job": ["*"]}, from_index=2)
        out = (_drain(live), _drain(allocs_only), _drain(late),
               [s.stats() for s in (live, allocs_only, late)],
               broker.stats()["DroppedTotal"],
               {k: v for k, v in broker.mem_stats().items()
                if k != "bytes"})
        broker.unsubscribe(late)
        return out
    finally:
        broker.close()
        state.clock.close()


def test_event_sequences_alike():
    ref, port = (_stream_run(name) for name in PACKAGES)
    assert ref == port
    topics = {e[0] for e in ref[0]}
    assert {"Node", "Job", "Evaluation", "Allocation",
            "PlacementFailure"} <= topics
    assert [e[2] for e in ref[1] if e[0] == "Allocation"] == \
        ["alloc-0", "alloc-2", "alloc-0"]


def test_small_ring_drops_alike():
    ref, port = (_stream_run(name, buffer_size=4) for name in PACKAGES)
    assert ref == port
    assert ref[4] > 0


def _hub_run(name):
    """WatchHub on a store: a call already past returns at once, one
    with no wait times out, two parked waiters of one shape wake on a
    write that moves the shape's result and not on one that does not."""
    fanout = pkg(name, "core.fanout")
    mock = pkg(name, "mock")
    state = _store(name)
    hub = fanout.WatchHub(state, state.clock)
    out = []
    try:
        state.upsert_node(mock.node(id="node-0"))
        idx = state.latest_index()

        def jobs_index():
            return max([j.modify_index for j in state.snapshot().jobs()]
                       or [0])

        out.append(hub.block("nodes", state.latest_index, idx - 1, 0.0))
        out.append(hub.block("jobs", jobs_index, 0, 0.0))
        results = []
        started = threading.Barrier(3)

        def waiter():
            started.wait(timeout=5)
            results.append(hub.block("jobs", jobs_index, 0, 5.0))

        threads = [threading.Thread(target=waiter) for _ in range(2)]
        try:
            for t in threads:
                t.start()
            started.wait(timeout=5)
            # a write the shape does not watch, then one it does
            state.upsert_node(mock.node(id="node-1"))
            state.upsert_job(mock.job(id="web"))
        finally:
            for t in threads:
                t.join(timeout=10)
        out.append(sorted(results))
        out.append(any(t.is_alive() for t in threads))
        st = hub.stats()
        out.append((st["shapes"], st["waiters"], st["wakes"],
                    st["timeouts"]))
        out.append(hub.reap_idle(state.clock.monotonic(), 0.0))
        return out
    finally:
        state.clock.close()


def test_watch_hub_wakes_alike():
    ref, port = (_hub_run(name) for name in PACKAGES)
    assert ref == port
    assert ref[:4] == [True, False, [True, True], False]


def _ring_run(name):
    """EventRing alone: seeks over indexes after a trim, the stats, and
    a reader parked on the head woken by close."""
    ring = pkg(name, "core.fanout").EventRing(capacity=3)
    for i in range(1, 6):
        ring.append("Node", i, f"n{i}", 1)
    out = [ring.seek(k) for k in (0, 2, 4, 9)]
    out.append({k: v for k, v in ring.stats().items() if k != "bytes"})
    woke = []
    t = threading.Thread(target=lambda: woke.append(
        ring.wait_for(ring.head()[0], 5.0, lambda: False)))
    try:
        t.start()
        ring.close()
    finally:
        t.join(timeout=10)
    out.append((t.is_alive(), woke))
    return out


def test_event_ring_seek_and_close_alike():
    ref, port = (_ring_run(name) for name in PACKAGES)
    assert ref == port
    assert ref[-1][0] is False
