"""The port's cluster plane (nomad_tpu_torch/core/{raft,membership,
cluster}.py) on the CPU: the scenarios of the reference's
tests/test_cluster.py run on the port (election, replication, failover,
forwarding, autopilot reap, NotLeaderError), a scripted command sequence
gives equal stores in a reference and a port three-server cluster, and
a Raft snapshot restores across packages in both directions.

Clusters run on loopback TCP with the wall clock, one worker a server,
the port's engine on the CPU (`device="cpu"`) and the reference's on one
device (`one_device`).  The Raft timings (50 ms heartbeats and 0.3-0.6 s
elections for bare Raft, 0.1 s and 1.5-3 s for whole servers) and every
wait (up to 60 s) leave room for a loaded host: the tests run under
xdist beside other files.  Elections draw from the
module `random`, so the two packages' clusters need not elect the same
server: the comparisons are of committed state and committed command
bytes, never of who led."""

import pickle
import time

import pytest

from torch_parity import (PACKAGES, fsm_restore, fsm_snapshot,  # noqa: F401
                          one_device, pinned, pkg, reset_mock_counters)

REF, PORT = PACKAGES
# stamped from each server's wall clock as its FSM applies the command
# (an eval's or alloc's ModifyTime): they differ between the servers of
# one cluster too, so the store comparisons drop them
WALL_FIELDS = {"CreateTime", "ModifyTime"}
TIMING = dict(heartbeat_interval=0.05, election_timeout=(0.3, 0.6))
# the full clusters: a first engine call can hold the interpreter for
# most of a second, so their followers wait longer before an election
CLUSTER_TIMING = dict(heartbeat_interval=0.1, election_timeout=(1.5, 3.0))
WAIT = 60.0


def drop_fields(obj, names=WALL_FIELDS):
    """`obj` with every dict key in `names` removed, at any depth."""
    if isinstance(obj, dict):
        return {k: drop_fields(v, names) for k, v in obj.items()
                if k not in names}
    if isinstance(obj, list):
        return [drop_fields(v, names) for v in obj]
    return obj


def wait_for(fn, timeout=WAIT, interval=0.05, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = fn()
        if v:
            return v
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {msg}")


# --------------------------------------------------------------------- raft


class KVFSM:
    """Tiny deterministic FSM for the Raft cases."""

    def __init__(self):
        self.data = {}
        self.applied = []

    def apply(self, cmd: bytes):
        k, v = pickle.loads(cmd)
        self.data[k] = v
        self.applied.append((k, v))
        return len(self.applied)

    def snapshot(self) -> bytes:
        return pickle.dumps((self.data, self.applied))

    def restore(self, data: bytes) -> None:
        self.data, self.applied = pickle.loads(data)


def raft_node(name, fsm, **kw):
    raft = pkg(PORT, "core.raft")
    return raft.RaftNode(name, ("127.0.0.1", 0), fsm_apply=fsm.apply,
                         fsm_snapshot=fsm.snapshot,
                         fsm_restore=fsm.restore, **{**TIMING, **kw})


def raft_trio(**kw):
    fsms = [KVFSM() for _ in range(3)]
    nodes = [raft_node(f"s{i}", fsms[i], **kw) for i in range(3)]
    addrs = {n.name: n.addr for n in nodes}
    for n in nodes:
        n.set_peers(addrs)
        n.start()
    return nodes, fsms


def leader_of(nodes):
    leaders = [n for n in nodes if n.is_leader()]
    return leaders[0] if len(leaders) == 1 else None


def stop_all(nodes):
    for n in nodes:
        n.stop()


def test_raft_election_and_replication():
    nodes, fsms = raft_trio()
    try:
        leader = wait_for(lambda: leader_of(nodes), msg="leader")
        for i in range(5):
            leader.apply(pickle.dumps((f"k{i}", i)))
        wait_for(lambda: all(len(f.applied) == 5 for f in fsms),
                 msg="replication")
        assert all(f.data == fsms[0].data for f in fsms)
        assert len({n.term for n in nodes}) == 1
    finally:
        stop_all(nodes)


def test_raft_followers_learn_a_commit_without_a_heartbeat():
    """The port's leader tells its followers of a commit advance at once
    (core/raft.py, difference 2): with a simulated network and the
    virtual clock stopped once a leader is elected, so that no heartbeat
    can fire, an entry the leader commits reaches every follower's
    commit index and FSM.  The reference's followers stay one entry
    behind until a heartbeat."""
    import threading

    clock_mod = pkg(PORT, "chaos.clock")
    transport = pkg(PORT, "chaos.transport")
    raft = pkg(PORT, "core.raft")
    clock = clock_mod.VirtualClock()
    net = transport.SimNetwork(clock=clock, seed=0)
    fsms = [KVFSM() for _ in range(3)]
    nodes = [raft.RaftNode(f"s{i}", ("", 0), fsm_apply=fsms[i].apply,
                           transport=net.node(f"s{i}"), clock=clock,
                           bootstrap_expect=3, heartbeat_interval=0.05,
                           election_timeout=(0.2, 0.4))
             for i in range(3)]
    addrs = {n.name: n.addr for n in nodes}
    stop = threading.Event()

    def drive():
        while not stop.is_set():
            clock.advance(0.01)
            time.sleep(0.001)

    ticker = threading.Thread(target=drive, daemon=True)
    try:
        for n in nodes:
            n.set_peers(addrs)
            n.start()
        ticker.start()
        leader = wait_for(lambda: leader_of(nodes), msg="leader")
        wait_for(lambda: len({n.commit_index for n in nodes}) == 1
                 and nodes[0].commit_index > 0, msg="no-op committed")
        stop.set()
        ticker.join()
        frozen = clock.monotonic()
        leader.apply(pickle.dumps(("k", 1)))
        idx = leader.commit_index
        wait_for(lambda: all(n.commit_index >= idx for n in nodes)
                 and all(f.data.get("k") == 1 for f in fsms),
                 timeout=5.0, msg="followers learn the commit")
        assert clock.monotonic() == frozen
    finally:
        stop.set()
        stop_all(nodes)
        clock.close()


def test_raft_follower_rejects_apply():
    nodes, _ = raft_trio()
    try:
        leader = wait_for(lambda: leader_of(nodes), msg="leader")
        follower = next(n for n in nodes if n is not leader)
        wait_for(lambda: follower.leader_hint() == leader.name,
                 msg="leader hint")
        NotLeaderError = pkg(PORT, "core.raft").NotLeaderError
        with pytest.raises(NotLeaderError) as info:
            follower.apply(b"nope")
        assert info.value.leader == leader.name
    finally:
        stop_all(nodes)


def test_raft_failover_preserves_log():
    nodes, fsms = raft_trio()
    try:
        leader = wait_for(lambda: leader_of(nodes), msg="leader")
        for i in range(3):
            leader.apply(pickle.dumps((f"k{i}", i)))
        leader.stop()
        rest = [n for n in nodes if n is not leader]
        new_leader = wait_for(lambda: leader_of(rest), msg="new leader")
        new_leader.apply(pickle.dumps(("post", 1)))
        live = [fsms[nodes.index(n)] for n in rest]
        wait_for(lambda: all(f.data.get("post") == 1
                             and len(f.applied) == 4 for f in live),
                 msg="post-failover replication")
        assert all(f.data.get("k2") == 2 for f in live)
    finally:
        stop_all(nodes)


def test_raft_lagging_follower_catches_up_via_snapshot():
    nodes, fsms = raft_trio(max_log_entries=8)
    try:
        leader = wait_for(lambda: leader_of(nodes), msg="leader")
        follower = next(n for n in nodes if n is not leader)
        follower.stop()
        for i in range(40):     # compaction past the stopped follower
            leader.apply(pickle.dumps((f"k{i}", i)))
        wait_for(lambda: leader.snap_index > 0, msg="compaction")
        reborn_fsm = KVFSM()
        reborn = raft_node(follower.name, reborn_fsm)
        others = {n.name: n.addr for n in nodes if n is not follower}
        reborn.set_peers(others)
        for n in nodes:
            if n is not follower:
                n.set_peers({reborn.name: reborn.addr})
        reborn.start()
        try:
            wait_for(lambda: reborn_fsm.data.get("k39") == 39,
                     msg="catch-up")
            assert reborn.snap_index > 0     # by snapshot install
            assert reborn_fsm.data == fsms[nodes.index(leader)].data
        finally:
            reborn.stop()
    finally:
        stop_all(n for n in nodes if n is not follower)


def test_raft_durable_restart_replays_log(tmp_path):
    fsm = KVFSM()
    node = raft_node("solo", fsm, data_dir=str(tmp_path))
    node.start()
    try:
        wait_for(lambda: node.is_leader(), msg="single-node leader")
        for i in range(4):
            node.apply(pickle.dumps((f"k{i}", i)))
    finally:
        node.stop()
    fsm2 = KVFSM()
    node2 = raft_node("solo", fsm2, data_dir=str(tmp_path))
    node2.start()
    try:
        wait_for(lambda: node2.is_leader(), msg="restarted leader")
        wait_for(lambda: fsm2.data.get("k3") == 3, msg="log replay")
        assert fsm2.data == fsm.data and node2.term > node.term - 1
    finally:
        node2.stop()


def _durable_log(name, data_dir):
    """The log a fresh RaftNode of `name` restores from `data_dir`."""
    raft = pkg(name, "core.raft")
    fsm = KVFSM()
    node = raft.RaftNode("f", ("127.0.0.1", 0), fsm_apply=fsm.apply,
                         fsm_snapshot=fsm.snapshot,
                         fsm_restore=fsm.restore, data_dir=str(data_dir))
    try:
        return ([(e.term, e.index, e.cmd) for e in node.log],
                node.term, node.snap_index)
    finally:
        node.stop()


APPENDS = [
    # (term, prev_idx, prev_term, entries, commit)
    (1, 0, 0, [(1, 1, b"a"), (1, 2, b"b")], 0),
    (1, 2, 1, [(1, 3, b"c")], 2),
    (1, 3, 1, [], 3),                        # a heartbeat: nothing new
    (2, 1, 1, [(2, 2, b"B"), (2, 3, b"C")], 3),   # conflict: truncate
    (2, 3, 2, [(2, 4, b"D")], 3),
    (2, 2, 2, [(2, 3, b"C"), (2, 4, b"D")], 4),   # a resend: no change
]


@pytest.mark.parametrize("name", PACKAGES)
def test_follower_durable_log_restores_what_it_appended(tmp_path, name):
    """A follower's AppendEntries, conflicts and resends included, leave
    a durable log that restores to the follower's own log, in both
    packages (the port appends where the reference rewrites; the
    restored log is the same)."""
    raft = pkg(name, "core.raft")
    fsm = KVFSM()
    node = raft.RaftNode("f", ("127.0.0.1", 0), fsm_apply=fsm.apply,
                         data_dir=str(tmp_path))
    answers = []
    try:
        for term, prev_idx, prev_term, ents, commit in APPENDS:
            answers.append(node._on_append({
                "term": term, "leader": "l", "prev_idx": prev_idx,
                "prev_term": prev_term, "entries": ents,
                "commit": commit}))
        live = [(e.term, e.index, e.cmd) for e in node.log]
    finally:
        node.stop()
    assert live == [(1, 1, b"a"), (2, 2, b"B"), (2, 3, b"C"),
                    (2, 4, b"D")]
    assert _durable_log(name, tmp_path) == (live, 2, 0)
    assert [a["ok"] for a in answers] == [True] * 6


# ------------------------------------------------------------------- gossip


def test_gossip_join_and_failure_detection():
    Gossip = pkg(PORT, "core.membership").Gossip
    gs = [Gossip(n, ("127.0.0.1", 0), probe_interval=0.1,
                 suspect_timeout=0.6) for n in "abc"]
    for g in gs:
        g.start()
    try:
        assert gs[1].join(gs[0].addr)
        assert gs[2].join(gs[0].addr)
        wait_for(lambda: all(len(g.alive_members()) == 3 for g in gs),
                 msg="convergence")
        gs[1].stop()
        wait_for(lambda: "b" not in gs[0].alive_members()
                 and "b" not in gs[2].alive_members(),
                 msg="failure detection")
    finally:
        for g in (gs[0], gs[2]):
            g.stop()


# ---------------------------------------------------------- full cluster


def cluster_trio(name, **kw):
    """Three ClusterServers of `name` joined through the first one's
    gossip address, started.  Not yet led."""
    cluster = pkg(name, "core.cluster")
    extra = {"device": "cpu"} if name == PORT else {}
    servers = [cluster.ClusterServer(
        f"{name}-s{i}", autopilot_grace=1.0, bootstrap_expect=3,
        heartbeat_ttl=1e6, profile_hz=0, **CLUSTER_TIMING, **extra, **kw)
        for i in range(3)]
    servers[0].start(tick_interval=0.2)
    for s in servers[1:]:
        s._join_seeds = [servers[0].gossip.addr]
        s.start(tick_interval=0.2)
    return servers


def shutdown_all(servers):
    for s in servers:
        try:
            s.shutdown()
        except Exception:  # noqa: BLE001 - best-effort teardown
            pass


def established(servers):
    """The one server that leads and has passed its leadership barrier."""
    leaders = [s for s in servers
               if s.is_leader() and getattr(s, "_leader", False)]
    return leaders[0] if len(leaders) == 1 else None


@pytest.fixture
def trio():
    servers = cluster_trio(PORT)
    try:
        yield servers
    finally:
        shutdown_all(servers)


def live_allocs(server, job):
    return [a for a in server.state.allocs_by_job(job.namespace, job.id)
            if not a.terminal_status()]


def test_cluster_elects_one_leader_everyone_knows(trio):
    leader = wait_for(lambda: established(trio), msg="leader")
    wait_for(lambda: all(s.leader_rpc_addr() == leader.rpc.addr
                         for s in trio), msg="leader known everywhere")
    assert all(len(s.raft.peers) == 2 for s in trio)
    assert all(len(s.gossip.alive_members()) == 3 for s in trio)
    secret = wait_for(lambda: leader.state.identity_secret(),
                      msg="identity secret minted")
    wait_for(lambda: all(s.state.identity_secret() == secret
                         for s in trio), msg="identity secret replicated")


def test_cluster_forwarding_and_replication(trio):
    """A node and a job registered through a FOLLOWER's RPC endpoint:
    the leader schedules, and every store holds the same allocs."""
    mock = pkg(PORT, "mock")
    leader = wait_for(lambda: established(trio), msg="leader")
    follower = next(s for s in trio if s is not leader)
    wait_for(lambda: follower.leader_rpc_addr() is not None,
             msg="follower knows the leader")
    rpc = pkg(PORT, "core.cluster").RemoteRPC([follower.rpc.addr])
    rpc.register_node(mock.node())
    job = mock.job()
    job.task_groups[0].count = 3
    rpc.call("register_job", job)
    wait_for(lambda: all(len(live_allocs(s, job)) == 3 for s in trio),
             msg="replicated placement")
    ids = [{a.id for a in live_allocs(s, job)} for s in trio]
    assert ids[0] == ids[1] == ids[2]
    # the followers' executors dispatched nothing: only the leader places
    for s in trio:
        if s is not leader:
            assert s.executor.stats["dispatches"] == 0


def test_cluster_not_leader_paths(trio):
    """NotLeaderError on a follower's Raft, the follower's state proxy
    forwarding a mutation to the leader, and the RPC endpoint's
    allowlists."""
    cluster = pkg(PORT, "core.cluster")
    structs = pkg(PORT, "structs")
    NotLeaderError = pkg(PORT, "core.raft").NotLeaderError
    leader = wait_for(lambda: established(trio), msg="leader")
    follower = next(s for s in trio if s is not leader)
    wait_for(lambda: follower.leader_rpc_addr() == leader.rpc.addr,
             msg="follower knows the leader")
    with pytest.raises(NotLeaderError):
        follower.raft.apply(b"")
    follower.state.upsert_namespace(structs.Namespace(name="fwd"))
    wait_for(lambda: all("fwd" in {n.name for n in
                                    s.state.snapshot().namespaces()}
                         for s in trio), msg="forwarded mutation")
    transport = pkg(PORT, "chaos.transport").TCPTransport()
    bad = transport.request(leader.rpc.addr, {"method": "shutdown",
                                              "args": [], "kwargs": {}},
                            timeout=10.0)
    assert bad["ok"] is False and "unknown RPC method" in bad["error"]
    bad = transport.request(leader.rpc.addr, {
        "method": "_state_mutation", "args": ["snapshot_save"],
        "kwargs": {}}, timeout=10.0)
    assert bad["ok"] is False and "unknown state mutation" in bad["error"]
    # a forwarded request landing on a non-leader bounces (one hop)
    hop = transport.request(follower.rpc.addr, {
        "method": "heartbeat_node", "args": ["x"], "kwargs": {},
        "fwd": True}, timeout=10.0)
    assert hop == {"ok": False, "not_leader": True,
                   "leader_rpc": list(leader.rpc.addr)}
    assert isinstance(cluster.MUTATIONS, frozenset)


def test_cluster_failover_reap_and_no_duplicates(trio):
    """The leader shuts down: a survivor leads, autopilot reaps the dead
    server, scheduling goes on, wave 1's allocs survive and no alloc is
    placed twice."""
    mock = pkg(PORT, "mock")
    leader = wait_for(lambda: established(trio), msg="leader")
    rpc = pkg(PORT, "core.cluster").RemoteRPC([s.rpc.addr for s in trio])
    rpc.register_node(mock.node())
    job1 = mock.job()
    job1.task_groups[0].count = 2
    rpc.call("register_job", job1)
    wait_for(lambda: len(live_allocs(leader, job1)) == 2,
             msg="initial placement")
    leader.shutdown()
    rest = [s for s in trio if s is not leader]
    new_leader = wait_for(lambda: established(rest), msg="failover leader")
    wait_for(lambda: leader.name not in new_leader.raft.peers,
             msg="autopilot reap")
    job2 = mock.job()
    job2.task_groups[0].count = 2
    rpc.call("register_job", job2)
    wait_for(lambda: all(len(live_allocs(s, job2)) == 2 for s in rest),
             msg="post-failover placement")
    for s in rest:
        assert len(live_allocs(s, job1)) == 2
        names = [a.name for j in (job1, job2) for a in live_allocs(s, j)]
        assert len(names) == len(set(names)) == 4


# ------------------------------------------------------ cross-package


def script(name):
    """A scripted sequence of replicated store mutations, built from
    explicit ids: nodes, a namespace, a job, a volume, the scheduler
    config, evals, allocs, node status, eligibility and a deletion."""
    mock = pkg(name, "mock")
    structs = pkg(name, "structs")
    nodes = [mock.node(id=f"node-{i:04d}", name=f"node-{i:04d}")
             for i in range(4)]
    job = mock.batch_job(id="script-job")
    gone = mock.batch_job(id="script-gone")
    ev = mock.eval(id="eval-0000-0000-0000-000000000001", job_id=job.id,
                   type="batch", status="complete")
    allocs = [mock.alloc(id=f"alloc-{i:04d}", node_id=nodes[i].id,
                         job=job, eval_id=ev.id,
                         name=f"{job.id}.web[{i}]") for i in range(2)]
    for obj in allocs + [ev]:           # wall time at construction
        obj.create_time = obj.modify_time = 1
    return [
        ("upsert_nodes", (nodes,)),
        ("upsert_namespace", (structs.Namespace(name="team-a"),)),
        ("upsert_job", (job,)),
        ("upsert_job", (gone,)),
        ("upsert_csi_volume", (structs.CSIVolume(
            id="vol-zone0", plugin_id="ebs0",
            access_mode="multi-node-multi-writer",
            topology_node_ids=tuple(n.id for n in nodes[:2])),)),
        ("set_scheduler_config", (structs.SchedulerConfiguration(
            scheduler_algorithm=structs.SCHED_ALGO_SPREAD),)),
        ("upsert_evals", ([ev],)),
        ("upsert_allocs", (allocs,)),
        ("update_node_status", (nodes[3].id, "down")),
        ("update_node_eligibility", (nodes[2].id, "ineligible")),
        ("delete_job", ("default", gone.id)),
    ]


def run_script(name, same_ids, committed):
    """The script (built first, from pinned ids) through `name`'s
    cluster: each command through the established leader's replicated
    store, then every server's FSM caught up.  Returns each server's
    snapshot document; `committed` gets the command bytes in commit
    order (the leader's FSM stream, minus the no-ops and the random
    identity secret)."""
    same_ids()
    commands = script(name)
    servers = cluster_trio(name)
    try:
        leader = wait_for(lambda: established(servers), msg="leader")
        wait_for(lambda: leader.state.identity_secret(), msg="secret")
        wire = pkg(name, "core.wire")
        seen = []
        leader.raft.fsm_observer = lambda e: seen.append(e.cmd)
        for method, args in commands:
            getattr(leader.state, method)(*args)
        top = leader.raft.commit_index
        wait_for(lambda: all(s.raft.last_applied >= top for s in servers),
                 msg="every FSM caught up")
        committed.extend(c for c in seen if c and wire.unpackb(c)[0]
                         != "set_identity_secret")
        docs = []
        for s in servers:
            doc = s._local_state.snapshot_save()
            doc.pop("IdentitySecret")
            docs.append(drop_fields(doc))
        return docs
    finally:
        shutdown_all(servers)


def test_scripted_commands_give_equal_stores(one_device, pinned,  # noqa: F811
                                              monkeypatch):
    """The same commands through a reference and a port three-server
    cluster: every server of both clusters ends with the same store (its
    WALL_FIELDS and the random identity secret dropped), and the two
    leaders committed the same command bytes."""
    out, cmds = {}, {}

    def same_ids():
        pinned(11)
        reset_mock_counters(monkeypatch)

    for name in PACKAGES:
        cmds[name] = []
        out[name] = run_script(name, same_ids, cmds[name])
    assert cmds[PORT] == cmds[REF]
    assert len(cmds[REF]) == len(script(REF))
    for doc in out[REF][1:] + out[PORT]:
        assert doc == out[REF][0]
    assert len(out[REF][0]["Nodes"]) == 4 and len(out[REF][0]["Jobs"]) == 1


def _store_with_state(name):
    """A store holding a zoned cluster, its volumes and one placed batch
    wave (allocs, evals, claims), from explicit ids."""
    from torch_parity import (add_jobs, build_zoned_cluster, make_evals,
                              run_batch_wave)
    h = build_zoned_cluster(name, n_nodes=40, n_zones=2)
    jobs, _ = add_jobs(name, h, n_items=3, count=8, zones=2)
    evals = make_evals(name, jobs)
    h.state.upsert_evals(evals)
    run_batch_wave(name, h, evals)
    structs = pkg(name, "structs")
    h.state.upsert_namespace(structs.Namespace(name="team-a"))
    h.state.set_identity_secret("secret")
    return h.state


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_snapshot_restores_across_packages(pinned, monkeypatch,  # noqa: F811
                                           direction):
    """A Raft snapshot of one package's store (`_fsm_snapshot`) restores
    through the other package's `_fsm_restore` into a store equal to the
    source table by table, and equal to the other package's own store
    built from the same inputs."""
    src, dst = (REF, PORT) if direction == "ref_to_port" else (PORT, REF)
    stores = {}
    for name in PACKAGES:
        pinned(2)
        reset_mock_counters(monkeypatch)
        stores[name] = _store_with_state(name)
    data = fsm_snapshot(src, stores[src])
    restored = fsm_restore(dst, data)
    want = stores[src].snapshot_save()
    got = restored.snapshot_save()
    assert sorted(got) == sorted(want)
    for table in want:
        if table != "Index":        # a restore is one more write
            assert got[table] == want[table], table
    assert len(want["Allocs"]) == 24 and len(want["Nodes"]) == 40
    # the same as the source package's own restore, index included
    assert got == fsm_restore(src, data).snapshot_save()
    # the destination package's own store, built the same way, agrees
    # on every table but the wall-clock stamps of the wave
    native = stores[dst].snapshot_save()
    for table in ("Nodes", "Jobs", "CSIVolumes", "Namespaces",
                  "SchedulerConfig", "IdentitySecret"):
        assert native[table] == want[table], table


REASONS = ("foreign-plan", "node-write", "restore", "capacity-freed",
           "stale-node-table", "client-drop", "close", "explicit")


def _invalidations(name):
    reg = pkg(name, "core.telemetry").REGISTRY
    return {r: reg.counter("nomad.executor.invalidations", reason=r)
            for r in REASONS}


def _wave(name, leader, via, jobs):
    """Register `jobs` through `via` (a follower: forwarded) with the
    leader's scheduling paused, release it, and wait for every eval."""
    leader.stop_scheduling()
    evals = [via.register_job(j) for j in jobs]
    leader.start_scheduling()
    wait_for(lambda: all(
        (e := leader.state.eval_by_id(ev.id)) is not None
        and e.status == "complete" for ev in evals), msg="wave settled")
    return evals


def run_two_waves(name, same_ids):
    """A small config 5 (zoned cluster, batch jobs on their zone's
    volume) through `name`'s three-server cluster: the nodes and volumes
    through the leader's replicated store, wave 1 through a follower,
    then the leader shut down and wave 2 through a survivor.  Returns
    the executors' invalidations by reason, the executors' counts and
    each wave's placements."""
    from torch_parity import add_zoned_cluster
    same_ids()
    mock = pkg(name, "mock")
    structs = pkg(name, "structs")
    jobs = []
    for i in range(12):
        job = mock.batch_job(id=f"wave-{i:03d}")
        job.datacenters = ["dc1", "dc2", "dc3"]
        tg = job.task_groups[0]
        tg.count = 64
        tg.tasks[0].resources.cpu = tg.tasks[0].resources.memory_mb = 10
        tg.volumes = {"data": structs.VolumeRequest(
            name="data", type="csi", source=f"vol-zone{i % 2}",
            read_only=True)}
        jobs.append(job)
    inv0 = _invalidations(name)
    servers = cluster_trio(name)
    try:
        for s in servers:
            s.eval_batch = 64
        leader = wait_for(lambda: established(servers), msg="leader")
        wait_for(lambda: leader.state.identity_secret(), msg="secret")
        add_zoned_cluster(name, leader.state, n_nodes=60, n_zones=2)
        follower = next(s for s in servers if s is not leader)
        wait_for(lambda: follower.leader_rpc_addr() is not None,
                 msg="follower knows the leader")
        _wave(name, leader, follower, jobs[:8])
        placed = [sum(len(live_allocs(leader, j)) for j in jobs[:8])]
        counts = [{k: leader.executor.stats[k] for k in
                   ("dispatches", "resident_waves", "invalidations")}]
        leader.shutdown()
        rest = [s for s in servers if s is not leader]
        new_leader = wait_for(lambda: established(rest), msg="new leader")
        via = next(s for s in rest if s is not new_leader)
        wait_for(lambda: via.leader_rpc_addr() == new_leader.rpc.addr,
                 msg="survivor knows the new leader")
        _wave(name, new_leader, via, jobs[8:])
        placed.append(sum(len(live_allocs(new_leader, j))
                          for j in jobs[8:]))
        counts.append({k: new_leader.executor.stats[k] for k in
                       ("dispatches", "resident_waves", "invalidations")})
        names = [(j.id, a.name) for j in jobs
                 for a in live_allocs(new_leader, j)]
        assert len(names) == len(set(names)) == 12 * 64
        for s in servers:
            assert s is leader or s is new_leader or \
                s.executor.stats["dispatches"] == 0
    finally:
        shutdown_all(servers)
    inv1 = _invalidations(name)
    return {r: inv1[r] - inv0[r] for r in REASONS}, counts, placed


def test_two_waves_invalidations_match_reference(one_device, pinned,  # noqa: F811
                                                 monkeypatch):
    """The same two waves (wave 1 through a follower, wave 2 after the
    leader's shutdown) through a reference and a port cluster: the
    executors drop their retained chains for the same reasons the same
    number of times, the leaders' executors dispatch and chain alike,
    every placement lands once, and the followers' executors dispatch
    nothing.  The leader's own plan commits reach its store through the
    Raft FSM and are not foreign plans: both packages count no
    invalidation of any reason over these waves."""
    out = {}

    def same_ids():
        pinned(13)
        reset_mock_counters(monkeypatch)

    for name in PACKAGES:
        out[name] = run_two_waves(name, same_ids)
    assert out[PORT] == out[REF]
    assert out[REF][2] == [8 * 64, 4 * 64]
    assert not any(out[REF][0].values())


# ------------------------------------------- chip_smoke.py's http_drain


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _DrainStubs:
    """A Server and an APIClient for chip_smoke.http_drain: GET
    /v1/evaluation/<id> answers `infos` in turn (an exception is
    raised), then the last one for ever; GET /v1/evaluations lists every
    eval with the last status."""

    def __init__(self, infos):
        from types import SimpleNamespace

        self.infos = list(infos)
        self.calls = 0
        self.running = None
        self.engine = SimpleNamespace(
            packer=SimpleNamespace(update=lambda snap: None))
        self.state = SimpleNamespace(snapshot=lambda: None)
        self.evaluations = self

    def start_scheduling(self):
        self.running = True

    def stop_scheduling(self):
        self.running = False

    def info(self, eval_id):
        out = self.infos[min(self.calls, len(self.infos) - 1)]
        self.calls += 1
        if isinstance(out, Exception):
            raise out
        return {"ID": eval_id, "Status": out}

    def list(self):
        return [{"ID": "ev-0", "Status": self.infos[-1]},
                {"ID": "ev-1", "Status": self.infos[-1]}]


def test_http_drain_waits_out_a_followers_404():
    """Read through a follower, an eval the leader created answers 404
    until it has replicated there: http_drain counts that as pending and
    returns once the eval settles; any other error still raises, and so
    does an eval unsettled at the deadline."""
    APIException = pkg(PORT, "api.client").APIException
    smoke = _chip_smoke()
    not_yet = APIException(404, "eval not found")
    stubs = _DrainStubs([not_yet, not_yet, "pending", "complete"])
    polls = []
    dt = smoke.http_drain(stubs, stubs, ["ev-0", "ev-1"], deadline_s=30.0,
                          poll_s=0.0, polls=polls)
    assert dt >= 0.0 and stubs.calls == 4 and polls == [5]
    assert stubs.running is False

    stubs = _DrainStubs([not_yet, APIException(500, "boom"), "complete"])
    with pytest.raises(APIException, match="500"):
        smoke.http_drain(stubs, stubs, ["ev-0"], deadline_s=30.0,
                         poll_s=0.0)
    assert stubs.running is False

    stubs = _DrainStubs([not_yet])
    with pytest.raises(AssertionError, match="unsettled"):
        smoke.http_drain(stubs, stubs, ["ev-0"], deadline_s=0.2,
                         poll_s=0.01)
    assert stubs.running is False
