"""The port's single-process Agent (nomad_tpu_torch/agent.py: server, two
in-process clients on the mock driver, the HTTP API) against the
reference's, on the CPU: examples/web.hcl run through each agent's HTTP
API on two clients reaches the same placements and statuses, and the
agents' stats and metrics agree.

Ids are pinned (`pinned`), the clients' nodes carry explicit ids
(`agent_nodes`), the reference's engine runs on one device
(`one_device`), and heartbeats never expire.  The comparison is taken
once all three allocs report `running`: alloc ids, names, nodes, desired
and client statuses, and the deployment's id.

The documented differences have tests of their own:
`device_executor="jax"` is refused, and `Agent()` without `device` needs
CUDA.  An agent starts with `plugin_dir` (the external plugins) and with
`worker_mode="process"` (the worker pool).  Cluster mode (`server_name`, `join`,
`bootstrap_expect`), a read follower (`follow`) and `encrypt` work as
the reference's: three port agents form a cluster whose `server members`
lists all three, an encrypted pair schedules through its follower, and
the process-global key refuses a second secret or a plaintext agent as
the reference's does."""

import os
import time

import pytest
import torch

from torch_parity import (PACKAGES, agent_nodes, make_agent, make_node,
                          one_device, pinned, pkg, settle)  # noqa: F401

PORT = "nomad_tpu_torch"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_web(name, agent, timeout=60.0):
    """web.hcl through the agent's HTTP API; waits for its three allocs
    to run.  Returns the allocs and the job's deployment id."""
    encode = pkg(name, "structs.codec").encode
    wire = encode(pkg(name, "jobspec").parse_file("examples/web.hcl"))
    api = pkg(name, "api.client").APIClient(address=agent.address)
    api.jobs.register(wire)
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        allocs = api.jobs.allocations("web")
        if (len(allocs) == 3
                and all(a["ClientStatus"] == "running" for a in allocs)):
            break
        time.sleep(0.05)
    else:
        raise AssertionError(f"web did not run: {allocs}")
    dep = api.jobs.latest_deployment("web")
    return (sorted((a["ID"], a["Name"], a["NodeID"], a["DesiredStatus"],
                    a["ClientStatus"]) for a in allocs),
            dep["ID"] if dep else None)


def test_web_on_two_clients_alike(pinned, one_device, tmp_path,
                                  monkeypatch):
    monkeypatch.chdir(ROOT)
    out = []
    for name in PACKAGES:
        pinned(9)
        agent = make_agent(name, tmp_path / name, num_clients=2,
                           nodes=agent_nodes(name, 2)).start()
        try:
            out.append(run_web(name, agent))
        finally:
            agent.shutdown()
    assert out[1] == out[0]
    assert {a[2] for a in out[0][0]} <= {"client-0000", "client-0001"}
    assert out[0][1] is not None


def test_stats_and_metrics_alike(pinned, one_device, tmp_path):
    """After one batch job on two registered nodes (no in-process
    client, whose status writes would land at times of their own): the
    agents' stats (uptime and thread count dropped: wall time and the
    runtime's own threads) and the metrics the reference names in
    `Agent.metrics`."""
    keys = ("nomad.broker.total_ready", "nomad.broker.acked",
            "nomad.broker.nacked", "nomad.broker.failed",
            "nomad.blocked_evals.total_blocked", "nomad.plan.queue_depth",
            "nomad.worker.invoked", "nomad.state.nodes", "nomad.state.jobs")
    out = []
    for name in PACKAGES:
        pinned(4)
        # the wave pipeline's series are process-global: start each
        # package's run without those of tests run before it here
        pkg(name, "core.telemetry").REGISTRY.clear_series(
            "nomad.wavepipe.")
        agent = make_agent(name, tmp_path / name).start()
        try:
            for i in range(2):
                agent.server.register_node(make_node(name, i))
            job = pkg(name, "mock").batch_job(id="b")
            job.task_groups[0].count = 2
            job.task_groups[0].tasks[0].config = {"run_for_s": 60}
            agent.server.register_job(job)
            settle(agent)
            stats = agent.stats()
            stats.pop("uptime_s")
            stats.pop("threads")
            metrics = agent.metrics()
        finally:
            agent.shutdown()
        out.append((stats, {k: metrics[k] for k in keys},
                    sorted(k for k in metrics
                           if k.startswith("nomad.wavepipe."))))
    assert out[1] == out[0]
    assert out[0][1]["nomad.state.jobs"] == 1


STARTS_WITH = ("plugin_dir", "worker_mode")


@pytest.mark.parametrize("case", STARTS_WITH)
def test_agent_starts_with_plugins_and_process_workers(case, tmp_path):
    """The reference's options the port now has: a `plugin_dir` (the
    example plugins copied into a short directory, so that the default
    socket directory fits the Unix limit) dispenses the external driver
    and device to the client's node; `worker_mode="process"` runs
    web.hcl through the pool's children.  Shutdown leaves no plugin or
    pool process behind."""
    import shutil
    import tempfile
    kw = {"num_clients": 1}
    plugdir = None
    if case == "plugin_dir":
        plugdir = tempfile.mkdtemp(prefix="plg", dir="/tmp")
        for f in ("hello_driver.py", "fake_gpu_device.py"):
            shutil.copy(os.path.join(ROOT, "examples", "plugins_torch", f),
                        plugdir)
        kw["plugin_dir"] = plugdir
    else:
        kw.update(worker_mode="process", num_clients=2)
    agent = make_agent(PORT, tmp_path / "d", **kw)
    agent.start()
    try:
        if case == "plugin_dir":
            procs = [c.proc for c in
                     agent.clients[0].plugin_manager._clients.values()]
            (node,) = agent.server.state.snapshot().nodes()
            assert node.attributes.get("driver.hello") == "1"
            assert [d.id() for d in node.resources.devices] == \
                ["acme/gpu/fake100"]
        else:
            procs = [c.proc for c in agent.server.worker_pool._children]
            allocs, _ = run_web(PORT, agent)
            assert len(allocs) == 3
            stats = agent.server.worker_pool.pool_stats()
            assert stats["alive"] == 1 and stats["places"] >= 1
    finally:
        agent.shutdown()
        if plugdir:
            shutil.rmtree(plugdir, ignore_errors=True)
    if case == "plugin_dir":
        assert len(procs) == 2 and all(p.poll() is not None for p in procs)
    else:
        assert len(procs) == 1 and not procs[0].is_alive()


def test_refused_options_alike_where_the_reference_refuses(tmp_path):
    """Client-only agents and bad log levels are refused by both."""
    out = []
    for name in PACKAGES:
        row = []
        for kw in ({"server_enabled": False}, {"log_level": "loud"}):
            kw = dict(kw, data_dir=str(tmp_path / name))
            if name == PORT:
                kw["device"] = "cpu"
            try:
                pkg(name, "agent").Agent(**kw)
                row.append(None)
            except Exception as e:  # noqa: BLE001 - the error is the result
                row.append((type(e).__name__, str(e)))
        out.append(row)
    assert out[1] == out[0]
    assert all(r is not None for r in out[0])


@pytest.mark.parametrize("executor,error", [
    ("jax", ValueError), ("bridge", "ExecutorUnavailable"),
    ("nosuch", ValueError)])
def test_device_executor_rule(tmp_path, executor, error):
    if isinstance(error, str):
        error = getattr(pkg(PORT, "ops.executor"), error)
    with pytest.raises(error):
        pkg(PORT, "agent").Agent(data_dir=str(tmp_path), device="cpu",
                                 device_executor=executor, num_clients=0)


def test_default_executor_is_torch(tmp_path):
    agent = make_agent(PORT, tmp_path).start()
    try:
        assert type(agent.server.executor).__name__ == "TorchExecutor"
        assert agent.transport.kind == "tcp" and agent.follower is None
    finally:
        agent.shutdown()


def test_agent_defaults_to_cuda(tmp_path):
    """`Agent()` follows the Server's device rule: CUDA unless given,
    raising without it."""
    if torch.cuda.is_available():
        agent = pkg(PORT, "agent").Agent(data_dir=str(tmp_path),
                                         num_clients=0, profile_hz=0)
        assert agent.server.engine.device.type == "cuda"
        agent.start().shutdown()
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        pkg(PORT, "agent").Agent(data_dir=str(tmp_path), num_clients=0,
                                 profile_hz=0)


def _leader_of(agents, timeout=60.0):
    """The agent every agent names in GET /v1/status/leader, once all
    agree and it has established its leadership."""
    import json
    import urllib.request
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        seen = set()
        for a in agents:
            with urllib.request.urlopen(a.address + "/v1/status/leader",
                                        timeout=10) as r:
                seen.add(json.loads(r.read()))
        if len(seen) == 1 and "" not in seen:
            addr = seen.pop()
            for a in agents:
                host, port = a.server.rpc.addr
                if (f"{host}:{port}" == addr
                        and getattr(a.server, "_leader", False)):
                    return a
        time.sleep(0.05)
    raise AssertionError("no leader")


def _free_ports(n):
    import socket
    socks = [socket.socket() for _ in range(n)]
    try:
        for sock in socks:
            sock.bind(("127.0.0.1", 0))
        return [sock.getsockname()[1] for sock in socks]
    finally:
        for sock in socks:
            sock.close()


def test_cluster_mode_three_agents(tmp_path, capsys):
    """Three port agents in cluster mode (`server_name`,
    `bootstrap_expect=3`, each joining the others' gossip ports) elect
    one leader; `server members` through any of them lists all three
    alive; a job registered through a follower's HTTP API runs."""
    from nomad_tpu_torch import cli
    serf = _free_ports(3)
    agents = []
    try:
        for i in range(3):
            agents.append(make_agent(
                PORT, tmp_path / f"s{i}", server_name=f"port-s{i}",
                bootstrap_expect=3, serf_port=serf[i],
                join=[f"127.0.0.1:{p}" for j, p in enumerate(serf)
                      if j != i]))
        for a in agents:
            a.start()
        leader = _leader_of(agents)
        follower = next(a for a in agents if a is not leader)
        assert type(follower.server).__name__ == "ClusterServer"
        assert follower.server.federation is not None
        assert follower.server.gossip.meta["http"] == follower.address
        capsys.readouterr()
        assert cli.main(["-address", follower.address, "server",
                         "members"]) == 0
        out = capsys.readouterr().out
        assert all(f"port-s{i}" in out for i in range(3))
        assert out.count("alive") == 3
        api = pkg(PORT, "api.client").APIClient(address=follower.address)
        api.put("/v1/nodes", {"Node": pkg(PORT, "structs.codec").encode(
            make_node(PORT, 0))})
        job = pkg(PORT, "mock").batch_job(id="clustered")
        job.task_groups[0].count = 2
        resp = api.jobs.register(pkg(PORT, "structs.codec").encode(job))
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if len(leader.server.state.allocs_by_job("default",
                                                     "clustered")) == 2:
                break
            time.sleep(0.05)
        assert len(leader.server.state.allocs_by_job("default",
                                                     "clustered")) == 2
        assert resp["EvalID"]
    finally:
        for a in agents:
            a.shutdown()


def test_encrypted_pair_schedules_through_follower(tmp_path):
    """Two port agents sharing an `encrypt` secret form a cluster over
    the authenticated wire and schedule a job written to the follower;
    afterwards the key is removed."""
    wire = pkg(PORT, "core.wire")
    serf = _free_ports(2)
    agents = []
    try:
        for i in range(2):
            agents.append(make_agent(
                PORT, tmp_path / f"e{i}", server_name=f"enc-{i}",
                bootstrap_expect=2, serf_port=serf[i], encrypt="e2e-secret",
                join=[f"127.0.0.1:{serf[1 - i]}"]))
        assert wire.has_key()
        for a in agents:
            a.start()
        leader = _leader_of(agents)
        follower = next(a for a in agents if a is not leader)
        follower.server.register_node(make_node(PORT, 0))
        job = pkg(PORT, "mock").batch_job(id="sealed")
        job.task_groups[0].count = 2
        follower.server.register_job(job)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if len(follower.server.state.allocs_by_job("default",
                                                       "sealed")) == 2:
                break
            time.sleep(0.05)
        assert len(follower.server.state.allocs_by_job("default",
                                                       "sealed")) == 2
    finally:
        for a in agents:
            a.shutdown()
        wire.set_key(None)


def test_encrypt_key_rules_match_reference(tmp_path):
    """With one agent's secret installed, a second secret and a plaintext
    agent are refused with the reference's errors, before anything
    starts; an empty secret resets the process to plaintext."""
    out = []
    for name in PACKAGES:
        wire = pkg(name, "core.wire")
        first = make_agent(name, tmp_path / name / "a",
                           encrypt="one").start()
        try:
            row = []
            for kw in ({"encrypt": "two"}, {}):
                try:
                    make_agent(name, tmp_path / name / "b", **kw)
                    row.append(None)
                except ValueError as e:
                    row.append(str(e))
            row.append(wire.has_key())
        finally:
            first.shutdown()
            wire.set_key(None)
        row.append(wire.has_key())
        out.append(row)
    assert out[1] == out[0]
    assert out[0][0] and out[0][1] and out[0][2:] == [True, False]
