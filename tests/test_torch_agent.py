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

The documented differences have tests of their own: cluster mode, a
read follower, `encrypt` and `plugin_dir` raise NotImplementedError
before anything starts; `device_executor="jax"` is refused; and
`Agent()` without `device` needs CUDA."""

import os
import threading
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


REFUSED = {
    "server_name": {"server_name": "s1"},
    "join": {"join": ["127.0.0.1:4648"]},
    "bootstrap_expect": {"bootstrap_expect": 3},
    "follow": {"follow": "http://127.0.0.1:4646"},
    "encrypt": {"encrypt": "a" * 32},
    "plugin_dir": {"plugin_dir": "examples/plugins", "num_clients": 1},
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_unported_options_raise_before_start(case, tmp_path):
    """The documented difference: each option of the cluster plane (and
    the plugins) raises NotImplementedError naming its ROADMAP item,
    before a thread, a socket or a data dir exists."""
    before = threading.active_count()
    with pytest.raises(NotImplementedError,
                       match="ROADMAP queue 1 item (4|3b)"):
        pkg(PORT, "agent").Agent(data_dir=str(tmp_path / "d"), device="cpu",
                                 **REFUSED[case])
    assert threading.active_count() == before
    assert not (tmp_path / "d").exists()


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
        assert agent.transport is None and agent.follower is None
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
