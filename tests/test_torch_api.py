"""The port's HTTP API (nomad_tpu_torch/api/{http_server,client,ui}.py)
against the reference's: a fixed script of HTTP requests, sent through
each package's own APIClient to each package's Agent on the CPU, must
get equal responses.

Both agents run one server with no in-process clients (nodes join over
`PUT /v1/nodes`), the sampler off and no heartbeat expiry; the
reference's engine on one device (`one_device`).  Every id is pinned
(`pinned`: a seeded os.urandom, both id pools emptied) and the agent
settles after each write, so the two runs mint the same ids and reach
the same indexes.

Fields dropped from the comparison, each because it is wall time:
`CreateTime` and `ModifyTime` (evals, allocs, ACL tokens) and an alloc
metric's `AllocationTimeNS` (the scheduler's wall time for the
placement).

The cluster plane's routes have tests of their own: the journal export,
the compact federation scrape and the cluster trace answer as the
reference's (they answered 501 before the port had core/wire.py and
core/federation.py), the catch-all's NotLeaderError answer matches, and
a read follower tails a port or a reference upstream."""

import json
import urllib.error
import urllib.request

import pytest

from torch_parity import (PACKAGES, make_agent, make_node, one_device,
                          pinned, pkg, settle)  # noqa: F401

REF, PORT = PACKAGES
WALL_FIELDS = {"CreateTime", "ModifyTime", "AllocationTimeNS"}


def drop_fields(obj, names):
    """`obj` with every dict key in `names` removed, at any depth."""
    if isinstance(obj, dict):
        return {k: drop_fields(v, names) for k, v in obj.items()
                if k not in names}
    if isinstance(obj, list):
        return [drop_fields(v, names) for v in obj]
    return obj


def wire_job(name, jid, count=3, cpu=100):
    j = pkg(name, "mock").batch_job(id=jid)
    tg = j.task_groups[0]
    tg.count = count
    tg.tasks[0].resources.cpu = cpu
    tg.tasks[0].config = {"run_for_s": 300}
    return pkg(name, "structs.codec").encode(j)


def wire_node(name, i, dc="dc1"):
    n = make_node(name, i, dc=dc)
    n.csi_node_plugins = {"ebs0": True}
    return pkg(name, "structs.codec").encode(n)


# (label, method, path, params, body(name) or None, settle after)
SCRIPT = [
    *[(f"node_register_{i}", "PUT", "/v1/nodes", {},
       lambda name, i=i: {"Node": wire_node(name, i, f"dc{1 + i % 2}")},
       True) for i in range(4)],
    ("nodes", "GET", "/v1/nodes", {}, None, False),
    ("node", "GET", "/v1/node/node-00001", {}, None, False),
    ("job_register", "PUT", "/v1/jobs", {},
     lambda name: {"Job": wire_job(name, "batch-a")}, True),
    ("job_register_second", "PUT", "/v1/jobs", {},
     lambda name: {"Job": wire_job(name, "batch-b", count=2, cpu=300)},
     True),
    ("jobs", "GET", "/v1/jobs", {}, None, False),
    ("job", "GET", "/v1/job/batch-a", {}, None, False),
    ("job_summary", "GET", "/v1/job/batch-a/summary", {}, None, False),
    ("job_allocations", "GET", "/v1/job/batch-a/allocations", {}, None,
     False),
    ("job_evaluations", "GET", "/v1/job/batch-a/evaluations", {}, None,
     False),
    ("job_plan", "POST", "/v1/job/batch-a/plan", {},
     lambda name: {"Job": wire_job(name, "batch-a", count=5), "Diff": True},
     False),
    ("job_plan_new", "POST", "/v1/job/batch-c/plan", {},
     lambda name: {"Job": wire_job(name, "batch-c", count=2)}, False),
    ("evaluations", "GET", "/v1/evaluations", {}, None, False),
    ("allocations", "GET", "/v1/allocations", {}, None, False),
    ("allocations_columnar", "GET", "/v1/allocations",
     {"columnar": "true"}, None, False),
    ("job_scale", "POST", "/v1/job/batch-a/scale", {},
     lambda name: {"Count": 5, "Target": {"Group": "worker"}}, True),
    ("job_scale_bad_group", "POST", "/v1/job/batch-a/scale", {},
     lambda name: {"Count": 5, "Target": {"Group": "nosuch"}}, False),
    ("job_allocations_scaled", "GET", "/v1/job/batch-a/allocations", {},
     None, False),
    ("job_versions", "GET", "/v1/job/batch-a/versions", {}, None, False),
    ("volume_register", "PUT", "/v1/volume/csi/vol-a", {},
     lambda name: {"Volume": {"ID": "vol-a", "PluginID": "ebs0",
                              "AccessMode": "multi-node-multi-writer",
                              "TopologyNodeIDs": ["node-00000",
                                                  "node-00002"]}}, True),
    ("volume_mismatch", "PUT", "/v1/volume/csi/vol-b", {},
     lambda name: {"Volume": {"ID": "vol-x", "PluginID": "ebs0"}}, False),
    ("volumes", "GET", "/v1/volumes", {"type": "csi"}, None, False),
    ("volume", "GET", "/v1/volume/csi/vol-a", {}, None, False),
    ("blocking_jobs", "GET", "/v1/jobs", {"index": 10_000, "wait": "0.3"},
     None, False),
    ("blocking_nodes", "GET", "/v1/nodes", {"index": 1, "wait": "5"},
     None, False),
    ("node_allocations", "GET", "/v1/node/node-00000/allocations", {},
     None, False),
    ("job_missing", "GET", "/v1/job/nosuch", {}, None, False),
    ("job_deregister", "DELETE", "/v1/job/batch-b", {}, None, True),
    ("job_after_deregister", "GET", "/v1/job/batch-b", {}, None, False),
    ("status_leader", "GET", "/v1/status/leader", {}, None, False),
    ("status_peers", "GET", "/v1/status/peers", {}, None, False),
    ("regions", "GET", "/v1/regions", {}, None, False),
    ("scheduler_config", "GET", "/v1/operator/scheduler/configuration", {},
     None, False),
    ("search", "POST", "/v1/search", {},
     lambda name: {"Prefix": "batch", "Context": "jobs"}, False),
    ("acl_bootstrap", "POST", "/v1/acl/bootstrap", {}, None, True),
    ("acl_bootstrap_again", "POST", "/v1/acl/bootstrap", {}, None, False),
    ("acl_tokens", "GET", "/v1/acl/tokens", {}, None, False),
    ("no_such_route", "GET", "/v1/nosuch", {}, None, False),
]


def run_script(name, agent):
    api = pkg(name, "api.client")
    c = api.APIClient(address=agent.address)
    out = []
    for label, method, path, params, body, then_settle in SCRIPT:
        try:
            resp = 200, c.request(method, path, params=params,
                                  body=body(name) if body else None)
        except api.APIException as e:
            resp = e.status, str(e)
        if then_settle:
            settle(agent)
        out.append((label, resp[0], drop_fields(resp[1], WALL_FIELDS)))
    return out


def test_http_script_gets_equal_responses(pinned, one_device, tmp_path):
    runs = []
    for name in PACKAGES:
        pinned(21)
        agent = make_agent(name, tmp_path / name).start()
        try:
            settle(agent)
            runs.append(run_script(name, agent))
        finally:
            agent.shutdown()
    ref, port = runs
    assert [r[0] for r in port] == [r[0] for r in ref]
    for want, got in zip(ref, port):
        assert got == want, want[0]
    by = {r[0]: r for r in ref}
    assert by["job_missing"][1] == 404
    assert len(by["job_allocations_scaled"][2]) == 5
    assert by["acl_bootstrap_again"][1] == 400
    assert by["blocking_jobs"][1] == by["blocking_nodes"][1] == 200


def _raw_get(address, path):
    try:
        with urllib.request.urlopen(address + path, timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _unpack(name, raw):
    """A msgpack body, decoded by `name`'s wire codec."""
    return pkg(name, "core.wire").unpackb(raw)


def _compact_shape(doc):
    """The compact scrape's document with its host-dependent values
    (registry readings, memory sizes, timeline samples) replaced by
    their types: what must agree is the schema, not this host."""
    if isinstance(doc, dict):
        return {k: _compact_shape(v) for k, v in doc.items()}
    if isinstance(doc, list):
        return [_compact_shape(v) for v in doc[:1]]
    return type(doc).__name__


@pytest.mark.parametrize("path", [
    "/v1/operator/export?since=0",
    "/v1/agent/self?compact=true",
    "/v1/trace/abc?cluster=true",
])
def test_cluster_plane_endpoints_answer_501(pinned, one_device, tmp_path,
                                            path):
    """The three endpoints of the cluster plane, which answered 501 while
    the port lacked core/wire.py and core/federation.py, now answer as
    the reference's: the journal export (msgpack, decoded by either
    package's codec), the compact scrape (its schema), and the cluster
    trace of an unknown id on a single server (404)."""
    out = []
    for name in PACKAGES:
        pinned(4)
        agent = make_agent(name, tmp_path / name).start()
        try:
            settle(agent)
            c = pkg(name, "api.client").APIClient(address=agent.address)
            c.put("/v1/nodes", {"Node": wire_node(name, 0)})
            settle(agent)
            status, body = _raw_get(agent.address, path)
        finally:
            agent.shutdown()
        out.append((name, status, body))
    (_, ref_status, ref_body), (_, status, body) = out
    assert status == ref_status
    if path.startswith("/v1/trace"):
        assert (status, body) == (404, ref_body)
        return
    assert status == 200
    for decoder in PACKAGES:
        got, want = _unpack(decoder, body), _unpack(decoder, ref_body)
        if path.startswith("/v1/operator/export"):
            assert drop_fields(got, WALL_FIELDS) == \
                drop_fields(want, WALL_FIELDS)
        else:
            assert _compact_shape(got) == _compact_shape(want)
            assert got["Schema"] == want["Schema"]


def test_not_leader_answer_matches_reference(one_device, tmp_path):
    """A write to a cluster-mode agent that has no leader (it waits for
    two more servers) gets the catch-all's NotLeaderError answer: 500,
    "rpc error: no cluster leader", and an empty leader address."""
    out = []
    for name in PACKAGES:
        agent = make_agent(name, tmp_path / name, server_name=f"{name}-1",
                           bootstrap_expect=3).start()
        try:
            req = urllib.request.Request(
                agent.address + "/v1/jobs", method="PUT",
                data=json.dumps({"Job": wire_job(name, "lonely")}).encode())
            try:
                with urllib.request.urlopen(req, timeout=30) as r:
                    out.append((r.status, json.loads(r.read())))
            except urllib.error.HTTPError as e:
                out.append((e.code, json.loads(e.read())))
        finally:
            agent.shutdown()
    assert out[1] == out[0] == (500, {"Error": "rpc error: no cluster leader",
                                      "LeaderRPCAddr": ""})


def _follow(upstream, follower_pkg, tmp_path):
    """A read follower of `follower_pkg` tailing an upstream agent: the
    follower's store after a node and a job were written through the
    follower's own API (proxied to the upstream)."""
    import time

    fol = make_agent(follower_pkg, tmp_path / "follower",
                     follow=upstream.address).start()
    try:
        assert fol.clients == [] and fol.follower is not None
        c = pkg(follower_pkg, "api.client").APIClient(address=fol.address)
        c.put("/v1/nodes", {"Node": wire_node(follower_pkg, 0)})
        settle(upstream)
        c.put("/v1/jobs", {"Job": wire_job(follower_pkg, "followed")})
        settle(upstream)
        want = upstream.server.state.latest_index()
        deadline = time.monotonic() + 60
        while (fol.server.state.latest_index() < want
               and time.monotonic() < deadline):
            time.sleep(0.05)
        codec = pkg(follower_pkg, "structs.codec")
        snap = fol.server.state.snapshot()
        jobs = [codec.encode(j) for j in snap.jobs()]
        nodes = [codec.encode(n) for n in snap.nodes()]
        stats = (fol.follower.pulls > 0, fol.follower.failures,
                 fol.server.state.latest_index() == want)
        return jobs, nodes, stats, c.request("GET", "/v1/jobs")
    finally:
        fol.shutdown()


@pytest.mark.parametrize("upstream_pkg", PACKAGES)
def test_read_follower_tails_upstream(pinned, one_device, tmp_path,
                                      upstream_pkg):
    """A port read follower (`Agent(follow=...)`) of a reference or a
    port upstream: writes through its API reach the upstream, its store
    catches up to the upstream's index through the journal export, and
    it serves what the upstream holds, as a reference follower of the
    same upstream does."""
    out = {}
    for follower_pkg in PACKAGES:
        pinned(6)
        up = make_agent(upstream_pkg, tmp_path / follower_pkg / "up").start()
        try:
            settle(up)
            jobs, nodes, stats, listed = _follow(up, follower_pkg,
                                                 tmp_path / follower_pkg)
            codec = pkg(upstream_pkg, "structs.codec")
            snap = up.server.state.snapshot()
            assert nodes == [codec.encode(n) for n in snap.nodes()]
            assert jobs == [codec.encode(j) for j in snap.jobs()]
        finally:
            up.shutdown()
        assert stats == (True, 0, True)
        out[follower_pkg] = drop_fields((jobs, nodes, listed),
                                        WALL_FIELDS | {"SubmitTime"})
    assert out[PORT] == out[REF]
    assert [j["ID"] for j in out[PORT][0]] == ["followed"]


def test_agent_self_and_ui_alike(pinned, one_device, tmp_path):
    """`GET /v1/agent/self` (its stats' wall and thread counts dropped)
    and the UI page, which differs from the reference's in one
    JavaScript comment only: the port's ends at "run two pump loops",
    dropping the reference's note on its own history (the module
    docstring says so)."""
    out = []
    for name in PACKAGES:
        pinned(3)
        agent = make_agent(name, tmp_path / name).start()
        try:
            settle(agent)
            _, doc = _raw_get(agent.address, "/v1/agent/self")
            doc = json.loads(doc)
            doc["stats"].pop("uptime_s")
            doc["stats"].pop("threads")
            _, ui = _raw_get(agent.address, "/ui")
        finally:
            agent.shutdown()
        out.append((doc, ui))
    ref_doc, ref_ui = out[0]
    cut = b"// run two pump loops"
    i = ref_ui.index(cut) + len(cut)
    j = ref_ui.index(b"\n", i)
    assert out[1] == (ref_doc, ref_ui[:i] + ref_ui[j:])
    assert b"<title>" in ref_ui


def test_prometheus_metrics_render(tmp_path):
    """The port's agent renders its own registry as text exposition."""
    agent = make_agent(PORT, tmp_path).start()
    try:
        text = pkg(PORT, "api.client").APIClient(
            address=agent.address).agent.metrics(format="prometheus")
        flat = agent.metrics()
    finally:
        agent.shutdown()
    assert "nomad_broker" in text or "nomad.broker" in text
    assert flat["nomad.state.nodes"] == 0
