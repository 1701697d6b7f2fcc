"""The port's client (nomad_tpu_torch/client/ with drivers/) and its
integrations seam against the reference's, on the CPU: the same inputs
through both packages' drivers, restart tracker, task environment,
client state db, fingerprints, task and alloc runners on the mock
driver, and an in-process Client over each package's Server.

Ids: allocs, jobs and nodes are built with explicit ids.  The end-to-end
case pins every minted id with a seeded `os.urandom` (both id pools
emptied) and seeds `random`, as tests/test_torch_server.py does, and
compares after `Client.wait_until_idle` and a final `sync_once`.

Fields left out of a comparison, each because it is wall time: a task
handle's `started_at`, a task event's `time`, a task state's
`started_at` and `finished_at`."""

import os
import random
import time

import pytest

from torch_parity import PACKAGES, make_node, pkg

PORT = "nomad_tpu_torch"


@pytest.fixture
def pinned(monkeypatch):
    stream = {}
    monkeypatch.setattr(os, "urandom",
                        lambda n: stream["rng"].randbytes(n))

    def reset(seed: int = 0) -> None:
        stream["rng"] = random.Random(seed)
        for name in PACKAGES:
            pkg(name, "structs.structs")._ID_POOL.clear()
        random.seed(seed)

    return reset


def make_job(name, jid="job-1", kind="batch_job", count=1, config=None,
             **tg_kw):
    j = getattr(pkg(name, "mock"), kind)(id=jid)
    tg = j.task_groups[0]
    tg.count = count
    for k, v in tg_kw.items():
        setattr(tg, k, v)
    tg.tasks[0].driver = "mock"
    tg.tasks[0].config = dict(config or {})
    return j


def make_alloc(name, job, node, aid="alloc-1"):
    a = pkg(name, "mock").alloc(job=job, node_id=node.id, id=aid,
                                eval_id="eval-1")
    a.job = job
    return a


def task_view(tr):
    """A task runner's end state, wall times dropped."""
    st = tr.state
    return (st.state, st.failed, st.restarts,
            [(e.type, e.message, e.exit_code) for e in st.events])


# ------------------------------------------------------------- drivers

def test_driver_registries_alike():
    regs = [pkg(n, "client.drivers").new_driver_registry() for n in PACKAGES]
    views = [{k: (type(d).__name__, getattr(d, "available", bool)(),
                  d.fingerprint(),
                  vars(d.capabilities()))
              for k, d in reg.items()} for reg in regs]
    assert sorted(views[0]) == sorted(pkg("nomad_tpu", "client.drivers")
                                      .BUILTIN_DRIVERS)
    assert views[1] == views[0]


MOCK_CONFIGS = {
    "success": {"run_for_s": 0.02},
    "exit_code": {"run_for_s": 0.02, "exit_code": 3},
    "kill_after": {"run_for_s": 5, "kill_after_s": 0.02, "signal": 15},
    "start_error": {"start_error": "no such image"},
}


@pytest.mark.parametrize("case", sorted(MOCK_CONFIGS))
def test_mock_driver_alike(case):
    out = []
    for name in PACKAGES:
        drivers = pkg(name, "client.drivers")
        structs = pkg(name, "structs")
        d = drivers.MockDriver()
        task = structs.Task(name="t", driver="mock",
                            config=dict(MOCK_CONFIGS[case]))
        try:
            h = d.start_task("t1", task, {}, "")
        except pkg(name, "client.drivers.base").DriverError as e:
            out.append(("DriverError", str(e)))
            continue
        res = d.wait_task(h, timeout=5)
        out.append((h.task_id, h.driver, h.driver_state, vars(res),
                    res.successful(), d.inspect_task(h),
                    d.exec_task(h, ["ls", "-l"])))
    assert out[1] == out[0]


def test_mock_driver_stop_alike():
    out = []
    for name in PACKAGES:
        d = pkg(name, "client.drivers").MockDriver()
        task = pkg(name, "structs").Task(name="t", driver="mock",
                                         config={"run_for_s": 30})
        h = d.start_task("t2", task, {}, "")
        d.stop_task(h)
        out.append(vars(d.wait_task(h, timeout=2)))
    assert out[1] == out[0] and out[0]["exit_code"] == 137


RAW_EXEC_CASES = {
    "echo": ("sh", ["-c", "echo hi; echo err >&2; exit 0"]),
    "nonzero": ("sh", ["-c", "exit 7"]),
    "env": ("sh", ["-c", "echo $NOMAD_TASK_NAME"]),
}


@pytest.mark.parametrize("driver", ["raw_exec", "exec"])
@pytest.mark.parametrize("case", sorted(RAW_EXEC_CASES))
def test_process_drivers_alike(tmp_path, driver, case):
    cmd, args = RAW_EXEC_CASES[case]
    out = []
    for name in PACKAGES:
        d = pkg(name, "client.drivers").new_driver_registry()[driver]
        task = pkg(name, "structs").Task(
            name="t", driver=driver, config={"command": cmd, "args": args})
        task_dir = tmp_path / name
        task_dir.mkdir()
        h = d.start_task("t1", task, {"NOMAD_TASK_NAME": "t"},
                         str(task_dir))
        res = d.wait_task(h, timeout=10)
        files = {p.name: p.read_bytes() for p in sorted(task_dir.iterdir())}
        out.append((vars(res), res.successful(), files))
        d.destroy_task(h)
    assert out[1] == out[0]


def test_unavailable_driver_start_raises_alike(tmp_path):
    """docker, java and qemu on this host: equal availability, and equal
    errors where the binary is absent."""
    out = []
    for name in PACKAGES:
        reg = pkg(name, "client.drivers").new_driver_registry()
        row = {}
        for drv in ("docker", "java", "qemu"):
            d = reg[drv]
            task = pkg(name, "structs").Task(
                name="t", driver=drv, config={"image": "x", "class": "X",
                                              "image_path": "/nonexistent"})
            try:
                if d.available():
                    row[drv] = "available"
                    continue
                d.start_task("t1", task, {}, str(tmp_path))
                row[drv] = "started"
            except Exception as e:  # noqa: BLE001 - the error is the result
                row[drv] = (type(e).__name__, str(e))
        out.append(row)
    assert out[1] == out[0]


# ------------------------------------------------------------ restarts

RESTART_CASES = {
    "batch_success": (dict(attempts=3), True, [(0, False, 100.0)]),
    "fail_mode": (dict(attempts=2, interval_s=300, delay_s=0.01,
                       mode="fail"), False,
                  [(1, True, 10.0), (1, True, 11.0), (1, True, 12.0)]),
    "interval_reset": (dict(attempts=1, interval_s=10, delay_s=0.01,
                            mode="fail"), False,
                       [(1, True, 0.0), (1, True, 20.0), (1, True, 21.0)]),
    "delay_mode": (dict(attempts=1, interval_s=60, delay_s=2.0,
                        mode="delay"), False,
                   [(1, True, 0.0), (1, True, 5.0), (1, True, 70.0)]),
    "service_success": (dict(attempts=2, delay_s=1.0), False,
                        [(0, False, 1.0), (0, False, 2.0)]),
}


@pytest.mark.parametrize("case", sorted(RESTART_CASES))
def test_restart_tracker_alike(case):
    policy, is_batch, steps = RESTART_CASES[case]
    out = []
    for name in PACKAGES:
        random.seed(7)
        rt = pkg(name, "client.restarts").RestartTracker(
            pkg(name, "structs").RestartPolicy(**policy), is_batch=is_batch)
        out.append([rt.next(code, failed, now=now)
                    for code, failed, now in steps])
    assert out[1] == out[0]


# ------------------------------------------------------------ task env

def test_task_env_alike():
    out = []
    for name in PACKAGES:
        taskenv = pkg(name, "client.taskenv")
        job = make_job(name, kind="job")
        node = make_node(name, 0, rack="r1")
        node.meta = {"team": "a"}
        alloc = make_alloc(name, job, node)
        alloc.allocated_ports = {"http": 25000}
        task = job.task_groups[0].tasks[0]
        task.env = {"DC": "${node.datacenter}", "K": "${attr.kernel.name}",
                    "R": "${attr.rack}", "T": "${meta.team}",
                    "P": "${NOMAD_PORT_http}", "X": "${env.NOMAD_DC}",
                    "U": "${nosuch}"}
        env = taskenv.build_task_env(alloc, task, node, "/tmp/t", "/tmp/s")
        out.append((env, [taskenv.interpolate(s, env, node) for s in (
            "${node.unique.id}", "${node.unique.name}", "${node.class}",
            "${meta.missing}", "a-${NOMAD_ALLOC_ID}-b", "${x")]))
    assert out[1] == out[0]


# --------------------------------------------------------- client state

def test_state_db_round_trip_alike(tmp_path):
    out = []
    for name in PACKAGES:
        client = pkg(name, "client")
        base = pkg(name, "client.drivers.base")
        job = make_job(name)
        node = make_node(name, 0)
        db = client.StateDB(str(tmp_path / name))
        for i in range(3):
            db.put_allocation(make_alloc(name, job, node, f"alloc-{i}"))
        db.put_task_handle("alloc-1", "worker", base.TaskHandle(
            task_id="x", driver="mock", pid=42, started_at=1.5,
            driver_state={"a": [1, 2]}))
        db.delete_allocation("alloc-2")
        db.close()
        db2 = client.StateDB(str(tmp_path / name))
        rows = sorted(db2.get_allocations(), key=lambda r: r["id"])
        handles = {k: vars(v) for k, v in
                   db2.get_task_handles("alloc-1").items()}
        db2.close()
        out.append((rows, handles, db2.get_allocations()))
    assert out[1] == out[0]
    assert [r["id"] for r in out[0][0]] == ["alloc-0", "alloc-1"]


# --------------------------------------------------------- fingerprints

def test_fingerprints_alike(tmp_path):
    """Both packages read the same host, so each field must be equal."""
    out = []
    for name in PACKAGES:
        fp = pkg(name, "client.fingerprint")
        structs = pkg(name, "structs")
        node = structs.Node(id="node-fp", name="node-fp")
        fp.FingerprintManager(pkg(name, "client.drivers")
                              .new_driver_registry(),
                              str(tmp_path)).run(node)
        out.append(pkg(name, "structs.codec").encode(node))
    ref, port = out
    assert sorted(port) == sorted(ref)
    for field in ref:
        assert port[field] == ref[field], field


# --------------------------------------------------------- task runners

TASK_CASES = {
    "batch_completes": ({"run_for_s": 0.02}, {}),
    "restarts_then_fails": ({"run_for_s": 0.02, "exit_code": 1},
                            {"attempts": 1, "interval_s": 300,
                             "delay_s": 0.01, "mode": "fail"}),
    "start_error": ({"start_error": "boom"},
                    {"attempts": 0, "mode": "fail"}),
    "killed": ({"run_for_s": 5, "kill_after_s": 0.02},
               {"attempts": 0, "mode": "fail"}),
}


@pytest.mark.parametrize("case", sorted(TASK_CASES))
def test_task_runner_mock_lifecycle_alike(case):
    config, policy = TASK_CASES[case]
    out = []
    for name in PACKAGES:
        random.seed(3)
        structs = pkg(name, "structs")
        kw = ({"restart_policy": structs.RestartPolicy(**policy)}
              if policy else {})
        job = make_job(name, config=config, **kw)
        node = make_node(name, 0)
        alloc = make_alloc(name, job, node)
        seen = []
        tr = pkg(name, "client.task_runner").TaskRunner(
            alloc, job.task_groups[0].tasks[0],
            pkg(name, "client.drivers").MockDriver(), node, is_batch=True,
            on_state_change=lambda r, seen=seen: seen.append(r.state.state))
        tr.run()
        out.append((task_view(tr), tr.env, seen))
    assert out[1] == out[0]


ALLOC_CASES = {
    "batch_two_tasks": ("batch_job", {"run_for_s": 0.02}),
    "service_failing": ("job", {"run_for_s": 0.02, "exit_code": 2}),
    "missing_driver": ("batch_job", None),
}


@pytest.mark.parametrize("case", sorted(ALLOC_CASES))
def test_alloc_runner_mock_lifecycle_alike(case):
    kind, config = ALLOC_CASES[case]
    out = []
    for name in PACKAGES:
        random.seed(5)
        structs = pkg(name, "structs")
        job = make_job(name, kind=kind, config=config,
                       restart_policy=structs.RestartPolicy(
                           attempts=0, mode="fail"))
        tg = job.task_groups[0]
        if case == "batch_two_tasks":
            t2 = tg.tasks[0].copy() if hasattr(tg.tasks[0], "copy") else \
                __import__("copy").deepcopy(tg.tasks[0])
            t2.name = "second"
            tg.tasks.append(t2)
        if config is None:
            tg.tasks[0].driver = "docker"
        node = make_node(name, 0)
        alloc = make_alloc(name, job, node)
        updates = []
        drivers = {"mock": pkg(name, "client.drivers").MockDriver()}
        ar = pkg(name, "client.alloc_runner").AllocRunner(
            alloc, drivers, node, on_update=lambda ar, u=updates:
            u.append(ar.alloc.client_status))
        ar.run()
        assert ar.wait(10.0)
        states = {t: (s.state, s.failed, [(e.type, e.message)
                                          for e in s.events])
                  for t, s in sorted(alloc.task_states.items())}
        out.append((alloc.client_status, states, updates[-1]))
    assert out[1] == out[0]


# ------------------------------------------------- client over a server

def make_server(name):
    kw = {"device": "cpu"} if name == PORT else {"mesh": False}
    s = pkg(name, "core.server").Server(dev_mode=True, profile_hz=0, **kw)
    s.establish_leadership()
    return s


def test_client_runs_batch_job_alike(pinned, tmp_path):
    """A dev-mode Server, one in-process Client: a batch job of two
    mock tasks and a failing one run to their end; the store's allocs
    and evals, ids included, must be equal."""
    out = []
    for name in PACKAGES:
        pinned(11)
        client_mod = pkg(name, "client")
        s = make_server(name)
        node = make_node(name, 0)
        c = client_mod.Client(client_mod.InProcessRPC(s), node=node,
                              data_dir=str(tmp_path / name),
                              heartbeat_interval=0.2, sync_interval=0.05)
        try:
            c.rpc.register_node(c.node)
            ok = make_job(name, "ok", count=2, config={"run_for_s": 0.02})
            bad = make_job(name, "bad", config={"run_for_s": 0.02,
                                                "exit_code": 1},
                           restart_policy=pkg(name, "structs").RestartPolicy(
                               attempts=0, mode="fail"))
            for j in (ok, bad):
                s.register_job(j)
            s.process_all()
            allocs, _ = s.get_client_allocs(node.id, 0, timeout=1.0)
            c.run_allocs(allocs)
            assert c.wait_until_idle(timeout=10)
            c.sync_once()
            s.process_all()
            snap = s.state.snapshot()
            view = (sorted((a.id, a.name, a.node_id, a.client_status,
                            a.desired_status,
                            sorted((t, st.state, st.failed)
                                   for t, st in a.task_states.items()))
                           for j in ("ok", "bad")
                           for a in snap.allocs_by_job("default", j)),
                    sorted((e.id, e.job_id, e.triggered_by, e.status)
                           for e in snap.evals()),
                    sorted(c.alloc_runners))
        finally:
            c.shutdown()
            s.shutdown()
        out.append(view)
    assert out[1] == out[0]
    assert any(e[2] == "alloc-failure" for e in out[0][1])


def test_secrets_provider_alike(pinned):
    """integrations: the variables provider over each Server's RPC
    surface reads, misses and refuses alike."""
    out = []
    for name in PACKAGES:
        pinned(5)
        client_mod = pkg(name, "client")
        integ = pkg(name, "integrations")
        s = make_server(name)
        try:
            rpc = client_mod.InProcessRPC(s)
            structs = pkg(name, "structs")
            s.state.upsert_variable(structs.VariableItem(
                namespace="default", path="nomad/jobs/app",
                items={"user": "u", "password": "p"}))
            prov = integ.VariablesSecretsProvider(rpc)
            row = []
            for path, token in (("nomad/jobs/app", ""),
                                ("nomad/jobs/none", "")):
                try:
                    row.append(prov.fetch("default", path, token))
                except PermissionError as e:
                    row.append(("PermissionError", str(e)))
            assert isinstance(prov, integ.SecretsProvider)
        finally:
            s.shutdown()
        out.append(row)
    assert out[1] == out[0]


def test_service_registrations_alike():
    out = []
    for name in PACKAGES:
        services = pkg(name, "client.services")
        structs = pkg(name, "structs")
        job = make_job(name, kind="job")
        tg = job.task_groups[0]
        tg.services = [structs.Service(name="web-svc", port_label="http",
                                       tags=["a"], provider="nomad")]
        node = make_node(name, 0)
        alloc = make_alloc(name, job, node)
        alloc.allocated_ports = {"http": 25001}
        regs = services.build_registrations(alloc, node)
        out.append(([pkg(name, "structs.codec").encode(r) for r in regs],
                    services.registration_id("a1", "g", "web-svc")))
    assert out[1] == out[0]


def test_exec_session_alike():
    out = []
    for name in PACKAGES:
        es = pkg(name, "client.exec_session")
        d = pkg(name, "client.drivers").MockDriver()
        task = pkg(name, "structs").Task(name="t", driver="mock",
                                         config={"run_for_s": 5})
        h = d.start_task("t1", task, {}, "")
        stream = d.open_exec(h, ["/bin/sh"])
        sess = es.ExecSession(stream, alloc_id="a1", task="t")
        reg = es.ExecSessionRegistry()
        sid = reg.add(sess)
        sess.stdin(b"hello\n")
        deadline = time.time() + 5
        data, off = b"", 0
        while time.time() < deadline and b"hello" not in data:
            chunk, off, _, _ = sess.wait_output(off, timeout=0.5)
            data += chunk
        sess.stdin(b"exit\n")
        sess.stdin_eof()
        sess.close()
        reg.remove(sid)
        d.stop_task(h)
        out.append((data, reg.get(sid) is None))
    assert out[1] == out[0] and b"hello" in out[0][0]
