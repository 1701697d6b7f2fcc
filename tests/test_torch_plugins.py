"""The port's external plugins (nomad_tpu_torch/plugins/) against the
reference's (tests/test_plugins.py) on the CPU: real plugin processes
(examples/plugins_torch/, the port's copies of examples/plugins/) over
the handshake protocol.

The reference's ten cases are mirrored.  Where the reference's answer is
data (the handshake line, the frames, the device groups, a reserve, the
error on a socket path past the 108-byte limit), the reference's own
plugins run beside the port's and the two are compared.  Every socket
directory here is a short one made with `tempfile.mkdtemp(dir="/tmp")`:
the default (`plugin_dir/.sockets`, the reference's) and pytest's
`tmp_path` can exceed the limit."""

import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time

import pytest

from torch_parity import PACKAGES, make_node, pkg

PORT = "nomad_tpu_torch"
REF = "nomad_tpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLUGDIRS = {REF: os.path.join(REPO, "examples", "plugins"),
            PORT: os.path.join(REPO, "examples", "plugins_torch")}
PLUGDIR = PLUGDIRS[PORT]


def short_dir():
    return tempfile.mkdtemp(prefix="plg", dir="/tmp")


def start_manager(name):
    m = pkg(name, "plugins").PluginManager(PLUGDIRS[name],
                                           socket_dir=short_dir())
    m.scan()
    return m


@pytest.fixture(scope="module")
def managers():
    """Both packages' managers over their example plugins."""
    ms = {name: start_manager(name) for name in PACKAGES}
    yield ms
    for m in ms.values():
        shutil.rmtree(m.socket_dir, ignore_errors=True)
        m.shutdown()


@pytest.fixture(scope="module")
def manager(managers):
    return managers[PORT]


def hello_task(**config):
    task = pkg(PORT, "mock").job().task_groups[0].tasks[0]
    task.driver = "hello"
    task.config = config
    return task


# =====================================================================
# the protocol
# =====================================================================


def test_handshake_and_info(managers):
    for m in managers.values():
        assert "hello" in m.drivers and "fake-gpu" in m.devices
    info = {name: ({k: c.info for k, c in m._clients.items()})
            for name, m in managers.items()}
    assert sorted(info[PORT].values(), key=str) == \
        sorted(info[REF].values(), key=str)


def test_handshake_line_and_frames_equal_the_reference():
    """The protocol constants, a frame's bytes and the announced line are
    the reference's byte for byte."""
    bases = {name: pkg(name, "plugins.base") for name in PACKAGES}
    for key in ("MAGIC_COOKIE_KEY", "MAGIC_COOKIE_VALUE", "SOCKET_ENV",
                "CORE_PROTOCOL", "APP_PROTOCOL"):
        assert getattr(bases[PORT], key) == getattr(bases[REF], key)
    msg = {"id": 7, "method": "start_task",
           "params": {"task_id": "t", "env": {"A": "é"}, "n": [1, 2.5]}}
    frames = {}
    for name, base in bases.items():
        a, b = socket.socketpair()
        try:
            base._send(a, msg)
            a.shutdown(socket.SHUT_WR)
            frames[name] = b.recv(1 << 16)
        finally:
            a.close()
            b.close()
    assert frames[PORT] == frames[REF] and len(frames[PORT]) > 4
    # and the port reads the reference's frame back
    a, b = socket.socketpair()
    try:
        a.sendall(frames[REF])
        assert bases[PORT]._recv(b) == msg
    finally:
        a.close()
        b.close()
    lines = {}
    d = short_dir()
    sock = os.path.join(d, "p.sock")
    for name in PACKAGES:
        env = dict(os.environ, PYTHONPATH=REPO, **{
            bases[name].MAGIC_COOKIE_KEY: bases[name].MAGIC_COOKIE_VALUE,
            bases[name].SOCKET_ENV: sock})
        proc = subprocess.Popen(
            [sys.executable, "-c",
             f"from {name}.plugins.base import serve; "
             "serve({}, {'type': 'driver', 'name': 'x'})"],
            stdout=subprocess.PIPE, env=env)
        try:
            lines[name] = proc.stdout.readline()
        finally:
            proc.kill()
            proc.wait(timeout=10)
            proc.stdout.close()
    shutil.rmtree(d, ignore_errors=True)
    assert lines[PORT] == lines[REF]
    assert lines[PORT].decode().strip().endswith(f"|unix|{sock}|json")


def test_refuses_direct_execution():
    out = []
    for name in PACKAGES:
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("NOMAD_TPU_PLUGIN")}
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        p = subprocess.run(
            [sys.executable, os.path.join(PLUGDIRS[name],
                                          "hello_driver.py")],
            capture_output=True, timeout=120, env=env)
        out.append((p.returncode, p.stderr))
    assert out[0] == out[1]
    assert out[0][0] == 1 and b"plugin manager" in out[0][1]


def test_bad_plugin_rejected(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import sys; sys.exit(3)\n")
    base = pkg(PORT, "plugins")
    d = short_dir()
    try:
        with pytest.raises(base.PluginError):
            base.launch_plugin([sys.executable, str(bad)], d, timeout=60.0)
    finally:
        shutil.rmtree(d, ignore_errors=True)


def test_socket_path_limit_and_default_dir_alike(tmp_path):
    """The default socket directory is `plugin_dir/.sockets` in both, and
    a socket path past the 108-byte Unix limit fails alike: the plugin
    cannot bind, announces nothing, and the host raises PluginError with
    the child's error."""
    long_dir = str(tmp_path / ("s" * 120))
    errors = {}
    for name in PACKAGES:
        plugins = pkg(name, "plugins")
        m = plugins.PluginManager(PLUGDIRS[name])
        assert m.socket_dir == os.path.join(PLUGDIRS[name], ".sockets")
        with pytest.raises(plugins.PluginError) as exc:
            plugins.launch_plugin(
                [sys.executable,
                 os.path.join(PLUGDIRS[name], "hello_driver.py")],
                long_dir, timeout=60.0)
        errors[name] = str(exc.value)
    for msg in errors.values():
        assert "did not announce its socket" in msg
        assert "AF_UNIX path too long" in msg


# =====================================================================
# the external driver
# =====================================================================


def test_task_lifecycle(manager):
    drv = manager.drivers["hello"]
    assert drv.fingerprint()["driver.hello"] == "1"
    h = drv.start_task("t1", hello_task(message="hi", run_for_s=0.2),
                       {"NOMAD_TASK_NAME": "web"}, "")
    assert h.pid > 0 and h.driver == "hello"
    res = drv.wait_task(h, timeout=60.0)
    assert res is not None and res.successful()


def test_stop_task(manager):
    drv = manager.drivers["hello"]
    h = drv.start_task("t2", hello_task(run_for_s=300), {}, "")
    assert drv.recover_task(h)
    drv.stop_task(h, kill_timeout=2.0)
    res = drv.wait_task(h, timeout=60.0)
    assert res is not None and not drv.recover_task(h)


def test_concurrent_wait_does_not_block_other_calls(manager):
    """Request-id multiplexing: a blocked wait_task must not stall a
    fingerprint."""
    drv = manager.drivers["hello"]
    h = drv.start_task("t3", hello_task(run_for_s=3), {}, "")
    done = []
    t = threading.Thread(
        target=lambda: done.append(drv.wait_task(h, timeout=30)))
    t.start()
    t0 = time.time()
    fp = drv.fingerprint()
    assert fp and time.time() - t0 < 2.0
    drv.stop_task(h, 1.0)
    t.join(timeout=10)
    assert not t.is_alive() and done


def test_crashed_plugin_relaunched():
    m = start_manager(PORT)
    try:
        from nomad_tpu_torch.core.logging import RING
        assert "hello" in m.drivers, RING.tail(6)
        drv = m.drivers["hello"]
        assert drv.fingerprint()
        drv.client.proc.kill()
        drv.client.proc.wait(timeout=5)
        time.sleep(0.2)
        assert drv.fingerprint() == {}      # dead connection
        m.start_supervisor(interval=0.5)
        deadline = time.time() + 90
        while time.time() < deadline:
            if drv.fingerprint().get("driver.hello") == "1":
                break
            time.sleep(0.3)
        # the SAME shim object works again after the relaunch
        assert drv.fingerprint()["driver.hello"] == "1"
        assert m.drivers["hello"] is drv
    finally:
        m.shutdown()
        shutil.rmtree(m.socket_dir, ignore_errors=True)
    assert drv.client.proc.poll() is not None


# =====================================================================
# the external device plugin
# =====================================================================


def _groups(m):
    return sorted((g.id(), tuple(g.instance_ids), sorted(g.attributes.items()))
                  for g in m.fingerprint_devices())


def test_fingerprint_groups(managers):
    got = {name: _groups(m) for name, m in managers.items()}
    assert got[PORT] == got[REF]
    assert got[PORT][0][0] == "acme/gpu/fake100"


def test_reserve(managers):
    got = {name: m.devices["fake-gpu"].reserve(["fake100-1"])
           for name, m in managers.items()}
    assert got[PORT] == got[REF]
    assert got[PORT]["envs"]["ACME_VISIBLE_DEVICES"] == "fake100-1"


# =====================================================================
# the client
# =====================================================================


def test_client_uses_plugin_driver_and_devices(tmp_path):
    """A port Client with a plugin_dir (the example plugins copied into a
    short directory, so that its default socket directory fits) on a
    `device="cpu"` Server: the node advertises the plugin's driver and
    devices, and a job on the external driver with one device runs with
    the plugin's reservation in its environment."""
    plugdir = short_dir()
    for f in os.listdir(PLUGDIR):
        if f.endswith(".py"):
            shutil.copy(os.path.join(PLUGDIR, f), plugdir)
    client_mod = pkg(PORT, "client")
    structs = pkg(PORT, "structs")
    srv = pkg(PORT, "core.server").Server(dev_mode=False, heartbeat_ttl=3600,
                                          device="cpu", profile_hz=0)
    srv.start()
    node = make_node(PORT, 0)
    cl = client_mod.Client(client_mod.InProcessRPC(srv), node=node,
                           data_dir=str(tmp_path / "c1"),
                           plugin_dir=plugdir)
    cl.start()
    procs = [c.proc for c in cl.plugin_manager._clients.values()]
    try:
        nd = srv.state.node_by_id(node.id)
        assert nd.attributes.get("driver.hello") == "1"
        assert nd.drivers.get("hello") is True
        assert any(d.id() == "acme/gpu/fake100"
                   for d in nd.resources.devices)
        job = pkg(PORT, "mock").job(id="hello-job")
        job.task_groups[0].count = 1
        t = job.task_groups[0].tasks[0]
        t.driver = "hello"
        t.config = {"message": "external", "run_for_s": 60}
        t.resources.devices = [structs.RequestedDevice(name="gpu", count=1)]
        srv.register_job(job)
        deadline = time.time() + 30
        runner = None
        while time.time() < deadline:
            runners = list(cl.alloc_runners.values())
            if runners and runners[0].task_runners[0].state.state \
                    == "running":
                runner = runners[0]
                break
            time.sleep(0.2)
        assert runner is not None, "task never started on plugin driver"
        tr = runner.task_runners[0]
        assert tr.handle.driver == "hello" and tr.handle.pid > 0
        iid = runner.alloc.allocated_devices[0].device_ids[0]
        assert tr.env["ACME_VISIBLE_DEVICES"] == iid
        assert tr.env["NOMAD_DEVICE_ACME_GPU_FAKE100"] == iid
    finally:
        cl.shutdown()
        srv.shutdown()
        shutil.rmtree(plugdir, ignore_errors=True)
    assert len(procs) == 2
    assert all(p.poll() is not None for p in procs)
