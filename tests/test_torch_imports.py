"""The port stands alone: every module of nomad_tpu_torch imports with
JAX and the reference package made unimportable, and its entry points
default to CUDA, raising where there is none."""

import ast
import subprocess
import sys
import textwrap

import pytest
import torch


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


# msgpack and cryptography are blocked too: they are not among the
# packages the port may rely on.  The cluster plane's wire codec has its
# own MessagePack (core/_msgpack.py) and imports cryptography only when a
# key is installed.  The
# package's __main__ is the CLI's script (it runs the CLI on import), so
# the probe imports the CLI module instead.
PROBE = textwrap.dedent("""
    import importlib, pkgutil, sys
    for blocked in ("jax", "nomad_tpu", "msgpack", "cryptography"):
        sys.modules[blocked] = None
    import nomad_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        nomad_tpu_torch.__path__, "nomad_tpu_torch.")
        if m.name != "nomad_tpu_torch.__main__"]
    for name in names:
        importlib.import_module(name)
    leaked = sorted(k for k in sys.modules
                    if (k == "jax" or k.startswith("jax.")
                        or k == "nomad_tpu" or k.startswith("nomad_tpu.")
                        or k.split(".")[0] in ("msgpack", "cryptography"))
                    and sys.modules[k] is not None)
    print(len(names), leaked)
""")


def test_every_module_imports_without_jax_or_reference():
    out = subprocess.run([sys.executable, "-c", PROBE], capture_output=True,
                         text=True, timeout=120, check=True)
    count, leaked = out.stdout.strip().split(" ", 1)
    assert int(count) >= 102
    assert leaked == "[]"


def test_native_bridge_bindings_import_without_torch():
    """nomad_tpu_torch/native/: the bridge's bindings load a built library
    with ctypes and numpy alone, so a worker without torch imports them
    (the walk above imports the package with torch present)."""
    probe = textwrap.dedent("""
        import sys
        for blocked in ("torch", "jax", "nomad_tpu"):
            sys.modules[blocked] = None
        import nomad_tpu_torch.native
        from nomad_tpu_torch.native import bridge
        print(sorted(bridge.PROGRAMS), bridge.BridgeError.__mro__[1].__name__)
    """)
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.split() == [
        "['place_bulk_packed',", "'place_multi_compact_packed',",
        "'place_multi_packed']", "RuntimeError"]


def test_no_source_line_imports_jax_or_reference():
    """Lazy imports inside functions count too."""
    import pathlib
    import re

    import nomad_tpu_torch
    root = pathlib.Path(nomad_tpu_torch.__file__).parent
    bad = re.compile(r"^\s*(from|import)\s+(jax\b|nomad_tpu(\.|\s|$))")
    hits = [f"{p}:{i}" for p in root.rglob("*.py")
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if bad.match(line)]
    assert hits == []


def test_engine_defaults_to_cuda():
    from nomad_tpu_torch.ops import PlacementEngine
    from nomad_tpu_torch.scheduler import Harness
    if torch.cuda.is_available():
        assert PlacementEngine().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        PlacementEngine()
    with pytest.raises(RuntimeError, match="CUDA"):
        Harness()
    with pytest.raises(RuntimeError, match="CUDA"):
        PlacementEngine(device="cuda")
    assert Harness(device="cpu").engine.device.type == "cpu"


def test_mesh_modules_stand_alone():
    """The mesh slice's modules, the mesh across parts among them, are
    among those the probe imports; a mesh of parts splits its shards
    over them, and a CUDA mesh on a host without CUDA raises."""
    import pkgutil

    import nomad_tpu_torch
    from nomad_tpu_torch.parallel import make_mesh
    names = {m.name for m in pkgutil.walk_packages(
        nomad_tpu_torch.__path__, "nomad_tpu_torch.")}
    assert {"nomad_tpu_torch.parallel",
            "nomad_tpu_torch.parallel.mesh",
            "nomad_tpu_torch.parallel.xmesh"} <= names
    mesh = make_mesh(8, ["cpu", "cpu"])
    assert (mesh.n_parts, mesh.shards_per_part) == (2, 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh(8, ["cuda:0", "cuda:1"])



def test_observability_and_executor_modules_stand_alone():
    """The planes and the executor seam are among the modules the probe
    imports, and the port's core package binds its exports, the server
    among them, at first access: importing the package alone imports no
    server, and `from nomad_tpu_torch.core import Server` imports the
    server and with it the planes and the executor seam."""
    import pkgutil

    import nomad_tpu_torch
    names = {m.name for m in pkgutil.walk_packages(
        nomad_tpu_torch.__path__, "nomad_tpu_torch.")}
    new = {f"nomad_tpu_torch.core.{m}" for m in (
        "obsbus", "telemetry", "memledger", "logging", "profiling",
        "timeline", "flightrec", "identity")} | {
        "nomad_tpu_torch.ops.executor"}
    assert new <= names
    probe = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["nomad_tpu"] = None
        import nomad_tpu_torch.core
        bare = sorted(k for k in sys.modules
                      if k.startswith("nomad_tpu_torch.core."))
        from nomad_tpu_torch.core import Server  # noqa: F401
        eager = sorted(k for k in sys.modules
                       if k.startswith("nomad_tpu_torch.core."))
        from nomad_tpu_torch.ops import TorchExecutor  # noqa: F401
        print([bare, eager])
    """)
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=120, check=True)
    bare, eager = map(set, ast.literal_eval(out.stdout.strip()))
    assert "nomad_tpu_torch.core.server" not in bare
    assert {"nomad_tpu_torch.core.server"} | {
        m for m in new if m.startswith("nomad_tpu_torch.core.")} <= eager


SERVER_SLICE = ("acl", "acl.acl", "acl.policy", "acl.auth_methods",
                "jobspec.hcl") + tuple(f"core.{m}" for m in (
                    "eval_broker", "blocked_evals", "heartbeat", "fanout",
                    "stream", "plan_apply", "wavepipe", "worker",
                    "periodic", "drainer", "deployment_watcher",
                    "volume_watcher", "server"))


def test_server_slice_modules_stand_alone():
    """The acl package and the server loop's modules are among those the
    probe imports; the fanout copy holds the read follower."""
    import pkgutil

    import nomad_tpu_torch
    from nomad_tpu_torch.core import fanout
    names = {m.name for m in pkgutil.walk_packages(
        nomad_tpu_torch.__path__, "nomad_tpu_torch.")}
    assert {f"nomad_tpu_torch.{m}" for m in SERVER_SLICE} <= names
    assert hasattr(fanout, "ReadFollower")


# modules whose import runs core/__init__ (and with it server -> ops ->
# the executor -> core planes) from another package's import first
FIRST_IMPORTS = ("nomad_tpu_torch.core.telemetry",
                 "nomad_tpu_torch.core.server",
                 "nomad_tpu_torch.core.wavepipe",
                 "nomad_tpu_torch.ops.executor",
                 "nomad_tpu_torch.ops.engine",
                 "nomad_tpu_torch.state",
                 "nomad_tpu_torch.scheduler.generic",
                 "nomad_tpu_torch.acl")


@pytest.mark.parametrize("first", FIRST_IMPORTS)
def test_import_order_from_a_fresh_interpreter(first):
    """Each of these imported first in a fresh interpreter, then the
    server: the core package's exports, which import the server, do not
    meet a partly initialised module on the way (the whole-package probe
    above imports in one order only)."""
    probe = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["nomad_tpu"] = None
        import {first}
        import nomad_tpu_torch.core.server as server
        from nomad_tpu_torch.core import Server, Worker
        assert Server is server.Server
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "ok"


AGENT_SLICE = (
    "agent", "agent_config", "cli", "__main__", "api", "api.client",
    "api.http_server", "api.ui", "client", "client.alloc_runner",
    "client.client", "client.exec_session", "client.fingerprint",
    "client.restarts", "client.services", "client.state",
    "client.task_runner", "client.taskenv", "client.drivers",
    "client.drivers.base", "client.drivers.docker",
    "client.drivers.execdriver", "client.drivers.java",
    "client.drivers.mock", "client.drivers.qemu", "client.drivers.rawexec",
    "integrations", "integrations.secrets", "core.regions", "jobspec",
    "jobspec.schema", "jobspec.api_json")


def test_agent_slice_modules_stand_alone():
    """The agent, API, CLI, client and jobspec modules are among those
    the probe imports, and so are the cluster plane's modules the agent
    reaches in cluster mode and the process planes' (PROCESS_SLICE)."""
    import pkgutil

    import nomad_tpu_torch
    names = {m.name for m in pkgutil.walk_packages(
        nomad_tpu_torch.__path__, "nomad_tpu_torch.")}
    assert {f"nomad_tpu_torch.{m}" for m in AGENT_SLICE} <= names
    assert {f"nomad_tpu_torch.{m}" for m in CLUSTER_SLICE} <= names
    assert {f"nomad_tpu_torch.{m}" for m in PROCESS_SLICE} <= names


PROCESS_SLICE = ("plugins", "plugins.base", "plugins.device",
                 "plugins.driver", "plugins.manager", "core.workerpool")


def test_process_slice_modules_stand_alone():
    """The worker pool and the plugins import with jax and the reference
    blocked.  A plugin process's chain (the plugins package, structs,
    the driver contract, logging) imports no torch; the pool's module
    imports none until a child needs it, and importing the pool, the
    server and the engine initializes no CUDA.  The example plugins of
    the port import neither jax nor the reference."""
    import pathlib
    import re
    probe = textwrap.dedent("""
        import sys
        for blocked in ("jax", "nomad_tpu", "msgpack", "cryptography"):
            sys.modules[blocked] = None
        import nomad_tpu_torch.plugins
        import nomad_tpu_torch.structs
        import nomad_tpu_torch.client.drivers.base
        import nomad_tpu_torch.core.logging
        import nomad_tpu_torch.core.workerpool
        plugin_torch = "torch" in sys.modules
        import nomad_tpu_torch.core.server
        import nomad_tpu_torch.ops.engine
        import torch
        print([plugin_torch, torch.cuda.is_initialized()])
    """)
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert ast.literal_eval(out.stdout.strip()) == [False, False]
    bad = re.compile(r"^\s*(from|import)\s+(jax\b|nomad_tpu(\.|\s|$))")
    examples = pathlib.Path(__file__).parent.parent / "examples" / \
        "plugins_torch"
    files = sorted(examples.glob("*.py"))
    assert [f.name for f in files] == ["fake_gpu_device.py",
                                       "hello_driver.py"]
    assert not [f"{f}:{i}" for f in files
                for i, line in enumerate(f.read_text().splitlines(), 1)
                if bad.match(line)]


CLUSTER_SLICE = ("core._msgpack", "core.wire", "core.membership",
                 "core.raft", "core.cluster", "core.federation",
                 "chaos.transport")


def test_cluster_slice_modules_stand_alone():
    """The cluster plane's modules import with jax, the reference,
    msgpack and cryptography blocked, and export what the reference's
    export; the chaos package exports the reference's names."""
    probe = textwrap.dedent("""
        import sys
        for blocked in ("jax", "nomad_tpu", "msgpack", "cryptography"):
            sys.modules[blocked] = None
        import importlib
        mods = %r
        for m in mods:
            importlib.import_module("nomad_tpu_torch." + m)
        from nomad_tpu_torch.core.cluster import (  # noqa: F401
            MUTATIONS, ClusterServer, RemoteRPC, ReplicatedState, RPCServer)
        from nomad_tpu_torch.core.raft import (  # noqa: F401
            Entry, NotLeaderError, RaftNode, recv_msg, reply, send_msg)
        from nomad_tpu_torch.core.membership import Gossip, Member  # noqa
        from nomad_tpu_torch.core.federation import (  # noqa: F401
            FederationPuller, agent_snapshot, http_transport, local_trace,
            stitch_trace)
        import nomad_tpu_torch.chaos as chaos
        print(sorted(chaos.__all__))
    """ % (CLUSTER_SLICE,))
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert ast.literal_eval(out.stdout.strip()) == sorted([
        "Clock", "SystemClock", "VirtualClock", "resolve_clock",
        "Connection", "Listener", "Transport", "TCPTransport",
        "SimNetwork", "SimTransport", "resolve_transport"])


CHAOS_SLICE = ("chaos.trace", "chaos.traffic", "chaos.invariants",
               "chaos.scenarios", "chaos.soak")


def test_chaos_slice_modules_stand_alone():
    """The traces, traffic, invariants, scenarios and soak import with
    jax, the reference, msgpack and cryptography blocked, and export the
    reference's names; the first three are pure (no torch, no server),
    as the reference's are."""
    probe = textwrap.dedent("""
        import sys
        for blocked in ("jax", "nomad_tpu", "msgpack", "cryptography"):
            sys.modules[blocked] = None
        import importlib
        for m in %r[:3]:
            importlib.import_module("nomad_tpu_torch." + m)
        pure = not any(k == "torch" or k.startswith(
            ("torch.", "nomad_tpu_torch.core.server")) for k in sys.modules)
        for m in %r[3:]:
            importlib.import_module("nomad_tpu_torch." + m)
        from nomad_tpu_torch.chaos.trace import (  # noqa: F401
            SCHEDULE_KINDS, Trace, schedule_from_trace, state_fingerprint)
        from nomad_tpu_torch.chaos.traffic import (  # noqa: F401
            DEFAULT_SCENARIOS, FaultyCall, TrafficProfile, fleet,
            generate_schedule, retry_idempotent, stable_id)
        from nomad_tpu_torch.chaos.invariants import (  # noqa: F401
            alloc_coherence, check_all, committed_entries_survive,
            leadership_converged, log_consistency, membership_converged,
            no_deposed_commit, single_leader_per_term)
        from nomad_tpu_torch.chaos.scenarios import (  # noqa: F401
            SCENARIOS, ScenarioResult, ScenarioRunner, run_scenario)
        from nomad_tpu_torch.chaos.soak import (  # noqa: F401
            SOAK_SLO, SoakResult, SoakRunner, coarse_fingerprint, run_soak)
        print([pure, sorted(SCENARIOS)])
    """) % (CHAOS_SLICE, CHAOS_SLICE)
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert ast.literal_eval(out.stdout.strip()) == [True, sorted([
        "leader_partition", "split_brain_attempt", "gossip_flap_storm",
        "lossy_link_raft_append", "heartbeat_expiry_during_drain"])]


def test_state_store_does_not_import_the_server():
    """A port StateStore reaches core.wire through chaos (its clock
    import runs chaos/__init__, which imports the transport, which
    imports the wire codec) and stops there: no server, no engine, no
    torch."""
    probe = textwrap.dedent("""
        import sys
        for blocked in ("jax", "nomad_tpu", "msgpack", "cryptography"):
            sys.modules[blocked] = None
        from nomad_tpu_torch.state import StateStore
        StateStore()
        print(sorted(k for k in sys.modules
                     if k.startswith(("nomad_tpu_torch.core",
                                      "nomad_tpu_torch.chaos",
                                      "nomad_tpu_torch.ops", "torch"))))
    """)
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(ast.literal_eval(out.stdout.strip()))
    assert {"nomad_tpu_torch.chaos.transport",
            "nomad_tpu_torch.core.wire"} <= loaded
    assert not any(m == "torch" or m.startswith(("torch.",
                                                  "nomad_tpu_torch.ops"))
                   for m in loaded)
    assert "nomad_tpu_torch.core.server" not in loaded


def test_encrypt_without_cryptography_raises_at_set_key():
    """AES-GCM stays behind the lazy import in set_key: without the
    cryptography package a non-empty key raises there and nothing is
    installed; an empty one is a no-op; plaintext frames still work."""
    probe = textwrap.dedent("""
        import sys
        sys.modules["cryptography"] = None
        from nomad_tpu_torch.core import wire
        wire.set_key("")
        try:
            wire.set_key("secret")
        except ImportError as e:
            print("ImportError", wire.has_key())
        frame = wire.encode_frame({"a": 1})
        print(wire.decode_body(frame[4:]))
    """)
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[:2] == ["ImportError False", "{'a': 1}"]


def test_agent_and_cli_agent_default_to_cuda(tmp_path):
    """The Agent and the CLI's `agent` command build the Server on CUDA
    unless told otherwise, and raise without it."""
    from nomad_tpu_torch import cli
    from nomad_tpu_torch.agent import Agent
    if torch.cuda.is_available():
        agent = Agent(data_dir=str(tmp_path), num_clients=0, profile_hz=0)
        assert agent.server.engine.device.type == "cuda"
        agent.start().shutdown()
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        Agent(data_dir=str(tmp_path), num_clients=0, profile_hz=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["agent", "-bind", "127.0.0.1:0", "-clients", "0",
                  "-data-dir", str(tmp_path)])
    agent = Agent(data_dir=str(tmp_path), num_clients=0, profile_hz=0,
                  device="cpu").start()
    try:
        assert agent.server.engine.device.type == "cpu"
    finally:
        agent.shutdown()
