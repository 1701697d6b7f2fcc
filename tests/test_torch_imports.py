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


PROBE = textwrap.dedent("""
    import importlib, pkgutil, sys
    sys.modules["jax"] = None
    sys.modules["nomad_tpu"] = None
    import nomad_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        nomad_tpu_torch.__path__, "nomad_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    leaked = sorted(k for k in sys.modules
                    if (k == "jax" or k.startswith("jax.")
                        or k == "nomad_tpu" or k.startswith("nomad_tpu."))
                    and sys.modules[k] is not None)
    print(len(names), leaked)
""")


def test_every_module_imports_without_jax_or_reference():
    out = subprocess.run([sys.executable, "-c", PROBE], capture_output=True,
                         text=True, timeout=120, check=True)
    count, leaked = out.stdout.strip().split(" ", 1)
    assert int(count) >= 68
    assert leaked == "[]"


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
    """The mesh slice's modules are among those the probe imports, and
    a mesh across several cards raises."""
    import pkgutil

    import nomad_tpu_torch
    from nomad_tpu_torch.parallel import make_mesh
    names = {m.name for m in pkgutil.walk_packages(
        nomad_tpu_torch.__path__, "nomad_tpu_torch.")}
    assert {"nomad_tpu_torch.parallel",
            "nomad_tpu_torch.parallel.mesh"} <= names
    with pytest.raises(NotImplementedError):
        make_mesh(8, ["cuda:0", "cuda:1"])



def test_observability_and_executor_modules_stand_alone():
    """The planes and the executor seam are among the modules the probe
    imports, and the port's core package, like the reference's, imports
    its server and with it the planes and the executor seam."""
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
        eager = sorted(k for k in sys.modules
                       if k.startswith("nomad_tpu_torch.core."))
        from nomad_tpu_torch.ops import TorchExecutor  # noqa: F401
        print(eager)
    """)
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=120, check=True)
    eager = set(ast.literal_eval(out.stdout.strip()))
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
    probe imports; the fanout copy leaves out the read follower."""
    import pkgutil

    import nomad_tpu_torch
    from nomad_tpu_torch.core import fanout
    names = {m.name for m in pkgutil.walk_packages(
        nomad_tpu_torch.__path__, "nomad_tpu_torch.")}
    assert {f"nomad_tpu_torch.{m}" for m in SERVER_SLICE} <= names
    assert not hasattr(fanout, "ReadFollower")


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
