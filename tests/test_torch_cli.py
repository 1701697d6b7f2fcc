"""The port's CLI (nomad_tpu_torch/cli.py, `python -m nomad_tpu_torch`)
against the reference's: `cli.main([...])` of each package, pointed at
its own Agent on the CPU (two in-process clients on the mock driver),
prints the same output for `job run`, `job status`, `job inspect`,
`job validate`, `node status`, `eval list` and the rest of the sequence
below.

Ids are pinned (`pinned`), the clients' nodes carry explicit ids, the
reference's engine runs on one device (`one_device`); each command runs
once the agent has settled, and `job status web` once its three allocs
run.  Nothing is dropped from the output: the commands print no wall
time.

`soak -quick` runs through both packages, the port's soak on the CPU,
and prints the same summary but for the lines that are wall facts or
that the reference's own runs do not repeat, each dropped by name
(SOAK_DROPPED).  The documented difference has a test of its own:
`agent` runs on CUDA, raising without it."""

import os
import re
import subprocess
import sys
import time

import pytest

from torch_parity import (PACKAGES, agent_nodes, make_agent, one_device,
                          pinned, pkg, settle)  # noqa: F401

PORT = "nomad_tpu_torch"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (command, wait for web's allocs to run before it)
SEQUENCE = [
    (["job", "validate", "examples/web.hcl"], False),
    (["job", "validate", "examples/batch.hcl"], False),
    (["job", "run", "examples/web.hcl"], False),
    (["job", "status", "web"], True),
    (["job", "status"], False),
    (["job", "inspect", "web"], False),
    (["job", "plan", "examples/web.hcl"], False),
    (["node", "status"], False),
    (["eval", "list"], False),
    (["job", "status", "nosuch"], False),
    (["version"], False),
]


def wait_running(agent, n=3, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        allocs = agent.server.state.snapshot().allocs_by_job("default",
                                                             "web")
        if (len(allocs) == n
                and all(a.client_status == "running" for a in allocs)):
            return
        time.sleep(0.05)
    raise AssertionError("web did not run")


def run_sequence(name, agent, capsys):
    cli = pkg(name, "cli")
    out = []
    for argv, wait in SEQUENCE:
        if wait:
            wait_running(agent)
        settle(agent)
        capsys.readouterr()
        rc = cli.main(["-address", agent.address] + argv)
        cap = capsys.readouterr()
        out.append((argv, rc, cap.out, cap.err))
    return out


def test_cli_sequence_prints_alike(pinned, one_device, tmp_path,
                                   monkeypatch, capsys):
    monkeypatch.chdir(ROOT)
    runs = []
    for name in PACKAGES:
        pinned(13)
        agent = make_agent(name, tmp_path / name, num_clients=2,
                           nodes=agent_nodes(name, 2)).start()
        try:
            runs.append(run_sequence(name, agent, capsys))
        finally:
            agent.shutdown()
    ref, port = runs
    for want, got in zip(ref, port):
        assert got == want, want[0]
    by = {" ".join(r[0]): r for r in ref}
    assert by["job run examples/web.hcl"][1] == 0
    assert "run/running" in by["job status web"][2]
    assert by["job status nosuch"][1] == 1


# summary lines of `soak` that are not a function of the seed: the wall
# facts (wall seconds, memory, the timeline's self-metered overhead), and
# what thread timing moves in the reference's own runs of `soak -quick`
# (three gave evals 29, 31, 31 and zone balance 2, 1.66667, 1.66667: which
# node a reschedule lands on, and whether a node update races a sweep) and
# the timeline digest (a drain's completion lands on one sweep or the next;
# tests/test_torch_soak.py)
SOAK_DROPPED = ("wall seconds", "memory", "evals", "zone balance max/min")
SOAK_TIMELINE = re.compile(r"\(overhead [0-9.]+, digest [0-9a-f]+…\)")


def soak_lines(out):
    lines = []
    for ln in out.splitlines():
        key = ln.split("=", 1)[0].strip()
        if key in SOAK_DROPPED:
            continue
        if key == "timeline":
            ln, n = SOAK_TIMELINE.subn("", ln)
            assert n == 1, ln
        lines.append(ln)
    return lines


# the reference's interleaved scenarios pace virtual time against the
# wall and miss their budget on a loaded host (six copies of this test
# side by side: the reference's soak failed in two on a chaos scenario,
# the port's in none), so a reference run that failed on its chaos
# scenarios alone is run again, up to this many runs; the port's gets one
REF_SOAK_RUNS = 3


def chaos_only_failure(rc, out):
    bad = [ln for ln in out.splitlines() if ln.startswith("VIOLATION: ")]
    return rc != 0 and bad and all(ln.startswith("VIOLATION: chaos ")
                                   for ln in bad)


def test_soak_quick_prints_alike(pinned, one_device, monkeypatch, capsys):
    """`soak -quick` (0.1 virtual hours on four nodes, two chaos
    scenarios interleaved) through both packages' CLIs, the port's soak
    on the CPU: both pass, and print the same lines but for the wall
    facts and what the reference's own runs do not repeat
    (SOAK_DROPPED, the timeline's overhead and digest)."""
    soak_mod = pkg(PORT, "chaos.soak")
    run_soak = soak_mod.run_soak
    monkeypatch.setattr(soak_mod, "run_soak",
                        lambda *a, **kw: run_soak(*a, device="cpu", **kw))
    out = {}
    for name in PACKAGES:
        for _ in range(REF_SOAK_RUNS if name == "nomad_tpu" else 1):
            pinned(0)
            capsys.readouterr()
            rc = pkg(name, "cli").main(["soak", "-quick"])
            cap = capsys.readouterr()
            if not chaos_only_failure(rc, cap.out):
                break
        assert rc == 0, (name, cap.out, cap.err)
        out[name] = soak_lines(cap.out)
    assert out[PORT] == out["nomad_tpu"]
    assert out[PORT][-1].endswith("= PASS")
    assert any(ln.startswith("trace digest") for ln in out[PORT])


def test_agent_command_needs_cuda(tmp_path):
    """`agent` builds the port's Agent on CUDA; without a card it raises
    before it serves anything."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present; chip_smoke.py's agent_cli phase "
                    "runs the command there")
    with pytest.raises(RuntimeError, match="CUDA"):
        pkg(PORT, "cli").main(["agent", "-bind", "127.0.0.1:0",
                               "-clients", "0", "-data-dir",
                               str(tmp_path)])


def test_module_entry_point_runs_the_port_cli(tmp_path):
    """`python -m nomad_tpu_torch` is the port's CLI, with JAX and the
    reference made unimportable."""
    probe = ("import runpy, sys; sys.modules['jax'] = None; "
             "sys.modules['nomad_tpu'] = None; "
             "sys.argv = ['nomad_tpu_torch', 'version']; "
             "runpy.run_module('nomad_tpu_torch', run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    ref = subprocess.run([sys.executable, "-m", "nomad_tpu", "version"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.stdout == ref.stdout
