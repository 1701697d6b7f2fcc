"""The port's jobspec package (nomad_tpu_torch/jobspec/{__init__,schema,
api_json}.py) and agent config parser (agent_config.py) against the
reference's: the same sources through both, compared as
`structs.codec.encode` dicts, and equal errors (type and message) where
the reference raises.

The sources: every job in examples/*.hcl, the HCL fixtures of
tests/test_jobspec.py, and a list of bad specs.  examples/agent.hcl
parses to equal AgentConfig fields apart from the documented
`device_executor` default ("torch" in the port, "jax" in the
reference)."""

import dataclasses
import glob
import json
import os

import pytest

from test_jobspec import FULL_SPEC
from torch_parity import PACKAGES, pkg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOB_EXAMPLES = sorted(
    os.path.basename(p)
    for p in glob.glob(os.path.join(ROOT, "examples", "*.hcl"))
    if os.path.basename(p) != "agent.hcl")

DYNAMIC_SPEC = '''
job "dyn" {
  group "g" {
    dynamic "task" {
      for_each = ["a", "b"]
      labels   = [task.value]
      content {
        driver = "exec"
        config { command = "/bin/${task.value}" }
      }
    }
  }
}
'''

API_JSON = {"Job": {
    "ID": "jj", "Type": "batch", "Datacenters": ["dc1"],
    "TaskGroups": [{"Name": "g", "Count": 0,
                    "Tasks": [{"Name": "t", "Driver": "exec",
                               "Resources": {"CPU": 250,
                                             "MemoryMB": 128}}]}]}}


def outcome(fn):
    """(encoded value, None) or (None, (error type name, message))."""
    try:
        return fn(), None
    except Exception as e:  # noqa: BLE001 - the error is the result
        return None, (type(e).__name__, str(e))


def both(fn):
    """`fn(package name)` for each package, as outcomes."""
    return [outcome(lambda name=name: fn(name)) for name in PACKAGES]


def encode(name, job):
    return pkg(name, "structs.codec").encode(job)


@pytest.fixture(autouse=True)
def _in_root(monkeypatch):
    monkeypatch.chdir(ROOT)


@pytest.mark.parametrize("example", JOB_EXAMPLES)
def test_example_job_parses_alike(example):
    ref, port = both(lambda name: encode(name, pkg(name, "jobspec")
                                         .parse_file(f"examples/{example}")))
    assert ref[1] is None, ref[1]
    assert port == ref


FULL_SPEC_CASES = {
    "defaults": {},
    "var_override": {"variables": {"replicas": 5}},
    "env_var_plane": {"env": {"NOMAD_VAR_image_tag": "9.9.9"}},
    "both_planes": {"variables": {"replicas": 2},
                    "env": {"NOMAD_VAR_image_tag": "0.0.1",
                            "OTHER": "ignored"}},
}


@pytest.mark.parametrize("case", sorted(FULL_SPEC_CASES))
def test_full_spec_parses_alike(case):
    kw = FULL_SPEC_CASES[case]
    ref, port = both(lambda name: encode(
        name, pkg(name, "jobspec").parse(FULL_SPEC, **kw)))
    assert ref[1] is None, ref[1]
    assert port == ref


def test_dynamic_block_parses_alike():
    ref, port = both(lambda name: encode(
        name, pkg(name, "jobspec").parse(DYNAMIC_SPEC)))
    assert ref[1] is None
    assert [t["Name"] for t in ref[0]["TaskGroups"][0]["Tasks"]] == \
        ["a", "b"]
    assert port == ref


# sources the reference refuses; the port must refuse them alike
BAD_SPECS = {
    "missing_variable": 'variable "x" {}\n'
                        'job "${var.x}" { group "g" { task "t" {} } }',
    "no_job_block": 'variable "x" { default = 1 }',
    "syntax": 'job "j" { group "g" {',
    "unknown_root": 'job "j" { meta { a = bogus.field } }',
    "bad_duration": 'job "j" { group "g" { restart { delay = "10 '
                    'parsecs" } task "t" {} } }',
    "local_cycle": 'locals { a = local.b\n b = local.a }\n'
                   'job "j" { group "g" { task "t" {} } }',
    "unknown_function": 'job "j" { meta { a = nosuch(1) } }',
    "bad_operator": 'job "j" { constraint { attribute = "x"\n'
                    ' operator = "~~"\n value = "y" } }',
}


@pytest.mark.parametrize("case", sorted(BAD_SPECS))
def test_bad_spec_raises_alike(case):
    ref, port = both(lambda name: encode(
        name, pkg(name, "jobspec").parse(BAD_SPECS[case])))
    assert port == ref
    if case in ("missing_variable", "no_job_block", "syntax",
                "unknown_root", "bad_duration"):
        assert ref[1] is not None and ref[1][0] == "ParseError"


JSON_CASES = {
    "api_shape": lambda name: json.dumps(API_JSON),
    "bare_job": lambda name: API_JSON["Job"],
    "full_spec_wire": lambda name: {"Job": encode(
        name, pkg(name, "jobspec").parse(FULL_SPEC))},
    "unnamed": lambda name: {"ID": "only-id", "TaskGroups": [
        {"Tasks": [{"Name": "t"}]}]},
}


@pytest.mark.parametrize("case", sorted(JSON_CASES))
def test_parse_json_alike(case):
    ref, port = both(lambda name: encode(
        name, pkg(name, "jobspec").parse_json(JSON_CASES[case](name))))
    assert ref[1] is None, ref[1]
    assert port == ref


def test_parse_file_json_alike(tmp_path):
    path = tmp_path / "job.json"
    path.write_text(json.dumps(API_JSON))
    ref, port = both(lambda name: encode(
        name, pkg(name, "jobspec").parse_file(str(path))))
    assert ref[1] is None
    assert port == ref


def test_api_json_canonicalizes_alike():
    obj = {"ID": "x", "TaskGroups": [{"Count": -1, "Tasks": []}]}
    ref, port = both(lambda name: encode(
        name, pkg(name, "jobspec.api_json").job_from_api_dict(dict(obj))))
    assert ref[0]["Name"] == "x"
    assert ref[0]["TaskGroups"][0]["Count"] == 1
    assert port == ref


def test_hcl_to_dict_alike():
    src = 'a = 1\nb { c = "${attr.x}"\n d = [1, 2] }\n'
    ref, port = both(lambda name: pkg(name, "jobspec").hcl_to_dict(src))
    assert ref[1] is None
    assert port == ref


@pytest.mark.parametrize("value", ["30s", "1h30m", "500ms", "2d", 45, None,
                                   "-1m", "1.5h", "", "10 parsecs", "5x"])
def test_parse_duration_alike(value):
    ref, port = both(lambda name: pkg(name, "jobspec")
                     .parse_duration(value, 7.5))
    assert port == ref


# --------------------------------------------------------- agent config

def config_fields(name, src):
    cfg, set_fields = pkg(name, "agent_config").parse_agent_config(src)
    return dataclasses.asdict(cfg), sorted(set_fields)


def test_example_agent_config_parses_alike():
    src = open("examples/agent.hcl").read()
    (ref, ref_set), (port, port_set) = (config_fields(n, src)
                                        for n in PACKAGES)
    assert ref.pop("device_executor") == "jax"
    assert port.pop("device_executor") == "torch"
    assert port == ref
    assert port_set == ref_set
    assert ref["client_count"] == 2 and ref["num_workers"] == 2


def test_load_agent_config_merges_alike(tmp_path):
    a = tmp_path / "a.hcl"
    b = tmp_path / "b.hcl"
    a.write_text(open("examples/agent.hcl").read())
    b.write_text('server { heartbeat_ttl = "5m"\n profile_hz = 0 }\n'
                 'client { count = 3 }\nregion = "eu"\n')
    ref, port = (dataclasses.asdict(pkg(n, "agent_config")
                                    .load_agent_config([str(a), str(b)]))
                 for n in PACKAGES)
    assert ref.pop("device_executor") == "jax"
    assert port.pop("device_executor") == "torch"
    assert port == ref
    assert ref["heartbeat_ttl"] == 300.0 and ref["client_count"] == 3


BAD_AGENT_CONFIGS = {
    "unknown_block": "telemetry { x = 1 }",
    "unknown_server_key": "server { bogus = 1 }",
    "bad_transport": 'server { transport = "udp" }',
    "bad_clock": 'server { clock = "lunar" }',
    "bad_profile_hz": 'server { profile_hz = "fast" }',
    "unknown_slo": "server { slo { nope = 1 } }",
    "bad_log_level": 'log_level = "loud"',
    "bad_worker_mode": 'server { worker_mode = "fiber" }',
}


@pytest.mark.parametrize("case", sorted(BAD_AGENT_CONFIGS))
def test_bad_agent_config_raises_alike(case):
    ref, port = both(lambda name: config_fields(
        name, BAD_AGENT_CONFIGS[case]))
    assert ref[1] is not None
    assert port == ref


def test_device_executor_names():
    """The documented difference: the port takes "torch" and "bridge"
    and rejects "jax"; the reference takes "jax" and "bridge"."""
    parse = {n: pkg(n, "agent_config").parse_agent_config
             for n in PACKAGES}
    ref, port = parse["nomad_tpu"], parse["nomad_tpu_torch"]
    for v in ("torch", "bridge"):
        cfg, _ = port(f'server {{ device_executor = "{v}" }}')
        assert cfg.device_executor == v
    with pytest.raises(ValueError, match="'torch' or 'bridge', got 'jax'"):
        port('server { device_executor = "jax" }')
    assert ref('server { device_executor = "jax" }')[0].device_executor \
        == "jax"
    with pytest.raises(ValueError):
        ref('server { device_executor = "torch" }')
    assert pkg("nomad_tpu_torch", "agent_config").AgentConfig() \
        .device_executor == "torch"
