"""The port's virtual-time soak (nomad_tpu_torch/chaos/soak.py) against
the reference's (nomad_tpu/chaos/soak.py) on the CPU.

Each run boots the package's own Agent on a VirtualClock and drives the
seeded traffic through its HTTP API; the port's Agent runs on
`device="cpu"`, the reference's engine on one device (`one_device`), and
ids are pinned before each package's run (`pinned`).  Tolerance: exact.

- TINY seed 1 (tests/test_soak_sim.py's profile): both green, and the
  canonical trace (bytes and digest), the converged fingerprint, the
  timeline's canonical dump and digest, the evals enqueued and the
  schedule's length equal.  The summary's keys are the reference's.
- CHURNY seed 3: both green; the canonical trace, the fingerprint and
  the schedule's length equal, and the timeline's canonical dump but for
  the `drain.complete` annotations' times.  A drain completes on the
  client sweep after its node's last alloc stops, and thread timing moves
  that by one sweep interval (8 virtual s) in the reference itself: nine
  runs of the reference's CHURNY seed 3 beside each other gave
  `drain.complete` at 186.24 in seven and 194.24 in two, with two
  timeline digests (tests/test_timeline.py keeps drains out of its
  byte-identity profile for that reason).  The evals enqueued are not
  compared: heartbeat expiry and node updates race the sweep, and the
  reference's own runs of this profile enqueued 42 to 46.
- The port replays TINY seed 1 byte for byte.
- The default profile (2 virtual hours, two chaos scenarios interleaved)
  is the `slow` twin of the reference's acceptance run.

The port's one difference, the `device` of its Agent and of the chaos
scenarios' servers, has tests of its own."""

import json
from types import SimpleNamespace

import pytest

from torch_parity import PACKAGES, one_device, pinned, pkg  # noqa: F401

PORT, REF = "nomad_tpu_torch", "nomad_tpu"

TINY = dict(hours=0.05, n_nodes=4, n_zones=2, service_per_hour=40,
            batch_per_hour=40, drains_per_hour=10,
            flap_storms_per_hour=0, preempt_storms_per_hour=0,
            chaos_scenarios=())
CHURNY = dict(hours=0.1, n_nodes=4, n_zones=2, service_per_hour=30,
              batch_per_hour=30, drains_per_hour=10,
              flap_storms_per_hour=10, flap_storm_nodes=2,
              preempt_storms_per_hour=10, chaos_scenarios=())

SUMMARY_KEYS = {"seed", "soak_virtual_hours", "soak_evals",
                "soak_breaches", "converged_fingerprint",
                "trace_digest", "schedule_events", "wall_s",
                "compression_x", "p99_plan_queue_ms", "quality", "ok",
                "timeline_points", "timeline_annotations",
                "timeline_overhead_fraction", "timeline_evictions",
                "timeline_digest", "rss_bytes", "rss_peak_bytes",
                "journal_bytes", "journal_entries",
                "journal_compactions", "journal_bytes_reclaimed",
                "journal_floor_fallbacks", "ring_evictions",
                "mem_scrape_us", "mem_overhead_fraction"}

_RUNS = {}


def soak(name, profile, seed, pinned, again=False):
    """run_soak of package `name` on `profile` at `seed`, ids pinned to
    the seed; kept per (name, profile, seed) unless `again`."""
    key = (name, json.dumps(profile, sort_keys=True), seed)
    if again or key not in _RUNS:
        pinned(seed)
        traffic = pkg(name, "chaos.traffic")
        kw = {"device": "cpu"} if name == PORT else {}
        r = pkg(name, "chaos.soak").run_soak(
            seed=seed, profile=traffic.TrafficProfile(**profile), **kw)
        if again:
            return r
        _RUNS[key] = r
    return _RUNS[key]


def _timeline(r, drop_drain_times=False):
    doc = json.loads(json.dumps(r.timeline_canonical, sort_keys=True))
    if drop_drain_times:
        for a in doc["Annotations"]:
            if a["Kind"] == "drain.complete":
                a.pop("T")
        doc["Annotations"].sort(key=lambda a: json.dumps(a,
                                                         sort_keys=True))
    return doc


def test_tiny_soak_equals_reference(pinned, one_device):
    runs = {name: soak(name, TINY, 1, pinned) for name in PACKAGES}
    for name, r in runs.items():
        assert r.ok, (name, r.violations)
        assert r.summary["soak_breaches"] == 0
        assert set(r.summary) == SUMMARY_KEYS
        assert r.summary["converged_fingerprint"] == r.fingerprint
    port, ref = runs[PORT], runs[REF]
    assert port.trace.canonical_bytes() == ref.trace.canonical_bytes()
    for k in ("trace_digest", "converged_fingerprint", "timeline_digest",
              "soak_evals", "schedule_events", "ok",
              "soak_virtual_hours", "timeline_points",
              "timeline_annotations", "timeline_evictions", "quality",
              "p99_plan_queue_ms"):
        assert port.summary[k] == ref.summary[k], k
    assert _timeline(port) == _timeline(ref)
    assert port.summary["soak_evals"] > 0
    assert port.summary["quality"]["nodes_in_use"] > 0


def test_churny_soak_equals_reference(pinned, one_device):
    runs = {name: soak(name, CHURNY, 3, pinned) for name in PACKAGES}
    for name, r in runs.items():
        assert r.ok, (name, r.violations)
        assert r.summary["soak_breaches"] == 0
        lines = r.trace.canonical_lines()
        assert any(ln.startswith("verdict ") for ln in lines)
        assert any(ln.startswith("slo ") for ln in lines)
    port, ref = runs[PORT], runs[REF]
    assert port.trace.canonical_bytes() == ref.trace.canonical_bytes()
    for k in ("trace_digest", "converged_fingerprint", "schedule_events",
              "ok", "soak_virtual_hours", "timeline_annotations"):
        assert port.summary[k] == ref.summary[k], k
    assert (_timeline(port, drop_drain_times=True)
            == _timeline(ref, drop_drain_times=True))


def test_summary_keys_equal_reference(pinned, one_device):
    keys = {name: set(soak(name, TINY, 1, pinned).summary)
            for name in PACKAGES}
    assert keys[PORT] == keys[REF] == SUMMARY_KEYS
    assert (pkg(PORT, "chaos.soak").SOAK_SLO
            == pkg(REF, "chaos.soak").SOAK_SLO)


def test_same_seed_byte_identical_in_port(pinned):
    a = soak(PORT, TINY, 1, pinned)
    b = soak(PORT, TINY, 1, pinned, again=True)
    assert a.ok and b.ok, (a.violations, b.violations)
    assert a.digest == b.digest
    assert a.fingerprint == b.fingerprint
    assert a.trace.canonical_bytes() == b.trace.canonical_bytes()
    assert _timeline(a) == _timeline(b)
    assert a.summary["timeline_digest"] == b.summary["timeline_digest"]
    assert a.summary["soak_evals"] == b.summary["soak_evals"]


def _fp_store(name, node_for_alloc, n_allocs=2):
    """tests/test_soak_sim.py's coarse-fingerprint store, explicit ids."""
    mock = pkg(name, "mock")
    s = pkg(name, "state").StateStore()
    nodes = []
    for i in range(2):
        n = mock.node(id=f"fp-node-{i}", name=f"fp-n{i}")
        nodes.append(n)
        s.upsert_node(n)
    job = mock.job()
    job.id = "fp-job"
    s.upsert_job(job)
    for k in range(n_allocs):
        a = mock.alloc()
        a.id = f"fp-alloc-{k}"
        a.job_id = job.id
        a.namespace = job.namespace
        a.task_group = job.task_groups[0].name
        a.node_id = nodes[node_for_alloc(k)].id
        a.client_status = "running"
        s.upsert_allocs([a])
    return s.snapshot()


def test_coarse_fingerprint_equal_reference():
    def run(name):
        fp = pkg(name, "chaos.soak").coarse_fingerprint
        return (fp(_fp_store(name, lambda k: 0)),
                fp(_fp_store(name, lambda k: k % 2)),
                fp(_fp_store(name, lambda k: 0, n_allocs=3)))
    port, ref = (run(name) for name in (PORT, REF))
    assert port == ref
    assert port[0] == port[1] != port[2]


class _Stop(Exception):
    pass


@pytest.fixture
def restore_clocks():
    """The soak binds the wire codec to its VirtualClock before it boots
    the Agent; a run stopped there leaves it bound."""
    yield
    from nomad_tpu_torch.chaos.clock import SystemClock
    from nomad_tpu_torch.core import wire
    from nomad_tpu_torch.core.obsbus import OBSBUS
    wire.set_clock(SystemClock())
    OBSBUS.configure(SystemClock())


def test_soak_agent_and_scenarios_get_the_device(monkeypatch,
                                                 restore_clocks):
    """The port's difference: `run_soak(..., device=...)` builds its
    Agent on that device and runs the interleaved chaos scenarios on it;
    the default is None, which the port's Server takes as CUDA."""
    soak_mod = pkg(PORT, "chaos.soak")
    agent_mod = pkg(PORT, "agent")
    scen_mod = pkg(PORT, "chaos.scenarios")
    traffic = pkg(PORT, "chaos.traffic")
    seen = {}

    def fake_agent(**kw):
        seen["agent"] = kw["device"]
        raise _Stop

    monkeypatch.setattr(agent_mod, "Agent", fake_agent)
    with pytest.raises(_Stop):
        soak_mod.run_soak(seed=1, profile=traffic.TrafficProfile(**TINY),
                          device="cpu")
    assert seen == {"agent": "cpu"}
    assert soak_mod.SoakRunner().device is None

    def fake_scenario(name, seed=0, schedule=None, device=None):
        seen["scenario"] = (name, seed, device)
        return SimpleNamespace(ok=True, violations=[], fingerprint="f",
                               trace=pkg(PORT, "chaos.trace").Trace())

    monkeypatch.setattr(scen_mod, "run_scenario", fake_scenario)
    runner = soak_mod.SoakRunner(seed=1, device="cpu")
    runner.clock = pkg(PORT, "chaos.clock").VirtualClock()
    runner.agent = SimpleNamespace(server=SimpleNamespace(
        health=SimpleNamespace(rebase=lambda: None)))
    runner._run_chaos({"at": 5.0, "kind": "chaos",
                       "scenario": "leader_partition", "seed": 1000})
    assert seen["scenario"] == ("leader_partition", 1000, "cpu")
    assert runner.trace.canonical_lines()[-1].startswith("chaos_result ")
    runner.clock.close()


def test_soak_default_device_needs_cuda(restore_clocks):
    import threading

    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present; chip_smoke.py's soak phase runs "
                    "the soak there")
    traffic = pkg(PORT, "chaos.traffic")
    threads = threading.active_count()
    with pytest.raises(RuntimeError, match="CUDA"):
        pkg(PORT, "chaos.soak").run_soak(
            seed=1, profile=traffic.TrafficProfile(**TINY))
    assert threading.active_count() == threads


@pytest.mark.slow
def test_default_profile_two_virtual_hours_equals_reference(pinned,
                                                            one_device):
    """The reference's acceptance run through both packages: two virtual
    hours, twelve nodes in three datacenters, leader_partition and
    gossip_flap_storm interleaved; both green, the canonical trace and
    the converged fingerprint equal."""
    runs = {name: soak(name, {}, 0, pinned) for name in PACKAGES}
    for name, r in runs.items():
        assert r.ok, (name, r.violations)
        assert r.summary["soak_virtual_hours"] >= 2.0
        assert r.summary["soak_breaches"] == 0
        chaos = [ln for ln in r.trace.canonical_lines()
                 if ln.startswith("chaos_result ")]
        assert len(chaos) == 2
    port, ref = runs[PORT], runs[REF]
    assert port.trace.canonical_bytes() == ref.trace.canonical_bytes()
    assert port.summary["trace_digest"] == ref.summary["trace_digest"]
    assert port.fingerprint == ref.fingerprint
