"""The port's seeded traffic generator (nomad_tpu_torch/chaos/traffic.py)
against the reference's (nomad_tpu/chaos/traffic.py) on the CPU.

Tolerance: exact.  The schedule and the fleet of each seed 0-9 are the
reference's byte for byte (JSON with sorted keys) on five profiles: the
default, the CLI's `soak -quick`, the soak tests' TINY and CHURNY, and a
networked one with node classes.  The reference's tests of the module
(tests/test_traffic.py) run here through both packages, and the retry
discipline (`retry_idempotent`, `FaultyCall`) answers the same call
sequences with the same results, attempts and errors."""

import json

import pytest

from torch_parity import PACKAGES, pkg

PORT, REF = "nomad_tpu_torch", "nomad_tpu"

# the CLI's `soak -quick` (cli.py cmd_soak), at its default flags
QUICK = dict(hours=0.1, n_nodes=4, n_zones=2, service_per_hour=30,
             batch_per_hour=30, drains_per_hour=10,
             flap_storms_per_hour=10, flap_storm_nodes=2,
             preempt_storms_per_hour=10)
# tests/test_soak_sim.py's shrunk profiles
TINY = dict(hours=0.05, n_nodes=4, n_zones=2, service_per_hour=40,
            batch_per_hour=40, drains_per_hour=10,
            flap_storms_per_hour=0, preempt_storms_per_hour=0,
            chaos_scenarios=())
CHURNY = dict(hours=0.1, n_nodes=4, n_zones=2, service_per_hour=30,
              batch_per_hour=30, drains_per_hour=10,
              flap_storms_per_hour=10, flap_storm_nodes=2,
              preempt_storms_per_hour=10, chaos_scenarios=())
NETWORKED = dict(hours=0.5, networked_fraction=0.7,
                 node_classes=("edge", "core"))
PROFILES = {"default": {}, "quick": QUICK, "tiny": TINY, "churny": CHURNY,
            "networked": NETWORKED}

KINDS = {"job.register", "job.deploy", "job.scale", "job.stop",
         "node.drain", "node.restore", "node.flap", "chaos"}


def _blob(events):
    return json.dumps(events, sort_keys=True).encode()


def traffic(name):
    return pkg(name, "chaos.traffic")


@pytest.fixture(params=PACKAGES)
def T(request):
    """The traffic module of each package in turn."""
    return traffic(request.param)


# ------------------------------------------------------------- parity


@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_schedule_and_fleet_equal_reference(profile):
    kw = PROFILES[profile]
    for seed in range(10):
        got = {}
        for name in PACKAGES:
            t = traffic(name)
            p = t.TrafficProfile(**kw)
            got[name] = (_blob(t.generate_schedule(seed, p)),
                         _blob(t.fleet(seed, p)))
        assert got[PORT][0] == got[REF][0], (profile, seed)
        assert got[PORT][1] == got[REF][1], (profile, seed)
        assert len(got[PORT][0]) > 2


def test_profile_defaults_and_ids_equal_reference():
    port, ref = traffic(PORT), traffic(REF)
    assert port.DEFAULT_SCENARIOS == ref.DEFAULT_SCENARIOS
    assert (vars(port.TrafficProfile()) == vars(ref.TrafficProfile()))
    for parts in [("node", 0, 1), ("node", 12, ""), ("x",), ()]:
        assert port.stable_id(*parts) == ref.stable_id(*parts)


def _retry_cases(t):
    """Each case of the retry discipline, as (result, attempts, error,
    side effects, ops issued, verify probes, on_retry calls)."""
    out = []

    def run(op_factory, verify_factory, attempts=4):
        state, probes, retries = [], [], []
        op = op_factory(state)

        def verify():
            probes.append(len(state))
            return verify_factory(state)

        try:
            res, n = t.retry_idempotent(
                op, verify, attempts=attempts,
                on_retry=lambda i, e: retries.append((i, repr(e))))
            err = None
        except Exception as e:  # noqa: BLE001 - compared across packages
            res, n, err = None, None, repr(e)
        calls = getattr(op, "calls", None)
        out.append((res, n, err, list(state), calls, probes, retries))

    run(lambda s: (lambda: 42), lambda s: False)
    run(lambda s: t.FaultyCall(lambda: s.append("x"), fail_first=1),
        lambda s: bool(s))
    run(lambda s: t.FaultyCall(lambda: s.append("x") or "ok",
                               fail_first=2),
        lambda s: False)
    run(lambda s: t.FaultyCall(lambda: s.append("x") or "ok",
                               fail_first=5),
        lambda s: False, attempts=3)

    def flaky(s):
        calls = []

        def op():
            calls.append(1)
            if len(calls) < 3:
                raise ConnectionError("injected: request lost")
            s.append("x")
            return "ok"
        return op
    run(flaky, lambda s: bool(s))

    def down(s):
        def op():
            raise ConnectionError("down")
        return op
    run(down, lambda s: False, attempts=3)
    return out


def test_retry_discipline_equal_reference():
    port, ref = _retry_cases(traffic(PORT)), _retry_cases(traffic(REF))
    assert port == ref
    assert port[1][:2] == (None, 1) and port[1][3] == ["x"]
    assert port[5][2] == repr(ConnectionError("down"))


# ------------------------------------------- twins of tests/test_traffic.py


class TestDeterminism:
    def test_same_seed_byte_identical(self, T):
        p = T.TrafficProfile()
        assert _blob(T.generate_schedule(7, p)) == \
            _blob(T.generate_schedule(7, p))

    def test_different_seed_differs(self, T):
        p = T.TrafficProfile()
        assert _blob(T.generate_schedule(1, p)) != \
            _blob(T.generate_schedule(2, p))

    def test_fleet_stable(self, T):
        p = T.TrafficProfile(n_nodes=5, n_zones=2)
        a, b = T.fleet(3, p), T.fleet(3, p)
        assert a == b
        assert [s["datacenter"] for s in a] == \
            ["dc1", "dc2", "dc1", "dc2", "dc1"]
        assert len({s["id"] for s in a}) == 5

    def test_stable_id_is_not_positional_soup(self, T):
        assert T.stable_id("node", 1, 2) != T.stable_id("node", 12, "")
        assert len(T.stable_id("x")) == 32


class TestScheduleShape:
    @pytest.fixture(autouse=True)
    def _events(self, T):
        self.T = T
        self.p = T.TrafficProfile(hours=1.0)
        self.events = T.generate_schedule(11, self.p)

    def test_sorted_and_known_kinds(self):
        ats = [e["at"] for e in self.events]
        assert ats == sorted(ats)
        assert {e["kind"] for e in self.events} <= KINDS

    def test_mixed_workload_present(self):
        kinds = [e["kind"] for e in self.events]
        regs = [e for e in self.events if e["kind"] == "job.register"]
        assert {e["jtype"] for e in regs} == {"service", "batch",
                                              "system"}
        assert "node.drain" in kinds and "node.flap" in kinds

    def test_drains_paired_with_restores(self):
        drains = [e for e in self.events if e["kind"] == "node.drain"]
        restores = {(e["node"], e["at"])
                    for e in self.events if e["kind"] == "node.restore"}
        assert drains
        for d in drains:
            assert (d["node"], round(d["at"] + d["duration"], 3)) \
                in restores

    def test_chaos_interleaved_inside_active_window(self):
        chaos = [e for e in self.events if e["kind"] == "chaos"]
        assert [e["scenario"] for e in chaos] == \
            list(self.T.DEFAULT_SCENARIOS)
        active_end = self.p.hours * 3600 * (1 - self.p.quiet_tail_frac)
        for e in chaos:
            assert 0 < e["at"] < active_end
            assert e["seed"] == 11 * 1000 + chaos.index(e)

    def test_faults_stay_clear_of_quiet_tail(self):
        active_end = self.p.hours * 3600 * (1 - self.p.quiet_tail_frac)
        for e in self.events:
            if e["kind"] in ("node.drain", "node.flap"):
                assert e["at"] + e["duration"] < active_end

    def test_batch_runtimes_clear_the_tail(self):
        active_end = self.p.hours * 3600 * (1 - self.p.quiet_tail_frac)
        for e in self.events:
            if e["kind"] == "job.register" and "runtime_s" in e \
                    and e["jtype"] == "batch" and \
                    e["job"].startswith("bat-"):
                assert e["at"] + e["runtime_s"] < active_end

    def test_capacity_ledger_bounds_standing_demand(self):
        budget = (self.p.n_nodes * self.p.node_cpu
                  * self.p.capacity_fraction)
        booked = {}
        for e in self.events:
            if e["kind"] == "job.register" and e["jtype"] == "service":
                booked[e["job"]] = e["count"] * e["cpu"]
            elif e["kind"] == "job.scale":
                booked[e["job"]] = e["count"] * e["cpu"]
            elif e["kind"] == "job.stop":
                booked.pop(e["job"], None)
            assert sum(booked.values()) <= budget + 1e-9


class TestRetryIdempotent:
    def test_clean_call_single_attempt(self, T):
        result, n = T.retry_idempotent(lambda: 42, lambda: False)
        assert (result, n) == (42, 1)

    def test_landed_but_reply_lost_is_not_reissued(self, T):
        state = []
        op = T.FaultyCall(lambda: state.append("x"), fail_first=1)
        result, n = T.retry_idempotent(op, lambda: bool(state))
        assert result is None and n == 1
        assert state == ["x"]

    def test_not_landed_reissues_until_success(self, T):
        state = []
        calls = []

        def op():
            calls.append(1)
            if len(calls) < 3:
                raise ConnectionError("injected: request lost")
            state.append("x")
            return "ok"

        result, n = T.retry_idempotent(op, lambda: bool(state))
        assert (result, n) == ("ok", 3)
        assert state == ["x"]

    def test_budget_spent_raises_last_error(self, T):
        def op():
            raise ConnectionError("down")
        with pytest.raises(ConnectionError):
            T.retry_idempotent(op, lambda: False, attempts=3)
