"""The port's observability planes (nomad_tpu_torch/core/{obsbus,
telemetry,memledger,logging,profiling,timeline,flightrec,identity}.py)
against the reference's: the same seeded inputs go into a fresh
instance of each package's class, on each package's own VirtualClock,
and the documents that come out must be equal.  The only differences
are the two that the port's profiling.py lists in its docstring (the
device-wait frames, and torch.profiler in place of jax.profiler).
No test here reads the wall clock or asserts a rate or a duration."""

import importlib
import json
import threading
import types

import numpy as np
import pytest

PACKAGES = ("nomad_tpu", "nomad_tpu_torch")
PORT = "nomad_tpu_torch"
PLANES = ["flightrec", "identity", "logging", "memledger", "profiler",
          "telemetry", "timeline", "tracer"]
SCHEMAS = {"memledger": "nomad-tpu.memory.v1",
           "timeline": "nomad-tpu.timeline.v1",
           "profiling": "nomad-tpu.profile.v1"}


def core(name, sub):
    return importlib.import_module(f"{name}.core.{sub}")


def vclock(name, start=0.0):
    clock = importlib.import_module(f"{name}.chaos.clock")
    return clock.VirtualClock(start=start, epoch=1.7e9)


def both(fn):
    """fn(package name) for the reference and the port."""
    return [fn(name) for name in PACKAGES]


# --------------------------------------------------------------- telemetry

def _metric_ops(seed, n=400):
    rng = np.random.default_rng(seed)
    names = ["nomad.broker.acked", "nomad.plan.queue_wait_s",
             "nomad.executor.uploads", "nomad.worker.wave_s"]
    ops = []
    for _ in range(n):
        kind = ["inc", "gauge", "observe", "windowed", "advance",
                "span"][int(rng.integers(6))]
        name = names[int(rng.integers(len(names)))]
        labels = ({} if rng.random() < 0.5
                  else {"cause": ["a", "b"][int(rng.integers(2))]})
        ops.append((kind, name, float(rng.exponential(0.05)),
                    int(rng.integers(1, 5)), labels,
                    f"trace-{int(rng.integers(6)):04d}"))
    return ops


def _run_telemetry(name, ops):
    tel = core(name, "telemetry")
    clock = vclock(name)
    reg = tel.MetricsRegistry(clock=clock, window_s=10.0, window_subs=5)
    tracer = tel.Tracer(clock=clock, max_spans=64)
    for kind, metric, value, k, labels, tid in ops:
        if kind == "inc":
            reg.inc(metric, k, **labels)
        elif kind == "gauge":
            reg.set_gauge(metric, value, **labels)
        elif kind == "observe":
            reg.observe(metric, value, **labels)
        elif kind == "windowed":
            reg.observe_windowed(metric, value, **labels)
        elif kind == "advance":
            clock.advance(value * 20)
        else:
            with tracer.span(f"s{k}", tid, parent=None if k == 1
                             else tel.span_id(tid, "s1"), n=k):
                clock.advance(value)
    names = sorted({op[1] for op in ops})
    return {
        "snapshot": reg.snapshot(),
        "prometheus": reg.prometheus(),
        "histograms": {m: reg.histogram(m) for m in names},
        "windows": {m: reg.window_summary(m) for m in names},
        "sums": {m: reg.counter_sum(m) for m in names},
        "labels": {m: reg.counter_labels(m) for m in names},
        "spans": tracer.spans(),
        "traces": tracer.traces(),
        "trace": tracer.trace("trace-0001"),
        "dropped": tracer.dropped,
        "mem": (reg.mem_stats(), tracer.mem_stats()["entries"]),
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_telemetry_matches_reference(seed):
    ops = _metric_ops(seed)
    ref, port = both(lambda name: _run_telemetry(name, ops))
    assert ref == port
    assert port["traces"] and port["snapshot"]["windows"]


def test_histogram_quantiles_match_reference():
    rng = np.random.default_rng(5)
    values = rng.lognormal(-5, 2, size=500).tolist()

    def run(name):
        tel = core(name, "telemetry")
        h = tel.Histogram()
        w = tel.WindowedHistogram(window_s=6.0, n_sub=3)
        for i, v in enumerate(values):
            h.observe(v)
            w.observe(v, now=i * 0.05)
        return ([h.quantile(q) for q in (0.1, 0.5, 0.9, 0.99)],
                h.summary(), w.summary(now=25.0), w.rotations)

    assert both(run)[0] == both(run)[1]


@pytest.mark.parametrize("args", [("0123456789abcdef", "worker.schedule"),
                                  ("t", "broker"), ("", "x")])
def test_span_id_matches_reference(args):
    ref, port = both(lambda name: core(name, "telemetry").span_id(*args))
    assert ref == port


def test_stat_counters_two_threads_match_reference():
    def run(name):
        tel = core(name, "telemetry")
        reg = tel.MetricsRegistry(clock=vclock(name))
        stats = tel.StatCounters("nomad.test", ["a", "b"], registry=reg)

        def work():
            for _ in range(2000):
                stats.inc("a")
                stats.inc("b", 2)

        threads = [threading.Thread(target=work) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        stats["peak"] = 7
        return (dict(stats.items()), reg.counter("nomad.test.a"),
                reg.counter("nomad.test.b"), "peak" in stats, len(stats))

    ref, port = both(run)
    assert ref == port
    assert port[0] == {"a": 4000, "b": 8000, "peak": 7}


# ---------------------------------------------------------------- timeline

def _run_timeline(name, seed):
    tel = core(name, "telemetry")
    tlm = core(name, "timeline")
    clock = vclock(name, start=90.0)
    reg = tel.MetricsRegistry(clock=clock)
    tl = tlm.Timeline(clock=clock, registry=reg, step_s=1.0)
    tl.reset()
    rng = np.random.default_rng(seed)
    kinds = ["traffic.node.flap", "traffic.job.deploy", "chaos.partition",
             "executor.invalidation"]
    for step in range(40):
        reg.inc("nomad.broker.acked", int(rng.integers(0, 50)))
        reg.inc("nomad.plan.plans", int(rng.integers(1, 9)))
        reg.inc("nomad.plan.plans_refuted", int(rng.integers(0, 2)))
        if step in (12, 13, 14):
            reg.inc("nomad.heartbeat.missed", 5)
        reg.observe_windowed("nomad.plan.queue_wait_s",
                             float(rng.exponential(0.01))
                             * (30 if step == 25 else 1))
        reg.set_gauge("nomad.quality.nodes_in_use",
                      float(rng.integers(10, 20)))
        reg.set_gauge("nomad.quality.binpack_fill", float(rng.random()),
                      dimension="cpu")
        if rng.random() < 0.3:
            tl.annotate(kinds[int(rng.integers(len(kinds)))], node="n1",
                        step=step)
        if step == 14:
            tl.annotate("health.breach", rule="heartbeat_misses",
                        observed=5.0, threshold=0.0)
        if step == 20:
            tl.annotate("health.recover", rule="heartbeat_misses")
        clock.advance(1.0)
        tl.sample(settled=True)
    series = list(tlm.CANONICAL_SERIES + tlm.VOLATILE_SERIES)
    query = tl.query(series=series)
    query["Stats"].pop("sample_s")          # host self-metering
    report = tlm.build_report(query)
    return {
        "schemas": (tlm.SCHEMA, tlm.REPORT_SCHEMA),
        "canonical": json.dumps(tl.canonical_dump(), sort_keys=True),
        "digest": tl.canonical_digest(),
        "query": json.dumps(query, sort_keys=True),
        "slice": json.dumps(_strip_wall({"Timeline": tl.slice(95.0, 120.0)}),
                            sort_keys=True),
        "delta": json.dumps(tl.export_delta(since_seq=10), sort_keys=True),
        "report": json.dumps(report, sort_keys=True),
        "markdown": tlm.render_report_md(report),
        "spark": tlm.sparkline([1.0, None, 3.0, 2.0] * 10, width=16),
        "window": tl.window(),
    }


@pytest.mark.parametrize("seed", [3, 4])
def test_timeline_matches_reference(seed):
    ref, port = both(lambda name: _run_timeline(name, seed))
    assert ref == port
    assert port["schemas"] == (SCHEMAS["timeline"],
                               "nomad-tpu.timeline-report.v1")
    assert "heartbeat_misses" in port["markdown"]


# --------------------------------------------------------------- flightrec

# the dump sections the reference calls wall facts: the sampler's brief
# (real clock) and the memory ledger's document (RSS)
_WALL_DUMP_KEYS = ("Profiler", "Memory")


def _strip_wall(doc):
    doc = {k: v for k, v in doc.items() if k not in _WALL_DUMP_KEYS}
    tl = doc.get("Timeline")
    if tl is not None:
        tl = dict(tl, Series={k: v for k, v in tl["Series"].items()
                              if k != "gil_wait_fraction"})
        doc["Timeline"] = tl
    for key in ("Verdicts", "Rules", "Breaches"):
        if isinstance(doc.get(key), list):
            doc[key] = [dict(v, Observed=None) if v["Rule"] == "rss_mb"
                        else v for v in doc[key]]
    return doc


def _run_flight(name, seed):
    tel = core(name, "telemetry")
    fr = core(name, "flightrec")
    tlm = core(name, "timeline")
    clock = vclock(name)
    reg = tel.MetricsRegistry(clock=clock)
    tracer = tel.Tracer(clock=clock)
    flight = fr.FlightRecorder(clock=clock, max_waves=16, max_evals=32,
                               max_events=8)
    timeline = tlm.Timeline(clock=clock, registry=reg)
    dog = fr.HealthWatchdog(slo={"refute_rate": 0.2,
                                 "invalidations_per_s": 0.5,
                                 "heartbeat_misses": 3.0},
                            clock=clock, registry=reg, flight=flight,
                            tracer=tracer, log_ring=None,
                            timeline=timeline)
    rng = np.random.default_rng(seed)
    docs = []
    for step in range(30):
        wave = int(rng.integers(0, 24))
        flight.record_wave(wave, device_s=float(rng.random()),
                           evals=int(rng.integers(1, 9)), chained=True)
        flight.record_eval(f"eval-{int(rng.integers(0, 48)):03d}",
                           latency_s=float(rng.random()), ok=True)
        reg.inc("nomad.plan.plans", int(rng.integers(1, 6)))
        reg.inc("nomad.plan.plans_refuted",
                int(rng.integers(0, 4)) if step > 15 else 0)
        if step % 7 == 3:
            reg.inc("nomad.executor.invalidations", 9, reason="node-write")
            flight.record_event("executor.invalidation",
                                reason="node-write")
        reg.inc("nomad.heartbeat.missed", 5 if step in (10, 11) else 0)
        reg.observe_windowed("nomad.plan.queue_wait_s",
                             float(rng.exponential(0.2)))
        tracer.record("worker.schedule", f"trace-{step:04d}",
                      clock.monotonic(), clock.monotonic() + 0.01)
        clock.advance(float(rng.uniform(1.0, 6.0)))
        doc = dog.tick()
        if doc is not None:
            docs.append(_strip_wall(doc))
    return {
        "slo": fr.DEFAULT_SLO,
        "rings": flight.snapshot(),
        "ring_n": flight.snapshot(n_waves=3, n_evals=2, n_events=1),
        "docs": docs,
        "stats": dog.stats,
        "dumps": [json.dumps(_strip_wall(d), sort_keys=True)
                  for d in dog.dumps()],
        "breach_events": [e for e in flight.events()
                          if e["Kind"] == "health.breach"],
        "annotations": json.dumps(timeline.canonical_dump(),
                                  sort_keys=True),
        "gauges": (reg.gauge("nomad.health.healthy"),
                   reg.counter("nomad.health.breaches")),
    }


@pytest.mark.parametrize("seed", [5, 6])
def test_flightrec_and_watchdog_match_reference(seed):
    ref, port = both(lambda name: _run_flight(name, seed))
    assert ref == port
    assert port["stats"]["breaches"] > 0 and port["breach_events"]


def test_watchdog_refuses_unknown_slo_like_reference():
    for name in PACKAGES:
        fr = core(name, "flightrec")
        with pytest.raises(ValueError, match="unknown slo setting"):
            fr.HealthWatchdog(slo={"p100": 1.0}, clock=vclock(name),
                              registry=core(name, "telemetry")
                              .MetricsRegistry(), log_ring=None)


# --------------------------------------------------------------- memledger

def _store_writes(name, seed):
    mock = importlib.import_module(f"{name}.mock")
    store = importlib.import_module(f"{name}.state").StateStore()
    rng = np.random.default_rng(seed)
    nodes = [mock.node(id=f"node-{i:04d}") for i in range(20)]
    store.upsert_nodes(nodes)
    for i in range(6):
        job = mock.batch_job(id=f"job-{i:02d}")
        job.task_groups[0].count = int(rng.integers(1, 9))
        store.upsert_job(job)
    return store


@pytest.mark.parametrize("seed", [0, 1])
def test_memledger_scrape_matches_reference(seed, monkeypatch):
    def run(name):
        tel = core(name, "telemetry")
        ml = core(name, "memledger")
        # the scrape publishes gauges on telemetry.REGISTRY: a fresh one
        reg = tel.MetricsRegistry(clock=vclock(name))
        monkeypatch.setattr(tel, "REGISTRY", reg)
        ledger = ml.MemLedger(clock=vclock(name), interval_s=5.0)
        store = _store_writes(name, seed)
        ledger.register("state", store.mem_stats)
        ledger.register("registry", reg.mem_stats)
        ledger.register("broken", lambda: 1 / 0)
        docs = [ledger.scrape() for _ in range(3)]
        sampled = [ledger.sample(now) for now in (0.0, 1.0, 10.0)]
        for d in docs:
            for key in ("RSSBytes", "RSSPeakBytes", "ScrapeMicros",
                        "ScrapeMeanMicros", "ScrapeTotalSeconds"):
                d.pop(key)
        gauges = {k: v for k, v in reg.snapshot()["gauges"].items()
                  if "rss" not in k and "scrape_us" not in k}
        return (docs, ledger.planes(), ledger.evictions(), gauges,
                sampled[0], ml.SCHEMA)

    ref, port = both(run)
    assert ref[:4] == port[:4]
    assert port[4] is True and port[5] == SCHEMAS["memledger"]
    assert "error" in port[0][0]["Planes"]["broken"]


@pytest.mark.parametrize("obj", [
    {"a": [1, 2, 3], "b": "x" * 40},
    [(i, str(i)) for i in range(50)],
    {"nested": {"deep": {"deeper": list(range(20))}}},
])
def test_approx_sizeof_matches_reference(obj):
    ref, port = both(lambda name: core(name, "memledger").approx_sizeof(obj))
    assert ref == port


# ----------------------------------------------------------------- logging

def test_log_ring_matches_reference(monkeypatch):
    def run(name):
        lg = core(name, "logging")
        tel = core(name, "telemetry")
        reg = tel.MetricsRegistry(clock=vclock(name))
        monkeypatch.setattr(lg, "REGISTRY", reg)
        ring = lg.LogRing(size=16)
        ring.clock = vclock(name, start=5.0)
        ring.min_level = "debug"
        rng = np.random.default_rng(9)
        sub = ring.subscribe(maxsize=4)
        for i in range(40):
            level = ["trace", "debug", "info", "warn", "error"][
                int(rng.integers(5))]
            if i % 3 == 0:
                with lg.trace_scope(f"trace-{i:03d}"):
                    with lg.trace_scope(""):
                        ring.log("worker", level, f"msg {i}", i=i)
            else:
                ring.log("applier", level, f"msg {i}", i=i,
                         **({"trace_id": "own"} if i % 5 == 0 else {}))
            ring.clock.advance(0.5)
        got = []
        while not sub.empty():
            got.append(sub.get_nowait())
        ring.unsubscribe(sub)
        return (ring.tail(100), ring.tail(5, min_level="warn"), got,
                reg.counter_labels("nomad.logring.dropped"),
                lg.current_trace(), sorted(lg.LEVELS.items()))

    ref, port = both(run)
    assert ref == port
    assert any("trace_id" in r for r in port[0])


# ---------------------------------------------------------------- identity

CLAIMS = [dict(namespace="default", job_id="web", alloc_id="a-1",
               task="nginx"),
          dict(namespace="prod", job_id="batch-7", alloc_id="a-2",
               task="t", ttl_s=60.0)]


@pytest.mark.parametrize("claims", CLAIMS)
def test_identity_matches_reference(claims, monkeypatch):
    mods = {name: core(name, "identity") for name in PACKAGES}
    for name, m in mods.items():
        monkeypatch.setattr(m, "_CLOCK", vclock(name, start=30.0))
    tokens = {name: m.mint("s3cret", **claims) for name, m in mods.items()}
    assert tokens["nomad_tpu"] == tokens[PORT]
    explicit = {name: m.mint("s3cret", now=1.7e9 + 5, **claims)
                for name, m in mods.items()}
    assert explicit["nomad_tpu"] == explicit[PORT]
    # a token from one package verifies in the other, and is refused
    # by both under another secret or after its expiry
    for a in PACKAGES:
        for b in PACKAGES:
            got = mods[b].verify("s3cret", tokens[a])
            assert got == mods[a].verify("s3cret", tokens[a])
            assert got["nomad_job_id"] == claims["job_id"]
            assert mods[b].verify("other", tokens[a]) is None
    late = 1.7e9 + 30.0 + 61.0
    assert (mods[PORT].verify("s3cret", tokens[PORT], now=late) is None) \
        == ("ttl_s" in claims)
    assert mods["nomad_tpu"].variable_prefix("web") == \
        mods[PORT].variable_prefix("web")
    assert mods[PORT].IDENTITY_PREFIX == mods["nomad_tpu"].IDENTITY_PREFIX


# --------------------------------------------------------------- profiling

def _frames(stack):
    """A synthetic sampled stack, innermost first: (filename, name)."""
    f = None
    for fn, name in reversed(stack):
        f = types.SimpleNamespace(
            f_code=types.SimpleNamespace(co_filename=fn, co_name=name),
            f_back=f)
    return f


STACKS = {
    "lock": [("/usr/lib/python3/threading.py", "acquire"),
             ("/app/core/worker.py", "run")],
    "idle_queue": [("/usr/lib/python3/threading.py", "wait"),
                   ("/usr/lib/python3/queue.py", "get")],
    "contended": [("/usr/lib/python3/threading.py", "wait"),
                  ("/usr/lib/python3/threading.py", "acquire"),
                  ("/app/core/plan_apply.py", "apply")],
    "event_wait": [("/usr/lib/python3/threading.py", "wait"),
                   ("/app/core/server.py", "tick")],
    "clock": [("/app/chaos/clock.py", "sleep")],
    "wire": [("/usr/lib/python3/json/encoder.py", "encode"),
             ("/app/api/http.py", "serve")],
    "host": [("/app/ops/engine.py", "build_multi_inputs"),
             ("/app/core/worker.py", "run")],
}
# the frames in which each package waits for its device
PORT_WAITS = {
    "event": [("/site-packages/torch/cuda/streams.py", "synchronize"),
              ("/app/nomad_tpu_torch/ops/engine.py", "collect_batch")],
    "fetch": [("/app/nomad_tpu_torch/ops/engine.py", "_fetch"),
              ("/app/nomad_tpu_torch/ops/engine.py", "place")],
    "device_sync": [("/site-packages/torch/cuda/__init__.py",
                     "synchronize")],
}
REF_WAITS = {
    "ready": [("/site-packages/jax/_src/array.py", "block_until_ready")],
    "to_numpy": [("/site-packages/jax/_src/array.py",
                  "_single_device_array_to_np_array")],
}


@pytest.mark.parametrize("case", sorted(STACKS))
def test_classify_stack_matches_reference(case):
    ref, port = both(lambda name: core(name, "profiling").classify_stack(
        _frames(STACKS[case])))
    assert ref == port


@pytest.mark.parametrize("case", sorted(PORT_WAITS))
def test_port_device_wait_frames(case):
    """The port's waits land in device-wait; the reference, which knows
    only JAX's frames, files them as host (profiling.py's docstring)."""
    frames = _frames(PORT_WAITS[case])
    assert core(PORT, "profiling").classify_stack(frames) == "device-wait"
    assert core("nomad_tpu", "profiling").classify_stack(frames) == "host"


@pytest.mark.parametrize("case", sorted(REF_WAITS))
def test_reference_device_wait_frames_are_not_the_ports(case):
    frames = _frames(REF_WAITS[case])
    assert core("nomad_tpu", "profiling").classify_stack(frames) == \
        "device-wait"
    assert core(PORT, "profiling").classify_stack(frames) == "host"


@pytest.mark.parametrize("thread", ["worker-3", "plan-applier", "raft-x",
                                    "http-api-1", "pool-2", "MainThread",
                                    "chaos-net", "server-tick"])
def test_role_of_matches_reference(thread):
    ref, port = both(lambda name: core(name, "profiling").role_of(thread))
    assert ref == port


def test_compile_ledger_matches_reference():
    rng = np.random.default_rng(11)
    notes = [(["hit", "miss", "steady"][int(rng.integers(3))],
              f"engine.multi/{int(rng.integers(3))}x300",
              float(rng.random())) for _ in range(60)]

    def run(name):
        led = core(name, "profiling").CompileLedger()
        for kind, site, s in notes:
            if kind == "hit":
                led.note_hit(site)
            elif kind == "miss":
                led.note_miss(site, s)
            else:
                led.note_steady(site, s)
        snap = led.snapshot()
        led.reset()
        return snap, led.snapshot()

    ref, port = both(run)
    assert ref == port
    assert port[0]["misses"] and port[1]["sites"] == {}


def test_activity_markers_match_reference():
    def run(name):
        prof = core(name, "profiling")
        seen = [prof.current_activity()]
        with prof.activity("device-wait"):
            seen.append(prof.current_activity())
            seen.append(prof._MARKS.get(threading.get_ident()))
            with prof.activity("queue-wait"):
                seen.append(prof.current_activity())
            seen.append(prof._MARKS.get(threading.get_ident()))
        seen.append(prof.current_activity())
        seen.append(threading.get_ident() in prof._MARKS)
        return seen, prof.BUCKETS, prof.SCHEMA

    ref, port = both(run)
    assert ref == port
    assert port[0] == [None, "device-wait", "device-wait", "queue-wait",
                       "device-wait", None, False]


def test_sampler_buckets_match_reference():
    """One sample of a thread parked under a device-wait marker and one
    holding a lock, taken synchronously (no sampler thread, no rate)."""
    def run(name):
        prof = core(name, "profiling")
        go, done = threading.Event(), threading.Event()
        lock = threading.Lock()

        def marked():
            with prof.activity("device-wait"):
                go.set()
                done.wait()

        def locked():
            with lock:
                pass

        lock.acquire()
        threads = [threading.Thread(target=marked, name="worker-1"),
                   threading.Thread(target=locked, name="plan-applier")]
        try:
            for t in threads:
                t.start()
            go.wait()
            sampler = prof.SamplingProfiler(hz=10.0)
            sampler._sample_once()
            roles = sampler.snapshot()["roles"]
        finally:
            lock.release()
            done.set()
            for t in threads:
                t.join()
        return roles.get("worker"), sorted(roles)

    ref, port = both(run)
    assert ref[0] == port[0] == {"device-wait": 1.0}


def test_capture_bundle_carries_torch_trace(tmp_path):
    """A capture with a device trace: a torch.profiler window exported
    as a Chrome trace into the capture's directory (the reference's
    jax.profiler glue, ported); the sampler it started is stopped."""
    prof = core(PORT, "profiling")
    sampler = prof.SamplingProfiler(hz=50.0)
    try:
        bundle = sampler.capture(duration_s=0.05, include_trace=True,
                                 trace_dir=str(tmp_path))
    finally:
        sampler.stop()
    assert not sampler.running
    assert bundle["schema"] == SCHEMAS["profiling"]
    assert "jax_trace" not in bundle
    trace = bundle["torch_trace"]
    assert trace["ok"], trace
    assert trace["activities"][0] == "CPU"
    assert (tmp_path / "trace.json").exists()
    assert set(bundle["buckets"]) == set(prof.BUCKETS)
    assert sampler.get_capture(bundle["id"]) is bundle


# ------------------------------------------------------------------ obsbus

def test_obsbus_planes_match_reference():
    for sub in ("telemetry", "memledger", "logging", "profiling",
                "timeline", "flightrec", "identity"):
        core(PORT, sub)
        core("nomad_tpu", sub)
    port_bus = core(PORT, "obsbus").OBSBUS
    ref_bus = core("nomad_tpu", "obsbus").OBSBUS
    assert port_bus.planes() == PLANES
    assert set(PLANES) <= set(ref_bus.planes())
    assert port_bus is not ref_bus
    assert core(PORT, "telemetry").REGISTRY is not \
        core("nomad_tpu", "telemetry").REGISTRY


def test_obsbus_configure_reaches_every_plane():
    tel = core(PORT, "telemetry")
    fr = core(PORT, "flightrec")
    tlm = core(PORT, "timeline")
    lg = core(PORT, "logging")
    ident = core(PORT, "identity")
    ml = core(PORT, "memledger")
    bus = core(PORT, "obsbus").OBSBUS
    reads = {
        "telemetry": lambda: tel.REGISTRY.clock,
        "tracer": lambda: tel.TRACER.clock,
        "flightrec": lambda: fr.FLIGHT.clock,
        "timeline": lambda: tlm.TIMELINE.clock,
        "logging": lambda: lg.RING.clock,
        "identity": lambda: ident._CLOCK,
        "memledger": lambda: ml.MEMLEDGER._clock,
    }
    before = {k: r() for k, r in reads.items()}
    clock = vclock(PORT)
    try:
        bus.configure(clock)
        assert {k: r() for k, r in reads.items()} == \
            {k: clock for k in reads}
        snap = bus.snapshot()
        assert sorted(snap) == [p for p in PLANES if p != "identity"]
        assert all("error" not in v for v in snap.values())
    finally:
        tel.REGISTRY.set_clock(before["telemetry"])
        tel.TRACER.set_clock(before["tracer"])
        fr.FLIGHT.set_clock(before["flightrec"])
        tlm.TIMELINE.set_clock(before["timeline"])
        lg.configure(before["logging"])
        ident.configure(before["identity"])
        ml.MEMLEDGER.configure(before["memledger"])
    assert reads["telemetry"]() is before["telemetry"]


def test_obsbus_isolates_planes_like_reference():
    def run(name):
        bus = core(name, "obsbus").ObsBus()
        got = []
        bus.register("b", configure=lambda c: got.append(("b", c)),
                     snapshot=lambda: {"b": 1}, reset=lambda: None)
        bus.register("a", configure=lambda c: 1 / 0,
                     snapshot=lambda: 1 / 0, reset=lambda: 1 / 0)
        bus.register("c")
        bus.configure("clock")
        snap = bus.snapshot()
        done = bus.reset()
        bus.unregister("c")
        return got, snap, done, bus.stats(), bus.planes()

    ref, port = both(run)
    assert ref == port
    assert port[3]["hook_errors"] == 2
