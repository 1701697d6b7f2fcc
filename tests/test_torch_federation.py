"""The port's metric federation and trace stitching
(nomad_tpu_torch/core/federation.py) against the reference's, on canned
inputs: `stitch_trace` builds the same tree, and a `FederationPuller`
scraping the same canned compact snapshots (and one dead peer) through
an injected transport publishes the same rows, gauges and counters.

Each package has its own process-global REGISTRY; the gauges compared
are the `nomad.cluster.*` series of the canned origins, read back from
each package's own registry.  The scrape's wall and CPU timings are
host facts and are dropped from the documents."""

import pytest

from torch_parity import PACKAGES, pkg

REF, PORT = PACKAGES
TIMINGS = ("ScrapeMicros", "ScrapeTotalSeconds", "ScrapeCPUSeconds")


def span(sid, parent="", start=0.0, seq=0, name="x", **kw):
    return {"SpanID": sid, "ParentID": parent, "Start": start, "Seq": seq,
            "Name": name, "End": start + 0.01, **kw}


STITCH_CASES = {
    "forwarded_write": {
        # follower: the forwarded RPC; leader: the eval and its commit;
        # serving follower: the read after replication
        "f1": [span("fwd", "", 0.0, 1, "rpc.forward")],
        "leader": [span("eval", "fwd", 0.1, 1, "eval"),
                   span("commit", "eval", 0.2, 2, "plan.commit")],
        "f2": [span("read", "commit", 0.3, 1, "http.read")],
    },
    "same_span_id_on_two_origins": {
        # one logical hop recorded on both nodes: each parents its own
        "a": [span("root", "", 0.0, 1), span("hop", "root", 0.1, 2)],
        "b": [span("root", "", 0.05, 1), span("hop", "root", 0.12, 2)],
    },
    "orphans_and_self_parent": {
        "a": [span("lost", "missing", 0.0, 1), span("me", "me", 0.1, 2),
              span("kid", "me", 0.2, 3)],
    },
    "duplicates_and_empty_origin": {
        "a": [span("s", "", 0.0, 1), span("s", "", 0.0, 1),
              span("t", "s", 0.0, 2)],
        "quiet": [],
    },
    "ties_on_start": {
        "b": [span("q", "", 1.0, 2), span("p", "", 1.0, 1)],
        "a": [span("r", "q", 1.0, 1)],
    },
    "nothing": {"a": [], "b": []},
}


@pytest.mark.parametrize("case", sorted(STITCH_CASES))
def test_stitch_trace_matches_reference(case):
    spans = STITCH_CASES[case]
    out = [pkg(name, "core.federation").stitch_trace("trace-1", spans)
           for name in PACKAGES]
    assert out[1] == out[0]
    if case == "forwarded_write":
        tree = out[0]["Tree"]
        assert out[0]["Origins"] == ["f1", "f2", "leader"]
        assert len(tree) == 1 and tree[0]["Span"]["Origin"] == "f1"
        assert (tree[0]["Children"][0]["Children"][0]["Children"][0]
                ["Span"]["Origin"]) == "f2"


def canned(origin, applied, follower=False, misses=0.0, plans=0.0):
    """A compact snapshot as agent_snapshot shapes it, without the
    process planes (Flight/Memory canned, no timeline delta)."""
    return {
        "Schema": "nomad-tpu.federation.v1", "Origin": origin, "At": 12.5,
        "Counters": {"nomad.heartbeat.missed": misses,
                     "nomad.plan.plans": plans},
        "Gauges": {"nomad.health.healthy": 1.0,
                   "nomad.health.breached_rules": 0.0,
                   "nomad.mem.rss_bytes": 1.5e9},
        "Flight": {"entries": 7}, "Memory": {"total_bytes": 1},
        "AppliedIndex": applied,
        "Follower": ({"applied_index": applied - 3, "last_contact_s": 0.2,
                      "failures": 1} if follower else None),
        "Timeline": None,
    }


class _State:
    def latest_index(self):
        return 40


def _scrape(name, rounds=2):
    fed = pkg(name, "core.federation")
    reg = pkg(name, "core.telemetry").REGISTRY
    docs = {"s2": canned("s2", 38, misses=2.0, plans=11.0),
            "s3": canned("s3", 40),
            "follower-9": canned("follower-9", 35, follower=True)}

    def transport(origin, url, since):
        if origin == "dead":
            raise ConnectionError(f"{url} refused")
        return docs[origin]

    puller = fed.FederationPuller(
        "s1", targets=lambda: [("s3", "http://s3"), ("s2", "http://s2"),
                               ("dead", "http://dead"), ("s1", "http://s1"),
                               ("", "http://none")],
        transport=transport, state=_State(), min_wall_s=0.0)
    puller.register_target("follower-9", "http://f9")
    f0 = reg.counter("nomad.cluster.scrape_failures", origin="dead")
    s0 = reg.counter("nomad.cluster.scrapes")
    for _ in range(rounds):
        doc = puller.scrape()
    for k in TIMINGS:
        doc.pop(k)
    gauges = {(g, o): reg.gauge(f"nomad.cluster.{g}", origin=o)
              for o in docs for g in ("heartbeat_misses", "plans",
                                      "healthy", "breached_rules",
                                      "rss_bytes", "applied_index",
                                      "flight_entries")}
    cluster = {g: reg.gauge(f"nomad.cluster.{g}")
               for g in ("peers", "peers_ok", "follower_lag_max")}
    stats = puller.stats()
    for k in ("scrape_total_s", "scrape_cpu_s", "last_scrape_us"):
        stats.pop(k)
    counts = (reg.counter("nomad.cluster.scrape_failures", origin="dead")
              - f0, reg.counter("nomad.cluster.scrapes") - s0)
    puller.unregister_target("follower-9")
    return doc, gauges, cluster, stats, counts, puller.targets()


def test_scrape_of_canned_snapshots_matches_reference():
    out = [_scrape(name) for name in PACKAGES]
    assert out[1] == out[0]
    doc, _, cluster, stats, counts, targets = out[0]
    assert sorted(doc["Origins"]) == ["dead", "follower-9", "s2", "s3"]
    assert doc["Origins"]["dead"]["Ok"] is False
    assert cluster == {"peers": 4.0, "peers_ok": 3.0,
                       "follower_lag_max": 8.0}
    assert counts == (2, 2) and stats["failures"] == 2
    assert [t[0] for t in targets] == ["dead", "s2", "s3"]


def test_sample_throttle_matches_reference():
    """sample(now) scrapes at most once an interval of the injected
    clock (a negative delta, a rebound timebase, is due at once)."""
    out = []
    for name in PACKAGES:
        fed = pkg(name, "core.federation")
        puller = fed.FederationPuller(
            "s1", targets=lambda: [], transport=lambda *a: {},
            interval_s=5.0, min_wall_s=0.0)
        out.append([puller.sample(t) for t in
                    (0.0, 1.0, 4.9, 5.0, 7.0, 10.1, 3.0, 4.0)])
    assert out[1] == out[0] == [True, False, False, True, False, True,
                                True, False]


def test_agent_snapshot_round_trips_the_wire_across_packages():
    """Each package's compact self-snapshot, packed by its wire codec,
    decodes in the other with the same schema and keys."""
    docs = {}
    for name in PACKAGES:
        fed = pkg(name, "core.federation")
        docs[name] = fed.agent_snapshot("s9", state=_State(), since_seq=0)
    for src, dst in ((REF, PORT), (PORT, REF)):
        raw = pkg(src, "core.wire").packb(docs[src])
        got = pkg(dst, "core.wire").unpackb(raw)
        assert sorted(got) == sorted(docs[dst])
        assert (got["Schema"], got["Origin"], got["AppliedIndex"],
                got["Follower"]) == ("nomad-tpu.federation.v1", "s9", 40,
                                     None)
