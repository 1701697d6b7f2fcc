"""The port's simulated network (nomad_tpu_torch/chaos/transport.py)
against the reference's, on the CPU: the same seed and the same fault
schedule give the same delivery trace in both packages.

Each case drives one package at a time on its own `VirtualClock` from a
single thread, so the seeded per-message draws (drops, latency, reorder
jitter) happen in the same order in both runs; a trace lists every
message each endpoint received, with the virtual time of its receipt."""

import pytest

from torch_parity import PACKAGES, pkg

REF, PORT = PACKAGES


def _net(name, seed):
    clock = pkg(name, "chaos.clock").VirtualClock()
    return clock, pkg(name, "chaos.transport").SimNetwork(clock=clock,
                                                          seed=seed)


def _drain(clock, conn, who, trace, until, step=0.005):
    """Advance the clock to `until` in steps, recording each message
    `conn` receives as (who, virtual time, payload)."""
    while True:
        msg = conn.recv(0.0)
        if msg is not None:
            trace.append((who, round(clock.monotonic(), 6), msg["n"]))
            continue
        if clock.monotonic() >= until:
            return
        clock.advance(step)


def _links(name, seed, faults):
    """a dials b's listener; a sends 120 numbered messages and b answers
    each one it receives; `faults(net)` configures the fabric first."""
    clock, net = _net(name, seed)
    a, b = net.node("a"), net.node("b")
    lst = b.listen(("0", 0), "rpc")
    faults(net)
    trace = []
    try:
        ca = a.dial(lst.addr, "rpc")
    except OSError as e:
        return [("dial", str(e))]
    cb = lst.accept()
    for n in range(120):
        try:
            ca.send({"n": n})
        except OSError as e:
            trace.append(("send", n, str(e)))
        clock.advance(0.001)
        while True:
            got = cb.recv(0.0)
            if got is None:
                break
            trace.append(("b", round(clock.monotonic(), 6), got["n"]))
            try:
                cb.send({"n": -got["n"]})
            except OSError as e:
                trace.append(("reply", got["n"], str(e)))
    _drain(clock, cb, "b", trace, clock.monotonic() + 0.5)
    _drain(clock, ca, "a", trace, clock.monotonic() + 0.5)
    ca.close()
    cb.close()
    lst.close()
    return trace


FAULTS = {
    "clean": lambda net: None,
    "drop": lambda net: net.set_drop("a", "b", 0.3),
    "drop_one_way": lambda net: net.set_drop("b", "a", 0.5,
                                             bidirectional=False),
    "latency": lambda net: net.set_latency("a", "b", 0.01, 0.05),
    "reorder": lambda net: (net.set_latency("a", "b", 0.002, 0.004),
                            net.set_reorder("a", "b", 0.05)),
    "everything": lambda net: (net.set_drop("a", "b", 0.2),
                               net.set_latency("a", "b", 0.0, 0.03),
                               net.set_reorder("b", "a", 0.02,
                                               bidirectional=False)),
    "partition": lambda net: net.partition(["a"], ["b"]),
    "partition_one_way": lambda net: net.partition(["a"], ["b"],
                                                   bidirectional=False),
    "crashed": lambda net: net.crash("b"),
}


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_delivery_trace_matches_reference(fault, seed):
    out = [_links(name, seed, FAULTS[fault]) for name in PACKAGES]
    assert out[1] == out[0]
    if fault in ("partition", "partition_one_way", "crashed"):
        assert out[0][0][0] == "dial"          # a handshake needs both ways
    else:
        assert any(e[0] == "b" for e in out[0])


def _mid_run(name):
    """Faults that arrive while the connection is up: a one-way cut, then
    a heal, then a crash (which resets the connection) and a restart."""
    clock, net = _net(name, 3)
    a, b = net.node("a"), net.node("b")
    lst = b.listen(("0", 0), "raft")
    ca = a.dial(lst.addr, "raft")
    cb = lst.accept()
    trace = []
    for n in range(40):
        if n == 10:
            net.partition(["a"], ["b"], bidirectional=False)
        if n == 20:
            net.heal()
        if n == 30:
            net.crash("b")
        try:
            ca.send({"n": n})
            trace.append(("sent", n))
        except OSError as e:
            trace.append(("send", n, str(e)))
        clock.advance(0.001)
        got = cb.recv(0.0)
        trace.append(("b", None if got is None else got["n"]))
    net.restart("b")
    try:
        a.dial(lst.addr, "raft")
        trace.append(("redial", "ok"))
    except OSError as e:
        trace.append(("redial", str(e)))
    lst2 = b.listen(("0", 0), "raft")
    a.dial(lst2.addr, "raft").close()
    trace.append(("nodes", net.nodes(), lst2.addr))
    return trace


def test_faults_mid_connection_match_reference():
    out = [_mid_run(name) for name in PACKAGES]
    assert out[1] == out[0]
    # the crash closed the connection: later sends fail, the redial is
    # refused until the restart, and the cut dropped 10 messages
    assert ("send", 30, "simulated connection closed") in out[0]
    assert sum(1 for e in out[0] if e == ("b", None)) >= 10


@pytest.mark.parametrize("spec", ["tcp", "", None, "sim", "bogus"])
def test_resolve_transport_matches_reference(spec):
    out = []
    for name in PACKAGES:
        tr = pkg(name, "chaos.transport")
        try:
            t = tr.resolve_transport(spec, node_name="n1")
            out.append((t.kind, getattr(t, "node_name", None)))
        except ValueError as e:
            out.append(("error", str(e)))
    assert out[1] == out[0]


def test_tcp_request_round_trip_between_packages():
    """A port TCP listener answers a reference request and the other way
    round: the framing on the socket is the same."""
    import threading
    for server, client in ((PORT, REF), (REF, PORT)):
        lst = pkg(server, "chaos.transport").TCPTransport().listen(
            ("127.0.0.1", 0), "rpc")

        def serve(lst=lst):
            conn = lst.accept()
            msg = conn.recv(5.0)
            conn.send({"echo": msg, "by": server})
            conn.close()

        t = threading.Thread(target=serve, daemon=True)
        t.start()
        try:
            reply = pkg(client, "chaos.transport").TCPTransport().request(
                lst.addr, {"method": "ping", "args": [1, b"x"]},
                timeout=5.0)
        finally:
            t.join(timeout=5)
            lst.close()
        assert reply == {"echo": {"method": "ping", "args": [1, b"x"]},
                         "by": server}
