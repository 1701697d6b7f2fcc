"""Transport abstraction: real TCP vs. in-memory simulated network.

The cluster plane's three wire channels (raft, serf gossip, rpc) speak
through this interface:

    listener = transport.listen(bind, channel)      # server side
    conn     = transport.dial(addr, channel, t)     # persistent client
    reply    = transport.request(addr, msg, t, ch)  # one-shot RPC

`TCPTransport` is the production path — the exact length-prefixed
msgpack framing of core/wire.py (data-only, optional AES-GCM with
channel-bound AAD tags) that raft.send_msg/recv_msg used to open-code.

`SimNetwork`/`SimTransport` replace the sockets with in-memory queues
while still round-tripping every message through `wire.packb/unpackb`
(an unserializable payload must fail in simulation exactly as it would
on the real wire).  The network owns seeded, schedulable faults:

  - `partition(a, b, bidirectional=...)` — cut links between node
    groups; asymmetric cuts model one-way reachability (an established
    connection keeps delivering one way while the other blackholes).
  - `set_drop(src, dst, p)`    — per-link, per-message drop probability.
  - `set_latency(src, dst, lo, hi)` — per-link delivery delay sampled
    from the seeded RNG, in CLOCK time (virtual under a VirtualClock).
  - `set_reorder(src, dst, jitter)` — extra per-message jitter so later
    sends can overtake earlier ones.
  - `crash(node)` / `restart(node)` — kill a node's endpoint: dials are
    refused and every established connection drops; the node's threads
    keep running (it is the ENDPOINT that dies, like a firewalled box).

Dialing requires both directions of the link to be up (a TCP handshake
needs the SYN-ACK back); per-message faults apply to established
connections, so an asymmetric cut starves one direction only.

Determinism note: fault *schedules* are expanded from a seed before a
scenario runs (chaos/scenarios.py) and form the canonical trace; the
per-message RNG here (drops, latency samples) is seeded too, but its
draw order depends on thread interleaving — message-level events are
therefore recorded as debug trace only, never canonical.

A copy of the reference's nomad_tpu/chaos/transport.py with its imports
rewritten; nothing else differs.  Frames go through the port's
`core/wire.py`.  The scenarios it mentions are the port's
`chaos/scenarios.py`.
"""

from __future__ import annotations

import heapq
import itertools
import random
import socket
import struct
import threading
from typing import Dict, Iterable, List, Optional, Set, Tuple

from nomad_tpu_torch.core import wire

from .clock import Clock, SystemClock

Addr = Tuple[str, int]

# real-time re-check period for simulated recv/accept waits (see
# chaos/clock._BACKSTOP_S; same bounded-staleness contract)
_SIM_BACKSTOP_S = 0.02


class Connection:
    """One message stream.  `send` raises OSError on a known-dead pipe;
    `recv` returns None on timeout/EOF/garbage (the callers' uniform
    "lost message" signal — raft is built on lost messages)."""

    def send(self, msg: dict) -> None:
        raise NotImplementedError

    def recv(self, timeout: float) -> Optional[dict]:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError


class Listener:
    addr: Addr

    def accept(self) -> Connection:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError


class Transport:
    kind = "abstract"

    def listen(self, bind: Addr, channel: str) -> Listener:
        raise NotImplementedError

    def dial(self, addr: Addr, channel: str,
             timeout: float = 1.0) -> Connection:
        """Open a persistent connection; raises OSError on failure."""
        raise NotImplementedError

    def request(self, addr: Addr, msg: dict, timeout: float = 1.0,
                channel: str = "rpc") -> Optional[dict]:
        """One-shot request/response; None on ANY failure.  Encoding
        errors still raise (an unencodable payload is a local bug, not a
        dead server) — both implementations encode outside the
        swallowed-error net."""
        try:
            conn = self.dial(tuple(addr), channel, timeout=timeout)
        except OSError:
            return None
        try:
            conn.send(msg)
            return conn.recv(timeout)
        except OSError:
            return None
        finally:
            conn.close()


# =============================================================== real TCP


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def recv_frame(sock: socket.socket, timeout: float = 5.0,
               tag: bytes = b"") -> Optional[dict]:
    """Read one length-prefixed frame; None on timeout/EOF/bad frame."""
    sock.settimeout(timeout)
    try:
        hdr = _recv_exact(sock, 4)
        if hdr is None:
            return None
        (n,) = struct.unpack(">I", hdr)
        body = _recv_exact(sock, n)
        if body is None:
            return None
        return wire.decode_body(body, tag=tag)
    except (OSError, ValueError, TypeError, EOFError):
        return None


class TCPConnection(Connection):
    """One side of a TCP message stream.  The req/rep AAD tags bind
    frames to the LISTENER's advertised address and direction (see
    wire.channel_tag): the dialing side sends "req" and reads "rep",
    the accepting side the reverse."""

    def __init__(self, sock: socket.socket, channel: str,
                 listener_addr: Addr, server_side: bool) -> None:
        self._sock = sock
        self._send_tag = wire.channel_tag(
            channel, "rep" if server_side else "req", listener_addr)
        self._recv_tag = wire.channel_tag(
            channel, "req" if server_side else "rep", listener_addr)

    def send(self, msg: dict) -> None:
        # encode per send (fresh nonce — a byte-identical resend would
        # trip the receiver's replay guard) and OUTSIDE any swallowed-
        # error net: an unencodable payload must raise loudly
        frame = wire.encode_frame(msg, tag=self._send_tag)
        self._sock.sendall(frame)

    def recv(self, timeout: float) -> Optional[dict]:
        return recv_frame(self._sock, timeout, tag=self._recv_tag)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


class TCPListener(Listener):
    def __init__(self, bind: Addr, channel: str, backlog: int) -> None:
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(bind)
        self._sock.listen(backlog)
        self.addr = self._sock.getsockname()
        self._channel = channel

    def accept(self) -> Connection:
        conn, _ = self._sock.accept()
        return TCPConnection(conn, self._channel, self.addr,
                             server_side=True)

    def close(self) -> None:
        # shutdown() BEFORE close(): close() does not wake a thread
        # already blocked in accept() — the in-flight syscall keeps the
        # file description alive and would accept (and serve!) one more
        # connection after "close"
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


class TCPTransport(Transport):
    """The production transport: loopback/LAN TCP, one frame per
    message, core/wire.py codec + optional encryption."""

    kind = "tcp"

    def listen(self, bind: Addr, channel: str,
               backlog: int = 64) -> Listener:
        return TCPListener(tuple(bind), channel, backlog)

    def dial(self, addr: Addr, channel: str,
             timeout: float = 1.0) -> Connection:
        sock = socket.create_connection(tuple(addr), timeout=timeout)
        return TCPConnection(sock, channel, tuple(addr),
                             server_side=False)


# ========================================================== simulated net


class SimConnection(Connection):
    """One endpoint of an in-memory duplex stream.  Messages arrive in a
    (deliver_at, seq) heap; `recv` blocks in CLOCK time until the head
    message's delivery time has passed."""

    def __init__(self, net: "SimNetwork", local: str, remote: str) -> None:
        self.net = net
        self.local = local
        self.remote = remote
        self.peer: Optional["SimConnection"] = None
        self._inbox: List[Tuple[float, int, bytes]] = []
        self._cv = threading.Condition()
        self._closed = False
        net.clock.register(self._cv)

    # sender side -----------------------------------------------------

    def send(self, msg: dict) -> None:
        # serialize FIRST: the simulated wire must reject exactly the
        # payloads the real wire would (and encoding errors must raise,
        # not look like a fault)
        body = wire.packb(msg)
        peer = self.peer
        if self._closed or peer is None or peer._closed:
            raise OSError("simulated connection closed")
        verdict, deliver_at = self.net._route(self.local, self.remote)
        if verdict == "reset":
            raise OSError("simulated connection reset (endpoint down)")
        if verdict == "drop":
            # a partitioned/lossy link eats the frame silently — the
            # sender only ever finds out via a missing reply, like TCP
            # into a blackhole
            return
        peer._deliver(deliver_at, body)

    def _deliver(self, deliver_at: float, body: bytes) -> None:
        with self._cv:
            if self._closed:
                return
            heapq.heappush(self._inbox,
                           (deliver_at, next(self.net._msg_seq), body))
            self._cv.notify_all()

    # receiver side ---------------------------------------------------

    def recv(self, timeout: float) -> Optional[dict]:
        clock = self.net.clock
        deadline = clock.monotonic() + max(0.0, timeout)
        with self._cv:
            while True:
                now = clock.monotonic()
                if self._inbox and self._inbox[0][0] <= now:
                    _, _, body = heapq.heappop(self._inbox)
                    try:
                        return wire.unpackb(body)
                    except Exception:  # noqa: BLE001 - garbage == lost
                        return None
                if self._closed and not self._inbox:
                    return None                     # EOF
                if now >= deadline:
                    return None                     # timeout
                if getattr(clock, "closed", False):
                    return None     # timeline torn down mid-recv
                # woken by a send, a clock advance, or the backstop
                self._cv.wait(_SIM_BACKSTOP_S)

    def close(self) -> None:
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
        self.net.clock.unregister(self._cv)
        self.net._forget(self)
        peer = self.peer
        if peer is not None and not peer._closed:
            # the peer sees EOF once it drains what was already in
            # flight — close is not retroactive packet loss
            with peer._cv:
                peer._cv.notify_all()


class SimListener(Listener):
    def __init__(self, net: "SimNetwork", owner: str, addr: Addr,
                 channel: str) -> None:
        self.net = net
        self.owner = owner
        self.addr = addr
        self.channel = channel
        self._backlog: List[SimConnection] = []
        self._cv = threading.Condition()
        self._closed = False
        net.clock.register(self._cv)

    def _offer(self, conn: SimConnection) -> None:
        with self._cv:
            if self._closed:
                raise OSError("listener closed")
            self._backlog.append(conn)
            self._cv.notify_all()

    def accept(self) -> Connection:
        with self._cv:
            while not self._backlog:
                if self._closed:
                    raise OSError("listener closed")
                self._cv.wait(_SIM_BACKSTOP_S)
            return self._backlog.pop(0)

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self.net.clock.unregister(self._cv)
        self.net._unlisten(self.addr)


class SimNetwork:
    """The shared in-memory fabric: address registry + fault state +
    seeded RNG + optional trace.  One instance per simulated cluster;
    per-node `Transport` handles come from `node(name)`."""

    def __init__(self, clock: Optional[Clock] = None, seed: int = 0,
                 trace=None) -> None:
        self.clock = clock if clock is not None else SystemClock()
        self.seed = seed
        self.trace = trace          # chaos.trace.Trace or None (debug only)
        self._rng = random.Random(seed)
        self._lock = threading.RLock()
        self._listeners: Dict[Addr, SimListener] = {}
        self._conns: Set[SimConnection] = set()
        self._nodes: Dict[str, "SimTransport"] = {}
        self._port_seq = itertools.count(10001)
        self._msg_seq = itertools.count()
        # fault state, all keyed by DIRECTED (src, dst) node-name edges
        self._down: Set[str] = set()
        self._cut: Set[Tuple[str, str]] = set()
        self._drop: Dict[Tuple[str, str], float] = {}
        self._latency: Dict[Tuple[str, str], Tuple[float, float]] = {}
        self._reorder: Dict[Tuple[str, str], float] = {}

    def node(self, name: str) -> "SimTransport":
        with self._lock:
            t = self._nodes.get(name)
            if t is None:
                t = SimTransport(self, name)
                self._nodes[name] = t
            return t

    # ------------------------------------------------------------ routing

    def _listen(self, owner: str, bind: Addr, channel: str) -> SimListener:
        with self._lock:
            port = bind[1] if len(bind) > 1 and bind[1] else \
                next(self._port_seq)
            addr = (f"sim.{owner}", port)
            if addr in self._listeners:
                raise OSError(f"address in use: {addr}")
            lst = SimListener(self, owner, addr, channel)
            self._listeners[addr] = lst
            return lst

    def _unlisten(self, addr: Addr) -> None:
        with self._lock:
            self._listeners.pop(tuple(addr), None)

    def _dial(self, src: str, addr: Addr, channel: str) -> SimConnection:
        with self._lock:
            lst = self._listeners.get(tuple(addr))
            if lst is None or lst._closed:
                raise OSError(f"connection refused: {addr}")
            dst = lst.owner
            # a handshake needs BOTH directions: SYN out, SYN-ACK back
            if (src in self._down or dst in self._down
                    or (src, dst) in self._cut or (dst, src) in self._cut):
                self._debug("dial_blocked", src=src, dst=dst)
                raise OSError(f"unreachable: {src}->{dst}")
            a = SimConnection(self, src, dst)
            b = SimConnection(self, dst, src)
            a.peer, b.peer = b, a
            self._conns.add(a)
            self._conns.add(b)
        lst._offer(b)
        return a

    def _route(self, src: str, dst: str) -> Tuple[str, float]:
        """Per-message fault verdict for an ESTABLISHED connection:
        ("ok"|"drop"|"reset", deliver_at)."""
        with self._lock:
            if src in self._down or dst in self._down:
                return "reset", 0.0
            if (src, dst) in self._cut:
                return "drop", 0.0
            edge = (src, dst)
            p = self._drop.get(edge, 0.0)
            if p > 0.0 and self._rng.random() < p:
                self._debug("msg_dropped", src=src, dst=dst)
                return "drop", 0.0
            lo, hi = self._latency.get(edge, (0.0, 0.0))
            delay = lo if hi <= lo else self._rng.uniform(lo, hi)
            jitter = self._reorder.get(edge, 0.0)
            if jitter > 0.0:
                delay += self._rng.uniform(0.0, jitter)
            return "ok", self.clock.monotonic() + delay

    def _forget(self, conn: SimConnection) -> None:
        with self._lock:
            self._conns.discard(conn)

    def _debug(self, kind: str, **fields) -> None:
        if self.trace is not None:
            self.trace.debug(self.clock.monotonic(), kind, **fields)

    # ------------------------------------------------------------- faults

    def partition(self, group_a: Iterable[str], group_b: Iterable[str],
                  bidirectional: bool = True) -> None:
        """Cut every link from group_a to group_b (and back when
        bidirectional)."""
        a, b = list(group_a), list(group_b)
        with self._lock:
            for x in a:
                for y in b:
                    if x == y:
                        continue
                    self._cut.add((x, y))
                    if bidirectional:
                        self._cut.add((y, x))
        self._debug("partition", a=sorted(a), b=sorted(b),
                    bidirectional=bidirectional)

    def heal(self, group_a: Optional[Iterable[str]] = None,
             group_b: Optional[Iterable[str]] = None) -> None:
        """Remove cuts between two groups; with no arguments, remove
        EVERY cut (heal the world)."""
        with self._lock:
            if group_a is None or group_b is None:
                self._cut.clear()
            else:
                for x in list(group_a):
                    for y in list(group_b):
                        self._cut.discard((x, y))
                        self._cut.discard((y, x))
        self._debug("heal")

    def clear_link_faults(self) -> None:
        """Drop/latency/reorder back to a clean fabric (cuts/downs keep)."""
        with self._lock:
            self._drop.clear()
            self._latency.clear()
            self._reorder.clear()
        self._debug("clear_link_faults")

    def set_drop(self, src: str, dst: str, p: float,
                 bidirectional: bool = True) -> None:
        with self._lock:
            self._drop[(src, dst)] = p
            if bidirectional:
                self._drop[(dst, src)] = p
        self._debug("set_drop", src=src, dst=dst, p=p)

    def set_latency(self, src: str, dst: str, lo: float, hi: float,
                    bidirectional: bool = True) -> None:
        with self._lock:
            self._latency[(src, dst)] = (lo, hi)
            if bidirectional:
                self._latency[(dst, src)] = (lo, hi)
        self._debug("set_latency", src=src, dst=dst, lo=lo, hi=hi)

    def set_reorder(self, src: str, dst: str, jitter: float,
                    bidirectional: bool = True) -> None:
        with self._lock:
            self._reorder[(src, dst)] = jitter
            if bidirectional:
                self._reorder[(dst, src)] = jitter
        self._debug("set_reorder", src=src, dst=dst, jitter=jitter)

    def crash(self, node: str) -> None:
        """Kill the node's ENDPOINT: refuse dials, reset established
        connections.  The node's threads keep running blind."""
        with self._lock:
            self._down.add(node)
            doomed = [c for c in self._conns
                      if c.local == node or c.remote == node]
        for c in doomed:
            c.close()
        self._debug("crash", node=node)

    def restart(self, node: str) -> None:
        with self._lock:
            self._down.discard(node)
        self._debug("restart", node=node)

    def nodes(self) -> List[str]:
        with self._lock:
            return sorted(self._nodes)


class SimTransport(Transport):
    """Per-node handle onto a SimNetwork — the object a ClusterServer
    gets as its `transport`, so every listen/dial is attributed to the
    owning node for fault routing."""

    kind = "sim"

    def __init__(self, net: SimNetwork, node_name: str) -> None:
        self.net = net
        self.node_name = node_name

    def listen(self, bind: Addr, channel: str) -> Listener:
        return self.net._listen(self.node_name, tuple(bind), channel)

    def dial(self, addr: Addr, channel: str,
             timeout: float = 1.0) -> Connection:
        return self.net._dial(self.node_name, tuple(addr), channel)


# ------------------------------------------------------------ config glue

_shared_sim: Optional[SimNetwork] = None
_shared_sim_lock = threading.Lock()


def shared_sim_network(clock: Optional[Clock] = None) -> SimNetwork:
    """Process-global SimNetwork for config-selected sim transport:
    in-process agents of one simulated cluster share a fabric (first
    caller's clock wins, like the process-global wire key)."""
    global _shared_sim
    with _shared_sim_lock:
        if _shared_sim is None:
            _shared_sim = SimNetwork(clock=clock)
        return _shared_sim


def resolve_transport(spec, node_name: str = "",
                      clock: Optional[Clock] = None) -> Transport:
    """Agent-config knob -> Transport.  `spec` is a Transport (passed
    through), or "tcp" / "sim"."""
    if isinstance(spec, Transport):
        return spec
    if spec in (None, "", "tcp", "real"):
        return TCPTransport()
    if spec == "sim":
        return shared_sim_network(clock).node(node_name or "agent")
    raise ValueError(f"unknown transport {spec!r} (expected 'tcp'/'sim')")
