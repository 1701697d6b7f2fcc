"""Gossip membership — the Serf/memberlist analog
(reference: nomad/serf.go + hashicorp/serf/memberlist).

Servers discover each other and detect failures without any central
registry: each member keeps a member table (name → addr, meta,
incarnation, status) and periodically pings a random peer, piggybacking
its full table; tables merge by (incarnation, status-precedence).  A
missed ack marks the peer suspect; a suspect that stays silent becomes
dead (and the leave callback fires — feeding the Raft peer set and
autopilot).  A member that hears itself called suspect/dead refutes by
bumping its incarnation — straight SWIM, minus the indirect-probe round
(loopback/LAN links don't partition one-way often enough to pay for it;
the reference's memberlist does implement it).

Transport and clock are injected seams (chaos/transport.py,
chaos/clock.py): by default the same length-prefixed msgpack framing as
raft.py over TCP and the wall clock; chaos scenarios swap in
SimTransport + VirtualClock so suspicion timeouts and probe rounds run
in seeded virtual time.  Member.status_time is stamped from the
injected clock for exactly that reason — a `time.monotonic()` default
would make suspicion deadlines wall-bound and nondeterministic.

A copy of the reference's nomad_tpu/core/membership.py with its imports
rewritten; nothing else differs.
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

from nomad_tpu_torch.chaos.clock import Clock, SystemClock
from nomad_tpu_torch.chaos.transport import Connection, TCPTransport, Transport

from .logging import log

ALIVE = "alive"
SUSPECT = "suspect"
DEAD = "dead"
LEFT = "left"

_PRECEDENCE = {ALIVE: 0, SUSPECT: 1, DEAD: 2, LEFT: 2}

PROBE_INTERVAL = 0.3
SUSPECT_TIMEOUT = 1.5


@dataclass
class Member:
    name: str
    addr: Tuple[str, int]                  # gossip addr
    meta: Dict[str, object] = field(default_factory=dict)
    incarnation: int = 0
    status: str = ALIVE
    # stamped by the OWNING Gossip's injected clock (never a wall-clock
    # default_factory: suspicion timeouts must be deterministic under a
    # VirtualClock)
    status_time: float = 0.0

    def to_wire(self) -> dict:
        return {"name": self.name, "addr": tuple(self.addr),
                "meta": self.meta, "inc": self.incarnation,
                "status": self.status}


class Gossip:
    """One member of the gossip pool."""

    def __init__(self, name: str, bind: Tuple[str, int],
                 meta: Optional[Dict[str, object]] = None,
                 on_change: Optional[Callable[[Dict[str, Member]], None]] = None,
                 probe_interval: float = PROBE_INTERVAL,
                 suspect_timeout: float = SUSPECT_TIMEOUT,
                 transport: Optional[Transport] = None,
                 clock: Optional[Clock] = None) -> None:
        self.name = name
        self.meta = meta or {}
        self.on_change = on_change
        self.probe_interval = probe_interval
        self.suspect_timeout = suspect_timeout
        self.transport = transport if transport is not None \
            else TCPTransport()
        self.clock = clock if clock is not None else SystemClock()
        self._incarnation = 0
        self._probe_round = 0
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._threads = []

        self._listener = self.transport.listen(tuple(bind), "serf")
        self.addr = self._listener.addr
        self.members: Dict[str, Member] = {
            name: Member(name=name, addr=self.addr, meta=self.meta,
                         status_time=self.clock.monotonic())}

    # ------------------------------------------------------------ control

    def start(self) -> None:
        for nm, fn in (("gossip-listen", self._listen_loop),
                       ("gossip-probe", self._probe_loop)):
            t = threading.Thread(target=fn, daemon=True,
                                 name=f"{nm}-{self.name}")
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        # listener close wakes the accept loop (the TCP implementation
        # shuts the socket down before closing — see TCPListener.close)
        self._listener.close()
        for t in self._threads:
            t.join(timeout=2)

    def join(self, seed: Tuple[str, int]) -> bool:
        """Push-pull state sync with any existing member."""
        r = self.transport.request(
            seed, {"type": "sync", "members": self._wire_members()},
            timeout=2.0, channel="serf")
        if r is None:
            return False
        self._merge(r.get("members", []))
        return True

    def leave(self) -> None:
        """Graceful leave: tell peers before going silent."""
        with self._lock:
            me = self.members[self.name]
            me.status = LEFT
            me.incarnation += 1
            wire_members = self._wire_members()
            peers = [m for m in self.members.values()
                     if m.name != self.name and m.status == ALIVE]
        for m in peers:
            self.transport.request(
                m.addr, {"type": "sync", "members": wire_members},
                timeout=0.5, channel="serf")

    def alive_members(self) -> Dict[str, Member]:
        with self._lock:
            return {n: m for n, m in self.members.items()
                    if m.status == ALIVE}

    def members_snapshot(self) -> Dict[str, Member]:
        """All members (any status) — keeps the table's locking inside
        this module for external readers like the HTTP API."""
        with self._lock:
            return dict(self.members)

    # ----------------------------------------------------------- internals

    def _wire_members(self) -> list:
        with self._lock:
            return [m.to_wire() for m in self.members.values()]

    def _merge(self, wire_members: list) -> None:
        changed = False
        with self._lock:
            for w in wire_members:
                nm = w["name"]
                if nm == self.name:
                    # refutation: bump incarnation past any rumor of death
                    if w["status"] != ALIVE \
                            and w["inc"] >= self._incarnation:
                        self._incarnation = w["inc"] + 1
                        self.members[self.name].incarnation = self._incarnation
                        changed = True
                    continue
                cur = self.members.get(nm)
                if cur is None:
                    self.members[nm] = Member(
                        name=nm, addr=tuple(w["addr"]), meta=w["meta"],
                        incarnation=w["inc"], status=w["status"],
                        status_time=self.clock.monotonic())
                    changed = True
                    continue
                newer = (w["inc"], _PRECEDENCE[w["status"]]) > \
                    (cur.incarnation, _PRECEDENCE[cur.status])
                if newer:
                    if cur.status != w["status"]:
                        changed = True
                    cur.incarnation = w["inc"]
                    cur.status = w["status"]
                    cur.meta = w["meta"]
                    cur.addr = tuple(w["addr"])
                    cur.status_time = self.clock.monotonic()
        if changed:
            self._notify()

    def _notify(self) -> None:
        if self.on_change:
            try:
                self.on_change(self.alive_members())
            except Exception as exc:  # noqa: BLE001
                log("gossip", "error", "on_change failed", error=str(exc))

    def _listen_loop(self) -> None:
        backoff = 0.05
        while not self._stop.is_set():
            try:
                conn = self._listener.accept()
            except OSError:
                # transient (e.g. EMFILE) must not silence the member
                # permanently — it would be declared dead while healthy.
                # Capped exponential backoff: a fixed retry under a
                # persistent fault is a busy loop
                if self._stop.is_set():
                    return
                self.clock.wait(self._stop, backoff)
                backoff = min(backoff * 2, 1.0)
                continue
            backoff = 0.05
            if self._stop.is_set():
                conn.close()
                return
            threading.Thread(target=self._serve, daemon=True,
                             name=f"gossip-serve-{self.name}",
                             args=(conn,)).start()

    def _serve(self, conn: Connection) -> None:
        # per-connection daemon thread: a peer vanishing mid-exchange or
        # a malformed frame must not leave a silent corpse
        try:
            msg = conn.recv(timeout=2.0)
            if msg is None:
                return
            if msg.get("type") in ("ping", "sync"):
                self._merge(msg.get("members", []))
                try:
                    conn.send({"type": "ack",
                               "members": self._wire_members()})
                except OSError:
                    pass            # peer gone; nothing to ack
        except Exception as exc:  # noqa: BLE001 - daemon thread
            log("serf", "debug", "gossip serve failed", error=repr(exc))
        finally:
            conn.close()

    def _probe_loop(self) -> None:
        while not self.clock.wait(self._stop, self.probe_interval):
            with self._lock:
                candidates = [m for m in self.members.values()
                              if m.name != self.name
                              and m.status in (ALIVE, SUSPECT)]
                dead = [m for m in self.members.values()
                        if m.name != self.name and m.status == DEAD]
            # gossip-to-the-dead (reference: memberlist
            # GossipToTheDeadTime): without an occasional probe of dead
            # members, a healed partition never re-converges — nobody
            # contacts the dead side, so it never gets the gossip that
            # lets it refute its own death.  LEFT members stay left.
            self._probe_round += 1
            if dead and (not candidates or self._probe_round % 3 == 0):
                candidates = candidates + dead
            if not candidates:
                continue
            target = random.choice(candidates)
            r = self.transport.request(
                target.addr,
                {"type": "ping", "members": self._wire_members()},
                timeout=0.5, channel="serf")
            now = self.clock.monotonic()
            if r is not None:
                self._merge(r.get("members", []))
                revived = False
                with self._lock:
                    m = self.members.get(target.name)
                    if m is not None and m.status == SUSPECT:
                        m.status = ALIVE
                        m.status_time = now
                        revived = True
                if revived:
                    self._notify()
            else:
                changed = False
                with self._lock:
                    m = self.members.get(target.name)
                    if m is not None and m.status == ALIVE:
                        m.status = SUSPECT
                        m.status_time = now
                        changed = True
                if changed:
                    log("gossip", "warn", "member suspect",
                        member=target.name)
            # suspects past the timeout are dead
            dead = []
            with self._lock:
                for m in self.members.values():
                    if m.status == SUSPECT \
                            and now - m.status_time > self.suspect_timeout:
                        m.status = DEAD
                        m.status_time = now
                        dead.append(m.name)
            if dead:
                for nm in dead:
                    log("gossip", "warn", "member dead", member=nm)
                self._notify()
