"""Raft consensus for multi-server state replication
(reference: hashicorp/raft + nomad/raft_rpc.go + nomad/fsm.go wiring).

The reference replicates every cluster mutation through a Raft log applied
to the FSM on 3/5 servers; this module is the same protocol re-implemented
for the TPU framework's Python server plane: leader election with
randomized timeouts, log replication with per-follower progress tracking,
commit on majority match, FSM apply in log order, and snapshot
install for lagging followers (log compaction via the state store's
snapshot_save/snapshot_restore).

Transport and clock are INJECTED seams (chaos/transport.py,
chaos/clock.py): the default is length-prefixed msgpack over
loopback/LAN TCP via core.wire — DATA ONLY (no pickle on any socket: a
reachable port must never yield code execution), with optional AES-GCM
frame encryption from the cluster shared secret (`encrypt` agent
option; the reference likewise runs msgpack-RPC between servers with
optional mTLS) — and the wall clock; chaos scenarios swap in
SimTransport + VirtualClock to run seeded partitions/loss/flaps in
virtual time.  Any transport error is a lost message, and Raft is
built on lost messages.

Durable files (log/meta on local disk) use pickle — the trust boundary
is the socket, not the node's own data_dir.

Simplification vs the reference (documented, deliberate): peer-set
changes (autopilot add/remove) take effect via the membership layer on
every server symmetrically rather than through joint-consensus
configuration entries.

A copy of the reference's nomad_tpu/core/raft.py with its imports
rewritten and one difference: a follower whose log only grew appends
the new entries to its durable log (`_persist_entry`, the leader's
path), where the reference's `_on_append` rewrites the whole log and
the compaction snapshot on every AppendEntries that adds an entry.  A
conflict (a truncated suffix) still rewrites.  Restoring either file
gives the same log; the reference's rewrite costs a follower time
proportional to its log for every replicated command (tens of MB once
a 50,000-node cluster has been seeded).  Its durable files pickle
`Entry`, so a data directory is readable only by the package that
wrote it.  The chaos invariants and scenarios it mentions are not
ported yet (ROADMAP queue 1 item 5).
"""

from __future__ import annotations

import os
import pickle
import random
import socket
import struct
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from nomad_tpu_torch.chaos.clock import Clock, SystemClock
from nomad_tpu_torch.chaos.transport import (
    Connection,
    TCPTransport,
    Transport,
    recv_frame,
)

from . import wire
from .logging import log
from .telemetry import REGISTRY

FOLLOWER = "follower"
CANDIDATE = "candidate"
LEADER = "leader"

HEARTBEAT_INTERVAL = 0.075
ELECTION_TIMEOUT = (0.3, 0.6)
MAX_APPEND_ENTRIES = 256


class NotLeaderError(Exception):
    """Raised by apply() on a non-leader; carries the leader hint."""

    def __init__(self, leader: Optional[str]) -> None:
        super().__init__(f"not the leader (leader={leader})")
        self.leader = leader


@dataclass
class Entry:
    term: int
    index: int
    cmd: bytes


# Back-compat shims: the cluster layer now speaks through an injected
# chaos.transport.Transport; these keep the historical one-shot TCP
# helpers working for external callers (tests, tools).
_DEFAULT_TCP = TCPTransport()


def send_msg(addr: Tuple[str, int], msg: dict, timeout: float = 1.0,
             channel: str = "rpc") -> Optional[dict]:
    """One-shot TCP request/response; None on any failure.  Encoding
    errors still raise (a local programming error must not masquerade
    as a dead server — see Transport.request)."""
    return _DEFAULT_TCP.request(tuple(addr), msg, timeout=timeout,
                                channel=channel)


def recv_msg(sock: socket.socket, timeout: float = 5.0,
             tag: bytes = b"") -> Optional[dict]:
    """Read one length-prefixed frame off a raw socket (back-compat
    alias of chaos.transport.recv_frame)."""
    return recv_frame(sock, timeout, tag=tag)


def reply(sock: socket.socket, msg: dict, tag: bytes = b"") -> None:
    try:
        sock.sendall(wire.encode_frame(msg, tag=tag))
    except OSError:
        pass


class RaftNode:
    """One Raft participant.

    fsm_apply(cmd: bytes) -> result   applied exactly once, in log order
    fsm_snapshot() -> bytes           full-state snapshot for compaction
    fsm_restore(data: bytes)          replace state from a snapshot
    on_leader() / on_follower()       leadership transition callbacks
    """

    def __init__(self, name: str, bind: Tuple[str, int],
                 fsm_apply: Callable[[bytes], object],
                 fsm_snapshot: Optional[Callable[[], bytes]] = None,
                 fsm_restore: Optional[Callable[[bytes], None]] = None,
                 on_leader: Optional[Callable[[], None]] = None,
                 on_follower: Optional[Callable[[], None]] = None,
                 data_dir: Optional[str] = None,
                 max_log_entries: int = 8192,
                 heartbeat_interval: float = HEARTBEAT_INTERVAL,
                 election_timeout: Tuple[float, float] = ELECTION_TIMEOUT,
                 bootstrap_expect: int = 1,
                 transport: Optional[Transport] = None,
                 clock: Optional[Clock] = None,
                 ) -> None:
        self.name = name
        # injected seams (chaos/): every timer reads `clock`, every
        # frame rides `transport` — the fault-injection scenarios swap
        # both; production defaults are wall clock + TCP
        self.transport = transport if transport is not None \
            else TCPTransport()
        self.clock = clock if clock is not None else SystemClock()
        self.fsm_apply = fsm_apply
        self.fsm_snapshot = fsm_snapshot
        self.fsm_restore = fsm_restore
        self.on_leader = on_leader
        self.on_follower = on_follower
        self.data_dir = data_dir
        self.max_log_entries = max_log_entries
        self.heartbeat_interval = heartbeat_interval
        self.election_timeout = election_timeout
        # no elections until this many servers are known (reference:
        # server config bootstrap_expect) — a server that starts before
        # membership converges must not win a singleton "quorum"
        self.bootstrap_expect = max(1, bootstrap_expect)

        # persistent state (term/vote/log; durable when data_dir given)
        self.term = 0
        self.voted_for: Optional[str] = None
        self.log: List[Entry] = []
        # log prefix replaced by a snapshot; _snap_data holds the bytes of
        # the last compaction for lagging-follower installs
        self.snap_index = 0
        self.snap_term = 0
        self._snap_data: Optional[bytes] = None
        # in-memory replication-only tail of already-compacted entries
        # (index <= snap_index); see _maybe_compact
        self._tail: List[Entry] = []

        # volatile
        self.role = FOLLOWER
        self.leader_name: Optional[str] = None
        self.commit_index = 0
        self.last_applied = 0
        self.peers: Dict[str, Tuple[str, int]] = {}   # name -> raft addr
        self.next_index: Dict[str, int] = {}
        self.match_index: Dict[str, int] = {}

        # chaos observers (scenario hooks; None in production).
        # append_observer fires under the lock when THIS node creates an
        # entry as leader; fsm_observer fires as entries reach the FSM —
        # together they let chaos/invariants.py prove nothing committed
        # came from a deposed leader without reading logs.
        self.append_observer: Optional[Callable[[Entry], None]] = None
        self.fsm_observer: Optional[Callable[[Entry], None]] = None
        # fires with (snap_index, snap_term) when a lagging follower
        # catches up via snapshot install: the observed per-entry apply
        # stream legitimately jumps over the installed range
        self.install_observer: Optional[Callable[[int, int], None]] = None

        self._lock = threading.RLock()
        self._apply_cv = threading.Condition(self._lock)
        self._waiters: Dict[int, list] = {}   # index -> [event, result, term]
        self._last_contact = self.clock.monotonic()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        # one long-lived replicator thread per peer, kicked by an event on
        # apply() and by the heartbeat timeout — not a thread per message
        self._peer_kick: Dict[str, threading.Event] = {}
        self._peer_threads: Dict[str, threading.Thread] = {}
        self._peer_ack: Dict[str, float] = {}   # last response, any kind
        self._lease_start = 0.0

        self._listener = self.transport.listen(tuple(bind), "raft")
        self.addr = self._listener.addr

        if data_dir:
            os.makedirs(data_dir, exist_ok=True)
            self._restore_durable()

    # ------------------------------------------------------------ control

    def start(self) -> None:
        for name, fn in (("raft-listen", self._listen_loop),
                         ("raft-tick", self._tick_loop),
                         ("raft-apply", self._apply_loop)):
            t = threading.Thread(target=fn, daemon=True,
                                 name=f"{name}-{self.name}")
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        with self._lock:
            self._stop.set()
            # a stopped node must not linger as an apparent leader —
            # apply() checks role, and the step-down drops pending
            # waiters with NotLeaderError so callers retry elsewhere
            if self.role == LEADER:
                self._become_follower(self.term, None)
            self.role = FOLLOWER
        # listener close wakes the accept loop (the TCP implementation
        # shuts the socket down before closing — see TCPListener.close)
        self._listener.close()
        with self._apply_cv:
            self._apply_cv.notify_all()
        for t in self._threads:
            t.join(timeout=2)

    def set_peers(self, peers: Dict[str, Tuple[str, int]]) -> None:
        """Merge in peers (membership layer callback).  ADD-ONLY by
        design: a server that merely *looks* dead must keep counting
        toward quorum, or a fully-partitioned node would shrink its peer
        set to nothing and elect itself (split brain).  Removal happens
        only through `remove_peer` — driven by the leader's autopilot
        after the grace window, and only while the leader still has
        quorum contact."""
        with self._lock:
            for n, a in peers.items():
                if n == self.name:
                    continue
                self.peers[n] = tuple(a)
                self.next_index.setdefault(n, self._last_index() + 1)
                self.match_index.setdefault(n, 0)
                if n not in self._peer_threads and not self._stop.is_set():
                    self._peer_kick[n] = threading.Event()
                    t = threading.Thread(
                        target=self._replicator_loop, args=(n,),
                        daemon=True, name=f"raft-repl-{self.name}->{n}")
                    self._peer_threads[n] = t
                    t.start()

    def remove_peer(self, name: str) -> None:
        with self._lock:
            self.peers.pop(name, None)
            self.next_index.pop(name, None)
            self.match_index.pop(name, None)
            self._peer_threads.pop(name, None)   # loop exits on its own
            kick = self._peer_kick.pop(name, None)
        if kick is not None:
            kick.set()

    def is_leader(self) -> bool:
        return self.role == LEADER

    def leader_hint(self) -> Optional[str]:
        if self.role == LEADER:
            return self.name
        # never advertise ourselves while not leading
        return self.leader_name if self.leader_name != self.name else None

    # ------------------------------------------------------------- client

    def apply(self, cmd: bytes, timeout: float = 10.0):
        """Replicate one command; returns the local FSM result after the
        entry commits.  Raises NotLeaderError on non-leaders."""
        t_start = self.clock.monotonic()
        with self._lock:
            if self.role != LEADER or self._stop.is_set():
                raise NotLeaderError(self.leader_name)
            index = self._last_index() + 1
            entry = Entry(term=self.term, index=index, cmd=cmd)
            self.log.append(entry)
            self._persist_entry(entry)
            self._observe_append(entry)
            waiter = [threading.Event(), None, self.term]
            self._waiters[index] = waiter
            single = not self.peers
            if single:
                self.commit_index = index
                self._apply_cv.notify_all()
        # append latency: local log append + persist (the lock section);
        # commit latency below additionally covers replication + quorum
        REGISTRY.observe("nomad.raft.append_s",
                         self.clock.monotonic() - t_start)
        if not single:
            self._replicate_once()
        # clock-time wait: under a VirtualClock the commit timeout is
        # virtual too, so a partitioned leader's doomed apply resolves in
        # simulated seconds, not wall seconds
        if not self.clock.wait(waiter[0], timeout):
            with self._lock:
                self._waiters.pop(index, None)
                e = self._entry_at(index)
                now_m = self.clock.monotonic()
                acks = {n: round(now_m - self._peer_ack.get(n, 0.0), 2)
                        for n in self.peers}
                detail = (f"index {index}: node={self.name}"
                          f" role={self.role} term={self.term}"
                          f" commit={self.commit_index}"
                          f" applied={self.last_applied}"
                          f" last={self._last_index()}"
                          f" entry_term={e.term if e else None}"
                          f" entry_is_noop={e is not None and not e.cmd}"
                          f" waiter_term={waiter[2]}"
                          f" next={dict(self.next_index)}"
                          f" match={dict(self.match_index)}"
                          f" ack_age={acks}"
                          f" repl_alive="
                          f"{ {n: t.is_alive() for n, t in self._peer_threads.items()} }")
            raise TimeoutError(f"raft apply timed out at {detail}")
        REGISTRY.observe("nomad.raft.commit_s",
                         self.clock.monotonic() - t_start)
        if isinstance(waiter[1], _Dropped):
            raise NotLeaderError(self.leader_name)
        if isinstance(waiter[1], Exception):
            raise waiter[1]
        return waiter[1]

    def barrier(self, timeout: float = 10.0) -> bool:
        """Block until the FSM has applied every entry currently in the
        log (reference: the raft Barrier leaderLoop issues before
        establishLeadership).  A new leader inherits committed entries
        it has not yet applied locally; reading or restoring from state
        before they land would schedule against a stale snapshot (e.g.
        re-running an eval whose plan already committed — the classic
        double-placement).  Returns False on timeout or shutdown."""
        deadline = self.clock.monotonic() + timeout
        with self._apply_cv:
            target = self._last_index()
            while (self.last_applied < target
                   and not self._stop.is_set()
                   and self.clock.monotonic() < deadline):
                # real-time backstop re-check (chaos/clock contract):
                # applies notify _apply_cv; the slice only bounds
                # staleness of the stop/deadline checks
                self._apply_cv.wait(0.05)
            return self.last_applied >= target

    # ------------------------------------------------------------ internals

    def _observe_append(self, entry: Entry) -> None:
        """Leader-side append hook for chaos invariants; an observer
        bug must never break consensus."""
        if self.append_observer is not None:
            try:
                self.append_observer(entry)
            except Exception:  # noqa: BLE001 - observer is test-side
                pass

    def _last_index(self) -> int:
        return self.log[-1].index if self.log else self.snap_index

    def _last_term(self) -> int:
        return self.log[-1].term if self.log else self.snap_term

    def _entry_at(self, index: int) -> Optional[Entry]:
        i = index - (self.snap_index + 1)
        if 0 <= i < len(self.log):
            return self.log[i]
        return None

    def _term_at(self, index: int) -> Optional[int]:
        if index == self.snap_index:
            return self.snap_term
        e = self._entry_at(index)
        return e.term if e is not None else None

    def _become_follower(self, term: int, leader: Optional[str]) -> None:
        was_leader = self.role == LEADER
        if was_leader:
            REGISTRY.inc("nomad.raft.leadership_lost", node=self.name)
        self.role = FOLLOWER
        if term > self.term:
            self.term = term
            self.voted_for = None
            self._persist_meta()
        if leader is not None:
            self.leader_name = leader
        elif self.leader_name == self.name:
            # stepping down with no successor known: clearing the stale
            # self-hint matters — forwarding would otherwise loop back to
            # this non-leader for the whole partition
            self.leader_name = None
        if was_leader:
            for idx, waiter in list(self._waiters.items()):
                if idx > self.commit_index:
                    waiter[1] = _Dropped()
                    waiter[0].set()
                    self._waiters.pop(idx, None)
            if self.on_follower:
                cb = self.on_follower
                threading.Thread(target=cb, daemon=True,
                                 name=f"raft-onfollower-{self.name}").start()

    def _tick_loop(self) -> None:
        while not self._stop.is_set():
            if self.role == LEADER:
                self._check_lease()
                self._replicate_once()
                self.clock.wait(self._stop, self.heartbeat_interval)
                continue
            timeout = random.uniform(*self.election_timeout)
            self.clock.wait(self._stop, 0.02)
            if (self.clock.monotonic() - self._last_contact) >= timeout:
                self._run_election()

    def _check_lease(self) -> None:
        """Leader lease: a leader that hasn't heard from a majority for a
        multiple of the election timeout steps down rather than lingering
        as a stale leader (its applies would only time out anyway, and a
        deaf-but-alive node must rejoin via a fresh election)."""
        lease = self.election_timeout[1] * 4
        now = self.clock.monotonic()
        with self._lock:
            if self.role != LEADER or not self.peers:
                return
            if now - self._lease_start < lease:
                return
            fresh = sum(1 for n in self.peers
                        if now - self._peer_ack.get(n, 0.0) < lease)
            needed = (len(self.peers) + 1) // 2 + 1
            if fresh + 1 < needed:
                log("raft", "warn", "leader lease lost; stepping down",
                    name=self.name, term=self.term)
                self._become_follower(self.term, None)
                self._last_contact = self.clock.monotonic()

    def _run_election(self) -> None:
        with self._lock:
            if self.role == LEADER or self._stop.is_set():
                return
            # bootstrap gate: only before the cluster has EVER formed
            # (empty log, term 0).  After that, elections must proceed
            # with whatever peer set remains — autopilot legitimately
            # shrinks it below the original bootstrap_expect.
            if (self.term == 0 and self._last_index() == 0
                    and len(self.peers) + 1 < self.bootstrap_expect):
                self._last_contact = self.clock.monotonic()
                return
            self.role = CANDIDATE
            self.term += 1
            self.voted_for = self.name
            self._persist_meta()
            term = self.term
            last_idx, last_term = self._last_index(), self._last_term()
            peers = dict(self.peers)
            self._last_contact = self.clock.monotonic()
        votes = 1
        needed = (len(peers) + 1) // 2 + 1
        results = []
        threads = []

        def ask(addr):
            # vote-collector daemon thread: a transport failure is just
            # a missing vote, never a dead thread
            try:
                results.append(self.transport.request(addr, {
                    "type": "vote_req", "term": term, "cand": self.name,
                    "last_idx": last_idx, "last_term": last_term},
                    timeout=0.5, channel="raft"))
            except Exception:  # noqa: BLE001 - count as no vote
                results.append(None)

        for peer_name, addr in peers.items():
            t = threading.Thread(target=ask, daemon=True, args=(addr,),
                                 name=f"raft-vote-{self.name}->{peer_name}")
            t.start()
            threads.append(t)
        for t in threads:
            t.join(timeout=0.6)
        for r in results:
            if r is None:
                continue
            if r.get("term", 0) > term:
                with self._lock:
                    self._become_follower(r["term"], None)
                return
            if r.get("granted"):
                votes += 1
        with self._lock:
            if self.role != CANDIDATE or self.term != term:
                return
            if votes >= needed:
                self._become_leader()

    def _become_leader(self) -> None:
        REGISTRY.inc("nomad.raft.leadership_transitions", node=self.name)
        self.role = LEADER
        self.leader_name = self.name
        self._lease_start = self.clock.monotonic()
        nxt = self._last_index() + 1
        for n in self.peers:
            self.next_index[n] = nxt
            self.match_index[n] = 0
        # no-op barrier entry: prior-term entries may only commit via a
        # committed entry of the CURRENT term (Raft §5.4.2); without it a
        # restarted/new leader never commits its replayed log
        noop = Entry(term=self.term, index=nxt, cmd=b"")
        self.log.append(noop)
        self._persist_entry(noop)
        self._observe_append(noop)
        if not self.peers:
            self.commit_index = noop.index
            self._apply_cv.notify_all()
        log("raft", "info", "leadership won", name=self.name, term=self.term)
        if self.on_leader:
            cb = self.on_leader
            threading.Thread(target=cb, daemon=True,
                             name=f"raft-onleader-{self.name}").start()

    def _replicate_once(self) -> None:
        """Kick every per-peer replicator."""
        with self._lock:
            kicks = list(self._peer_kick.values())
        for k in kicks:
            k.set()

    def _replicator_loop(self, name: str) -> None:
        """Long-lived replication pump for one peer: sends on apply-kick
        or heartbeat timeout over ONE persistent connection (reconnect on
        error), exits when the peer is removed."""
        conn: Optional[Connection] = None
        try:
            while not self._stop.is_set():
                with self._lock:
                    if name not in self.peers:
                        return
                    addr = self.peers[name]
                    kick = self._peer_kick.get(name)
                    is_leader = self.role == LEADER
                if is_leader:
                    try:
                        conn = self._replicate_to(name, addr, conn)
                    except Exception as exc:  # noqa: BLE001 - pump must live
                        log("raft", "error", "replicate failed",
                            peer=name, error=str(exc))
                        if conn is not None:
                            conn.close()
                        conn = None
                if kick is None:
                    return
                self.clock.wait(kick, self.heartbeat_interval)
                kick.clear()
        except BaseException as exc:  # noqa: BLE001 - must never die silent
            log("raft", "error", "replicator died",
                peer=name, error=repr(exc))
            raise
        finally:
            if conn is not None:
                conn.close()

    def _peer_roundtrip(self, conn: Optional[Connection],
                        addr: Tuple[str, int], msg: dict,
                        ) -> Tuple[Optional[Connection], Optional[dict]]:
        """Send one message over the persistent peer connection,
        reconnecting once on failure.  Returns (connection, response).
        Connection.send re-encodes per attempt (fresh nonce — a
        byte-identical resend would trip the receiver's replay guard)
        and raises on a failed send, so a dead pipe triggers the
        immediate reconnect here instead of a silent recv timeout on a
        request that never left."""
        for attempt in range(2):
            if conn is None:
                try:
                    conn = self.transport.dial(addr, "raft", timeout=1.0)
                except OSError:
                    return None, None
            try:
                conn.send(msg)
                r = conn.recv(timeout=2.0)
                if r is not None:
                    return conn, r
            except (OSError, ValueError):
                pass
            conn.close()
            conn = None
        return None, None

    def _replicate_to(self, name: str, addr: Tuple[str, int],
                      conn: Optional[Connection] = None,
                      ) -> Optional[Connection]:
        with self._lock:
            if self.role != LEADER:
                return conn
            nxt = self.next_index.get(name, self._last_index() + 1)
            if nxt <= self.snap_index:
                # follower is behind the compacted prefix: serve from the
                # retained tail if it still covers nxt, else snapshot
                msg = self._tail_append_msg(nxt) or self._snapshot_msg()
            else:
                prev_idx = nxt - 1
                prev_term = self._term_at(prev_idx)
                if prev_term is None and prev_idx > self._last_index():
                    # defensive: next_index drifted past our log (stale
                    # match bookkeeping); resync from the top instead of
                    # stalling on a snapshot we may not have
                    self.next_index[name] = self._last_index() + 1
                    nxt = self.next_index[name]
                    prev_idx = nxt - 1
                    prev_term = self._term_at(prev_idx)
                if prev_term is None:
                    msg = self._snapshot_msg()
                else:
                    ents = [(e.term, e.index, e.cmd) for e in
                            self.log[nxt - self.snap_index - 1:
                                     nxt - self.snap_index - 1
                                     + MAX_APPEND_ENTRIES]]
                    msg = {"type": "append", "term": self.term,
                           "leader": self.name, "prev_idx": prev_idx,
                           "prev_term": prev_term, "entries": ents,
                           "commit": self.commit_index}
        if msg is None:
            return conn
        conn, r = self._peer_roundtrip(conn, addr, msg)
        if r is None:
            return conn
        self._peer_ack[name] = self.clock.monotonic()
        with self._lock:
            if r.get("term", 0) > self.term:
                self._become_follower(r["term"], None)
                return conn
            if self.role != LEADER:
                return conn
            if msg["type"] == "snap":
                self.next_index[name] = msg["last_idx"] + 1
                self.match_index[name] = msg["last_idx"]
            elif r.get("ok"):
                m = r.get("match", 0)
                self.match_index[name] = max(self.match_index.get(name, 0), m)
                self.next_index[name] = self.match_index[name] + 1
                self._advance_commit()
            else:
                hint = r.get("hint")
                self.next_index[name] = max(
                    1, hint if hint else self.next_index.get(name, 2) - 1)
        return conn

    def _tail_append_msg(self, nxt: int) -> Optional[dict]:
        """Append msg for a follower behind the compaction point, built
        from the replication tail (entries with index <= snap_index kept
        at compaction).  None when the tail doesn't cover nxt-1 — the
        prev entry's term must be known for the consistency check."""
        if not self._tail or nxt <= self._tail[0].index:
            return None
        base = self._tail[0].index
        prev_idx = nxt - 1
        prev_term = self._tail[prev_idx - base].term
        ents = [(e.term, e.index, e.cmd)
                for e in (self._tail[nxt - base:]
                          + self.log)[:MAX_APPEND_ENTRIES]]
        return {"type": "append", "term": self.term, "leader": self.name,
                "prev_idx": prev_idx, "prev_term": prev_term,
                "entries": ents, "commit": self.commit_index}

    def _snapshot_msg(self) -> Optional[dict]:
        """Ship the snapshot taken at the last compaction.  NEVER snapshot
        the live FSM here: this runs in a replication thread while the
        apply loop may have advanced last_applied past what it has
        actually applied — a fresh snapshot stamped with last_applied
        could omit committed commands forever.  Compaction snapshots are
        taken by the apply thread itself between batches, where
        fsm-applied == snap_index exactly."""
        if self._snap_data is None:
            return None
        return {"type": "snap", "term": self.term, "leader": self.name,
                "last_idx": self.snap_index,
                "last_term": self.snap_term,
                "data": self._snap_data}

    def _advance_commit(self) -> None:
        matches = sorted([self._last_index()]
                         + [self.match_index.get(n, 0) for n in self.peers],
                         reverse=True)
        majority = matches[len(matches) // 2]
        if majority > self.commit_index \
                and self._term_at(majority) == self.term:
            self.commit_index = majority
            self._apply_cv.notify_all()

    # ------------------------------------------------------------- serving

    def _listen_loop(self) -> None:
        backoff = 0.05
        while not self._stop.is_set():
            try:
                conn = self._listener.accept()
            except OSError:
                # transient failure (e.g. EMFILE) must NOT make the node
                # deaf — a deaf node never hears higher terms and lingers
                # as a stale leader forever.  Capped exponential backoff:
                # under a persistent fault (fd exhaustion) a fixed 50ms
                # retry is a busy loop that worsens the pressure
                if self._stop.is_set():
                    return
                self.clock.wait(self._stop, backoff)
                backoff = min(backoff * 2, 1.0)
                continue
            backoff = 0.05
            if self._stop.is_set():
                conn.close()
                return
            threading.Thread(target=self._serve_conn, daemon=True,
                             name=f"raft-serve-{self.name}",
                             args=(conn,)).start()

    def _serve_conn(self, conn: Connection) -> None:
        """Serve a connection until the peer closes it: replicators hold
        one persistent connection and pump many messages through it.
        Daemon thread: a handler blowing up mid-exchange must drop the
        connection (the replicator reconnects), not die silently."""
        try:
            while not self._stop.is_set():
                msg = conn.recv(timeout=10.0)
                if msg is None:
                    return
                handler = {"vote_req": self._on_vote_req,
                           "append": self._on_append,
                           "snap": self._on_snap}.get(msg.get("type"))
                if handler is None:
                    return
                resp = handler(msg)
                if resp is None:
                    return
                try:
                    conn.send(resp)
                except OSError:
                    return          # peer vanished mid-reply; it retries
        except Exception as exc:  # noqa: BLE001 - daemon thread
            log("raft", "debug", "conn serve failed", node=self.name,
                error=repr(exc))
        finally:
            conn.close()

    def _on_vote_req(self, m: dict) -> dict:
        with self._lock:
            if m["term"] > self.term:
                self._become_follower(m["term"], None)
            granted = False
            if m["term"] == self.term \
                    and self.voted_for in (None, m["cand"]):
                up_to_date = (m["last_term"], m["last_idx"]) >= \
                    (self._last_term(), self._last_index())
                if up_to_date:
                    granted = True
                    self.voted_for = m["cand"]
                    self._persist_meta()
                    self._last_contact = self.clock.monotonic()
            return {"term": self.term, "granted": granted}

    def _on_append(self, m: dict) -> dict:
        with self._lock:
            if m["term"] < self.term:
                return {"term": self.term, "ok": False}
            self._last_contact = self.clock.monotonic()
            if m["term"] > self.term or self.role != FOLLOWER:
                self._become_follower(m["term"], m["leader"])
            self.leader_name = m["leader"]
            prev_idx, prev_term = m["prev_idx"], m["prev_term"]
            if prev_idx > 0:
                t = self._term_at(prev_idx)
                if t is None:
                    return {"term": self.term, "ok": False,
                            "hint": self._last_index() + 1}
                if t != prev_term:
                    # conflict: drop the conflicting suffix
                    self.log = self.log[:prev_idx - self.snap_index - 1]
                    self._persist_log()
                    return {"term": self.term, "ok": False,
                            "hint": max(1, prev_idx)}
            appended = False
            truncated = False
            fresh: List[Entry] = []
            for term, index, cmd in m["entries"]:
                existing = self._entry_at(index)
                if existing is not None:
                    if existing.term == term:
                        continue
                    self.log = self.log[:index - self.snap_index - 1]
                    appended = truncated = True
                if index == self._last_index() + 1:
                    entry = Entry(term=term, index=index, cmd=cmd)
                    self.log.append(entry)
                    fresh.append(entry)
                    appended = True
            if truncated:
                self._persist_log()
            elif appended:
                # the log only grew: append the new entries to the
                # durable log, as the leader's apply does, instead of
                # rewriting every entry and the snapshot
                for entry in fresh:
                    self._persist_entry(entry)
            # match = the last index KNOWN to agree with the leader — NOT
            # our raw last_index: a longer stale suffix from a deposed
            # leader would inflate the leader's next_index past its own
            # log and stall replication forever (the leader would try to
            # ship a snapshot it does not have)
            ents = m["entries"]
            match = (ents[-1][1] if ents else prev_idx)
            if m["commit"] > self.commit_index:
                self.commit_index = min(m["commit"], match)
                self._apply_cv.notify_all()
            return {"term": self.term, "ok": True, "match": match}

    def _on_snap(self, m: dict) -> dict:
        with self._lock:
            if m["term"] < self.term:
                return {"term": self.term}
            self._last_contact = self.clock.monotonic()
            self._become_follower(m["term"], m["leader"])
            if m["last_idx"] <= self.last_applied:
                return {"term": self.term}
            if self.fsm_restore is not None:
                self.fsm_restore(m["data"])
            self._snap_data = m["data"]
            self.snap_index = m["last_idx"]
            self.snap_term = m["last_term"]
            self.log = []
            self._tail = []
            self.commit_index = max(self.commit_index, m["last_idx"])
            self.last_applied = m["last_idx"]
            self._persist_log()
            if self.install_observer is not None:
                try:
                    self.install_observer(m["last_idx"], m["last_term"])
                except Exception:  # noqa: BLE001 - observer is test-side
                    pass
            return {"term": self.term}

    # --------------------------------------------------------------- apply

    def _apply_loop(self) -> None:
        while not self._stop.is_set():
            with self._apply_cv:
                while (self.last_applied >= self.commit_index
                       and not self._stop.is_set()):
                    self._apply_cv.wait(timeout=0.5)
                if self._stop.is_set():
                    return
                batch = []
                while self.last_applied < self.commit_index:
                    idx = self.last_applied + 1
                    e = self._entry_at(idx)
                    if e is None:
                        break
                    batch.append(e)
                    self.last_applied = idx
            for e in batch:
                if self.fsm_observer is not None:
                    try:
                        self.fsm_observer(e)
                    except Exception:  # noqa: BLE001 - observer is test-side
                        pass
                if not e.cmd:          # leadership no-op barrier
                    continue
                try:
                    result = self.fsm_apply(e.cmd)
                    err = None
                except Exception as exc:  # noqa: BLE001 - FSM must not kill raft
                    result, err = None, exc
                    log("raft", "error", "fsm apply failed",
                        index=e.index, error=str(exc))
                with self._lock:
                    waiter = self._waiters.pop(e.index, None)
                if waiter is not None:
                    waiter[1] = err if err is not None else result
                    waiter[0].set()
            with self._lock:
                self._maybe_compact()

    def _maybe_compact(self) -> None:
        if self.fsm_snapshot is None \
                or len(self.log) <= self.max_log_entries:
            return
        # the snapshot must be taken at EXACTLY the FSM's applied index
        # (fsm_apply is not idempotent), so compaction always cuts at
        # last_applied; slightly-lagging followers are instead served
        # from the in-memory replication tail kept below
        new_snap_idx = self.last_applied
        cut = [e for e in self.log if e.index <= new_snap_idx]
        if not cut:
            return
        self._snap_data = self.fsm_snapshot()
        self.snap_term = self._term_at(new_snap_idx) or self.term
        self.snap_index = new_snap_idx
        self.log = [e for e in self.log if e.index > new_snap_idx]
        # replication-only tail: the most recent compacted entries, kept
        # in memory so a follower just behind the compaction point gets a
        # normal append instead of a full snapshot transfer.  Never used
        # for local replay (the durable snapshot covers these indexes)
        # and not persisted — losing it merely costs a laggard a
        # snapshot.  Contiguity holds: cut starts where the previous
        # tail ended (the old snap_index), and [-keep:] keeps a suffix.
        keep = max(1, self.max_log_entries // 2)   # [-0:] keeps ALL
        self._tail = (self._tail + cut)[-keep:]
        self._persist_log()

    # ---------------------------------------------------------- durability

    def _meta_path(self) -> str:
        return os.path.join(self.data_dir, f"raft-{self.name}.meta")

    def _log_path(self) -> str:
        return os.path.join(self.data_dir, f"raft-{self.name}.log")

    def _persist_meta(self) -> None:
        if not self.data_dir:
            return
        tmp = self._meta_path() + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump({"term": self.term, "voted_for": self.voted_for}, f)
        os.replace(tmp, self._meta_path())

    def _persist_entry(self, entry: Entry) -> None:
        if not self.data_dir:
            return
        with open(self._log_path(), "ab") as f:
            payload = pickle.dumps(entry)
            f.write(struct.pack(">I", len(payload)) + payload)

    def _persist_log(self) -> None:
        """Rewrite the durable log (suffix truncation / compaction).
        ALWAYS embeds the current compaction snapshot: this header is the
        snapshot's only durable home, so a rewrite that dropped it would
        leave a restarted node with snap_index > 0 but no bytes to
        restore — last_applied stuck at 0 behind a prefix that no longer
        exists in the log."""
        if not self.data_dir:
            return
        tmp = self._log_path() + ".tmp"
        with open(tmp, "wb") as f:
            hdr = pickle.dumps({"snap_index": self.snap_index,
                                "snap_term": self.snap_term,
                                "snapshot": self._snap_data})
            f.write(struct.pack(">I", len(hdr)) + hdr)
            for e in self.log:
                payload = pickle.dumps(e)
                f.write(struct.pack(">I", len(payload)) + payload)
        os.replace(tmp, self._log_path())

    def _restore_durable(self) -> None:
        try:
            with open(self._meta_path(), "rb") as f:
                meta = pickle.load(f)
                self.term = meta["term"]
                self.voted_for = meta["voted_for"]
        except (OSError, pickle.PickleError, EOFError, KeyError):
            pass
        try:
            with open(self._log_path(), "rb") as f:
                first = True
                while True:
                    hdr = f.read(4)
                    if len(hdr) < 4:
                        break
                    (n,) = struct.unpack(">I", hdr)
                    body = f.read(n)
                    if len(body) < n:
                        break
                    obj = pickle.loads(body)
                    if first and isinstance(obj, dict):
                        self.snap_index = obj.get("snap_index", 0)
                        self.snap_term = obj.get("snap_term", 0)
                        snap = obj.get("snapshot")
                        if snap is not None and self.fsm_restore is not None:
                            self.fsm_restore(snap)
                            self._snap_data = snap
                            self.last_applied = self.snap_index
                            self.commit_index = self.snap_index
                        first = False
                        continue
                    first = False
                    if isinstance(obj, Entry):
                        self.log.append(obj)
        except (OSError, pickle.PickleError, EOFError):
            pass


class _Dropped:
    """Sentinel result for entries lost to leadership loss before commit."""
