"""Multi-process scheduler worker plane — break the one-core ceiling.

PERF.md §16 measured the ceiling this module removes: thread workers
serialize on the GIL, so 2 workers are SLOWER than 1 (sustained evals/s
39.4 -> 22.3 while worker `gil_wait_fraction` climbs 0.47 -> 0.62).
The reference scheduler runs its workers as goroutines across cores;
this plane runs them as PROCESSES while keeping every single-owner
invariant of the landed planes intact:

  - N spawn-context worker processes (`pool-worker-<i>`) each run the
    UNCHANGED dequeue -> schedule -> submit-plan loop (core/worker.py)
    against a local StateStore REPLICA, fed by the parent's
    `export_since` snapshots + modify-index-keyed deltas
    (state/state_store.py) bundled onto every dequeue reply.
  - The Raft/plan-applier/broker plane stays single-process in the
    parent: children dequeue, ack/nack, submit plans, and write eval
    updates over an RPC channel (the `core/wire.py` codec over an OS
    pipe — data-only frames, never pickle), so partitioned-dequeue
    exclusivity, delivery tokens, and the applier's per-node fence are
    enforced exactly where they always were.
  - Device work funnels through a thin submission queue to the
    parent-owned DeviceExecutor (ops/executor.SubmissionFrontEnd): a
    child ships its batch's (job, tg, count) items + tie-break seeds,
    the parent packs/launches against its OWN snapshot, and the child
    gets back array-form decisions — the resident-buffer chain and
    sharded handles never leave the parent.  Each child owns a
    per-client chain slot, referenced over the wire by opaque handles,
    so cross-batch chaining works per worker without device buffers
    ever crossing a process boundary.
  - Scheduler types split: children serve the batchable types
    (POOL_SCHEDULERS); one in-parent thread worker keeps
    system/sysbatch/_core (those schedulers read the live store and
    packer directly).
  - Children run their own SamplingProfiler and ship snapshot docs up
    (`prof` notifies -> profiling.PROFILER.publish_remote), merged into
    the parent's capture bundles; submission-queue contention meters as
    the new `queue-wait` bucket.

Crash safety: a dead child's outstanding deliveries are nacked (which
invalidates their tokens, so any orphaned in-flight plan is rejected at
the applier's token check), its chain slot and pending waves are
dropped, and the process is respawned (bounded).  Thread mode stays the
default everywhere — seeded VirtualClock soaks and chaos replays are
byte-identical to pre-pool builds.

Differences from the reference (nomad_tpu/core/workerpool.py), because
the port runs its kernels on the card and never their plain versions
beside it:
  - a child has no PlacementEngine.  The reference's child builds one on
    CPU JAX for the solo path (`sched.process` -> `engine.place`: spread
    and device jobs, small counts); here the child's engine is a
    `_RemoteEngine` that keeps the host-side packer (attached to the
    replica) and forwards `place` over the channel as the `place` op:
    the job, its task groups, the requests or the (task group, count)
    block, the ids of the allocs the plan stops, the seed and the
    in-plan device assignments.  The parent serves it through the same
    SubmissionFrontEnd as the waves, against its own snapshot and its
    engine on the card (K8, K1, K5 or K6, K7).  Every other device entry
    of a child's engine raises;
  - a child sets CUDA_VISIBLE_DEVICES="" first thing, before anything
    in it can initialize CUDA (the reference sets JAX_PLATFORMS=cpu in
    the parent around the spawn; the port leaves the parent's
    environment alone, which other threads' subprocesses inherit), so
    a stray CUDA call in a child fails loud.  Each child reports on
    its report cadence whether CUDA was initialized in it, its kernel
    launches and eager device ops (both 0), and its bootstrap:
    `pool_stats()["children"]`;
  - the run and stop gates the children poll are lock-free shared
    flags (`_Flag`), not multiprocessing Events: a child killed while it
    waited on the reference's stop Event leaves the Event's condition
    waiting for it, and the parent's next set() or clear() (resume,
    pause, shutdown) hangs;
  - the parent's collect waits on the wave's CUDA event under the
    `device-wait` marker (as WavePipeline.collect does) before it
    expands the decisions; the pending wave's tensors and events never
    leave the parent.
"""

from __future__ import annotations

import itertools
import multiprocessing as mp
import os
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional

from nomad_tpu_torch.chaos.clock import SystemClock
from nomad_tpu_torch.core import wire
from nomad_tpu_torch.core.logging import log

# eval types the pool children serve (the batchable types: their
# GenericScheduler path reconciles host-side against a snapshot and
# places through the device funnel) vs the types the parent's single
# thread worker keeps (system/sysbatch iterate live nodes; _core GC
# mutates the store directly)
POOL_SCHEDULERS = ["service", "batch", "service-tpu", "batch-tpu"]
PARENT_SCHEDULERS = ["system", "sysbatch", "_core"]

# per-child bound on parked pending waves a child may reference later
# (chain refs); beyond this the oldest is dropped — its chain simply
# cannot be ridden, which is a fresh re-sync, never an error
_PENDING_CAP = 8

_RESPAWN_CAP = 3


def _ensure_wire_types() -> None:
    """The pool ships structs dataclasses (state exports, evals, plans)
    plus ops/engine ones (BatchItem, BulkDecisions); register all of
    them with the data-only codec.  Structs must be explicit here: the
    codec's lazy default only fires while its registry is EMPTY, and we
    are about to put engine types in it."""
    import nomad_tpu_torch.ops.engine as engine_mod
    import nomad_tpu_torch.structs as structs
    import nomad_tpu_torch.structs.structs as structs_impl
    wire.register_module(structs)
    wire.register_module(structs_impl)
    wire.register_module(engine_mod)


# =====================================================================
# child side
# =====================================================================

class _ChannelClosed(RuntimeError):
    """The parent went away (or is tearing the pool down)."""


class _Channel:
    """Child half of the RPC pipe: rid-multiplexed request/reply plus
    fire-and-forget notifies.  One reader thread resolves replies; any
    thread may call() (the worker) or notify() (the profiling
    reporter) concurrently under the send lock."""

    def __init__(self, conn) -> None:
        self._conn = conn
        self._send_lock = threading.Lock()
        self._lock = threading.Lock()
        self._rid = itertools.count(1)
        # rid -> [event, payload, ok]
        self._waiters: Dict[int, list] = {}
        self.closed = threading.Event()
        self._reader = threading.Thread(
            target=_channel_read_main, args=(self,),
            name="pool-rpc-reader", daemon=True)
        self._reader.start()

    def _read_loop(self) -> None:
        try:
            while True:
                rid, ok, data = wire.unpackb(self._conn.recv_bytes())
                with self._lock:
                    rec = self._waiters.pop(rid, None)
                if rec is not None:
                    rec[1], rec[2] = data, ok
                    rec[0].set()
        except (EOFError, OSError, ValueError):
            pass
        self.closed.set()
        with self._lock:
            waiters, self._waiters = dict(self._waiters), {}
        for rec in waiters.values():
            rec[1], rec[2] = "pool channel closed", False
            rec[0].set()

    def _send(self, msg) -> None:
        if self.closed.is_set():
            raise _ChannelClosed("pool channel closed")
        try:
            # the send lock guards nothing but this write: it exists
            # precisely to serialize (blocking) pipe sends per channel
            with self._send_lock:
                self._conn.send_bytes(wire.packb(msg))  # analyze: ok lockorder
        except (OSError, ValueError, BrokenPipeError) as e:
            self.closed.set()
            raise _ChannelClosed(str(e))

    def call(self, op: str, payload=None, timeout: float = 300.0):
        rid = next(self._rid)
        evt = threading.Event()
        rec = [evt, None, False]
        with self._lock:
            self._waiters[rid] = rec
        self._send([rid, op, payload])
        if not evt.wait(timeout):
            with self._lock:
                self._waiters.pop(rid, None)
            raise _ChannelClosed(f"pool rpc {op!r} timed out")
        if not rec[2]:
            raise _ChannelClosed(f"pool rpc {op!r} failed: {rec[1]}")
        return rec[1]

    def notify(self, op: str, payload=None) -> None:
        self._send([None, op, payload])


def _channel_read_main(chan: "_Channel") -> None:
    # top-level handler: a torn frame must close the channel, never
    # kill the process with an unhandled thread exception
    try:
        chan._read_loop()
    except Exception:  # noqa: BLE001 - reader isolation
        chan.closed.set()


class _BrokerProxy:
    """Child-side EvalBroker facade: every dequeue/ack/nack round-trips
    to the parent's real broker, so tokens, per-job serialization, and
    partitioned-dequeue exclusivity hold POOL-WIDE.  Dequeue replies
    piggyback a state export; the replica is caught up BEFORE the evals
    are returned, so the worker's wait_for_index is already satisfied."""

    def __init__(self, chan: _Channel, state, run_evt, idx: int) -> None:
        self._chan = chan
        self._state = state
        self._run_evt = run_evt
        self._idx = idx
        self._pause_acked = False

    def dequeue(self, schedulers, now, timeout=None):
        batch = self.dequeue_batch(schedulers, 1, now, timeout=timeout)
        return (batch[0][0], batch[0][1]) if batch else (None, "")

    def dequeue_batch(self, schedulers, max_n, now, timeout=None):
        if not self._run_evt.is_set():
            # paused (or not yet resumed).  The prefetch dequeue passes
            # timeout=0.0 mid-batch — only the TOP-of-loop dequeue acks,
            # so an ack means this worker is fully drained.
            if timeout:
                if not self._pause_acked:
                    self._pause_acked = True
                    try:
                        self._chan.notify("pause_ack", {"idx": self._idx})
                    except _ChannelClosed:
                        pass
                threading.Event().wait(0.02)
            return []
        self._pause_acked = False
        try:
            reply = self._chan.call("deq", {
                "max_n": int(max_n),
                "timeout": float(timeout or 0.0),
                "since": self._state.latest_index()})
        except _ChannelClosed:
            return []
        export = reply.get("export")
        if export and export.get("kind") != "empty":
            self._state.apply_export(export)
        return [(ev, tok) for ev, tok in reply["batch"]]

    def ack(self, eval_id, token):
        try:
            self._chan.call("ack", {"id": eval_id, "tok": token})
        except _ChannelClosed:
            pass

    def nack(self, eval_id, token, now=0.0):
        try:
            self._chan.call("nack", {"id": eval_id, "tok": token})
        except _ChannelClosed:
            pass

    def extend_outstanding(self, pairs, now):
        try:
            self._chan.notify("extend", {"pairs": [list(p) for p in pairs]})
        except _ChannelClosed:
            pass


class _RemotePendingPlan:
    """Child-side handle for a plan enqueued on the parent's queue."""

    def __init__(self, chan: _Channel, pid: int, state) -> None:
        self._chan = chan
        self._pid = pid
        self._state = state

    def wait(self, timeout: float = 30.0):
        try:
            reply = self._chan.call(
                "plan_wait", {"pid": self._pid, "timeout": timeout,
                              "since": self._state.latest_index()},
                timeout=timeout + 60.0)
        except _ChannelClosed as e:
            return None, e
        # every verdict carries the parent's journal delta: the replica
        # tracks commits (other workers' included) at plan-apply cadence
        # — the same view a thread worker gets from the shared store —
        # instead of advancing only at the next dequeue
        export = reply.get("export")
        if export and export.get("kind") != "empty":
            self._state.apply_export(export)
        err = reply.get("err")
        return reply.get("result"), (RuntimeError(err) if err else None)


class _PlanQueueProxy:
    def __init__(self, chan: _Channel, state) -> None:
        self._chan = chan
        self._state = state

    def enqueue(self, plan):
        pid = self._chan.call("plan", {"plan": plan})
        return _RemotePendingPlan(self._chan, pid, self._state)


class _ChildServer:
    """The Server facade a pooled Worker runs against: replica state,
    wall clock, proxied broker/plan-queue, a local engine for solo
    fallbacks, and the remote device executor for the batched path."""

    dev_mode = False
    # replica staleness needs more optimistic-retry headroom than the
    # shared store's near-immediate visibility (scheduler/generic.py
    # adds this on top of the reference attempt limits)
    schedule_attempt_boost = 2

    def __init__(self, state, chan: _Channel, engine, executor,
                 eval_batch: int, run_evt, idx: int) -> None:
        self.state = state
        self.clock = SystemClock()
        self.engine = engine
        self.executor = executor
        self.stage_timers = None        # each child times its own waves
        self.eval_batch = eval_batch
        self.eval_broker = _BrokerProxy(chan, state, run_evt, idx)
        self.plan_queue = _PlanQueueProxy(chan, state)
        self._chan = chan

    def maybe_apply_inline(self, pending) -> None:
        """The parent's applier thread owns every commit."""

    def refresh_state(self) -> None:
        """Pull the parent's journal delta into the replica NOW.  The
        refute-retry path must see the refuting writes (another
        worker's committed ports, usually) before it re-places; without
        this the replica only advances at the next dequeue and the
        retry re-picks the exact colliding assignment until the
        delivery limit kills the eval."""
        try:
            export = self._chan.call(
                "pull", {"since": self.state.latest_index()})
        except _ChannelClosed:
            return
        if export and export.get("kind") != "empty":
            self.state.apply_export(export)

    def apply_eval_update(self, evals, now=None) -> None:
        evals = list(evals)
        if not evals:
            return
        try:
            self._chan.call("evup", {"evals": evals})
        except _ChannelClosed:
            pass


class _RemoteEngine:
    """A child's PlacementEngine stand-in.  It keeps the host-side
    packer (attached to the replica) and sends `place` to the parent,
    whose engine runs the kernels on the card against the parent's
    snapshot; the batched path reaches the parent through the remote
    executor.  Every other device entry raises: a child never runs a
    kernel or its plain version."""

    def __init__(self, chan: _Channel, packer) -> None:
        self._chan = chan
        self.packer = packer

    def place(self, snapshot, job, tgs, requests, tensors=None,
              stopped_allocs=(), bulk_api: bool = False, seed: int = 0,
              device_in_use=None, block=None):
        """PlacementEngine.place, served by the parent (`snapshot` is
        the replica's: the parent places against its own)."""
        from nomad_tpu_torch.core import profiling
        if tensors is not None:
            raise RuntimeError("a pool child has no node tensors")
        in_use = None
        if device_in_use is not None:
            in_use = [[nid, gid, sorted(ids)]
                      for nid, gid, ids in device_in_use.items()]
        with profiling.activity("device-wait"):
            return self._chan.call("place", {
                "job": job, "tgs": list(tgs),
                "requests": None if requests is None else list(requests),
                "block": None if block is None else list(block),
                "stopped": [a.id for a in stopped_allocs],
                "bulk_api": bool(bulk_api), "seed": int(seed),
                "in_use": in_use})

    def _parent_only(self, *args, **kwargs):
        raise RuntimeError("device work of a pool child runs in the "
                           "parent (the remote executor, or `place`)")

    dispatch_batch = collect_batch = place_batch = _parent_only
    build_multi_inputs = job_masks = _parent_only


def _make_remote_executor(chan: _Channel, engine):
    """Build the child-side DeviceExecutor proxy.  Defined as a factory
    so importing this module never imports the ops package (torch) —
    the parent has it loaded already; the child pays it once here."""
    from nomad_tpu_torch.core import profiling
    from nomad_tpu_torch.ops.executor import DeviceExecutor

    class _RemoteExecutor(DeviceExecutor):
        """Proxies the wave launch/collect/chain surface to the
        parent-owned executor behind its submission queue.  Pending
        waves are opaque {pid} dicts (no "buf" key, so the wave
        pipeline's sync point is the collect RPC itself); chain state
        is an opaque ref resolved parent-side into the child's
        per-client chain slot."""

        name = "pool-remote"

        def __init__(self) -> None:
            super().__init__(engine)
            self._chan = chan

        def dispatch_batch(self, snapshot, items, seed=0,
                           used0_dev=None, masked_node_ids=None):
            if not items:
                return None
            seeds = (int(seed) if isinstance(seed, int)
                     else [int(s) for s in seed])
            reply = self._chan.call("dispatch", {
                "items": list(items), "seeds": seeds,
                "chain": used0_dev,
                "masked": sorted(masked_node_ids)
                if masked_node_ids else None})
            kind = reply["kind"]
            if kind == "none":
                return None
            if kind == "sentinel":
                # same shape engine.build_multi_inputs returns for an
                # empty cluster; collect expands it locally
                return (None, list(items))
            pending = dict(reply["pending"])
            self._note_dispatch(pending, used0_dev is not None)
            return pending

        def collect_batch(self, pending):
            if pending is None:
                return []
            if not isinstance(pending, dict):
                # the empty-cluster sentinel: no decision for any item
                return [None] * len(pending[1])
            with profiling.activity("device-wait"):
                reply = self._chan.call(
                    "collect", {"pid": pending["pid"]})
            node_ids = reply["node_ids"]
            out = []
            for d in reply["decisions"]:
                if d is not None:
                    # node_ids ships ONCE per batch (a shared
                    # row->node-id table); reattach it
                    d.node_ids = node_ids
                out.append(d)
            return out

        def chain_state(self, pending):
            if not isinstance(pending, dict):
                return None
            return {"pid": pending["pid"]}

        def claim_chain(self, client: str = ""):
            reply = self._chan.call("chain_claim", None)
            if reply is None:
                return None
            return (reply["bid"], reply["seq0"],
                    {"tok": reply["tok"]},
                    frozenset(reply.get("masked") or ()))

        def retain_chain(self, batch_id, seq0, used_triple,
                         masked=None, client: str = "") -> None:
            if used_triple is None or not batch_id:
                return
            try:
                self._chan.call("chain_retain", {
                    "bid": batch_id, "seq0": seq0, "ref": used_triple,
                    "masked": sorted(masked or ())})
            except _ChannelClosed:
                pass

        def invalidate(self, reason: str = "explicit") -> None:
            """Parent-side invalidation triggers handle this."""

        def attach_store(self, store) -> None:
            pass

        def close(self) -> None:
            pass

    return _RemoteExecutor()


def _sanitize_log_rec(rec: Dict) -> Dict:
    """Log fields may carry arbitrary objects; the wire codec must not
    be the reason a warn record kills the reporter."""
    out = {}
    for k, v in rec.items():
        out[str(k)] = (v if isinstance(v, (str, int, float, bool))
                       or v is None else repr(v))
    return out


def _child_state(idx: int, boot: Dict) -> Dict:
    """What the parent's pool_stats shows of this child: whether CUDA
    was initialized here, the kernel launches and eager device ops this
    process made (a child makes none), and its bootstrap."""
    import torch

    from nomad_tpu_torch.ops import kernels as K
    return {"idx": idx, "pid": os.getpid(),
            "cuda_initialized": bool(torch.cuda.is_initialized()),
            "launches": sum(k.launches for k in K.KERNELS),
            "eager_ops": sum(K.EAGER.values()), **boot}


def _report_loop(chan: _Channel, stop_evt, idx: int, boot: Dict) -> None:
    from nomad_tpu_torch.core import profiling
    from nomad_tpu_torch.core.logging import LEVELS, RING
    from nomad_tpu_torch.core.timeline import TIMELINE
    # warn+ records ship to the parent ring: a child's nack reasons and
    # scheduler errors must be visible from the one process an operator
    # actually tails (logging.RING is per-process)
    logq = RING.subscribe(maxsize=512)
    tl_seq = 0   # high-water mark of timeline writes already shipped
    while not stop_evt.wait(0.5):
        if chan.closed.is_set():
            return
        recs = []
        try:
            while True:
                rec = logq.get_nowait()
                if rec and LEVELS.get(rec.get("level"), 2) >= LEVELS["warn"]:
                    recs.append(_sanitize_log_rec(rec))
        except Exception:  # noqa: BLE001 - queue.Empty ends the drain
            pass
        try:
            if recs:
                chan.notify("logs", {"idx": idx, "recs": recs[-50:]})
            chan.notify("state", _child_state(idx, boot))
            chan.notify("prof",
                        {"idx": idx,
                         "snapshot": profiling.PROFILER.snapshot()})
            # retrospective timeline (core/timeline.py): sample this
            # process's registry on the report cadence and ship only
            # what the parent hasn't seen — the parent folds the rows
            # in under `col@pool-N` series names
            TIMELINE.sample()
            delta = TIMELINE.export_delta(since_seq=tl_seq)
            if delta["Samples"] or delta["Annotations"]:
                chan.notify("tl", {"idx": idx, "delta": delta})
            tl_seq = delta["Seq"]
        except _ChannelClosed:
            return


def _report_main(chan: _Channel, stop_evt, idx: int, boot: Dict) -> None:
    # top-level handler: the reporter is telemetry; it must never take
    # the worker process down
    try:
        _report_loop(chan, stop_evt, idx, boot)
    except Exception:  # noqa: BLE001 - reporter isolation
        pass


def _child_run(idx: int, conn, stop_evt, run_evt, cfg: Dict) -> None:
    # the child never owns device hardware: hide the card before
    # anything here can reach CUDA, so that any CUDA call fails loud.
    # CUDA reads the variable when it initializes, lazily; the spawn
    # bootstrap before this line only imports (this module, its
    # imports and the parent's __main__), and importing torch does not
    # initialize CUDA
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    _ensure_wire_types()
    chan = _Channel(conn)
    chan.call("ready", {"idx": idx})
    from nomad_tpu_torch.core import profiling
    from nomad_tpu_torch.core.worker import Worker
    from nomad_tpu_torch.pack.packer import ClusterPacker
    from nomad_tpu_torch.state import StateStore

    # Shard the dynamic-port scan: each child starts its first-fit
    # cursor in a disjoint region of the range (the parent keeps the
    # bottom), so workers placing networked groups on one node against
    # the same snapshot pick non-overlapping ports instead of all
    # taking first-fit-from-the-bottom and refuting at the applier.
    from nomad_tpu_torch.structs.funcs import set_dynamic_port_scan_base
    from nomad_tpu_torch.structs.structs import (MAX_DYNAMIC_PORT,
                                                 MIN_DYNAMIC_PORT)
    shards = int(cfg.get("n_workers", 1)) + 1
    span = MAX_DYNAMIC_PORT - MIN_DYNAMIC_PORT + 1
    set_dynamic_port_scan_base(
        MIN_DYNAMIC_PORT + ((idx + 1) * span) // shards, rotate=True)

    # bootstrap: the parent's full journal into the replica (set-up,
    # reported as bootstrap_s; the parent counts its bytes)
    t0 = time.perf_counter()
    replica = StateStore()
    export = chan.call("pull", {"since": 0})
    if export and export.get("kind") != "empty":
        replica.apply_export(export)
    del export
    boot = {"bootstrap_s": time.perf_counter() - t0}
    engine = _RemoteEngine(chan, ClusterPacker())
    engine.packer.attach(replica)
    executor = _make_remote_executor(chan, engine)
    shim = _ChildServer(replica, chan, engine, executor,
                        int(cfg.get("eval_batch", 64)), run_evt, idx)
    hz = cfg.get("profile_hz")
    profiling.configure(hz=hz)
    reporter = threading.Thread(
        target=_report_main, args=(chan, stop_evt, idx, boot),
        name=f"pool-report-{idx}", daemon=True)
    reporter.start()
    worker = Worker(shim, worker_id=idx, served=POOL_SCHEDULERS)
    worker.start()
    try:
        while not stop_evt.wait(0.05):
            if chan.closed.is_set():
                break
    finally:
        worker.stop()


def pool_worker_main(idx: int, conn, stop_evt, run_evt,
                     cfg: Dict) -> None:
    """Process entry point for one pool worker (spawn target — must be
    importable top-level)."""
    # top-level handler: a crashing worker process must exit cleanly so
    # the parent's attendant sees EOF and runs crash recovery
    try:
        _child_run(idx, conn, stop_evt, run_evt, cfg)
    except Exception as exc:  # noqa: BLE001 - child isolation
        import traceback
        traceback.print_exc()
        log("workerpool", "error", "pool worker died",
            worker=idx, error=repr(exc))
    finally:
        try:
            conn.close()
        except OSError:
            pass


# =====================================================================
# parent side
# =====================================================================

class _Child:
    """Parent-side bookkeeping for one worker process."""

    def __init__(self, idx: int) -> None:
        self.idx = idx
        self.client = f"pool-{idx}"
        self.proc = None
        self.conn = None
        self.thread: Optional[threading.Thread] = None
        # eval_id -> delivery token for every undrained delivery
        self.outstanding: Dict[str, str] = {}
        # pid -> real parent-side pending wave (chain-ref resolution)
        self.pendings: "OrderedDict[int, dict]" = OrderedDict()
        # claim token -> claimed chain triple awaiting its dispatch
        self.chains: Dict[int, tuple] = {}
        # plan id -> PendingPlan awaiting plan_wait
        self.plans: Dict[int, object] = {}
        self.pid_seq = itertools.count(1)
        self.tok_seq = itertools.count(1)
        self.paused = threading.Event()
        self.respawns = 0
        # the child's latest `state` report (_child_state), the packed
        # bytes of its bootstrap pull, and the device work it sent
        self.report: Dict = {}
        self.reports = 0
        self.boot_bytes = 0
        self.dispatches = 0


def _attend_main(pool: "WorkerPool", child: _Child) -> None:
    """Attendant thread entry (one per child): serve the child's RPCs
    until EOF, then run crash/teardown recovery."""
    # top-level handler: recovery must run even if serving throws
    try:
        pool._serve(child)
    except Exception as exc:  # noqa: BLE001 - attendant isolation
        log("workerpool", "warn", "pool attendant failed",
            worker=child.idx, error=repr(exc))
    try:
        pool._on_child_gone(child)
    except Exception as exc:  # noqa: BLE001 - recovery isolation
        log("workerpool", "error", "pool child recovery failed",
            worker=child.idx, error=repr(exc))


class _Flag:
    """A process-shared boolean with Event's set/clear/is_set/wait, and
    no lock: a child killed at any point cannot leave it held.  (A
    multiprocessing Event counts the sleepers of its condition; a child
    killed inside wait() leaves one behind, and the parent's next set()
    waits for it forever.)  `wait` polls every 10 ms."""

    def __init__(self, ctx) -> None:
        self._v = ctx.RawValue("b", 0)

    def set(self) -> None:
        self._v.value = 1

    def clear(self) -> None:
        self._v.value = 0

    def is_set(self) -> bool:
        return bool(self._v.value)

    def wait(self, timeout: float) -> bool:
        end = time.monotonic() + timeout
        while not self._v.value:
            left = end - time.monotonic()
            if left <= 0:
                return False
            time.sleep(min(left, 0.01))
        return True


class WorkerPool:
    """Parent-side owner of the worker processes: spawns them, serves
    their RPCs against the Server's broker/state/plan-queue/device
    front-end, merges their profiling docs, and recovers crashes."""

    def __init__(self, server, num_workers: int) -> None:
        self.server = server
        self.num_workers = int(num_workers)
        self.front = server.device_front
        self._ctx = mp.get_context("spawn")
        # shared run/stop gates: run cleared = children spin down to an
        # acked pause between batches; stop set = children exit
        self._run_evt = _Flag(self._ctx)
        self._stop_evt = _Flag(self._ctx)
        self._children = [_Child(i) for i in range(self.num_workers)]
        self._lock = threading.Lock()
        self._started = False
        self._closing = False
        self.stats = {"respawns": 0, "plans": 0, "dispatches": 0,
                      "dequeues": 0, "places": 0,
                      # replica-journal accounting (parent side): the
                      # children's journals live across the process
                      # boundary, so the ledger charges the wire — every
                      # reply that carried an export_since doc counts
                      # its packed bytes here
                      "export_replies": 0, "export_bytes": 0}

    # ----------------------------------------------------- lifecycle

    def ensure_started(self) -> None:
        with self._lock:
            if self._started or self._closing:
                return
            self._started = True
        _ensure_wire_types()
        for child in self._children:
            self._spawn(child)

    def _spawn(self, child: _Child) -> None:
        parent_conn, child_conn = self._ctx.Pipe()
        cfg = {"eval_batch": getattr(self.server, "eval_batch", 64),
               "profile_hz": self._child_profile_hz(),
               "n_workers": len(self._children)}
        # the parent's environment is left alone (other threads of an
        # Agent start plugins and tasks that must see the card): the
        # child hides the card itself, first thing in _child_run
        proc = self._ctx.Process(
            target=pool_worker_main,
            name=f"pool-worker-{child.idx}",
            args=(child.idx, child_conn, self._stop_evt,
                  self._run_evt, cfg),
            daemon=True)
        proc.start()
        child_conn.close()
        child.proc = proc
        child.conn = parent_conn
        child.paused.clear()
        child.thread = threading.Thread(
            target=_attend_main, args=(self, child),
            name=f"pool-attend-{child.idx}", daemon=True)
        child.thread.start()

    def _child_profile_hz(self):
        from nomad_tpu_torch.core import profiling
        p = profiling.PROFILER
        return p.hz if p.running else 0

    def pause(self, wait: bool = True) -> None:
        """Quiesce: children finish their in-flight batch and park at
        the top of the dequeue loop (acked).  The plan queue stays
        valid — pause before stopping the applier, resume after it is
        back."""
        self._run_evt.clear()
        if not wait:
            return
        for child in self._children:
            if child.proc is not None and child.proc.is_alive():
                child.paused.wait(timeout=30.0)

    def resume(self) -> None:
        for child in self._children:
            child.paused.clear()
        self._run_evt.set()

    def close(self) -> None:
        with self._lock:
            self._closing = True
        self._run_evt.clear()
        self._stop_evt.set()
        for child in self._children:
            proc = child.proc
            if proc is not None:
                proc.join(timeout=10.0)
                if proc.is_alive():
                    proc.terminate()
                    proc.join(timeout=5.0)
            conn = child.conn
            if conn is not None:
                try:
                    conn.close()
                except OSError:
                    pass
            if (child.thread is not None
                    and child.thread is not threading.current_thread()):
                child.thread.join(timeout=5.0)

    def alive_workers(self) -> int:
        return sum(1 for c in self._children
                   if c.proc is not None and c.proc.is_alive())

    def pool_stats(self) -> Dict:
        out = dict(self.stats)
        out["workers"] = self.num_workers
        out["alive"] = self.alive_workers()
        out.update({f"queue_{k}": v
                    for k, v in self.front.stats.items()})
        out["children"] = [
            {**c.report, "idx": c.idx, "respawns": c.respawns,
             "alive": c.proc is not None and c.proc.is_alive(),
             "bootstrap_bytes": c.boot_bytes, "reports": c.reports,
             "dispatches": c.dispatches}
            for c in self._children]
        return out

    def mem_stats(self) -> Dict:
        """Ledger sizer (core/memledger): parent-side bookkeeping for
        the children (outstanding eval tokens, queued plan handles,
        chain refs) plus the cumulative replica-sync wire bytes — the
        children's actual journals are across the process boundary, so
        shipped bytes are the honest proxy the ledger can audit."""
        entries = sum(len(c.outstanding) + len(c.plans)
                      + len(c.chains) + len(c.pendings)
                      for c in self._children)
        return {"bytes": 4096 * len(self._children) + 192 * entries,
                "entries": entries, "cap": 0, "evictions": 0,
                "export_replies": self.stats["export_replies"],
                "export_bytes_shipped": self.stats["export_bytes"],
                "gauges": {"nomad.pool.export_bytes":
                           self.stats["export_bytes"]}}

    # ------------------------------------------------------- serving

    def _serve(self, child: _Child) -> None:
        conn = child.conn
        while True:
            try:
                msg = wire.unpackb(conn.recv_bytes())
            except (EOFError, OSError, ValueError, BrokenPipeError):
                return
            rid, op, payload = msg
            try:
                result = self._handle(child, op, payload)
                ok = True
            except Exception as e:  # noqa: BLE001 - reply, don't die
                result, ok = f"{type(e).__name__}: {e}", False
            if rid is not None:
                try:
                    blob = wire.packb([rid, ok, result])
                    if op == "pull" and not child.boot_bytes:
                        child.boot_bytes = len(blob)
                    if (ok and isinstance(result, dict)
                            and ("export" in result
                                 or "kind" in result)):
                        self.stats["export_replies"] += 1
                        self.stats["export_bytes"] += len(blob)
                    conn.send_bytes(blob)
                except (OSError, ValueError, BrokenPipeError):
                    return

    def _handle(self, child: _Child, op: str, payload):
        server = self.server
        if op == "deq":
            self.stats["dequeues"] += 1
            now = server.clock.time()
            # short broker wait keeps the attendant responsive to EOF
            timeout = min(float(payload.get("timeout") or 0.0), 0.2)
            batch = server.eval_broker.dequeue_batch(
                POOL_SCHEDULERS, int(payload["max_n"]), now=now,
                timeout=timeout)
            for ev, tok in batch:
                child.outstanding[ev.id] = tok
            export = server.state.export_since(
                int(payload.get("since") or 0))
            return {"batch": batch, "export": export}
        if op == "ack":
            child.outstanding.pop(payload["id"], None)
            server.eval_broker.ack(payload["id"], payload["tok"])
            return None
        if op == "nack":
            child.outstanding.pop(payload["id"], None)
            server.eval_broker.nack(payload["id"], payload["tok"],
                                    now=server.clock.time())
            return None
        if op == "extend":
            server.eval_broker.extend_outstanding(
                [(p[0], p[1]) for p in payload["pairs"]],
                now=server.clock.time())
            return None
        if op == "evup":
            server.apply_eval_update(payload["evals"],
                                     now=server.clock.time())
            return None
        if op == "plan":
            self.stats["plans"] += 1
            pending = server.plan_queue.enqueue(payload["plan"])
            server.maybe_apply_inline(pending)
            pid = next(child.pid_seq)
            child.plans[pid] = pending
            return pid
        if op == "plan_wait":
            pending = child.plans.pop(int(payload["pid"]), None)
            if pending is None:
                return {"result": None, "err": "unknown plan id"}
            result, err = pending.wait(
                timeout=float(payload.get("timeout") or 30.0))
            reply = {"result": result,
                     "err": repr(err) if err is not None else None}
            since = payload.get("since")
            if since is not None:
                reply["export"] = server.state.export_since(int(since))
            return reply
        if op == "dispatch":
            return self._handle_dispatch(child, payload)
        if op == "place":
            return self._handle_place(payload)
        if op == "collect":
            return self._handle_collect(child, payload)
        if op == "chain_claim":
            claimed = self.front.claim_chain(client=child.client)
            if claimed is None:
                return None
            bid, seq0, triple, masked = claimed
            tok = next(child.tok_seq)
            child.chains[tok] = triple
            return {"bid": bid, "seq0": seq0, "tok": tok,
                    "masked": sorted(masked or ())}
        if op == "chain_retain":
            triple = self._resolve_chain_ref(child, payload["ref"])
            if triple is not None:
                self.front.retain_chain(
                    payload["bid"], int(payload["seq0"]), triple,
                    masked=frozenset(payload.get("masked") or ()),
                    client=child.client)
            return None
        if op == "prof":
            from nomad_tpu_torch.core import profiling
            profiling.PROFILER.publish_remote(
                f"pool-worker-{child.idx}", payload.get("snapshot"))
            return None
        if op == "tl":
            # child timeline delta (same reporter cadence as `prof`):
            # rows fold into the parent timeline under `col@pool-N`,
            # annotations join the stream tagged with their origin
            from nomad_tpu_torch.core.timeline import TIMELINE
            delta = payload.get("delta")
            if isinstance(delta, dict):
                TIMELINE.merge_delta(delta, origin=f"pool-{child.idx}")
            return None
        if op == "logs":
            # child warn+ records, re-logged into the parent ring (the
            # one an operator tails / `operator debug` bundles) with the
            # origin process stamped into the component
            from nomad_tpu_torch.core.logging import RING
            for rec in (payload.get("recs") or [])[:50]:
                if not isinstance(rec, dict):
                    continue
                fields = {k: v for k, v in rec.items()
                          if k not in ("ts", "level", "component", "msg")}
                RING.log(f"pool-worker-{child.idx}/"
                         f"{rec.get('component', '?')}",
                         rec.get("level", "warn"),
                         str(rec.get("msg", "")), **fields)
            return None
        if op == "pause_ack":
            child.paused.set()
            return None
        if op == "state":
            child.report = dict(payload)
            child.reports += 1
            return None
        if op in ("ready", "pull"):
            if op == "pull":
                return self.server.state.export_since(
                    int(payload.get("since") or 0))
            return {"ok": True}
        raise ValueError(f"unknown pool rpc {op!r}")

    def _resolve_chain_ref(self, child: _Child, ref):
        """Opaque chain ref -> (used, node_version, npad) triple.  The
        ref is consumed (the buffer is donated to whatever rides it)."""
        if not isinstance(ref, dict):
            return None
        if "tok" in ref:
            return child.chains.pop(int(ref["tok"]), None)
        if "pid" in ref:
            pend = child.pendings.pop(int(ref["pid"]), None)
            if not isinstance(pend, dict):
                return None
            return self.front.chain_state(pend)
        return None

    def _handle_dispatch(self, child: _Child, payload):
        self.stats["dispatches"] += 1
        child.dispatches += 1
        triple = self._resolve_chain_ref(child, payload.get("chain"))
        masked = payload.get("masked")
        snapshot = self.server.state.snapshot()
        pending = self.front.dispatch_batch(
            snapshot, payload["items"], seed=payload["seeds"],
            used0_dev=triple,
            masked_node_ids=frozenset(masked) if masked else None)
        if pending is None:
            return {"kind": "none"}
        if isinstance(pending, tuple):
            return {"kind": "sentinel"}
        pid = next(child.pid_seq)
        child.pendings[pid] = pending
        while len(child.pendings) > _PENDING_CAP:
            child.pendings.popitem(last=False)
        return {"kind": "wave", "pending": {
            "pid": pid,
            "chained": bool(pending.get("chained")),
            "n": pending["n"], "npad": pending["npad"],
            "node_version": pending["node_version"],
            "padded_fraction": float(pending["padded_fraction"]),
            "prep_ns": int(pending["prep_ns"]),
            "collective_bytes": int(pending.get("collective_bytes")
                                    or 0),
            "shard_h2d_bytes": int(pending.get("shard_h2d_bytes")
                                   or 0)}}

    def _handle_place(self, payload):
        """A child's solo placement (its _RemoteEngine.place), run by
        the parent's engine on the card through the submission queue,
        against the parent's snapshot."""
        from nomad_tpu_torch.scheduler.device import InUseIndex
        self.stats["places"] += 1
        snapshot = self.server.state.snapshot()
        stopped = [a for a in map(snapshot.alloc_by_id, payload["stopped"])
                   if a is not None]
        in_use = None
        if payload["in_use"] is not None:
            in_use = InUseIndex()
            for nid, gid, ids in payload["in_use"]:
                in_use.add(nid, gid, ids)
        block = payload["block"]
        return self.front.place(
            snapshot, payload["job"], payload["tgs"], payload["requests"],
            stopped_allocs=stopped, bulk_api=payload["bulk_api"],
            seed=payload["seed"], device_in_use=in_use,
            block=None if block is None else tuple(block))

    def _handle_collect(self, child: _Child, payload):
        import dataclasses

        from nomad_tpu_torch.core import profiling
        pending = child.pendings.get(int(payload["pid"]))
        if pending is None:
            raise ValueError("unknown pending wave (evicted?)")
        ready = pending.get("ready")
        if ready is not None:
            # the wave's one sync point, as WavePipeline.collect's: the
            # result's copy into pinned host memory
            with profiling.activity("device-wait"):
                ready.synchronize()
        decisions = self.front.collect_batch(pending)
        # the result buffer is spent; only the chain candidate ("used")
        # must stay alive for a later chain ref
        for key in ("buf", "fills_full", "ready"):
            pending.pop(key, None)
        node_ids: List[str] = []
        slim = []
        for d in decisions:
            if d is None:
                slim.append(None)
                continue
            if not node_ids:
                node_ids = d.node_ids
            # every decision of a wave shares ONE row->node-id table;
            # ship it once and strip the copies
            slim.append(dataclasses.replace(d, node_ids=[]))
        return {"decisions": slim, "node_ids": node_ids}

    # ------------------------------------------------ crash recovery

    def _on_child_gone(self, child: _Child) -> None:
        """EOF from a child (exit or crash): give its deliveries back
        (nack invalidates their tokens, so any orphaned in-flight plan
        fails the applier's token check), drop its device-side state,
        and respawn unless the pool is closing."""
        now = self.server.clock.time()
        for eid, tok in list(child.outstanding.items()):
            try:
                self.server.eval_broker.nack(eid, tok, now=now)
            except Exception:  # noqa: BLE001 - recovery best-effort
                pass
        child.outstanding.clear()
        child.pendings.clear()
        child.chains.clear()
        child.plans.clear()
        self.front.drop_client(child.client)
        from nomad_tpu_torch.core import profiling
        profiling.PROFILER.drop_remote(f"pool-worker-{child.idx}")
        conn = child.conn
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass
        with self._lock:
            closing = self._closing or self._stop_evt.is_set()
        if closing:
            return
        if child.respawns >= _RESPAWN_CAP:
            log("workerpool", "error",
                "pool worker exceeded respawn cap; not restarting",
                worker=child.idx, respawns=child.respawns)
            return
        child.respawns += 1
        self.stats["respawns"] += 1
        log("workerpool", "warn", "pool worker exited; respawning",
            worker=child.idx, respawn=child.respawns)
        from nomad_tpu_torch.core.timeline import TIMELINE
        TIMELINE.annotate("pool.respawn", worker=child.idx,
                          respawn=child.respawns)
        self._spawn(child)
