"""Device executor seam — resident buffer handles for the worker loop
(reference: nomad_tpu/ops/executor.py).

Node tensors are uploaded once into the engine's resident device
caches, every wave runs on them, and each wave's proposed-usage OUTPUT
tensor chains into the next wave's `used0`, so steady-state scheduling
never materializes node state on the host.  This module makes that chain
the contract between the wave pipeline and the kernels:

  - `DeviceExecutor` is the seam: dispatch/collect a multi-eval wave,
    hand out a wave's chain state, and RETAIN the final wave's
    proposed-usage tensor across worker passes so the next dequeued
    batch starts device-resident instead of re-syncing `used0` from the
    packer through the host.
  - `TorchExecutor` (the one backend, the reference's `JaxExecutor`):
    delegates to `PlacementEngine.dispatch_batch` /
    `collect_batch`, whose hand-written CUDA kernels run on the card.

Safety of the retained chain: proposed usage is a SUPERSET of what the
chain's own plans commit, so a chained wave can under-pack but never
oversubscribe.  The executor INVALIDATES the retained chain (dropping
back to a packer-synced re-upload, counted in
`nomad.executor.invalidations`) on every state-store write that changes
node state the chain cannot observe:

  - node writes (register / drain / eligibility / attribute change),
  - snapshot restore,
  - capacity-freeing alloc writes (terminal transitions),
  - a committed plan from OUTSIDE the chain (`note_plan_commit`), and
    a chain retained AFTER such a commit that its base snapshot
    predates (`retain_chain`: the chain was in flight, riding its own
    waves, while a sibling worker committed, so the retained usage
    misses that commit).  The reference keeps such a chain; with two
    pool workers its next wave then packs on nodes whose usage it
    cannot see, and the applier refutes those nodes.

Telemetry (core/telemetry.py):
  nomad.executor.uploads / upload_bytes   host->device node-state syncs
  nomad.executor.upload_bytes_by_cause    the same bytes split by cause
                                          (initial-upload / dirty-shard-
                                          patch / invalidation-replay)
  nomad.executor.d2h_bytes / d2h_s        device->host result fetches
  nomad.executor.hbm_resident_bytes       retained-tensor HBM estimate
  nomad.executor.hbm_high_watermark_bytes   ... and its high watermark
  nomad.executor.resident_waves           launches that chained tensors
  nomad.executor.invalidations            retained chains dropped
  nomad.executor.h2d_s                    upload latency histogram

Differences from the reference:
  - one backend, `torch` (`TorchExecutor`); the reference's `jax`
    backend is its counterpart.  `make_executor("bridge")` raises
    `ExecutorUnavailable`: the reference's `BridgeExecutor` drives the
    C++ PJRT bridge, whose counterpart, a native CUDA executor, is not
    ported;
  - a chained wave reuses the usage tensor in place (the reference
    donates it to XLA), so a retained chain's tensor must not be read
    after a wave has claimed it; dropping a chain frees its tensor when
    the last reference goes, so `_release_chain` does nothing.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Sequence

from nomad_tpu_torch.core.flightrec import FLIGHT
from nomad_tpu_torch.core.telemetry import REGISTRY
from nomad_tpu_torch.core.timeline import TIMELINE

EXECUTOR_BACKENDS = ("torch",)


class ExecutorUnavailable(RuntimeError):
    """The requested executor backend cannot run in this process."""


def make_executor(name: str, engine, plugin: Optional[str] = None,
                  chain_enabled: bool = True) -> "DeviceExecutor":
    """Build the configured executor backend over `engine`
    (agent_config `server.device_executor`).  Raises ValueError on an
    unknown name, and ExecutorUnavailable for `bridge`, whose native
    executor the port does not have.  Both raise at SERVER
    CONSTRUCTION — agent start — never mid-worker-loop; no backend is
    chosen silently.  `plugin` is the reference's PJRT plugin path,
    unused here."""
    if name in ("", None, "torch"):
        return TorchExecutor(engine, chain_enabled=chain_enabled)
    if name == "bridge":
        raise ExecutorUnavailable(
            "device_executor 'bridge' drives the native PJRT bridge, "
            "which this port does not have (a native CUDA executor is "
            "ROADMAP queue 1 item 6); configure device_executor = "
            "\"torch\" instead")
    raise ValueError(
        f"unknown device_executor {name!r} "
        f"(expected one of {EXECUTOR_BACKENDS})")


class DeviceExecutor:
    """Pluggable device-execution seam between the wave pipeline and the
    kernels.  One instance per Server, shared by its workers — each
    retained chain lives in a per-CLIENT slot CLAIMED atomically
    (claim_chain pops; in-process workers share the default "" slot),
    so two workers can never chain concurrently on the same
    donated/retained buffer under one chain id (which would exempt each
    other from the applier's per-node fence)."""

    name = "base"

    def __init__(self, engine, chain_enabled: bool = True) -> None:
        self.engine = engine
        # chain_enabled=False is the A/B lever (bench --resident off and
        # the parity suite's serial reference): every wave re-syncs
        # `used0` from the packer through the host
        self.chain_enabled = chain_enabled
        self._lock = threading.Lock()
        # client -> (batch_id, seq0, (used, node_version, npad),
        # masked_nodes).  One slot per chain CLIENT: the in-process
        # worker plane uses the default "" slot (single slot, exactly
        # the pre-pool behavior); the multi-process pool
        # (core/workerpool) keys a slot per worker process so each
        # child's retained chain survives other children's waves while
        # foreign plan commits still drop every slot they invalidate.
        self._chains: dict = {}
        # the two latest committing origins, newest first, each with
        # the store's placement seq after its latest commit: the latest
        # foreign commit for any chain id is one of them
        self._commits: list = []
        self.stats = {"dispatches": 0, "resident_waves": 0,
                      "invalidations": 0, "uploads": 0, "upload_bytes": 0,
                      # mesh deployments: per-launch cross-shard
                      # collective payload (engine._note_collective) —
                      # 0 forever on a single device
                      "collective_bytes": 0,
                      # device->host result fetches (the d2h twin)
                      "d2h_fetches": 0, "d2h_bytes": 0,
                      # HBM residency estimate from retained/donated
                      # handle sizes, plus its high watermark
                      "hbm_resident_bytes": 0,
                      "hbm_high_watermark_bytes": 0}
        # upload_bytes split by CAUSE (initial-upload / dirty-shard-patch
        # / invalidation-replay) — kept OUT of `stats` so existing
        # numeric delta readers (bench, perfcheck) stay shape-stable;
        # `upload_bytes` above remains the sum for continuity
        self.upload_bytes_by_cause: dict = {}

    # ------------------------------------------------------------ waves

    def dispatch_batch(self, snapshot, items: Sequence, seed=0,
                       used0_dev=None, masked_node_ids=None):
        raise NotImplementedError

    def collect_batch(self, pending):
        raise NotImplementedError

    def chain_state(self, pending):
        """The (usage, node version, padded n) triple a successor wave
        chains on, or None when `pending` cannot seed a chain."""
        if not isinstance(pending, dict):
            return None
        return (pending["used"], pending["node_version"], pending["npad"])

    def _note_dispatch(self, pending, wanted_chain: bool) -> None:
        if not isinstance(pending, dict):
            return
        chained = bool(pending.get("chained"))
        coll = int(pending.get("collective_bytes") or 0)
        with self._lock:
            self.stats["dispatches"] += 1
            self.stats["collective_bytes"] += coll
            if chained:
                self.stats["resident_waves"] += 1
        if chained:
            REGISTRY.inc("nomad.executor.resident_waves")
        elif wanted_chain:
            # the engine rejected the handed-in chain (node-table
            # rebuild remapped rows): that buffer is dead
            self._count_invalidation("stale-node-table")

    # --------------------------------------------- retained chain slot

    def retain_chain(self, batch_id: str, seq0: int, used_triple,
                     masked=None, client: str = "") -> None:
        """Park a finished wave's proposed-usage chain for the NEXT
        dequeued batch (core/worker.py calls this when a fully-coupled
        batch ends with no prefetch to hand the chain to)."""
        if not self.chain_enabled or used_triple is None or not batch_id:
            return
        chain = (batch_id, seq0, used_triple, frozenset(masked or ()))
        with self._lock:
            foreign = next((seq for origin, seq in self._commits
                            if origin != batch_id), 0)
            stale = foreign > seq0
            old = (self._chains.pop(client, None) if stale
                   else self._chains.get(client))
            if not stale:
                self._chains[client] = chain
        if old is not None:
            self._release_chain(old)
        if stale:
            # a foreign plan committed after the chain's base snapshot
            # while the chain was in flight: its usage misses that commit
            self._count_invalidation("foreign-plan")
            self._release_chain(chain)

    def claim_chain(self, client: str = ""):
        """Pop the client's retained chain (single consumer per slot —
        see class doc).  Returns (batch_id, seq0, used_triple,
        masked_nodes) or None."""
        if not self.chain_enabled:
            return None
        with self._lock:
            return self._chains.pop(client, None)

    def invalidate(self, reason: str = "explicit") -> None:
        """Drop every retained chain: the next wave of each client
        re-syncs node state from the packer (re-upload counted via
        uploads/upload_bytes).  The triggers (node writes, restore,
        capacity-freeing allocs) blind ALL chains equally, so there is
        no per-client variant."""
        with self._lock:
            dropped = list(self._chains.values())
            self._chains.clear()
        for c in dropped:
            self._count_invalidation(reason)
            self._release_chain(c)

    def drop_client(self, client: str) -> None:
        """Forget one client's slot (pool worker exited/crashed)."""
        with self._lock:
            c = self._chains.pop(client, None)
        if c is not None:
            self._count_invalidation("client-drop")
            self._release_chain(c)

    def _count_invalidation(self, reason: str) -> None:
        with self._lock:
            self.stats["invalidations"] += 1
        REGISTRY.inc("nomad.executor.invalidations", reason=reason)
        # the flight ring's event lane: an invalidation STORM (every wave
        # re-uploading node state) is an SLO rule, and the dump bundle
        # should show which writes caused it
        FLIGHT.record_event("executor.invalidation", reason=reason)
        # ...and the retrospective timeline's (volatile) annotation lane,
        # so `nomad report` can line storms up against breaches
        TIMELINE.annotate("executor.invalidation", reason=reason)

    def _release_chain(self, chain) -> None:
        """Backend hook: free device resources a dropped chain held."""

    # ------------------------------------------------- store coupling

    def note_plan_commit(self, origin: str, seq: int = None) -> None:
        """The plan applier committed a plan from `origin` (chain id or
        eval id), leaving the store at placement seq `seq`.  A foreign
        plan's usage is invisible to every retained chain EXCEPT the one
        that proposed it — drop the others so their next wave re-syncs;
        `seq` lets a chain retained later see that it missed this commit
        (retain_chain)."""
        with self._lock:
            if seq is not None:
                if self._commits and self._commits[0][0] == origin:
                    self._commits[0] = (origin, seq)
                else:
                    self._commits = [(origin, seq)] + self._commits[:1]
            dropped = [c for c in self._chains.values()
                       if c[0] != origin]
            if dropped:
                self._chains = {k: c for k, c in self._chains.items()
                                if c[0] == origin}
        for c in dropped:
            self._count_invalidation("foreign-plan")
            self._release_chain(c)

    def attach_store(self, store) -> None:
        """Subscribe to state-store events that change node state the
        retained chain cannot observe (node writes, snapshot restore,
        capacity-freeing terminal allocs)."""

        def on_event(topic: str, index: int, payload) -> None:
            if topic == "Node":
                self.invalidate("node-write")
            elif topic == "Restore":
                self.invalidate("restore")
            elif topic == "Allocations":
                # placements the chain proposed are non-terminal; a
                # terminal transition FREES capacity the chain still
                # counts as used — it must re-sync or under-pack forever
                # (a blocked eval would never see the freed node)
                try:
                    freed = any(a.terminal_status() for a in payload)
                except TypeError:
                    freed = True
                if freed:
                    self.invalidate("capacity-freed")

        store.subscribe(on_event)

    # ----------------------------------------------------- telemetry

    def _observe_h2d(self, nbytes: int, seconds: float,
                     cause: str = "initial-upload") -> None:
        with self._lock:
            self.stats["uploads"] += 1
            self.stats["upload_bytes"] += int(nbytes)
            self.upload_bytes_by_cause[cause] = \
                self.upload_bytes_by_cause.get(cause, 0) + int(nbytes)
            self._update_hbm_locked()
        REGISTRY.inc("nomad.executor.uploads")
        REGISTRY.inc("nomad.executor.upload_bytes", int(nbytes))
        # the by-cause twin rides a SEPARATE counter name: labeling the
        # original would double `counter_sum("...upload_bytes")` readers
        REGISTRY.inc("nomad.executor.upload_bytes_by_cause",
                     int(nbytes), cause=cause)
        REGISTRY.observe("nomad.executor.h2d_s", seconds)

    def _observe_d2h(self, nbytes: int, seconds: float,
                     cause: str = "result-fetch") -> None:
        with self._lock:
            self.stats["d2h_fetches"] += 1
            self.stats["d2h_bytes"] += int(nbytes)
        REGISTRY.inc("nomad.executor.d2h_bytes", int(nbytes),
                     cause=cause)
        REGISTRY.observe("nomad.executor.d2h_s", seconds)

    def _update_hbm_locked(self) -> None:
        """Refresh the HBM-residency estimate (self._lock held): the
        engine's retained device caches plus the parked chain handle.
        An estimate from handle sizes, not an allocator query — the
        high watermark is the capacity-planning number."""
        total = 0
        eng = self.engine
        if eng is not None and hasattr(eng, "device_resident_bytes"):
            total += eng.device_resident_bytes()
        for c in self._chains.values():
            total += int(getattr(c[2][0], "nbytes", 0))
        self.stats["hbm_resident_bytes"] = total
        if total > self.stats["hbm_high_watermark_bytes"]:
            self.stats["hbm_high_watermark_bytes"] = total
        REGISTRY.set_gauge("nomad.executor.hbm_resident_bytes", total)
        REGISTRY.set_gauge("nomad.executor.hbm_high_watermark_bytes",
                           self.stats["hbm_high_watermark_bytes"])

    def ledger(self) -> dict:
        """The device ledger (capture bundles, /v1/operator/debug):
        compile-cache traffic, HBM residency + watermark, and h2d/d2h
        transfer attribution by cause."""
        from nomad_tpu_torch.core.profiling import COMPILE
        with self._lock:
            self._update_hbm_locked()
            stats = dict(self.stats)
            by_cause = dict(self.upload_bytes_by_cause)
        return {
            "backend": self.name,
            "compile": COMPILE.snapshot(),
            "hbm_resident_bytes": stats["hbm_resident_bytes"],
            "hbm_high_watermark_bytes":
                stats["hbm_high_watermark_bytes"],
            "uploads": stats["uploads"],
            "upload_bytes": stats["upload_bytes"],
            "upload_bytes_by_cause": by_cause,
            "d2h_fetches": stats["d2h_fetches"],
            "d2h_bytes": stats["d2h_bytes"],
            "invalidations": stats["invalidations"],
            "resident_waves": stats["resident_waves"],
            "dispatches": stats["dispatches"],
        }

    def close(self) -> None:
        self.invalidate("close")


class TorchExecutor(DeviceExecutor):
    """The in-process PyTorch engine (the reference's `JaxExecutor`).
    A chained launch reuses the previous wave's usage tensor in place;
    node tensors are device-resident in the engine's version-keyed
    caches and the executor's H2D observer meters every sync the engine
    performs."""

    name = "torch"

    def __init__(self, engine, chain_enabled: bool = True) -> None:
        super().__init__(engine, chain_enabled=chain_enabled)
        # meter the engine's host->device node-state syncs
        # (_node_arrays full uploads + _used_device delta replays) and
        # its device->host result fetches
        engine.h2d_observer = self._observe_h2d
        engine.d2h_observer = self._observe_d2h

    def dispatch_batch(self, snapshot, items, seed=0, used0_dev=None,
                       masked_node_ids=None):
        if not self.chain_enabled:
            used0_dev = None
        pending = self.engine.dispatch_batch(
            snapshot, items, seed=seed, used0_dev=used0_dev,
            masked_node_ids=masked_node_ids)
        self._note_dispatch(pending, used0_dev is not None)
        return pending

    def collect_batch(self, pending):
        return self.engine.collect_batch(pending)


class SubmissionFrontEnd:
    """Thin submission queue in front of a shared DeviceExecutor.

    The multi-process worker pool (core/workerpool.py) funnels every
    child's device work through the parent-owned executor; this
    front-end serializes those submissions under ONE lock so the
    resident-buffer chain and the engine's version-keyed device caches
    keep their single-owner invariants — callers queue, they never
    interleave inside a dispatch.  Contended acquisition is metered as
    the `queue-wait` profiling bucket (the pool's analogue of the
    thread plane's gil-wait) and accumulated in `stats["queue_wait_s"]`
    for the bench JSON."""

    def __init__(self, executor: DeviceExecutor) -> None:
        self.executor = executor
        self._lock = threading.Lock()
        self.stats = {"submits": 0, "queue_wait_s": 0.0,
                      "queue_waits": 0}

    def _acquire(self) -> None:
        if self._lock.acquire(blocking=False):
            return
        from nomad_tpu_torch.core.profiling import activity
        t0 = time.perf_counter()
        with activity("queue-wait"):
            self._lock.acquire()
        waited = time.perf_counter() - t0
        self.stats["queue_wait_s"] += waited
        self.stats["queue_waits"] += 1

    def dispatch_batch(self, snapshot, items, seed=0, used0_dev=None,
                       masked_node_ids=None):
        self._acquire()
        try:
            self.stats["submits"] += 1
            return self.executor.dispatch_batch(
                snapshot, items, seed=seed, used0_dev=used0_dev,
                masked_node_ids=masked_node_ids)
        finally:
            self._lock.release()

    def collect_batch(self, pending):
        self._acquire()
        try:
            return self.executor.collect_batch(pending)
        finally:
            self._lock.release()

    def place(self, snapshot, job, tgs, requests, **kwargs):
        """A pool child's solo placement (`PlacementEngine.place`) on
        the executor's engine, queued with the waves (the port's pool
        children have no engine of their own)."""
        self._acquire()
        try:
            self.stats["submits"] += 1
            return self.executor.engine.place(snapshot, job, tgs, requests,
                                              **kwargs)
        finally:
            self._lock.release()

    def chain_state(self, pending):
        return self.executor.chain_state(pending)

    def claim_chain(self, client: str = ""):
        return self.executor.claim_chain(client)

    def retain_chain(self, batch_id: str, seq0: int, used_triple,
                     masked=None, client: str = "") -> None:
        self.executor.retain_chain(batch_id, seq0, used_triple,
                                   masked=masked, client=client)

    def drop_client(self, client: str) -> None:
        self.executor.drop_client(client)
