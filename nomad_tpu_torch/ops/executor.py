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
  - `TorchExecutor` (default backend, the reference's `JaxExecutor`):
    delegates to `PlacementEngine.dispatch_batch` /
    `collect_batch`, whose hand-written CUDA kernels run on the card.
  - `BridgeExecutor`: the same kernels driven through the native CUDA
    bridge (native/bridge.py over csrc/bridge.cu, a C-ABI library with
    device buffers of its own): stable inputs upload once and are
    reused by identity, each wave uploads only its own tensors, and the
    proposed-usage output handle chains into the next wave's `used0`
    without a host round trip.

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
  - the backends are `torch` (`TorchExecutor`, the reference's `jax`
    backend's counterpart) and `bridge`; `make_executor("bridge")`
    raises ValueError on a mesh engine, on one card or across parts (the
    library runs the unsharded programs), as the reference's does, and
    ExecutorUnavailable on a CPU engine (no card for the library to
    drive), before anything is built;
  - `BridgeExecutor(engine, bridge=None)` takes an injected bridge
    (tests pass `native.bridge.PlainBridge`); it has no plugin path, and
    its programs are named kernels, compiled once per shape bucket only
    in name (`COMPILE` site `bridge/<dims>`);
  - the bridge's identity cache keys an input by what the engine knows
    of it besides its identity: the engine replays plan deltas into its
    usage tensor in place through K4, which torch's version counter
    does not see, so `used0` carries the packer's used version, and
    every stable input the node-table version and torch's counter.
    Only the stable inputs (node tensors, LUTs, base masks, the synced
    usage) are cached; a wave's own tensors are uploaded, read and
    freed (`upload_bytes_by_cause["per-wave"]`), and a usage re-upload
    after a commit counts as "invalidation-replay";
  - a bridge wave's `pending["ready"]` is its result buffer, whose
    `synchronize()` is the fetch: as in the reference, the fetch is the
    synchronisation point, and the wave pipeline stamps one `device`
    interval on it;
  - a chained torch wave reuses the usage tensor in place (the reference
    donates it to XLA), so a retained chain's tensor must not be read
    after a wave has claimed it; dropping a chain frees its tensor when
    the last reference goes, so `TorchExecutor` needs no
    `_release_chain`.  A bridge handle is freed when it is consumed,
    dropped, collected or garbage, and `close()` frees the rest.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Sequence

import numpy as np

from nomad_tpu_torch.core.flightrec import FLIGHT
from nomad_tpu_torch.core.telemetry import REGISTRY
from nomad_tpu_torch.core.timeline import TIMELINE

EXECUTOR_BACKENDS = ("torch", "bridge")


class ExecutorUnavailable(RuntimeError):
    """The requested executor backend cannot run in this process."""


def make_executor(name: str, engine, plugin: Optional[str] = None,
                  chain_enabled: bool = True) -> "DeviceExecutor":
    """Build the configured executor backend over `engine`
    (agent_config `server.device_executor`).  Raises ValueError on an
    unknown name OR on a config the engine cannot honor (bridge over a
    mesh), and ExecutorUnavailable when `bridge` is requested on a CPU
    engine or its library does not build (the message carries nvcc's
    output).  All raise at SERVER CONSTRUCTION — agent start — never
    mid-worker-loop; no backend is chosen silently.  `plugin` is the
    reference's PJRT plugin path, unused here."""
    if name in ("", None, "torch"):
        return TorchExecutor(engine, chain_enabled=chain_enabled)
    if name == "bridge":
        if getattr(engine, "mesh", None) is not None:
            # config validation, not availability: the library runs the
            # unsharded programs, and this engine shards the node axis.
            # There is no silent fallback — the operator picks one.
            raise ValueError(
                "agent_config: server.device_executor = \"bridge\" runs "
                "the native library's unsharded programs, but this engine "
                f"shards the node axis over a {engine.mesh.n_shards}-shard "
                "mesh; set server.device_executor = \"torch\" (the "
                "sharded backend), or run the engine without a mesh")
        return BridgeExecutor(engine, chain_enabled=chain_enabled)
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

    def release(self) -> None:
        """Server shutdown: free what the backend holds outside Python's
        reach (the bridge's device buffers and library client); the
        torch backend holds nothing of the kind."""


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


def _host(leaf) -> np.ndarray:
    """An input leaf as a contiguous host array (a device tensor is
    copied to the host; `.cpu()` waits for the work queued on it)."""
    if hasattr(leaf, "cpu"):
        leaf = leaf.cpu().numpy()
    return np.asarray(leaf, order="C")


class _BridgeArray:
    """A device buffer of the native bridge masquerading as an array:
    carries shape/dtype for shape-bucket keys and fetches to host lazily
    (`numpy()`, `np.asarray`): the compact-fills overflow path then pays
    its fetch only when the prefix actually overflowed.  `synchronize()`
    is that fetch: for the bridge the fetch IS the synchronisation point
    (the wave pipeline's device interval and the engine's collect wait on
    `pending["ready"]`, which is the result buffer itself).  The handle is
    freed by `free()`, or when the object is garbage."""

    __slots__ = ("shape", "dtype", "_bridge", "handle", "_host")

    def __init__(self, bridge, handle, shape, dtype) -> None:
        self._bridge = bridge
        self.handle = handle
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self._host = None

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) * self.dtype.itemsize

    def fetch(self) -> np.ndarray:
        if self._host is None:
            self._host = self._bridge.fetch(self.handle, self.shape,
                                            self.dtype)
        return self._host

    synchronize = fetch
    numpy = fetch

    def __array__(self, dtype=None, copy=None):
        a = self.fetch()
        return a if dtype is None else a.astype(dtype)

    def free(self) -> None:
        h, self.handle = self.handle, 0
        if h:
            try:
                self._bridge.buffer_free(h)
            except Exception:  # noqa: BLE001 - teardown best-effort
                pass

    def __del__(self) -> None:
        self.free()


class BridgeExecutor(DeviceExecutor):
    """The multi-eval programs driven through the native CUDA bridge
    (native/bridge.py over csrc/bridge.cu) with device buffers the
    library owns.  Stable inputs (node tensors, LUTs, base masks, the
    packer-synced usage) upload once and are reused by object identity
    while the engine's versions of them hold; each wave uploads only its
    own small tensors and fetches only the compact result buffer; the
    proposed-usage output handle chains into the next wave's `used0`
    untouched by the host.  `bridge`: a CudaBridge on the engine's card
    unless given (tests inject a PlainBridge)."""

    name = "bridge"

    # stable-input handle cache bound (entries are freed on eviction)
    _CACHE_CAP = 256
    # the inputs that stay on the device across waves; every other input
    # is the wave's own
    _STABLE = frozenset(("attrs", "cap", "elig", "luts", "base_mask",
                         "used0"))

    def __init__(self, engine, bridge=None,
                 chain_enabled: bool = True) -> None:
        # mesh FIRST: a config contradiction (make_executor raises the
        # agent_config-worded ValueError before ever constructing this
        # class) must win over mere availability for direct callers
        if engine.mesh is not None:
            raise ValueError(
                "device_executor 'bridge' runs the unsharded programs; "
                "this engine shards over a mesh — use 'torch'")
        if bridge is None:
            if engine.device.type != "cuda":
                raise ExecutorUnavailable(
                    "device_executor 'bridge' drives the native CUDA "
                    f"library, and this engine runs on {engine.device}; "
                    "configure device_executor = \"torch\" instead")
            import torch

            from nomad_tpu_torch.native.bridge import BridgeError, CudaBridge
            index = engine.device.index
            try:
                bridge = CudaBridge(torch.cuda.current_device()
                                    if index is None else index)
            except BridgeError as e:
                raise ExecutorUnavailable(
                    f"device_executor 'bridge': {e}") from e
        super().__init__(engine, chain_enabled=chain_enabled)
        self._bridge = bridge
        # the engine's collect path materializes bridge result buffers
        # (np.asarray on _BridgeArray): meter those d2h fetches; the
        # uploads are metered here (_upload), not by the engine
        engine.d2h_observer = self._observe_d2h
        self._compiled = {}       # program + shape signature -> exec
        self._h2d_cache = {}      # id(leaf) -> (leaf, token, handle)
        self._h2d_order = []      # insertion order for eviction
        self._cache_lock = threading.Lock()

    # ------------------------------------------------------- uploads

    def _upload(self, arr: np.ndarray, cause: str) -> int:
        t0 = time.perf_counter()
        handle = self._bridge.upload(arr)
        self._observe_h2d(arr.nbytes, time.perf_counter() - t0, cause)
        return handle

    def _leaf_handle(self, leaf, token) -> int:
        """Device handle for one stable input, cached by object identity:
        the engine's version-keyed caches keep node tensors as the SAME
        objects across waves, so they upload once, and again only when
        `token` (what the engine knows of their contents) moves.  The
        caller holds `_cache_lock` until the program that reads the
        handle is enqueued: a handle freed after that is freed in stream
        order, behind its readers."""
        key = id(leaf)
        hit = self._h2d_cache.get(key)
        if hit is not None and hit[0] is leaf and hit[1] == token:
            return hit[2]
        if hit is not None:
            self._bridge.buffer_free(hit[2])
        handle = self._upload(
            _host(leaf),
            "invalidation-replay" if hit is not None else "initial-upload")
        if hit is None:
            self._h2d_order.append(key)
        self._h2d_cache[key] = (leaf, token, handle)
        if len(self._h2d_order) > self._CACHE_CAP:
            for old in self._h2d_order[:self._CACHE_CAP // 4]:
                stale = self._h2d_cache.pop(old, None)
                if stale is not None:
                    self._bridge.buffer_free(stale[2])
            del self._h2d_order[:self._CACHE_CAP // 4]
        return handle

    def _compile(self, program: str, statics, leaves) -> int:
        """The executable of `program` at `statics` for these input
        shapes (once per shape bucket, as the reference compiles)."""
        from nomad_tpu_torch.core.profiling import COMPILE
        shapes = tuple((tuple(lf.shape), str(lf.dtype).replace("torch.", ""))
                       for _, lf in leaves)
        sig = (program, tuple(statics), shapes)
        # shape-bucket site label: the largest leaf (the node-axis
        # tensor) tells buckets apart without dumping the whole sig
        dims = max((s for s, _ in shapes if s), default=(),
                   key=lambda t: int(np.prod(t)))
        site = "bridge/" + "x".join(map(str, dims))
        hit = self._compiled.get(sig)
        if hit is not None:
            COMPILE.note_hit(site)
            return hit
        t0 = time.perf_counter()
        ex = self._bridge.compile(program, statics)
        COMPILE.note_miss(site, time.perf_counter() - t0)
        self._compiled[sig] = ex
        return ex

    # --------------------------------------------------------- waves

    def dispatch_batch(self, snapshot, items, seed=0, used0_dev=None,
                       masked_node_ids=None):
        from nomad_tpu_torch.native.bridge import multi_program

        from .select import FILL_K

        if not self.chain_enabled and used0_dev is not None:
            self._release_chain((None, None, used0_dev))
            used0_dev = None
        if not items:
            return None
        built = self.engine.build_multi_inputs(
            snapshot, items, seed=seed, used0_dev=used0_dev,
            masked_node_ids=masked_node_ids)
        chained = not isinstance(built, tuple) and built["chained"]
        if used0_dev is not None and not chained:
            # the version guard rejected the chain: its handle is dead
            self._release_chain((None, None, used0_dev))
        if isinstance(built, tuple):
            return built                       # empty-cluster sentinel
        inp, rs, t = built["inp"], built["rs"], built["t"]
        compact = built["cand_rows"] is not None
        program, statics, leaves = multi_program(
            inp, rs, built["cand_rows"], built["cand_valid"],
            built["n_lanes"])
        ex = self._compile(program, statics, leaves)
        handles, own, consumed = [], [], None
        # the workers share the cache: its handles stay put until this
        # program is enqueued
        with self._cache_lock:
            try:
                for name, leaf in leaves:
                    if isinstance(leaf, _BridgeArray):
                        handles.append(leaf.handle)    # the chained used0
                        consumed = leaf
                    elif name in self._STABLE:
                        handles.append(self._leaf_handle(leaf, (
                            t.version,
                            t.used_version if name == "used0" else None,
                            getattr(leaf, "_version", None))))
                    else:
                        own.append(self._upload(_host(leaf), "per-wave"))
                        handles.append(own[-1])
                outs = self._bridge.execute_resident(ex, handles, 3)
            finally:
                # stream-ordered: freed after the programs that read them
                for h in own:
                    self._bridge.buffer_free(h)
                if consumed is not None:
                    consumed.free()
        wrapped = [_BridgeArray(self._bridge, h,
                                *self._bridge.buffer_info(h)) for h in outs]
        if compact:
            buf, fills, used = wrapped
        else:
            buf, used, jc = wrapped
            jc.free()
            fills = None
        pending = {
            "bridge": True,
            "buf": buf, "ready": buf, "used": used,
            "items": list(items),
            "spans": built["spans"], "counts": built["counts"],
            "rs": rs, "t": t, "ctxs": built["ctxs"],
            "n": built["n"], "npad": built["npad"],
            "collective_bytes": 0, "shard_h2d_bytes": 0,
            "padded_fraction":
                (built["npad"] - built["n"]) / built["npad"],
            "node_version": t.version, "perm": built["perm"],
            "fills_full": fills,
            "fill_k": min(FILL_K, rs) if compact else None,
            "chained": chained, "n_lanes": built["n_lanes"],
            "cand_rows": built["cand_rows"],
            "prep_ns": time.perf_counter_ns() - built["t0"],
        }
        self._note_dispatch(pending, used0_dev is not None)
        return pending

    def collect_batch(self, pending):
        if not isinstance(pending, dict) or not pending.get("bridge"):
            return self.engine.collect_batch(pending)
        try:
            # engine.collect_batch waits on pending["ready"] (the fetch of
            # buf) and fetches fills_full only on a prefix overflow
            return self.engine.collect_batch(pending)
        finally:
            for key in ("buf", "fills_full"):
                arr = pending.get(key)
                if isinstance(arr, _BridgeArray):
                    arr.free()
            # pending["used"] stays alive: it is the chain candidate

    def _release_chain(self, chain) -> None:
        arr = chain[2][0]
        if isinstance(arr, _BridgeArray):
            arr.free()

    def release(self) -> None:
        self.close()

    def close(self) -> None:
        super().close()
        with self._cache_lock:
            for _, _, handle in self._h2d_cache.values():
                self._bridge.buffer_free(handle)
            self._h2d_cache.clear()
            self._h2d_order.clear()
        self._bridge.close()


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
