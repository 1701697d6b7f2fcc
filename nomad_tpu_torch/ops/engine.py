"""Host<->device placement engine (reference: nomad_tpu/ops/engine.py).

Bridges the control plane (snapshots, Job/TaskGroup objects) and the
device kernels: packs state, keeps node tensors and the usage tensor
resident on the device, places one eval's batch (`place`: the bulk
rounds K6 or the exact scan K5, then preemption through K8 and K7 for
what failed), lowers a multi-eval batch (`build_multi_inputs`),
launches it (`dispatch_batch`) and maps node rows back to ids and
AllocMetrics (`collect_batch`).

On a `parallel.mesh.Mesh` (`PlacementEngine(mesh=make_mesh(8))`) the node
axis is split into shards on the engine's one device: node tensors are
padded to a multiple of the shard count (padded rows ineligible), a node
write re-uploads only the shards holding dirty rows, and every launch
goes through the sharded kernels K9-K13 (parallel/mesh.py).

Differences from the reference's engine:
  - the lane prover's per-signature masks (`_host_signature_masks`) come
    from kernel K1 on the device, copied back as a [U, N] bool array;
  - `dispatch_batch` starts the result's device->host copy into pinned
    memory with a CUDA event that `collect_batch` waits on;
  - a chained wave reuses the previous wave's usage tensor in place (the
    reference donates it to XLA);
  - a mesh runs its shards on one card: `mesh=None` means one device
    (no automatic sharding), and a mesh across cards raises;
  - the compile ledger (`_launch`) sees no per-shape compile: the CUDA
    sources are built once, at the first launch of any kernel, and
    `kernels.build_all` notes that build on `kernels.nvcc/<source>`.  A
    first launch of a shape bucket pays the module load and the first
    allocations, and the ledger splits it from the steady launches as
    the reference's does.  The delta-replay scatter launches its chunk
    unpadded (K4 takes any length); its site still names the
    reference's pad bucket, so the two ledgers list the same sites, and
    its upload bytes are the unpadded int32 arrays';
  - the d2h meter sees every `_fetch` (the preemption path's reads
    too, which the reference takes unmetered with np.asarray) and the
    pinned copy that `collect_batch` waits for, its seconds the wait on
    the copy's CUDA event; the lane prover's [U, N] mask copy (the
    reference computes that mask on the host) is not metered;
  - `device_resident_bytes` also counts the resident base-mask table
    (`_base`), which the reference does not have, and sums the storage
    bytes of the resident tensors (an estimate from tensor sizes, not
    an allocator query).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nomad_tpu_torch.pack.interner import UNSET
from nomad_tpu_torch.pack.packer import (
    ClusterPacker,
    JobContext,
    NodeTensors,
    TGTensors,
)
from nomad_tpu_torch.pack.spread import SpreadTensors, lower_spreads
from nomad_tpu_torch.structs import (
    AllocMetric,
    Job,
    NodeScoreMeta,
    SCHED_ALGO_SPREAD,
    TaskGroup,
)
from nomad_tpu_torch.parallel import mesh as pmesh

from . import kernels as K
from .feasibility import feasible_mask, landscape_mask
from .preempt import (
    Preemptor,
    build_victim_tables,
    preempt_bulk,
    preemption_enabled,
)
from .select import (
    FILL_K,
    TOP_K,
    BulkInputs,
    MultiEvalInputs,
    PlacementInputs,
    place_bulk_packed,
    place_multi_chained,
    place_multi_compact_chained,
    place_multi_compact_packed,
    place_multi_packed,
    place_packed,
)

# Minimum homogeneous batch size before the bulk rounds beat the
# per-placement scan (the scan is exact sequential semantics; bulk commits
# whole rounds between state refreshes)
BULK_THRESHOLD = 64
BULK_ROUND = 1024

# fixed-size chunks for the delta-replay scatter (reference: engine.py:49)
SCATTER_CHUNK = 16384

# lane-parallel scheduling cap: lanes beyond this stop paying (each step's
# [L, N] math grows linearly while the sequential depth shrinks as 1/L)
MAX_LANES = 8

# shape buckets already launched at least once in this process — the
# compile-ledger mirror of the reference's process-global jit caches (a
# second engine in the same process must not count a first launch).
# See `PlacementEngine._launch`.
_KERNEL_SHAPES_SEEN: set = set()


def _compile_ledger():
    """Process compile ledger (core/profiling.py), imported lazily for
    the same first-importer-order reason as `_registry` below."""
    from nomad_tpu_torch.core.profiling import COMPILE
    return COMPILE


def _registry():
    """Process metrics registry, imported lazily, so the order in which
    the core and ops modules are first imported does not matter."""
    from nomad_tpu_torch.core.telemetry import REGISTRY
    return REGISTRY


def scatter_add_plain(used: torch.Tensor, rows: torch.Tensor,
                      vals: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: used[rows] += vals in place, indexed as the
    reference's `u.at[r].add(v)`: for N rows, a row in [-N, 0) adds to
    row r + N, a row below -N or at N and above is dropped; repeated
    rows sum."""
    r = K.wrap_rows(rows, used.shape[0])
    keep = (r >= 0) & (r < used.shape[0])
    used.index_put_((r[keep],), vals[keep].to(used.dtype), accumulate=True)
    return used


def scatter_add_(used: torch.Tensor, rows: torch.Tensor,
                 vals: torch.Tensor) -> torch.Tensor:
    """`used[rows] += vals` in place (reference: engine._scatter_add_jit;
    rows index as in scatter_add_plain).  A CPU tensor takes the plain
    version; a CUDA tensor launches K4 or raises.  used [N, 3] int32,
    rows [M] int32, vals [M, 3] int32."""
    if used.is_cpu:
        return scatter_add_plain(used, rows, vals)
    d, n, m = K.check_scatter("scatter_add", used, rows, vals)
    if m:
        K.SCATTER_ADD.launch(d, "scatter_add", used.data_ptr(), n,
                             rows.data_ptr(), vals.data_ptr(), m)
    return used


@dataclass
class PlacementRequest:
    """One placement the reconciler asked for."""
    tg_name: str
    prev_node_id: str = ""       # reschedule penalty target


@dataclass
class BatchItem:
    """One eval's placement block inside a multi-eval batch: `count`
    fresh placements of `tg` for `job`."""
    job: Job
    tg: TaskGroup
    count: int


@dataclass
class PlacementDecision:
    tg_name: str
    node_id: Optional[str]       # None = no feasible node
    score: float
    metric: AllocMetric
    # allocs to evict to make this placement possible (preemption)
    evictions: List = field(default_factory=list)


# The sharded-function dispatch (reference: engine._sharded_fn): kind ->
# the parallel.mesh wrapper that launches its kernel, looked up at call
# time.  Each takes the engine's mesh as an argument.
_SHARDED_KINDS = {
    "scan": "place_sharded_packed",                              # K9
    "bulk": "place_bulk_sharded_packed",                         # K10
    "multi": "place_multi_sharded_packed",                       # K11
    "multi_chained": "place_multi_sharded_chained",
    "multi_compact": "place_multi_compact_sharded",              # K12
    "multi_compact_chained": "place_multi_compact_sharded_chained",
    "scatter": "scatter_add_sharded_",                           # K13
}


def _pad_rows(a: np.ndarray, n_pad: int, fill=0) -> np.ndarray:
    """Pad a host array's leading (node) axis to n_pad rows."""
    n = a.shape[0]
    if n == n_pad:
        return a
    out = np.full((n_pad,) + a.shape[1:], fill, a.dtype)
    out[:n] = a
    return out


def _pad_cols(a: np.ndarray, n_pad: int, fill=0) -> np.ndarray:
    """Pad a host array's trailing (node) axis to n_pad columns."""
    n = a.shape[-1]
    if n == n_pad:
        return a
    out = np.full(a.shape[:-1] + (n_pad,), fill, a.dtype)
    out[..., :n] = a
    return out


def _pad_pow2(x: int, lo: int = 8) -> int:
    p = lo
    while p < x:
        p *= 2
    return p


def _sig_disjoint(con_a, con_b, luts) -> bool:
    """Prove two lowered constraint signatures select DISJOINT node sets,
    from structure alone (conservative: False = "could not prove", not
    "overlaps").  Sufficient conditions, per shared column:
      EQ(v1) vs EQ(v2), v1 != v2            — an attr has one value
      EQ(v)  vs LUT(row) with not row[v]    — v outside the LUT set
      LUT(a) vs LUT(b) with (a & b) empty   — e.g. two CSI topologies
                                              over disjoint node-id sets
    `luts` is the packer's host LUT matrix [L, V] bool."""
    from nomad_tpu_torch.pack.packer import DOP_EQ, DOP_LUT
    by_col: Dict[int, list] = {}
    for col, op, arg in con_a:
        if op in (DOP_EQ, DOP_LUT):
            by_col.setdefault(int(col), []).append((int(op), int(arg)))
    nrows, v = luts.shape
    for col, op, arg in con_b:
        op, arg = int(op), int(arg)
        if op not in (DOP_EQ, DOP_LUT):
            continue
        for op_a, arg_a in by_col.get(int(col), ()):
            if op_a == DOP_EQ and op == DOP_EQ:
                if arg_a != arg:
                    return True
            elif op_a == DOP_EQ and op == DOP_LUT:
                if arg < nrows and (arg_a >= v or not luts[arg, arg_a]):
                    return True
            elif op_a == DOP_LUT and op == DOP_EQ:
                if arg_a < nrows and (arg >= v or not luts[arg_a, arg]):
                    return True
            else:
                if (arg_a < nrows and arg < nrows
                        and not (luts[arg_a] & luts[arg]).any()):
                    return True
    return False


def _host_signature_masks(attrs, con, luts, elig, base_mask, u_mask,
                          node_ok, sigs):
    """Static feasibility masks of the signatures `sigs` for the lane
    prover, computed by K1 on the device with the SAME landscape code
    the kernels run (reference: engine._host_signature_masks, which ran
    constraint_mask on the host CPU, then ANDed the refuted-node row).
    The arguments are the launch's own device inputs (`con` [U, C, 3]
    and `u_mask` [U] as uploaded for the wave, `base_mask` the engine's
    resident table, `node_ok` the refuted-node row or None): K1 runs
    over signatures [0, max(sigs)] and nothing is stacked or uploaded
    for the prover.  Returns the [len(sigs), n] bool rows on the host."""
    u = max(sigs) + 1
    mask = landscape_mask(attrs, con[:u], luts, elig, base_mask, u_mask[:u],
                          node_ok)
    return mask.cpu().numpy()[list(sigs)]


def _disjoint_cliques(sig_rows, luts, weights):
    """Greedy partition of signature indices into cliques of pairwise
    provably-disjoint signatures (heaviest-first so the biggest lanes
    land together).  Each clique's members run as concurrent lanes; the
    cliques themselves run sequentially."""
    u = len(sig_rows)
    order = sorted(range(u), key=lambda s: -weights[s])
    memo: Dict[tuple, bool] = {}

    def dis(a: int, b: int) -> bool:
        key = (a, b) if a < b else (b, a)
        hit = memo.get(key)
        if hit is None:
            hit = _sig_disjoint(sig_rows[a], sig_rows[b], luts)
            memo[key] = hit
        return hit

    assigned = [False] * u
    cliques = []
    for s in order:
        if assigned[s]:
            continue
        clique = [s]
        assigned[s] = True
        for t in order:
            if assigned[t] or len(clique) >= MAX_LANES:
                continue
            if all(dis(t, m) for m in clique):
                clique.append(t)
                assigned[t] = True
        cliques.append(clique)
    return cliques


def _resolve_compact_fills(buf_np: np.ndarray, fills_full, slot_k: int):
    """The compact-output overflow protocol: the small buffer's fill
    prefix is complete iff the per-round prefix counts sum to the
    placed-total meta column; otherwise fetch the device-resident full
    fills and rebuild the full-layout buffer.  Returns (buf, slot_k)
    where slot_k == 0 means full layout."""
    if not slot_k:
        return buf_np, 0
    cnt_small = buf_np[:, :slot_k] & 2047
    if np.array_equal(cnt_small.sum(axis=1), buf_np[:, slot_k + 12]):
        return buf_np, slot_k
    full = fills_full() if callable(fills_full) else np.asarray(fills_full)
    return np.concatenate([full, buf_np[:, slot_k:]], axis=1), 0


def _unpack_bulk_compact(buf: np.ndarray, round_size: int, p_real: int,
                         with_scores: bool = False, slot_k: int = 0):
    """Expand a per-round buffer (layout: select.pack_round_buffer, with
    an optional score block) into per-placement picks and scores plus the
    per-round metric block.  Placements within a round are
    interchangeable, so per-node fill counts expand with np.repeat.
    `slot_k`: fill slots per buffer row when they differ from the round
    size."""
    n_rounds = buf.shape[0]
    slot_k = slot_k or round_size
    fills = buf[:, :slot_k]
    off = 2 * slot_k if with_scores else slot_k
    sc_r = buf[:, slot_k:off].view(np.float32) if with_scores else None
    meta = buf[:, off:]
    rows_r = fills >> 11
    cnt_r = fills & 2047
    placed_r = meta[:, 12]

    p_pad = n_rounds * round_size
    picks = np.full(p_pad, -1, np.int32)
    scores = np.zeros(p_pad, np.float32)
    for r in range(n_rounds):
        lo = r * round_size
        k = int(placed_r[r])
        if k <= 0:
            continue
        nz = cnt_r[r].nonzero()[0]
        picks[lo:lo + k] = np.repeat(rows_r[r, nz], cnt_r[r, nz])[:k]
        if with_scores:
            scores[lo:lo + k] = np.repeat(sc_r[r, nz], cnt_r[r, nz])[:k]
    return picks[:p_real], scores[:p_real], meta


def _unpack_bulk(buf: np.ndarray, round_size: int, p_real: int):
    """Per-placement expansion of the buffer with scores (the exact-API
    path): picks, scores, top-k rows and scores, and the metric columns,
    each round's metrics repeated over its placements."""
    picks, scores, meta = _unpack_bulk_compact(
        buf, round_size, p_real, with_scores=True)
    rep = np.repeat(np.arange(buf.shape[0]), round_size)[:p_real]
    m = meta[rep]
    return (picks, scores,
            m[:, 0:3], m[:, 3:6].view(np.float32),
            m[:, 6], m[:, 7], m[:, 8], m[:, 9:12])


@dataclass
class BulkDecisions:
    """Array-form result of a homogeneous placement batch: one shared
    AllocMetric per water-fill round instead of per-placement objects."""
    tg_name: str
    picks: np.ndarray                  # [P] node row or -1
    node_ids: List[str]                # row -> node id (shared, read-only)
    round_size: int
    metrics: List[AllocMetric]         # one per round, shared by the round
    evictions: Dict[int, List] = field(default_factory=dict)
    nodes_evaluated: int = 0


def _default_device():
    if not torch.cuda.is_available():
        raise RuntimeError(
            "PlacementEngine runs on CUDA by default and no CUDA device "
            "is available; pass device='cpu' to run the plain versions")
    return torch.device("cuda")


def _same_device(a: torch.device, b: torch.device) -> bool:
    """One device: the same type, and the same index where both name one
    (an index-less CUDA device is the current one)."""
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device()
    return (cur if a.index is None else a.index) == (
        cur if b.index is None else b.index)


class PlacementEngine:
    """Owns a ClusterPacker + device caches for one scheduling session,
    on one device (`torch.device("cuda")` unless the caller passes
    another, or the mesh's; the CPU runs the kernels' plain versions).

    `mesh`: None or False = one device, unsharded; a
    `parallel.mesh.Mesh` shards the node axis over its shards on its
    device, which must be the engine's.  Node tensors are then padded to
    a multiple of the shard count (padded rows are ineligible) and every
    launch goes through the sharded kernels."""

    def __init__(self, packer: Optional[ClusterPacker] = None,
                 device=None, mesh=None) -> None:
        mesh = mesh or None
        if mesh is not None and not isinstance(mesh, pmesh.Mesh):
            raise TypeError(f"mesh must be a parallel.mesh.Mesh, got "
                            f"{type(mesh).__name__}")
        if device is None and mesh is not None:
            device = mesh.device
        self.device = (_default_device() if device is None
                       else torch.device(device))
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device} requested but CUDA "
                               "is not available")
        if mesh is not None and not _same_device(mesh.device, self.device):
            raise ValueError(f"the mesh lies on {mesh.device}, the engine "
                             f"on {self.device}")
        self.mesh = mesh
        self._ndev = 1 if mesh is None else mesh.n_shards
        self.packer = packer or ClusterPacker()
        self._dev_cache: Dict[str, torch.Tensor] = {}
        self._cache_version: Tuple[int, int, int] = (-1, -1, -1)
        self._cache_npad: int = -1
        self._used_version: int = -1
        self._used_dev: Optional[torch.Tensor] = None
        self._const_cache: Dict[tuple, torch.Tensor] = {}
        # the resident base-mask table: (node-table version, npad), key
        # -> row, host rows, device table [cap, npad] bool
        self._base: Optional[list] = None
        self._dc_cache: Optional[Tuple[int, Dict[str, int]]] = None
        # mesh meters: bytes re-uploaded by dirty-shard patches, and the
        # analytic cross-shard exchange payload of each launch
        self.shard_h2d_bytes: int = 0
        self.collective_bytes: int = 0
        # host->device sync meter (ops/executor.py installs it): called
        # with (bytes, seconds, cause) for every node-state upload —
        # full node tensors ("initial-upload"), dirty-shard patches
        # ("dirty-shard-patch"), and the per-eval delta-replay scatters
        # ("invalidation-replay"); the d2h twin meters result fetches
        self.h2d_observer = None
        self.d2h_observer = None

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        """Copy a host array to the device (always a copy: the packer
        mutates its arrays in place after the upload)."""
        return torch.tensor(a, device=self.device)

    @property
    def n_devices(self) -> int:
        """Shards of the node axis (1 unsharded)."""
        return self._ndev

    def padded_row_fraction(self, n: int) -> float:
        """Fraction of kernel rows that are mesh padding (ineligible)."""
        npad = self._padded_n(max(n, 1))
        return (npad - n) / npad if npad else 0.0

    def _note_collective(self, rounds: int, kk: int, width: int = 5,
                         extra: int = 64) -> int:
        """Meter one mesh launch's cross-shard exchange (reference:
        engine._note_collective): per round every shard receives a
        [width, kk] candidate pack from each shard plus ~`extra` bytes of
        summed metrics."""
        nbytes = rounds * (width * kk * 4 * self._ndev + extra)
        self.collective_bytes += nbytes
        _registry().inc("nomad.engine.collective_bytes", nbytes)
        return nbytes

    def _note_h2d(self, nbytes: int, seconds: float,
                  cause: str = "initial-upload") -> None:
        obs = self.h2d_observer
        if obs is not None and nbytes:
            obs(nbytes, seconds, cause)

    def _note_d2h(self, nbytes: int, seconds: float,
                  cause: str = "result-fetch") -> None:
        obs = self.d2h_observer
        if obs is not None and nbytes:
            obs(nbytes, seconds, cause)

    def _launch(self, kind: str, shape_key: tuple, fn, *args):
        """Run one kernel launch under the compile ledger
        (core/profiling.py): the FIRST launch of a shape bucket in this
        process counts as a miss with its seconds, later ones as steady
        launches.  The bucket key is the reference's — kernel kind + the
        static shape arguments.  Host time only: no synchronize."""
        key = (kind, shape_key)
        t0 = time.perf_counter()
        out = fn(*args)
        dt = time.perf_counter() - t0
        site = f"engine.{kind}/" + "x".join(str(s) for s in shape_key)
        led = _compile_ledger()
        if key in _KERNEL_SHAPES_SEEN:
            led.note_hit(site)
            led.note_steady(site, dt)
        else:
            _KERNEL_SHAPES_SEEN.add(key)
            led.note_miss(site, dt)
        return out

    def device_resident_bytes(self) -> int:
        """Estimated device residency of this engine's retained tensors
        (node tensors, resident `used`, const cache, and the base-mask
        table, which the reference has no counterpart of): the storage
        bytes of each, a storage counted once.  Reads WITHOUT the packer
        lock — callers sit inside _note_h2d, some of whose call sites
        already hold it — so a concurrent eviction can tear an
        iteration; this is a gauge, report the partial sum rather than
        block the hot path."""
        total = 0
        seen = set()
        try:
            base = self._base
            for v in (*tuple(self._dev_cache.values()), self._used_dev,
                      *tuple(self._const_cache.values()),
                      base[3] if base is not None else None):
                if v is None:
                    continue
                st = v.untyped_storage()
                ptr = st.data_ptr()
                if ptr not in seen:
                    seen.add(ptr)
                    total += st.nbytes()
        except RuntimeError:
            pass
        return total

    def _padded_n(self, n: int) -> int:
        """Node count padded to a mesh multiple (identity unsharded)."""
        return pmesh.pad_nodes(n, self._ndev)

    def job_masks(self, t: NodeTensors, job, ctx: JobContext):
        """The job's datacenter and node pool masks on the device, padded
        to the node arrays' npad rows (padding rows ineligible)."""
        npad = self._padded_n(t.n)
        dcm = self._dev_const(
            ("dc", t.version, npad, tuple(job.datacenters)),
            lambda: _pad_rows(ctx.dc_mask, npad, False))
        pm = self._dev_const(("pool", t.version, npad, job.node_pool),
                             lambda: _pad_rows(ctx.pool_mask, npad, False))
        return dcm, pm

    @staticmethod
    def _sharded(kind: str):
        """The mesh wrapper of `kind` (see _SHARDED_KINDS)."""
        return getattr(pmesh, _SHARDED_KINDS[kind])

    # ------------------------------------------------------------ devices

    def _node_arrays(self, t: NodeTensors):
        """Upload node tensors once per (version, vocab, width) — the
        incremental device sync point.  On a mesh the node axis is padded
        to a shard multiple (padded rows ineligible, attributes UNSET),
        and a version bump from dirty-row refreshes with stable width and
        padding re-uploads only the shards that hold dirty rows."""
        key = (t.version, len(self.packer.interner), t.attrs.shape[1])
        if self._cache_version != key:
            t0h = time.perf_counter()
            with self.packer.lock:
                npad = self._padded_n(t.n)
                h2d = 0
                patched = False
                if (self.mesh is not None and self._dev_cache
                        and self._cache_version[2] == key[2]
                        and self._cache_npad == npad):
                    rows = self.packer.node_rows_dirty_since(
                        self._cache_version[0])
                    if rows is not None:
                        h2d = self._patch_node_shards(t, npad, rows)
                        patched = True
                if not patched:
                    self._dev_cache = {
                        "attrs": self._to_dev(_pad_rows(t.attrs, npad,
                                                        UNSET)),
                        "cap": self._to_dev(_pad_rows(t.cap, npad)),
                        "elig": self._to_dev(_pad_rows(t.elig, npad,
                                                       False)),
                    }
                    h2d = sum(v.nbytes for v in self._dev_cache.values())
                    # a full re-upload invalidates the resident `used`
                    # copy too (row remap / width change); a shard patch
                    # keeps it and _used_device heals the dirty shards
                    self._used_version = -1
                    self._used_dev = None
                self._cache_version = key
                self._cache_npad = npad
            self._note_h2d(h2d, time.perf_counter() - t0h,
                           "dirty-shard-patch" if patched
                           else "initial-upload")
        return self._dev_cache

    def _shard_of(self, rows: np.ndarray, npad: int) -> set:
        """Mesh shard indices owning `rows` (node axis split evenly)."""
        nloc = max(npad // self._ndev, 1)
        return set((np.asarray(rows, np.int64) // nloc).tolist())

    def _patch_shards(self, arr: torch.Tensor, host: np.ndarray, fill,
                      npad: int, dirty_shards: set
                      ) -> Tuple[torch.Tensor, int]:
        """A copy of the node-sharded tensor `arr` with the row ranges of
        `dirty_shards` re-uploaded from the host tensor (padding rows
        `fill`); the clean shards are copied on the device.  Returns
        (new tensor, bytes uploaded)."""
        nloc = max(npad // self._ndev, 1)
        out = arr.clone()
        nbytes = 0
        for sh in sorted(dirty_shards):
            lo = sh * nloc
            sl = np.full((nloc,) + host.shape[1:], fill, host.dtype)
            real = max(min(lo + nloc, host.shape[0]) - lo, 0)
            if real:
                sl[:real] = host[lo:lo + real]
            out[lo:lo + nloc] = self._to_dev(sl)
            nbytes += sl.nbytes
        return out, nbytes

    def _patch_node_shards(self, t: NodeTensors, npad: int,
                           rows: np.ndarray) -> int:
        """Dirty-shard re-upload of attrs/cap/elig (packer lock held by
        the caller).  Zero rows = nothing to move (version-only bump)."""
        if rows.size == 0:
            return 0
        dirty = self._shard_of(rows, npad)
        nbytes = 0
        cache = dict(self._dev_cache)
        for name, host, fill in (("attrs", t.attrs, UNSET),
                                 ("cap", t.cap, 0),
                                 ("elig", t.elig, False)):
            cache[name], nb = self._patch_shards(
                cache[name], host, fill, npad, dirty)
            nbytes += nb
        self._dev_cache = cache
        self.shard_h2d_bytes += nbytes
        _registry().inc("nomad.engine.shard_h2d_bytes", nbytes)
        return nbytes

    def _used_device(self, t: NodeTensors) -> torch.Tensor:
        """Device-resident usage tensor.  The packer's delta log is
        replayed onto it in place through K4 (K13 on a mesh): upload
        O(changed rows), not O(N).  On a mesh, a dirty-row refresh heals
        only the shards whose rows may be stale; a row remap or rebuild
        re-uploads it whole, padded."""
        with self.packer.lock:
            ver = t.used_version
            if self._used_dev is not None and self._used_version == ver:
                return self._used_dev
            t0h = time.perf_counter()
            h2d_bytes = 0
            deltas = None
            if self._used_dev is not None:
                deltas = self.packer.used_deltas_since(self._used_version)
            if (deltas is None and self._used_dev is not None
                    and self.mesh is not None):
                sync_rows = self.packer.used_sync_rows_since(
                    self._used_version)
                if (sync_rows is not None
                        and self._cache_npad == self._padded_n(t.n)):
                    if sync_rows.size:
                        self._used_dev, nb = self._patch_shards(
                            self._used_dev, t.used, 0, self._cache_npad,
                            self._shard_of(sync_rows, self._cache_npad))
                        h2d_bytes += nb
                        self.shard_h2d_bytes += nb
                        _registry().inc("nomad.engine.shard_h2d_bytes",
                                        nb)
                    self._used_version = ver
                    self._note_h2d(h2d_bytes, time.perf_counter() - t0h,
                                   "dirty-shard-patch")
                    return self._used_dev
            if deltas is not None:
                rows = np.concatenate([d[0] for d in deltas])
                vals = np.concatenate([d[1] for d in deltas])
                # aggregate per row first: a 100k-alloc plan touches far
                # fewer distinct rows
                if len(rows) > SCATTER_CHUNK:
                    uniq, inv = np.unique(rows, return_inverse=True)
                    agg = np.zeros((len(uniq), 3), vals.dtype)
                    np.add.at(agg, inv, vals)
                    rows, vals = uniq, agg
                dev = self._used_dev
                for lo in range(0, len(rows), SCATTER_CHUNK):
                    r_h = rows[lo:lo + SCATTER_CHUNK].astype(np.int32)
                    v_h = vals[lo:lo + SCATTER_CHUNK].astype(np.int32)
                    # the reference's pad bucket names the ledger site
                    for pad in (512, 2048, 8192, SCATTER_CHUNK):
                        if len(r_h) <= pad:
                            break
                    r_c, v_c = self._to_dev(r_h), self._to_dev(v_h)
                    if self.mesh is not None:
                        self._launch("scatter", (int(dev.shape[0]), pad),
                                     self._sharded("scatter"), dev, r_c,
                                     v_c, self.mesh)
                    else:
                        self._launch("scatter", (int(dev.shape[0]), pad),
                                     scatter_add_, dev, r_c, v_c)
                    h2d_bytes += r_h.nbytes + v_h.nbytes
            else:
                self._used_dev = self._to_dev(
                    _pad_rows(t.used, self._padded_n(t.n)))
                h2d_bytes += self._used_dev.nbytes
            self._used_version = ver
            # the delta-log scatter replays stale usage after a chain
            # invalidation / plan commit; a full upload is the initial
            # (or post-rebuild) sync
            self._note_h2d(h2d_bytes, time.perf_counter() - t0h,
                           "invalidation-replay" if deltas is not None
                           else "initial-upload")
            return self._used_dev

    def _dev_const(self, key, builder) -> torch.Tensor:
        """Small per-eval tensors that repeat across evals (dc/pool
        masks, the LUT matrix, zero rows) — uploaded once and reused by
        cache key (LRU via dict insertion order)."""
        with self.packer.lock:
            hit = self._const_cache.pop(key, None)
            if hit is not None:
                self._const_cache[key] = hit
                return hit
        val = self._to_dev(np.asarray(builder()))
        with self.packer.lock:
            if len(self._const_cache) > 256:
                for old in list(self._const_cache)[:64]:
                    self._const_cache.pop(old, None)
            self._const_cache[key] = val
        return val

    def _base_row(self, t: NodeTensors, npad: int, key, ctx):
        """(row, table): the row of the job's `dc & pool` mask in the
        resident base table (`self._base`: one row per (datacenters,
        pool) key seen at this node-table version and padding), uploading
        the row for a new key, and the table that holds it and every
        earlier row.  K1 reads base rows by index (`u_mask`), so a wave
        passes the table itself and stacks nothing."""
        with self.packer.lock:
            tab = self._base
            if tab is None or tab[0] != (t.version, npad):
                tab = self._base = [(t.version, npad), {}, [], None]
            _, index, host, dev = tab
            i = index.get(key)
            if i is not None:
                return i, dev
            i = len(host)
            row = _pad_rows(ctx.dc_mask & ctx.pool_mask, npad, False)
            host.append(row)
            index[key] = i
            if dev is not None and i < dev.shape[0]:
                dev[i].copy_(torch.from_numpy(row))
            else:
                # a new table, twice the rows, from the host rows (an
                # earlier wave's launch keeps the old one)
                full = np.zeros((max(8, 2 * i), npad), bool)
                full[:i + 1] = host
                tab[3] = self._to_dev(full)
            return i, tab[3]

    def _dc_counts(self, t: NodeTensors) -> Dict[str, int]:
        """Ready-node count per datacenter (AllocMetric.nodes_available),
        cached per row version."""
        if self._dc_cache is not None and self._dc_cache[0] == t.version:
            return self._dc_cache[1]
        counts: Dict[str, int] = {}
        if t.n:
            bc = np.bincount(t.dc[t.elig])
            for vid in np.nonzero(bc)[0]:
                counts[self.packer.interner.string(int(vid))] = int(bc[vid])
        self._dc_cache = (t.version, counts)
        return counts

    @staticmethod
    def _metrics_from_meta(meta, n, n_in_pool, dc_counts, node_ids,
                           elapsed) -> List[AllocMetric]:
        """Per-round AllocMetric objects from the compact meta block."""
        dims = ("cpu", "memory", "disk")
        tsc = meta[:, 3:6].view(np.float32).tolist()
        metrics: List[AllocMetric] = []
        for r, row in enumerate(meta.tolist()):
            metric = AllocMetric(
                nodes_evaluated=n,
                nodes_filtered=row[7],
                nodes_in_pool=n_in_pool,
                nodes_available=dc_counts,
                nodes_exhausted=row[8],
                allocation_time_ns=elapsed,
            )
            if row[9] or row[10] or row[11]:
                for d in range(3):
                    if row[9 + d]:
                        metric.dimension_exhausted[dims[d]] = row[9 + d]
            metric.score_meta_data = [
                NodeScoreMeta(node_id=node_ids[kr],
                              scores={"final": ks}, norm_score=ks)
                for kr, ks in zip(row[0:3], tsc[r]) if kr >= 0]
            metrics.append(metric)
        return metrics

    def _fetch(self, t: torch.Tensor) -> np.ndarray:
        """A device result as a host array (waits for the kernels), with
        the d2h ledger fed ("result-fetch" cause)."""
        t0 = time.perf_counter_ns()
        out = t.cpu().numpy()
        self._note_d2h(out.nbytes, (time.perf_counter_ns() - t0) / 1e9)
        return out

    # -------------------------------------------------------------- solo

    def _device_mask(self, tgs: Sequence[TaskGroup], t: NodeTensors,
                     snapshot, stopped_ids, device_in_use=None):
        """Host-side DeviceChecker analog (scheduler/device.py): a [G, N]
        bool mask of "node can satisfy this task group's device
        requests", ANDed into the kernels' static feasibility.  None when
        no group asks for devices.  `device_in_use` overlays in-plan
        assignments the snapshot cannot see yet."""
        from nomad_tpu_torch.scheduler.device import (
            InUseIndex, node_feasible, tg_device_requests)
        reqs_by_g = [tg_device_requests(tg) for tg in tgs]
        if not any(reqs_by_g):
            return None
        dev_nodes = []
        for row, nid in enumerate(t.node_ids):
            node = snapshot.node_by_id(nid)
            if node is not None and node.resources.devices:
                dev_nodes.append((row, node))
        in_use = InUseIndex()
        for row, node in dev_nodes:
            for a in snapshot.allocs_by_node(node.id):
                if a.terminal_status() or a.id in stopped_ids:
                    continue
                in_use.add_alloc(node.id, a)
        if device_in_use is not None:
            for node_id, gid, ids in device_in_use.items():
                in_use.add(node_id, gid, ids)
        mask = np.zeros((len(tgs), t.n), bool)
        for g, tg in enumerate(tgs):
            if not reqs_by_g[g]:
                mask[g, :] = True
                continue
            for row, node in dev_nodes:
                mask[g, row] = node_feasible(node, tg, in_use)
        return mask

    def place(self, snapshot, job: Job, tgs: Sequence[TaskGroup],
              requests: Sequence[PlacementRequest],
              tensors: Optional[NodeTensors] = None,
              stopped_allocs: Sequence = (),
              bulk_api: bool = False,
              seed: int = 0,
              device_in_use=None,
              block=None,
              ):
        """Score + select nodes for `requests` (placements of `tgs`), one
        decision per request in order, or a BulkDecisions with `bulk_api`
        when the batch takes the bulk rounds.

        `block`: a (tg_name, count) pair of `count` fresh placements of
        one task group, the compact alternative to `requests`.
        `stopped_allocs`: allocs the in-flight plan stops; their usage
        (and this job's counts) is subtracted before scoring.  `seed`:
        the per-eval tie-break for equal scores."""
        if block is not None:
            block_tg, block_count = block
            if block_count <= 0:
                return []
        elif not requests:
            return []
        t0 = time.perf_counter_ns()
        t = tensors if tensors is not None else self.packer.update(snapshot)
        n = t.n
        if n == 0:
            if block is not None:
                requests = [PlacementRequest(tg_name=block_tg)] * block_count
            return [self._no_nodes_decision(r, snapshot, job)
                    for r in requests]

        tg_tensors: TGTensors = self.packer.lower_task_groups(
            job, tgs, snapshot=snapshot)
        ctx: JobContext = self.packer.job_context(job, snapshot, t)

        name_to_g = {name: i for i, name in enumerate(tg_tensors.names)}
        p_real = block_count if block is not None else len(requests)
        p_pad = _pad_pow2(p_real)
        npad = self._padded_n(n)

        desired = np.array([tg.count for tg in tgs], np.int32)
        algo = snapshot.scheduler_config().scheduler_algorithm
        dev = self._node_arrays(t)
        used0 = self._used_device(t)
        job_count = ctx.job_count
        if stopped_allocs:
            delta = np.zeros((npad, 3), np.int32)
            job_count = job_count.copy()
            for a in stopped_allocs:
                row = t.id_to_row.get(a.node_id)
                if row is None:
                    continue
                delta[row, 0] -= a.resources.cpu
                delta[row, 1] -= a.resources.memory_mb
                delta[row, 2] -= a.resources.disk_mb
                if a.job_id == job.id and job_count[row] > 0:
                    job_count[row] -= 1
            used0 = used0 + self._to_dev(delta)
            K.count_eager("solo_used0_delta")

        dcm, pm = self.job_masks(t, job, ctx)
        luts_dev = self._dev_const(
            ("luts", self.packer.lut_epoch, tg_tensors.luts.shape),
            lambda: tg_tensors.luts)
        if job_count.any():
            jc_dev = self._to_dev(_pad_rows(job_count, npad))
        else:
            jc_dev = self._dev_const(("zjc", npad),
                                     lambda: np.zeros(npad, np.int32))

        # device (GPU/...) feasibility: a host-computed per-group node mask
        dev_mask = self._device_mask(
            tgs, t, snapshot, {a.id for a in stopped_allocs}, device_in_use)
        extra_mask = (None if dev_mask is None
                      else self._to_dev(_pad_cols(dev_mask, npad, False)))

        has_spread = bool(job.spreads) or any(tg.spreads for tg in tgs)
        has_distinct = any(tg_tensors.distinct)
        if block is not None:
            bulk_ok = (p_real >= BULK_THRESHOLD
                       and not has_spread and not has_distinct
                       and dev_mask is None)
            if not bulk_ok or not bulk_api:
                # the exact scan and per-placement decisions need rows
                requests = [PlacementRequest(tg_name=block_tg)] * p_real
        else:
            bulk_ok = (
                p_real >= BULK_THRESHOLD
                and len({r.tg_name for r in requests}) == 1
                and not has_spread and not has_distinct
                # device asks cap per-node intake by discrete instance
                # counts, which the rounds cannot see: exact scan only
                and dev_mask is None
                and all(not r.prev_node_id for r in requests))
        # the sharded bulk rounds have no score block: the per-placement
        # API routes through the exact scan on a mesh
        if self.mesh is not None and not bulk_api:
            bulk_ok = False

        if bulk_ok:
            g_idx = name_to_g[block_tg if block is not None
                              else requests[0].tg_name]
            round_size = min(BULK_ROUND, p_pad)
            n_rounds = p_pad // round_size
            binp = BulkInputs(
                attrs=dev["attrs"], cap=dev["cap"], used0=used0,
                elig=dev["elig"], dc_mask=dcm, pool_mask=pm, luts=luts_dev,
                con=self._to_dev(tg_tensors.con),
                aff=self._to_dev(tg_tensors.aff),
                req=self._to_dev(tg_tensors.req),
                desired=self._to_dev(desired),
                dh_limit=self._to_dev(tg_tensors.dh_limit),
                job_count0=jc_dev,
                spread_algo=algo == SCHED_ALGO_SPREAD,
                g=g_idx, p_real=p_real, seed=seed & 0xFFFFFFFF,
                extra_mask=extra_mask)
            fills_full = None
            slot_k = 0
            if self.mesh is not None:
                buf, used_dev, job_count_dev = self._launch(
                    "bulk", (round_size, n_rounds, npad),
                    self._sharded("bulk"), binp, self.mesh, round_size,
                    n_rounds)
                self._note_collective(n_rounds,
                                      min(round_size, npad // self._ndev))
            elif bulk_api and algo != SCHED_ALGO_SPREAD:
                # compact output: FILL_K slots always fetched, the full
                # fills stay on the device for a round that overflows
                # (the spread algorithm fans each round over ~want nodes
                # and keeps the full layout)
                slot_k = min(FILL_K, round_size)
                buf, fills_full, used_dev, job_count_dev = self._launch(
                    "bulk_compact", (round_size, n_rounds, npad, slot_k),
                    place_bulk_packed, binp, round_size, n_rounds, False,
                    slot_k)
            else:
                buf, used_dev, job_count_dev = self._launch(
                    "bulk", (round_size, n_rounds, npad, bulk_api),
                    place_bulk_packed, binp, round_size, n_rounds,
                    not bulk_api)
            tg_idx = np.full(p_real, g_idx, np.int32)
            if bulk_api:
                buf_np, slot_k = _resolve_compact_fills(
                    self._fetch(buf),
                    None if fills_full is None
                    else (lambda: self._fetch(fills_full)), slot_k)
                picks, _, meta = _unpack_bulk_compact(
                    buf_np, round_size, p_real, slot_k=slot_k)
                if npad != n:
                    # mesh padding rows are statically infeasible; they
                    # are not filtered nodes
                    meta = meta.copy()
                    meta[:, 7] -= npad - n
                return self._bulk_decisions(
                    block_tg if block is not None else requests[0].tg_name,
                    picks, meta, round_size, t, ctx,
                    snapshot, job, binp, tg_tensors, tg_idx, used_dev,
                    job_count_dev, p_real, n, t0)
            (picks, scores, topk_rows, topk_scores,
             n_feas, n_filt, n_exh, dim_exh) = _unpack_bulk(
                self._fetch(buf), round_size, p_real)
            inp = binp      # _preempt_fallback's field source
        else:
            sp: SpreadTensors = lower_spreads(self.packer, job, t, snapshot)
            pd = self.packer.lower_distinct(job, tgs, tg_tensors, t,
                                            snapshot)
            tg_idx = np.zeros(p_pad, np.int32)
            prev_row = np.full(p_pad, -1, np.int32)
            active = np.zeros(p_pad, bool)
            for i, r in enumerate(requests):
                tg_idx[i] = name_to_g[r.tg_name]
                if r.prev_node_id:
                    prev_row[i] = t.id_to_row.get(r.prev_node_id, -1)
                active[i] = True
            inp = PlacementInputs(
                attrs=dev["attrs"], cap=dev["cap"], used0=used0,
                elig=dev["elig"], dc_mask=dcm, pool_mask=pm, luts=luts_dev,
                con=self._to_dev(tg_tensors.con),
                aff=self._to_dev(tg_tensors.aff),
                req=self._to_dev(tg_tensors.req),
                desired=self._to_dev(desired),
                dh_limit=self._to_dev(tg_tensors.dh_limit),
                sp_nodeval=self._to_dev(_pad_cols(sp.sp_nodeval, npad, -1)),
                sp_weight=self._to_dev(sp.sp_weight),
                sp_expected=self._to_dev(sp.sp_expected),
                sp_counts0=self._to_dev(sp.sp_counts0),
                pd_nodeval=self._to_dev(_pad_cols(pd.pd_nodeval, npad, -1)),
                pd_limit=self._to_dev(pd.pd_limit),
                pd_apply=self._to_dev(pd.pd_apply),
                pd_counts0=self._to_dev(pd.pd_counts0),
                tg_idx=self._to_dev(tg_idx),
                prev_row=self._to_dev(prev_row),
                active=self._to_dev(active),
                job_count0=jc_dev,
                spread_algo=algo == SCHED_ALGO_SPREAD,
                seed=seed & 0xFFFFFFFF,
                extra_mask=extra_mask)
            if self.mesh is not None:
                buf, used_dev, job_count_dev = self._launch(
                    "scan", (npad, p_pad), self._sharded("scan"), inp,
                    self.mesh)
                self._note_collective(
                    p_pad, min(TOP_K, npad // self._ndev), width=2,
                    extra=128)
            else:
                buf, used_dev, job_count_dev = self._launch(
                    "scan", (npad, p_pad), place_packed, inp)
            b = self._fetch(buf)[:p_real]
            picks = b[:, 0].copy()
            scores = b[:, 1].view(np.float32)
            topk_rows = b[:, 2:5]
            topk_scores = b[:, 5:8].view(np.float32)
            n_filt = b[:, 9] - (npad - n)
            n_exh = b[:, 10]
            dim_exh = b[:, 11:14]
        elapsed = (time.perf_counter_ns() - t0) // max(p_real, 1)

        # ---- preemption fallback for failed placements ----
        evictions_by_req = self._preempt_fallback(
            picks, snapshot, job, inp, tg_tensors, tg_idx,
            t, used_dev, job_count_dev, p_real)

        dc_counts = self._dc_counts(t)
        picks_l = picks.tolist()
        scores_l = scores.tolist()
        topk_rows_l = topk_rows.tolist()
        topk_scores_l = topk_scores.tolist()
        n_filt_l = n_filt.tolist()
        n_exh_l = n_exh.tolist()
        dim_exh_l = dim_exh.tolist()
        n_in_pool = int(ctx.pool_mask.sum())
        elapsed = int(elapsed)
        node_ids = t.node_ids

        # score_meta_data repeats within a bulk round: one shared list per
        # distinct top-k (read-only by convention)
        smd_cache: Dict[tuple, list] = {}
        decisions: List[PlacementDecision] = []
        dims = ("cpu", "memory", "disk")
        for i, r in enumerate(requests):
            metric = AllocMetric(
                nodes_evaluated=n,
                nodes_filtered=n_filt_l[i],
                nodes_in_pool=n_in_pool,
                nodes_available=dc_counts,
                nodes_exhausted=n_exh_l[i],
                allocation_time_ns=elapsed,
            )
            de = dim_exh_l[i]
            if de[0] or de[1] or de[2]:
                for d in range(3):
                    if de[d]:
                        metric.dimension_exhausted[dims[d]] = de[d]
            key = (tuple(topk_rows_l[i]), tuple(topk_scores_l[i]))
            smd = smd_cache.get(key)
            if smd is None:
                smd = [NodeScoreMeta(node_id=node_ids[kr],
                                     scores={"final": ks},
                                     norm_score=ks)
                       for kr, ks in zip(topk_rows_l[i], topk_scores_l[i])
                       if kr >= 0]
                smd_cache[key] = smd
            metric.score_meta_data = smd
            pick = picks_l[i]
            node_id = node_ids[pick] if pick >= 0 else None
            decisions.append(PlacementDecision(
                tg_name=r.tg_name, node_id=node_id,
                score=scores_l[i], metric=metric,
                evictions=evictions_by_req.get(i, [])))
        return decisions

    # Device preemption runs over the compact victim tables (candidate
    # nodes x pow2 depth), one K7 launch per failing task group; groups
    # chain through the same usage state.  The host Preemptor covers
    # small batches, oversized tables and whatever the kernel left.
    PREEMPT_DEVICE_MIN_FAILED = 4
    # upload guard: candidates x depth
    PREEMPT_DEVICE_MAX_TABLE = 256 * 1024

    def _preempt_fallback(self, picks, snapshot, job, inp, tg_tensors,
                          tg_idx, t, used_dev, job_count_dev, p_real
                          ) -> Dict[int, List]:
        """Preemption for placements the kernels could not fit, when the
        scheduler type enables it.  Mutates `picks`."""
        evictions_by_req: Dict[int, List] = {}
        if (not np.any(picks < 0)
                or not preemption_enabled(snapshot.scheduler_config(),
                                          job.type)):
            return evictions_by_req
        # mesh padding rows sliced off: the preemptor works over the real
        # node rows
        static = self._fetch(feasible_mask(
            inp.attrs, inp.elig, inp.dc_mask, inp.pool_mask, inp.con,
            inp.luts))[:, :t.n]
        used = self._fetch(used_dev)[:t.n]
        job_count = self._fetch(job_count_dev)[:t.n]
        pre_evicted: set = set()

        failed = [i for i in range(p_real) if picks[i] < 0]
        by_g: Dict[int, list] = {}
        for i in failed:
            by_g.setdefault(int(tg_idx[i]), []).append(i)
        tables = None
        # victims consumed so far per row, shared across the chained
        # per-group launches: each victim frees its capacity once
        taken: Dict[int, int] = {}
        for g, failed_g in sorted(by_g.items()):
            if len(failed_g) < self.PREEMPT_DEVICE_MIN_FAILED:
                continue
            if tables is None:
                tables = build_victim_tables(job, snapshot, t)
            if (not tables[3]
                    or tables[1].size > self.PREEMPT_DEVICE_MAX_TABLE):
                break
            used, job_count = self._preempt_device(
                failed_g, g, tables, tg_tensors, t, static,
                used, job_count, picks, evictions_by_req, pre_evicted,
                taken)

        if not np.any(picks < 0):
            return evictions_by_req
        preemptor = Preemptor(job, snapshot, t, static, used,
                              job_count=job_count,
                              dh_limit=tg_tensors.dh_limit)
        preemptor.evicted_ids |= pre_evicted
        for i in range(p_real):
            if picks[i] >= 0:
                continue
            g = int(tg_idx[i])
            res = preemptor.preempt_for(g, tg_tensors.req[g].astype(np.int64))
            if res is not None:
                picks[i] = res.node_row
                evictions_by_req[i] = res.evictions
        return evictions_by_req

    def _preempt_device(self, failed, g, tables, tg_tensors, t,
                        static, used, job_count, picks, evictions_by_req,
                        pre_evicted, taken):
        """One K7 launch for ONE task group's failed batch over the
        compact candidate tables; maps (candidate, k) results back to
        victim allocs.  Victims consumed by earlier groups (`taken`)
        start consumed.  Returns the post-eviction (used, job_count)."""
        cand_rows, prio, res, by_row = tables
        k0 = np.zeros(len(cand_rows), np.int32)
        if taken:
            for ci, row in enumerate(cand_rows):
                k0[ci] = taken.get(int(row), 0)
        # candidate axis padded on the pow2 ladder
        m = len(cand_rows)
        m_pad = _pad_pow2(m)

        def padr(a, fill=0):
            out = np.full((m_pad,) + a.shape[1:], fill, a.dtype)
            out[:m] = a
            return out

        best_c, ks, used2_c, jc2_c = preempt_bulk(
            self._to_dev(padr(t.cap[cand_rows])),
            self._to_dev(padr(used[cand_rows])),
            self._to_dev(padr(static[g][cand_rows], False)),
            int(tg_tensors.dh_limit[g]),
            self._to_dev(padr(job_count[cand_rows])),
            self._to_dev(padr(prio, 1 << 30)), self._to_dev(padr(res)),
            self._to_dev(tg_tensors.req[g].astype(np.int32)),
            self._to_dev(padr(k0)),
            _pad_pow2(len(failed)), len(failed))
        best_c = self._fetch(best_c)
        ks = self._fetch(ks)
        used = used.copy()
        used[cand_rows] = self._fetch(used2_c)[:m]
        job_count = job_count.copy()
        job_count[cand_rows] = self._fetch(jc2_c)[:m]
        for j, i in enumerate(failed):
            ci = int(best_c[j])
            if ci < 0:
                continue
            row = int(cand_rows[ci])
            k = int(ks[j])
            start = taken.get(row, 0)
            victims = by_row[row][start:start + k]
            taken[row] = start + k
            picks[i] = row
            evictions_by_req[i] = victims
            pre_evicted.update(v.id for v in victims)
        return used, job_count

    def _bulk_decisions(self, tg_name, picks, meta, round_size, t, ctx,
                        snapshot, job, inp, tg_tensors, tg_idx, used_dev,
                        job_count_dev, p_real, n, t0) -> BulkDecisions:
        evictions = self._preempt_fallback(
            picks, snapshot, job, inp, tg_tensors, tg_idx,
            t, used_dev, job_count_dev, p_real)
        elapsed = int(time.perf_counter_ns() - t0) // max(p_real, 1)
        metrics = self._metrics_from_meta(
            meta, n, int(ctx.pool_mask.sum()), self._dc_counts(t),
            t.node_ids, elapsed)
        return BulkDecisions(
            tg_name=tg_name, picks=picks, node_ids=t.node_ids,
            round_size=round_size, metrics=metrics, evictions=evictions,
            nodes_evaluated=n)

    def _no_nodes_decision(self, r: PlacementRequest, snapshot, job: Job
                           ) -> PlacementDecision:
        return PlacementDecision(
            tg_name=r.tg_name, node_id=None, score=0.0,
            metric=AllocMetric(nodes_evaluated=0))

    # -------------------------------------------------------- multi-eval

    def place_batch(self, snapshot, items: Sequence[BatchItem],
                    seed=0) -> List[Optional[BulkDecisions]]:
        """Score + select nodes for MANY evals' placement blocks in ONE
        device launch.  Rounds run sequentially on the device, so the
        items' plans see each other's proposed usage.  `seed` may be one
        int (broadcast) or one per item.  Returns one BulkDecisions per
        item (None when the cluster is empty).  Preemption is not
        attempted here."""
        pending = self.dispatch_batch(snapshot, items, seed=seed)
        return self.collect_batch(pending)

    def dispatch_batch(self, snapshot, items: Sequence[BatchItem],
                       seed=0, used0_dev=None, masked_node_ids=None):
        """Asynchronous half of place_batch: pack + LAUNCH the kernels and
        start the result's copy to pinned host memory; returns a pending
        handle for collect_batch.

        `used0_dev`: a (usage tensor, node-table version, padded node
        count `npad`) triple to start from instead of the packer-synced state — the
        cross-batch chaining hook (a wave may start from the previous
        wave's proposed usage before its plans commit).  On a version or
        size mismatch the chain falls back to the packer-synced tensor.
        An accepted chain reuses that tensor in place: the caller must
        not read it afterwards except through this wave's result.

        `masked_node_ids`: node ids excluded from this launch's
        eligibility (the wave pipeline's refute-repair input)."""
        if not items:
            return None
        # per-dispatch dirty-shard upload meter
        shard_b0 = self.shard_h2d_bytes
        built = self.build_multi_inputs(snapshot, items, seed=seed,
                                        used0_dev=used0_dev,
                                        masked_node_ids=masked_node_ids)
        if isinstance(built, tuple):
            return built                 # empty-cluster sentinel
        inp, rs, aux = built["inp"], built["rs"], built
        chained = aux["chained"]
        fills_full = None
        fill_k = None
        coll_bytes = 0
        mesh = self.mesh
        launch = self._launch
        skey = (rs, aux["npad"], aux["n_lanes"])
        if aux["cand_rows"] is not None:
            cr = self._to_dev(aux["cand_rows"])
            cv = self._to_dev(aux["cand_valid"])
            if mesh is not None:
                if chained:
                    buf, fills_full, used_out = launch(
                        "multi_compact_chained", skey,
                        self._sharded("multi_compact_chained"),
                        inp.used0, inp._replace(used0=None), cr, cv,
                        mesh, rs, aux["n_lanes"])
                else:
                    buf, fills_full, used_out = launch(
                        "multi_compact", skey,
                        self._sharded("multi_compact"), inp, cr, cv, mesh,
                        rs, aux["n_lanes"])
                coll_bytes = self._note_collective(
                    int(inp.round_g.shape[0]),
                    min(rs, int(aux["cand_rows"].shape[-1])))
            elif chained:
                buf, fills_full, used_out = launch(
                    "multi_compact_chained", skey,
                    place_multi_compact_chained, inp.used0,
                    inp._replace(used0=None), cr, cv, rs, aux["n_lanes"])
            else:
                buf, fills_full, used_out = launch(
                    "multi_compact", skey, place_multi_compact_packed, inp,
                    cr, cv, rs, aux["n_lanes"])
            fill_k = min(FILL_K, rs)
        elif mesh is not None:
            if chained:
                buf, used_out, _ = launch(
                    "multi_chained", skey, self._sharded("multi_chained"),
                    inp.used0, inp._replace(used0=None), mesh, rs)
            else:
                buf, used_out, _ = launch(
                    "multi", skey, self._sharded("multi"), inp, mesh, rs)
            coll_bytes = self._note_collective(
                int(inp.round_g.shape[0]), min(rs, aux["npad"] // self._ndev))
        elif chained:
            buf, used_out, _ = launch(
                "multi_chained", skey, place_multi_chained, inp.used0,
                inp._replace(used0=None), rs)
        else:
            buf, used_out, _ = launch("multi", skey, place_multi_packed,
                                      inp, rs)
        host_buf, ready = self._start_fetch(buf)
        return {"buf": host_buf, "ready": ready, "used": used_out,
                "items": list(items), "spans": aux["spans"],
                "counts": aux["counts"], "rs": rs, "t": aux["t"],
                "ctxs": aux["ctxs"], "n": aux["n"], "npad": aux["npad"],
                "collective_bytes": coll_bytes,
                "shard_h2d_bytes": self.shard_h2d_bytes - shard_b0,
                "padded_fraction": (aux["npad"] - aux["n"]) / aux["npad"],
                "node_version": aux["t"].version, "perm": aux["perm"],
                "fills_full": fills_full, "fill_k": fill_k,
                "chained": chained, "n_lanes": aux["n_lanes"],
                "cand_rows": aux["cand_rows"],
                "prep_ns": time.perf_counter_ns() - aux["t0"]}

    def _start_fetch(self, buf: torch.Tensor):
        """Queue the result buffer's device->host copy behind the kernels
        (non-blocking, into pinned memory) and record an event that marks
        its arrival.  A CPU buffer is already on the host."""
        if buf.device.type == "cpu":
            return buf, None
        host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
        host.copy_(buf, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(buf.device))
        return host, ready

    def build_multi_inputs(self, snapshot, items: Sequence[BatchItem],
                           seed=0, used0_dev=None, masked_node_ids=None):
        """Host half of dispatch_batch: pack + lower a multi-eval batch
        into MultiEvalInputs WITHOUT launching the placement kernels.
        Returns a dict {inp, rs, spans, counts, t, ctxs, n, npad, t0,
        n_lanes, perm, chained, cand_rows, cand_valid} or the
        empty-cluster sentinel tuple.  On a mesh the compact frames are
        per shard, [S, L, Nc_loc], and their job-count seeds
        [S, J', Nc_loc]."""
        t = self.packer.update(snapshot)
        n = t.n
        if n == 0:
            return (None, items)
        t0 = time.perf_counter_ns()
        npad = self._padded_n(n)
        dev = self._node_arrays(t)
        used0 = None
        if used0_dev is not None:
            arr, chain_ver, chain_npad = used0_dev
            if chain_ver == t.version and chain_npad == npad:
                used0 = arr
        chained = used0 is not None
        if used0 is None:
            used0 = self._used_device(t)
        # refuted-node mask: a bool row that K1 ANDs into eligibility
        node_ok = None
        if masked_node_ids:
            rows = np.array([t.id_to_row[nid] for nid in masked_node_ids
                             if nid in t.id_to_row], np.int64)
            if rows.size:
                ok = np.ones(npad, bool)
                ok[rows] = False
                node_ok = self._to_dev(ok)
        algo = snapshot.scheduler_config().scheduler_algorithm

        G = len(items)
        g_pad = _pad_pow2(G, lo=1)
        # per-item tie-break seeds: a scalar broadcasts; the worker passes
        # one seed per eval, the value the eval's solo launch would use
        if np.ndim(seed) == 0:
            seed_g = np.full(g_pad, int(seed) & 0xFFFFFFFF, np.uint32)
        else:
            seeds = [int(s) & 0xFFFFFFFF for s in seed]
            if len(seeds) != G:
                raise ValueError(
                    f"per-item seeds: got {len(seeds)} for {G} items")
            seed_g = np.zeros(g_pad, np.uint32)
            seed_g[:G] = seeds
        tgts = []
        ctxs = []
        for it in items:
            tgts.append(self.packer.lower_task_groups(
                it.job, [it.tg], snapshot=snapshot))
            ctxs.append(self.packer.job_context(it.job, snapshot, t))
        # pad the constraint/affinity row axes to a pow2 ladder
        c_max = _pad_pow2(max(tt.con.shape[1] for tt in tgts), lo=1)
        a_max = _pad_pow2(max(tt.aff.shape[1] for tt in tgts), lo=1)
        req = np.zeros((g_pad, 3), np.int32)
        desired = np.ones(g_pad, np.int32)
        dh_limit = np.zeros(g_pad, np.int32)
        # constraint/affinity signatures dedupe across the batch
        g_static = np.zeros(g_pad, np.int32)
        g_aff = np.zeros(g_pad, np.int32)
        static_keys: Dict[bytes, int] = {}
        static_con: List[np.ndarray] = []
        static_mi: List[int] = []
        aff_keys: Dict[bytes, int] = {}
        aff_rows: List[np.ndarray] = []
        jc_nz_idx: List[int] = []
        jc_nz_rows: List[np.ndarray] = []
        for gi, it in enumerate(items):
            tt, ctx = tgts[gi], ctxs[gi]
            req[gi] = tt.req[0]
            desired[gi] = max(it.tg.count, 1)
            dh_limit[gi] = tt.dh_limit[0]
            mi, base_mask = self._base_row(
                t, npad, (tuple(it.job.datacenters), it.job.node_pool), ctx)
            con_row = np.zeros((c_max, 3), np.int32)
            con_row[:tt.con.shape[1]] = tt.con[0]
            skey = con_row.tobytes() + mi.to_bytes(4, "little")
            si = static_keys.get(skey)
            if si is None:
                si = len(static_con)
                static_keys[skey] = si
                static_con.append(con_row)
                static_mi.append(mi)
            g_static[gi] = si
            aff_row = np.zeros((a_max, 4), np.int32)
            aff_row[:tt.aff.shape[1]] = tt.aff[0]
            akey = aff_row.tobytes()
            ai = aff_keys.get(akey)
            if ai is None:
                ai = len(aff_rows)
                aff_keys[akey] = ai
                aff_rows.append(aff_row)
            g_aff[gi] = ai
            if ctx.job_count.any():
                jc_nz_idx.append(gi)
                jc_nz_rows.append(ctx.job_count)
        u_pad = _pad_pow2(len(static_con), lo=1)
        con = np.zeros((u_pad, c_max, 3), np.int32)
        u_mask = np.zeros(u_pad, np.int32)
        for si, row in enumerate(static_con):
            con[si] = row
            u_mask[si] = static_mi[si]
        con = self._to_dev(con)
        u_mask = self._to_dev(u_mask)
        ua_pad = _pad_pow2(len(aff_rows), lo=1)
        aff = np.zeros((ua_pad, a_max, 4), np.int32)
        for ai, row in enumerate(aff_rows):
            aff[ai] = row

        # round schedule: item gi -> ceil(count / rs) consecutive rounds;
        # the smallest bucket covering the biggest item
        counts = [max(it.count, 0) for it in items]
        biggest = max(counts) if counts else 0
        for rs in (64, 256, 512, 1024):
            if biggest <= rs:
                break
        round_g: List[int] = []
        round_want: List[int] = []
        spans: List[Tuple[int, int]] = []
        for gi, c in enumerate(counts):
            start = len(round_g)
            left = c
            while left > 0:
                round_g.append(gi)
                round_want.append(min(left, rs))
                left -= rs
            spans.append((start, len(round_g)))

        # ---- compact lane-parallel schedule ----
        # When the batch's signatures form ONE clique of pairwise
        # provably-disjoint static landscapes, each signature gets a lane
        # and a compact candidate frame, and the rounds run one per lane
        # concurrently: sequential depth drops R -> R/L and per-round work
        # drops N -> Nc.  Otherwise the flat sequential schedule runs.
        n_real = len(round_g)
        n_lanes = 1
        perm = None
        cand_rows = cand_valid = None
        lane_of: Dict[int, int] = {}
        nc = 0
        luts = tgts[-1].luts      # the most complete LUT matrix
        luts_dev = self._dev_const(
            ("luts", self.packer.lut_epoch, luts.shape), lambda: luts)
        if n_real > 1 and len(static_con) > 1:
            weights = [0] * len(static_con)
            for r_idx in range(n_real):
                weights[int(g_static[round_g[r_idx]])] += 1
            cliques = _disjoint_cliques(static_con, luts, weights)
            # one clique of WIDTH > 1: single-signature batches stay on
            # the flat kernel
            if len(cliques) == 1 and len(cliques[0]) > 1:
                clique = cliques[0]
                width = len(clique)
                # the frame IS the static mask on the compact path
                masks = _host_signature_masks(
                    dev["attrs"], con, luts_dev, dev["elig"], base_mask,
                    u_mask, node_ok, clique)
                rows_l = [np.nonzero(masks[i])[0].astype(np.int32)
                          for i in range(width)]
                if self.mesh is None:
                    nc = max(max((len(r) for r in rows_l), default=1), 1)
                    nc = ((nc + 2047) // 2048) * 2048
                    cand_rows = np.full((width, nc), npad, np.int32)
                    cand_valid = np.zeros((width, nc), bool)
                    for li, rows in enumerate(rows_l):
                        cand_rows[li, :len(rows)] = rows
                        cand_valid[li, :len(rows)] = True
                else:
                    # per-shard frame blocks: shard s holds its slice of
                    # every lane's candidates (global rows; padding npad
                    # lies past every shard)
                    ndev = self._ndev
                    nloc = npad // ndev
                    shard_rows = [[rows[(rows // nloc) == sh]
                                   for rows in rows_l]
                                  for sh in range(ndev)]
                    nc = max(max((len(r) for per in shard_rows
                                  for r in per), default=1), 1)
                    nc = ((nc + 511) // 512) * 512
                    cand_rows = np.full((ndev, width, nc), npad, np.int32)
                    cand_valid = np.zeros((ndev, width, nc), bool)
                    for sh in range(ndev):
                        for li, rows in enumerate(shard_rows[sh]):
                            cand_rows[sh, li, :len(rows)] = rows
                            cand_valid[sh, li, :len(rows)] = True
                lane_of = {s: li for li, s in enumerate(clique)}
                lanes: List[List[int]] = [[] for _ in range(width)]
                for r_idx in range(n_real):
                    si = int(g_static[round_g[r_idx]])
                    lanes[lane_of[si]].append(r_idx)
                t_c = max(len(ln) for ln in lanes)
                t_pad = _pad_pow2(t_c, lo=1)
                sched_g: List[int] = []
                sched_want: List[int] = []
                perm = np.zeros(n_real, np.int64)
                for t_i in range(t_pad):
                    for li in range(width):
                        pos = len(sched_g)
                        if t_i < len(lanes[li]):
                            r_idx = lanes[li][t_i]
                            sched_g.append(round_g[r_idx])
                            sched_want.append(round_want[r_idx])
                            perm[r_idx] = pos
                        else:
                            # inert: repeat the lane's previous g (want=0
                            # commits nothing; keeping the same g
                            # preserves job-count chains)
                            prev = (sched_g[pos - width]
                                    if pos >= width else 0)
                            sched_g.append(prev)
                            sched_want.append(0)
                n_lanes = width
                round_g, round_want = sched_g, sched_want

        if cand_rows is None:
            r_pad = _pad_pow2(max(len(round_g), 1), lo=1)
            pad_r = r_pad - len(round_g)
            round_g.extend([0] * pad_r)
            round_want.extend([0] * pad_r)

        # per-job alloc-count seeds.  Compact path: a tiny [J', Nc] table
        # (row 0 = zeros shared by every fresh job; one gathered row per
        # job with live allocs).  Flat path: zeros [G, N] with only the
        # nonzero jobs' rows written.
        if cand_rows is not None:
            g_job = np.zeros(g_pad, np.int32)
            jrows = [np.zeros(cand_rows.shape[:-2] + (nc,), np.int32)]
            for gi, jc_row in zip(jc_nz_idx, jc_nz_rows):
                idx = cand_rows[..., lane_of[int(g_static[gi])], :]
                row = np.where(idx < n, jc_row[np.minimum(idx, n - 1)], 0)
                g_job[gi] = len(jrows)
                jrows.append(row.astype(np.int32))
            jc0 = np.stack(jrows)
            if cand_rows.ndim == 3:
                # sharded seeds: [S, J', Nc_loc]
                jc0 = np.ascontiguousarray(np.moveaxis(jc0, 0, 1))
            jc0 = self._to_dev(jc0)
            g_job_dev = self._to_dev(g_job)
        else:
            jc0 = torch.zeros((g_pad, npad), dtype=torch.int32,
                              device=self.device)
            K.count_eager("flat_jc0_zeros")
            if jc_nz_idx:
                jc0[torch.tensor(jc_nz_idx, device=self.device)] = \
                    self._to_dev(_pad_cols(np.stack(jc_nz_rows), npad)
                                 .astype(np.int32))
                K.count_eager("flat_jc0_set")
            g_job_dev = torch.arange(g_pad, dtype=torch.int32,
                                     device=self.device)
            K.count_eager("flat_g_job_arange")

        inp = MultiEvalInputs(
            attrs=dev["attrs"], cap=dev["cap"], used0=used0,
            elig=dev["elig"], luts=luts_dev, base_mask=base_mask,
            con=con, u_mask=u_mask,
            aff=self._to_dev(aff),
            req=self._to_dev(req), desired=self._to_dev(desired),
            dh_limit=self._to_dev(dh_limit),
            g_static=self._to_dev(g_static), g_aff=self._to_dev(g_aff),
            g_job=g_job_dev,
            job_count0=jc0,
            spread_algo=algo == SCHED_ALGO_SPREAD,
            round_g=self._to_dev(np.array(round_g, np.int32)),
            round_want=self._to_dev(np.array(round_want, np.int32)),
            seed=self._to_dev(seed_g.astype(np.int64)),
            node_ok=node_ok,
        )
        return {"inp": inp, "rs": rs, "spans": spans, "counts": counts,
                "t": t, "ctxs": ctxs, "n": n, "npad": npad, "t0": t0,
                "n_lanes": n_lanes, "perm": perm, "chained": chained,
                "cand_rows": cand_rows, "cand_valid": cand_valid}

    def collect_batch(self, pending) -> List[Optional[BulkDecisions]]:
        """Blocking half of place_batch: wait for the packed buffer and
        expand per-item decisions."""
        if pending is None:
            return []
        if isinstance(pending, tuple):      # empty-cluster dispatch
            return [None] * len(pending[1])
        items = pending["items"]
        spans, counts, rs = (pending["spans"], pending["counts"],
                             pending["rs"])
        t, ctxs, n = pending["t"], pending["ctxs"], pending["n"]
        t1 = time.perf_counter_ns()
        # the d2h meter: the pinned copy's bytes, its seconds the wait on
        # the copy's event (the copy itself was queued at dispatch)
        tw = time.perf_counter()
        if pending["ready"] is not None:
            pending["ready"].synchronize()
        buf_np = pending["buf"].numpy()
        self._note_d2h(buf_np.nbytes, time.perf_counter() - tw)
        perm = pending.get("perm")
        if perm is not None:
            # laned schedule: reorder rows back to eval-major order so
            # the spans below slice each eval's contiguous rounds
            buf_np = buf_np[perm]
        fill_k = pending.get("fill_k")

        def _full_fills():
            full = self._fetch(pending["fills_full"])
            return full[perm] if perm is not None else full

        buf_np, slot_eff = _resolve_compact_fills(
            buf_np, _full_fills, fill_k or 0)
        rs_eff = slot_eff or rs

        dc_counts = self._dc_counts(t)
        elapsed = ((pending["prep_ns"] + time.perf_counter_ns() - t1)
                   // max(sum(counts), 1))
        decisions: List[Optional[BulkDecisions]] = []
        for gi, it in enumerate(items):
            lo, hi = spans[gi]
            if hi == lo:
                decisions.append(BulkDecisions(
                    tg_name=it.tg.name, picks=np.empty(0, np.int32),
                    node_ids=t.node_ids, round_size=rs, metrics=[],
                    nodes_evaluated=n))
                continue
            picks, _, meta = _unpack_bulk_compact(
                buf_np[lo:hi], rs, counts[gi],
                slot_k=rs_eff if rs_eff != rs else 0)
            if pending["npad"] != n:
                meta = meta.copy()
                meta[:, 7] -= pending["npad"] - n
            metrics = self._metrics_from_meta(
                meta, n, int(ctxs[gi].pool_mask.sum()), dc_counts,
                t.node_ids, int(elapsed))
            decisions.append(BulkDecisions(
                tg_name=it.tg.name, picks=picks, node_ids=t.node_ids,
                round_size=rs, metrics=metrics, nodes_evaluated=n))
        return decisions
