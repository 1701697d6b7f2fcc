"""Node-sharded placement (reference: nomad_tpu/parallel/mesh.py).

The node axis is split over S shards.  Shard s owns the contiguous rows
[s * n_loc, (s + 1) * n_loc) of every node tensor (`used`, `attrs`,
`cap`, `elig`, the masks), padded to npad = S * n_loc rows that are
ineligible.  Per step or round each shard scores its rows, picks its
local winners, and the winners meet in a global top-k; the owning shard
commits, and counts and metrics are sums over the shards.

The reference runs the shards as devices of a `jax.sharding.Mesh` under
`shard_map`.  The port's `Mesh` holds the shard count and its parts: a
part is a device that holds a contiguous block of the shards (part p of
D owns shards [p S/D, (p + 1) S/D)), and two parts may name the same
card.  A mesh of one part runs its S shards on that one device, as
below; a mesh of several parts keeps each part's rows on its own device
and runs one launch a part, the parts meeting through a hand-written
exchange on every step or round (parallel/xmesh.py, which the wrappers
below route such a mesh to).  The plain versions below carry the shard
axis as a leading tensor dimension (`all_gather` is a reshape over it,
`psum` a sum, `axis_index` an arange) and reuse ops/select.py's round
and step cores.  On a CUDA tensor each wrapper launches its kernel, one
thread-block cluster per exchange group (S blocks, or K3's plan for
K11's rows):

  place_sharded_packed               K9  (exact scan, csrc/place_scan.cu;
                                          `place_sharded` unpacks its
                                          buffer)
  place_bulk_sharded_packed          K10 (bulk rounds: K6's entry in K3's
                                          flat mode, csrc/compact_rounds.cu,
                                          over the npad rows in order)
  place_multi_sharded_packed         K11 (flat multi-eval rounds: K3's
                                          flat mode, csrc/compact_rounds.cu,
                                          over the npad rows in order)
  place_multi_compact_sharded        K12 (laned rounds over shard frames:
                                          K2's kernel, csrc/compact_rounds.cu,
                                          over lane_frames' layout)
  scatter_add_sharded_               K13 (usage delta replay,
                                          csrc/scatter_add.cu)

`make_mesh(8)` is 8 shards on one card; `make_mesh(8, ["cuda:0",
"cuda:1"])` 8 shards over two cards (4 a part); `make_mesh(8, ["cpu"] *
4)` 4 parts of the plain versions; `default_mesh()` one shard on every
visible card, the mesh `PlacementEngine(mesh=None)` builds when more
than one card is visible (reference: engine._default_mesh over
`make_mesh()`, which shards over every device with no condition).

A CUDA mesh of parts records where its parts meet (`Mesh.exchange`,
one private rule, `_exchange_of`): "device", the home card's global
memory, when its parts share one card or every pair of its distinct
cards has peer access; else "host", one exchange buffer a call in
mapped, portable pinned host memory, which every card reaches over
PCIe.  A host without peer access between its cards thus runs the same
mesh, slower on every wait.
"""

from __future__ import annotations

import threading
from functools import partial
from typing import Optional

import torch

from nomad_tpu_torch.ops import kernels as K
from nomad_tpu_torch.ops import select as S
from nomad_tpu_torch.parallel import xmesh as X
from nomad_tpu_torch.ops.select import (
    NEG_INF,
    TOP_K,
    BulkInputs,
    MultiEvalInputs,
    PlacementInputs,
    PlacementOutputs,
    tiebreak_noise,
)

AXIS = "nodes"
# the reference's tests and `bench.py --mesh 8` run 8 shards; one
# thread-block cluster holds at most 8 blocks portably: the shards of
# one part
MAX_SHARDS = 8
# parts of a mesh (the rounds kernels merge 8 parts' posts in one warp)
MAX_PARTS = 8
# the exchange rule's private override: True puts every CUDA mesh of
# parts made from then on in host memory (the card tests and
# chip_smoke.py run the host exchange on one card this way)
_FORCE_HOST_EXCHANGE = False


class Mesh:
    """S shards of the node axis over its parts: part p of D, on device
    `parts[p]`, holds shards [p S/D, (p + 1) S/D).  `device` is the
    first part's, the home of the packed outputs."""

    def __init__(self, n_shards: int, device, parts=None) -> None:
        parts = [torch.device(device)] if parts is None else [
            torch.device(d) for d in parts]
        n_shards = int(n_shards)
        if not 1 <= len(parts) <= MAX_PARTS or n_shards % len(parts):
            raise ValueError(f"{n_shards} shards do not split into "
                             f"{len(parts)} parts (1..{MAX_PARTS})")
        if not 1 <= n_shards // len(parts) <= MAX_SHARDS:
            raise ValueError(f"a mesh has 1..{MAX_SHARDS} shards a part, "
                             f"got {n_shards // len(parts)}")
        self.n_shards = n_shards
        self.parts = parts
        self.n_parts = len(parts)
        self.shards_per_part = n_shards // len(parts)
        self.device = parts[0]
        # the distinct devices, in part order
        self.cards = list(dict.fromkeys(parts))
        # read on every wrapper call (a torch.device builds its type
        # string anew at each read)
        self.on_cpu = self.device.type == "cpu"
        # across parts (parallel/xmesh.py): the wait deadline in clock64()
        # cycles, each part's stream for its exchanging launches, the
        # lock one caller's exchanging launches hold, each thread's
        # launches whose error word is unchecked, peer access enabled
        self.deadline = X.DEADLINE_CYCLES
        self._streams: dict = {}
        self._lock = threading.RLock()
        self._local = threading.local()
        self._peers_on = False
        # where the parts meet ("device" or "host", _exchange_of), the
        # host buffers of a "host" mesh and K13's staging ring
        # (parallel/xmesh.py)
        self.exchange = "device"
        self._host_bufs: list = []
        self._k13_ring = None
        self._k13_used = None

    def stream(self, p: int):
        """Part p's stream on its card, made once and used only for the
        part's exchanging launches (parallel/xmesh.py `_run_parts`, under
        the mesh's lock): no two parts share a stream, and no caller's
        work on a card's current stream (a copy between cards orders
        both cards' current streams) can queue between one call's parts."""
        s = self._streams.get(p)
        if s is None:
            s = self._streams[p] = torch.cuda.Stream(device=self.parts[p])
        return s

    def __repr__(self) -> str:
        if self.n_parts == 1:
            return f"Mesh({self.n_shards} x {AXIS!r} on {self.device})"
        return (f"Mesh({self.n_shards} x {AXIS!r} over "
                f"{[str(d) for d in self.parts]})")


def _exchange_of(idx) -> str:
    """Where the parts of a CUDA mesh on the cards `idx` meet: "device"
    (the home card's global memory) when they share one card or every
    pair of distinct cards has peer access, else "host" (mapped, portable
    pinned host memory)."""
    if _FORCE_HOST_EXCHANGE:
        return "host"
    peers = all(a == b or torch.cuda.can_device_access_peer(a, b)
                for a in idx for b in idx)
    return "device" if peers else "host"


def _cuda_parts(devs) -> list:
    """CUDA parts with their indices (an index-less one is the current
    card), checked: CUDA available, each index a visible card."""
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh needs CUDA and no CUDA device is "
                           "available; pass CPU devices")
    cur = torch.cuda.current_device()
    out = [torch.device("cuda", cur if d.index is None else d.index)
           for d in devs]
    count = torch.cuda.device_count()
    idx = sorted({d.index for d in out})
    for i in idx:
        if i >= count:
            raise ValueError(f"cuda:{i} is not visible ({count} cards)")
    return out


def make_mesh(n_shards: int = MAX_SHARDS, device=None) -> Mesh:
    """An `n_shards` mesh on `device` (CUDA unless given), or, for a
    sequence of devices (repeats allowed), a mesh of that many parts,
    part p on device[p] holding shards [p S/D, (p + 1) S/D); `n_shards`
    must be a multiple of the part count.  A CUDA mesh of parts meets
    in host memory where a pair of its distinct cards lacks peer access
    (`Mesh.exchange`)."""
    if isinstance(device, (list, tuple)):
        devs = [torch.device(d) for d in device]
        if len(devs) == 1:
            device = devs[0]
        else:
            types = {d.type for d in devs}
            if len(types) != 1:
                raise ValueError(f"the parts of a mesh lie on one kind of "
                                 f"device, got {sorted(types)}")
            if types != {"cuda"}:
                return Mesh(n_shards, devs[0], devs)
            devs = _cuda_parts(devs)
            mesh = Mesh(n_shards, devs[0], devs)
            mesh.exchange = _exchange_of(sorted({d.index for d in devs}))
            return mesh
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh defaults to CUDA and no CUDA "
                               "device is available; pass device='cpu'")
        device = "cuda"
    return Mesh(n_shards, device)


def default_mesh(home=None) -> Mesh:
    """The automatic mesh: one shard on every visible card, one part a
    card (reference: engine._default_mesh, `make_mesh()` over every
    device), the part on `home` (the current card unless given) first.
    A host of more than MAX_PARTS cards gives the mesh its first
    MAX_PARTS cards in that order."""
    n = torch.cuda.device_count()
    if n < 1:
        raise RuntimeError("default_mesh needs CUDA and no CUDA device is "
                           "available")
    first = (torch.cuda.current_device() if home is None
             or torch.device(home).index is None
             else torch.device(home).index)
    order = ([first] + [i for i in range(n) if i != first])[:MAX_PARTS]
    return make_mesh(len(order), [f"cuda:{i}" for i in order])


def pad_nodes(n: int, ndev: int) -> int:
    """Global node count padded to a multiple of the mesh size."""
    return ((n + ndev - 1) // ndev) * ndev


def _n_loc(n: int, n_shards: int) -> int:
    if n % n_shards:
        raise ValueError(f"{n} node rows do not split into {n_shards} "
                         "shards; pad them with pad_nodes")
    return n // n_shards


# ------------------------------------------------------ plain versions

def sharded_top_k(keys: torch.Tensor, final: torch.Tensor, seed,
                  n_shards: int):
    """The sharded scan's step selection (reference: mesh._place_local):
    each shard's top min(3, n_loc) keys, rows of infeasible picks as -1,
    then the top 3 of the shard-major concatenation (lower shard, then
    lower local rank, among equal keys).  Scores are reported as the key
    less the row's tie-break noise, in f32.  `final` is not read: the
    reference recovers the score by subtraction."""
    n = keys.shape[0]
    n_loc = _n_loc(n, n_shards)
    k_loc = min(TOP_K, n_loc)
    keys2 = keys.view(n_shards, n_loc)
    loc = torch.sort(keys2, dim=1, descending=True,
                     stable=True).indices[:, :k_loc]
    loc_sc = keys2.gather(1, loc)
    offset = torch.arange(n_shards, device=keys.device)[:, None] * n_loc
    grows = torch.where(loc_sc > NEG_INF / 2, loc + offset, -1)
    all_sc = loc_sc.reshape(-1)
    all_rows = grows.reshape(-1)
    g = torch.sort(all_sc, descending=True,
                   stable=True).indices[:min(TOP_K, all_sc.shape[0])]
    top_rows, top_nsc = all_rows[g], all_sc[g]
    top_sc = torch.where(
        top_nsc > NEG_INF / 2,
        top_nsc - tiebreak_noise(seed, top_rows.clamp(min=0)), NEG_INF)
    return top_rows, top_sc


def sharded_waterfill(k_i, score, noise, want, spread_algo: bool,
                      round_size: int, n_shards: int):
    """One sharded water-fill round per lane (reference:
    mesh._sharded_waterfill) over frames of S * n_loc rows, shard-major:
    `viable` summed over the mesh; each shard's top min(round_size,
    n_loc) keys; the global top round_size of their concatenation;
    the fill prefix; commits to the winners' own rows.  Same returns as
    select.waterfill_round, with frame indices (shard * n_loc + local
    row) for rows."""
    lanes, f = k_i.shape
    n_loc = _n_loc(f, n_shards)
    dev = k_i.device
    viable = torch.clamp((k_i > 0).sum(dim=-1), min=1)
    if spread_algo:
        cap_round = torch.clamp(want.to(torch.int64) // viable + 1, min=1)
    else:
        cap_round = torch.full_like(viable, round_size)
    k_round = torch.minimum(k_i, cap_round[:, None].to(k_i.dtype))

    kk_loc = min(round_size, n_loc)
    keys = (torch.where(k_round > 0, score, NEG_INF) + noise).view(
        lanes, n_shards, n_loc)
    loc = torch.sort(keys, dim=-1, descending=True,
                     stable=True).indices[..., :kk_loc]
    all_nsc = keys.gather(-1, loc).reshape(lanes, -1)
    all_idx = (loc + torch.arange(n_shards, device=dev)[:, None]
               * n_loc).reshape(lanes, -1)
    kk_glob = min(round_size, all_nsc.shape[1])
    g = torch.sort(all_nsc, dim=-1, descending=True,
                   stable=True).indices[:, :kk_glob]
    g_nsc = all_nsc.gather(-1, g)
    rows_k = all_idx.gather(-1, g)
    sc_k = torch.where(g_nsc > NEG_INF / 2, score.gather(-1, rows_k),
                       NEG_INF)
    k_sorted = torch.where(sc_k > NEG_INF / 2, k_round.gather(-1, rows_k),
                           0)
    csum = torch.cumsum(k_sorted, dim=-1, dtype=torch.int32)
    c_sorted = torch.minimum(
        torch.clamp(want[:, None] - (csum - k_sorted), min=0),
        k_sorted).to(torch.int32)
    placed_total = c_sorted.sum(dim=-1, dtype=torch.int32)
    # each winner's owner shard commits it (its rows are its own)
    c_i = torch.zeros_like(k_i, dtype=torch.int32).scatter_add_(
        -1, rows_k, c_sorted)

    pad = round_size - kk_glob
    if pad:
        rows_k = torch.cat([rows_k, rows_k.new_zeros((lanes, pad))], dim=-1)
        c_sorted = torch.cat([c_sorted, c_sorted.new_zeros((lanes, pad))],
                             dim=-1)
        sc_k = torch.cat([sc_k, sc_k.new_full((lanes, pad), NEG_INF)],
                         dim=-1)
    return rows_k, c_sorted, sc_k, c_i, placed_total, k_round


def place_sharded_plain(inp: PlacementInputs,
                        n_shards: int) -> PlacementOutputs:
    """Plain version of K9: select.place_plain with the sharded step
    selection.  The owner shard's psum-broadcast of the pick's spread
    and distinct_property values equals reading the pick's column."""
    return S.place_plain(inp,
                         select=partial(sharded_top_k, n_shards=n_shards))


def place_bulk_sharded_plain(inp: BulkInputs, n_shards: int,
                             round_size: int, n_rounds: int):
    """Plain version of K10: the bulk rounds with the sharded fill, full
    layout.  Returns (buf [R, round_size + 16], used, job_count)."""
    _n_loc(inp.attrs.shape[0], n_shards)
    return S.place_bulk_packed_plain(
        inp, round_size, n_rounds,
        fill=partial(sharded_waterfill, n_shards=n_shards))


def place_multi_sharded_plain(inp: MultiEvalInputs, n_shards: int,
                              round_size: int):
    """Plain version of K11: the flat rounds with the sharded fill.
    Returns (buf [R, round_size + 16], used, last job count row)."""
    _n_loc(inp.attrs.shape[0], n_shards)
    return S.place_multi_packed_plain(
        inp, round_size, fill=partial(sharded_waterfill, n_shards=n_shards))


def lane_frames(cand_rows, cand_valid, job_count0):
    """Per-shard frames [S, L, Nc_loc] and seeds [S, J', Nc_loc] as lane
    frames [L, S * Nc_loc] and seeds [J', S * Nc_loc], shard-major."""
    s, lanes, nc = cand_rows.shape

    def flat(x):
        return x.permute(1, 0, 2).reshape(x.shape[1], s * nc)

    return flat(cand_rows), flat(cand_valid), flat(job_count0)


def place_multi_compact_sharded_plain(inp: MultiEvalInputs, cand_rows,
                                      cand_valid, n_shards: int,
                                      round_size: int, n_lanes: int):
    """Plain version of K12: the laned rounds over each lane's shard
    frames laid end to end, with the sharded fill in frame-commit mode
    (a winner's origin shard commits it to its slot) and the `set`
    write-back of every valid slot.  `cand_rows` [S, L, Nc_loc] holds
    global rows (padding = npad); `inp.job_count0` is [S, J', Nc_loc].
    Returns (buf_small [T*L, FILL_K + 16], fills [T*L, round_size],
    used [npad, 3])."""
    _check_frames(inp, cand_rows, cand_valid, n_shards, n_lanes)
    cr, cv, jc0 = lane_frames(cand_rows, cand_valid, inp.job_count0)
    return S.place_multi_compact_packed_plain(
        inp._replace(job_count0=jc0), cr, cv, round_size, n_lanes,
        fill=partial(sharded_waterfill, n_shards=n_shards))


def _check_frames(inp, cand_rows, cand_valid, n_shards, n_lanes) -> None:
    _n_loc(inp.attrs.shape[0], n_shards)
    if (cand_rows.dim() != 3 or cand_rows.shape != cand_valid.shape
            or cand_rows.shape[:2] != (n_shards, n_lanes)
            or inp.job_count0.dim() != 3
            or inp.job_count0.shape[0] != n_shards
            or inp.job_count0.shape[2] != cand_rows.shape[2]):
        raise ValueError("sharded frames must be [S, L, Nc_loc] with "
                         "seeds [S, J', Nc_loc]")


def scatter_add_sharded_plain(used: torch.Tensor, rows: torch.Tensor,
                              vals: torch.Tensor,
                              n_shards: int) -> torch.Tensor:
    """Plain version of K13: each shard adds the deltas of the rows it
    owns, used[rows] += vals in place.  Rows index the padded global
    table [npad, 3] as in the reference: a row in [-npad, 0) adds to
    row r + npad, a row below -npad or at npad and above is dropped."""
    npad = used.shape[0]
    n_loc = _n_loc(npad, n_shards)
    r = K.wrap_rows(rows, npad)
    for s in range(n_shards):
        keep = (r >= s * n_loc) & (r < (s + 1) * n_loc)
        used.index_put_((r[keep],), vals[keep].to(used.dtype),
                        accumulate=True)
    return used


# ------------------------------------------------------------ wrappers

def _on_mesh(mesh: Mesh, t: torch.Tensor) -> bool:
    """True for a CPU mesh (plain version); raises when the tensors lie
    on another device than the mesh."""
    if isinstance(t, X.Parts):
        t = t.blocks[0]
    if mesh.on_cpu:
        if t.is_cpu:
            return True
    elif t.is_cuda and (mesh.device.index is None or mesh.n_parts > 1
                        or t.get_device() == mesh.device.index):
        return False
    raise ValueError(f"tensors on {t.device}, mesh on {mesh.device}")


def place_sharded_packed(inp: PlacementInputs, mesh: Mesh):
    """K9 (reference: mesh.place_sharded_packed_fn): (buf [P, 14],
    used [npad, 3], job_count [npad]; `Parts` on a mesh of parts).  `inp`
    is not modified."""
    if mesh.n_parts > 1:
        if _on_mesh(mesh, inp.attrs):
            return S.pack_outputs(X.place_xmesh_plain(inp, mesh))
        return X.place_xmesh_packed(inp, mesh)
    if _on_mesh(mesh, inp.attrs):
        return S.pack_outputs(place_sharded_plain(inp, mesh.n_shards))
    return S._scan_launch(inp, n_shards=mesh.n_shards)


def place_sharded(inp: PlacementInputs, mesh: Mesh) -> PlacementOutputs:
    """The sharded exact scan with per-placement outputs (reference:
    mesh.place_sharded_fn(mesh)(inp)): K9's packed buffer split by
    `select.unpack_outputs`, as `select.place` splits K5's.  `used` and
    `job_count` keep the npad rows.  `inp` is not modified."""
    if mesh.n_parts > 1:
        if _on_mesh(mesh, inp.attrs):
            return X.place_xmesh_plain(inp, mesh)
        return S.unpack_outputs(*X.place_xmesh_packed(inp, mesh))
    if _on_mesh(mesh, inp.attrs):
        return place_sharded_plain(inp, mesh.n_shards)
    return S.unpack_outputs(*S._scan_launch(inp, n_shards=mesh.n_shards))


def place_bulk_sharded_packed(inp: BulkInputs, mesh: Mesh, round_size: int,
                              n_rounds: int):
    """K10 (reference: mesh.place_bulk_sharded_packed_fn): (buf
    [R, round_size + 16], used, job_count), full layout only."""
    if mesh.n_parts > 1:
        if _on_mesh(mesh, inp.attrs):
            return X.place_bulk_xmesh_plain(inp, mesh, round_size, n_rounds)
        return X.place_bulk_xmesh_packed(inp, mesh, round_size, n_rounds)
    if _on_mesh(mesh, inp.attrs):
        return place_bulk_sharded_plain(inp, mesh.n_shards, round_size,
                                        n_rounds)
    return S._bulk_launch(inp, round_size, n_rounds, False, 0,
                          n_shards=mesh.n_shards)


def place_multi_sharded_packed(inp: MultiEvalInputs, mesh: Mesh,
                               round_size: int):
    """K11 (reference: mesh.place_multi_sharded_packed_fn): (buf
    [R, round_size + 16], used, last job count row).  `inp.used0` is not
    modified.  Shard s owns rows [s n_loc, (s + 1) n_loc), so the
    shard-major union of the shards' top lists is the top over all npad
    rows in row order, and the card runs K3's flat mode over those rows
    (tests/test_torch_mesh.py::test_k11_is_k3_on_padded_rows)."""
    if mesh.n_parts > 1:
        if _on_mesh(mesh, inp.attrs):
            return X.place_multi_xmesh_plain(inp, mesh, round_size)
        used = X.Parts([torch.empty_like(b) for b in
                        X.split(inp.used0, mesh).blocks])
        return X.place_multi_xmesh_launch(used, inp.used0, inp, mesh,
                                          round_size)
    if _on_mesh(mesh, inp.attrs):
        return place_multi_sharded_plain(inp, mesh.n_shards, round_size)
    return S._flat_launch(torch.empty_like(inp.used0), inp.used0, inp,
                          round_size, n_shards=mesh.n_shards)


def place_multi_sharded_chained(used0: torch.Tensor, inp: MultiEvalInputs,
                                mesh: Mesh, round_size: int):
    """K11 from a dead `used0` buffer, updated in place and returned (the
    reference's donated chained form)."""
    if mesh.n_parts > 1:
        used0 = X.split(used0, mesh)
        if _on_mesh(mesh, used0):
            buf, used, jc = X.place_multi_xmesh_plain(
                inp._replace(used0=used0), mesh, round_size)
            return buf, used0.copy_(used), jc
        return X.place_multi_xmesh_launch(used0, used0, inp, mesh,
                                          round_size)
    if _on_mesh(mesh, used0):
        buf, used, jc = place_multi_sharded_plain(
            inp._replace(used0=used0), mesh.n_shards, round_size)
        used0.copy_(used)
        return buf, used0, jc
    return S._flat_launch(used0, used0, inp, round_size,
                          n_shards=mesh.n_shards)


def place_multi_compact_sharded(inp: MultiEvalInputs, cand_rows, cand_valid,
                                mesh: Mesh, round_size: int, n_lanes: int):
    """K12 (reference: mesh.place_multi_compact_sharded_fn): (buf_small
    [T*L, FILL_K + 16], fills [T*L, round_size], used [npad, 3]) over
    per-shard frames [S, L, Nc_loc].  `inp.used0` is not modified."""
    if mesh.n_parts > 1:
        if _on_mesh(mesh, inp.attrs):
            return X.place_multi_compact_xmesh_plain(
                inp, cand_rows, cand_valid, mesh, round_size, n_lanes)
        used_in = X.split(inp.used0, mesh)
        K.count_eager("compact_used0_clone")
        return X.place_multi_compact_xmesh_launch(
            used_in.clone(), used_in, inp, cand_rows, cand_valid, mesh,
            round_size, n_lanes)
    if _on_mesh(mesh, inp.attrs):
        return place_multi_compact_sharded_plain(
            inp, cand_rows, cand_valid, mesh.n_shards, round_size, n_lanes)
    K.count_eager("compact_used0_clone")
    return S._compact_launch(inp.used0.clone(), inp.used0, inp, cand_rows,
                             cand_valid, round_size, n_lanes,
                             n_shards=mesh.n_shards)


def place_multi_compact_sharded_chained(used0: torch.Tensor,
                                        inp: MultiEvalInputs, cand_rows,
                                        cand_valid, mesh: Mesh,
                                        round_size: int, n_lanes: int):
    """K12 from a dead `used0` buffer, updated in place and returned."""
    if mesh.n_parts > 1:
        used0 = X.split(used0, mesh)
        if _on_mesh(mesh, used0):
            buf, fills, used = X.place_multi_compact_xmesh_plain(
                inp._replace(used0=used0), cand_rows, cand_valid, mesh,
                round_size, n_lanes)
            return buf, fills, used0.copy_(used)
        return X.place_multi_compact_xmesh_launch(
            used0, used0, inp, cand_rows, cand_valid, mesh, round_size,
            n_lanes)
    if _on_mesh(mesh, used0):
        buf, fills, used = place_multi_compact_sharded_plain(
            inp._replace(used0=used0), cand_rows, cand_valid,
            mesh.n_shards, round_size, n_lanes)
        used0.copy_(used)
        return buf, fills, used0
    return S._compact_launch(used0, used0, inp, cand_rows, cand_valid,
                             round_size, n_lanes, n_shards=mesh.n_shards)


def scatter_add_sharded_(used: torch.Tensor, rows: torch.Tensor,
                         vals: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """K13 (reference: engine._sharded_fn(mesh, "scatter")):
    used[rows] += vals in place on the sharded usage [npad, 3], rows as
    in scatter_add_sharded_plain.  On the card the shards are one
    contiguous tensor, so K13 is one pass over the rows.  On a mesh of
    parts `used` is a `Parts` (each part's rows on its device) and each
    part keeps the rows it owns."""
    if mesh.n_parts > 1:
        if mesh.on_cpu and _on_mesh(mesh, used):
            return X.scatter_add_xmesh_plain(used, rows, vals, mesh)
        # a CUDA mesh: scatter_add_xmesh_ checks every block's device
        return X.scatter_add_xmesh_(used, rows, vals, mesh)
    if used.is_cpu and mesh.on_cpu:
        return scatter_add_sharded_plain(used, rows, vals, mesh.n_shards)
    # _on_mesh's test, on the device index the checks return
    d, npad, m = K.check_scatter("scatter_add_sharded", used, rows, vals)
    idx = mesh.device.index
    if mesh.on_cpu or (idx is not None and idx != d):
        raise ValueError(f"tensors on {used.device}, mesh on {mesh.device}")
    s = mesh.n_shards
    if npad % s:
        _n_loc(npad, s)                  # raises
    if m:
        K.SCATTER_ADD_SHARDED.launch(
            d, "scatter_add_sharded", used.data_ptr(), npad,
            rows.data_ptr(), vals.data_ptr(), m, s)
    return used
