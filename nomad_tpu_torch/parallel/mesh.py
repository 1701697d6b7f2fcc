"""Node-sharded placement on one card (reference: nomad_tpu/parallel/mesh.py).

The node axis is split over S shards.  Shard s owns the contiguous rows
[s * n_loc, (s + 1) * n_loc) of every node tensor (`used`, `attrs`,
`cap`, `elig`, the masks), padded to npad = S * n_loc rows that are
ineligible.  Per step or round each shard scores its rows, picks its
local winners, and the winners meet in a global top-k; the owning shard
commits, and counts and metrics are sums over the shards.

The reference runs the shards as devices of a `jax.sharding.Mesh` under
`shard_map`.  The port runs them on ONE card: `Mesh` holds the shard
count and one `torch.device`.  The plain versions below carry the shard
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

A mesh across several cards waits for a later slice and raises.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch

from nomad_tpu_torch.ops import kernels as K
from nomad_tpu_torch.ops import select as S
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
# thread-block cluster holds at most 8 blocks portably
MAX_SHARDS = 8


class Mesh:
    """S shards of the node axis on one device."""

    def __init__(self, n_shards: int, device) -> None:
        if not 1 <= int(n_shards) <= MAX_SHARDS:
            raise ValueError(f"a mesh has 1..{MAX_SHARDS} shards, "
                             f"got {n_shards}")
        self.n_shards = int(n_shards)
        self.device = torch.device(device)
        # read on every wrapper call (a torch.device builds its type
        # string anew at each read)
        self.on_cpu = self.device.type == "cpu"

    def __repr__(self) -> str:
        return f"Mesh({self.n_shards} x {AXIS!r} on {self.device})"


def make_mesh(n_shards: int = MAX_SHARDS, device=None) -> Mesh:
    """An `n_shards` mesh on `device` (CUDA unless given).  A sequence of
    more than one device, a mesh across cards, raises."""
    if isinstance(device, (list, tuple)):
        devs = {torch.device(d) for d in device}
        if len(devs) != 1:
            raise NotImplementedError(
                "a mesh across several cards is not supported yet: "
                "shards run on one device")
        device = devs.pop()
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh defaults to CUDA and no CUDA "
                               "device is available; pass device='cpu'")
        device = "cuda"
    return Mesh(n_shards, device)


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
    if mesh.on_cpu:
        if t.is_cpu:
            return True
    elif t.is_cuda and (mesh.device.index is None
                        or t.get_device() == mesh.device.index):
        return False
    raise ValueError(f"tensors on {t.device}, mesh on {mesh.device}")


def place_sharded_packed(inp: PlacementInputs, mesh: Mesh):
    """K9 (reference: mesh.place_sharded_packed_fn): (buf [P, 14],
    used [npad, 3], job_count [npad]).  `inp` is not modified."""
    if _on_mesh(mesh, inp.attrs):
        return S.pack_outputs(place_sharded_plain(inp, mesh.n_shards))
    return S._scan_launch(inp, n_shards=mesh.n_shards)


def place_sharded(inp: PlacementInputs, mesh: Mesh) -> PlacementOutputs:
    """The sharded exact scan with per-placement outputs (reference:
    mesh.place_sharded_fn(mesh)(inp)): K9's packed buffer split by
    `select.unpack_outputs`, as `select.place` splits K5's.  `used` and
    `job_count` keep the npad rows.  `inp` is not modified."""
    if _on_mesh(mesh, inp.attrs):
        return place_sharded_plain(inp, mesh.n_shards)
    return S.unpack_outputs(*S._scan_launch(inp, n_shards=mesh.n_shards))


def place_bulk_sharded_packed(inp: BulkInputs, mesh: Mesh, round_size: int,
                              n_rounds: int):
    """K10 (reference: mesh.place_bulk_sharded_packed_fn): (buf
    [R, round_size + 16], used, job_count), full layout only."""
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
    if _on_mesh(mesh, inp.attrs):
        return place_multi_sharded_plain(inp, mesh.n_shards, round_size)
    return S._flat_launch(torch.empty_like(inp.used0), inp.used0, inp,
                          round_size, n_shards=mesh.n_shards)


def place_multi_sharded_chained(used0: torch.Tensor, inp: MultiEvalInputs,
                                mesh: Mesh, round_size: int):
    """K11 from a dead `used0` buffer, updated in place and returned (the
    reference's donated chained form)."""
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
    contiguous tensor, so K13 is one pass over the rows."""
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
