"""The node-sharded mesh across parts (reference: nomad_tpu/parallel/mesh.py
on a `jax.sharding.Mesh` of several devices).

A part is a device that holds a contiguous block of the mesh's shards:
part p of D owns the shards [p S/D, (p + 1) S/D) and so the node rows
[p npad/D, (p + 1) npad/D), and keeps only those rows of every node
tensor, on its own device (`Parts`).  Two parts may name the same
card.  The shard order stays shard-major, so a D-part mesh of S shards
decides exactly what the one-card S-shard mesh decides, and so what the
reference's S-device mesh decides.

Per step or round each part runs its local step on its own rows, posts
its candidates and partial sums, and every part reads the D posts in
part order and decides alike: the reference's `all_gather` and `psum`.
Only the part that owns a winner commits it.

  * The plain versions below (`*_plain`, the CPU) run every part's local
    step on that part's tensors, then merge through an explicit
    exchange of the parts' posts, reusing ops/select.py's step and
    round cores.
  * On the card every entry is one launch a part, each on its own
    stream (`Mesh.stream`), all launched before anything waits, the
    parts meeting on every step or round through an exchange buffer on
    the home part's card, or in host memory where the cards lack peer
    access (`Mesh.exchange`, csrc/xmesh.cuh): K9 `place_scan_xmesh`, K10
    `multi_bulk_xmesh`, K11 `multi_flat_xmesh`, K12
    `multi_compact_xmesh`, K13 `scatter_add_xmesh` (no exchange: each
    part keeps the rows it owns).  Between cards a device buffer is
    reached through peer access and a host buffer over PCIe (the same
    protocol, at system scope); a wait that runs out its deadline sets the
    buffer's error word, and `check` raises after the fetch.  A CUDA
    part never runs a plain version.

The wrappers in parallel/mesh.py route a mesh of more than one part
here; they take node tensors as `Parts` or as whole tensors (split here)
and return the usage and job counts as `Parts`.
"""

from __future__ import annotations

import ctypes
import time
import weakref
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from nomad_tpu_torch.ops import kernels as K
from nomad_tpu_torch.ops import select as S
from nomad_tpu_torch.ops.feasibility import and_rows, landscape_mask_plain
from nomad_tpu_torch.ops.scoring import affinity_landscape_plain
from nomad_tpu_torch.ops.select import (
    NEG_INF,
    TOP_K,
    BulkInputs,
    MultiEvalInputs,
    PlacementInputs,
    PlacementOutputs,
    round_metrics_g,
    round_scores_g,
    round_seeds,
    tiebreak_noise,
)

# clock64() cycles a part's wait for another part may take (about 9 s at
# the H100's 1.98 GHz): a stalled part is a loud failure, not a hang
DEADLINE_CYCLES = 1 << 34


class Parts:
    """A node-axis tensor as one block of rows per part of a mesh (block
    p on part p's device), split along `axis`."""

    __slots__ = ("blocks", "axis")

    def __init__(self, blocks: Sequence[torch.Tensor], axis: int = 0):
        self.blocks = list(blocks)
        self.axis = axis

    @property
    def shape(self) -> torch.Size:
        s = list(self.blocks[0].shape)
        s[self.axis] = sum(b.shape[self.axis] for b in self.blocks)
        return torch.Size(s)

    @property
    def dtype(self):
        return self.blocks[0].dtype

    @property
    def device(self) -> torch.device:
        """The home part's device."""
        return self.blocks[0].device

    @property
    def is_cpu(self) -> bool:
        return self.blocks[0].is_cpu

    @property
    def nbytes(self) -> int:
        return sum(b.nbytes for b in self.blocks)

    def dim(self) -> int:
        return self.blocks[0].dim()

    def gather(self) -> torch.Tensor:
        """The whole tensor on the home part's device."""
        home = self.blocks[0].device
        return torch.cat([b.to(home) for b in self.blocks], dim=self.axis)

    def cpu(self) -> torch.Tensor:
        return torch.cat([b.cpu() for b in self.blocks], dim=self.axis)

    def numpy(self):
        return self.cpu().numpy()

    def clone(self) -> "Parts":
        return Parts([b.clone() for b in self.blocks], self.axis)

    def copy_(self, other: "Parts") -> "Parts":
        for b, o in zip(self.blocks, other.blocks):
            b.copy_(o)
        return self

    def __repr__(self) -> str:
        return (f"Parts({len(self.blocks)} x {list(self.blocks[0].shape)} "
                f"along {self.axis}, {self.dtype})")


def block(x, mesh, p: int, axis: int = 0) -> torch.Tensor:
    """Part p's rows of `x` (a `Parts`, or a whole tensor split here) on
    part p's device."""
    if isinstance(x, Parts):
        if len(x.blocks) != mesh.n_parts:
            raise ValueError(f"{len(x.blocks)} blocks for a mesh of "
                             f"{mesh.n_parts} parts")
        return x.blocks[p]
    n = x.shape[axis]
    if n % mesh.n_parts:
        raise ValueError(f"{n} rows do not split into {mesh.n_parts} parts")
    m = n // mesh.n_parts
    return x.narrow(axis, p * m, m).to(mesh.parts[p]).contiguous()


def split(x, mesh, axis: int = 0) -> Parts:
    """`x` as a `Parts` of the mesh (itself when it is one)."""
    if isinstance(x, Parts):
        return x
    return Parts([block(x, mesh, p, axis) for p in range(mesh.n_parts)],
                 axis)


def host_by_part(fn, probe, axis: int = 1):
    """The host array `fn(at)` computes from node tensors, `at(x)` the
    tensor to use for `x`.  On a mesh of parts (`probe` a `Parts`) `fn`
    runs once a part over its own rows, `at` giving the part's block of
    a `Parts` and any other tensor on the part's device, and the results
    are joined along the node axis `axis` in part order; else `fn` runs
    once and `at` is the identity.  (K1's and K8's host masks: a node-row
    function needs no exchange.)"""
    if not isinstance(probe, Parts):
        return fn(lambda x: x)
    outs = []
    for p, blk in enumerate(probe.blocks):
        def at(x, p=p, dev=blk.device):
            return x.blocks[p] if isinstance(x, Parts) else _rep(x, dev)
        outs.append(fn(at))
    return np.concatenate(outs, axis=axis)


def _rep(x, dev):
    """A replicated input on part `dev` (a copy on another device)."""
    if isinstance(x, torch.Tensor) and x.device != dev:
        return x.to(dev)
    return x


# the node-axis fields of each input type and their axis
_NODE_AXES = {
    PlacementInputs: dict(attrs=0, cap=0, used0=0, elig=0, dc_mask=0,
                          pool_mask=0, job_count0=0, sp_nodeval=1,
                          pd_nodeval=1, extra_mask=1),
    BulkInputs: dict(attrs=0, cap=0, used0=0, elig=0, dc_mask=0,
                     pool_mask=0, job_count0=0, extra_mask=1),
    MultiEvalInputs: dict(attrs=0, cap=0, used0=0, elig=0, node_ok=0,
                          base_mask=1, job_count0=1),
}


def part_inputs(inp, mesh, p: int, axes: Optional[dict] = None):
    """Part p's inputs: its rows of every node-axis field, the other
    tensors on its device."""
    axes = _NODE_AXES[type(inp)] if axes is None else axes
    dev = mesh.parts[p]
    out = {}
    for f, v in zip(inp._fields, inp):
        if v is None or not isinstance(v, (torch.Tensor, Parts)):
            out[f] = v
        elif f in axes:
            out[f] = block(v, mesh, p, axes[f])
        else:
            out[f] = _rep(v, dev)
    return type(inp)(**out)


def _n_rows(mesh, n: int) -> int:
    """Rows a part holds of an npad-row node axis."""
    if n % mesh.n_shards:
        raise ValueError(f"{n} node rows do not split into {mesh.n_shards} "
                         "shards; pad them with pad_nodes")
    return n // mesh.n_parts


# ------------------------------------------------------ plain versions

def _local_top(keys: torch.Tensor, k: int):
    """A part's candidates: the top k of its keys in slot order (value
    descending, lower slot first among ties): the shard-major union of
    its shards' top lists, merged.  keys [L, F] -> indices [L, k]."""
    return torch.sort(keys, dim=-1, descending=True,
                      stable=True).indices[..., :k]


def place_xmesh_plain(inp: PlacementInputs, mesh) -> PlacementOutputs:
    """Plain version of K9 across parts: each part scores its rows with
    select.step_scores, posts its top min(3, rows) keys (rows of
    infeasible keys -1), their spread and distinct values and its
    counts; every part merges the D posts in part order (the stable top
    3 of their concatenation: lower part, then lower rank, among equal
    keys), reports key - noise(row) as the reference does, and adds the
    pick's values to its spread and distinct counts; the owner commits
    the pick's usage and job count.  `used` and `job_count` are
    `Parts`."""
    n = inp.attrs.shape[0]
    n_p = _n_rows(mesh, n)
    D = mesh.n_parts
    parts = [part_inputs(inp, mesh, p) for p in range(D)]
    seed = S._seed_t(inp.seed, parts[0].attrs.device)
    st = [S.scan_statics(q, torch.arange(p * n_p, (p + 1) * n_p,
                                         device=q.attrs.device))
          for p, q in enumerate(parts)]
    used = [q.used0.clone() for q in parts]
    jc = [q.job_count0.clone() for q in parts]
    spc = [q.sp_counts0.clone() for q in parts]
    pdc = [q.pd_counts0.clone() for q in parts]
    k_part = min(TOP_K, n_p)
    k = min(TOP_K, D * k_part)
    dev0 = parts[0].attrs.device
    cols = []
    for g, prev, act in zip(inp.tg_idx.tolist(), inp.prev_row.tolist(),
                            inp.active.tolist()):
        posts = []
        for p, q in enumerate(parts):
            feas, final, stat_g, fit, dh_ok = S.step_scores(
                q, st[p], (used[p], jc[p], spc[p], pdc[p]), g, prev)
            keys = torch.where(feas, final, NEG_INF) + st[p].noise
            loc = _local_top(keys, k_part)
            nsc = keys[loc]
            rows = torch.where(nsc > NEG_INF / 2, loc + p * n_p, -1)
            req_g = q.req[g]
            over = used[p] + req_g[None, :] > q.cap
            sums = torch.stack([
                feas.sum(), (~stat_g).sum(),
                (stat_g & (~fit | ~dh_ok)).sum(),
                *((stat_g & ~fit)[:, None] & over).sum(dim=0)])
            posts.append((nsc.cpu(), rows.cpu(), q.sp_nodeval[:, loc].cpu(),
                          q.pd_nodeval[:, loc].cpu(), sums.cpu()))
        # the exchange: the D posts in part order
        all_nsc = torch.cat([x[0] for x in posts])
        all_rows = torch.cat([x[1] for x in posts])
        gi = torch.sort(all_nsc, descending=True, stable=True).indices[:k]
        top_rows, top_nsc = all_rows[gi], all_nsc[gi]
        top_sc = torch.where(
            top_nsc > NEG_INF / 2,
            top_nsc - tiebreak_noise(seed.cpu(), top_rows.clamp(min=0)),
            NEG_INF)
        sums = torch.stack([x[4] for x in posts]).sum(dim=0)
        ok = bool(act) and float(top_sc[0]) > NEG_INF / 2
        pick = int(top_rows[0]) if ok else -1
        cols.append((
            torch.tensor([pick], dtype=torch.int32),
            top_sc[:1] if ok else torch.zeros(1),
            (top_rows if ok else torch.full_like(top_rows, -1))[None],
            (top_sc if ok else torch.zeros_like(top_sc))[None],
            sums[None, 0], sums[None, 1], sums[None, 2], sums[None, 3:]))
        if not ok:
            continue
        src, idx = divmod(int(gi[0]), k_part)
        sval, pval = posts[src][2][:, idx], posts[src][3][:, idx]
        owner = pick // n_p
        used[owner][pick - owner * n_p] += parts[owner].req[g]
        jc[owner][pick - owner * n_p] += 1
        for p, q in enumerate(parts):
            s_idx = torch.arange(spc[p].shape[0])
            hit = sval >= 0
            spc[p].index_put_(
                (s_idx[hit].to(spc[p].device),
                 sval[hit].long().clamp(0, spc[p].shape[1] - 1)
                 .to(spc[p].device)),
                torch.ones((), device=spc[p].device), accumulate=True)
            d_idx = torch.arange(pdc[p].shape[0])
            hit = (pval >= 0) & q.pd_apply[g].cpu()
            pdc[p].index_put_(
                (d_idx[hit].to(pdc[p].device),
                 pval[hit].long().clamp(0, pdc[p].shape[1] - 1)
                 .to(pdc[p].device)),
                torch.ones((), dtype=pdc[p].dtype, device=pdc[p].device),
                accumulate=True)
    out = [torch.cat(c, dim=0).to(dev0) for c in zip(*cols)]
    i32 = [o.to(torch.int32) for o in out[4:]]
    return PlacementOutputs(
        picks=out[0], scores=out[1].to(torch.float32),
        topk_rows=out[2].to(torch.int32),
        topk_scores=out[3].to(torch.float32), n_feasible=i32[0],
        n_filtered=i32[1], n_exhausted=i32[2], dim_exhausted=i32[3],
        used=Parts(used), job_count=Parts(jc))


class _Post(NamedTuple):
    """A part's round post: per lane its top keys (nsc), their scores,
    intakes (uncapped), output rows and slots in the part's frame, and
    its counts of viable and of statically filtered rows."""
    nsc: torch.Tensor
    score: torch.Tensor
    k: torch.Tensor
    rows: torch.Tensor
    slot: torch.Tensor
    viable: torch.Tensor
    filt: torch.Tensor


def _round_post(k_i, score, noise, rows, static, round_size: int) -> _Post:
    """A part's post for one round per lane (reference:
    mesh._sharded_waterfill's local half): its top min(round_size, F)
    keys by where(k > 0, score, NEG_INF) + noise, in slot order among
    ties.  The order needs no intake cap: k_round > 0 exactly where
    k > 0, so the cap waits for the summed viable counts."""
    keys = torch.where(k_i > 0, score, NEG_INF) + noise
    loc = _local_top(keys, min(round_size, k_i.shape[-1]))
    return _Post(keys.gather(-1, loc), score.gather(-1, loc),
                 k_i.gather(-1, loc), rows.gather(-1, loc), loc,
                 (k_i > 0).sum(dim=-1), (~static).sum(dim=-1))


def xmesh_waterfill(posts: List[_Post], want, spread_algo: bool,
                    round_size: int, frames: Sequence[int]):
    """The decision of one round per lane from the D posts, in part
    order (reference: mesh._sharded_waterfill's global half): the summed
    viable count sets the spread intake cap, the stable top round_size
    of the posts' concatenation is water-filled up to `want`, and each
    winner's part commits it at its slot.  `frames` are the parts' frame
    sizes.  Returns (rows_p, cnt_p, sc_p [L, round_size], c_i per part
    [L, F_p], placed [L], n_feasible [L], n_filtered [L])."""
    lanes = posts[0].nsc.shape[0]
    viable_all = sum(x.viable for x in posts)
    viable = torch.clamp(viable_all, min=1)
    if spread_algo:
        cap_round = torch.clamp(want.to(torch.int64) // viable + 1, min=1)
    else:
        cap_round = torch.full_like(viable, round_size)
    nsc = torch.cat([x.nsc for x in posts], dim=-1)
    kk = min(round_size, sum(frames))
    g = torch.sort(nsc, dim=-1, descending=True, stable=True).indices[:, :kk]
    g_nsc = nsc.gather(-1, g)
    sc_k = torch.where(g_nsc > NEG_INF / 2,
                       torch.cat([x.score for x in posts], -1).gather(-1, g),
                       NEG_INF)
    k_round = torch.minimum(torch.cat([x.k for x in posts], -1).gather(-1, g),
                            cap_round[:, None].to(torch.int32))
    k_sorted = torch.where(sc_k > NEG_INF / 2, k_round, 0)
    rows_k = torch.cat([x.rows for x in posts], -1).gather(-1, g)
    csum = torch.cumsum(k_sorted, dim=-1, dtype=torch.int32)
    c_sorted = torch.minimum(
        torch.clamp(want[:, None] - (csum - k_sorted), min=0),
        k_sorted).to(torch.int32)
    placed = c_sorted.sum(dim=-1, dtype=torch.int32)
    # each winner's part commits it at its slot
    widths = [x.nsc.shape[-1] for x in posts]
    starts = torch.tensor([0] + widths[:-1]).cumsum(0)
    src = torch.bucketize(g.contiguous(), starts[1:].to(g.device), right=True)
    slots = torch.cat([x.slot for x in posts], -1).gather(-1, g)
    c_i = []
    for p, f in enumerate(frames):
        mine = src == p
        c_i.append(torch.zeros((lanes, f), dtype=torch.int32,
                               device=g.device).scatter_add_(
            -1, torch.where(mine, slots, 0), torch.where(mine, c_sorted, 0)))
    pad = round_size - kk
    if pad:
        rows_k = torch.cat([rows_k, rows_k.new_zeros((lanes, pad))], dim=-1)
        c_sorted = torch.cat([c_sorted, c_sorted.new_zeros((lanes, pad))],
                             dim=-1)
        sc_k = torch.cat([sc_k, sc_k.new_full((lanes, pad), NEG_INF)],
                         dim=-1)
    return (rows_k, c_sorted, sc_k, c_i, placed, viable_all,
            sum(x.filt for x in posts))


def _round_outputs(rows_p, cnt_p, sc_p, top_k: int):
    top_sc = sc_p[:, :top_k]
    valid = top_sc > NEG_INF / 2
    return (torch.where(valid, rows_p[:, :top_k], -1),
            torch.where(valid, top_sc, 0.0))


def _multi_core(parts: List[MultiEvalInputs], round_size: int, n_glob: int):
    """The flat rounds across parts (K11's plain version, and K10's
    through select.bulk_as_flat): per round each part runs
    select.round_scores_g on its rows and posts (`_round_post`); the
    decision (`xmesh_waterfill`) commits on the owning parts; each part's
    post-commit exhaustion metrics (select.round_metrics_g) are summed
    in a second exchange.  Returns (buf [R, round_size + 16], used, last
    job count row), the last two `Parts`."""
    S._check_rounds(n_glob, round_size)
    top_k = min(TOP_K, n_glob)
    n_p = parts[0].attrs.shape[0]
    rg = parts[0].round_g.long().cpu()
    st = []
    for p, q in enumerate(parts):
        dev = q.attrs.device
        static_u = landscape_mask_plain(q.attrs, q.con, q.luts,
                                        and_rows(q.elig, q.node_ok),
                                        q.base_mask, q.u_mask)
        aff_u = affinity_landscape_plain(q.attrs, q.aff, q.luts)
        rows = torch.arange(p * n_p, (p + 1) * n_p, device=dev)[None, :]
        st.append((static_u, aff_u, (q.aff[..., 3] != 0).any(dim=1), rows))
    g_static = parts[0].g_static.long().cpu()
    g_aff = parts[0].g_aff.long().cpu()
    jobs_r = parts[0].g_job.long().cpu()[rg]
    same_r = torch.cat([torch.zeros(1, dtype=torch.bool),
                        jobs_r[1:] == jobs_r[:-1]])
    seed_r = round_seeds(parts[0].seed.cpu(), rg)
    want_r = parts[0].round_want.cpu()
    used = [q.used0[None].clone() for q in parts]
    cur = [q.job_count0[0][None] for q in parts]
    outs = []
    for r in range(rg.shape[0]):
        g = int(rg[r])
        posts, state = [], []
        for p, q in enumerate(parts):
            static_u, aff_u, aff_any_u, rows = st[p]
            dev = q.attrs.device
            gs = slice(g, g + 1)
            static = static_u[int(g_static[g])][None]
            a = int(g_aff[g])
            noise = tiebreak_noise(seed_r[r:r + 1, None].to(dev), rows)
            job_count = (cur[p] if bool(same_r[r])
                         else q.job_count0[int(jobs_r[r])][None])
            k_i, score = round_scores_g(
                q.cap[None], q.req[gs], q.desired[gs], q.dh_limit[gs],
                static, aff_u[a:a + 1], aff_any_u[a:a + 1], used[p],
                job_count, q.spread_algo, round_size)
            posts.append(_Post(*(x.cpu() for x in _round_post(
                k_i, score, noise, rows, static, round_size))))
            state.append((static, job_count))
        rows_p, cnt_p, sc_p, c_i, placed, n_feas, n_filt = xmesh_waterfill(
            posts, want_r[r:r + 1], parts[0].spread_algo, round_size,
            [n_p] * len(parts))
        n_exh = dim_ex = 0
        for p, q in enumerate(parts):
            static, job_count = state[p]
            c = c_i[p].to(q.attrs.device)
            used[p] = used[p] + c[..., None] * q.req[g:g + 1][:, None, :]
            cur[p] = job_count + c
            e, d = round_metrics_g(q.cap[None], q.req[g:g + 1],
                                   q.dh_limit[g:g + 1], static, used[p],
                                   cur[p])
            n_exh = n_exh + e.cpu()
            dim_ex = dim_ex + d.cpu()
        top_rows, top_sc = _round_outputs(rows_p, cnt_p, sc_p, top_k)
        outs.append((rows_p, cnt_p, top_rows, top_sc, n_feas, n_filt,
                     n_exh, dim_ex, placed))
    cols = [torch.cat(c, dim=0) for c in zip(*outs)]
    fills, meta = S.pack_round_buffer(*cols)
    buf = torch.cat([fills, meta], dim=1).to(parts[0].attrs.device)
    return (buf, Parts([u[0] for u in used]),
            Parts([c[0].to(torch.int32) for c in cur]))


def place_multi_xmesh_plain(inp: MultiEvalInputs, mesh, round_size: int):
    """Plain version of K11 across parts: (buf [R, round_size + 16],
    used, last job count row), the last two `Parts`."""
    n = inp.attrs.shape[0]
    _n_rows(mesh, n)
    return _multi_core([part_inputs(inp, mesh, p)
                        for p in range(mesh.n_parts)], round_size, n)


def place_bulk_xmesh_plain(inp: BulkInputs, mesh, round_size: int,
                           n_rounds: int):
    """Plain version of K10 across parts: each part's bulk inputs as the
    flat rounds' at one group (select.bulk_as_flat), through the flat
    rounds across parts.  (buf [R, round_size + 16], used, job_count),
    the last two `Parts`."""
    n = inp.attrs.shape[0]
    _n_rows(mesh, n)
    parts = [S.bulk_as_flat(part_inputs(inp, mesh, p), round_size, n_rounds)
             for p in range(mesh.n_parts)]
    return _multi_core(parts, round_size, n)


def _frame_axes():
    axes = dict(_NODE_AXES[MultiEvalInputs])
    axes["job_count0"] = 0          # seeds [S, J', Nc_loc] split by shard
    return axes


def place_multi_compact_xmesh_plain(inp: MultiEvalInputs, cand_rows,
                                    cand_valid, mesh, round_size: int,
                                    n_lanes: int):
    """Plain version of K12 across parts: each part holds its shards'
    slices of every lane's frame ([S/D, L, Nc_loc] of global rows, its
    seeds [S/D, J', Nc_loc]), laid end to end as the part's lane frames
    (mesh.lane_frames); per step each part scores its frames with
    select.round_scores_g and posts; the decision commits each winner
    at its slot on its part; the parts' valid slots are written back to
    their own rows.  n_filtered is npad less the summed valid slots.
    Returns (buf_small [T*L, FILL_K + 16], fills [T*L, round_size],
    used), `used` a `Parts`."""
    from nomad_tpu_torch.parallel.mesh import lane_frames
    n = inp.attrs.shape[0]
    n_p = _n_rows(mesh, n)
    S._check_rounds(n, round_size)
    if (cand_rows.dim() != 3 or cand_rows.shape[:2] != (mesh.n_shards,
                                                        n_lanes)):
        raise ValueError("sharded frames must be [S, L, Nc_loc]")
    top_k = min(TOP_K, n)
    fill_k = min(S.FILL_K, round_size)
    D = mesh.n_parts
    axes = _frame_axes()
    parts, st = [], []
    for p in range(D):
        q = part_inputs(inp, mesh, p, axes)
        cr, cv, jc0 = lane_frames(block(cand_rows, mesh, p),
                                  block(cand_valid, mesh, p), q.job_count0)
        loc = (cr.long() - p * n_p).clamp(0, n_p - 1)
        aff_cu = affinity_landscape_plain(q.attrs, q.aff, q.luts,
                                          rows=cr - p * n_p)
        parts.append(q)
        st.append(dict(cr=cr, cv=cv, jc0=jc0, cap=q.cap[loc],
                       used=q.used0[loc], aff=aff_cu,
                       aff_any=(q.aff[..., 3] != 0).any(dim=1),
                       cur=torch.zeros(cr.shape, dtype=torch.int32,
                                       device=cr.device)))
    rg = parts[0].round_g.long().cpu().reshape(-1, n_lanes)
    seed_r = round_seeds(parts[0].seed.cpu(), rg)
    a_r = parts[0].g_aff.long().cpu()[rg]
    jrow_r = parts[0].g_job.long().cpu()[rg]
    same_r = torch.cat([torch.zeros((1, n_lanes), dtype=torch.bool),
                        rg[1:] == rg[:-1]], dim=0)
    want_r = parts[0].round_want.cpu().reshape(-1, n_lanes)
    frames = [x["cr"].shape[1] for x in st]
    lane_ix = torch.arange(n_lanes)
    outs = []
    for t in range(rg.shape[0]):
        posts, state = [], []
        for p, q in enumerate(parts):
            x = st[p]
            dev = q.attrs.device
            rq = q.req[rg[t].to(dev)]
            dh = q.dh_limit[rg[t].to(dev)]
            jc0 = x["jc0"][jrow_r[t].to(dev)]
            aff_sc = x["aff"][lane_ix.to(dev), a_r[t].to(dev)]
            noise = tiebreak_noise(seed_r[t][:, None].to(dev), x["cr"])
            job_count = torch.where(same_r[t][:, None].to(dev), x["cur"],
                                    jc0)
            k_i, score = round_scores_g(
                x["cap"], rq, q.desired[rg[t].to(dev)], dh, x["cv"], aff_sc,
                x["aff_any"][a_r[t].to(dev)], x["used"], job_count,
                q.spread_algo, round_size)
            post = _round_post(k_i, score, noise, x["cr"], x["cv"],
                               round_size)
            # n_filtered counts the frames' valid slots, not the rows
            posts.append(_Post(*(y.cpu() for y in post._replace(
                filt=x["cv"].sum(dim=-1)))))
            state.append((rq, dh, job_count))
        rows_p, cnt_p, sc_p, c_i, placed, n_feas, n_valid = xmesh_waterfill(
            posts, want_r[t], parts[0].spread_algo, round_size, frames)
        n_exh = dim_ex = 0
        for p, q in enumerate(parts):
            x = st[p]
            rq, dh, job_count = state[p]
            c = c_i[p].to(q.attrs.device)
            x["used"] = x["used"] + c[..., None] * rq[:, None, :]
            x["cur"] = job_count + c
            e, d = round_metrics_g(x["cap"], rq, dh, x["cv"], x["used"],
                                   x["cur"])
            n_exh = n_exh + e.cpu()
            dim_ex = dim_ex + d.cpu()
        top_rows, top_sc = _round_outputs(rows_p, cnt_p, sc_p, top_k)
        outs.append((rows_p, cnt_p, top_rows, top_sc, n_feas, n - n_valid,
                     n_exh, dim_ex, placed))
    cols = [torch.cat(c, dim=0) for c in zip(*outs)]
    fills, meta = S.pack_round_buffer(*cols)
    dev0 = parts[0].attrs.device
    used = []
    for p, q in enumerate(parts):
        x = st[p]
        u = q.used0.clone()
        keep = x["cv"]
        u[x["cr"][keep].long() - p * n_p] = x["used"][keep].to(u.dtype)
        used.append(u)
    return (torch.cat([fills[:, :fill_k], meta], dim=1).to(dev0),
            fills.to(dev0), Parts(used))


def scatter_add_xmesh_plain(used: Parts, rows: torch.Tensor,
                            vals: torch.Tensor, mesh) -> Parts:
    """Plain version of K13 across parts: each part adds the deltas of
    the rows it owns to its own rows, in place; rows index the npad
    global rows as in mesh.scatter_add_sharded_plain."""
    n_p = used.blocks[0].shape[0]
    npad = n_p * mesh.n_parts
    _n_rows(mesh, npad)
    r = K.wrap_rows(rows, npad)
    for p, u in enumerate(used.blocks):
        keep = (r >= p * n_p) & (r < (p + 1) * n_p)
        u.index_put_(((r[keep] - p * n_p).to(u.device),),
                     vals[keep].to(u.dtype).to(u.device), accumulate=True)
    return used


# ------------------------------------------------------------ the card

def _ensure_peers(mesh) -> None:
    """Peer access for every ordered pair of the mesh's distinct cards
    that has it, enabled once a mesh (a "host" mesh's parts meet in host
    memory and need none)."""
    if mesh._peers_on:
        return
    idx = sorted({d.index for d in mesh.parts})
    fn = K.PLACE_SCAN_XMESH.fn("xmesh_enable_peer")
    for a in idx:
        for b in idx:
            if a != b and torch.cuda.can_device_access_peer(a, b):
                rc = fn(a, b)
                if rc != 0:
                    raise RuntimeError(f"peer access from cuda:{a} to "
                                       f"cuda:{b} failed: cudaError {rc}")
    mesh._peers_on = True


class _HostBuf:
    """Mapped, portable pinned host memory (csrc/place_scan.cu
    `xmesh_host_alloc`), `view` its int32 words as a CPU tensor: an
    exchange buffer of a "host" mesh, busy from the launch that takes it
    until that launch's error word is read (`_HostWord`), or K13's
    staging ring."""

    __slots__ = ("ptr", "words", "view", "_arr", "busy")

    def __init__(self, words: int) -> None:
        out = torch.zeros(1, dtype=torch.int64)
        rc = K.PLACE_SCAN_XMESH.fn("xmesh_host_alloc")(4 * words,
                                                       out.data_ptr())
        if rc != 0:
            raise RuntimeError(f"xmesh_host_alloc of {4 * words} bytes "
                               f"failed: cudaError {rc}")
        self.ptr = int(out[0])
        self.words = words
        self._arr = (ctypes.c_int32 * words).from_address(self.ptr)
        self.view = torch.frombuffer(self._arr, dtype=torch.int32)
        self.busy = False


class _HostWord:
    """The error word of a launch across a "host" mesh, read in place
    (no copy) once the launch is done; reading it frees the buffer for
    the mesh's next call."""

    __slots__ = ("buf", "value")

    def __init__(self, buf: _HostBuf) -> None:
        self.buf = buf
        self.value = None

    def __getitem__(self, i: int) -> int:
        if self.value is None:
            self.value = int(self.buf.view[0])
            self.buf.busy = False
        return self.value


def _free_host_bufs(bufs: list) -> None:
    fn = K.PLACE_SCAN_XMESH.fn("xmesh_host_free")
    for b in bufs:
        fn(b.ptr)
    bufs.clear()


def _host_buf(mesh, words: int) -> _HostBuf:
    """A free host buffer of at least `words` words from the mesh's
    pool (a new one when none is free; at least 16 KiB, so that the
    entries' different sizes share buffers), marked busy."""
    with mesh._lock:
        for b in mesh._host_bufs:
            if b.words >= words and not b.busy:
                break
        else:
            if not mesh._host_bufs:
                f = weakref.finalize(mesh, _free_host_bufs,
                                     mesh._host_bufs)
                f.atexit = False
            b = _HostBuf(max(words, 4096))
            mesh._host_bufs.append(b)
        b.busy = True
    return b


def _run_parts(mesh, name: str, words: int, launch_part):
    """Launch every part's work, then order each device's later work
    after it.  A zeroed exchange buffer of `words` int32 on the home
    card, or for a "host" mesh one of its pool in host memory, zeroed
    from the host (free only once its last launch's error word was
    read, so after that launch's `done`); part p's
    `launch_part(p, XPart)` queues its set-up (inputs,
    statics, allocations) on its card's current stream and defers its
    exchanging launch (`XPart.launches`).  Once every part's set-up is
    queued, the deferred launches run one after another, each on
    `mesh.stream(p)` after that card's current stream (and, on another
    card, after the home stream's zeros): no part waits for the others
    while another part's host side still allocates or first loads a
    kernel (a lazy module load waits for the card to idle, which a
    waiting part never lets it do), and every tensor belongs to a
    current stream's pool.  Then the current stream of each part's
    card waits on every part's event.  The error word's copy to the
    host is queued behind them (a host buffer's is read in place), and
    the launch joins the calling thread's unchecked launches (`take`,
    `check`).

    The whole sequence holds the mesh's lock, and the parts' streams
    take no other work: two callers' exchanging launches interleaved on
    them (part 0 of one behind part 0 of the other, part 1 the other
    way round), or a copy between cards queued on the current streams
    between one call's parts (it orders each card's current stream
    after the other's), would each make a part wait for one queued
    behind it.  Returns the parts' outputs."""
    with mesh._lock:
        _ensure_peers(mesh)
        home = mesh.device
        home_cur = torch.cuda.current_stream(home)
        host = mesh.exchange == "host"
        if host:
            hbuf = _host_buf(mesh, words)
            hbuf.view.zero_()
            ptr = hbuf.ptr
        else:
            xbuf = torch.zeros(words, dtype=torch.int32, device=home)
            K.count_eager("xmesh_exchange_zeros")
            ptr = xbuf.data_ptr()
            ev0 = torch.cuda.Event()
            ev0.record(home_cur)
        sys_scope = int(host or len({d.index for d in mesh.parts}) > 1)
        outs, runs = [], []
        for p, dev in enumerate(mesh.parts):
            xp = S.XPart(p, mesh.n_parts, ptr, mesh.deadline, [], sys_scope)
            with torch.cuda.device(dev):
                outs.append(launch_part(p, xp))
            runs.append((dev, mesh.stream(p), xp.launches))
        # every part's stream ordered after the set-up first, before
        # any exchanging launch (and after the device buffer's zeros)
        for dev, run_on, _ in runs:
            run_on.wait_stream(torch.cuda.current_stream(dev))
            if dev != home and not host:
                run_on.wait_event(ev0)
        evs = []
        for dev, run_on, launches in runs:
            with torch.cuda.device(dev), torch.cuda.stream(run_on):
                for launch in launches:
                    launch()
            ev = torch.cuda.Event()
            ev.record(run_on)
            evs.append(ev)
        del runs
        for dev in dict.fromkeys(mesh.parts):
            cur = torch.cuda.current_stream(dev)
            for ev in evs:
                cur.wait_event(ev)
        if host:
            err = _HostWord(hbuf)
        else:
            err = torch.empty(1, dtype=torch.int32, pin_memory=True)
            err.copy_(xbuf[:1], non_blocking=True)
        done = torch.cuda.Event()
        done.record(home_cur)
    mine = _unchecked(mesh)
    if len(mine) >= 64:
        # launches never checked whose error word came back clean
        mine[:] = [x for x in mine if not (x[2].query() and int(x[1][0]) == 0)]
    mine.append((name, err, done))
    return outs


def _unchecked(mesh) -> list:
    """The calling thread's launches on `mesh` whose error word nobody
    has read yet."""
    local = mesh._local
    if not hasattr(local, "launches"):
        local.launches = []
    return local.launches


def take(mesh) -> list:
    """The calling thread's unchecked launches, handed over (a wave's
    dispatch keeps them for its collect, which may run on another
    thread)."""
    mine = _unchecked(mesh)
    out = list(mine)
    mine.clear()
    return out


def check(mesh, launches: Optional[list] = None, wait: bool = True) -> None:
    """Raise when a part of `launches` (by default the calling thread's
    unchecked launches) ran out its wait deadline (the exchange
    buffer's error word).  `wait`: wait for each launch's error word
    (which follows its kernels); else read only those already back,
    keeping the others for a later check."""
    own = launches is None
    todo = take(mesh) if own else launches
    bad, keep = [], []
    for entry in todo:
        name, err, done = entry
        if wait:
            done.synchronize()
        elif not done.query():
            keep.append(entry)
            continue
        if int(err[0]):
            bad.append(name)
    if own:
        _unchecked(mesh)[:0] = keep
    if bad:
        raise RuntimeError(f"{', '.join(bad)}: a part of the mesh ran out "
                           "its wait for another part (deadline "
                           f"{mesh.deadline} cycles)")


def _launch_check(mesh, t) -> None:
    if isinstance(t, Parts):
        t = t.blocks[0]
    if t.device.type != "cuda":
        raise ValueError(f"tensors on {t.device}, mesh on {mesh.parts}")


def place_xmesh_packed(inp: PlacementInputs, mesh):
    """K9 across parts on the card: (buf [P, 14] on the home part, used,
    job_count `Parts`)."""
    _launch_check(mesh, inp.attrs)
    _n_rows(mesh, inp.attrs.shape[0])
    s, d = inp.sp_counts0.shape[0], inp.pd_counts0.shape[0]
    words = K.PLACE_SCAN_XMESH.fn("place_scan_xmesh_words")(
        mesh.n_parts, s, d)
    if words < 0:
        raise ValueError("place_scan_xmesh: inconsistent shapes")

    def one(p, xp):
        return S._scan_launch(part_inputs(inp, mesh, p),
                              n_shards=mesh.shards_per_part, xp=xp)

    outs = _run_parts(mesh, "place_scan_xmesh", words, one)
    return (outs[0][0], Parts([o[1] for o in outs]),
            Parts([o[2] for o in outs]))


def _rounds_words(n_lanes: int, n_parts: int, kk: int) -> int:
    words = K.MULTI_FLAT_XMESH.fn("multi_xmesh_words")(n_lanes, n_parts, kk)
    if words < 0:
        raise ValueError("multi_xmesh_words: inconsistent shapes")
    return words


def place_bulk_xmesh_packed(inp: BulkInputs, mesh, round_size: int,
                            n_rounds: int):
    """K10 across parts on the card: (buf [R, round_size + 16], used,
    job_count), the last two `Parts`."""
    _launch_check(mesh, inp.attrs)
    n = inp.attrs.shape[0]
    _n_rows(mesh, n)
    words = _rounds_words(1, mesh.n_parts, min(round_size, n))

    def one(p, xp):
        return S._bulk_launch(part_inputs(inp, mesh, p), round_size,
                              n_rounds, False, 0, xp=xp)

    outs = _run_parts(mesh, "multi_bulk_xmesh", words, one)
    return (outs[0][0], Parts([o[1] for o in outs]),
            Parts([o[2] for o in outs]))


def place_multi_xmesh_launch(used, used_in, inp: MultiEvalInputs, mesh,
                             round_size: int, profs=None):
    """K11 across parts on the card: reads `used_in` and writes every row
    of `used` (both `Parts`; the same for the chained form).  (buf, used,
    last job count row), the last two `Parts`.  With `profs` (a part's
    int64 [select.XPROF_WORDS] each) the PROF instantiation runs and
    writes each part's split there (chip_smoke.py)."""
    _launch_check(mesh, inp.attrs)
    n = inp.attrs.shape[0]
    _n_rows(mesh, n)
    words = _rounds_words(1, mesh.n_parts, min(round_size, n))

    def one(p, xp):
        q = part_inputs(inp._replace(used0=None), mesh, p)
        return S._flat_launch(block(used, mesh, p), block(used_in, mesh, p),
                              q, round_size, xp=xp,
                              prof=None if profs is None else profs[p])

    outs = _run_parts(mesh, "multi_flat_xmesh" if profs is None
                      else "multi_flat_xmesh_prof", words, one)
    if not isinstance(used, Parts):
        used = Parts([o[1] for o in outs])
    return outs[0][0], used, Parts([o[2] for o in outs])


def place_multi_compact_xmesh_launch(used, used_in, inp: MultiEvalInputs,
                                     cand_rows, cand_valid, mesh,
                                     round_size: int, n_lanes: int,
                                     profs=None):
    """K12 across parts on the card: each part's launch over its shards'
    frames (`Parts` or whole [S, L, Nc_loc] tensors split by shard),
    reading `used_in` and writing the valid slots' rows of `used`.
    (buf_small, fills on the home part, used `Parts`).  `profs` as in
    `place_multi_xmesh_launch`."""
    _launch_check(mesh, inp.attrs)
    n = inp.attrs.shape[0]
    _n_rows(mesh, n)
    nct = mesh.n_shards * cand_rows.shape[-1]
    words = _rounds_words(n_lanes, mesh.n_parts, min(round_size, nct))
    axes = _frame_axes()

    def one(p, xp):
        q = part_inputs(inp._replace(used0=None), mesh, p, axes)
        return S._compact_launch(
            block(used, mesh, p), block(used_in, mesh, p), q,
            block(cand_rows, mesh, p), block(cand_valid, mesh, p),
            round_size, n_lanes, n_shards=mesh.shards_per_part, xp=xp,
            prof=None if profs is None else profs[p])

    outs = _run_parts(mesh, "multi_compact_xmesh" if profs is None
                      else "multi_compact_xmesh_prof", words, one)
    if not isinstance(used, Parts):
        used = Parts([o[2] for o in outs])
    return outs[0][0], outs[0][1], used


# K13 across parts: replay chunks from the CPU staged in mapped pinned
# host memory, a ring of K13_SLOTS slots of K13_SLOT_ROWS rows (the
# engine's chunk), each read by one call's launches (one a card) and
# reused once the last block of each of those launches has stored the
# slot's use number in the slot's done word (one a card, in the same
# pinned buffer)
K13_SLOT_ROWS = 16384
K13_SLOTS = 8
_K13_HEAD = 64                  # done words: 8 cards x K13_SLOTS
# seconds a slot's last launches may take to say they are done
K13_WAIT_S = 10.0
_I32 = torch.int32


class _K13Ring:
    """A mesh's staging ring for K13's host chunks: the pinned buffer
    (the done words, then the slots; `done` its numpy view), each card's
    block counters (a zeroed word a slot on the card), each slot's use
    number, the next slot."""

    __slots__ = ("buf", "done", "counts", "count_ptrs", "seq", "next")

    def __init__(self, cards) -> None:
        self.buf = _HostBuf(_K13_HEAD + K13_SLOTS * 4 * K13_SLOT_ROWS)
        self.buf.view.zero_()
        self.done = self.buf.view.numpy()
        self.counts = [torch.zeros(K13_SLOTS, dtype=torch.int32, device=d)
                       for d in cards]
        self.count_ptrs = [t.data_ptr() for t in self.counts]
        self.seq = [0] * K13_SLOTS
        self.next = 0


def _check_rows(rows, vals) -> int:
    """rows [M] and vals [M, 3], int32 and contiguous, both on the CPU or
    both on one card (K13 across parts, every call).  Returns M."""
    rs, vs = rows.shape, vals.shape
    if (rows.get_device() != vals.get_device() or rows.dtype is not _I32
            or vals.dtype is not _I32 or len(rs) != 1 or vs != (rs[0], 3)
            or not rows.is_contiguous() or not vals.is_contiguous()):
        raise ValueError(f"scatter_add_xmesh: rows {tuple(rs)} "
                         f"{rows.dtype} on {rows.device}, vals {tuple(vs)} "
                         f"{vals.dtype} on {vals.device}: want int32 [M] "
                         "and [M, 3], contiguous, on one device")
    return rs[0]


def _parts_ptrs(used: Parts, mesh):
    """The addresses K13 across parts takes for `used` on each card of
    the mesh (a part's used tensor where it lies on that card, None
    elsewhere), after checking every block: an int32 [n, 3] contiguous
    tensor on its part's card.  Kept for the mesh's last `used`, checked
    again when any of its blocks is another tensor."""
    blocks = used.blocks
    key = tuple(map(id, blocks))
    last = mesh._k13_used
    if last is not None and last[0] is used and last[1] == key:
        return last[3]
    shape = blocks[0].shape
    if len(blocks) != mesh.n_parts or len(shape) != 2 or shape[1] != 3:
        raise ValueError(f"scatter_add_xmesh: {len(blocks)} blocks of "
                         f"{tuple(shape)} for a mesh of {mesh.n_parts} "
                         "parts, want [n, 3] each")
    for b, dev in zip(blocks, mesh.parts):
        if (b.shape != shape or b.dtype is not _I32
                or b.get_device() != dev.index or not b.is_contiguous()):
            raise ValueError(f"scatter_add_xmesh: a used block "
                             f"{tuple(b.shape)} {b.dtype} on {b.device}, "
                             f"want {tuple(shape)} int32, contiguous, on "
                             f"{dev}")
    _n_rows(mesh, shape[0] * mesh.n_parts)
    pad = [None] * (8 - mesh.n_parts)
    ptrs = [[b.data_ptr() if d == dev else None
             for b, d in zip(blocks, mesh.parts)] + pad
            for dev in mesh.cards]
    # the blocks are kept too, so that no id of theirs is reused
    mesh._k13_used = (used, key, tuple(blocks), ptrs)
    return ptrs


def scatter_add_xmesh_(used: Parts, rows: torch.Tensor, vals: torch.Tensor,
                       mesh) -> Parts:
    """K13 across parts on the card: one launch a distinct card over the
    whole chunk, adding each row to the part that owns it among the
    card's parts (`scatter_add_xmesh`), on the card's current stream.
    rows and vals are checked every call, `used` whenever it is another
    tensor than the last call's (`_parts_ptrs`).  They reach each card
    once: from the CPU straight out of pinned host memory (a slot of the
    mesh's staging ring, filled by one host copy and read by every
    card's launch over PCIe; no copy to a card), from a card as they lie
    there, and a copy on each other card.  No exchange."""
    m = _check_rows(rows, vals)
    ptrs = _parts_ptrs(used, mesh)
    if not m:
        return used
    n, n_parts = used.blocks[0].shape[0], mesh.n_parts
    launch = K.SCATTER_ADD_XMESH.launch
    on = rows.get_device()
    if on >= 0:
        for c, dev in enumerate(mesh.cards):
            r, v = ((rows, vals) if dev.index == on
                    else (rows.to(dev), vals.to(dev)))
            launch(dev.index, "scatter_add_xmesh", *ptrs[c], n, n_parts,
                   r.data_ptr(), v.data_ptr(), m, None, None, 0)
        return used
    stage = K.SCATTER_ADD_XMESH.fn("xmesh_stage_chunk")
    r_src, v_src = rows.data_ptr(), vals.data_ptr()
    with mesh._lock:
        ring = mesh._k13_ring
        if ring is None:
            ring = mesh._k13_ring = _K13Ring(mesh.cards)
            f = weakref.finalize(mesh, _free_host_bufs, [ring.buf])
            f.atexit = False
        done, base = ring.done, ring.buf.ptr
        for lo in range(0, m, K13_SLOT_ROWS):
            k = min(K13_SLOT_ROWS, m - lo)
            i = ring.next
            ring.next = (i + 1) % K13_SLOTS
            seq = ring.seq[i]
            if done[i] != seq or len(mesh.cards) > 1:
                _k13_slot_free(done, i, seq, len(mesh.cards))
            seq = ring.seq[i] = seq + 1
            r_ptr = base + 4 * (_K13_HEAD + 4 * i * K13_SLOT_ROWS)
            rc = stage(r_ptr, r_src + 4 * lo, v_src + 12 * lo, k)
            try:
                if rc != 0:
                    raise RuntimeError(f"xmesh_stage_chunk: cudaError {rc}")
                for c, dev in enumerate(mesh.cards):
                    launch(dev.index, "scatter_add_xmesh", *ptrs[c], n,
                           n_parts, r_ptr, r_ptr + 4 * k, k,
                           ring.count_ptrs[c] + 4 * i,
                           base + 4 * (c * K13_SLOTS + i), seq)
            except BaseException:
                # a slot whose launches did not all go out would never
                # be told done: the next call starts a new ring
                mesh._k13_ring = None
                raise
    return used


def _k13_slot_free(done, i: int, seq: int, n_cards: int) -> None:
    """Wait until every card's last launch on slot i (use `seq`) has
    said it is done; raise after K13_WAIT_S seconds."""
    t0 = None
    for c in range(n_cards):
        while done[c * K13_SLOTS + i] != seq:
            t0 = time.monotonic() if t0 is None else t0
            if time.monotonic() - t0 > K13_WAIT_S:
                raise RuntimeError(
                    f"scatter_add_xmesh: staging slot {i} not released by "
                    f"its launches within {K13_WAIT_S} s")
            time.sleep(0)


def exchange_probe(mesh, rounds: int):
    """One launch a part of `rounds` exchanges of a 16-word post across
    the mesh's parts by K9's protocol (csrc/place_scan.cu
    `xmesh_exchange_probe`), each part on its own stream; returns the
    home stream's elapsed ms.  The placement path never calls it."""
    # the header, then two slots a part of 16 (word, flag) pairs
    words = 32 + 2 * mesh.n_parts * 32
    sink = torch.zeros(1, dtype=torch.int32, device=mesh.device)
    fn = K.PLACE_SCAN_XMESH.fn("xmesh_exchange_probe")
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record(torch.cuda.current_stream(mesh.device))

    def launch(p, xp):
        rc = fn(rounds, p, mesh.n_parts, xp.buf, xp.deadline, xp.sys_scope,
                sink.data_ptr(), K._raw_stream(mesh.parts[p].index))
        if rc != 0:
            raise RuntimeError(f"xmesh_exchange_probe: cudaError {rc}")

    def one(p, xp):
        xp.launches.append(lambda: launch(p, xp))

    _run_parts(mesh, "xmesh_exchange_probe", words, one)
    end.record(torch.cuda.current_stream(mesh.device))
    end.synchronize()
    check(mesh)
    return start.elapsed_time(end)
