"""Placement selection (reference: nomad_tpu/ops/select.py).

The solo path places one eval's batch: an exact scan, one placement per
step, that sees every earlier placement's capacity, job count, spread and
distinct_property state (`PlacementInputs`), or, for a homogeneous
batch, water-fill rounds of up to 1,024 placements (`BulkInputs`).  The
multi-eval path places G task groups drawn from up to J jobs in rounds
against one shared capacity state (`MultiEvalInputs`).  Each launch has
a plain PyTorch version, written in the reference's order of operations
so that its integer outputs, packed buffers and f32 score bits agree
with the JAX functions on the CPU, and a wrapper that launches the
hand-written CUDA kernel for a CUDA tensor:

  place, place_packed         K5 (csrc/place_scan.cu, exact scan)
  place_bulk_packed           K6 (csrc/compact_rounds.cu, bulk rounds:
                              the flat mode at one group, bulk_as_flat)
  place_multi_packed          K3 (csrc/compact_rounds.cu, flat rounds)
  place_multi_compact_packed  K2 (csrc/compact_rounds.cu, laned rounds)

all on top of K1's landscapes (scoring.landscapes, the mask and the
affinity in one launch, for K3; scoring.affinity_landscape for the
others); K5 and K6 take their static mask from K8
(feasibility.feasible_mask).

Top-k order: `jax.lax.top_k` puts the lower index first among equal
values; the plain versions sort stably (value descending, index
ascending) and the kernels select on (value, inverted index) keys.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import kernels as K
from .feasibility import (
    and_rows,
    feasible_mask,
    feasible_mask_plain,
    landscape_mask_plain,
)
from .scoring import (
    affinity_landscape,
    affinity_landscape_plain,
    affinity_score,
    binpack_score,
    capacity_fit,
    job_anti_affinity,
    landscapes,
    normalize_scores,
    spread_boost,
)

NEG_INF = -1e30
TOP_K = 3
# Compact-output fill prefix: rounds report their top FILL_K (node, count)
# fills in the always-fetched small buffer; the full [round_size] prefix
# stays on the device and is fetched only when a round overflows
# (reference: select.FILL_K).
FILL_K = 32
# int64 words of a PROF split across parts (csrc/compact_rounds.cu
# XPROF_WORDS): K2's 18, 9 exchange sub-phases of two step kinds for
# block 0 and for the cluster's last block, the exchange counts
XPROF_WORDS = 18 + 4 * 9 + 2

_U32 = 0xFFFFFFFF
_INV18 = torch.tensor(1.0 / 18.0, dtype=torch.float32)


def tiebreak_noise(seed: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Per-eval tie-break jitter of magnitude 1e-6 over global node rows:
    the reference's uint32 counter hash, computed in int64 with the low
    32 bits kept, then x * (1e-6 / 2^32) in f32, times (seed != 0).
    `seed` broadcasts against `rows` (int64 values in [0, 2^32))."""
    seed = seed.to(torch.int64)
    x = (((rows.to(torch.int64) & _U32) * 0x9E3779B1) & _U32) ^ (
        (seed * 0x85EBCA77) & _U32)
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & _U32
    x = ((x ^ (x >> 15)) * 0x846CA68B) & _U32
    x = x ^ (x >> 16)
    scale = torch.tensor(1e-6 / 2**32, dtype=torch.float32,
                         device=rows.device)
    return x.to(torch.float32) * scale * (seed != 0)


class MultiEvalInputs(NamedTuple):
    """Device inputs for ONE batched multi-eval launch (field meanings
    and shapes as the reference's select.MultiEvalInputs).  `seed` holds
    per-task-group uint32 values in int64 ([G], or a 0-dim tensor that
    broadcasts); `spread_algo` is a Python bool.  `node_ok` (the port's
    own field) is the refuted-node row ANDed into `elig` by K1, where
    the reference's engine passes `elig & node_ok` as `elig`."""
    attrs: torch.Tensor       # [N, A] int32
    cap: torch.Tensor         # [N, 3] int32
    used0: Optional[torch.Tensor]  # [N, 3] int32 (None in a chained call)
    elig: torch.Tensor        # [N] bool
    luts: torch.Tensor        # [L, V] bool
    base_mask: torch.Tensor   # [M, N] bool
    con: torch.Tensor         # [U, C, 3] int32
    u_mask: torch.Tensor      # [U] int32
    aff: torch.Tensor         # [Ua, Af, 4] int32
    req: torch.Tensor         # [G, 3] int32
    desired: torch.Tensor     # [G] int32
    dh_limit: torch.Tensor    # [G] int32
    g_static: torch.Tensor    # [G] int32
    g_aff: torch.Tensor       # [G] int32
    g_job: torch.Tensor       # [G] int32
    job_count0: torch.Tensor  # flat [G, N] / compact [J', Nc] int32
    spread_algo: bool
    round_g: torch.Tensor     # [R] int32
    round_want: torch.Tensor  # [R] int32
    seed: torch.Tensor        # [G] int64 (uint32 values) or 0-dim
    node_ok: Optional[torch.Tensor] = None  # [N] bool


def round_seeds(seed: torch.Tensor, rg: torch.Tensor) -> torch.Tensor:
    """Per-round seeds gathered by the round schedule (a 0-dim seed
    broadcasts to every round)."""
    if seed.dim() == 0:
        return seed.expand(rg.shape)
    return seed[rg.long()]


# ------------------------------------------------------- shared round core
# Every tensor below carries a leading lane axis L (1 on the flat path).

def round_scores_g(cap, req, desired, dh_limit, static, aff_sc, aff_any,
                   used, job_count, spread_algo: bool, round_size: int):
    """Intake k_i and rank score per frame row for one round per lane
    (reference: select.round_scores_g).  cap/used [L, Nc, 3], req [L, 3],
    desired/dh_limit [L], static/aff_sc/job_count [L, Nc], aff_any [L]."""
    big = round_size
    free = cap - used
    rq = req[:, None, :]
    per_dim = torch.where(
        rq > 0, torch.div(free, torch.clamp(rq, min=1),
                          rounding_mode="floor"), big)
    k_i = torch.clamp(per_dim.min(dim=-1).values, 0, big)
    k_i = torch.where((free < 0).any(dim=-1), 0, k_i)
    dh = dh_limit[:, None]
    k_i = torch.where(dh > 0,
                      torch.minimum(k_i, torch.clamp(dh - job_count, 0, big)),
                      k_i)
    k_i = torch.where(static, k_i, 0).to(torch.int32)

    # the reference writes `/ 18.0`; XLA's simplifier turns a division by
    # a constant into a multiply by its f32 reciprocal, and the scores
    # must agree to the bit, so the port multiplies too
    bp = binpack_score(cap.to(torch.float32), used.to(torch.float32),
                       rq.to(torch.float32), spread_algo) * _INV18.to(
                           cap.device)
    aa = job_anti_affinity(job_count, desired[:, None])
    score = normalize_scores(
        [bp, aa, aff_sc],
        [torch.ones_like(static), job_count > 0,
         aff_any[:, None].expand_as(static)])
    return k_i, score


def round_metrics_g(cap, req, dh_limit, static, used, job_count):
    """Post-commit exhaustion metrics per lane (reference:
    select.round_metrics_g): (n_exhausted [L], dim_exhausted [L, 3])."""
    free2 = cap - used
    rq = req[:, None, :]
    fit2 = (free2 >= rq).all(dim=-1) & (free2 >= 0).all(dim=-1)
    dh = dh_limit[:, None]
    dh_ok2 = torch.where(dh > 0, job_count < dh, True)
    exhausted2 = static & ~(fit2 & dh_ok2)
    n_exh = exhausted2.sum(dim=-1)
    dim_ex = (exhausted2[..., None] & (free2 < rq)).sum(dim=-2)
    return n_exh.to(torch.int32), dim_ex.to(torch.int32)


def waterfill_round(k_i, score, noise, want, spread_algo: bool,
                    round_size: int):
    """Water-fill one round per lane (reference: select.waterfill_round):
    top-`round_size` rows by (score + noise) descending, index ascending
    among ties, each filled up to its intake until `want` placements.
    Returns (rows_p, cnt_p, sc_p [L, round_size], c_i [L, Nc],
    placed_total [L], k_round [L, Nc])."""
    lanes, n = k_i.shape
    big = round_size
    viable = torch.clamp((k_i > 0).sum(dim=-1), min=1)
    if spread_algo:
        cap_round = torch.clamp(want.to(torch.int64) // viable + 1, min=1)
    else:
        cap_round = torch.full_like(viable, big)
    k_round = torch.minimum(k_i, cap_round[:, None].to(k_i.dtype))

    masked = torch.where(k_round > 0, score, NEG_INF)
    kk = min(round_size, n)
    keys = masked + noise
    order = torch.sort(keys, dim=-1, descending=True,
                       stable=True).indices[:, :kk]
    nsc = keys.gather(-1, order)
    sc_k = torch.where(nsc > NEG_INF / 2, score.gather(-1, order), NEG_INF)
    k_sorted = torch.where(sc_k > NEG_INF / 2, k_round.gather(-1, order), 0)
    csum = torch.cumsum(k_sorted, dim=-1, dtype=torch.int32)
    c_sorted = torch.minimum(
        torch.clamp(want[:, None] - (csum - k_sorted), min=0), k_sorted)
    c_sorted = c_sorted.to(torch.int32)
    placed_total = c_sorted.sum(dim=-1, dtype=torch.int32)
    c_i = torch.zeros_like(k_i, dtype=torch.int32).scatter_add_(
        -1, order, c_sorted)

    pad = round_size - kk
    if pad:
        rows_p = torch.cat(
            [order, order.new_zeros((lanes, pad))], dim=-1)
        cnt_p = torch.cat([c_sorted, c_sorted.new_zeros((lanes, pad))],
                          dim=-1)
        sc_p = torch.cat([sc_k, sc_k.new_full((lanes, pad), NEG_INF)],
                         dim=-1)
    else:
        rows_p, cnt_p, sc_p = order, c_sorted, sc_k
    return rows_p, cnt_p, sc_p, c_i, placed_total, k_round


def pack_round_buffer(rows_p, cnt_p, top_rows, top_sc, n_feas, n_filt,
                      n_exh, dim_ex, placed):
    """Packed fill slots (row*2048 + count) and the 16-word meta block of
    every rounds-based kernel (reference: select.pack_round_buffer):
    topk_rows(3) | bitcast topk_scores(3) | n_feasible | n_filtered |
    n_exhausted | dim_exhausted(3) | placed_total | pad(3)."""
    fills = torch.where(cnt_p > 0, rows_p * 2048 + cnt_p, 0).to(torch.int32)
    r, tk = top_rows.shape
    dev = top_rows.device
    meta = torch.cat([
        top_rows.to(torch.int32),
        torch.full((r, 3 - tk), -1, dtype=torch.int32, device=dev),
        top_sc.to(torch.float32).contiguous().view(torch.int32),
        torch.zeros((r, 3 - tk), dtype=torch.int32, device=dev),
        n_feas[:, None].to(torch.int32), n_filt[:, None].to(torch.int32),
        n_exh[:, None].to(torch.int32), dim_ex.to(torch.int32),
        placed[:, None].to(torch.int32),
        torch.zeros((r, 3), dtype=torch.int32, device=dev),
    ], dim=1)
    return fills, meta


def _check_rounds(n: int, round_size: int) -> None:
    if n >= (1 << 20):
        raise ValueError("packed fill rows support < 2^20 nodes")
    if not 1 <= round_size <= 1024:
        raise ValueError("packed fill counts support rounds <= 1024")


# ------------------------------------------------------------------ K3

def place_multi_packed_plain(inp: MultiEvalInputs, round_size: int,
                             fill=waterfill_round):
    """Plain version of K3: the round core over all N rows, one round at
    a time.  Returns (buf [R, round_size + 16], used [N, 3], last job
    count row [N]).  `fill` decides each round's fills (the sharded
    plain versions pass parallel.mesh's two-stage water-fill)."""
    n = inp.attrs.shape[0]
    _check_rounds(n, round_size)
    top_k = min(TOP_K, n)
    static_u = landscape_mask_plain(inp.attrs, inp.con, inp.luts,
                                    and_rows(inp.elig, inp.node_ok),
                                    inp.base_mask, inp.u_mask)    # [U, N]
    aff_u = affinity_landscape_plain(inp.attrs, inp.aff, inp.luts)  # [Ua, N]
    aff_any_u = (inp.aff[..., 3] != 0).any(dim=1)
    rg = inp.round_g.long()
    u_r = inp.g_static.long()[rg]
    a_r = inp.g_aff.long()[rg]
    jobs_r = inp.g_job.long()[rg]
    jc_r = inp.job_count0[jobs_r]                                  # [R, N]
    same_r = torch.cat([torch.zeros(1, dtype=torch.bool, device=rg.device),
                        jobs_r[1:] == jobs_r[:-1]])
    seed_r = round_seeds(inp.seed, rg)
    rows_all = torch.arange(n, device=rg.device)[None, :]
    used = inp.used0[None].clone()                               # [1, N, 3]
    cap = inp.cap[None]
    cur = inp.job_count0[0][None]
    outs = []
    for r in range(rg.shape[0]):
        g = rg[r:r + 1]
        static = static_u[u_r[r:r + 1]]
        noise = tiebreak_noise(seed_r[r:r + 1, None], rows_all)
        job_count = torch.where(same_r[r], cur, jc_r[r][None])
        req = inp.req[g]
        k_i, score = round_scores_g(
            cap, req, inp.desired[g], inp.dh_limit[g], static,
            aff_u[a_r[r:r + 1]], aff_any_u[a_r[r:r + 1]], used, job_count,
            inp.spread_algo, round_size)
        rows_p, cnt_p, sc_p, c_i, placed, k_round = fill(
            k_i, score, noise, inp.round_want[r:r + 1], inp.spread_algo,
            round_size)
        used = used + c_i[..., None] * req[:, None, :]
        job_count = job_count + c_i
        cur = job_count
        top_sc = sc_p[:, :top_k]
        valid = top_sc > NEG_INF / 2
        top_rows = torch.where(valid, rows_p[:, :top_k], -1)
        top_sc = torch.where(valid, top_sc, 0.0)
        n_feas = (k_round > 0).sum(dim=-1)
        n_filt = (~static).sum(dim=-1)
        n_exh, dim_ex = round_metrics_g(cap, req, inp.dh_limit[g], static,
                                        used, job_count)
        outs.append((rows_p, cnt_p, top_rows, top_sc, n_feas, n_filt,
                     n_exh, dim_ex, placed))
    cols = [torch.cat(c, dim=0) for c in zip(*outs)]
    fills, meta = pack_round_buffer(*cols)
    buf = torch.cat([fills, meta], dim=1)
    return buf, used[0], cur[0].to(torch.int32)


class XPart(NamedTuple):
    """One part's launch of a mesh across parts (parallel/xmesh.py):
    the part's index and the part count, the address of the exchange
    buffer on the home part's card, and the clock64() cycles a wait for
    another part may take.  The launch's node tensors are the part's own
    rows [part n, (part + 1) n); only part 0 writes the packed buffers.
    The launch helpers append the part's exchanging launch to `launches`
    (a closure) instead of making it: every part's set-up (its statics,
    allocations, first loads of kernels) then ends before any part
    starts to wait for the others (parallel/xmesh.py `_run_parts`).
    `sys_scope`: the exchange's memory operations at system scope (parts
    on several cards, or a buffer in host memory), else at GPU scope
    (every part on one card, the buffer in its memory); K9 and the
    rounds across parts (K10, K11, K12) take it alike."""
    part: int
    n_parts: int
    buf: int
    deadline: int
    launches: list
    sys_scope: int


def _launch(kern, xp, keep, device: int, symbol: str, *args) -> None:
    """`kern.launch`, or with an XPart its deferred launch, which holds
    `keep` (the tensors whose addresses `args` pass) until it runs."""
    if xp is None:
        kern.launch(device, symbol, *args)
    else:
        xp.launches.append(
            lambda keep=keep: kern.launch(device, symbol, *args))


def _check_shards(name: str, n: int, n_shards: int) -> None:
    if n_shards and (not 1 <= n_shards <= 8 or n % n_shards):
        raise ValueError(f"{name}: {n} rows do not split into {n_shards} "
                         "shards (1..8)")


def _multi_seed(inp: MultiEvalInputs) -> torch.Tensor:
    """The per-group seeds [G] as int64 (a 0-dim seed broadcast)."""
    g_cnt = inp.req.shape[0]
    seed = inp.seed.expand(g_cnt) if inp.seed.dim() == 0 else inp.seed
    return seed.to(torch.int64).contiguous()


def _frame_scratch(kern, name, dev, *plan):
    """The global scratch of a compact_rounds.cu launch whose frame
    state does not fit in shared memory (None when it fits); `plan` as
    the `multi_compact_scratch_bytes` launcher takes it (with a sixth
    value, the part count of a mesh across parts, as
    `multi_xmesh_scratch_bytes` takes it)."""
    nbytes = kern.fn("multi_xmesh_scratch_bytes" if len(plan) > 5
                     else "multi_compact_scratch_bytes")(*plan)
    if nbytes < 0:
        raise ValueError(f"{name}: frames of {plan[1]} slots at round "
                         f"size {plan[2]} do not fit")
    return (torch.empty(nbytes, dtype=torch.uint8, device=dev)
            if nbytes else None)


def _flat_mode_launch(kern, dev, n: int, round_size: int, args,
                      n_shards: int = 0, prof=None, xp=None,
                      keep=()) -> None:
    """One launch of csrc/compact_rounds.cu's flat mode (K3, K6, and K11,
    K10 with `n_shards`: the same launch over rows that many shards hold
    in order), on a cluster that `plan()` sizes for `n` rows, with global
    scratch when the frame does not fit in its shared memory.  `args`
    are the entry's arguments before its scratch.  With `prof` (int64
    [18] on the card; K11 across parts [XPROF_WORDS]) the PROF
    instantiation runs instead and writes block 0's phase split there
    (chip_smoke.py).  With `xp` (an XPart) the launch is one part's of a
    mesh across parts (K10, K11), deferred with `keep`, the tensors
    `args` point into."""
    if xp is not None:
        frame = _frame_scratch(kern, kern.name, dev, 1, n, round_size, 1,
                               1, xp.n_parts)
    else:
        frame = _frame_scratch(kern, kern.name, dev, 1, n, round_size, 1, 1)
    tail = [None if frame is None else frame.data_ptr()]
    symbol = kern.name
    if xp is not None:
        tail += [xp.part, xp.n_parts, xp.buf, xp.deadline, xp.sys_scope]
    elif n_shards:
        tail.append(n_shards)
    if prof is not None:
        symbol += "_prof"
        tail.append(prof.data_ptr())
    _launch(kern, xp, (keep, frame), dev.index, symbol, *args, *tail)


def _flat_launch(used: torch.Tensor, used_in: torch.Tensor,
                 inp: MultiEvalInputs, round_size: int, n_shards: int = 0,
                 prof=None, xp=None):
    """K1's landscapes (one launch for both) + one K3 launch
    (`_flat_mode_launch`; K11 with `n_shards`, counted on K11's entry;
    with `xp` one part's K11 of a mesh across parts, over the part's own
    rows, counted on its entry, its buffer None but on part 0).
    The kernel reads the usage from `used_in` and writes every row of
    `used` (the same tensor for the chained form, updated in place)."""
    kern = (K.MULTI_FLAT_XMESH if xp is not None
            else K.MULTI_FLAT_SHARDED if n_shards else K.MULTI_FLAT)
    name = kern.name
    n = inp.attrs.shape[0]
    _check_rounds(n, round_size)
    _check_shards(name, n, n_shards)
    dev = inp.attrs.device
    static_u, aff_u = landscapes(inp.attrs, inp.con, inp.luts, inp.elig,
                                 inp.base_mask, inp.u_mask, inp.aff,
                                 inp.node_ok)
    seed = _multi_seed(inp)
    tensors = dict(cap=inp.cap, used_in=used_in, used=used,
                   static_u=static_u, aff_u=aff_u, aff=inp.aff, req=inp.req,
                   desired=inp.desired, dh_limit=inp.dh_limit,
                   g_static=inp.g_static, g_aff=inp.g_aff, g_job=inp.g_job,
                   seed=seed, job_count0=inp.job_count0,
                   round_g=inp.round_g, round_want=inp.round_want)
    K.check_cuda(name, **tensors)
    for key in ("cap", "used_in", "used", "aff", "req", "desired",
                "dh_limit", "g_static", "g_aff", "g_job", "job_count0",
                "round_g", "round_want"):
        K.check_dtype(f"{name}.{key}", tensors[key], torch.int32)
    if (used.shape != (n, 3) or used_in.shape != (n, 3)
            or inp.cap.shape != (n, 3)
            or inp.job_count0.dim() != 2 or inp.job_count0.shape[1] != n
            or seed.shape[0] != inp.req.shape[0]
            or inp.round_g.shape != inp.round_want.shape):
        raise ValueError(f"{name}: inconsistent shapes")
    n_rounds = inp.round_g.shape[0]
    ua, af = inp.aff.shape[:2]
    buf = (torch.empty((n_rounds, round_size + 16), dtype=torch.int32,
                       device=dev) if xp is None or xp.part == 0 else None)
    jc = torch.empty(n, dtype=torch.int32, device=dev)
    if not n_rounds:
        if used is not used_in:
            used.copy_(used_in)
        return buf, used, jc.copy_(inp.job_count0[0])
    _flat_mode_launch(kern, dev, n, round_size, [
        *[t.data_ptr() for t in tensors.values()],
        None if buf is None else buf.data_ptr(), jc.data_ptr(), n, ua, af,
        n_rounds, int(bool(inp.spread_algo)), round_size], n_shards, prof,
        xp, (tensors, buf, jc))
    return buf, used, jc


def place_multi_packed(inp: MultiEvalInputs, round_size: int):
    """Batched multi-eval placement over all N rows (reference:
    select.place_multi_packed): (buf [R, round_size + 16], used [N, 3],
    last job count row [N]).  CPU tensors take the plain version; CUDA
    tensors launch K1 and K3 (or raise).  `inp.used0` is not modified."""
    if inp.attrs.device.type == "cpu":
        return place_multi_packed_plain(inp, round_size)
    return _flat_launch(torch.empty_like(inp.used0), inp.used0, inp,
                        round_size)


def place_multi_chained(used0: torch.Tensor, inp: MultiEvalInputs,
                        round_size: int):
    """`place_multi_packed` starting from `used0`, a dead buffer (the
    previous wave's usage output) that is updated in place and returned
    as this wave's usage: the port's form of the reference's donated
    argument."""
    if used0.device.type == "cpu":
        buf, used, jc = place_multi_packed_plain(
            inp._replace(used0=used0), round_size)
        used0.copy_(used)
        return buf, used0, jc
    return _flat_launch(used0, used0, inp, round_size)


# ------------------------------------------------------------------ K2

def place_multi_compact_packed_plain(inp: MultiEvalInputs, cand_rows,
                                     cand_valid, round_size: int,
                                     n_lanes: int, fill=waterfill_round):
    """Plain version of K2: lanes over disjoint candidate frames
    (`cand_rows` [L, Nc] int32, padding = N; `cand_valid` [L, Nc] bool),
    one round per lane per step over the step-major [T * L] schedule.
    Returns (buf_small [T*L, FILL_K + 16], fills_full [T*L, round_size],
    used [N, 3]).  `fill` as in `place_multi_packed_plain`."""
    n = inp.attrs.shape[0]
    _check_rounds(n, round_size)
    top_k = min(TOP_K, n)
    fill_k = min(FILL_K, round_size)
    dev = inp.attrs.device
    cr = cand_rows.long()
    crc = cr.clamp(max=n - 1)           # gathers clamp like JAX's
    cap_c = inp.cap[crc]                                         # [L, Nc, 3]
    used_c = inp.used0[crc]
    aff_cu = affinity_landscape_plain(inp.attrs, inp.aff, inp.luts,
                                      rows=cand_rows)          # [L, Ua, Nc]
    aff_any_u = (inp.aff[..., 3] != 0).any(dim=1)
    rg = inp.round_g.long().reshape(-1, n_lanes)                 # [T, L]
    seed_r = round_seeds(inp.seed, rg)
    a_r = inp.g_aff.long()[rg]
    jrow_r = inp.g_job.long()[rg]
    req_r = inp.req[rg]
    des_r = inp.desired[rg]
    dh_r = inp.dh_limit[rg]
    same_r = torch.cat([torch.zeros((1, n_lanes), dtype=torch.bool,
                                    device=dev), rg[1:] == rg[:-1]], dim=0)
    want_r = inp.round_want.reshape(-1, n_lanes)
    cand_n = cand_valid.sum(dim=1)
    lane_ix = torch.arange(n_lanes, device=dev)
    cur = torch.zeros(cand_rows.shape, dtype=torch.int32, device=dev)
    outs = []
    for t in range(rg.shape[0]):
        jc0 = inp.job_count0[jrow_r[t]]                          # [L, Nc]
        aff_sc = aff_cu[lane_ix, a_r[t]]                         # [L, Nc]
        noise = tiebreak_noise(seed_r[t][:, None], cr)
        job_count = torch.where(same_r[t][:, None], cur, jc0)
        k_i, score = round_scores_g(
            cap_c, req_r[t], des_r[t], dh_r[t], cand_valid, aff_sc,
            aff_any_u[a_r[t]], used_c, job_count, inp.spread_algo,
            round_size)
        rows_p, cnt_p, sc_p, c_i, placed, k_round = fill(
            k_i, score, noise, want_r[t], inp.spread_algo, round_size)
        used_c = used_c + c_i[..., None] * req_r[t][:, None, :]
        job_count = job_count + c_i
        cur = job_count
        top_sc = sc_p[:, :top_k]
        valid = top_sc > NEG_INF / 2
        top_rows = torch.where(valid, cand_rows.gather(1, rows_p[:, :top_k]),
                               -1)
        top_sc = torch.where(valid, top_sc, 0.0)
        n_feas = (k_round > 0).sum(dim=-1)
        n_filt = n - cand_n
        n_exh, dim_ex = round_metrics_g(cap_c, req_r[t], dh_r[t],
                                        cand_valid, used_c, job_count)
        rows_g = cand_rows.gather(1, rows_p)
        outs.append((rows_g, cnt_p, top_rows, top_sc, n_feas, n_filt,
                     n_exh, dim_ex, placed))
    cols = [torch.cat(c, dim=0) for c in zip(*outs)]    # step-major rows
    fills, meta = pack_round_buffer(*cols)
    used = inp.used0.clone()
    keep = cr < n
    used[cr[keep]] = used_c[keep].to(used.dtype)
    buf_small = torch.cat([fills[:, :fill_k], meta], dim=1)
    return buf_small, fills, used


def _compact_launch(used_out: torch.Tensor, used_in: torch.Tensor,
                    inp: MultiEvalInputs, cand_rows, cand_valid,
                    round_size: int, n_lanes: int, n_shards: int = 0,
                    prof=None, xp=None):
    """K1's per-frame affinity + one K2 launch (csrc/compact_rounds.cu, a
    cluster of up to 8 blocks per lane; K12 with `n_shards`: per-shard
    frames [S, L, Nc_loc] and seeds [S, J', Nc_loc], each lane's shard
    slices laid end to end, one block per shard).  `used_out` receives
    the final usage; it may be `used_in` itself.  With `prof` (int64
    [18] on the card; with `xp` [XPROF_WORDS]) the PROF instantiation
    runs instead and writes block 0's phase split there (chip_smoke.py;
    across parts also the exchanges' sub-phases).  With `xp` (an XPart)
    the launch is one part's K12 of a mesh across parts: its frames
    [S_p, L, Nc_loc] hold global rows, its node tensors its own rows, and
    its buffers are None but on part 0."""
    kern = (K.MULTI_COMPACT_XMESH if xp is not None
            else K.MULTI_COMPACT_SHARDED if n_shards else K.MULTI_COMPACT)
    name = kern.name
    n = inp.attrs.shape[0]
    _check_rounds(n, round_size)
    _check_shards(name, n, n_shards)
    dev = inp.attrs.device
    lead = (n_shards, n_lanes) if n_shards else (n_lanes,)
    if cand_rows.shape != cand_valid.shape \
            or cand_rows.shape[:-1] != lead:
        raise ValueError(f"{name}: frames must be {list(lead)} + [Nc]")
    K.check_dtype(f"{name}.cand_rows", cand_rows, torch.int32)
    K.check_dtype(f"{name}.cand_valid", cand_valid, torch.bool)
    nc = cand_rows.shape[-1]
    aff_rows = cand_rows.reshape(-1, nc)
    if xp is not None:
        # K1 reads the part's own rows
        K.count_eager("xmesh_local_rows")
        aff_rows = aff_rows - xp.part * n
    aff_cu = affinity_landscape(inp.attrs, inp.aff, inp.luts,
                                rows=aff_rows)
    seed = _multi_seed(inp)
    tensors = dict(cap=inp.cap, used_in=used_in, used_out=used_out,
                   cand_rows=cand_rows, cand_valid=cand_valid,
                   aff_cu=aff_cu, aff=inp.aff, req=inp.req,
                   desired=inp.desired, dh_limit=inp.dh_limit,
                   g_aff=inp.g_aff, g_job=inp.g_job, seed=seed,
                   job_count0=inp.job_count0, round_g=inp.round_g,
                   round_want=inp.round_want)
    K.check_cuda(name, **tensors)
    for key in ("cap", "used_in", "used_out", "aff", "req", "desired",
                "dh_limit", "g_aff", "g_job", "job_count0", "round_g",
                "round_want"):
        K.check_dtype(f"{name}.{key}", tensors[key], torch.int32)
    jc_lead = (n_shards,) if n_shards else ()
    if (used_in.shape != (n, 3) or used_out.shape != (n, 3)
            or inp.job_count0.dim() != len(jc_lead) + 2
            or inp.job_count0.shape[:len(jc_lead)] != jc_lead
            or inp.job_count0.shape[-1] != nc
            or seed.shape[0] != inp.req.shape[0]
            or inp.round_g.shape != inp.round_want.shape
            or inp.round_g.shape[0] % n_lanes):
        raise ValueError(f"{name}: inconsistent shapes")
    n_steps = inp.round_g.shape[0] // n_lanes
    fill_k = min(FILL_K, round_size)
    ua, af = inp.aff.shape[:2]
    home = xp is None or xp.part == 0
    buf_small = (torch.empty((n_steps * n_lanes, fill_k + 16),
                             dtype=torch.int32, device=dev) if home else None)
    fills = (torch.empty((n_steps * n_lanes, round_size), dtype=torch.int32,
                         device=dev) if home else None)
    if not (n_steps and nc):
        return buf_small, fills, used_out
    plan = (n_lanes, nc, round_size, max(n_shards, 1), 0)
    if xp is not None:
        plan += (xp.n_parts,)
    frame = _frame_scratch(kern, name, dev, *plan)
    tail = [None if frame is None else frame.data_ptr()]
    if n_shards:
        tail += [n_shards, inp.job_count0.shape[1]]
    if xp is not None:
        tail += [xp.part, xp.n_parts, xp.buf, xp.deadline, xp.sys_scope]
    symbol = name
    if prof is not None:
        symbol = name + "_prof"
        tail.append(prof.data_ptr())
    _launch(kern, xp, (tensors, buf_small, fills, frame), dev.index, symbol,
            *[t.data_ptr() for t in tensors.values()],
            *[None if t is None else t.data_ptr()
              for t in (buf_small, fills)],
            n, n_lanes, nc, ua, af, n_steps, int(bool(inp.spread_algo)),
            round_size, fill_k, *tail)
    return buf_small, fills, used_out


def place_multi_compact_packed(inp: MultiEvalInputs, cand_rows, cand_valid,
                               round_size: int, n_lanes: int):
    """Lane-parallel multi-eval placement over per-signature compact
    candidate frames (reference: select.place_multi_compact_packed):
    (buf_small [T*L, FILL_K + 16], fills_full [T*L, round_size],
    used [N, 3]).  CPU tensors take the plain version; CUDA tensors
    launch K1 and K2 (or raise).  `inp.used0` is not modified."""
    if inp.attrs.device.type == "cpu":
        return place_multi_compact_packed_plain(inp, cand_rows, cand_valid,
                                                round_size, n_lanes)
    K.count_eager("compact_used0_clone")
    return _compact_launch(inp.used0.clone(), inp.used0, inp, cand_rows,
                           cand_valid, round_size, n_lanes)


def place_multi_compact_chained(used0: torch.Tensor, inp: MultiEvalInputs,
                                cand_rows, cand_valid, round_size: int,
                                n_lanes: int):
    """`place_multi_compact_packed` from a dead `used0` buffer that is
    updated in place and returned (the reference's donated argument)."""
    if used0.device.type == "cpu":
        buf, fills, used = place_multi_compact_packed_plain(
            inp._replace(used0=used0), cand_rows, cand_valid, round_size,
            n_lanes)
        used0.copy_(used)
        return buf, fills, used0
    return _compact_launch(used0, used0, inp, cand_rows, cand_valid,
                           round_size, n_lanes)


# ------------------------------------------------------ solo: exact scan

class PlacementInputs(NamedTuple):
    """Device inputs for one eval's placement batch (field meanings and
    shapes as the reference's select.PlacementInputs).  `spread_algo` is
    a Python bool and `seed` a Python int (uint32 value, 0 = no
    tie-break noise); `extra_mask` is an optional [G, N] bool AND-mask
    (the host's device-instance feasibility)."""
    attrs: torch.Tensor       # [N, A] int32
    cap: torch.Tensor         # [N, 3] int32
    used0: torch.Tensor       # [N, 3] int32
    elig: torch.Tensor        # [N] bool
    dc_mask: torch.Tensor     # [N] bool
    pool_mask: torch.Tensor   # [N] bool
    luts: torch.Tensor        # [L, V] bool
    con: torch.Tensor         # [G, C, 3] int32
    aff: torch.Tensor         # [G, Af, 4] int32
    req: torch.Tensor         # [G, 3] int32
    desired: torch.Tensor     # [G] int32
    dh_limit: torch.Tensor    # [G] int32 (0 = no distinct_hosts)
    sp_nodeval: torch.Tensor  # [S, N] int32 (-1 = not a target)
    sp_weight: torch.Tensor   # [S] float32 (0 = padding)
    sp_expected: torch.Tensor  # [S, K] float32
    sp_counts0: torch.Tensor  # [S, K] float32
    pd_nodeval: torch.Tensor  # [D, N] int32 (-1 = unset)
    pd_limit: torch.Tensor    # [D] int32 (0 = inert padding row)
    pd_apply: torch.Tensor    # [G, D] bool
    pd_counts0: torch.Tensor  # [D, Kd] int32
    tg_idx: torch.Tensor      # [P] int32
    prev_row: torch.Tensor    # [P] int32 (-1 = not a reschedule)
    active: torch.Tensor      # [P] bool (padding rows False)
    job_count0: torch.Tensor  # [N] int32
    spread_algo: bool
    seed: int = 0
    extra_mask: Optional[torch.Tensor] = None


class PlacementOutputs(NamedTuple):
    picks: torch.Tensor        # [P] int32 node row or -1
    scores: torch.Tensor       # [P] float32 final score of the pick
    topk_rows: torch.Tensor    # [P, k] int32
    topk_scores: torch.Tensor  # [P, k] float32
    n_feasible: torch.Tensor   # [P] int32
    n_filtered: torch.Tensor   # [P] int32
    n_exhausted: torch.Tensor  # [P] int32
    dim_exhausted: torch.Tensor  # [P, 3] int32
    used: torch.Tensor         # [N, 3] final proposed usage
    job_count: torch.Tensor    # [N] final job counts


class StepStatics(NamedTuple):
    """Loop-invariant per-eval tensors of the scan."""
    static: torch.Tensor   # [G, N] feasibility
    aff_sc: torch.Tensor   # [G, N]
    aff_any: torch.Tensor  # [G]
    sp_any: torch.Tensor   # []
    capf: torch.Tensor     # [N, 3] float32
    noise: torch.Tensor    # [N]
    rows: torch.Tensor     # [N] node row ids


def _seed_t(seed: int, device) -> torch.Tensor:
    return torch.tensor(int(seed) & _U32, dtype=torch.int64, device=device)


def scan_statics(inp: PlacementInputs, rows: torch.Tensor) -> StepStatics:
    """Plain statics: feasibility ([G, N], ANDed with `extra_mask`),
    affinity, and the tie-break noise over `rows`."""
    static = feasible_mask_plain(inp.attrs, inp.elig, inp.dc_mask,
                                 inp.pool_mask, inp.con, inp.luts)
    if inp.extra_mask is not None:
        static = static & inp.extra_mask
    return StepStatics(
        static=static,
        aff_sc=affinity_score(inp.attrs, inp.aff, inp.luts),
        aff_any=(inp.aff[..., 3] != 0).any(dim=1),
        sp_any=(inp.sp_weight > 0).any(),
        capf=inp.cap.to(torch.float32),
        noise=tiebreak_noise(_seed_t(inp.seed, rows.device), rows),
        rows=rows)


def step_scores(inp: PlacementInputs, st: StepStatics, carry, g: int,
                prev: int):
    """Scoring core of one scan step (reference: select.step_scores):
    (feas, final, stat_g, fit, dh_ok) over every node row."""
    used, job_count, sp_counts, pd_counts = carry
    n = st.rows.shape[0]
    req_g = inp.req[g]
    stat_g = st.static[g]
    fit = capacity_fit(inp.cap, used, req_g)
    dh = inp.dh_limit[g]
    dh_ok = torch.where(dh > 0, job_count < dh, True)
    kd = pd_counts.shape[1]
    pd_val = inp.pd_nodeval.long().clamp(0, kd - 1)
    pd_cnt = pd_counts.gather(1, pd_val)
    pd_row_ok = (pd_cnt < inp.pd_limit[:, None]) & (inp.pd_nodeval >= 0)
    pd_applies = inp.pd_apply[g] & (inp.pd_limit > 0)
    pd_ok = torch.where(pd_applies[:, None], pd_row_ok, True).all(dim=0)
    feas = stat_g & fit & dh_ok & pd_ok

    # `/ 18.0` in the reference, a multiply by f32(1/18) under XLA
    bp = binpack_score(st.capf, used.to(torch.float32),
                       req_g.to(torch.float32),
                       inp.spread_algo) * _INV18.to(st.capf.device)
    aa = job_anti_affinity(job_count, inp.desired[g])
    is_prev = st.rows == prev
    rp = torch.where(is_prev, -1.0, 0.0)
    af = st.aff_sc[g]
    sp = spread_boost(inp.sp_nodeval, inp.sp_weight, inp.sp_expected,
                      sp_counts)
    ones = torch.ones(n, dtype=torch.bool, device=st.rows.device)
    final = normalize_scores(
        [bp, aa, rp, af, sp],
        [ones, job_count > 0, is_prev, st.aff_any[g].expand(n),
         st.sp_any.expand(n)])
    return feas, final, stat_g, fit, dh_ok


def top_k_select(keys: torch.Tensor, final: torch.Tensor, seed):
    """One step's top rows (node rows, `keys` = masked score + noise
    descending, lower row first among ties) and their reported scores
    (`final`, NEG_INF where the key is infeasible)."""
    top_rows = torch.sort(keys, descending=True,
                          stable=True).indices[:min(TOP_K, keys.shape[0])]
    top_sc = torch.where(keys[top_rows] > NEG_INF / 2, final[top_rows],
                         NEG_INF)
    return top_rows, top_sc


def place_plain(inp: PlacementInputs,
                select=top_k_select) -> PlacementOutputs:
    """Plain version of K5's scan (reference: select.place): one
    placement per step, each seeing the state every earlier placement
    committed.  `select(keys, final, seed)` picks each step's top rows
    (the sharded scan passes parallel.mesh's two-stage top-k)."""
    n = inp.attrs.shape[0]
    dev = inp.attrs.device
    seed = _seed_t(inp.seed, dev)
    st = scan_statics(inp, torch.arange(n, device=dev))
    used = inp.used0.clone()
    job_count = inp.job_count0.clone()
    sp_counts = inp.sp_counts0.clone()
    pd_counts = inp.pd_counts0.clone()
    s_idx = torch.arange(sp_counts.shape[0], device=dev)
    d_idx = torch.arange(pd_counts.shape[0], device=dev)
    cols = []
    for g, prev, act in zip(inp.tg_idx.tolist(), inp.prev_row.tolist(),
                            inp.active.tolist()):
        feas, final, stat_g, fit, dh_ok = step_scores(
            inp, st, (used, job_count, sp_counts, pd_counts), g, prev)
        req_g = inp.req[g]
        masked = torch.where(feas, final, NEG_INF)
        top_rows, top_sc = select(masked + st.noise, final, seed)
        ok = bool(act) and float(top_sc[0]) > NEG_INF / 2
        pick = int(top_rows[0]) if ok else -1

        # metrics, on the usage before this step's commit
        exhausted = stat_g & (~fit | ~dh_ok)
        over = used + req_g[None, :] > inp.cap
        dim_ex = ((stat_g & ~fit)[:, None] & over).sum(dim=0)
        cols.append((
            torch.tensor([pick], dtype=torch.int32, device=dev),
            top_sc[:1] if ok else torch.zeros(1, device=dev),
            (top_rows if ok else torch.full_like(top_rows, -1))[None],
            (top_sc if ok else torch.zeros_like(top_sc))[None],
            feas.sum()[None], (~stat_g).sum()[None], exhausted.sum()[None],
            dim_ex[None]))
        if ok:
            used[pick] += req_g
            job_count[pick] += 1
            val = inp.sp_nodeval[:, pick].long()
            hit = val >= 0
            sp_counts.index_put_(
                (s_idx[hit], val[hit].clamp(0, sp_counts.shape[1] - 1)),
                torch.ones((), device=dev), accumulate=True)
            val = inp.pd_nodeval[:, pick].long()
            hit = (val >= 0) & inp.pd_apply[g]
            pd_counts.index_put_(
                (d_idx[hit], val[hit].clamp(0, pd_counts.shape[1] - 1)),
                torch.ones((), dtype=pd_counts.dtype, device=dev),
                accumulate=True)
    out = [torch.cat(c, dim=0) for c in zip(*cols)]
    i32 = [o.to(torch.int32) for o in out[4:]]
    return PlacementOutputs(
        picks=out[0], scores=out[1].to(torch.float32),
        topk_rows=out[2].to(torch.int32),
        topk_scores=out[3].to(torch.float32), n_feasible=i32[0],
        n_filtered=i32[1], n_exhausted=i32[2], dim_exhausted=i32[3],
        used=used, job_count=job_count)


def place(inp: PlacementInputs) -> PlacementOutputs:
    """The exact scan with per-placement outputs (reference:
    select.place / place_jit).  CPU tensors take the plain version
    (`place_plain`); CUDA tensors launch K1 and K5 through
    `_scan_launch` (or raise), whose [P, 14] buffer `unpack_outputs`
    splits: the plain step loop never runs on the card here."""
    if inp.attrs.device.type == "cpu":
        return place_plain(inp)
    return unpack_outputs(*_scan_launch(inp))


def pack_outputs(out: PlacementOutputs):
    """One int32 buffer [P, 14] (floats bitcast): 0 pick | 1 score |
    2-4 topk_rows | 5-7 topk_scores | 8 n_feasible | 9 n_filtered |
    10 n_exhausted | 11-13 dim_exhausted.  Returns (buf, used,
    job_count)."""
    p, top_k = out.topk_rows.shape
    dev = out.picks.device
    f2i = lambda x: x.to(torch.float32).contiguous().view(torch.int32)
    buf = torch.cat([
        out.picks[:, None], f2i(out.scores)[:, None],
        out.topk_rows,
        torch.full((p, 3 - top_k), -1, dtype=torch.int32, device=dev),
        f2i(out.topk_scores),
        torch.zeros((p, 3 - top_k), dtype=torch.int32, device=dev),
        out.n_feasible[:, None], out.n_filtered[:, None],
        out.n_exhausted[:, None], out.dim_exhausted,
    ], dim=1).to(torch.int32)
    return buf, out.used, out.job_count


def unpack_outputs(buf: torch.Tensor, used: torch.Tensor,
                   job_count: torch.Tensor) -> PlacementOutputs:
    """The inverse of `pack_outputs` for N rows: the top lists keep
    min(3, N) columns, as `place` reports them."""
    top_k = min(TOP_K, used.shape[0])
    i2f = lambda x: x.contiguous().view(torch.float32)
    return PlacementOutputs(
        picks=buf[:, 0].contiguous(), scores=i2f(buf[:, 1]),
        topk_rows=buf[:, 2:2 + top_k].contiguous(),
        topk_scores=i2f(buf[:, 5:5 + top_k]),
        n_feasible=buf[:, 8].contiguous(), n_filtered=buf[:, 9].contiguous(),
        n_exhausted=buf[:, 10].contiguous(),
        dim_exhausted=buf[:, 11:14].contiguous(), used=used,
        job_count=job_count)


def _solo_statics(attrs, elig, dc_mask, pool_mask, con, aff, luts,
                  extra_mask):
    """The solo kernels' statics: K8's [G, N] static mask (`extra_mask`
    ANDed in) and K1's [G, N] affinity."""
    static = feasible_mask(attrs, elig, dc_mask, pool_mask, con, luts)
    if extra_mask is not None:
        static = static & extra_mask
    return static, affinity_landscape(attrs, aff, luts)


_SCAN_I32 = ("cap", "used0", "con", "aff", "req", "desired", "dh_limit",
             "sp_nodeval", "pd_nodeval", "pd_limit", "pd_counts0", "tg_idx",
             "prev_row", "job_count0", "attrs")
_SCAN_F32 = ("sp_weight", "sp_expected", "sp_counts0")
_SCAN_BOOL = ("elig", "dc_mask", "pool_mask", "luts", "pd_apply", "active")


def _check_inputs(name: str, inp, i32, f32=(), bools=()) -> None:
    """Dtypes first, then one CUDA device and contiguity, for every
    tensor field of a solo kernel's inputs."""
    for keys, dtype in ((i32, torch.int32), (f32, torch.float32),
                        (bools, torch.bool)):
        for key in keys:
            K.check_dtype(f"{name}.{key}", getattr(inp, key), dtype)
    if getattr(inp, "extra_mask", None) is not None:
        K.check_dtype(f"{name}.extra_mask", inp.extra_mask, torch.bool, 2)
    K.check_cuda(name, **{f: v for f, v in zip(inp._fields, inp)
                          if isinstance(v, torch.Tensor)})


def _scan_launch(inp: PlacementInputs, n_shards: int = 0, prof=None,
                 nt: int = 0, xp=None):
    """K1 statics + one K5 launch (K9 with `n_shards`: one cluster of
    that many blocks, each keeping its own spread and distinct counts).
    With `prof` (int64 [18] on the card; [34] with `xp`, the exchange's
    sub-phases after it) the PROF instantiation runs instead, with `nt`
    threads a block (0: as the main path chooses), and writes block 0's
    phase split there (chip_smoke.py).  With `xp` (an XPart) the launch
    is one part's K9 of a mesh across parts over its own rows, its
    buffer None but on part 0."""
    kern = (K.PLACE_SCAN_XMESH if xp is not None
            else K.PLACE_SCAN_SHARDED if n_shards else K.PLACE_SCAN)
    name = kern.name
    n = inp.attrs.shape[0]
    _check_shards(name, n, n_shards)
    _check_inputs(name, inp, _SCAN_I32, _SCAN_F32, _SCAN_BOOL)
    g = inp.req.shape[0]
    s, k = inp.sp_counts0.shape
    d, kd = inp.pd_counts0.shape
    p = inp.tg_idx.shape[0]
    if (inp.cap.shape != (n, 3) or inp.used0.shape != (n, 3)
            or inp.job_count0.shape != (n,) or inp.con.shape[0] != g
            or inp.aff.shape[0] != g or inp.sp_nodeval.shape != (s, n)
            or inp.sp_weight.shape != (s,) or inp.sp_expected.shape != (s, k)
            or inp.pd_nodeval.shape != (d, n) or inp.pd_limit.shape != (d,)
            or inp.pd_apply.shape != (g, d) or inp.prev_row.shape != (p,)
            or inp.active.shape != (p,) or n == 0
            or (inp.extra_mask is not None
                and inp.extra_mask.shape != (g, n))):
        raise ValueError(f"{name}: inconsistent shapes")
    dev = inp.attrs.device
    static, aff_sc = _solo_statics(inp.attrs, inp.elig, inp.dc_mask,
                                   inp.pool_mask, inp.con, inp.aff,
                                   inp.luts, inp.extra_mask)
    aff_any = (inp.aff[..., 3] != 0).any(dim=1)
    used = inp.used0.clone()
    job_count = inp.job_count0.clone()
    buf = (torch.empty((p, 14), dtype=torch.int32, device=dev)
           if xp is None or xp.part == 0 else None)
    if not p:
        return buf, used, job_count
    # the kernel's caches, counts and group statics (csrc/place_scan.cu
    # scan_layout), one copy of the state per block
    words = kern.fn("place_scan_scratch_words")(n, g, s, k, d, kd, n_shards)
    if words < 0:
        raise ValueError(f"{name}: scratch of {g} x {n} nodes too large")
    scratch = torch.empty(words, dtype=torch.int32, device=dev)
    tail = [n_shards] if n_shards else []
    if xp is not None:
        tail += [xp.part, xp.n_parts, xp.buf, xp.deadline, xp.sys_scope]
    symbol = name
    if prof is not None:
        symbol = name + "_prof"
        tail += [nt, prof.data_ptr()]
    args = (inp.cap, used, static, aff_sc, aff_any, inp.req, inp.desired,
            inp.dh_limit, inp.sp_nodeval, inp.sp_weight, inp.sp_expected,
            inp.sp_counts0, inp.pd_nodeval, inp.pd_limit, inp.pd_apply,
            inp.pd_counts0, inp.tg_idx, inp.prev_row, inp.active,
            job_count, buf, scratch)
    _launch(
        kern, xp, args, dev.index, symbol,
        *[None if t is None else t.data_ptr() for t in args],
        n, g, s, k, d, kd, p, int(bool(inp.spread_algo)),
        int(inp.seed) & _U32, *tail)
    return buf, used, job_count


def place_packed(inp: PlacementInputs):
    """`place` packed (reference: select.place_packed): (buf [P, 14],
    used [N, 3], job_count [N]).  CPU tensors take the plain version;
    CUDA tensors launch K1 and K5 (or raise).  `inp` is not modified."""
    if inp.attrs.device.type == "cpu":
        return pack_outputs(place_plain(inp))
    return _scan_launch(inp)


# ------------------------------------------------------ solo: bulk rounds

class BulkInputs(NamedTuple):
    """Inputs of the bulk rounds for one task group `g` (reference:
    select.BulkInputs): no per-placement arrays and no spread or
    distinct state; `p_real` placements form a prefix of the padded
    batch.  `spread_algo`, `g`, `p_real` and `seed` are Python values."""
    attrs: torch.Tensor       # [N, A] int32
    cap: torch.Tensor         # [N, 3] int32
    used0: torch.Tensor       # [N, 3] int32
    elig: torch.Tensor        # [N] bool
    dc_mask: torch.Tensor     # [N] bool
    pool_mask: torch.Tensor   # [N] bool
    luts: torch.Tensor        # [L, V] bool
    con: torch.Tensor         # [G, C, 3] int32
    aff: torch.Tensor         # [G, Af, 4] int32
    req: torch.Tensor         # [G, 3] int32
    desired: torch.Tensor     # [G] int32
    dh_limit: torch.Tensor    # [G] int32
    job_count0: torch.Tensor  # [N] int32
    spread_algo: bool
    g: int
    p_real: int
    seed: int = 0
    extra_mask: Optional[torch.Tensor] = None


def _to_bulk_inputs(inp: PlacementInputs) -> BulkInputs:
    return BulkInputs(
        attrs=inp.attrs, cap=inp.cap, used0=inp.used0, elig=inp.elig,
        dc_mask=inp.dc_mask, pool_mask=inp.pool_mask, luts=inp.luts,
        con=inp.con, aff=inp.aff, req=inp.req, desired=inp.desired,
        dh_limit=inp.dh_limit, job_count0=inp.job_count0,
        spread_algo=inp.spread_algo, g=int(inp.tg_idx[0]),
        p_real=int(inp.active.sum()), seed=inp.seed,
        extra_mask=inp.extra_mask)


def bulk_want(p_real: int, round_size: int, n_rounds: int) -> list:
    """The bulk rounds' demands: clip(p_real - r round_size, 0,
    round_size) for round r (reference: select._bulk_scan)."""
    return [min(max(p_real - r * round_size, 0), round_size)
            for r in range(n_rounds)]


def bulk_as_flat(inp: BulkInputs, round_size: int,
                 n_rounds: int) -> MultiEvalInputs:
    """K6's inputs as K3's at one group (on `inp`'s device): the group's
    rows of con, aff, req, desired and dh_limit; one signature whose base
    row is dc & pool (& the group's extra_mask row); one job count row,
    carried from round to round as K6 carries it; every round of group
    0, wanting `bulk_want`; one seed.  K3 on these inputs is K6 in the
    full layout (tests/test_torch_bulk.py shows it on the reference);
    on the card K6 launches K3's flat mode through its own entry, which
    derives the round schedule from `p_real` (`_bulk_launch`)."""
    dev = inp.attrs.device
    gs = slice(inp.g, inp.g + 1)
    base = inp.dc_mask & inp.pool_mask
    if inp.extra_mask is not None:
        base = base & inp.extra_mask[inp.g]
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    return MultiEvalInputs(
        attrs=inp.attrs, cap=inp.cap, used0=inp.used0, elig=inp.elig,
        luts=inp.luts, base_mask=base[None], con=inp.con[gs], u_mask=zero,
        aff=inp.aff[gs], req=inp.req[gs], desired=inp.desired[gs],
        dh_limit=inp.dh_limit[gs], g_static=zero, g_aff=zero, g_job=zero,
        job_count0=inp.job_count0[None], spread_algo=inp.spread_algo,
        round_g=torch.zeros(n_rounds, dtype=torch.int32, device=dev),
        round_want=torch.tensor(bulk_want(inp.p_real, round_size, n_rounds),
                                dtype=torch.int32, device=dev),
        seed=torch.tensor([int(inp.seed) & _U32], dtype=torch.int64,
                          device=dev))


def _bulk_static(inp: BulkInputs, g: int):
    """Plain statics of the bulk rounds: (static [N], aff_sc [N],
    aff_any [], noise [N])."""
    full = feasible_mask_plain(inp.attrs, inp.elig, inp.dc_mask,
                               inp.pool_mask, inp.con, inp.luts)
    if inp.extra_mask is not None:
        full = full & inp.extra_mask
    n = inp.attrs.shape[0]
    rows = torch.arange(n, device=inp.attrs.device)
    return (full[g], affinity_score(inp.attrs, inp.aff, inp.luts)[g],
            (inp.aff[..., 3] != 0).any(dim=1)[g],
            tiebreak_noise(_seed_t(inp.seed, rows.device), rows))


def bulk_round_scores(inp: BulkInputs, static_t, used, job_count,
                      round_size: int):
    """round_scores_g at the bulk rounds' fixed group `inp.g`: (k_i [N],
    score [N])."""
    g = inp.g
    static, aff_sc, aff_any, _ = static_t
    k_i, score = round_scores_g(
        inp.cap[None], inp.req[g:g + 1], inp.desired[g:g + 1],
        inp.dh_limit[g:g + 1], static[None], aff_sc[None], aff_any[None],
        used[None], job_count[None], inp.spread_algo, round_size)
    return k_i[0], score[0]


def bulk_round_metrics(inp: BulkInputs, static, used, job_count):
    """round_metrics_g at the fixed group: (n_exhausted [], dim [3])."""
    g = inp.g
    n_exh, dim_ex = round_metrics_g(
        inp.cap[None], inp.req[g:g + 1], inp.dh_limit[g:g + 1],
        static[None], used[None], job_count[None])
    return n_exh[0], dim_ex[0]


def _bulk_step(inp: BulkInputs, round_size: int, top_k: int, static_t,
               carry, want: int, fill=waterfill_round):
    """One water-fill round of the bulk kernel: ((used, job_count),
    (rows_p, cnt_p, sc_p, top_rows, top_sc, n_feas, n_filt, n_exh,
    dim_ex, placed))."""
    req = inp.req[inp.g]
    static, _, _, noise = static_t
    used, job_count = carry
    k_i, score = bulk_round_scores(inp, static_t, used, job_count,
                                   round_size)
    want_t = torch.tensor([want], dtype=torch.int32, device=used.device)
    rows_p, cnt_p, sc_p, c_i, placed, k_round = fill(
        k_i[None], score[None], noise[None], want_t, inp.spread_algo,
        round_size)
    used = used + c_i[0][:, None] * req[None, :]
    job_count = job_count + c_i[0]
    top_sc = sc_p[0, :top_k]
    valid = top_sc > NEG_INF / 2
    top_rows = torch.where(valid, rows_p[0, :top_k], -1)
    top_sc = torch.where(valid, top_sc, 0.0)
    n_exh, dim_ex = bulk_round_metrics(inp, static, used, job_count)
    out = (rows_p[0], cnt_p[0], sc_p[0], top_rows, top_sc,
           (k_round[0] > 0).sum(), (~static).sum(), n_exh, dim_ex,
           placed[0])
    return (used, job_count), out


def _bulk_scan(inp: BulkInputs, round_size: int, n_rounds: int,
               top_k: int, fill=waterfill_round):
    """All rounds; the demand of round r is clip(p_real - r * round_size,
    0, round_size).  Returns ((used, job_count), stacked outputs)."""
    static_t = _bulk_static(inp, inp.g)
    carry = (inp.used0, inp.job_count0)
    outs = []
    for want in bulk_want(inp.p_real, round_size, n_rounds):
        carry, out = _bulk_step(inp, round_size, top_k, static_t, carry,
                                want, fill)
        outs.append(out)
    return carry, [torch.stack(c) for c in zip(*outs)]


def _check_bulk(n: int, round_size: int, with_scores: bool,
                fill_k: int) -> None:
    _check_rounds(n, round_size)
    if with_scores and fill_k:
        raise ValueError("scores need the full slot layout")


def place_bulk_packed_plain(inp: BulkInputs, round_size: int,
                            n_rounds: int, with_scores: bool = False,
                            fill_k: int = 0, fill=waterfill_round):
    """Plain version of K6: (buf [R, round_size + 16], used, job_count);
    with `with_scores` the buffer carries a bitcast score block before
    the meta ([R, 2 * round_size + 16]); with `fill_k` it is
    (buf_small [R, fill_k' + 16], fills [R, round_size], used,
    job_count), fill_k' = min(fill_k, round_size).  `fill` as in
    `place_multi_packed_plain`."""
    n = inp.attrs.shape[0]
    _check_bulk(n, round_size, with_scores, fill_k)
    (used, job_count), outs = _bulk_scan(inp, round_size, n_rounds,
                                         min(TOP_K, n), fill)
    (rows_p, cnt_p, sc_p, top_rows, top_sc, n_feas, n_filt, n_exh,
     dim_ex, placed) = outs
    fills, meta = pack_round_buffer(rows_p, cnt_p, top_rows, top_sc,
                                    n_feas, n_filt, n_exh, dim_ex, placed)
    if fill_k:
        buf_small = torch.cat([fills[:, :min(fill_k, round_size)], meta],
                              dim=1)
        return buf_small, fills, used, job_count
    parts = [fills]
    if with_scores:
        parts.append(sc_p.to(torch.float32).contiguous().view(torch.int32))
    buf = torch.cat(parts + [meta], dim=1)
    return buf, used, job_count


# K6's tensor fields: (field, dtype, rank), checked in one lean pass
_BULK_SPECS = (("attrs", torch.int32, 2), ("cap", torch.int32, 2),
               ("used0", torch.int32, 2), ("elig", torch.bool, 1),
               ("dc_mask", torch.bool, 1), ("pool_mask", torch.bool, 1),
               ("luts", torch.bool, 2), ("con", torch.int32, 3),
               ("aff", torch.int32, 3), ("req", torch.int32, 2),
               ("desired", torch.int32, 1), ("dh_limit", torch.int32, 1),
               ("job_count0", torch.int32, 1))


def _bulk_launch(inp: BulkInputs, round_size: int, n_rounds: int,
                 with_scores: bool, fill_k: int, n_shards: int = 0,
                 prof=None, xp=None):
    """K8's static row and K1's affinity of group g, then one K6 launch:
    K3's flat mode at one group (csrc/compact_rounds.cu `multi_bulk`,
    `bulk_as_flat`'s identity), which derives each round's demand from
    `p_real`; K10 with `n_shards` (`multi_bulk_sharded`, full layout
    only).  The group's `extra_mask` row is ANDed into the static row
    here (one counted eager op; the engine sends no mask on this path).
    The kernel reads `inp.used0` and writes every row of a fresh usage.
    `prof` and `xp` (K10 on a mesh across parts: full layout, the buffer
    None but on part 0) as in `_flat_mode_launch`."""
    kern = (K.MULTI_BULK_XMESH if xp is not None
            else K.MULTI_BULK_SHARDED if n_shards else K.MULTI_BULK)
    name = kern.name
    specs = [(f, getattr(inp, f), dtype, ndim)
             for f, dtype, ndim in _BULK_SPECS]
    if inp.extra_mask is not None:
        specs.append(("extra_mask", inp.extra_mask, torch.bool, 2))
    K.check_launch(name, specs)
    n = inp.attrs.shape[0]
    _check_bulk(n, round_size, with_scores, fill_k)
    _check_shards(name, n, n_shards)
    if (n_shards or xp is not None) and (with_scores or fill_k):
        raise ValueError(f"{name}: the sharded bulk rounds have the full "
                         "layout only")
    g = inp.g
    if (inp.cap.shape != (n, 3) or inp.used0.shape != (n, 3)
            or inp.job_count0.shape != (n,)
            or not 0 <= g < inp.req.shape[0] or inp.p_real < 0
            or (inp.extra_mask is not None
                and inp.extra_mask.shape != (inp.req.shape[0], n))):
        raise ValueError(f"{name}: inconsistent shapes")
    dev = inp.attrs.device
    gs = slice(g, g + 1)
    aff = inp.aff[gs]
    extra = None
    if inp.extra_mask is not None:
        K.count_eager("bulk_extra_mask")
        extra = inp.extra_mask[gs]
    static, aff_sc = _solo_statics(inp.attrs, inp.elig, inp.dc_mask,
                                   inp.pool_mask, inp.con[gs], aff,
                                   inp.luts, extra)
    slot_k = min(fill_k, round_size) if fill_k else round_size
    width = slot_k + (round_size if with_scores else 0) + 16
    buf = (inp.used0.new_empty((n_rounds, width))
           if xp is None or xp.part == 0 else None)
    fills = (inp.used0.new_empty((n_rounds, round_size)) if fill_k
             else None)
    used = torch.empty_like(inp.used0)
    jc = torch.empty_like(inp.job_count0)
    if n_rounds:
        _flat_mode_launch(kern, dev, n, round_size, [
            inp.cap.data_ptr(), inp.used0.data_ptr(), used.data_ptr(),
            static.data_ptr(), aff_sc.data_ptr(), aff.data_ptr(), inp.req[g].data_ptr(),
            inp.desired[g].data_ptr(), inp.dh_limit[g].data_ptr(),
            inp.job_count0.data_ptr(),
            None if buf is None else buf.data_ptr(),
            None if fills is None else fills.data_ptr(), jc.data_ptr(), n,
            aff.shape[1], n_rounds, int(bool(inp.spread_algo)), round_size,
            slot_k, int(bool(with_scores)), inp.p_real,
            int(inp.seed) & _U32], n_shards, prof, xp,
            (inp, static, aff_sc, aff, used, buf, fills, jc))
    else:
        used.copy_(inp.used0)
        jc.copy_(inp.job_count0)
    if fill_k:
        return buf, fills, used, jc
    return buf, used, jc


def place_bulk_packed(inp: BulkInputs, round_size: int, n_rounds: int,
                      with_scores: bool = False, fill_k: int = 0):
    """Bulk water-fill rounds for one task group with packed per-round
    outputs (reference: select.place_bulk_packed; layouts on
    `place_bulk_packed_plain`).  CPU tensors take the plain version;
    CUDA tensors launch K1 and K6 (or raise).  `inp` is not modified."""
    if inp.attrs.device.type == "cpu":
        return place_bulk_packed_plain(inp, round_size, n_rounds,
                                       with_scores, fill_k)
    return _bulk_launch(inp, round_size, n_rounds, with_scores, fill_k)


def place_bulk(inp: PlacementInputs, round_size: int) -> PlacementOutputs:
    """Homogeneous batch in rounds, expanded to per-placement outputs
    (reference: select.place_bulk): the packed buffer with scores,
    each round's fills expanded in fill order (placements of a round are
    interchangeable) and its metrics repeated over its placements."""
    n = inp.attrs.shape[0]
    p_pad = inp.tg_idx.shape[0]
    if p_pad % round_size:
        raise ValueError("the padded batch must be whole rounds")
    n_rounds = p_pad // round_size
    buf, used, job_count = place_bulk_packed(
        _to_bulk_inputs(inp), round_size, n_rounds, with_scores=True)
    top_k = min(TOP_K, n)
    fills = buf[:, :round_size]
    sc_r = buf[:, round_size:2 * round_size].contiguous().view(
        torch.float32)
    meta = buf[:, 2 * round_size:]
    rows_r = fills >> 11
    cnt_r = fills & 2047
    placed = meta[:, 12]
    edges = torch.cumsum(cnt_r, dim=1)
    p_idx = torch.arange(round_size, device=buf.device).expand(
        n_rounds, round_size).contiguous()
    slot = torch.searchsorted(edges, p_idx, right=True).clamp(
        0, round_size - 1)
    picks = torch.where(p_idx < placed[:, None], rows_r.gather(1, slot), -1)
    scores = torch.where(picks >= 0, sc_r.gather(1, slot), 0.0)

    def rep(x):
        return x.repeat_interleave(round_size, dim=0)

    return PlacementOutputs(
        picks=picks.reshape(p_pad).to(torch.int32),
        scores=scores.reshape(p_pad),
        topk_rows=rep(meta[:, 0:top_k]),
        topk_scores=rep(meta[:, 3:3 + top_k].contiguous().view(
            torch.float32)),
        n_feasible=rep(meta[:, 6]), n_filtered=rep(meta[:, 7]),
        n_exhausted=rep(meta[:, 8]), dim_exhausted=rep(meta[:, 9:12]),
        used=used, job_count=job_count)
