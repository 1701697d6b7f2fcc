"""Preemption, host part (reference: nomad_tpu/ops/preempt.py).

When normal placement fails and preemption is enabled for the job's
scheduler type, lower-priority allocs are evicted to make room:

  - only allocs whose job priority is strictly lower than the preempting
    job's priority are candidates;
  - node choice minimizes the aggregate priority/resources disturbed;
  - per node, eviction is greedy: lowest priority first, and within a
    priority band the alloc whose resources best match the remaining
    shortfall (basicResourceDistance).

Two implementations share the packed victim tables:

  - `preempt_bulk`, kernel K7 (`csrc/preempt.cu`): every failed placement
    of a homogeneous batch resolves in ONE launch.  A step computes, for
    every candidate node, the eviction count that fits the ask (prefix
    sums over the priority-sorted victim table) and its priority-weighted
    cost, picks the cheapest node (lowest row on ties) and commits, so
    later placements see earlier evictions.  `preempt_bulk_plain` is its
    plain version.  A step changes its chosen row only, and a row's
    consumed victims are always a prefix of its table
    (tests/test_torch_preempt.py), so the kernel caches every row's key
    and recomputes one row a step.
  - `Preemptor`, the host implementation for the long tail (deep victim
    tables, heterogeneous asks, leftovers of the kernel).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from nomad_tpu_torch.structs import (
    Allocation,
    Job,
    JOB_TYPE_BATCH,
    JOB_TYPE_SERVICE,
    JOB_TYPE_SYSBATCH,
    JOB_TYPE_SYSTEM,
    PreemptionConfig,
    SchedulerConfiguration,
)

from .kernels import PREEMPT_BULK, check_launch, count_eager
from .scoring import fmaf

# victim-table depth: nodes with more evictable allocs are truncated to
# their MAX_VICTIMS lowest-priority ones
MAX_VICTIMS = 32
BIG_COST = 1e30
# XLA's CPU backend computes a cumulative sum longer than this in blocks
# of this length: each block sequentially, then the blocks' running sums
# added on (its reduce-window rewrite)
_XLA_SCAN_BLOCK = 16
_I32 = torch.int32


def build_victim_tables(job: Job, snapshot, tensors
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                   Dict[int, list]]:
    """Pack evictable allocs (priority < job.priority, not the same job)
    into COMPACT priority-sorted tables covering only candidate nodes —
    nodes with at least one victim.  The depth axis sizes to the deepest
    candidate on a pow2 ladder (capped at MAX_VICTIMS), so the device
    upload is O(candidates x actual depth), not O(cluster x 32): the
    homogeneous one-victim-per-node shape at 50k nodes is [50k, 1]
    (~800KB) instead of the [50k, 32] (~25MB) that previously forced the
    8192-node cap.

    Returns (cand_rows [M] int32 — tensor row per table row, prio [M,A],
    res [M,A,3], allocs {TENSOR row: [Allocation in sorted order]}).
    Padding entries carry prio=2^30, res=0 — they can never help fill an
    ask."""
    by_row: Dict[int, list] = {}
    my_prio = job.priority
    deepest = 1
    for row, node_id in enumerate(tensors.node_ids):
        lst = []
        for a in snapshot.allocs_by_node(node_id):
            if a.terminal_status():
                continue
            p = a.job.priority if a.job is not None else 50
            if p >= my_prio or a.job_id == job.id:
                continue
            lst.append((p, a))
        if not lst:
            continue
        lst.sort(key=lambda t: t[0])
        lst = lst[:MAX_VICTIMS]
        by_row[row] = [a for _, a in lst]
        deepest = max(deepest, len(lst))
    a_eff = 1
    while a_eff < deepest:
        a_eff *= 2
    m = len(by_row)
    cand_rows = np.fromiter(by_row.keys(), np.int32, m)
    prio = np.full((m, a_eff), 1 << 30, np.int32)
    res = np.zeros((m, a_eff, 3), np.int32)
    for ci, (row, allocs) in enumerate(by_row.items()):
        for i, a in enumerate(allocs):
            prio[ci, i] = (a.job.priority if a.job is not None else 50)
            res[ci, i] = (a.resources.cpu, a.resources.memory_mb,
                          a.resources.disk_mb)
    return cand_rows, prio, res, by_row


def xla_cumsum(x: torch.Tensor) -> torch.Tensor:
    """float32 cumulative sum over the last axis in the order XLA's CPU
    backend sums it (reference: `jnp.cumsum` in preempt_bulk): up to 16
    terms from 0 in order; longer rows in blocks of 16, each block in
    order from 0, then the sum of the earlier blocks (itself summed in
    order from 0) added to every element of a block."""
    a = x.shape[-1]
    if a <= _XLA_SCAN_BLOCK:
        acc = torch.zeros_like(x[..., 0])
        outs = []
        for i in range(a):
            acc = acc + x[..., i]
            outs.append(acc)
        return torch.stack(outs, dim=-1)
    if a % _XLA_SCAN_BLOCK or a > _XLA_SCAN_BLOCK ** 2:
        raise ValueError(f"no XLA scan order for a row of {a}")
    blocks = xla_cumsum(x.reshape(x.shape[:-1] + (-1, _XLA_SCAN_BLOCK)))
    carry = torch.zeros_like(blocks[..., 0, -1])
    outs = []
    for b in range(blocks.shape[-2]):
        outs.append(blocks[..., b, :] + carry[..., None])
        carry = carry + blocks[..., b, -1]
    return torch.cat(outs, dim=-1)


def preempt_bulk_plain(cap, used0, static_g, dh_limit_g: int, job_count0,
                       pre_prio, pre_res, req, k0, n_place: int,
                       n_real: int):
    """Plain version of K7 (reference: preempt.preempt_bulk): resolve up
    to `n_real` (<= n_place) failed placements by eviction over M
    candidate rows.  `k0` [M] counts victims already consumed by earlier
    launches of the eval.  Returns (best_rows [n_place], k_counts
    [n_place], used [M, 3], job_count [M]); best_rows[i] = -1 when
    nothing makes placement i fit (or i is padding)."""
    dev = cap.device
    a = pre_prio.shape[1]
    # (prio + 1) * 1000 + resource sum: XLA contracts it into one fma
    vic_cost = fmaf(pre_prio.to(torch.float32) + 1.0, 1000.0,
                    pre_res.sum(dim=2).to(torch.float32))     # [M, A]
    used = used0.clone()
    job_count = job_count0.clone()
    consumed = torch.arange(a, device=dev)[None, :] < k0[:, None]
    pos = torch.arange(a, device=dev)
    best_out, k_out = [], []
    for idx in range(n_place):
        alive = ~consumed
        freed = torch.cumsum(pre_res * alive[..., None], dim=1)  # [M, A, 3]
        free = (cap - used)[:, None, :]
        ok_k = (free + freed >= req[None, None, :]).all(dim=2)
        any_ok = ok_k.any(dim=1)
        k_idx = torch.where(any_ok, ok_k.to(torch.int8).argmax(dim=1), 0)
        cost_pfx = xla_cumsum(torch.where(alive, vic_cost, 0.0))
        cost = cost_pfx.gather(1, k_idx[:, None])[:, 0]
        dh_ok = (job_count < dh_limit_g if dh_limit_g > 0
                 else torch.ones_like(any_ok))
        cost = torch.where(static_g & any_ok & dh_ok, cost, BIG_COST)
        best = int(torch.nonzero(cost == cost.min())[0, 0])
        ok = float(cost[best]) < BIG_COST / 2 and idx < n_real
        take = alive[best] & (pos <= k_idx[best])
        if ok:
            consumed[best] |= take
            used[best] += req - (pre_res[best] * take[:, None]).sum(dim=0)
            job_count[best] += 1
        best_out.append(best if ok else -1)
        k_out.append(int(take.sum()) if ok else 0)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    return i32(best_out), i32(k_out), used, job_count


def preempt_bulk(cap, used0, static_g, dh_limit_g: int, job_count0,
                 pre_prio, pre_res, req, k0, n_place: int, n_real: int,
                 prof=None):
    """Device preemption for one task group's failed placements (see
    `preempt_bulk_plain`).  CPU tensors take the plain version; CUDA
    tensors launch K7 (or raise): it reads `used0` and `job_count0` and
    writes every row of fresh `used` and `job_count` outputs.  The inputs
    are not modified.  With `prof` (int64 [10] on the card) the PROF
    instantiation runs and writes its phase split there
    (chip_smoke.py)."""
    if cap.is_cpu:
        return preempt_bulk_plain(cap, used0, static_g, dh_limit_g,
                                  job_count0, pre_prio, pre_res, req, k0,
                                  n_place, n_real)
    name = "preempt_bulk"
    d = check_launch(name, (
        ("cap", cap, _I32, 2), ("used0", used0, _I32, 2),
        ("static_g", static_g, torch.bool, 1),
        ("job_count0", job_count0, _I32, 1), ("pre_prio", pre_prio, _I32, 2),
        ("pre_res", pre_res, _I32, 3), ("req", req, _I32, 1),
        ("k0", k0, _I32, 1)))
    m, a = pre_prio.shape
    if (cap.shape != (m, 3) or used0.shape != (m, 3)
            or static_g.shape != (m,) or job_count0.shape != (m,)
            or pre_res.shape != (m, a, 3) or req.shape != (3,)
            or k0.shape != (m,) or not 1 <= a <= MAX_VICTIMS):
        raise ValueError(f"{name}: inconsistent shapes")
    dev = cap.device
    best = torch.empty(n_place, dtype=_I32, device=dev)
    ks = torch.empty(n_place, dtype=_I32, device=dev)
    used = torch.empty_like(used0)
    job_count = torch.empty_like(job_count0)
    if not m:
        if n_place:
            count_eager("preempt_no_rows_fill")
            best.fill_(-1)
            count_eager("preempt_no_rows_zero")
            ks.zero_()
        return best, ks, used, job_count
    # the keys and (consumed, first fit) of rows past shared memory
    # (csrc/preempt.cu make_plan)
    nbytes = PREEMPT_BULK.fn("preempt_scratch_bytes")(m)
    if nbytes < 0:
        raise ValueError(f"{name}: {m} candidate rows do not fit")
    scratch = (torch.empty(nbytes, dtype=torch.uint8, device=dev)
               if nbytes else None)
    tail = [] if prof is None else [prof.data_ptr()]
    PREEMPT_BULK.launch(
        d, name if prof is None else name + "_prof",
        *[t.data_ptr() for t in (
            cap, used0, static_g, job_count0, pre_prio, pre_res, req, k0)],
        m, a, int(dh_limit_g), n_place, int(n_real),
        best.data_ptr(), ks.data_ptr(), used.data_ptr(),
        job_count.data_ptr(), None if scratch is None else scratch.data_ptr(),
        *tail)
    return best, ks, used, job_count


def preemption_enabled(cfg: SchedulerConfiguration, job_type: str) -> bool:
    """reference: SchedulerConfiguration.PreemptionConfig gates by type."""
    pc: PreemptionConfig = cfg.preemption_config
    return {
        JOB_TYPE_SYSTEM: pc.system_scheduler_enabled,
        JOB_TYPE_SYSBATCH: pc.sysbatch_scheduler_enabled,
        JOB_TYPE_BATCH: pc.batch_scheduler_enabled,
        JOB_TYPE_SERVICE: pc.service_scheduler_enabled,
    }.get(job_type, False)


def resource_distance(delta: np.ndarray, ask: np.ndarray) -> float:
    """reference: basicResourceDistance — euclidean distance between the
    remaining shortfall and a candidate alloc's resources, normalized per
    dimension."""
    num = ask.astype(np.float64)
    den = np.maximum(delta.astype(np.float64), 1.0)
    return float(np.sqrt(np.sum(((num - den) / den) ** 2)))


@dataclass
class PreemptionResult:
    node_row: int
    evictions: List[Allocation] = field(default_factory=list)


class Preemptor:
    """Per-eval preemption state over packed node tensors.

    Built lazily on the first failed placement; tracks capacity freed by
    earlier preemptions within the same plan so successive failed
    placements see each other's evictions.
    """

    def __init__(self, job: Job, snapshot, tensors, static_mask: np.ndarray,
                 used: np.ndarray, job_count: Optional[np.ndarray] = None,
                 dh_limit: Optional[np.ndarray] = None) -> None:
        self.job = job
        self.tensors = tensors
        self.static = static_mask            # [G, N] bool
        self.used = used.copy()              # [N, 3] int32 (proposed usage)
        # dynamic constraints the kernel enforces must hold here too:
        self.job_count = (job_count.copy() if job_count is not None
                          else np.zeros(tensors.n, np.int32))
        self.dh_limit = (dh_limit if dh_limit is not None
                         else np.zeros(1, np.int32))
        self.evicted_ids: set = set()
        # candidate allocs per node row: (priority, resources array, alloc)
        self.cands: Dict[int, List[Tuple[int, np.ndarray, Allocation]]] = {}
        # incrementally-maintained sum of preemptible resources per row
        self._preemptible = np.zeros((tensors.n, 3), np.int64)
        # eviction-plan cache: req-bytes -> row -> (evictions, cost).
        # Evictions are strictly row-local, so a placement invalidates
        # ONLY its chosen row — every other row's plan stays exact.  This
        # is what keeps an eval with hundreds of preempting placements
        # from re-solving every node each time.
        self._plans: Dict[bytes, Dict[int, tuple]] = {}
        self._build(snapshot)

    def _build(self, snapshot) -> None:
        t = self.tensors
        my_prio = self.job.priority
        for row, node_id in enumerate(t.node_ids):
            lst = []
            for a in snapshot.allocs_by_node(node_id):
                if a.terminal_status():
                    continue
                prio = a.job.priority if a.job is not None else 50
                if prio >= my_prio:
                    continue
                if a.job_id == self.job.id:
                    continue
                res = np.array([a.resources.cpu, a.resources.memory_mb,
                                a.resources.disk_mb], np.int64)
                lst.append((prio, res, a))
            if lst:
                self.cands[row] = lst
                self._preemptible[row] = np.sum([c[1] for c in lst], axis=0)

    # ------------------------------------------------------------- solve

    def preempt_for(self, g: int, req: np.ndarray
                    ) -> Optional[PreemptionResult]:
        """Find a node where evicting lower-priority allocs fits `req`.
        Returns None when impossible."""
        t = self.tensors
        cap = t.cap.astype(np.int64)
        used = self.used.astype(np.int64)
        fits = np.all(used - self._preemptible + req <= cap, axis=1)
        fits &= self.static[g]
        if g < len(self.dh_limit) and self.dh_limit[g] > 0:
            fits &= self.job_count < self.dh_limit[g]
        rows = np.nonzero(fits)[0]
        if rows.size == 0:
            return None
        # node choice: minimize total preempted priority-weighted resources
        # (row plans cached across placements; see _plans)
        key = req.tobytes()
        plans = self._plans.setdefault(key, {})
        best_row, best_cost, best_evict = -1, None, None
        for row in rows:
            row = int(row)
            plan = plans.get(row)
            if plan is None:
                plan = self._greedy_evict(row, req)
                plans[row] = plan
            evict, cost = plan
            if evict is None:
                continue
            if best_cost is None or cost < best_cost:
                best_row, best_cost, best_evict = row, cost, evict
        if best_evict is None:
            return None
        freed = np.zeros(3, np.int64)
        for a in best_evict:
            self.evicted_ids.add(a.id)
            res = np.array(
                [a.resources.cpu, a.resources.memory_mb, a.resources.disk_mb],
                np.int64)
            freed += res
        self.used[best_row] -= freed.astype(np.int32)
        self.used[best_row] += req.astype(np.int32)
        self.job_count[best_row] += 1
        self._preemptible[best_row] -= freed
        # only the chosen row's state changed: drop its plans (all reqs)
        for p in self._plans.values():
            p.pop(best_row, None)
        return PreemptionResult(node_row=best_row, evictions=best_evict)

    def _greedy_evict(self, row: int, req: np.ndarray):
        """Greedy eviction on one node: lowest priority first; within a
        band, best resource-distance match to the remaining shortfall."""
        t = self.tensors
        cap = t.cap[row].astype(np.int64)
        used = self.used[row].astype(np.int64)
        shortfall = used + req - cap           # per-dim overrun
        cands = [c for c in self.cands.get(row, [])
                 if c[2].id not in self.evicted_ids]
        cands.sort(key=lambda c: c[0])         # priority ascending
        evictions: List[Allocation] = []
        cost = 0.0
        while np.any(shortfall > 0):
            if not cands:
                return None, None
            lowest = cands[0][0]
            delta = np.maximum(shortfall, 0)
            # best same-priority candidate by resource distance; remove by
            # index (tuples contain numpy arrays, so list.remove would
            # attempt an ambiguous array comparison)
            best_i = min(
                (i for i, c in enumerate(cands) if c[0] == lowest),
                key=lambda i: resource_distance(delta, cands[i][1]))
            prio, res, alloc = cands.pop(best_i)
            evictions.append(alloc)
            shortfall -= res
            cost += (prio + 1) * 1000 + float(res.sum())
        return evictions, cost
