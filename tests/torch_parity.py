"""Shared builders for the PyTorch-port parity tests (tests/test_torch_*.py).

Every builder takes the package to build with (`nomad_tpu` or
`nomad_tpu_torch`) and makes the same cluster in both from explicit ids
and a seeded RNG, so the reference and the port see identical state
(`mock` mints random UUIDs otherwise, and rows follow state-store
order).
"""

import importlib
import random

import numpy as np
import pytest
import torch

PACKAGES = ("nomad_tpu", "nomad_tpu_torch")


def pkg(name: str, sub: str):
    return importlib.import_module(f"{name}.{sub}")


def harness(name: str):
    """A scheduler Harness whose engine runs on the CPU: the reference's
    single-device JAX engine (the test session exposes 8 virtual CPU
    devices, which would otherwise shard it) or the port's plain
    versions."""
    sched = pkg(name, "scheduler")
    if name == "nomad_tpu":
        from nomad_tpu.ops import PlacementEngine
        h = sched.Harness()
        h.engine = PlacementEngine(mesh=False)
        h.engine.packer.attach(h.state)
        return h
    return sched.Harness(device="cpu")


def engine(name: str):
    if name == "nomad_tpu":
        from nomad_tpu.ops import PlacementEngine
        return PlacementEngine(mesh=False)
    from nomad_tpu_torch.ops import PlacementEngine
    return PlacementEngine(device="cpu")


def build_zoned_cluster(name, n_nodes=300, n_zones=5, seed=0,
                        tiny=False):
    """Bench-shaped cluster (bench.py _build_bench_cluster at test size):
    3 DCs, per-zone CSI volumes whose topologies pin jobs to disjoint
    node sets.  `tiny` nodes hold two 100/100 asks each."""
    h = harness(name)
    add_zoned_cluster(name, h.state, n_nodes, n_zones, seed, tiny)
    return h


def add_zoned_cluster(name, state, n_nodes=300, n_zones=5, seed=0,
                      tiny=False):
    """build_zoned_cluster's nodes and volumes, into `state`."""
    mock = pkg(name, "mock")
    structs = pkg(name, "structs")
    rng = random.Random(seed)
    nodes = []
    zone_nodes = {z: [] for z in range(n_zones)}
    for i in range(n_nodes):
        n = mock.node(id=f"node-{i:05d}")
        n.datacenter = f"dc{1 + i % 3}"
        n.attributes["platform.rack"] = f"r{i % 20}"
        n.attributes["storage.topology"] = f"zone{i % n_zones}"
        n.csi_node_plugins["ebs0"] = True
        if tiny:
            n.resources.cpu = 300
            n.resources.memory_mb = 456
        else:
            n.resources.cpu = rng.choice([4000, 8000, 16000])
            n.resources.memory_mb = rng.choice([8192, 16384, 32768])
        nodes.append(n)
        zone_nodes[i % n_zones].append(n.id)
    state.upsert_nodes(nodes)
    for z in range(n_zones):
        state.upsert_csi_volume(structs.CSIVolume(
            id=f"vol-zone{z}", plugin_id="ebs0",
            access_mode="multi-node-multi-writer",
            topology_node_ids=tuple(zone_nodes[z])))


def build_flat_cluster(name, n_nodes=200, seed=0):
    """Cluster without volumes: a batch of plain jobs shares one
    signature and runs on the flat kernel."""
    mock = pkg(name, "mock")
    rng = random.Random(seed)
    h = harness(name)
    nodes = []
    for i in range(n_nodes):
        n = mock.node(id=f"node-{i:05d}")
        n.datacenter = f"dc{1 + i % 3}"
        n.resources.cpu = rng.choice([4000, 8000, 16000])
        n.resources.memory_mb = rng.choice([8192, 16384, 32768])
        nodes.append(n)
    h.state.upsert_nodes(nodes)
    return h


def add_jobs(name, h, n_items, count, zones=5, cpu=10, mem=10,
             prefix="job"):
    """Register `n_items` batch jobs of `count` placements; with `zones`
    each claims its zone's CSI volume.  Returns (jobs, BatchItems)."""
    mock = pkg(name, "mock")
    structs = pkg(name, "structs")
    BatchItem = pkg(name, "ops.engine").BatchItem
    jobs, items = [], []
    for i in range(n_items):
        job = mock.batch_job(id=f"{prefix}-{i:04d}")
        job.datacenters = ["dc1", "dc2", "dc3"]
        tg = job.task_groups[0]
        tg.count = count
        tg.tasks[0].resources.cpu = cpu
        tg.tasks[0].resources.memory_mb = mem
        if zones:
            tg.volumes = {"data": structs.VolumeRequest(
                name="data", type="csi", source=f"vol-zone{i % zones}",
                read_only=True)}
        h.state.upsert_job(job)
        jobs.append(job)
        items.append(BatchItem(job=job, tg=tg, count=count))
    return jobs, items


def set_spread(name, h):
    structs = pkg(name, "structs")
    h.state.set_scheduler_config(structs.SchedulerConfiguration(
        scheduler_algorithm=structs.SCHED_ALGO_SPREAD))


def reference_inputs_numpy(inp) -> dict:
    """The reference's MultiEvalInputs as numpy arrays by field."""
    return {name: (None if v is None else np.asarray(v))
            for name, v in zip(type(inp)._fields, inp)}


@pytest.fixture
def cuda_device():
    """The card, for tests of the CUDA kernels themselves; skips on a
    machine without one (decided here, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def make_evals(name, jobs, prefix="eval"):
    """One pending batch eval per job, with fixed ids (the per-eval
    tie-break seed is crc32 of the eval id)."""
    mock = pkg(name, "mock")
    return [mock.eval(id=f"{prefix}-{i:04d}-0000-0000-000000000000",
                      type="batch", job_id=j.id, priority=j.priority,
                      triggered_by="job-register")
            for i, j in enumerate(jobs)]


def run_batch_wave(name, h, evals, used0_dev=None):
    """The worker's batched flow through a Harness: prepare_batch per
    eval, ONE dispatch/collect, then submit_batched + finalize_batched
    per eval.  Returns (pending, decisions)."""
    import zlib
    GenericScheduler = pkg(name, "scheduler.generic").GenericScheduler
    BatchItem = pkg(name, "ops.engine").BatchItem
    snap = h.snapshot()
    now = h.clock.time()
    scheds, preps = [], []
    for ev in evals:
        s = GenericScheduler(snap, h, is_batch=True, engine=h.engine,
                             now=now)
        prep = s.prepare_batch(ev)
        assert prep is not None, ev.job_id
        scheds.append(s)
        preps.append(prep)
    items = [BatchItem(job=p.job, tg=p.tg, count=p.count) for p in preps]
    seeds = [(zlib.crc32(ev.id.encode()) & 0xFFFFFFFF) or 1 for ev in evals]
    pending = h.engine.dispatch_batch(snap, items, seed=seeds,
                                      used0_dev=used0_dev)
    decisions = h.engine.collect_batch(pending)
    for ev, s, prep, bd in zip(evals, scheds, preps, decisions):
        assert s.finalize_batched(ev, s.submit_batched(ev, prep, bd)) is None
    return pending, decisions


def alloc_map(h, jobs):
    """(job id, alloc name) -> node id over the store's live allocs."""
    out = {}
    for j in jobs:
        for a in h.state.allocs_by_job(j.namespace, j.id):
            if not a.terminal_status():
                out[(j.id, a.name)] = a.node_id
    return out


def random_placement_arrays(rng, n=40, g=2, p=16, p_real=None, s=0, k=3,
                            d=0, kd=3, spread_algo=False, seed=12345,
                            prev=False, extra=False, dh=False,
                            tight=False, tg=None, active=None, pad_g=False,
                            dead_group=None):
    """Seeded numpy PlacementInputs fields for the solo kernels: `s`
    spread rows of `k` values, `d` distinct_property rows of `kd`
    values, reschedule rows (`prev`), a device AND-mask (`extra`),
    distinct_hosts limits (`dh`), and with `tight` small nodes that run
    out within the batch.  Options for the scan's memo: `tg` fixes the
    real steps' groups, `active` the whole active mask (inactive steps
    anywhere), `pad_g` draws the padding steps' groups, `dead_group` is
    a group that no node admits (its device mask row all False).  The
    defaults draw exactly as before."""
    p_real = p if p_real is None else p_real
    a = 4
    attrs = rng.integers(-1, 5, (n, a)).astype(np.int32)
    luts = rng.random((3, 6)) < 0.6
    if tight:
        cap = np.stack([rng.choice([300, 500, 800], n),
                        rng.choice([256, 512, 1024], n),
                        np.full(n, 3000)], axis=1).astype(np.int32)
    else:
        cap = np.stack([rng.choice([4000, 8000, 16000], n),
                        rng.choice([8192, 16384], n),
                        np.full(n, 100000)], axis=1).astype(np.int32)
    used0 = (cap * rng.random((n, 3)) * 0.6).astype(np.int32)
    used0[rng.random(n) < 0.1, 1] = cap[0, 1] * 3     # over capacity
    con = np.zeros((g, 2, 3), np.int32)
    for gi in range(g):
        if rng.random() < 0.7:
            con[gi, 0] = (rng.integers(0, a), rng.integers(1, 6),
                          rng.integers(0, 3))
    aff = np.zeros((g, 2, 4), np.int32)
    for gi in range(g):
        if rng.random() < 0.6:
            aff[gi, 0] = (rng.integers(0, a), 1, rng.integers(0, 4),
                          rng.integers(-50, 51))
            aff[gi, 1] = (rng.integers(0, a), 5, rng.integers(0, 3),
                          rng.integers(1, 30))
    req = np.stack([rng.choice([50, 100, 250], g),
                    rng.choice([64, 128, 300], g),
                    rng.choice([0, 10], g)], axis=1).astype(np.int32)
    s_rows = max(s, 1)
    if s:
        sp_nodeval = rng.integers(-1, k, (s, n)).astype(np.int32)
        sp_weight = rng.choice([50.0, 33.0, 70.0], s).astype(np.float32)
        sp_expected = (rng.random((s, k)) * p).astype(np.float32)
        sp_counts0 = rng.integers(0, 3, (s, k)).astype(np.float32)
    else:
        sp_nodeval = np.full((1, n), -1, np.int32)
        sp_weight = np.zeros(1, np.float32)
        sp_expected = np.ones((1, 1), np.float32)
        sp_counts0 = np.zeros((1, 1), np.float32)
    if d:
        pd_nodeval = rng.integers(-1, kd, (d, n)).astype(np.int32)
        pd_limit = rng.integers(1, 4, d).astype(np.int32)
        pd_apply = rng.random((g, d)) < 0.7
        pd_counts0 = rng.integers(0, 2, (d, kd)).astype(np.int32)
    else:
        pd_nodeval = np.full((1, n), -1, np.int32)
        pd_limit = np.zeros(1, np.int32)
        pd_apply = np.zeros((g, 1), bool)
        pd_counts0 = np.zeros((1, 1), np.int32)
    tg_idx = np.zeros(p, np.int32)
    tg_idx[:p_real] = rng.integers(0, g, p_real)
    prev_row = np.full(p, -1, np.int32)
    if prev:
        hit = rng.random(p_real) < 0.5
        prev_row[:p_real][hit] = rng.integers(0, n, int(hit.sum()))
    active = np.arange(p) < p_real if active is None else np.asarray(
        active, bool)
    if tg is not None:
        tg_idx[:p_real] = tg
    out = dict(
        attrs=attrs, cap=cap, used0=used0, elig=rng.random(n) < 0.9,
        dc_mask=rng.random(n) < 0.9, pool_mask=rng.random(n) < 0.95,
        luts=luts, con=con, aff=aff, req=req,
        desired=rng.integers(1, 8, g).astype(np.int32),
        dh_limit=(rng.integers(0, 3, g) if dh
                  else np.zeros(g)).astype(np.int32),
        sp_nodeval=sp_nodeval[:s_rows], sp_weight=sp_weight,
        sp_expected=sp_expected, sp_counts0=sp_counts0,
        pd_nodeval=pd_nodeval, pd_limit=pd_limit, pd_apply=pd_apply,
        pd_counts0=pd_counts0, tg_idx=tg_idx, prev_row=prev_row,
        active=active,
        job_count0=rng.integers(0, 2, n).astype(np.int32),
        spread_algo=np.bool_(spread_algo), seed=np.uint32(seed),
        extra_mask=(rng.random((g, n)) < 0.8) if extra else None)
    if pad_g:
        tg_idx[p_real:] = rng.integers(0, g, p - p_real)
    if dead_group is not None:
        if out["extra_mask"] is None:
            out["extra_mask"] = np.ones((g, n), bool)
        out["extra_mask"][dead_group] = False
    return out


# Inputs that exercise the scan kernels' memo (csrc/place_scan.cu): the
# group changing every step (each commit refreshes every group's cache
# entry), inactive steps right after a commit and between active ones,
# an active step with no feasible row followed by one of the same group,
# and a shard of fewer than 3 rows with memoised padding steps
MEMO_SCAN_CASES = {
    "g_alternating": dict(n=40, g=3, p=32, p_real=27, s=1, d=1, dh=True,
                          tight=True, tg=np.arange(27) % 3, pad_g=True),
    "inactive_after_commit": dict(
        n=40, g=2, p=24, s=1, k=4, d=1, tg=np.repeat([0, 1], 12),
        active=np.array([1, 0, 1, 1, 0, 0, 1, 0, 1, 1, 1, 0] * 2)),
    "infeasible_then_same_g": dict(
        n=40, g=2, p=16, s=1, tg=[0, 0, 0, 1, 0, 0, 1, 1, 0, 0, 1, 0, 0,
                                  0, 1, 1], dead_group=0),
    "n_loc_below_3_memo": dict(n=13, p=16, p_real=9, s=1, pad_g=True),
}


def memo_identity(buf, tg_idx, active):
    """Asserts, on a scan's packed output, the identity the kernels' memo
    rests on: two steps of one group with no commit between them have
    equal metric columns, and such a step places nothing (row
    [-1, 0, -1, -1, -1, 0, 0, 0]) when it is inactive or the earlier one
    had no feasible row.  Returns the number of steps it held for."""
    seen = {}
    ver = 0
    held = 0
    empty = [-1, 0, -1, -1, -1, 0, 0, 0]
    for t, g in enumerate(tg_idx):
        first = seen.get((int(g), ver))
        if first is not None:
            assert (buf[t, 8:] == buf[first, 8:]).all(), t
            if not active[t] or buf[first, 8] == 0:
                assert buf[t, :8].tolist() == empty, t
            held += 1
        else:
            seen[(int(g), ver)] = t
        if not active[t]:
            assert buf[t, :8].tolist() == empty, t
        if buf[t, 0] >= 0:
            ver += 1
    return held


# K2's cases (csrc/compact_rounds.cu): zoned batches built by the
# engine, then reshaped to reach each branch of the kernel: a frame that
# is not a multiple of the cluster's blocks, a frame below the round
# size, round sizes 1 and 1024, one lane, lanes of unequal valid counts,
# lanes of padding steps (memoised, and with distinct groups), requests
# that change between steps (the cache refill), the spread algorithm's
# wide rounds, keys tied without tie-break noise (seed 0), and a frame
# too large for shared memory
COMPACT_CASES = {
    "binpack": dict(),
    "spread": dict(spread=True),
    "ragged_frame": dict(nc=1001),
    "frame_below_round": dict(nc=50, count=60, spread=True),
    "round_1": dict(rs=1),
    "round_1024": dict(rs=1024, spread=True, count=300),
    "one_lane": dict(lanes=[2]),
    "unequal_lanes": dict(valid=[60, 7, 33, 1, 45]),
    "padding_lanes": dict(idle=True),
    "mixed_requests": dict(mixed=True),
    "tied_keys": dict(spread=True, no_noise=True),
    "global_frame": dict(nc=40960, lanes=[0, 1], spread=True),
}
# rows a K2 round fills on the kernel's one-exchange path
# (csrc/compact_rounds.cu TOPB)
COMPACT_TOPB = 4


def compact_case(name, case, seed=7):
    """(arrays, cand_rows, cand_valid, round_size, n_lanes) of one of
    COMPACT_CASES, built with package `name`'s engine on the CPU: numpy
    MultiEvalInputs fields and [L, Nc] frames."""
    kw = COMPACT_CASES[case]
    h = build_zoned_cluster(name)
    if kw.get("spread"):
        set_spread(name, h)
    count = kw.get("count", 40)
    _, items = add_jobs(name, h, 13, count)
    if kw.get("mixed"):
        _, more = add_jobs(name, h, 12, count, cpu=250, mem=300,
                           prefix="big")
        items = [x for pair in zip(items, more) for x in pair] + items[12:]
    built = engine(name).build_multi_inputs(h.state.snapshot(), items,
                                            seed=seed)
    assert built["cand_rows"] is not None
    arrs = _numpy_inputs(name, built["inp"])
    cr = np.array(built["cand_rows"], np.int32)
    cv = np.array(built["cand_valid"], bool)
    lanes = built["n_lanes"]
    n = arrs["cap"].shape[0]
    steps = arrs["round_g"].shape[0] // lanes
    rg = arrs["round_g"].reshape(steps, lanes).copy()
    rw = arrs["round_want"].reshape(steps, lanes).copy()
    jc0 = arrs["job_count0"]
    if "lanes" in kw:
        sel = kw["lanes"]
        cr, cv, rg, rw = cr[sel], cv[sel], rg[:, sel], rw[:, sel]
        lanes = len(sel)
    if "nc" in kw:
        nc, cur = kw["nc"], cr.shape[1]
        if nc <= cur:
            cr, cv, jc0 = cr[:, :nc], cv[:, :nc], jc0[:, :nc]
        else:
            pad = ((0, 0), (0, nc - cur))
            cr = np.pad(cr, pad, constant_values=n)
            cv = np.pad(cv, pad, constant_values=False)
            jc0 = np.pad(jc0, pad)
    for li, k in enumerate(kw.get("valid", ())):
        cv[li, k:] = False
        cr[li, k:] = n
    if kw.get("idle"):
        # the last lane pads every step (one group), the one before it
        # keeps its groups with nothing to place
        rw[:, -1] = 0
        rg[:, -1] = rg[0, -1]
        rw[:, -2] = 0
    if kw.get("no_noise"):
        arrs["seed"] = np.zeros_like(arrs["seed"])
    arrs.update(round_g=rg.reshape(-1), round_want=rw.reshape(-1),
                job_count0=np.ascontiguousarray(jc0))
    return (arrs, np.ascontiguousarray(cr), np.ascontiguousarray(cv),
            kw.get("rs", built["rs"]), lanes)


# K3's cases (csrc/compact_rounds.cu flat mode) on a 150-node flat
# cluster of 9 jobs x 30 (N a multiple of neither 8 nor 16): where its
# frame differs from a one-lane K2 launch (two signatures alternating
# round by round, one job over two groups in consecutive rounds), the
# spread fan-out, round sizes 1 and 1024, idle and memoised rounds, and
# fewer rows than a block takes
FLAT_CASES = {
    "binpack": dict(),
    "spread": dict(spread=True),
    "two_signatures": dict(signatures=True),
    "job_over_two_groups": dict(shared_job=True),
    "round_1": dict(rs=1),
    "round_1024": dict(spread=True, count=600),
    "padding_rounds": dict(idle=True),
    "small_n": dict(n_nodes=37),
}


def _numpy_inputs(name, inp):
    arrs = {k: (None if v is None else np.asarray(v) if name == "nomad_tpu"
                else v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in zip(type(inp)._fields, inp)}
    arrs["seed"] = np.asarray(arrs["seed"]).astype(np.uint32)
    return arrs


def flat_case(name, case, seed=3, n_rows=None):
    """(arrays, round_size) of one of FLAT_CASES, built with package
    `name`'s engine on the CPU: numpy MultiEvalInputs fields of a flat
    batch.  `n_rows` tiles the node axis to that many rows (the card's
    cases at the flat wave's width)."""
    kw = FLAT_CASES[case]
    h = build_flat_cluster(name, n_nodes=kw.get("n_nodes", 150))
    if kw.get("spread"):
        set_spread(name, h)
    _, items = add_jobs(name, h, 9, kw.get("count", 30), zones=0)
    built = engine(name).build_multi_inputs(h.state.snapshot(), items,
                                            seed=seed)
    assert built["cand_rows"] is None
    arrs = _numpy_inputs(name, built["inp"])
    rs = built["rs"]
    rg = arrs["round_g"].copy()
    rw = arrs["round_want"].copy()
    g_cnt = arrs["req"].shape[0]
    if "rs" in kw:
        # one placement a round, padded to a power of two as the engine
        rs = kw["rs"]
        g1 = [g for g, w in zip(rg, rw) for _ in range(w)]
        r_pad = 1 << max(len(g1) - 1, 0).bit_length()
        rg = np.array(g1 + [0] * (r_pad - len(g1)), np.int32)
        rw = np.array([1] * len(g1) + [0] * (r_pad - len(g1)), np.int32)
    if kw.get("signatures"):
        # a second signature (the first less every third node, through a
        # second base mask row), taken by every odd group
        u = arrs["con"].shape[0]
        extra = arrs["base_mask"][arrs["u_mask"][0]].copy()
        extra[::3] = False
        arrs["u_mask"] = np.append(arrs["u_mask"],
                                   arrs["base_mask"].shape[0]).astype(np.int32)
        arrs["base_mask"] = np.concatenate([arrs["base_mask"], extra[None]])
        arrs["con"] = np.concatenate([arrs["con"], arrs["con"][:1]])
        arrs["g_static"] = np.where(np.arange(g_cnt) % 2 == 1, u,
                                    arrs["g_static"]).astype(np.int32)
    if kw.get("shared_job"):
        # groups 0 and 1 (rounds 0 and 1) of one job with live allocs
        jc0 = arrs["job_count0"].copy()
        jc0[0] = np.random.default_rng(seed).integers(0, 3, jc0.shape[1])
        arrs["job_count0"] = jc0
        g_job = arrs["g_job"].copy()
        g_job[1] = g_job[0]
        arrs["g_job"] = g_job
    if kw.get("idle"):
        # round 3 places nothing, round 4 repeats it (a memoised step)
        rw[3] = 0
        rg[4] = rg[3]
        rw[4] = 0
    arrs.update(round_g=rg, round_want=rw)
    if n_rows:
        idx = np.arange(n_rows) % arrs["cap"].shape[0]
        for k in ("attrs", "cap", "used0", "elig"):
            arrs[k] = np.ascontiguousarray(arrs[k][idx])
        for k in ("base_mask", "job_count0"):
            arrs[k] = np.ascontiguousarray(arrs[k][:, idx])
    return arrs, rs


def reference_multi_inputs(arrays):
    """The reference's MultiEvalInputs from numpy arrays by field."""
    import jax.numpy as jnp
    from nomad_tpu.ops.select import MultiEvalInputs
    return MultiEvalInputs(**{
        k: (bool(arrays[k]) if k == "spread_algo" else
            None if arrays[k] is None else jnp.asarray(arrays[k]))
        for k in MultiEvalInputs._fields})


def compact_identities(buf, fills, round_g, round_want, lanes):
    """Asserts, on a compact wave's packed output (buf_small [T*L,
    FILL_K + 16], fills [T*L, rs]), what K2's design rests on: a round's
    filled rows form a prefix of its fill slots whose counts sum to its
    placed column; and a step whose group and want equal the lane's last
    computed step's, after that step placed nothing, repeats that step's
    row (its memo).  Returns (memoised steps, rounds that fill at most
    COMPACT_TOPB rows)."""
    steps = round_g.shape[0] // lanes
    held = short = 0
    for li in range(lanes):
        last = None
        for t in range(steps):
            r = t * lanes + li
            cnt = fills[r] & 2047
            m = int((cnt > 0).sum())
            assert (cnt[:m] > 0).all() and int(cnt.sum()) == buf[r, -4], r
            short += m <= COMPACT_TOPB
            key = (int(round_g[r]), int(round_want[r]))
            if last is not None and last[0] == key and last[1] == 0:
                assert (buf[r] == buf[last[2]]).all(), r
                assert (fills[r] == fills[last[2]]).all(), r
                held += 1
                continue
            last = (key, int(buf[r, -4]), r)
    return held, short


# node-axis fields of random_placement_arrays and their padding values
# (reference engine._pad_rows / _pad_cols): padded rows are ineligible and
# match nothing
_PAD_ROWS = {"attrs": -1, "cap": 0, "used0": 0, "elig": False,
             "dc_mask": False, "pool_mask": False, "job_count0": 0}
_PAD_COLS = {"sp_nodeval": -1, "pd_nodeval": -1, "extra_mask": False}


def pad_arrays(arr, npad):
    """`random_placement_arrays` output with the node axis padded to
    `npad` rows, as the mesh engine pads it."""
    out = dict(arr)
    for k, fill in _PAD_ROWS.items():
        a = arr[k]
        p = np.full((npad,) + a.shape[1:], fill, a.dtype)
        p[:a.shape[0]] = a
        out[k] = p
    for k, fill in _PAD_COLS.items():
        a = arr.get(k)
        if a is None:
            continue
        p = np.full(a.shape[:-1] + (npad,), fill, a.dtype)
        p[..., :a.shape[-1]] = a
        out[k] = p
    return out


_BULK_FIELDS = ("attrs", "cap", "used0", "elig", "dc_mask", "pool_mask",
                "luts", "con", "aff", "req", "desired", "dh_limit",
                "job_count0", "spread_algo", "seed", "extra_mask")


def bulk_arrays(arr, g, p_real):
    """The BulkInputs fields of `random_placement_arrays` output, the
    rounds placing `p_real` of group `g`."""
    b = {k: arr[k] for k in _BULK_FIELDS}
    b.update(g=np.int32(g), p_real=np.int32(p_real))
    return b


# K6 as K3 at one group, and on the card K6's entry in K3's flat mode:
# (random_placement_arrays kwargs, round size, rounds, p_real, variant)
BULK_FLAT_CASES = {
    "binpack": (dict(n=300), 64, 4, 256, None),
    "spread": (dict(n=300, spread_algo=True), 64, 4, 256, None),
    "extra_mask": (dict(n=300, extra=True, tight=True), 64, 4, 256, None),
    # 50 rows against a round of 256: padded fill slots
    "n_below_round": (dict(n=50), 256, 3, 700, None),
    # a last real round of 34, then a padding round
    "p_real_not_multiple": (dict(n=200), 64, 5, 226, None),
    # no row admits the group: every round places nothing
    "infeasible_group": (dict(n=200, extra=True), 64, 3, 150, "infeasible"),
    # job counts of up to 4 against distinct_hosts limits
    "job_count0": (dict(n=200, dh=True), 64, 3, 150, "job_count0"),
}


def bulk_flat_case(case, seed=21):
    """(BulkInputs arrays, round size, rounds) of BULK_FLAT_CASES[case]
    for group 1 of two."""
    kw, rs, rounds, p_real, variant = BULK_FLAT_CASES[case]
    rng = np.random.default_rng(seed)
    arr = random_placement_arrays(rng, g=2, p=rs * rounds, **kw)
    if variant == "infeasible":
        arr["extra_mask"][1] = False
    elif variant == "job_count0":
        arr["job_count0"] = rng.integers(0, 5, kw["n"]).astype(np.int32)
        arr["dh_limit"][1] = 3
    return bulk_arrays(arr, 1, p_real), rs, rounds


def reference_bulk_inputs(b):
    """The reference's BulkInputs from `bulk_arrays` output."""
    import jax.numpy as jnp
    from nomad_tpu.ops.select import BulkInputs
    return BulkInputs(**{k: (None if v is None else jnp.asarray(v))
                         for k, v in b.items()})


def reference_placement_inputs(arrays):
    """The reference's PlacementInputs from `random_placement_arrays`."""
    import jax.numpy as jnp
    from nomad_tpu.ops.select import PlacementInputs
    return PlacementInputs(**{
        k: (None if v is None else jnp.asarray(v))
        for k, v in arrays.items()})


def random_preempt_args(rng, m=40, a=4, big=False, ties=False, dh=0,
                        k0max=0, n_fail=10):
    """Seeded numpy `preempt_bulk` arguments over `m` full candidate
    rows with up to `a` priority-sorted victims each.  `big` victims'
    disk makes their cost prefix sums inexact in f32; `ties` gives every
    victim the same priority and resources, so candidates tie on cost;
    `k0max` marks victims consumed by an earlier launch."""
    cap = np.stack([np.full(m, 4000), np.full(m, 8192),
                    np.full(m, 10 ** 8)], 1).astype(np.int32)
    depth = rng.integers(1, a + 1, m)
    prio = np.full((m, a), 1 << 30, np.int32)
    res = np.zeros((m, a, 3), np.int32)
    for i in range(m):
        dd = depth[i]
        prio[i, :dd] = 20 if ties else np.sort(rng.integers(10, 60, dd))
        if ties:
            res[i, :dd] = (1000, 64, 0)
        else:
            res[i, :dd] = np.stack([
                rng.integers(100, 2000, dd), rng.integers(64, 4000, dd),
                rng.integers(10 ** 6, 1.6 * 10 ** 7, dd) if big
                else rng.integers(0, 500, dd)], 1)
    used = np.minimum(res.sum(1), cap).astype(np.int32)
    static = rng.random(m) < 0.9
    jc = rng.integers(0, 2, m).astype(np.int32)
    req = np.array([1500, 512, 0], np.int32)
    k0 = np.minimum(rng.integers(0, k0max + 1, m), depth).astype(np.int32)
    n_place = 1
    while n_place < n_fail:
        n_place *= 2
    return (cap, used, static, np.int32(dh), jc, prio, res, req, k0,
            n_place, np.int32(n_fail))


# ------------------------------------------------ solo-path scenarios

# Row sets of the usage delta replay (K4, K13) for a table of n rows:
# the reference indexes like numpy, so [-n, 0) wraps and the rest of
# what lies outside [0, n) drops.
SCATTER_ROW_CASES = ("negative", "below_table", "past_table", "mixed",
                     "repeats", "empty")


def scatter_case(case, n, m, rng):
    """(rows [m] int32, vals [m, 3] int32) of one row set, from `rng`
    (`empty` has m = 0)."""
    lo, hi = {"negative": (-n, 0), "below_table": (-3 * n, -n),
              "past_table": (n, 3 * n), "mixed": (-2 * n, 2 * n),
              "repeats": (-n, n), "empty": (0, n)}[case]
    m = 0 if case == "empty" else m
    rows = rng.integers(lo, hi, m).astype(np.int32)
    if case == "repeats" and m:
        r0 = int(rows[0]) % n
        rows[: m // 2] = r0
        rows[m // 2: 3 * m // 4] = r0 - n         # the same row, wrapped
    vals = rng.integers(-500, 500, (m, 3)).astype(np.int32)
    return rows, vals


def make_node(name, i, dc="dc1", cpu=4000, mem=8192, **attrs):
    mock = pkg(name, "mock")
    nid = f"node-{i:05d}"
    n = mock.node(id=nid, name=nid, datacenter=dc)
    n.attributes["unique.hostname"] = nid
    n.attributes.update(attrs)
    n.resources.cpu = cpu
    n.resources.memory_mb = mem
    return n


def add_nodes(name, h, specs):
    """specs: (dc, cpu, mem, attrs) per node, ids node-00000..."""
    structs = pkg(name, "structs")
    nodes = []
    for i, (dc, cpu, mem, attrs) in enumerate(specs):
        n = make_node(name, i, dc, cpu, mem, **attrs)
        n.computed_class = structs.compute_class(n)
        nodes.append(n)
    h.state.upsert_nodes(nodes)
    return nodes


def eval_for(name, job, tag="0", **kw):
    mock = pkg(name, "mock")
    kw.setdefault("triggered_by", "job-register")
    return mock.eval(id=f"eval-{job.id}-{tag}-0000-000000000000",
                     type=job.type, job_id=job.id, priority=job.priority,
                     **kw)


def _metric(m):
    if m is None:
        return None
    return (m.nodes_evaluated, m.nodes_filtered, m.nodes_in_pool,
            dict(m.nodes_available), m.nodes_exhausted,
            dict(m.dimension_exhausted), dict(m.class_filtered),
            dict(m.constraint_filtered),
            [(s.node_id, np.float32(s.norm_score).view(np.int32).item())
             for s in m.score_meta_data])


def view(h):
    """Everything the two packages must agree on, keyed by stable names:
    live and stopped allocs per (job, name), their node, status, metric,
    devices and preempted victims; each eval update's status, failed
    group metrics and queued counts; the blocked/follow-up evals."""
    snap = h.snapshot()
    by_id = {}
    for job in snap.jobs():
        for a in snap.allocs_by_job(job.namespace, job.id):
            by_id[a.id] = (a.job_id, a.name)
    allocs = {}
    for job in snap.jobs():
        for a in snap.allocs_by_job(job.namespace, job.id):
            allocs[(a.job_id, a.name, a.node_id, a.desired_status,
                    a.client_status)] = (
                _metric(a.metrics),
                [(d.name, tuple(d.device_ids))
                 for d in (a.allocated_devices or [])],
                sorted(by_id.get(v, v)
                       for v in (a.preempted_allocations or [])),
                by_id.get(a.previous_allocation, a.previous_allocation))
    evals = [(e.job_id, e.status,
              {k: _metric(v) for k, v in (e.failed_tg_allocs or {}).items()},
              dict(e.queued_allocations or {}))
             for e in h.evals]
    created = [(e.job_id, e.triggered_by, e.status) for e in h.create_evals]
    return allocs, evals, created


# ------------------------------------------------------------- agents

@pytest.fixture
def pinned(monkeypatch):
    """`reset(seed)` before each package's run: os.urandom draws from
    random.Random(seed), both id pools are emptied and `random` is
    seeded, so the two runs mint the same ids in the same order."""
    import os
    stream = {}
    monkeypatch.setattr(os, "urandom",
                        lambda n: stream["rng"].randbytes(n))

    def reset(seed: int = 0) -> None:
        stream["rng"] = random.Random(seed)
        for name in PACKAGES:
            pkg(name, "structs.structs")._ID_POOL.clear()
        random.seed(seed)

    return reset


@pytest.fixture
def one_device(monkeypatch):
    """The reference's Server builds `PlacementEngine(mesh=None)`, which
    shards over the test session's 8 virtual CPU devices; its agents
    here run on one device, as the port's do."""
    import nomad_tpu.core.server as ref_server
    from nomad_tpu.ops import PlacementEngine

    def single(mesh=None, **kw):
        return PlacementEngine(mesh=False if mesh is None else mesh, **kw)

    monkeypatch.setattr(ref_server, "PlacementEngine", single)


def make_agent(name, data_dir, **kw):
    """An Agent of `name` on the CPU (the port's `device="cpu"`, the
    reference's default "jax" executor), HTTP on a free port, the
    sampler off, no heartbeat expiry, in `data_dir` (a default would
    draw a temporary name from os.urandom).  Not started."""
    kw.setdefault("num_clients", 0)
    kw.setdefault("heartbeat_ttl", 1e6)
    kw.setdefault("profile_hz", 0)
    if name == "nomad_tpu_torch":
        kw.setdefault("device", "cpu")
    return pkg(name, "agent").Agent(data_dir=str(data_dir), **kw)


def agent_nodes(name, n, dc="dc1"):
    """`n` client nodes with explicit ids and names for an Agent's
    in-process clients."""
    structs = pkg(name, "structs")
    return [structs.Node(id=f"client-{i:04d}", name=f"client-{i:04d}",
                         datacenter=dc) for i in range(n)]


def settle(agent, timeout: float = 60.0) -> None:
    """Wait until the agent's server has nothing in flight: no eval in
    the broker (ready, delayed or outstanding), no plan queued, and no
    pending eval in the store, for three polls in a row."""
    import time
    s = agent.server
    deadline = time.monotonic() + timeout
    quiet = 0
    while quiet < 3:
        if time.monotonic() > deadline:
            raise AssertionError("the agent did not settle")
        busy = (s.eval_broker.pending_evals() or s.eval_broker._outstanding
                or s.plan_queue.depth()
                or any(e.status == "pending"
                       for e in s.state.snapshot().evals()))
        quiet = 0 if busy else quiet + 1
        time.sleep(0.02)


# ------------------------------------------------------- cluster plane


def fsm_snapshot(name, store) -> bytes:
    """`store`'s state as `name`'s ClusterServer._fsm_snapshot packs it
    (`wire.packb(store.snapshot_save())`) for a Raft snapshot."""
    import types
    cluster = pkg(name, "core.cluster")
    return cluster.ClusterServer._fsm_snapshot(
        types.SimpleNamespace(_local_state=store))


def fsm_restore(name, data: bytes):
    """A fresh store of `name` restored from Raft snapshot bytes through
    its ClusterServer._fsm_restore: the state counterpart of the weight
    converter (either package's snapshot restores into either store)."""
    import types
    store = pkg(name, "state").StateStore()
    pkg(name, "core.cluster").ClusterServer._fsm_restore(
        types.SimpleNamespace(_local_state=store), data)
    return store


def reset_mock_counters(monkeypatch) -> None:
    """Both packages' mock name counters from 0 (mock names nodes from a
    module counter that earlier tests in the process have advanced)."""
    import itertools
    for name in PACKAGES:
        monkeypatch.setattr(pkg(name, "mock"), "_counter",
                            itertools.count())
