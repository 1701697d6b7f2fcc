#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (nomad_tpu_torch) on one card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from nomad_tpu_torch/csrc (nvcc, sm_90a,
into nomad_tpu_torch/csrc/build/), then:

  1. environment: the card's name and power limit, torch/CUDA versions,
     kernel build time;
  2. kernels: each kernel's wrapper against its plain PyTorch version,
     at the shapes the main path gives it, both on the card and on CPU
     copies of the same inputs (the CPU plain version is the one that
     matches the JAX reference bit for bit).  Tolerance: none; every
     output word, f32 scores compared as their bits, must be equal.
     Kernel / plain / library times (K4 and K13 timed in turns with
     their library call), and each kernel's bound; K2's and K3's chained
     forms, their phase splits (the PROF launchers of
     csrc/compact_rounds.cu: microseconds per real and per padding step
     in the loop top, the pass, the merge, the exchange, the decision,
     the wide path and memoised steps) and what their steps need
     (`steps`); K3's cluster size and where its frame lies (`blocks`,
     `frame`);
  3. the north-star zoned wave through the port's Harness: 50,000 nodes
     in 3 DCs and 5 CSI zones (bench.py _build_bench_cluster), 384 batch
     evals x 260 placements, prepare_batch per eval, ONE place_batch
     (compact laned kernel K2, 5 lanes), submit/finalize into the store;
  4. a second, chained wave of 384 evals started from wave 1's usage
     (in-place chained K2);
  5. a smaller zoned wave of 128 evals x 260 (K2), unchained;
  6. a single-signature wave of 64 evals x 100 (K3, the flat mode of
     K2's kernel), whose dispatch first replays wave 5's 128 plans onto
     the device usage through K4.  (The packer logs at most 256 plan
     deltas, so after a 384-eval wave the next dispatch re-uploads the
     usage instead.)

The four waves dispatch and collect through one TorchExecutor (the
device executor seam, ops/executor.py) attached to the store; the
chained wave's usage triple is the one the zoned wave retained
(`retain_chain`, then `claim_chain`, as the worker does).  Then:

  executor: the executor's device ledger (compile sites with misses and
     first-launch seconds, the `kernels.nvcc/*` builds among them;
     uploads and their bytes by cause, each wave's too; d2h fetches and
     bytes; dispatches, resident waves, invalidations; the residency
     estimate and its watermark beside torch.cuda.memory_allocated and
     max_memory_allocated), the host µs `_launch` adds to a launch, and
     the registry's nomad.executor.* and nomad.engine.* rows;
  executor_invalidation: the flat wave's chain retained, one node
     written through the store, the chain dropped (reason node-write)
     and a small zoned wave (128 x 260, K1 + K2) unchained, re-uploading
     the node tensors and the usage;
  device_wait: WAIT_WAVES zoned waves (384 x 260 each, K1 + K2) under
     the port's sampling profiler at WAIT_HZ, each collect's wait marked
     device-wait: the window's bucket split, the main thread's innermost
     frames, each wait's seconds and the dispatch's pinned-copy set-up.

  server_waves: bench.py config 5 through the port's Server in thread
     mode (dev_mode=False, one worker, eval_batch 384, a TorchExecutor,
     the sampler at its default rate) on a fresh 50,000-node cluster
     built alike: a warm-up wave (384 x 260 at cpu 1 / mem 1) and the
     measured wave (384 x 260 at cpu 10 / mem 10), each registered
     through Server.register_job and drained as bench.py's drain does
     (the packer synced outside the timed window, start_scheduling,
     the eval statuses polled, stop_scheduling).  Each wave's line
     (`server_warmup_wave`, `server_wave`): wall, evals/s, placements/s,
     the plan queue's p50 and p99, the stage timers, the pipeline's,
     the applier's and the executor's counts, launches, memory and
     full collections.  Gates: every eval complete and every placement
     committed, zones, capacity, the retained chain's usage equal to
     the store's, K1 and K2 launched and K5 and K6 not, none of the
     worker's or the applier's recovery records in the log ring, one
     `device` interval per dispatched wave.  Then shutdown, and the
     Server's engine must be freed.
  agent_waves: the same config 5 through the port's own front door: an
     in-process Agent (one worker, eval_batch 384, a TorchExecutor, two
     in-process clients on the mock driver in a datacenter of their
     own, HTTP on a free port) fed through its APIClient only: 50,000
     nodes built alike by `PUT /v1/nodes`, the five zone volumes by the
     CSI volume endpoint, the two waves by `PUT /v1/jobs` with
     scheduling paused around each registration, settlement polled over
     HTTP every 20 ms, placements read back through `GET
     /v1/allocations?columnar=true`.  Lines `agent_warmup_wave`,
     `agent_wave`: the server wave's fields and gates, plus
     `node_register_s`, `register_s`, jobs/s and the polls; then
     `agent_web`: examples/web.hcl to three running allocs on the two
     clients (and stopped again).  The Agent's engine must be freed.
  agent_cli: `python -m nomad_tpu_torch agent -bind 127.0.0.1:<port>
     -clients 2` in a subprocess (on CUDA), the CLI in subprocesses:
     `job run examples/web.hcl`, `job status web` to three running
     allocs, both nodes made ineligible, three batch jobs run, one node
     eligible again (their blocked evals are released together: one
     wave); /v1/metrics and /v1/operator/debug must show an upload and
     a dispatch; SIGINT must end the agent with exit code 0 and no
     traceback.  Its files go to .smoke/agent_cli/ (git-ignored).
  cluster_waves: the same config 5 through a three-server port cluster
     in this process: three Agents in cluster mode (server_name s1-s3,
     bootstrap_expect 3, each joining the other two's gossip ports, TCP
     on loopback, no encrypt, one worker with eval_batch 384, a
     TorchExecutor, a large heartbeat TTL; CLUSTER_RAFT's timings:
     elections after 5-10 s, past a full collection's pause), and
     two in-process clients in the agents' datacenter on a follower,
     through RemoteRPC.  The leader is awaited through GET
     /v1/status/leader on all three; the 50,000 nodes go through the
     leader's replicated upsert_nodes in chunks of CLUSTER_SEED_CHUNK
     (set-up: `node_seed_s`, the Raft entries and bytes) and the volumes
     through a follower's HTTP API.  Wave 1 (`cluster_wave`): 384 x 260
     registered through a follower's HTTP API (forwarded to the leader)
     with the leader's scheduling paused, settled and gated as
     agent_waves (server_wave on the leader), then each follower caught
     up to the leader's Raft index with the same allocs and per-node
     usage, and its executor without a dispatch or an upload; its Raft
     commits and bytes, the followers' catch-up after the settle, the
     executors' invalidations by reason.  Then the leader is shut down,
     a survivor elected (`failover_s`) and `cluster_failover_wave`:
     CLUSTER_FAIL_EVALS x 260 through the surviving follower, K2
     launched by the new leader, no alloc placed twice, capacity with
     wave 1's allocs.  Every Agent and client is shut down and each
     engine must be freed.

Every wave line (the mesh waves' too) counts the interpreter's full
collections inside the wave (`gc2_n`, `gc2_s`); the summary line, the
run's.

Then the solo path, each eval through Harness.process at the widths of
bench.py's configs 1-4 (bench.py:409, :442, :484, :553):

  7. dev_eval: one node, a service job of 3 groups x 2 (K5 with N < 3);
  8. bulk_eval: 1,000 nodes, one batch job of 10,000 x cpu 10/mem 10
     (K8 + K1 + K6, compact output; K6 is K3's flat mode at one group);
  9. spread_eval: 5,000 nodes in 3 DCs, 3,000 placements spread
     50/30/20 over the DCs with a rack affinity (K1 + K5); prints the
     spread deviation;
 10. preempt_eval: 500 nodes of cpu 4000/mem 8192 filled by a
     low-priority batch job, then 125 high-priority placements at cpu
     3000 (K6, then K8 + K7 evict);
 11. system_eval: a system job over the spread_eval cluster (K8), one
     alloc per feasible node;
 12. solo kernel checks: K5 (the spread and dev evals' inputs, and a
     variant with distinct_property, reschedule rows and a device mask),
     K6 (the bulk eval's inputs in all three output layouts, and with the
     spread algorithm; the preempt eval's inputs in the layout the
     engine used there), K7 and K8 (the preempt and system evals' inputs)
     against their plain versions, on the card and on CPU copies (K7 also
     at 65,536 rows of one victim and 256 placements, past shared
     memory: `large`, timed, split and checked; K7's row and that record
     carry its PROF split: µs per computed step in the commit, the new
     key and the tree path), and
     K5's phase split at the spread eval's inputs (the PROF launcher of
     csrc/place_scan.cu, blocks of 256 and of 1024 threads: microseconds
     per active and per padding step in the loop top, the pass, the
     merge, the exchange or decode, the commit and memoised steps); K6's
     split and steps (csrc/compact_rounds.cu's PROF launcher, as K3's)
     and its wall and device ms in each layout (`layouts`).

Then the node-sharded mesh: a second engine on make_mesh(8) of the card
(8 shards of the node axis, parallel/mesh.py) over the same clusters:

 13. mesh_waves: the four waves above on a second 50,000-node cluster
     built alike (K12, K2's kernel over 5 lanes of 8 shard slices, K12
     chained, K12, then K11, K3's flat mode over the padded rows, with
     K13 replaying the small wave's deltas), every eval held against
     the single-device engine at the same snapshot and seeds (bench.py
     _sharded_parity_gate: sorted picks and nodes_filtered equal), and
     the store gates as above;
 14. mesh_solo: spread_eval (K9, 5,000 nodes in shards of 625) and
     bulk_eval (K10, K6's entry over the padded rows, 1,000 nodes)
     through Harness.process on the mesh
     engine: the scan's allocs on the single-device eval's nodes alloc by
     alloc, the bulk's as sorted lists;
 15. mesh kernel checks: K9-K13 against their plain versions at those
     phases' inputs, on the card and on CPU copies (K9 also through
     `parallel.place_sharded`, the unpacked entry: one launch, equal to
     the packed entry's buffer unpacked and to the plain version), K9's
     phase split at the mesh spread eval's inputs, K12's split and
     steps, K10's and
     K11's steps.  The `exchange_probes` line, before the solo kernel
     checks, times one exchange through distributed shared memory of
     K9 (and K5 above 512 rows) at 8 blocks, and one of the rounds (K2,
     K3, K6, K10, K11, K12) at 8 and at 16 blocks.

After every wall-time measurement:

 16. launch_path: K4's wall time per call split by the host clock, the
     median of 11 loops of 1,000 calls each (the wrapper's Python, the
     call into the launcher, the same call launching nothing, both again
     through ctypes) and its device time per call; then (`k1`) K1's calls
     split alike: the K1 row's pair at the zoned wave's inputs (the
     mask, the frames' affinity) and the flat waves' one launch of both
     landscapes, each with the pair's wall and device time per call;
     and (`k8`) K8's call at the system eval's inputs;
     eager_ops: the main path's eager device ops (kernels.EAGER, the
     copies, fills and stacks around the kernels, counted where they run)
     with each op's host and device time per call at the waves' shapes,
     and per phase their counts and count x per-call time (each phase
     line also carries its `eager` counts);
 17. device_times: each kernel row's timed loop run again under one
     torch.profiler window, giving `device_ms` (and `library_device_ms`
     for the rows that have a library call).

Every phase prints one JSON line; a failed phase raises and the script
exits non-zero.  The kernel launch counters are zeroed before each main
path phase and read after it; the line before the last carries them.
The last line is {"ok": true, "device": {...}}.  Without CUDA the script
exits non-zero before printing any result.  Imports nothing of JAX and
nothing of the JAX package.

    python3 chip_smoke.py --bulk-layouts

times K6 alone at bulk_eval's inputs in its three layouts (one JSON
line); copied into an older checkout, it times that checkout's K6.

    python3 chip_smoke.py --cluster

builds the kernels and runs cluster_waves alone (its two lines and a
`cluster_only` line with the launches and the seconds).
"""

from __future__ import annotations

import functools
import gc
import json
import statistics
import subprocess
import sys
import threading
import time
import zlib

N_NODES = 50_000
N_ZONES = 5
N_EVALS = 384
PER_EVAL = 260
SMALL_EVALS = 128
# shards of the node-sharded mesh on the one card (bench.py --mesh 8)
MESH_SHARDS = 8
FLAT_EVALS = 64
FLAT_PER_EVAL = 100

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and non-tensor-core
# f32 operations/s; integer and f64 work are counted at the f32 rate
# (f64 runs at half of it, so the bound stays a lower bound)
PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12
# K2, K3, K6, K10, K11 and K12 (csrc/compact_rounds.cu) counted from the
# source.  A cache entry
# (refresh_row: rounds_kcap's 3 subtractions, 3 floor divisions at 7 and
# clamps 32; rounds_binpack's conversions, 2 divisions, 2 libm_pow10f at
# 14, clamps and scale 54; the metrics' fit bits 22) is built per valid
# row at a computed step whose request differs from the cached one, and
# again at each committed row with the commit itself (usage and job
# count 7, the metrics' correction 49).  Per valid row of a computed
# step: validity and the distinct_hosts clamp 7, the mean of the cached
# binpack term, anti-affinity and affinity 14, the tie-break noise 16,
# the key bits and the slot 10, the counts of viable and exhausted rows
# 10, the top-4 test 1.  The merge compares 2 per entry of the lists it
# merges (each warp's and each block's top 4).  A step on the wide path
# adds per valid row 4 radix passes at 4 and the take test 3.  A
# memoised step copies its row (bytes, counted with the outputs).  K3's
# refresh of the valid bits at a change of signature: per row the mask
# byte's test, the bit's merge and the count, 3.
OPS_K2_CACHE = 32 + 54 + 22
OPS_K2_COMMIT = 7 + 49
OPS_K2_ROW = 7 + 14 + 16 + 10 + 10 + 1
OPS_K2_MERGE = 2
OPS_K2_WIDE = 4 * 4 + 3
OPS_K3_STATIC = 3
# The exact scan (csrc/place_scan.cu) counted from the source.  A cache
# entry (node_cache: capacity fit and distinct_hosts 7, the binpack term
# with its 2 divisions and 2 libm_pow10f at 14 47, anti-affinity 3, two
# additions 2) is built once per (group, node) and again per group for
# the pick of each commit.  Per node of a computed active step: the
# feasibility test and count 3, the mean's additions, count and division
# 9, the key (add, orderable bits) 4 and the top-3 insert 3, plus 4 per
# spread row (lookup, clamp, select, fma); of a computed inactive step
# the feasibility test and count 3; per applying distinct_property row
# 4.  A step whose row the memo knows (scan_steps) writes its row only.
OPS_SCAN_CACHE = 7 + 47 + 3 + 2
OPS_SCAN_STEP = 3 + 9 + 4 + 3
OPS_SCAN_FEAS = 3
OPS_SCAN_SPREAD = 4
OPS_SCAN_DISTINCT = 4
# Device preemption (csrc/preempt.cu) per key it computes (every row
# once at set-up, the chosen row again at each computed step): the
# first-fit prefix 7 and the cost prefix 2 per victim, then the key 6;
# per tree level of a computed step, the minimum over 32 keys; building
# the tree, about one comparison a row.
OPS_PREEMPT_VICTIM = 9
OPS_PREEMPT_ROW = 6
OPS_PREEMPT_LEVEL = 32
# K8 (csrc/landscape.cu feasible entry) per node and group: the base
# mask 3 and about 4 per constraint row.
OPS_FEASIBLE_ROW = 4
OPS_FEASIBLE_BASE = 3
# the solo evals' clock
SOLO_NOW = 1.7e9
# scan_variant's distinct_property row: node index % 7, at most 300
# placements per value, so 2,100 of the spread eval's 3,000 fit
VARIANT_PD_VALUES = 7
VARIANT_PD_LIMIT = 300
# K4, K13 and their index_add_ (a few microseconds a call) are timed in
# turns: REPLAY_ROUNDS loops a side of REPLAY_REPS back-to-back calls
REPLAY_REPS = 1000
REPLAY_ROUNDS = 11
# block barriers per computed step of the scan (two of all threads, one
# of warps 0-2) and of the preemption kernel
BARRIERS_SCAN = 3
# bytes of one block's post in the scan's exchange (csrc/place_scan.cu XW)
XCH_POST = 64
# K7's step (csrc/preempt.cu) is one warp's chain and has no block
# barrier: per computed step, the chosen row's read and then one round
# per tree level above the leaves, each a dependent shared-memory read
# of 32 keys and a warp minimum (the probe `preempt_level_probe` times
# one round), so depth = computed steps x (levels + 1) x round
ROUNDS_PREEMPT_EXTRA = 1
# K7 past shared memory: the candidate rows of a 50,000-node cluster
# with one victim a node (build_victim_tables pads to 65,536), 256
# placements
PREEMPT_LARGE = (65_536, 1, 256)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# the interpreter's full (generation 2) collections: count and seconds,
# kept by `gc_meter` once main() installs it; each wave line carries its
# own (`gc2_n`, `gc2_s`), since a full collection over the store's
# objects takes a large part of a second on that host
GC2 = {"n": 0, "s": 0.0, "t0": 0.0}


def gc_meter(phase: str, info: dict) -> None:
    if info["generation"] != 2:
        return
    if phase == "start":
        GC2["t0"] = time.perf_counter()
    else:
        GC2["n"] += 1
        GC2["s"] += time.perf_counter() - GC2["t0"]


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# ------------------------------------------------------------- cluster

def build_cluster(h, n_nodes: int, n_zones: int, seed: int = 0):
    """bench.py _build_bench_cluster: 3 DCs, n_zones storage zones, a CSI
    node plugin on every node, one CSI volume per zone restricted to the
    zone's nodes.  Returns {node id: zone}."""
    from nomad_tpu_torch.structs import CSIVolume

    nodes, zone_of, zone_nodes = cluster_nodes(n_nodes, n_zones, seed)
    h.state.upsert_nodes(nodes)
    for z in range(n_zones):
        h.state.upsert_csi_volume(CSIVolume(
            id=f"vol-zone{z}", plugin_id="ebs0",
            access_mode="multi-node-multi-writer",
            topology_node_ids=tuple(zone_nodes[z])))
    return zone_of


def cluster_nodes(n_nodes: int, n_zones: int, seed: int = 0):
    """build_cluster's nodes: (nodes, {node id: zone}, {zone: node
    ids})."""
    import random

    from nomad_tpu_torch import mock

    rng = random.Random(seed)
    nodes = []
    zone_of = {}
    zone_nodes = {z: [] for z in range(n_zones)}
    for i in range(n_nodes):
        n = mock.node(id=f"node-{i:06d}")
        n.datacenter = f"dc{1 + i % 3}"
        n.attributes["platform.rack"] = f"r{i % 20}"
        n.attributes["storage.topology"] = f"zone{i % n_zones}"
        n.csi_node_plugins["ebs0"] = True
        n.resources.cpu = rng.choice([4000, 8000, 16000])
        n.resources.memory_mb = rng.choice([8192, 16384, 32768])
        nodes.append(n)
        zone_nodes[i % n_zones].append(n.id)
        zone_of[n.id] = i % n_zones
    return nodes, zone_of, zone_nodes


def register_wave(h, prefix: str, n_evals: int, per_eval: int,
                  n_zones: int):
    """Batch jobs of `per_eval` placements (cpu 10, mem 10); with zones,
    job i claims vol-zone{i % n_zones}.  Returns (jobs, evals)."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs import VolumeRequest

    jobs, evals = [], []
    for i in range(n_evals):
        job = mock.batch_job(id=f"{prefix}-{i:04d}")
        job.datacenters = ["dc1", "dc2", "dc3"]
        tg = job.task_groups[0]
        tg.count = per_eval
        tg.tasks[0].resources.cpu = 10
        tg.tasks[0].resources.memory_mb = 10
        if n_zones:
            tg.volumes = {"data": VolumeRequest(
                name="data", type="csi", source=f"vol-zone{i % n_zones}",
                read_only=True)}
        h.state.upsert_job(job)
        jobs.append(job)
        evals.append(mock.eval(type="batch", job_id=job.id,
                               priority=job.priority,
                               triggered_by="job-register"))
    return jobs, evals


def prepare(h, evals):
    """Phase 1 of the worker's batched flow: one scheduler per eval on a
    shared snapshot, prepare_batch, per-eval seeds."""
    from nomad_tpu_torch.ops.engine import BatchItem
    from nomad_tpu_torch.scheduler.generic import GenericScheduler

    snap = h.snapshot()
    now = h.clock.time()
    scheds, preps = [], []
    for ev in evals:
        s = GenericScheduler(snap, h, is_batch=True, engine=h.engine,
                             now=now)
        prep = s.prepare_batch(ev)
        if prep is None:
            raise RuntimeError(f"eval {ev.id} is not batch-eligible")
        scheds.append(s)
        preps.append(prep)
    items = [BatchItem(job=p.job, tg=p.tg, count=p.count) for p in preps]
    seeds = [(zlib.crc32(ev.id.encode()) & 0xFFFFFFFF) or 1 for ev in evals]
    return snap, scheds, preps, items, seeds


def run_wave(h, evals, used0_dev=None, twin=None, executor=None,
             mark_wait=False):
    """prepare -> ONE dispatch/collect -> submit/finalize per eval, as
    the worker runs a wave; returns (pending, decisions, timings, twin
    pending).  `executor` (a DeviceExecutor over h.engine) dispatches
    and collects in place of the bare engine.  `mark_wait`: the wait for
    the result runs under profiling.activity("device-wait") before the
    collect, as the reference's wave pipeline marks it.  `twin` =
    (engine, used0_dev): that engine places the same items at the same
    snapshot and seeds first (untimed), and each eval's decisions must
    pass `parity_gate` against its."""
    import torch

    from nomad_tpu_torch.core import profiling

    place = executor if executor is not None else h.engine
    gc0 = GC2["n"], GC2["s"]
    t0 = time.perf_counter()
    snap, scheds, preps, items, seeds = prepare(h, evals)
    t1 = time.perf_counter()
    twin_pend = None
    if twin is not None:
        twin_pend = twin[0].dispatch_batch(snap, items, seed=seeds,
                                           used0_dev=twin[1])
        twin_dec = twin[0].collect_batch(twin_pend)
        torch.cuda.synchronize()
    t1b = time.perf_counter()
    pending = place.dispatch_batch(snap, items, seed=seeds,
                                   used0_dev=used0_dev)
    wait_s = None
    if mark_wait and pending["ready"] is not None:
        tw = time.perf_counter()
        with profiling.activity("device-wait"):
            pending["ready"].synchronize()
        wait_s = time.perf_counter() - tw
    decisions = place.collect_batch(pending)
    t2 = time.perf_counter()
    if twin is not None:
        parity_gate(decisions, twin_dec)
    for ev, s, prep, bd in zip(evals, scheds, preps, decisions):
        err = s.finalize_batched(ev, s.submit_batched(ev, prep, bd))
        if err is not None:
            raise RuntimeError(f"eval {ev.id} failed: {err}")
    if h.engine.device.type == "cuda":
        torch.cuda.synchronize()
    t3 = time.perf_counter()
    tm = {"prepare_s": t1 - t0, "place_s": t2 - t1b, "commit_s": t3 - t2,
          "wall_s": t3 - t0 - (t1b - t1), "gc2_n": GC2["n"] - gc0[0],
          "gc2_s": GC2["s"] - gc0[1]}
    if wait_s is not None:
        tm["wait_s"] = wait_s
    return pending, decisions, tm, twin_pend


def parity_gate(got, want):
    """bench.py _sharded_parity_gate's criteria: per eval the same picks
    as sorted lists and the same nodes_filtered per round."""
    import numpy as np

    if len(got) != len(want):
        raise AssertionError(f"{len(got)} decisions, want {len(want)}")
    for gi, (a, b) in enumerate(zip(got, want)):
        if not np.array_equal(np.sort(a.picks), np.sort(b.picks)):
            raise AssertionError(f"eval {gi}: sharded and single-device "
                                 "picks differ")
        fa = [m.nodes_filtered for m in a.metrics]
        fb = [m.nodes_filtered for m in b.metrics]
        if fa != fb:
            raise AssertionError(f"eval {gi}: nodes_filtered {fa} != {fb}")


def check_store(h, jobs, per_eval, all_jobs, zone_of=None, n_zones=0):
    """Every placement of `jobs` committed, each alloc in its volume's
    zone; no node over capacity, with usage recomputed from the store's
    allocs of `all_jobs`.  Returns (placed, {node id: usage})."""
    placed = 0
    for i, job in enumerate(jobs):
        allocs = [a for a in h.state.allocs_by_job(job.namespace, job.id)
                  if not a.terminal_status()]
        if len(allocs) != per_eval:
            raise AssertionError(
                f"job {job.id}: {len(allocs)} allocs, want {per_eval}")
        placed += len(allocs)
        for a in allocs:
            if n_zones and zone_of[a.node_id] != i % n_zones:
                raise AssertionError(
                    f"alloc {a.id} of {job.id} on {a.node_id}, outside "
                    f"zone{i % n_zones}")
    usage = {}
    for job in all_jobs:
        for a in h.state.allocs_by_job(job.namespace, job.id):
            if a.terminal_status():
                continue
            u = usage.setdefault(a.node_id, [0, 0, 0])
            u[0] += a.resources.cpu
            u[1] += a.resources.memory_mb
            u[2] += a.resources.disk_mb
    for node_id, (cpu, mem, disk) in usage.items():
        n = h.state.node_by_id(node_id)
        if (cpu > n.resources.cpu - n.reserved.cpu
                or mem > n.resources.memory_mb - n.reserved.memory_mb
                or disk > n.resources.disk_mb - n.reserved.disk_mb):
            raise AssertionError(f"node {node_id} over capacity: "
                                 f"{(cpu, mem, disk)}")
    return placed, usage


def used_matches_store(h, used_dev, usage):
    """A device usage tensor equals the per-node usage recomputed from
    the store, row for row in the packer's order (`h`: a Harness or a
    Server, read for its store and its engine)."""
    import numpy as np

    t = h.engine.packer.update(h.state.snapshot())
    want = np.zeros((t.n, 3), np.int64)
    for node_id, u in usage.items():
        want[t.id_to_row[node_id]] = u
    got = used_dev.cpu().numpy()
    if got[t.n:].any():
        raise AssertionError("usage on mesh padding rows")
    got = got[:t.n]
    if not np.array_equal(got, want):
        bad = np.nonzero((got != want).any(axis=1))[0]
        raise AssertionError(f"device usage differs from the store on "
                             f"{len(bad)} rows, e.g. {bad[:5].tolist()}")


# ------------------------------------------------------------ executor

# the device-wait record: a zoned wave's collect waits 0.1-0.5 ms, and
# the sampler, whose sleep and sample take some 0.1-0.2 ms at any higher
# rate, lands 0-3 samples in it; WAIT_WAVES waves of it
WAIT_HZ = 100_000.0
WAIT_WAVES = 6
# the nomad.* series the executor line prints from the registry
EXECUTOR_SERIES = ("nomad.executor.", "nomad.engine.")


def cause_delta(executor, before: dict) -> dict:
    """upload_bytes_by_cause's growth since `before`."""
    now = executor.upload_bytes_by_cause
    return {c: now[c] - before.get(c, 0) for c in sorted(now)
            if now[c] != before.get(c, 0)}


def launch_meter_us(engine, calls: int = 20_000, loops: int = 5) -> float:
    """Host µs that `PlacementEngine._launch` adds to one launch (a
    no-op in its place, median of `loops`), timed on a private compile
    ledger."""
    import nomad_tpu_torch.ops.engine as E
    from nomad_tpu_torch.core.profiling import CompileLedger

    def noop():
        return None

    led = CompileLedger()
    orig = E._compile_ledger
    E._compile_ledger = lambda: led
    try:
        engine._launch("meter_probe", (1,), noop)
        per = []
        for _ in range(loops):
            t0 = time.perf_counter()
            for _ in range(calls):
                engine._launch("meter_probe", (1,), noop)
            t1 = time.perf_counter()
            for _ in range(calls):
                noop()
            t2 = time.perf_counter()
            per.append(((t1 - t0) - (t2 - t1)) / calls * 1e6)
    finally:
        E._compile_ledger = orig
    return statistics.median(per)


def executor_phase(card, executor, n_waves, wave_uploads, flat_replayed):
    """The executor's device ledger after the four waves, the allocator's
    figures beside its residency estimate, and the registry's
    nomad.executor.* / nomad.engine.* rows."""
    import torch

    from nomad_tpu_torch.core.telemetry import REGISTRY
    from nomad_tpu_torch.ops import kernels as K

    led = executor.ledger()
    alloc = torch.cuda.memory_allocated()
    if led["resident_waves"] != 1:
        raise AssertionError(f"resident_waves {led['resident_waves']}")
    if led["dispatches"] != n_waves:
        raise AssertionError(f"dispatches {led['dispatches']}, want "
                             f"{n_waves}")
    flat = wave_uploads["flat_wave"]
    cause = "invalidation-replay" if flat_replayed else "initial-upload"
    if flat.get(cause, 0) <= 0:
        raise AssertionError(f"flat wave uploads {flat}, want {cause}")
    if not 0 < led["hbm_resident_bytes"] <= alloc:
        raise AssertionError(f"hbm_resident_bytes "
                             f"{led['hbm_resident_bytes']}, allocated "
                             f"{alloc}")
    sites = led["compile"]["sites"]
    if K.build_seconds is not None:
        missing = [src for src in K.SOURCES
                   if sites.get(f"kernels.nvcc/{src}", {}).get("misses", 0)
                   < 1]
        if missing:
            raise AssertionError(f"nvcc builds not in the ledger: "
                                 f"{missing}")
    snap = REGISTRY.snapshot()
    emit({"phase": "executor", "card": card, "backend": led["backend"],
          "compile_sites": {k: v for k, v in sorted(sites.items())
                            if v["misses"]},
          "compile": {k: led["compile"][k] for k in
                      ("hits", "misses", "hit_rate", "first_launch_s",
                       "steady_s")},
          **{k: led[k] for k in ("uploads", "upload_bytes",
                                 "upload_bytes_by_cause", "d2h_fetches",
                                 "d2h_bytes", "dispatches",
                                 "resident_waves", "invalidations",
                                 "hbm_resident_bytes",
                                 "hbm_high_watermark_bytes")},
          "wave_upload_bytes_by_cause": wave_uploads,
          "memory_allocated": alloc,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "launch_meter_us": launch_meter_us(executor.engine),
          "registry": {kind: {k: v for k, v in snap[kind].items()
                              if k.startswith(EXECUTOR_SERIES)}
                       for kind in ("counters", "gauges", "histograms")}})


def invalidation_phase(card, h, executor, prev, all_jobs, zone_of,
                       launches):
    """Retain the flat wave's chain, write one node through the store the
    executor is attached to, and show the chain dropped (reason
    node-write) and the next wave (a small zoned wave) unchained with
    its re-upload."""
    from nomad_tpu_torch.core.telemetry import REGISTRY

    jobs, evals = register_wave(h, "reupload_wave", SMALL_EVALS, PER_EVAL,
                                N_ZONES)
    all_jobs += jobs
    executor.retain_chain("flat_wave", 0, executor.chain_state(prev))
    inv0 = executor.stats["invalidations"]
    reg0 = REGISTRY.counter("nomad.executor.invalidations",
                            reason="node-write")
    node = h.state.node_by_id("node-000007").copy()
    node.attributes["platform.rack"] = "r8"
    h.state.upsert_node(node)
    inv = executor.stats["invalidations"] - inv0
    reg = REGISTRY.counter("nomad.executor.invalidations",
                           reason="node-write") - reg0
    if inv != 1 or reg != 1:
        raise AssertionError(f"invalidations +{inv} (node-write +{reg}), "
                             "want +1")
    claimed = executor.claim_chain()
    if claimed is not None:
        raise AssertionError("the chain survived a node write")
    up0 = dict(executor.upload_bytes_by_cause)
    n_up0 = executor.stats["uploads"]
    reset_counts()
    pend, _, tm, _ = run_wave(h, evals, used0_dev=None, executor=executor)
    ph, eager = read_counts("reupload_wave")
    for k, v in ph.items():
        launches[k] += v
    if pend["chained"]:
        raise AssertionError("reupload_wave chained after a node write")
    placed, usage = check_store(h, jobs, PER_EVAL, all_jobs, zone_of,
                                N_ZONES)
    used_matches_store(h, pend["used"], usage)
    eng = executor.engine
    want = (sum(v.nbytes for v in eng._dev_cache.values())
            + eng._used_dev.nbytes)
    delta = cause_delta(executor, up0)
    if delta != {"initial-upload": want} \
            or executor.stats["uploads"] - n_up0 != 2:
        raise AssertionError(f"re-upload {delta} in "
                             f"{executor.stats['uploads'] - n_up0} "
                             f"uploads, want {want} in 2")
    emit({"phase": "executor_invalidation", "card": card,
          "invalidations": executor.stats["invalidations"],
          "reason": "node-write", "chained": pend["chained"],
          "evals": len(evals), "placements": placed, **tm,
          "reupload_bytes_by_cause": delta, "launches": ph,
          "eager": eager})


def device_wait_phase(card, h, executor, all_jobs, zone_of, launches):
    """WAIT_WAVES zoned waves under the port's PROFILER at WAIT_HZ, each
    collect's wait marked device-wait: the window's bucket split, the
    main thread's innermost frames (where the port's waits show, the
    frames profiling._DEVICE_WAIT_FUNCS names), each wait's seconds and
    the seconds of the result's pinned copy set-up in dispatch.  (A
    zoned wave's collect waits ~0.3 ms, the longest wait of the waves;
    the small wave's ends before the sampler's next sample.)"""
    from nomad_tpu_torch.core import profiling

    prof = profiling.PROFILER
    waves = [register_wave(h, f"device_wait_wave{i}", N_EVALS, PER_EVAL,
                           N_ZONES) for i in range(WAIT_WAVES)]

    def folds():
        out = {}
        for line in prof.folded().splitlines():
            stack, n = line.rsplit(" ", 1)
            out[stack] = int(n)
        return out

    eng = executor.engine
    start_fetch = eng._start_fetch
    fetch_s = []

    def timed_start_fetch(buf):
        t0 = time.perf_counter()
        out = start_fetch(buf)
        fetch_s.append(time.perf_counter() - t0)
        return out

    eng._start_fetch = timed_start_fetch
    timings = []
    prof.start(hz=WAIT_HZ)
    try:
        base, base_folds = prof.snapshot(), folds()
        reset_counts()
        for jobs, evals in waves:
            all_jobs += jobs
            pend, _, tm, _ = run_wave(h, evals, executor=executor,
                                      mark_wait=True)
            timings.append(tm)
        ph, eager = read_counts("device_wait_waves")
        cur, cur_folds = prof.snapshot(), folds()
    finally:
        prof.stop()
        del eng._start_fetch
    for k, v in ph.items():
        launches[k] += v
    # each wave's allocs and zones, then capacity once over every job
    placed = sum(check_store(h, jobs, PER_EVAL, [], zone_of, N_ZONES)[0]
                 for jobs, _ in waves)
    _, usage = check_store(h, [], PER_EVAL, all_jobs)
    used_matches_store(h, pend["used"], usage)
    buckets = {b: round(cur["buckets"].get(b, 0.0)
                        - base["buckets"].get(b, 0.0), 3)
               for b in profiling.BUCKETS}
    leaves = {}
    for stack, n in cur_folds.items():
        d = n - base_folds.get(stack, 0)
        if d > 0 and stack.startswith("other;"):
            leaf = stack.rsplit(";", 1)[-1]
            leaves[leaf] = leaves.get(leaf, 0) + d
    by_frames = sum(n for leaf, n in leaves.items()
                    if leaf.rsplit(":", 1)[-1]
                    in profiling._DEVICE_WAIT_FUNCS)
    if buckets["device-wait"] <= 0 or by_frames <= 0:
        raise AssertionError(f"no device-wait sample: buckets {buckets}, "
                             f"innermost frames {leaves}")
    emit({"phase": "device_wait", "card": card, "hz": WAIT_HZ,
          "samples": cur["samples"] - base["samples"],
          "buckets": buckets, "roles": profiling.role_window(base, cur),
          "main_thread_leaf_frames": dict(sorted(
              leaves.items(), key=lambda kv: -kv[1])[:10]),
          "device_wait_frames": sorted(profiling._DEVICE_WAIT_FUNCS),
          "samples_in_device_wait_frames": by_frames,
          "overhead_fraction": cur["overhead_fraction"],
          "waves": len(waves), "placements": placed, "timings": timings,
          "start_fetch_s": fetch_s, "launches": ph, "eager": eager})


# -------------------------------------------------------------- server

# the records by which the worker and the applier report a failure that
# their loop recovered from (nomad_tpu/core/worker.py:132, :202, :243,
# :341, :403; core/plan_apply.py:253): a kernel failure that the worker
# turned into a solo eval or a nack must not pass the server phase
RECOVERY_RECORDS = {
    ("worker", "worker iteration failed"),
    ("worker", "eval nacked"),
    ("worker", "batch pass failed; nacking remainder"),
    ("worker", "batch launch failed; going solo"),
    ("worker", "prefetch dispatch failed"),
    ("plan", "applier iteration failed"),
}
# the applier's refute warnings (core/plan_apply.py:357, :540, :749):
# the reference's behaviour, counted and printed, not gated
REFUTE_RECORDS = {("plan", "plan partially refuted"),
                  ("plan", "plan nodes refuted"),
                  ("plan", "block nodes refuted")}
# the waves of the server phase (bench.py config 5): a warm-up at
# cpu 1 / mem 1, then the measured wave at cpu 10 / mem 10
SERVER_WAVES = (("server_warmup_wave", 1), ("server_wave", 10))
# the kernels of a zoned server wave (K1, K2), and the solo path's (K5,
# K6), which a batched wave must not launch
SERVER_KERNELS = ("landscape", "multi_compact")
SOLO_KERNELS = ("place_scan", "multi_bulk")
SERVER_DEADLINE_S = 600.0


def config5_job(prefix: str, i: int, per_eval: int, cpu: int,
                n_zones: int):
    """bench.py run_config_5's make_job: job i of a wave, a batch job of
    `per_eval` placements at cpu `cpu` / mem `cpu`, claiming
    vol-zone{i % n_zones}."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs import VolumeRequest

    job = mock.batch_job(id=f"{prefix}-{i:04d}")
    job.datacenters = ["dc1", "dc2", "dc3"]
    tg = job.task_groups[0]
    tg.count = per_eval
    tg.tasks[0].resources.cpu = cpu
    tg.tasks[0].resources.memory_mb = cpu
    tg.volumes = {"data": VolumeRequest(
        name="data", type="csi", source=f"vol-zone{i % n_zones}",
        read_only=True)}
    return job


def server_jobs(s, prefix: str, n_evals: int, per_eval: int, cpu: int,
                n_zones: int):
    """A wave's jobs (config5_job), each registered through
    Server.register_job (the job endpoint: upsert, eval, enqueue).
    Returns (jobs, evals)."""
    jobs, evals = [], []
    for i in range(n_evals):
        job = config5_job(prefix, i, per_eval, cpu, n_zones)
        evals.append(s.register_job(job))
        jobs.append(job)
    return jobs, evals


def drain(s, evals, deadline_s: float = SERVER_DEADLINE_S) -> float:
    """bench.py run_config_5's drain: the packer synced outside the timed
    window, then start_scheduling, the evals' statuses polled on the
    live store until each settles or the deadline passes, then
    stop_scheduling.  Returns the wall seconds from the start to the
    last settled eval's poll."""
    s.engine.packer.update(s.state.snapshot())
    t0 = time.perf_counter()
    s.start_scheduling()
    try:
        pending = {e.id for e in evals}
        end = t0 + deadline_s
        while pending and time.perf_counter() < end:
            pending = {eid for eid in pending
                       if (ev := s.state.eval_by_id(eid)) is None
                       or ev.status not in ("complete", "failed",
                                            "canceled")}
            if pending:
                time.sleep(0.005)
        dt = time.perf_counter() - t0
    finally:
        s.stop_scheduling()
    if pending:
        raise AssertionError(f"{len(pending)} evals unsettled after "
                             f"{deadline_s} s")
    return dt


def server_wave(s, name, jobs, evals, all_jobs, zone_of, n_zones,
                per_eval, settle=drain):
    """One drained wave through the Server's threaded loop, with the
    kernels' counts zeroed just before it and read just after, the log
    ring's records of the wave, the plan queue's latencies, the stage
    timers, the pipeline's and the applier's stats and the executor's
    dispatches and uploads of the wave.  Gates: every eval complete and
    every placement committed, allocs in their zones, no node over
    capacity, the retained chain's usage equal to the store's, each of
    SERVER_KERNELS launched and no solo kernel, no recovery record, one
    `device` interval per dispatched wave.  `settle(s, evals)` runs the
    wave and returns its wall seconds (`drain`, or the agent phase's
    `http_drain`)."""
    import torch

    from nomad_tpu_torch.core.logging import RING
    from nomad_tpu_torch.core.telemetry import REGISTRY

    pipe = s.workers[0].pipeline
    ex = s.executor
    s.plan_queue.latencies.clear()
    s.plan_applier.stats.update(plans=0, plans_refuted=0)
    s.stage_timers.reset()
    pipe0 = dict(pipe.stats)
    ex0 = dict(ex.stats)
    up0 = dict(ex.upload_bytes_by_cause)
    dropped0 = REGISTRY.counter("nomad.logring.dropped",
                                reason="subscriber")
    gc0 = GC2["n"], GC2["s"]
    sub = RING.subscribe(maxsize=1 << 20)
    try:
        reset_counts()
        wall = settle(s, evals)
        ph, eager = read_counts(name)
    finally:
        RING.unsubscribe(sub)
    records = []
    while not sub.empty():
        records.append(sub.get_nowait())
    if REGISTRY.counter("nomad.logring.dropped",
                        reason="subscriber") != dropped0:
        raise AssertionError(f"{name}: log records dropped")
    failures = [r for r in records
                if (r["component"], r["msg"]) in RECOVERY_RECORDS]
    if failures:
        raise AssertionError(f"{name}: the loop recovered from a failure: "
                             f"{failures[:5]}")
    refutes = {}
    for r in records:
        if (r["component"], r["msg"]) in REFUTE_RECORDS:
            refutes[r["msg"]] = refutes.get(r["msg"], 0) + 1
    statuses = [s.state.eval_by_id(e.id).status for e in evals]
    if any(st != "complete" for st in statuses):
        by = {st: statuses.count(st) for st in set(statuses)}
        raise AssertionError(f"{name}: eval statuses {by}")
    placed, usage = check_store(s, jobs, per_eval, all_jobs, zone_of,
                                n_zones)
    chain = ex._chains.get("")
    if chain is None:
        raise AssertionError(f"{name}: no chain retained after the wave")
    used_matches_store(s, chain[2][0], usage)
    if (any(ph[k] < 1 for k in SERVER_KERNELS)
            or any(ph[k] for k in SOLO_KERNELS)):
        raise AssertionError(f"{name} launches {ph}: want "
                             f"{SERVER_KERNELS}, no {SOLO_KERNELS}")
    waves = pipe.stats["waves"] - pipe0["waves"]
    counts = s.stage_timers.counts()
    if waves < 1 or counts.get("device", 0) != waves:
        raise AssertionError(f"{name}: {waves} waves dispatched, "
                             f"{counts.get('device', 0)} device intervals")
    q = s.plan_queue.latency_quantiles((0.5, 0.99))
    return {"evals": len(evals), "placements": placed, "wall_s": wall,
            "evals_per_s": len(evals) / wall,
            "placements_per_s": placed / wall,
            "plan_queue_p50_s": q["p50"], "plan_queue_p99_s": q["p99"],
            "stage_s": s.stage_timers.totals(), "stage_counts": counts,
            "pipeline": {k: pipe.stats[k] - pipe0[k] for k in pipe0},
            "plans": s.plan_applier.stats["plans"],
            "plans_refuted": s.plan_applier.stats["plans_refuted"],
            "refute_records": refutes,
            "dispatches": ex.stats["dispatches"] - ex0["dispatches"],
            "resident_waves": (ex.stats["resident_waves"]
                               - ex0["resident_waves"]),
            "upload_bytes_by_cause": cause_delta(ex, up0),
            "launches": ph, "eager": eager,
            "memory_allocated": (torch.cuda.memory_allocated()
                                 if torch.cuda.is_available() else 0),
            "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                     if torch.cuda.is_available() else 0),
            "gc2_n": GC2["n"] - gc0[0], "gc2_s": GC2["s"] - gc0[1]}


def server_phase(card, launches, n_nodes: int = N_NODES,
                 n_evals: int = N_EVALS, per_eval: int = PER_EVAL,
                 n_zones: int = N_ZONES, device=None):
    """bench.py config 5 through the port's Server in thread mode
    (dev_mode=False, one worker, eval_batch n_evals, a TorchExecutor):
    a fresh cluster built through the Server's store, leadership, then
    each of SERVER_WAVES registered through the job endpoint and
    drained (server_wave).  The sampler runs at its default rate, as in
    a fresh process's Server, and is stopped after shutdown; the
    Server's hooks on the process planes are cleared so that its
    tensors are freed before the next phase (the store's subscribers
    hold the executor, and through it the engine)."""
    import weakref

    import torch

    from nomad_tpu_torch.core import memledger, profiling
    from nomad_tpu_torch.core.server import Server

    profiling.PROFILER.hz = profiling.DEFAULT_HZ
    t0 = time.perf_counter()
    s = Server(dev_mode=False, num_workers=1, eval_batch=n_evals,
               heartbeat_ttl=1e9, nack_timeout=600.0,
               device_executor="torch", device=device)
    engine_ref = weakref.ref(s.engine)
    try:
        s.establish_leadership()
        zone_of = build_cluster(s, n_nodes, n_zones)
        build_s = time.perf_counter() - t0
        all_jobs = []
        for name, cpu in SERVER_WAVES:
            t1 = time.perf_counter()
            jobs, evals = server_jobs(s, name, n_evals, per_eval, cpu,
                                      n_zones)
            all_jobs += jobs
            register_s = time.perf_counter() - t1
            line = server_wave(s, name, jobs, evals, all_jobs, zone_of,
                               n_zones, per_eval)
            for k, v in line["launches"].items():
                launches[k] += v
            emit({"phase": name, "card": card, "nodes": n_nodes,
                  "cluster_build_s": build_s, "register_s": register_s,
                  **line})
    finally:
        s.shutdown()
        profiling.PROFILER.stop()
        profiling.PROFILER.device_ledger_provider = None
        for plane in ("state", "journal", "watch_hub", "events"):
            memledger.MEMLEDGER.unregister(plane)
    del s
    gc.collect()
    if engine_ref() is not None:
        raise AssertionError("the Server's engine outlived its shutdown")
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


# --------------------------------------------------------------- agent

# the agent phases: config 5 through the port's own front door.  The
# waves of agent_waves (bench.py config 5, as SERVER_WAVES), the
# datacenter of its two in-process clients (no config 5 placement can
# land there: the waves' jobs ask for dc1-dc3), and the least gap
# between two settlement polls.  One caller registers the cluster and
# the jobs: eight caller threads were no faster (they share the agent's
# interpreter lock with its request threads)
AGENT_WAVES = (("agent_warmup_wave", 1), ("agent_wave", 10))
AGENT_DC = "dc-agent"
AGENT_POLL_S = 0.02
# the batch jobs of agent_cli, three so that their blocked evals are
# released together and the worker takes them as one wave
CLI_BATCH_JOBS = 3
CLI_BATCH_HCL = """job "%s" {
  datacenters = ["dc1"]
  type        = "batch"
  group "g" {
    count = 2
    task "t" {
      driver = "mock"
      config { run_for_s = 1 }
      resources {
        cpu    = 100
        memory = 64
      }
    }
  }
}
"""


def http_drain(s, api, eval_ids, deadline_s: float = SERVER_DEADLINE_S,
               poll_s: float = AGENT_POLL_S, polls=None) -> float:
    """`drain` through the HTTP API: the packer synced outside the timed
    window, start_scheduling, then settlement polled through the API no
    more often than every `poll_s`: GET /v1/evaluation/<id> of the last
    unsettled eval (the last registered first), and once it has
    settled, GET /v1/evaluations for the rest; then stop_scheduling.
    Returns the wall seconds from the start to the poll that saw the
    last eval settled; `polls` (a list) gets the number of requests."""
    done = ("complete", "failed", "canceled")
    s.engine.packer.update(s.state.snapshot())
    t0 = time.perf_counter()
    s.start_scheduling()
    n = 0
    try:
        pending = list(eval_ids)
        end = t0 + deadline_s
        while pending and time.perf_counter() < end:
            t_poll = time.perf_counter()
            n += 1
            if api.evaluations.info(pending[-1])["Status"] in done:
                n += 1
                status = {e["ID"]: e["Status"]
                          for e in api.evaluations.list()}
                pending = [e for e in pending if status.get(e) not in done]
            if pending:
                time.sleep(max(0.0, poll_s - (time.perf_counter()
                                              - t_poll)))
        dt = time.perf_counter() - t0
    finally:
        s.stop_scheduling()
    if polls is not None:
        polls.append(n)
    if pending:
        raise AssertionError(f"{len(pending)} evals unsettled after "
                             f"{deadline_s} s")
    return dt


def columnar_gate(api, name, jobs, per_eval, zone_of, n_zones) -> int:
    """Every placement of `jobs` read back through GET
    /v1/allocations?columnar=true, each on a node of its volume's zone.
    Returns the rows read."""
    doc = api.request("GET", "/v1/allocations",
                      params={"columnar": "true"})
    cols = doc["Columns"]
    want = {job.id: i for i, job in enumerate(jobs)}
    count = dict.fromkeys(want, 0)
    for jid, nid in zip(cols["JobID"], cols["NodeID"]):
        i = want.get(jid)
        if i is None:
            continue
        count[jid] += 1
        if zone_of.get(nid) != i % n_zones:
            raise AssertionError(f"{name}: an alloc of {jid} on {nid}, "
                                 f"outside zone{i % n_zones}")
    short = {j: c for j, c in count.items() if c != per_eval}
    if short:
        raise AssertionError(f"{name}: allocs read back per job differ "
                             f"from {per_eval}: "
                             f"{list(short.items())[:5]}")
    return doc["Count"]


def agent_web(agent, api, timeout_s: float = 120.0) -> float:
    """examples/web.hcl through the agent's HTTP API, its datacenters
    set to the clients' own, until its three allocs run on the two
    in-process clients.  Returns the seconds from the register."""
    from nomad_tpu_torch import jobspec
    from nomad_tpu_torch.structs import codec

    job = jobspec.parse_file("examples/web.hcl")
    job.datacenters = [AGENT_DC]
    clients = {c.node.id for c in agent.clients}
    agent.server.start_scheduling()
    t0 = time.perf_counter()
    api.jobs.register(codec.encode(job))
    while time.perf_counter() - t0 < timeout_s:
        allocs = api.jobs.allocations("web")
        if (len(allocs) == 3
                and all(a["ClientStatus"] == "running" for a in allocs)):
            break
        time.sleep(0.05)
    else:
        raise AssertionError(f"web did not run: {allocs}")
    if {a["NodeID"] for a in allocs} - clients:
        raise AssertionError(f"web ran off the clients: {allocs}")
    running_s = time.perf_counter() - t0
    # stopped through the API too: its task runners end, and with them
    # the clients' references to the server
    api.jobs.deregister("web")
    while time.perf_counter() - t0 < 2 * timeout_s:
        if all(a["ClientStatus"] != "running"
               for a in api.jobs.allocations("web")):
            return running_s
        time.sleep(0.05)
    raise AssertionError("web's allocs did not stop")


def agent_phase(card, launches, n_nodes: int = N_NODES,
                n_evals: int = N_EVALS, per_eval: int = PER_EVAL,
                n_zones: int = N_ZONES, device=None):
    """bench.py config 5 through the HTTP API of an in-process port
    Agent: one worker (eval_batch n_evals), a TorchExecutor, two
    in-process clients on the mock driver in AGENT_DC, HTTP on a free
    port.  Through the agent's APIClient only: the cluster's nodes
    (`PUT /v1/nodes`), the zones' volumes (the CSI volume endpoint),
    then each of AGENT_WAVES (`PUT /v1/jobs`) with scheduling paused
    around its registration and settled through the API (http_drain),
    its placements read back through the columnar allocations;
    server_wave's gates.  Then web.hcl on the two clients.  Shut down
    and freed as server_phase's Server."""
    import types
    import weakref

    import torch

    from nomad_tpu_torch.agent import Agent
    from nomad_tpu_torch.api.client import APIClient
    from nomad_tpu_torch.core import memledger, profiling
    from nomad_tpu_torch.structs import Node, codec

    profiling.PROFILER.hz = profiling.DEFAULT_HZ
    t0 = time.perf_counter()
    agent = Agent(num_clients=2, num_workers=1, http_host="127.0.0.1",
                  http_port=0, heartbeat_ttl=1e9, device_executor="torch",
                  device=device,
                  nodes=[Node(id=f"agent-client-{i}",
                              name=f"agent-client-{i}", datacenter=AGENT_DC)
                         for i in range(2)])
    s = agent.server
    s.eval_batch = n_evals
    s.eval_broker.nack_timeout = 600.0
    engine_ref = weakref.ref(s.engine)
    try:
        agent.start()
        start_s = time.perf_counter() - t0
        api = APIClient(address=agent.address)
        nodes, zone_of, zone_nodes = cluster_nodes(n_nodes, n_zones)
        t1 = time.perf_counter()
        wires = [{"Node": codec.encode(n)} for n in nodes]
        encode_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        for w in wires:
            api.put("/v1/nodes", w)
        node_register_s = time.perf_counter() - t1
        del wires
        t1 = time.perf_counter()
        for z in range(n_zones):
            api.volumes.register(
                f"vol-zone{z}", "ebs0",
                AccessMode="multi-node-multi-writer",
                TopologyNodeIDs=zone_nodes[z])
        volume_register_s = time.perf_counter() - t1
        counts = s.state.counts()
        if counts["nodes"] != n_nodes + 2:
            raise AssertionError(f"{counts['nodes']} nodes in the store, "
                                 f"want {n_nodes} + 2 clients")
        all_jobs = []
        for name, cpu in AGENT_WAVES:
            s.stop_scheduling()
            jobs = [config5_job(name, i, per_eval, cpu, n_zones)
                    for i in range(n_evals)]
            wires = [codec.encode(j) for j in jobs]
            t1 = time.perf_counter()
            resp = [api.jobs.register(w) for w in wires]
            register_s = time.perf_counter() - t1
            all_jobs += jobs
            eval_ids = [r["EvalID"] for r in resp]
            polls = []
            line = server_wave(
                s, name, jobs,
                [types.SimpleNamespace(id=e) for e in eval_ids], all_jobs,
                zone_of, n_zones, per_eval,
                settle=lambda s, evals: http_drain(s, api, eval_ids,
                                                   polls=polls))
            rows = columnar_gate(api, name, jobs, per_eval, zone_of,
                                 n_zones)
            for k, v in line["launches"].items():
                launches[k] += v
            emit({"phase": name, "card": card, "nodes": n_nodes,
                  "agent_start_s": start_s, "node_encode_s": encode_s,
                  "node_register_s": node_register_s,
                  "nodes_per_s": n_nodes / node_register_s,
                  "volume_register_s": volume_register_s,
                  "register_s": register_s,
                  "jobs_per_s": n_evals / register_s,
                  "settle_polls": polls[0], "columnar_rows": rows,
                  **line})
        web_s = agent_web(agent, api)
        emit({"phase": "agent_web", "card": card, "clients": 2,
              "web_running_s": web_s})
    finally:
        agent.shutdown()
        profiling.PROFILER.stop()
        profiling.PROFILER.device_ledger_provider = None
        for plane in ("state", "journal", "watch_hub", "events"):
            memledger.MEMLEDGER.unregister(plane)
    del s, agent
    gc.collect()
    if engine_ref() is not None:
        raise AssertionError("the Agent's engine outlived its shutdown")
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def agent_cli_phase(card, out_dir: str = ".smoke/agent_cli",
                    timeout_s: float = 120.0):
    """The user's own path in subprocesses: `python -m nomad_tpu_torch
    agent -bind 127.0.0.1:<free port> -clients 2` (on CUDA, its default),
    /v1/status/leader waited for, `job run examples/web.hcl` and `job
    status web` until three allocs run; then both clients made
    ineligible, CLI_BATCH_JOBS batch jobs run (their evals block), one
    client made eligible again (the blocked evals are released together
    and scheduled as one wave) and each job's allocs waited for; then
    the executor's registry counters (GET /v1/metrics) and its ledger
    (GET /v1/operator/debug): at least one upload and one dispatch.
    SIGINT ends the agent: exit code 0 and no traceback required."""
    import os
    import signal
    import urllib.request

    os.makedirs(out_dir, exist_ok=True)
    port = free_port()
    addr = f"http://127.0.0.1:{port}"
    py = [sys.executable, "-m", "nomad_tpu_torch"]

    def cli(*argv):
        return subprocess.run(py + ["-address", addr, *argv],
                              capture_output=True, text=True, timeout=60,
                              check=True).stdout

    def get(path):
        with urllib.request.urlopen(addr + path, timeout=10) as r:
            return json.loads(r.read())

    def wait(what, ok):
        end = time.perf_counter() + timeout_s
        while time.perf_counter() < end:
            if proc.poll() is not None:
                with open(err_path) as f:
                    tail = f.read()[-2000:]
                raise AssertionError(f"the agent exited ({proc.returncode}) "
                                     f"waiting for {what}: {tail}")
            if ok():
                return
            time.sleep(0.2)
        raise AssertionError(f"timed out waiting for {what}")

    def leader():
        try:
            return bool(get("/v1/status/leader"))
        except OSError:
            return False

    for i in range(CLI_BATCH_JOBS):
        with open(os.path.join(out_dir, f"batch{i}.hcl"), "w") as f:
            f.write(CLI_BATCH_HCL % f"smoke-batch-{i}")
    err_path = os.path.join(out_dir, "agent.stderr")
    t0 = time.perf_counter()
    with open(os.path.join(out_dir, "agent.stdout"), "w") as out, \
            open(err_path, "w") as err:
        proc = subprocess.Popen(
            py + [
                "agent", "-bind", f"127.0.0.1:{port}", "-clients", "2",
                "-data-dir", os.path.join(out_dir, "data")],
            stdout=out, stderr=err)
        try:
            wait("/v1/status/leader", leader)
            leader_s = time.perf_counter() - t0
            t1 = time.perf_counter()
            cli("job", "run", "examples/web.hcl")
            wait("three running web allocs", lambda: cli(
                "job", "status", "web").count("run/running") == 3)
            web_s = time.perf_counter() - t1
            node_ids = [ln.split()[0] for ln in
                        cli("node", "status").splitlines() if ln.strip()]
            if len(node_ids) != 2:
                raise AssertionError(f"nodes: {node_ids}")
            for nid in node_ids:
                cli("node", "eligibility", "-disable", nid)
            for i in range(CLI_BATCH_JOBS):
                cli("job", "run", os.path.join(out_dir, f"batch{i}.hcl"))
            cli("node", "eligibility", "-enable", node_ids[0])
            for i in range(CLI_BATCH_JOBS):
                wait(f"smoke-batch-{i}'s allocs", lambda i=i: cli(
                    "job", "status", f"smoke-batch-{i}").count(
                    "  g  ") == 2)
            metrics = get("/v1/metrics")
            ledger = get("/v1/operator/debug")["DeviceLedger"]
        finally:
            if proc.poll() is None:
                proc.send_signal(signal.SIGINT)
            try:
                rc = proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                raise AssertionError("the agent did not exit on SIGINT")
    with open(err_path) as f:
        stderr = f.read()
    if rc != 0 or "Traceback" in stderr:
        raise AssertionError(f"the agent exited {rc}: {stderr[-2000:]}")
    executor = {k: v for k, v in metrics.items()
                if k.startswith("nomad.executor.")}
    if (metrics.get("nomad.executor.uploads", 0) < 1
            or ledger["dispatches"] < 1):
        raise AssertionError(f"executor: {executor}, ledger dispatches "
                             f"{ledger['dispatches']}")
    emit({"phase": "agent_cli", "card": card, "leader_s": leader_s,
          "web_running_s": web_s, "total_s": time.perf_counter() - t0,
          "exit_code": rc, "uploads": metrics["nomad.executor.uploads"],
          "dispatches": ledger["dispatches"],
          "resident_waves": ledger["resident_waves"],
          "compile_sites": sorted(ledger["compile"]["sites"]),
          "executor_metrics": executor})


# ------------------------------------------------------------- cluster

# the cluster phase: config 5 through a three-server port cluster, each
# server an in-process Agent in cluster mode (Raft, gossip, RPC on
# loopback TCP).  The 50,000 nodes go through the leader's replicated
# store in chunks of CLUSTER_SEED_CHUNK (one Raft entry each, a few MB:
# the AppendEntries frame stays well inside the transport's 5 s read
# timeout and the 10 s commit timeout); wave 1 is config 5 at its full
# width through a follower's HTTP API; the failover wave, after the
# leader's shutdown, is CLUSTER_FAIL_EVALS x PER_EVAL through the
# surviving follower
CLUSTER_SERVERS = 3
CLUSTER_SEED_CHUNK = 5_000
CLUSTER_FAIL_EVALS = 48
CLUSTER_WAIT_S = 120.0
# Raft timings of the cluster's servers, set on each RaftNode before it
# starts (the Agent has no knob for them; Nomad's is raft_multiplier):
# three servers share one interpreter here, and by this phase a full
# collection of its heap stops every thread for 2-3 s (`gc2_s`), longer
# than the default 0.3-0.6 s election window, so elections wait 5-10 s
CLUSTER_RAFT = {"heartbeat_interval": 0.2, "election_timeout": (5.0, 10.0)}
# the executor's invalidation reasons (ops/executor.py)
INVALIDATION_REASONS = ("foreign-plan", "node-write", "restore",
                        "capacity-freed", "stale-node-table",
                        "client-drop", "close", "explicit")


def cluster_leader(agents, deadline_s: float = CLUSTER_WAIT_S):
    """Poll GET /v1/status/leader on every agent until all answer the
    same non-empty RPC address and that server has established its
    leadership.  Returns (the leader's agent, seconds waited)."""
    from nomad_tpu_torch.api.client import APIClient, APIException

    apis = [APIClient(address=a.address) for a in agents]
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < deadline_s:
        try:
            seen = {api.get("/v1/status/leader") for api in apis}
        except (OSError, APIException):
            seen = set()
        if len(seen) == 1 and "" not in seen:
            addr = seen.pop()
            for a in agents:
                rpc = a.server.rpc.addr
                if (f"{rpc[0]}:{rpc[1]}" == addr
                        and getattr(a.server, "_leader", False)):
                    return a, time.perf_counter() - t0
        time.sleep(0.05)
    raise AssertionError(f"no leader within {deadline_s} s")


def raft_span(raft, lo: int, hi: int):
    """(entries, command bytes) of the leader's log in (lo, hi]."""
    ents = [e for e in raft.log if lo < e.index <= hi and e.cmd]
    return len(ents), sum(len(e.cmd) for e in ents)


def caught_up(agents, index: int, deadline_s: float = CLUSTER_WAIT_S):
    """Wait until every agent's FSM has applied `index`; seconds."""
    t0 = time.perf_counter()
    while any(a.server.raft.last_applied < index for a in agents):
        if time.perf_counter() - t0 > deadline_s:
            raise AssertionError(
                f"followers behind {index}: "
                f"{[a.server.raft.last_applied for a in agents]}")
        time.sleep(0.005)
    return time.perf_counter() - t0


def invalidations():
    from nomad_tpu_torch.core.telemetry import REGISTRY

    return {r: REGISTRY.counter("nomad.executor.invalidations", reason=r)
            for r in INVALIDATION_REASONS}


def follower_gates(name, leader, followers, jobs, per_eval, all_jobs,
                   zone_of, n_zones, ex0, up0):
    """Each follower's store holds the leader's allocs of `all_jobs` with
    the same per-node usage (store_gates on the follower's store), and
    its executor dispatched and uploaded nothing since (ex0, up0)."""
    placed, usage = check_store(leader.server, jobs, per_eval, all_jobs,
                                zone_of, n_zones)
    ids = {a.id for j in all_jobs for a in leader.server.state.allocs_by_job(
        j.namespace, j.id)}
    for f in followers:
        s = f.server
        f_placed, f_usage = check_store(s, jobs, per_eval, all_jobs,
                                        zone_of, n_zones)
        f_ids = {a.id for j in all_jobs
                 for a in s.state.allocs_by_job(j.namespace, j.id)}
        if (f_placed, f_usage, f_ids) != (placed, usage, ids):
            raise AssertionError(f"{name}: follower {s.name}'s store "
                                 f"differs from the leader's")
        if (s.executor.stats["dispatches"] != ex0[s.name]["dispatches"]
                or s.executor.stats["uploads"] != ex0[s.name]["uploads"]
                or dict(s.executor.upload_bytes_by_cause) != up0[s.name]):
            raise AssertionError(f"{name}: follower {s.name}'s executor "
                                 f"dispatched or uploaded")
    return placed


def no_duplicates(name, server, all_jobs):
    """No alloc id and no (job, alloc name) held twice by live allocs."""
    seen_ids, seen_names = set(), set()
    for j in all_jobs:
        for a in server.state.allocs_by_job(j.namespace, j.id):
            if a.terminal_status():
                continue
            if a.id in seen_ids or (j.id, a.name) in seen_names:
                raise AssertionError(f"{name}: alloc {a.id} ({a.name}) "
                                     f"placed twice")
            seen_ids.add(a.id)
            seen_names.add((j.id, a.name))
    return len(seen_ids)


def cluster_wave(name, leader, followers, api, n_evals, per_eval, cpu,
                 n_zones, all_jobs, zone_of):
    """One wave of config5_job through `api` (a follower's HTTP API: the
    writes are forwarded to the leader) with the leader's scheduling
    paused around the registration, then settled as agent_waves does
    (http_drain, polling through the same follower) and gated by
    server_wave on the leader; then the followers caught up to the
    leader's commit index and their stores and executors checked
    (follower_gates).  Returns the wave's line."""
    import types

    from nomad_tpu_torch.structs import codec

    s = leader.server
    raft = s.raft
    s.stop_scheduling()
    jobs = [config5_job(name, i, per_eval, cpu, n_zones)
            for i in range(n_evals)]
    wires = [codec.encode(j) for j in jobs]
    t1 = time.perf_counter()
    resp = [api.jobs.register(w) for w in wires]
    register_s = time.perf_counter() - t1
    all_jobs += jobs
    eval_ids = [r["EvalID"] for r in resp]
    ex0 = {f.server.name: dict(f.server.executor.stats) for f in followers}
    up0 = {f.server.name: dict(f.server.executor.upload_bytes_by_cause)
           for f in followers}
    inv0 = invalidations()
    c0 = raft.commit_index
    line = server_wave(
        s, name, jobs, [types.SimpleNamespace(id=e) for e in eval_ids],
        all_jobs, zone_of, n_zones, per_eval,
        settle=lambda s, evals: http_drain(s, api, eval_ids))
    c1 = raft.commit_index
    lag_s = caught_up(followers, c1)
    commits, commit_bytes = raft_span(raft, c0, c1)
    follower_gates(name, leader, followers, jobs, per_eval, all_jobs,
                   zone_of, n_zones, ex0, up0)
    live = no_duplicates(name, s, all_jobs)
    inv1 = invalidations()
    line.update({
        "register_s": register_s, "jobs_per_s": n_evals / register_s,
        "raft_commits": commits, "raft_commit_bytes": commit_bytes,
        "raft_index": c1, "follower_catch_up_s": lag_s,
        "live_allocs": live,
        "invalidations_by_reason": {r: inv1[r] - inv0[r] for r in inv1
                                    if inv1[r] != inv0[r]}})
    return line


def cluster_phase(card, launches, n_nodes: int = N_NODES,
                  n_evals: int = N_EVALS, per_eval: int = PER_EVAL,
                  n_zones: int = N_ZONES,
                  fail_evals: int = CLUSTER_FAIL_EVALS,
                  chunk: int = CLUSTER_SEED_CHUNK, device=None,
                  out_dir: str = ".smoke/cluster_waves"):
    """bench.py config 5 through a three-server port cluster in one
    process: CLUSTER_SERVERS Agents in cluster mode (server_name s1-s3,
    bootstrap_expect 3, each joining the others' gossip ports, TCP on
    loopback, no encrypt, one worker with eval_batch n_evals, a
    TorchExecutor, a large heartbeat TTL), then two in-process clients
    in AGENT_DC on a follower, reaching the servers through RemoteRPC.
    Elect (GET /v1/status/leader on all three), seed the nodes through
    the leader's replicated upsert_nodes in chunks and the zones'
    volumes through a follower's HTTP API, wave 1 (config 5 at full
    width, cluster_wave), then the leader shut down, a survivor elected
    and the failover wave (fail_evals x per_eval) through the surviving
    follower: the new leader's executor launches K2, no alloc is placed
    twice and capacity holds with wave 1's allocs.  Shut down and freed
    as agent_phase's Agent."""
    import os
    import weakref

    import torch

    from nomad_tpu_torch.agent import Agent
    from nomad_tpu_torch.api.client import APIClient
    from nomad_tpu_torch.client.client import Client
    from nomad_tpu_torch.core import memledger, profiling
    from nomad_tpu_torch.core.cluster import RemoteRPC
    from nomad_tpu_torch.structs import Node

    profiling.PROFILER.hz = profiling.DEFAULT_HZ
    threads0 = set(threading.enumerate())
    t0 = time.perf_counter()
    serf = [free_port() for _ in range(CLUSTER_SERVERS)]
    agents, clients = [], []
    for i in range(CLUSTER_SERVERS):
        a = Agent(num_clients=0, num_workers=1, http_host="127.0.0.1",
                  http_port=0, heartbeat_ttl=1e9, device_executor="torch",
                  device=device, server_name=f"s{i + 1}",
                  bootstrap_expect=CLUSTER_SERVERS, serf_port=serf[i],
                  join=[f"127.0.0.1:{p}" for j, p in enumerate(serf)
                        if j != i])
        a.server.eval_batch = n_evals
        a.server.eval_broker.nack_timeout = 600.0
        for k, v in CLUSTER_RAFT.items():
            setattr(a.server.raft, k, v)
        agents.append(a)
    engine_refs = [weakref.ref(a.server.engine) for a in agents]
    try:
        for a in agents:
            a.start()
        build_s = time.perf_counter() - t0
        leader, election_s = cluster_leader(agents)
        followers = [a for a in agents if a is not leader]
        fapi = APIClient(address=followers[0].address)
        os.makedirs(out_dir, exist_ok=True)
        rpc = RemoteRPC([followers[1].server.rpc.addr])
        for i in range(2):
            cdir = os.path.join(out_dir, f"client{i}")
            os.makedirs(cdir, exist_ok=True)
            clients.append(Client(rpc, node=Node(
                id=f"cluster-client-{i}", name=f"cluster-client-{i}",
                datacenter=AGENT_DC), data_dir=cdir))
        for c in clients:
            c.start()

        # seed: the nodes through the leader's replicated store, the
        # volumes through a follower's HTTP API (forwarded)
        nodes, zone_of, zone_nodes = cluster_nodes(n_nodes, n_zones)
        raft = leader.server.raft
        c0 = raft.commit_index
        t1 = time.perf_counter()
        for k in range(0, n_nodes, chunk):
            leader.server.state.upsert_nodes(nodes[k:k + chunk])
        node_seed_s = time.perf_counter() - t1
        seed_entries, seed_bytes = raft_span(raft, c0, raft.commit_index)
        seed_catch_up_s = caught_up(followers, raft.commit_index)
        del nodes
        t1 = time.perf_counter()
        for z in range(n_zones):
            fapi.volumes.register(
                f"vol-zone{z}", "ebs0",
                AccessMode="multi-node-multi-writer",
                TopologyNodeIDs=zone_nodes[z])
        volume_register_s = time.perf_counter() - t1
        caught_up(followers, raft.commit_index)
        for a in agents:
            counts = a.server.state.counts()
            if counts["nodes"] != n_nodes + len(clients):
                raise AssertionError(
                    f"{a.server.name}: {counts['nodes']} nodes, want "
                    f"{n_nodes} + {len(clients)} clients")

        # wave 1: config 5 at full width through a follower
        all_jobs = []
        line = cluster_wave("cluster_wave", leader, followers, fapi,
                            n_evals, per_eval, 10, n_zones, all_jobs,
                            zone_of)
        for k, v in line["launches"].items():
            launches[k] += v
        emit({"phase": "cluster_wave", "card": card, "nodes": n_nodes,
              "servers": CLUSTER_SERVERS, "leader": leader.server.name,
              "cluster_start_s": build_s, "election_s": election_s,
              "node_seed_s": node_seed_s, "seed_chunk": chunk,
              "seed_raft_entries": seed_entries,
              "seed_raft_bytes": seed_bytes,
              "seed_catch_up_s": seed_catch_up_s,
              "volume_register_s": volume_register_s, **line})

        # wave 2: the leader shut down, a survivor leads
        old = leader
        t1 = time.perf_counter()
        agents.remove(old)
        old.shutdown()
        old_name = old.server.name
        del old
        leader, _ = cluster_leader(agents)
        failover_s = time.perf_counter() - t1
        followers = [a for a in agents if a is not leader]
        line = cluster_wave("cluster_failover_wave", leader, followers,
                            APIClient(address=followers[0].address),
                            fail_evals, per_eval, 10, n_zones, all_jobs,
                            zone_of)
        for k, v in line["launches"].items():
            launches[k] += v
        emit({"phase": "cluster_failover_wave", "card": card,
              "old_leader": old_name, "leader": leader.server.name,
              "failover_s": failover_s,
              "memory_allocated": (torch.cuda.memory_allocated()
                                   if torch.cuda.is_available() else 0),
              **line})
    finally:
        for c in clients:
            c.shutdown()
        for a in agents:
            a.shutdown()
        profiling.PROFILER.stop()
        profiling.PROFILER.device_ledger_provider = None
        for plane in ("state", "journal", "watch_hub", "events"):
            memledger.MEMLEDGER.unregister(plane)
    del agents, leader, followers, a, raft
    # the servers' daemon threads (Raft, gossip, RPC serving, autopilot)
    # end within their join timeouts after shutdown; their frames hold
    # the servers until then
    end = time.perf_counter() + CLUSTER_WAIT_S
    while (set(threading.enumerate()) - threads0
           and time.perf_counter() < end):
        time.sleep(0.1)
    gc.collect()
    if any(r() is not None for r in engine_refs):
        raise AssertionError(
            "a cluster Agent's engine outlived its shutdown; threads "
            f"left: {[t.name for t in set(threading.enumerate()) - threads0]}")
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


# ------------------------------------------------------------- timing

def time_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def timing(fn, reps: int) -> dict:
    """A kernel row's `ms` (time_ms over `reps` back-to-back calls: the
    wall time per call) and the loop itself, kept for the row's device
    window at the end of the run (device_phase)."""
    return {"ms": time_ms(fn, reps), "_timed": (fn, reps)}


def paired_timing(kernel_fn, library_fn, rounds: int = REPLAY_ROUNDS,
                  reps: int = REPLAY_REPS) -> dict:
    """`ms` and `library_ms` of a kernel's wrapper and of the one
    PyTorch call that computes its function, timed in turns (kernel,
    library, library, kernel, ...): `rounds` loops of `reps` calls after
    10 warm-up calls each, the median loop of each side.  One loop of a
    call of a few microseconds moves by a third with the host's load, so
    a single loop of each, taken at two moments, cannot order two calls
    that differ by a tenth."""
    loops = {kernel_fn: [], library_fn: []}
    for i in range(rounds):
        for fn in ((kernel_fn, library_fn) if i % 2 == 0
                   else (library_fn, kernel_fn)):
            loops[fn].append(time_ms(fn, reps, 10))
    return {"ms": statistics.median(loops[kernel_fn]),
            "library_ms": statistics.median(loops[library_fn]),
            "ms_loops": loops[kernel_fn],
            "library_ms_loops": loops[library_fn],
            "_timed": (kernel_fn, reps), "_library_timed": (library_fn, reps)}


def device_ms(fn, reps: int):
    """Device time per call of `fn`: one torch.profiler window (CPU and
    CUDA activities) over `reps` calls after a warm-up call, summing the
    duration of every device activity the calls ran (kernels, copies,
    fills).  None when the profiler recorded no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    return us / reps / 1e3 if us > 0 else None


def device_phase(rows) -> dict:
    """`device_ms` (and, where a row has one, `library_device_ms`) of
    every kernel row from its own timed loop, run again under the
    profiler.  The windows run after every `ms` of the script was taken,
    so no profiler state is left behind under a wall-time measurement.
    A row whose window saw no device time keeps None ("not measured")."""
    by = {}
    for r in rows:
        fn, reps = r.pop("_timed")
        lib = r.pop("_library_timed", None)
        r["device_ms"] = device_ms(fn, reps)
        r["library_device_ms"] = device_ms(*lib) if lib else None
        for name, (f, n) in r.pop("_layouts_timed", {}).items():
            r["layouts"][name]["device_ms"] = device_ms(f, n)
        large = r.pop("_large_timed", None)
        if large:
            r["large"]["device_ms"] = device_ms(*large)
        by[r["kernel"].name] = ("torch.profiler" if r["device_ms"]
                                else "not measured")
    return by


def host_us(f, *a, calls: int = 1000) -> float:
    """`f(*a)`'s wall time per call by the host clock: the median of
    REPLAY_ROUNDS loops of `calls` calls (after 10 warm-up calls and a
    synchronize each).  For a call whose device work is shorter than its
    host work this is the host's time."""
    import torch

    per_call = []
    for _ in range(REPLAY_ROUNDS):
        for _ in range(10):
            f(*a)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            f(*a)
        per_call.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(per_call)


def launch_path(row, calls: int = 1000) -> dict:
    """K4's wall time per call split by the host clock, `calls` calls
    each (the chunk of the kernel row `row`): the wrapper's Python before
    the launcher (checks, stream, guard: the wrapper run with its bound
    launcher swapped for a Python no-op), the call into the launcher
    with the wrapper's arguments, the same call with m = 0 (argument
    conversion and cudaGetLastError, no launch), the whole wrapper and
    `index_add_`, and the launcher's two calls again through ctypes, each
    the median of REPLAY_ROUNDS loops; then the device time per call of
    the wrapper from one profiler window."""
    import ctypes

    import torch

    from nomad_tpu_torch.ops import kernels as K
    from nomad_tpu_torch.ops.engine import scatter_add_

    work, rows, vals, rows_l = row["_args"]
    kern, sym = K.SCATTER_ADD, "scatter_add"
    launcher = kern.fn(sym)
    args = (work.data_ptr(), work.shape[0], rows.data_ptr(),
            vals.data_ptr(), rows.shape[0], K.stream_of(work))
    empty = args[:4] + (0, args[5])
    out = {"phase": "launch_path", "kernel": kern.name, "calls": calls,
           "rows": rows.shape[0],
           "stream": "torch._C._cuda_getCurrentRawStream",
           "wrapper_host_us": host_us(scatter_add_, work, rows, vals),
           "index_add_host_us": host_us(work.index_add_, 0, rows_l, vals)}
    kern._fns[sym] = lambda *a: 0
    try:
        out["python_us"] = host_us(scatter_add_, work, rows, vals)
    finally:
        kern._fns[sym] = launcher
    out["launcher_us"] = host_us(launcher, *args)
    out["launcher_no_launch_us"] = host_us(launcher, *empty)
    # the same launcher bound through ctypes, as the port bound every
    # launcher before its FASTCALL binding (csrc/py_launchers.cuh)
    cfn = ctypes.CDLL(str(K.build_all()[kern.source]))[sym]
    cfn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    cfn.restype = ctypes.c_int
    out["ctypes_us"] = host_us(cfn, *args)
    out["ctypes_no_launch_us"] = host_us(cfn, *empty)
    dev_ms = device_ms(lambda: scatter_add_(work, rows, vals), calls)
    out["device_us"] = dev_ms * 1e3 if dev_ms else None
    return out


# K1's and K8's launchers (csrc/landscape.cu): the argument that counts
# the launch's work (signatures, groups, frame sets), set to 0 for the
# launcher call that launches nothing
K1_COUNT_ARG = {"landscape_mask": 4, "landscape_affinity": 4,
                "landscape_pair": 1, "feasible_mask": 4}


def k1_split(pairs, calls: int = 1000, kern=None) -> dict:
    """K1's (or `kern`'s: K8's) wall time per call split by the host
    clock, as launch_path splits K4's: for each wrapper call of each
    labelled sequence in `pairs` ({label: [(wrapper, args), ...]}), the
    wrapper's Python before the launcher (its bound launchers swapped for
    a no-op), the launcher call with the arguments the wrapper passed,
    the same call with its count argument 0 (K1_COUNT_ARG: no kernel
    runs), the whole wrapper, and its device time per call from one
    profiler window; then the whole sequence by wall and on the
    device."""
    from nomad_tpu_torch.ops import kernels as K

    kern = kern or K.LANDSCAPE
    out = {}
    for label, seq in pairs.items():
        for fn, args in seq:       # bind every launcher the calls use
            fn(*args)
        entries = []
        for fn, args in seq:
            saved = dict(kern._fns)
            got = []
            for sym in saved:
                kern._fns[sym] = functools.partial(
                    lambda s, *a: got.append((s, a)) or 0, sym)
            try:
                fn(*args)
                for sym in saved:
                    kern._fns[sym] = lambda *a: 0
                python_us = host_us(fn, *args, calls=calls)
            finally:
                kern._fns.update(saved)
            if len(got) != 1:
                raise AssertionError(f"k1_split: {fn.__name__} launched "
                                     f"{len(got)} times")
            sym, cargs = got[0]
            i = K1_COUNT_ARG[sym]
            empty = cargs[:i] + (0,) + cargs[i + 1:]
            entries.append({
                "wrapper": fn.__name__, "symbol": sym,
                "wrapper_host_us": host_us(fn, *args, calls=calls),
                "python_us": python_us,
                "launcher_us": host_us(saved[sym], *cargs, calls=calls),
                "launcher_no_launch_us": host_us(saved[sym], *empty,
                                                 calls=calls),
                "_run": functools.partial(fn, *args)})

        def run(seq=seq):
            for fn, args in seq:
                fn(*args)

        out[label] = {"calls": entries,
                      "wall_us": host_us(run, calls=calls), "_run": run}
    # the profiler windows after every host-clock loop
    for split in out.values():
        for r in split["calls"] + [split]:
            dev_ms = device_ms(r.pop("_run"), calls)
            r["device_us"] = dev_ms * 1e3 if dev_ms else None
    return out


def eager_replays(zoned_built, flat_built) -> dict:
    """Each counted eager device op (kernels.EAGER) as the main path runs
    it, at the zoned and flat waves' shapes: {op: (call, shape)}."""
    import numpy as np
    import torch

    zin, fin = zoned_built["inp"], flat_built["inp"]
    dev = zin.attrs.device
    npad = zin.attrs.shape[0]
    u = zoned_built["n_lanes"]
    con_np = zin.con[:u].cpu().numpy()
    base_rows = [zin.base_mask[zin.u_mask[i]] for i in range(u)]
    m_rows = list(zin.base_mask)
    g_pad = fin.req.shape[0]
    jc0 = torch.zeros((g_pad, npad), dtype=torch.int32, device=dev)
    jrow = torch.zeros((1, npad), dtype=torch.int32, device=dev)

    def jc0_set():
        jc0[torch.tensor([0], device=dev)] = jrow

    return {
        "prover_con_h2d": (lambda: torch.tensor(np.stack(list(con_np)),
                                                device=dev),
                           list(con_np.shape)),
        "prover_base_stack": (lambda: torch.stack(base_rows), [u, npad]),
        "prover_arange": (lambda: torch.arange(u, dtype=torch.int32,
                                               device=dev), [u]),
        "stack_base_mask": (lambda: torch.stack(m_rows),
                            [len(m_rows), npad]),
        "elig_and_node_ok": (lambda: fin.elig & fin.elig, [npad]),
        "compact_used0_clone": (lambda: zin.used0.clone(), [npad, 3]),
        "flat_used0_clone": (lambda: fin.used0.clone(), [npad, 3]),
        "flat_jc0_zeros": (lambda: torch.zeros(
            (g_pad, npad), dtype=torch.int32, device=dev), [g_pad, npad]),
        "flat_jc0_set": (jc0_set, [1, npad]),
        "flat_g_job_arange": (lambda: torch.arange(
            g_pad, dtype=torch.int32, device=dev), [g_pad]),
        "solo_used0_delta": (lambda: fin.used0 + fin.used0, [npad, 3]),
    }


def eager_phase(replays, calls: int = 200) -> dict:
    """Per-call host and device time of each eager op (its replay at the
    main path's shapes), and per main-path phase the ops' counts and
    count x per-call times."""
    per = {op: {"shape": shape, "host_us": host_us(fn, calls=calls)}
           for op, (fn, shape) in replays.items()}
    for op, (fn, _) in replays.items():
        dev_ms = device_ms(fn, calls)
        per[op]["device_us"] = dev_ms * 1e3 if dev_ms else None
    by_phase = {}
    for ph, counts in EAGER_BY_PHASE.items():
        unknown = set(counts) - set(per)
        if unknown:
            raise AssertionError(f"eager ops without a replay: {unknown}")
        by_phase[ph] = {
            "counts": {op: counts.get(op, 0) for op in per},
            "host_ms": sum(c * per[op]["host_us"]
                           for op, c in counts.items()) / 1e3,
            "device_ms": sum(c * (per[op]["device_us"] or 0.0)
                             for op, c in counts.items()) / 1e3}
    return {"phase": "eager_ops", "per_call": per, "by_phase": by_phase}


# the main path's eager device ops of each phase (kernels.EAGER)
EAGER_BY_PHASE = {}


def reset_counts() -> None:
    """Zero the kernels' launch counts and the eager-op counts."""
    from nomad_tpu_torch.ops import kernels as K

    K.reset_launches()
    K.reset_eager()


def read_counts(name: str):
    """(launches by kernel, eager ops by name) since reset_counts; the
    eager counts are kept for the eager_ops line under `name`."""
    from nomad_tpu_torch.ops import kernels as K

    eager = dict(K.EAGER)
    EAGER_BY_PHASE[name] = eager
    return {k.name: k.launches for k in K.KERNELS}, eager


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: int, n_ops: int) -> dict:
    """The least time of `n_bytes` moved and `n_ops` done on the card
    (PEAK_BYTES, PEAK_OPS), and which of the two bounds it."""
    b_ms = n_bytes / PEAK_BYTES * 1e3
    o_ms = n_ops / PEAK_OPS * 1e3
    return {"bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations"}


def tree_map(fn, x):
    """`x` (a tensor, or an inputs tuple or argument list holding some)
    with `fn` applied to every tensor."""
    import torch
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[tree_map(fn, v) for v in x])
    if isinstance(x, (tuple, list)):
        return type(x)(tree_map(fn, v) for v in x)
    return x


def to_cpu(x):
    import torch
    return tree_map(torch.Tensor.cpu, x)


def table_bytes(attrs, luts, con, aff=None) -> int:
    """Bytes of the [N, A] attribute table and the [L, V] LUT table that
    a mask or affinity pass needs: the attribute columns its live
    constraint rows (`con`, opcodes EQ to LUT) and weighted affinity
    rows (`aff`) name, and the LUT rows that their LUT rows name."""
    import torch

    from nomad_tpu_torch.pack.packer import DOP_EQ, DOP_LUT

    rows = con.reshape(-1, 3).cpu()
    rows = rows[(rows[:, 1] >= DOP_EQ) & (rows[:, 1] <= DOP_LUT)]
    if aff is not None:
        a = aff.reshape(-1, 4).cpu()
        rows = torch.cat([rows, a[a[:, 3] != 0, :3]])
    cols = set(rows[:, 0].tolist())
    lut_rows = set(rows[rows[:, 1] == DOP_LUT, 2].tolist())
    return (attrs.shape[0] * len(cols) * attrs.element_size()
            + len(lut_rows) * luts.shape[1] * luts.element_size())


def fn_bytes(tensors, attrs, luts, con, aff=None) -> int:
    """Bytes a function reads once: every tensor but the attribute and
    LUT tables, plus the parts of them that `con` and `aff` name."""
    return (nbytes(*[t for t in tensors
                     if t is not attrs and t is not luts])
            + table_bytes(attrs, luts, con, aff))


def check_exact(name, got, *wants, packed=False, score_cols=None) -> float:
    """Every output of `got` equal to each of `wants` word for word, f32
    values compared as their bits.  Returns the largest absolute
    difference of the f32 values (with `packed`, also the first output's
    top-score meta columns, bitcast back; with `score_cols`, those
    columns of the first output) from the last of `wants`."""
    import torch

    err = 0.0
    for want in wants:
        if len(got) != len(want):
            raise AssertionError(f"{name}: {len(got)} outputs, "
                                 f"want {len(want)}")
        for i, (g, w) in enumerate(zip(got, want)):
            g, w = g.cpu(), w.cpu()
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError(f"{name}: output {i} shape/dtype "
                                     f"{g.shape} {g.dtype} vs {w.shape} "
                                     f"{w.dtype}")
            gb = g.view(torch.int32) if g.dtype == torch.float32 else g
            wb = w.view(torch.int32) if w.dtype == torch.float32 else w
            if not torch.equal(gb, wb):
                bad = (gb != wb).nonzero()[:5].tolist()
                raise AssertionError(f"{name}: output {i} differs at {bad}")
    for i, (g, w) in enumerate(zip(got, wants[-1])):
        g, w = g.cpu(), w.cpu()
        if g.dtype == torch.float32:
            gs, ws = g, w
        elif (packed or score_cols) and i == 0:
            cols = score_cols or [g.shape[1] - 16 + c for c in (3, 4, 5)]
            gs = g[:, cols].contiguous().view(torch.float32)
            ws = w[:, cols].contiguous().view(torch.float32)
        else:
            continue
        if gs.numel():
            err = max(err, float((gs - ws).abs().max()))
    return err


# K2, K3, K6, K10, K11 and K12 (csrc/compact_rounds.cu) per computed
# step: a block
# barrier after the pass and one after the decision, one exchange
# through distributed shared memory between them; a memoised step none.
# A step on the wide path adds 4 radix passes x 3, the quota 1, the
# entry count 1, the sort 1, the fill scan 2 and its sums 2 block
# barriers, and 6 cluster barriers (4 histograms, the entry counts, the
# entries).  K3's (and K6's) refresh of the valid bits adds 3 block
# barriers.
TOPB_K2 = 4
K2_WARPS = 8      # warps a block (256 threads)
BARRIERS_K2 = 2
EXCHANGES_K2 = 1
BARRIERS_K2_WIDE = 4 * 3 + 1 + 1 + 1 + 2 + 2
CLUSTER_K2_WIDE = 6
BARRIERS_K3_STATIC = 3


def barrier_round_ms(rounds: int = 20000) -> float:
    """Measured cost of one barrier round: the probe kernel's dependent
    __syncthreads (with a shared-memory exchange between them) in one
    1024-thread block (csrc/compact_rounds.cu barrier_probe)."""
    import torch

    from nomad_tpu_torch.ops import kernels as K

    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    probe = K.MULTI_COMPACT.fn("barrier_probe")

    def run():
        rc = probe(rounds, sink.data_ptr(), K.stream_of(sink))
        if rc != 0:
            raise RuntimeError(f"barrier_probe failed with cudaError {rc}")

    return time_ms(run, 5) / (2 * rounds)


# the PROF instantiation's phases (csrc/compact_rounds.cu NPH)
COMPACT_PHASES = ("top", "pass", "merge", "exchange", "decide", "wide",
                  "memo")


def rounds_phase_split(launch) -> dict:
    """One launch of a compact_rounds.cu PROF instantiation
    (`launch(prof)`): block 0's clock64() cycles per phase converted to
    microseconds by the launch's own CUDA-event time over its total
    cycles, per real step (want > 0) and per padding step."""
    import torch

    nph = len(COMPACT_PHASES)
    prof = torch.zeros(2 * nph + 4, dtype=torch.int64, device="cuda")
    launch(prof)                                     # warm-up
    prof.zero_()
    _, ms = timed(lambda: launch(prof))
    return phase_us(prof.tolist(), ms, COMPACT_PHASES, ("real", "padding"))


def compact_phase_split(inp, cand_rows, cand_valid, rs, lanes,
                        n_shards=0) -> dict:
    """K2's split at `inp` (K12's with `n_shards`)."""
    from nomad_tpu_torch.ops import select as S

    return rounds_phase_split(lambda prof: S._compact_launch(
        inp.used0.clone(), inp.used0, inp, cand_rows, cand_valid, rs, lanes,
        n_shards=n_shards, prof=prof))


def flat_phase_split(inp, rs) -> dict:
    """K3's split at `inp`."""
    import torch

    from nomad_tpu_torch.ops import select as S

    return rounds_phase_split(lambda prof: S._flat_launch(
        torch.empty_like(inp.used0), inp.used0, inp, rs, prof=prof))


def bulk_phase_split(binp, rs, n_rounds, with_scores=False) -> dict:
    """K6's split at `binp`, in the main path's compact layout (or with
    scores)."""
    from nomad_tpu_torch.ops import select as S

    fill_k = 0 if with_scores else S.FILL_K
    return rounds_phase_split(lambda prof: S._bulk_launch(
        binp, rs, n_rounds, with_scores, fill_k, prof=prof))


def bulk_stats(kern, binp, rs, n_rounds, buf, fills, k_bytes,
               barrier_ms) -> dict:
    """flat_stats of a K6 (or K10) launch at `binp`: K3's flat mode at
    one group, on `bulk_as_flat`'s inputs."""
    from nomad_tpu_torch.ops import select as S

    return flat_stats(kern, S.bulk_as_flat(binp, rs, n_rounds), rs, buf,
                      fills, k_bytes, barrier_ms)


def bulk_layouts(binp, rs, n_rounds, reps: int = 5) -> dict:
    """K6's wrapper at `binp` in each of its three layouts (full, with
    scores, compact): the wall ms of `reps` back-to-back calls, and each
    loop kept for its device window (`_layouts_timed`, device_phase)."""
    from nomad_tpu_torch.ops import select as S

    out, timed = {}, {}
    for name, ws, fk in (("full", False, 0), ("scores", True, 0),
                         ("compact", False, S.FILL_K)):
        fn = functools.partial(S.place_bulk_packed, binp, rs, n_rounds, ws,
                               fk)
        out[name] = {"ms": time_ms(fn, reps)}
        timed[name] = (fn, reps)
    return {"layouts": out, "_layouts_timed": timed}


@functools.lru_cache(maxsize=None)
def sm_mhz(cycles: int = 20_000_000) -> float:
    """The SM clock in MHz: a spin of `cycles` clock64() cycles
    (torch.cuda._sleep) timed by CUDA events."""
    import torch

    torch.cuda._sleep(cycles)
    _, ms = timed(lambda: torch.cuda._sleep(cycles))
    return cycles / (ms * 1e3)


def phase_us(c, ms, phases, kinds) -> dict:
    """A PROF launch's phase split (PhaseClock, csrc/score_common.cuh:
    block 0's clock64() cycles per phase of the two step kinds, the step
    counts, the set-up and the whole launch) in microseconds at the SM
    clock `sm_mhz` (`event_mhz`: the cycles over the launch's CUDA-event
    time `ms`, which also holds the wrapper's host time and its other
    launches, so it reads low for a launch of tens of microseconds)."""
    nph = len(phases)
    total, setup = c[2 * nph + 3], c[2 * nph + 2]
    mhz = sm_mhz()
    us_per_cycle = 1 / mhz
    out = {"prof_ms": ms, "cycles": total, "mhz": mhz,
           "event_mhz": total / max(ms * 1e3, 1e-9),
           "kernel_us": total * us_per_cycle,
           "setup_us": setup * us_per_cycle}
    for k, kind in enumerate(kinds):
        n = c[2 * nph + k]
        out[f"{kind}_steps"] = n
        out[f"per_{kind}_step_us"] = {
            ph: c[k * nph + i] * us_per_cycle / max(n, 1)
            for i, ph in enumerate(phases)}
    return out


def compact_steps(inp, lanes, out, kk, valid, static=None) -> dict:
    """What K2's steps at `inp` need (K3's and K12's alike), from the
    run's own output `out` (buf_small, fills; K3: buf and its fill
    slots), by the kernel's rules (csrc/compact_rounds.cu): per lane the
    real steps, the steps whose request repeats the lane's previous
    step's, the memoised steps (group and want of the last computed step
    repeat after it placed nothing), the computed ones, those whose
    request differs from the cached one (the cache's refills), the
    committed rows, the steps on the wide path (a round that fills more
    than TOPB_K2 rows, or TOPB_K2 short of `want`, of more than TOPB_K2
    candidates `kk`), K3's refreshes of the valid bits (a computed step
    whose group's signature `static[g]` differs from the last one's),
    and the valid rows `valid(lane, g)` summed over the computed steps,
    the refills and the wide steps; over the real steps how many rows
    each round fills (the water-fill depth)."""
    import collections

    steps = inp.round_g.shape[0] // lanes
    g = inp.round_g.view(steps, lanes).cpu().tolist()
    want = inp.round_want.view(steps, lanes).cpu().tolist()
    req = inp.req.cpu().tolist()
    placed = out[0][:, -16 + 12].view(steps, lanes).cpu().tolist()
    depth = (out[1] & 2047).gt(0).sum(1).view(steps, lanes).cpu().tolist()
    keys = ("real", "req_repeats", "memo", "computed", "refills",
            "commits", "wide", "refreshes", "row_steps", "row_refills",
            "row_wide")
    per = {k: [0] * lanes for k in keys}
    hist = collections.Counter()
    for lane in range(lanes):
        last = None      # (group, want, placed) of the last computed step
        cached = None    # the request the lane's cache holds
        sig = None       # K3: the signature the valid bits hold
        for t in range(steps):
            gt, wt = g[t][lane], want[t][lane]
            if wt > 0:
                per["real"][lane] += 1
                hist[depth[t][lane]] += 1
                if t and req[g[t - 1][lane]] == req[gt]:
                    per["req_repeats"][lane] += 1
            if last == (gt, wt, 0):
                per["memo"][lane] += 1
                continue
            v = valid(lane, gt)
            per["computed"][lane] += 1
            per["row_steps"][lane] += v
            if static is not None and static[gt] != sig:
                per["refreshes"][lane] += 1
                sig = static[gt]
            if req[gt] != cached:
                per["refills"][lane] += 1
                per["row_refills"][lane] += v
                cached = req[gt]
            m = depth[t][lane]
            per["commits"][lane] += m
            if kk > TOPB_K2 and (m > TOPB_K2 or (
                    m == TOPB_K2 and placed[t][lane] < wt)):
                per["wide"][lane] += 1
                per["row_wide"][lane] += v
            last = (gt, wt, placed[t][lane])
    return {"lanes": lanes, "steps": steps, **per,
            "fill_depth": {str(k): v for k, v in sorted(hist.items())}}


def compact_ops(counts, blocks, n_rows=0) -> int:
    """Operations K2, K3 or K12 need (OPS_K2_*, OPS_K3_STATIC), `counts`
    from compact_steps, `blocks` blocks a lane, `n_rows` rows a refresh
    of K3's valid bits reads."""
    ops = 0
    for i in range(counts["lanes"]):
        ops += (counts["row_steps"][i] * OPS_K2_ROW
                + counts["row_refills"][i] * OPS_K2_CACHE
                + counts["row_wide"][i] * OPS_K2_WIDE
                + counts["commits"][i] * (OPS_K2_CACHE + OPS_K2_COMMIT)
                + counts["computed"][i] * blocks * OPS_K2_MERGE * TOPB_K2
                * (K2_WARPS + blocks)
                + counts["refreshes"][i] * n_rows * OPS_K3_STATIC)
    return ops


def compact_depth(counts, barrier_ms, xch_ms) -> dict:
    """The chain of the lane whose steps cost the most: its computed
    steps (BARRIERS_K2 block barriers and EXCHANGES_K2 exchanges of
    `xch_ms` each), those on the wide path with their extra barriers and
    cluster barriers, and K3's refreshes of the valid bits."""
    def chain(i):
        return (counts["computed"][i] * (BARRIERS_K2 * barrier_ms
                                         + EXCHANGES_K2 * xch_ms)
                + counts["wide"][i] * (BARRIERS_K2_WIDE * barrier_ms
                                       + CLUSTER_K2_WIDE * xch_ms)
                + counts["refreshes"][i] * BARRIERS_K3_STATIC * barrier_ms)

    worst = max(range(counts["lanes"]), key=chain)
    return dict(depth_ms=chain(worst), depth_steps=counts["computed"][worst],
                barriers_per_step=BARRIERS_K2,
                exchanges_per_step=EXCHANGES_K2,
                wide_steps=counts["wide"][worst], exchange_ms=xch_ms)


def compact_mixed(zin, zcpu, args, valid) -> dict:
    """K2 at the zoned wave's shapes with a request that changes at
    every real step of a lane (memory 10 and 11 MB in turn), so that
    every computed step refills the cache: its time, its steps and its
    split, the kernel held against its plain version to the bit."""
    import torch

    from nomad_tpu_torch.ops import select as S

    cr, cv, rs, lanes = args
    steps = zin.round_g.shape[0] // lanes
    g = zin.round_g.view(steps, lanes).cpu().tolist()
    want = zin.round_want.view(steps, lanes).cpu().tolist()
    base = zin.req.cpu()
    req = base.clone()
    for lane in range(lanes):
        real = [g[t][lane] for t in range(steps) if want[t][lane] > 0]
        for i, gt in enumerate(real):
            req[gt, 1] = base[gt, 1] + i % 2
    mix = zin._replace(req=req.to(zin.req.device))
    got = S.place_multi_compact_packed(mix, *args)
    err = check_exact(
        "multi_compact mixed", got,
        S.place_multi_compact_packed_plain(mix, *args),
        S.place_multi_compact_packed_plain(zcpu._replace(req=req), cr.cpu(),
                                           cv.cpu(), rs, lanes),
        packed=True)
    torch.cuda.synchronize()
    return {"max_abs_err": err,
            "ms": time_ms(lambda: S.place_multi_compact_packed(mix, *args),
                          5),
            "steps": compact_steps(mix, lanes, got, min(rs, cr.shape[1]),
                                   valid),
            "phase_split": compact_phase_split(mix, *args)}


def used_base(inp):
    """The rows of `inp.base_mask` that its signatures read (u_mask): the
    engine passes its resident table, whose other rows no launch reads."""
    return inp.base_mask[inp.u_mask.unique().long()]


def flat_bytes(fin, got) -> int:
    """What a launch of K3 (or K11) at `fin` must move: each input read
    once, K1's two landscapes included, and its outputs `got`."""
    from nomad_tpu_torch.ops.feasibility import and_rows

    return (fn_bytes((fin.cap, fin.used0, and_rows(fin.elig, fin.node_ok),
                      fin.luts, used_base(fin), fin.con, fin.aff, fin.req,
                      fin.desired, fin.dh_limit, fin.g_static, fin.g_aff,
                      fin.g_job, fin.seed, fin.job_count0, fin.round_g,
                      fin.round_want), fin.attrs, fin.luts, fin.con, fin.aff)
            + nbytes(*got))


def flat_stats(kern, fin, frs, buf, fills, k_bytes, barrier_ms) -> dict:
    """What a launch of K3's flat mode (K3, K11 over the padded rows, K6
    and K10 at `bulk_as_flat`'s inputs) at `fin` computes, by the
    compact_rounds.cu count (compact_steps and compact_ops) from its
    output `buf` (meta last) and `fills`, with `k_bytes` moved; its
    depth, cluster size, frame placement and steps."""
    from nomad_tpu_torch.ops.feasibility import and_rows, landscape_mask_plain

    n = fin.attrs.shape[0]
    # the valid rows of each signature (K1's static rows)
    sig_valid = landscape_mask_plain(
        fin.attrs, fin.con, fin.luts, and_rows(fin.elig, fin.node_ok),
        fin.base_mask, fin.u_mask).sum(1).cpu().tolist()
    g_static = fin.g_static.cpu().tolist()
    counts = compact_steps(fin, 1, (buf, fills), min(frs, n),
                           lambda lane, g: sig_valid[g_static[g]], g_static)
    blocks = kern.fn("multi_compact_blocks")(n, frs, 1, 1)
    frame = ("shared memory" if kern.fn(
        "multi_compact_scratch_bytes")(1, n, frs, 1, 1) == 0
             else "global scratch")
    return dict(bytes=k_bytes, ops=compact_ops(counts, blocks, n),
                **compact_depth(counts, barrier_ms,
                                compact_exchange_ms(blocks)),
                blocks=blocks, frame=frame, steps=counts)


def kernel_phase(h, zoned_built, flat_built):
    """Each kernel's wrapper against its plain version, on the card and
    on CPU copies, at the main path's shapes (the zoned and flat waves'
    own inputs)."""
    import numpy as np
    import torch

    from nomad_tpu_torch.ops import kernels as K
    from nomad_tpu_torch.ops import select as S
    from nomad_tpu_torch.ops.engine import scatter_add_, scatter_add_plain
    from nomad_tpu_torch.ops.feasibility import (
        and_rows,
        landscape_mask,
        landscape_mask_plain,
    )
    from nomad_tpu_torch.ops.scoring import (
        affinity_landscape,
        affinity_landscape_plain,
        landscapes,
    )

    dev = h.engine.device
    barrier_ms = barrier_round_ms()
    zin = zoned_built["inp"]
    zcpu = to_cpu(zin)
    cr = torch.tensor(zoned_built["cand_rows"], device=dev)
    cv = torch.tensor(zoned_built["cand_valid"], device=dev)
    rs, lanes = zoned_built["rs"], zoned_built["n_lanes"]
    n = zin.attrs.shape[0]
    rows = []

    # K1: the lane prover's [U, N] mask and the frames' affinity
    u = lanes
    umask = torch.arange(u, dtype=torch.int32, device=dev)

    def k1_args(inp, frames, um):
        con = inp.con[:u].contiguous()
        base = inp.base_mask[inp.u_mask[:u].long()].contiguous()
        return ((inp.attrs, con, inp.luts, inp.elig, base, um),
                (inp.attrs, inp.aff, inp.luts, frames))

    m_args, a_args = k1_args(zin, cr, umask)
    m_cpu, a_cpu = k1_args(zcpu, cr.cpu(), umask.cpu())

    def k1():
        return landscape_mask(*m_args), affinity_landscape(*a_args)

    def k1_plain():
        return landscape_mask_plain(*m_args), affinity_landscape_plain(*a_args)

    got = k1()
    err = check_exact("landscape", got, k1_plain(),
                      (landscape_mask_plain(*m_cpu),
                       affinity_landscape_plain(*a_cpu)))
    torch.cuda.synchronize()
    c_rows, af_rows = m_args[1].shape[1], zin.aff.shape[1]
    valid = int(cv.sum())
    k1_bytes = (fn_bytes((*m_args, zin.aff, cr), zin.attrs, zin.luts,
                         m_args[1], zin.aff) + u * n + nbytes(got[1]))
    k1_ops = u * n * c_rows * 4 + valid * zin.aff.shape[0] * af_rows * 6
    # the flat waves' one launch of both landscapes
    fin = flat_built["inp"]
    p_args = (fin.attrs, fin.con, fin.luts, fin.elig, fin.base_mask,
              fin.u_mask, fin.aff, fin.node_ok)

    def pair_plain(attrs, con, luts, elig, base, u_mask, aff, node_ok):
        return (landscape_mask_plain(attrs, con, luts,
                                     and_rows(elig, node_ok), base, u_mask),
                affinity_landscape_plain(attrs, aff, luts))

    err = max(err, check_exact("landscape pair", landscapes(*p_args),
                               pair_plain(*p_args),
                               landscapes(*to_cpu(p_args))))
    torch.cuda.synchronize()
    split = {"zoned": [(landscape_mask, m_args), (affinity_landscape, a_args)],
             "flat": [(landscapes, p_args)]}
    rows.append(dict(kernel=K.LANDSCAPE, max_abs_err=err,
                     **timing(k1, 20), plain_ms=time_ms(k1_plain, 3),
                     bytes=k1_bytes, ops=k1_ops, library_ms=None,
                     depth_ms=None, _split=split))

    # K2: the zoned wave's compact launch
    args = (cr, cv, rs, lanes)
    got = S.place_multi_compact_packed(zin, *args)
    err = check_exact(
        "multi_compact", got, S.place_multi_compact_packed_plain(zin, *args),
        S.place_multi_compact_packed_plain(zcpu, cr.cpu(), cv.cpu(), rs,
                                           lanes), packed=True)
    torch.cuda.synchronize()
    valid_l = cv.sum(1).cpu()
    k2_bytes = (nbytes(zin.cap, zin.used0, cr, cv, zin.aff, zin.req,
                       zin.desired, zin.dh_limit, zin.g_aff, zin.g_job,
                       zin.seed, zin.job_count0, zin.round_g,
                       zin.round_want) + nbytes(*got))
    # the chained wave's in-place form, from the zoned wave's usage
    used0 = zin.used0.clone()
    chained = S.place_multi_compact_chained(used0, zin._replace(used0=None),
                                            *args)
    if chained[2] is not used0:
        raise AssertionError("multi_compact chained: usage not in place")
    err = max(err, check_exact("multi_compact chained", chained,
                               S.place_multi_compact_packed_plain(
                                   zcpu, cr.cpu(), cv.cpu(), rs, lanes),
                               packed=True))
    torch.cuda.synchronize()
    valid_l = valid_l.tolist()
    lane_valid = lambda lane, g: valid_l[lane]
    counts = compact_steps(zin, lanes, got, min(rs, cr.shape[1]), lane_valid)
    blocks = K.MULTI_COMPACT.fn("multi_compact_blocks")(cr.shape[1], rs, 1,
                                                        0)
    mixed = compact_mixed(zin, zcpu, args, lane_valid)
    mixed["bound_ms"] = max(
        k2_bytes / PEAK_BYTES,
        compact_ops(mixed["steps"], blocks) / PEAK_OPS) * 1e3
    rows.append(dict(
        kernel=K.MULTI_COMPACT, max_abs_err=max(err, mixed["max_abs_err"]),
        **timing(lambda: S.place_multi_compact_packed(zin, *args), 5),
        plain_ms=time_ms(
            lambda: S.place_multi_compact_packed_plain(zin, *args), 2),
        bytes=k2_bytes, ops=compact_ops(counts, blocks), library_ms=None,
        **compact_depth(counts, barrier_ms, compact_exchange_ms(blocks)),
        blocks=blocks, steps=counts,
        phase_split=compact_phase_split(zin, *args),
        mixed_requests=mixed))

    # K3: the flat wave's launch, and its chained form in place
    fin, frs = flat_built["inp"], flat_built["rs"]
    fcpu = to_cpu(fin)
    got = S.place_multi_packed(fin, frs)
    want_cpu = S.place_multi_packed_plain(fcpu, frs)
    err = check_exact("multi_flat", got, S.place_multi_packed_plain(fin, frs),
                      want_cpu, packed=True)
    used0 = fin.used0.clone()
    chained = S.place_multi_chained(used0, fin._replace(used0=None), frs)
    if chained[1] is not used0:
        raise AssertionError("multi_flat chained: usage not in place")
    err = max(err, check_exact("multi_flat chained", chained, want_cpu,
                               packed=True))
    torch.cuda.synchronize()
    rows.append(dict(
        kernel=K.MULTI_FLAT, max_abs_err=err,
        **timing(lambda: S.place_multi_packed(fin, frs), 5),
        plain_ms=time_ms(lambda: S.place_multi_packed_plain(fin, frs), 2),
        library_ms=None, **flat_stats(K.MULTI_FLAT, fin, frs, got[0],
                                      got[0][:, :frs], flat_bytes(fin, got),
                                      barrier_ms),
        phase_split=flat_phase_split(fin, frs)))

    # K4: one full replay chunk (SCATTER_CHUNK rows, repeats included)
    from nomad_tpu_torch.ops.engine import SCATTER_CHUNK
    rng = np.random.default_rng(0)
    base_used = zin.used0.clone()
    r4 = torch.tensor(rng.integers(0, n, SCATTER_CHUNK), dtype=torch.int32,
                      device=dev)
    v4 = torch.tensor(rng.integers(-20, 20, (SCATTER_CHUNK, 3)),
                      dtype=torch.int32, device=dev)
    got = scatter_add_(base_used.clone(), r4, v4)
    err = check_exact("scatter_add", [got],
                      [scatter_add_plain(base_used.clone(), r4, v4)],
                      [scatter_add_plain(base_used.cpu(), r4.cpu(),
                                         v4.cpu())])
    torch.cuda.synchronize()
    work = base_used.clone()
    r4l = r4.long()
    rows.append(dict(
        kernel=K.SCATTER_ADD, max_abs_err=err,
        **paired_timing(lambda: scatter_add_(work, r4, v4),
                        lambda: work.index_add_(0, r4l, v4)),
        plain_ms=time_ms(lambda: scatter_add_plain(work, r4, v4), 20),
        bytes=nbytes(r4, v4) + 2 * SCATTER_CHUNK * 3 * 4,
        ops=SCATTER_CHUNK * 3,
        depth_ms=None, _args=(work, r4, v4, r4l)))
    for r in rows:
        r.update(bound(r["bytes"], r["ops"]))
        r["barrier_ms"] = barrier_ms
    return rows



# ------------------------------------------------------------- solo path

class Recorder:
    """Spies on the solo path's kernel wrappers where the engine and the
    system scheduler call them, and keeps a copy of the first call's
    arguments per (phase, kernel) while armed, for the kernel checks.
    It calls the wrapped function unchanged, so launch counts are the
    path's own."""

    def __init__(self):
        self.phase = None
        self.calls = {}
        # per phase: {alloc name: (node id, nodes_filtered)}
        self.placed = {}

    def wrap(self, module, attr, kind):
        import torch

        orig = getattr(module, attr)

        def spy(*args, **kw):
            key = (self.phase, kind)
            if self.phase is not None and key not in self.calls:
                if kw:
                    raise AssertionError(f"{attr} called with keywords")
                self.calls[key] = tree_map(torch.Tensor.clone, args)
            return orig(*args, **kw)

        setattr(module, attr, spy)

    def get(self, phase, kind):
        if (phase, kind) not in self.calls:
            raise AssertionError(f"{phase} never called {kind}")
        return self.calls[(phase, kind)]


def bench_cluster(h, n_nodes: int, n_dcs: int = 1, seed: int = 0,
                  cpu=None, mem=None, mock=None):
    """bench.py build_harness: n_dcs datacenters, 20 racks, random node
    sizes (or the given ones), ids node-000000...  `mock` is the port's
    unless given (the parity tests build the same cluster in the
    reference)."""
    import random

    if mock is None:
        from nomad_tpu_torch import mock

    rng = random.Random(seed)
    nodes = []
    for i in range(n_nodes):
        n = mock.node(id=f"node-{i:06d}")
        n.datacenter = f"dc{1 + i % n_dcs}"
        n.attributes["platform.rack"] = f"r{i % 20}"
        n.resources.cpu = cpu or rng.choice([4000, 8000, 16000])
        n.resources.memory_mb = mem or rng.choice([8192, 16384, 32768])
        nodes.append(n)
    h.state.upsert_nodes(nodes)
    return nodes


def solo_eval(mock, job):
    """The registration eval of `job`, with an id fixed by the job's (the
    per-eval seed is crc32 of the eval id)."""
    return mock.eval(id=f"eval-{job.id}-0000-0000-000000000000",
                     job_id=job.id, type=job.type, priority=job.priority,
                     triggered_by="job-register")


def config3_job(mock, structs):
    """bench.py config 3's job: 3,000 placements of cpu 10/mem 10 spread
    50/30/20 over dc1-dc3, with an affinity for rack r3."""
    job = mock.job(id="config3")
    job.datacenters = ["dc1", "dc2", "dc3"]
    tg = job.task_groups[0]
    tg.count = 3000
    tg.tasks[0].resources.cpu = 10
    tg.tasks[0].resources.memory_mb = 10
    job.spreads = [structs.Spread(
        attribute="${node.datacenter}", weight=50,
        targets=[structs.SpreadTarget("dc1", 50),
                 structs.SpreadTarget("dc2", 30),
                 structs.SpreadTarget("dc3", 20)])]
    job.affinities = [structs.Affinity("${attr.platform.rack}",
                                       structs.OP_EQ, "r3", weight=50)]
    return job


def process(h, job, kind):
    """Register `job` and run its eval through Harness.process on the
    card; returns the host seconds (ending in a synchronize)."""
    import torch

    from nomad_tpu_torch import mock

    h.state.upsert_job(job)
    ev = solo_eval(mock, job)
    t0 = time.perf_counter()
    err = h.process(kind, ev, now=SOLO_NOW)
    torch.cuda.synchronize()
    if err is not None:
        raise RuntimeError(f"eval {ev.id} failed: {err}")
    return time.perf_counter() - t0


def live_allocs(h, job):
    return [a for a in h.state.allocs_by_job(job.namespace, job.id)
            if not a.terminal_status()]


def alloc_view(h, job):
    """{alloc name: (node id, nodes_filtered)} of the job's live allocs."""
    return {a.name: (a.node_id, a.metrics.nodes_filtered)
            for a in live_allocs(h, job)}


def check_capacity(h):
    """No node over capacity, usage recomputed from the store's allocs."""
    snap = h.snapshot()
    for n in snap.nodes():
        used = [0, 0, 0]
        for a in snap.allocs_by_node(n.id):
            if a.terminal_status():
                continue
            used[0] += a.resources.cpu
            used[1] += a.resources.memory_mb
            used[2] += a.resources.disk_mb
        if (used[0] > n.resources.cpu - n.reserved.cpu
                or used[1] > n.resources.memory_mb - n.reserved.memory_mb
                or used[2] > n.resources.disk_mb - n.reserved.disk_mb):
            raise AssertionError(f"node {n.id} over capacity: {used}")


def config2_job(mock):
    """bench.py config 2's job: one batch group of 10,000 placements of
    cpu 10, memory 10."""
    job = mock.batch_job(id="config2")
    job.task_groups[0].count = 10000
    job.task_groups[0].tasks[0].resources.cpu = 10
    job.task_groups[0].tasks[0].resources.memory_mb = 10
    return job


def cluster_main() -> int:
    """`chip_smoke.py --cluster`: the kernels built, then cluster_waves
    alone (cluster_phase at config 5's full width on the card), its
    lines and the launches it made.  The whole script runs the same
    phase after agent_cli."""
    import torch

    from nomad_tpu_torch.ops import kernels as K

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    card = card_line()
    gc.callbacks.append(gc_meter)
    K.build_all()
    launches = {k.name: 0 for k in K.KERNELS}
    cluster_phase(card, launches)
    emit({"phase": "cluster_only", "card": card, "launches": launches,
          "total_s": time.perf_counter() - t0})
    return 0


def bulk_layouts_main() -> int:
    """`chip_smoke.py --bulk-layouts`: K6 at bulk_eval's inputs (config
    2 through the Harness, the engine's call recorded) in each of its
    three layouts, wall and device ms, as one JSON line.  It reads only
    the package's public K6 API, so the same file can time an older
    checkout's package (copy it into that checkout and run it there)."""
    import torch

    import nomad_tpu_torch.ops.engine as E
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.ops import kernels as K
    from nomad_tpu_torch.scheduler import Harness

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    K.build_all()
    rec = Recorder()
    rec.wrap(E, "place_bulk_packed", "bulk")
    h = Harness()
    bench_cluster(h, 1000)
    h.engine.packer.update(h.snapshot())
    rec.phase = "bulk_eval"
    process(h, config2_job(mock), "batch")
    rec.phase = None
    binp, rs, n_rounds = rec.get("bulk_eval", "bulk")[:3]
    out = bulk_layouts(binp, rs, n_rounds)
    for name, (f, n) in out.pop("_layouts_timed").items():
        out["layouts"][name]["device_ms"] = device_ms(f, n)
    emit({"phase": "bulk_layouts", "card": card_line(), "rows": binp.attrs.shape[0],
          "round_size": rs, "rounds": n_rounds,
          **out})
    return 0


def solo_phases(card, launches):
    """The solo path through Harness.process at bench.py configs 1-4
    and a system job; returns the Recorder with each phase's kernel
    inputs."""
    import nomad_tpu_torch.ops.engine as E
    import nomad_tpu_torch.scheduler.system as SY
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.ops import kernels as K
    from nomad_tpu_torch.scheduler import Harness
    from nomad_tpu_torch import structs
    from nomad_tpu_torch.structs import (
        PreemptionConfig, Resources, SchedulerConfiguration, Task, TaskGroup)

    rec = Recorder()
    for attr, kind in (("place_packed", "scan"),
                       ("place_bulk_packed", "bulk"),
                       ("preempt_bulk", "preempt"),
                       ("feasible_mask", "feasible")):
        rec.wrap(E, attr, kind)
    rec.wrap(SY, "feasible_mask", "feasible")

    def phase(name, must, body):
        reset_counts()
        rec.phase = name
        out = body()
        rec.phase = None
        ph, eager = read_counts(name)
        for k, v in ph.items():
            launches[k] += v
        if min(ph[k] for k in must) < 1:
            raise AssertionError(f"{name} launches {ph}, want {must}")
        emit({"phase": name, "card": card, **out, "launches": ph,
              "eager": eager})

    # config 1: one node, 3 groups x 2
    h1 = Harness()
    bench_cluster(h1, 1)

    def dev_eval():
        job = mock.job(id="config1")
        job.task_groups = [TaskGroup(name=f"tg{i}", count=2, tasks=[
            Task(name="t", driver="exec",
                 resources=Resources(cpu=100, memory_mb=64))])
            for i in range(3)]
        dt = process(h1, job, "service")
        placed = len(live_allocs(h1, job))
        if placed != 6:
            raise AssertionError(f"dev_eval placed {placed} of 6")
        check_capacity(h1)
        return {"nodes": 1, "placements": placed, "eval_s": dt}

    phase("dev_eval", ("place_scan",), dev_eval)

    # config 2: 1,000 nodes, one batch job of 10,000
    h2 = Harness()
    n2 = len(bench_cluster(h2, 1000))
    h2.engine.packer.update(h2.snapshot())

    def bulk_eval():
        job = config2_job(mock)
        dt = process(h2, job, "batch")
        placed = len(live_allocs(h2, job))
        if placed != 10000:
            raise AssertionError(f"bulk_eval placed {placed} of 10000")
        check_capacity(h2)
        rec.placed["bulk_eval"] = alloc_view(h2, job)
        return {"nodes": n2, "placements": placed, "eval_s": dt,
                "placements_per_s": placed / dt}

    phase("bulk_eval", ("landscape", "multi_bulk"), bulk_eval)
    del h2

    # config 3: 5,000 nodes in 3 DCs, spread 50/30/20 + rack affinity
    h3 = Harness()
    n3 = len(bench_cluster(h3, 5000, n_dcs=3))
    h3.engine.packer.update(h3.snapshot())

    def spread_eval():
        job = config3_job(mock, structs)
        dt = process(h3, job, "service")
        allocs = live_allocs(h3, job)
        if len(allocs) != 3000:
            raise AssertionError(f"spread_eval placed {len(allocs)} of 3000")
        check_capacity(h3)
        rec.placed["spread_eval"] = alloc_view(h3, job)
        by_dc = {"dc1": 0, "dc2": 0, "dc3": 0}
        for a in allocs:
            by_dc[h3.state.node_by_id(a.node_id).datacenter] += 1
        targets = {"dc1": 50.0, "dc2": 30.0, "dc3": 20.0}
        dev = max(abs(100.0 * by_dc[d] / len(allocs) - pct)
                  for d, pct in targets.items())
        return {"nodes": n3, "placements": len(allocs), "eval_s": dt,
                "placements_per_s": len(allocs) / dt,
                "spread_achieved": by_dc, "spread_deviation_pct": dev}

    phase("spread_eval", ("landscape", "place_scan"), spread_eval)

    # config 4: 500 full nodes, then 125 high-priority placements
    h4 = Harness()
    nodes4 = bench_cluster(h4, 500, cpu=4000, mem=8192)
    h4.state.set_scheduler_config(SchedulerConfiguration(
        preemption_config=PreemptionConfig(
            system_scheduler_enabled=True, batch_scheduler_enabled=True,
            service_scheduler_enabled=True)))
    low = mock.batch_job(id="config4-low")
    low.priority = 20
    low.task_groups[0].count = len(nodes4)
    low.task_groups[0].tasks[0].resources.cpu = 3000
    low.task_groups[0].tasks[0].resources.memory_mb = 64
    process(h4, low, "batch")
    if len(live_allocs(h4, low)) != len(nodes4):
        raise AssertionError("config 4's low-priority fill is incomplete")

    def preempt_eval():
        hi = mock.job(id="config4-hi")
        hi.priority = 80
        hi.task_groups[0].count = len(nodes4) // 4
        hi.task_groups[0].tasks[0].resources.cpu = 3000
        hi.task_groups[0].tasks[0].resources.memory_mb = 64
        dt = process(h4, hi, "service")
        plan = h4.plans[-1]
        victims = [a for allocs in plan.node_preemptions.values()
                   for a in allocs]
        placed = len(live_allocs(h4, hi))
        if placed != hi.task_groups[0].count:
            raise AssertionError(f"preempt_eval placed {placed}")
        if not victims or any(v.job.priority >= hi.priority
                              for v in victims):
            raise AssertionError("an eviction is not of lower priority")
        check_capacity(h4)
        return {"nodes": len(nodes4), "placements": placed,
                "preemptions": len(victims), "eval_s": dt}

    phase("preempt_eval", ("multi_bulk", "feasible_mask", "preempt_bulk"),
          preempt_eval)

    # a system job over the config-3 cluster
    def system_eval():
        job = mock.system_job(id="system")
        job.datacenters = ["dc1", "dc2", "dc3"]
        dt = process(h3, job, "system")
        allocs = live_allocs(h3, job)
        ask = job.task_groups[0].tasks[0].resources
        snap = h3.snapshot()
        fits = 0
        for n in snap.nodes():
            used = [0, 0]
            for a in snap.allocs_by_node(n.id):
                if a.terminal_status() or a.job_id == job.id:
                    continue
                used[0] += a.resources.cpu
                used[1] += a.resources.memory_mb
            fits += (used[0] + ask.cpu <= n.resources.cpu - n.reserved.cpu
                     and used[1] + ask.memory_mb
                     <= n.resources.memory_mb - n.reserved.memory_mb)
        if len(allocs) != fits or len({a.node_id for a in allocs}) != fits:
            raise AssertionError(f"system_eval placed {len(allocs)} allocs "
                                 f"for {fits} feasible nodes")
        check_capacity(h3)
        return {"nodes": n3, "placements": len(allocs), "eval_s": dt}

    phase("system_eval", ("feasible_mask",), system_eval)
    return rec


def scan_variant(inp):
    """The spread eval's scan inputs with a distinct_property row over
    VARIANT_PD_VALUES values (limit VARIANT_PD_LIMIT, which binds),
    reschedule rows on every other real step and a device AND-mask:
    every branch of K5 at the main path's width."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    dev = inp.attrs.device
    n = inp.attrs.shape[0]
    g = inp.req.shape[0]
    p = inp.tg_idx.shape[0]
    real = int(inp.active.sum())
    prev = np.full(p, -1, np.int32)
    prev[:real:2] = rng.integers(0, n, len(range(0, real, 2)))

    def t(a):
        return torch.tensor(a, device=dev)

    return inp._replace(
        pd_nodeval=t((np.arange(n) % VARIANT_PD_VALUES)
                     .astype(np.int32)[None]),
        pd_limit=t(np.array([VARIANT_PD_LIMIT], np.int32)),
        pd_apply=t(np.ones((g, 1), bool)),
        pd_counts0=t(np.zeros((1, VARIANT_PD_VALUES), np.int32)),
        prev_row=t(prev), extra_mask=t(rng.random((g, n)) < 0.9))


# the PROF instantiation's phases (csrc/place_scan.cu PhaseClock)
SCAN_PHASES = ("top", "pass", "merge", "exchange", "decode", "commit",
               "memo")
NPH = len(SCAN_PHASES)


def scan_phase_split(inp, n_shards: int = 0) -> dict:
    """K5's (K9's with `n_shards`) phase split at `inp`, for blocks of 256
    and of 1024 threads (the main path takes 1024 above 1024 rows a
    block, else 256)."""
    return {str(nt): scan_phase_split_nt(inp, n_shards, nt)
            for nt in (256, 1024)}


def scan_phase_split_nt(inp, n_shards: int, nt: int) -> dict:
    """One launch of the PROF instantiation (csrc/place_scan.cu
    PhaseClock) with `nt` threads a block: block 0's clock64() cycles
    per phase converted to microseconds by the launch's own CUDA-event
    time over its total cycles, per active and per inactive (padding)
    step."""
    import torch

    from nomad_tpu_torch.ops import select as S

    prof = torch.zeros(2 * NPH + 4, dtype=torch.int64,
                       device=inp.attrs.device)
    S._scan_launch(inp, n_shards, prof, nt)         # warm-up
    prof.zero_()
    _, ms = timed(lambda: S._scan_launch(inp, n_shards, prof, nt))
    return phase_us(prof.tolist(), ms, SCAN_PHASES, ("active", "inactive"))


PREEMPT_PHASES = ("commit", "key", "tree")


def preempt_phase_split(args) -> dict:
    """K7's split at `args` (the PROF instantiation of csrc/preempt.cu:
    warp 0's cycles per computed step in the commit of the root's row,
    that row's new key and the tree path, the count of steps that
    computed nothing (padding), and the set-up: every row's key and the
    tree)."""
    import torch

    from nomad_tpu_torch.ops import preempt as P

    prof = torch.zeros(2 * len(PREEMPT_PHASES) + 4, dtype=torch.int64,
                       device=args[0].device)
    P.preempt_bulk(*args, prof=prof)                 # warm-up
    prof.zero_()
    _, ms = timed(lambda: P.preempt_bulk(*args, prof=prof))
    return phase_us(prof.tolist(), ms, PREEMPT_PHASES, ("real", "padding"))


def preempt_levels(m: int) -> int:
    """Levels of K7's 32-ary tree above its m leaves."""
    levels = 0
    while m > 1:
        m = (m + 31) // 32
        levels += 1
    return levels


def preempt_level_ms(rounds: int = 20000) -> float:
    """Measured cost of one round of K7's tree path: the probe's
    dependent shared-memory reads and warp minima (csrc/preempt.cu
    preempt_level_probe)."""
    import torch

    from nomad_tpu_torch.ops import kernels as K

    sink = torch.zeros(1, dtype=torch.int64, device="cuda")
    probe = K.PREEMPT_BULK.fn("preempt_level_probe")

    def run():
        rc = probe(rounds, sink.data_ptr(), K.stream_of(sink))
        if rc != 0:
            raise RuntimeError(f"preempt_level_probe failed with cudaError "
                               f"{rc}")

    return time_ms(run, 5) / rounds


def preempt_large_args(m: int, a: int, n_place: int, seed: int = 0):
    """K7's arguments over m full candidate rows of up to `a` victims
    each, made from `seed` with numpy as the card tests make theirs
    (tests/torch_parity.py random_preempt_args): every placement real."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    cap = np.tile(np.array([4000, 8192, 10 ** 8], np.int32), (m, 1))
    depth = rng.integers(1, a + 1, m)
    live = np.arange(a)[None, :] < depth[:, None]
    prio = np.where(live, np.sort(rng.integers(10, 60, (m, a)), axis=1),
                    1 << 30).astype(np.int32)
    res = np.stack([rng.integers(100, 2000, (m, a)),
                    rng.integers(64, 4000, (m, a)),
                    rng.integers(0, 500, (m, a))], axis=2)
    res = np.where(live[..., None], res, 0).astype(np.int32)
    used = np.minimum(res.sum(1), cap).astype(np.int32)
    dev = lambda x: torch.from_numpy(np.ascontiguousarray(x)).cuda()
    return (dev(cap), dev(used), dev(rng.random(m) < 0.9), 0,
            dev(rng.integers(0, 2, m).astype(np.int32)), dev(prio),
            dev(res), dev(np.array([1500, 512, 0], np.int32)),
            dev(np.zeros(m, np.int32)), n_place, n_place)


def preempt_stats(args, got, level_ms) -> dict:
    """What a K7 launch at `args` needs, from its own output `got`: the
    bytes (inputs once, outputs once), the operations (OPS_PREEMPT_*)
    and the bound they give, the computed steps and the depth of their
    chain; and where the rows' state lies (csrc/preempt.cu make_plan)."""
    from nomad_tpu_torch.ops import kernels as K

    m, a = args[5].shape
    steps = int((got[0] >= 0).sum())
    levels = preempt_levels(m)
    n_bytes = nbytes(*[x for x in args if hasattr(x, "data_ptr")], *got)
    n_ops = ((m + steps) * (OPS_PREEMPT_VICTIM * a + OPS_PREEMPT_ROW)
             + m + steps * levels * OPS_PREEMPT_LEVEL)
    in_smem = K.PREEMPT_BULK.fn("preempt_scratch_bytes")(m) == 0
    return dict(
        bytes=n_bytes, ops=n_ops, **bound(n_bytes, n_ops),
        depth_ms=steps * (levels + ROUNDS_PREEMPT_EXTRA) * level_ms,
        depth_steps=steps, levels=levels, rows=m, victims=a,
        placements=args[9], level_round_ms=level_ms,
        state="shared" if in_smem else "global")


def scan_steps(inp, buf) -> dict:
    """The steps of a scan that need a pass, by the kernel's memo rule
    (csrc/place_scan.cu): a step whose group and committed state equal
    the last computed step's, and which is inactive or follows a
    computed step with no feasible row, writes its row only.  From the
    run's own output `buf` (a commit is a pick >= 0); also the applying
    distinct_property rows summed over the computed steps."""
    tg = inp.tg_idx.tolist()
    act = inp.active.tolist()
    picks = buf[:, 0].tolist()
    feas = buf[:, 8].tolist()
    d_rows = (inp.pd_apply & (inp.pd_limit > 0)[None]).sum(1).tolist()
    out = {"active": 0, "inactive": 0, "memo": 0, "commits": 0,
           "distinct_rows": 0}
    memo = None
    ver = 0
    for t, g in enumerate(tg):
        if memo == (g, ver) and (not act[t] or memo_feas == 0):
            out["memo"] += 1
            continue
        out["active" if act[t] else "inactive"] += 1
        out["distinct_rows"] += d_rows[g]
        memo, memo_feas = (g, ver), feas[t]
        if picks[t] >= 0:
            ver += 1
            out["commits"] += 1
    return out


def scan_ops(inp, steps) -> int:
    """Operations K5/K9 need at `inp` (OPS_SCAN_*), `steps` from
    scan_steps."""
    n = inp.attrs.shape[0]
    g = inp.req.shape[0]
    s_rows = int((inp.sp_weight > 0).sum())
    return (g * (n + steps["commits"]) * OPS_SCAN_CACHE
            + n * (steps["active"] * (OPS_SCAN_STEP
                                      + OPS_SCAN_SPREAD * s_rows)
                   + steps["inactive"] * OPS_SCAN_FEAS
                   + OPS_SCAN_DISTINCT * steps["distinct_rows"]))


def solo_kernel_phase(rec, barrier_ms, dsmem_ms):
    """K5-K8 against their plain versions, on the card and on CPU
    copies, at the solo phases' own inputs."""
    import torch

    from nomad_tpu_torch.ops import kernels as K
    from nomad_tpu_torch.ops import preempt as P
    from nomad_tpu_torch.ops import select as S
    from nomad_tpu_torch.ops.feasibility import (
        feasible_mask, feasible_mask_plain)

    rows = []
    tensors = lambda x: [v for v in x if isinstance(v, torch.Tensor)]

    # K5: the spread eval's 4,096-step scan, the variant, the dev eval
    spread_in = rec.get("spread_eval", "scan")[0]
    checks = [("spread_eval", spread_in), ("variant", scan_variant(spread_in)),
              ("dev_eval", rec.get("dev_eval", "scan")[0])]
    err = 0.0
    placed = {}
    for label, inp in checks:
        got = S.place_packed(inp)
        err = max(err, check_exact(
            "place_scan", got, S.pack_outputs(S.place_plain(inp)),
            S.place_packed(to_cpu(inp)), score_cols=[1, 5, 6, 7]))
        torch.cuda.synchronize()
        placed[label] = int((got[0][:, 0] >= 0).sum())
    # the variant's distinct_property limit must reject placements
    if not (placed["variant"] <= VARIANT_PD_VALUES * VARIANT_PD_LIMIT
            < placed["spread_eval"]):
        raise AssertionError(f"scan variant's distinct_property limit did "
                             f"not bind: placed {placed}")
    inp = spread_in
    n, p = inp.attrs.shape[0], inp.tg_idx.shape[0]
    steps = scan_steps(inp, S.place_packed(inp)[0])
    real = steps["active"] + steps["inactive"]
    # above 512 rows K5 runs on a cluster and exchanges as K9 does
    blocks = K.PLACE_SCAN.fn("place_scan_blocks")(n)
    meets = int(blocks > 1)
    rows.append(dict(
        kernel=K.PLACE_SCAN, max_abs_err=err,
        **timing(lambda: S.place_packed(inp), 3),
        plain_ms=time_ms(lambda: S.pack_outputs(S.place_plain(inp)), 1, 0),
        bytes=fn_bytes(tensors(inp), inp.attrs, inp.luts, inp.con,
                       inp.aff)
        + p * 14 * 4 + n * 16 + meets * real * blocks * blocks * XCH_POST,
        ops=scan_ops(inp, steps), steps=steps, blocks=blocks,
        library_ms=None,
        depth_ms=real * (BARRIERS_SCAN * barrier_ms + meets * dsmem_ms),
        depth_steps=real, barriers_per_step=BARRIERS_SCAN,
        exchanges_per_step=meets, placed=placed,
        phase_split=scan_phase_split(inp)))

    # K6: the bulk eval's rounds in the three layouts and the spread
    # algorithm
    binp, rs, n_rounds = rec.get("bulk_eval", "bulk")[:3]
    cpu = to_cpu(binp)
    err = 0.0
    for b_in, b_cpu in ((binp, cpu), (binp._replace(spread_algo=True),
                                      cpu._replace(spread_algo=True))):
        for ws, fk in ((False, 0), (True, 0), (False, S.FILL_K)):
            got = S.place_bulk_packed(b_in, rs, n_rounds, ws, fk)
            err = max(err, check_exact(
                "multi_bulk", got,
                S.place_bulk_packed_plain(b_in, rs, n_rounds, ws, fk),
                S.place_bulk_packed(b_cpu, rs, n_rounds, ws, fk),
                packed=True))
            torch.cuda.synchronize()
    # and the preempt eval's launch (500 full rows, nearly all infeasible,
    # one round), in the layout the engine used there
    pargs = rec.get("preempt_eval", "bulk")
    pre = S.place_bulk_packed(*pargs)
    err = max(err, check_exact(
        "multi_bulk preempt_eval", pre, S.place_bulk_packed_plain(*pargs),
        S.place_bulk_packed(*to_cpu(pargs)), packed=True))
    torch.cuda.synchronize()
    pmeta = pre[0][:, -16:].cpu()
    preempt_check = {"rows": pargs[0].attrs.shape[0], "round_size": pargs[1],
                     "rounds": pargs[2], "with_scores": bool(pargs[3]),
                     "fill_k": int(pargs[4]) if len(pargs) > 4 else 0,
                     "feasible": int(pmeta[0, 6]),
                     "exhausted": int(pmeta[0, 8]),
                     "placed": int(pmeta[:, 12].sum())}
    # the main path's compact layout, counted as K3's flat mode at one
    # group (bulk_as_flat)
    k6_out = S.place_bulk_packed(binp, rs, n_rounds, False, S.FILL_K)
    k6_bytes = fn_bytes(tensors(binp), binp.attrs, binp.luts, binp.con,
                        binp.aff) + nbytes(*k6_out)
    layouts = bulk_layouts(binp, rs, n_rounds)
    layouts["layouts"]["scores"]["phase_split"] = bulk_phase_split(
        binp, rs, n_rounds, with_scores=True)
    rows.append(dict(
        kernel=K.MULTI_BULK, max_abs_err=err,
        **timing(lambda: S.place_bulk_packed(binp, rs, n_rounds, False,
                                               S.FILL_K), 5),
        plain_ms=time_ms(lambda: S.place_bulk_packed_plain(
            binp, rs, n_rounds, False, S.FILL_K), 1, 0),
        library_ms=None,
        **bulk_stats(K.MULTI_BULK, binp, rs, n_rounds, k6_out[0], k6_out[1],
                     k6_bytes, barrier_ms),
        **layouts, preempt_check=preempt_check,
        phase_split=bulk_phase_split(binp, rs, n_rounds)))

    # K7: the preempt eval's launch, then a table past shared memory
    args = rec.get("preempt_eval", "preempt")
    got = P.preempt_bulk(*args)
    err = check_exact("preempt_bulk", got, P.preempt_bulk_plain(*args),
                      P.preempt_bulk(*to_cpu(args)))
    torch.cuda.synchronize()
    level_ms = preempt_level_ms()
    large_args = preempt_large_args(*PREEMPT_LARGE)
    large = P.preempt_bulk(*large_args)
    err = max(err, check_exact("preempt_bulk large", large,
                               P.preempt_bulk_plain(*to_cpu(large_args))))
    torch.cuda.synchronize()
    large_fn = functools.partial(P.preempt_bulk, *large_args)
    rows.append(dict(
        kernel=K.PREEMPT_BULK, max_abs_err=err,
        **timing(lambda: P.preempt_bulk(*args), 10),
        plain_ms=time_ms(lambda: P.preempt_bulk_plain(*args), 1, 0),
        library_ms=None, **preempt_stats(args, got, level_ms),
        smem_rows=K.PREEMPT_BULK.fn("preempt_smem_rows")(),
        phase_split=preempt_phase_split(args),
        large={"ms": time_ms(large_fn, 10),
               **preempt_stats(large_args, large, level_ms),
               "phase_split": preempt_phase_split(large_args)},
        _large_timed=(large_fn, 10)))

    # K8: the system eval's [G, 5,000] mask and the preempt eval's
    err = 0.0
    for phase in ("system_eval", "preempt_eval"):
        fa = rec.get(phase, "feasible")
        got = feasible_mask(*fa)
        err = max(err, check_exact("feasible_mask", [got],
                                   [feasible_mask_plain(*fa)],
                                   [feasible_mask(*to_cpu(fa))]))
        torch.cuda.synchronize()
    fa = rec.get("system_eval", "feasible")
    g, c = fa[4].shape[:2]
    n = fa[0].shape[0]
    rows.append(dict(
        kernel=K.FEASIBLE, max_abs_err=err,
        **timing(lambda: feasible_mask(*fa), 50),
        plain_ms=time_ms(lambda: feasible_mask_plain(*fa), 10),
        bytes=fn_bytes(fa, fa[0], fa[5], fa[4]) + g * n,
        ops=g * n * (OPS_FEASIBLE_ROW * c + OPS_FEASIBLE_BASE),
        library_ms=None, depth_ms=None))
    for r in rows:
        r.update(bound(r["bytes"], r["ops"]))
        r["barrier_ms"] = barrier_ms
    return rows


# ------------------------------------------------------------- the mesh

def dsmem_exchange_ms(rounds: int = 20000) -> float:
    """Measured cost of one of K9's exchanges at MESH_SHARDS blocks
    (csrc/place_scan.cu dsmem_exchange_probe: each block's warp pushes a
    48-byte post into every peer's shared memory, arrives on the peer's
    mbarrier and waits on its own, as xch_meet does in K9)."""
    import torch

    from nomad_tpu_torch.ops import kernels as K

    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    probe = K.PLACE_SCAN.fn("dsmem_exchange_probe")

    def run():
        rc = probe(rounds, MESH_SHARDS, sink.data_ptr(), K.stream_of(sink))
        if rc != 0:
            raise RuntimeError(f"dsmem_exchange_probe failed with "
                               f"cudaError {rc}")

    return time_ms(run, 5) / rounds


@functools.lru_cache(maxsize=None)
def compact_exchange_ms(cluster: int, rounds: int = 20000) -> float:
    """Measured cost of one exchange of K2, K3, K11 and K12 at `cluster`
    blocks (csrc/compact_rounds.cu compact_exchange_probe: each block's
    warp pushes its 176-byte post into every peer's shared memory,
    arrives on the peer's mbarrier and waits on its own, as a step's
    xch_meet does)."""
    import torch

    from nomad_tpu_torch.ops import kernels as K

    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    probe = K.MULTI_COMPACT.fn("compact_exchange_probe")

    def run():
        rc = probe(rounds, cluster, sink.data_ptr(), K.stream_of(sink))
        if rc != 0:
            raise RuntimeError(f"compact_exchange_probe failed with "
                               f"cudaError {rc}")

    return time_ms(run, 5) / rounds


def timed(fn):
    """One call of `fn` on the card: (its result, ms by CUDA events)."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def mesh_engine(h):
    """A PlacementEngine on an 8-shard mesh of the card, attached to
    `h`'s store."""
    from nomad_tpu_torch.ops import PlacementEngine
    from nomad_tpu_torch.parallel import make_mesh

    eng = PlacementEngine(mesh=make_mesh(MESH_SHARDS))
    eng.packer.attach(h.state)
    return eng


def mesh_phases(card, launches, waves, solo_placed):
    """The mesh engine (8 shards on the card) over the same clusters:
    the four config-5 waves, each eval held against the single-device
    engine at the same snapshot and seeds (`parity_gate`), then the
    config-3 and config-2 solo evals through Harness.process, held
    against the single-device evals' placements (`solo_placed`).
    Returns the Recorder with each phase's sharded kernel inputs."""
    import torch

    import nomad_tpu_torch.parallel.mesh as PM
    from nomad_tpu_torch import mock, structs
    from nomad_tpu_torch.ops import kernels as K
    from nomad_tpu_torch.scheduler import Harness

    rec = Recorder()
    for attr, kind in (("place_sharded_packed", "scan"),
                       ("place_bulk_sharded_packed", "bulk"),
                       ("place_multi_sharded_packed", "flat"),
                       ("place_multi_compact_sharded", "compact"),
                       ("place_multi_compact_sharded_chained",
                        "compact_chained"),
                       ("scatter_add_sharded_", "scatter")):
        rec.wrap(PM, attr, kind)

    def phase(name, must, body):
        reset_counts()
        rec.phase = name
        out = body()
        rec.phase = None
        ph, eager = read_counts(name)
        for k, v in ph.items():
            launches[k] += v
        if min(ph[k] for k in must) < 1:
            raise AssertionError(f"{name} launches {ph}, want {must}")
        emit({"phase": name, "card": card, "shards": MESH_SHARDS, **out,
              "launches": ph, "eager": eager})

    # mesh_waves: a second cluster built as the first, the harness's own
    # single-device engine kept as the twin
    h = Harness()
    t0 = time.perf_counter()
    zone_of = build_cluster(h, N_NODES, N_ZONES)
    registered = [register_wave(h, name, n_ev, per, zones)
                  for name, n_ev, per, zones, _, _ in waves]
    solo = h.engine
    h.engine = mesh_engine(h)
    h.engine.packer.update(h.snapshot())
    solo.packer.update(h.snapshot())
    emit({"phase": "mesh_cluster", "nodes": N_NODES, "zones": N_ZONES,
          "build_s": time.perf_counter() - t0})
    all_jobs = []
    prev = prev_twin = None
    mesh_must = {"zoned_wave": ("multi_compact_sharded",),
                 "chained_wave": ("multi_compact_sharded",),
                 "small_zoned_wave": ("multi_compact_sharded",),
                 "flat_wave": ("multi_flat_sharded", "scatter_add_sharded")}
    for (name, n_ev, per, zones, chained, _), (jobs, evals) in zip(
            waves, registered):
        all_jobs += jobs

        def wave():
            chain = twin_chain = None
            if chained:
                chain = (prev["used"], prev["node_version"], prev["npad"])
                twin_chain = (prev_twin["used"], prev_twin["node_version"],
                              prev_twin["npad"])
            pend, _, tm, tpend = run_wave(h, evals, used0_dev=chain,
                                          twin=(solo, twin_chain))
            if bool(pend["chained"]) != chained:
                raise AssertionError(f"{name}: chained={pend['chained']}")
            if zones and (pend["cand_rows"] is None
                          or pend["cand_rows"].shape[:2]
                          != (MESH_SHARDS, zones)):
                raise AssertionError(f"{name} did not take the sharded "
                                     f"compact path with {zones} lanes")
            if not zones and pend["cand_rows"] is not None:
                raise AssertionError(f"{name} took the compact path")
            placed, usage = check_store(h, jobs, per, all_jobs, zone_of,
                                        zones)
            used_matches_store(h, pend["used"], usage)
            wave.out = (pend, tpend)
            return {"evals": n_ev, "placements": placed,
                    "lanes": pend["n_lanes"], "round_size": pend["rs"],
                    **tm, "evals_per_s": n_ev / tm["wall_s"],
                    "placements_per_s": placed / tm["wall_s"],
                    "parity_gate": "sorted picks and nodes_filtered equal",
                    "collective_bytes": pend["collective_bytes"],
                    "shard_h2d_bytes": pend["shard_h2d_bytes"]}

        phase("mesh_" + name, mesh_must[name], wave)
        prev, prev_twin = wave.out
    del h, solo, prev, prev_twin, registered

    # mesh_solo: config 3 (K9) and config 2 (K10)
    def mesh_solo_eval(label, n_nodes, n_dcs, job, kind, ordered):
        hm = Harness()
        bench_cluster(hm, n_nodes, n_dcs=n_dcs)
        hm.engine = mesh_engine(hm)
        hm.engine.packer.update(hm.snapshot())
        dt = process(hm, job, kind)
        got = alloc_view(hm, job)
        want = solo_placed[label]
        check_capacity(hm)
        if ordered:
            same = got == want
        else:
            same = sorted(got.values()) == sorted(want.values())
        if not same or len(got) != job.task_groups[0].count:
            raise AssertionError(f"mesh {label}: placements differ from "
                                 "the single-device eval's")
        return {"nodes": n_nodes, "placements": len(got), "eval_s": dt,
                "placements_per_s": len(got) / dt,
                "parity": "picks in order" if ordered
                else "picks as sorted lists",
                "collective_bytes": hm.engine.collective_bytes}

    phase("mesh_spread_eval", ("place_scan_sharded",),
          lambda: mesh_solo_eval("spread_eval", 5000, 3,
                            config3_job(mock, structs), "service", True))

    def config2_job():
        job = mock.batch_job(id="config2")
        job.task_groups[0].count = 10000
        job.task_groups[0].tasks[0].resources.cpu = 10
        job.task_groups[0].tasks[0].resources.memory_mb = 10
        return job

    phase("mesh_bulk_eval", ("multi_bulk_sharded",),
          lambda: mesh_solo_eval("bulk_eval", 1000, 1, config2_job(),
                                 "batch", False))
    torch.cuda.synchronize()
    return rec


def mesh_kernel_phase(rec, barrier_ms, dsmem_ms):
    """K9-K13 against their plain versions, on the card and on CPU
    copies, at the mesh phases' own inputs."""
    import torch

    import nomad_tpu_torch.parallel.mesh as PM
    from nomad_tpu_torch.ops import kernels as K
    from nomad_tpu_torch.ops import select as S

    cpu_mesh = PM.make_mesh(MESH_SHARDS, "cpu")
    ns = MESH_SHARDS
    rows = []
    tensors = lambda x: [v for v in x if isinstance(v, torch.Tensor)]

    def depth(steps, block_barriers, cluster_barriers, meet_ms):
        return dict(depth_ms=steps * (block_barriers * barrier_ms
                                      + cluster_barriers * meet_ms),
                    depth_steps=steps, barriers_per_step=block_barriers,
                    cluster_barriers_per_step=cluster_barriers)

    # K9: the mesh spread eval's 4,096-step scan
    inp, mesh = rec.get("mesh_spread_eval", "scan")
    got = PM.place_sharded_packed(inp, mesh)
    steps = scan_steps(inp, got[0])
    want, plain_ms = timed(
        lambda: S.pack_outputs(PM.place_sharded_plain(inp, ns)))
    err = check_exact("place_scan_sharded", got, want,
                      PM.place_sharded_packed(to_cpu(inp), cpu_mesh),
                      score_cols=[1, 5, 6, 7])
    # the unpacked entry (reference: place_sharded_fn): one K9 launch,
    # its buffer split as the packed entry's, and the plain version
    before = K.PLACE_SCAN_SHARDED.launches
    unpacked = PM.place_sharded(inp, mesh)
    torch.cuda.synchronize()
    place_sharded = {"k9_launches": K.PLACE_SCAN_SHARDED.launches - before}
    if place_sharded["k9_launches"] != 1:
        raise AssertionError(f"place_sharded launched K9 "
                             f"{place_sharded['k9_launches']} times")
    place_sharded["max_abs_err"] = check_exact(
        "place_sharded", unpacked, S.unpack_outputs(*got),
        PM.place_sharded(to_cpu(inp), cpu_mesh))
    torch.cuda.synchronize()
    n, p = inp.attrs.shape[0], inp.tg_idx.shape[0]
    real = steps["active"] + steps["inactive"]
    rows.append(dict(
        kernel=K.PLACE_SCAN_SHARDED, max_abs_err=err,
        place_sharded=place_sharded,
        **timing(lambda: PM.place_sharded_packed(inp, mesh), 3),
        plain_ms=plain_ms,
        # plus each computed step's posts, from every block to every block
        bytes=fn_bytes(tensors(inp), inp.attrs, inp.luts, inp.con, inp.aff)
        + p * 14 * 4 + n * 16 + real * ns * ns * XCH_POST,
        ops=scan_ops(inp, steps), steps=steps,
        library_ms=None, **depth(real, BARRIERS_SCAN, 1, dsmem_ms),
        phase_split=scan_phase_split(inp, ns)))

    # K10: the mesh bulk eval's rounds
    binp, mesh, rs, n_rounds = rec.get("mesh_bulk_eval", "bulk")
    got = PM.place_bulk_sharded_packed(binp, mesh, rs, n_rounds)
    want, plain_ms = timed(
        lambda: PM.place_bulk_sharded_plain(binp, ns, rs, n_rounds))
    err = check_exact("multi_bulk_sharded", got, want,
                      PM.place_bulk_sharded_packed(to_cpu(binp), cpu_mesh,
                                                   rs, n_rounds),
                      packed=True)
    torch.cuda.synchronize()
    rows.append(dict(
        kernel=K.MULTI_BULK_SHARDED, max_abs_err=err,
        **timing(lambda: PM.place_bulk_sharded_packed(binp, mesh, rs,
                                                        n_rounds), 5),
        plain_ms=plain_ms, library_ms=None,
        **bulk_stats(K.MULTI_BULK_SHARDED, binp, rs, n_rounds, got[0],
                     got[0][:, :rs],
                     fn_bytes(tensors(binp), binp.attrs, binp.luts, binp.con,
                              binp.aff) + nbytes(*got), barrier_ms)))

    # K11: the mesh flat wave's launch, K3's flat mode over the npad rows
    # (one cluster of up to 16 blocks, as K3), and its chained form
    fin, mesh, frs = rec.get("mesh_flat_wave", "flat")
    got = PM.place_multi_sharded_packed(fin, mesh, frs)
    want, plain_ms = timed(lambda: PM.place_multi_sharded_plain(fin, ns, frs))
    want_cpu = PM.place_multi_sharded_packed(to_cpu(fin), cpu_mesh, frs)
    err = check_exact("multi_flat_sharded", got, want, want_cpu, packed=True)
    used0 = fin.used0.clone()
    chained = PM.place_multi_sharded_chained(used0, fin._replace(used0=None),
                                             mesh, frs)
    if chained[1] is not used0:
        raise AssertionError("multi_flat_sharded chained: usage not in "
                             "place")
    err = max(err, check_exact("multi_flat_sharded chained", chained,
                               want_cpu, packed=True))
    torch.cuda.synchronize()
    rows.append(dict(
        kernel=K.MULTI_FLAT_SHARDED, max_abs_err=err,
        **timing(lambda: PM.place_multi_sharded_packed(fin, mesh, frs), 5),
        plain_ms=plain_ms, library_ms=None,
        **flat_stats(K.MULTI_FLAT_SHARDED, fin, frs, got[0],
                     got[0][:, :frs], flat_bytes(fin, got), barrier_ms)))

    # K12: the mesh zoned wave's launch, and the chained wave's in place
    zin, cr, cv, mesh, rs, lanes = rec.get("mesh_zoned_wave", "compact")
    got = PM.place_multi_compact_sharded(zin, cr, cv, mesh, rs, lanes)
    want, plain_ms = timed(lambda: PM.place_multi_compact_sharded_plain(
        zin, cr, cv, ns, rs, lanes))
    err = check_exact("multi_compact_sharded", got, want,
                      PM.place_multi_compact_sharded_plain(
                          to_cpu(zin), cr.cpu(), cv.cpu(), ns, rs, lanes),
                      packed=True)
    used0, cin, ccr, ccv, mesh, crs, clanes = rec.get("mesh_chained_wave",
                                                      "compact_chained")
    cgot = PM.place_multi_compact_sharded_chained(
        used0.clone(), cin, ccr, ccv, mesh, crs, clanes)
    err = max(err, check_exact(
        "multi_compact_sharded chained", cgot,
        PM.place_multi_compact_sharded_plain(
            to_cpu(cin._replace(used0=used0)), ccr.cpu(), ccv.cpu(), ns,
            crs, clanes), packed=True))
    torch.cuda.synchronize()
    valid_l = cv.sum(dim=(0, 2)).cpu().tolist()
    counts = compact_steps(zin, lanes, got, min(rs, ns * cr.shape[-1]),
                           lambda lane, g: valid_l[lane])
    rows.append(dict(
        kernel=K.MULTI_COMPACT_SHARDED, max_abs_err=err,
        **timing(lambda: PM.place_multi_compact_sharded(
            zin, cr, cv, mesh, rs, lanes), 5),
        plain_ms=plain_ms,
        bytes=nbytes(zin.cap, zin.used0, cr, cv, zin.aff, zin.req,
                     zin.desired, zin.dh_limit, zin.g_aff, zin.g_job,
                     zin.seed, zin.job_count0, zin.round_g, zin.round_want)
        + nbytes(*got),
        ops=compact_ops(counts, ns), library_ms=None,
        **compact_depth(counts, barrier_ms, compact_exchange_ms(ns)),
        blocks=ns, steps=counts,
        phase_split=compact_phase_split(zin, cr, cv, rs, lanes, ns)))

    # K13: the mesh flat wave's replay chunk
    used, r13, v13, mesh = rec.get("mesh_flat_wave", "scatter")
    got = PM.scatter_add_sharded_(used.clone(), r13, v13, mesh)
    want, plain_ms = timed(lambda: PM.scatter_add_sharded_plain(
        used.clone(), r13, v13, ns))
    err = check_exact("scatter_add_sharded", [got], [want],
                      [PM.scatter_add_sharded_plain(used.cpu(), r13.cpu(),
                                                    v13.cpu(), ns)])
    torch.cuda.synchronize()
    work = used.clone()
    r13l = r13.long()
    m = r13.shape[0]
    rows.append(dict(
        kernel=K.SCATTER_ADD_SHARDED, max_abs_err=err,
        **paired_timing(
            lambda: PM.scatter_add_sharded_(work, r13, v13, mesh),
            lambda: work.index_add_(0, r13l, v13)),
        plain_ms=plain_ms, bytes=nbytes(r13, v13) + 2 * m * 3 * 4,
        ops=m * 3,
        depth_ms=None, replay_rows=m))
    for r in rows:
        r.update(bound(r["bytes"], r["ops"]))
        r["barrier_ms"] = barrier_ms
        r["dsmem_exchange_ms"] = dsmem_ms
    return rows


# ------------------------------------------------------------- main

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); the port's kernels need the card", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    from nomad_tpu_torch.ops import kernels as K
    from nomad_tpu_torch.ops import TorchExecutor
    from nomad_tpu_torch.ops.feasibility import feasible_mask
    from nomad_tpu_torch.scheduler import Harness

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    gc.callbacks.append(gc_meter)
    t0 = time.perf_counter()
    K.build_all()
    build_s = time.perf_counter() - t0
    emit({"phase": "environment", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "kernel_build_s": build_s, "nvcc_parallel_s": K.build_seconds,
          "ptxas": {src: [ln.strip() for ln in log.splitlines()
                          if "registers" in ln or "spill" in ln]
                    for src, log in K.build_logs().items()}})

    # cluster + the four waves' jobs, registered up front
    h = Harness()
    executor = TorchExecutor(h.engine)
    executor.attach_store(h.state)
    t0 = time.perf_counter()
    zone_of = build_cluster(h, N_NODES, N_ZONES)
    waves = [  # (phase, evals, placements each, zones, chained, kernels)
        ("zoned_wave", N_EVALS, PER_EVAL, N_ZONES, False,
         ("landscape", "multi_compact")),
        ("chained_wave", N_EVALS, PER_EVAL, N_ZONES, True,
         ("multi_compact",)),
        ("small_zoned_wave", SMALL_EVALS, PER_EVAL, N_ZONES, False,
         ("landscape", "multi_compact")),
        ("flat_wave", FLAT_EVALS, FLAT_PER_EVAL, 0, False,
         ("landscape", "multi_flat", "scatter_add")),
    ]
    registered = [register_wave(h, name, n_ev, per, zones)
                  for name, n_ev, per, zones, _, _ in waves]
    h.engine.packer.update(h.snapshot())
    emit({"phase": "cluster", "nodes": N_NODES, "zones": N_ZONES,
          "build_s": time.perf_counter() - t0})

    # 2. kernels against their plain versions at the main path's shapes
    snap, _, _, items1, seeds1 = prepare(h, registered[0][1])
    zoned_built = h.engine.build_multi_inputs(snap, items1, seed=seeds1)
    snap, _, _, items3, seeds3 = prepare(h, registered[3][1])
    flat_built = h.engine.build_multi_inputs(snap, items3, seed=seeds3)
    if zoned_built["cand_rows"] is None or flat_built["cand_rows"] is not None:
        raise AssertionError("main-path inputs took the wrong kernel")
    # the probes of the cluster exchanges (the rounds' depth needs their
    # own, at 8 and at 16 blocks)
    dsmem_ms = dsmem_exchange_ms()
    xch_us = {cb: compact_exchange_ms(cb) * 1e3 for cb in (8, 16)}
    krows = kernel_phase(h, zoned_built, flat_built)
    torch.cuda.synchronize()
    emit({"phase": "kernel_checks", "card": card, "tolerance": "exact",
          "checks": [{k: (v.name if k == "kernel" else v)
                      for k, v in r.items() if k[0] != "_"} for r in krows]})
    replays = eager_replays(zoned_built, flat_built)
    del zoned_built, flat_built

    # 3-6. the main path: each wave through the Harness's schedulers and
    # one TorchExecutor, launch counts zeroed just before it and read just
    # after; the chained wave claims the chain the zoned wave retained
    launches = {k.name: 0 for k in K.KERNELS}
    all_jobs = []
    prev = prev_name = None
    wave_uploads = {}
    for (name, n_ev, per, zones, chained, must), (jobs, evals) in zip(
            waves, registered):
        all_jobs += jobs
        chain = None
        if chained:
            executor.retain_chain(prev_name, 0, executor.chain_state(prev))
            claimed = executor.claim_chain()
            if claimed is None or claimed[0] != prev_name:
                raise AssertionError(f"{name}: claimed {claimed}")
            chain = claimed[2]
        up0 = dict(executor.upload_bytes_by_cause)
        reset_counts()
        pend, _, tm, _ = run_wave(h, evals, used0_dev=chain,
                                  executor=executor)
        ph, eager = read_counts(name)
        wave_uploads[name] = cause_delta(executor, up0)
        for k, v in ph.items():
            launches[k] += v
        if bool(pend["chained"]) != chained:
            raise AssertionError(f"{name}: chained={pend['chained']}")
        if zones and (pend["cand_rows"] is None
                      or pend["n_lanes"] != zones):
            raise AssertionError(f"{name} did not take the compact path "
                                 f"with {zones} lanes")
        if not zones and pend["cand_rows"] is not None:
            raise AssertionError(f"{name} took the compact path")
        placed, usage = check_store(h, jobs, per, all_jobs, zone_of, zones)
        used_matches_store(h, pend["used"], usage)
        if min(ph[k] for k in must) < 1:
            raise AssertionError(f"{name} launches {ph}, want {must}")
        emit({"phase": name, "card": card, "evals": n_ev,
              "placements": placed, "lanes": pend["n_lanes"],
              "round_size": pend["rs"], **tm,
              "evals_per_s": n_ev / tm["wall_s"],
              "placements_per_s": placed / tm["wall_s"], "launches": ph,
              "eager": eager,
              "upload_bytes_by_cause": wave_uploads[name]})
        prev, prev_name = pend, name
        if name == "flat_wave":
            flat_replayed = ph["scatter_add"] > 0

    # the executor's ledger, then a node write that drops the retained
    # chain, then a wave under the sampler with its wait marked
    executor_phase(card, executor, len(waves), wave_uploads, flat_replayed)
    # (their jobs registered only now, so that the four waves run on the
    # store the parent's do: a full collection's timing follows the
    # objects alive)
    invalidation_phase(card, h, executor, prev, all_jobs, zone_of,
                       launches)
    device_wait_phase(card, h, executor, all_jobs, zone_of, launches)
    # the same waves through the port's Server: broker, worker, wave
    # pipeline, plan queue and threaded applier; then through the HTTP
    # API of the port's Agent, and the agent and CLI in subprocesses
    server_phase(card, launches)
    agent_phase(card, launches)
    agent_cli_phase(card)
    # the same waves through a three-server port cluster (Raft, gossip,
    # forwarding), then a failover wave
    cluster_phase(card, launches)

    # 7-11. the solo path, then 12. its kernels against the plain versions
    # (after the line of the two exchange probes)
    rec = solo_phases(card, launches)
    emit({"phase": "exchange_probes", "card": card,
          "dsmem_exchange_us": dsmem_ms * 1e3, "blocks": MESH_SHARDS,
          "compact_exchange_us": xch_us})
    srows = solo_kernel_phase(rec, krows[0]["barrier_ms"], dsmem_ms)
    torch.cuda.synchronize()
    emit({"phase": "solo_kernel_checks", "card": card, "tolerance": "exact",
          "checks": [{k: (v.name if k == "kernel" else v)
                      for k, v in r.items() if k[0] != "_"} for r in srows]})

    # 13-14. the node-sharded mesh, then 15. its kernels against the plain
    # versions
    mrec = mesh_phases(card, launches, waves, rec.placed)
    k8_calls = {"system_eval": [(feasible_mask,
                                 rec.get("system_eval", "feasible"))]}
    del rec
    mrows = mesh_kernel_phase(mrec, krows[0]["barrier_ms"], dsmem_ms)
    torch.cuda.synchronize()
    emit({"phase": "mesh_kernel_checks", "card": card, "tolerance": "exact",
          "checks": [{k: (v.name if k == "kernel" else v)
                      for k, v in r.items() if k[0] != "_"} for r in mrows]})

    # K4's launch path split, then every row's device window (after all
    # wall-time measurements)
    lp = launch_path(next(r for r in krows if r["kernel"] is K.SCATTER_ADD))
    lp["k1"] = k1_split(next(r for r in krows
                             if r["kernel"] is K.LANDSCAPE).pop("_split"))
    lp["k8"] = k1_split(k8_calls, kern=K.FEASIBLE)
    lp["card"] = card
    eager = eager_phase(replays)
    eager["card"] = card
    device_by = device_phase(krows + srows + mrows)
    emit(lp)
    emit(eager)
    emit({"phase": "device_times", "card": card, "source": device_by,
          "rows": [{"name": r["kernel"].name, "ms": r["ms"],
                    "device_ms": r["device_ms"],
                    "library_ms": r["library_ms"],
                    "library_device_ms": r["library_device_ms"],
                    **{k: r[k] for k in ("layouts", "large") if k in r}}
                   for r in krows + srows + mrows]})

    missing = [k for k, v in launches.items() if v < 1]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    kernels = []
    for r in krows + srows + mrows:
        k = r["kernel"]
        kernels.append({
            "name": k.name, "route": "cuda",
            "source": f"nomad_tpu_torch/csrc/{k.source}",
            "replaces": k.replaces, "launches": launches[k.name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "depth_ms": r["depth_ms"], "device_ms": r["device_ms"],
            "library_device_ms": r["library_device_ms"]})
    emit({"phase": "summary", "total_s": time.perf_counter() - t_start,
          "gc2_n": GC2["n"], "gc2_s": GC2["s"]})
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(bulk_layouts_main() if sys.argv[1:] == ["--bulk-layouts"]
             else cluster_main() if sys.argv[1:] == ["--cluster"]
             else main())
