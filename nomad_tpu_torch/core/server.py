"""In-process server core (reference: nomad/server.go + nomad/leader.go +
job/node endpoint semantics).

Owns the state store, eval broker, blocked-evals tracker, plan queue +
serialized applier, heartbeat timers, and N eval workers sharing one
PlacementEngine — the single-process equivalent of `nomad agent -dev`'s
server half (SURVEY.md §4.1), minus Raft/RPC (explicitly out of scope per
the north-star; this object IS the seam where the Go/Raft plane would sit).

Two run modes:
  dev_mode=True  (default): no threads; `process_all()` drains the broker
      deterministically — what tests and bench.py use.
  dev_mode=False: applier + worker threads, wall-clock ticks.

Differences from the reference (nomad_tpu/core/server.py), because the
port runs on PyTorch and CUDA, not JAX:
  - `device=None` is a keyword the reference lacks.  It is forwarded to
    `PlacementEngine(device=..., mesh=...)`: CUDA unless given, raising
    when CUDA is absent, as `scheduler.testing.Harness` does.  Tests
    pass `device="cpu"` to run the kernels' plain versions;
  - `device_executor="torch"` is the default and goes through the
    port's `ops.executor.make_executor`: "", None and "torch" build a
    `TorchExecutor`, "bridge" a `BridgeExecutor` over the native CUDA
    library (ValueError on a mesh, `ExecutorUnavailable` on the CPU),
    and any other name, "jax" included, raises ValueError.  `shutdown`
    also releases the executor (`DeviceExecutor.release`: the bridge
    frees its device buffers; nothing for "torch");
  - `mesh` takes the port engine's meaning, the reference's: None
    shards automatically over every card when the engine's device is
    CUDA and more than one card is visible (`parallel.mesh.default_mesh`,
    one shard a card; one device otherwise), False is one device, a
    `parallel.mesh.Mesh` is that many shards of the node axis over its
    parts (one card, or several: parallel/xmesh.py);
  - `worker_mode` is checked first, before any store or thread is
    built.  In "process" mode the pool's children have no engine: their
    solo placements run on this Server's engine (core/workerpool.py).
`self.federation` is None here, as in the reference; the agent's cluster
mode sets it to a `core.federation.FederationPuller`, which `tick`
samples on the leader.
"""

from __future__ import annotations

import random
import threading
from typing import Dict, Iterable, List, Optional

from nomad_tpu_torch.chaos.clock import Clock, SystemClock

from nomad_tpu_torch.ops import PlacementEngine
from nomad_tpu_torch.state import StateStore
from nomad_tpu_torch.structs import (
    EVAL_STATUS_BLOCKED,
    EVAL_STATUS_FAILED,
    EVAL_STATUS_PENDING,
    Evaluation,
    Job,
    Node,
    TRIGGER_ALLOC_FAILURE,
    TRIGGER_ALLOC_STOP,
    TRIGGER_JOB_DEREGISTER,
    TRIGGER_JOB_REGISTER,
    TRIGGER_NODE_DRAIN,
    TRIGGER_PREEMPTION,
    new_id,
)

# importing the plane modules is what registers them on the ObsBus
# (each registers at module bottom); `identity` is imported for exactly
# that side effect — the server itself only touches it via the bus
from . import (flightrec, identity, memledger,  # noqa: F401 - bus reg
               obsbus, profiling, telemetry, timeline)
from . import logging as logging_mod
from .logging import log
from .blocked_evals import BlockedEvals
from .deployment_watcher import DeploymentWatcher
from .drainer import NodeDrainer
from .eval_broker import EvalBroker
from .periodic import PeriodicDispatch, dispatch_job
from .stream import EventBroker
from .heartbeat import HeartbeatTimers, build_node_evals, invalidate_heartbeat
from .plan_apply import PlanApplier, PlanQueue
from .volume_watcher import VolumeWatcher
from .wavepipe import StageTimers
from .worker import Worker


class Server:
    def __init__(self, num_workers: int = 1, dev_mode: bool = True,
                 heartbeat_ttl: float = 30.0,
                 failed_follow_up_delay: tuple = (60.0, 240.0),
                 acl_enabled: bool = False,
                 state: Optional[StateStore] = None,
                 eval_batch: int = 64,
                 nack_timeout: Optional[float] = None,
                 clock: Optional[Clock] = None,
                 device_executor: str = "torch",
                 mesh=None,
                 slo: Optional[Dict[str, float]] = None,
                 profile_hz: Optional[float] = None,
                 worker_mode: str = "thread",
                 device=None) -> None:
        # the worker plane's mode is checked before anything is built
        # (the reference checks it after the store and engine)
        if worker_mode not in ("thread", "process"):
            raise ValueError(
                f"worker_mode must be 'thread' or 'process', "
                f"got {worker_mode!r}")
        if (worker_mode == "process" and clock is not None
                and not isinstance(clock, SystemClock)):
            # children run on the wall clock of the same host; a
            # virtual timeline cannot cross the process boundary
            raise ValueError(
                "worker_mode='process' requires the wall clock "
                "(seeded VirtualClock soaks stay thread-mode)")
        # injected timebase (chaos/clock.py): every endpoint default
        # `now`, heartbeat deadline, and the tick loop read this clock,
        # so a chaos scenario's VirtualClock owns the whole server's
        # timeline; production default is the wall clock
        self.clock = clock if clock is not None else SystemClock()
        # every observability plane (telemetry registry, tracer, flight
        # recorder, timeline, log ring, identity signer, memory ledger;
        # the profiler opts out — wall-clock by doctrine) rides the same
        # injected clock through the ObsBus seam (core/obsbus.py): one
        # call replaces the former per-plane configure() litany, and the
        # analyzer's `obsbus` pass enforces that new planes register.
        # Planes are process-global like logging.RING; all in-process
        # agents of one simulated cluster share a clock already, so
        # last-write-wins is benign.
        obsbus.OBSBUS.configure(self.clock)
        # cluster-scope metric federation (core/federation.py): the
        # Agent wires a FederationPuller here in cluster mode; the tick
        # loop drives it as a leader duty (None on standalone servers
        # and followers-only deployments)
        self.federation = None
        # max ready evals one worker pass batches into a single device
        # launch (DP over evals, SURVEY §3.6 row 1); <=1 disables batching
        self.eval_batch = eval_batch
        # `state` may be a ReplicatedState proxy (cluster.py): every
        # component below then routes mutations through Raft transparently
        self.state = state if state is not None else StateStore()
        # scheduling domain this server belongs to (reference:
        # nomad/regions.go); the Agent overrides it from its config
        self.region = "global"
        self.eval_broker = (EvalBroker(nack_timeout=nack_timeout)
                            if nack_timeout else EvalBroker())
        if num_workers > 1:
            # zone/domain-partitioned batches: concurrent workers get
            # single-signature batches whose jobs contend for (mostly)
            # disjoint node sets, so the applier's per-node fence keeps
            # every worker on the skip-fit fast path (see
            # EvalBroker.partition_of)
            self.eval_broker.partition_of = self._eval_partition
        self.blocked_evals = BlockedEvals(self.eval_broker)
        self.plan_queue = PlanQueue()
        self.plan_applier = PlanApplier(self.state, self.plan_queue)
        # plan queue-wait / apply latencies measure on the injected
        # clock; the store's eval create/modify stamps ride it too, so
        # a virtual-time soak stamps replayable virtual times
        self.plan_queue.clock = self.clock
        self.plan_applier.clock = self.clock
        self.state.clock = self.clock
        # shared per-stage wall-interval timers (core/wavepipe.py): the
        # workers' WavePipelines record dispatch/device/d2h/materialize,
        # the applier records commit — one clock, so the device↔commit
        # overlap is measurable (exported via /v1/metrics, bench.py)
        self.stage_timers = StageTimers()
        self.plan_applier.timers = self.stage_timers
        # stale-delivery gate: a worker that held evals past the
        # redelivery deadline (device compile) must not double-commit
        # concurrently with the redelivery's worker
        self.plan_applier.token_check = self.eval_broker.token_valid
        self.heartbeats = HeartbeatTimers(ttl=heartbeat_ttl)
        self.deployments = DeploymentWatcher(self)
        self.drainer = NodeDrainer(self)
        self.periodic = PeriodicDispatch(self)
        self.volumes = VolumeWatcher(self)
        self.events = EventBroker()
        self.events.attach(self.state)
        # read-path fanout (core/fanout.py): one store wait per watched
        # shape for every blocking HTTP query; the API's _block parks
        # here.  Set to None to fall back to per-client re-arm loops
        # (the bench watcher A/B baseline).
        from nomad_tpu_torch.core.fanout import WatchHub
        self.watch_hub = WatchHub(self.state, self.clock)
        # `device`: the engine's torch device, CUDA unless given (raises
        # without CUDA).  `mesh`: None = auto (shard the node axis over
        # every card when more than one is visible), False = one device,
        # or a parallel.mesh.Mesh = that many shards of the node axis
        # over its parts — forwarded to PlacementEngine (the
        # sharded-vs-single A/B and the sharded parity suite both need
        # the explicit override)
        self.engine = PlacementEngine(device=device, mesh=mesh)
        self.engine.packer.attach(self.state)
        # pluggable device executor (ops/executor.py, agent_config
        # server.device_executor): the seam the workers' wave pipelines
        # launch through — "torch" (default), riding resident device
        # tensors with the proposed-usage chain held resident ACROSS
        # worker passes, or "bridge", the native CUDA library with its
        # own device buffers.  Raises loudly for "bridge" on a mesh or
        # on the CPU and for any unknown name.
        from nomad_tpu_torch.ops.executor import make_executor
        self.executor = make_executor(device_executor, self.engine)
        # chain hygiene: node writes / restores / capacity-freeing alloc
        # writes invalidate the resident chain (it cannot see them)...
        self.executor.attach_store(self.state)
        # ...and so does any committed plan from OUTSIDE the chain
        self.plan_applier.executor = self.executor
        self.plan_applier.on_preempted = self._on_preempted
        self.dev_mode = dev_mode
        # (baseline, max) delay before a failed eval's follow-up re-enters
        # the queue (reference: evalFailedFollowupBaselineDelay 1min +
        # up to 4min jitter in nomad/leader.go)
        self.failed_follow_up_delay = failed_follow_up_delay
        self.acl_enabled = acl_enabled
        self._acl_cache: Dict[tuple, object] = {}
        # worker plane: "thread" (default) keeps every
        # scheduler worker as an in-process thread — byte-identical to
        # pre-pool builds, and the only mode a VirtualClock can drive.
        # "process" runs the batchable scheduler types in N spawned
        # worker processes (core/workerpool.py) over replica state +
        # the parent-owned device executor behind a submission queue;
        # one thread worker stays in-parent for system/sysbatch/_core.
        self.worker_mode = worker_mode
        self.device_front = None
        self.worker_pool = None
        if worker_mode == "process":
            from nomad_tpu_torch.core.workerpool import (PARENT_SCHEDULERS,
                                                         WorkerPool)
            from nomad_tpu_torch.ops.executor import SubmissionFrontEnd
            # every device launch of the pool children (their waves and
            # forwarded solo placements) funnels through the submission
            # queue so the resident-buffer chain keeps one owner; the
            # in-parent worker's system/sysbatch/_core evals call the
            # engine directly
            self.device_front = SubmissionFrontEnd(self.executor)
            self.workers = [Worker(self, 0, served=PARENT_SCHEDULERS)]
            self.worker_pool = WorkerPool(self, max(num_workers, 1))
        else:
            self.workers = [Worker(self, i) for i in range(num_workers)]
        self._applier_running = False
        self._leader = False
        # serializes tick() bodies: the soak runner drives an explicit
        # tick after each quiesce (so heartbeat expiry lands in a
        # deterministic virtual-time bucket of the timeline) while the
        # threaded tick loop keeps its own cadence — the duties are
        # idempotent but must not interleave
        self._tick_lock = threading.Lock()
        # capacity-change events release blocked evals
        self.state.subscribe(self._on_state_event)
        # health watchdog (core/flightrec.py): declarative SLO rules
        # (agent_config server.slo.*) evaluated each tick against the
        # rolling-window histograms and counter deltas; a breach emits a
        # HealthBreach event and snapshots a dump bundle
        self.health = flightrec.HealthWatchdog(slo=slo, clock=self.clock)
        self.health.on_breach = self._on_health_breach
        # continuous profiling plane (core/profiling.py): the host
        # sampler is always-on at a low default rate (agent_config
        # server.profile_hz tunes it; <= 0 disables).  Unlike every
        # configure() above, the PROFILER deliberately does NOT get this
        # server's injected clock — it samples the real process
        # regardless of whose timeline the server runs on, and stays up
        # across server close (it profiles the process, not a server)
        profiling.configure(hz=profile_hz)
        profiling.PROFILER.device_ledger_provider = self._device_ledger
        profiling.PROFILER.flight_provider = flightrec.FLIGHT.snapshot
        # memory ledger plane registrations (core/memledger.py): every
        # bounded plane this server owns gets a sizer; last-write-wins
        # by name, so a new Server re-binds its planes the way the
        # configure() calls above re-bind the clock.  `state` may be a
        # ReplicatedState proxy without the sizer hooks — register what
        # exists and skip the rest.
        ml = memledger.MEMLEDGER
        if hasattr(self.state, "mem_stats"):
            ml.register("state", self.state.mem_stats)
        if hasattr(self.state, "journal_stats"):
            ml.register("journal", self.state.journal_stats)
        ml.register("watch_hub", self.watch_hub.mem_stats)
        ml.register("events", self.events.mem_stats)
        ml.register("flight", flightrec.FLIGHT.mem_stats)
        ml.register("timeline", timeline.TIMELINE.mem_stats)
        ml.register("tracer", telemetry.TRACER.mem_stats)
        ml.register("metrics", telemetry.REGISTRY.mem_stats)
        ml.register("logring", logging_mod.RING.mem_stats)
        ml.register("profiler", profiling.PROFILER.mem_stats)
        if self.worker_pool is not None:
            ml.register("worker_pool", self.worker_pool.mem_stats)
        else:
            ml.unregister("worker_pool")
        # blocking watchers re-touch their shape each park; a shape
        # nobody has parked on for this long is garbage (defensive GC —
        # the pop-at-zero path already frees the common case)
        self.watch_idle_s = 300.0

    def _device_ledger(self) -> Dict:
        """Capture-bundle provider: this server's executor ledger
        (compile cache + HBM residency + transfer attribution)."""
        return self.executor.ledger()

    def _on_health_breach(self, verdict: Dict, bundle: Dict) -> None:
        """Fan a newly-breached SLO rule out as a HealthBreach event
        (live + replayable from the stream buffer) and a log record."""
        doc = {"Rule": verdict["Rule"], "Kind": verdict["Kind"],
               "Observed": verdict["Observed"],
               "Threshold": verdict["Threshold"],
               "Unit": verdict["Unit"], "At": bundle["At"]}
        self.events._on_state_event(
            "HealthBreach", max(self.state.latest_index(), 1), doc)
        log("health", "error", "SLO breach", rule=verdict["Rule"],
            observed=verdict["Observed"], threshold=verdict["Threshold"])

    # --------------------------------------------------------- leadership

    def establish_leadership(self) -> None:
        """reference: leaderLoop/establishLeadership — enable broker, plan
        queue, blocked evals; restore pending evals from state."""
        self._leader = True
        log("server", "info", "leadership established")
        telemetry.REGISTRY.inc("nomad.server.leadership_transitions")
        timeline.TIMELINE.annotate("leadership.established",
                                   region=self.region)
        # workload-identity signing secret: minted once per cluster
        # (first-writer-wins in the store; replicated + snapshotted)
        if not self.state.identity_secret():
            self.state.set_identity_secret(new_id() + new_id())
        self.eval_broker.set_enabled(True)
        self.blocked_evals.set_enabled(True)
        self.plan_queue.set_enabled(True)
        snap = self.state.snapshot()
        now = self.clock.time()
        # restored evals must not schedule against state older than this
        # restore point: floor their wait index (worker waitForIndex) at
        # the snapshot we restored from, so an eval whose plan already
        # committed under the previous leadership re-runs with that plan
        # visible instead of double-placing
        floor = self.state.latest_index()
        for ev in snap.evals():
            if ev.status == EVAL_STATUS_PENDING:
                if (ev.modify_index or 0) < floor:
                    ev = ev.copy()
                    ev.modify_index = floor
                self.eval_broker.enqueue(ev, now=now)
            elif ev.status == EVAL_STATUS_BLOCKED:
                if not self.blocked_evals.block(ev):
                    self._cancel_eval(ev)
        # restore periodic launch tracking (reference: restorePeriodicDispatch)
        for j in snap.jobs():
            if j.periodic is not None:
                self.periodic.add(j, now=now)
        # fresh TTL grace for EVERY ready node: after (re)gaining
        # leadership any pre-existing deadline is stale — the node has
        # been heartbeating some other leader meanwhile, and an old
        # frozen deadline would expire a live node on the first tick
        # (reference: initializeHeartbeatTimers)
        for n in snap.nodes():
            if n.status == "ready":
                self.heartbeats.reset(n.id, now)

    def revoke_leadership(self) -> None:
        """reference: revokeLeadership — disable the leader-only machinery
        when Raft moves the leadership elsewhere (cluster mode)."""
        if not self._leader:
            return
        self._leader = False
        log("server", "info", "leadership revoked")
        telemetry.REGISTRY.inc("nomad.server.leadership_revocations")
        timeline.TIMELINE.annotate("leadership.revoked",
                                   region=self.region)
        self.eval_broker.set_enabled(False)
        self.blocked_evals.set_enabled(False)
        self.plan_queue.set_enabled(False)

    def start(self, tick_interval: float = 1.0,
              establish: bool = True) -> None:
        """Threaded mode: start applier + workers + the tick loop that
        drives heartbeat expiry and broker timeouts.  `establish=False`
        (cluster mode): leadership comes from the Raft election callback
        instead of being assumed."""
        if establish and not self._leader:
            self.establish_leadership()
        self.dev_mode = False
        self.plan_applier.start()
        self._applier_running = True
        for w in self.workers:
            w.start()
        if self.worker_pool is not None:
            self.worker_pool.ensure_started()
            self.worker_pool.resume()
        self._tick_stop = threading.Event()

        def tick_loop():
            while not self.clock.wait(self._tick_stop, tick_interval):
                # a tick must never kill the loop: leadership can move
                # between tick()'s _leader check and a forwarded write
                # (NotLeaderError), and any other transient failure will
                # be retried next tick anyway
                try:
                    self.tick()
                except Exception as exc:  # noqa: BLE001
                    log("server", "warn", "tick failed", error=repr(exc))

        self._tick_thread = threading.Thread(target=tick_loop,
                                             name="server-tick", daemon=True)
        self._tick_thread.start()

    def shutdown(self) -> None:
        if getattr(self, "_tick_thread", None) is not None:
            self._tick_stop.set()
            self._tick_thread.join(timeout=5)
            self._tick_thread = None
        if self.worker_pool is not None:
            self.worker_pool.close()
        for w in self.workers:
            w.stop()
        if self._applier_running:
            self.plan_applier.stop()
            self._applier_running = False
        self.eval_broker.set_enabled(False)
        self.events.close()
        self.executor.release()

    def maybe_apply_inline(self, pending) -> None:
        """dev_mode: the worker's submit_plan applies plans synchronously
        (there is no applier thread)."""
        if not self._applier_running:
            self.plan_applier.apply_one(pending)

    def start_scheduling(self) -> None:
        """Start ONLY the applier + worker threads (no tick loop) — for
        drivers like bench.py that enqueue everything first and control
        time themselves.  Keeps _applier_running consistent: starting the
        applier thread without it would double-apply every plan (inline
        at submit AND via the queue drain)."""
        self.plan_applier.start()
        self._applier_running = True
        for w in self.workers:
            w.start()
        if self.worker_pool is not None:
            self.worker_pool.ensure_started()
            self.worker_pool.resume()

    def stop_scheduling(self) -> None:
        if self.worker_pool is not None:
            # quiesce children FIRST (their plans must drain through the
            # applier before it stops); processes stay warm for the next
            # round — only shutdown() reaps them
            self.worker_pool.pause(wait=True)
        for w in self.workers:
            w.stop()
        self.plan_applier.stop()
        self._applier_running = False
        self.plan_queue.set_enabled(True)   # re-arm for a next round

    # ------------------------------------------------------- job endpoint

    def register_job(self, job: Job,
                     now: Optional[float] = None) -> Optional[Evaluation]:
        """reference: Job.Register RPC — upsert + eval create + enqueue.
        Periodic and parameterized PARENTS are never scheduled directly:
        they get no eval; the dispatcher launches child jobs."""
        t = now if now is not None else self.clock.time()
        if job.periodic is not None and job.periodic.enabled:
            # validate the cron spec BEFORE persisting: a bad spec must
            # reject the registration, not leave an untracked parent
            from .periodic import CronSpec
            CronSpec(job.periodic.spec)
        self.state.upsert_job(job)
        stored = self.state.job_by_id(job.namespace, job.id)
        if stored.periodic is not None:
            self.periodic.add(stored, now=t)
            return None
        if stored.parameterized is not None:
            return None
        ev = Evaluation(
            namespace=job.namespace,
            priority=stored.priority,
            type=stored.type,
            triggered_by=TRIGGER_JOB_REGISTER,
            job_id=stored.id,
            job_modify_index=stored.modify_index,
        )
        self.apply_eval_update([ev], now=t)
        return ev

    def dispatch_job(self, namespace: str, job_id: str, payload: bytes = b"",
                     meta: Optional[Dict[str, str]] = None,
                     now: Optional[float] = None):
        """reference: Job.Dispatch RPC — mint a child of a parameterized
        job with payload/meta merged in.  Returns (child_job, error)."""
        return dispatch_job(self, namespace, job_id, payload, meta, now=now)

    def revert_job(self, namespace: str, job_id: str, version: int,
                   now: Optional[float] = None):
        """reference: Job.Revert RPC — re-register a prior version's spec
        as a NEW version.  Returns (eval_or_none, error)."""
        prior = self.state.job_by_id_and_version(namespace, job_id, version)
        if prior is None:
            return None, f"job version {version} not found"
        cur = self.state.job_by_id(namespace, job_id)
        if cur is not None and cur.version == version:
            return None, "can't revert to current version"
        reverted = prior.copy()
        reverted.stop = False
        return self.register_job(reverted, now=now), ""

    def force_gc(self, now: Optional[float] = None) -> None:
        """reference: System.GarbageCollect RPC (`nomad system gc`)."""
        self.apply_eval_update([Evaluation(
            type="_core", job_id="force-gc", priority=100)], now=now)

    # ------------------------------------------------------------------ acl

    def bootstrap_acl(self):
        """Mint the initial management token (reference: ACL.Bootstrap).
        Returns (token, error)."""
        from nomad_tpu_torch.structs import ACL_TOKEN_TYPE_MANAGEMENT, ACLToken
        token = ACLToken(name="Bootstrap Token",
                         type=ACL_TOKEN_TYPE_MANAGEMENT,
                         global_=True, create_time=self.clock.time())
        # the exists-check and insert are one atomic store op: concurrent
        # bootstrap requests must not each mint a management token
        if not self.state.bootstrap_acl_token(token):
            return None, "ACL bootstrap already done"
        return token, ""

    def derive_identity_tokens(self, alloc_id: str):
        """Mint one workload identity per task of a live alloc
        (reference: Alloc.SignIdentities RPC / identity_hook).
        Returns ({task_name: token}, error)."""
        from .identity import mint
        alloc = self.state.alloc_by_id(alloc_id)
        if alloc is None:
            return None, "alloc not found"
        if alloc.terminal_status():
            return None, "alloc is terminal"
        secret = self.state.identity_secret()
        if not secret:
            return None, "identity keyring not initialized"
        job = alloc.job or self.state.job_by_id(alloc.namespace,
                                                alloc.job_id)
        tg = job.lookup_task_group(alloc.task_group) if job else None
        tasks = [t.name for t in tg.tasks] if tg else []
        return {t: mint(secret, namespace=alloc.namespace,
                        job_id=alloc.job_id, alloc_id=alloc_id, task=t)
                for t in tasks}, ""

    def read_variable(self, namespace: str, path: str, token: str):
        """Read one variable under a caller credential — the secrets
        plane's server half (reference: Variables.Read RPC; the workload
        identity resolves to the implicit job-subtree read policy).
        Returns (items, error)."""
        acl, err = self.resolve_token(token)
        if acl is None:
            return None, err or "permission denied"
        if not acl.allow_variable(namespace, path, write=False):
            return None, f"permission denied: variables-read {path!r}"
        var = self.state.variable_by_path(namespace, path)
        if var is None:
            return None, ""
        return dict(var.items), ""

    def resolve_token(self, secret_id: str):
        """secret -> compiled ACL; (None, error) when unknown
        (reference: Server.ResolveToken + its ACL cache).  Workload
        identity tokens resolve to the implicit read-only policy over
        the job's variable subtree."""
        from nomad_tpu_torch.acl import compile_acl, management_acl, parse_policy
        from .identity import IDENTITY_PREFIX, variable_prefix, verify
        if secret_id.startswith(IDENTITY_PREFIX):
            secret = self.state.identity_secret()
            if not secret:
                # NEVER verify against a fallback value — an empty
                # keyring means no identity can possibly be valid
                return None, "identity keyring not initialized"
            claims = verify(secret, secret_id)
            if claims is None:
                return None, "invalid workload identity"
            ns = claims.get("nomad_namespace")
            job_id = claims.get("nomad_job_id")
            if not ns or not job_id:
                return None, "invalid workload identity claims"
            alloc = self.state.alloc_by_id(
                claims.get("nomad_allocation_id", ""))
            if alloc is None or alloc.terminal_status():
                return None, "workload identity alloc not active"
            from nomad_tpu_torch.acl import workload_acl
            return workload_acl(ns, variable_prefix(job_id)), ""
        if not self.acl_enabled:
            return management_acl(), ""
        if not secret_id:
            from nomad_tpu_torch.acl import ACL
            return ACL(), ""           # anonymous: no capabilities
        token = self.state.acl_token_by_secret(secret_id)
        if token is None:
            return None, "ACL token not found"
        if token.expired(self.clock.time()):
            return None, "ACL token expired"
        if token.is_management():
            return management_acl(), ""
        pols = [(name, self.state.acl_policy_by_name(name))
                for name in token.policies]
        # compiled-ACL cache: HCL parse + compile is too hot for a
        # per-request path; key on every contributing modify_index so
        # token rotation / policy edits invalidate naturally
        key = (token.accessor_id, token.modify_index,
               tuple((n, p.modify_index if p else -1) for n, p in pols))
        hit = self._acl_cache.get(key)
        if hit is not None:
            return hit, ""
        acl = compile_acl([parse_policy(p.rules)
                           for _, p in pols if p is not None])
        if len(self._acl_cache) > 512:
            self._acl_cache.clear()
        self._acl_cache[key] = acl
        return acl, ""

    # ------------------------------------------------------ checkpointing

    def save_snapshot(self) -> Dict:
        """reference: `nomad operator snapshot save`."""
        return self.state.snapshot_save()

    def restore_snapshot(self, doc: Dict) -> None:
        """reference: `nomad operator snapshot restore` — replace state,
        then re-run the leadership restore path so brokers/trackers match
        the restored state."""
        self.eval_broker.set_enabled(False)    # drop stale queue contents
        self.blocked_evals.set_enabled(False)
        self.state.snapshot_restore(doc)
        self._acl_cache.clear()
        # heartbeat timers must track the RESTORED node set: restored
        # nodes get a fresh TTL (their clients re-heartbeat or expire);
        # timers for nodes absent from the snapshot are dropped
        now = self.clock.time()
        self.heartbeats = HeartbeatTimers(ttl=self.heartbeats.ttl)
        for n in self.state.snapshot().nodes():
            if n.status == "ready":
                self.heartbeats.reset(n.id, now)
        self.establish_leadership()

    def deregister_job(self, namespace: str, job_id: str,
                       purge: bool = False,
                       now: Optional[float] = None) -> Optional[Evaluation]:
        t = now if now is not None else self.clock.time()
        job = self.state.job_by_id(namespace, job_id)
        if job is None:
            return None
        stopped = job.copy()
        stopped.stop = True
        self.state.upsert_job(stopped)
        if purge:
            self.state.delete_job(namespace, job_id)
        self.blocked_evals.untrack(namespace, job_id)
        self.periodic.remove(namespace, job_id)
        ev = Evaluation(
            namespace=namespace,
            priority=job.priority,
            type=job.type,
            triggered_by=TRIGGER_JOB_DEREGISTER,
            job_id=job_id,
        )
        self.apply_eval_update([ev], now=t)
        return ev

    # ------------------------------------------------------ node endpoint

    def register_node(self, node: Node, now: Optional[float] = None) -> None:
        t = now if now is not None else self.clock.time()
        if not node.region or node.region == "global":
            node.region = self.region
        self.state.upsert_node(node)
        self.heartbeats.reset(node.id, t)

    def heartbeat_node(self, node_id: str, now: Optional[float] = None) -> None:
        t = now if now is not None else self.clock.time()
        self.heartbeats.reset(node_id, t)
        # a heartbeat from a node the server expired brings it back
        # (reference: the client keeps beating while the server thought
        # it dead — UpdateStatus ready re-evaluates its jobs and lets
        # blocked placements land on the recovered capacity).  Without
        # this a single missed-TTL flap marks a live client down forever.
        node = self.state.node_by_id(node_id)
        if node is not None and node.status == "down":
            self.update_node_status(node_id, "ready", now=t)

    def update_node_status(self, node_id: str, status: str,
                           now: Optional[float] = None) -> List[Evaluation]:
        t = now if now is not None else self.clock.time()
        node = self.state.node_by_id(node_id)
        self.state.update_node_status(node_id, status)
        evals: List[Evaluation] = []
        if status == "down" and node is not None:
            evals = build_node_evals(self.state.snapshot(), node_id)
        elif (status == "ready" and node is not None
              and node.status != "ready"):
            # recovered capacity: reconcile jobs that still have allocs
            # here AND re-place system jobs that lost theirs while the
            # node was down (reference: Node.createNodeEvals on ready)
            evals = build_node_evals(self.state.snapshot(), node_id,
                                     include_system=True)
        self.apply_eval_update(evals, now=t)
        return evals

    def drain_node(self, node_id: str, strategy,
                   now: Optional[float] = None) -> None:
        """Start or cancel (strategy=None) a node drain
        (reference: Node.UpdateDrain RPC → nomad/drainer/)."""
        self.drainer.drain_node(node_id, strategy, now=now)

    def set_node_eligibility(self, node_id: str, eligible: bool) -> None:
        """reference: Node.UpdateEligibility RPC."""
        node = self.state.node_by_id(node_id)
        was_eligible = (node is not None
                        and node.scheduling_eligibility == "eligible")
        if eligible and node is not None and node.drain is not None:
            # a finished drain's marker is cleared lazily on the next
            # drainer tick; an operator restoring eligibility inside that
            # window would leave the node drain-flagged (ready_nodes skips
            # it) with the node-update evals below landing as no-ops —
            # restoring eligibility cancels any lingering drain first
            self.drainer.drain_node(node_id, None)
        self.state.update_node_eligibility(
            node_id, "eligible" if eligible else "ineligible")
        if eligible and node is not None and not was_eligible:
            timeline.TIMELINE.annotate("drain.restore", node=node_id)
            # capacity returning from a drain: system jobs whose alloc
            # was evicted here need a fresh placement, and blocked jobs
            # a chance at the freed node — without this, a drained-then-
            # restored node never regains its system allocs
            self.apply_eval_update(build_node_evals(
                self.state.snapshot(), node_id, include_system=True))

    def update_alloc_desired_transition(self, alloc_ids, transition,
                                        now: Optional[float] = None) -> None:
        """Flag allocs for migration and re-evaluate their jobs
        (reference: Alloc.UpdateDesiredTransition RPC)."""
        t = now if now is not None else self.clock.time()
        self.state.update_alloc_desired_transition(alloc_ids, transition)
        evals: List[Evaluation] = []
        seen = set()
        for aid in alloc_ids:
            a = self.state.alloc_by_id(aid)
            if a is None:
                continue
            key = (a.namespace, a.job_id)
            if key in seen:
                continue
            seen.add(key)
            job = self.state.job_by_id(a.namespace, a.job_id)
            if job is None:
                continue
            evals.append(Evaluation(
                namespace=a.namespace,
                priority=job.priority,
                type=job.type,
                triggered_by=TRIGGER_NODE_DRAIN,
                job_id=a.job_id,
            ))
        self.apply_eval_update(evals, now=t)

    def get_client_allocs(self, node_id: str, min_index: int,
                          timeout: float = 5.0):
        """reference: Node.GetClientAllocs — blocking query: waits until
        the state index advances past min_index, then returns the node's
        allocations (with job attached) and the current index."""
        self.state.wait_for_index(min_index + 1, timeout=timeout)
        snap = self.state.snapshot()
        allocs = snap.allocs_by_node(node_id)
        return allocs, snap.index

    def update_allocs_from_client(self, updates,
                                  now: Optional[float] = None) -> None:
        """reference: Node.UpdateAlloc — merge client statuses, then create
        evals for terminal allocs so the scheduler reacts (reschedule on
        failure, next periodic/batch bookkeeping on completion)."""
        t = now if now is not None else self.clock.time()
        updates = list(updates)
        self.state.update_allocs_from_client(updates)
        evals: List[Evaluation] = []
        seen = set()
        for u in updates:
            if not u.client_terminal_status():
                continue
            stored = self.state.alloc_by_id(u.id)
            if stored is None:
                continue
            job = self.state.job_by_id(stored.namespace, stored.job_id)
            if job is None or job.stopped():
                continue
            failed = u.client_status == "failed"
            key = (stored.namespace, stored.job_id, failed)
            if key in seen:
                continue
            seen.add(key)
            evals.append(Evaluation(
                namespace=stored.namespace,
                priority=job.priority,
                type=job.type,
                triggered_by=(TRIGGER_ALLOC_FAILURE if failed
                              else TRIGGER_ALLOC_STOP),
                job_id=stored.job_id,
            ))
        self.apply_eval_update(evals, now=t)

    # ------------------------------------------------------ eval plumbing

    def _on_preempted(self, allocs: List) -> None:
        """Plan-applier hook: each job an applied plan preempted runs
        below its desired count now — one follow-up eval per distinct
        (namespace, job) replaces the evicted work elsewhere
        (reference: planApply's preemption follow-up evals)."""
        seen = set()
        evals: List[Evaluation] = []
        for a in allocs:
            key = (a.namespace, a.job_id)
            if key in seen:
                continue
            seen.add(key)
            job = self.state.job_by_id(a.namespace, a.job_id)
            evals.append(Evaluation(
                namespace=a.namespace,
                priority=job.priority if job else 50,
                type=job.type if job else "service",
                triggered_by=TRIGGER_PREEMPTION,
                job_id=a.job_id,
            ))
        self.apply_eval_update(evals)

    def apply_eval_update(self, evals: Iterable[Evaluation],
                          now: Optional[float] = None) -> None:
        """The FSM ApplyEval analog: persist evals, then route pending ones
        to the broker and blocked ones to the tracker."""
        evals = list(evals)
        if not evals:
            return
        t = now if now is not None else self.clock.time()
        # trace-context origin: every eval entering the FSM gets a trace
        # id here (its own id — deterministic and join-friendly); evals
        # minted by other evals (follow-ups, blocked) inherit instead
        for ev in evals:
            if not ev.trace_id:
                ev.trace_id = ev.id
        # an eval TRANSITIONING to failed (scheduler retry exhaustion,
        # delivery limit) gets a delayed follow-up so its job is not
        # stranded until the next state change (reference: leader.go
        # reapFailedEvaluations / eval.CreateFailedFollowUpEval).  Only on
        # transition: a persistently-failing eval re-upserted as failed on
        # every redelivery must mint ONE follow-up, not one per delivery
        # (geometric eval storm otherwise).
        follow_ups = []
        for ev in evals:
            if ev.status == EVAL_STATUS_FAILED:
                prev = self.state.eval_by_id(ev.id)
                if prev is None or prev.status != EVAL_STATUS_FAILED:
                    lo, hi = self.failed_follow_up_delay
                    follow_ups.append(ev.create_failed_follow_up_eval(
                        t + random.uniform(lo, hi)))
        evals.extend(follow_ups)
        self.state.upsert_evals(evals)
        for ev in evals:
            if ev.should_enqueue():
                self.eval_broker.enqueue(ev, now=t)
            elif ev.should_block():
                if not self.blocked_evals.block(ev):
                    self._cancel_eval(ev)

    def _cancel_eval(self, ev: Evaluation) -> None:
        """Duplicate blocked eval: cancel it in state so it neither lingers
        as 'blocked' forever nor re-feeds the tracker on leader flaps."""
        c = ev.copy()
        c.status = "canceled"
        c.status_description = "canceled: duplicate blocked evaluation"
        self.state.upsert_evals([c])

    # ------------------------------------------------------------- events

    def _on_state_event(self, topic: str, index: int, payload) -> None:
        """Capacity-change signals release blocked evals
        (reference: BlockedEvals.Unblock wiring in nomad/fsm.go)."""
        if topic == "Node" and not isinstance(payload, str):
            if payload.ready():
                self.blocked_evals.unblock(payload.computed_class,
                                           index=index)
        elif topic == "Allocations":
            for a in payload:
                if a.terminal_status() and a.node_id:
                    node = self.state.node_by_id(a.node_id)
                    if node is not None:
                        self.blocked_evals.unblock(node.computed_class,
                                                   index=index)

    # --------------------------------------------------------------- tick

    def _eval_partition(self, ev):
        """Placement-domain signature of an eval's job: jobs sharing it
        contend for the same nodes (same datacenters/pool and the same
        CSI volume topologies); distinct signatures mostly don't.  Used
        by the broker to hand concurrent workers disjoint batches."""
        job = self.state.job_by_id(ev.namespace, ev.job_id)
        if job is None:
            return None
        vols = tuple(sorted(
            vr.source for tg in job.task_groups
            for vr in (tg.volumes or {}).values()
            if vr.type == "csi" and vr.source))
        return (tuple(sorted(job.datacenters)), job.node_pool, vols)

    def tick(self, now: Optional[float] = None) -> None:
        """Periodic leader duties: broker delayed-eval promotion + nack
        timeouts, heartbeat expiry."""
        t = now if now is not None else self.clock.time()
        with self._tick_lock:
            self._tick_locked(t)
        # metric federation is a leader duty like the timers above, but
        # its scrapes are real HTTP to peers — that I/O stays OUTSIDE
        # the tick lock so a slow or dead peer (connect timeout) can
        # never stall health/timeline sampling for the next tick.
        # Throttled inside the puller (injected-clock cadence + wall
        # floor, the MEMLEDGER discipline), and it never raises — a
        # dead peer is a counted scrape failure, not a broken tick.
        # The unlocked _leader read is the same benign race the tick
        # loop already tolerates (leadership can move mid-tick).
        if self.federation is not None and self._leader:
            self.federation.sample(self.clock.monotonic())

    def _tick_locked(self, t: float) -> None:
        # the health watchdog is node-local observability, not a leader
        # duty: followers evaluate their own SLOs too (throttled to
        # slo.interval_s; reads the monotonic clock like the windows)
        self.health.tick(self.clock.monotonic())
        # retrospective history rides the same cadence: one clock-
        # aligned timeline row per tick, followers included (their
        # gauges and windows are node-local too)
        timeline.TIMELINE.sample(self.clock.monotonic())
        # footprint sampling shares the tick too (throttled inside the
        # ledger); idle-shape GC rides the same cadence so a scrape
        # never reports shapes the fanout plane has already abandoned
        if memledger.MEMLEDGER.sample(self.clock.monotonic()):
            self.watch_hub.reap_idle(self.clock.monotonic(),
                                     self.watch_idle_s)
        if not self._leader:
            # followers carry no timers/queues; their copies of these
            # duties belong to the leader (reference: leaderLoop)
            return
        self.eval_broker.tick(t)
        # delivery-limit failures: mark failed in state (apply_eval_update
        # then creates the delayed follow-up)
        reaped = self.eval_broker.drain_failed()
        if reaped:
            updates = []
            for ev in reaped:
                f = ev.copy()
                f.status = EVAL_STATUS_FAILED
                f.status_description = "maximum delivery attempts exceeded"
                updates.append(f)
            self.apply_eval_update(updates, now=t)
        for node_id in self.heartbeats.expired(t):
            log("heartbeat", "warn", "node heartbeat missed; marking down",
                node_id=node_id)
            # the flap-storm SLO rule counts these per check interval
            telemetry.REGISTRY.inc("nomad.heartbeat.missed")
            evals = invalidate_heartbeat(self.state, node_id, t)
            self.apply_eval_update(evals, now=t)
        self.deployments.tick(t)
        self.drainer.tick(t)
        self.periodic.tick(t)
        self.volumes.tick(t)

    # ---------------------------------------------------------- dev drive

    def process_all(self, now: Optional[float] = None, limit: int = 1000,
                    ) -> int:
        """dev_mode: drain the broker with worker 0 until empty.  Returns
        the number of evals processed."""
        t = now if now is not None else self.clock.time()
        n = 0
        while n < limit:
            handled = self.workers[0].run_once(timeout=0.0, now=t)
            if not handled:
                break
            n += handled
        return n
