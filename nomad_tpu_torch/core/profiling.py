"""Continuous profiling plane: host flamegraphs, device ledgers,
on-demand capture bundles.

PERF.md's two biggest wins came from one-off, by-hand profiling
("worker-thread profiling exposed three host costs"; "CPU scale is
dominated by one-time chained-kernel compiles"), and ROADMAP item 5
(multi-process workers) cannot be scoped without a number for how much
of a worker's wall time is GIL wait.  This module makes profiling a
standing plane of the product instead of an artifact of someone's
terminal history:

  - `SamplingProfiler`: an always-on daemon thread samples
    `sys._current_frames()` at a configurable hz, folds stacks per
    thread ROLE (worker / applier / raft / broker / http / client /
    chaos / other) into bounded merge-by-count tables, and classifies
    every thread-sample into a named BUCKET:

      device-wait   blocked in block_until_ready / device fetch (the
                    GIL is released — the host is free)
      lock-wait     blocked acquiring a Lock/Condition
      idle          parked on an Event/queue/clock wait (no work queued)
      gil-wait      runnable Python that cannot run because another
                    thread holds the GIL — measured by threads-runnable
                    vs threads-on-cpu accounting: when N threads are
                    simultaneously executing-Python in one sample, only
                    one can actually hold the GIL, so each such thread
                    sample is (N-1)/N gil-wait and 1/N its own bucket
      wire          serializing / deserializing / socket I/O (json,
                    pickle, core/wire framing, the HTTP plane)
      host          pure-host Python work (the residual)

    The folded-stack tables export in flamegraph.pl / speedscope
    "folded" format: `role;frame;frame;... count` per line.

  - `CompileLedger` (the device ledger's compile half): per-site,
    per-shape-bucket compile-cache hits / misses / first-launch
    seconds vs steady-call split.  ops/engine.py records `_sharded_fn`
    cache traffic here; ops/executor.py records the PJRT bridge's
    StableHLO compiles.  The HBM-residency half lives on the executor
    (`DeviceExecutor.ledger()`), built from retained buffer handle
    sizes.

  - `capture()`: a timed on-demand capture (POST /v1/operator/profile,
    SDK `operator.profile`, CLI `nomad profile`) bundling the folded
    stacks, bucket breakdown, device ledger, optional `torch.profiler`
    trace, and the active flight-recorder rings into one retained
    schema-stamped bundle ("nomad-tpu.profile.v1"), folded into
    /v1/operator/debug and linkable from HealthBreach dumps.

Clock discipline: the sampler deliberately reads the REAL clock
(`time.perf_counter` intervals, `Event.wait` sleeps), never the
injected chaos Clock — a VirtualClock soak must replay byte-identical
with the sampler on or off, so the sampler may observe virtual-time
runs but must never participate in their timeline (and it writes to no
ring, registry, or tracer while sampling: snapshots are computed on
demand from its own private tables).

Differences from the reference (nomad_tpu/core/profiling.py), because the
port runs on PyTorch and CUDA, not JAX:
  - a capture's optional device trace is a `torch.profiler.profile`
    window (CPU activity, and CUDA activity when the process has a
    card), exported at stop as a Chrome trace into the capture's
    directory; the bundle carries it under `torch_trace`, not
    `jax_trace`.  A profiler that cannot start records
    `{"ok": False, "error": ...}`, as the reference's does;
  - `_DEVICE_WAIT_FUNCS` names the frames in which the port waits for
    the card: `synchronize` (the result's CUDA event at collect,
    `torch.cuda.Event.synchronize`, and `torch.cuda.synchronize`) and
    the engine's `_fetch` (a blocking `Tensor.cpu()` copy), not JAX's
    `block_until_ready` and array-fetch frames.
"""

from __future__ import annotations

import itertools
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

SCHEMA = "nomad-tpu.profile.v1"

# default sampling rate: 19 Hz keeps the whole-process sample cost well
# under the 2% overhead budget (PERF.md §16 measures it) while giving
# ~40 samples over a 2s capture — enough to rank buckets
DEFAULT_HZ = 19.0

# thread-name prefix -> role (first match wins; names are assigned at
# Thread construction across core/, client/, api/ — see the modules)
_ROLE_PREFIXES: Tuple[Tuple[str, str], ...] = (
    ("worker-", "worker"),
    ("plan-applier", "applier"),
    ("raft-", "raft"),
    ("rpc-", "raft"),
    ("gossip-", "raft"),
    ("autopilot-", "raft"),
    ("election-", "raft"),
    ("heartbeat-", "raft"),
    ("probe-", "raft"),
    ("server-tick", "broker"),
    ("http-api", "http"),
    ("client-", "client"),
    ("checks-", "client"),
    ("alloc-", "client"),
    ("task-", "client"),
    ("exec-", "client"),
    ("plugin-", "client"),
    ("chaos-", "chaos"),
    # multi-process worker plane (core/workerpool): parent attendants
    # and child-side RPC threads do scheduler work on behalf of a pool
    # worker — account them under the worker role
    ("pool-", "worker"),
)

# `queue-wait`: blocked behind the shared device executor's submission
# queue (ops/executor.SubmissionFrontEnd) — the multi-process pool's
# analogue of gil-wait
BUCKETS = ("device-wait", "lock-wait", "gil-wait", "queue-wait",
           "idle", "wire", "host")

# stack-frame classification tables (checked against the co_name and
# filename of sampled frames, innermost first)
_DEVICE_WAIT_FUNCS = frozenset((
    "synchronize", "_fetch",
))
_LOCK_WAIT_FUNCS = frozenset((
    "acquire", "_wait_for_tstate_lock", "__enter__",
))
_IDLE_FILES = ("/chaos/clock.py", "/queue.py", "/selectors.py",
               "/socketserver.py", "/concurrent/futures/")
_WIRE_FILES = ("/wire.py", "/json/", "/pickle.py", "/socket.py",
               "/ssl.py", "/http/", "/api/http_server.py")

_FOLD_CAP = 512          # distinct folded stacks retained per role
_STACK_DEPTH = 48        # frames kept per folded stack
_CAPTURE_CAP = 8         # retained on-demand capture bundles

# ------------------------------------------------------ activity markers

_tls = threading.local()

# cross-thread marker map: threading.local has no cross-thread read, so
# `activity` also publishes into this ident-keyed dict for the sampler.
# A plain dict write/delete is atomic under the GIL; stale entries for
# exited threads are skipped (the sampler only reads idents it just
# enumerated as alive).
_MARKS: Dict[int, str] = {}


class activity:
    """Context manager: mark the current thread's activity for the
    sampler (worker device-waits, broker idle polls).  A marker beats
    the stack heuristics — `with profiling.activity("device-wait"):`
    around a block_until_ready makes the classification exact whatever
    the backend's frames look like.  Nestable; a few attribute/dict
    writes per enter/exit, cheap enough for the hot loop."""

    __slots__ = ("name", "_prev")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> "activity":
        self._prev = getattr(_tls, "activity", None)
        _tls.activity = self.name
        _MARKS[threading.get_ident()] = self.name
        return self

    def __exit__(self, *exc) -> None:
        _tls.activity = self._prev
        if self._prev is None:
            _MARKS.pop(threading.get_ident(), None)
        else:
            _MARKS[threading.get_ident()] = self._prev


def current_activity() -> Optional[str]:
    return getattr(_tls, "activity", None)


# ------------------------------------------------------- classification

def role_of(thread_name: str) -> str:
    for prefix, role in _ROLE_PREFIXES:
        if thread_name.startswith(prefix):
            return role
    return "other"


def classify_stack(frame) -> str:
    """Bucket for one sampled thread given its innermost frame (marker
    absent).  Walks outward; the innermost recognizable signal wins."""
    depth = 0
    f = frame
    while f is not None and depth < _STACK_DEPTH:
        code = f.f_code
        fn = code.co_filename
        name = code.co_name
        if name in _DEVICE_WAIT_FUNCS:
            return "device-wait"
        if fn.endswith("/threading.py") or fn.endswith("threading.py"):
            # Event.wait / Condition.wait vs Lock.acquire: a bare
            # `wait` under an idle-ish caller is parked, not contending
            if name in _LOCK_WAIT_FUNCS:
                return "lock-wait"
            if name == "wait":
                caller = f.f_back
                while caller is not None:
                    cfn = caller.f_code.co_filename
                    if any(p in cfn for p in _IDLE_FILES):
                        return "idle"
                    if not (cfn.endswith("threading.py")):
                        break
                    # Semaphore/Condition acquire parks in an inner
                    # Condition.wait — that is contention, not idle
                    if caller.f_code.co_name in _LOCK_WAIT_FUNCS:
                        return "lock-wait"
                    caller = caller.f_back
                return "idle"
        for p in _IDLE_FILES:
            if p in fn:
                return "idle"
        for p in _WIRE_FILES:
            if p in fn:
                return "wire"
        f = f.f_back
        depth += 1
    return "host"


def _fold(frame) -> Tuple[str, ...]:
    """Outermost-first `module:func` labels for one sampled stack
    (flamegraph convention: root first, leaf last)."""
    out: List[str] = []
    f = frame
    while f is not None and len(out) < _STACK_DEPTH:
        code = f.f_code
        fn = code.co_filename
        # shorten to the last two path components: enough to identify
        # the module without leaking absolute build paths into bundles
        parts = fn.replace("\\", "/").rsplit("/", 2)
        short = "/".join(parts[-2:]) if len(parts) > 1 else fn
        out.append(f"{short}:{code.co_name}")
        f = f.f_back
    out.reverse()
    return tuple(out)


# ------------------------------------------------------- compile ledger

class CompileLedger:
    """Per-shape-bucket compile-cache accounting (the device ledger's
    compile half).  A SITE is one compile cache keyed by shape bucket —
    `engine.multi/1024x50000`, `bridge/...` — and per site the ledger
    splits first-launch seconds (trace+lower+compile+run) from steady
    calls, the split PERF.md §13 measured by hand."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._sites: Dict[str, Dict[str, float]] = {}

    def _site(self, site: str) -> Dict[str, float]:
        s = self._sites.get(site)
        if s is None:
            s = self._sites[site] = {"hits": 0, "misses": 0,
                                     "first_launch_s": 0.0,
                                     "steady_calls": 0,
                                     "steady_s": 0.0}
        return s

    def note_hit(self, site: str) -> None:
        with self._lock:
            self._site(site)["hits"] += 1

    def note_miss(self, site: str, compile_s: float = 0.0) -> None:
        with self._lock:
            s = self._site(site)
            s["misses"] += 1
            s["first_launch_s"] += compile_s

    def note_steady(self, site: str, seconds: float) -> None:
        with self._lock:
            s = self._site(site)
            s["steady_calls"] += 1
            s["steady_s"] += seconds

    def wrap(self, site: str, fn) -> "_TimedFn":
        """Wrap a freshly-built compiled callable: its FIRST call is
        timed into the site's first-launch seconds (jit compiles at
        first invocation), later calls count as steady."""
        return _TimedFn(self, site, fn)

    def snapshot(self) -> Dict[str, Dict]:
        with self._lock:
            sites = {k: dict(v) for k, v in self._sites.items()}
        hits = sum(s["hits"] for s in sites.values())
        misses = sum(s["misses"] for s in sites.values())
        total = hits + misses
        return {
            "sites": sites,
            "hits": hits,
            "misses": misses,
            "hit_rate": (hits / total) if total else 0.0,
            "first_launch_s": round(sum(s["first_launch_s"]
                                        for s in sites.values()), 6),
            "steady_s": round(sum(s["steady_s"]
                                  for s in sites.values()), 6),
        }

    def reset(self) -> None:
        with self._lock:
            self._sites.clear()


class _TimedFn:
    """First-call-timed wrapper for a compiled callable (CompileLedger
    hands these out).  The steady path costs one attribute read and a
    branch — invisible next to a device launch."""

    __slots__ = ("_ledger", "_site", "_fn", "_first")

    def __init__(self, ledger: CompileLedger, site: str, fn) -> None:
        self._ledger = ledger
        self._site = site
        self._fn = fn
        self._first = True

    def __call__(self, *args, **kwargs):
        if self._first:
            self._first = False
            t0 = time.perf_counter()
            out = self._fn(*args, **kwargs)
            self._ledger.note_miss(self._site,
                                   time.perf_counter() - t0)
            return out
        return self._fn(*args, **kwargs)


COMPILE = CompileLedger()


# ------------------------------------------------------------- sampler

class SamplingProfiler:
    """Always-on host sampling profiler.  One daemon thread; all state
    private (nothing written to REGISTRY / TRACER / FLIGHT while
    sampling — see the module docstring's clock-discipline contract)."""

    def __init__(self, hz: float = DEFAULT_HZ) -> None:
        self.hz = float(hz)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # (role, stack tuple) -> count; bounded per role
        self._folds: Dict[Tuple[str, Tuple[str, ...]], int] = {}
        self._fold_sizes: Dict[str, int] = {}
        self._overflow: Dict[str, int] = {}
        # bucket accounting: plain per-(role, bucket) sample weights
        # (floats: gil-wait splits a runnable sample across buckets)
        self._buckets: Dict[Tuple[str, str], float] = {}
        self._samples = 0            # sampler ticks
        self._thread_samples = 0     # thread-samples (ticks x threads)
        self._self_s = 0.0           # time spent inside _sample_once
        self._started_at = 0.0       # perf_counter at start()
        self._elapsed_base = 0.0     # accumulated across stop/start
        # capture surface
        self._captures: List[Dict] = []
        self._capture_seq = 0
        # providers installed by the Server (device ledger, flight
        # rings); plain callables so this module imports nothing above
        self.device_ledger_provider: Optional[Callable[[], Dict]] = None
        self.flight_provider: Optional[Callable[[], Dict]] = None
        # remote samplers: pool worker processes run their OWN
        # SamplingProfiler and ship snapshot docs up; the parent merges
        # the latest doc per key into its snapshot/capture surfaces
        self._remote: Dict[str, Dict] = {}

    # ------------------------------------------------------- lifecycle

    def start(self, hz: Optional[float] = None) -> bool:
        """Start (or re-tune) the sampler; idempotent.  hz <= 0 leaves
        it stopped (the agent_config off switch)."""
        with self._lock:
            if hz is not None:
                self.hz = float(hz)
            if self.hz <= 0:
                return False
            if self._thread is not None and self._thread.is_alive():
                return True
            self._stop = threading.Event()
            self._started_at = time.perf_counter()
            self._thread = threading.Thread(
                target=self._run, name="prof-sampler", daemon=True)
            self._thread.start()
            return True

    def stop(self) -> None:
        with self._lock:
            t = self._thread
            self._thread = None
            if t is not None and self._started_at:
                self._elapsed_base += (time.perf_counter()
                                       - self._started_at)
                self._started_at = 0.0
        self._stop.set()
        if t is not None:
            t.join(timeout=2.0)

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def reset(self) -> None:
        with self._lock:
            self._folds.clear()
            self._fold_sizes.clear()
            self._overflow.clear()
            self._buckets.clear()
            self._samples = 0
            self._thread_samples = 0
            self._self_s = 0.0
            self._elapsed_base = 0.0
            if self._started_at:
                self._started_at = time.perf_counter()

    # ----------------------------------------------------- sample loop

    def _run(self) -> None:
        # top-level handler: a dead sampler must never take the process
        # down, and must not die silently either — it parks a reason
        try:
            interval = 1.0 / max(self.hz, 0.1)
            while not self._stop.wait(interval):
                t0 = time.perf_counter()
                try:
                    self._sample_once()
                except Exception:
                    # a single torn sample (thread exited mid-walk) is
                    # noise; losing the sampler over it is not
                    pass
                with self._lock:
                    self._self_s += time.perf_counter() - t0
                interval = 1.0 / max(self.hz, 0.1)
        except Exception:
            pass

    def _sample_once(self) -> None:
        me = threading.get_ident()
        names: Dict[int, str] = {}
        markers: Dict[int, Optional[str]] = {}
        for t in threading.enumerate():
            ident = t.ident
            if ident is None or ident == me:
                continue
            names[ident] = t.name
        frames = sys._current_frames()
        marks = dict(_MARKS)
        classified: List[Tuple[str, str, Tuple[str, ...]]] = []
        runnable: List[int] = []
        for ident, frame in frames.items():
            if ident == me:
                continue
            name = names.get(ident)
            if name is None or name == "prof-sampler":
                continue
            role = role_of(name)
            marker = marks.get(ident)
            bucket = marker if marker in BUCKETS else classify_stack(frame)
            classified.append((role, bucket, _fold(frame)))
            if bucket in ("host", "wire"):
                runnable.append(len(classified) - 1)
        n_run = len(runnable)
        with self._lock:
            self._samples += 1
            for i, (role, bucket, stack) in enumerate(classified):
                self._thread_samples += 1
                if n_run > 1 and bucket in ("host", "wire"):
                    # threads-runnable vs threads-on-cpu: N threads are
                    # executing-Python this tick but one GIL exists, so
                    # each carries (N-1)/N of a sample as gil-wait
                    share = 1.0 / n_run
                    self._bump(role, bucket, share)
                    self._bump(role, "gil-wait", 1.0 - share)
                else:
                    self._bump(role, bucket, 1.0)
                key = (role, stack)
                cur = self._folds.get(key)
                if cur is not None:
                    self._folds[key] = cur + 1
                elif self._fold_sizes.get(role, 0) < _FOLD_CAP:
                    self._folds[key] = 1
                    self._fold_sizes[role] = \
                        self._fold_sizes.get(role, 0) + 1
                else:
                    self._overflow[role] = \
                        self._overflow.get(role, 0) + 1

    def _bump(self, role: str, bucket: str, w: float) -> None:
        key = (role, bucket)
        self._buckets[key] = self._buckets.get(key, 0.0) + w

    # -------------------------------------------------------- exports

    def gil_fraction(self, role: str = "worker") -> float:
        """Cheap point read of one role's gil-wait share — the timeline
        samples this every tick, so it must not pay snapshot()'s full
        fold/matrix build."""
        with self._lock:
            items = [(b, w) for (r, b), w in self._buckets.items()
                     if r == role]
        total = sum(w for _, w in items)
        if not total:
            return 0.0
        return dict(items).get("gil-wait", 0.0) / total

    def _elapsed(self) -> float:
        e = self._elapsed_base
        if self._started_at:
            e += time.perf_counter() - self._started_at
        return e

    def snapshot(self) -> Dict:
        """Bucket breakdown, per-role matrix, GIL fractions, sampler
        self-overhead — everything but the folded stacks."""
        with self._lock:
            buckets = dict(self._buckets)
            samples = self._samples
            thread_samples = self._thread_samples
            self_s = self._self_s
            elapsed = self._elapsed()
            overflow = dict(self._overflow)
            remote = {k: dict(v) for k, v in self._remote.items()}
        totals: Dict[str, float] = {b: 0.0 for b in BUCKETS}
        roles: Dict[str, Dict[str, float]] = {}
        for (role, bucket), w in buckets.items():
            totals[bucket] = totals.get(bucket, 0.0) + w
            roles.setdefault(role, {})[bucket] = round(w, 3)
        named = sum(v for b, v in totals.items() if b in BUCKETS)
        return {
            "hz": self.hz,
            "running": self.running,
            "samples": samples,
            "thread_samples": thread_samples,
            "elapsed_s": round(elapsed, 3),
            "buckets": {b: round(v, 3) for b, v in totals.items()},
            "roles": roles,
            # share of sampled thread wall time landing in a NAMED
            # bucket (acceptance floor: >= 0.90) — any unrecognized
            # classification would fall outside `named`
            "attributed_fraction":
                min(named / thread_samples, 1.0)
                if thread_samples else 1.0,
            "gil_wait_fraction": self._gil_fraction(roles, "worker"),
            "gil_wait_fraction_by_role": {
                r: self._gil_fraction(roles, r) for r in roles},
            "overhead_fraction":
                (self_s / elapsed) if elapsed > 0 else 0.0,
            "sampler_self_s": round(self_s, 6),
            "fold_overflow": overflow,
            # latest per-process sampler doc shipped via publish_remote
            # (empty in the default single-process deployment)
            "remote": remote,
        }

    def publish_remote(self, key: str, doc: Dict) -> None:
        """Merge a pool worker process's sampler snapshot under `key`
        (core/workerpool's attendant calls this on every `prof` report;
        newest doc wins)."""
        if not isinstance(doc, dict):
            return
        with self._lock:
            self._remote[key] = doc

    def drop_remote(self, key: str) -> None:
        with self._lock:
            self._remote.pop(key, None)

    @staticmethod
    def _gil_fraction(roles: Dict[str, Dict[str, float]],
                      role: str) -> float:
        r = roles.get(role)
        if not r:
            return 0.0
        total = sum(r.values())
        return (r.get("gil-wait", 0.0) / total) if total else 0.0

    def folded(self, role: Optional[str] = None) -> str:
        """flamegraph.pl / speedscope "folded" lines:
        `role;frame;frame;... count`."""
        with self._lock:
            items = sorted(self._folds.items(),
                           key=lambda kv: (-kv[1], kv[0]))
            overflow = dict(self._overflow)
        lines = []
        for (r, stack), count in items:
            if role is not None and r != role:
                continue
            lines.append(f"{r};" + ";".join(stack) + f" {count}")
        for r, count in sorted(overflow.items()):
            if role is None or r == role:
                lines.append(f"{r};<fold-table-overflow> {count}")
        return "\n".join(lines)

    def mem_stats(self) -> Dict:
        """Ledger sizer (core/memledger): fold-table + capture
        occupancy.  Folds are (role, stack-tuple) keys — flat per-key
        estimate scaled by a sampled key length; fold-table overflow
        counts as the eviction stream."""
        with self._lock:
            folds = len(self._folds)
            frames = sum(len(k[1]) for k in
                         itertools.islice(self._folds, 8))
            sampled = min(folds, 8)
            captures = len(self._captures)
            overflow = sum(self._overflow.values())
            buckets = len(self._buckets)
            remote = len(self._remote)
        per_fold = 96 + (frames / sampled if sampled else 0) * 80
        return {"bytes": int(folds * per_fold + captures * 16384
                             + buckets * 96 + remote * 2048),
                "entries": folds + captures,
                "cap": 0, "evictions": overflow,
                "folds": folds, "captures": captures}

    def brief(self) -> Dict:
        """Compact summary for /v1/operator/debug and HealthBreach
        dumps: buckets + GIL fraction + a pointer at the full surface."""
        snap = self.snapshot()
        return {
            "running": snap["running"],
            "hz": snap["hz"],
            "samples": snap["samples"],
            "buckets": snap["buckets"],
            "gil_wait_fraction": snap["gil_wait_fraction"],
            "overhead_fraction": round(snap["overhead_fraction"], 5),
            "captures": [c["id"] for c in self.captures()],
            "capture_endpoint": "/v1/operator/profile",
        }

    # -------------------------------------------------------- capture

    def capture(self, duration_s: float = 2.0,
                include_trace: bool = False,
                trace_dir: Optional[str] = None) -> Dict:
        """Timed on-demand capture: sample for `duration_s` of REAL
        time, then bundle the window's folded stacks + bucket deltas
        with the device ledger, compile ledger, and flight-recorder
        rings into a retained schema-stamped bundle."""
        duration_s = min(max(float(duration_s), 0.05), 60.0)
        was_running = self.running
        if not was_running:
            self.start(hz=self.hz if self.hz > 0 else DEFAULT_HZ)
        base = self.snapshot()
        with self._lock:
            base_folds = dict(self._folds)
        trace_info = None
        if include_trace:
            trace_info = self._start_trace(trace_dir)
        # cross-link seam for `nomad report`: the capture's [start, end]
        # on the TIMELINE's (injected) clock, whatever wall span the
        # capture itself measures
        from nomad_tpu_torch.core.timeline import TIMELINE
        tl_start = TIMELINE.clock.monotonic()
        # real-time wait on a never-set Event: the capture window is
        # wall time by contract, whatever clock the cluster runs on
        threading.Event().wait(duration_s)
        if trace_info is not None and trace_info.get("ok"):
            self._stop_trace(trace_info)
        snap = self.snapshot()
        with self._lock:
            folds = dict(self._folds)
            self._capture_seq += 1
            seq = self._capture_seq
        window_folds = []
        for key, count in folds.items():
            d = count - base_folds.get(key, 0)
            if d > 0:
                role, stack = key
                window_folds.append(f"{role};" + ";".join(stack)
                                    + f" {d}")
        window_folds.sort()
        buckets = {b: round(snap["buckets"].get(b, 0.0)
                            - base["buckets"].get(b, 0.0), 3)
                   for b in BUCKETS}
        named = sum(max(v, 0.0) for v in buckets.values())
        window_ts = snap["thread_samples"] - base["thread_samples"]
        device_ledger = None
        if self.device_ledger_provider is not None:
            try:
                device_ledger = self.device_ledger_provider()
            except Exception as e:  # provider's server may be closing
                device_ledger = {"error": str(e)}
        flight = None
        if self.flight_provider is not None:
            try:
                flight = self.flight_provider()
            except Exception as e:
                flight = {"error": str(e)}
        bundle = {
            "schema": SCHEMA,
            "id": f"prof-{seq:04d}",
            # capture timestamps are wall-clock domain by design (see
            # the module docstring's clock-discipline contract)
            "captured_unix": time.time(),  # analyze: ok rawtime
            "duration_s": duration_s,
            # [start, end] on the timeline clock (core/timeline.py):
            # `nomad report` cross-links captures into its incident view
            "timeline_window": [round(tl_start, 9),
                                round(TIMELINE.clock.monotonic(), 9)],
            "hz": snap["hz"],
            "sampler_was_running": was_running,
            "samples": snap["samples"] - base["samples"],
            "thread_samples":
                snap["thread_samples"] - base["thread_samples"],
            "buckets": buckets,
            "attributed_fraction":
                min(named / window_ts, 1.0) if window_ts else 1.0,
            "gil_wait_fraction": snap["gil_wait_fraction"],
            "gil_wait_fraction_by_role":
                snap["gil_wait_fraction_by_role"],
            "roles": snap["roles"],
            "overhead_fraction": round(snap["overhead_fraction"], 5),
            "folded": window_folds,
            "folded_cumulative_lines":
                len(self.folded().splitlines()),
            "device_ledger": device_ledger,
            "compile_ledger": COMPILE.snapshot(),
            "flight_recorder": flight,
            "torch_trace": trace_info,
            # per-process sampler docs from the multi-process worker
            # plane (latest snapshot per pool worker at capture time)
            "remote_samplers": snap.get("remote", {}),
        }
        with self._lock:
            self._captures.append(bundle)
            del self._captures[:-_CAPTURE_CAP]
        if not was_running:
            self.stop()
        return bundle

    def captures(self) -> List[Dict]:
        with self._lock:
            return list(self._captures)

    def get_capture(self, capture_id: str) -> Optional[Dict]:
        with self._lock:
            for c in self._captures:
                if c["id"] == capture_id:
                    return c
        return None

    # ---------------------------------------------- torch.profiler glue

    @staticmethod
    def _start_trace(trace_dir: Optional[str]) -> Dict:
        try:
            import tempfile

            import torch
            d = trace_dir or tempfile.mkdtemp(prefix="nomad-torch-trace-")
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
            _TRACES[d] = prof
            return {"ok": True, "dir": d,
                    "activities": [a.name for a in acts]}
        except Exception as e:  # torch profiler unavailable
            return {"ok": False, "error": str(e)}

    @staticmethod
    def _stop_trace(info: Dict) -> None:
        try:
            import os
            prof = _TRACES.pop(info["dir"])
            prof.stop()
            path = os.path.join(info["dir"], "trace.json")
            prof.export_chrome_trace(path)
            info["trace"] = path
        except Exception as e:
            info["ok"] = False
            info["error"] = str(e)


# running torch.profiler windows by capture directory (the bundle's
# trace info stays JSON-safe)
_TRACES: Dict[str, object] = {}


def role_window(base: Dict, cur: Dict) -> Dict[str, Dict[str, float]]:
    """Per-role bucket-weight deltas between two `snapshot()` docs —
    the windowed view bench.py uses to attribute a measured section
    (e.g. the sustained waves) without resetting the sampler."""
    out: Dict[str, Dict[str, float]] = {}
    for role, rb in cur.get("roles", {}).items():
        base_rb = base.get("roles", {}).get(role, {})
        d = {b: round(w - base_rb.get(b, 0.0), 3)
             for b, w in rb.items()}
        d = {b: w for b, w in d.items() if w > 0}
        if d:
            out[role] = d
    return out


PROFILER = SamplingProfiler()


def configure(hz: Optional[float] = None,
              enabled: Optional[bool] = None) -> SamplingProfiler:
    """Process-global profiler tuning (every Server calls this at
    construction, like telemetry/flightrec `configure`).  hz=0 or
    enabled=False stops the sampler; any positive hz (re)starts it."""
    if hz is not None:
        PROFILER.hz = float(hz)
    if enabled is False or (hz is not None and hz <= 0):
        PROFILER.stop()
    else:
        PROFILER.start()
    return PROFILER


# The profiler is wall-clock-only by doctrine (sampling a virtual clock
# would alias the sampler against compressed time), so its bus hook
# registers configure=None: the bus-wide clock rebind skips it, while
# snapshot capture still includes it.
from nomad_tpu_torch.core.obsbus import OBSBUS  # noqa: E402 - after globals

OBSBUS.register("profiler", snapshot=PROFILER.brief)
