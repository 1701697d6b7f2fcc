"""Memory & footprint observability plane: the process memory ledger.

Every bounded plane in the system (state store tables, the export
journal, the flight/timeline/trace/log rings, the EventRing, the
WatchHub shape table, the worker-pool replica journals) registers a
cheap `sizer()` callback with the process-global MEMLEDGER.  A scrape
calls every sizer, reads process RSS from `/proc/self/status`
(VmRSS/VmHWM — psutil-free), and publishes `nomad.mem.*` gauges, so
the first thing that kills a long-lived scheduler — footprint — is a
first-class observable instead of an autopsy finding.

Contract for sizers: return a small dict of ints, conventionally
  {"bytes": .., "entries": .., "cap": .., "evictions": ..}
plus any plane-specific extras; an optional "gauges" sub-dict maps
absolute metric names to values the scrape publishes verbatim (the
export journal uses it for `nomad.journal.{compactions,
bytes_reclaimed,floor_fallbacks}`).  Sizers must be O(1)-ish counter
reads — anything that needs to walk a table amortizes the walk with
sampling (see `approx_sizeof` + StateStore.mem_stats) so the whole
scrape stays within the PERF.md §21 budget.

Timebase: the scrape CADENCE rides the injected Clock seam
(configure-from-Server, like REGISTRY/FLIGHT), so VirtualClock soaks
sample at deterministic virtual instants and replay byte-identical.
The VALUES are wall facts (RSS, byte estimates) and are therefore
volatile by doctrine: they feed gauges and the operator doc, never the
timeline's canonical dump or the soak's canonical trace.  Scrape
self-metering uses time.perf_counter — host-side cost measurement, the
sanctioned raw primitive.
"""

from __future__ import annotations

import itertools
import sys
import threading
import time
from collections import deque
from typing import Callable, Dict, Optional

from nomad_tpu_torch.core import telemetry

SCHEMA = "nomad-tpu.memory.v1"

# ---------------------------------------------------------------------------
# byte estimation
# ---------------------------------------------------------------------------


def approx_sizeof(obj, depth: int = 3, sample: int = 8,
                  _seen: Optional[set] = None) -> int:
    """Sampled, interned-aware deep-ish sys.getsizeof.  Containers
    measure up to `sample` elements and extrapolate to their length;
    the shared `_seen` id-set means interned/shared objects (string
    keys, job pointers embedded in many allocs) are charged once per
    estimate, not once per reference.  Bounded depth keeps one call
    O(sample^depth) regardless of object graph size — this is an
    estimator for the ledger, not an allocator audit."""
    if _seen is None:
        _seen = set()
    oid = id(obj)
    if oid in _seen:
        return 0
    _seen.add(oid)
    n = sys.getsizeof(obj, 64)
    if depth <= 0:
        return n
    if isinstance(obj, dict):
        if obj:
            items = list(itertools.islice(obj.items(), sample))
            per = sum(approx_sizeof(k, depth - 1, sample, _seen)
                      + approx_sizeof(v, depth - 1, sample, _seen)
                      for k, v in items) / len(items)
            n += int(per * len(obj))
    elif isinstance(obj, (list, tuple, set, frozenset, deque)):
        size = len(obj)
        if size:
            items = list(itertools.islice(obj, sample))
            per = sum(approx_sizeof(v, depth - 1, sample, _seen)
                      for v in items) / len(items)
            n += int(per * size)
    elif hasattr(obj, "__dict__"):
        n += approx_sizeof(obj.__dict__, depth - 1, sample, _seen)
    elif hasattr(obj, "__slots__"):
        for slot in obj.__slots__:
            v = getattr(obj, slot, None)
            if v is not None:
                n += approx_sizeof(v, depth - 1, sample, _seen)
    return n


def read_rss() -> Dict[str, int]:
    """Process RSS + high-water mark in bytes from /proc/self/status
    (VmRSS/VmHWM are kB lines).  Zero on platforms without procfs —
    the ledger still tracks per-plane bytes there."""
    rss = peak = 0
    try:
        with open("/proc/self/status", "rb") as f:
            for line in f:
                if line.startswith(b"VmRSS:"):
                    rss = int(line.split()[1]) * 1024
                    break              # VmHWM precedes VmRSS
                if line.startswith(b"VmHWM:"):
                    peak = int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    return {"rss_bytes": rss, "rss_peak_bytes": peak}


# ---------------------------------------------------------------------------
# the ledger
# ---------------------------------------------------------------------------


class MemLedger:
    """Process-wide registry of plane sizers + the RSS sampler.
    `sample(now)` is the Server.tick hook (throttled on the injected
    clock); `scrape()` is the on-demand path the HTTP endpoint and CLI
    hit.  Thread-safe; sizers run OUTSIDE the ledger lock (they take
    their own plane locks) and a sizer that raises is reported as an
    errored plane, never a failed scrape."""

    def __init__(self, clock=None, interval_s: float = 5.0,
                 min_wall_s: float = 0.5) -> None:
        self._lock = threading.Lock()
        self._clock = clock
        self.interval_s = interval_s
        # wall-side cost guard: a VirtualClock soak compresses hundreds
        # of virtual seconds into one wall second, which would turn the
        # injected-clock cadence into dozens of scrapes per wall second.
        # Values are volatile wall facts anyway, so skipping scrapes on
        # a wall throttle loses nothing canonical — it just keeps the
        # ledger inside its 0.1%-of-soak-wall budget (PERF.md §21)
        self.min_wall_s = min_wall_s
        self._last_wall = 0.0
        self._sizers: Dict[str, Callable[[], Dict]] = {}
        self._last: Dict[str, Dict] = {}      # plane -> last sizer doc
        self._last_rss: Dict[str, int] = {"rss_bytes": 0,
                                          "rss_peak_bytes": 0}
        self._last_at: Optional[float] = None  # injected-clock stamp
        self._last_scrape_us = 0.0
        self._scrape_total_s = 0.0
        self._scrapes = 0

    # ---------------------------------------------------------- control

    def configure(self, clock) -> None:
        with self._lock:
            self._clock = clock
            self._last_at = None   # new clock, new epoch: re-anchor

    def register(self, plane: str, sizer: Callable[[], Dict]) -> None:
        """Last-write-wins by plane name: each new Server re-binds its
        planes the way telemetry.configure re-binds the clock."""
        with self._lock:
            self._sizers[plane] = sizer

    def unregister(self, plane: str) -> None:
        with self._lock:
            self._sizers.pop(plane, None)
            self._last.pop(plane, None)

    def planes(self) -> list:
        with self._lock:
            return sorted(self._sizers)

    # ----------------------------------------------------------- scrape

    def sample(self, now: float) -> bool:
        """Tick-cadence sampling, throttled to `interval_s` of the
        injected clock; returns True when a scrape ran.  Cheap when
        throttled: one lock + one float compare."""
        with self._lock:
            if (self._last_at is not None
                    and 0 <= now - self._last_at < self.interval_s):
                return False   # negative delta = rebound timebase: due
            w = time.perf_counter()
            if w - self._last_wall < self.min_wall_s:
                return False
            self._last_at = now
            self._last_wall = w
        self.scrape()
        return True

    def scrape(self) -> Dict:
        """Run every sizer + the RSS read, publish gauges, return the
        operator document.  Self-metered (perf_counter): the cost rides
        `nomad.mem.scrape_us` and the soak's overhead gate."""
        t0 = time.perf_counter()
        with self._lock:
            sizers = sorted(self._sizers.items())
        planes: Dict[str, Dict] = {}
        extra_gauges: Dict[str, float] = {}
        for name, sizer in sizers:
            try:
                doc = dict(sizer() or {})
            except Exception as exc:  # noqa: BLE001 - plane isolation
                doc = {"bytes": 0, "error": repr(exc)}
            g = doc.pop("gauges", None)
            if g:
                extra_gauges.update(g)
            planes[name] = doc
        rss = read_rss()
        tracked = sum(int(d.get("bytes", 0)) for d in planes.values())
        reg = telemetry.REGISTRY
        reg.set_gauge("nomad.mem.rss_bytes", rss["rss_bytes"])
        reg.set_gauge("nomad.mem.rss_peak_bytes", rss["rss_peak_bytes"])
        reg.set_gauge("nomad.mem.tracked_bytes", tracked)
        for name, doc in planes.items():
            reg.set_gauge("nomad.mem.plane_bytes",
                          int(doc.get("bytes", 0)), plane=name)
        for gname, val in extra_gauges.items():
            reg.set_gauge(gname, val)
        dt = time.perf_counter() - t0
        with self._lock:
            self._last = planes
            self._last_rss = rss
            self._last_scrape_us = dt * 1e6
            self._scrape_total_s += dt
            self._scrapes += 1
        reg.set_gauge("nomad.mem.scrape_us", round(dt * 1e6, 2))
        return self.doc()

    # -------------------------------------------------------- documents

    def doc(self) -> Dict:
        """The operator document (`GET /v1/operator/memory`, the debug
        bundle's Memory section, HealthBreach dumps): last scrape's
        per-plane table + RSS + the ledger's own cost accounting."""
        with self._lock:
            planes = {k: dict(v) for k, v in self._last.items()}
            rss = dict(self._last_rss)
            out = {
                "Schema": SCHEMA,
                "RSSBytes": rss["rss_bytes"],
                "RSSPeakBytes": rss["rss_peak_bytes"],
                "TrackedBytes": sum(int(d.get("bytes", 0))
                                    for d in planes.values()),
                "Planes": planes,
                "Scrapes": self._scrapes,
                "ScrapeMicros": round(self._last_scrape_us, 2),
                "ScrapeMeanMicros": round(
                    self._scrape_total_s * 1e6 / self._scrapes, 2)
                    if self._scrapes else 0.0,
                "ScrapeTotalSeconds": round(self._scrape_total_s, 6),
            }
        return out

    def evictions(self) -> Dict[str, int]:
        """Unified drop/eviction counters, one entry per plane (the
        debug bundle's `Evictions` key)."""
        with self._lock:
            return {name: int(doc.get("evictions", 0))
                    for name, doc in sorted(self._last.items())}

    def stats(self) -> Dict:
        with self._lock:
            return {"scrapes": self._scrapes,
                    "scrape_total_s": self._scrape_total_s,
                    "last_scrape_us": self._last_scrape_us,
                    "rss_bytes": self._last_rss["rss_bytes"],
                    "rss_peak_bytes": self._last_rss["rss_peak_bytes"]}

    def rss_mb(self) -> float:
        """Last sampled RSS in MiB (the HealthWatchdog `rss_mb` rule
        reads this; 0.0 before the first scrape means the rule cannot
        false-positive during boot)."""
        with self._lock:
            return self._last_rss["rss_bytes"] / (1024.0 * 1024.0)


# process singleton, configure-from-Server like REGISTRY/FLIGHT
MEMLEDGER = MemLedger()


def configure(clock) -> None:
    MEMLEDGER.configure(clock)


from nomad_tpu_torch.core.obsbus import OBSBUS  # noqa: E402 - after globals

OBSBUS.register("memledger", configure=MEMLEDGER.configure,
                snapshot=MEMLEDGER.doc)
