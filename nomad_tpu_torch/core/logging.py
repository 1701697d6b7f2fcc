"""Structured in-process logging with a bounded ring + live subscribers
(reference: hclog + the `nomad monitor` RPC in command/agent/monitor.go).

`log(component, level, msg, **fields)` appends to a process-wide ring that
`/v1/agent/monitor` streams and `operator debug` bundles.  Deliberately
tiny: no handlers/formatters, one producer API, lock-protected ring.

Loss is COUNTED, never silent (core/telemetry.py registry series
`nomad.logring.dropped{reason=trim|subscriber}`): the wrap-trim discards
the oldest quarter of the ring, and a full subscriber queue sheds the
record for that subscriber only.  `min_level` is the producer-side gate,
set from agent_config's `log_level` (records below it never touch the
lock — the ack log sits on the eval hot path).

`trace_scope(trace_id)` stamps the active eval's trace id onto every
record logged inside it (thread-local): a health dump bundle's log tail
joins its traces without the callers threading ids into every log call
— the worker's schedule path and the plan applier run inside one."""

from __future__ import annotations

import queue
import threading
from contextlib import contextmanager
from typing import Dict, List, Optional

from nomad_tpu_torch.chaos.clock import Clock, SystemClock
from nomad_tpu_torch.core.telemetry import REGISTRY

LEVELS = {"trace": 0, "debug": 1, "info": 2, "warn": 3, "error": 4}

# active trace context, per thread (worker schedule / applier apply)
_TLS = threading.local()


def current_trace() -> str:
    return getattr(_TLS, "trace_id", "")


@contextmanager
def trace_scope(trace_id: str):
    """Records logged inside this scope carry `trace_id` (unless the
    call passes its own).  Nests; empty ids are a no-op scope."""
    prev = getattr(_TLS, "trace_id", "")
    _TLS.trace_id = trace_id or prev
    try:
        yield
    finally:
        _TLS.trace_id = prev


class LogRing:
    def __init__(self, size: int = 2048) -> None:
        self._lock = threading.Lock()
        self._buf: List[Dict] = []
        self._size = size
        self._subs: List["queue.Queue[Optional[Dict]]"] = []
        # producer-side gate: records below this level are dropped before
        # touching the lock (the ack log sits on the eval hot path)
        self.min_level = "trace"
        # injected timebase for record stamps (chaos/clock.py): dump
        # bundles must carry log ts on the same timeline as the traces
        # and SLO windows they are joined with
        self.clock: Clock = SystemClock()

    def log(self, component: str, level: str, msg: str, **fields) -> None:
        if LEVELS.get(level, 2) < LEVELS.get(self.min_level, 0):
            return
        rec = {"ts": self.clock.time(), "level": level,
               "component": component, "msg": msg}
        if fields:
            rec.update(fields)
        if "trace_id" not in rec:
            tid = current_trace()
            if tid:
                rec["trace_id"] = tid
        trimmed = 0
        with self._lock:
            self._buf.append(rec)
            if len(self._buf) > self._size:
                trimmed = self._size // 4
                del self._buf[:trimmed]
            subs = list(self._subs)
        if trimmed:
            REGISTRY.inc("nomad.logring.dropped", trimmed, reason="trim")
        for q in subs:
            try:
                q.put_nowait(rec)
            except queue.Full:
                REGISTRY.inc("nomad.logring.dropped", reason="subscriber")

    def tail(self, n: int = 200,
             min_level: str = "trace") -> List[Dict]:
        lvl = LEVELS.get(min_level, 0)
        with self._lock:
            recs = list(self._buf)
        return [r for r in recs
                if LEVELS.get(r["level"], 2) >= lvl][-n:]

    def subscribe(self, maxsize: int = 512) -> "queue.Queue":
        q: "queue.Queue[Optional[Dict]]" = queue.Queue(maxsize)
        with self._lock:
            self._subs.append(q)
        return q

    def unsubscribe(self, q) -> None:
        with self._lock:
            if q in self._subs:
                self._subs.remove(q)

    def mem_stats(self) -> Dict:
        """Ledger sizer (core/memledger): buffer occupancy with the
        newest record as the per-record byte estimate; evictions read
        the registry's trim counter (the ring itself keeps none)."""
        from nomad_tpu_torch.core.memledger import approx_sizeof
        with self._lock:
            entries = len(self._buf)
            newest = self._buf[-1] if self._buf else None
            subs = len(self._subs)
        per = approx_sizeof(newest, depth=2) if newest is not None else 0
        dropped = int(REGISTRY.counter_sum("nomad.logring.dropped"))
        return {"bytes": per * entries + subs * 256, "entries": entries,
                "cap": self._size, "evictions": dropped,
                "subscribers": subs}


# process-wide default ring (one agent per process in practice)
RING = LogRing()


def configure(clock: Clock) -> None:
    """Bind the process log ring to an injected clock (every Server
    calls this with its own, next to telemetry.configure)."""
    RING.clock = clock


from nomad_tpu_torch.core.obsbus import OBSBUS  # noqa: E402 - after globals

OBSBUS.register("logging", configure=configure,
                snapshot=lambda: {"tail": RING.tail(200)})


def log(component: str, level: str, msg: str, **fields) -> None:
    RING.log(component, level, msg, **fields)
