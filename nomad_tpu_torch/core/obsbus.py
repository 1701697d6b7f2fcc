"""ObsBus: the one registration seam for every observability plane.

Before this module, rebinding the injected chaos `Clock` meant eight
ad-hoc `configure(clock)` calls scattered through `Server.__init__` and
the soak runner's `_rebind_clock` (telemetry's registry, the tracer,
the flight recorder, the log ring, the identity signer, the timeline,
the memory ledger, the sampling profiler) — and every new plane meant
remembering to add a ninth call in two places.  The bus inverts that:
each plane module registers `(name, configure, snapshot, reset)` hooks
at import time, and `Server`/soak/chaos say `OBSBUS.configure(clock)`
once.  The `analyze.py` `obsbus` pass enforces the contract — a core
module that defines a module-level `configure()` without registering
on the bus is a finding.

Hook contract:

  - ``configure(clock)`` — rebind the plane's timebase.  Planes whose
    cadence is wall-clock by doctrine (the profiler) register ``None``
    and are skipped.
  - ``snapshot()``      — a JSON-safe debug document (the bus-level
    `snapshot()` feeds debug bundles and health dumps).
  - ``reset()``         — drop accumulated state (test isolation; no
    production path calls it).

All hooks are optional; registration is last-write-wins by name, like
`MemLedger.register`.  Hooks run OUTSIDE the bus lock (they take their
own plane locks) and a hook that raises is isolated per plane — one
broken plane never blocks the clock rebind or the debug capture of the
other seven.

This module imports nothing from the plane modules (planes import the
bus, never the reverse), so registration can never cycle.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

from nomad_tpu_torch.chaos.clock import Clock


class PlaneHooks:
    """One plane's registered hooks.  Plain attribute bag — the bus
    owns the locking."""

    __slots__ = ("name", "configure", "snapshot", "reset")

    def __init__(self, name: str,
                 configure: Optional[Callable[[Clock], None]] = None,
                 snapshot: Optional[Callable[[], Dict]] = None,
                 reset: Optional[Callable[[], None]] = None) -> None:
        self.name = name
        self.configure = configure
        self.snapshot = snapshot
        self.reset = reset


class ObsBus:
    """Process-wide plane registry.  Thread-safe; iteration order is
    sorted by plane name so configure/snapshot sequences are
    deterministic run-to-run (the federation determinism tests pin
    byte-identical snapshots)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._planes: Dict[str, PlaneHooks] = {}
        self._errors = 0

    # ---------------------------------------------------------- control

    def register(self, name: str,
                 configure: Optional[Callable[[Clock], None]] = None,
                 snapshot: Optional[Callable[[], Dict]] = None,
                 reset: Optional[Callable[[], None]] = None) -> None:
        """Register (or re-register) a plane.  Last-write-wins by name:
        re-imports and test doubles re-bind the same slot."""
        hooks = PlaneHooks(name, configure, snapshot, reset)
        with self._lock:
            self._planes[name] = hooks

    def unregister(self, name: str) -> None:
        with self._lock:
            self._planes.pop(name, None)

    def planes(self) -> List[str]:
        with self._lock:
            return sorted(self._planes)

    def _hooks(self) -> List[PlaneHooks]:
        with self._lock:
            return [self._planes[k] for k in sorted(self._planes)]

    # ------------------------------------------------------------- fanout

    def configure(self, clock: Clock) -> None:
        """Rebind every plane's timebase.  Per-plane error isolation:
        a raising hook is counted, the rest still rebind."""
        for hooks in self._hooks():
            if hooks.configure is None:
                continue
            try:
                hooks.configure(clock)
            except Exception:  # noqa: BLE001 - plane isolation
                with self._lock:
                    self._errors += 1

    def snapshot(self) -> Dict[str, Dict]:
        """Debug-state capture across every plane that registered a
        snapshot hook; an erroring plane reports `{"error": ...}` in
        its slot instead of poisoning the bundle."""
        out: Dict[str, Dict] = {}
        for hooks in self._hooks():
            if hooks.snapshot is None:
                continue
            try:
                out[hooks.name] = hooks.snapshot()
            except Exception as exc:  # noqa: BLE001 - plane isolation
                out[hooks.name] = {"error": repr(exc)}
        return out

    def reset(self) -> List[str]:
        """Reset every plane that registered a reset hook; returns the
        names that were reset.  Test-isolation path only."""
        done: List[str] = []
        for hooks in self._hooks():
            if hooks.reset is None:
                continue
            try:
                hooks.reset()
                done.append(hooks.name)
            except Exception:  # noqa: BLE001 - plane isolation
                with self._lock:
                    self._errors += 1
        return done

    def stats(self) -> Dict:
        with self._lock:
            return {"planes": sorted(self._planes),
                    "hook_errors": self._errors}


# process singleton, mirroring REGISTRY/FLIGHT/MEMLEDGER: one agent per
# process in practice, and the planes it federates are themselves
# process globals
OBSBUS = ObsBus()
