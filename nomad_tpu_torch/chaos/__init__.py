"""Deterministic-simulation seams (reference: nomad_tpu.chaos).

The cluster plane (core/raft.py, core/membership.py, core/cluster.py)
is written against two seams this package owns:

  - `chaos.clock.Clock`         — time source; `SystemClock` is the wall
    clock, `VirtualClock` is advanced explicitly by a scenario driver.
  - `chaos.transport.Transport` — message transport; `TCPTransport` is
    length-prefixed MessagePack over TCP (core/wire.py framing, optional
    AES-GCM), `SimTransport` routes the same payloads through an
    in-memory `SimNetwork` with seeded faults.

On top of the seams, as in the reference:

  - `chaos.trace`      — canonical event traces (same seed => identical
    bytes) and state-store fingerprints for replay checks.
  - `chaos.traffic`    — the soak's seeded traffic schedule and fleet
    (pure data).
  - `chaos.invariants` — cluster safety checks over what a scenario
    observed.
  - `chaos.scenarios`  — named, seeded fault schedules run against real
    `ClusterServer`s on a `SimNetwork` and a `VirtualClock`.
  - `chaos.soak`       — the virtual-time production soak through a real
    `Agent`'s HTTP API.

The exports are the reference's.  `scenarios` and `soak` pull in the
cluster layer and are imported directly
(`nomad_tpu_torch.chaos.scenarios`, `nomad_tpu_torch.chaos.soak`); they
take a `device` for the servers they boot, CUDA unless given.  Importing
the transport imports `core.wire`, whose package init is lazy, so this
init (which the state store's clock import runs) pulls in no server.
"""

from .clock import Clock, SystemClock, VirtualClock, resolve_clock
from .transport import (
    Connection,
    Listener,
    SimNetwork,
    SimTransport,
    TCPTransport,
    Transport,
    resolve_transport,
)

__all__ = [
    "Clock", "SystemClock", "VirtualClock", "resolve_clock",
    "Connection", "Listener", "Transport", "TCPTransport",
    "SimNetwork", "SimTransport", "resolve_transport",
]
