"""Deterministic-simulation seams (reference: nomad_tpu.chaos).

The cluster plane (core/raft.py, core/membership.py, core/cluster.py)
is written against two seams this package owns:

  - `chaos.clock.Clock`         — time source; `SystemClock` is the wall
    clock, `VirtualClock` is advanced explicitly by a scenario driver.
  - `chaos.transport.Transport` — message transport; `TCPTransport` is
    length-prefixed MessagePack over TCP (core/wire.py framing, optional
    AES-GCM), `SimTransport` routes the same payloads through an
    in-memory `SimNetwork` with seeded faults.

The exports are the reference's.  The traces, invariants, scenarios and
soak of the reference's package are not ported yet.  Importing the
transport imports `core.wire`, whose package init is lazy, so this init
(which the state store's clock import runs) pulls in no server.
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
