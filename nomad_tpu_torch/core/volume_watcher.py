"""CSI volume claim watcher (reference: nomad/volumewatcher/ —
volumes_watcher.go + volume_reap).

The state store already drops claims when a terminal alloc is UPSERTED
(the common path).  This watcher covers everything that path can't see —
claims whose alloc was garbage-collected, never reached a terminal upsert
(node lost + alloc GC), or was restored stale from a snapshot — and it
owns the UNPUBLISH side effect: before a claim is released, the external
detach (CSI NodeUnpublish/ControllerUnpublish against the storage
backend) must succeed, with per-claim exponential backoff on failure so a
flapping storage controller cannot wedge the leader loop.

The unpublish hook is injectable: the in-process default is a no-op
success (no external CSI drivers exist here); tests inject failures to
exercise the retry ladder, and a real deployment would wire the client's
CSI plugin RPCs in.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

from .logging import log

MAX_BACKOFF_S = 60.0


class VolumeWatcher:
    """Leader-side reaper of stale CSI claims."""

    def __init__(self, server,
                 unpublish: Optional[Callable] = None) -> None:
        self.server = server
        # unpublish(volume, alloc_id) -> None; raises on failure
        self.unpublish = unpublish or (lambda vol, alloc_id: None)
        self._retry_at: Dict[Tuple[str, str, str], float] = {}
        self._backoff: Dict[Tuple[str, str, str], float] = {}
        self.stats = {"released": 0, "unpublish_failures": 0}

    def tick(self, now: Optional[float] = None) -> int:
        """One sweep: release claims held by terminal or vanished allocs.
        Returns the number of claims released this pass."""
        t = now if now is not None else self.server.clock.time()
        snap = self.server.state.snapshot()
        released = 0
        converted = 0
        live_keys = set()
        for vol in snap.csi_volumes():
            for alloc_id in list(vol.read_allocs) + list(vol.write_allocs):
                alloc = snap.alloc_by_id(alloc_id)
                if alloc is not None and not alloc.terminal_status():
                    continue                    # live claim: keep
                key = (vol.namespace, vol.id, alloc_id)
                live_keys.add(key)
                if self._retry_at.get(key, 0.0) > t:
                    continue                    # backing off
                try:
                    self.unpublish(vol, alloc_id)
                except Exception as exc:  # noqa: BLE001 - retry w/ backoff
                    backoff = min(self._backoff.get(key, 0.5) * 2,
                                  MAX_BACKOFF_S)
                    self._backoff[key] = backoff
                    self._retry_at[key] = t + backoff
                    self.stats["unpublish_failures"] += 1
                    log("volumewatcher", "warn",
                        "unpublish failed; will retry",
                        volume=vol.id, alloc_id=alloc_id,
                        retry_in_s=backoff, error=str(exc))
                    continue
                self.server.state.release_csi_claim(
                    vol.namespace, vol.id, alloc_id)
                self.stats["released"] += 1
                released += 1
                self._retry_at.pop(key, None)
                self._backoff.pop(key, None)
                log("volumewatcher", "info", "stale claim released",
                    volume=vol.id, alloc_id=alloc_id)
            # columnar block claims: every member is live by construction
            # (any member update materializes the block, migrating its
            # claims to the per-alloc ledger above), so the only stale
            # case is a block that vanished from the store entirely —
            # O(blocks) to check, never O(members).  Conversion, not
            # release: the members become ordinary per-alloc claims and
            # the reap loop above unpublishes each INDEPENDENTLY with
            # per-claim backoff on the next sweep (an all-or-nothing
            # block unpublish would restart from member zero on every
            # intermittent failure and might never converge).
            for block_id in list(vol.read_blocks):
                if block_id in snap._alloc_blocks:
                    continue
                self.server.state.convert_csi_block_claim(
                    vol.namespace, vol.id, block_id)
                converted += 1
                log("volumewatcher", "info",
                    "vanished-block claim expanded for per-member reap",
                    volume=vol.id, block_id=block_id)
        # forget backoff state for claims that no longer exist
        for key in list(self._retry_at):
            if key not in live_keys:
                self._retry_at.pop(key, None)
                self._backoff.pop(key, None)
        if converted:
            # the expanded members are per-alloc claims now; reap them
            # in the same tick so a single sweep still converges when
            # unpublish succeeds first try
            return released + self.tick(now=t)
        return released
