"""Blocked evaluations tracker (reference: nomad/blocked_evals.go).

Parks evals whose placement failed on exhausted resources and re-enqueues
them into the broker when node capacity changes.  One blocked eval per job
(later ones for the same job are deduplicated); escaped-computed-class evals
unblock on any capacity change, class-restricted ones only when a node of a
relevant computed class changes (we conservatively unblock on any change when
class tracking is absent, which is correct — just extra evals)."""

from __future__ import annotations

import threading
from typing import Dict, Tuple

from nomad_tpu_torch.structs import EVAL_STATUS_PENDING, Evaluation


class BlockedEvals:
    def __init__(self, broker) -> None:
        self._lock = threading.Lock()
        self._broker = broker
        self._enabled = False
        # (namespace, job_id) -> blocked eval
        self._blocked: Dict[Tuple[str, str], Evaluation] = {}
        # class-eligibility index: computed class -> set of job keys
        self._by_class: Dict[str, set] = {}
        self._escaped: set = set()
        # state index of the newest capacity change seen (reference:
        # blocked_evals.go unblockIndexes): an eval arriving to block
        # whose scheduling snapshot PREDATES it raced a capacity change —
        # park it and the change is missed forever; re-enqueue instead.
        # One global watermark, not per-class: conservative (extra evals,
        # never a stranded job).
        self._last_unblock_index = 0
        self.stats = {"blocked": 0, "unblocked": 0, "deduped": 0,
                      "raced": 0}

    def set_enabled(self, enabled: bool) -> None:
        with self._lock:
            self._enabled = enabled
            if not enabled:
                self._blocked.clear()
                self._by_class.clear()
                self._escaped.clear()

    def block(self, evaluation: Evaluation) -> bool:
        """Track a blocked eval.  Returns False when an eval for the same
        job is already blocked (the caller should cancel the duplicate in
        state, matching the reference's duplicate-blocked-eval
        cancellation)."""
        with self._lock:
            if not self._enabled:
                return True
            key = (evaluation.namespace, evaluation.job_id)
            if key in self._blocked:
                if self._blocked[key].id == evaluation.id:
                    return True      # same eval re-tracked (leader flap)
                self.stats["deduped"] += 1
                return False
            if (evaluation.snapshot_index
                    and evaluation.snapshot_index
                    < self._last_unblock_index):
                # capacity changed AFTER this eval's scheduling snapshot
                # but BEFORE it reached the tracker: parking it would
                # miss that unblock forever — retry immediately
                e = evaluation.copy()
                e.status = EVAL_STATUS_PENDING
                e.status_description = ("unblocked: capacity changed "
                                        "during scheduling")
                self._broker.enqueue(e)
                self.stats["raced"] += 1
                return True
            self._blocked[key] = evaluation
            self.stats["blocked"] += 1
            if evaluation.escaped_computed_class or not evaluation.class_eligibility:
                self._escaped.add(key)
            else:
                for klass, eligible in evaluation.class_eligibility.items():
                    if eligible:
                        self._by_class.setdefault(klass, set()).add(key)
            return True

    def unblock(self, computed_class: str, now: float = 0.0,
                index: int = 0) -> int:
        """Capacity changed on a node of `computed_class`: release matching
        blocked evals back to the broker.  `index` is the state index of
        the change (the block-time race guard's watermark)."""
        with self._lock:
            if not self._enabled:
                return 0
            if index > self._last_unblock_index:
                self._last_unblock_index = index
            keys = set(self._escaped)
            keys |= self._by_class.pop(computed_class, set())
            released = 0
            for key in keys:
                ev = self._blocked.pop(key, None)
                if ev is None:
                    continue
                self._escaped.discard(key)
                e = ev.copy()
                e.status = EVAL_STATUS_PENDING
                e.status_description = "unblocked due to capacity change"
                self._broker.enqueue(e, now=now)
                released += 1
                self.stats["unblocked"] += 1
            return released

    def unblock_all(self, now: float = 0.0) -> int:
        with self._lock:
            keys = list(self._blocked)
        total = 0
        for key in keys:
            with self._lock:
                ev = self._blocked.pop(key, None)
                self._escaped.discard(key)
            if ev is not None:
                e = ev.copy()
                e.status = EVAL_STATUS_PENDING
                self._broker.enqueue(e, now=now)
                total += 1
                self.stats["unblocked"] += 1
        return total

    def untrack(self, namespace: str, job_id: str) -> None:
        """Job deregistered: drop its blocked eval."""
        with self._lock:
            self._blocked.pop((namespace, job_id), None)
            self._escaped.discard((namespace, job_id))

    def num_blocked(self) -> int:
        with self._lock:
            return len(self._blocked)
