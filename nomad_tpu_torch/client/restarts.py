"""Restart tracker (reference: client/allocrunner/taskrunner/restarts).

Decides, after each task exit, whether to restart locally (per the group's
RestartPolicy), wait, or give up (which surfaces as a failed alloc and hands
control to the server-side reschedule policy).
"""

from __future__ import annotations

import random
import time
from typing import Optional, Tuple

from nomad_tpu_torch.structs import RestartPolicy

RESTART = "restart"
WAIT = "wait"        # same as restart but caller sleeps `delay` first
KILL = "kill"


class RestartTracker:
    def __init__(self, policy: RestartPolicy,
                 is_batch: bool = False) -> None:
        self.policy = policy
        self.is_batch = is_batch
        self.count = 0
        self.start_time = 0.0

    def next(self, exit_code: int, failed: bool,
             now: Optional[float] = None) -> Tuple[str, float]:
        """Returns (decision, delay_s). reference: restarts.go GetState."""
        t = now if now is not None else time.time()
        # service semantics: successful exit still restarts; batch: done.
        if not failed and exit_code == 0 and self.is_batch:
            return KILL, 0.0
        if self.policy.attempts == 0:
            return KILL, 0.0
        if self.start_time == 0.0 or \
                t - self.start_time > self.policy.interval_s:
            self.start_time = t
            self.count = 0
        self.count += 1
        if self.count > self.policy.attempts:
            if self.policy.mode == "delay":
                # wait out the rest of the interval, then a fresh interval
                delay = self.start_time + self.policy.interval_s - t
                self.start_time = 0.0
                self.count = 0
                return WAIT, max(delay, self.policy.delay_s)
            return KILL, 0.0
        jitter = random.uniform(0, self.policy.delay_s * 0.25)
        return RESTART, self.policy.delay_s + jitter
