"""Fault tolerance for 1000+-node runs: preemption handling, straggler
detection, elastic restart decisions.

This layer is what Mirage's control plane drives: the wall-clock limit
(or a preemption signal) triggers checkpoint-and-exit; the provisioner has
(ideally) already queued the successor sub-job, which resumes from the
latest checkpoint — possibly on a smaller/larger mesh (see
checkpoint.restore_checkpoint's reshape path).
"""
from __future__ import annotations

import bisect
import dataclasses
import signal
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional


class PreemptionGuard:
    """Watches for SIGTERM/SIGUSR1 (batch-scheduler preemption) and a
    wall-clock budget; the train loop polls ``should_stop`` each step."""

    def __init__(self, wall_limit_s: Optional[float] = None,
                 grace_s: float = 120.0, install_signals: bool = True):
        self.t0 = time.monotonic()
        self.wall_limit_s = wall_limit_s
        self.grace_s = grace_s
        self._signalled = threading.Event()
        if install_signals:
            try:
                signal.signal(signal.SIGTERM, self._on_signal)
                signal.signal(signal.SIGUSR1, self._on_signal)
            except ValueError:
                pass  # not the main thread (tests)

    def _on_signal(self, signum, frame) -> None:
        self._signalled.set()

    def trigger(self) -> None:
        """Programmatic preemption (used by tests and the chain driver)."""
        self._signalled.set()

    @property
    def elapsed(self) -> float:
        return time.monotonic() - self.t0

    def should_stop(self) -> bool:
        if self._signalled.is_set():
            return True
        if self.wall_limit_s is not None:
            return self.elapsed >= self.wall_limit_s - self.grace_s
        return False


@dataclasses.dataclass
class StragglerMonitor:
    """Per-step wall-time tracker: flags steps slower than
    ``threshold x`` the trailing median — on real pods this drives the
    launcher's decision to health-check / evict a host and restart on a
    shrunken mesh (elastic path).

    The trailing window is kept in two views: ``_times`` in insertion
    order (for eviction) and ``_sorted`` maintained incrementally with
    ``bisect`` (for the median), so ``record`` is O(window) worst case
    instead of re-sorting the whole window every step."""
    window: int = 50
    threshold: float = 2.5
    _times: Deque[float] = dataclasses.field(default_factory=deque)
    _sorted: List[float] = dataclasses.field(default_factory=list)
    flagged: int = 0

    def record(self, step_time_s: float) -> bool:
        ts, srt = self._times, self._sorted
        is_straggler = False
        if len(ts) >= 10:
            med = srt[len(srt) // 2]
            is_straggler = step_time_s > self.threshold * med
            if is_straggler:
                self.flagged += 1
        ts.append(step_time_s)
        bisect.insort(srt, step_time_s)
        if len(ts) > self.window:
            old = ts.popleft()
            del srt[bisect.bisect_left(srt, old)]
        return is_straggler

    @property
    def median(self) -> float:
        if not self._sorted:
            return 0.0
        return self._sorted[len(self._sorted) // 2]


@dataclasses.dataclass
class ElasticPlan:
    """Mesh-shape fallbacks in preference order; the launcher walks down
    the list as nodes fail and back up as they return. Restores resolve
    through checkpoint.restore_checkpoint with the new mesh's shardings."""
    shapes: List[Dict] = dataclasses.field(default_factory=lambda: [
        {"pod": 2, "data": 16, "model": 16},
        {"pod": 1, "data": 16, "model": 16},
        {"pod": 1, "data": 8, "model": 16},
    ])
    level: int = 0

    def current(self) -> Dict:
        return self.shapes[self.level]

    def degrade(self) -> Dict:
        self.level = min(self.level + 1, len(self.shapes) - 1)
        return self.current()

    def recover(self) -> Dict:
        self.level = max(self.level - 1, 0)
        return self.current()
