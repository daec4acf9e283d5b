"""Fault tolerance for 1000+-node runs: preemption handling, straggler
detection, elastic restart decisions.

This layer is what Mirage's control plane drives: the wall-clock limit
(or a preemption signal) triggers checkpoint-and-exit; the provisioner has
(ideally) already queued the successor sub-job, which resumes from the
latest checkpoint — possibly on a smaller/larger mesh (see
checkpoint.restore_checkpoint's reshape path).
"""
from __future__ import annotations

import signal
import threading
import time
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
