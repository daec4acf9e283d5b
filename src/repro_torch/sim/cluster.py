"""Cluster abstraction: homogeneous node pool with counting allocation.

The paper's clusters are homogeneous GPU nodes (4xV100 / 4xRTX / 3xA100);
jobs request whole nodes, so allocation is a counting problem. Node
identity is tracked only to support downtime windows (maintenance) and
per-node accounting.

Busy capacity is maintained as a plain counter so the simulator's hot
path (batch start/release from the structure-of-arrays scheduling core)
is O(1); the per-job dict API remains for callers that track job ids.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple


@dataclasses.dataclass
class Cluster:
    n_nodes: int
    down_nodes: int = 0
    _allocated: Dict[int, int] = dataclasses.field(default_factory=dict)
    _busy: int = 0

    @property
    def n_available(self) -> int:
        return self.n_nodes - self.down_nodes

    @property
    def n_busy(self) -> int:
        return self._busy

    @property
    def n_free(self) -> int:
        return self.n_available - self._busy

    def can_fit(self, n: int) -> bool:
        return n <= self.n_free

    # ------------------------------------------------ counting fast path
    def allocate_n(self, n: int) -> None:
        if n > self.n_free:
            raise RuntimeError(f"allocation overflow: want {n}, "
                               f"free {self.n_free}")
        self._busy += n

    def release_n(self, n: int) -> None:
        self._busy = max(self._busy - n, 0)

    # ------------------------------------------------- per-job id API
    def allocate(self, job_id: int, n: int) -> None:
        self.allocate_n(n)
        self._allocated[job_id] = n

    def release(self, job_id: int) -> int:
        n = self._allocated.pop(job_id, 0)
        self.release_n(n)
        return n

    def utilization(self) -> float:
        return self._busy / max(self.n_available, 1)
