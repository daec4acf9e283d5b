"""Heuristic provisioning baselines (§6), on the batched Policy protocol.

* ``reactive`` — the common practice [39]: submit the successor when the
  predecessor COMPLETES; interruption = the successor's full queue wait.
* ``avg`` — monitor the average queue wait T_avg and submit the successor
  T_avg before the predecessor's wall-clock limit expires.
* tree policies (RF / GBDT wait regressors) — submit when the predicted
  successor wait covers the predecessor's remaining wall-clock.

All three decide whole lockstep batches at once: the heuristics are one
vector compare over the (B,) ``pred_remaining`` field, the trees one
batched ``predict`` over the (B, F) summary block.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional

import numpy as np

from .policy import Policy


class ReactivePolicy(Policy):
    """Submit only when the predecessor has ended."""

    method = name = "reactive"

    def act_batch(self, obs: Dict) -> np.ndarray:
        return (np.asarray(obs["pred_remaining"]) <= 0).astype(np.int64)


class AvgWaitPolicy(Policy):
    """Submit T_avg (rolling mean observed wait) before the predecessor's
    end; falls back to reactive until an estimate exists.

    The rolling window is a deque with a running sum — O(1) per observed
    wait regardless of the window size.
    """

    method = name = "avg"

    def __init__(self, window: int = 50):
        self.window = window
        self._waits: deque = deque()
        self._sum = 0.0

    @property
    def waits(self) -> List[float]:
        """Snapshot of the window (a copy — mutate via ``observe_wait``
        or by assigning a new list, not in place)."""
        return list(self._waits)

    @waits.setter
    def waits(self, xs) -> None:
        """Back-compat warm start: assigning a list seeds the window."""
        xs = [float(x) for x in xs][-self.window:]
        self._waits = deque(xs)
        self._sum = float(sum(xs))

    def observe_wait(self, wait_s: float) -> None:
        self._waits.append(float(wait_s))
        self._sum += float(wait_s)
        if len(self._waits) > self.window:
            self._sum -= self._waits.popleft()

    def observe(self, infos: List[Optional[Dict]]) -> None:
        for info in infos:
            if info:
                self.observe_wait(float(info.get("wait_s", 0.0)))

    @property
    def t_avg(self) -> float:
        return self._sum / len(self._waits) if self._waits else 0.0

    def act_batch(self, obs: Dict) -> np.ndarray:
        return (np.asarray(obs["pred_remaining"]) <= self.t_avg
                ).astype(np.int64)


class TreePolicy(Policy):
    """Wait-time-regressor policy (RF / GBDT): submit when the predicted
    successor wait >= the predecessor's remaining time. One batched
    ``predict`` call serves the whole (B, F) summary block."""

    def __init__(self, model, name: str):
        self.model = model
        self.name = self.method = name

    def act_batch(self, obs: Dict) -> np.ndarray:
        pred_wait = np.maximum(
            self.model.predict(np.asarray(obs["summary"])), 0.0)
        return (np.asarray(obs["pred_remaining"]) <= pred_wait
                ).astype(np.int64)
