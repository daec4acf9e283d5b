"""Experience replay (§4.8).

Host-side numpy pool. Instances are (state matrix, action, reward,
next state matrix, done); sampling is uniform over the shuffled pool to
break the correlation between consecutive simulation steps.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np


class ReplayBuffer:
    def __init__(self, capacity: int, k: int, m: int, seed: int = 0):
        self.capacity = capacity
        self.s = np.zeros((capacity, k, m), np.float32)
        self.a = np.zeros((capacity,), np.int32)
        self.r = np.zeros((capacity,), np.float32)
        self.s2 = np.zeros((capacity, k, m), np.float32)
        self.done = np.zeros((capacity,), bool)
        self.idx = 0
        self.full = False
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self.capacity if self.full else self.idx

    def add(self, s, a, r, s2, done) -> None:
        i = self.idx
        self.s[i], self.a[i], self.r[i] = s, a, r
        self.s2[i], self.done[i] = s2, done
        self.idx = (self.idx + 1) % self.capacity
        self.full = self.full or self.idx == 0

    def sample(self, batch: int) -> Dict[str, np.ndarray]:
        n = len(self)
        ids = self.rng.integers(0, n, batch)
        return {"s": self.s[ids], "a": self.a[ids], "r": self.r[ids],
                "s2": self.s2[ids], "done": self.done[ids]}
