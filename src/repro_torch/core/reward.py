"""Reward shaping (§4.5, Eq. 8).

Negative penalties; zero is the best possible reward. ``e_I`` / ``e_O``
are the user-configurable interruption / overlap penalty coefficients
(performance-sensitive users raise e_I; waste-averse users raise e_O).
"""
from __future__ import annotations

import dataclasses

HOUR = 3600.0


@dataclasses.dataclass(frozen=True)
class RewardConfig:
    e_interrupt: float = 1.0
    e_overlap: float = 0.5
    time_scale: float = 12 * HOUR   # penalty unit (keeps Q targets O(1-10))


def shape_reward(kind: str, amount_s: float, cfg: RewardConfig) -> float:
    """kind: 'interrupt' | 'overlap'; amount_s: outcome magnitude (seconds)."""
    hours = amount_s / cfg.time_scale
    if kind == "interrupt":
        return -cfg.e_interrupt * hours
    if kind == "overlap":
        return -cfg.e_overlap * hours
    raise ValueError(kind)
