"""Mirage: the batched evaluation loop of the provisioner (§5.1, §6), port
of ``repro.core.agent``'s serving subset: the method registry,
``EvalResult``, ``LearnerPolicy`` and ``evaluate_batch``. Offline
pretraining, online training and ``build_policy`` come with the training
slice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from .policy import Policy
from .provisioner import VectorProvisionEnv

HOUR = 3600.0

RL_METHODS = ("transformer+dqn", "transformer+pg", "moe+dqn", "moe+pg")
ALL_METHODS = ("reactive", "avg", "random_forest", "xgboost") + RL_METHODS
DEFAULT_METHOD = "moe+dqn"          # §6.3: balanced default


# ------------------------------------------------------------- evaluation
@dataclasses.dataclass
class EvalResult:
    method: str
    interruptions_h: List[float]
    overlaps_h: List[float]
    waits_h: List[float]
    # robustness accounting (all zeros on fault-free cells): per-episode
    # node-failure / requeue counts observed during the decision window,
    # and how often a FallbackPolicy bypassed the method
    fault_counts: List[int] = dataclasses.field(default_factory=list)
    requeue_counts: List[int] = dataclasses.field(default_factory=list)
    fallbacks: int = 0

    @property
    def mean_interruption_h(self) -> float:
        return float(np.mean(self.interruptions_h)) if self.interruptions_h else 0.0

    @property
    def mean_overlap_h(self) -> float:
        return float(np.mean(self.overlaps_h)) if self.overlaps_h else 0.0

    @property
    def zero_interruption_frac(self) -> float:
        n = len(self.interruptions_h) + len(self.overlaps_h)
        zero = sum(1 for x in self.interruptions_h if x < 1e-6) + len(self.overlaps_h)
        return zero / max(n, 1)

    def summary(self) -> Dict[str, float]:
        return {"mean_interruption_h": self.mean_interruption_h,
                "mean_overlap_h": self.mean_overlap_h,
                "zero_interruption_frac": self.zero_interruption_frac,
                "n_episodes": len(self.interruptions_h) + len(self.overlaps_h),
                "n_faults": int(sum(self.fault_counts)),
                "n_requeues": int(sum(self.requeue_counts)),
                "n_fallbacks": int(self.fallbacks)}


class LearnerPolicy(Policy):
    """RL learner as an evaluation Policy: one forward on the learner's
    device decides the whole batch, exploration off (§4.4 serving mode)."""

    def __init__(self, method: str, learner):
        self.method = method
        self.learner = learner

    def act_batch(self, obs: Dict) -> np.ndarray:
        return self.learner.act_batch(np.asarray(obs["matrix"]),
                                      explore=False)


def _policy_method(policy) -> str:
    return getattr(policy, "method", "policy")


def evaluate_batch(venv: VectorProvisionEnv, policy: Policy,
                   episodes: Optional[int] = None, seed: int = 0,
                   t_starts: Optional[Sequence[float]] = None) -> EvalResult:
    """Batched evaluation: lockstep B-lane episodes off one shared
    ReplayCheckpointCache.

    Episode start instants are one uniform draw over the env's start
    range (``rng(seed).uniform(lo, hi, episodes)`` — the same sequence
    the scalar loop drew), or ``t_starts`` verbatim. They are processed
    in chunks of ``venv.batch`` lanes; a shorter tail chunk runs on a
    tail-sized env sharing ``venv``'s cache. Per-lane accounting matches
    the scalar loop (result order == start-instant order) because lane
    ``i`` is bit-identical to a scalar env seeded ``venv.seed + i``.

    Policy hooks: ``reset_lanes`` fires when a chunk begins;
    ``observe(infos)`` fires once per finished chunk with the B final
    infos — so within a chunk every lane acts under the same policy
    state (stateful policies like ``avg`` update between chunks; with a
    B=1 env that degenerates to updating between episodes, the legacy
    scalar-loop cadence).

    Robustness accounting: each final info's ``n_faults``/``n_requeues``
    (node failures / Slurm-style requeues observed during the decision
    window — zero on fault-free cells) land in ``fault_counts`` /
    ``requeue_counts``, and a ``FallbackPolicy`` wrapper's running
    ``n_fallbacks`` is copied into the result.
    """
    if t_starts is None:
        episodes = venv.batch if episodes is None else int(episodes)
        lo, hi = venv._t_start_range
        t_starts = np.random.default_rng(seed).uniform(lo, hi, episodes)
    t_starts = np.asarray(t_starts, np.float64)
    res = EvalResult(_policy_method(policy), [], [], [])
    for c0 in range(0, len(t_starts), venv.batch):
        chunk = t_starts[c0:c0 + venv.batch]
        v = venv
        if len(chunk) != venv.batch:          # tail chunk: smaller env,
            v = venv.resized(len(chunk))
        obs = v.reset(t_starts=chunk)
        policy.reset_lanes(np.ones(v.batch, bool))
        finals: List[Optional[Dict]] = [None] * v.batch
        while not v.dones.all():
            acts = policy.act_batch(obs)
            live = ~v.dones
            obs, r, dones, infos = v.step(acts)
            for i in np.flatnonzero(live & dones):
                finals[int(i)] = infos[int(i)]
        for info in finals:
            if info.get("kind") == "interrupt":
                res.interruptions_h.append(info["amount_s"] / HOUR)
            else:
                res.overlaps_h.append(info["amount_s"] / HOUR)
            res.waits_h.append(info.get("wait_s", 0.0) / HOUR)
            res.fault_counts.append(int(info.get("n_faults", 0)))
            res.requeue_counts.append(int(info.get("n_requeues", 0)))
        policy.observe(finals)
    res.fallbacks = int(getattr(policy, "n_fallbacks", 0))
    return res
