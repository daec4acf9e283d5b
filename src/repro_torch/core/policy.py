"""The unified batched Policy protocol (§6 evaluation matrix).

Every provisioning method — heuristics, tree regressors, RL learners —
implements one interface:

* ``act_batch(obs) -> (B,) int64 actions`` over a batched observation
  dict (the ``VectorProvisionEnv`` field set: ``matrix`` (B, k, 40),
  ``summary`` (B, 4*40), ``pred_remaining`` (B,), ``time_pos`` (B,));
* ``reset_lanes(mask)`` — called when the masked lanes begin a fresh
  episode (hook for per-lane policy state; stateless policies ignore it);
* ``observe(infos)`` — called once per evaluation chunk with the B
  episode-final info dicts (``kind``/``amount_s``/``wait_s``), subsuming
  the ad-hoc ``observe_wait`` plumbing the scalar loop used to thread by
  hand for the ``avg`` heuristic.

The scalar ``act(obs)`` adapter lifts a single-episode observation dict
to a B=1 batch, so interactive callers (examples stepping one episode by
hand) keep a one-line interface while every policy runs the same batched
code path.

``FallbackPolicy`` wraps any Policy with graceful degradation: if the
inner ``act_batch`` raises, or overruns a wall-clock decision deadline,
that interval's decision falls back to the reactive heuristic and the
fallback is counted — serving stays up when the learner misbehaves.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np


def batch_obs(obs: Dict) -> Dict:
    """Lift a scalar observation dict to a B=1 batched one."""
    return {k: np.asarray(v)[None] for k, v in obs.items()}


def stack_obs(obs_list: List[Dict]) -> Dict:
    """Stack N scalar observation dicts into one (N, ...) batched dict —
    the dynamic-batching boundary of the multi-tenant serving path."""
    keys = obs_list[0].keys()
    return {k: np.stack([np.asarray(o[k]) for o in obs_list])
            for k in keys}


class Policy:
    """Base class of the batched policy protocol."""

    #: method-registry name reported in EvalResult (subclasses override)
    method: str = "policy"

    def act_batch(self, obs: Dict) -> np.ndarray:
        """Batched decision: obs dict with (B, ...) fields -> (B,) int64
        actions (1 = submit the successor, 0 = wait)."""
        raise NotImplementedError

    def reset_lanes(self, mask: np.ndarray) -> None:
        """The masked lanes are starting a fresh episode."""

    def observe(self, infos: List[Optional[Dict]]) -> None:
        """Episode-final infos for a finished evaluation chunk."""

    def act(self, obs: Dict) -> int:
        """Scalar adapter: one episode's obs dict -> one action."""
        return int(self.act_batch(batch_obs(obs))[0])


class FallbackPolicy(Policy):
    """Graceful degradation around any Policy (the serving-side half of
    the self-healing control plane).

    Each ``act_batch`` call delegates to the wrapped policy; if it raises
    any exception, or ``deadline_s`` is set and the call overruns it
    (measured on ``clock``, injectable for tests), the whole interval's
    decision falls back to the reactive heuristic — submit exactly when
    the predecessor's limit has expired (``pred_remaining <= 0``), the
    same rule as ``baselines.ReactivePolicy`` (inlined to stay import-
    cycle-free). Fallbacks are counted in ``n_fallbacks`` / ``n_decisions``
    so evaluation results can report how often the learner was bypassed.
    """

    def __init__(self, inner: Policy, deadline_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.inner = inner
        self.method = f"{getattr(inner, 'method', 'policy')}+fallback"
        self.deadline_s = deadline_s
        self.clock = clock
        self.n_decisions = 0
        self.n_fallbacks = 0

    @staticmethod
    def _reactive(obs: Dict) -> np.ndarray:
        return (np.asarray(obs["pred_remaining"]) <= 0.0).astype(np.int64)

    def act_batch(self, obs: Dict) -> np.ndarray:
        self.n_decisions += 1
        t0 = self.clock()
        try:
            acts = np.asarray(self.inner.act_batch(obs), np.int64)
        except Exception:
            self.n_fallbacks += 1
            return self._reactive(obs)
        if self.deadline_s is not None and self.clock() - t0 > self.deadline_s:
            self.n_fallbacks += 1
            return self._reactive(obs)
        return acts

    def reset_lanes(self, mask: np.ndarray) -> None:
        self.inner.reset_lanes(mask)

    def observe(self, infos: List[Optional[Dict]]) -> None:
        self.inner.observe(infos)
