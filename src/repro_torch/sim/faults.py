"""Seeded, deterministic fault injection for the Slurm simulator.

A ``FaultPlan`` is a *fixed, precomputed schedule* of cluster faults —
node-failure / node-repair windows plus a transient control-plane error
model — consumed by ``SlurmSimulator`` as first-class event types in its
event loop. Determinism is the whole contract:

* The plan is generated once from ``(spec, horizon, n_nodes, seed)`` and
  is immutable afterwards; two simulators given the same plan see the
  same faults at the same simulated instants, independent of how time is
  advanced (one ``run_until`` or many, forked or fresh — the same
  property the checkpoint cache relies on).
* ``FaultPlan.none()`` (or ``faults=None``) is **bit-identical** to the
  fault-free engine: no extra events, no behavioural branch taken —
  pinned by ``tests/test_checkpoint_cache.py`` / ``tests/test_faults.py``.
* Control-plane errors (transient submit/cancel failures) are a pure
  function of ``(ctrl_seed, op_index)`` so a restarted control plane
  replays the same error sequence it saw before the crash.

Fault semantics in the simulator (see ``SlurmSimulator._apply_faults``):
a *failure* event takes ``nodes`` nodes out of service; running jobs are
killed newest-start-first until the remaining allocation fits, and the
killed jobs are requeued Slurm-style (original submit time kept, so
their age priority survives the requeue) with the lost node-seconds
charged to ``sim.lost_node_s``. A *repair* event returns the nodes and
lets the next scheduling pass restart work.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

HOUR = 3600.0
DAY = 24 * HOUR

#: event kinds in ``FaultPlan.kinds``
FAIL = 0
REPAIR = 1

#: cap on consecutive transient control errors per operation (keeps the
#: retry loop bounded even at pathological error rates)
MAX_CTRL_FAILURES = 8


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable, time-sorted schedule of node fault events.

    ``times``/``kinds``/``nodes`` are parallel arrays: event ``e`` at
    ``times[e]`` either fails (``kinds[e] == FAIL``) or repairs
    (``kinds[e] == REPAIR``) ``nodes[e]`` nodes. Arrays are marked
    read-only so a plan can be shared across forked simulators without
    copy-on-write bookkeeping.
    """
    times: np.ndarray                    # (E,) float64, ascending
    kinds: np.ndarray                    # (E,) int64, FAIL / REPAIR
    nodes: np.ndarray                    # (E,) int64 node counts
    ctrl_seed: int = 0
    ctrl_error_rate: float = 0.0

    def __post_init__(self):
        times = np.asarray(self.times, np.float64)
        kinds = np.asarray(self.kinds, np.int64)
        nodes = np.asarray(self.nodes, np.int64)
        assert times.shape == kinds.shape == nodes.shape
        assert times.ndim == 1
        if times.size > 1:
            assert (np.diff(times) >= 0).all(), "fault times must be sorted"
        for name, a in (("times", times), ("kinds", kinds), ("nodes", nodes)):
            a = a.copy()
            a.flags.writeable = False
            object.__setattr__(self, name, a)

    def __len__(self) -> int:
        return int(self.times.size)

    @property
    def empty(self) -> bool:
        return self.times.size == 0

    @staticmethod
    def none(ctrl_seed: int = 0, ctrl_error_rate: float = 0.0) -> "FaultPlan":
        """The empty plan — provably bit-identical to ``faults=None``."""
        return FaultPlan(np.empty(0, np.float64), np.empty(0, np.int64),
                         np.empty(0, np.int64), ctrl_seed=ctrl_seed,
                         ctrl_error_rate=ctrl_error_rate)

    @staticmethod
    def generate(horizon_s: float, n_nodes: int, seed: int,
                 mtbf_s: float = 4 * DAY, repair_mean_s: float = 6 * HOUR,
                 max_nodes: int = 4, ctrl_error_rate: float = 0.0
                 ) -> "FaultPlan":
        """Draw a fault schedule over ``[0, horizon_s)``.

        Failure onsets arrive with exponential inter-arrival times
        (``mtbf_s``); each failure takes ``1..max_nodes`` nodes down for
        an exponential repair duration (``repair_mean_s``, floored at
        5 min). Every failure is paired with its own repair, so the
        net down-node count always returns to zero.
        """
        rng = np.random.default_rng(seed)
        t = 0.0
        ts, ks, ns = [], [], []
        while True:
            t += float(rng.exponential(mtbf_s))
            if t >= horizon_s:
                break
            m = int(rng.integers(1, max(max_nodes, 1) + 1))
            m = min(m, max(n_nodes - 1, 1))      # never fail the whole pool
            dur = max(float(rng.exponential(repair_mean_s)), 300.0)
            ts += [t, t + dur]
            ks += [FAIL, REPAIR]
            ns += [m, m]
        times = np.asarray(ts, np.float64)
        order = np.argsort(times, kind="stable")
        return FaultPlan(times[order],
                         np.asarray(ks, np.int64)[order],
                         np.asarray(ns, np.int64)[order],
                         ctrl_seed=seed, ctrl_error_rate=ctrl_error_rate)

    # -------------------------------------------- control-plane error model
    def ctrl_failures(self, op_index: int) -> int:
        """Consecutive transient errors for control operation ``op_index``.

        Pure function of ``(ctrl_seed, op_index)``: the k-th submit/cancel
        in a control-plane run always sees the same number of transient
        failures before succeeding, whether or not the driver crashed and
        replayed in between. Bounded by ``MAX_CTRL_FAILURES``.
        """
        if self.ctrl_error_rate <= 0.0:
            return 0
        rng = np.random.default_rng((int(self.ctrl_seed) & 0x7FFFFFFF,
                                     int(op_index)))
        k = 0
        while k < MAX_CTRL_FAILURES and rng.random() < self.ctrl_error_rate:
            k += 1
        return k


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """A named fault *profile*: plan parameters scaled to a cluster.

    ``max_nodes_frac`` scales the per-failure blast radius with cluster
    size so one profile makes sense across V100/RTX/A100 cells.
    """
    name: str
    mtbf_s: float = 4 * DAY
    repair_mean_s: float = 6 * HOUR
    max_nodes_frac: float = 0.05
    ctrl_error_rate: float = 0.05

    def make_plan(self, horizon_s: float, n_nodes: int, seed: int
                  ) -> FaultPlan:
        max_nodes = max(1, int(round(self.max_nodes_frac * n_nodes)))
        return FaultPlan.generate(horizon_s, n_nodes, seed,
                                  mtbf_s=self.mtbf_s,
                                  repair_mean_s=self.repair_mean_s,
                                  max_nodes=max_nodes,
                                  ctrl_error_rate=self.ctrl_error_rate)


#: registered fault profiles; "" (no profile) means fault-free
FAULT_PROFILES = {
    "faulty": FaultSpec("faulty", mtbf_s=4 * DAY, repair_mean_s=6 * HOUR,
                        max_nodes_frac=0.05, ctrl_error_rate=0.05),
}


def get_fault_spec(name: str) -> Optional[FaultSpec]:
    """Profile lookup; empty name -> ``None`` (fault-free)."""
    if not name:
        return None
    return FAULT_PROFILES[name]
