"""Chained sub-job workloads: the unit Mirage provisions (§4.1, §4.5).

A long-running service (training or inference) is split into a chain of
wall-clock-limited sub-jobs J1..Jk. The provisioner controls WHEN each
successor is submitted; the outcome per consecutive pair is either an
INTERRUPTION (successor starts after the predecessor ends) or an OVERLAP
(successor starts while the predecessor still runs).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from .trace import Job
from .simulator import SlurmSimulator

HOUR = 3600.0


@dataclasses.dataclass
class SubJobChain:
    """A service of ``k`` sub-jobs, each with the same size and limit."""
    user_id: int
    n_nodes: int
    sub_limit: float = 48 * HOUR
    k: int = 2
    next_id: int = 900_000

    def make_sub(self, idx: int, submit_time: float) -> Job:
        return Job(job_id=self.next_id + idx, user_id=self.user_id,
                   submit_time=submit_time, runtime=self.sub_limit,
                   time_limit=self.sub_limit, n_nodes=self.n_nodes,
                   job_name=f"chain_{self.user_id}.sub_{idx}")


def pair_outcome(pred: Job, succ: Job) -> Tuple[str, float]:
    """('interrupt'|'overlap', seconds). Interrupt: succ starts after pred
    ends; overlap: succ starts (holds nodes) before pred ends."""
    assert pred.end_time >= 0 and succ.start_time >= 0
    gap = succ.start_time - pred.end_time
    if gap >= 0:
        return "interrupt", gap
    return "overlap", -gap


def run_pair(sim: SlurmSimulator, chain: SubJobChain, t_pred_submit: float,
             succ_delay: float) -> Tuple[str, float, Job, Job]:
    """Reference harness: submit the predecessor at t_pred_submit, the
    successor ``succ_delay`` seconds after the predecessor STARTS, then run
    until the outcome is observable. Used by heuristics/offline sampling."""
    pred = chain.make_sub(0, t_pred_submit)
    sim.run_until(t_pred_submit)
    sim.submit(pred)
    sim.run_until_started(pred)
    t_succ = pred.start_time + min(succ_delay, chain.sub_limit)
    succ = chain.make_sub(1, t_succ)
    sim.run_until(t_succ)
    sim.submit(succ)
    sim.run_until_started(succ)
    # ensure the predecessor end time is known (it runs to its limit)
    if pred.end_time < 0:
        pred.end_time = pred.start_time + min(pred.runtime, pred.time_limit)
    kind, amount = pair_outcome(pred, succ)
    return kind, amount, pred, succ
