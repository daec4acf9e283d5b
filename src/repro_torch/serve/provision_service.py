"""Always-on multi-tenant provisioning service (robustness spine).

``ProvisionService`` multiplexes N tenant chains — each a journaled
``ChainLane`` with its own ``DecisionJournal``, seed and control-plane
fault cursor — over one shared ``ReplayCheckpointCache``, dynamically
batching the pending tenants' observations into single
``Policy.act_batch`` calls. Production means answering under load,
through faults, and across restarts, so the robustness layer is the
point:

* **Load shedding** — a bounded admission queue with deadline-aware
  rejection: a decision request whose projected completion (queue
  position x the EWMA-measured batch cost) provably overruns the
  per-decision SLO is shed with a retry-after hint and counted per
  tenant, instead of growing an unbounded backlog. Shedding delays a
  tenant's decision in *wall-clock* time only — simulated time is
  frozen until its decision applies — so the eventual schedule is
  untouched (the lane determinism contract).
* **Degradation** — a fleet-wide ``CircuitBreaker`` around the learner:
  after ``threshold`` failures (exceptions / decision-deadline
  overruns) in a sliding outcome window, every decision degrades to
  the reactive heuristic until a half-open probe recovers. The service
  keeps answering; it never stalls on a sick learner.
* **Recovery** — decisions are journaled before they are applied, and
  a ``PreemptionGuard.trigger()`` drains gracefully: the in-flight
  batch finishes journaling, the rest of the round is abandoned. A
  restarted service rehydrates every tenant from its journal
  (``ChainLane.begin`` replays the logged prefix verbatim, no policy
  calls) and finishes with per-tenant schedules bit-identical to an
  uninterrupted run — no lost, no double-applied decisions.

``health()`` serves a readiness snapshot (queue depth, breaker state,
per-tenant lag) at any point. The ``serve_decisions`` tracked benchmark
(``benchmarks/bench_serve.py``) gates decisions/sec, p99 decision
latency and degraded-mode throughput via ``scripts/check_bench.py
serve``.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.control import (ChainLane, ChainResult, CircuitBreaker,
                                DecisionJournal, RetryPolicy)
from repro_torch.core.policy import FallbackPolicy, Policy, stack_obs
from repro_torch.core.provisioner import EnvConfig, ReplayCheckpointCache
from repro_torch.sim.trace import Job
from repro_torch.train.fault import PreemptionGuard
from .cosim import CoSimChainLane, CoSimWorld


@dataclasses.dataclass
class ServiceConfig:
    """Knobs of the multi-tenant serving loop."""
    tenants: int = 8
    links: int = 2                       # chain links per tenant
    max_batch: int = 32                  # act_batch fan-in per call
    max_queue: int = 256                 # admission-queue bound (requests)
    slo_s: Optional[float] = None        # per-decision SLO (None = no shed)
    decision_deadline_s: Optional[float] = None   # FallbackPolicy deadline
    breaker_window: int = 16
    breaker_threshold: int = 4
    breaker_cooldown_s: float = 5.0
    # co-simulation: all tenants' chains contend in ONE shared simulator
    # (repro.serve.cosim) instead of one fork each. Load shedding is
    # disabled in this mode — every awaiting tenant must decide before
    # the shared clock advances, so a wall-clock shed would leak
    # simulated time between tenants' decisions.
    co_sim: bool = False


@dataclasses.dataclass
class ServiceHealth:
    """Point-in-time readiness/health snapshot."""
    ready: bool
    draining: bool
    round: int
    tenants: int
    tenants_live: int
    queue_depth: int                     # live decision requests pending
    breaker_state: str
    max_lag_rounds: int                  # worst tenant: rounds since served
    n_decisions: int
    n_degraded: int
    n_shed: int


@dataclasses.dataclass
class ServiceResult:
    """Outcome of one ``ProvisionService.run``."""
    reason: str                          # "completed" | "drained" | "max_rounds"
    tenants: List[ChainResult]           # per-tenant chain outcomes
    n_rounds: int = 0
    n_batches: int = 0
    n_decisions: int = 0                 # live decisions applied this run
    n_replayed: int = 0                  # journal-rehydrated decisions
    n_degraded: int = 0                  # answered with the breaker open
    n_shed: int = 0
    breaker_trips: int = 0
    shed_per_tenant: List[int] = dataclasses.field(default_factory=list)
    latencies_s: List[float] = dataclasses.field(default_factory=list)

    def latency_quantile(self, q: float) -> float:
        if not self.latencies_s:
            return 0.0
        return float(np.quantile(np.asarray(self.latencies_s, np.float64), q))

    @property
    def p99_latency_s(self) -> float:
        return self.latency_quantile(0.99)


class ProvisionService:
    """N concurrent journaled tenant chains behind one batched policy.

    The loop is synchronous and deterministic in *simulated* outcomes:
    wall-clock (``clock``, injectable) only gates shedding, breaker
    cooldowns and latency accounting, never the applied-decision
    sequence. Per-tenant schedule identity across kill/restart follows
    from the lane contract — the journal is authoritative for the
    replayed prefix, and live decisions are a pure function of per-lane
    observations for every registry policy in evaluation mode.
    """

    def __init__(self, trace: Sequence[Job], cfg: EnvConfig, policy: Policy,
                 svc: Optional[ServiceConfig] = None, seed: int = 0,
                 journal_dir: Optional[str] = None,
                 cache: Optional[ReplayCheckpointCache] = None,
                 guard: Optional[PreemptionGuard] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 retry_factory: Optional[Callable[[int], RetryPolicy]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.svc = svc or ServiceConfig()
        self.seed = seed
        self.clock = clock
        self.cache = cache if cache is not None else ReplayCheckpointCache(
            trace, cfg.n_nodes, faults=cfg.faults)
        if journal_dir:
            os.makedirs(journal_dir, exist_ok=True)

        def _journal(i: int) -> Optional[DecisionJournal]:
            return (DecisionJournal(os.path.join(
                journal_dir, f"tenant_{i:05d}.journal"))
                if journal_dir else None)

        if self.svc.co_sim:
            self.cosim: Optional[CoSimWorld] = CoSimWorld(
                trace, cfg, self.svc.tenants, seed=seed, cache=self.cache)
            self.lanes: List[ChainLane] = [
                CoSimChainLane(trace, cfg, self.cosim, i,
                               links=self.svc.links, seed=seed + i,
                               journal=_journal(i),
                               retry=retry_factory(i) if retry_factory
                               else None, cache=self.cache)
                for i in range(self.svc.tenants)]
        else:
            self.cosim = None
            self.lanes = [
                ChainLane(trace, cfg, links=self.svc.links, seed=seed + i,
                          journal=_journal(i),
                          retry=retry_factory(i) if retry_factory else None,
                          cache=self.cache)
                for i in range(self.svc.tenants)]
        self.policy = (policy if isinstance(policy, FallbackPolicy)
                       else FallbackPolicy(
                           policy, deadline_s=self.svc.decision_deadline_s,
                           clock=clock))
        self.breaker = breaker or CircuitBreaker(
            window=self.svc.breaker_window,
            threshold=self.svc.breaker_threshold,
            cooldown_s=self.svc.breaker_cooldown_s, clock=clock)
        self.guard = guard or PreemptionGuard(install_signals=False)
        T = self.svc.tenants
        self.started = False
        self.n_rounds = 0
        self.n_batches = 0
        self.n_decisions = 0
        self.n_degraded = 0
        self.n_shed = 0
        self.shed_per_tenant = [0] * T
        self.retry_after_s = [0.0] * T   # last shed hint per tenant
        self._last_round = [0] * T
        self._arrival = [0.0] * T
        self._latencies: List[float] = []
        self._est_batch_s = 0.0          # EWMA act_batch wall cost

    # ------------------------------------------------------------- start
    def start(self, t_starts: Optional[Sequence[float]] = None) -> None:
        """Begin (or rehydrate) every tenant lane. With journals on disk
        this replays each tenant's logged decision prefix verbatim. In
        co-sim mode the tenants share one episode start — ``t_starts[0]``
        pins it (the rest are ignored); the journals replay together, in
        shared-round order."""
        if self.cosim is not None:
            t0 = (float(np.asarray(t_starts, np.float64).ravel()[0])
                  if t_starts is not None else None)
            self.cosim.begin(t_start=t0)
        else:
            for i, lane in enumerate(self.lanes):
                lane.begin(t_start=t_starts[i] if t_starts is not None
                           else None)
        self.started = True

    # --------------------------------------------------------- admission
    def _eta_s(self, position: int) -> float:
        """Projected wall time until the request at queue ``position``
        has its decision applied (whole batches ahead of it, plus its
        own), from the EWMA batch cost."""
        batches_ahead = position // self.svc.max_batch + 1
        return batches_ahead * self._est_batch_s

    def _admit(self, pending: List[int]) -> List[int]:
        """Bounded, deadline-aware admission: requests beyond the queue
        bound, or whose projected completion provably overruns the SLO,
        are shed with a retry-after hint. The head-of-line batch is
        always served — its latency is unavoidable and shedding it would
        livelock the service when one batch already costs more than the
        SLO — so every round makes progress."""
        admitted: List[int] = []
        now = self.clock()
        for i in pending:
            pos = len(admitted)
            eta = self._eta_s(pos)
            if pos >= self.svc.max_queue:
                self._shed(i, hint=eta)
            elif (self.svc.slo_s is not None and pos >= self.svc.max_batch
                    and eta > self.svc.slo_s):
                self._shed(i, hint=eta - self.svc.slo_s)
            else:
                admitted.append(i)
                self._arrival[i] = now
        return admitted

    def _shed(self, tenant: int, hint: float) -> None:
        self.n_shed += 1
        self.shed_per_tenant[tenant] += 1
        self.retry_after_s[tenant] = max(hint, self._est_batch_s)

    # ------------------------------------------------------------ serving
    @staticmethod
    def _reactive(obs: Dict) -> np.ndarray:
        return (np.asarray(obs["pred_remaining"]) <= 0.0).astype(np.int64)

    def _serve_chunk(self, chunk: List[int]) -> None:
        """One dynamic batch: stack the chunk's observations, answer via
        the breaker-gated policy, journal-then-apply each decision."""
        obs = stack_obs([self.lanes[i].obs for i in chunk])
        t0 = self.clock()
        if not self.breaker.allow():
            acts = self._reactive(obs)
            fell_back = True
            self.n_degraded += len(chunk)
        else:
            fb0 = self.policy.n_fallbacks
            acts = np.asarray(self.policy.act_batch(obs), np.int64)
            fell_back = self.policy.n_fallbacks > fb0
            self.breaker.record(not fell_back)
        dt = self.clock() - t0
        self._est_batch_s = (dt if self.n_batches == 0
                             else 0.8 * self._est_batch_s + 0.2 * dt)
        self.n_batches += 1
        for i, a in zip(chunk, acts):
            lane = self.lanes[i]
            lane.apply(int(a), fell_back=fell_back)
            self.n_decisions += 1
            self._last_round[i] = self.n_rounds
            self._latencies.append(self.clock() - self._arrival[i])

    def _round(self, live: List[int]) -> None:
        """One service round: admit, then serve the queue in batches.
        A drain request (``guard``) finishes the in-flight batch —
        journaling included — and abandons the rest of the round."""
        self.n_rounds += 1
        admitted = self._admit(live)
        for c0 in range(0, len(admitted), self.svc.max_batch):
            if c0 > 0 and self.guard.should_stop():
                break                            # graceful drain mid-round
            self._serve_chunk(admitted[c0:c0 + self.svc.max_batch])

    # ---------------------------------------------------------------- run
    def live_tenants(self) -> List[int]:
        return [i for i, lane in enumerate(self.lanes)
                if lane.needs_decision]

    def run(self, max_rounds: Optional[int] = None) -> ServiceResult:
        """Serve until every tenant chain completes, the guard drains the
        service, or ``max_rounds`` elapses."""
        if not self.started:
            self.start()
        if self.cosim is not None:
            return self._run_co(max_rounds)
        reason = "completed"
        while True:
            live = self.live_tenants()
            if not live:
                break
            if self.guard.should_stop():
                reason = "drained"
                break
            if max_rounds is not None and self.n_rounds >= max_rounds:
                reason = "max_rounds"
                break
            self._round(live)
        return self._result(reason)

    def _run_co(self, max_rounds: Optional[int]) -> ServiceResult:
        """Co-sim serving loop: serve every awaiting tenant (no shedding
        — the shared clock cannot advance past an undecided tenant), then
        close the shared round. A drain request finishes the in-flight
        batch, journaling included, and leaves the round un-advanced; the
        restarted service replays the partial round from the journals and
        serves the remainder at the identical round head."""
        reason = "completed"
        while True:
            live = self.live_tenants()
            if not live:
                break
            if self.guard.should_stop():
                reason = "drained"
                break
            if max_rounds is not None and self.n_rounds >= max_rounds:
                reason = "max_rounds"
                break
            self.n_rounds += 1
            awaiting = [i for i in live if self.lanes[i].awaiting]
            if awaiting:
                now = self.clock()
                for i in awaiting:
                    self._arrival[i] = now
                interrupted = False
                for c0 in range(0, len(awaiting), self.svc.max_batch):
                    if c0 > 0 and self.guard.should_stop():
                        interrupted = True   # graceful drain mid-round
                        break
                    self._serve_chunk(awaiting[c0:c0 + self.svc.max_batch])
                if interrupted:
                    continue                 # round stays un-advanced
            self.cosim.advance_round()
        return self._result(reason)

    def _result(self, reason: str) -> ServiceResult:
        tenants = [lane.result("completed" if lane.done else reason)
                   for lane in self.lanes]
        return ServiceResult(
            reason=reason, tenants=tenants, n_rounds=self.n_rounds,
            n_batches=self.n_batches, n_decisions=self.n_decisions,
            n_replayed=sum(lane.n_replayed for lane in self.lanes),
            n_degraded=self.n_degraded, n_shed=self.n_shed,
            breaker_trips=self.breaker.n_trips,
            shed_per_tenant=list(self.shed_per_tenant),
            latencies_s=list(self._latencies))

    # ------------------------------------------------------------- health
    def health(self) -> ServiceHealth:
        live = self.live_tenants() if self.started else []
        lags = [self.n_rounds - self._last_round[i] for i in live]
        return ServiceHealth(
            ready=self.started and not self.guard.should_stop(),
            draining=self.guard.should_stop(),
            round=self.n_rounds,
            tenants=self.svc.tenants,
            tenants_live=len(live),
            queue_depth=len(live),
            breaker_state=self.breaker.state,
            max_lag_rounds=max(lags) if lags else 0,
            n_decisions=self.n_decisions,
            n_degraded=self.n_degraded,
            n_shed=self.n_shed)
