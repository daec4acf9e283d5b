"""Co-simulation mode for the provisioning service: N journaled tenant
lanes sharing ONE simulator.

The classic service forks a private simulator per ``ChainLane``; here a
``CoSimWorld`` owns one ``repro.sim.multitenant.MultiTenantSim`` and the
lanes become ``CoSimChainLane``s — same journals, same control planes,
same policy batching, but every tenant's chain jobs contend in the same
backlog. The simulated clock advances in shared *rounds*:

1. every lane awaiting a decision (live, not pending) is served and its
   decision journaled-then-applied — submit decisions are *deferred*
   into the world's request queue, wait decisions are no-ops until the
   round advances;
2. ``advance_round`` flushes the requested submissions in canonical
   (submit-instant, tenant) order through each tenant's retried control
   plane, advances the shared clock one lockstep interval (or
   fast-forwards every pending successor to its start when no lane is
   waiting), resolves the started successors into per-link outcomes, and
   refreshes the waiting lanes' observation windows.

Determinism contract: the shared schedule is a pure function of
``(trace, fault plan, cfg, seed, links, tenants, t0)`` plus the applied
per-round decision sequences. Journal records carry their round index
(``"r"``) and the header pins ``(co, t0)`` alongside the lane config, so
a killed service rehydrates by replaying the journals *in shared-round
order* against a rebuilt world: full rounds re-advance, a partial round
(crash mid-round) leaves the remaining lanes to be served live at the
same round head — the final per-tenant schedules are bit-identical to an
uninterrupted run. Load shedding is disabled in this mode: every
awaiting lane must decide before the shared clock moves, or simulated
time would leak between tenants' decisions.

Attribution: fault/requeue counters come from the world's owned-job
accounting (the simulator's fault-kill observer), never the
fleet-aggregated simulator totals — a background job dying on a shared
cluster is nobody's interruption.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.control import (JOURNAL_VERSION, ChainLane, ChainResult,
                                DecisionJournal, JournalCorruptionError,
                                RetryPolicy)
from repro_torch.core.provisioner import EnvConfig, ReplayCheckpointCache
from repro_torch.core.reward import shape_reward
from repro_torch.core.state import StateHistory
from repro_torch.sim.multitenant import (MultiTenantSim, TenantOutcome,
                                   make_tenant_chain)
from repro_torch.sim.simulator import SlurmSimulator
from repro_torch.sim.trace import Job


class CoSimChainLane(ChainLane):
    """A ``ChainLane`` whose simulator is shared with every other tenant.

    Keeps the lane contract (journal-then-apply, re-entrant state,
    per-tenant control plane and seeds) but delegates all simulated-time
    movement to the ``CoSimWorld`` round protocol: ``_apply`` only files
    submit requests / marks the round decided, and link outcomes arrive
    via ``_finish_link`` when the shared clock crosses the successor's
    start. ``begin`` is driven by ``CoSimWorld.begin`` (the journals of
    all tenants must replay together, in shared-round order).
    """

    def __init__(self, trace: Sequence[Job], cfg: EnvConfig,
                 cosim: "CoSimWorld", tenant: int, links: int = 3,
                 seed: int = 0, journal: Optional[DecisionJournal] = None,
                 retry: Optional[RetryPolicy] = None,
                 cache: Optional[ReplayCheckpointCache] = None):
        super().__init__(trace, cfg, links=links, seed=seed,
                         journal=journal, retry=retry, cache=cache)
        self.cosim = cosim
        self.tenant = tenant
        self.round_applied = -1      # last world round this lane decided
        self._ctrl0 = (0, 0)         # ctrl counters at the live submit
        cosim._register(self)

    # ------------------------------------------------------------ journal
    def _check_header(self, replayed):
        if not replayed:
            return []
        hdr = replayed[0]
        if (hdr.get("v") != JOURNAL_VERSION or hdr.get("seed") != self.seed
                or hdr.get("links") != self.links
                or hdr.get("co") != self.cosim.tenants
                or hdr.get("t0") != self.cosim.t0):
            raise ValueError(
                f"journal header {hdr} does not match co-sim lane config "
                f"(seed={self.seed}, links={self.links}, "
                f"co={self.cosim.tenants}, t0={self.cosim.t0})")
        return replayed[1:]

    def _header(self) -> dict:
        return {"v": JOURNAL_VERSION, "seed": self.seed,
                "links": self.links, "co": self.cosim.tenants,
                "t0": self.cosim.t0}

    # ----------------------------------------------------------- stepping
    def begin(self, t_start: Optional[float] = None) -> None:
        raise RuntimeError(
            "co-sim lanes begin together through CoSimWorld.begin() — "
            "their journals replay in shared-round order")

    def _reset_state(self) -> None:
        """Fresh lane state over the shared simulator (world ``begin``)."""
        env = self.env
        env.hist = StateHistory(env.cfg.history)
        env.pred = env.succ = env.chain = None
        self.obs = None
        self.done = False
        self.link = 1
        self.outcomes = []
        self.n_decisions = self.n_replayed = self.n_fallbacks = 0
        self._di = 0
        self._seen = {}
        self.round_applied = -1
        self._ctrl0 = (0, 0)

    @property
    def awaiting(self) -> bool:
        """Live, successor not in flight, and not yet decided this round."""
        return (not self.done
                and not bool(self.cosim.world.pending[self.tenant])
                and self.round_applied < self.cosim.round)

    def apply(self, action: int, fell_back: bool = False) -> None:
        """Journal one live decision (tagged with the shared round), then
        apply it — deferred into the world's round protocol."""
        assert self.awaiting
        if self.journal:
            self.journal.append({"i": self._di, "a": int(action),
                                 "fb": bool(fell_back),
                                 "r": self.cosim.round})
        self._apply(int(action), bool(fell_back))

    def _apply(self, action: int, fell_back: bool) -> None:
        self._di += 1
        self.n_decisions += 1
        self.n_fallbacks += int(fell_back)
        env = self.env
        forced = (action == 0
                  and env.sim.now + env.cfg.interval >= self._pred_end())
        if action == 1 or forced:
            # deferred: the world flushes all of this round's submissions
            # in canonical order when the round advances
            self.cosim.world.request_submit(self.tenant, forced)
        self.round_applied = self.cosim.round

    def _finish_link(self, out: TenantOutcome) -> None:
        """The shared clock crossed this lane's successor start: score the
        link (same info shape as the solo ``_submit_link``) and roll the
        chain forward."""
        env = self.env
        r = shape_reward(out.kind, out.amount_s, env.cfg.reward)
        info = {"link": self.link, "kind": out.kind,
                "amount_s": out.amount_s, "wait_s": out.wait_s,
                "forced": out.forced, "reward": r,
                "pred_id": out.pred.job_id, "succ_id": out.succ.job_id,
                "n_retries": self.ctrl.n_retries - self._ctrl0[0],
                "n_ctrl_errors": self.ctrl.n_errors - self._ctrl0[1],
                "n_faults": out.n_faults, "n_requeues": out.n_requeues}
        self._seen[out.pred.job_id] = (out.pred.start_time,
                                       out.pred.end_time)
        self.outcomes.append(info)
        env.pred = out.succ
        env.succ = None
        self.cosim.world.roll(self.tenant)
        self.link += 1
        if self.link > self.links:
            self.done = True
            self.cosim.world.finish(self.tenant)

    def result(self, reason: str) -> ChainResult:
        res = super().result(reason)
        w = self.cosim.world
        # owned attribution: fault events that killed this tenant's jobs,
        # and this tenant's requeues — never the fleet totals
        res.n_faults = int(w.fault_counts[self.tenant])
        res.n_requeues = int(w.requeue_counts[self.tenant])
        return res


class CoSimWorld:
    """Shared-simulator coordinator for a fleet of ``CoSimChainLane``s.

    Owns the ``MultiTenantSim``, the shared episode start (``t0``, drawn
    once from the world seed or pinned by the caller), the round counter,
    and the begin/rehydrate/advance machinery. Lanes register at
    construction in tenant order.
    """

    def __init__(self, trace: Sequence[Job], cfg: EnvConfig, tenants: int,
                 seed: int = 0,
                 cache: Optional[ReplayCheckpointCache] = None):
        assert tenants >= 1
        self.trace = trace
        self.cfg = cfg
        self.tenants = tenants
        self.seed = seed
        self.cache = cache if cache is not None else ReplayCheckpointCache(
            trace, cfg.n_nodes, faults=cfg.faults)
        self.rng = np.random.default_rng(seed)
        self.lanes: List[CoSimChainLane] = []
        self.world: Optional[MultiTenantSim] = None
        self.round = 0
        self.t0: Optional[float] = None

    def _register(self, lane: CoSimChainLane) -> None:
        assert lane.tenant == len(self.lanes) < self.tenants
        self.lanes.append(lane)

    # -------------------------------------------------------------- begin
    def begin(self, t_start: Optional[float] = None) -> None:
        """Build (or rebuild) the shared world and rehydrate every lane
        from its journal, replaying the logged decisions in shared-round
        order. Restarts re-draw the identical ``t0`` (seeded), and the
        journal headers pin it — a mismatched rebuild is an error, never
        silent divergence."""
        assert len(self.lanes) == self.tenants
        lo, hi = self.lanes[0].env._t_start_range
        self.t0 = (float(t_start) if t_start is not None
                   else float(self.rng.uniform(lo, hi)))
        bodies: List[List[dict]] = []
        for lane in self.lanes:
            records = lane.journal.replay() if lane.journal else []
            bodies.append(lane._check_header(records))
            if lane.journal and not records:
                lane.journal.append(lane._header())
        self.round = 0
        cfg = self.cfg
        wp = max(self.t0 - cfg.history * cfg.interval, 0.0)
        sim = self.cache.fork_at(wp)
        self.world = MultiTenantSim(sim, self.tenants)
        for lane in self.lanes:
            lane._reset_state()
            lane.env.sim = sim
        # warm up: the scalar push sequence (snapshot at the window head,
        # one per interval crossing) — tenants share every snapshot until
        # their predecessors differentiate the lanes
        self._push_shared()
        while sim.now + cfg.interval <= self.t0:
            sim.step(cfg.interval)
            self._push_shared()
        if sim.now < self.t0:
            sim.step(self.t0 - sim.now)
        # inject + start the predecessors, in tenant order
        for lane in self.lanes:
            chain = make_tenant_chain(lane.tenant, lane.env.rng,
                                      cfg.chain_nodes, cfg.sub_limit)
            lane.env.chain = chain
            lane.env.pred = self.world.submit_pred(lane.tenant, chain)
        self.world.start_preds()
        for lane in self.lanes:
            lane.env.hist.push(lane.env._snapshot())
            lane.obs = lane.env.obs()
        self._rehydrate(bodies)

    def _push_shared(self) -> None:
        """One warm-up history push into every lane's ring: no lane has a
        predecessor yet, so the snapshot is shared (``push`` copies)."""
        vec = self.lanes[0].env._snapshot()
        for lane in self.lanes:
            lane.env.hist.push(vec)

    # ---------------------------------------------------------- rehydrate
    def _rehydrate(self, bodies: List[List[dict]]) -> None:
        """Round-ordered journal replay over the rebuilt world. Each
        iteration applies every awaiting lane's next record at the
        current round, then advances; records running out mid-round (a
        crash between a round's batches) stop the replay with the round
        partially decided — the live loop serves the remainder at the
        same round head, where the observations are unchanged."""
        cursors = [0] * self.tenants
        while True:
            awaiting = [lane for lane in self.lanes if lane.awaiting]
            if not awaiting:
                if all(lane.done for lane in self.lanes):
                    return
                # every live lane is pending or already decided: the
                # advance is decision-free, hence journal-free — re-run it
                self.advance_round()
                continue
            have = [lane for lane in awaiting
                    if cursors[lane.tenant] < len(bodies[lane.tenant])]
            for lane in have:
                rec = bodies[lane.tenant][cursors[lane.tenant]]
                cursors[lane.tenant] += 1
                if int(rec.get("r", -1)) != self.round:
                    raise JournalCorruptionError(
                        f"{lane.journal.path}: record round "
                        f"{rec.get('r')} != world round {self.round} — "
                        "co-sim journals must replay in shared-round "
                        "order")
                lane.n_replayed += 1
                lane._apply(int(rec["a"]), bool(rec["fb"]))
            if len(have) < len(awaiting):
                return
        # (unreachable)

    # ------------------------------------------------------------ advance
    def _ctrl_submit(self, tenant: int, sim: SlurmSimulator,
                     job: Job) -> None:
        lane = self.lanes[tenant]
        lane._ctrl0 = (lane.ctrl.n_retries, lane.ctrl.n_errors)
        lane.ctrl.submit(sim, job)

    def advance_round(self) -> None:
        """Close the current round: flush this round's submissions (each
        through its tenant's retried control plane), advance the shared
        clock one interval — or fast-forward every pending successor to
        its start when no lane is waiting — resolve the started
        successors, and refresh the waiting lanes' windows."""
        w = self.world
        sim = w.sim
        round_t0 = sim.now
        w.flush_submits(submit=self._ctrl_submit)
        waiting = w.waiting.copy()
        if waiting.any():
            w.run_until(round_t0 + self.cfg.interval)
        else:
            w.fast_forward()
        for out in w.resolve_ready():
            self.lanes[out.tenant]._finish_link(out)
        self.round += 1
        for t in np.flatnonzero(waiting):
            lane = self.lanes[int(t)]
            if not lane.done:
                lane.env.hist.push(lane.env._snapshot())
        for lane in self.lanes:
            if not lane.done and not w.pending[lane.tenant]:
                lane.obs = lane.env.obs()
