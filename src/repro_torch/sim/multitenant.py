"""Cross-tenant co-simulation: N tenant chains contending in ONE simulator.

The single-tenant engines fork a private ``SlurmSimulator`` per chain:
every tenant sees the same background backlog but never each other's
chain jobs, so multi-tenant layers above (the provisioning service, the
vector envs) measure coordination overhead without ever simulating
*contention*. ``MultiTenantSim`` closes that gap: one shared simulator,
N tenant slots, with

* **injection** — per-tenant chain jobs submitted into the shared
  backlog (tenant ``t`` draws its chain ids inside a disjoint
  ``TENANT_ID_STRIDE`` band, so chain jobs can never collide with each
  other or with background ids);
* **observation** — per-tenant lanes carved out of the existing CSR
  ``sample_batch`` flats (``sample_tenant_batch``): the shared queue /
  running populations are gathered once per simulator and tiled per
  tenant, so every tenant observes the full contended state — including
  the other tenants' chain jobs — at zero marginal gather cost;
* **attribution** — per-tenant reward/interruption accounting: queue
  waits belong to the tenant whose link is pending, and fault/requeue
  counters are attributed to the tenant *owning* the killed job via the
  simulator's fault-kill observer (``set_kill_observer``), instead of
  the fleet-aggregated ``n_node_failures``/``n_requeues`` totals.

Round protocol (driven by the callers — ``repro.core.cotenant`` for the
batched env, the co-sim ``ProvisionService`` mode for serving):

1. every undecided tenant requests submit/wait (``request_submit``);
2. ``flush_submits`` injects the requested successors in ascending
   submit-instant order (the shared clock only moves forward);
3. the caller advances the shared clock one lockstep interval — or,
   when every live tenant is pending, ``fast_forward`` runs each
   pending successor to its start;
4. ``resolve_ready`` scores tenants whose successor started, with the
   exact float expressions of the single-tenant episode engine — with
   one tenant, the request/flush/fast-forward/resolve sequence reduces
   operation-for-operation to ``ProvisionEnv._submit_successor``, which
   is what pins the N=1 co-sim bit-identity contract.

Determinism: given the per-tenant decision sequences, the shared
schedule is a pure function of (trace, fault plan, tenant chains) —
submissions are flushed in a canonical order and the event engine is
deterministic, so journal replays reproduce the shared schedule exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .simulator import SampleBatch, SlurmSimulator, sample_batch
from .trace import Job
from .workload import SubJobChain, pair_outcome

#: tenant ``t`` draws chain job ids in [t*STRIDE + 10**6, t*STRIDE + 10**7):
#: disjoint across tenants, far above background trace ids, and tenant 0's
#: band equals the single-tenant draw — N=1 stays bit-identical.
TENANT_ID_STRIDE = 10 ** 7

#: width of the per-tenant fleet-pressure observation block
FLEET_DIM = 8

#: fleet-size normalizer (the co-sim bench pushes toward 10^4 tenants)
_FLEET_SCALE = float(np.log1p(10_000.0))


@dataclasses.dataclass
class TenantOutcome:
    """One resolved predecessor/successor pair, attributed to a tenant."""
    tenant: int
    kind: str                 # "interrupt" | "overlap"
    amount_s: float
    wait_s: float             # successor queue wait (this tenant's link)
    forced: bool
    n_faults: int             # fault events that killed >=1 owned job
    n_requeues: int           # owned-job requeues (since the link began)
    pred: Job = None
    succ: Job = None


def make_tenant_chain(tenant: int, rng: np.random.Generator,
                      n_nodes: int, sub_limit: float) -> SubJobChain:
    """Draw tenant ``tenant``'s chain with the single-tenant rng protocol
    (user_id then next_id — the same two draws, in the same order, as
    ``ProvisionEnv._begin_episode``), then lift the id into the tenant's
    disjoint band. Tenant 0 is the identity lift."""
    user_id = int(rng.integers(1000, 2000))
    next_id = int(rng.integers(10 ** 6, 10 ** 7))
    return SubJobChain(user_id=user_id, n_nodes=n_nodes,
                       sub_limit=sub_limit,
                       next_id=next_id + tenant * TENANT_ID_STRIDE)


class MultiTenantSim:
    """N tenant chains co-simulated inside one shared ``SlurmSimulator``.

    Holds the per-tenant slots (chain, predecessor, pending successor,
    link cursor, owned fault/requeue counters) and the canonical
    submit/advance/resolve machinery; the shared simulator is advanced
    only through this object's round protocol, so the callers above
    (vector env, co-sim service) cannot skip each other's decision
    points. Attribution is wired at construction: the simulator's
    fault-kill observer maps every killed job id back to its owning
    tenant (background kills are nobody's — they stay fleet-only).
    """

    def __init__(self, sim: SlurmSimulator, tenants: int):
        assert tenants >= 1
        self.sim = sim
        self.tenants = tenants
        self.chains: List[Optional[SubJobChain]] = [None] * tenants
        self.preds: List[Optional[Job]] = [None] * tenants
        self.succs: List[Optional[Job]] = [None] * tenants
        self.link = np.ones(tenants, np.int64)       # next sub index
        self.pending = np.zeros(tenants, bool)       # succ submitted, not started
        self.forced = np.zeros(tenants, bool)
        self.done = np.zeros(tenants, bool)
        # owned-job attribution (satellite of the co-sim contract): a
        # fault event increments fault_counts[t] once per tenant it hit
        # and requeue_counts[t] once per owned job it requeued
        self.fault_counts = np.zeros(tenants, np.int64)
        self.requeue_counts = np.zeros(tenants, np.int64)
        self._fc0 = np.zeros((tenants, 2), np.int64)  # per-link baselines
        self._owner: Dict[int, int] = {}              # job_id -> tenant
        self._req: List[Tuple[float, int]] = []       # (t_sub, tenant)
        sim.set_kill_observer(self._on_fault_kills)

    # ------------------------------------------------------- attribution
    def _on_fault_kills(self, job_ids: np.ndarray) -> None:
        """One fault event's requeued job ids -> owned counters."""
        hit = set()
        for jid in job_ids.tolist():
            t = self._owner.get(int(jid))
            if t is not None:
                self.requeue_counts[t] += 1
                hit.add(t)
        for t in hit:
            self.fault_counts[t] += 1

    def counters(self, tenant: int) -> Tuple[int, int]:
        """Owned (fault_events, requeues) attributed to ``tenant`` since
        its current link began."""
        f0, rq0 = self._fc0[tenant]
        return (int(self.fault_counts[tenant] - f0),
                int(self.requeue_counts[tenant] - rq0))

    # --------------------------------------------------------- injection
    def submit_pred(self, tenant: int, chain: SubJobChain) -> Job:
        """Inject tenant ``tenant``'s predecessor into the shared backlog
        at the current instant (contends with background and every other
        tenant from here on)."""
        self.chains[tenant] = chain
        pred = chain.make_sub(0, self.sim.now)
        self.preds[tenant] = pred
        self._owner[pred.job_id] = tenant
        self.sim.submit(pred)
        return pred

    def start_preds(self) -> None:
        """Run each tenant's predecessor to its start, in tenant order,
        then baseline that tenant's owned counters (the decision window
        opens at the own-pred start, as in the single-tenant engine)."""
        for t in range(self.tenants):
            self.sim.run_until_started(self.preds[t])
            self._fc0[t, 0] = self.fault_counts[t]
            self._fc0[t, 1] = self.requeue_counts[t]

    # ----------------------------------------------------- round protocol
    def pred_end(self, tenant: int) -> float:
        """The predecessor's projected end (inf while fault-killed and
        still queued — it cannot force a reactive submission)."""
        pred = self.preds[tenant]
        if pred.start_time < 0:
            return float("inf")
        return pred.start_time + min(pred.runtime, pred.time_limit)

    def request_submit(self, tenant: int, forced: bool) -> None:
        """Queue tenant ``tenant``'s successor submission for this round.
        The submit instant is the single-tenant expression evaluated at
        the round head: now for a voluntary submit, the predecessor's end
        for a forced (reactive-fallback) one."""
        pred = self.preds[tenant]
        started = pred.start_time >= 0
        pe = self.pred_end(tenant)
        t_sub = max(self.sim.now, pe if forced and started
                    else self.sim.now)
        self.forced[tenant] = forced
        self._req.append((t_sub, tenant))

    def flush_submits(self, submit: Optional[
            Callable[[int, SlurmSimulator, Job], None]] = None) -> None:
        """Inject this round's requested successors in ascending submit-
        instant order (ties broken by tenant — the order requests were
        filed), advancing the shared clock monotonically to each instant.
        ``submit(tenant, sim, job)`` overrides the injection call so the
        service can route it through a tenant's retried control plane."""
        if not self._req:
            return
        self._req.sort(key=lambda r: r[0])           # stable: tenant order ties
        for t_sub, t in self._req:
            self.sim.run_until(t_sub)
            succ = self.chains[t].make_sub(int(self.link[t]), t_sub)
            self.succs[t] = succ
            self._owner[succ.job_id] = t
            if submit is None:
                self.sim.submit(succ)
            else:
                submit(t, self.sim, succ)
            self.pending[t] = True
        self._req = []

    def run_until(self, t: float) -> None:
        """Advance the shared clock (all tenants observe the same events)."""
        self.sim.run_until(t)

    def fast_forward(self) -> None:
        """No tenant is waiting on a decision: run each pending successor
        to its start, in tenant order. With one tenant this is exactly
        the single-tenant ``run_until_started`` call a scalar submission
        performs — the N=1 identity hinges on it."""
        for t in range(self.tenants):
            if self.pending[t]:
                self.sim.run_until_started(self.succs[t])

    def resolve_ready(self) -> List[TenantOutcome]:
        """Score every pending tenant whose successor has started, with
        the single-tenant engine's float expressions: backfill the
        predecessor's end, classify the pair, attribute the wait and the
        owned fault/requeue counters to this tenant."""
        out: List[TenantOutcome] = []
        for t in range(self.tenants):
            if not self.pending[t]:
                continue
            succ = self.succs[t]
            if succ.start_time < 0:
                continue
            pred = self.preds[t]
            if pred.end_time < 0:
                if pred.start_time >= 0:
                    # the predecessor (original or fault-requeued restart)
                    # runs to its limit from its current start
                    pred.end_time = pred.start_time + min(pred.runtime,
                                                          pred.time_limit)
                else:
                    # killed and still queued when the successor went in
                    pred.end_time = succ.submit_time
            kind, amount = pair_outcome(pred, succ)
            wait = float(succ.start_time - succ.submit_time)
            nf, nr = self.counters(t)
            out.append(TenantOutcome(
                tenant=t, kind=kind, amount_s=amount, wait_s=wait,
                forced=bool(self.forced[t]), n_faults=nf, n_requeues=nr,
                pred=pred, succ=succ))
            self.pending[t] = False
        return out

    def roll(self, tenant: int) -> None:
        """The chain rolls forward: the resolved successor becomes the
        next link's predecessor and the owned-counter window reopens."""
        self.preds[tenant] = self.succs[tenant]
        self.succs[tenant] = None
        self.link[tenant] += 1
        self._fc0[tenant, 0] = self.fault_counts[tenant]
        self._fc0[tenant, 1] = self.requeue_counts[tenant]

    def finish(self, tenant: int) -> None:
        self.done[tenant] = True

    @property
    def waiting(self) -> np.ndarray:
        """Tenants still deciding this round (not done, not pending)."""
        return ~self.done & ~self.pending

    # ------------------------------------------------------- observation
    def fleet_features(self, out: Optional[np.ndarray] = None) -> np.ndarray:
        """(tenants, FLEET_DIM) float32 tenant-population summary block:
        what a fleet-aware policy sees beyond its own lane. Columns:
        log-scaled tenant count, live/pending/done fractions, the
        tenant's own queued/running chain nodes over the cluster size,
        and its own pending / pred-started flags."""
        T = self.tenants
        if out is None:
            out = np.zeros((T, FLEET_DIM), np.float32)
        n_nodes = float(self.sim.cluster.n_nodes)
        live = ~self.done
        out[:, 0] = np.float32(np.log1p(float(T)) / _FLEET_SCALE)
        out[:, 1] = np.float32(float(live.sum()) / T)
        out[:, 2] = np.float32(float(self.pending.sum()) / T)
        out[:, 3] = np.float32(float(self.done.sum()) / T)
        for t in range(self.tenants):
            qn = rn = 0.0
            pred, succ = self.preds[t], self.succs[t]
            for job in (pred, succ):
                if job is None:
                    continue
                if job.start_time < 0:
                    qn += job.n_nodes
                elif job.end_time < 0 or job.end_time > self.sim.now:
                    rn += job.n_nodes
            out[t, 4] = np.float32(qn / n_nodes)
            out[t, 5] = np.float32(rn / n_nodes)
        out[:, 6] = self.pending.astype(np.float32)
        out[:, 7] = np.fromiter(
            (1.0 if self.preds[t] is not None
             and self.preds[t].start_time >= 0 else 0.0
             for t in range(T)), np.float32, T)
        return out


# ----------------------------------------------------- tiled CSR sampling
def _tile_segments(off: np.ndarray, reps: np.ndarray) -> np.ndarray:
    """Gather indices that repeat CSR segment ``g`` (``off[g]:off[g+1]``)
    ``reps[g]`` times, concatenated in group order."""
    parts = [np.tile(np.arange(off[g], off[g + 1], dtype=np.int64),
                     int(reps[g]))
             for g in range(reps.size)]
    if not parts:
        return np.empty(0, np.int64)
    return np.concatenate(parts)


def sample_tenant_batch(worlds: Sequence[MultiTenantSim],
                        reps: Optional[np.ndarray] = None) -> SampleBatch:
    """Carve per-tenant observation lanes out of the shared CSR flats.

    Each world's shared simulator is gathered ONCE (``sample_batch`` on
    the distinct simulators), then its queue/running segment is tiled
    ``tenants`` times: lane ``g*T + t`` is a bit-exact copy of group
    ``g``'s shared gather — every tenant observes the full contended
    populations, including the other tenants' chain jobs. Per-tenant
    differentiation happens downstream (predecessor columns and the
    fleet block), not in the shared flats. ``reps`` overrides the lane
    count per world (0 drops a world — used for row subsets). With one
    lane per world the result equals ``sample_batch([w.sim for w in
    worlds])`` exactly.
    """
    base = sample_batch([w.sim for w in worlds])
    if reps is None:
        reps = np.fromiter((w.tenants for w in worlds), np.int64,
                           len(worlds))
    else:
        reps = np.asarray(reps, np.int64)
        assert reps.size == len(worlds)
    if (reps == 1).all():
        return base
    B = int(reps.sum())
    q_count = np.repeat(base.q_count, reps)
    r_count = np.repeat(base.r_count, reps)
    q_off = np.zeros(B + 1, np.int64)
    r_off = np.zeros(B + 1, np.int64)
    np.cumsum(q_count, out=q_off[1:])
    np.cumsum(r_count, out=r_off[1:])
    qi = _tile_segments(base.q_off, reps)
    ri = _tile_segments(base.r_off, reps)
    return SampleBatch(
        times=np.repeat(base.times, reps),
        q_count=q_count, q_off=q_off,
        q_sizes=base.q_sizes[qi], q_ages=base.q_ages[qi],
        q_limits=base.q_limits[qi],
        r_count=r_count, r_off=r_off,
        r_sizes=base.r_sizes[ri], r_elapsed=base.r_elapsed[ri],
        r_limits=base.r_limits[ri])
