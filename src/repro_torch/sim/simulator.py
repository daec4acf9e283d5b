"""Low-overhead Slurm simulator (§5.2): multifactor priority + EASY backfill.

Two modes sharing one scheduling core:

* ``fast``  (default) — event-driven: the schedule is re-evaluated only when
  something can change (submission, completion). This is the simulator the
  RL agent trains against (paper: ~1 simulated month / wall-clock minute —
  ours is far under that, see benchmarks/bench_simulator.py).
* ``exact`` — polls the scheduler on a fixed interval with age-recomputed
  priorities, mimicking production Slurm's sched/backfill cycle (the role
  the "standard Slurm simulator" [3,44] plays in the paper's fidelity
  study). benchmarks/bench_simulator.py reproduces the §5.2 comparison:
  makespan diff <2.5%, JCT geomean diff <15%, 3-26x overhead.

The scheduling core is a structure-of-arrays engine: per-job submit /
runtime / limit / nodes / start / end live in numpy arrays, priorities are
computed and ordered with vectorized argsort, and the EASY-backfill
reservation scan is a cumulative sum over running jobs' limit-ends. `Job`
dataclasses exist only at the API boundary (``load``/``submit``/
``finished``); start/end times are written back to them as they happen.

The array layout also makes episode forking cheap: ``fork()`` snapshots
the whole scheduler state with a handful of numpy copies, which is what
``repro.core.VectorProvisionEnv`` uses to share one background-trace
warm-up across a batch of RL episodes.

API (§5.1): ``submit()``, ``step()``, ``sample()`` + ``run_until`` /
``run_to_completion`` / ``run_until_started`` conveniences.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.analysis import cow as _cow
from .cluster import Cluster
from .faults import FaultPlan
from .trace import Job

# multifactor priority weights (slurm.conf-style)
AGE_WEIGHT = 1000.0
AGE_MAX = 7 * 24 * 3600.0
SIZE_WEIGHT = 100.0

_INF = float("inf")
_EMPTY_I = np.empty(0, np.int64)


@dataclasses.dataclass(frozen=True)
class ScheduleView:
    """Read-only snapshot view of a simulator's per-job schedule arrays.

    Served by ``SlurmSimulator.schedule_view()`` — the one supported
    cross-module read of schedule state (the ``BackgroundTimeline``
    builder and the checkpoint cache's sizing are its consumers). All
    arrays are length-``n`` truncated views with ``writeable=False``;
    index ``i`` is the simulator's internal job index (``ids[i]`` maps
    back to the external ``job_id``).
    """
    n: int                   # registered jobs
    now: float               # simulated time of the snapshot
    sub: np.ndarray          # (n,) submit times
    runtime: np.ndarray      # (n,) actual runtimes
    limit: np.ndarray        # (n,) wall-clock limits
    nodes: np.ndarray        # (n,) node counts (int64)
    ids: np.ndarray          # (n,) external job ids (int64)
    start: np.ndarray        # (n,) start times (-1 = not started)
    end: np.ndarray          # (n,) end times (-1 = not finished)


class SlurmSimulator:
    def __init__(self, n_nodes: int, mode: str = "fast",
                 sched_interval: float = 300.0, backfill: bool = True,
                 faults: Optional[FaultPlan] = None):
        assert mode in ("fast", "exact")
        self.cluster = Cluster(n_nodes)
        self.mode = mode
        self.sched_interval = sched_interval
        self.backfill = backfill
        self.now = 0.0
        self._next_sched = 0.0
        self._sched_passes = 0
        # fault schedule (immutable, shareable across forks); the empty
        # plan takes no branch the fault-free engine wouldn't
        self._faults = faults
        self._has_faults = faults is not None and len(faults) > 0
        self._fault_ptr = 0
        # next fault instant, maintained as a scalar so the fault-free hot
        # loop pays one attribute read (inf), not a method call per event
        self._nf = float(faults.times[0]) if self._has_faults else _INF
        self.n_node_failures = 0
        self.n_requeues = 0
        self.lost_node_s = 0.0
        # fault-kill observer: called once per fault event with the
        # external job_ids it requeued (attribution hook; see
        # set_kill_observer). Never inherited by forks.
        self._kill_obs = None
        # --- structure-of-arrays job store -------------------------------
        cap = 64
        self._cap = cap
        self._n = 0
        self._sub = np.zeros(cap, np.float64)      # submit time
        self._rt = np.zeros(cap, np.float64)       # actual runtime
        self._lim = np.zeros(cap, np.float64)      # wall-clock limit
        self._nn = np.zeros(cap, np.int64)   # node count
        self._ids = np.zeros(cap, np.int64)  # external job_id (tie-break)
        self._start = np.full(cap, -1.0, np.float64)
        self._end = np.full(cap, -1.0, np.float64)
        self._jobs: List[Job] = []           # aligned Job refs (API boundary)
        self._by_id: Dict[int, int] = {}     # job_id -> index (last wins)
        # pending arrivals: sorted by time (stable); _arr_ptr = next arrival
        self._arr_t = np.empty(0, np.float64)
        self._arr_i = _EMPTY_I
        self._arr_ptr = 0
        # queue of waiting job indices (priority order as of last schedule)
        self._q = _EMPTY_I
        # running set (parallel arrays, compacted on completion)
        self._run_i = np.zeros(cap, np.int64)
        self._run_end = np.zeros(cap, np.float64)
        self._run_n = 0
        self._next_comp = _INF               # cached min over _run_end
        # finished job indices, completion order
        self._fin: List[int] = []
        self._makespan = 0.0
        # forked sims only write Job attrs for jobs submitted post-fork
        self._forked = False
        self._tracked: set = set()
        # job-store arrays shared copy-on-write with the fork parent
        # (unshared on first _register)
        self._shared_store = False
        # no-op scheduling cache: after a pass that starts nothing, the
        # blocking state (free nodes, head, reservation, priority-order
        # validity horizon) lets later passes skip the full sort/backfill
        # scan when provably nothing could start (see _schedule)
        self._noop_free = -1
        self._noop_qlen = 0
        self._noop_head = -1
        self._noop_shadow = _INF
        self._noop_spare = 0
        self._noop_horizon = -_INF
        # optional scheduling-pass recorder (repro.sim.timeline attaches
        # one while building the immutable background timeline)
        self._pass_rec = None

    # ------------------------------------------------------------- loading
    def _unshare(self) -> None:
        """First registration on a fork: take private copies of the
        job-store arrays/containers shared copy-on-write by ``fork()``.
        Entries the parent added after the fork (index >= our _n) are
        pruned — they belong to the parent's timeline."""
        n = self._n
        self._sub = self._sub.copy()
        self._rt = self._rt.copy()
        self._lim = self._lim.copy()
        self._nn = self._nn.copy()
        self._ids = self._ids.copy()
        prune = len(self._jobs) > n      # parent registered past our fork
        self._jobs = list(self._jobs[:n])
        self._by_id = ({k: v for k, v in self._by_id.items() if v < n}
                       if prune else dict(self._by_id))
        self._shared_store = False

    def _register(self, job: Job) -> int:
        if self._shared_store:
            self._unshare()
        i = self._n
        if i == self._cap:
            self._grow(max(2 * self._cap, i + 1))
        self._sub[i] = job.submit_time
        self._rt[i] = job.runtime
        self._lim[i] = job.time_limit
        self._nn[i] = job.n_nodes
        self._ids[i] = job.job_id
        self._start[i] = -1.0
        self._end[i] = -1.0
        self._jobs.append(job)
        self._by_id[int(job.job_id)] = i
        self._n = i + 1
        return i

    def _grow(self, cap: int) -> None:
        def pad(a, fill=0.0):
            out = np.full(cap, fill, a.dtype)
            out[:len(a)] = a
            return out
        self._sub, self._rt, self._lim = (pad(self._sub), pad(self._rt),
                                          pad(self._lim))
        self._nn, self._ids = pad(self._nn), pad(self._ids)
        self._start, self._end = pad(self._start, -1.0), pad(self._end, -1.0)
        self._cap = cap

    def load(self, jobs: Sequence[Job]) -> None:
        """Register a batch of future arrivals (typically the whole trace)."""
        idx = np.array([self._register(j) for j in jobs], np.int64)
        t = self._sub[idx]
        # merge with any not-yet-processed arrivals; stable sort keeps
        # equal-time arrivals in insertion order (heap-seq semantics)
        pend_t = np.concatenate([self._arr_t[self._arr_ptr:], t])
        pend_i = np.concatenate([self._arr_i[self._arr_ptr:], idx])
        order = np.argsort(pend_t, kind="stable")
        self._arr_t, self._arr_i, self._arr_ptr = (pend_t[order],
                                                   pend_i[order], 0)

    # ------------------------------------------------------------ user API
    def submit(self, job: Job) -> None:
        """Submit a job at the current simulation time."""
        job.submit_time = max(job.submit_time, self.now)
        i = self._register(job)
        self._tracked.add(i)
        # insert after any equal-time arrivals (matches event-seq order)
        pos = int(np.searchsorted(self._arr_t[self._arr_ptr:],
                                  job.submit_time, side="right"))
        self._arr_t = np.insert(self._arr_t[self._arr_ptr:], pos,
                                job.submit_time)
        self._arr_i = np.insert(self._arr_i[self._arr_ptr:], pos, i)
        self._arr_ptr = 0

    def step(self, dt: float) -> None:
        """Advance simulated time by dt, processing all events."""
        self.run_until(self.now + dt)

    def sample(self) -> Dict:
        """Snapshot of queue and server state (the provisioner's raw input)."""
        q = self._q
        r = self._run_i[:self._run_n]
        return {
            "time": self.now,
            "n_queued": int(q.size),
            "queued_sizes": self._nn[q],
            "queued_ages": self.now - self._sub[q],
            "queued_limits": self._lim[q],
            "n_running": int(self._run_n),
            "running_sizes": self._nn[r],
            "running_elapsed": self.now - self._start[r],
            "running_limits": self._lim[r],
            "n_free_nodes": self.cluster.n_free,
            "utilization": self.cluster.utilization(),
        }

    # ---------------------------------------------------------- event loop
    def _next_arrival(self) -> float:
        return (self._arr_t[self._arr_ptr] if self._arr_ptr < self._arr_t.size
                else _INF)

    def _next_completion(self) -> float:
        return self._next_comp

    def _next_fault(self) -> float:
        return self._nf

    def _next_event_time(self) -> float:
        return min(self._next_arrival(), self._next_completion(), self._nf)

    def _queue_prio(self, idx: np.ndarray) -> np.ndarray:
        """Multifactor priority (age + size) at the current instant.

        In-place evaluation of
        ``AGE_WEIGHT * min((now - sub) / AGE_MAX, 1) + SIZE_WEIGHT * nn / nav``
        — elementwise op order is unchanged, so results stay bit-exact."""
        cl = self.cluster
        nav = max(cl.n_nodes - cl.down_nodes, 1)
        a = self.now - self._sub[idx]
        a /= AGE_MAX
        np.minimum(a, 1.0, out=a)
        a *= AGE_WEIGHT
        b = SIZE_WEIGHT * self._nn[idx]
        b /= nav
        a += b
        return a

    def _prio_one(self, h: int, nav: int) -> float:
        """Scalar ``_queue_prio`` for a single index: identical IEEE
        double operations without the array round-trip."""
        return (AGE_WEIGHT * min((self.now - float(self._sub[h])) / AGE_MAX,
                                 1.0)
                + SIZE_WEIGHT * float(self._nn[h]) / nav)

    def _absorb_events(self, t: float) -> None:
        """Process every arrival/completion with time <= t (no scheduling)."""
        # arrivals -> queue (append; order fixed by the next schedule pass)
        p = self._arr_ptr
        e = int(self._arr_t.searchsorted(t, side="right"))
        if e > p:
            self._q = np.concatenate([self._q, self._arr_i[p:e]])
            self._arr_ptr = e
        # completions -> release nodes
        rn = self._run_n
        if rn and self._next_comp <= t:
            self._noop_free = -1             # free nodes change
            ends = self._run_end[:rn]
            done = ends <= t
            ids = self._run_i[:rn][done]
            self.cluster.release_n(int(self._nn[ids].sum()))
            # _run_end mirrors _end for running ids: same max, one gather.
            # Copied before the in-place compaction below clobbers `ends`.
            mk = float(ends[done].max())
            keep = ~done
            nk = int(keep.sum())
            self._run_i[:nk] = self._run_i[:rn][keep]
            self._run_end[:nk] = ends[keep]
            self._run_n = nk
            self._next_comp = (float(self._run_end[:nk].min()) if nk
                               else _INF)
            self._fin.extend(ids.tolist())
            if mk > self._makespan:
                self._makespan = mk
        # faults last: a job ending exactly at the fault instant completes
        # rather than being killed, and kills see post-completion capacity
        if self._nf <= t:
            self._apply_faults(t)

    # ---------------------------------------------------------- fault path
    def _apply_faults(self, t: float) -> None:
        """Apply every fault event with time <= t, in plan order.

        Failure: ``nodes`` leave service; if the running allocation no
        longer fits the shrunk capacity, jobs are killed newest-start-
        first (ties: higher index first — deterministic) and requeued.
        Repair: the nodes return and the next scheduling pass can place
        work on them. Every event invalidates the no-op scheduling cache:
        capacity — and with it both fit tests and the size-priority
        normalizer — changed."""
        F = self._faults
        p = self._fault_ptr
        cl = self.cluster
        while p < len(F) and F.times[p] <= t:
            m = int(F.nodes[p])
            if int(F.kinds[p]) == 0:                    # failure
                cl.down_nodes += m
                self.n_node_failures += 1
                deficit = -cl.n_free
                rn = self._run_n
                if deficit > 0 and rn:
                    run = self._run_i[:rn]
                    order = np.lexsort((-run, -self._start[run]))
                    csum = np.cumsum(self._nn[run[order]])
                    k = min(int(np.searchsorted(csum, deficit, "left")) + 1,
                            rn)
                    victims = run[order[:k]]            # fancy index: copy
                    self._kill(victims, requeue=True, charge_lost=True)
            else:                                       # repair
                cl.down_nodes = max(cl.down_nodes - m, 0)
            self._noop_free = -1
            p += 1
        self._fault_ptr = p
        self._nf = float(F.times[p]) if p < len(F) else _INF

    def _kill(self, ids: np.ndarray, requeue: bool,
              charge_lost: bool) -> None:
        """Remove running jobs ``ids`` at the current instant: release
        their nodes, reset start/end (eagerly-copied arrays — CoW-safe),
        and optionally requeue them Slurm-style. Requeued jobs keep their
        original submit time, so their age priority survives the kill."""
        rn = self._run_n
        keep = ~np.isin(self._run_i[:rn], ids)
        nk = int(keep.sum())
        self._run_i[:nk] = self._run_i[:rn][keep]
        self._run_end[:nk] = self._run_end[:rn][keep]
        self._run_n = nk
        self._next_comp = float(self._run_end[:nk].min()) if nk else _INF
        self.cluster.release_n(int(self._nn[ids].sum()))
        if charge_lost:
            self.lost_node_s += float(((self.now - self._start[ids])
                                       * self._nn[ids]).sum())
        self._start[ids] = -1.0
        self._end[ids] = -1.0
        if requeue:
            self._q = np.concatenate([self._q, ids])    # wholesale: CoW-safe
            self.n_requeues += int(ids.size)
            if self._kill_obs is not None:
                # attribution boundary: external ids of the jobs this
                # fault event requeued (cancel() never notifies)
                self._kill_obs(self._ids[ids])
        # boundary write-back (same ownership rule as _start_batch)
        jobs, tracked = self._jobs, self._tracked
        for i in ids.tolist():
            if not self._forked or i in tracked:
                j = jobs[i]
                j.start_time = -1.0
                j.end_time = -1.0
        self._noop_free = -1               # free nodes / queue changed

    def set_kill_observer(self, obs) -> None:
        """Register the fault-kill observer: ``obs(job_ids)`` fires once
        per fault event with the int64 array of external job_ids that
        event requeued. One observer per simulator (last wins; ``None``
        clears); forks start with no observer — a fork is a new world and
        must opt in again. Intentional ``cancel()`` never notifies: the
        hook exists to attribute *failures* to the tenant owning the
        killed job (``repro.sim.multitenant``), not to count teardowns.
        """
        self._kill_obs = obs

    def cancel(self, job_id: int) -> bool:
        """Best-effort cancel: drop the job from the queue or pending
        arrivals, or kill it if running (no requeue, no loss charged —
        cancellation is intentional). Returns False when the job is not
        live on this simulator (unknown index, or already finished)."""
        idx = self._by_id.get(int(job_id))
        if idx is None or idx >= self._n:
            return False
        pos = np.flatnonzero(self._q == idx)
        if pos.size:
            self._q = np.delete(self._q, pos)           # wholesale: CoW-safe
            self._noop_free = -1           # cached head/qlen may be stale
            return True
        ap = self._arr_ptr
        keep = self._arr_i[ap:] != idx
        if not keep.all():
            self._arr_t = self._arr_t[ap:][keep]
            self._arr_i = self._arr_i[ap:][keep]
            self._arr_ptr = 0
            return True
        if (self._run_i[:self._run_n] == idx).any():
            self._kill(np.array([idx], np.int64), requeue=False,
                       charge_lost=False)
            return True
        return False

    def run_until(self, t: float, _stop_idx: Optional[int] = None) -> None:
        """Advance to time t, processing events (and polls in exact mode).

        Monotonic: a target in the past is clamped to the current time, so
        simulated time never moves backward. With ``_stop_idx`` the loop
        returns as soon as that job starts (time rests at the start
        event), or — in fast mode — as soon as the event horizon empties,
        since nothing could start it anymore.
        """
        t = max(t, self.now)
        exact = self.mode == "exact"
        arr_t = self._arr_t
        arr_size = arr_t.size
        while True:
            # inlined _next_event_time: this loop body runs once per event
            p = self._arr_ptr
            tn = min(arr_t[p] if p < arr_size else _INF,
                     self._next_comp, self._nf)
            if exact and self._next_sched <= t and self._next_sched < tn:
                self.now = self._next_sched
                self._schedule()
                self._next_sched += self.sched_interval
                if _stop_idx is not None and self._start[_stop_idx] >= 0:
                    return
                continue
            if tn > t:
                break
            if _stop_idx is not None and tn == _INF and not exact:
                return
            # arrival-run fast-forward: absorb a whole run of arrivals up
            # to the next completion/fault (or t) in one event when none
            # of them could change the schedule — trivially true with
            # zero free nodes (every per-arrival pass would early-out),
            # and provable via the cached blocking state otherwise (each
            # pending arrival checked at its own submit instant). The
            # jump is bounded by the next fault event so capacity changes
            # are never skipped (with no faults the bound is +inf — the
            # fault-free math is untouched).
            if (not exact and self._next_comp > tn and self._nf > tn):
                free = self.cluster.n_free
                tj = min(self._next_comp, self._nf, t)
                if free == 0:
                    tn = tj
                elif self._noop_free == free:
                    if self._noop_horizon is None:
                        self._compute_noop_horizon()
                    if tj < self._noop_horizon:
                        p = self._arr_ptr
                        e = int(np.searchsorted(self._arr_t, tj,
                                                side="right"))
                        if e > p and self._noop_arrivals_blocked(
                                self._arr_i[p:e], self._arr_t[p:e], free):
                            tn = tj
            self.now = tn
            self._absorb_events(tn)
            if not exact:
                self._schedule()
            if _stop_idx is not None and self._start[_stop_idx] >= 0:
                return
        self.now = t

    def run_to_completion(self) -> None:
        """Drain every pending event; leaves nothing in flight.

        Jobs that can never start (e.g. oversized requests) are left in the
        queue rather than spinning forever: once no events remain and a
        scheduling pass makes no progress, the remainder is unstartable.
        """
        while True:
            tn = self._next_event_time()
            if tn < _INF:
                self.run_until(tn)
                continue
            if not self._q.size or self.mode == "fast":
                break
            # exact mode: queued jobs wait for the next scheduling poll
            nq = self._q.size
            self.run_until(max(self._next_sched,
                               self.now + self.sched_interval))
            if self._next_event_time() == _INF and self._q.size == nq:
                break        # poll made no progress and nothing will change

    def run_until_started(self, job: Job, hard_limit: float = 400 * 24 * 3600.0
                          ) -> float:
        """Advance until `job` starts; returns its queue wait time.

        One bounded ``run_until`` with a start-stop flag: the event loop
        advances monotonically through events/polls and halts at the event
        that starts the job, so it always terminates — either the job
        starts or ``hard_limit`` of simulated time elapses (returns inf,
        with ``now`` advanced, never spinning in place).
        """
        idx = self._by_id.get(int(job.job_id))
        if idx is not None and idx >= self._n:
            idx = None      # registered on the CoW parent after our fork
        if idx is None:
            return job.wait_time if job.start_time >= 0 else float("inf")
        if self._start[idx] < 0:
            self.run_until(self.now + hard_limit, _stop_idx=idx)
        if self._start[idx] >= 0:
            return float(self._start[idx] - self._sub[idx])
        return float("inf")

    # ------------------------------------------------------------ scheduler
    def _start_batch(self, ids: np.ndarray) -> None:
        self._noop_free = -1                 # free nodes / running set change
        total = int(self._nn[ids].sum())
        if total > self.cluster.n_free:
            raise RuntimeError(f"allocation overflow: want {total}, "
                               f"free {self.cluster.n_free}")
        self.cluster.allocate_n(total)
        now = self.now
        if ids.size == 1:
            # scalar fast path for the common one-job start: identical
            # IEEE arithmetic, no array temporaries
            i0 = int(ids[0])
            rt, lm = self._rt[i0], self._lim[i0]
            end = float(now + (rt if rt < lm else lm))
            self._start[i0] = now
            self._end[i0] = end
            rn = self._run_n
            if rn + 1 > self._run_i.size:
                cap = max(2 * self._run_i.size, rn + 1)
                self._run_i = np.resize(self._run_i, cap)
                self._run_end = np.resize(self._run_end, cap)
            self._run_i[rn] = i0
            self._run_end[rn] = end
            self._run_n = rn + 1
            if end < self._next_comp:
                self._next_comp = end
            if not self._forked or i0 in self._tracked:
                j = self._jobs[i0]
                j.start_time = now
                j.end_time = end
            return
        ends = now + np.minimum(self._rt[ids], self._lim[ids])
        self._start[ids] = now
        self._end[ids] = ends
        rn = self._run_n
        need = rn + ids.size
        if need > self._run_i.size:
            cap = max(2 * self._run_i.size, need)
            self._run_i = np.resize(self._run_i, cap)
            self._run_end = np.resize(self._run_end, cap)
        self._run_i[rn:need] = ids
        self._run_end[rn:need] = ends
        self._run_n = need
        mn = float(ends.min())
        if mn < self._next_comp:
            self._next_comp = mn
        # write back to the boundary Job objects (forked sims only touch
        # jobs submitted after the fork -- shared trace refs stay pristine)
        jobs, tracked = self._jobs, self._tracked
        if not self._forked:
            for k, i in enumerate(ids):
                j = jobs[int(i)]
                j.start_time = now
                j.end_time = float(ends[k])
        elif tracked:
            for k, i in enumerate(ids):
                i = int(i)
                if i in tracked:
                    j = jobs[i]
                    j.start_time = now
                    j.end_time = float(ends[k])

    def _noop_still_blocked(self, new: np.ndarray, free: int) -> bool:
        """True iff the queued-since-the-cached-pass arrivals provably
        cannot start now nor change the cached head/reservation: none
        backfills under the cached shadow/spare, and none sorts above the
        cached head. Old entries were all rejected with the same free/
        shadow/spare (their ends_ok can only degrade as time advances),
        so the whole pass would start nothing."""
        if not new.size:
            return True
        nn = self._nn[new]
        fits = nn <= free
        if fits.any():
            if (self.now + self._lim[new[fits]] <= self._noop_shadow).any():
                return False
            if (nn[fits] <= self._noop_spare).any():
                return False
        h = self._noop_head
        cl = self.cluster
        nav = max(cl.n_nodes - cl.down_nodes, 1)
        prio_h = self._prio_one(h, nav)
        prio_n = self._queue_prio(new)
        if (prio_n > prio_h).any():
            return False
        eq = prio_n == prio_h
        if eq.any():
            s, i = self._sub[new[eq]], self._ids[new[eq]]
            if ((s < self._sub[h])
                    | ((s == self._sub[h]) & (i < self._ids[h]))).any():
                return False
        if self.now - self._sub[h] >= AGE_MAX:
            # saturated head: the (unsaturated) newcomers keep aging, so
            # tighten the horizon to their earliest possible overtake
            tx = (self._sub[new] + AGE_MAX
                  + (SIZE_WEIGHT * AGE_MAX / (AGE_WEIGHT * nav))
                  * (self._nn[h] - nn))
            self._noop_horizon = min(self._noop_horizon, float(tx.min()))
        return True

    def _record_noop(self, q: np.ndarray, free: int, shadow_time: float,
                     spare: int) -> None:
        """Cache the blocking state after a pass that started nothing.

        Valid until free nodes change (completion/start) or the priority
        ORDER against the head can change; the order-validity horizon is
        computed lazily on the first probe (many records are invalidated
        by the next completion without ever being probed)."""
        self._noop_free = free
        self._noop_qlen = int(q.size)
        self._noop_head = int(q[0])
        self._noop_shadow = shadow_time
        self._noop_spare = int(spare)
        self._noop_horizon = None

    def _compute_noop_horizon(self) -> None:
        """Earliest instant the cached priority order could change:
        pairwise priority gaps are constant in time except across the
        7-day age cap, so the bound is the earliest queued-job saturation
        — and, under an already-saturated head, the earliest instant an
        aging job could overtake the frozen head priority."""
        q = self._q[:self._noop_qlen]
        h = self._noop_head
        sub_q = self._sub[q]
        unsat = self.now - sub_q < AGE_MAX
        horizon = float(sub_q[unsat].min() + AGE_MAX) if unsat.any() else _INF
        if self.now - self._sub[h] >= AGE_MAX and unsat.any():
            cl = self.cluster
            nav = max(cl.n_nodes - cl.down_nodes, 1)
            tx = (sub_q[unsat] + AGE_MAX
                  + (SIZE_WEIGHT * AGE_MAX / (AGE_WEIGHT * nav))
                  * (self._nn[h] - self._nn[q][unsat]))
            horizon = min(horizon, float(tx.min()))
        self._noop_horizon = horizon

    def _noop_arrivals_blocked(self, idx: np.ndarray, times: np.ndarray,
                               free: int) -> bool:
        """Pending-arrival variant of ``_noop_still_blocked``: each future
        arrival is checked at its own submit instant (age zero, its own
        ends_ok), with the head priority taken at the current — earliest —
        time, which is conservative since the head only ages upward."""
        nn = self._nn[idx]
        fits = nn <= free
        if fits.any():
            if (times[fits] + self._lim[idx[fits]] <= self._noop_shadow).any():
                return False
            if (nn[fits] <= self._noop_spare).any():
                return False
        h = self._noop_head
        cl = self.cluster
        nav = max(cl.n_nodes - cl.down_nodes, 1)
        prio_h = self._prio_one(h, nav)
        if (SIZE_WEIGHT * nn / nav > prio_h).any():
            return False
        if self.now - self._sub[h] >= AGE_MAX:
            # under a saturated (frozen-priority) head the arrivals keep
            # aging toward an overtake; if the earliest possible overtake
            # falls inside the batched window itself, a sequential pass
            # at a later arrival could behave differently — bail out to
            # per-event processing instead of committing the jump
            tx = (times + AGE_MAX
                  + (SIZE_WEIGHT * AGE_MAX / (AGE_WEIGHT * nav))
                  * (self._nn[h] - nn))
            earliest = float(tx.min())
            if earliest <= float(times[-1]):
                return False
            self._noop_horizon = min(self._noop_horizon, earliest)
        return True

    def _schedule(self) -> None:
        """Priority order + EASY backfill with one head-of-line reservation."""
        self._sched_passes += 1
        rec = self._pass_rec
        q = self._q
        if not q.size:
            if rec is not None:
                rec.empty(self)
            return
        # nothing can start with zero free nodes; the queue order is
        # recomputed on every pass, so skipping the sort here is safe
        cl = self.cluster
        free = cl.n_nodes - cl.down_nodes - cl._busy      # n_free, inlined
        if free == 0:
            if rec is not None:
                rec.free0(self)
            return
        # no-op fast path: same free nodes, priority order still valid,
        # and no newcomer can start or displace the cached head
        if self._noop_free == free and q.size >= self._noop_qlen:
            if self._noop_horizon is None:
                self._compute_noop_horizon()
            if (self.now < self._noop_horizon
                    and self._noop_still_blocked(q[self._noop_qlen:], free)):
                self._noop_qlen = q.size
                return
        self._noop_free = -1
        free_entry = free
        # vectorized multifactor priority, ordered by (-prio, submit, id)
        key = self._queue_prio(q)
        np.negative(key, out=key)
        q = q[np.lexsort((self._ids[q], self._sub[q], key))]
        # start in priority order until the head doesn't fit
        nn_q = self._nn[q]
        csum = nn_q.cumsum()
        k = int(csum.searchsorted(free, side="right"))
        prefix = q[:k] if k else _EMPTY_I
        if k:
            self._start_batch(prefix)
            q = q[k:]
            nn_q = nn_q[k:]
        if not q.size:
            self._q = q
            if rec is not None:
                rec.full(self, free_entry, prefix, _EMPTY_I, -1,
                         self.cluster.n_free, _INF, 0)
            return
        if not self.backfill:
            self._q = q
            # blocked head, no backfill: arrivals can only start by
            # outranking-and-fitting, which the noop check covers
            self._record_noop(q, self.cluster.n_free, -_INF, -1)
            if rec is not None:
                rec.full(self, free_entry, prefix, _EMPTY_I, int(q[0]),
                         self.cluster.n_free, -_INF, -1)
            return
        free = cl.n_nodes - cl.down_nodes - cl._busy      # post-prefix free
        if free == 0:
            # the priority prefix consumed every node: no backfill and
            # nothing to cache (the free==0 exits above handle probes)
            self._q = q
            if rec is not None:
                rec.full(self, free_entry, prefix, _EMPTY_I, int(q[0]),
                         0, -_INF, -1)
            return
        cand = q[1:]
        n = nn_q[1:]
        if not cand.size or not (n <= free).any():
            # nothing can backfill regardless of the reservation; record
            # with an open shadow so any fitting arrival forces a full pass
            self._q = q
            self._record_noop(q, free, _INF, 0)
            if rec is not None:
                rec.full(self, free_entry, prefix, _EMPTY_I, int(q[0]),
                         free, _INF, 0)
            return
        # reservation for the blocked head based on running jobs' LIMITS
        head_n = int(nn_q[0])
        rn = self._run_n
        run = self._run_i[:rn]
        run_nn = self._nn[run]
        order = np.lexsort((run_nn, self._start[run] + self._lim[run]))
        avail = free + run_nn[order].cumsum()
        pos = int(avail.searchsorted(head_n, side="left"))
        if pos < rn:
            r = run[order[pos]]
            shadow_time = float(self._start[r] + self._lim[r])
            spare = int(avail[pos]) - head_n
        else:
            shadow_time = _INF
            spare = 0
        # backfill the rest: must fit now AND not delay the reservation.
        # A job is charged against the head's spare nodes only if it can
        # outlive the reservation; jobs ending by shadow_time are free.
        # The sequential scan only visits candidates that pass the
        # vectorized fit/time pre-filter, and stops once nodes run out.
        ends_ok = self.now + self._lim[cand] <= shadow_time
        viable = ((n <= free) & (ends_ok | (n <= spare))).nonzero()[0]
        if not viable.size:
            self._q = q
            self._record_noop(q, free, shadow_time, spare)
            if rec is not None:
                rec.full(self, free_entry, prefix, _EMPTY_I, int(q[0]),
                         free, shadow_time, spare)
            return
        free_bf, spare_bf = free, spare
        started_mask = np.zeros(cand.size, bool)
        for k in viable:
            nk = int(n[k])
            if nk > free:
                continue
            if ends_ok[k]:
                started_mask[k] = True
                free -= nk
            elif nk <= spare:
                started_mask[k] = True
                free -= nk
                spare -= nk
            if free == 0:
                break
        if started_mask.any():
            self._start_batch(cand[started_mask])
            self._q = np.concatenate([q[:1], cand[~started_mask]])
            if rec is not None:
                rec.full(self, free_entry, prefix, cand[started_mask],
                         int(q[0]), free_bf, shadow_time, spare_bf)
        else:
            self._q = q
            self._record_noop(q, free, shadow_time, spare)
            if rec is not None:
                rec.full(self, free_entry, prefix, _EMPTY_I, int(q[0]),
                         free, shadow_time, spare)

    # --------------------------------------------------- boundary views
    def schedule_view(self) -> "ScheduleView":
        """Documented read-only view of the per-job schedule arrays.

        The returned arrays are truncated to the registered-job count and
        marked non-writeable (the underlying SoA buffers stay private to
        the simulator — this is the CoW sanitizer's freeze applied at the
        API boundary, unconditionally). This is the ONLY supported
        cross-module read of the schedule state; external pokes at
        ``_sub``/``_start``/... are deprecated (see ``fork_nbytes`` for
        the checkpoint-cache sizing that used to read privates).
        """
        n = self._n
        view = ScheduleView(
            n=n, now=self.now,
            sub=self._sub[:n], runtime=self._rt[:n], limit=self._lim[:n],
            nodes=self._nn[:n], ids=self._ids[:n],
            start=self._start[:n], end=self._end[:n])
        for a in (view.sub, view.runtime, view.limit, view.nodes,
                  view.ids, view.start, view.end):
            a.flags.writeable = False
        return view

    def fork_nbytes(self) -> int:
        """Marginal memory of one ``fork()`` of this simulator: the state
        copied eagerly (start/end, running arrays, finished list) — the
        job-store arrays are shared copy-on-write and amortize across all
        forks of one base."""
        return (self._start.nbytes + self._end.nbytes + self._run_i.nbytes
                + self._run_end.nbytes + 8 * len(self._fin) + 2048)

    # ------------------------------------------- differential adoption
    def adopt_running(self, job: Job, start_time: float, pass_pos: int,
                      pass_size: int) -> None:
        """Graft ``job`` into the running set as if the scheduling pass at
        ``start_time`` (== ``now``) had started it at position
        ``pass_pos`` of its ``pass_size`` starts.

        Used by the differential episode engine after it proves, against
        the immutable background timeline, that the injected job starts at
        exactly this instant without perturbing any background decision:
        the background fork already holds the pass's other
        ``pass_size - 1`` starts at the tail of the running arrays, so the
        job is registered and spliced in at the slot the real interleaved
        pass would have given it (running-array order is observable via
        ``sample()``'s elapsed/size vectors). ``job.submit_time`` is
        preserved un-clamped — its queue-age history predates this fork.
        """
        i = self._register(job)
        self._tracked.add(i)
        end = start_time + min(job.runtime, job.time_limit)
        self._start[i] = start_time
        self._end[i] = end
        rn = self._run_n
        need = rn + 1
        if need > self._run_i.size:
            cap = max(2 * self._run_i.size, need)
            self._run_i = np.resize(self._run_i, cap)
            self._run_end = np.resize(self._run_end, cap)
        slot = rn - (pass_size - 1) + pass_pos
        assert 0 <= slot <= rn, (slot, rn, pass_pos, pass_size)
        self._run_i[slot + 1:need] = self._run_i[slot:rn].copy()
        self._run_end[slot + 1:need] = self._run_end[slot:rn].copy()
        self._run_i[slot] = i
        self._run_end[slot] = end
        self._run_n = need
        self.cluster.allocate_n(job.n_nodes)
        if end < self._next_comp:
            self._next_comp = end
        job.start_time = start_time
        job.end_time = end
        self._noop_free = -1

    def adopt_queued(self, job: Job, run_pass: bool = False) -> None:
        """Graft ``job`` into the wait queue with its original (possibly
        past) submit time — unlike ``submit()`` there is no clamp to
        ``now``, so the job's accumulated age priority survives the
        adoption. With ``run_pass`` a scheduling pass runs immediately,
        reproducing the pass the job's own submission event would have
        triggered (the differential engine's cascade path at the episode
        start instant)."""
        i = self._register(job)
        self._tracked.add(i)
        self._q = np.concatenate([self._q, np.array([i], np.int64)])
        self._noop_free = -1
        if run_pass:
            self._schedule()

    def _job_view(self, i: int) -> Job:
        j = self._jobs[i]
        if self._forked and i not in self._tracked:
            # shared trace ref: materialize a copy with this lane's truth
            return dataclasses.replace(j, start_time=float(self._start[i]),
                                       end_time=float(self._end[i]))
        return j

    @property
    def queue(self) -> List[Job]:
        return [self._job_view(int(i)) for i in self._q]

    @property
    def running(self) -> Dict[int, Job]:
        r = self._run_i[:self._run_n]
        return {int(self._ids[i]): self._job_view(int(i)) for i in r}

    @property
    def finished(self) -> List[Job]:
        return [self._job_view(i) for i in self._fin]

    @property
    def _events(self) -> Tuple[float, ...]:
        """Pending-event view (kept for test/driver compatibility)."""
        t = self._next_event_time()
        return () if t == _INF else (t,)

    # ------------------------------------------------------------- forking
    def fork(self) -> "SlurmSimulator":
        """Snapshot of the full scheduler state, mostly copy-on-write.

        Eagerly copied: only what mutates in place as the fork runs —
        ``_start``/``_end`` (written per job start), the running-set
        arrays, the finished list, and the cluster counter. Shared with
        the parent: the job-store arrays (``_sub``/``_rt``/``_lim``/
        ``_nn``/``_ids``, written only at index >= _n by ``_register``,
        which unshares first), ``_jobs``/``_by_id`` (same), and
        ``_arr_t``/``_arr_i``/``_q``, which are only ever replaced
        wholesale, never written in place.

        The fork shares the loaded Job objects read-only: their
        start/end attributes are no longer written by the fork (views
        materialize copies instead), so many forks of one base simulator
        can diverge without corrupting each other. Jobs submitted to the
        fork after the split are tracked and written back as usual.
        """
        s = SlurmSimulator.__new__(SlurmSimulator)
        s.cluster = Cluster(self.cluster.n_nodes, self.cluster.down_nodes)
        s.cluster.allocate_n(self.cluster.n_busy)
        s.mode = self.mode
        s.sched_interval = self.sched_interval
        s.backfill = self.backfill
        s.now = self.now
        s._next_sched = self._next_sched
        s._sched_passes = self._sched_passes
        s._cap = self._cap
        s._n = self._n
        for name in ("_sub", "_rt", "_lim", "_nn", "_ids",
                     "_arr_t", "_arr_i", "_q"):
            setattr(s, name, getattr(self, name))
        s._shared_store = True
        s._start = self._start.copy()
        s._end = self._end.copy()
        s._jobs = self._jobs
        s._by_id = self._by_id
        s._arr_ptr = self._arr_ptr
        s._run_i = self._run_i.copy()
        s._run_end = self._run_end.copy()
        s._run_n = self._run_n
        s._next_comp = self._next_comp
        s._fin = list(self._fin)
        s._makespan = self._makespan
        # fault schedule: the plan is immutable and shared; only the
        # cursor and counters are per-simulator state
        s._faults = self._faults
        s._has_faults = self._has_faults
        s._fault_ptr = self._fault_ptr
        s._nf = self._nf
        s.n_node_failures = self.n_node_failures
        s.n_requeues = self.n_requeues
        s.lost_node_s = self.lost_node_s
        s._kill_obs = None          # observers never follow a fork
        s._forked = True
        s._tracked = set()
        # the no-op scheduling cache references queue layout; start the
        # fork invalidated (one extra full pass, provably same decisions)
        s._noop_free = -1
        s._noop_qlen = 0
        s._noop_head = -1
        s._noop_shadow = _INF
        s._noop_spare = 0
        s._noop_horizon = -_INF
        s._pass_rec = None          # recorders never follow a fork
        if _cow.enabled():
            # CoW aliasing sanitizer: freeze the shared arrays (both
            # endpoints alias the same objects) so any in-place mutation
            # of fork-shared state raises at the write site, and put the
            # parent on the same copy-on-write footing — its next
            # _register copies instead of writing through the snapshot.
            _cow.freeze_shared(s)
            self._shared_store = True
        return s

    # ------------------------------------------------------------ metrics
    def makespan(self) -> float:
        return self._makespan

    def jcts(self) -> np.ndarray:
        f = np.fromiter(self._fin, np.int64, len(self._fin))
        return self._end[f] - self._sub[f]

    def waits(self) -> np.ndarray:
        f = np.fromiter(self._fin, np.int64, len(self._fin))
        return self._start[f] - self._sub[f]

    @property
    def sched_passes(self) -> int:
        return self._sched_passes


def replay(jobs: Sequence[Job], n_nodes: int, mode: str = "fast",
           **kw) -> SlurmSimulator:
    """Convenience: load a trace and run it to completion."""
    sim = SlurmSimulator(n_nodes, mode=mode, **kw)
    sim.load([dataclasses.replace(j) for j in jobs])
    sim.run_to_completion()
    return sim


# -------------------------------------------------------- batched sampling
@dataclasses.dataclass
class SampleBatch:
    """Flat-layout snapshot of B simulators (the vector-env hot path).

    Ragged per-lane populations are concatenated into flat float64 arrays
    with CSR-style offsets: lane ``b``'s queued sizes are
    ``q_sizes[q_off[b]:q_off[b + 1]]``, in the simulator's queue order
    (likewise the running set, in running-array order). Values match
    ``SlurmSimulator.sample()`` exactly — same gathers off the SoA
    arrays, minus the per-lane dict materialization.
    """
    times: np.ndarray        # (B,)   current simulated time per lane
    q_count: np.ndarray      # (B,)   int64 queued-job counts
    q_off: np.ndarray        # (B+1,) int64 offsets into the q_* flats
    q_sizes: np.ndarray      # (Nq,)  float64 node counts
    q_ages: np.ndarray       # (Nq,)  float64 now - submit
    q_limits: np.ndarray     # (Nq,)  float64 wall-clock limits
    r_count: np.ndarray      # (B,)   int64 running-job counts
    r_off: np.ndarray        # (B+1,) int64 offsets into the r_* flats
    r_sizes: np.ndarray      # (Nr,)  float64 node counts
    r_elapsed: np.ndarray    # (Nr,)  float64 now - start
    r_limits: np.ndarray     # (Nr,)  float64 wall-clock limits

    @property
    def batch(self) -> int:
        return self.times.size


def sample_batch(sims: Sequence[SlurmSimulator]) -> SampleBatch:
    """Gather B simulators' queue/running populations into one flat layout.

    One pair of preallocated flats per field; per lane the fill is a
    handful of vectorized gathers straight off the SoA arrays (no dicts,
    no per-job Python). Downstream, ``repro.core.state.encode_sample_batch``
    turns this into the (B, 40) observation slab in one numpy pass.
    """
    B = len(sims)
    times = np.empty(B, np.float64)
    q_count = np.empty(B, np.int64)
    r_count = np.empty(B, np.int64)
    for b, s in enumerate(sims):   # repro-static: ok[lane-loop] CSR gather
        # fill: O(B) python over simulator objects, vectorized per-lane inner
        times[b] = s.now
        q_count[b] = s._q.size
        r_count[b] = s._run_n
    q_off = np.zeros(B + 1, np.int64)
    r_off = np.zeros(B + 1, np.int64)
    np.cumsum(q_count, out=q_off[1:])
    np.cumsum(r_count, out=r_off[1:])
    q_sizes = np.empty(q_off[-1], np.float64)
    q_ages = np.empty(q_off[-1], np.float64)
    q_limits = np.empty(q_off[-1], np.float64)
    r_sizes = np.empty(r_off[-1], np.float64)
    r_elapsed = np.empty(r_off[-1], np.float64)
    r_limits = np.empty(r_off[-1], np.float64)
    for b, s in enumerate(sims):   # repro-static: ok[lane-loop] CSR gather
        # fill: the inner gathers are vectorized slices off the SoA arrays
        a, e = q_off[b], q_off[b + 1]
        if e > a:
            q = s._q
            q_sizes[a:e] = s._nn[q]
            q_ages[a:e] = times[b] - s._sub[q]
            q_limits[a:e] = s._lim[q]
        a, e = r_off[b], r_off[b + 1]
        if e > a:
            r = s._run_i[:s._run_n]
            r_sizes[a:e] = s._nn[r]
            r_elapsed[a:e] = times[b] - s._start[r]
            r_limits[a:e] = s._lim[r]
    return SampleBatch(times, q_count, q_off, q_sizes, q_ages, q_limits,
                       r_count, r_off, r_sizes, r_elapsed, r_limits)


def step_batch(sims: Sequence[SlurmSimulator], dt: float) -> None:
    """Advance B simulators by ``dt`` each (the lockstep-interval twin of
    ``sample_batch``). Simulator advances are object-granular by design —
    each lane drains its own event heap — so like the CSR gather above,
    the per-simulator loop IS the batched API; the inner work is the
    vectorized event engine."""
    for s in sims:   # repro-static: ok[lane-loop] per-simulator event advance
        s.run_until(s.now + dt)
