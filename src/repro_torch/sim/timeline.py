"""Immutable background timeline + the differential episode engine.

The vector env's episode tail re-simulates days of background backlog
churn per lane, even though every lane is a one-job perturbation of the
*same* cached background replay. This module materializes that replay
once as an immutable ``BackgroundTimeline`` — frozen per-job event
arrays (from ``SlurmSimulator.schedule_view()``) plus a scheduling-pass
record captured by a ``PassRecorder`` during the replay — and then
answers the two questions an episode reset needs without touching a
live simulator:

* ``sample_lanes(ts)`` — the warm-up observations: queue/running
  populations of the background at B instants, served as one flat
  ``SampleBatch`` bit-identical to sampling B forked simulators
  (queue statistics are percentile-based and order-insensitive; the
  running set is reconstructed in start-log order, which equals the
  running-array order the scalar path observes).

* ``place(t0, job)`` — where the injected chain job lands: a two-layer
  proof against the recorded passes.  Layer 1 is a vectorized
  inertness certificate over every instant the scheduler could act
  (recorded passes + arrivals): the job provably neither starts nor
  perturbs the pass when the recorded blocked head strictly outranks
  it (C1) and it provably cannot backfill under the recorded
  reservation entry state (C2).  Layer 2, at the first uncertified
  instant, replays that single scheduling pass exactly (same sort
  keys, same float expressions, same reservation scan as
  ``SlurmSimulator._schedule``) with the job in the queue, and
  compares the background starts to the recorded ones.  Outcomes:
  the job STARTS at that instant (with its exact position in the
  pass, so the running-array order can be reproduced), the
  perturbation provably CASCADES (a background start would shift —
  fall back to forking a real simulator at the last verified
  instant), or the pass is inert and the scan continues.

Soundness leans on engine invariants pinned by the tier-1 suite:
unrecorded scheduling instants only ever follow a pass that recorded
its blocking state (the no-op cache is decision-neutral and every
full pass is recorded), completions always trigger recorded passes,
and fault windows bound the valid region (``valid_until`` — everything
at or past the first fault event falls back to real simulation).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from .faults import FaultPlan
from .simulator import (AGE_MAX, AGE_WEIGHT, SIZE_WEIGHT, SampleBatch,
                        ScheduleView, SlurmSimulator)

_INF = float("inf")
_EMPTY_I = np.empty(0, np.int64)

# record kinds
EMPTY, FREE0, FULL = 0, 1, 2

# snapshot grid step for the alive/queued bucket index (coarse: queries
# pay one bucket snapshot + a <=6h log window each)
GRID_STEP = 6 * 3600.0

# scan budget per placement before giving up and syncing to a real fork
MAX_REPLICAS = 96
MAX_INSTANTS = 250_000


class PassRecorder:
    """Collects one record per executed scheduling pass (attach via
    ``sim._pass_rec``). Noop fast-path passes are intentionally
    unrecorded — they are decision-neutral and always follow a recorded
    pass whose blocking state still bounds them."""

    def __init__(self):
        self.t: List[float] = []
        self.kind: List[int] = []
        self.free_entry: List[int] = []
        self.free_exit: List[int] = []
        self.free_bf: List[int] = []
        self.shadow: List[float] = []
        self.spare: List[int] = []
        self.head: List[int] = []
        self.nstart: List[int] = []
        self._log: List[np.ndarray] = []

    def _push(self, t, kind, fe, fx, fbf, shadow, spare, head, started):
        self.t.append(t)
        self.kind.append(kind)
        self.free_entry.append(fe)
        self.free_exit.append(fx)
        self.free_bf.append(fbf)
        self.shadow.append(shadow)
        self.spare.append(spare)
        self.head.append(head)
        self.nstart.append(int(started.size))
        if started.size:
            self._log.append(started.astype(np.int64, copy=True))

    def empty(self, sim: SlurmSimulator) -> None:
        f = sim.cluster.n_free
        self._push(sim.now, EMPTY, f, f, f, -_INF, -1, -1, _EMPTY_I)

    def free0(self, sim: SlurmSimulator) -> None:
        f = sim.cluster.n_free
        self._push(sim.now, FREE0, f, f, f, -_INF, -1, -1, _EMPTY_I)

    def full(self, sim: SlurmSimulator, free_entry: int, prefix: np.ndarray,
             bf: np.ndarray, head: int, free_bf: int, shadow: float,
             spare: int) -> None:
        started = (np.concatenate([prefix, bf]) if bf.size
                   else prefix)
        self._push(sim.now, FULL, int(free_entry), sim.cluster.n_free,
                   int(free_bf), float(shadow), int(spare), int(head),
                   started)


@dataclasses.dataclass
class Placement:
    """Outcome of ``BackgroundTimeline.place``."""
    kind: str                # "start" | "cascade" | "fallback"
    t: float = 0.0           # start instant / sync instant
    pass_pos: int = 0        # position of the job in its starting pass
    pass_size: int = 0       # total starts of that pass (incl. the job)
    run_pass: bool = False   # cascade at t0: re-run the submission pass
    intervals: int = 0       # verified decision intervals (hit-rate acct)


class BackgroundTimeline:
    """Frozen replay of one background trace (see module docstring).

    Build via ``BackgroundTimeline.from_recording`` after draining a
    simulator that carried a ``PassRecorder``; all arrays are read-only
    and shared across every lane/env holding the timeline.
    """

    def __init__(self, view: ScheduleView, rec: PassRecorder,
                 n_nodes: int, faults: Optional[FaultPlan],
                 backfill: bool = True):
        self.n_nodes = int(n_nodes)
        self.backfill = bool(backfill)
        self.nav = max(self.n_nodes, 1)     # fault-free priority normalizer
        self.valid_until = (float(faults.times[0])
                            if faults is not None and len(faults) else _INF)
        # per-job arrays (read-only views from the recording simulator)
        self.sub = view.sub
        self.rt = view.runtime
        self.lim = view.limit
        self.nn = view.nodes
        self.ids = view.ids
        self.n = view.n
        # pass records
        self.rec_t = np.asarray(rec.t, np.float64)
        self.rec_kind = np.asarray(rec.kind, np.int8)
        self.rec_free_entry = np.asarray(rec.free_entry, np.int64)
        self.rec_free_exit = np.asarray(rec.free_exit, np.int64)
        self.rec_free_bf = np.asarray(rec.free_bf, np.int64)
        self.rec_shadow = np.asarray(rec.shadow, np.float64)
        self.rec_spare = np.asarray(rec.spare, np.int64)
        self.rec_head = np.asarray(rec.head, np.int64)
        self.rec_nstart = np.asarray(rec.nstart, np.int64)
        self.rec_off = np.zeros(self.rec_t.size + 1, np.int64)
        np.cumsum(self.rec_nstart, out=self.rec_off[1:])
        # flat start log, pass order == running-array append order
        self.log_idx = (np.concatenate(rec._log) if rec._log else _EMPTY_I)
        self.log_t = np.repeat(self.rec_t, self.rec_nstart)
        self.log_end = self.log_t + np.minimum(self.rt[self.log_idx],
                                               self.lim[self.log_idx])
        # first start per job (kill/requeue restarts only exist past
        # valid_until, where the differential path never reads)
        self.first_start = np.full(self.n, _INF, np.float64)
        np.minimum.at(self.first_start, self.log_idx, self.log_t)
        # submit-order index
        self.sub_order = np.argsort(self.sub, kind="stable").astype(np.int64)
        self.sub_sorted = self.sub[self.sub_order]
        self.horizon = float(self.rec_t[-1]) if self.rec_t.size else 0.0
        self._build_grid()
        for name in ("rec_t", "rec_kind", "rec_free_entry", "rec_free_exit",
                     "rec_free_bf", "rec_shadow", "rec_spare", "rec_head",
                     "rec_nstart", "rec_off", "log_idx", "log_t", "log_end",
                     "first_start", "sub_order", "sub_sorted"):
            getattr(self, name).flags.writeable = False

    # ------------------------------------------------------------ building
    @staticmethod
    def record(sim: SlurmSimulator) -> PassRecorder:
        """Attach a recorder to ``sim`` (the caller drains the replay)."""
        rec = PassRecorder()
        sim._pass_rec = rec
        return rec

    @classmethod
    def from_recording(cls, sim: SlurmSimulator, rec: PassRecorder,
                       faults: Optional[FaultPlan]) -> "BackgroundTimeline":
        sim._pass_rec = None
        return cls(sim.schedule_view(), rec, sim.cluster.n_nodes, faults,
                   backfill=sim.backfill)

    def _build_grid(self) -> None:
        """Coarse alive/queued snapshots every GRID_STEP: a query pays one
        snapshot plus a <=GRID_STEP log/submit window instead of a scan
        over the whole start log."""
        L = self.log_t.size
        n = self.n
        nb = int(self.horizon // GRID_STEP) + 1
        self._nb = nb
        end_order = np.argsort(self.log_end, kind="stable")
        fs_order = np.argsort(self.first_start, kind="stable")
        alive = np.zeros(L, bool)
        queued = np.zeros(n, bool)
        ia = ib = ic = iq = 0
        r_parts, q_parts = [], []
        r_off = np.zeros(nb + 1, np.int64)
        q_off = np.zeros(nb + 1, np.int64)
        log_end_ro = self.log_end[end_order]
        fs_ro = self.first_start[fs_order]
        for k in range(nb):
            g = k * GRID_STEP
            while ia < L and self.log_t[ia] <= g:
                alive[ia] = True
                ia += 1
            while ib < L and log_end_ro[ib] <= g:
                alive[end_order[ib]] = False
                ib += 1
            while ic < n and self.sub_sorted[ic] <= g:
                queued[self.sub_order[ic]] = True
                ic += 1
            while iq < n and fs_ro[iq] < g:
                queued[fs_order[iq]] = False
                iq += 1
            ra = np.flatnonzero(alive)
            qa = np.flatnonzero(queued)
            r_parts.append(ra)
            q_parts.append(qa)
            r_off[k + 1] = r_off[k] + ra.size
            q_off[k + 1] = q_off[k] + qa.size
        self._rsnap = (np.concatenate(r_parts) if r_parts else _EMPTY_I)
        self._qsnap = (np.concatenate(q_parts) if q_parts else _EMPTY_I)
        self._rsnap_off = r_off
        self._qsnap_off = q_off
        for a in (self._rsnap, self._qsnap, r_off, q_off):
            a.flags.writeable = False

    # ---------------------------------------------------------- obs service
    def sample_lanes(self, ts: np.ndarray) -> SampleBatch:
        """Queue/running populations of the background at ``ts`` (B,) as a
        flat ``SampleBatch`` — value-identical to ``sample_batch`` over B
        simulators advanced to those instants (every ``ts`` must be <
        ``valid_until``). Queue entries are served in submit order
        (the encoder's queue statistics are order-insensitive); running
        entries in start-log order, which IS the running-array order."""
        ts = np.asarray(ts, np.float64)
        B = ts.size
        bk = np.minimum((ts // GRID_STEP).astype(np.int64), self._nb - 1)
        g = bk * GRID_STEP
        lane_ids = np.arange(B)
        # running: bucket snapshot + starts in (g, t]
        e1, l1 = self._ragged(self._rsnap_off[bk], self._rsnap_off[bk + 1]
                              - self._rsnap_off[bk], lane_ids)
        e1 = self._rsnap[e1]
        lo = np.searchsorted(self.log_t, g, side="right")
        hi = np.searchsorted(self.log_t, ts, side="right")
        e2, l2 = self._ragged(lo, hi - lo, lane_ids)
        e = np.concatenate([e1, e2])
        ln = np.concatenate([l1, l2])
        keep = (self.log_t[e] <= ts[ln]) & (self.log_end[e] > ts[ln])
        e, ln = e[keep], ln[keep]
        order = np.lexsort((e, ln))        # lane-major, log order within
        e, ln = e[order], ln[order]
        r_count = np.bincount(ln, minlength=B)
        r_off = np.zeros(B + 1, np.int64)
        np.cumsum(r_count, out=r_off[1:])
        jr = self.log_idx[e]
        r_sizes = self.nn[jr].astype(np.float64)
        r_elapsed = ts[ln] - self.log_t[e]
        r_limits = self.lim[jr]
        # queue: bucket snapshot + submissions in (g, t]
        j1, m1 = self._ragged(self._qsnap_off[bk], self._qsnap_off[bk + 1]
                              - self._qsnap_off[bk], lane_ids)
        j1 = self._qsnap[j1]
        lo = np.searchsorted(self.sub_sorted, g, side="right")
        hi = np.searchsorted(self.sub_sorted, ts, side="right")
        j2, m2 = self._ragged(lo, hi - lo, lane_ids)
        j2 = self.sub_order[j2]
        j = np.concatenate([j1, j2])
        mn = np.concatenate([m1, m2])
        keep = (self.sub[j] <= ts[mn]) & (self.first_start[j] > ts[mn])
        j, mn = j[keep], mn[keep]
        order = np.lexsort((j, mn))
        j, mn = j[order], mn[order]
        q_count = np.bincount(mn, minlength=B)
        q_off = np.zeros(B + 1, np.int64)
        np.cumsum(q_count, out=q_off[1:])
        q_sizes = self.nn[j].astype(np.float64)
        q_ages = ts[mn] - self.sub[j]
        q_limits = self.lim[j]
        return SampleBatch(ts.copy(), q_count.astype(np.int64), q_off,
                           q_sizes, q_ages, q_limits,
                           r_count.astype(np.int64), r_off,
                           r_sizes, r_elapsed, r_limits)

    @staticmethod
    def _ragged(starts: np.ndarray, counts: np.ndarray,
                lane_ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Flatten per-lane [start, start+count) ranges: returns the flat
        element indices and their lane ids (vectorized, no lane loop)."""
        counts = np.maximum(counts, 0)
        total = int(counts.sum())
        if not total:
            return _EMPTY_I, _EMPTY_I
        rep = np.repeat(lane_ids, counts)
        base = np.zeros(counts.size + 1, np.int64)
        np.cumsum(counts, out=base[1:])
        rep_pos = np.repeat(np.arange(counts.size), counts)
        flat = (np.arange(total) - base[rep_pos]) + starts[rep_pos]
        return flat, rep

    # ------------------------------------------------------- state queries
    def _running_at(self, tau: float, post: bool) -> np.ndarray:
        """Start-log entries running at ``tau`` (log order). ``post``
        includes starts at exactly ``tau`` (post-pass state)."""
        bk = min(int(tau // GRID_STEP), self._nb - 1)
        g = bk * GRID_STEP
        lo = int(np.searchsorted(self.log_t, g, side="right"))
        hi = int(np.searchsorted(self.log_t, tau,
                                 side="right" if post else "left"))
        cand = np.concatenate([self._rsnap[self._rsnap_off[bk]:
                                           self._rsnap_off[bk + 1]],
                               np.arange(lo, hi, dtype=np.int64)])
        if post:
            keep = (self.log_t[cand] <= tau) & (self.log_end[cand] > tau)
        else:
            keep = (self.log_t[cand] < tau) & (self.log_end[cand] > tau)
        return cand[keep]

    def _queued_at(self, tau: float, post: bool) -> np.ndarray:
        """Background job indices queued at ``tau`` (submit order; the
        replica pass re-sorts, so only content matters). ``post`` excludes
        jobs starting exactly at ``tau``."""
        bk = min(int(tau // GRID_STEP), self._nb - 1)
        g = bk * GRID_STEP
        lo = int(np.searchsorted(self.sub_sorted, g, side="right"))
        hi = int(np.searchsorted(self.sub_sorted, tau, side="right"))
        cand = np.concatenate([self._qsnap[self._qsnap_off[bk]:
                                           self._qsnap_off[bk + 1]],
                               self.sub_order[lo:hi]])
        fs = self.first_start[cand]
        keep = (self.sub[cand] <= tau) & (fs > tau if post else fs >= tau)
        return cand[keep]

    # --------------------------------------------------------- layer 2
    def _replica_pass(self, tau: float, q_idx: np.ndarray,
                      p_sub: float, p_nn: int, p_lim: float, p_id: int,
                      free: int) -> Tuple[np.ndarray, int]:
        """Replay one scheduling pass exactly (``SlurmSimulator._schedule``
        arithmetic, operation for operation) on background queue ``q_idx``
        plus the injected job. Returns the started sequence as positions
        into the working arrays (background jobs identified by position
        < q_idx.size; the injected job is position q_idx.size) and the
        injected job's rank in that sequence (-1 = not started)."""
        m = q_idx.size
        sub = np.concatenate([self.sub[q_idx], np.array([p_sub], np.float64)])
        nn = np.concatenate([self.nn[q_idx], np.array([p_nn], np.int64)])
        lim = np.concatenate([self.lim[q_idx], np.array([p_lim], np.float64)])
        ids = np.concatenate([self.ids[q_idx], np.array([p_id], np.int64)])
        started = []
        if free > 0:
            prio = (AGE_WEIGHT * np.minimum((tau - sub) / AGE_MAX, 1.0)
                    + SIZE_WEIGHT * nn / self.nav)
            q = np.lexsort((ids, sub, -prio))
            csum = np.cumsum(nn[q])
            k = int(np.searchsorted(csum, free, side="right"))
            if k:
                started.append(q[:k])
                free -= int(csum[k - 1])
                q = q[k:]
            if q.size and self.backfill and free > 0:
                cand = q[1:]
                n = nn[cand]
                if cand.size and (n <= free).any():
                    head_n = int(nn[q[0]])
                    run = self._running_at(tau, post=False)
                    jr = self.log_idx[run]
                    run_nn = self.nn[jr]
                    run_limend = self.log_t[run] + self.lim[jr]
                    order = np.lexsort((run_nn, run_limend))
                    avail = free + np.cumsum(run_nn[order])
                    pos = int(np.searchsorted(avail, head_n, side="left"))
                    if pos < run.size:
                        shadow_time = float(run_limend[order[pos]])
                        spare = int(avail[pos]) - head_n
                    else:
                        shadow_time = _INF
                        spare = 0
                    ends_ok = tau + lim[cand] <= shadow_time
                    viable = np.flatnonzero((n <= free)
                                            & (ends_ok | (n <= spare)))
                    mask = np.zeros(cand.size, bool)
                    for v in viable:
                        nv = int(n[v])
                        if nv > free:
                            continue
                        if ends_ok[v]:
                            mask[v] = True
                            free -= nv
                        elif nv <= spare:
                            mask[v] = True
                            free -= nv
                            spare -= nv
                        if free == 0:
                            break
                    if mask.any():
                        started.append(cand[mask])
        seq = np.concatenate(started) if started else _EMPTY_I
        hit = np.flatnonzero(seq == m)
        return seq, (int(hit[0]) if hit.size else -1)

    def _check_instant(self, tau: float, t0: float, p_nn: int, p_lim: float,
                       p_rt: float, p_id: int, post: bool
                       ) -> Tuple[str, int, int]:
        """Layer-2: exact single-pass replica at ``tau``. Returns
        ("inert"|"start"|"cascade", pass_pos, pass_size)."""
        q_idx = self._queued_at(tau, post=post)
        run = self._running_at(tau, post=post)
        free = self.n_nodes - int(self.nn[self.log_idx[run]].sum())
        seq, rank = self._replica_pass(tau, q_idx, t0, p_nn, p_lim, p_id,
                                       free)
        m = q_idx.size
        bg = seq[seq != m]
        if post:
            target = _EMPTY_I
        else:
            s = int(np.searchsorted(self.rec_t, tau, side="right")) - 1
            if s >= 0 and self.rec_t[s] == tau:
                target = self.log_idx[self.rec_off[s]:self.rec_off[s + 1]]
            else:
                target = _EMPTY_I
        if bg.size != target.size or not np.array_equal(q_idx[bg], target):
            return "cascade", 0, 0
        if rank < 0:
            return "inert", 0, 0
        # zero-runtime guard: a start ending at tau would complete (and
        # trigger another pass) inside the same instant on a real fork
        jdx = q_idx[bg] if bg.size else _EMPTY_I
        if bg.size and not (np.minimum(self.rt[jdx], self.lim[jdx])
                            > 0).all():
            return "cascade", 0, 0
        return "start", rank, int(seq.size)

    # --------------------------------------------------------- layer 1
    def _cert_inert(self, taus: np.ndarray, t0: float, p_nn: int,
                    p_lim: float, p_id: int) -> np.ndarray:
        """Vectorized layer-1 inertness certificate at instants ``taus``
        (all > t0): True where the injected job provably neither starts
        nor perturbs the scheduling pass."""
        s = np.searchsorted(self.rec_t, taus, side="right") - 1
        ok = s >= 0
        sc = np.maximum(s, 0)
        fe = self.rec_free_exit[sc]
        kind = self.rec_kind[sc]
        ns = self.rec_nstart[sc]
        head = self.rec_head[sc]
        fbf = self.rec_free_bf[sc]
        shadow = self.rec_shadow[sc]
        spare = self.rec_spare[sc]
        unrec = taus > self.rec_t[sc]
        # free_exit == 0 alone is NOT sufficient when the pass started
        # jobs: a higher-priority injected job can displace a prefix
        # member even with zero free nodes at exit. Those records fall
        # through to the C1/C2 rule below.
        inert = ok & (fe == 0) & (ns == 0)
        # Between-record instants off a free_exit == 0 record stay
        # inert regardless of ns: free cannot grow without a recorded
        # completion pass, and a pass at free == 0 exits at FREE0
        # before touching the queue.
        inert |= ok & unrec & (fe == 0)
        inert |= ok & ~unrec & (kind == EMPTY) & (p_nn > fe)
        # FULL records with a blocked head: C1 (head strictly outranks
        # the job at tau) and not-C2 (the job provably cannot backfill
        # under the recorded reservation entry state). Between-record
        # instants are only certifiable off no-start records (a start
        # invalidates the noop cache, so the next event re-records).
        hd = np.maximum(head, 0)
        sub_h = self.sub[hd]
        prio_h = (AGE_WEIGHT * np.minimum((taus - sub_h) / AGE_MAX, 1.0)
                  + SIZE_WEIGHT * self.nn[hd] / self.nav)
        prio_p = (AGE_WEIGHT * np.minimum((taus - t0) / AGE_MAX, 1.0)
                  + SIZE_WEIGHT * p_nn / self.nav)
        ids_h = self.ids[hd]
        c1 = (prio_h > prio_p) | ((prio_h == prio_p)
                                  & ((sub_h < t0)
                                     | ((sub_h == t0) & (ids_h < p_id))))
        c2 = (p_nn <= fbf) & ((taus + p_lim <= shadow) | (p_nn <= spare))
        full_ok = (kind == FULL) & (head >= 0) & ~(unrec & (ns > 0))
        inert |= ok & full_ok & c1 & ~c2
        return inert

    # ------------------------------------------------------------ placement
    def place(self, t0: float, p_nn: int, p_lim: float, p_rt: float,
              p_id: int, interval: float) -> Placement:
        """Where does a job (submit=t0, nn, limit) land against the
        background? See module docstring for the certificate/replica
        split. ``interval`` only feeds the hit-rate accounting."""
        if not np.isfinite(t0) or t0 >= self.valid_until or t0 < 0:
            return Placement("fallback")
        n_replicas = 0

        def acct(t):
            return int(max(t - t0, 0.0) // max(interval, 1.0)) + 1

        out = self._check_instant(t0, t0, p_nn, p_lim, p_rt, p_id, post=True)
        n_replicas += 1
        if out[0] == "start":
            return Placement("start", t0, out[1], out[2], intervals=acct(t0))
        if out[0] == "cascade":
            return Placement("cascade", t0, run_pass=True, intervals=0)
        t_sync = t0
        # scan instants: recorded passes + arrivals after t0
        ri = int(np.searchsorted(self.rec_t, t0, side="right"))
        ai = int(np.searchsorted(self.sub_sorted, t0, side="right"))
        taus = np.union1d(self.rec_t[ri:], self.sub_sorted[ai:])
        taus = taus[taus < self.valid_until]
        if taus.size > MAX_INSTANTS:
            taus = taus[:MAX_INSTANTS]
        pos = 0
        while pos < taus.size:
            chunk = taus[pos:pos + 4096]
            inert = self._cert_inert(chunk, t0, p_nn, p_lim, p_id)
            bad = np.flatnonzero(~inert)
            if not bad.size:
                t_sync = float(chunk[-1])
                pos += chunk.size
                continue
            b = int(bad[0])
            if b > 0:
                t_sync = float(chunk[b - 1])
            tau = float(chunk[b])
            if n_replicas >= MAX_REPLICAS:
                return Placement("cascade", t_sync, intervals=acct(t_sync))
            out = self._check_instant(tau, t0, p_nn, p_lim, p_rt, p_id,
                                      post=False)
            n_replicas += 1
            if out[0] == "start":
                return Placement("start", tau, out[1], out[2],
                                 intervals=acct(tau))
            if out[0] == "cascade":
                return Placement("cascade", t_sync, intervals=acct(t_sync))
            t_sync = tau
            pos += b + 1
        # events exhausted (timeline horizon or fault boundary): hand the
        # rest to a real fork synced at the last verified instant
        return Placement("cascade", t_sync, intervals=acct(t_sync))
