"""The Mirage provisioner: episode environment, offline pretraining,
online RL training, and evaluation (§4.9, §5.1, §6).

Episode protocol (§5.1):
  1. fresh simulator loaded with the background trace, run to a sampled
     instant (>= 2-day warm-up);
  2. the predecessor sub-job is submitted and runs;
  3. every 10 simulated minutes the agent observes the state matrix and
     decides submit / no-submit for the successor;
  4. on submission the simulator runs until the successor STARTS; the
     outcome (interruption or overlap vs. the predecessor's end) shapes
     the reward (Eq. 8) credited to the episode's actions.

If the agent never submits before the predecessor's limit expires, the
environment falls back to reactive submission (the paper's ε-greedy
online training prevents the infinite-episode case; the fallback bounds
it in evaluation too).

Batched rollouts: ``VectorProvisionEnv`` steps B independent episodes in
lockstep and returns stacked (B, k, 40) state matrices. Its observation
path is one numpy pass per lockstep interval: live lanes' simulators are
sampled into one flat ``SampleBatch`` (``repro.sim.sample_batch``),
encoded with the segment-sorted ``encode_sample_batch`` kernel into a
preallocated slab, and pushed into a persistent ``StateHistoryBatch``
ring with per-lane cursors; ``step``/``reset`` serve views of persistent
buffers (copy anything you retain across steps).

``reset`` forks each lane's simulator off a ``ReplayCheckpointCache``: the
shared background replay is paid once per cache (not once per reset), with
``fork()`` checkpoints taken at fixed simulated-time intervals so later
resets — and later training epochs sharing the cache — fork from the
nearest checkpoint at or before their warm-up point. Lane ``i`` remains
bit-identical to a scalar ``ProvisionEnv`` seeded ``seed + i``: a forked
checkpoint advanced to the warm-up point equals a fresh replay to the
same instant (the event engine is deterministic), and the batched
encoder/ring reproduce the scalar per-lane push sequences exactly.
"""
from __future__ import annotations

import bisect
import copy
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.sim.faults import FaultPlan
from repro_torch.sim.simulator import SlurmSimulator, sample_batch, step_batch
from repro_torch.sim.trace import Job
from repro_torch.sim.workload import SubJobChain, pair_outcome
from .reward import RewardConfig, shape_reward
from .state import (SAMPLE_INTERVAL, STATE_DIM, StateHistory,
                    StateHistoryBatch, encode_sample_batch, encode_snapshot,
                    summary_features, summary_features_batch)

HOUR = 3600.0
DAY = 24 * HOUR


@dataclasses.dataclass
class EnvConfig:
    n_nodes: int = 88
    sub_limit: float = 48 * HOUR
    chain_nodes: int = 1
    history: int = 144
    interval: float = SAMPLE_INTERVAL
    warmup: float = 2 * DAY
    reward: RewardConfig = dataclasses.field(default_factory=RewardConfig)
    # deterministic fault schedule threaded into every simulator the env
    # (or its checkpoint cache) builds; None == fault-free
    faults: Optional[FaultPlan] = None
    # serve vector-env resets from the differential engine (the immutable
    # background timeline) where provably exact, falling back to real
    # forks otherwise; False forces the classic fork-per-lane path
    differential: bool = True


class ProvisionEnv:
    """One predecessor-successor pair per episode (§4.1's P/S protocol)."""

    def __init__(self, trace: Sequence[Job], cfg: EnvConfig, seed: int = 0,
                 cache: Optional["ReplayCheckpointCache"] = None):
        self.trace = trace
        self.cfg = cfg
        self.seed = seed
        self.cache = cache
        self.rng = np.random.default_rng(seed)
        self.sim: Optional[SlurmSimulator] = None
        self.hist: Optional[StateHistory] = None
        self.pred: Optional[Job] = None
        self.succ: Optional[Job] = None
        self.chain: Optional[SubJobChain] = None
        self._fc0 = (0, 0)       # fault/requeue counters at episode start
        self._t_start_range = (
            trace[0].submit_time + cfg.warmup,
            max(trace[-1].submit_time - 3 * cfg.sub_limit,
                trace[0].submit_time + cfg.warmup + DAY))

    # ------------------------------------------------------------ helpers
    def _snapshot(self) -> np.ndarray:
        s = self.sim.sample()
        pred_info = None
        if self.pred is not None:
            pred_info = {
                "size": self.pred.n_nodes, "limit": self.pred.time_limit,
                "queue_time": max(self.pred.wait_time, 0.0),
                "elapsed": (max(self.sim.now - self.pred.start_time, 0.0)
                            if self.pred.start_time >= 0 else 0.0),
            }
        succ_info = {"size": self.cfg.chain_nodes, "limit": self.cfg.sub_limit}
        return encode_snapshot(s, self.cfg.n_nodes, self.cfg.sub_limit,
                               pred_info, succ_info)

    def _advance(self, dt: float) -> None:
        """Advance in sampling-interval steps, recording history."""
        end = self.sim.now + dt
        while self.sim.now + self.cfg.interval <= end:
            self.sim.step(self.cfg.interval)
            self.hist.push(self._snapshot())
        if self.sim.now < end:
            self.sim.step(end - self.sim.now)

    def obs(self) -> Dict:
        m = self.hist.matrix()
        remaining = (self.pred.start_time + self.pred.time_limit - self.sim.now
                     if self.pred.start_time >= 0 else self.cfg.sub_limit)
        return {
            "matrix": m,
            "summary": summary_features(m),
            "pred_remaining": remaining,
            "time_pos": (self.sim.now - self.trace[0].submit_time)
            / max(self.trace[-1].submit_time - self.trace[0].submit_time, 1.0),
        }

    # ------------------------------------------------------------ episode
    def warmup_point(self, t0: float) -> float:
        """The instant an episode's history window begins (fork point)."""
        return max(t0 - self.cfg.history * self.cfg.interval, 0.0)

    def reset(self, t_start: Optional[float] = None) -> Dict:
        lo, hi = self._t_start_range
        t0 = t_start if t_start is not None else float(self.rng.uniform(lo, hi))
        if self.cache is not None:
            # warm path: fork the shared background replay at the window
            # head instead of re-replaying the trace from t=0 (checkpoint
            # forks are bit-identical to a fresh replay — cache contract)
            sim = self.cache.fork_at(self.warmup_point(t0))
        else:
            sim = SlurmSimulator(self.cfg.n_nodes, mode="fast",
                                 faults=self.cfg.faults)
            sim.load([copy.copy(j) for j in self.trace])
        return self._begin_episode(sim, t0)

    def _begin_episode(self, sim: SlurmSimulator, t0: float) -> Dict:
        """Start an episode at t0 on ``sim`` (fresh, or forked at/before
        the warm-up point — identical state either way)."""
        self.sim = sim
        self.hist = StateHistory(self.cfg.history)
        self.pred = None
        self.succ = None
        # warm up: run to the history-window start, then fill the window
        self.sim.run_until(self.warmup_point(t0))
        self.hist.push(self._snapshot())
        self._advance(max(t0 - self.sim.now, 0.0))
        # submit + start the predecessor
        self.chain = SubJobChain(user_id=int(self.rng.integers(1000, 2000)),
                                 n_nodes=self.cfg.chain_nodes,
                                 sub_limit=self.cfg.sub_limit,
                                 next_id=int(self.rng.integers(10**6, 10**7)))
        self.pred = self.chain.make_sub(0, self.sim.now)
        self.sim.submit(self.pred)
        self.sim.run_until_started(self.pred)
        self._fc0 = (self.sim.n_node_failures, self.sim.n_requeues)
        self.hist.push(self._snapshot())
        return self.obs()

    def step(self, action: int) -> Tuple[Dict, float, bool, Dict]:
        """action: 1=submit successor, 0=wait. Returns (obs, reward, done, info)."""
        assert self.pred is not None and self.succ is None
        # a fault-killed (requeued, not yet restarted) predecessor has no
        # known end: it cannot force a reactive submission until restarted
        pred_end = (self.pred.start_time + min(self.pred.runtime,
                                               self.pred.time_limit)
                    if self.pred.start_time >= 0 else float("inf"))
        forced = False
        if action == 0:
            if self.sim.now + self.cfg.interval >= pred_end:
                forced = True        # limit expired -> reactive fallback
            else:
                self._advance(self.cfg.interval)
                return self.obs(), 0.0, False, {}
        r, info = self._submit_successor(forced)
        return self.obs(), r, True, info

    def _submit_successor(self, forced: bool) -> Tuple[float, Dict]:
        """Submit the successor (possibly forced at the predecessor's end),
        run it to start, and score the episode outcome. Shared by the
        scalar step and the vector env's batched step (which serves the
        final observation from its own ring instead of ``obs()``)."""
        started = self.pred.start_time >= 0
        pred_end = (self.pred.start_time + min(self.pred.runtime,
                                               self.pred.time_limit)
                    if started else float("inf"))
        t_sub = max(self.sim.now, pred_end if forced and started
                    else self.sim.now)
        self.sim.run_until(t_sub)
        self.succ = self.chain.make_sub(1, t_sub)
        self.sim.submit(self.succ)
        wait = self.sim.run_until_started(self.succ)
        if self.pred.end_time < 0:
            if self.pred.start_time >= 0:
                # the predecessor (original or fault-requeued restart)
                # runs to its limit from its current start
                self.pred.end_time = self.pred.start_time + min(
                    self.pred.runtime, self.pred.time_limit)
            else:
                # killed and still queued when the successor went in: the
                # service has been down since before the submission
                self.pred.end_time = t_sub
        kind, amount = pair_outcome(self.pred, self.succ)
        r = shape_reward(kind, amount, self.cfg.reward)
        f0, rq0 = self._fc0
        return r, {"kind": kind, "amount_s": amount, "wait_s": wait,
                   "forced": forced,
                   "n_faults": self.sim.n_node_failures - f0,
                   "n_requeues": self.sim.n_requeues - rq0}


class ReplayCheckpointCache:
    """Warm-up replay cache: checkpointed forks of one background replay.

    A single frontier simulator replays the trace forward on demand,
    snapshotting ``fork()`` checkpoints every ``interval`` of simulated
    time. ``fork_at(t)`` serves a simulator advanced to exactly ``t``:
    ahead of the frontier it extends the replay (cold path, paid once per
    region of the trace); behind it, it forks the nearest checkpoint at or
    before ``t`` and replays only the remainder (warm path). Shared across
    ``VectorProvisionEnv.reset`` calls and across training epochs, so
    repeated resets stop re-paying the trace-head replay.

    Determinism: the event engine advances identically whether driven in
    one ``run_until`` or many, and ``fork()`` is an exact state snapshot,
    so a checkpoint fork advanced to ``t`` is bit-identical to a fresh
    replay to ``t``.

    The checkpoint ring is bounded by ``max_bytes``: on overflow every
    other interior checkpoint is dropped (density halves, coverage and the
    endpoints stay), keeping the worst-case warm replay bounded while the
    memory stays under the configured budget.
    """

    def __init__(self, trace: Sequence[Job], n_nodes: int, mode: str = "fast",
                 interval: float = 6 * HOUR, max_bytes: int = 256 << 20,
                 faults: Optional[FaultPlan] = None):
        assert interval > 0
        self.trace = trace
        self.interval = interval
        self.max_bytes = max_bytes
        self.faults = faults
        self._frontier = SlurmSimulator(n_nodes, mode=mode, faults=faults)
        self._frontier.load([copy.copy(j) for j in trace])
        self._times: List[float] = []
        self._sims: List[SlurmSimulator] = []
        self._bytes: List[int] = []
        self._timeline = None
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._sims)

    @property
    def nbytes(self) -> int:
        return sum(self._bytes)

    def fork_at(self, t: float) -> SlurmSimulator:
        """A forked simulator advanced to exactly ``t`` (>= 0)."""
        hit, sim = self._fork_at(t)
        if hit:
            self.hits += 1
        else:
            self.misses += 1
        return sim

    def fork_quiet(self, t: float) -> SlurmSimulator:
        """``fork_at`` without touching the hit/miss counters. Used by the
        differential engine's materialization forks, which the counters
        are not meant to measure (``timeline()`` does its own accounting:
        one miss to build, a hit per reuse)."""
        return self._fork_at(t)[1]

    def _fork_at(self, t: float) -> Tuple[bool, SlurmSimulator]:
        if t == self._frontier.now:
            return True, self._frontier.fork()   # no replay needed at all
        if t > self._frontier.now:
            self._advance_frontier(t)
            return False, self._frontier.fork()
        j = bisect.bisect_right(self._times, t) - 1
        if j >= 0:
            f = self._sims[j].fork()
            f.run_until(t)
            return True, f
        # no checkpoint early enough (evicted): fresh short replay
        sim = SlurmSimulator(self._frontier.cluster.n_nodes,
                             mode=self._frontier.mode, faults=self.faults)
        sim.load([copy.copy(j) for j in self.trace])
        sim.run_until(t)
        return False, sim

    def timeline(self):
        """The immutable ``BackgroundTimeline`` of this cache's replay,
        built lazily on first call (counted as one miss; every reuse is a
        hit). On a pristine frontier the recording drains the frontier
        itself, leaving warm checkpoints behind for later forks; otherwise
        a throwaway replay records (the replay engine is deterministic, so
        both record the same timeline)."""
        if self._timeline is not None:
            self.hits += 1
            return self._timeline
        from repro_torch.sim.timeline import BackgroundTimeline
        self.misses += 1
        fr = self._frontier
        if fr.now == 0.0 and fr._sched_passes == 0 and not self._sims:
            rec = BackgroundTimeline.record(fr)
            while True:
                tn = fr._next_event_time()
                if tn == float("inf"):
                    break
                t = max(tn, fr.now + self.interval)
                if not np.isfinite(t):
                    t = tn
                self._advance_frontier(float(t))
            sim = fr
        else:
            sim = SlurmSimulator(fr.cluster.n_nodes, mode=fr.mode,
                                 faults=self.faults)
            sim.load([copy.copy(j) for j in self.trace])
            rec = BackgroundTimeline.record(sim)
            sim.run_to_completion()
        self._timeline = BackgroundTimeline.from_recording(sim, rec,
                                                           self.faults)
        return self._timeline

    def _advance_frontier(self, t: float) -> None:
        fr = self._frontier
        if not self._sims:
            self._add(fr.now, fr.fork())     # pristine head checkpoint
        while True:
            nxt = (np.floor(fr.now / self.interval) + 1) * self.interval
            if nxt > t:
                break
            fr.run_until(float(nxt))
            self._add(float(nxt), fr.fork())
        fr.run_until(t)

    def _add(self, t: float, sim: SlurmSimulator) -> None:
        self._times.append(t)
        self._sims.append(sim)
        self._bytes.append(sim.fork_nbytes())
        while len(self._sims) > 2 and sum(self._bytes) > self.max_bytes:
            drop = range(len(self._sims) - 2, 0, -2)   # every other interior
            for k in drop:
                del self._times[k], self._sims[k], self._bytes[k]


class VectorProvisionEnv:
    """B ProvisionEnv episodes stepped in lockstep (batch-first API).

    ``reset()`` -> obs dict with "matrix" (B, k, 40), "summary" (B, 4m),
    "pred_remaining" (B,), "time_pos" (B,).
    ``step(actions)`` -> (obs, rewards (B,), dones (B,), infos list).

    Lanes that finish stay frozen (done=True, reward 0, no per-lane work)
    until the next reset. Lane i reproduces a scalar ProvisionEnv seeded
    ``seed + i`` exactly. The speedup comes from three places: the shared
    background replay is served from a ``ReplayCheckpointCache`` (pass
    ``cache=`` to share it across env instances/epochs; resets after the
    first fork from checkpoints instead of replaying the trace head), the
    whole observation pipeline is one numpy pass per lockstep interval
    (flat ``sample_batch`` -> segment-sorted ``encode_sample_batch`` ->
    per-lane-cursor ring), and obs are served as views of persistent
    buffers. Consumers must copy any obs array they retain across steps.
    """

    def __init__(self, trace: Sequence[Job], cfg: EnvConfig, batch: int,
                 seed: int = 0, cache: Optional[ReplayCheckpointCache] = None):
        assert batch >= 1
        self.trace = trace
        self.cfg = cfg
        self.batch = batch
        self.seed = seed
        self.envs = [ProvisionEnv(trace, cfg, seed=seed + i)
                     for i in range(batch)]
        self.cache = cache if cache is not None else ReplayCheckpointCache(
            trace, cfg.n_nodes, faults=cfg.faults)
        # under faults the predecessor is mutable (kill/requeue/restart):
        # the cached per-lane pred columns must be re-synced from the Job
        # objects each step. Fault-free envs never take that path.
        self._faulted = cfg.faults is not None and len(cfg.faults) > 0
        self.dones = np.ones(batch, bool)      # not yet reset
        k = cfg.history
        self._hist = StateHistoryBatch(batch, k)
        # persistent obs buffers (served as views; copy to retain)
        self._mat = np.zeros((batch, k, STATE_DIM), np.float32)
        self._summary = np.zeros((batch, 4 * STATE_DIM), np.float32)
        self._pred_remaining = np.zeros(batch, np.float64)
        self._time_pos = np.zeros(batch, np.float64)
        self._slab = np.empty((batch, STATE_DIM), np.float32)
        # per-lane episode state (raw predecessor features + end time)
        self._has_pred = np.zeros(batch, bool)
        self._pred_size = np.zeros(batch, np.float64)
        self._pred_limit = np.zeros(batch, np.float64)
        self._pred_qtime = np.zeros(batch, np.float64)
        self._pred_start = np.full(batch, -1.0, np.float64)
        self._pred_end = np.zeros(batch, np.float64)
        self._pred_rt = np.zeros(batch, np.float64)
        self._succ_cols = np.broadcast_to(
            np.array([float(cfg.chain_nodes), cfg.sub_limit], np.float64),
            (batch, 2))
        t0 = trace[0].submit_time
        self._trace_t0 = t0
        self._trace_span = max(trace[-1].submit_time - t0, 1.0)
        # differential-engine accounting, accumulated across resets:
        # lane-intervals served straight off the immutable timeline vs.
        # the total a fork-per-lane reset would have simulated
        self.reset_stats = {"diff_lanes": 0, "fallback_lanes": 0,
                            "starts": 0, "cascades": 0,
                            "hit_intervals": 0, "total_intervals": 0}

    @property
    def differential_hit_rate(self) -> float:
        """Fraction of lane-intervals served without a full fork."""
        total = self.reset_stats["total_intervals"]
        return self.reset_stats["hit_intervals"] / total if total else 0.0

    # ------------------------------------------------------------ helpers
    def _obs_view(self) -> Dict:
        return {"matrix": self._mat, "summary": self._summary,
                "pred_remaining": self._pred_remaining,
                "time_pos": self._time_pos}

    def _encode_lanes(self, lanes: np.ndarray) -> np.ndarray:
        """Sample + encode ``lanes``' simulators -> (n, 40) slab view."""
        sb = sample_batch([self.envs[int(i)].sim for i in lanes])
        pred_cols = None
        if self._has_pred[lanes].any():
            pred_cols = np.zeros((lanes.size, 4), np.float64)
            m = self._has_pred[lanes]
            l = lanes[m]
            pred_cols[m, 0] = self._pred_size[l]
            pred_cols[m, 1] = self._pred_limit[l]
            pred_cols[m, 2] = self._pred_qtime[l]
            st = self._pred_start[l]
            pred_cols[m, 3] = np.where(
                st >= 0, np.maximum(sb.times[m] - st, 0.0), 0.0)
        out = self._slab[:lanes.size]
        return encode_sample_batch(sb, self.cfg.n_nodes, self.cfg.sub_limit,
                                   pred_cols, self._succ_cols[:lanes.size],
                                   out=out)

    def _refresh_obs(self, lanes: np.ndarray) -> None:
        """Re-materialize ``lanes``' rows of the served obs buffers."""
        if not lanes.size:
            return
        self._hist.matrix_into(self._mat, lanes)
        summary_features_batch(self._mat, lanes, self._summary)
        nows = np.fromiter((self.envs[int(i)].sim.now for i in lanes),
                           np.float64, lanes.size)
        started = self._pred_start[lanes] >= 0
        self._pred_remaining[lanes] = np.where(
            started,
            self._pred_start[lanes] + self._pred_limit[lanes] - nows,
            self.cfg.sub_limit)
        self._time_pos[lanes] = (nows - self._trace_t0) / self._trace_span

    def _sync_pred_state(self, lanes: np.ndarray) -> None:
        """Faulted envs only: refresh the cached per-lane predecessor
        columns from the Job objects, which a node failure can mutate
        (kill resets start to -1; a later restart sets it anew). Matches
        the scalar env, which reads the live attrs every step. A down
        predecessor has no known end (inf): it cannot force a reactive
        submission until it restarts."""
        if not lanes.size:
            return
        starts = np.fromiter(
            (self.envs[int(i)].pred.start_time for i in lanes),
            np.float64, lanes.size)
        self._pred_start[lanes] = starts
        self._pred_qtime[lanes] = np.where(
            starts >= 0,
            np.fromiter((self.envs[int(i)].pred.wait_time for i in lanes),
                        np.float64, lanes.size).clip(min=0.0), 0.0)
        self._pred_end[lanes] = np.where(
            starts >= 0,
            starts + np.minimum(self._pred_rt[lanes],
                                self._pred_limit[lanes]),
            np.inf)

    @property
    def _t_start_range(self) -> Tuple[float, float]:
        return self.envs[0]._t_start_range

    # ------------------------------------------------------------ episode
    def _push_rows(self, lanes: np.ndarray, ts: np.ndarray,
                   diff: np.ndarray, tl) -> None:
        """One warm-up history push for ``lanes``: differential lanes
        sample the shared immutable timeline in one fused pass, fallback
        lanes sample their live simulators (warm-up has no predecessor,
        so pred columns are zero either way)."""
        d = lanes[diff[lanes]]
        if d.size:
            sb = tl.sample_lanes(ts[d])
            out = encode_sample_batch(sb, self.cfg.n_nodes,
                                      self.cfg.sub_limit, None,
                                      self._succ_cols[:d.size],
                                      out=self._slab[:d.size])
            self._hist.push(out, d)
        f = lanes[~diff[lanes]]
        if f.size:
            self._hist.push(self._encode_lanes(f), f)

    def reset(self, t_starts: Optional[Sequence[float]] = None) -> Dict:
        lo, hi = self._t_start_range
        t0s = np.array([float(t_starts[i]) if t_starts is not None
                        else float(env.rng.uniform(lo, hi))
                        for i, env in enumerate(self.envs)], np.float64)
        wps = np.array([self.envs[i].warmup_point(t0s[i])
                        for i in range(self.batch)], np.float64)
        # differential lanes are served from the immutable background
        # timeline (no per-lane simulator until the predecessor placement
        # materializes one); lanes whose episode reaches the first fault
        # event — where the timeline stops being the truth — fall back to
        # the classic fork-per-lane path
        tl = self.cache.timeline() if self.cfg.differential else None
        diff = (np.isfinite(t0s) & (t0s < tl.valid_until)
                if tl is not None else np.zeros(self.batch, bool))
        fb = np.flatnonzero(~diff)
        # checkpointed forks, ascending so the frontier advances monotonically
        for i in fb[np.argsort(wps[fb], kind="stable")]:
            i = int(i)
            self.envs[i].sim = self.cache.fork_at(wps[i])
        for env in self.envs:   # repro-static: ok[lane-loop] per-lane attribute clears
            env.hist = None          # the batch ring owns history now
            env.pred = env.succ = env.chain = None
        for i in np.flatnonzero(diff):
            self.envs[int(i)].sim = None     # materialized after placement
        self._hist.clear()
        self._has_pred[:] = False
        self._pred_start[:] = -1.0
        idx = np.arange(self.batch)
        # warm-up fill, batched: each lane replays the scalar push sequence
        # (snapshot at the window head, one per interval crossing) but the
        # per-lane instants advance as one float64 array — elementwise
        # identical to each scalar simulator's own now += interval
        ends = wps + np.maximum(t0s - wps, 0.0)
        ts = wps.copy()
        pushes = np.ones(self.batch, np.int64)
        self._push_rows(idx, ts, diff, tl)
        active = idx
        while True:
            active = active[ts[active] + self.cfg.interval <= ends[active]]
            if not active.size:
                break
            ts[active] = ts[active] + self.cfg.interval
            for i in active[~diff[active]]:   # repro-static: ok[lane-loop] fallback lanes advance live simulators
                self.envs[int(i)].sim.step(self.cfg.interval)
            pushes[active] += 1
            self._push_rows(active, ts, diff, tl)
        # partial advance to the episode start (exact float expression of
        # the scalar step(end - now)), then the predecessor placement
        t0_eff = np.where(ts < ends, ts + (ends - ts), ts)
        st = self.reset_stats
        for i in range(self.batch):   # repro-static: ok[lane-loop] per-lane rng draws + placement materialization
            env = self.envs[i]
            t0i = float(t0_eff[i])
            env.chain = SubJobChain(
                user_id=int(env.rng.integers(1000, 2000)),
                n_nodes=self.cfg.chain_nodes, sub_limit=self.cfg.sub_limit,
                next_id=int(env.rng.integers(10**6, 10**7)))
            env.pred = env.chain.make_sub(0, t0i)
            if diff[i]:
                pl = tl.place(t0i, env.pred.n_nodes, env.pred.time_limit,
                              env.pred.runtime, env.pred.job_id,
                              self.cfg.interval)
                if pl.kind == "start":
                    # proved: the job starts at pl.t without displacing
                    # any background start — fork the background there
                    # and splice the job in at its in-pass position
                    sim = self.cache.fork_quiet(pl.t)
                    sim.adopt_running(env.pred, pl.t, pl.pass_pos,
                                      pl.pass_size)
                    st["starts"] += 1
                    st["hit_intervals"] += int(pushes[i]) + pl.intervals
                elif pl.kind == "cascade" and pl.t > t0i:
                    # provable cascade past t0: sync a real fork at the
                    # last verified-inert instant with the job queued
                    # (original submit time — age priority survives)
                    sim = self.cache.fork_quiet(pl.t)
                    sim.adopt_queued(env.pred)
                    sim.run_until_started(env.pred)
                    st["cascades"] += 1
                    st["hit_intervals"] += int(pushes[i]) + pl.intervals
                else:
                    # cascade at the submission instant itself: replay
                    # the whole decision on a real fork from t0
                    sim = self.cache.fork_quiet(t0i)
                    sim.submit(env.pred)
                    sim.run_until_started(env.pred)
                    st["cascades"] += 1
                    st["hit_intervals"] += int(pushes[i])
                env.sim = sim
                st["diff_lanes"] += 1
            else:
                if env.sim.now < ends[i]:
                    env.sim.step(ends[i] - env.sim.now)
                env.sim.submit(env.pred)
                env.sim.run_until_started(env.pred)
                st["fallback_lanes"] += 1
            env._fc0 = (env.sim.n_node_failures, env.sim.n_requeues)
        starts = np.fromiter((e.pred.start_time for e in self.envs),
                             np.float64, self.batch)
        self._pred_size[:] = np.fromiter(
            (e.pred.n_nodes for e in self.envs), np.float64, self.batch)
        self._pred_limit[:] = np.fromiter(
            (e.pred.time_limit for e in self.envs), np.float64, self.batch)
        self._pred_rt[:] = np.fromiter(
            (e.pred.runtime for e in self.envs), np.float64, self.batch)
        self._pred_qtime[:] = np.maximum(np.fromiter(
            (e.pred.wait_time for e in self.envs), np.float64, self.batch),
            0.0)
        self._pred_start[:] = starts
        self._pred_end[:] = starts + np.minimum(self._pred_rt,
                                                self._pred_limit)
        span = np.maximum(starts - t0_eff, 0.0)
        st["total_intervals"] += int(pushes.sum()) + int(
            (span // max(self.cfg.interval, 1.0)).sum()) + self.batch
        self._has_pred[:] = True
        self._hist.push(self._encode_lanes(idx), idx)
        self.dones = np.zeros(self.batch, bool)
        self._refresh_obs(idx)
        return self._obs_view()

    def resized(self, n: int) -> "VectorProvisionEnv":
        """A new vector env with batch size ``n`` sharing this env's
        trace, config, seed, and checkpoint cache — evaluate_batch's tail
        chunks stop re-plumbing constructor arguments through call sites."""
        if n == self.batch:
            return self
        return VectorProvisionEnv(self.trace, self.cfg, n, seed=self.seed,
                                  cache=self.cache)

    def step(self, actions: Sequence[int]
             ) -> Tuple[Dict, np.ndarray, np.ndarray, List[Dict]]:
        actions = np.asarray(actions, np.int64)
        rewards = np.zeros(self.batch, np.float64)
        infos: List[Dict] = [{} for _ in range(self.batch)]
        live = np.flatnonzero(~self.dones)
        if not live.size:
            return self._obs_view(), rewards, self.dones.copy(), infos
        if self._faulted:
            self._sync_pred_state(live)
        nows = np.fromiter((self.envs[int(i)].sim.now for i in live),
                           np.float64, live.size)
        forced = (actions[live] == 0) & (
            nows + self.cfg.interval >= self._pred_end[live])
        submit = (actions[live] == 1) | forced
        sub_idx = live[submit]
        wait_idx = live[~submit]
        # submitting lanes finish: their obs window freezes at the current
        # per-lane cursor (the scalar env pushes nothing on submission)
        for i, f in zip(sub_idx, forced[submit]):
            i = int(i)
            r, info = self.envs[i]._submit_successor(bool(f))
            rewards[i] = r
            infos[i] = info
            self.dones[i] = True
        # waiting lanes advance one interval and push one batched slab
        step_batch([self.envs[int(i)].sim for i in wait_idx],
                   self.cfg.interval)
        if self._faulted:
            # the advance (and the successor waits above) may have killed
            # or restarted predecessors: re-sync before encoding/serving
            self._sync_pred_state(live)
        if wait_idx.size:
            self._hist.push(self._encode_lanes(wait_idx), wait_idx)
        self._refresh_obs(np.concatenate([wait_idx, sub_idx]))
        return self._obs_view(), rewards, self.dones.copy(), infos


# ------------------------------------------------------- offline sampling
def collect_offline_samples(env: ProvisionEnv, n_episodes: int,
                            n_points: int = 7, seed: int = 0,
                            batch: Optional[int] = None) -> List[Dict]:
    """§4.9.1(a): per episode, probe ``n_points`` evenly spaced submission
    instants between warm-up and the predecessor's end; record
    (state matrix, summary, observed reward, outcome).

    Probes run on a VectorProvisionEnv: all points of one episode share a
    start instant, so they fork from the same background state and the
    whole (episode x point) grid rolls out in lockstep batches off one
    shared ReplayCheckpointCache (chunks after the first fork from warm
    checkpoints instead of re-replaying the trace head).
    """
    # function-local: scenarios imports repro.core lazily, so a module-
    # level import here would complete the cycle
    from repro_torch.sim.scenarios import make_vector_env
    rng = np.random.default_rng(seed)
    lo, hi = env._t_start_range
    ep_t0 = [float(rng.uniform(lo, hi)) for _ in range(n_episodes)]
    lanes = [(ep, p) for ep in range(n_episodes) for p in range(n_points)]
    out: List[Optional[Dict]] = [None] * len(lanes)
    B = batch or min(len(lanes), 32)
    cache = env.cache or ReplayCheckpointCache(env.trace, env.cfg.n_nodes,
                                               faults=env.cfg.faults)
    for c0 in range(0, len(lanes), B):
        chunk = lanes[c0:c0 + B]
        n = len(chunk)
        venv = make_vector_env(env.trace, env.cfg, n,
                               seed=seed + c0, cache=cache)
        obs = venv.reset(t_starts=[ep_t0[ep] for ep, _ in chunk])
        fracs = np.array([(p + 0.5) / n_points for _, p in chunk],
                         np.float64)
        targets = np.fromiter(
            (venv.envs[i].pred.start_time for i in range(n)),
            np.float64, n) + fracs * env.cfg.sub_limit
        # per lane: the observation after the last wait step feeds the
        # sample; the reward comes from the (possibly forced) submission.
        # obs arrays are views of the env's persistent buffers -> copied
        # wholesale; a lane's rows freeze once it stops waiting.
        mats = obs["matrix"].copy()
        tps = obs["time_pos"].copy()
        rewards = np.zeros(n, np.float64)
        kinds = [""] * n
        waits = np.zeros(n, np.float64)
        while not venv.dones.all():
            nows = np.fromiter((e.sim.now for e in venv.envs),
                               np.float64, n)
            acts = np.where(~venv.dones
                            & (nows + env.cfg.interval < targets), 0, 1)
            was_done = venv.dones.copy()
            nobs, r, dones, infos = venv.step(acts)
            newly = ~was_done & dones
            waiting = ~was_done & ~dones
            rewards[newly] = r[newly]
            for i in np.flatnonzero(newly).tolist():
                kinds[i] = infos[i].get("kind", "")
                waits[i] = float(infos[i].get("wait_s", 0.0))
            # still-waiting lanes roll their pre-submit obs forward
            mats[waiting] = nobs["matrix"][waiting]
            tps[waiting] = nobs["time_pos"][waiting]
        for i in range(n):      # boundary: materialize the sample dicts
            out[c0 + i] = {
                "matrix": mats[i],
                "summary": summary_features(mats[i]),
                "reward": float(rewards[i]),
                "kind": kinds[i],
                "wait_s": waits[i],
                "time_pos": float(tps[i]),
            }
    return [s for s in out if s is not None]
