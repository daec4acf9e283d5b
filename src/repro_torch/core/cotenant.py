"""``CoTenantVectorEnv``: the cross-tenant batched episode environment.

``VectorProvisionEnv`` steps B *independent* episodes — each lane owns a
forked simulator, so tenants never contend. This env adds the tenant
axis: G lane-groups x T tenants, where each group's T tenant chains are
injected into ONE shared ``MultiTenantSim`` and contend for the same
nodes. The flattened batch is row-major group-major (lane ``g*T + t`` is
group ``g``'s tenant ``t``), so the batched consumers — ``act_batch``
policies, ``_rollout_batch``, the DQN/PG training loops — work on it
unchanged.

Observation dict: the standard keys ("matrix", "summary",
"pred_remaining", "time_pos") with batch axis G*T, plus a "fleet" block
((G*T, FLEET_DIM) float32) summarizing the tenant population so a
fleet-aware policy can see contention pressure; policies that only read
the standard keys ignore it.

Step semantics per group round: every undecided tenant acts on the same
round-head instant; submissions are flushed in canonical order, then the
shared clock advances one lockstep interval (or fast-forwards when every
live tenant is pending). A tenant whose successor has been submitted is
*pending*: its matrix window freezes, its action is ignored until the
shared clock crosses the successor's start, at which point the pair is
scored with per-tenant attribution (wait, interruption, owned
fault/requeue counters) and the lane finishes.

Contract (pinned by ``tests/test_multitenant.py``): with ``tenants=1``
this env is bit-identical to ``make_vector_env``'s single-tenant engine
— observations, rewards, dones and infos — because the one-tenant round
protocol reduces operation-for-operation to the scalar
``_submit_successor`` sequence. Construct through
``repro.sim.make_co_vector_env`` (the factory owns cache wiring), not
directly.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.sim.multitenant import (FLEET_DIM, MultiTenantSim,
                                   make_tenant_chain, sample_tenant_batch)
from repro_torch.sim.trace import Job
from .provisioner import DAY, EnvConfig, ReplayCheckpointCache
from .reward import shape_reward
from .state import (STATE_DIM, StateHistoryBatch, encode_sample_batch,
                    summary_features_batch)


class CoTenantVectorEnv:
    """G groups x T contending tenants, flattened to a (G*T,) batch."""

    def __init__(self, trace: Sequence[Job], cfg: EnvConfig, groups: int,
                 tenants: int, seed: int = 0,
                 cache: Optional[ReplayCheckpointCache] = None):
        assert groups >= 1 and tenants >= 1
        self.trace = trace
        self.cfg = cfg
        self.groups = groups
        self.tenants = tenants
        self.batch = groups * tenants
        self.seed = seed
        self.cache = cache if cache is not None else ReplayCheckpointCache(
            trace, cfg.n_nodes, faults=cfg.faults)
        self.rngs = [np.random.default_rng(seed + g) for g in range(groups)]
        self.worlds: List[Optional[MultiTenantSim]] = [None] * groups
        self._faulted = cfg.faults is not None and len(cfg.faults) > 0
        self.dones = np.ones(self.batch, bool)       # not yet reset
        k = cfg.history
        B = self.batch
        self._hist = StateHistoryBatch(B, k)
        # persistent obs buffers (served as views; copy to retain)
        self._mat = np.zeros((B, k, STATE_DIM), np.float32)
        self._summary = np.zeros((B, 4 * STATE_DIM), np.float32)
        self._pred_remaining = np.zeros(B, np.float64)
        self._time_pos = np.zeros(B, np.float64)
        self._fleet = np.zeros((B, FLEET_DIM), np.float32)
        self._slab = np.empty((B, STATE_DIM), np.float32)
        # per-lane predecessor state (same layout as VectorProvisionEnv)
        self._pred_size = np.zeros(B, np.float64)
        self._pred_limit = np.zeros(B, np.float64)
        self._pred_qtime = np.zeros(B, np.float64)
        self._pred_start = np.full(B, -1.0, np.float64)
        self._pred_end = np.zeros(B, np.float64)
        self._pred_rt = np.zeros(B, np.float64)
        self._has_pred = np.zeros(B, bool)
        self._succ_cols = np.broadcast_to(
            np.array([float(cfg.chain_nodes), cfg.sub_limit], np.float64),
            (B, 2))
        t0 = trace[0].submit_time
        self._trace_t0 = t0
        self._trace_span = max(trace[-1].submit_time - t0, 1.0)
        self._t_start_range = (
            trace[0].submit_time + cfg.warmup,
            max(trace[-1].submit_time - 3 * cfg.sub_limit,
                trace[0].submit_time + cfg.warmup + DAY))

    # ------------------------------------------------------------ helpers
    def _obs_view(self) -> Dict:
        return {"matrix": self._mat, "summary": self._summary,
                "pred_remaining": self._pred_remaining,
                "time_pos": self._time_pos, "fleet": self._fleet}

    def _rows_of(self, g: int) -> np.ndarray:
        return g * self.tenants + np.arange(self.tenants)

    def _encode_rows(self, rows: np.ndarray) -> np.ndarray:
        """Sample + encode the shared flats for ``rows`` (sorted flat
        lane indices) -> (n, 40) slab view. The CSR lanes are carved by
        ``sample_tenant_batch``: one gather per distinct simulator,
        tiled per selected tenant row."""
        reps = np.bincount(rows // self.tenants, minlength=self.groups)
        sb = sample_tenant_batch(self.worlds, reps=reps)
        pred_cols = None
        if self._has_pred[rows].any():
            pred_cols = np.zeros((rows.size, 4), np.float64)
            m = self._has_pred[rows]
            l = rows[m]
            pred_cols[m, 0] = self._pred_size[l]
            pred_cols[m, 1] = self._pred_limit[l]
            pred_cols[m, 2] = self._pred_qtime[l]
            st = self._pred_start[l]
            pred_cols[m, 3] = np.where(
                st >= 0, np.maximum(sb.times[m] - st, 0.0), 0.0)
        out = self._slab[:rows.size]
        return encode_sample_batch(sb, self.cfg.n_nodes, self.cfg.sub_limit,
                                   pred_cols, self._succ_cols[:rows.size],
                                   out=out)

    def _refresh_obs(self, rows: np.ndarray) -> None:
        if not rows.size:
            return
        self._hist.matrix_into(self._mat, rows)
        summary_features_batch(self._mat, rows, self._summary)
        nows = np.fromiter(
            (self.worlds[int(i) // self.tenants].sim.now for i in rows),
            np.float64, rows.size)
        started = self._pred_start[rows] >= 0
        self._pred_remaining[rows] = np.where(
            started,
            self._pred_start[rows] + self._pred_limit[rows] - nows,
            self.cfg.sub_limit)
        self._time_pos[rows] = (nows - self._trace_t0) / self._trace_span

    def _refresh_fleet(self) -> None:
        T = self.tenants
        for g, world in enumerate(self.worlds):
            if world is not None:
                world.fleet_features(out=self._fleet[g * T:(g + 1) * T])

    def _sync_pred_state(self, rows: np.ndarray) -> None:
        """Faulted cells only: re-read the mutable predecessor Job attrs
        (a kill resets start to -1; a restart sets it anew). A down
        predecessor has no known end (inf) — it cannot force a reactive
        submission until it restarts."""
        if not rows.size:
            return
        T = self.tenants
        starts = np.fromiter(
            (self.worlds[int(i) // T].preds[int(i) % T].start_time
             for i in rows), np.float64, rows.size)
        self._pred_start[rows] = starts
        self._pred_qtime[rows] = np.where(
            starts >= 0,
            np.fromiter(
                (self.worlds[int(i) // T].preds[int(i) % T].wait_time
                 for i in rows), np.float64, rows.size).clip(min=0.0), 0.0)
        self._pred_end[rows] = np.where(
            starts >= 0,
            starts + np.minimum(self._pred_rt[rows], self._pred_limit[rows]),
            np.inf)

    # ------------------------------------------------------------ episode
    def warmup_point(self, t0: float) -> float:
        return max(t0 - self.cfg.history * self.cfg.interval, 0.0)

    def reset(self, t_starts: Optional[Sequence[float]] = None) -> Dict:
        """Start G fresh co-simulated groups. ``t_starts`` (optional) is
        per-GROUP (length ``groups``): one shared episode start per
        contending tenant population, not per flattened lane."""
        G, T = self.groups, self.tenants
        lo, hi = self._t_start_range
        t0s = np.array([float(t_starts[g]) if t_starts is not None
                        else float(self.rngs[g].uniform(lo, hi))
                        for g in range(G)], np.float64)
        wps = np.array([self.warmup_point(t0s[g]) for g in range(G)],
                       np.float64)
        # checkpointed forks, ascending so the frontier advances
        # monotonically; every group takes the classic fork path (the
        # differential one-job proof does not cover multi-injection)
        for g in np.argsort(wps, kind="stable"):
            g = int(g)
            self.worlds[g] = MultiTenantSim(self.cache.fork_at(wps[g]), T)
        self._hist.clear()
        self._has_pred[:] = False
        self._pred_start[:] = -1.0
        # warm-up fill: each group replays the scalar push sequence (one
        # encode per interval crossing, broadcast to its T tenant rows —
        # tenants share the window until the predecessors go in)
        gidx = np.arange(G)
        ends = wps + np.maximum(t0s - wps, 0.0)
        ts = wps.copy()
        self._push_groups(gidx, broadcast=True)
        act = gidx
        while True:
            act = act[ts[act] + self.cfg.interval <= ends[act]]
            if not act.size:
                break
            ts[act] = ts[act] + self.cfg.interval
            for g in act:
                self.worlds[int(g)].sim.step(self.cfg.interval)
            self._push_groups(act, broadcast=True)
        # partial advance to the episode start, then the contended
        # predecessor injection: all T preds enter the shared backlog at
        # the same instant (arrival ties break in tenant order), then run
        # to start in tenant order
        for g in range(G):
            world = self.worlds[g]
            if world.sim.now < ends[g]:
                world.sim.step(ends[g] - world.sim.now)
            rng = self.rngs[g]
            for t in range(T):
                world.submit_pred(t, make_tenant_chain(
                    t, rng, self.cfg.chain_nodes, self.cfg.sub_limit))
            world.start_preds()
        rows = np.arange(self.batch)
        T_ = self.tenants
        for r in rows:
            pred = self.worlds[int(r) // T_].preds[int(r) % T_]
            self._pred_size[r] = pred.n_nodes
            self._pred_limit[r] = pred.time_limit
            self._pred_rt[r] = pred.runtime
            self._pred_qtime[r] = max(pred.wait_time, 0.0)
            self._pred_start[r] = pred.start_time
        self._pred_end[:] = self._pred_start + np.minimum(
            self._pred_rt, self._pred_limit)
        self._has_pred[:] = True
        self._hist.push(self._encode_rows(rows), rows)
        self.dones = np.zeros(self.batch, bool)
        self._refresh_obs(rows)
        self._refresh_fleet()
        return self._obs_view()

    def _push_groups(self, groups_sel: np.ndarray, broadcast: bool) -> None:
        """One warm-up history push: encode each selected group's shared
        simulator once and broadcast the row to its T tenant lanes."""
        if not groups_sel.size:
            return
        T = self.tenants
        reps = np.zeros(self.groups, np.int64)
        reps[groups_sel] = 1
        sb = sample_tenant_batch(self.worlds, reps=reps)
        out = encode_sample_batch(sb, self.cfg.n_nodes, self.cfg.sub_limit,
                                  None, self._succ_cols[:groups_sel.size],
                                  out=self._slab[:groups_sel.size])
        rows = (np.repeat(groups_sel * T, T)
                + np.tile(np.arange(T), groups_sel.size))
        self._hist.push(np.repeat(out, T, axis=0), rows)

    def resized(self, n: int) -> "CoTenantVectorEnv":
        """A new env with ``n`` flattened lanes (must be a whole number
        of tenant groups) sharing trace/config/seed/cache."""
        if n == self.batch:
            return self
        assert n % self.tenants == 0, \
            f"batch {n} is not a multiple of tenants={self.tenants}"
        return CoTenantVectorEnv(self.trace, self.cfg, n // self.tenants,
                                 self.tenants, seed=self.seed,
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
        T = self.tenants
        wait_rows: List[np.ndarray] = []
        for g in range(self.groups):
            world = self.worlds[g]
            if world.done.all():
                continue
            base = g * T
            round_now = world.sim.now
            for t in np.flatnonzero(~world.done & ~world.pending):
                t = int(t)
                a = int(actions[base + t])
                forced = (a == 0 and round_now + self.cfg.interval
                          >= self._pred_end[base + t])
                if a == 1 or forced:
                    world.request_submit(t, forced)
            world.flush_submits()
            waiting = world.waiting
            if waiting.any():
                world.run_until(round_now + self.cfg.interval)
                wait_rows.append(base + np.flatnonzero(waiting))
            else:
                world.fast_forward()
            for out in world.resolve_ready():
                row = base + out.tenant
                rewards[row] = shape_reward(out.kind, out.amount_s,
                                            self.cfg.reward)
                infos[row] = {"kind": out.kind, "amount_s": out.amount_s,
                              "wait_s": out.wait_s, "forced": out.forced,
                              "n_faults": out.n_faults,
                              "n_requeues": out.n_requeues}
                world.finish(out.tenant)
                self.dones[row] = True
        if self._faulted:
            self._sync_pred_state(live)
        wr = (np.concatenate(wait_rows) if wait_rows
              else np.empty(0, np.int64))
        if wr.size:
            self._hist.push(self._encode_rows(wr), wr)
        # every lane live at the round head gets fresh scalars (waiting,
        # just-submitted, just-resolved, and pending carry-overs alike)
        self._refresh_obs(live)
        self._refresh_fleet()
        return self._obs_view(), rewards, self.dones.copy(), infos
