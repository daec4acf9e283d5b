"""Self-healing provisioning control plane (robustness layer).

The data plane (simulator + policy) decides *when* to submit; this module
makes the *act of provisioning* survive the failures a real batch cluster
throws at it:

* ``RetryPolicy`` — seeded-jitter exponential backoff with a wall-clock
  deadline around transient control errors. Retries consume wall time
  only (``sleep``/``clock`` are injectable), never simulated time, so a
  retried submission lands at the same simulated instant as a clean one
  — the schedule is invariant to the error sequence.
* ``ControlPlane`` — fault-injectable submit/cancel facade over a
  simulator: the k-th control operation sees
  ``FaultPlan.ctrl_failures(k)`` transient errors before succeeding.
  Because that count is a pure function of ``(ctrl_seed, k)``, a
  restarted driver replays the exact error sequence it saw before the
  crash.
* ``DecisionJournal`` — crash-safe append-only msgpack log of every
  provisioning decision. Records are length+CRC framed and flushed +
  fsynced per append, so replay distinguishes a torn trailing record
  (crash mid-write: silently dropped) from mid-file corruption
  (``JournalCorruptionError`` — never a silent divergent resume).
* ``ChainLane`` — the stepwise core of a journaled chain: a re-entrant
  state machine (``begin`` -> ``apply`` per decision -> ``done``) that
  replays its journal prefix on ``begin`` and journals every live
  decision before applying it. ``ChainDriver`` runs one lane to
  completion; ``repro.serve.provision_service`` multiplexes many.
* ``CircuitBreaker`` — fleet-wide learner protection for the serving
  path: after ``threshold`` failures (exceptions / deadline overruns)
  in a sliding window of outcomes it trips open and decisions degrade
  to the reactive heuristic; after ``cooldown_s`` a half-open probe
  consults the learner again and closes on success.
* ``ChainDriver`` — drives a k-link sub-job chain end to end on a
  ``ProvisionEnv``: per decision interval it consults a
  ``FallbackPolicy``-wrapped policy (graceful degradation to the
  reactive heuristic on exceptions / deadline overruns), journals the
  decision, and submits each successor through the retried control
  plane. Killed mid-chain (``PreemptionGuard.trigger()``), a fresh
  driver pointed at the same journal replays the logged decisions
  without consulting the policy, reconstructs the identical simulator
  state, and resumes — the final schedule is bit-identical to an
  uninterrupted run.
"""
from __future__ import annotations

import dataclasses
import os
import struct
import time
import zlib
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

from repro_torch import _msgpack as msgpack
import numpy as np

from repro_torch.sim.faults import FaultPlan
from repro_torch.sim.trace import Job
from repro_torch.sim.workload import pair_outcome
from repro_torch.train.fault import PreemptionGuard
from .policy import FallbackPolicy, Policy, batch_obs
from .provisioner import EnvConfig, ProvisionEnv, ReplayCheckpointCache
from .reward import shape_reward

HOUR = 3600.0

#: journal format version (header record); v2 added per-record framing
JOURNAL_VERSION = 2


class TransientControlError(RuntimeError):
    """A control-plane operation (submit/cancel) failed transiently and
    may be retried."""


class RetryExhaustedError(TransientControlError):
    """A retried operation gave up — names the op, the attempt count and
    the elapsed wall time (chained from the last transient error)."""


class JournalCorruptionError(RuntimeError):
    """A ``DecisionJournal`` holds corrupt bytes *before* its final
    record — resuming from it would silently diverge, so replay refuses."""


class RetryPolicy:
    """Seeded-jitter exponential backoff with a deadline.

    ``call(fn)`` invokes ``fn`` until it succeeds, retrying on
    ``TransientControlError`` with delay ``min(base * 2**k, max) *
    (0.5 + u)`` for a seeded uniform ``u`` — jittered so a fleet of
    drivers doesn't thundering-herd the controller, seeded so tests are
    deterministic. Gives up after ``max_attempts`` attempts or once the
    next delay would overrun ``deadline_s`` of wall time (a delay
    landing *exactly* on the deadline is still taken — the deadline is
    inclusive), raising ``RetryExhaustedError`` naming the op, attempt
    count and elapsed wall time, chained from the last transient error.
    ``sleep``/``clock`` are injectable; simulated time is never touched.
    """

    def __init__(self, max_attempts: int = 6, base_delay_s: float = 0.05,
                 max_delay_s: float = 2.0, deadline_s: float = 30.0,
                 seed: int = 0,
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic):
        assert max_attempts >= 1
        self.max_attempts = max_attempts
        self.base_delay_s = base_delay_s
        self.max_delay_s = max_delay_s
        self.deadline_s = deadline_s
        self._rng = np.random.default_rng(seed)
        self._sleep = sleep
        self._clock = clock

    def call(self, fn: Callable[[], object], op_name: str = "op"
             ) -> Tuple[object, int]:
        """Run ``fn`` with retries; returns ``(result, n_retries)``."""
        t0 = self._clock()
        attempt = 0
        while True:
            try:
                return fn(), attempt
            except TransientControlError as e:
                attempt += 1
                elapsed = self._clock() - t0
                if attempt >= self.max_attempts:
                    raise RetryExhaustedError(
                        f"{op_name}: gave up after {attempt} attempts "
                        f"({elapsed:.3f}s elapsed)") from e
                d = min(self.base_delay_s * 2.0 ** (attempt - 1),
                        self.max_delay_s)
                d *= 0.5 + float(self._rng.random())
                if elapsed + d > self.deadline_s:
                    raise RetryExhaustedError(
                        f"{op_name}: next delay ({d:.3f}s) would overrun "
                        f"the {self.deadline_s:.3f}s deadline after "
                        f"{attempt} attempts ({elapsed:.3f}s elapsed)"
                    ) from e
                self._sleep(d)


class ControlPlane:
    """Fault-injectable submit/cancel facade over a ``SlurmSimulator``.

    Operations are numbered in issue order; operation ``k`` raises
    ``TransientControlError`` exactly ``plan.ctrl_failures(k)`` times
    before taking effect (the error is checked *before* the simulator
    mutates, so a failed attempt is side-effect free). With no plan (or
    ``ctrl_error_rate == 0``) every operation succeeds first try.
    """

    def __init__(self, faults: Optional[FaultPlan],
                 retry: Optional[RetryPolicy] = None):
        self.faults = faults
        self.retry = retry or RetryPolicy()
        self.n_ops = 0
        self.n_errors = 0
        self.n_retries = 0

    def _attempts(self, op: int) -> int:
        if self.faults is None:
            return 0
        return self.faults.ctrl_failures(op)

    def _op(self, fn: Callable[[], object], name: str) -> object:
        op = self.n_ops
        self.n_ops += 1
        state = {"left": self._attempts(op)}

        def attempt():
            if state["left"] > 0:
                state["left"] -= 1
                self.n_errors += 1
                raise TransientControlError(f"{name} #{op}")
            return fn()

        result, retries = self.retry.call(attempt, op_name=name)
        self.n_retries += retries
        return result

    def submit(self, sim, job: Job) -> None:
        self._op(lambda: sim.submit(job), "submit")

    def cancel(self, sim, job_id: int) -> bool:
        return bool(self._op(lambda: sim.cancel(job_id), "cancel"))


#: per-record frame header: little-endian (body length, crc32(body))
_FRAME = struct.Struct("<II")


class DecisionJournal:
    """Crash-safe append-only msgpack decision log with framed records.

    Each ``append`` writes one frame — a (length, crc32) header followed
    by the msgpack body — in a single write, then flush+fsyncs, so a
    record is either fully on disk or a strict prefix of a frame at the
    tail. ``replay`` therefore distinguishes the two failure shapes: a
    *torn tail* (short final frame from a mid-write crash) is silently
    dropped, while corrupt bytes anywhere before the end of the file (a
    CRC or decode mismatch on a complete frame) raise
    ``JournalCorruptionError`` instead of silently truncating the log —
    resuming from a silently-truncated journal would diverge. The first
    record is a header pinning (version, seed, links) — resuming with a
    mismatched configuration is an error, not silent divergence.
    """

    def __init__(self, path: str):
        self.path = path

    def append(self, record: Dict) -> None:
        body = msgpack.packb(record, use_bin_type=True)
        frame = _FRAME.pack(len(body), zlib.crc32(body)) + body
        with open(self.path, "ab") as f:
            f.write(frame)
            f.flush()
            os.fsync(f.fileno())

    def replay(self) -> List[Dict]:
        """All complete records on disk, in append order. A torn tail is
        truncated away (redo-log recovery) so subsequent appends extend
        the durable prefix instead of landing after garbage bytes."""
        if not os.path.exists(self.path):
            return []
        with open(self.path, "rb") as f:
            blob = f.read()
        out: List[Dict] = []
        off, size = 0, len(blob)
        while off < size:
            if size - off < _FRAME.size:
                break                     # torn tail: partial frame header
            length, crc = _FRAME.unpack_from(blob, off)
            body = blob[off + _FRAME.size: off + _FRAME.size + length]
            if len(body) < length:
                break                     # torn tail: partial frame body
            if zlib.crc32(body) != crc:
                raise JournalCorruptionError(
                    f"{self.path}: CRC mismatch in complete record at "
                    f"byte {off} (record {len(out)}) — journal is "
                    "corrupt, refusing a divergent resume")
            try:
                out.append(msgpack.unpackb(body, raw=False))
            except Exception as e:
                raise JournalCorruptionError(
                    f"{self.path}: undecodable record at byte {off} "
                    f"(record {len(out)}): {e}") from e
            off += _FRAME.size + length
        if off < size:                    # discard the torn tail on disk
            with open(self.path, "rb+") as f:
                f.truncate(off)
                f.flush()
                os.fsync(f.fileno())
        return out


class CircuitBreaker:
    """Fleet-wide learner circuit breaker (closed -> open -> half-open).

    The serving path records one outcome per learner consultation
    (``ok=False`` on an exception or decision-deadline overrun). When
    ``threshold`` failures accumulate in the sliding window of the last
    ``window`` outcomes, the breaker trips **open**: ``allow()`` returns
    False and every decision degrades to the reactive heuristic — the
    service keeps answering instead of hammering a sick learner. After
    ``cooldown_s`` of wall time (``clock`` injectable) the breaker goes
    **half-open**: ``allow()`` admits a probe consultation, whose
    outcome either closes the breaker or re-opens it for another
    cooldown. The window is outcome-counted (not wall-clock-bucketed)
    so chaos tests are deterministic under injected clocks.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, window: int = 16, threshold: int = 4,
                 cooldown_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic):
        assert 1 <= threshold <= window
        self.window = window
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._outcomes: Deque[bool] = deque(maxlen=window)
        self.state = self.CLOSED
        self.n_trips = 0
        self._opened_at = 0.0

    def trip(self) -> None:
        """Force the breaker open (chaos harness / degraded-mode bench)."""
        self.state = self.OPEN
        self.n_trips += 1
        self._opened_at = self._clock()
        self._outcomes.clear()

    def record(self, ok: bool) -> None:
        """One learner-consultation outcome."""
        if self.state == self.HALF_OPEN:
            if ok:
                self.state = self.CLOSED
                self._outcomes.clear()
            else:
                self.trip()
            return
        self._outcomes.append(ok)
        if (self.state == self.CLOSED
                and sum(1 for o in self._outcomes if not o)
                >= self.threshold):
            self.trip()

    def allow(self) -> bool:
        """May the next decision consult the learner? (Open breakers
        transition to half-open once the cooldown elapses.)"""
        if self.state == self.OPEN and (self._clock() - self._opened_at
                                        >= self.cooldown_s):
            self.state = self.HALF_OPEN
        return self.state != self.OPEN


@dataclasses.dataclass
class ChainResult:
    """Outcome of one ``ChainDriver.run``."""
    reason: str                               # "completed" | "preempted"
    outcomes: List[Dict]                      # one per submitted link
    schedule: List[Tuple[int, float, float]]  # (job_id, start, end) per sub
    n_decisions: int = 0
    n_replayed: int = 0
    n_fallbacks: int = 0
    n_retries: int = 0
    n_ctrl_errors: int = 0
    # owned attribution: fault events that killed >=1 of THIS chain's
    # jobs, and this chain's requeues — background jobs dying elsewhere
    # on the cluster are nobody's interruption (they used to be counted
    # here as fleet-aggregated simulator totals)
    n_faults: int = 0
    n_requeues: int = 0

    @property
    def interruption_h(self) -> float:
        return sum(o["amount_s"] for o in self.outcomes
                   if o["kind"] == "interrupt") / HOUR

    @property
    def overlap_h(self) -> float:
        return sum(o["amount_s"] for o in self.outcomes
                   if o["kind"] == "overlap") / HOUR


class ChainLane:
    """The stepwise core of one journaled ``links``-link chain.

    Reuses ``ProvisionEnv``'s episode machinery (warm-up, history window,
    observation encoding) but rolls the chain forward instead of ending
    after one pair: once link ``i``'s successor starts, it becomes the
    next link's predecessor and the decision loop continues.

    A lane is a re-entrant state machine so a multiplexing service can
    interleave many of them: ``begin()`` resets the episode, replays the
    journal prefix (no policy consultation — counted in ``n_replayed``)
    and leaves ``obs`` ready; while ``needs_decision``, the caller
    produces one action per call to ``apply(action, fell_back)``, which
    journals the decision *before* applying it (a crash in between
    re-applies it from the journal on restart — the applied effects live
    only in the in-memory simulator, which the restart reconstructs, so
    nothing is double-applied).

    Determinism contract: given the same ``(trace, cfg, seed, links,
    t_start)``, the sequence of *applied* decisions fully determines the
    final schedule — policy consultation, retries, fallbacks and load
    shedding only choose or delay decisions in wall-clock time, never
    simulated time. So a lane killed mid-chain and restarted against the
    same journal replays the logged decisions verbatim and produces a
    schedule identical to an uninterrupted run.
    """

    def __init__(self, trace: Sequence[Job], cfg: EnvConfig,
                 links: int = 3, seed: int = 0,
                 journal: Optional[DecisionJournal] = None,
                 retry: Optional[RetryPolicy] = None,
                 cache: Optional[ReplayCheckpointCache] = None):
        assert links >= 1
        self.env = ProvisionEnv(trace, cfg, seed=seed, cache=cache)
        self.links = links
        self.seed = seed
        self.journal = journal
        self.ctrl = ControlPlane(cfg.faults, retry=retry)
        self.obs: Optional[Dict] = None
        self.done = True            # not begun yet
        self.link = 0
        self.outcomes: List[Dict] = []
        self.n_decisions = self.n_replayed = self.n_fallbacks = 0
        self._di = 0
        self._seen: Dict[int, Tuple[float, float]] = {}
        # owned fault attribution (fed by the simulator's kill observer)
        self._owned: set = set()
        self._n_faults = 0
        self._n_requeues = 0

    # ------------------------------------------------------------ helpers
    def _check_header(self, replayed: List[Dict]) -> List[Dict]:
        if not replayed:
            return []
        hdr = replayed[0]
        if "co" in hdr:
            raise ValueError(
                f"journal header {hdr} was written by a co-sim service — "
                "its decisions replay in shared-round order, not per lane")
        if (hdr.get("v") != JOURNAL_VERSION or hdr.get("seed") != self.seed
                or hdr.get("links") != self.links):
            raise ValueError(
                f"journal header {hdr} does not match lane config "
                f"(seed={self.seed}, links={self.links})")
        return replayed[1:]

    def _on_fault_kills(self, job_ids: np.ndarray) -> None:
        """One fault event's requeued job ids: count the event (once) and
        the requeues against this chain iff they hit an owned job."""
        hit = sum(1 for jid in job_ids.tolist() if int(jid) in self._owned)
        if hit:
            self._n_faults += 1
            self._n_requeues += hit

    def _pred_end(self) -> float:
        pred = self.env.pred
        if pred.start_time < 0:      # fault-killed, still queued: unknown end
            return float("inf")
        return pred.start_time + min(pred.runtime, pred.time_limit)

    def _submit_link(self, link: int, forced: bool) -> Dict:
        """Submit link ``link``'s sub-job through the retried control
        plane, run it to start, score it against its predecessor, and
        roll the chain forward (successor becomes the next predecessor)."""
        env = self.env
        started = env.pred.start_time >= 0
        pred_end = self._pred_end()
        t_sub = (max(env.sim.now, pred_end) if forced and started
                 else env.sim.now)
        env.sim.run_until(t_sub)
        succ = env.chain.make_sub(link, t_sub)
        self._owned.add(succ.job_id)
        retries0, errors0 = self.ctrl.n_retries, self.ctrl.n_errors
        self.ctrl.submit(env.sim, succ)
        wait = env.sim.run_until_started(succ)
        pred = env.pred
        if pred.end_time < 0:
            if pred.start_time >= 0:
                pred.end_time = pred.start_time + min(pred.runtime,
                                                      pred.time_limit)
            else:
                pred.end_time = t_sub      # killed, never restarted
        kind, amount = pair_outcome(pred, succ)
        r = shape_reward(kind, amount, env.cfg.reward)
        info = {"link": link, "kind": kind, "amount_s": amount,
                "wait_s": wait, "forced": forced, "reward": r,
                "pred_id": pred.job_id, "succ_id": succ.job_id,
                "n_retries": self.ctrl.n_retries - retries0,
                "n_ctrl_errors": self.ctrl.n_errors - errors0}
        # the chain rolls forward: the successor is the next predecessor
        env.pred = succ
        env.succ = None
        env._fc0 = (env.sim.n_node_failures, env.sim.n_requeues)
        return info

    # ----------------------------------------------------------- stepping
    def begin(self, t_start: Optional[float] = None) -> None:
        """Reset the episode and rehydrate from the journal: the logged
        decision prefix is applied verbatim (no policy calls). ``t_start``
        pins the first link's episode start; by default it is drawn from
        the env's seeded rng (deterministic per seed, so restarts re-draw
        the identical instant)."""
        records = self.journal.replay() if self.journal else []
        replayed = self._check_header(records)
        if self.journal and not records:
            # fresh journal: write the header before the first decision
            self.journal.append({"v": JOURNAL_VERSION, "seed": self.seed,
                                 "links": self.links})
        self.obs = self.env.reset(t_start=t_start)
        self.link = 1
        self.done = False
        self.outcomes = []
        self.n_decisions = self.n_replayed = self.n_fallbacks = 0
        self._di = 0
        self._seen = {}
        # owned attribution window opens at the predecessor's start (the
        # single-tenant convention): the lane's private fork then notifies
        # us of every fault kill, and we count only the chain's own jobs
        self._owned = {self.env.pred.job_id}
        self._n_faults = self._n_requeues = 0
        self.env.sim.set_kill_observer(self._on_fault_kills)
        for rec in replayed:
            if self.done:       # journal longer than the chain: ignore tail
                break
            self.n_replayed += 1
            self._apply(int(rec["a"]), bool(rec["fb"]))

    @property
    def needs_decision(self) -> bool:
        return not self.done

    def apply(self, action: int, fell_back: bool = False) -> None:
        """Journal one live decision, then apply it to the simulator."""
        assert not self.done
        if self.journal:
            self.journal.append({"i": self._di, "a": int(action),
                                 "fb": bool(fell_back)})
        self._apply(int(action), bool(fell_back))

    def _apply(self, action: int, fell_back: bool) -> None:
        env = self.env
        self._di += 1
        self.n_decisions += 1
        self.n_fallbacks += int(fell_back)
        forced = (action == 0
                  and env.sim.now + env.cfg.interval >= self._pred_end())
        if action == 1 or forced:
            pred = env.pred
            info = self._submit_link(self.link, forced)
            self._seen[pred.job_id] = (pred.start_time, pred.end_time)
            self.outcomes.append(info)
            self.link += 1
            if self.link > self.links:
                self.done = True
        else:
            env._advance(env.cfg.interval)
        self.obs = env.obs()

    def result(self, reason: str) -> ChainResult:
        """Materialize the lane's outcome (projecting the live tail link
        into the schedule)."""
        tail = self.env.pred
        seen = dict(self._seen)
        if tail is not None and tail.job_id not in seen:
            end = (tail.start_time + min(tail.runtime, tail.time_limit)
                   if tail.start_time >= 0 else -1.0)
            seen[tail.job_id] = (tail.start_time, end)
        return ChainResult(
            reason=reason, outcomes=list(self.outcomes),
            schedule=sorted((jid, st, en) for jid, (st, en) in seen.items()),
            n_decisions=self.n_decisions, n_replayed=self.n_replayed,
            n_fallbacks=self.n_fallbacks, n_retries=self.ctrl.n_retries,
            n_ctrl_errors=self.ctrl.n_errors,
            n_faults=self._n_faults, n_requeues=self._n_requeues)


class ChainDriver:
    """Drives one ``ChainLane`` to completion with journaled decisions —
    the single-tenant front end of the stepwise lane machinery (the
    multi-tenant ``repro.serve.provision_service`` multiplexes many lanes
    over one policy and one checkpoint cache)."""

    def __init__(self, trace: Sequence[Job], cfg: EnvConfig, policy: Policy,
                 links: int = 3, seed: int = 0,
                 journal: Optional[DecisionJournal] = None,
                 guard: Optional[PreemptionGuard] = None,
                 retry: Optional[RetryPolicy] = None,
                 cache: Optional[ReplayCheckpointCache] = None,
                 decision_deadline_s: Optional[float] = None):
        self.lane = ChainLane(trace, cfg, links=links, seed=seed,
                              journal=journal, retry=retry, cache=cache)
        self.policy = (policy if isinstance(policy, FallbackPolicy)
                       else FallbackPolicy(policy,
                                           deadline_s=decision_deadline_s))
        self.guard = guard or PreemptionGuard(install_signals=False)

    # back-compat accessors (tests and the launcher poke at these)
    @property
    def env(self) -> ProvisionEnv:
        return self.lane.env

    @property
    def ctrl(self) -> ControlPlane:
        return self.lane.ctrl

    def run(self, t_start: Optional[float] = None) -> ChainResult:
        """Run the chain to completion (or preemption)."""
        lane = self.lane
        lane.begin(t_start=t_start)
        reason = "completed"
        while lane.needs_decision:
            if self.guard.should_stop():
                reason = "preempted"
                break
            fb0 = self.policy.n_fallbacks
            action = int(self.policy.act_batch(batch_obs(lane.obs))[0])
            lane.apply(action, fell_back=self.policy.n_fallbacks > fb0)
        return lane.result(reason)
