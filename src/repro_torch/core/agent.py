"""Mirage: the end-to-end provisioner (§5.1, Fig. 7), port of
``repro.core.agent``: the method registry, offline pretraining (§4.9.1),
online on-policy training (§4.9.2), ``EvalResult``, ``LearnerPolicy``,
``evaluate_batch`` and ``build_policy``.

Every numpy draw happens in the reference's order (the permutation of each
pretraining epoch, replay sampling, exploration, the seeds of the rollout
envs), so on weights converted from JAX the port takes the same decisions, with and
without the cross-tenant axis (``tenants > 1``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.sim.scenarios import make_co_vector_env, make_vector_env
from repro_torch.train.optimizer import (OptimizerConfig, adamw_update,
                                         init_opt_state)
from .baselines import AvgWaitPolicy, ReactivePolicy, TreePolicy
from .dqn import DQNConfig, DQNLearner, value_and_grad
from .foundation import FoundationConfig, init_foundation, reward_prediction
from .pg import PGConfig, PGLearner
from .policy import Policy
from .provisioner import (ProvisionEnv, ReplayCheckpointCache,
                          VectorProvisionEnv)
from .replay import ReplayBuffer
from .state import STATE_DIM
from .trees import GradientBoosting, RandomForest

HOUR = 3600.0

RL_METHODS = ("transformer+dqn", "transformer+pg", "moe+dqn", "moe+pg")
ALL_METHODS = ("reactive", "avg", "random_forest", "xgboost") + RL_METHODS
DEFAULT_METHOD = "moe+dqn"          # §6.3: balanced default
AGGRESSIVE_METHOD = "transformer+pg"


# --------------------------------------------------- offline pretraining
def pretrain_foundation(fc: FoundationConfig, samples: List[Dict],
                        epochs: int = 30, lr: float = 3e-4, seed: int = 0,
                        batch_size: int = 16, device=None
                        ) -> Tuple[Dict, List[float]]:
    """§4.9.1(b): supervised (state -> observed reward) pretraining of the
    trunk + V-head, the gate seeing each sample's time position. The
    weights are drawn from ``seed`` by ``init_foundation`` on ``device``
    (CUDA unless ``device="cpu"``); returns them trained, and the mean loss
    of each epoch."""
    dev = resolve_device(device)
    params = init_foundation(torch.Generator().manual_seed(seed), fc,
                             device=dev)
    ocfg = OptimizerConfig(lr=lr, warmup_steps=10, total_steps=max(
        epochs * max(len(samples) // batch_size, 1), 100), weight_decay=0.0)
    opt = init_opt_state(params, ocfg)
    X = torch.from_numpy(np.stack([s["matrix"] for s in samples]).astype(
        np.float32)).to(dev)
    y = torch.from_numpy(np.array([s["reward"] for s in samples],
                                  np.float32)).to(dev)
    tp = torch.from_numpy(np.array([s["time_pos"] for s in samples],
                                   np.float32)).to(dev)

    def loss_fn(p, xb, yb, tb):
        pred = reward_prediction(p, fc, xb, tb)
        return torch.mean(torch.square(pred - yb))

    rng = np.random.default_rng(seed)
    losses = []
    n = len(X)
    for ep in range(epochs):
        order = rng.permutation(n)
        tot = 0.0
        for i in range(0, n, batch_size):
            ids = torch.from_numpy(order[i:i + batch_size]).to(dev)
            loss, g = value_and_grad(loss_fn, params, X[ids], y[ids],
                                     tp[ids])
            params, opt, _ = adamw_update(g, params, opt, ocfg)
            tot += float(loss) * len(ids)
        losses.append(tot / n)
    return params, losses


# ------------------------------------------------------------ online RL
def _rollout_batch(venv: VectorProvisionEnv, act_batch) -> Tuple[
        List[List[Tuple]], np.ndarray]:
    """Roll every lane to termination; returns per-lane transition lists
    (s, a, s2, done) and the episode returns. The env serves obs as views
    of persistent buffers, so every retained matrix is copied here."""
    obs = venv.reset()
    B = venv.batch
    trajs: List[List[Tuple]] = [[] for _ in range(B)]
    finals = np.zeros(B)
    mats = obs["matrix"].copy()
    while not venv.dones.all():
        acts = act_batch(mats)
        live = ~venv.dones
        nobs, r, dones, _ = venv.step(acts)
        nmats = nobs["matrix"].copy()
        for i in np.flatnonzero(live):
            trajs[i].append((mats[i], int(acts[i]), nmats[i], bool(dones[i])))
            if dones[i]:
                finals[i] = r[i]
        mats = nmats
    return trajs, finals


def _make_train_env(env: ProvisionEnv, b: int, tenants: int, seed: int,
                    cache: ReplayCheckpointCache):
    """The per-iteration rollout env: a B-lane vector env, or — with a
    cross-tenant axis (``tenants > 1``) — a co-tenant env whose ``b``
    episode groups each hold ``tenants`` contending chains, so the
    policy trains against fleet-wide contention instead of per-chain
    isolation. Lanes flatten to ``b * tenants`` either way, and the
    rollout loop is axis-agnostic (a pending co-tenant lane records its
    decision as a no-op transition, exactly as the env applied it)."""
    if tenants <= 1:
        return make_vector_env(env.trace, env.cfg, b, seed=seed,
                               cache=cache)
    return make_co_vector_env(env.trace, env.cfg, b, tenants, seed=seed,
                              cache=cache)


def train_online_dqn(env: ProvisionEnv, learner: DQNLearner,
                     episodes: int = 30, replay_capacity: int = 2048,
                     seed: int = 0, batch: Optional[int] = None,
                     tenants: int = 1) -> List[float]:
    """Online training on batched rollouts: B episodes share one
    background replay (VectorProvisionEnv) and one forward on the
    learner's device per lockstep decision point; each finished episode's
    transitions enter the replay (Eq. 8: the outcome reward credits every
    action), followed by 4 ``train_on`` steps once the replay holds a
    batch."""
    assert tenants >= 1 and episodes % max(tenants, 1) == 0, \
        "episodes must be a multiple of the tenant count"
    buf = ReplayBuffer(replay_capacity, learner.fc.history, STATE_DIM, seed)
    returns: List[float] = []
    B = batch or min(episodes // tenants, 8)
    cache = env.cache or ReplayCheckpointCache(env.trace, env.cfg.n_nodes,
                                               faults=env.cfg.faults)
    while len(returns) < episodes:
        b = min(B, (episodes - len(returns)) // tenants)
        venv = _make_train_env(env, b, tenants, seed + len(returns), cache)
        trajs, finals = _rollout_batch(
            venv, lambda m: learner.act_batch(m, explore=True))
        for i in range(b * tenants):
            # Eq. 8: the outcome reward credits every action of the episode
            for (s, a, s2, d) in trajs[i]:
                buf.add(s, a, finals[i], s2, d)
            returns.append(float(finals[i]))
            if len(buf) >= learner.dc.batch_size:
                for _ in range(4):
                    learner.train_on(buf.sample(learner.dc.batch_size))
    return returns


def train_online_pg(env: ProvisionEnv, learner: PGLearner,
                    episodes: int = 30, seed: int = 0,
                    batch: Optional[int] = None,
                    tenants: int = 1) -> List[float]:
    """On-policy training: one ``train_on_episode`` per finished episode of
    each batched rollout."""
    assert tenants >= 1 and episodes % max(tenants, 1) == 0, \
        "episodes must be a multiple of the tenant count"
    returns: List[float] = []
    B = batch or min(episodes // tenants, 8)
    cache = env.cache or ReplayCheckpointCache(env.trace, env.cfg.n_nodes,
                                               faults=env.cfg.faults)
    while len(returns) < episodes:
        b = min(B, (episodes - len(returns)) // tenants)
        venv = _make_train_env(env, b, tenants, seed + len(returns), cache)
        trajs, finals = _rollout_batch(
            venv, lambda m: learner.act_batch(m, explore=True))
        for i in range(b * tenants):
            states = np.stack([t[0] for t in trajs[i]])
            actions = np.asarray([t[1] for t in trajs[i]], np.int64)
            learner.train_on_episode(states, actions, float(finals[i]))
            returns.append(float(finals[i]))
    return returns


# ------------------------------------------------------------- evaluation
@dataclasses.dataclass
class EvalResult:
    method: str
    interruptions_h: List[float]
    overlaps_h: List[float]
    waits_h: List[float]
    # robustness accounting (all zeros on fault-free cells): per-episode
    # node-failure / requeue counts observed during the decision window,
    # and how often a FallbackPolicy bypassed the method
    fault_counts: List[int] = dataclasses.field(default_factory=list)
    requeue_counts: List[int] = dataclasses.field(default_factory=list)
    fallbacks: int = 0

    @property
    def mean_interruption_h(self) -> float:
        return float(np.mean(self.interruptions_h)) if self.interruptions_h else 0.0

    @property
    def mean_overlap_h(self) -> float:
        return float(np.mean(self.overlaps_h)) if self.overlaps_h else 0.0

    @property
    def zero_interruption_frac(self) -> float:
        n = len(self.interruptions_h) + len(self.overlaps_h)
        zero = sum(1 for x in self.interruptions_h if x < 1e-6) + len(self.overlaps_h)
        return zero / max(n, 1)

    def summary(self) -> Dict[str, float]:
        return {"mean_interruption_h": self.mean_interruption_h,
                "mean_overlap_h": self.mean_overlap_h,
                "zero_interruption_frac": self.zero_interruption_frac,
                "n_episodes": len(self.interruptions_h) + len(self.overlaps_h),
                "n_faults": int(sum(self.fault_counts)),
                "n_requeues": int(sum(self.requeue_counts)),
                "n_fallbacks": int(self.fallbacks)}


class LearnerPolicy(Policy):
    """RL learner as an evaluation Policy: one forward on the learner's
    device decides the whole batch, exploration off (§4.4 serving mode)."""

    def __init__(self, method: str, learner):
        self.method = method
        self.learner = learner

    def act_batch(self, obs: Dict) -> np.ndarray:
        return self.learner.act_batch(np.asarray(obs["matrix"]),
                                      explore=False)


def _policy_method(policy) -> str:
    return getattr(policy, "method", "policy")


def evaluate_batch(venv: VectorProvisionEnv, policy: Policy,
                   episodes: Optional[int] = None, seed: int = 0,
                   t_starts: Optional[Sequence[float]] = None) -> EvalResult:
    """Batched evaluation: lockstep B-lane episodes off one shared
    ReplayCheckpointCache.

    Episode start instants are one uniform draw over the env's start
    range (``rng(seed).uniform(lo, hi, episodes)`` — the same sequence
    the scalar loop drew), or ``t_starts`` verbatim. They are processed
    in chunks of ``venv.batch`` lanes; a shorter tail chunk runs on a
    tail-sized env sharing ``venv``'s cache. Per-lane accounting matches
    the scalar loop (result order == start-instant order) because lane
    ``i`` is bit-identical to a scalar env seeded ``venv.seed + i``.

    Policy hooks: ``reset_lanes`` fires when a chunk begins;
    ``observe(infos)`` fires once per finished chunk with the B final
    infos — so within a chunk every lane acts under the same policy
    state (stateful policies like ``avg`` update between chunks; with a
    B=1 env that degenerates to updating between episodes, the legacy
    scalar-loop cadence).

    Robustness accounting: each final info's ``n_faults``/``n_requeues``
    (node failures / Slurm-style requeues observed during the decision
    window — zero on fault-free cells) land in ``fault_counts`` /
    ``requeue_counts``, and a ``FallbackPolicy`` wrapper's running
    ``n_fallbacks`` is copied into the result.
    """
    if t_starts is None:
        episodes = venv.batch if episodes is None else int(episodes)
        lo, hi = venv._t_start_range
        t_starts = np.random.default_rng(seed).uniform(lo, hi, episodes)
    t_starts = np.asarray(t_starts, np.float64)
    res = EvalResult(_policy_method(policy), [], [], [])
    for c0 in range(0, len(t_starts), venv.batch):
        chunk = t_starts[c0:c0 + venv.batch]
        v = venv
        if len(chunk) != venv.batch:          # tail chunk: smaller env,
            v = venv.resized(len(chunk))
        obs = v.reset(t_starts=chunk)
        policy.reset_lanes(np.ones(v.batch, bool))
        finals: List[Optional[Dict]] = [None] * v.batch
        while not v.dones.all():
            acts = policy.act_batch(obs)
            live = ~v.dones
            obs, r, dones, infos = v.step(acts)
            for i in np.flatnonzero(live & dones):
                finals[int(i)] = infos[int(i)]
        for info in finals:
            if info.get("kind") == "interrupt":
                res.interruptions_h.append(info["amount_s"] / HOUR)
            else:
                res.overlaps_h.append(info["amount_s"] / HOUR)
            res.waits_h.append(info.get("wait_s", 0.0) / HOUR)
            res.fault_counts.append(int(info.get("n_faults", 0)))
            res.requeue_counts.append(int(info.get("n_requeues", 0)))
        policy.observe(finals)
    res.fallbacks = int(getattr(policy, "n_fallbacks", 0))
    return res


# --------------------------------------------------------------- factory
def build_policy(method: str, env: ProvisionEnv,
                 offline_samples: Optional[List[Dict]] = None,
                 online_episodes: int = 20, pretrain_epochs: int = 10,
                 history: int = 144, reduced: bool = False,
                 seed: int = 0, device=None) -> Policy:
    """Train (if needed) and build the concrete Policy for one of the
    eight methods (ReactivePolicy / AvgWaitPolicy / TreePolicy /
    LearnerPolicy); the RL methods train on ``device`` (CUDA unless
    ``device="cpu"``)."""
    if method == "reactive":
        return ReactivePolicy()
    if method == "avg":
        return AvgWaitPolicy()
    assert offline_samples, f"{method} needs offline samples"
    if method in ("random_forest", "xgboost"):
        X = np.stack([s["summary"] for s in offline_samples])
        y = np.array([s["wait_s"] for s in offline_samples], np.float64)
        model = (RandomForest(n_trees=10, seed=seed) if method == "random_forest"
                 else GradientBoosting(n_rounds=25, seed=seed))
        model.fit(X, y)
        return TreePolicy(model, method)
    kind = "moe" if method.startswith("moe") else "transformer"
    fc = FoundationConfig(kind=kind, history=history)
    if reduced:
        fc = fc.reduced()
        fc = dataclasses.replace(fc, kind=kind, history=history)
    params, _ = pretrain_foundation(fc, offline_samples,
                                    epochs=pretrain_epochs, seed=seed,
                                    device=device)
    if method.endswith("dqn"):
        learner = DQNLearner(fc, DQNConfig(), seed=seed, params=params,
                             device=device)
        train_online_dqn(env, learner, episodes=online_episodes, seed=seed)
    else:
        learner = PGLearner(fc, PGConfig(), seed=seed, params=params,
                            device=device)
        train_online_pg(env, learner, episodes=online_episodes, seed=seed)
    return LearnerPolicy(method, learner)
