"""The provisioning service, the chain driver and the provision launcher on
the port's torch learners, against the JAX package's, on the CPU.

``repro_torch.core.control``, ``repro_torch.serve.cosim`` and
``repro_torch.serve.provision_service`` are verbatim copies of the
reference's numpy layers; what is new is the policy behind them, a torch
``DQNLearner``. Both packages' learners start from the same weights (JAX's
draw, converted) over the reduced ``moe`` trunk in fp32, so each live
decision is the same argmax; every run records the smallest Q gap the port
met and asserts that none fell within 1e-4, where the frameworks'
roundings could decide differently. Schedules are compared for equality.

The journals cross packages: the port writes its records with
``repro_torch._msgpack``, and a journal the JAX service wrote resumes in
the port's service to the JAX run's schedules.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.configs.mirage_agent as jagent_cfg
import repro.core as jcore
import repro.serve as jserve
import repro.sim as jsim
import repro_torch.configs.mirage_agent as tagent_cfg
import repro_torch.core as tcore
import repro_torch.serve as tserve
import repro_torch.sim as tsim
from repro.train.checkpoint import restore_checkpoint as jax_restore
from repro.train.fault import PreemptionGuard as JGuard
from repro_torch import convert
from repro_torch.core import foundation as tfn
from repro_torch.launch import provision as t_provision
from repro_torch.train import PreemptionGuard as TGuard

HOUR = 3600.0
DAY = 24 * HOUR
HISTORY = 12
SEED = 11
TENANTS = 6
LINKS = 2
TIE_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many tiny tensors on the CPU: intra-op threads only spin on them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Kill(BaseException):
    """Abrupt process death: not an ``Exception``, so ``FallbackPolicy``
    cannot turn it into a reactive decision."""


def _fc(core, cfg_mod):
    fc = core.FoundationConfig(kind="moe").reduced()
    return dataclasses.replace(
        fc, kind="moe", history=HISTORY,
        trunk=cfg_mod.SMOKE.replace(compute_dtype="float32"))


class GapPolicy(tcore.Policy):
    """The port's ``LearnerPolicy``, recording the smallest Q gap of the
    batches it decides."""

    method = "moe+dqn"

    def __init__(self, learner):
        self.inner = tcore.LearnerPolicy("moe+dqn", learner)
        self.learner = learner
        self.min_gap = np.inf
        self.batch_sizes = []

    def act_batch(self, obs):
        states = torch.from_numpy(np.asarray(obs["matrix"], np.float32))
        with torch.inference_mode():
            q = tfn.q_values(self.learner.params, self.learner.fc, states)
        self.min_gap = min(self.min_gap, float((q[:, 1] - q[:, 0]).abs().min()))
        self.batch_sizes.append(len(states))
        return self.inner.act_batch(obs)


class Dying:
    """Wraps a policy; raises ``Kill`` once ``after`` batches were
    answered."""

    def __init__(self, inner, after):
        self.inner, self.after, self.batches = inner, after, 0
        self.method = "moe+dqn"

    def act_batch(self, obs):
        if self.batches >= self.after:
            raise Kill()
        self.batches += 1
        return self.inner.act_batch(obs)

    def reset_lanes(self, mask):
        pass

    def observe(self, infos):
        pass


@pytest.fixture(scope="module")
def learners():
    """A JAX and a torch DQN learner on the same random weights: the draw
    of key 6, which both waits and submits in these worlds (most draws
    only do one of the two)."""
    jfc, tfc = _fc(jcore, jagent_cfg), _fc(tcore, tagent_cfg)
    jparams = jcore.init_foundation(jax.random.PRNGKey(6), jfc)
    tparams = convert.from_jax(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    jl = jcore.DQNLearner(jfc, jcore.DQNConfig(), seed=0, params=jparams)
    tl = tcore.DQNLearner(tfc, tcore.DQNConfig(), seed=0, params=tparams,
                          device="cpu")
    return jl, tl


def _world(sim, core, **limit):
    """``tests/test_provision_service.py``'s world (8-hour sub-jobs), or
    with no ``sub_limit`` ``tests/test_control.py``'s: a month of V100
    trace under the faulty plan, history 12, a decision every 30 minutes."""
    jobs = sim.synthesize_trace(sim.PROFILES["V100"], months=1, seed=5,
                                load_scale=1.0)
    plan = sim.get_fault_spec("faulty").make_plan(
        jobs[-1].submit_time + 3 * DAY, sim.PROFILES["V100"].n_nodes, seed=3)
    cfg = core.EnvConfig(n_nodes=sim.PROFILES["V100"].n_nodes,
                         history=HISTORY, interval=1800.0, faults=plan,
                         **limit)
    cache = core.ReplayCheckpointCache(jobs, cfg.n_nodes, faults=plan)
    return jobs, cfg, cache


@pytest.fixture(scope="module")
def worlds():
    return (_world(jsim, jcore, sub_limit=8 * HOUR),
            _world(tsim, tcore, sub_limit=8 * HOUR))


def _service(core, serve, world, policy, co_sim, journal_dir=None):
    jobs, cfg, cache = world
    return serve.ProvisionService(
        jobs, cfg, policy,
        svc=serve.ServiceConfig(tenants=TENANTS, links=LINKS, max_batch=4,
                                co_sim=co_sim),
        seed=SEED, journal_dir=journal_dir, cache=cache,
        retry_factory=lambda i: core.RetryPolicy(seed=100 + i,
                                                 sleep=lambda s: None))


def _jax_run(learners, worlds, co_sim, journal_dir=None, policy=None):
    pol = policy or jcore.LearnerPolicy("moe+dqn", learners[0])
    return _service(jcore, jserve, worlds[0], pol, co_sim,
                    journal_dir).run()


def _port_run(learners, worlds, co_sim, journal_dir=None, policy=None):
    pol = policy or GapPolicy(learners[1])
    svc = _service(tcore, tserve, worlds[1], pol, co_sim, journal_dir)
    return svc.run(), svc


def _schedules(res):
    return [t.schedule for t in res.tenants]


def _assert_clean(res, svc):
    """Every decision came from the learner: no fallback, no degraded
    answer, no breaker trip, no shed, every chain completed."""
    assert res.reason == "completed" and res.n_shed == 0
    assert res.n_degraded == 0 and res.breaker_trips == 0
    assert svc.policy.n_fallbacks == 0
    assert all(t.reason == "completed" and t.n_fallbacks == 0
               for t in res.tenants)


@pytest.fixture(scope="module", params=[False, True], ids=["solo", "co_sim"])
def runs(request, learners, worlds):
    """The uninterrupted JAX and port runs of one mode."""
    co_sim = request.param
    jres = _jax_run(learners, worlds, co_sim)
    tres, svc = _port_run(learners, worlds, co_sim)
    return co_sim, jres, tres, svc


def test_service_schedules_match_jax(runs):
    """``ProvisionService`` over a torch learner, per fork and in one
    shared simulator: each tenant's schedule, outcomes and decision count
    equal the JAX learner's."""
    co_sim, jres, tres, svc = runs
    _assert_clean(tres, svc)
    assert svc.policy.inner.min_gap > TIE_TOL, "a decision within the tol."
    assert _schedules(tres) == _schedules(jres)
    assert [t.outcomes for t in tres.tenants] == \
        [t.outcomes for t in jres.tenants]
    assert (tres.n_rounds, tres.n_batches, tres.n_decisions) == \
        (jres.n_rounds, jres.n_batches, jres.n_decisions)
    # the dynamic batches are ragged: 4 lanes, then what is left
    assert set(svc.policy.inner.batch_sizes) > {4}
    # the learner both waited and submitted before the predecessor's end
    assert tres.n_decisions > TENANTS * LINKS
    assert any(not o["forced"] for t in tres.tenants for o in t.outcomes)


@pytest.mark.parametrize("after", [1, 4])
def test_service_kill_and_resume_identical(runs, learners, worlds, tmp_path,
                                           after):
    """Killed after ``after`` batches and restarted on its journals, the
    port's service finishes with its uninterrupted run's schedules."""
    co_sim, _, tres, _ = runs
    jdir = str(tmp_path / "journal")
    with pytest.raises(Kill):
        _port_run(learners, worlds, co_sim, jdir,
                  policy=Dying(GapPolicy(learners[1]), after))
    res, svc = _port_run(learners, worlds, co_sim, jdir)
    _assert_clean(res, svc)
    assert 0 < res.n_replayed < tres.n_decisions
    assert res.n_replayed + res.n_decisions == tres.n_decisions
    assert _schedules(res) == _schedules(tres)


def test_jax_journal_resumes_in_port(runs, learners, worlds, tmp_path):
    """A journal the JAX service wrote before it died resumes in the
    port's service to the JAX run's schedules: the records cross packages
    through ``repro_torch._msgpack``."""
    co_sim, jres, _, _ = runs
    jdir = str(tmp_path / "journal")
    with pytest.raises(Kill):
        _jax_run(learners, worlds, co_sim, jdir,
                 policy=Dying(jcore.LearnerPolicy("moe+dqn", learners[0]), 3))
    res, svc = _port_run(learners, worlds, co_sim, jdir)
    _assert_clean(res, svc)
    assert res.n_replayed > 0
    assert res.n_replayed + res.n_decisions == jres.n_decisions
    assert _schedules(res) == _schedules(jres)


def _driver(core, world, policy, guard_cls, journal=None, guard=None):
    jobs, cfg, cache = world
    return core.ChainDriver(jobs, cfg, policy, links=3, seed=SEED,
                            cache=cache, journal=journal,
                            guard=guard or guard_cls(install_signals=False),
                            retry=core.RetryPolicy(seed=1,
                                                   sleep=lambda s: None))


def test_chain_driver_matches_jax_and_resumes(learners, tmp_path):
    """A 3-link ``ChainDriver`` on ``tests/test_control.py``'s faulty world:
    the torch learner's schedule equals the JAX learner's, and a driver
    preempted mid-chain resumes on its journal to the same schedule."""
    jw, tw = _world(jsim, jcore), _world(tsim, tcore)
    jres = _driver(jcore, jw, jcore.LearnerPolicy("moe+dqn", learners[0]),
                   JGuard).run()
    gap = GapPolicy(learners[1])
    tres = _driver(tcore, tw, gap, TGuard).run()
    assert gap.min_gap > TIE_TOL, "a decision within the tolerance"
    assert tres.reason == jres.reason == "completed"
    assert tres.n_fallbacks == 0
    assert tres.schedule == jres.schedule and tres.outcomes == jres.outcomes
    assert (tres.n_faults, tres.n_requeues, tres.n_ctrl_errors) == \
        (jres.n_faults, jres.n_requeues, jres.n_ctrl_errors)

    journal = tcore.DecisionJournal(str(tmp_path / "chain.journal"))
    guard = TGuard(install_signals=False)

    class Preempting(GapPolicy):
        def act_batch(self, obs):
            if len(self.batch_sizes) + 1 >= tres.n_decisions // 2:
                guard.trigger()
            return super().act_batch(obs)

    first = _driver(tcore, tw, Preempting(learners[1]), TGuard, journal,
                    guard).run()
    assert first.reason == "preempted"
    res = _driver(tcore, tw, GapPolicy(learners[1]), TGuard, journal).run()
    assert res.reason == "completed" and res.n_fallbacks == 0
    assert res.n_replayed == first.n_decisions > 0
    assert res.schedule == tres.schedule


def test_provision_launcher_saves_agent(tmp_path):
    """The launcher on the CPU at a small size: trains a transformer+dqn
    learner, serves 4 tenants through the service and saves the agent in
    the JAX package's layout, which JAX's ``restore_checkpoint`` reads and
    ``convert.from_jax`` maps back to the trained weights."""
    ckpt = str(tmp_path / "agent")
    out = t_provision.main([
        "--device", "cpu", "--method", "transformer+dqn", "--service", "4",
        "--save-agent", ckpt, "--history", "12", "--episodes", "2",
        "--online-episodes", "2", "--offline-episodes", "1",
        "--pretrain-epochs", "1", "--journal", str(tmp_path / "journal")])
    sres = out["service"]
    assert sres.reason == "completed" and len(sres.tenants) == 4
    assert sres.n_degraded == 0 and out["method"]["n_episodes"] == 2
    params = out["policy"].learner.params
    jfc = dataclasses.replace(
        jcore.FoundationConfig(kind="transformer").reduced(),
        kind="transformer", history=12)
    template = {"params": jcore.init_foundation(jax.random.PRNGKey(1), jfc)}
    restored, step = jax_restore(ckpt, template)
    assert step == 0
    back = convert.from_jax(jax.tree.map(np.asarray, restored["params"]),
                            device="cpu")
    flat = [(a, b) for a, b in zip(jax.tree.leaves(back),
                                   jax.tree.leaves(params))]
    assert len(flat) == len(jax.tree.leaves(params)) > 0
    for a, b in flat:
        assert torch.equal(a, b)
