"""The port's offline pretraining, online training and ``build_policy``
against the JAX package's, end to end on the CPU.

The reference draws its own weights (``init_foundation(PRNGKey(seed))``);
the port draws from a torch generator, which cannot give the same numbers.
So each test patches the port's ``repro_torch.core.agent.init_foundation``
to return JAX's draw for the same seed, converted. Trunks compute in fp32
(bf16 would round at other places in the two frameworks), so losses agree
to 1e-4 relative. Returns and ``EvalResult``s are compared for equality:
every decision is either an argmax or a numpy draw against a probability,
and the tests record the smallest Q gap (DQN), logit gap (PG, greedy) and
|draw - probability| (PG, sampling) the port met, asserting that none fell
within 1e-4, the fp32 model tolerance, where the two frameworks' roundings
could decide differently.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.configs.mirage_agent as jagent_cfg
import repro.core as jcore
import repro.core.agent as jagent
import repro.sim as jsim
import repro_torch.configs.mirage_agent as tagent_cfg
import repro_torch.core as tcore
import repro_torch.core.agent as tagent
import repro_torch.sim as tsim
from repro.models.common import ModelConfig as JModelConfig
from repro_torch import convert
from repro_torch.core import foundation as tfn

HISTORY = 12
TIE_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests push many tiny tensors through the CPU; intra-op threads
    only spin on them and take the cores the other test workers run on."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_fc(fc):
    """The JAX FoundationConfig with the port config's fields."""
    trunk = JModelConfig(**{f.name: getattr(fc.trunk, f.name)
                            for f in dataclasses.fields(JModelConfig)})
    return jcore.FoundationConfig(
        kind=fc.kind, n_experts=fc.n_experts, history=fc.history, trunk=trunk,
        gate_time_feature=fc.gate_time_feature, gate_top1=fc.gate_top1)


@pytest.fixture
def jax_weights(monkeypatch):
    """The port's pretraining starts from JAX's weights for its seed, and
    both packages' reduced trunk computes in fp32."""
    def init_foundation(gen, fc, device=None):
        jparams = jcore.init_foundation(jax.random.PRNGKey(gen.initial_seed()),
                                        _jax_fc(fc))
        return convert.from_jax(jax.tree.map(np.asarray, jparams),
                                device=device)
    monkeypatch.setattr(tagent, "init_foundation", init_foundation)
    for mod in (jagent_cfg, tagent_cfg):
        monkeypatch.setattr(mod, "SMOKE",
                            mod.SMOKE.replace(compute_dtype="float32"))


class _Gaps:
    """Wraps the port's learner classes' ``act_batch`` to record how close
    each decision came to flipping."""

    def __init__(self, monkeypatch):
        self.min_gap = np.inf
        for cls, gap in ((tcore.DQNLearner, self._q_gap),
                         (tcore.PGLearner, self._pg_gap)):
            monkeypatch.setattr(cls, "act_batch", self._wrap(
                cls.act_batch, gap))

    def _wrap(self, act_batch, gap):
        def wrapped(learner, states, explore=True):
            self.min_gap = min(self.min_gap, gap(learner, states, explore))
            return act_batch(learner, states, explore=explore)
        return wrapped

    @staticmethod
    def _q_gap(learner, states, explore):
        with torch.inference_mode():
            q = tfn.q_values(learner.params, learner.fc,
                             torch.from_numpy(np.asarray(states, np.float32)))
        return float((q[:, 1] - q[:, 0]).abs().min())

    @staticmethod
    def _pg_gap(learner, states, explore):
        with torch.inference_mode():
            logits = tfn.policy_logits(learner.params, learner.fc,
                                       torch.from_numpy(np.asarray(
                                           states, np.float32)))
        if not explore:
            return float((logits[:, 1] - logits[:, 0]).abs().min())
        u = np.random.default_rng(0)
        u.bit_generator.state = learner.rng.bit_generator.state
        p1 = torch.softmax(logits, -1)[:, 1].numpy()
        return float(np.abs(u.random(len(p1)) - p1).min())


def _env(sim, core):
    jobs = sim.synthesize_trace(sim.PROFILES["V100"], months=1, seed=5,
                                load_scale=1.0)
    cfg = core.EnvConfig(n_nodes=sim.PROFILES["V100"].n_nodes,
                         history=HISTORY, interval=1800.0)
    return sim.make_env(jobs, cfg, seed=0)


@pytest.fixture(scope="module")
def samples():
    """Offline samples from each package's own (bit-identical) env."""
    out = [core.collect_offline_samples(_env(sim, core), n_episodes=2,
                                        n_points=3, seed=0)
           for sim, core in ((jsim, jcore), (tsim, tcore))]
    for a, b in zip(*out):
        np.testing.assert_array_equal(a["matrix"], b["matrix"])
        assert a["reward"] == b["reward"]
    return out


def _fcs(kind):
    out = []
    for core in (jcore, tcore):
        fc = core.FoundationConfig(kind=kind).reduced()
        out.append(dataclasses.replace(fc, kind=kind, history=HISTORY))
    return out


@pytest.mark.parametrize("kind", ["transformer", "moe"])
def test_pretrain_losses_match_jax(jax_weights, samples, kind):
    jfc, tfc = _fcs(kind)
    assert tfc.trunk.compute_dtype == "float32"
    jparams, jlosses = jagent.pretrain_foundation(jfc, samples[0], epochs=3,
                                                  seed=4, batch_size=4)
    tparams, tlosses = tcore.pretrain_foundation(tfc, samples[1], epochs=3,
                                                 seed=4, batch_size=4,
                                                 device="cpu")
    assert len(tlosses) == 3 and np.isfinite(tlosses).all()
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    assert tlosses[-1] < tlosses[0]
    for a, b in zip(jax.tree.leaves(jparams),
                    jax.tree.leaves(convert.to_jax(tparams))):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-4,
                                   atol=1e-4 * np.abs(np.asarray(a)).max())


def test_online_training_returns_match_jax(jax_weights, monkeypatch):
    """``train_online_dqn`` (replay sampling, 4 updates per finished episode
    once the replay holds a batch, ε-greedy draws) and ``train_online_pg``
    (sampled actions, one update per episode), 4 episodes each in batches
    of 2, fp32 moe trunk."""
    gaps = _Gaps(monkeypatch)
    jfc, tfc = _fcs("moe")
    jenv, tenv = _env(jsim, jcore), _env(tsim, tcore)
    params = tagent.init_foundation(torch.Generator().manual_seed(3), tfc,
                                    device="cpu")
    jparams = convert.to_jax(params)
    dc = dict(batch_size=8)
    jl = jcore.DQNLearner(jfc, jcore.DQNConfig(**dc), seed=3, params=jparams)
    tl = tcore.DQNLearner(tfc, tcore.DQNConfig(**dc), seed=3, params=params,
                          device="cpu")
    jret = jagent.train_online_dqn(jenv, jl, episodes=4, seed=3, batch=2)
    tret = tcore.train_online_dqn(tenv, tl, episodes=4, seed=3, batch=2)
    assert tl._steps > 0 and tl._steps == jl._steps
    assert gaps.min_gap > TIE_TOL, "a decision within the tolerance"
    assert tret == jret and len(tret) == 4

    jp = jcore.PGLearner(jfc, jcore.PGConfig(), seed=3, params=jparams)
    tp = tcore.PGLearner(tfc, tcore.PGConfig(), seed=3, params=params,
                         device="cpu")
    jret = jagent.train_online_pg(jenv, jp, episodes=4, seed=3, batch=2)
    tret = tcore.train_online_pg(tenv, tp, episodes=4, seed=3, batch=2)
    assert gaps.min_gap > TIE_TOL, "a decision within the tolerance"
    assert tret == jret and tp.baseline == pytest.approx(jp.baseline)
    assert int(tp.opt_state["step"]) == 4


@pytest.mark.parametrize("algo", ["dqn", "pg"])
def test_cotenant_training_returns_match_jax(jax_weights, monkeypatch, algo):
    """``train_online_dqn`` / ``_pg`` with ``tenants=2``: each rollout is a
    co-tenant env of 2 groups in which 2 chains contend for one simulated
    cluster, 8 episodes in all; the returns, the update counts and the
    trained weights' decisions equal JAX's."""
    gaps = _Gaps(monkeypatch)
    jfc, tfc = _fcs("moe")
    params = tagent.init_foundation(torch.Generator().manual_seed(4), tfc,
                                    device="cpu")
    jparams = convert.to_jax(params)
    kw = dict(episodes=8, seed=4, batch=2, tenants=2)
    if algo == "dqn":
        jl = jcore.DQNLearner(jfc, jcore.DQNConfig(batch_size=8), seed=4,
                              params=jparams)
        tl = tcore.DQNLearner(tfc, tcore.DQNConfig(batch_size=8), seed=4,
                              params=params, device="cpu")
        jret = jagent.train_online_dqn(_env(jsim, jcore), jl, **kw)
        tret = tcore.train_online_dqn(_env(tsim, tcore), tl, **kw)
        assert tl._steps > 0 and tl._steps == jl._steps
    else:
        jl = jcore.PGLearner(jfc, jcore.PGConfig(), seed=4, params=jparams)
        tl = tcore.PGLearner(tfc, tcore.PGConfig(), seed=4, params=params,
                             device="cpu")
        jret = jagent.train_online_pg(_env(jsim, jcore), jl, **kw)
        tret = tcore.train_online_pg(_env(tsim, tcore), tl, **kw)
        assert int(tl.opt_state["step"]) == 8
        assert tl.baseline == pytest.approx(jl.baseline)
    assert gaps.min_gap > TIE_TOL, "a decision within the tolerance"
    assert tret == jret and len(tret) == 8
    assert len(set(tret)) > 1                 # the chains' outcomes differ


def test_faulted_grid_cell_matches_jax(jax_weights, monkeypatch, samples):
    """One cell of the Fig-8 grid under faults: a ``moe+dqn`` learner
    trained as the grid trains it (fault-free heavy load), then
    ``evaluate_batch`` on ``V100/heavy/single/faulty``, whose seeded node
    failures requeue jobs; the ``EvalResult`` equals JAX's, fault and
    requeue counts included."""
    gaps = _Gaps(monkeypatch)
    kw = dict(online_episodes=2, pretrain_epochs=2, history=HISTORY,
              reduced=True, seed=0)
    env_kw = dict(months=1, seed=100, history=HISTORY, interval=1800.0)
    res = []
    for sim, core, agent, smp, dev in (
            (jsim, jcore, jagent, samples[0], {}),
            (tsim, tcore, tcore, samples[1], {"device": "cpu"})):
        train = sim.get_scenario("V100", "heavy", "single").make_env(**env_kw)
        pol = agent.build_policy("moe+dqn", train, offline_samples=smp,
                                 **kw, **dev)
        cell = sim.get_scenario("V100", "heavy", "single", fault="faulty")
        venv = cell.make_vector_env(3, **dict(env_kw, seed=200))
        res.append(core.evaluate_batch(venv, pol, episodes=6, seed=7))
    assert gaps.min_gap > TIE_TOL, "a decision within the tolerance"
    assert vars(res[1]) == vars(res[0])
    summary = res[1].summary()
    assert summary["n_episodes"] == 6
    assert summary["n_faults"] > 0 and summary["n_requeues"] > 0


@pytest.mark.parametrize("method", jcore.ALL_METHODS)
def test_build_policy_matches_jax(jax_weights, monkeypatch, samples, method):
    """Every method at ``reduced=True``: 2 pretraining epochs and 2 online
    episodes for the RL methods, then 4 evaluation episodes on 2 lanes; the
    ``EvalResult`` summaries are equal."""
    gaps = _Gaps(monkeypatch)
    kw = dict(online_episodes=2, pretrain_epochs=2, history=HISTORY,
              reduced=True, seed=1)
    jpol = jagent.build_policy(method, _env(jsim, jcore),
                               offline_samples=samples[0], **kw)
    tpol = tcore.build_policy(method, _env(tsim, tcore),
                              offline_samples=samples[1], device="cpu", **kw)
    assert type(tpol).__name__ == type(jpol).__name__
    res = []
    for sim, core, pol in ((jsim, jcore, jpol), (tsim, tcore, tpol)):
        venv = sim.make_vector_env(_env(sim, core).trace,
                                   _env(sim, core).cfg, 2, seed=100)
        res.append(core.evaluate_batch(venv, pol, episodes=4, seed=9))
    if method in jagent.RL_METHODS:
        assert gaps.min_gap > TIE_TOL, "a decision within the tolerance"
    assert res[1].summary() == res[0].summary()
    assert res[1].summary()["n_episodes"] == 4
