"""The port's serving path against the JAX package's: ``DQNLearner.act_batch``
and ``evaluate_batch(LearnerPolicy("moe+dqn"))``, on weights initialised in
JAX and converted, and on the same numpy RNG draws.

Actions are compared on lanes whose Q gap exceeds the Q tolerance (fp32
1e-4, bf16 2e-2, as in test_torch_foundation.py): within it the argmax of
either side may legitimately flip. The end-to-end ``evaluate_batch`` run
asserts that no such near-tie occurred, so every decision, and with it the
``EvalResult``, must be equal.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.sim as jsim
import repro_torch.core as tcore
import repro_torch.sim as tsim
from repro_torch import convert
from repro_torch.core import foundation as tfn

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
HISTORY = 12


def _learners(kind, dtype, history=HISTORY, seed=0):
    fcs = []
    for mod in (jcore, tcore):
        fc = mod.FoundationConfig(kind=kind).reduced()
        fcs.append(dataclasses.replace(
            fc, history=history, trunk=fc.trunk.replace(compute_dtype=dtype)))
    jl = jcore.DQNLearner(fcs[0], jcore.DQNConfig(), seed=seed)
    params = convert.from_jax(jax.tree.map(np.asarray, jl.params),
                              device="cpu")
    tl = tcore.DQNLearner(fcs[1], tcore.DQNConfig(), seed=seed, params=params,
                          device="cpu")
    return jl, tl


def _q(learner, states):
    with torch.inference_mode():
        return tfn.q_values(learner.params, learner.fc,
                            torch.from_numpy(states)).numpy()


@pytest.mark.parametrize("kind", ["transformer", "moe"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_act_batch_greedy(kind, dtype):
    jl, tl = _learners(kind, dtype)
    s = np.random.default_rng(1).normal(size=(16, HISTORY, 40)).astype(
        np.float32)
    q = _q(tl, s)
    clear = np.abs(q[:, 1] - q[:, 0]) > TOL[dtype]
    assert clear.sum() >= 8
    ja, ta = jl.act_batch(s, explore=False), tl.act_batch(s, explore=False)
    assert ta.dtype == np.int64 and ta.shape == (16,)
    np.testing.assert_array_equal(ja[clear], ta[clear])
    assert tl.act(s[0], explore=False) == ta[0]


def test_act_batch_explore_same_draws():
    jl, tl = _learners("moe", "float32")
    rng = np.random.default_rng(2)
    flipped = 0
    for _ in range(4):
        s = rng.normal(size=(32, HISTORY, 40)).astype(np.float32)
        q = _q(tl, s)
        clear = np.abs(q[:, 1] - q[:, 0]) > TOL["float32"]
        ja, ta = jl.act_batch(s, explore=True), tl.act_batch(s, explore=True)
        np.testing.assert_array_equal(ja[clear], ta[clear])
        flipped += int((ta != q.argmax(-1)).sum())
    assert flipped > 0                       # exploration took effect
    assert jl.rng.bit_generator.state == tl.rng.bit_generator.state


class _GapRecorder(tcore.Policy):
    """Delegates to a LearnerPolicy and records the smallest Q gap seen."""

    def __init__(self, inner):
        self.inner, self.method = inner, inner.method
        self.min_gap = np.inf

    def act_batch(self, obs):
        q = _q(self.inner.learner, np.asarray(obs["matrix"], np.float32))
        self.min_gap = min(self.min_gap, float(np.abs(q[:, 1] - q[:, 0]).min()))
        return self.inner.act_batch(obs)


def _venv(sim, core):
    jobs = sim.synthesize_trace(sim.PROFILES["V100"], months=1, seed=5,
                                load_scale=1.0)
    cfg = core.EnvConfig(n_nodes=sim.PROFILES["V100"].n_nodes,
                         history=HISTORY, interval=1800.0)
    return sim.make_vector_env(jobs, cfg, 3, seed=100)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_evaluate_batch_moe_dqn_matches(dtype):
    jl, tl = _learners("moe", dtype, seed=3)
    jres = jcore.evaluate_batch(_venv(jsim, jcore),
                                jcore.LearnerPolicy("moe+dqn", jl),
                                episodes=4, seed=9)
    pol = _GapRecorder(tcore.LearnerPolicy("moe+dqn", tl))
    tres = tcore.evaluate_batch(_venv(tsim, tcore), pol, episodes=4, seed=9)
    assert pol.min_gap > TOL[dtype], "near-tie: pick another seed"
    assert tres.method == "moe+dqn" == tcore.DEFAULT_METHOD
    assert vars(jres) == vars(tres)
    assert tres.summary()["n_episodes"] == 4
