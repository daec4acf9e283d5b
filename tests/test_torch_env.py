"""The port's copies of the numpy layers are the JAX package's layers.

``repro_torch`` keeps verbatim copies of the simulator, environments,
state encoder and heuristics (it imports nothing of ``repro``). Each copy
is the original with its ``repro.`` imports pointed at ``repro_torch.``
and unported parts removed, and it behaves bit-identically: the same
trace, config, seeds and action script give equal observations, rewards,
dones and infos at every step, and equal ``EvalResult``s.
"""
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest

import repro.core as jcore
import repro.sim as jsim
import repro_torch.core as tcore
import repro_torch.sim as tsim
from repro_torch.analysis import cow as tcow

SRC = Path(__file__).resolve().parents[1] / "src"
COPIED = ["analysis/cow.py", "sim/trace.py", "sim/cluster.py", "sim/faults.py",
          "sim/simulator.py", "sim/timeline.py", "sim/workload.py",
          "sim/scenarios.py", "sim/multitenant.py", "core/state.py",
          "core/reward.py", "core/provisioner.py", "core/policy.py",
          "core/baselines.py", "core/replay.py", "core/trees.py",
          "core/cotenant.py", "core/control.py", "serve/cosim.py",
          "serve/provision_service.py", "train/fault.py"]
# copies that drop parts of their original (the rest must keep its length)
PARTIAL = ("train/fault.py",)        # PreemptionGuard only
# the one import a copy rewrites beyond ``repro.`` -> ``repro_torch.``: the
# port's own MessagePack codec in place of the ``msgpack`` module
REWRITTEN = {"from repro_torch import _msgpack as msgpack": "import msgpack"}
HOUR = 3600.0


@pytest.mark.parametrize("path", COPIED)
def test_copy_is_original_minus_dropped_lines(path):
    """Every line of the copy, with ``repro_torch.`` read back as
    ``repro.`` on its import lines, appears in the original in order."""
    orig = (SRC / "repro" / path).read_text().splitlines()
    copy = (SRC / "repro_torch" / path).read_text().splitlines()
    it = iter(orig)
    for ln in copy:
        want = REWRITTEN.get(ln, re.sub(r"^(\s*from )repro_torch\.",
                                        r"\1repro.", ln))
        assert any(o == want for o in it), f"{path}: {ln!r} not in original"
    if path not in PARTIAL:
        assert len(copy) == len(orig)


def _envs(module_sim, module_core, batch, seed):
    jobs = module_sim.synthesize_trace(module_sim.PROFILES["V100"], months=1,
                                       seed=5, load_scale=1.0)
    cfg = module_core.EnvConfig(n_nodes=module_sim.PROFILES["V100"].n_nodes,
                                history=12, interval=1800.0)
    return module_sim.make_vector_env(jobs, cfg, batch, seed=seed)


def _assert_obs_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


def test_vector_env_bit_identical():
    B = 4
    jenv, tenv = _envs(jsim, jcore, B, 11), _envs(tsim, tcore, B, 11)
    rng = np.random.default_rng(3)
    with tcow.sanitized():
        _assert_obs_equal(jenv.reset(), tenv.reset())
        steps = 0
        while not jenv.dones.all():
            acts = (rng.random(B) < 0.15).astype(np.int64)
            jo, jr, jd, ji = jenv.step(acts)
            to, tr, td, ti = tenv.step(acts)
            _assert_obs_equal(jo, to)
            np.testing.assert_array_equal(jr, tr)
            np.testing.assert_array_equal(jd, td)
            assert ji == ti
            steps += 1
        assert tenv.dones.all() and steps > 1


def test_reactive_eval_bit_identical():
    jres = jcore.evaluate_batch(_envs(jsim, jcore, 3, 7), jcore.ReactivePolicy(),
                                episodes=5, seed=2)
    with tcow.sanitized():
        tres = tcore.evaluate_batch(_envs(tsim, tcore, 3, 7),
                                    tcore.ReactivePolicy(), episodes=5, seed=2)
    assert tres.summary()["n_episodes"] == 5
    assert vars(jres) == vars(tres)


def test_preemption_guard_copy_behaves():
    from repro.train.fault import PreemptionGuard as JGuard
    from repro_torch.train import PreemptionGuard as TGuard
    for guard in (JGuard, TGuard):
        g = guard(wall_limit_s=None, install_signals=False)
        assert not g.should_stop()
        g.trigger()
        assert g.should_stop()
        assert guard(wall_limit_s=1.0, grace_s=2.0,
                     install_signals=False).should_stop()


def test_scenario_registry_matches():
    s_j = jsim.get_scenario("V100", "medium", "single")
    s_t = tsim.get_scenario("V100", "medium", "single")
    assert s_t.name == s_j.name and s_t.load_scale == s_j.load_scale
    tj, tt = s_j.make_trace(months=1, seed=0), s_t.make_trace(months=1, seed=0)
    assert [vars(a) for a in tj] == [vars(b) for b in tt]
    assert dataclasses.asdict(s_j.env_config(history=144)) == \
        dataclasses.asdict(s_t.env_config(history=144))
    # a co-tenant cell: 2 groups of its 8 contending chains, stepped alike
    c_j = jsim.get_scenario("V100/heavy/single/co8")
    c_t = tsim.get_scenario("V100/heavy/single/co8")
    assert c_t.name == c_j.name and c_t.tenants == c_j.tenants == 8
    jenv, tenv = (c.make_co_vector_env(2, months=1, seed=4, history=12,
                                       interval=1800.0) for c in (c_j, c_t))
    rng = np.random.default_rng(5)
    with tcow.sanitized():
        _assert_obs_equal(jenv.reset(), tenv.reset())
        while not jenv.dones.all():
            acts = (rng.random(16) < 0.2).astype(np.int64)
            jo, jr, jd, ji = jenv.step(acts)
            to, tr, td, ti = tenv.step(acts)
            _assert_obs_equal(jo, to)
            np.testing.assert_array_equal(jr, tr)
            np.testing.assert_array_equal(jd, td)
            assert ji == ti
    assert tenv.dones.all()
