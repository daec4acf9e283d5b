"""The port's co-simulation against the JAX package's, on the CPU.

``repro_torch.sim.multitenant``, ``repro_torch.core.cotenant`` and
``make_co_vector_env`` are verbatim copies of the reference's numpy
layers (``tests/test_torch_env.py`` pins the text); here they are pinned in
behaviour: the same trace, fault plan, seeds and action script give equal
observations, rewards, dones and infos at every step, and the N = 1
co-simulation is the port's own fork engine.
"""
import numpy as np
import pytest

import repro.core as jcore
import repro.sim as jsim
import repro.sim.faults as jfaults
import repro.sim.multitenant as jmt
import repro_torch.core as tcore
import repro_torch.sim as tsim
import repro_torch.sim.faults as tfaults
import repro_torch.sim.multitenant as tmt
from repro_torch.analysis import cow as tcow

HOUR = 3600.0
DAY = 24 * HOUR
HISTORY = 12


def _world(sim, core, fault):
    jobs = sim.synthesize_trace(sim.PROFILES["V100"], months=1, seed=5,
                                load_scale=1.0)
    spec = sim.get_fault_spec(fault)
    plan = (spec.make_plan(jobs[-1].submit_time + 3 * DAY,
                           sim.PROFILES["V100"].n_nodes, seed=3)
            if spec is not None else None)
    cfg = core.EnvConfig(n_nodes=sim.PROFILES["V100"].n_nodes,
                         history=HISTORY, interval=1800.0, faults=plan)
    cache = core.ReplayCheckpointCache(jobs, cfg.n_nodes, faults=plan)
    return jobs, cfg, cache


def _assert_step_equal(a, b):
    (ao, ar, ad, ai), (bo, br, bd, bi) = a, b
    assert ao.keys() == bo.keys()
    for k in ao:
        np.testing.assert_array_equal(np.asarray(ao[k]), np.asarray(bo[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(ar, br)
    np.testing.assert_array_equal(ad, bd)
    assert ai == bi


@pytest.mark.parametrize("fault", ["", "faulty"])
def test_co_vector_env_bit_identical(fault):
    """2 groups x 4 contending tenants, fault-free and under the faulty
    plan (node failures requeue jobs): every step equal to JAX's."""
    G, T = 2, 4
    jenv, tenv = ((lambda jobs, cfg, cache: sim.make_co_vector_env(
        jobs, cfg, G, T, seed=21, cache=cache))(*_world(sim, core, fault))
        for sim, core in ((jsim, jcore), (tsim, tcore)))
    rng = np.random.default_rng(8)
    with tcow.sanitized():
        jo, to = jenv.reset(), tenv.reset()
        _assert_step_equal((jo, 0, 0, 0), (to, 0, 0, 0))
        steps = 0
        while not jenv.dones.all():
            acts = (rng.random(G * T) < 0.15).astype(np.int64)
            js, ts = jenv.step(acts), tenv.step(acts)
            _assert_step_equal(js, ts)
            steps += 1
            assert steps < 10_000
    assert tenv.dones.all() and steps > 1
    failures = [[w.sim.n_node_failures for w in env.worlds]
                for env in (jenv, tenv)]
    assert failures[0] == failures[1]
    assert (sum(failures[1]) > 0) == bool(fault)


@pytest.mark.parametrize("fault", ["", "faulty"])
def test_n1_cosim_equals_fork_engine(fault):
    """With one tenant a group, the port's co env is its vector env, step
    for step; the only addition is the "fleet" block. Under faults the two
    engines count faults differently, in both packages alike
    (``test_co_vector_env_bit_identical``): the co env only the faults that
    kill the chain's own jobs, the vector env those of the decision window;
    everything else still agrees."""
    jobs, cfg, cache = _world(tsim, tcore, fault)
    B = 3
    ref = tsim.make_vector_env(jobs, cfg, B, seed=100, cache=cache)
    co = tsim.make_co_vector_env(jobs, cfg, B, 1, seed=100, cache=cache)
    lo, hi = ref._t_start_range
    t0s = np.random.default_rng(7).uniform(lo, hi, B)
    counts = ("n_faults", "n_requeues") if fault else ()

    def infos(step):
        return step[:3] + ([{k: v for k, v in i.items() if k not in counts}
                            for i in step[3]],)

    with tcow.sanitized():
        obs_r, obs_c = ref.reset(t_starts=t0s), co.reset(t_starts=t0s)
        assert set(obs_c) == set(obs_r) | {"fleet"}
        rng = np.random.default_rng(3)
        steps = 0
        while not ref.dones.all():
            acts = (rng.random(B) < 0.15).astype(np.int64)
            r_step, c_step = ref.step(acts), co.step(acts)
            c_obs = {k: v for k, v in c_step[0].items() if k != "fleet"}
            _assert_step_equal(infos(r_step), infos((c_obs,) + c_step[1:]))
            steps += 1
            assert steps < 10_000
    assert co.dones.all() and steps > 1


def test_fault_attribution_matches_jax():
    """Owned-job attribution in a shared simulator: a fault charged to the
    tenant whose job it killed, equal in both packages."""
    out = []
    for sim, faults, mtmod in ((jsim, jfaults, jmt), (tsim, tfaults, tmt)):
        plan = sim.FaultPlan(np.array([1 * HOUR, 2 * HOUR]),
                             np.array([faults.FAIL, faults.REPAIR]),
                             np.array([2, 2]))
        s = sim.SlurmSimulator(4, mode="fast", faults=plan)
        mt = sim.MultiTenantSim(s, 2)
        for t in range(2):
            mt.submit_pred(t, sim.SubJobChain(
                user_id=1 + t, n_nodes=2, sub_limit=10 * HOUR,
                next_id=10 ** 6 + t * mtmod.TENANT_ID_STRIDE))
        mt.start_preds()
        s.run_until(3 * HOUR)
        out.append((mt.fault_counts.tolist(), mt.requeue_counts.tolist(),
                    s.n_node_failures, s.n_requeues))
    assert out[0] == out[1]
    assert out[1][2] == 1
