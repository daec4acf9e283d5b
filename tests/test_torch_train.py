"""The port's training step against the JAX package's: AdamW, one DQN
update in both credit modes, one PG update with padding, and the learning
tests of tests/test_core_rl.py on the port's learners.

Weights are drawn in JAX and converted; batches are drawn with numpy.
Tolerances: AdamW 1e-6 (the same fp32 arithmetic, one rounding apart);
gradients and losses 1e-4 of each leaf's largest magnitude with an fp32
trunk (sums in another order) and 2e-2 with the bf16 trunk (bf16 rounds at
other places in the two frameworks); parameters after 5 fp32 steps 1e-4 of
each leaf's scale (AdamW divides by sqrt(v), which lifts the gradients'
relative rounding to the step size of tiny-gradient entries).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.core import foundation as jfn
from repro.train import optimizer as jopt
from repro_torch import convert
from repro_torch.convert import tree_map
from repro_torch.core import foundation as tfn
from repro_torch.core.dqn import value_and_grad
from repro_torch.core.state import STATE_DIM
from repro_torch.train import optimizer as topt

GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
HISTORY = 24


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests push many tiny tensors through the CPU; intra-op threads
    only spin on them and take the cores the other test workers run on."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fcs(kind, dtype, history=HISTORY):
    out = []
    for mod in (jcore, tcore):
        fc = mod.FoundationConfig(kind=kind).reduced()
        out.append(dataclasses.replace(
            fc, kind=kind, history=history,
            trunk=fc.trunk.replace(compute_dtype=dtype)))
    return out


def _leaves(tree):
    return jax.tree.leaves(tree)


def _assert_tree_close(jtree, ttree, rel, what):
    """Every leaf of the port's tree (in JAX's layout) within ``rel`` of the
    JAX leaf's largest magnitude."""
    jl, tl = _leaves(jtree), _leaves(convert.to_jax(ttree))
    assert len(jl) == len(tl)
    for i, (a, b) in enumerate(zip(jl, tl)):
        a = np.asarray(a, np.float32)
        b = np.asarray(b, np.float32)
        assert a.shape == b.shape, (what, i, a.shape, b.shape)
        scale = max(float(np.abs(a).max()), 1e-30)
        err = float(np.abs(a - b).max())
        assert err <= rel * scale, f"{what} leaf {i}: {err} > {rel} x {scale}"


# ------------------------------------------------------------------ AdamW
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
@pytest.mark.parametrize("state_dtype", [None, "bfloat16"])
def test_adamw_matches_jax(weight_decay, state_dtype):
    """5 steps on a tree of 1-D, 2-D and 3-D leaves, under warmup and
    cosine decay, with a clip that binds (grad norms ~20 against 0.5)."""
    rng = np.random.default_rng(0)
    shapes = {"bias": (7,), "w": {"mat": (4, 5), "stack": [(2, 3, 4)]}}

    def draw(scale=1.0):
        return jax.tree.map(
            lambda s: (rng.normal(size=s) * scale).astype(np.float32),
            shapes, is_leaf=lambda x: isinstance(x, tuple))
    params = draw()
    kw = dict(lr=1e-2, weight_decay=weight_decay, grad_clip=0.5,
              warmup_steps=3, total_steps=20, state_dtype=state_dtype)
    jcfg, tcfg = jopt.OptimizerConfig(**kw), topt.OptimizerConfig(**kw)
    jp = jax.tree.map(jnp.asarray, params)
    tp = jax.tree.map(torch.from_numpy, params)
    js, ts = jopt.init_opt_state(jp, jcfg), topt.init_opt_state(tp, tcfg)
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 0
    for _ in range(5):
        g = draw(3.0)
        jp, js, jm = jopt.adamw_update(jax.tree.map(jnp.asarray, g), jp, js,
                                       jcfg)
        tp, ts, tm = topt.adamw_update(jax.tree.map(torch.from_numpy, g),
                                       tp, ts, tcfg)
        assert float(jm["grad_norm"]) > 10 * tcfg.grad_clip   # clip binds
        for key in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 5
    for jt, tt in ((jp, tp), (js["m"], ts["m"]), (js["v"], ts["v"])):
        for a, b in zip(_leaves(jt), _leaves(tt)):
            assert str(b.dtype).split(".")[-1] == str(a.dtype)
            np.testing.assert_allclose(b.float().numpy(),
                                       np.asarray(a, np.float32),
                                       rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["transformer", "moe"])
def test_adamw_decay_on_converted_agent_params_matches_jax(kind):
    """3 steps with weight decay 0.1 on the reduced agent's parameters,
    drawn in JAX and converted: the port widens every transformer-kind leaf
    by an expert axis of 1, and still decays exactly the leaves that JAX
    decays (its 1-D LayerNorm scales and biases stay undecayed)."""
    jfc, _ = _fcs(kind, "float32")
    jp = jfn.init_foundation(jax.random.PRNGKey(0), jfc)
    tp = convert.from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    assert any(np.ndim(a) == 1 for a in _leaves(jp)) == (kind == "transformer")
    kw = dict(lr=1e-2, weight_decay=0.1, grad_clip=0.5, warmup_steps=3,
              total_steps=20)
    jcfg, tcfg = jopt.OptimizerConfig(**kw), topt.OptimizerConfig(**kw)
    js, ts = jopt.init_opt_state(jp, jcfg), topt.init_opt_state(tp, tcfg)
    rng = np.random.default_rng(0)
    for _ in range(3):
        g = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 3.0)
                         .astype(np.float32), jp)
        jp, js, _ = jopt.adamw_update(jax.tree.map(jnp.asarray, g), jp, js,
                                      jcfg)
        tp, ts, _ = topt.adamw_update(convert.from_jax(g, device="cpu"), tp,
                                      ts, tcfg)
    for jt, tt in ((jp, tp), (js["m"], ts["m"]), (js["v"], ts["v"])):
        for a, b in zip(_leaves(jt), _leaves(convert.to_jax(tt))):
            np.testing.assert_allclose(b, np.asarray(a), rtol=1e-6,
                                       atol=1e-6)


def test_adamw_does_not_write_its_inputs():
    p = {"w": torch.ones(3, 2)}
    cfg = topt.OptimizerConfig()
    state = topt.init_opt_state(p, cfg)
    new, new_state, _ = topt.adamw_update({"w": torch.ones(3, 2)}, p, state,
                                          cfg)
    assert torch.equal(p["w"], torch.ones(3, 2))
    assert int(state["step"]) == 0 and not state["m"]["w"].any()
    assert not torch.equal(new["w"], p["w"]) and int(new_state["step"]) == 1


# -------------------------------------------------------------------- DQN
def _dqn_batch(rng, n, history=HISTORY):
    return {"s": rng.normal(size=(n, history, STATE_DIM)).astype(np.float32),
            "a": rng.integers(0, 2, n).astype(np.int32),
            "r": rng.normal(size=n).astype(np.float32),
            "s2": rng.normal(size=(n, history, STATE_DIM)).astype(np.float32),
            "done": rng.random(n) < 0.5}


def _jax_dqn_loss(fc, dc):
    """The reference's loss, as written at repro/core/dqn.py:54-64."""
    def loss_fn(params, target_params, batch):
        q = jfn.q_values(params, fc, batch["s"])
        qa = jnp.take_along_axis(q, batch["a"][:, None], 1)[:, 0]
        if dc.paper_credit:
            target = batch["r"]
        else:
            q_next = jfn.q_values(target_params, fc, batch["s2"])
            target = batch["r"] + dc.gamma * jnp.max(q_next, -1) * (
                1.0 - batch["done"].astype(jnp.float32))
        target = jax.lax.stop_gradient(target)
        return jnp.mean(jnp.square(qa - target))
    return loss_fn


def _learners(kind, dtype, dc_kw, seed=0):
    jfc, tfc = _fcs(kind, dtype)
    jl = jcore.DQNLearner(jfc, jcore.DQNConfig(**dc_kw), seed=seed)
    params = convert.from_jax(jax.tree.map(np.asarray, jl.params),
                              device="cpu")
    tl = tcore.DQNLearner(tfc, tcore.DQNConfig(**dc_kw), seed=seed,
                          params=params, device="cpu")
    return jl, tl


@pytest.mark.parametrize("kind", ["transformer", "moe"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("paper_credit", [True, False])
def test_dqn_loss_and_grads_match_jax(kind, dtype, paper_credit):
    dc_kw = dict(paper_credit=paper_credit, batch_size=8)
    jl, tl = _learners(kind, dtype, dc_kw)
    rng = np.random.default_rng(1)
    # a target network that differs from the online one
    tl.target_params = tree_map(lambda t: t * 0.9, tl.target_params)
    jtarget = jax.tree.map(lambda a: a * 0.9, jl.target_params)
    batch = _dqn_batch(rng, 8)
    jloss, jgrads = jax.jit(jax.value_and_grad(_jax_dqn_loss(jl.fc, jl.dc)))(
        jl.params, jtarget, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss, tgrads = value_and_grad(
        tl.loss, tl.params, {k: torch.as_tensor(v) for k, v in batch.items()})
    tol = GRAD_TOL[dtype]
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=tol)
    _assert_tree_close(jgrads, tgrads, tol, "grad")


@pytest.mark.parametrize("paper_credit", [True, False])
def test_dqn_steps_and_target_refresh_match_jax(paper_credit):
    """5 fp32 ``train_on`` steps on the moe trunk: losses and parameters
    agree, and the target network is re-cloned every
    ``target_update_every`` steps, as the reference's is."""
    dc_kw = dict(paper_credit=paper_credit, batch_size=8,
                 target_update_every=2)
    jl, tl = _learners("moe", "float32", dc_kw)
    rng = np.random.default_rng(2)
    for step in range(1, 6):
        batch = _dqn_batch(rng, 8)
        before = tl.target_params
        jloss, tloss = jl.train_on(batch), tl.train_on(batch)
        np.testing.assert_allclose(tloss, jloss, rtol=1e-4)
        assert tl._steps == step
        refreshed = tl.target_params is not before
        assert refreshed == (step % 2 == 0)
        if refreshed:
            for a, b in zip(_leaves(tl.target_params), _leaves(tl.params)):
                assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
        _assert_tree_close(jl.target_params, tl.target_params, 1e-4,
                           "target")
    _assert_tree_close(jl.params, tl.params, 1e-4, "params")
    assert int(tl.opt_state["step"]) == 5


def test_opt_state_converts_both_ways():
    """JAX trains 2 fp32 steps; its parameters and AdamW state, converted,
    carry the port on for 3 more steps alongside it: the parameters agree,
    and the state round-trips exactly."""
    dc_kw = dict(paper_credit=True, batch_size=8)
    jl, tl = _learners("moe", "float32", dc_kw)
    rng = np.random.default_rng(6)
    for _ in range(2):
        jl.train_on(_dqn_batch(rng, 8))
    jstate = jax.tree.map(np.asarray, jl.opt_state)
    tl.params = convert.from_jax(jax.tree.map(np.asarray, jl.params),
                                 device="cpu")
    tl.opt_state = convert.opt_state_from_jax(jstate, device="cpu")
    assert tl.opt_state["step"].dtype == torch.int32
    back = convert.opt_state_to_jax(tl.opt_state)
    assert int(back["step"]) == 2 and back["step"].dtype == np.int32
    for a, b in zip(_leaves(jstate["m"]) + _leaves(jstate["v"]),
                    _leaves(back["m"]) + _leaves(back["v"])):
        np.testing.assert_array_equal(a, b)
    for _ in range(3):
        batch = _dqn_batch(rng, 8)
        jl.train_on(batch)
        tl.train_on(batch)
    _assert_tree_close(jl.params, tl.params, 1e-4, "params")
    _assert_tree_close(jl.opt_state["m"], tl.opt_state["m"], 1e-4, "m")
    assert int(tl.opt_state["step"]) == 5


def test_dqn_act_batch_leaves_no_inference_tensor_to_train_on():
    """``act_batch`` runs under inference_mode; a ``train_on`` right after
    it must not meet an inference tensor (it could not be saved for
    backward), and the parameters it leaves are ordinary tensors."""
    _, tl = _learners("moe", "float32", dict(batch_size=4))
    rng = np.random.default_rng(3)
    tl.act_batch(rng.normal(size=(4, HISTORY, STATE_DIM)).astype(np.float32))
    assert np.isfinite(tl.train_on(_dqn_batch(rng, 4)))
    tl.act_batch(rng.normal(size=(4, HISTORY, STATE_DIM)).astype(np.float32))
    for t in _leaves(tl.params) + _leaves(tl.opt_state):
        assert not t.is_inference() and not t.requires_grad


# --------------------------------------------------------------------- PG
def _jax_pg_loss(fc, pc):
    """The reference's loss, as written at repro/core/pg.py:46-53."""
    def loss_fn(params, states, actions, advantage, mask):
        logits = jfn.policy_logits(params, fc, states)
        logp = jax.nn.log_softmax(logits, -1)
        lp_a = jnp.take_along_axis(logp, actions[:, None], 1)[:, 0]
        denom = jnp.maximum(mask.sum(), 1.0)
        entropy = (-jnp.sum(jnp.exp(logp) * logp, -1) * mask).sum() / denom
        return (-(lp_a * advantage * mask).sum() / denom
                - pc.entropy_coef * entropy)
    return loss_fn


def _pg_learners(kind, dtype, seed=0):
    jfc, tfc = _fcs(kind, dtype)
    jl = jcore.PGLearner(jfc, jcore.PGConfig(), seed=seed)
    params = convert.from_jax(jax.tree.map(np.asarray, jl.params),
                              device="cpu")
    tl = tcore.PGLearner(tfc, tcore.PGConfig(), seed=seed, params=params,
                         device="cpu")
    return jl, tl


@pytest.mark.parametrize("kind", ["transformer", "moe"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pg_loss_and_grads_match_jax(kind, dtype):
    """One padded episode (T=11 to 16 rows, mask 0 past T)."""
    jl, tl = _pg_learners(kind, dtype)
    rng = np.random.default_rng(4)
    T, Tp = 11, 16
    sp = np.zeros((Tp, HISTORY, STATE_DIM), np.float32)
    sp[:T] = rng.normal(size=(T, HISTORY, STATE_DIM))
    ap = np.zeros(Tp, np.int32)
    ap[:T] = rng.integers(0, 2, T)
    mask = (np.arange(Tp) < T).astype(np.float32)
    adv = np.full(Tp, -0.7, np.float32)
    jloss, jgrads = jax.jit(jax.value_and_grad(_jax_pg_loss(jl.fc, jl.pc)))(
        jl.params, *(jnp.asarray(a) for a in (sp, ap, adv, mask)))
    tloss, tgrads = value_and_grad(
        tl.loss, tl.params, *(torch.from_numpy(a) for a in (sp, ap, adv,
                                                             mask)))
    tol = GRAD_TOL[dtype]
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=tol)
    _assert_tree_close(jgrads, tgrads, tol, "grad")


def test_pg_episode_update_and_draws_match_jax():
    """``train_on_episode`` with padding (T=5 to 8 and T=13 to 16), fp32:
    losses, baseline and parameters agree; ``act_batch``'s sampled actions
    equal JAX's on the same numpy draws."""
    jl, tl = _pg_learners("moe", "float32")
    rng = np.random.default_rng(5)
    for T, ret in ((5, -2.0), (13, -0.5)):
        s = rng.normal(size=(T, HISTORY, STATE_DIM)).astype(np.float32)
        a = rng.integers(0, 2, T)
        jloss = jl.train_on_episode(s, a, ret, pad_to=8)
        tloss = tl.train_on_episode(s, a, ret, pad_to=8)
        np.testing.assert_allclose(tloss, jloss, rtol=1e-4, atol=1e-6)
        assert tl.baseline == jl.baseline
    _assert_tree_close(jl.params, tl.params, 1e-4, "params")
    s = rng.normal(size=(32, HISTORY, STATE_DIM)).astype(np.float32)
    p1 = torch.softmax(tfn.policy_logits(tl.params, tl.fc,
                                         torch.from_numpy(s)), -1)[:, 1]
    u = np.random.default_rng(0)
    u.bit_generator.state = tl.rng.bit_generator.state
    gap = np.abs(u.random(32) - p1.detach().numpy()).min()
    assert gap > 1e-4, "a draw within the tolerance of its probability"
    np.testing.assert_array_equal(tl.act_batch(s), jl.act_batch(s))
    assert jl.rng.bit_generator.state == tl.rng.bit_generator.state


# ------------------------------- learning tests (tests/test_core_rl.py:111)
@pytest.fixture(scope="module")
def fc_small():
    fc = tcore.FoundationConfig(kind="transformer").reduced()
    return dataclasses.replace(fc, kind="transformer", history=8)


def test_dqn_learns_constant_target(fc_small):
    """Q regression toward a fixed reward must reduce TD loss."""
    learner = tcore.DQNLearner(fc_small, tcore.DQNConfig(
        batch_size=8, paper_credit=True), seed=0, device="cpu")
    rng = np.random.default_rng(0)
    batch = {
        "s": rng.normal(size=(8, 8, STATE_DIM)).astype(np.float32) * 0.1,
        "a": rng.integers(0, 2, 8).astype(np.int32),
        "r": np.full(8, -3.0, np.float32),
        "s2": rng.normal(size=(8, 8, STATE_DIM)).astype(np.float32) * 0.1,
        "done": np.ones(8, bool),
    }
    losses = [learner.train_on(batch) for _ in range(30)]
    assert losses[-1] < losses[0] * 0.5


def test_dqn_bootstrap_mode(fc_small):
    learner = tcore.DQNLearner(fc_small, tcore.DQNConfig(
        batch_size=4, paper_credit=False), seed=0, device="cpu")
    rng = np.random.default_rng(0)
    batch = {
        "s": rng.normal(size=(4, 8, STATE_DIM)).astype(np.float32) * 0.1,
        "a": rng.integers(0, 2, 4).astype(np.int32),
        "r": np.zeros(4, np.float32),
        "s2": rng.normal(size=(4, 8, STATE_DIM)).astype(np.float32) * 0.1,
        "done": np.zeros(4, bool),
    }
    l0 = learner.train_on(batch)
    assert np.isfinite(l0)


def _p_submit(learner, s):
    with torch.inference_mode():
        logits = tfn.policy_logits(learner.params, learner.fc,
                                   torch.from_numpy(s))
    return float(torch.softmax(logits, -1)[:, 1].mean())


def test_pg_shifts_probability_toward_rewarded_action(fc_small):
    learner = tcore.PGLearner(fc_small, tcore.PGConfig(
        lr=3e-3, entropy_coef=0.0), seed=0, device="cpu")
    s = np.random.default_rng(0).normal(
        size=(4, 8, STATE_DIM)).astype(np.float32) * 0.1
    a = np.ones(4, np.int32)           # always "submit"
    p0 = _p_submit(learner, s)
    for _ in range(20):
        learner.train_on_episode(s, a, episode_return=+1.0)
    assert _p_submit(learner, s) > p0


def test_pg_padding_invariance(fc_small):
    """Padded episode steps must not contribute gradient."""
    learner_a = tcore.PGLearner(fc_small, tcore.PGConfig(), seed=0,
                                device="cpu")
    learner_b = tcore.PGLearner(fc_small, tcore.PGConfig(), seed=0,
                                device="cpu")
    s = np.random.default_rng(1).normal(
        size=(5, 8, STATE_DIM)).astype(np.float32) * 0.1
    a = np.asarray([0, 1, 0, 1, 1], np.int32)
    learner_a.train_on_episode(s, a, -2.0, pad_to=8)
    learner_b.train_on_episode(s, a, -2.0, pad_to=16)
    for x, y in zip(_leaves(learner_a.params), _leaves(learner_b.params)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-6)
