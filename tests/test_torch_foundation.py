"""The port's foundation models against the JAX package's, on the same
weights (initialised in JAX, converted with ``repro_torch.convert``) and
the same numpy states.

Tolerances: 1e-4 in fp32 (``compute_dtype="float32"``; the trunk's sums
run in other orders in the two frameworks), and 2e-2 in bf16 (``TOL`` of
tests/test_kernels.py): JAX and PyTorch round the bf16 trunk at the same
points (each projection's output, norm and residual), but from sums taken
in other orders, so single values may differ by a bf16 ulp and the
difference carries through the layers.

The JAX side runs the reference agent config (``attn_impl="reference"``);
the port's agent config runs its flash-attention path, whose plain version
runs here.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import mirage_agent as j_agent
from repro.core import foundation as jf
from repro.models.layers import apply_norm as j_apply_norm
from repro_torch import convert
from repro_torch.configs import mirage_agent as t_agent
from repro_torch.core import foundation as tfn
from repro_torch.models.layers import apply_norm as t_apply_norm

TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _configs(kind, dtype="bfloat16", history=None, reduced=True, **kw):
    """The JAX and the port FoundationConfig of the same model."""
    out = []
    for mod in (jf, tfn):
        fc = mod.FoundationConfig(kind=kind)
        fc = fc.reduced() if reduced else fc
        fc = dataclasses.replace(
            fc, trunk=fc.trunk.replace(compute_dtype=dtype),
            history=history or fc.history, **kw)
        out.append(fc)
    return out


def _weights(jfc, seed=0):
    jp = jf.init_foundation(jax.random.PRNGKey(seed), jfc)
    return jp, convert.from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _states(B, history, seed=0):
    return np.random.default_rng(seed).normal(
        size=(B, history, 40)).astype(np.float32)


@pytest.mark.parametrize("kind", ["transformer", "moe"])
def test_convert_round_trip(kind):
    jfc, tfc = _configs(kind)
    jp, tp = _weights(jfc)
    jnp_tree = jax.tree.map(np.asarray, jp)
    back = convert.to_jax(tp)
    assert jax.tree.structure(back) == jax.tree.structure(jnp_tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jnp_tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # the unused head leaf is carried, with the port's expert axis
    E = 1 if kind == "transformer" else jfc.n_experts
    trunk = tp["trunk"] if kind == "transformer" else tp["experts"]["trunk"]
    assert trunk["head"].shape == (E, jfc.trunk.d_model, jfc.trunk.vocab)
    # native init draws the same tree: same keys, shapes and dtypes
    native = tfn.init_foundation(torch.Generator().manual_seed(0), tfc,
                                 device="cpu")
    assert jax.tree.structure(native) == jax.tree.structure(tp)
    for a, b in zip(jax.tree.leaves(native), jax.tree.leaves(tp)):
        assert a.shape == b.shape and a.dtype == b.dtype


@pytest.mark.parametrize("kind", ["transformer", "moe"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("history", [8, 24])
def test_q_values_and_logits_match(kind, dtype, history):
    jfc, tfc = _configs(kind, dtype, history)
    jp, tp = _weights(jfc, seed=history)
    s = _states(3, history)
    with torch.inference_mode():
        q = tfn.q_values(tp, tfc, torch.from_numpy(s))
        logits = tfn.policy_logits(tp, tfc, torch.from_numpy(s))
    assert q.shape == (3, 2) and logits.shape == (3, 2)
    np.testing.assert_allclose(q.numpy(), np.asarray(
        jf.q_values(jp, jfc, jnp.asarray(s))), atol=TOL[dtype])
    np.testing.assert_allclose(logits.numpy(), np.asarray(
        jf.policy_logits(jp, jfc, jnp.asarray(s))), atol=TOL[dtype])
    np.testing.assert_allclose(
        tfn.reward_prediction(tp, tfc, torch.from_numpy(s)).numpy(),
        np.asarray(jf.reward_prediction(jp, jfc, jnp.asarray(s))),
        atol=TOL[dtype])


def test_gate_top1_matches():
    jfc, tfc = _configs("moe", "float32", gate_top1=True)
    jp, tp = _weights(jfc, seed=4)
    s = _states(5, jfc.history, seed=4)
    tp_ = torch.from_numpy(np.linspace(0, 1, 5).astype(np.float32))
    g = tfn._gate(tp, tfc, torch.from_numpy(s), tp_)
    # hard routing forward: one expert per row
    assert torch.equal((g > 0.5).sum(-1), torch.ones(5, dtype=torch.long))
    np.testing.assert_allclose(g.numpy(), np.asarray(jf._gate(
        jp, jfc, jnp.asarray(s), jnp.asarray(tp_.numpy()))), atol=1e-6)
    np.testing.assert_allclose(
        tfn.q_values(tp, tfc, torch.from_numpy(s), tp_).numpy(),
        np.asarray(jf.q_values(jp, jfc, jnp.asarray(s),
                               jnp.asarray(tp_.numpy()))), atol=1e-4)


def test_gate_sees_zero_time_when_acting():
    """The learners pass no time_pos (dqn.py:49): the gate reads zeros."""
    jfc, tfc = _configs("moe", "float32")
    jp, tp = _weights(jfc, seed=5)
    s = torch.from_numpy(_states(4, jfc.history, seed=5))
    zeros, ones = torch.zeros(4), torch.ones(4)
    none_q = tfn.q_values(tp, tfc, s)
    assert torch.equal(none_q, tfn.q_values(tp, tfc, s, zeros))
    assert not torch.allclose(none_q, tfn.q_values(tp, tfc, s, ones))
    np.testing.assert_allclose(none_q.numpy(), np.asarray(
        jf.q_values(jp, jfc, jnp.asarray(s.numpy()))), atol=1e-4)


def test_mean_pool_runs_in_bf16():
    """foundation.py:82 pools the bf16 final-norm output, then casts: the
    pooled features are bf16 values, as JAX's are."""
    jfc, tfc = _configs("transformer", "bfloat16")
    jp, tp = _weights(jfc, seed=6)
    s = _states(2, jfc.history, seed=6)
    act = np.array([1.0, -1.0], np.float32)
    ours = tfn._trunk_apply(tp, tfc, torch.from_numpy(s),
                            torch.from_numpy(act))[0]
    assert torch.equal(ours, ours.to(torch.bfloat16).float())
    theirs = np.asarray(jf._trunk_apply(jp, jfc, jnp.asarray(s),
                                        jnp.asarray(act)))
    np.testing.assert_allclose(ours.numpy(), theirs, atol=2e-2)


def test_norm_in_fp32_cast_back():
    cfg_j, cfg_t = j_agent.CONFIG, t_agent.CONFIG
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(2, 5, cfg_j.d_model)) * 3 + 1).astype(np.float32)
    scale = rng.normal(size=cfg_j.d_model).astype(np.float32)
    bias = rng.normal(size=cfg_j.d_model).astype(np.float32)
    ours = t_apply_norm({"scale": torch.from_numpy(scale),
                         "bias": torch.from_numpy(bias)},
                        torch.from_numpy(x).to(torch.bfloat16), cfg_t)
    theirs = j_apply_norm({"scale": jnp.asarray(scale),
                           "bias": jnp.asarray(bias)},
                          jnp.asarray(x).astype(jnp.bfloat16), cfg_j)
    assert ours.dtype == torch.bfloat16
    # one rounding of the same fp32 value: at most one bf16 ulp apart
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(theirs.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-6)


def test_full_width_transformer_bf16():
    """mirage_agent.CONFIG at its published width, history 144, B=2."""
    jfc, tfc = _configs("transformer", "bfloat16", reduced=False)
    assert tfc.trunk.d_model == 256 and tfc.history == 144
    assert tfc.trunk.attn_impl == "flash" and jfc.trunk.attn_impl == "reference"
    jp, tp = _weights(jfc, seed=8)
    s = _states(2, 144, seed=8)
    with torch.inference_mode():
        q = tfn.q_values(tp, tfc, torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(q, np.asarray(jf.q_values(jp, jfc,
                                                         jnp.asarray(s))),
                               atol=2e-2)
