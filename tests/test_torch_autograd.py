"""The backward kernels' plain versions against JAX, and the autograd
wiring of the flash and grouped-GEMM wrappers, on the CPU.

* ``flash_attention_bwd_ref`` (from the forward's out and row log-sum-exp)
  against ``jax.vjp`` of the JAX package's ``attention_chunked``, whose VJP
  is the ``flash_bwd`` it is written after, and against torch autograd of
  ``flash_attention_ref``: causal and not, GQA, softcap, the trunk's ragged
  S=144. fp32, 3e-5 absolute plus 1e-5 relative: the repo's fp32 attention
  bound (tests/test_kernels.py), sums over 144 terms in other orders.
* ``grouped_gemm_bwd_ref`` against ``jax.vjp`` of the einsum the Pallas
  kernel computes (the Pallas call itself has no VJP: ``jax.vjp`` of
  ``moe_grouped_gemm`` raises), and against the Pallas kernel in interpret
  mode applied to the two backward products. fp32 2e-5, the repo's GEMM
  bound; bf16 2e-2 (one rounding at the output after sums in two orders).
* On the card the wrappers differentiate through ``autograd.Function``s
  whose launches cannot run here. These tests route a reduced trunk's calls
  to the card's route on CPU tensors, with each launch replaced by its plain
  version, and check that every parameter leaf gets the gradient autograd
  gives the plain path, with the backward launches counted, and that
  serving (no_grad, inference_mode) never enters the Functions. A wrapper
  whose output had no ``grad_fn`` would leave the attention and projection
  weights without gradient and fail here.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_gemm.ops import moe_grouped_gemm
from repro.models.attention import attention_chunked
from repro_torch.convert import tree_map
from repro_torch.core import DQNConfig, DQNLearner, FoundationConfig
from repro_torch.core.dqn import value_and_grad
from repro_torch.core.state import STATE_DIM
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_ref,
                                                 flash_attention_lse_ref,
                                                 flash_attention_ref)
from repro_torch.kernels.moe_gemm import ops as gemm_ops
from repro_torch.kernels.moe_gemm import (grouped_gemm, grouped_gemm_bwd_ref,
                                          grouped_gemm_ref)
from repro_torch.models import attention, layers

FLASH_ATOL, FLASH_RTOL = 3e-5, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests push many tiny tensors through the CPU; intra-op threads
    only spin on them and take the cores the other test workers run on."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


# -------------------------------------------------------- flash backward
@pytest.mark.parametrize("B,Sq,Hq,Hkv,D,causal,softcap", [
    (2, 144, 4, 4, 32, False, 0.0),      # the trunk's S, ragged tiles
    (2, 144, 4, 4, 32, True, 0.0),
    (1, 61, 8, 2, 16, True, 30.0),       # GQA, softcap
    (2, 40, 4, 1, 64, False, 20.0),
])
def test_flash_bwd_ref_matches_jax_vjp(B, Sq, Hq, Hkv, D, causal, softcap):
    q, k, v, do = _normal(Sq + D, (B, Sq, Hq, D), (B, Sq, Hkv, D),
                          (B, Sq, Hkv, D), (B, Sq, Hq, D))
    pos = jnp.broadcast_to(jnp.arange(Sq)[None], (B, Sq))
    # JAX pads the last kv chunk with zero keys at position 2**30, which
    # only the causal mask removes: without it they would join the softmax,
    # so non-causal cases take one chunk of the whole sequence
    chunk = 64 if causal else Sq
    out, vjp = jax.vjp(lambda a, b, c: attention_chunked(
        a, b, c, pos, pos, causal=causal, softcap=softcap, chunk=chunk),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    opts = dict(causal=causal, softcap=softcap)
    o = flash_attention_ref(tq, tk, tv, **opts)
    np.testing.assert_allclose(o.numpy(), np.asarray(out), atol=FLASH_ATOL,
                               rtol=FLASH_RTOL)
    lse = flash_attention_lse_ref(tq, tk, **opts)
    assert lse.shape == (B, Hq, Sq) and lse.dtype == torch.float32
    grads = flash_attention_bwd(tq, tk, tv, o, lse, tdo, device="cpu", **opts)
    for name, g, jg in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg),
                                   atol=FLASH_ATOL, rtol=FLASH_RTOL,
                                   err_msg=f"d{name}")
    # and against autograd of the forward's plain version
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    auto = torch.autograd.grad(flash_attention_ref(*leaves, **opts), leaves,
                               tdo)
    for name, g, ag in zip("qkv", grads, auto):
        torch.testing.assert_close(g, ag, atol=FLASH_ATOL, rtol=FLASH_RTOL,
                                   msg=f"d{name}")


def test_flash_bwd_ref_bf16_dtypes_and_shapes():
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in _normal(
        1, (2, 30, 4, 32), (2, 30, 2, 32), (2, 30, 2, 32), (2, 30, 4, 32)))
    o = flash_attention_ref(q, k, v, causal=True)
    lse = flash_attention_lse_ref(q, k, causal=True)
    dq, dk, dv = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=True)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, k, v, o, lse.bfloat16(), do, device="cpu")


# --------------------------------------------------------- GEMM backward
@pytest.mark.parametrize("E,C,d,f,dtype", [
    (3, 144, 64, 96, "float32"), (2, 200, 128, 64, "float32"),
    (3, 144, 64, 96, "bfloat16")])
def test_gemm_bwd_ref_matches_jax(E, C, d, f, dtype):
    x, w, dy = _normal(C, (E, C, d), (E, d, f), (E, C, f))
    jdt = jnp.dtype(dtype)
    jx, jw, jdy = (jnp.asarray(a).astype(jdt) for a in (x, w, dy))
    _, vjp = jax.vjp(lambda a, b: jnp.einsum(
        "ecd,edf->ecf", a, b, preferred_element_type=jnp.float32).astype(jdt),
        jx, jw)
    jdx, jdw = vjp(jdy)
    # the Pallas kernel (interpret mode) on the two backward products
    kdx = moe_grouped_gemm(jdy, jnp.swapaxes(jw, 1, 2), interpret=True)
    kdw = moe_grouped_gemm(jnp.swapaxes(jx, 1, 2), jdy, interpret=True)
    tdt = getattr(torch, dtype)
    tx, tw, tdy = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)
                   for a in (jx, jw, jdy))
    dx, dw = grouped_gemm_bwd_ref(tx, tw, tdy)
    assert dx.dtype == dw.dtype == tdt
    tol = 2e-5 if dtype == "float32" else 2e-2
    for g, refs in ((dx, (jdx, kdx)), (dw, (jdw, kdw))):
        for ref in refs:
            np.testing.assert_allclose(g.float().numpy(),
                                       np.asarray(ref.astype(jnp.float32)),
                                       atol=tol, rtol=tol)


# ------------------------------------------------------ autograd wiring
def _flash_route(q, k, v, *, causal=True, window=0, softcap=0.0, scale=None,
                 device=None):
    """``flash_attention``'s card route, taken on CPU tensors."""
    fa_ops._check(q, k, v)
    return fa_ops._flash_cuda(q, k, v, causal=causal, window=window,
                              softcap=softcap,
                              scale=scale or 1.0 / math.sqrt(q.shape[3]))


def _gemm_route(x, w, *, device=None):
    """``grouped_gemm``'s card route, taken on CPU tensors."""
    return gemm_ops._gemm_cuda(x, w)


def _flash_launch(q, k, v, variant, *, causal, window, softcap, scale,
                  lse=False):
    out = flash_attention_ref(q, k, v, causal=causal, window=window,
                              softcap=softcap, scale=scale)
    if not lse:
        return out
    return out, flash_attention_lse_ref(q, k, causal=causal, softcap=softcap,
                                        scale=scale)


@pytest.fixture
def card_route(monkeypatch):
    """The model's flash and GEMM calls take the card's route, each kernel
    launch replaced by its plain version; counters start at 0."""
    monkeypatch.setattr(fa_ops, "_launch", _flash_launch)
    monkeypatch.setattr(fa_ops, "_launch_bwd",
                        lambda q, k, v, o, lse, do, variant, **kw:
                        flash_attention_bwd_ref(q, k, v, o, lse, do, **kw))
    monkeypatch.setattr(gemm_ops, "_launch",
                        lambda x, w, variant, trans_x=False: grouped_gemm_ref(
                            x.transpose(1, 2) if trans_x else x, w))
    monkeypatch.setattr(attention, "flash_attention", _flash_route)
    monkeypatch.setattr(attention, "grouped_gemm", _gemm_route)
    monkeypatch.setattr(layers, "grouped_gemm", _gemm_route)
    for name, value in (("launches", 0), ("tc_launches", 0)):
        monkeypatch.setattr(flash_attention, name, value)
        monkeypatch.setattr(grouped_gemm, name, value)
    for name in ("bwd_launches", "bwd_tc_launches"):
        monkeypatch.setattr(grouped_gemm, name, 0)
    monkeypatch.setattr(fa_ops.flash_attention_bwd, "launches", 0)
    monkeypatch.setattr(fa_ops.flash_attention_bwd, "tc_launches", 0)


def _learner(kind, dtype):
    fc = FoundationConfig(kind=kind).reduced()
    fc = dataclasses.replace(fc, kind=kind, trunk=fc.trunk.replace(
        compute_dtype=dtype))
    return DQNLearner(fc, DQNConfig(paper_credit=True), seed=0, device="cpu")


def _batch(n, history):
    rng = np.random.default_rng(0)
    return {"s": torch.from_numpy(rng.normal(size=(n, history, STATE_DIM))
                                  .astype(np.float32)),
            "a": torch.from_numpy(rng.integers(0, 2, n)),
            "r": torch.from_numpy(rng.normal(size=n).astype(np.float32))}


@pytest.mark.parametrize("kind", ["transformer", "moe"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trunk_gradients_through_the_functions(card_route, monkeypatch, kind,
                                               dtype):
    learner = _learner(kind, dtype)
    batch = _batch(3, learner.fc.history)
    loss, grads = value_and_grad(learner.loss, learner.params, batch)
    layers_n = learner.fc.trunk.n_layers
    assert fa_ops.flash_attention_bwd.launches == layers_n
    assert grouped_gemm.bwd_launches == 2 * 6 * layers_n
    assert flash_attention.launches == layers_n
    assert grouped_gemm.launches == 6 * layers_n
    # the tensor-core variants' rules hold for the bf16 trunk on CPU too
    assert grouped_gemm.bwd_tc_launches == (grouped_gemm.bwd_launches
                                            if dtype == "bfloat16" else 0)
    assert fa_ops.flash_attention_bwd.tc_launches == (
        layers_n if dtype == "bfloat16" else 0)
    monkeypatch.undo()                       # the plain path
    ploss, pgrads = value_and_grad(learner.loss, learner.params, batch)
    tol = 1e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(loss, ploss, atol=0, rtol=tol)
    flat, pflat = [], []
    tree_map(flat.append, grads)
    tree_map(pflat.append, pgrads)
    for i, (g, pg) in enumerate(zip(flat, pflat)):
        scale = float(pg.abs().max())
        assert float((g - pg).abs().max()) <= tol * max(scale, 1e-30), i
    # every trunk weight upstream of attention and the projections moved
    seg = (grads["experts"] if kind == "moe" else grads)["trunk"]["segments"]
    for name in ("wq", "wk", "wv", "wo"):
        assert seg[0]["b0"]["attn"][name].abs().sum() > 0, name
    for name in ("wi", "wo"):
        assert seg[0]["b0"]["ffn"][name].abs().sum() > 0, name


def test_serving_never_enters_the_functions(card_route, monkeypatch):
    """Under no_grad and inference_mode, and for parameters that do not
    require grad, the wrappers launch directly: no Function, no grad_fn."""
    class Refuse:
        @staticmethod
        def apply(*args):
            raise AssertionError("serving went through an autograd.Function")
    monkeypatch.setattr(fa_ops, "_FlashFn", Refuse)
    monkeypatch.setattr(gemm_ops, "_GemmFn", Refuse)
    learner = _learner("moe", "bfloat16")
    s = _batch(2, learner.fc.history)["s"]
    trainable = tree_map(lambda t: t.detach().requires_grad_(True),
                         learner.params)
    from repro_torch.core.foundation import q_values
    for ctx in (torch.no_grad, torch.inference_mode):
        with ctx():
            assert q_values(trainable, learner.fc, s).grad_fn is None
    assert learner.act_batch(s.numpy(), explore=False).shape == (2,)
    n = learner.fc.trunk.n_layers
    assert flash_attention.launches == 3 * n      # three passes, one each
    assert grouped_gemm.launches == 3 * 6 * n
    assert grouped_gemm.bwd_launches == 0
    assert fa_ops.flash_attention_bwd.launches == 0


def test_flash_function_refuses_a_window(card_route):
    q = torch.zeros(1, 8, 2, 16, requires_grad=True)
    with pytest.raises(NotImplementedError, match="window"):
        _flash_route(q, q, q, window=4)
    with torch.no_grad():
        assert _flash_route(q, q, q, window=4).shape == q.shape
