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
  The fused kernel's split-K dW, modelled by ``grouped_gemm_dw_split_ref``
  (fp32 partials summed in split order, one rounding to bf16), against
  both at the trunk's widths, bf16 2e-2.
* ``rmsnorm_bwd_ref`` against ``jax.vjp`` of the JAX package's RMSNorm
  (``apply_norm``), with and without gemma: fp32 1e-5, bf16 2e-2 of each
  gradient's scale (one rounding at the output, sums in other orders).
* ``ssd_bwd_ref``, written as the backward kernel computes (the chunk
  states recomputed, then a reverse walk over the chunks), against
  ``jax.vjp`` of ``ssd_chunked`` and against torch autograd of ``ssd_ref``:
  one chunk and many, a ragged last chunk, G = 1 and 2, an initial state
  and the final state's gradient; fp32, 1e-5 of each gradient's scale
  (sums over up to 100 positions in other orders).
* On the card the wrappers differentiate through ``autograd.Function``s
  whose launches cannot run here. These tests route a reduced trunk's calls
  (and a reduced Mamba2's) to the card's route on CPU tensors, with each
  launch replaced by its plain version, and check that every parameter leaf
  gets the gradient autograd gives the plain path, with the backward
  launches counted, and that serving (no_grad, inference_mode) never enters
  the Functions. A wrapper whose output had no ``grad_fn`` would leave the
  weights upstream of it without gradient and fail here.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import mamba2_1_3b as j_mamba
from repro.kernels.moe_gemm.ops import moe_grouped_gemm
from repro.models.attention import attention_chunked
from repro.models.layers import apply_norm as j_apply_norm
from repro.models.ssm import ssd_chunked
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
                                          grouped_gemm_dw_split_ref,
                                          grouped_gemm_ref, split_count)
from repro_torch.configs import mamba2_1_3b as t_mamba
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm import (rmsnorm, rmsnorm_bwd, rmsnorm_bwd_ref,
                                         rmsnorm_ref)
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ssd, ssd_bwd, ssd_bwd_ref, ssd_ref
from repro_torch.models import attention, layers, ssm
from repro_torch.models import transformer as tt
from repro_torch.train.step import value_and_grad as value_and_grad_aux

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


@pytest.mark.parametrize("din,dout", [(256, 256), (256, 1024), (1024, 256)])
@pytest.mark.parametrize("splits", [2, 6])
def test_split_k_dw_model_matches_jax_at_trunk_widths(din, dout, splits):
    """The trunk's projection widths (6 splits is the card's choice for
    256->256), 2 experts and a ragged C = 1001 (16 k-steps of 64 rows, the
    last ragged) in place of the trunk's E=10, C=9216."""
    E, C = 2, 1001
    x, w, dy = _normal(din + dout + splits, (E, C, din), (E, din, dout),
                       (E, C, dout))
    jx, jw, jdy = (jnp.asarray(a * din ** -0.25).astype(jnp.bfloat16)
                   for a in (x, w, dy))
    _, vjp = jax.vjp(lambda a, b: jnp.einsum(
        "ecd,edf->ecf", a, b,
        preferred_element_type=jnp.float32).astype(jnp.bfloat16), jx, jw)
    _, jdw = vjp(jdy)
    tx, tw, tdy = (torch.from_numpy(np.array(a.astype(jnp.float32)))
                   .bfloat16() for a in (jx, jw, jdy))
    dw = grouped_gemm_dw_split_ref(tx, tdy, splits)
    plain = grouped_gemm_bwd_ref(tx, tw, tdy)[1]
    assert dw.dtype == torch.bfloat16 and dw.shape == (E, din, dout)
    for ref in (plain, torch.from_numpy(np.array(jdw.astype(jnp.float32)))):
        torch.testing.assert_close(dw.float(), ref.float(), atol=2e-2,
                                   rtol=2e-2)
    # whole 64-row steps, summed in split order, one rounding
    cut = [16 * s // splits * 64 for s in range(splits)] + [C]
    total = 0
    for lo, hi in zip(cut, cut[1:]):
        total = total + torch.einsum("ecd,ecf->edf", tx[:, lo:hi].float(),
                                     tdy[:, lo:hi].float())
    assert torch.equal(dw, total.bfloat16())
    assert torch.equal(grouped_gemm_dw_split_ref(tx, tdy, 1), plain)


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


def _gemm_launch_bwd(x, w, dy, need_dx, need_dw):
    """The fused backward kernel's plain stand-in: dX as the plain backward
    gives it, dW through the split-K model at the split count the kernel
    would take on an H100's 132 SMs."""
    E, C, d = x.shape
    dx = grouped_gemm_bwd_ref(x, w, dy)[0] if need_dx else None
    dw = grouped_gemm_dw_split_ref(x, dy, split_count(
        E, d, w.shape[2], C, 132)) if need_dw else None
    return dx, dw


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
    monkeypatch.setattr(gemm_ops, "_launch_bwd", _gemm_launch_bwd)
    monkeypatch.setattr(attention, "flash_attention", _flash_route)
    monkeypatch.setattr(attention, "grouped_gemm", _gemm_route)
    monkeypatch.setattr(layers, "grouped_gemm", _gemm_route)
    for name, value in (("launches", 0), ("tc_launches", 0)):
        monkeypatch.setattr(flash_attention, name, value)
        monkeypatch.setattr(grouped_gemm, name, value)
    for name in ("bwd_launches", "bwd_tc_launches", "bwd_fused_calls"):
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
    # the tensor-core variants' rules hold for the bf16 trunk on CPU too:
    # there every projection's backward is one call of the fused kernel
    assert grouped_gemm.bwd_tc_launches == (grouped_gemm.bwd_launches
                                            if dtype == "bfloat16" else 0)
    assert grouped_gemm.bwd_fused_calls == (6 * layers_n
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


@pytest.mark.parametrize("dtype,leaves", [
    ("bfloat16", "xw"), ("bfloat16", "x"), ("bfloat16", "w"),
    ("float32", "xw")])
def test_gemm_backward_calls_per_projection(card_route, dtype, leaves):
    """A bf16 projection's backward is one call of the fused kernel that
    computes only the gradients autograd asks for; fp32 keeps the
    two-launch route on the CUDA cores. Either way the products are
    counted."""
    x, w, dy = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in
                _normal(3, (3, 144, 64), (3, 64, 96), (3, 144, 96)))
    x.requires_grad_("x" in leaves)
    w.requires_grad_("w" in leaves)
    want = [t for t in (x, w) if t.requires_grad]
    got = torch.autograd.grad(_gemm_route(x, w), want, dy)
    refs = grouped_gemm_bwd_ref(x.detach(), w.detach(), dy)
    for g, r in zip(got, [r for r, t in zip(refs, (x, w)) if t.requires_grad]):
        assert torch.equal(g, r)
    tc = dtype == "bfloat16"
    assert grouped_gemm.bwd_fused_calls == int(tc)
    assert grouped_gemm.bwd_launches == len(leaves)
    assert grouped_gemm.bwd_tc_launches == (len(leaves) if tc else 0)


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


# ------------------------------------------------------ RMSNorm backward
def _within(got, ref, tol, what):
    """max|got - ref| within ``tol`` of ref's largest magnitude."""
    got = np.asarray(got.float() if torch.is_tensor(got) else got,
                     np.float32)
    ref = np.asarray(ref.float() if torch.is_tensor(ref) else ref,
                     np.float32)
    assert got.shape == ref.shape, what
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * max(scale, 1e-30), f"{what}: {err} (scale {scale})"


def _f32(a):
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gemma", [False, True])
def test_rmsnorm_bwd_ref_matches_jax_vjp(dtype, gemma):
    x, w, dy = _normal(11, (3, 17, 48), (48,), (3, 17, 48))
    cfg = j_mamba.SMOKE.replace(gemma_norm=gemma)
    jdt = jnp.dtype(dtype)
    jx, jdy = jnp.asarray(3 * x).astype(jdt), jnp.asarray(dy).astype(jdt)
    jw = jnp.asarray(0.5 * w)
    _, vjp = jax.vjp(lambda a, s: j_apply_norm({"scale": s}, a, cfg), jx, jw)
    jdx, jdw = vjp(jdy)
    tdt = getattr(torch, dtype)
    tx, tdy, tw = _f32(jx).to(tdt), _f32(jdy).to(tdt), _f32(jw)
    dx, dw = rmsnorm_bwd(tx, tw, tdy, eps=cfg.norm_eps, gemma=gemma,
                         device="cpu")
    assert dx.dtype == tdt and dw.dtype == torch.float32
    tol = 1e-5 if dtype == "float32" else 2e-2
    _within(dx, _f32(jdx), tol, "dx")
    _within(dw, _f32(jdw), tol, "dw")
    # and against autograd of the forward's plain version
    leaves = [tx.clone().requires_grad_(True), tw.clone().requires_grad_(True)]
    auto = torch.autograd.grad(rmsnorm_ref(*leaves, eps=cfg.norm_eps,
                                           gemma=gemma), leaves, tdy)
    _within(dx, auto[0], tol, "dx (autograd)")
    _within(dw, auto[1], tol, "dw (autograd)")


# ---------------------------------------------------------- SSD backward
def _ssd_inputs(seed, Bz, S, H, P, N, G):
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)
    dt = np.log1p(np.exp(n(Bz, S, H) - 1.0)).astype(np.float32)
    return (n(Bz, S, H, P, scale=0.5), dt, -np.exp(n(H, scale=0.3)),
            n(Bz, S, G, N, scale=0.3), n(Bz, S, G, N, scale=0.3), n(H),
            n(Bz, H, P, N, scale=0.3), n(Bz, S, H, P), n(Bz, H, P, N))


@pytest.mark.parametrize("S,chunk,G,init,dfin", [
    (64, 64, 1, False, False),      # one chunk
    (96, 32, 1, True, True),        # three whole chunks
    (77, 16, 2, True, False),       # ragged last chunk, groups
    (50, 64, 2, False, True),       # chunk longer than the sequence
    (100, 256, 1, True, True),      # one chunk of 100, off the kernel's tiles
])
def test_ssd_bwd_ref_matches_jax_vjp(S, chunk, G, init, dfin):
    Bz, H, P, N = 2, 4, 16, 8
    x, dt, A, B, C, D, s0, dy, df = _ssd_inputs(S + chunk, Bz, S, H, P, N, G)
    args = [jnp.asarray(a) for a in (x, dt, A, B, C, D)]
    if init:
        out, vjp = jax.vjp(lambda *a: ssd_chunked(*a[:6], chunk, a[6]),
                           *args, jnp.asarray(s0))
    else:
        out, vjp = jax.vjp(lambda *a: ssd_chunked(*a, chunk), *args)
    jgrads = vjp((jnp.asarray(dy), jnp.asarray(df) if dfin
                  else jnp.zeros_like(out[1])))
    targs = [torch.from_numpy(a) for a in (x, dt, A, B, C, D)]
    t0 = torch.from_numpy(s0) if init else None
    tdf = torch.from_numpy(df) if dfin else None
    grads = ssd_bwd(*targs, chunk, torch.from_numpy(dy), t0, tdf,
                    device="cpu")
    assert (grads[6] is None) == (not init)
    names = ("dx", "ddt", "dA", "dB", "dC", "dD", "dinit")
    for name, g, jg in zip(names, grads, jgrads):
        _within(g, jg, 1e-5, name)
    # and against autograd of the forward's plain version
    leaves = [t.clone().requires_grad_(True)
              for t in targs + ([t0] if init else [])]
    y, final = ssd_ref(*leaves[:6], chunk, leaves[6] if init else None)
    auto = torch.autograd.grad((y, final), leaves,
                               (torch.from_numpy(dy),
                                tdf if dfin else torch.zeros_like(final)))
    for name, g, ag in zip(names, grads, auto):
        _within(g, ag, 1e-5, name + " (autograd)")


def test_ssd_bwd_ref_bf16_dtypes_and_checks():
    x, dt, A, B, C, D, s0, dy, df = _ssd_inputs(3, 1, 40, 2, 16, 8, 1)
    bx, bB, bC, bdy = (torch.from_numpy(a).bfloat16() for a in (x, B, C, dy))
    rest = [torch.from_numpy(a) for a in (dt, A)]
    grads = ssd_bwd(bx, rest[0], rest[1], bB, bC, torch.from_numpy(D), 16,
                    bdy, device="cpu")
    assert [g.dtype for g in grads[:6]] == [torch.bfloat16] + \
        [torch.float32] * 2 + [torch.bfloat16] * 2 + [torch.float32]
    assert grads[3].shape == bB.shape and grads[6] is None
    with pytest.raises(ValueError, match="dy"):
        ssd_bwd(bx, rest[0], rest[1], bB, bC, torch.from_numpy(D), 16,
                bdy.float(), device="cpu")
    with pytest.raises(ValueError, match="d_final"):
        ssd_bwd(bx, rest[0], rest[1], bB, bC, torch.from_numpy(D), 16, bdy,
                d_final=torch.from_numpy(df).bfloat16(), device="cpu")


# ------------------------------------------------ Mamba2 autograd wiring
def _rmsnorm_route(x, w, *, eps=1e-6, gemma=False, device=None):
    """``rmsnorm``'s card route, taken on CPU tensors."""
    rms_ops._check(x, w)
    return rms_ops._rmsnorm_cuda(x, w, eps=eps, gemma=gemma)


def _ssd_route(x, dt, A, B, C, D, chunk, initial_state=None, *, device=None):
    """``ssd``'s card route, taken on CPU tensors."""
    ssd_ops._check(x, dt, A, B, C, D, chunk, initial_state)
    return ssd_ops._ssd_cuda(x, dt, A, B, C, D, chunk, initial_state)


@pytest.fixture
def lm_card_route(monkeypatch):
    """The Mamba2 model's RMSNorm and SSD calls take the card's route, each
    kernel launch replaced by its plain version; counters start at 0."""
    monkeypatch.setattr(rms_ops, "_launch", lambda flat, w, variant, *, eps,
                        gemma: rmsnorm_ref(flat, w, eps=eps, gemma=gemma))
    monkeypatch.setattr(rms_ops, "_launch_bwd", lambda flat, w, dy, variant,
                        *, eps, gemma: rmsnorm_bwd_ref(flat, w, dy, eps=eps,
                                                       gemma=gemma))
    monkeypatch.setattr(ssd_ops, "_launch",
                        lambda x, dt, A, B, C, D, Q, init, variant:
                        ssd_ref(x, dt, A, B, C, D, Q, init))
    monkeypatch.setattr(ssd_ops, "_launch_bwd",
                        lambda x, dt, A, B, C, D, Q, dy, init, d_final,
                        variant: ssd_bwd_ref(x, dt, A, B, C, D, Q, dy, init,
                                             d_final))
    monkeypatch.setattr(layers, "rmsnorm", _rmsnorm_route)
    monkeypatch.setattr(ssm, "ssd", _ssd_route)
    for name in ("launches", "vec_launches", "bwd_launches",
                 "bwd_vec_launches"):
        monkeypatch.setattr(rmsnorm, name, 0)
    for name in ("launches", "tc_launches", "bwd_launches",
                 "bwd_tc_launches"):
        monkeypatch.setattr(ssd, name, 0)


def _lm(dtype):
    cfg = t_mamba.SMOKE.replace(compute_dtype=dtype)
    params = tt.init(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 40)))
    batch = {"inputs": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    return cfg, params, batch


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_gradients_through_the_functions(lm_card_route, monkeypatch,
                                                dtype):
    """``loss_fn``'s gradient on the card's route (39 tokens: two chunks
    of 16 and a ragged one) equals the plain path's, leaf by leaf (fp32
    1e-5, bf16 2e-2 of each leaf's scale), with every norm and scan's
    backward launched once a pass."""
    cfg, params, batch = _lm(dtype)
    (loss, metrics), grads = value_and_grad_aux(
        lambda p, b: tt.loss_fn(p, cfg, b), params, batch, has_aux=True)
    L = cfg.n_layers
    assert (rmsnorm.launches, rmsnorm.bwd_launches) == (2 * L + 1, 2 * L + 1)
    assert (ssd.launches, ssd.bwd_launches) == (L, L)
    # the variants the card would run: every norm's backward vectorised,
    # the scan's on the tensor cores in bf16
    assert rmsnorm.bwd_vec_launches == 2 * L + 1
    assert ssd.bwd_tc_launches == (L if dtype == "bfloat16" else 0)
    monkeypatch.undo()                       # the plain path
    (ploss, _), pgrads = value_and_grad_aux(
        lambda p, b: tt.loss_fn(p, cfg, b), params, batch, has_aux=True)
    tol = 1e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(loss, ploss, atol=0, rtol=tol)
    flat, pflat = [], []
    tree_map(flat.append, grads)
    tree_map(pflat.append, pgrads)
    for i, (g, pg) in enumerate(zip(flat, pflat)):
        _within(g, pg, tol, f"leaf {i}")
    # every leaf upstream of the norms and scans moved
    for name in ("w_x", "w_B", "w_C", "w_dt", "A_log", "D", "dt_bias",
                 "conv_x_w"):
        assert grads["segments"][0]["b0"]["mamba"][name].abs().sum() > 0, \
            name
    assert grads["final_norm"]["scale"].abs().sum() > 0


def test_mamba2_serving_never_enters_the_functions(lm_card_route,
                                                   monkeypatch):
    """Prefill and decode under no_grad and inference_mode, on parameters
    that require grad, launch the forward kernels directly."""
    class Refuse:
        @staticmethod
        def apply(*args):
            raise AssertionError("serving went through an autograd.Function")
    monkeypatch.setattr(rms_ops, "_RMSNormFn", Refuse)
    monkeypatch.setattr(ssd_ops, "_SSDFn", Refuse)
    cfg, params, batch = _lm("float32")
    trainable = tree_map(lambda t: t.detach().requires_grad_(True), params)
    toks = batch["inputs"]
    pos = torch.arange(toks.shape[1]).expand(toks.shape)
    for ctx in (torch.no_grad, torch.inference_mode):
        with ctx():
            logits, cache = tt.prefill(trainable, cfg, toks, pos)
            tok = logits.argmax(-1, keepdim=True)
            logits2, _ = tt.decode_step(trainable, cfg, tok, pos[:, -1:] + 1,
                                        cache, toks.shape[1])
        assert logits.grad_fn is None and logits2.grad_fn is None
    L = cfg.n_layers
    assert rmsnorm.launches == 2 * 2 * (2 * L + 1)
    assert ssd.launches == 2 * L
    assert rmsnorm.bwd_launches == ssd.bwd_launches == 0
