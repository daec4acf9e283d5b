"""``attention_chunked`` (the port's flash-style scan over kv chunks with
its recomputing backward) against the JAX package's on the same numpy
inputs: the forward and the gradients of q, k and v under a causal mask,
a window, a softcap, GQA (8 q over 2 kv heads) and a last chunk shorter
than the others, fp32, within 3e-5. Then the deliberate divergence: a
non-causal ragged sequence against ``attention_reference``, where the
reference's scan lets its zero-padded keys into the softmax. Last, both
through ``forward`` with ``attn_impl="chunked"``: TinyLlama ``SMOKE``'s
loss and gradients against JAX's, and HuBERT ``SMOKE`` (bidirectional)
against the port's ``"reference"``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import tinyllama_1_1b as j_tiny
from repro.models import attention as j_attn
from repro.models import transformer as jt
from repro_torch import convert
from repro_torch.configs import hubert_xlarge as t_hubert
from repro_torch.configs import tinyllama_1_1b as t_tiny
from repro_torch.models import attention as t_attn
from repro_torch.models import transformer as tt
from repro_torch.train.step import value_and_grad

TOL = 3e-5


def _inputs(seed, B, S, Hq, Hkv, D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, Hq, D), dtype=np.float32)
    k = rng.standard_normal((B, S, Hkv, D), dtype=np.float32)
    v = rng.standard_normal((B, S, Hkv, D), dtype=np.float32)
    g = rng.standard_normal((B, S, Hq, D), dtype=np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    return q, k, v, g, pos


CASES = {                 # causal, window, softcap, S, chunk, Hq, Hkv
    "causal": (True, 0, 0.0, 64, 16, 4, 4),
    "window_softcap": (True, 12, 5.0, 64, 16, 4, 4),
    "gqa_ragged": (True, 10, 3.0, 45, 16, 8, 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_grads_match_jax(case):
    causal, window, softcap, S, chunk, Hq, Hkv = CASES[case]
    q, k, v, g, pos = _inputs(3, 2, S, Hq, Hkv, 16)
    kw = dict(causal=causal, window=window, softcap=softcap, chunk=chunk)
    jout, vjp = jax.vjp(lambda a, b, c: j_attn.attention_chunked(
        a, b, c, jnp.asarray(pos), jnp.asarray(pos), **kw),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    tpos = torch.from_numpy(pos)
    out = t_attn.attention_chunked(tq, tk, tv, tpos, tpos, **kw)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=TOL, rtol=TOL)
    for name, a, b in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL,
                                   rtol=TOL, err_msg=name)


def test_noncausal_ragged_masks_the_padded_tail():
    """Non-causal over 45 keys in chunks of 16: the port equals
    ``attention_reference``; JAX's scan gives its 3 zero keys (at position
    2**30, which no causal mask removes) weight and moves the output."""
    q, k, v, g, pos = _inputs(5, 2, 45, 4, 4, 16)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    tpos = torch.from_numpy(pos)
    out = t_attn.attention_chunked(tq, tk, tv, tpos, tpos, causal=False,
                                   chunk=16)
    ref = t_attn.attention_reference(tq, tk, tv, tpos, tpos, causal=False)
    torch.testing.assert_close(out, ref, atol=TOL, rtol=TOL)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    rgrads = torch.autograd.grad(ref, (tq, tk, tv), torch.from_numpy(g))
    for a, b in zip(grads, rgrads):
        torch.testing.assert_close(a, b, atol=TOL, rtol=TOL)
    jout = j_attn.attention_chunked(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(pos),
                                    jnp.asarray(pos), causal=False, chunk=16)
    assert np.abs(np.asarray(jout) - ref.detach().numpy()).max() > 1e-3


def test_kv_len_valid_masks_by_length():
    q, k, v, _, pos = _inputs(7, 2, 40, 4, 4, 16)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    tpos = torch.from_numpy(pos)
    lens = torch.tensor([17, 33])
    out = t_attn.attention_chunked(*args, tpos, tpos, causal=True, chunk=16,
                                   kv_len_valid=lens[:, None])
    ref = t_attn.attention_reference(*args, tpos, tpos, causal=True,
                                     kv_len_valid=lens[:, None])
    torch.testing.assert_close(out, ref, atol=TOL, rtol=TOL)


def test_loss_and_grads_under_chunked_match_jax():
    """TinyLlama ``SMOKE`` (weights drawn in JAX, converted) at
    ``attn_impl="chunked"`` in chunks of 8 over 20 positions: the loss
    and every leaf's gradient against JAX's at ``"chunked"`` (JAX's
    without remat, which compiles faster and computes the same)."""
    jcfg = j_tiny.SMOKE.replace(attn_impl="chunked", attn_chunk=8,
                                remat=False)
    tcfg = t_tiny.SMOKE.replace(attn_impl="chunked", attn_chunk=8)
    jp = jt.init(jax.random.PRNGKey(0), jcfg)
    tp = convert.from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(4).integers(0, jcfg.vocab, (2, 21))
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jt.loss_fn(p, jcfg, b), has_aux=True))(
        jp, jax.tree.map(jnp.asarray, batch))
    (loss, _), grads = value_and_grad(
        tt.loss_fn, tp, tcfg, {k: torch.from_numpy(v) for k, v in
                               batch.items()}, has_aux=True)
    np.testing.assert_allclose(float(loss), float(jl), atol=TOL)
    ours = jax.tree.leaves(convert.tree_map(
        lambda t: t.detach().numpy(), grads))
    for a, b in zip(ours, jax.tree.leaves(jg)):
        np.testing.assert_allclose(a, np.asarray(b), atol=TOL)


def test_bidirectional_forward_under_chunked_is_the_reference():
    """HuBERT ``SMOKE`` (bidirectional) at ``attn_impl="chunked"`` in
    chunks of 8 over 21 frames: the logits equal ``"reference"``'s, where
    the reference's scan would count its padded keys."""
    cfg = t_hubert.SMOKE
    params = tt.init(torch.Generator().manual_seed(0), cfg)
    frames = torch.randn(2, 21, cfg.d_model,
                         generator=torch.Generator().manual_seed(1))
    pos = torch.arange(21).expand(2, 21)
    with torch.no_grad():
        a, _ = tt.forward(params, cfg.replace(attn_impl="chunked",
                                              attn_chunk=8), frames, pos)
        b, _ = tt.forward(params, cfg.replace(attn_impl="reference"),
                          frames, pos)
    torch.testing.assert_close(a, b, atol=TOL, rtol=TOL)
