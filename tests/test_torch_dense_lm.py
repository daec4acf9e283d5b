"""The port's dense attention LM (TinyLlama-1.1B) against the JAX package's,
on the CPU.

* ``rope_freqs`` and ``apply_rope`` at positions up to 4096, fp32 and bf16;
  the LM-layout MLP.
* ``attn_prefill`` (both cache branches) and ``attn_decode`` on one layer's
  weights, scalar indices against JAX's decode and per-row indices against
  JAX's ``vmap`` of its single-sequence decode.
* TinyLlama ``SMOKE`` (2 layers, d 64, 4/2 heads of 16, fp32) through
  ``forward``, ``loss_fn`` and its gradients, ``prefill`` plus 8 decode
  steps (with ``attn_impl="reference"`` on both sides, and with ``"flash"``:
  JAX's Pallas kernel in interpret mode, the port's plain version),
  ``make_prefill_step``/``make_serve_step``, ``ServeEngine`` and the serve
  launcher, on weights initialised in JAX and converted.

Tolerances: the model 1e-4 in fp32, as the other model tests; RoPE 1e-5 in
fp32 at angles under 96 (both frameworks' cos and sin of the same fp32
angles agree within 1e-7), one fp32 spacing of the largest angle times
2|x| up to position 4095 (the angle is itself a rounded fp32 product), and
one bf16 ulp (2^-7 relative to the largest value) in bf16, where the one
rounding at the output may land either side. Greedy
tokens are compared while every decode call's logits agree within 1e-4 and
no row's top-2 gap falls under it (tests/test_torch_lm_serve.py's rule).
"""
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import tinyllama_1_1b as j_tiny
from repro.models import attention as j_attn
from repro.models import layers as j_layers
from repro.models import transformer as jt
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.train import make_prefill_step as j_make_prefill_step
from repro.train import make_serve_step as j_make_serve_step
from repro_torch import convert
from repro_torch.configs import tinyllama_1_1b as t_tiny
from repro_torch.launch import serve as t_launch
from repro_torch.models import attention as t_attn
from repro_torch.models import layers as t_layers
from repro_torch.models import registry
from repro_torch.models import transformer as tt
from repro_torch.serve import Request, ServeEngine
from repro_torch.train import make_prefill_step, make_serve_step
from repro_torch.train.step import value_and_grad

TOL = 1e-4
ROPE_TOL = 1e-5
DECODE_STEPS = 8


def _np(t):
    return t.detach().float().numpy()


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


def _pos(B, S, start=0):
    return np.broadcast_to(np.arange(start, start + S)[None], (B, S)).copy()


def _configs(attn_impl="reference"):
    return (j_tiny.SMOKE.replace(attn_impl=attn_impl),
            t_tiny.SMOKE.replace(attn_impl=attn_impl))


@pytest.fixture(scope="module")
def model():
    jp = jt.init(jax.random.PRNGKey(0), j_tiny.SMOKE)
    return jp, convert.from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _torch(jtree):
    """A JAX subtree (one layer's weights) as CPU tensors."""
    return convert.tree_map(lambda a: torch.from_numpy(np.array(a)), jtree)


def _layer(seed, cfg):
    """One attention layer's weights in JAX and converted."""
    jp = j_attn.init_attention(jax.random.PRNGKey(seed), cfg)
    return jp, _torch(jp)


def _x(seed, B, S, d):
    return np.random.default_rng(seed).normal(size=(B, S, d)).astype(
        np.float32)


# ------------------------------------------------------------------ config
def test_config_is_the_reference_but_flash():
    full_j, full_t = j_tiny.CONFIG, t_tiny.CONFIG
    assert asdict(full_t) == asdict(full_j.replace(attn_impl="flash"))
    assert (full_t.n_layers, full_t.d_model, full_t.nq, full_t.nkv,
            full_t.hd, full_t.d_ff, full_t.vocab) == \
        (22, 2048, 32, 4, 64, 5632, 32000)
    assert asdict(t_tiny.SMOKE) == asdict(j_tiny.SMOKE)
    assert t_tiny.SMOKE.attn_impl == "reference"
    assert registry.get_config("tinyllama-1.1b") is t_tiny.CONFIG
    assert registry.get_config("tinyllama-1.1b", smoke=True) is t_tiny.SMOKE


# -------------------------------------------------------------------- rope
@pytest.mark.parametrize("hd,theta", [(16, 1e4), (64, 1e4), (128, 5e5)])
def test_rope_freqs_match(hd, theta):
    np.testing.assert_array_equal(t_layers.rope_freqs(hd, theta).numpy(),
                                  np.asarray(j_layers.rope_freqs(hd, theta)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [16, 64])
def test_apply_rope_matches_jax(dtype, hd):
    """Rows start at 0, 2,000 and 4,000: angles up to 4096 radians."""
    rng = np.random.default_rng(hd)
    B, S, H = 3, 96, 4
    x = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    pos = np.stack([np.arange(S) + start for start in (0, 2000, 4000)])
    xj = jnp.asarray(x, dtype)
    ours = t_layers.apply_rope(torch.from_numpy(x).to(getattr(torch, dtype)),
                               torch.from_numpy(pos), 1e4)
    theirs = np.asarray(j_layers.apply_rope(xj, jnp.asarray(pos), 1e4),
                        np.float32)
    assert ours.dtype == getattr(torch, dtype) and ours.shape == x.shape
    err = np.abs(_np(ours) - theirs)
    if dtype == "float32":
        # the angle pos * freq is an fp32 product; two roundings of it may
        # land one spacing apart (2.4e-4 rad below 4096), which moves the
        # rotated pair by that much times |x|: the bound where angles are
        # large, ROPE_TOL where they stay under 96 (spacing 7.6e-6)
        far = np.spacing(np.float32(pos.max())) * 2 * np.abs(x).max()
        assert err.max() <= far, (err.max(), far)
        assert err[0].max() <= ROPE_TOL
    else:
        assert err.max() <= 2.0 ** -7 * np.abs(theirs).max()


@pytest.mark.parametrize("gated,act", [(True, "silu"), (False, "gelu")])
def test_lm_mlp_matches_jax(gated, act):
    jcfg, tcfg = (c.replace(gated_mlp=gated, mlp_activation=act,
                            mlp_bias=not gated) for c in _configs())
    jp = j_layers.init_mlp(jax.random.PRNGKey(3), jcfg)
    if not gated:       # nonzero biases, so that adding them is checked
        jp = dict(jp, bi=jp["bi"] + 0.1, bo=jp["bo"] - 0.2)
    tp = _torch(jp)
    x = _x(3, 2, 5, jcfg.d_model)
    ours = t_layers.apply_mlp(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(_np(ours), np.asarray(j_layers.apply_mlp(
        jp, jnp.asarray(x), jcfg)), atol=TOL)


# --------------------------------------------------------------- attention
@pytest.mark.parametrize("S,s_cache", [(12, 12), (12, 20), (12, 5)])
def test_attn_prefill_matches_jax(S, s_cache):
    """The cache holds the prompt (s_cache = S), the prompt then zeros
    (s_cache > S), or the last s_cache positions rolled to slot p % size."""
    jcfg, tcfg = _configs()
    jp, tp = _layer(S + s_cache, jcfg)
    B = 2
    x, pos = _x(s_cache, B, S, jcfg.d_model), _pos(B, S)
    jy, jc = j_attn.attn_prefill(
        jp, jnp.asarray(x), jcfg, jnp.asarray(pos),
        j_attn.init_kv_cache(jcfg, B, s_cache))
    y, c = t_attn.attn_prefill(
        tp, torch.from_numpy(x), tcfg, torch.from_numpy(pos),
        t_attn.init_kv_cache(tcfg, B, s_cache))
    np.testing.assert_allclose(_np(y), np.asarray(jy), atol=TOL)
    for name in ("k", "v"):
        assert c[name].shape == (B, s_cache, jcfg.nkv, jcfg.hd)
        np.testing.assert_allclose(_np(c[name]), np.asarray(jc[name]),
                                   atol=TOL)


def _prefilled(jcfg, tcfg, jp, tp, B, S, s_cache, seed):
    x, pos = _x(seed, B, S, jcfg.d_model), _pos(B, S)
    _, jc = j_attn.attn_prefill(jp, jnp.asarray(x), jcfg, jnp.asarray(pos),
                                j_attn.init_kv_cache(jcfg, B, s_cache))
    _, c = t_attn.attn_prefill(tp, torch.from_numpy(x), tcfg,
                               torch.from_numpy(pos),
                               t_attn.init_kv_cache(tcfg, B, s_cache))
    return jc, c


def test_attn_decode_matches_jax():
    """Scalar indices, through the last slot and past a full cache (the
    token then overwrites slot size - 1, as the reference does)."""
    jcfg, tcfg = _configs()
    jp, tp = _layer(7, jcfg)
    B, S, size = 2, 6, 9
    jc, c = _prefilled(jcfg, tcfg, jp, tp, B, S, size, seed=7)
    before = convert.tree_map(torch.clone, c)
    for i in range(S, size + 2):
        x = _x(i, B, 1, jcfg.d_model)
        pos = _pos(B, 1, i)
        jy, jc = j_attn.attn_decode(jp, jnp.asarray(x), jcfg,
                                    jnp.asarray(pos), jc, jnp.asarray(i))
        old = c
        y, c = t_attn.attn_decode(tp, torch.from_numpy(x), tcfg,
                                  torch.from_numpy(pos), c, i)
        np.testing.assert_allclose(_np(y), np.asarray(jy), atol=TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(c[name]), np.asarray(jc[name]),
                                       atol=TOL)
        if i == S:      # the input cache is not written
            for name in ("k", "v"):
                assert torch.equal(old[name], before[name])
                assert not torch.equal(c[name], old[name])


def test_attn_decode_per_row_matches_vmapped_jax():
    """Each row at its own index, as the reference's engine vmaps its
    single-sequence decode: rows before, at and past the last slot."""
    jcfg, tcfg = _configs()
    jp, tp = _layer(11, jcfg)
    B, S, size = 4, 8, 10
    jc, c = _prefilled(jcfg, tcfg, jp, tp, B, S, size, seed=11)
    idx = np.array([3, 8, 9, 12])
    x = _x(12, B, 1, jcfg.d_model)

    def one(xr, cache_row, i):
        cache = jax.tree.map(lambda a: a[None], cache_row)
        y, cache = j_attn.attn_decode(jp, xr[None], jcfg,
                                      jnp.full((1, 1), i), cache, i)
        return y[0], jax.tree.map(lambda a: a[0], cache)
    jy, jc = jax.vmap(one)(jnp.asarray(x), jc, jnp.asarray(idx))
    ti = torch.from_numpy(idx)
    y, c = t_attn.attn_decode(tp, torch.from_numpy(x), tcfg, ti[:, None], c,
                              ti)
    np.testing.assert_allclose(_np(y), np.asarray(jy), atol=TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(c[name]), np.asarray(jc[name]),
                                   atol=TOL)


def test_attention_core_masks_each_row_to_its_length():
    """``kv_len_valid`` of shape (B,) against (B, H, 1, Skv) logits: each
    row's output equals that row alone with its own scalar length."""
    cfg = t_tiny.SMOKE
    g = torch.Generator().manual_seed(0)
    B, Skv, H, D = 3, 7, 4, 16
    q = torch.randn(B, 1, H, D, generator=g)
    k, v = (torch.randn(B, Skv, 2, D, generator=g) for _ in range(2))
    q_pos = torch.tensor([[6], [6], [6]])
    kv_pos = torch.arange(Skv).expand(B, Skv)
    lens = torch.tensor([2, 5, 7])
    out = t_attn.attention_core(q, k, v, q_pos, kv_pos, cfg, causal=True,
                                kv_len_valid=lens)
    for b in range(B):
        row = t_attn.attention_core(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                    q_pos[b:b + 1], kv_pos[b:b + 1], cfg,
                                    causal=True, kv_len_valid=int(lens[b]))
        torch.testing.assert_close(out[b:b + 1], row)
        # slots past the row's length do not reach it
        k2, v2 = k.clone(), v.clone()
        k2[b, lens[b]:], v2[b, lens[b]:] = 9.0, -9.0
        again = t_attn.attention_core(q, k2, v2, q_pos, kv_pos, cfg,
                                      causal=True, kv_len_valid=lens)
        torch.testing.assert_close(again[b], out[b])


# ------------------------------------------------------------------- model
@pytest.mark.parametrize("attn_impl", ["reference", "flash"])
def test_forward_matches_jax(model, attn_impl):
    jcfg, tcfg = _configs(attn_impl)
    jp, tp = model
    toks, pos = _tokens(jcfg, 2, 24, seed=2), _pos(2, 24)
    with torch.inference_mode():
        logits, aux = tt.forward(tp, tcfg, torch.from_numpy(toks),
                                 torch.from_numpy(pos))
    jl, _ = jt.forward(jp, jcfg, jnp.asarray(toks), jnp.asarray(pos))
    assert logits.shape == (2, 24, jcfg.vocab) and float(aux) == 0.0
    np.testing.assert_allclose(_np(logits), np.asarray(jl), atol=TOL)


def test_loss_and_grads_match_jax(model):
    """The training forward's loss and every leaf's gradient (autograd
    through the plain attention, RoPE and the norms' plain versions)."""
    jcfg, tcfg = _configs()
    jp, tp = model
    toks = _tokens(jcfg, 2, 17, seed=4)
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    (jl, _), jg = jax.value_and_grad(jt.loss_fn, has_aux=True)(
        jp, jcfg, jax.tree.map(jnp.asarray, batch))
    (loss, _), grads = value_and_grad(
        tt.loss_fn, tp, tcfg, {k: torch.from_numpy(v) for k, v in
                               batch.items()}, has_aux=True)
    np.testing.assert_allclose(float(loss), float(jl), atol=TOL)
    ours = jax.tree.leaves(convert.tree_map(_np, grads))
    theirs = jax.tree.leaves(jg)
    assert len(ours) == len(theirs) == 11
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a, np.asarray(b), atol=TOL)


@pytest.mark.parametrize("attn_impl", ["reference", "flash"])
def test_prefill_and_decode_match_jax(model, attn_impl):
    """A 21-token prefill into a cache of 21 + 8, then 8 greedy decode
    steps, logits and caches against JAX at every step."""
    jcfg, tcfg = _configs(attn_impl)
    jp, tp = model
    B, P = 3, 21
    toks = _tokens(jcfg, B, P, seed=5)
    with torch.inference_mode():
        lg, cache = tt.prefill(tp, tcfg, torch.from_numpy(toks),
                               torch.from_numpy(_pos(B, P)),
                               s_cache=P + DECODE_STEPS)
    jlg, jcache = jt.prefill(jp, jcfg, jnp.asarray(toks),
                             jnp.asarray(_pos(B, P)), s_cache=P + DECODE_STEPS)
    np.testing.assert_allclose(_np(lg), np.asarray(jlg), atol=TOL)
    tok = lg.argmax(-1, keepdim=True)
    for i in range(P, P + DECODE_STEPS):
        with torch.inference_mode():
            lg, cache = tt.decode_step(tp, tcfg, tok,
                                       torch.from_numpy(_pos(B, 1, i)),
                                       cache, i)
        jlg, jcache = jt.decode_step(jp, jcfg, jnp.asarray(tok.numpy()),
                                     jnp.asarray(_pos(B, 1, i)), jcache,
                                     jnp.asarray(i))
        np.testing.assert_allclose(_np(lg), np.asarray(jlg), atol=TOL)
        tok = lg.argmax(-1, keepdim=True)
    ours = jax.tree.leaves(convert.tree_map(_np, cache))
    theirs = jax.tree.leaves(jcache)
    assert len(ours) == len(theirs) == 2
    for a, b in zip(ours, theirs):
        assert a.shape == b.shape == (jcfg.n_layers, B, P + DECODE_STEPS,
                                      jcfg.nkv, jcfg.hd)
        np.testing.assert_allclose(a, np.asarray(b), atol=TOL)


def test_prefill_decode_consistency(model):
    """On the port alone: prefill of a prefix, then token-by-token decode,
    gives the full forward's logits."""
    _, tp = model
    cfg = t_tiny.SMOKE
    B, S, P = 2, 20, 14
    toks = torch.from_numpy(_tokens(cfg, B, S, seed=6))
    with torch.inference_mode():
        full, _ = tt.forward(tp, cfg, toks, torch.from_numpy(_pos(B, S)))
        lg, cache = tt.prefill(tp, cfg, toks[:, :P],
                               torch.from_numpy(_pos(B, P)), s_cache=S)
        errs = [float((lg - full[:, P - 1]).abs().max())]
        for i in range(P, S):
            lg, cache = tt.decode_step(tp, cfg, toks[:, i:i + 1],
                                       torch.from_numpy(_pos(B, 1, i)),
                                       cache, i)
            errs.append(float((lg - full[:, i]).abs().max()))
    assert max(errs) < TOL, errs


def test_decode_does_not_write_its_input_cache(model):
    _, tp = model
    cfg = t_tiny.SMOKE
    cache = tt.init_cache(cfg, 2, 8, device="cpu")
    before = convert.tree_map(torch.clone, cache)
    _, new = tt.decode_step(tp, cfg, torch.ones(2, 1, dtype=torch.long),
                            torch.zeros(2, 1, dtype=torch.long), cache, 0)
    for name in ("k", "v"):
        assert torch.equal(cache["segments"][0]["b0"][name],
                           before["segments"][0]["b0"][name])
        assert not torch.equal(new["segments"][0]["b0"][name],
                               cache["segments"][0]["b0"][name])


def test_prefill_and_serve_steps_match_jax(model):
    jcfg, tcfg = _configs()
    jp, tp = model
    B, S = 2, 20
    toks = _tokens(jcfg, B, S, seed=8)
    pos = _pos(B, S)
    jlg, jcache = j_make_prefill_step(jcfg, s_cache=S + 4)(
        jp, jnp.asarray(toks), jnp.asarray(pos))
    with torch.inference_mode():
        lg, cache = make_prefill_step(tcfg, s_cache=S + 4)(
            tp, torch.from_numpy(toks), torch.from_numpy(pos))
    np.testing.assert_allclose(_np(lg), np.asarray(jlg), atol=TOL)
    jtok = jnp.argmax(jlg, -1).astype(jnp.int32)[:, None]
    tok = torch.from_numpy(np.array(jtok))
    jserve, serve = j_make_serve_step(jcfg), make_serve_step(tcfg)
    for i in range(S, S + 4):
        jtok, jlg, jcache = jserve(jp, jtok, jnp.full((B, 1), i), jcache,
                                   jnp.asarray(i))
        with torch.inference_mode():
            tok, lg, cache = serve(tp, tok, torch.full((B, 1), i), cache, i)
        np.testing.assert_allclose(_np(lg), np.asarray(jlg), atol=TOL)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))


# ------------------------------------------------------------------ engine
def _record(eng, log):
    """Keep the logits of every decode call the engine makes."""
    inner = eng._decode

    def decode(*args):
        logits, cache = inner(*args)
        log.append(np.asarray(logits, np.float32))
        return logits, cache
    eng._decode = decode


def test_engine_tokens_match_jax(model):
    """Batch 3, s_max 32, five requests of ragged prompts (1-7 tokens) and
    budgets, so slots run at different indices in one decode call."""
    jp, tp = model
    jeng = JServeEngine(j_tiny.SMOKE, jp, batch=3, s_max=32)
    teng = ServeEngine(t_tiny.SMOKE, tp, batch=3, s_max=32, device="cpu")
    jlog, tlog = [], []
    _record(jeng, jlog)
    _record(teng, tlog)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, j_tiny.SMOKE.vocab, k)]
               for k in rng.integers(1, 8, 5)]
    for eng, make in ((jeng, JRequest), (teng, Request)):
        for rid, prompt in enumerate(prompts):
            eng.add_request(make(rid=rid, prompt=prompt, max_new=4 + rid))
    with torch.inference_mode():
        tdone = teng.run()
    jdone = jeng.run()
    assert [r.rid for r in tdone] == [r.rid for r in jdone] == list(range(5))
    assert len(tlog) == len(jlog) > 20
    for j_logits, t_logits in zip(jlog, tlog):
        np.testing.assert_allclose(t_logits, j_logits, atol=TOL)
        top2 = np.sort(j_logits, axis=-1)[:, -2:]
        assert not (top2[:, 1] - top2[:, 0] < TOL).any(), \
            "a near-tie: pick another seed"
    assert [r.out for r in tdone] == [r.out for r in jdone]
    assert all(len(r.out) == 4 + r.rid for r in tdone)


def test_engine_matches_direct_greedy(model):
    """The engine against full-forward greedy decoding on the port, with a
    second request sharing the batch."""
    _, tp = model
    cfg = t_tiny.SMOKE
    prompt, n_new = [5, 17, 42, 9], 6
    toks = list(prompt)
    with torch.inference_mode():
        for _ in range(n_new):
            logits, _ = tt.forward(tp, cfg, torch.tensor([toks]),
                                   torch.arange(len(toks))[None])
            toks.append(int(logits[0, -1].argmax()))
        eng = ServeEngine(cfg, tp, batch=2, s_max=32, device="cpu")
        eng.add_request(Request(rid=0, prompt=list(prompt), max_new=n_new))
        eng.add_request(Request(rid=1, prompt=[3, 1, 4], max_new=3))
        done = eng.run()
    assert [r.rid for r in done] == [0, 1]
    assert done[0].out == toks[len(prompt):]


def test_launcher_serves_tinyllama_by_default(capsys):
    argv = ["--smoke", "--device", "cpu", "--requests", "2", "--max-new",
            "4"]
    out = t_launch.main(["--arch", "tinyllama-1.1b"] + argv)
    assert out["arch"] == "tinyllama-1.1b" and out["device"] == "cpu"
    assert out["done"] == out["requests"] == 2 and out["tokens"] == 8
    assert "2/2 requests done" in capsys.readouterr().out
    assert t_launch.main(argv)["outputs"] == out["outputs"]


# ---------------------------------------------------------------- convert
def test_converted_tree_is_the_reference_layout():
    """JAX's full TinyLlama tree (shapes only) holds the named leaves; at 2
    layers of width 256 with TinyLlama's heads, head dim, d_ff and vocab,
    the converted tree and the port's own init have JAX's leaves, shapes
    and order, and the round trip is exact."""
    full = jax.eval_shape(lambda k: jt.init(k, j_tiny.CONFIG),
                          jax.random.PRNGKey(0))
    b0 = full["segments"][0]["b0"]
    L, d, f = 22, 2048, 5632
    assert b0["attn"]["wq"].shape == (L, d, 32, 64)
    assert b0["attn"]["wk"].shape == b0["attn"]["wv"].shape == (L, d, 4, 64)
    assert b0["attn"]["wo"].shape == (L, 32, 64, d)
    assert b0["ffn"]["wi"].shape == (L, d, 2, f)
    assert b0["ffn"]["wo"].shape == (L, f, d)
    assert full["embed"]["table"].shape == (32000, d)
    assert full["head"].shape == (d, 32000)
    cut = dict(n_layers=2, d_model=256, head_dim=64)
    jp = jt.init(jax.random.PRNGKey(1), j_tiny.CONFIG.replace(**cut))
    tp = convert.from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    own = tt.init(torch.Generator().manual_seed(0),
                  t_tiny.CONFIG.replace(**cut))
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for tree in (tp, own):
        flat = jax.tree_util.tree_flatten_with_path(
            convert.tree_map(lambda t: np.zeros(0), tree))[0]
        assert [p for p, _ in flat] == [p for p, _ in jflat]
    for (path, a), t, o in zip(jflat, jax.tree.leaves(convert.tree_map(
            _np, tp)), jax.tree.leaves(convert.tree_map(_np, own))):
        assert a.shape == t.shape == o.shape, path
        np.testing.assert_array_equal(t, np.asarray(a))
    back = convert.to_jax(tp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
