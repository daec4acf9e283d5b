"""The port's Gemma-3 (local/global layers, the sliding-window ring-buffer
KV cache, QK-norm, sandwich norms, tied embeddings) against the JAX
package's, on the CPU.

* The config, and the trees of ``init_attention``, ``init_block`` and
  ``init``: JAX's leaves, shapes and order, with ``q_norm``, ``k_norm``,
  ``post_ln1``, ``post_ln2`` and no ``head``; conversion both ways.
* ``_project_qkv`` with QK-norm at the local and the global RoPE theta.
* ``attn_prefill`` and ``attn_decode`` with a window (``SMOKE``'s 32) on one
  layer's weights: prompts shorter than, as long as and longer than the
  window, then decode across the ring's wrap twice, once with a cache
  shorter than the window; per-row indices against JAX's ``vmap`` of its
  one-row decode.
* Gemma-3 ``SMOKE`` (4 layers: 2 x (local, global), d 64, 4/2 heads of 16,
  window 32, fp32): ``forward`` under ``attn_impl`` "reference" and "flash"
  (JAX: the Pallas kernel in interpret mode on the global layers, its
  chunked scan on the local ones; the port: the flash wrapper's plain
  version on both, with the window on the local ones), which window each
  layer hands the flash wrapper, ``loss_fn`` and its gradients, a prefill
  past the window and decode steps across the wrap, ``make_prefill_step``
  and ``make_serve_step``, ``ServeEngine``'s tokens against JAX's engine
  (slots past the window), and the serve launcher.
* A 5-layer plan, 2 x (local, global) then a remainder segment of 1 local
  layer, through ``forward`` and prefill + decode.
* One ``make_train_step`` step of ``SMOKE`` at ``attn_impl="flash"`` on 48
  tokens, past the window, against JAX's train step: the metrics and
  AdamW's m and v, then the updated parameters against JAX's AdamW update
  fed the port's own clipped gradient (1e-4 of each leaf's scale), on the
  plain path and on the card's route (the flash and
  RMSNorm autograd Functions with their launches' plain versions: the
  windowed backward's wiring).

The reference initialises the gemma norm scales to zero, so (1 + w) is 1
and a missing, swapped or misplaced norm would not show: every test first
writes nonzero scales into the JAX tree (``_bumped``), then converts it.

Tolerances: one attention layer 3e-5 in fp32, the model 1e-4 (the model
tests' bound). Greedy tokens are compared while every decode call's
logits agree within 1e-4 and no row's top-2 gap falls under it
(tests/test_torch_lm_serve.py's rule).
"""
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma3_27b as j_gemma
from repro.models import attention as j_attn
from repro.models import blocks as j_blocks
from repro.models import transformer as jt
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.train import make_prefill_step as j_make_prefill_step
from repro.train import make_serve_step as j_make_serve_step
from repro.train.optimizer import OptimizerConfig as JOptimizerConfig
from repro.train.optimizer import adamw_update as j_adamw_update
from repro.train.optimizer import init_opt_state as j_init_opt_state
from repro.train.step import make_train_step as j_make_train_step
from repro_torch import convert
from repro_torch.configs import gemma3_27b as t_gemma
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rmsnorm import ops as norm_ops
from repro_torch.launch import serve as t_launch
from repro_torch.models import attention as t_attn
from repro_torch.models import blocks as t_blocks
from repro_torch.models import layers as t_layers
from repro_torch.models import registry
from repro_torch.models import transformer as tt
from repro_torch.models.common import layer_plan
from repro_torch.serve import Request, ServeEngine
from repro_torch.train import (OptimizerConfig, init_opt_state,
                               make_prefill_step, make_serve_step,
                               make_train_step)
from repro_torch.train.step import value_and_grad

TOL = 1e-4
ATTN_TOL = 3e-5
NORM_STD = 0.3          # the norm scales written in place of the init's 0
WINDOW = j_gemma.SMOKE.sliding_window
LOCAL = dict(window=WINDOW, theta=j_gemma.SMOKE.rope_theta_local)
GLOBAL = dict(window=0, theta=j_gemma.SMOKE.rope_theta)


def _np(t):
    return t.detach().float().numpy()


def _torch(jtree):
    return convert.tree_map(lambda a: torch.from_numpy(np.array(a)), jtree)


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


def _pos(B, S, start=0):
    return np.broadcast_to(np.arange(start, start + S)[None], (B, S)).copy()


def _x(seed, B, S, d):
    return np.random.default_rng(seed).normal(size=(B, S, d)).astype(
        np.float32)


def _configs(attn_impl="reference", **kw):
    return (j_gemma.SMOKE.replace(attn_impl=attn_impl, **kw),
            t_gemma.SMOKE.replace(attn_impl=attn_impl, **kw))


def _is_norm(path) -> bool:
    keys = [getattr(k, "key", None) for k in path]
    return any(k in ("q_norm", "k_norm", "ln1", "ln2", "post_ln1",
                     "post_ln2", "final_norm") for k in keys)


def _bumped(jtree, seed):
    """The JAX tree with every norm scale drawn N(0, NORM_STD), each leaf
    its own draw."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, a: a + rng.normal(0, NORM_STD, a.shape).astype(a.dtype)
        if _is_norm(p) else a, jtree)


def _layer(seed, cfg):
    """One attention layer's weights (QK-norm scales nonzero) in JAX and
    converted."""
    jp = _bumped(j_attn.init_attention(jax.random.PRNGKey(seed), cfg), seed)
    return jp, _torch(jp)


def _model(cfg, seed=0):
    jp = _bumped(jt.init(jax.random.PRNGKey(seed), cfg), seed)
    return jp, convert.from_jax(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def model():
    return _model(j_gemma.SMOKE)


def _paths(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        convert.tree_map(lambda t: np.zeros(tuple(t.shape)), tree))[0]
    return [(jax.tree_util.keystr(p), a.shape) for p, a in flat]


# ------------------------------------------------------------------ config
def test_config_is_the_reference_but_flash():
    full_j, full_t = j_gemma.CONFIG, t_gemma.CONFIG
    assert asdict(full_t) == asdict(full_j.replace(attn_impl="flash"))
    assert (full_t.n_layers, full_t.d_model, full_t.nq, full_t.nkv,
            full_t.hd, full_t.d_ff, full_t.vocab, full_t.sliding_window) == \
        (62, 5376, 32, 16, 128, 21504, 262_144, 1024)
    assert asdict(t_gemma.SMOKE) == asdict(j_gemma.SMOKE)
    assert t_gemma.SMOKE.attn_impl == "reference"
    assert registry.get_config("gemma3-27b") is t_gemma.CONFIG
    assert registry.get_config("gemma3-27b", smoke=True) is t_gemma.SMOKE
    # 62 = 10 x (5 local, 1 global) + a remainder of 2 local layers
    plan = layer_plan(full_t)
    assert [(s.n_repeat, s.pattern) for s in plan] == [
        (10, ("local",) * 5 + ("global",)), (1, ("local", "local"))]


# -------------------------------------------------------------------- trees
@pytest.mark.parametrize("what", ["attention", "local", "global"])
def test_layer_tree_is_the_reference_layout(what):
    cfg = t_gemma.SMOKE
    gen = torch.Generator().manual_seed(0)
    if what == "attention":
        jp = j_attn.init_attention(jax.random.PRNGKey(0), j_gemma.SMOKE)
        tp = t_attn.init_attention(gen, cfg)
        assert {"q_norm", "k_norm"} <= set(tp)
    else:
        jp = j_blocks.init_block(jax.random.PRNGKey(0), what, j_gemma.SMOKE)
        tp = t_blocks.init_block(gen, what, cfg)
        assert {"post_ln1", "post_ln2"} <= set(tp)
        assert {"q_norm", "k_norm"} <= set(tp["attn"])
    assert _paths(tp) == _paths(jp)
    # the gemma scales start at zero on both sides: (1 + w) = 1
    for p, a in jax.tree_util.tree_flatten_with_path(jp)[0]:
        if _is_norm(p):
            assert not np.asarray(a).any()


def test_model_tree_is_the_reference_layout():
    """JAX's full Gemma-3 tree (shapes only): 62 layers as 10 x 6 + 2, no
    ``head`` (the table is tied); at 8 layers of width 128 the converted
    tree and the port's own init have JAX's leaves, shapes and order, and
    the round trip is exact."""
    full = jax.eval_shape(lambda k: jt.init(k, j_gemma.CONFIG),
                          jax.random.PRNGKey(0))
    assert "head" not in full and len(full["segments"]) == 2
    d, hd = 5376, 128
    b0 = full["segments"][0]["b0"]
    assert b0["attn"]["wq"].shape == (10, d, 32, hd)
    assert b0["attn"]["wk"].shape == (10, d, 16, hd)
    assert b0["attn"]["q_norm"]["scale"].shape == (10, hd)
    assert b0["post_ln2"]["scale"].shape == (10, d)
    assert full["segments"][1]["b1"]["ffn"]["wo"].shape == (1, 21504, d)
    assert full["embed"]["table"].shape == (262_144, d)
    cut = dict(n_layers=8, d_model=128, head_dim=32, d_ff=256,
               vocab_size=512)
    jp = _bumped(jt.init(jax.random.PRNGKey(1), j_gemma.CONFIG.replace(**cut)),
                 1)
    tp = convert.from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    own = tt.init(torch.Generator().manual_seed(0),
                  t_gemma.CONFIG.replace(**cut))
    assert "head" not in tp and "head" not in own
    assert _paths(tp) == _paths(own) == _paths(jp)
    for a, t in zip(jax.tree.leaves(jp), jax.tree.leaves(
            convert.tree_map(_np, tp))):
        np.testing.assert_array_equal(t, np.asarray(a))
    back = convert.to_jax(tp)
    assert "head" not in back
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------- attention
@pytest.mark.parametrize("opts", [LOCAL, GLOBAL], ids=["local", "global"])
def test_project_qkv_with_qk_norm_matches_jax(opts):
    jcfg, tcfg = _configs()
    jp, tp = _layer(3, jcfg)
    B, S = 2, 9
    x, pos = _x(3, B, S, jcfg.d_model), _pos(B, S, start=100)
    theirs = j_attn._project_qkv(jp, jnp.asarray(x), jcfg, jnp.asarray(pos),
                                 opts["theta"])
    ours = t_attn._project_qkv(tp, torch.from_numpy(x), tcfg,
                               torch.from_numpy(pos), opts["theta"])
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=ATTN_TOL)
    # the norms are nonzero and distinct: swapping them moves q and k
    swapped = dict(tp, q_norm=tp["k_norm"], k_norm=tp["q_norm"])
    moved = t_attn._project_qkv(swapped, torch.from_numpy(x), tcfg,
                                torch.from_numpy(pos), opts["theta"])
    assert (moved[0] - ours[0]).abs().max() > 1e-2


def _prefill(jcfg, tcfg, jp, tp, B, S, s_cache, opts, seed):
    x, pos = _x(seed, B, S, jcfg.d_model), _pos(B, S)
    jy, jc = j_attn.attn_prefill(
        jp, jnp.asarray(x), jcfg, jnp.asarray(pos),
        j_attn.init_kv_cache(jcfg, B, s_cache, opts["window"]), **opts)
    y, c = t_attn.attn_prefill(
        tp, torch.from_numpy(x), tcfg, torch.from_numpy(pos),
        t_attn.init_kv_cache(tcfg, B, s_cache, opts["window"]), **opts)
    return (jy, jc), (y, c)


@pytest.mark.parametrize("S,s_cache", [(20, 28), (32, 40), (45, 53),
                                       (12, 24)])
@pytest.mark.parametrize("opts", [LOCAL, GLOBAL], ids=["local", "global"])
def test_attn_prefill_matches_jax(S, s_cache, opts):
    """Prompts shorter than, as long as and longer than the window; the
    local cache is min(window, s_cache) slots (24 < 32 in the last case),
    filled from slot 0 or rolled so position p sits at p % size."""
    jcfg, tcfg = _configs()
    jp, tp = _layer(S, jcfg)
    (jy, jc), (y, c) = _prefill(jcfg, tcfg, jp, tp, 2, S, s_cache, opts,
                                seed=S)
    np.testing.assert_allclose(_np(y), np.asarray(jy), atol=ATTN_TOL)
    size = min(opts["window"], s_cache) if opts["window"] else s_cache
    for name in ("k", "v"):
        assert c[name].shape == jc[name].shape == (2, size, jcfg.nkv,
                                                   jcfg.hd)
        np.testing.assert_allclose(_np(c[name]), np.asarray(jc[name]),
                                   atol=ATTN_TOL)


@pytest.mark.parametrize("S,s_cache", [(20, 100), (45, 120), (10, 24)])
def test_attn_decode_ring_matches_jax(S, s_cache):
    """From a prompt shorter and longer than the window, and into a cache
    shorter than it (a ring of 24), decode 2 x size + 5 tokens at scalar
    indices: the ring wraps twice; outputs and caches at every step."""
    jcfg, tcfg = _configs()
    jp, tp = _layer(S + 1, jcfg)
    B = 2
    (_, jc), (_, c) = _prefill(jcfg, tcfg, jp, tp, B, S, s_cache, LOCAL,
                               seed=S + 1)
    size = c["k"].shape[1]
    assert size == min(WINDOW, s_cache)
    steps = 2 * size + 5
    assert (S + steps) // size - S // size >= 2
    for i in range(S, S + steps):
        x, pos = _x(i, B, 1, jcfg.d_model), _pos(B, 1, i)
        jy, jc = j_attn.attn_decode(jp, jnp.asarray(x), jcfg,
                                    jnp.asarray(pos), jc, jnp.asarray(i),
                                    **LOCAL)
        old = c
        y, c = t_attn.attn_decode(tp, torch.from_numpy(x), tcfg,
                                  torch.from_numpy(pos), c, i, **LOCAL)
        np.testing.assert_allclose(_np(y), np.asarray(jy), atol=ATTN_TOL)
        for name in ("k", "v"):
            assert c[name].shape == old[name].shape
            np.testing.assert_allclose(_np(c[name]), np.asarray(jc[name]),
                                       atol=ATTN_TOL)


def test_attn_decode_ring_per_row_matches_vmapped_jax():
    """Each row at its own index, as the reference's engine vmaps its
    one-row decode: before the ring fills, at its last slot, just past
    the first wrap and past the second."""
    jcfg, tcfg = _configs()
    jp, tp = _layer(11, jcfg)
    B = 4
    (_, jc), (_, c) = _prefill(jcfg, tcfg, jp, tp, B, 40, 120, LOCAL,
                               seed=11)
    idx = np.array([3, 31, 33, 70])
    x = _x(12, B, 1, jcfg.d_model)

    def one(xr, cache_row, i):
        cache = jax.tree.map(lambda a: a[None], cache_row)
        y, cache = j_attn.attn_decode(jp, xr[None], jcfg,
                                      jnp.full((1, 1), i), cache, i, **LOCAL)
        return y[0], jax.tree.map(lambda a: a[0], cache)
    jy, jc = jax.vmap(one)(jnp.asarray(x), jc, jnp.asarray(idx))
    ti = torch.from_numpy(idx)
    y, c = t_attn.attn_decode(tp, torch.from_numpy(x), tcfg, ti[:, None], c,
                              ti, **LOCAL)
    np.testing.assert_allclose(_np(y), np.asarray(jy), atol=ATTN_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(c[name]), np.asarray(jc[name]),
                                   atol=ATTN_TOL)


# ------------------------------------------------------------------- model
@pytest.mark.parametrize("attn_impl", ["reference", "flash"])
def test_forward_matches_jax(model, attn_impl):
    """48 tokens: the local layers' window (32) masks the early keys."""
    jcfg, tcfg = _configs(attn_impl)
    jp, tp = model
    toks, pos = _tokens(jcfg, 2, 48, seed=2), _pos(2, 48)
    with torch.inference_mode():
        logits, aux = tt.forward(tp, tcfg, torch.from_numpy(toks),
                                 torch.from_numpy(pos))
    jl, _ = jt.forward(jp, jcfg, jnp.asarray(toks), jnp.asarray(pos))
    assert logits.shape == (2, 48, jcfg.vocab) and float(aux) == 0.0
    np.testing.assert_allclose(_np(logits), np.asarray(jl), atol=TOL)


def test_flash_takes_each_layers_window(model, monkeypatch):
    """Under ``attn_impl="flash"`` a prefill hands the flash wrapper the
    window on the local layers and none on the global ones, in the plan's
    order; a decode step hands it nothing."""
    _, tcfg = _configs("flash")
    _, tp = model
    seen = []
    real = t_attn.flash_attention

    def record(q, k, v, **kw):
        seen.append(kw["window"])
        return real(q, k, v, **kw)
    monkeypatch.setattr(t_attn, "flash_attention", record)
    toks, pos = torch.from_numpy(_tokens(tcfg, 1, 40)), torch.from_numpy(
        _pos(1, 40))
    with torch.inference_mode():
        lg, cache = tt.prefill(tp, tcfg, toks, pos, s_cache=44)
        assert seen == [WINDOW, 0, WINDOW, 0]
        tt.decode_step(tp, tcfg, lg.argmax(-1, keepdim=True),
                       torch.full((1, 1), 40), cache, 40)
    assert seen == [WINDOW, 0, WINDOW, 0]


def test_loss_and_grads_match_jax(model):
    """The training forward's loss and every leaf's gradient (autograd
    through the plain attention, window included, RoPE and the norms'
    plain versions), at 40 tokens, past the window."""
    jcfg, tcfg = _configs()
    jp, tp = model
    toks = _tokens(jcfg, 2, 41, seed=4)
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    (jl, _), jg = jax.value_and_grad(jt.loss_fn, has_aux=True)(
        jp, jcfg, jax.tree.map(jnp.asarray, batch))
    (loss, _), grads = value_and_grad(
        tt.loss_fn, tp, tcfg, {k: torch.from_numpy(v) for k, v in
                               batch.items()}, has_aux=True)
    np.testing.assert_allclose(float(loss), float(jl), atol=TOL)
    ours = jax.tree_util.tree_flatten_with_path(
        convert.tree_map(_np, grads))[0]
    theirs = jax.tree_util.tree_flatten_with_path(jg)[0]
    # the table (tied), the final norm, and 12 leaves a block: 4 + 2
    # attention, 2 MLP, 4 norms
    assert len(ours) == len(theirs) == 2 + 2 * 12
    for (pa, a), (pb, b) in zip(ours, theirs):
        assert pa == pb
        np.testing.assert_allclose(a, np.asarray(b), atol=TOL,
                                   err_msg=jax.tree_util.keystr(pa))


def _prefill_decode(jcfg, tcfg, jp, tp, B, P, steps, seed):
    """A P-token prefill into a cache of P + steps, then ``steps`` greedy
    decode steps, logits against JAX at every step; returns both caches."""
    toks = _tokens(jcfg, B, P, seed=seed)
    with torch.inference_mode():
        lg, cache = tt.prefill(tp, tcfg, torch.from_numpy(toks),
                               torch.from_numpy(_pos(B, P)),
                               s_cache=P + steps)
    jlg, jcache = jt.prefill(jp, jcfg, jnp.asarray(toks),
                             jnp.asarray(_pos(B, P)), s_cache=P + steps)
    np.testing.assert_allclose(_np(lg), np.asarray(jlg), atol=TOL)
    tok = lg.argmax(-1, keepdim=True)
    for i in range(P, P + steps):
        with torch.inference_mode():
            lg, cache = tt.decode_step(tp, tcfg, tok,
                                       torch.from_numpy(_pos(B, 1, i)),
                                       cache, i)
        jlg, jcache = jt.decode_step(jp, jcfg, jnp.asarray(tok.numpy()),
                                     jnp.asarray(_pos(B, 1, i)), jcache,
                                     jnp.asarray(i))
        np.testing.assert_allclose(_np(lg), np.asarray(jlg), atol=TOL)
        tok = lg.argmax(-1, keepdim=True)
    ours = jax.tree_util.tree_flatten_with_path(convert.tree_map(_np, cache))[0]
    theirs = jax.tree_util.tree_flatten_with_path(jcache)[0]
    assert [p for p, _ in ours] == [p for p, _ in theirs]
    for (_, a), (_, b) in zip(ours, theirs):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, np.asarray(b), atol=TOL)
    return cache


@pytest.mark.parametrize("attn_impl", ["reference", "flash"])
def test_prefill_and_decode_match_jax(model, attn_impl):
    """A 40-token prefill (past the window) into a cache of 40 + 30, then
    30 greedy decode steps: the local layers' rings of 32 wrap at index
    64; the global layers' caches hold all 70 positions."""
    jcfg, tcfg = _configs(attn_impl)
    jp, tp = model
    B, P, steps = 3, 40, 30
    cache = _prefill_decode(jcfg, tcfg, jp, tp, B, P, steps, seed=5)
    seg = cache["segments"][0]
    assert seg["b0"]["k"].shape == (2, B, WINDOW, jcfg.nkv, jcfg.hd)
    assert seg["b1"]["k"].shape == (2, B, P + steps, jcfg.nkv, jcfg.hd)


def test_remainder_segment_matches_jax():
    """5 layers at a period of 2: 2 x (local, global), then a segment of
    one local layer; forward, then a prefill and 36 decode steps, each
    local ring wrapping."""
    jcfg, tcfg = _configs(n_layers=5)
    assert [(s.n_repeat, s.pattern) for s in layer_plan(tcfg)] == [
        (2, ("local", "global")), (1, ("local",))]
    jp, tp = _model(jcfg, seed=3)
    toks, pos = _tokens(jcfg, 2, 36, seed=6), _pos(2, 36)
    with torch.inference_mode():
        logits, _ = tt.forward(tp, tcfg, torch.from_numpy(toks),
                               torch.from_numpy(pos))
    jl, _ = jt.forward(jp, jcfg, jnp.asarray(toks), jnp.asarray(pos))
    np.testing.assert_allclose(_np(logits), np.asarray(jl), atol=TOL)
    cache = _prefill_decode(jcfg, tcfg, jp, tp, 2, 36, 36, seed=7)
    assert cache["segments"][1]["b0"]["k"].shape == (1, 2, WINDOW, jcfg.nkv,
                                                     jcfg.hd)


def test_prefill_and_serve_steps_match_jax(model):
    jcfg, tcfg = _configs()
    jp, tp = model
    B, S = 2, 36
    toks, pos = _tokens(jcfg, B, S, seed=8), _pos(B, S)
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
    """Batch 3, s_max 48 (the local rings hold 32), five requests of ragged
    prompts (1-7 tokens) and budgets up to 38 tokens, so slots run at
    different indices in one decode call and the longest ones wrap their
    rings."""
    jp, tp = model
    jeng = JServeEngine(j_gemma.SMOKE, jp, batch=3, s_max=48)
    teng = ServeEngine(t_gemma.SMOKE, tp, batch=3, s_max=48, device="cpu")
    jlog, tlog = [], []
    _record(jeng, jlog)
    _record(teng, tlog)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, j_gemma.SMOKE.vocab, k)]
               for k in rng.integers(1, 8, 5)]
    budgets = [4, 38, 12, 36, 20]
    for eng, make in ((jeng, JRequest), (teng, Request)):
        for rid, prompt in enumerate(prompts):
            eng.add_request(make(rid=rid, prompt=prompt,
                                 max_new=budgets[rid]))
    with torch.inference_mode():
        tdone = teng.run()
    jdone = jeng.run()
    assert [r.rid for r in tdone] == [r.rid for r in jdone] == list(range(5))
    assert max(len(p) + b for p, b in zip(prompts, budgets)) > WINDOW
    assert len(tlog) == len(jlog) > 40
    for j_logits, t_logits in zip(jlog, tlog):
        np.testing.assert_allclose(t_logits, j_logits, atol=TOL)
        top2 = np.sort(j_logits, axis=-1)[:, -2:]
        assert not (top2[:, 1] - top2[:, 0] < TOL).any(), \
            "a near-tie: pick another seed"
    assert [r.out for r in tdone] == [r.out for r in jdone]
    assert all(len(r.out) == budgets[r.rid] for r in tdone)


def test_launcher_serves_gemma3(capsys):
    out = t_launch.main(["--arch", "gemma3-27b", "--smoke", "--device",
                         "cpu", "--requests", "2", "--max-new", "4"])
    assert out["arch"] == "gemma3-27b" and out["device"] == "cpu"
    assert out["done"] == out["requests"] == 2 and out["tokens"] == 8
    assert "2/2 requests done" in capsys.readouterr().out


# ------------------------------------------------------------------ training
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=10)


def _card_route(monkeypatch):
    """The model's flash and RMSNorm calls take the card's route (their
    autograd Functions, with counters), each kernel launch replaced by its
    plain version on the CPU tensors."""
    def flash(q, k, v, *, causal=True, window=0, softcap=0.0, scale=None,
              device=None):
        fa_ops._check(q, k, v)
        return fa_ops._flash_cuda(q, k, v, causal=causal, window=window,
                                  softcap=softcap,
                                  scale=scale or q.shape[3] ** -0.5)

    def launch(q, k, v, variant, *, lse=False, **kw):
        out = fa_ops.flash_attention_ref(q, k, v, **kw)
        return (out, fa_ops.flash_attention_lse_ref(q, k, **kw)) if lse \
            else out

    def norm(x, w, *, eps=1e-6, gemma=False, device=None):
        return norm_ops._rmsnorm_cuda(x, w, eps=eps, gemma=gemma)
    monkeypatch.setattr(fa_ops, "_launch", launch)
    monkeypatch.setattr(fa_ops, "_launch_bwd",
                        lambda q, k, v, o, lse, do, variant, **kw:
                        fa_ops.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                                       **kw))
    monkeypatch.setattr(norm_ops, "_launch", lambda flat, w, variant, **kw:
                        norm_ops.rmsnorm_ref(flat, w, **kw))
    monkeypatch.setattr(norm_ops, "_launch_bwd",
                        lambda flat, w, dy, variant, **kw:
                        norm_ops.rmsnorm_bwd_ref(flat, w, dy, **kw))
    monkeypatch.setattr(t_attn, "flash_attention", flash)
    monkeypatch.setattr(t_layers, "rmsnorm", norm)
    for kern in (fa_ops.flash_attention, fa_ops.flash_attention_bwd):
        monkeypatch.setattr(kern, "launches", 0)
        monkeypatch.setattr(kern, "tc_launches", 0)
    for name in ("launches", "vec_launches", "bwd_launches",
                 "bwd_vec_launches"):
        monkeypatch.setattr(norm_ops.rmsnorm, name, 0)


def _close_tree(ours, theirs, tol, what):
    """Every leaf within ``tol`` of its JAX leaf's scale (paths equal)."""
    ours = jax.tree_util.tree_flatten_with_path(convert.tree_map(_np, ours))[0]
    theirs = jax.tree_util.tree_flatten_with_path(theirs)[0]
    assert len(ours) == len(theirs), what
    for (pa, a), (pb, b) in zip(ours, theirs):
        assert pa == pb, what
        b = np.asarray(b, np.float32)
        bound = tol * max(np.abs(b).max(), 1e-30)
        assert np.abs(a - b).max() <= bound, \
            f"{what} {jax.tree_util.keystr(pa)}"


def _jax_update_of(ts1, jp, jstate):
    """JAX's AdamW update past its clipping, fed the port's own clipped
    gradient with the same parameters and state: the first step's m is
    (1 - b1) times it, from m = 0. The parameters then compare at a
    well-conditioned point: an element whose |g| is near eps moves by lr *
    g / (|g| + eps), which a rounding-size change in g moves by a large
    share of lr, so the updates of two gradients that agree to rounding
    need not agree there."""
    jocfg = JOptimizerConfig(**OPT, grad_clip=0.0)
    one_minus_b1 = np.float32(1 - jocfg.beta1)
    grads = jax.tree.map(lambda m: jnp.asarray(m / one_minus_b1),
                         convert.to_jax(ts1["m"]))
    return j_adamw_update(grads, jp, jstate, jocfg)[0]


@pytest.mark.parametrize("route", ["plain", "card"])
def test_train_step_matches_jax(model, monkeypatch, route):
    """One ``make_train_step`` step of Gemma-3 ``SMOKE`` at
    ``attn_impl="flash"`` on 48 tokens, past the local layers' window of
    32, against JAX's train step: the metrics, the updated parameters and
    AdamW's m (the clipped gradient's tenth) and v. JAX trains at
    ``"chunked"``: its ``"flash"`` sends the local layers to that scan
    already, and its Pallas kernel on the global layers has no VJP. The
    port's "card" route runs the flash and RMSNorm autograd Functions with
    their launches' plain versions: each step launches 4 flash backwards,
    2 with the window, and 4 x 6 + 1 RMSNorm backwards. Tolerances of
    tests/test_torch_lm_train.py: metrics 1e-5 relative, m and v 1e-4 of
    each leaf's scale, parameters that plus 2e-2 of the leaf's update."""
    jcfg = j_gemma.SMOKE.replace(attn_impl="chunked")
    tcfg = t_gemma.SMOKE.replace(attn_impl="flash")
    jp, tp = model
    toks = _tokens(jcfg, 2, 49, seed=9)
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    jstate = j_init_opt_state(jp, JOptimizerConfig(**OPT))
    _, js1, jm = j_make_train_step(jcfg, JOptimizerConfig(**OPT))(
        jp, jstate, jax.tree.map(jnp.asarray, batch))
    if route == "card":
        _card_route(monkeypatch)
    windows = []
    inner = t_attn.flash_attention

    def record(q, k, v, **kw):
        windows.append(kw["window"])
        return inner(q, k, v, **kw)
    monkeypatch.setattr(t_attn, "flash_attention", record)
    tstate = init_opt_state(tp, OptimizerConfig(**OPT))
    tp1, ts1, tm = make_train_step(tcfg, OptimizerConfig(**OPT))(
        tp, tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    # the forward's two periods, then remat's recompute of each (the
    # second first) in the backward
    assert windows == [WINDOW, 0] * 4
    if route == "card":
        assert fa_ops.flash_attention_bwd.launches == 4
        assert norm_ops.rmsnorm.bwd_launches == 4 * 6 + 1
    for name in ("ce", "loss", "lr", "grad_norm"):
        np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                   rtol=1e-5, err_msg=name)
    _close_tree(ts1["m"], js1["m"], TOL, "m")
    _close_tree(ts1["v"], js1["v"], TOL, "v")
    _close_tree(tp1, _jax_update_of(ts1, jp, jstate), TOL, "params")
