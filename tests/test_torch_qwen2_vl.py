"""The port's Qwen2-VL-7B against the JAX package's, on the CPU.

Qwen2-VL-7B's LM backbone is a dense GQA LM of 28 layers, d 3584, 28 q
heads over 4 kv heads of 128 (a group of 7), d_ff 18,944, vocabulary
152,064 and QKV bias, rotated by M-RoPE: the rotary half-dims split
(16, 24, 24) among a temporal, a height and a width position stream. Its
vision encoder is a stub in both packages: patch embeddings are an input,
merged at the image tokens.

* ``apply_mrope`` against JAX's at ``SMOKE``'s (4, 2, 2) over D = 16 and
  the published (16, 24, 24) over D = 128, on distinct (t, h, w) streams
  and on text positions (where it equals ``apply_rope``), fp32 and bf16.
* ``SMOKE`` (2 layers, d 64, 4 q heads over 2 kv heads of 16, fp32) and a
  variant at 14 q heads over 2 kv heads, the published group of 7, with
  nonzero QKV biases (the reference initialises them to zero, so each test
  writes N(0, 0.5) draws into the JAX tree first, then converts it):
  ``forward`` with and without ``vision_embeds`` on image positions whose
  temporal stream repeats, under both ``attn_impl`` settings; ``loss_fn``
  and every gradient with an image in the batch; one ``make_train_step``
  step; a prefill with an image and 8 decode steps; ``ServeEngine``
  against JAX's engine with the port's slot repair; both launchers; the
  converted tree both ways.

The two ``attn_impl`` settings differ here, in both packages (ROADMAP §3):
``"reference"`` masks by the temporal stream, under which an image's
patches share one position and see each other both ways; ``"flash"`` masks
by sequence index (the port's plain version of its kernel; JAX's Pallas
kernel in interpret mode). ``test_attn_impls_differ_on_image_positions``
pins that. JAX's Pallas kernel has no VJP, so where a gradient is taken
under ``"flash"`` the JAX side runs its own chunked scan
(``attention_chunked``) at sequence-index positions in the kernel's place,
a stand-in held to the kernel's forward first.

Image positions are Qwen2-VL's: text before the image at 0..a-1 on all
three streams, a gh x gw grid of one frame at t = a, h = a + row, w = a +
col, and the text after it from a + max(gh, gw) on.

Tolerances: fp32 1e-4 (the model tests' bound); ``apply_mrope`` 1e-5 in
fp32 and one bf16 ulp (2^-8 of the value's magnitude) in bf16, where the
fp32 rotations may round to neighbouring bf16 values. Greedy tokens are
compared while every decode call's logits agree within 1e-4 and no row's
top-2 gap falls under it (tests/test_torch_lm_serve.py's rule).
"""
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import qwen2_vl_7b as j_vl
from repro.models import attention as j_attn
from repro.models import layers as j_layers
from repro.models import registry as j_registry
from repro.models import transformer as jt
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.train.optimizer import OptimizerConfig as JOptimizerConfig
from repro.train.optimizer import adamw_update as j_adamw_update
from repro.train.optimizer import init_opt_state as j_init_opt_state
from repro.train.step import make_train_step as j_make_train_step
from repro_torch import convert
from repro_torch.configs import qwen2_vl_7b as t_vl
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ops import (_flash_bwd_variant,
                                                     _flash_variant,
                                                     bwd_splits, bwd_tc_form)
from repro_torch.kernels.rmsnorm import ops as norm_ops
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.rmsnorm.ops import (_rmsnorm_bwd_variant,
                                             _rmsnorm_variant)
from repro_torch.launch import serve as t_serve_launch
from repro_torch.launch import train as t_train_launch
from repro_torch.models import attention as t_attn
from repro_torch.models import layers as t_layers
from repro_torch.models import registry
from repro_torch.models import transformer as tt
from repro_torch.serve import Request, ServeEngine
from repro_torch.train import (OptimizerConfig, init_opt_state,
                               make_prefill_step, make_serve_step,
                               make_train_step)
from repro_torch.train.step import value_and_grad

TOL = 1e-4
ROPE_TOL = 1e-5
DECODE_STEPS = 8
BIASES = ("bq", "bk", "bv")
# SMOKE's group of 2, and the published group of 7 at SMOKE's widths
VARIANTS = {"smoke": {}, "group7": dict(n_heads=14, n_kv_heads=2)}
# one image a row: (first image token, grid rows, grid columns), or None
ROWS = ((4, 3, 4), (9, 2, 3))
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=10)


def _np(t):
    return t.detach().float().numpy()


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


def _image_positions(rows, S):
    """(3, B, S) Qwen2-VL positions and the (B, S) image mask of rows each
    holding one gh x gw image (one frame) at token ``a``, or text only."""
    pos = np.zeros((3, len(rows), S), np.int64)
    mask = np.zeros((len(rows), S), bool)
    for b, row in enumerate(rows):
        if row is None:
            pos[:, b] = np.arange(S)
            continue
        a, gh, gw = row
        n = gh * gw
        pos[:, b, :a] = np.arange(a)
        pos[0, b, a:a + n] = a
        pos[1, b, a:a + n] = a + np.repeat(np.arange(gh), gw)
        pos[2, b, a:a + n] = a + np.tile(np.arange(gw), gh)
        pos[:, b, a + n:] = a + max(gh, gw) + np.arange(S - a - n)
        mask[b, a:a + n] = True
    return pos, mask


def _image_batch(cfg, rows, S, seed=0):
    """Tokens, (3, B, S) positions, vision embeddings N(0, 1) and the mask."""
    pos, mask = _image_positions(rows, S)
    rng = np.random.default_rng(seed + 100)
    vis = rng.normal(size=(len(rows), S, cfg.d_model)).astype(np.float32)
    return _tokens(cfg, len(rows), S, seed), pos, vis, mask


def _with_bias(jp, seed=0):
    """The JAX tree with every QKV bias leaf set to N(0, 0.5) draws."""
    rng = np.random.default_rng(seed)

    def fill(tree):
        if isinstance(tree, dict):
            return {k: (jnp.asarray(rng.normal(size=v.shape) * 0.5, v.dtype)
                        if k in BIASES else fill(v))
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(fill(v) for v in tree)
        return tree
    return fill(jp)


def _configs(variant, attn_impl="reference"):
    kw = dict(VARIANTS[variant], attn_impl=attn_impl)
    return j_vl.SMOKE.replace(**kw), t_vl.SMOKE.replace(**kw)


@pytest.fixture(scope="module", params=list(VARIANTS))
def model(request):
    jcfg, _ = _configs(request.param)
    jp = _with_bias(jt.init(jax.random.PRNGKey(0), jcfg))
    return request.param, jp, convert.from_jax(jax.tree.map(np.asarray, jp),
                                               device="cpu")


def _seq_index_flash(q, k, v, q_pos, kv_pos, *, causal, window=0,
                     softcap=0.0, scale=None, **_):
    """JAX's ``"flash"`` made differentiable: its chunked scan at
    sequence-index positions, the mask the Pallas kernel applies."""
    idx = jnp.broadcast_to(jnp.arange(q.shape[1])[None], q.shape[:2])
    return j_attn.attention_chunked(q, k, v, idx, idx, causal=causal,
                                    window=window, softcap=softcap,
                                    scale=scale)


# ------------------------------------------------------------------ config
def test_config_is_the_reference_but_flash():
    full_j, full_t = j_vl.CONFIG, t_vl.CONFIG
    assert asdict(full_t) == asdict(full_j.replace(attn_impl="flash"))
    assert (full_t.n_layers, full_t.d_model, full_t.nq, full_t.nkv,
            full_t.hd, full_t.d_ff, full_t.vocab, full_t.qkv_bias,
            full_t.mrope_sections, full_t.rope_theta, full_t.family) == (
        28, 3584, 28, 4, 128, 18_944, 152_064, True, (16, 24, 24), 1e6,
        "vlm")
    assert not full_t.tie_embeddings
    assert asdict(t_vl.SMOKE) == asdict(j_vl.SMOKE)
    assert t_vl.SMOKE.attn_impl == "reference"
    assert t_vl.SMOKE.mrope_sections == (4, 2, 2)
    assert registry.get_config("qwen2-vl-7b") is t_vl.CONFIG
    assert registry.get_config("qwen2-vl-7b", smoke=True) is t_vl.SMOKE
    assert sorted(registry.list_archs()) == sorted(j_registry.list_archs())
    assert len(registry.list_archs()) == 11


def test_full_tree_is_the_reference_layout():
    """JAX's full tree (shapes only): 7.62 B parameters, the untied head
    beside the table, the QKV biases a (28, heads, 128) leaf each; the
    port's own init at 2 layers of the full widths has its leaves, shapes
    and order."""
    full = jax.eval_shape(lambda k: jt.init(k, j_vl.CONFIG),
                          jax.random.PRNGKey(0))
    n = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(full))
    assert n == 7_615_616_512
    attn = full["segments"][0]["b0"]["attn"]
    assert attn["bq"].shape == (28, 28, 128)
    assert attn["bk"].shape == attn["bv"].shape == (28, 4, 128)
    assert attn["wq"].shape == (28, 3584, 28, 128)
    assert attn["wk"].shape == (28, 3584, 4, 128)
    assert full["head"].shape == (3584, 152_064)
    assert full["embed"]["table"].shape == (152_064, 3584)
    cut = dict(n_layers=2, vocab_size=512, d_ff=256)
    jcut = jax.eval_shape(lambda k: jt.init(k, j_vl.CONFIG.replace(**cut)),
                          jax.random.PRNGKey(0))
    own = tt.init(torch.Generator().manual_seed(0), t_vl.CONFIG.replace(**cut))
    jflat = jax.tree_util.tree_flatten_with_path(jcut)[0]
    flat = jax.tree_util.tree_flatten_with_path(
        convert.tree_map(lambda t: np.zeros(t.shape, np.int8), own))[0]
    assert [p for p, _ in flat] == [p for p, _ in jflat]
    assert [a.shape for _, a in flat] == [a.shape for _, a in jflat]


def test_converted_tree_both_ways(model):
    """``to_jax(from_jax(p))`` is the reference's tree exactly, and the
    port's own init goes through JAX's layout and back unchanged."""
    _, jp, _ = model
    jnp_tree = jax.tree.map(np.asarray, jp)
    back = convert.to_jax(convert.from_jax(jnp_tree, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(jnp_tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jnp_tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    own = tt.init(torch.Generator().manual_seed(3), t_vl.SMOKE)
    again = convert.from_jax(convert.to_jax(own), device="cpu")
    for a, b in zip(jax.tree.leaves(convert.tree_map(_np, own)),
                    jax.tree.leaves(convert.tree_map(_np, again))):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------- M-RoPE
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("streams", ["image", "text"])
@pytest.mark.parametrize("sections,D", [((4, 2, 2), 16),
                                        ((16, 24, 24), 128)])
def test_apply_mrope_matches_jax(sections, D, streams, dtype):
    """Distinct (t, h, w) streams (two rows of images at 1e6's theta and
    positions past 1000) and text positions, where M-RoPE is RoPE."""
    B, S, H = 2, 40, 3
    rng = np.random.default_rng(D)
    x = rng.normal(size=(B, S, H, D)).astype(np.float32)
    if streams == "image":
        pos, _ = _image_positions(((3, 5, 6), (10, 4, 4)), S)
        pos[:, 1] += 1000
    else:
        pos = np.broadcast_to(np.arange(1000, 1000 + S), (3, B, S)).copy()
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    theirs = j_layers.apply_mrope(jx, jnp.asarray(pos), 1e6, sections)
    ours = t_layers.apply_mrope(tx, torch.from_numpy(pos), 1e6, sections)
    assert ours.dtype == tx.dtype and ours.shape == tx.shape
    ref = np.asarray(theirs, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(_np(ours), ref, atol=ROPE_TOL)
    else:   # one bf16 ulp of the value's magnitude at most
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
        assert (np.abs(_np(ours) - ref) <= ulp).all()
    if streams == "text":
        rope = t_layers.apply_rope(tx, torch.from_numpy(pos[0]), 1e6)
        np.testing.assert_array_equal(_np(ours), _np(rope))
    else:   # the streams are distinct: not RoPE at the temporal stream
        rope = t_layers.apply_rope(tx, torch.from_numpy(pos[0]), 1e6)
        assert float((ours.float() - rope.float()).abs().max()) > 1e-2


def test_apply_mrope_asserts_the_sections():
    x = torch.zeros(1, 2, 1, 16)
    with pytest.raises(AssertionError):
        t_layers.apply_mrope(x, torch.zeros(3, 1, 2, dtype=torch.long), 1e4,
                             (4, 2, 4))


# ------------------------------------------------------------------- model
@pytest.mark.parametrize("attn_impl", ["reference", "flash"])
def test_forward_matches_jax(model, attn_impl):
    """With and without the image, on image positions, both ``attn_impl``
    settings on both sides (JAX's ``"flash"``: its Pallas kernel in
    interpret mode)."""
    variant, jp, tp = model
    jcfg, tcfg = _configs(variant, attn_impl)
    toks, pos, vis, mask = _image_batch(jcfg, ROWS, 24, seed=2)
    with torch.inference_mode():
        logits, aux = tt.forward(tp, tcfg, torch.from_numpy(toks),
                                 torch.from_numpy(pos),
                                 torch.from_numpy(vis),
                                 torch.from_numpy(mask))
        text, _ = tt.forward(tp, tcfg, torch.from_numpy(toks),
                             torch.from_numpy(pos))
    jl, _ = jt.forward(jp, jcfg, jnp.asarray(toks), jnp.asarray(pos),
                       jnp.asarray(vis), jnp.asarray(mask))
    jtext, _ = jt.forward(jp, jcfg, jnp.asarray(toks), jnp.asarray(pos))
    assert logits.shape == (2, 24, jcfg.vocab) and float(aux) == 0.0
    np.testing.assert_allclose(_np(logits), np.asarray(jl), atol=TOL)
    np.testing.assert_allclose(_np(text), np.asarray(jtext), atol=TOL)
    # the image reaches the output, and so do the biases
    assert float((logits - text).abs().max()) > 1e2 * TOL
    zero = convert.tree_map(lambda t: t, tp)
    attn = zero["segments"][0]["b0"]["attn"]
    for name in BIASES:
        attn[name] = torch.zeros_like(attn[name])
    with torch.inference_mode():
        unbiased, _ = tt.forward(zero, tcfg, torch.from_numpy(toks),
                                 torch.from_numpy(pos),
                                 torch.from_numpy(vis),
                                 torch.from_numpy(mask))
    assert float((unbiased - logits).abs().max()) > 1e2 * TOL


def test_attn_impls_differ_on_image_positions(model):
    """ROADMAP §3's trap: on image positions ``"reference"`` masks by the
    temporal stream (an image's patches see each other both ways) and
    ``"flash"`` by sequence index, in JAX and in the port alike; on text
    positions the two agree. The sequence-index stand-in the gradient
    tests give JAX's ``"flash"`` is its Pallas kernel's function."""
    variant, jp, tp = model
    toks, pos, vis, mask = _image_batch(j_vl.SMOKE, ROWS, 24, seed=2)
    text_pos = np.broadcast_to(np.arange(24), pos.shape).copy()
    out = {}
    for impl in ("reference", "flash"):
        jcfg, tcfg = _configs(variant, impl)
        for name, p in (("image", pos), ("text", text_pos)):
            jl, _ = jt.forward(jp, jcfg, jnp.asarray(toks), jnp.asarray(p),
                               jnp.asarray(vis), jnp.asarray(mask))
            with torch.inference_mode():
                tl, _ = tt.forward(tp, tcfg, torch.from_numpy(toks),
                                   torch.from_numpy(p), torch.from_numpy(vis),
                                   torch.from_numpy(mask))
            out[impl, name] = np.asarray(jl), _np(tl)
    for side in (0, 1):     # JAX, the port
        gap = np.abs(out["flash", "image"][side]
                     - out["reference", "image"][side]).max()
        assert gap > 1e2 * TOL
        np.testing.assert_allclose(out["flash", "text"][side],
                                   out["reference", "text"][side], atol=TOL)
    jcfg, _ = _configs(variant, "flash")
    orig = j_attn.attention_flash
    try:
        j_attn.attention_flash = _seq_index_flash
        stand_in, _ = jt.forward(jp, jcfg, jnp.asarray(toks),
                                 jnp.asarray(pos), jnp.asarray(vis),
                                 jnp.asarray(mask))
    finally:
        j_attn.attention_flash = orig
    np.testing.assert_allclose(np.asarray(stand_in), out["flash", "image"][0],
                               atol=TOL)


def _vision_batch(cfg, S, seed):
    toks, pos, vis, mask = _image_batch(cfg, ROWS, S + 1, seed=seed)
    return {"inputs": toks[:, :-1], "labels": toks[:, 1:],
            "positions": pos[..., :-1], "vision_embeds": vis[:, :-1],
            "vision_mask": mask[:, :-1]}


@pytest.mark.parametrize("attn_impl", ["reference", "flash"])
def test_loss_and_grads_match_jax(model, monkeypatch, attn_impl):
    """The training loss and every leaf's gradient with an image in the
    batch, the biases' among them. Under ``"flash"`` JAX's side runs the
    sequence-index stand-in for its Pallas kernel, which has no VJP."""
    variant, jp, tp = model
    jcfg, tcfg = _configs(variant, attn_impl)
    monkeypatch.setattr(j_attn, "attention_flash", _seq_index_flash)
    batch = _vision_batch(jcfg, 20, seed=4)
    (jl, _), jg = jax.value_and_grad(jt.loss_fn, has_aux=True)(
        jp, jcfg, jax.tree.map(jnp.asarray, batch))
    (loss, _), grads = value_and_grad(
        tt.loss_fn, tp, tcfg, {k: torch.from_numpy(v) for k, v in
                               batch.items()}, has_aux=True)
    np.testing.assert_allclose(float(loss), float(jl), atol=TOL)
    ours = jax.tree_util.tree_flatten_with_path(convert.tree_map(_np, grads))
    theirs = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert len(ours[0]) == len(theirs) == 14
    for (pa, a), (pb, b) in zip(ours[0], theirs):
        assert pa == pb
        np.testing.assert_allclose(a, np.asarray(b), atol=TOL,
                                   err_msg=jax.tree_util.keystr(pa))
    bq = grads["segments"][0]["b0"]["attn"]["bq"]
    assert float(bq.abs().max()) > 10 * TOL


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
    gradient with the same parameters and state (the first step's m is
    (1 - b1) times it, from m = 0): the parameters compare at a
    well-conditioned point, since an element whose |g| is near eps moves
    by a large share of lr under a rounding-size change in g."""
    jocfg = JOptimizerConfig(**OPT, grad_clip=0.0)
    one_minus_b1 = np.float32(1 - jocfg.beta1)
    grads = jax.tree.map(lambda m: jnp.asarray(m / one_minus_b1),
                         convert.to_jax(ts1["m"]))
    return j_adamw_update(grads, jp, jstate, jocfg)[0]


@pytest.mark.parametrize("route", ["plain", "card"])
def test_train_step_matches_jax(model, monkeypatch, route):
    """One ``make_train_step`` step at ``attn_impl="flash"`` on 20 tokens
    with an image a row, against JAX's train step at ``"flash"`` with the
    sequence-index stand-in: the metrics and AdamW's m and v, then the
    updated parameters against JAX's AdamW update fed the port's own
    clipped gradient. The "card" route runs the flash and RMSNorm autograd
    Functions with their launches' plain versions: a step launches 2 flash
    backwards and 2 x 2 + 1 RMSNorm backwards. Tolerances of
    tests/test_torch_lm_train.py: metrics 1e-5 relative, m, v and the
    parameters 1e-4 of each leaf's scale."""
    variant, jp, tp = model
    jcfg, tcfg = _configs(variant, "flash")
    monkeypatch.setattr(j_attn, "attention_flash", _seq_index_flash)
    batch = _vision_batch(jcfg, 20, seed=9)
    jstate = j_init_opt_state(jp, JOptimizerConfig(**OPT))
    _, js1, jm = j_make_train_step(jcfg, JOptimizerConfig(**OPT))(
        jp, jstate, jax.tree.map(jnp.asarray, batch))
    if route == "card":
        _card_route(monkeypatch)
    tstate = init_opt_state(tp, OptimizerConfig(**OPT))
    tp1, ts1, tm = make_train_step(tcfg, OptimizerConfig(**OPT))(
        tp, tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    if route == "card":
        # the forward's and remat's recompute of it
        assert fa_ops.flash_attention.launches == 2 * jcfg.n_layers
        assert fa_ops.flash_attention_bwd.launches == jcfg.n_layers
        assert norm_ops.rmsnorm.bwd_launches == 2 * jcfg.n_layers + 1
    for name in ("ce", "loss", "lr", "grad_norm"):
        np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                   rtol=1e-5, err_msg=name)
    _close_tree(ts1["m"], js1["m"], TOL, "m")
    _close_tree(ts1["v"], js1["v"], TOL, "v")
    _close_tree(tp1, _jax_update_of(ts1, jp, jstate), TOL, "params")


@pytest.mark.parametrize("attn_impl", ["reference", "flash"])
def test_prefill_and_decode_match_jax(model, attn_impl):
    """A 21-token prefill with an image in two of three rows (the third
    text only) through ``make_prefill_step`` into a cache of 21 + 8, then
    8 greedy ``make_serve_step`` steps at (3, B, 1) positions continuing
    each row's own, logits and caches against JAX's ``prefill`` and
    ``decode_step`` at every step."""
    variant, jp, tp = model
    jcfg, tcfg = _configs(variant, attn_impl)
    B, P = 3, 21
    toks, pos, vis, mask = _image_batch(jcfg, ROWS + (None,), P, seed=5)
    with torch.inference_mode():
        lg, cache = make_prefill_step(tcfg, s_cache=P + DECODE_STEPS)(
            tp, torch.from_numpy(toks), torch.from_numpy(pos),
            torch.from_numpy(vis), torch.from_numpy(mask))
    jlg, jcache = jt.prefill(jp, jcfg, jnp.asarray(toks), jnp.asarray(pos),
                             s_cache=P + DECODE_STEPS,
                             vision_embeds=jnp.asarray(vis),
                             vision_mask=jnp.asarray(mask))
    np.testing.assert_allclose(_np(lg), np.asarray(jlg), atol=TOL)
    serve_step = make_serve_step(tcfg)
    tok = lg.argmax(-1, keepdim=True)
    for i in range(DECODE_STEPS):
        step_pos = pos[..., -1:] + 1 + i
        jtok = jnp.asarray(tok.numpy())
        with torch.inference_mode():
            tok, lg, cache = serve_step(tp, tok, torch.from_numpy(step_pos),
                                        cache, P + i)
        jlg, jcache = jt.decode_step(jp, jcfg, jtok,
                                     jnp.asarray(step_pos), jcache,
                                     jnp.asarray(P + i))
        np.testing.assert_allclose(_np(lg), np.asarray(jlg), atol=TOL)
        top2 = np.sort(np.asarray(jlg), axis=-1)[:, -2:]
        assert not (top2[:, 1] - top2[:, 0] < TOL).any(), \
            "a near-tie: pick another seed"
    ours = jax.tree.leaves(convert.tree_map(_np, cache))
    theirs = jax.tree.leaves(jcache)
    assert len(ours) == len(theirs) == 2
    for a, b in zip(ours, theirs):
        assert a.shape == b.shape == (jcfg.n_layers, B, P + DECODE_STEPS,
                                      jcfg.nkv, jcfg.hd)
        np.testing.assert_allclose(a, np.asarray(b), atol=TOL)


class RepairedJServeEngine(JServeEngine):
    """The JAX engine with the port's slot repair: a refilled slot's rows
    of every cache leaf are zeroed before its prompt is fed."""

    def _prefill_slot(self, slot, req):
        self.cache = jax.tree.map(lambda c: c.at[:, slot].set(0), self.cache)
        super()._prefill_slot(slot, req)


def _record(eng, log):
    """Keep the logits of every decode call the engine makes."""
    inner = eng._decode

    def decode(*args):
        logits, cache = inner(*args)
        log.append(np.asarray(logits, np.float32))
        return logits, cache
    eng._decode = decode


@pytest.mark.parametrize("attn_impl", ["reference", "flash"])
def test_engine_tokens_match_jax(model, attn_impl):
    """Batch 3, s_max 32, five requests of ragged prompts (1-7 tokens) and
    budgets, so slots are refilled and run at different indices in one
    decode call, each at M-RoPE's (3, B, 1) text positions; JAX's engine
    with the port's slot repair."""
    variant, jp, tp = model
    jcfg, tcfg = _configs(variant, attn_impl)
    jeng = RepairedJServeEngine(jcfg, jp, batch=3, s_max=32)
    teng = ServeEngine(tcfg, tp, batch=3, s_max=32, device="cpu")
    jlog, tlog = [], []
    _record(jeng, jlog)
    _record(teng, tlog)
    rng = np.random.default_rng(1)
    prompts = [[int(t) for t in rng.integers(0, jcfg.vocab, k)]
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


# ----------------------------------------------------------------- kernels
def test_kernel_variants_at_full_width(monkeypatch):
    """The tensors the model hands its kernels at the published widths
    (one layer, bf16, M-RoPE positions with an image): flash at 28 q heads
    over 4 kv heads of 128 takes the tensor cores, and its backward the
    Hopper streaming form with 2 shares of the group of 7 (3 and 4 q
    heads) at a 2 x 2048 training layer on 132 SMs, 1 at 4 x 2048; the
    three norms
    over d 3584 (448 vectors) the vec variant both ways. A prefill runs 1
    flash and 3 norms, a decode step the norms alone."""
    flashes, norms = [], []

    def flash_probe(q, k, v, **kw):
        out = flash_attention(q, k, v, **kw)
        flashes.append((q.shape[2:], k.shape[2:], _flash_variant(q, k, v),
                        _flash_bwd_variant(q, k, v, out,
                                           torch.empty_like(out))))
        return out

    def norm_probe(x, w, **kw):
        norms.append((x.shape[-1], _rmsnorm_variant(x, w),
                      _rmsnorm_bwd_variant(x, w, torch.empty_like(x))))
        return rmsnorm(x, w, **kw)

    monkeypatch.setattr(t_attn, "flash_attention", flash_probe)
    monkeypatch.setattr(t_layers, "rmsnorm", norm_probe)
    cfg = t_vl.CONFIG.replace(n_layers=1, vocab_size=512, d_ff=256)
    params = tt.init(torch.Generator().manual_seed(0), cfg)
    S = 20
    toks, pos, vis, mask = _image_batch(cfg, ((4, 3, 4),), S, seed=1)
    with torch.inference_mode():
        _, cache = tt.prefill(params, cfg, torch.from_numpy(toks),
                              torch.from_numpy(pos), None,
                              torch.from_numpy(vis), torch.from_numpy(mask))
        assert flashes == [((28, 128), (4, 128), "tc", "tc")]
        assert norms == [(3584, "vec", "vec")] * 3
        tt.decode_step(params, cfg, torch.from_numpy(toks[:, :1]),
                       torch.from_numpy(pos[..., -1:] + 1), cache, S)
    assert len(flashes) == 1 and norms == [(3584, "vec", "vec")] * 6
    assert bwd_tc_form(2048, 2048, 28, 4, 128) == "wg"
    assert bwd_splits(2, 2048, 4, 7, 132) == 2
    assert bwd_splits(4, 2048, 4, 7, 132) == 1


# ---------------------------------------------------------------- launchers
def test_launchers_run_qwen2_vl(tmp_path, capsys):
    out = t_serve_launch.main(["--arch", "qwen2-vl-7b", "--smoke", "--device",
                               "cpu", "--requests", "5", "--max-new", "4"])
    assert out["arch"] == "qwen2-vl-7b"
    assert out["done"] == out["requests"] == 5 and out["tokens"] == 20
    args = ["--arch", "qwen2-vl-7b", "--smoke", "--device", "cpu", "--steps",
            "2", "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path)]
    first = t_train_launch.main(args)
    second = t_train_launch.main(args)
    assert "resumed at step 2" in capsys.readouterr().out
    assert first["arch"] == "qwen2-vl-7b" and second["steps_done"] == 4
    assert np.isfinite(first["losses"] + second["losses"]).all()
