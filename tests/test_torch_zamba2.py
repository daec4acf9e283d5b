"""The port's Zamba2-7B against the JAX package's, on the CPU.

Zamba2-7B is a hybrid of 81 layers: 11 groups of 6 Mamba2 blocks and one
attention + MLP block (``attn``) whose weights are tied across the 11
applications, then 4 more Mamba2 blocks; d 3584, d_inner 7168, 112 SSD
heads of 64, state 64, one group; the shared block has 32 heads of 112 and
a gated-GELU MLP of 14,336. ``SMOKE`` (7 layers: 2 groups of (mamba,
mamba, shared attn) and one more mamba, d 64, fp32) runs the shared block
twice and the remainder segment once. Every RMSNorm scale is a distinct
N(1, 0.3) draw written into the JAX tree first (the reference inits them
to ones, where a swapped ``ln``/``out_norm`` or ``ln1``/``ln2`` would
hide). A second variant runs the shared block at 2 heads of 112, the
published head dim that ``SMOKE``'s 16 hides.

Checked: the tree (one unstacked shared tree, converted both ways),
``forward``, ``loss_fn`` and every leaf's gradient (the shared leaves'
the sum over their applications, as JAX's scan closure gives it), the
same under the config's ``attn_impl="flash"`` against JAX's
``"reference"`` model, one
``make_train_step`` step, plain and through the card's route (the RMSNorm
and SSD autograd Functions with their launches' plain versions), against
JAX's train step, ``ChainedTrainer``'s donated step against the functional
one, a prefill and 8 decode steps with both caches, ``ServeEngine``'s
tokens against JAX's engine with the port's slot repair, the kernels'
variants at the full widths both ways, and both launchers.

Tolerances: fp32 1e-4 (the model tests' bound); the train step's metrics
1e-5 relative, m, v and the parameters 1e-4 of each leaf's scale
(tests/test_torch_lm_train.py's). Greedy tokens are compared
while every decode call's logits agree within 1e-4 and no row's top-2 gap
falls under it (tests/test_torch_lm_serve.py's rule).
"""
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import zamba2_7b as j_zamba
from repro.models import transformer as jt
from repro.models.common import layer_plan
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.train.optimizer import OptimizerConfig as JOptimizerConfig
from repro.train.optimizer import adamw_update as j_adamw_update
from repro.train.optimizer import init_opt_state as j_init_opt_state
from repro.train.step import make_train_step as j_make_train_step
from repro_torch import convert
from repro_torch.configs import zamba2_7b as t_zamba
from repro_torch.data import DataConfig, data_iterator
from repro_torch.kernels.rmsnorm import ops as norm_ops
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.rmsnorm.ops import (_rmsnorm_bwd_variant,
                                             _rmsnorm_variant, bwd_vec_split)
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ssd
from repro_torch.kernels.ssd.ops import (MAX_SMEM_BYTES, _ssd_bwd_variant,
                                         _ssd_variant, bwd_smem_bytes,
                                         smem_bytes)
from repro_torch.launch import serve as t_serve_launch
from repro_torch.launch import train as t_train_launch
from repro_torch.models import layers, registry, ssm
from repro_torch.models import transformer as tt
from repro_torch.serve import Request, ServeEngine
from repro_torch.train import (ChainConfig, ChainedTrainer, OptimizerConfig,
                               init_opt_state, make_train_step)
from repro_torch.train.step import value_and_grad

TOL = 1e-4
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=10)
DECODE_STEPS = 8
NORM_STD = 0.3
BF16 = torch.bfloat16
VARIANTS = {"smoke": {},
            "heads112": dict(n_heads=2, n_kv_heads=2, head_dim=112)}


def _np(t):
    return t.detach().float().numpy()


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


def _pos(B, S, start=0):
    return np.broadcast_to(np.arange(start, start + S)[None], (B, S)).copy()


def _draw_norms(jp, seed=0):
    """The JAX tree with every norm scale set to N(1, NORM_STD) draws."""
    rng = np.random.default_rng(seed)

    def fill(tree, key=None):
        if isinstance(tree, dict):
            return {k: fill(v, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(fill(v) for v in tree)
        if key == "scale":
            return jnp.asarray(1 + NORM_STD * rng.normal(size=tree.shape),
                               tree.dtype)
        return tree
    return fill(jp)


def _configs(variant):
    return (j_zamba.SMOKE.replace(**VARIANTS[variant]),
            t_zamba.SMOKE.replace(**VARIANTS[variant]))


@pytest.fixture(scope="module", params=list(VARIANTS))
def model(request):
    jcfg, tcfg = _configs(request.param)
    jp = _draw_norms(jt.init(jax.random.PRNGKey(0), jcfg))
    tp = convert.from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


class RepairedJServeEngine(JServeEngine):
    """The JAX engine with the port's slot repair: a refilled slot's rows
    of every cache leaf are zeroed before its prompt is fed."""

    def _prefill_slot(self, slot, req):
        self.cache = jax.tree.map(lambda c: c.at[:, slot].set(0), self.cache)
        super()._prefill_slot(slot, req)


# ------------------------------------------------------------------ config
def test_config_is_the_reference():
    """The reference's config but ``attn_impl="flash"`` (the shared block's
    heads of 112 on the flash kernel); ``SMOKE`` is the reference's,
    ``"reference"``."""
    full_j, full_t = j_zamba.CONFIG, t_zamba.CONFIG
    assert full_j.attn_impl == "reference"
    assert asdict(full_t) == asdict(full_j.replace(attn_impl="flash"))
    assert asdict(t_zamba.SMOKE) == asdict(j_zamba.SMOKE)
    assert t_zamba.SMOKE.attn_impl == "reference"
    assert (full_t.n_layers, full_t.d_model, full_t.d_inner,
            full_t.ssm_nheads, full_t.ssm_headdim, full_t.ssm_state,
            full_t.ssm_ngroups, full_t.nq, full_t.hd, full_t.d_ff,
            full_t.vocab, full_t.attn_impl) == (
        81, 3584, 7168, 112, 64, 64, 1, 32, 112, 14336, 32_000, "flash")
    plan = layer_plan(full_t)
    assert [(s.n_repeat, s.pattern, s.shared) for s in plan] == [
        (11, ("mamba",) * 6 + ("attn",), (False,) * 6 + (True,)),
        (1, ("mamba",) * 4, (False,) * 4)]
    assert [(s.n_repeat, s.pattern) for s in layer_plan(t_zamba.SMOKE)] == [
        (2, ("mamba", "mamba", "attn")), (1, ("mamba",))]
    assert registry.get_config("zamba2-7b") is t_zamba.CONFIG
    assert registry.get_config("zamba2-7b", smoke=True) is t_zamba.SMOKE


def test_full_tree_is_the_reference_layout():
    """JAX's full tree (shapes only): 5,893,372,128 parameters, the shared
    block one unstacked tree. The port's own init at the full widths, cut
    to one (mamba, shared attn) group, a vocabulary of 512 and an MLP of
    256, has JAX's leaves, shapes and order at the same cut."""
    full = jax.eval_shape(lambda k: jt.init(k, j_zamba.CONFIG),
                          jax.random.PRNGKey(0))
    n = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(full))
    assert n == 5_893_372_128
    shared = full["segments"][0]["b6"]
    assert shared["attn"]["wq"].shape == (3584, 32, 112)
    assert shared["ffn"]["wi"].shape == (3584, 2, 14336)
    assert full["segments"][0]["b0"]["mamba"]["w_x"].shape == (11, 3584,
                                                                 7168)
    assert full["segments"][1]["b0"]["mamba"]["A_log"].shape == (1, 112)
    cut = dict(n_layers=2, attn_every=2, vocab_size=512, d_ff=256)
    jcut = jax.eval_shape(lambda k: jt.init(k, j_zamba.CONFIG.replace(**cut)),
                          jax.random.PRNGKey(0))
    own = tt.init(torch.Generator().manual_seed(0),
                  t_zamba.CONFIG.replace(**cut))
    jflat = jax.tree_util.tree_flatten_with_path(jcut)[0]
    flat = jax.tree_util.tree_flatten_with_path(
        convert.tree_map(lambda t: np.zeros(t.shape, np.int8), own))[0]
    assert [p for p, _ in flat] == [p for p, _ in jflat]
    assert [a.shape for _, a in flat] == [a.shape for _, a in jflat]


def test_tied_block_is_one_unstacked_tree():
    """``init`` gives the shared position one tree without a layer axis
    beside the stacked Mamba positions, and ``to_jax(from_jax(p))`` gives
    back the reference's tree exactly."""
    cfg = t_zamba.SMOKE
    own = tt.init(torch.Generator().manual_seed(0), cfg)
    seg = own["segments"][0]
    assert seg["b2"]["attn"]["wq"].shape == (cfg.d_model, cfg.nq, cfg.hd)
    assert seg["b2"]["ln1"]["scale"].shape == (cfg.d_model,)
    assert seg["b0"]["ln"]["scale"].shape == (2, cfg.d_model)
    assert own["segments"][1]["b0"]["ln"]["scale"].shape == (1, cfg.d_model)
    jp = jax.tree.map(np.asarray, _draw_norms(
        jt.init(jax.random.PRNGKey(0), j_zamba.SMOKE)))
    back = convert.to_jax(convert.from_jax(jp, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------- model
def test_forward_matches_jax(model):
    jcfg, tcfg, jp, tp = model
    toks, pos = _tokens(jcfg, 2, 40, seed=2), _pos(2, 40)
    with torch.inference_mode():
        logits, aux = tt.forward(tp, tcfg, torch.from_numpy(toks),
                                 torch.from_numpy(pos))
    jl, _ = jt.forward(jp, jcfg, jnp.asarray(toks), jnp.asarray(pos))
    assert logits.shape == (2, 40, jcfg.vocab) and float(aux) == 0.0
    np.testing.assert_allclose(_np(logits), np.asarray(jl), atol=TOL)


def test_loss_and_grads_match_jax(model):
    """The training loss and every leaf's gradient: the shared block's
    leaves take the sum over its two applications."""
    jcfg, tcfg, jp, tp = model
    toks = _tokens(jcfg, 2, 37, seed=4)     # 36 positions: chunks 16, 16, 4
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    (jl, _), jg = jax.value_and_grad(jt.loss_fn, has_aux=True)(
        jp, jcfg, jax.tree.map(jnp.asarray, batch))
    (loss, _), grads = value_and_grad(
        tt.loss_fn, tp, tcfg, {k: torch.from_numpy(v) for k, v in
                               batch.items()}, has_aux=True)
    np.testing.assert_allclose(float(loss), float(jl), atol=TOL)
    ours = jax.tree_util.tree_flatten_with_path(convert.tree_map(_np, grads))
    theirs = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert len(ours[0]) == len(theirs) == 62
    for (pa, a), (pb, b) in zip(ours[0], theirs):
        assert pa == pb
        np.testing.assert_allclose(a, np.asarray(b), atol=TOL,
                                   err_msg=jax.tree_util.keystr(pa))
    wq = grads["segments"][0]["b2"]["attn"]["wq"]
    assert wq.shape == (tcfg.d_model, tcfg.nq, tcfg.hd)
    assert float(wq.abs().max()) > 1e2 * TOL


def test_flash_matches_jax_reference(model):
    """The port under ``attn_impl="flash"`` (the config's setting: the
    shared block's causal, unwindowed attention through the flash wrapper,
    its plain version here) against JAX's ``"reference"`` model on the
    same weights: ``forward``, the training loss and every leaf's gradient
    (the tied block's the sum over its two applications), 1e-4."""
    jcfg, tcfg, jp, tp = model
    tcfg = tcfg.replace(attn_impl="flash")
    assert jcfg.attn_impl == "reference"
    toks, pos = _tokens(jcfg, 2, 40, seed=12), _pos(2, 40)
    with torch.inference_mode():
        logits, _ = tt.forward(tp, tcfg, torch.from_numpy(toks),
                               torch.from_numpy(pos))
    jl, _ = jt.forward(jp, jcfg, jnp.asarray(toks), jnp.asarray(pos))
    np.testing.assert_allclose(_np(logits), np.asarray(jl), atol=TOL)
    toks = _tokens(jcfg, 2, 37, seed=13)
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    (jloss, _), jg = jax.value_and_grad(jt.loss_fn, has_aux=True)(
        jp, jcfg, jax.tree.map(jnp.asarray, batch))
    (loss, _), grads = value_and_grad(
        tt.loss_fn, tp, tcfg, {k: torch.from_numpy(v) for k, v in
                               batch.items()}, has_aux=True)
    np.testing.assert_allclose(float(loss), float(jloss), atol=TOL)
    ours = jax.tree_util.tree_flatten_with_path(convert.tree_map(_np, grads))
    theirs = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert len(ours[0]) == len(theirs) == 62
    for (pa, a), (pb, b) in zip(ours[0], theirs):
        assert pa == pb
        np.testing.assert_allclose(a, np.asarray(b), atol=TOL,
                                   err_msg=jax.tree_util.keystr(pa))


def _card_route(monkeypatch):
    """The model's RMSNorm and SSD calls take the card's route (their
    autograd Functions, with counters from 0), each kernel launch replaced
    by its plain version on the CPU tensors."""
    def norm(x, w, *, eps=1e-6, gemma=False, device=None):
        norm_ops._check(x, w)
        return norm_ops._rmsnorm_cuda(x, w, eps=eps, gemma=gemma)

    def scan(x, dt, A, B, C, D, chunk, initial_state=None, *, device=None):
        ssd_ops._check(x, dt, A, B, C, D, chunk, initial_state)
        return ssd_ops._ssd_cuda(x, dt, A, B, C, D, chunk, initial_state)
    monkeypatch.setattr(norm_ops, "_launch", lambda flat, w, variant, **kw:
                        norm_ops.rmsnorm_ref(flat, w, **kw))
    monkeypatch.setattr(norm_ops, "_launch_bwd",
                        lambda flat, w, dy, variant, **kw:
                        norm_ops.rmsnorm_bwd_ref(flat, w, dy, **kw))
    monkeypatch.setattr(ssd_ops, "_launch",
                        lambda x, dt, A, B, C, D, Q, init, variant:
                        ssd_ops.ssd_ref(x, dt, A, B, C, D, Q, init))
    monkeypatch.setattr(ssd_ops, "_launch_bwd",
                        lambda x, dt, A, B, C, D, Q, dy, init, d_final,
                        variant: ssd_ops.ssd_bwd_ref(x, dt, A, B, C, D, Q,
                                                     dy, init, d_final))
    monkeypatch.setattr(layers, "rmsnorm", norm)
    monkeypatch.setattr(ssm, "ssd", scan)
    for name in ("launches", "vec_launches", "bwd_launches",
                 "bwd_vec_launches"):
        monkeypatch.setattr(norm_ops.rmsnorm, name, 0)
    for name in ("launches", "tc_launches", "bwd_launches",
                 "bwd_tc_launches"):
        monkeypatch.setattr(ssd, name, 0)


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
    """One ``make_train_step`` step on 36 positions (chunks of 16, 16 and
    4) against JAX's train step: the metrics and AdamW's m and v, the tied
    block's leaves the sum over its two applications, then the updated
    parameters against JAX's AdamW update fed the port's own clipped
    gradient. The "card" route runs the RMSNorm and SSD autograd Functions
    with their launches' plain versions: a step launches 5 scans and 15
    norms (2 a Mamba block, 2 a shared-block application, the final)
    backward, and forward twice that but the final norm (remat's
    recompute)."""
    jcfg, tcfg, jp, tp = model
    toks = _tokens(jcfg, 2, 37, seed=9)
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    jstate = j_init_opt_state(jp, JOptimizerConfig(**OPT))
    _, js1, jm = j_make_train_step(jcfg, JOptimizerConfig(**OPT))(
        jp, jstate, jax.tree.map(jnp.asarray, batch))
    if route == "card":
        _card_route(monkeypatch)
    tstate = init_opt_state(tp, OptimizerConfig(**OPT))
    tp1, ts1, tm = make_train_step(tcfg, OptimizerConfig(**OPT))(
        tp, tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    if route == "card":
        mamba = sum(seg.n_repeat * seg.pattern.count("mamba")
                    for seg in layer_plan(tcfg))
        apps = tcfg.n_layers - mamba
        assert (mamba, apps) == (5, 2)
        norms = 2 * mamba + 2 * apps + 1
        # remat runs every block's forward again in the backward: the
        # forward launches twice but the final norm's, the backward once
        assert (ssd.launches, ssd.bwd_launches) == (2 * mamba, mamba)
        assert (norm_ops.rmsnorm.launches,
                norm_ops.rmsnorm.bwd_launches) == (2 * norms - 1, norms) \
            == (29, 15)
        assert norm_ops.rmsnorm.bwd_vec_launches == norms
    for name in ("ce", "loss", "lr", "grad_norm"):
        np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                   rtol=1e-5, err_msg=name)
    _close_tree(ts1["m"], js1["m"], TOL, "m")
    _close_tree(ts1["v"], js1["v"], TOL, "v")
    _close_tree(tp1, _jax_update_of(ts1, jp, jstate), TOL, "params")


def _leaves(tree):
    out = []
    convert.tree_map(out.append, tree)
    return out


def test_chained_trainer_donates_the_functional_bits(tmp_path):
    """``ChainedTrainer``'s donated step on ``SMOKE``, 3 steps, against
    ``make_train_step``'s functional step from the same state on the same
    batches: the same losses, every parameter, m and v leaf the same bits,
    and every leaf in its own storage, the tied block's one tree (updated by
    the sum over its two applications) among them."""
    cfg = t_zamba.SMOKE
    ocfg = OptimizerConfig(**OPT)
    dc = DataConfig(batch=2, seq_len=24, seed=1)
    tr = ChainedTrainer(cfg, ocfg, ChainConfig(ckpt_dir=str(tmp_path),
                                               ckpt_every=100),
                        data_iterator(cfg, dc, device="cpu"), seed=0,
                        device="cpu")
    params, opt = convert.tree_map(torch.clone, (tr.params, tr.opt_state))
    params_0 = convert.tree_map(torch.clone, params)
    tied = tr.params["segments"][0]["b2"]
    assert tied["attn"]["wq"].shape == (cfg.d_model, cfg.nq, cfg.hd)
    before = [t.data_ptr() for t in _leaves((tr.params, tr.opt_state))]
    tied_before = [t.data_ptr() for t in _leaves(tied)]
    info = tr.run_subjob(3)
    step = make_train_step(cfg, ocfg)
    data = data_iterator(cfg, dc, device="cpu")
    losses = []
    for _ in range(3):
        params, opt, metrics = step(params, opt, next(data))
        losses.append(float(metrics["loss"]))
    assert info["losses"] == losses and np.isfinite(losses).all()
    assert [t.data_ptr() for t in _leaves((tr.params, tr.opt_state))] == \
        before
    assert tr.params["segments"][0]["b2"] is tied
    assert [t.data_ptr() for t in _leaves(tied)] == tied_before
    assert not torch.equal(tied["attn"]["wq"],
                           params_0["segments"][0]["b2"]["attn"]["wq"])
    for a, b in zip(_leaves((tr.params, tr.opt_state)),
                    _leaves((params, opt))):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_prefill_and_decode_match_jax(model):
    """A 21-token prefill (a ragged second chunk) into a cache of 21 + 8,
    then 8 greedy decode steps: logits against JAX at every step, then
    every cache leaf, the shared block's K/V one entry an application."""
    jcfg, tcfg, jp, tp = model
    B, P = 3, 21
    toks = _tokens(jcfg, B, P, seed=5)
    s_cache = P + DECODE_STEPS
    with torch.inference_mode():
        lg, cache = tt.prefill(tp, tcfg, torch.from_numpy(toks),
                               torch.from_numpy(_pos(B, P)), s_cache=s_cache)
    jlg, jcache = jt.prefill(jp, jcfg, jnp.asarray(toks),
                             jnp.asarray(_pos(B, P)), s_cache=s_cache)
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
    kv = cache["segments"][0]["b2"]
    assert kv["k"].shape == (2, B, s_cache, tcfg.nkv, tcfg.hd)
    assert cache["segments"][0]["b0"]["state"].shape == (
        2, B, tcfg.ssm_nheads, tcfg.ssm_headdim, tcfg.ssm_state)
    ours = jax.tree_util.tree_flatten_with_path(convert.tree_map(_np, cache))
    theirs = jax.tree_util.tree_flatten_with_path(jcache)[0]
    assert len(ours[0]) == len(theirs) == 14
    for (pa, a), (pb, b) in zip(ours[0], theirs):
        assert pa == pb and a.shape == b.shape
        np.testing.assert_allclose(a, np.asarray(b), atol=TOL,
                                   err_msg=jax.tree_util.keystr(pa))


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
    budgets, so slots are refilled and run at different indices in one
    decode call; JAX's engine with the port's slot repair."""
    jcfg, tcfg, jp, tp = model
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
    """The tensors the model hands its kernels at the published widths, one
    (mamba, shared attn) group and a last Mamba block, bf16: each Mamba
    block's norm over d_model (448 vectors) and its gated out_norm over
    d_inner (896 vectors, two warps a row in the backward) take the vec
    kernel both ways; the shared block's two norms and the final one vec;
    the scan, 112 heads of 64, N = 64, the tc variant both ways (95,264
    bytes of shared memory at chunk 256 forward, 148,516 backward). A
    prefill runs 2 x 2 + 2 + 1 norms and 2 scans, a decode step the norms
    alone."""
    norms, scans = [], []

    def norm_probe(x, w, **kw):
        norms.append((x.shape[-1], _rmsnorm_variant(x, w),
                      _rmsnorm_bwd_variant(x, w, torch.empty_like(x))))
        return rmsnorm(x, w, **kw)

    def ssd_probe(x, dt, A, B, C, D, chunk, initial_state=None, **kw):
        scans.append((tuple(x.shape[2:]), tuple(B.shape[2:]),
                      _ssd_variant(x, B, C)))
        return ssd(x, dt, A, B, C, D, chunk, initial_state, **kw)

    monkeypatch.setattr(layers, "rmsnorm", norm_probe)
    monkeypatch.setattr(ssm, "ssd", ssd_probe)
    cfg = t_zamba.CONFIG.replace(n_layers=3, attn_every=2, vocab_size=512,
                                 d_ff=256)
    params = tt.init(torch.Generator().manual_seed(0), cfg)
    B, S = 1, 20
    toks = torch.randint(0, 512, (B, S),
                         generator=torch.Generator().manual_seed(1))
    pos = torch.arange(S)[None].expand(B, S)
    d, di = cfg.d_model, cfg.d_inner
    mamba = [(d, "vec", "vec"), (di, "vec", "vec")]
    per_pass = mamba + [(d, "vec", "vec")] * 2 + mamba + [(d, "vec", "vec")]
    with torch.inference_mode():
        _, cache = tt.prefill(params, cfg, toks, pos)
        assert norms == per_pass
        assert scans == [((112, 64), (1, 64), "tc")] * 2
        tt.decode_step(params, cfg, toks[:, :1], pos[:, :1] + S, cache, S)
    assert norms == per_pass * 2 and len(scans) == 2
    assert di // 8 == 896 and bwd_vec_split(di // 8) == 2
    x = torch.empty(4, 2048, 112, 64, dtype=BF16)
    assert _ssd_variant(x, x[..., :1, :], x[..., :1, :]) == "tc"
    assert smem_bytes(64, 64, 256, "tc") == 95_264 <= MAX_SMEM_BYTES
    x = x[:2]                                  # the training batch, 2 x 2048
    bc = x[..., :1, :]
    assert _ssd_bwd_variant(x, bc, bc, torch.empty_like(x), 256) == "tc"
    assert bwd_smem_bytes(64, 64, 256, "tc") == 148_516 <= MAX_SMEM_BYTES


# ---------------------------------------------------------------- launchers
def test_launchers_run_zamba2(tmp_path, capsys):
    out = t_serve_launch.main(["--arch", "zamba2-7b", "--smoke", "--device",
                               "cpu", "--requests", "5", "--max-new", "4"])
    assert out["arch"] == "zamba2-7b"
    assert out["done"] == out["requests"] == 5 and out["tokens"] == 20
    args = ["--arch", "zamba2-7b", "--smoke", "--device", "cpu", "--steps",
            "2", "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path)]
    first = t_train_launch.main(args)
    second = t_train_launch.main(args)
    assert "resumed at step 2" in capsys.readouterr().out
    assert first["arch"] == "zamba2-7b" and second["steps_done"] == 4
    assert np.isfinite(first["losses"] + second["losses"]).all()
