"""The port's MoE LM (Qwen1.5-MoE-A2.7B) against the JAX package's, on the
CPU.

* ``topk_moe``, ``topk_moe_sorted``, ``dense_moe`` and ``moe_forward`` on a
  layer's weights drawn in JAX and converted: without drops (capacity factor
  8), with drops (0.5: some tokens are asserted dropped), in capacity groups
  (``moe_group_size`` 8 over S = 32), with and without shared experts, fp32
  and bf16; the router's aux loss too.
* ``_project_qkv`` and ``attn_forward`` with nonzero QKV biases.
* Qwen2-MoE ``SMOKE`` (2 layers, d 64, 4 heads of 16, 8 experts top-2 + 1
  shared, fp32) with nonzero QKV biases, under both ``attn_impl`` settings
  (``"flash"``: JAX's Pallas kernel in interpret mode, the port's plain
  version): ``forward``, ``loss_fn`` with its aux and gradients, a prefill
  and 8 decode steps, ``make_serve_step``, ``ServeEngine``'s tokens against
  JAX's engine, a decode that never writes its input cache, the converted
  tree both ways, and the serve launcher.
* A padded-head config (``SMOKE.padded(3)``: 6 q heads over 4 kv heads) at
  ``attn_impl="flash"``: the port broadcasts K/V to the q heads as the
  reference math maps them and calls the flash kernel's wrapper, and its
  forward equals JAX's.
* A leading dense layer (``first_k_dense`` 1) before the MoE ones.
* One ``make_train_step`` step of ``SMOKE`` at ``attn_impl="flash"``
  against JAX's train step: the metrics (the aux loss among them) and
  AdamW's m and v, then the updated parameters against JAX's AdamW update
  fed the port's own clipped gradient (1e-4 of each leaf's scale), on the
  plain path and on the card's route (the flash,
  RMSNorm and grouped-GEMM autograd Functions with their launches' plain
  versions).
* The train launcher's default ``--arch`` is the reference's.

The reference initialises the QKV biases to zero, so every test that covers
them first writes nonzero values into the JAX tree, then converts it.

Tolerances: fp32 1e-4 (the model tests' bound), bf16 2e-2 of the output's
largest magnitude (a few bf16 ulps), the aux loss 1e-6 relative in fp32.
A route flips between the packages where a token's K-th and (K+1)-th router
probabilities lie within rounding of each other: every test counts the
tokens whose gap is under NEAR_TIE (in the port's router, which agrees with
JAX's within 1e-6) and asserts there are none. Greedy tokens are compared
while every decode call's logits agree within 1e-4 and no row's top-2 gap
falls under it (tests/test_torch_lm_serve.py's rule).
"""
import contextlib
import re
from dataclasses import asdict
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import qwen2_moe_a2_7b as j_qwen
from repro.models import attention as j_attn
from repro.models import moe as j_moe
from repro.models import transformer as jt
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.train import make_serve_step as j_make_serve_step
from repro.train.optimizer import OptimizerConfig as JOptimizerConfig
from repro.train.optimizer import adamw_update as j_adamw_update
from repro.train.optimizer import init_opt_state as j_init_opt_state
from repro.train.step import make_train_step as j_make_train_step
from repro_torch import convert
from repro_torch.configs import qwen2_moe_a2_7b as t_qwen
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.moe_gemm import ops as gemm_ops
from repro_torch.kernels.rmsnorm import ops as norm_ops
from repro_torch.launch import serve as t_serve_launch
from repro_torch.launch import train as t_train_launch
from repro_torch.models import attention as t_attn
from repro_torch.models import layers as t_layers
from repro_torch.models import moe as t_moe
from repro_torch.models import registry
from repro_torch.models import transformer as tt
from repro_torch.serve import Request, ServeEngine
from repro_torch.train import (OptimizerConfig, init_opt_state,
                               make_serve_step, make_train_step)
from repro_torch.train.step import value_and_grad

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4
BF16_REL = 2e-2
AUX_RTOL = 1e-6
NEAR_TIE = 1e-5
DECODE_STEPS = 8


def _np(t):
    return t.detach().float().numpy()


def _torch(jtree):
    return convert.tree_map(lambda a: torch.from_numpy(np.array(a)), jtree)


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


def _pos(B, S, start=0):
    return np.broadcast_to(np.arange(start, start + S)[None], (B, S)).copy()


@contextlib.contextmanager
def _route_gaps():
    """Record, for every token the port routes while active, the gap
    between its K-th and (K+1)-th router probabilities."""
    gaps, inner = [], t_moe._route

    def route(params, x, cfg):
        probs, gates, idx = inner(params, x, cfg)
        top = torch.topk(probs, min(cfg.top_k + 1, cfg.n_experts), -1)[0]
        gaps.append((top[..., -2] - top[..., -1]).flatten())
        return probs, gates, idx
    t_moe._route = route
    try:
        yield gaps
    finally:
        t_moe._route = inner


def _no_near_ties(gaps):
    assert gaps
    gap = torch.cat(gaps)
    assert int((gap < NEAR_TIE).sum()) == 0, \
        f"{int((gap < NEAR_TIE).sum())} near-tie routes: pick another seed"


def _close(ours, theirs, dtype):
    theirs = np.asarray(theirs, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(_np(ours), theirs, atol=TOL)
    else:
        err = np.abs(_np(ours) - theirs).max()
        assert err <= BF16_REL * np.abs(theirs).max(), err


def _with_bias(jp, seed=0):
    """The JAX tree with every ``bq``/``bk``/``bv`` leaf set to N(0, 0.5)
    draws: the reference initialises them to zero."""
    rng = np.random.default_rng(seed)

    def fill(tree):
        if isinstance(tree, dict):
            return {k: (jnp.asarray(rng.normal(size=v.shape) * 0.5, v.dtype)
                        if k in ("bq", "bk", "bv") else fill(v))
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(fill(v) for v in tree)
        return tree
    out = fill(jp)
    n = sum(1 for path, _ in jax.tree_util.tree_flatten_with_path(out)[0]
            if str(path[-1]) in ("['bq']", "['bk']", "['bv']"))
    assert n, "no QKV bias leaf"
    return out


# ------------------------------------------------------------------ config
def test_config_is_the_reference_but_flash():
    full_j, full_t = j_qwen.CONFIG, t_qwen.CONFIG
    assert asdict(full_t) == asdict(full_j.replace(attn_impl="flash"))
    assert (full_t.n_layers, full_t.d_model, full_t.nq, full_t.nkv,
            full_t.hd, full_t.n_experts, full_t.top_k,
            full_t.n_shared_experts, full_t.expert_d_ff, full_t.vocab,
            full_t.qkv_bias) == (24, 2048, 16, 16, 128, 60, 4, 4, 1408,
                                 151936, True)
    assert asdict(t_qwen.SMOKE) == asdict(j_qwen.SMOKE)
    assert t_qwen.SMOKE.attn_impl == "reference"
    assert registry.get_config("qwen2-moe-a2.7b") is t_qwen.CONFIG
    assert registry.get_config("qwen2-moe-a2.7b", smoke=True) is t_qwen.SMOKE


# --------------------------------------------------------------------- moe
MOE_CASES = {
    # name: (capacity_factor, moe_group_size, shared experts, drops)
    "no drops": (8.0, 4096, 1, False),
    "drops": (0.5, 4096, 1, True),
    "groups of 8": (1.25, 8, 1, None),
    "no shared": (0.5, 4096, 0, True),
}


def _moe_configs(case, dtype):
    cf, group, shared, _ = MOE_CASES[case]
    kw = dict(capacity_factor=cf, moe_group_size=group,
              n_shared_experts=shared, compute_dtype=dtype)
    return j_qwen.SMOKE.replace(**kw), t_qwen.SMOKE.replace(**kw)


def _moe_layer(case, dtype, seed):
    jcfg, tcfg = _moe_configs(case, dtype)
    jp = j_moe.init_moe(jax.random.PRNGKey(seed), jcfg)
    x = np.random.default_rng(seed).normal(size=(2, 32, jcfg.d_model)
                                           ).astype(np.float32)
    xj = jnp.asarray(x, dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    return jcfg, tcfg, jp, _torch(jp), xj, xt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(MOE_CASES))
@pytest.mark.parametrize("scheme", ["topk", "sorted"])
def test_topk_moe_matches_jax(scheme, case, dtype):
    jcfg, tcfg, jp, tp, xj, xt = _moe_layer(case, dtype, seed=len(case))
    jfn = {"topk": j_moe.topk_moe, "sorted": j_moe.topk_moe_sorted}[scheme]
    tfn = {"topk": t_moe.topk_moe, "sorted": t_moe.topk_moe_sorted}[scheme]
    jy, jaux = jfn(jp, xj, jcfg)
    with _route_gaps() as gaps:
        y, aux = tfn(tp, xt, tcfg)
    _no_near_ties(gaps)
    assert y.shape == xt.shape and y.dtype == xt.dtype
    _close(y, jy, dtype)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=AUX_RTOL)
    assert aux.dtype == torch.float32 and aux.ndim == 0
    # drops as the case says: count the kept (token, k) pairs
    x = xt
    if scheme == "topk" and tcfg.moe_group_size < x.shape[1]:
        x = x.reshape(-1, tcfg.moe_group_size, x.shape[-1])
    S, E, K = x.shape[1], tcfg.n_experts, tcfg.top_k
    C = max(1, int(np.ceil(S * K * tcfg.capacity_factor / E)))
    _, _, idx = t_moe._route(tp, x, tcfg)
    keep = t_moe._capacity_slots(idx, E, C)[1]
    drops = MOE_CASES[case][3]
    if drops is not None:
        assert bool((~keep).any()) == drops


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_moe_matches_jax(dtype):
    jcfg, tcfg, jp, tp, xj, xt = _moe_layer("no drops", dtype, seed=3)
    jy, jaux = j_moe.dense_moe(jp, xj, jcfg)
    y, aux = t_moe.dense_moe(tp, xt, tcfg)
    _close(y, jy, dtype)
    assert float(aux) == float(jaux) == 0.0


@pytest.mark.parametrize("scheme", ["topk", "sorted", "dense"])
def test_moe_forward_selects_the_scheme(scheme):
    jcfg, tcfg, jp, tp, xj, xt = _moe_layer("drops", "float32", seed=5)
    jy, jaux = j_moe.moe_forward(jp, xj, jcfg, scheme=scheme)
    with _route_gaps() as gaps:
        y, aux = t_moe.moe_forward(tp, xt, tcfg, scheme=scheme)
    if scheme != "dense":
        _no_near_ties(gaps)
    _close(y, jy, "float32")
    np.testing.assert_allclose(float(aux), float(jaux), rtol=AUX_RTOL)


@pytest.mark.parametrize("scheme", ["topk", "sorted", "dense"])
def test_moe_forward_without_aux(scheme):
    """``with_aux=False`` gives the same output, bit for bit, and a Python
    0.0 in the aux loss's place."""
    _, tcfg, _, tp, _, xt = _moe_layer("drops", "bfloat16", seed=5)
    y, aux = t_moe.moe_forward(tp, xt, tcfg, scheme=scheme)
    y0, aux0 = t_moe.moe_forward(tp, xt, tcfg, scheme=scheme, with_aux=False)
    assert torch.is_tensor(aux) and aux0 == 0.0 and isinstance(aux0, float)
    assert torch.equal(y0, y)


def test_moe_init_is_the_reference_layout():
    cfg = t_qwen.SMOKE
    jp = j_moe.init_moe(jax.random.PRNGKey(0), j_qwen.SMOKE)
    tp = t_moe.init_moe(torch.Generator().manual_seed(0), cfg, lead=(3,))
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tflat = jax.tree_util.tree_flatten_with_path(
        convert.tree_map(_np, tp))[0]
    assert [p for p, _ in jflat] == [p for p, _ in tflat]
    for (_, a), (_, t) in zip(jflat, tflat):
        assert t.shape == (3,) + a.shape and t.dtype == a.dtype
    assert tp["router"].dtype == torch.float32


# ---------------------------------------------------------------- qkv bias
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qkv_bias_matches_jax(dtype):
    jcfg = j_qwen.SMOKE.replace(compute_dtype=dtype)
    tcfg = t_qwen.SMOKE.replace(compute_dtype=dtype)
    jp = _with_bias(j_attn.init_attention(jax.random.PRNGKey(2), jcfg))
    tp = _torch(jp)
    t_own = t_attn.init_attention(torch.Generator().manual_seed(0), tcfg)
    for name in ("bq", "bk", "bv"):
        assert t_own[name].shape == tuple(jp[name].shape)
        assert not t_own[name].any() and float(np.abs(jp[name]).min()) > 0
    B, S = 2, 12
    x = np.random.default_rng(2).normal(size=(B, S, jcfg.d_model)).astype(
        np.float32)
    pos = _pos(B, S)
    xj, xt = jnp.asarray(x, dtype), torch.from_numpy(x).to(
        getattr(torch, dtype))
    jq = j_attn._project_qkv(jp, xj, jcfg, jnp.asarray(pos), jcfg.rope_theta)
    tq = t_attn._project_qkv(tp, xt, tcfg, torch.from_numpy(pos))
    for a, b in zip(tq, jq):
        _close(a, b, dtype)
    jy = j_attn.attn_forward(jp, xj, jcfg, jnp.asarray(pos))
    y = t_attn.attn_forward(tp, xt, tcfg, torch.from_numpy(pos))
    _close(y, jy, dtype)
    # the biases reach the output
    zero = dict(tp, bq=torch.zeros_like(tp["bq"]))
    assert not torch.equal(t_attn.attn_forward(zero, xt, tcfg,
                                               torch.from_numpy(pos)), y)


# ------------------------------------------------------------------- model
def _configs(attn_impl="reference"):
    return (j_qwen.SMOKE.replace(attn_impl=attn_impl),
            t_qwen.SMOKE.replace(attn_impl=attn_impl))


@pytest.fixture(scope="module")
def model():
    jp = _with_bias(jt.init(jax.random.PRNGKey(0), j_qwen.SMOKE))
    return jp, convert.from_jax(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("attn_impl", ["reference", "flash"])
def test_forward_matches_jax(model, attn_impl):
    jcfg, tcfg = _configs(attn_impl)
    jp, tp = model
    toks, pos = _tokens(jcfg, 2, 24, seed=2), _pos(2, 24)
    with torch.inference_mode(), _route_gaps() as gaps:
        logits, aux = tt.forward(tp, tcfg, torch.from_numpy(toks),
                                 torch.from_numpy(pos))
    _no_near_ties(gaps)
    jl, jaux = jt.forward(jp, jcfg, jnp.asarray(toks), jnp.asarray(pos))
    assert logits.shape == (2, 24, jcfg.vocab)
    np.testing.assert_allclose(_np(logits), np.asarray(jl), atol=TOL)
    assert torch.is_tensor(aux) and float(aux) > 0
    np.testing.assert_allclose(float(aux), float(jaux), rtol=AUX_RTOL)


def test_loss_and_grads_match_jax(model):
    """The training forward's loss (ce + the router's aux) and every leaf's
    gradient, the router's through the aux loss and the gates."""
    jcfg, tcfg = _configs()
    jp, tp = model
    toks = _tokens(jcfg, 2, 17, seed=4)
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    (jl, jm), jg = jax.value_and_grad(jt.loss_fn, has_aux=True)(
        jp, jcfg, jax.tree.map(jnp.asarray, batch))
    with _route_gaps() as gaps:
        (loss, metrics), grads = value_and_grad(
            tt.loss_fn, tp, tcfg, {k: torch.from_numpy(v) for k, v in
                                   batch.items()}, has_aux=True)
    _no_near_ties(gaps)
    np.testing.assert_allclose(float(loss), float(jl), atol=TOL)
    np.testing.assert_allclose(float(metrics["aux"]), float(jm["aux"]),
                               rtol=AUX_RTOL)
    np.testing.assert_allclose(float(metrics["ce"]) + float(metrics["aux"]),
                               float(loss), rtol=1e-6)
    ours = jax.tree.leaves(convert.tree_map(_np, grads))
    theirs = jax.tree.leaves(jg)
    assert len(ours) == len(theirs) == 17
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
    with torch.inference_mode(), _route_gaps() as gaps:
        lg, cache = tt.prefill(tp, tcfg, torch.from_numpy(toks),
                               torch.from_numpy(_pos(B, P)),
                               s_cache=P + DECODE_STEPS)
        jlg, jcache = jt.prefill(jp, jcfg, jnp.asarray(toks),
                                 jnp.asarray(_pos(B, P)),
                                 s_cache=P + DECODE_STEPS)
        np.testing.assert_allclose(_np(lg), np.asarray(jlg), atol=TOL)
        tok = lg.argmax(-1, keepdim=True)
        for i in range(P, P + DECODE_STEPS):
            lg, cache = tt.decode_step(tp, tcfg, tok,
                                       torch.from_numpy(_pos(B, 1, i)),
                                       cache, i)
            jlg, jcache = jt.decode_step(jp, jcfg, jnp.asarray(tok.numpy()),
                                         jnp.asarray(_pos(B, 1, i)), jcache,
                                         jnp.asarray(i))
            np.testing.assert_allclose(_np(lg), np.asarray(jlg), atol=TOL)
            tok = lg.argmax(-1, keepdim=True)
    _no_near_ties(gaps)
    ours = jax.tree.leaves(convert.tree_map(_np, cache))
    theirs = jax.tree.leaves(jcache)
    assert len(ours) == len(theirs) == 2
    for a, b in zip(ours, theirs):
        assert a.shape == b.shape == (jcfg.n_layers, B, P + DECODE_STEPS,
                                      jcfg.nkv, jcfg.hd)
        np.testing.assert_allclose(a, np.asarray(b), atol=TOL)


def test_serve_steps_match_jax(model):
    jcfg, tcfg = _configs()
    jp, tp = model
    B, S = 2, 20
    toks = _tokens(jcfg, B, S, seed=8)
    jlg, jcache = jt.prefill(jp, jcfg, jnp.asarray(toks),
                             jnp.asarray(_pos(B, S)), s_cache=S + 4)
    with torch.inference_mode():
        _, cache = tt.prefill(tp, tcfg, torch.from_numpy(toks),
                              torch.from_numpy(_pos(B, S)), s_cache=S + 4)
    jtok = jnp.argmax(jlg, -1).astype(jnp.int32)[:, None]
    tok = torch.from_numpy(np.array(jtok))
    jserve, serve = j_make_serve_step(jcfg), make_serve_step(tcfg)
    with _route_gaps() as gaps:
        for i in range(S, S + 4):
            jtok, jlg, jcache = jserve(jp, jtok, jnp.full((B, 1), i), jcache,
                                       jnp.asarray(i))
            with torch.inference_mode():
                tok, lg, cache = serve(tp, tok, torch.full((B, 1), i), cache,
                                       i)
            np.testing.assert_allclose(_np(lg), np.asarray(jlg), atol=TOL)
            np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    _no_near_ties(gaps)


def test_decode_does_not_write_its_input_cache(model):
    _, tp = model
    cfg = t_qwen.SMOKE
    cache = tt.init_cache(cfg, 2, 8, device="cpu")
    before = convert.tree_map(torch.clone, cache)
    _, new = tt.decode_step(tp, cfg, torch.ones(2, 1, dtype=torch.long),
                            torch.zeros(2, 1, dtype=torch.long), cache, 0)
    for name in ("k", "v"):
        assert torch.equal(cache["segments"][0]["b0"][name],
                           before["segments"][0]["b0"][name])
        assert not torch.equal(new["segments"][0]["b0"][name],
                               cache["segments"][0]["b0"][name])


def test_cached_modes_skip_the_aux_loss(model, monkeypatch):
    """The prefill and decode steps drop the router's aux loss, so they do
    not compute it; the training forward computes it once a layer."""
    _, tp = model
    cfg = t_qwen.SMOKE
    calls, inner = [], t_moe._aux_loss

    def aux_loss(*args):
        calls.append(1)
        return inner(*args)
    monkeypatch.setattr(t_moe, "_aux_loss", aux_loss)
    toks = torch.from_numpy(_tokens(cfg, 2, 9, seed=9))
    pos = torch.from_numpy(_pos(2, 9))
    with torch.inference_mode():
        _, cache = tt.prefill(tp, cfg, toks[:, :8], pos[:, :8], s_cache=9)
        tt.decode_step(tp, cfg, toks[:, 8:], pos[:, 8:], cache, 8)
        assert not calls
        _, aux = tt.forward(tp, cfg, toks, pos)
    assert torch.is_tensor(aux) and len(calls) == cfg.n_layers


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
    budgets, so slots run at different indices in one decode call; each
    slot routes as its own capacity group, as the reference's vmapped
    single-sequence decode does."""
    jp, tp = model
    jeng = JServeEngine(j_qwen.SMOKE, jp, batch=3, s_max=32)
    teng = ServeEngine(t_qwen.SMOKE, tp, batch=3, s_max=32, device="cpu")
    jlog, tlog = [], []
    _record(jeng, jlog)
    _record(teng, tlog)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, j_qwen.SMOKE.vocab, k)]
               for k in rng.integers(1, 8, 5)]
    for eng, make in ((jeng, JRequest), (teng, Request)):
        for rid, prompt in enumerate(prompts):
            eng.add_request(make(rid=rid, prompt=prompt, max_new=4 + rid))
    with torch.inference_mode(), _route_gaps() as gaps:
        tdone = teng.run()
    _no_near_ties(gaps)
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


def test_launcher_serves_qwen2_moe(capsys):
    out = t_serve_launch.main(["--arch", "qwen2-moe-a2.7b", "--smoke",
                               "--device", "cpu", "--requests", "2",
                               "--max-new", "4"])
    assert out["arch"] == "qwen2-moe-a2.7b" and out["device"] == "cpu"
    assert out["done"] == out["requests"] == 2 and out["tokens"] == 8
    assert "2/2 requests done" in capsys.readouterr().out


def test_padded_heads_take_the_reference_math(monkeypatch):
    """6 q heads over 4 kv heads (``padded(3)``): with ``attn_impl="flash"``
    the port broadcasts K/V to the 6 q heads by the reference math's map (a
    padded head reads the last kv head) and calls the flash kernel's
    wrapper once a layer with Hq = Hkv, which the kernel takes; its
    forward equals JAX's."""
    jcfg = j_qwen.SMOKE.padded(3)
    tcfg = t_qwen.SMOKE.padded(3).replace(attn_impl="flash")
    assert (tcfg.nq, tcfg.nkv) == (6, 4)
    jp = _with_bias(jt.init(jax.random.PRNGKey(6), jcfg), seed=6)
    tp = convert.from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    toks, pos = _tokens(jcfg, 2, 16, seed=6), _pos(2, 16)
    heads, inner = [], t_attn.flash_attention

    def flash(q, k, v, **kw):
        heads.append((q.shape[2], k.shape[2], v.shape[2]))
        return inner(q, k, v, **kw)
    monkeypatch.setattr(t_attn, "flash_attention", flash)
    with torch.inference_mode(), _route_gaps() as gaps:
        logits, aux = tt.forward(tp, tcfg, torch.from_numpy(toks),
                                 torch.from_numpy(pos))
    _no_near_ties(gaps)
    assert heads == [(6, 6, 6)] * tcfg.n_layers
    jl, jaux = jt.forward(jp, jcfg, jnp.asarray(toks), jnp.asarray(pos))
    assert logits.shape == (2, 16, jcfg.vocab)
    np.testing.assert_allclose(_np(logits), np.asarray(jl), atol=TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=AUX_RTOL)


def test_first_k_dense_layers_match_jax():
    """A leading dense layer before the MoE ones (``first_k_dense``, as
    deepseek-v2 has): its MLP takes the wide ``shared_d_ff``; the port's
    own init has JAX's layout and the forward equals JAX's."""
    jcfg = j_qwen.SMOKE.replace(first_k_dense=1, n_layers=3, shared_d_ff=96)
    tcfg = t_qwen.SMOKE.replace(first_k_dense=1, n_layers=3, shared_d_ff=96)
    jp = _with_bias(jt.init(jax.random.PRNGKey(7), jcfg), seed=7)
    tp = convert.from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    own = tt.init(torch.Generator().manual_seed(0), tcfg)
    for a, b in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                    jax.tree_util.tree_flatten_with_path(
                        convert.tree_map(_np, own))[0]):
        assert a[0] == b[0] and a[1].shape == b[1].shape, a[0]
    assert own["segments"][0]["b0"]["ffn"]["wo"].shape == (1, 96, 64)
    toks, pos = _tokens(jcfg, 2, 16, seed=7), _pos(2, 16)
    with torch.inference_mode(), _route_gaps() as gaps:
        logits, aux = tt.forward(tp, tcfg, torch.from_numpy(toks),
                                 torch.from_numpy(pos))
    _no_near_ties(gaps)
    jl, jaux = jt.forward(jp, jcfg, jnp.asarray(toks), jnp.asarray(pos))
    np.testing.assert_allclose(_np(logits), np.asarray(jl), atol=TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=AUX_RTOL)


# ---------------------------------------------------------------- convert
def test_converted_tree_is_the_reference_layout(model):
    """JAX's full Qwen2-MoE tree (shapes only) holds the named leaves; the
    converted SMOKE tree and the port's own init have JAX's leaves, shapes
    and order, and the round trip is exact."""
    full = jax.eval_shape(lambda k: jt.init(k, j_qwen.CONFIG),
                          jax.random.PRNGKey(0))
    b0 = full["segments"][0]["b0"]
    L, d, f = 24, 2048, 1408
    assert b0["attn"]["wq"].shape == (L, d, 16, 128)
    assert b0["attn"]["bq"].shape == b0["attn"]["bk"].shape == (L, 16, 128)
    assert b0["ffn"]["router"].shape == (L, d, 60)
    assert b0["ffn"]["experts"]["wi"].shape == (L, 60, d, 2, f)
    assert b0["ffn"]["experts"]["wo"].shape == (L, 60, f, d)
    assert b0["ffn"]["shared"]["wi"].shape == (L, 4, d, 2, f)
    assert full["embed"]["table"].shape == (151936, d)
    jp, tp = model
    own = tt.init(torch.Generator().manual_seed(0), t_qwen.SMOKE)
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


# ---------------------------------------------------------------- launcher
def test_train_launcher_defaults_to_the_reference_arch(tmp_path):
    ref = re.search(r'add_argument\("--arch", default="([^"]+)"\)',
                    (ROOT / "src/repro/launch/train.py").read_text())
    out = t_train_launch.main(["--smoke", "--device", "cpu", "--steps", "1",
                               "--batch", "2", "--seq", "16",
                               "--ckpt-dir", str(tmp_path)])
    assert out["arch"] == ref.group(1) == "tinyllama-1.1b"
    assert out["steps_done"] == 1 and np.isfinite(out["losses"]).all()


# ------------------------------------------------------------------ training
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=10)


def _card_route(monkeypatch):
    """The model's flash, RMSNorm and grouped-GEMM calls take the card's
    route (their autograd Functions, with counters), each kernel launch
    replaced by its plain version on the CPU tensors."""
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
    monkeypatch.setattr(gemm_ops, "_launch",
                        lambda x, w, variant, trans_x=False:
                        gemm_ops.grouped_gemm_ref(
                            x.transpose(1, 2) if trans_x else x, w))
    monkeypatch.setattr(t_attn, "flash_attention", flash)
    monkeypatch.setattr(t_layers, "rmsnorm", norm)
    monkeypatch.setattr(t_moe, "grouped_gemm",
                        lambda x, w, device=None: gemm_ops._gemm_cuda(x, w))
    for kern in (fa_ops.flash_attention, fa_ops.flash_attention_bwd,
                 gemm_ops.grouped_gemm):
        monkeypatch.setattr(kern, "launches", 0)
        monkeypatch.setattr(kern, "tc_launches", 0)
    for name in ("bwd_launches", "bwd_tc_launches", "bwd_fused_calls"):
        monkeypatch.setattr(gemm_ops.grouped_gemm, name, 0)
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
    """One ``make_train_step`` step of Qwen2-MoE ``SMOKE`` (nonzero QKV
    biases) at ``attn_impl="flash"`` against JAX's train step at
    ``"reference"`` (its Pallas kernel has no VJP): the metrics and AdamW's
    m (the clipped gradient's tenth) and v, the router's through the aux
    loss and the gates; no router near-tie. Then the updated parameters
    against JAX's AdamW update fed the port's own clipped gradient
    (``_jax_update_of``).
    The "card" route runs the flash, RMSNorm and grouped-GEMM autograd
    Functions with their launches' plain versions: each step launches 2
    flash backwards, 2 x 2 + 1 RMSNorm backwards and the experts' 2 grouped
    GEMMs a layer, each with dX and dW (fp32: two launches a projection).
    Tolerances: metrics 1e-5 relative, m, v and the parameters 1e-4 of
    each leaf's scale."""
    jcfg, _ = _configs()
    tcfg = t_qwen.SMOKE.replace(attn_impl="flash")
    jp, tp = model
    toks = _tokens(jcfg, 2, 25, seed=11)
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    jstate = j_init_opt_state(jp, JOptimizerConfig(**OPT))
    _, js1, jm = j_make_train_step(jcfg, JOptimizerConfig(**OPT))(
        jp, jstate, jax.tree.map(jnp.asarray, batch))
    if route == "card":
        _card_route(monkeypatch)
    tstate = init_opt_state(tp, OptimizerConfig(**OPT))
    with _route_gaps() as gaps:
        tp1, ts1, tm = make_train_step(tcfg, OptimizerConfig(**OPT))(
            tp, tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    _no_near_ties(gaps)
    if route == "card":
        assert fa_ops.flash_attention_bwd.launches == 2
        assert norm_ops.rmsnorm.bwd_launches == 2 * 2 + 1
        # the forward's and remat's recompute of it
        assert gemm_ops.grouped_gemm.launches == 2 * 2 * 2
        assert gemm_ops.grouped_gemm.bwd_launches == 2 * 2 * 2
    for name in ("ce", "aux", "loss", "lr", "grad_norm"):
        np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                   rtol=1e-5, err_msg=name)
    _close_tree(ts1["m"], js1["m"], TOL, "m")
    _close_tree(ts1["v"], js1["v"], TOL, "v")
    _close_tree(tp1, _jax_update_of(ts1, jp, jstate), TOL, "params")
