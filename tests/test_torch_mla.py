"""The port's Multi-head Latent Attention and DeepSeek-V2 against the JAX
package's, on the CPU.

* The config, the registry, and the trees of ``init_mla`` and ``init``:
  JAX's leaves, shapes and order; conversion both ways.
* ``_mla_q`` and ``_mla_latent``, ``mla_forward``, ``mla_latent_chunked``
  (a chunk that divides S, one that does not, and heads run one at a time),
  ``mla_prefill`` and its cache, and ``mla_decode`` over several steps at
  per-row indices against JAX's ``vmap`` of its one-row decode, on one
  layer's weights in fp32 and bf16, at ``SMOKE``'s widths and at uneven
  ones (q_lora 40, kv_lora 24, v 12, so that no two of the latent, the
  query rank and the head widths share a size).
* The absorbed decode against ``mla_forward``'s output for the same row.
* DeepSeek-V2 ``SMOKE`` (a dense layer, then MoE: 8 experts top-2 + 1
  shared, d 64, 4 heads, fp32) and a variant with 16 experts top-6 over 3
  layers, whose prefill drops (token, k) pairs at capacity: ``forward``,
  ``loss_fn`` and its gradients, a prefill and 8 decode steps,
  ``ServeEngine``'s tokens against JAX's engine, and the serve launcher.

In ``SMOKE`` the query and kv ranks are both 32 and the nope and v widths
both 16, and the reference initialises every norm scale to 1: a swapped
``q_norm``/``kv_norm`` or ``w_uk``/``w_uv`` would pass every shape check.
Every test first writes a distinct N(1, NORM_STD) draw into each norm
scale of the JAX tree (``_bumped``), then converts it.

Tolerances: fp32 1e-4 (the model tests' bound), bf16 2e-2 of the output's
largest magnitude. Every test that routes counts the tokens whose K-th and
(K+1)-th router probabilities lie within NEAR_TIE and asserts there are
none (tests/test_torch_moe_lm.py's rule). Greedy tokens are compared while
every decode call's logits agree within 1e-4 and no row's top-2 gap falls
under it (tests/test_torch_lm_serve.py's rule).
"""
import contextlib
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import deepseek_v2_236b as j_ds
from repro.models import attention as j_attn
from repro.models import transformer as jt
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch import convert
from repro_torch.configs import deepseek_v2_236b as t_ds
from repro_torch.launch import serve as t_launch
from repro_torch.models import attention as t_attn
from repro_torch.models import moe as t_moe
from repro_torch.models import registry
from repro_torch.models import transformer as tt
from repro_torch.models.common import layer_plan
from repro_torch.serve import Request, ServeEngine
from repro_torch.train.step import value_and_grad

TOL = 1e-4
BF16_REL = 2e-2
AUX_RTOL = 1e-6
NEAR_TIE = 1e-5
NORM_STD = 0.3
DECODE_STEPS = 8
NORMS = ("q_norm", "kv_norm", "ln1", "ln2", "final_norm")
# no two of q_lora, kv_lora, nope + rope and v share a size
UNEVEN = dict(q_lora_rank=40, kv_lora_rank=24, v_head_dim=12)
# 16 routed experts, top-6, over a dense layer and 2 MoE layers
TOP6 = dict(n_experts=16, top_k=6, n_layers=3)
MODELS = {"smoke": {}, "top6": TOP6}


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


def _configs(**kw):
    return j_ds.SMOKE.replace(**kw), t_ds.SMOKE.replace(**kw)


def _bumped(jtree, seed):
    """The JAX tree with every norm scale a distinct N(1, NORM_STD) draw,
    each leaf its own."""
    rng = np.random.default_rng(seed)
    n = [0]

    def fill(tree, norm=False):
        if isinstance(tree, dict):
            return {k: fill(v, norm or k in NORMS) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(fill(v, norm) for v in tree)
        if not norm:
            return tree
        n[0] += 1
        return jnp.asarray(1.0 + NORM_STD * rng.normal(size=tree.shape),
                           tree.dtype)
    out = fill(jtree)
    assert n[0], "no norm scale"
    return out


def _close(ours, theirs, dtype="float32"):
    theirs = np.asarray(theirs, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(_np(ours), theirs, atol=TOL)
    else:
        err = np.abs(_np(ours) - theirs).max()
        assert err <= BF16_REL * np.abs(theirs).max(), err


@contextlib.contextmanager
def _routes():
    """While entered, record for every token the port routes the gap
    between its K-th and (K+1)-th router probabilities, and count the
    (token, k) pairs dropped at capacity."""
    log = {"gaps": [], "dropped": 0}
    route, slots = t_moe._route, t_moe._capacity_slots

    def gapped(params, x, cfg):
        probs, gates, idx = route(params, x, cfg)
        top = torch.topk(probs, min(cfg.top_k + 1, cfg.n_experts), -1)[0]
        log["gaps"].append((top[..., -2] - top[..., -1]).flatten())
        return probs, gates, idx

    def counted(idx, E, C):
        out = slots(idx, E, C)
        log["dropped"] += int((~out[1]).sum())
        return out
    t_moe._route, t_moe._capacity_slots = gapped, counted
    try:
        yield log
    finally:
        t_moe._route, t_moe._capacity_slots = route, slots


def _no_near_ties(log):
    assert log["gaps"]
    gap = torch.cat(log["gaps"])
    assert int((gap < NEAR_TIE).sum()) == 0, \
        f"{int((gap < NEAR_TIE).sum())} near-tie routes: pick another seed"


# ------------------------------------------------------------------ config
def test_config_is_the_reference():
    full_j, full_t = j_ds.CONFIG, t_ds.CONFIG
    assert asdict(full_t) == asdict(full_j)
    assert asdict(t_ds.SMOKE) == asdict(j_ds.SMOKE)
    assert (full_t.n_layers, full_t.d_model, full_t.nq, full_t.q_lora_rank,
            full_t.kv_lora_rank, full_t.qk_nope_head_dim,
            full_t.qk_rope_head_dim, full_t.v_head_dim, full_t.n_experts,
            full_t.top_k, full_t.n_shared_experts, full_t.expert_d_ff,
            full_t.first_k_dense, full_t.vocab, full_t.tie_embeddings) == (
        60, 5120, 128, 1536, 512, 128, 64, 128, 160, 6, 2, 1536, 1, 102400,
        False)
    # head_dim 0: hd and nq as the reference reads them
    for j, t in ((full_j, full_t), (j_ds.SMOKE, t_ds.SMOKE)):
        assert t.head_dim == 0 and (t.hd, t.nq, t.nkv) == (j.hd, j.nq, j.nkv)
    assert [(s.n_repeat, s.pattern) for s in layer_plan(full_t)] == [
        (1, ("dense",)), (59, ("moe",))]
    assert registry.get_config("deepseek-v2-236b") is t_ds.CONFIG
    assert registry.get_config("deepseek-v2-236b", smoke=True) is t_ds.SMOKE


# -------------------------------------------------------------- one layer
def _layer(seed, jcfg):
    jp = _bumped(j_attn.init_mla(jax.random.PRNGKey(seed), jcfg), seed)
    return jp, _torch(jp)


def _cast(x, dtype):
    return jnp.asarray(x, dtype), torch.from_numpy(x).to(getattr(torch, dtype))


def test_mla_init_is_the_reference_layout():
    jcfg, tcfg = _configs(**UNEVEN)
    jp = j_attn.init_mla(jax.random.PRNGKey(0), jcfg)
    tp = t_attn.init_mla(torch.Generator().manual_seed(0), tcfg, lead=(3,))
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tflat = jax.tree_util.tree_flatten_with_path(
        convert.tree_map(_np, tp))[0]
    assert [p for p, _ in jflat] == [p for p, _ in tflat]
    for (_, a), (_, t) in zip(jflat, tflat):
        assert t.shape == (3,) + a.shape and t.dtype == a.dtype
    H = jcfg.nq
    assert tp["w_uq"].shape == (3, 40, H, 16 + 8)
    assert tp["w_uk"].shape == (3, 24, H, 16)
    assert tp["w_uv"].shape == (3, 24, H, 12)
    assert tp["wo"].shape == (3, H, 12, 64)
    assert bool((tp["q_norm"]["scale"] == 1).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("widths", ["smoke", "uneven"])
def test_mla_projections_and_forward_match_jax(widths, dtype):
    """``_mla_q``, ``_mla_latent`` and ``mla_forward`` at RoPE positions
    that do not start at 0."""
    jcfg, tcfg = _configs(compute_dtype=dtype,
                          **(UNEVEN if widths == "uneven" else {}))
    jp, tp = _layer(1, jcfg)
    B, S = 2, 12
    xj, xt = _cast(_x(1, B, S, jcfg.d_model), dtype)
    pos = _pos(B, S, start=5)
    jq = j_attn._mla_q(jp, xj, jcfg, jnp.asarray(pos))
    tq = t_attn._mla_q(tp, xt, tcfg, torch.from_numpy(pos))
    jl = j_attn._mla_latent(jp, xj, jcfg, jnp.asarray(pos))
    tl = t_attn._mla_latent(tp, xt, tcfg, torch.from_numpy(pos))
    for a, b in zip(tq + tl, jq + jl):
        assert a.shape == b.shape and a.dtype == xt.dtype
        _close(a, b, dtype)
    jy = j_attn.mla_forward(jp, xj, jcfg, jnp.asarray(pos))
    y = t_attn.mla_forward(tp, xt, tcfg, torch.from_numpy(pos))
    assert y.shape == xt.shape and y.dtype == xt.dtype
    _close(y, jy, dtype)
    # each norm reaches the output
    for name in ("q_norm", "kv_norm"):
        ones = dict(tp, **{name: {"scale": torch.ones_like(
            tp[name]["scale"])}})
        assert not torch.allclose(t_attn.mla_forward(
            ones, xt, tcfg, torch.from_numpy(pos)), y)


@pytest.mark.parametrize("chunk,S", [(8, 20), (8, 16), (32, 20)])
@pytest.mark.parametrize("one_head", [False, True])
def test_mla_latent_chunked_matches_jax(monkeypatch, chunk, S, one_head):
    """Chunks that do not divide S (the padded tail masked), that do, and
    one chunk over the whole prompt; with ``one_head`` the port's head
    groups are single heads."""
    jcfg, tcfg = _configs(**UNEVEN)
    jp, tp = _layer(2, jcfg)
    if one_head:
        monkeypatch.setattr(t_attn, "MLA_LOGITS_BYTES", 1)
    B = 2
    x = _x(2, B, S, jcfg.d_model)
    pos = _pos(B, S)
    jq = j_attn._mla_q(jp, jnp.asarray(x), jcfg, jnp.asarray(pos))
    jl = j_attn._mla_latent(jp, jnp.asarray(x), jcfg, jnp.asarray(pos))
    jy = j_attn.mla_latent_chunked(*jq, *jl, jp["w_uk"], jp["w_uv"],
                                   jp["wo"], jcfg, chunk=chunk)
    args = [torch.from_numpy(np.array(a)) for a in jq + jl]
    y = t_attn.mla_latent_chunked(*args, tp["w_uk"], tp["w_uv"], tp["wo"],
                                  tcfg, chunk=chunk)
    _close(y, jy)
    # the latent scan computes the expanded attention's function
    _close(y, j_attn.mla_forward(jp, jnp.asarray(x), jcfg, jnp.asarray(pos)))


def _prefill(jcfg, tcfg, jp, tp, B, S, s_cache, seed, dtype="float32"):
    xj, xt = _cast(_x(seed, B, S, jcfg.d_model), dtype)
    pos = _pos(B, S)
    jc = j_attn.init_mla_cache(jcfg, B, s_cache)
    tc = t_attn.init_mla_cache(tcfg, B, s_cache, device="cpu")
    jy, jc = j_attn.mla_prefill(jp, xj, jcfg, jnp.asarray(pos), jc)
    y, tc = t_attn.mla_prefill(tp, xt, tcfg, torch.from_numpy(pos), tc)
    return (jy, jc), (y, tc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_prefill_and_cache_match_jax(dtype):
    """A 20-token prompt in chunks of 8 into a cache of 26: the output, and
    the latents in the first 20 slots, zeros after them."""
    jcfg, tcfg = _configs(compute_dtype=dtype, attn_chunk=8, **UNEVEN)
    jp, tp = _layer(3, jcfg)
    (jy, jc), (y, c) = _prefill(jcfg, tcfg, jp, tp, 2, 20, 26, 3, dtype)
    _close(y, jy, dtype)
    assert set(c) == {"ckv", "kr"}
    assert c["ckv"].shape == (2, 26, 24) and c["kr"].shape == (2, 26, 8)
    for name in c:
        assert c[name].dtype == getattr(torch, dtype)
        _close(c[name], jc[name], dtype)
        assert not c[name][:, 20:].any() and c[name][:, :20].any()
    with pytest.raises(ValueError, match="exceeds"):
        t_attn.mla_prefill(tp, torch.zeros(1, 5, 64, dtype=c["kr"].dtype),
                           tcfg, torch.from_numpy(_pos(1, 5)),
                           t_attn.init_mla_cache(tcfg, 1, 4, device="cpu"))


def test_mla_decode_per_row_matches_vmapped_jax():
    """Three decode steps, each row at its own index (one past the
    cache's end, where the write lands in the last slot), as the
    reference's engine vmaps its one-row decode; the scalar index too."""
    jcfg, tcfg = _configs(**UNEVEN)
    jp, tp = _layer(4, jcfg)
    B, size = 4, 24
    (_, jc), (_, c) = _prefill(jcfg, tcfg, jp, tp, B, 16, size, 4)

    def one(xr, pr, cache_row, i):
        cache = jax.tree.map(lambda a: a[None], cache_row)
        y, cache = j_attn.mla_decode(jp, xr[None], jcfg, pr[None], cache, i)
        return y[0], jax.tree.map(lambda a: a[0], cache)
    idx = np.array([3, 16, 9, size - 1])
    jdecode = jax.jit(jax.vmap(one))
    for step in range(3):
        x = _x(10 + step, B, 1, jcfg.d_model)
        pos = (idx + step)[:, None]
        jy, jc = jdecode(jnp.asarray(x), jnp.asarray(pos), jc,
                         jnp.asarray(idx + step))
        ti = torch.from_numpy(idx + step)
        y, c = t_attn.mla_decode(tp, torch.from_numpy(x), tcfg,
                                 torch.from_numpy(pos), c, ti)
        _close(y, jy)
        for name in ("ckv", "kr"):
            assert c[name].shape == (B, size, jc[name].shape[-1])
            _close(c[name], jc[name])
    x = _x(20, B, 1, jcfg.d_model)
    jy, _ = j_attn.mla_decode(jp, jnp.asarray(x), jcfg,
                              jnp.full((B, 1), 7), jc, 7)
    y, _ = t_attn.mla_decode(tp, torch.from_numpy(x), tcfg,
                             torch.full((B, 1), 7), c, 7)
    _close(y, jy)


@pytest.mark.parametrize("widths", ["smoke", "uneven"])
def test_absorbed_decode_is_the_expanded_forward(widths):
    """The absorbed decode of the last prompt position, from the cache of
    the positions before it, against ``mla_forward``'s output for that
    row: one function computed two ways."""
    jcfg, tcfg = _configs(**(UNEVEN if widths == "uneven" else {}))
    _, tp = _layer(5, jcfg)
    B, P = 2, 14
    x = torch.from_numpy(_x(5, B, P, jcfg.d_model))
    pos = torch.from_numpy(_pos(B, P))
    full = t_attn.mla_forward(tp, x, tcfg, pos)
    cache = t_attn.init_mla_cache(tcfg, B, P, device="cpu")
    _, cache = t_attn.mla_prefill(tp, x[:, :-1], tcfg, pos[:, :-1], cache)
    y, _ = t_attn.mla_decode(tp, x[:, -1:], tcfg, pos[:, -1:], cache, P - 1)
    np.testing.assert_allclose(_np(y[:, 0]), _np(full[:, -1]), atol=TOL)


# ------------------------------------------------------------------- model
@pytest.fixture(scope="module")
def models():
    out = {}
    for i, (name, kw) in enumerate(MODELS.items()):
        jcfg, tcfg = _configs(**kw)
        jp = _bumped(jt.init(jax.random.PRNGKey(10 + i), jcfg), 10 + i)
        out[name] = (jcfg, tcfg, jp, convert.from_jax(
            jax.tree.map(np.asarray, jp), device="cpu"))
    return out


@pytest.mark.parametrize("name", list(MODELS))
def test_forward_and_loss_match_jax(models, name):
    """``forward``'s logits and aux loss; ``loss_fn`` and every leaf's
    gradient (MLA's through autograd on the plain path). The top-6 variant
    drops (token, k) pairs at capacity."""
    jcfg, tcfg, jp, tp = models[name]
    toks, pos = _tokens(jcfg, 2, 24, seed=2), _pos(2, 24)
    with torch.inference_mode(), _routes() as log:
        logits, aux = tt.forward(tp, tcfg, torch.from_numpy(toks),
                                 torch.from_numpy(pos))
    _no_near_ties(log)
    if name == "top6":
        assert log["dropped"] > 0
    jl, jaux = jt.forward(jp, jcfg, jnp.asarray(toks), jnp.asarray(pos))
    assert logits.shape == (2, 24, jcfg.vocab)
    np.testing.assert_allclose(_np(logits), np.asarray(jl), atol=TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=AUX_RTOL)
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    (jloss, jm), jg = jax.jit(jax.value_and_grad(jt.loss_fn, has_aux=True),
                              static_argnums=1)(
        jp, jcfg, jax.tree.map(jnp.asarray, batch))
    with _routes() as log:
        (loss, metrics), grads = value_and_grad(
            tt.loss_fn, tp, tcfg, {k: torch.from_numpy(v) for k, v in
                                   batch.items()}, has_aux=True)
    _no_near_ties(log)
    np.testing.assert_allclose(float(loss), float(jloss), atol=TOL)
    np.testing.assert_allclose(float(metrics["aux"]), float(jm["aux"]),
                               rtol=AUX_RTOL)
    ours = jax.tree_util.tree_flatten_with_path(
        convert.tree_map(_np, grads))[0]
    theirs = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert [p for p, _ in ours] == [p for p, _ in theirs]
    for (path, a), (_, b) in zip(ours, theirs):
        np.testing.assert_allclose(a, np.asarray(b), atol=TOL,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name", list(MODELS))
def test_prefill_and_decode_match_jax(models, name):
    """A 21-token prompt into a cache of 21 + 8, in kv chunks of 8, then
    8 greedy decode steps: logits at every step and the latent caches at
    the end."""
    jcfg, tcfg, jp, tp = models[name]
    jcfg, tcfg = jcfg.replace(attn_chunk=8), tcfg.replace(attn_chunk=8)
    B, P = 3, 21
    toks = _tokens(jcfg, B, P, seed=5)
    with torch.inference_mode(), _routes() as log:
        lg, cache = tt.prefill(tp, tcfg, torch.from_numpy(toks),
                               torch.from_numpy(_pos(B, P)),
                               s_cache=P + DECODE_STEPS)
        jlg, jcache = jt.prefill(jp, jcfg, jnp.asarray(toks),
                                 jnp.asarray(_pos(B, P)),
                                 s_cache=P + DECODE_STEPS)
        np.testing.assert_allclose(_np(lg), np.asarray(jlg), atol=TOL)
        tok = lg.argmax(-1, keepdim=True)
        jdecode = jax.jit(jt.decode_step, static_argnums=1)
        for i in range(P, P + DECODE_STEPS):
            lg, cache = tt.decode_step(tp, tcfg, tok,
                                       torch.from_numpy(_pos(B, 1, i)),
                                       cache, i)
            jlg, jcache = jdecode(jp, jcfg, jnp.asarray(tok.numpy()),
                                         jnp.asarray(_pos(B, 1, i)), jcache,
                                         jnp.asarray(i))
            np.testing.assert_allclose(_np(lg), np.asarray(jlg), atol=TOL)
            tok = lg.argmax(-1, keepdim=True)
    _no_near_ties(log)
    ours = jax.tree_util.tree_flatten_with_path(
        convert.tree_map(_np, cache))[0]
    theirs = jax.tree_util.tree_flatten_with_path(jcache)[0]
    assert [p for p, _ in ours] == [p for p, _ in theirs]
    assert len(ours) == 2 * len(layer_plan(tcfg))
    for (path, a), (_, b) in zip(ours, theirs):
        assert a.shape[1:3] == (B, P + DECODE_STEPS), path
        np.testing.assert_allclose(a, np.asarray(b), atol=TOL)


def _record(eng, log):
    """Keep the logits of every decode call the engine makes."""
    inner = eng._decode

    def decode(*args):
        logits, cache = inner(*args)
        log.append(np.asarray(logits, np.float32))
        return logits, cache
    eng._decode = decode


@pytest.mark.parametrize("name", list(MODELS))
def test_engine_tokens_match_jax(models, name):
    """Batch 3, s_max 32, five requests of ragged prompts (1-7 tokens) and
    budgets, so slots run at different indices in one decode call: the
    latent caches move through the slots as the reference's."""
    jcfg, tcfg, jp, tp = models[name]
    jeng = JServeEngine(jcfg, jp, batch=3, s_max=32)
    teng = ServeEngine(tcfg, tp, batch=3, s_max=32, device="cpu")
    assert set(teng.cache["segments"][0]["b0"]) == {"ckv", "kr"}
    jlog, tlog = [], []
    _record(jeng, jlog)
    _record(teng, tlog)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, jcfg.vocab, k)]
               for k in rng.integers(1, 8, 5)]
    for eng, make in ((jeng, JRequest), (teng, Request)):
        for rid, prompt in enumerate(prompts):
            eng.add_request(make(rid=rid, prompt=prompt, max_new=4 + rid))
    with torch.inference_mode(), _routes() as log:
        tdone = teng.run()
    _no_near_ties(log)
    jdone = jeng.run()
    assert [r.rid for r in tdone] == [r.rid for r in jdone] == list(range(5))
    assert len(tlog) == len(jlog) > 20
    for j_logits, t_logits in zip(jlog, tlog):
        np.testing.assert_allclose(t_logits, j_logits, atol=TOL)
        top2 = np.sort(j_logits, axis=-1)[:, -2:]
        assert not (top2[:, 1] - top2[:, 0] < TOL).any(), \
            "a near-tie: pick another seed"
    assert [r.out for r in tdone] == [r.out for r in jdone]


def test_launcher_serves_deepseek_v2(capsys):
    out = t_launch.main(["--arch", "deepseek-v2-236b", "--smoke", "--device",
                         "cpu", "--requests", "2", "--max-new", "4"])
    assert out["arch"] == "deepseek-v2-236b" and out["device"] == "cpu"
    assert out["done"] == out["requests"] == 2 and out["tokens"] == 8
    assert "2/2 requests done" in capsys.readouterr().out


# ---------------------------------------------------------------- convert
def test_converted_tree_is_the_reference_layout(models):
    """JAX's full DeepSeek-V2 tree (shapes only) holds the MLA leaves at
    their published widths; the converted SMOKE tree and the port's own
    init have JAX's leaves, shapes and order, and the round trip is
    exact."""
    full = jax.eval_shape(lambda k: jt.init(k, j_ds.CONFIG),
                          jax.random.PRNGKey(0))
    dense, moe = (full["segments"][i]["b0"] for i in (0, 1))
    L, d, H = 59, 5120, 128
    a = moe["attn"]
    assert a["w_dq"].shape == (L, d, 1536)
    assert a["q_norm"]["scale"].shape == (L, 1536)
    assert a["w_uq"].shape == (L, 1536, H, 192)
    assert a["w_dkv"].shape == (L, d, 512)
    assert a["kv_norm"]["scale"].shape == (L, 512)
    assert a["w_kr"].shape == (L, d, 64)
    assert a["w_uk"].shape == (L, 512, H, 128)
    assert a["w_uv"].shape == (L, 512, H, 128)
    assert a["wo"].shape == (L, H, 128, d)
    assert moe["ffn"]["experts"]["wi"].shape == (L, 160, d, 2, 1536)
    assert moe["ffn"]["shared"]["wi"].shape == (L, 2, d, 2, 1536)
    assert dense["attn"]["wo"].shape == (1, H, 128, d)
    assert dense["ffn"]["wi"].shape == (1, d, 2, 1536)   # shared_d_ff
    assert full["head"].shape == (d, 102400)
    jcfg, tcfg, jp, tp = models["smoke"]
    own = tt.init(torch.Generator().manual_seed(0), tcfg)
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
