"""The port's Qwen1.5-4B against the JAX package's, on the CPU.

Qwen1.5-4B is a dense LM of 40 layers, d 2560, 20 heads of 128 with as many
kv heads (MHA), d_ff 6912, vocabulary 151,936, QKV bias and RoPE at theta
5e6. Its one feature beyond TinyLlama's, the QKV bias, came with
Qwen1.5-MoE-A2.7B. ``SMOKE`` (2 layers, d 64, 4 heads of 16 over 4 kv
heads, fp32) runs with nonzero QKV biases (the reference initialises them
to zero, so each test writes N(0, 0.5) draws into the JAX tree first, then
converts it), under both ``attn_impl`` settings (``"flash"``: JAX's Pallas
kernel in interpret mode, the port's plain version): ``forward``,
``loss_fn`` and every leaf's gradient, a prefill and 8 decode steps,
``ServeEngine``'s tokens against JAX's engine, and both launchers at
``--smoke``. The full config is the reference's but for ``attn_impl``.

Tolerances: fp32 1e-4 (the model tests' bound). Greedy tokens are compared
while every decode call's logits agree within 1e-4 and no row's top-2 gap
falls under it (tests/test_torch_lm_serve.py's rule).
"""
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import qwen1_5_4b as j_qwen
from repro.models import transformer as jt
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch import convert
from repro_torch.configs import qwen1_5_4b as t_qwen
from repro_torch.launch import serve as t_serve_launch
from repro_torch.launch import train as t_train_launch
from repro_torch.models import registry
from repro_torch.models import transformer as tt
from repro_torch.serve import Request, ServeEngine
from repro_torch.train.step import value_and_grad

TOL = 1e-4
DECODE_STEPS = 8
BIASES = ("bq", "bk", "bv")


def _np(t):
    return t.detach().float().numpy()


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


def _pos(B, S, start=0):
    return np.broadcast_to(np.arange(start, start + S)[None], (B, S)).copy()


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


def _configs(attn_impl="reference"):
    return (j_qwen.SMOKE.replace(attn_impl=attn_impl),
            t_qwen.SMOKE.replace(attn_impl=attn_impl))


@pytest.fixture(scope="module")
def model():
    jp = _with_bias(jt.init(jax.random.PRNGKey(0), j_qwen.SMOKE))
    return jp, convert.from_jax(jax.tree.map(np.asarray, jp), device="cpu")


# ------------------------------------------------------------------ config
def test_config_is_the_reference_but_flash():
    full_j, full_t = j_qwen.CONFIG, t_qwen.CONFIG
    assert asdict(full_t) == asdict(full_j.replace(attn_impl="flash"))
    assert (full_t.n_layers, full_t.d_model, full_t.nq, full_t.nkv,
            full_t.hd, full_t.d_ff, full_t.vocab, full_t.qkv_bias,
            full_t.rope_theta) == (40, 2560, 20, 20, 128, 6912, 151_936,
                                   True, 5e6)
    assert asdict(t_qwen.SMOKE) == asdict(j_qwen.SMOKE)
    assert t_qwen.SMOKE.attn_impl == "reference"
    assert registry.get_config("qwen1.5-4b") is t_qwen.CONFIG
    assert registry.get_config("qwen1.5-4b", smoke=True) is t_qwen.SMOKE


def test_full_tree_is_the_reference_layout():
    """JAX's full tree (shapes only): 3.95 B parameters, the QKV biases a
    (40, 20, 128) leaf each; the port's own init at 2 layers of the full
    widths has its leaves, shapes and order."""
    full = jax.eval_shape(lambda k: jt.init(k, j_qwen.CONFIG),
                          jax.random.PRNGKey(0))
    n = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(full))
    assert n == 3_950_369_280
    attn = full["segments"][0]["b0"]["attn"]
    for name in BIASES:
        assert attn[name].shape == (40, 20, 128)
    assert attn["wq"].shape == attn["wk"].shape == (40, 2560, 20, 128)
    assert full["head"].shape == (2560, 151_936)
    cut = t_qwen.CONFIG.replace(n_layers=2, vocab_size=512)
    jcut = jax.eval_shape(lambda k: jt.init(k, j_qwen.CONFIG.replace(
        n_layers=2, vocab_size=512)), jax.random.PRNGKey(0))
    own = tt.init(torch.Generator().manual_seed(0), cut)
    jflat = jax.tree_util.tree_flatten_with_path(jcut)[0]
    flat = jax.tree_util.tree_flatten_with_path(
        convert.tree_map(lambda t: np.zeros(t.shape), own))[0]
    assert [p for p, _ in flat] == [p for p, _ in jflat]
    assert [a.shape for _, a in flat] == [a.shape for _, a in jflat]


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
    # the biases reach the output
    zero = convert.tree_map(lambda t: t, tp)
    attn = zero["segments"][0]["b0"]["attn"]
    for name in BIASES:
        attn[name] = torch.zeros_like(attn[name])
    with torch.inference_mode():
        unbiased, _ = tt.forward(zero, tcfg, torch.from_numpy(toks),
                                 torch.from_numpy(pos))
    assert float((unbiased - logits).abs().max()) > 1e2 * TOL


@pytest.mark.parametrize("attn_impl", ["reference", "flash"])
def test_loss_and_grads_match_jax(model, attn_impl):
    """The training loss and every leaf's gradient, the biases' among
    them (JAX's Pallas kernel has no VJP: its side runs ``"reference"``)."""
    jcfg, tcfg = _configs(attn_impl)
    jp, tp = model
    toks = _tokens(jcfg, 2, 17, seed=4)
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    (jl, _), jg = jax.value_and_grad(jt.loss_fn, has_aux=True)(
        jp, jcfg.replace(attn_impl="reference"),
        jax.tree.map(jnp.asarray, batch))
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
    assert float(bq.abs().max()) > 1e2 * TOL


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
    budgets, so slots run at different indices in one decode call."""
    jcfg, tcfg = _configs(attn_impl)
    jp, tp = model
    jeng = JServeEngine(jcfg, jp, batch=3, s_max=32)
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


# ---------------------------------------------------------------- launchers
def test_launchers_run_qwen1_5_4b(tmp_path, capsys):
    out = t_serve_launch.main(["--arch", "qwen1.5-4b", "--smoke", "--device",
                               "cpu", "--requests", "2", "--max-new", "4"])
    assert out["arch"] == "qwen1.5-4b"
    assert out["done"] == out["requests"] == 2 and out["tokens"] == 8
    args = ["--arch", "qwen1.5-4b", "--smoke", "--device", "cpu", "--steps",
            "2", "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path)]
    first = t_train_launch.main(args)
    second = t_train_launch.main(args)
    assert "resumed at step 2" in capsys.readouterr().out
    assert first["arch"] == "qwen1.5-4b" and second["steps_done"] == 4
    assert np.isfinite(first["losses"] + second["losses"]).all()
