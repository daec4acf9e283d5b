"""The port's Command-R 35B against the JAX package's, on the CPU.

Command-R 35B is a dense LM of 40 layers, d 8192, 64 heads over 8 kv heads
of 128, d_ff 22,528, vocabulary 256,000, LayerNorm (eps 1e-5), tied
embeddings, RoPE at theta 8e6 and the parallel block: one ``ln1`` feeds
attention and the MLP, and ``x + (a + f)`` comes out. The tree keeps the
reference's unused ``ln2``, whose gradient is zero on both sides (JAX's
autodiff gives zeros; the port's ``value_and_grad`` gives zeros for a leaf
the loss does not reach). ``SMOKE`` (2 layers, d 64, 4 heads of 16 over 2
kv heads, fp32) runs with every LayerNorm scale and bias drawn (the
reference inits them to ones and zeros) under both ``attn_impl`` settings
(``"flash"``: JAX's Pallas kernel in interpret mode, the port's plain
version): ``forward``, ``loss_fn`` and every leaf's gradient, a prefill and
8 decode steps, ``ServeEngine``'s tokens against JAX's engine (attention
caches: the port's slot repair leaves the tokens as they were), and both
launchers at ``--smoke``. The full config is the reference's but for
``attn_impl``.

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

from repro.configs import command_r_35b as j_cr
from repro.models import transformer as jt
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch import convert
from repro_torch.configs import command_r_35b as t_cr
from repro_torch.launch import serve as t_serve_launch
from repro_torch.launch import train as t_train_launch
from repro_torch.models import registry
from repro_torch.models import transformer as tt
from repro_torch.serve import Request, ServeEngine
from repro_torch.train.step import value_and_grad

TOL = 1e-4
DECODE_STEPS = 8


def _np(t):
    return t.detach().float().numpy()


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


def _pos(B, S, start=0):
    return np.broadcast_to(np.arange(start, start + S)[None], (B, S)).copy()


def _draw_norms(jp, seed=0):
    """The JAX tree with every LayerNorm scale N(1, 0.3) and bias N(0, 0.3)
    draws."""
    rng = np.random.default_rng(seed)

    def fill(tree, key=None):
        if isinstance(tree, dict):
            return {k: fill(v, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(fill(v) for v in tree)
        if key in ("scale", "bias"):
            return jnp.asarray((key == "scale") + 0.3 * rng.normal(
                size=tree.shape), tree.dtype)
        return tree
    return fill(jp)


def _configs(attn_impl="reference"):
    return (j_cr.SMOKE.replace(attn_impl=attn_impl),
            t_cr.SMOKE.replace(attn_impl=attn_impl))


@pytest.fixture(scope="module")
def model():
    jp = _draw_norms(jt.init(jax.random.PRNGKey(0), j_cr.SMOKE))
    return jp, convert.from_jax(jax.tree.map(np.asarray, jp), device="cpu")


# ------------------------------------------------------------------ config
def test_config_is_the_reference_but_flash():
    full_j, full_t = j_cr.CONFIG, t_cr.CONFIG
    assert asdict(full_t) == asdict(full_j.replace(attn_impl="flash"))
    assert (full_t.n_layers, full_t.d_model, full_t.nq, full_t.nkv,
            full_t.hd, full_t.d_ff, full_t.vocab, full_t.norm_style,
            full_t.norm_eps, full_t.tie_embeddings, full_t.parallel_block,
            full_t.rope_theta) == (40, 8192, 64, 8, 128, 22528, 256_000,
                                   "layer", 1e-5, True, True, 8e6)
    assert asdict(t_cr.SMOKE) == asdict(j_cr.SMOKE)
    assert t_cr.SMOKE.attn_impl == "reference"
    assert registry.get_config("command-r-35b") is t_cr.CONFIG
    assert registry.get_config("command-r-35b", smoke=True) is t_cr.SMOKE


def test_full_tree_is_the_reference_layout():
    """JAX's full tree (shapes only): 30,284,201,984 parameters, no head
    (tied), LayerNorm scales and biases, the unused ln2 kept. The port's
    own init at the full widths, cut to one layer, a vocabulary of 512 and
    an MLP of 256, has JAX's leaves, shapes and order at the same cut."""
    full = jax.eval_shape(lambda k: jt.init(k, j_cr.CONFIG),
                          jax.random.PRNGKey(0))
    n = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(full))
    assert n == 30_284_201_984
    assert "head" not in full
    layer = full["segments"][0]["b0"]
    assert layer["attn"]["wq"].shape == (40, 8192, 64, 128)
    assert layer["attn"]["wk"].shape == (40, 8192, 8, 128)
    assert layer["ln2"]["bias"].shape == (40, 8192)
    cut = dict(n_layers=1, vocab_size=512, d_ff=256)
    jcut = jax.eval_shape(lambda k: jt.init(k, j_cr.CONFIG.replace(**cut)),
                          jax.random.PRNGKey(0))
    own = tt.init(torch.Generator().manual_seed(0),
                  t_cr.CONFIG.replace(**cut))
    jflat = jax.tree_util.tree_flatten_with_path(jcut)[0]
    flat = jax.tree_util.tree_flatten_with_path(
        convert.tree_map(lambda t: np.zeros(t.shape, np.int8), own))[0]
    assert [p for p, _ in flat] == [p for p, _ in jflat]
    assert [a.shape for _, a in flat] == [a.shape for _, a in jflat]


# ------------------------------------------------------------------- model
@pytest.mark.parametrize("attn_impl", ["reference", "flash"])
def test_forward_matches_jax(model, attn_impl):
    """The logits, and the parallel block's form: zeroing ln2 changes
    nothing, as one norm feeds both branches."""
    jcfg, tcfg = _configs(attn_impl)
    jp, tp = model
    toks, pos = _tokens(jcfg, 2, 24, seed=2), _pos(2, 24)
    with torch.inference_mode():
        logits, aux = tt.forward(tp, tcfg, torch.from_numpy(toks),
                                 torch.from_numpy(pos))
    jl, _ = jt.forward(jp, jcfg, jnp.asarray(toks), jnp.asarray(pos))
    assert logits.shape == (2, 24, jcfg.vocab) and float(aux) == 0.0
    np.testing.assert_allclose(_np(logits), np.asarray(jl), atol=TOL)
    other = convert.tree_map(lambda t: t, tp)
    ln2 = other["segments"][0]["b0"]["ln2"]
    for k in ln2:
        ln2[k] = torch.zeros_like(ln2[k])
    with torch.inference_mode():
        same, _ = tt.forward(other, tcfg, torch.from_numpy(toks),
                             torch.from_numpy(pos))
    torch.testing.assert_close(same, logits, rtol=0, atol=0)


@pytest.mark.parametrize("attn_impl", ["reference", "flash"])
def test_loss_and_grads_match_jax(model, attn_impl):
    """The training loss and every leaf's gradient, ln2's zero on both
    sides (JAX's Pallas kernel has no VJP: its side runs
    ``"reference"``)."""
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
    assert len(ours[0]) == len(theirs) == 13
    for (pa, a), (pb, b) in zip(ours[0], theirs):
        assert pa == pb
        np.testing.assert_allclose(a, np.asarray(b), atol=TOL,
                                   err_msg=jax.tree_util.keystr(pa))
    layer, jlayer = grads["segments"][0]["b0"], jg["segments"][0]["b0"]
    for k in ("scale", "bias"):
        assert not layer["ln2"][k].any() and not np.asarray(
            jlayer["ln2"][k]).any()
        assert float(layer["ln1"][k].abs().max()) > 1e2 * TOL


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
    budgets, so slots are refilled and run at different indices in one
    decode call; JAX's engine as it is (stale attention rows are masked
    by the length, so the port's slot repair changes no token here)."""
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
def test_launchers_run_command_r(tmp_path, capsys):
    out = t_serve_launch.main(["--arch", "command-r-35b", "--smoke",
                               "--device", "cpu", "--requests", "2",
                               "--max-new", "4"])
    assert out["arch"] == "command-r-35b"
    assert out["done"] == out["requests"] == 2 and out["tokens"] == 8
    args = ["--arch", "command-r-35b", "--smoke", "--device", "cpu",
            "--steps", "2", "--batch", "2", "--seq", "16", "--ckpt-dir",
            str(tmp_path)]
    first = t_train_launch.main(args)
    second = t_train_launch.main(args)
    assert "resumed at step 2" in capsys.readouterr().out
    assert first["arch"] == "command-r-35b" and second["steps_done"] == 4
    assert np.isfinite(first["losses"] + second["losses"]).all()
