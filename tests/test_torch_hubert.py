"""The port's HuBERT X-Large against the JAX package's, on the CPU.

HuBERT X-Large is an encoder of 48 bidirectional layers, d 1280, 16 heads
of 80, d_ff 5120 (GELU, ungated), LayerNorm, vocabulary 504 (the masked-unit
targets), fed precomputed frame embeddings (``embed_inputs=False``). Its
config is the reference's but ``attn_impl="flash"``: the flash kernel's
Hopper form runs its heads of 80 (``SMOKE`` keeps ``"reference"``). Held
here, on weights drawn in JAX and
converted, every LayerNorm scale and bias first drawn away from the
init's 1 and 0 (so a misplaced norm shows), at two sizes: ``SMOKE`` (2
layers, d 64, 4 heads of 16) and a variant with the published head dim,
2 heads of 80 over d 160, which ``SMOKE``'s 16 hides:

* ``forward`` on frames, ``loss_fn`` and every leaf's gradient, and the
  same under ``attn_impl="flash"`` (the flash wrapper's plain version on
  the CPU) against JAX's ``"reference"`` model;
* bidirectional attention: a change to the last frame moves the first
  frame's logits (in both packages, by the same amount);
* ``ServeEngine`` refuses the encoder, as the reference's does, and so the
  serve launcher; the train launcher trains it on frames and resumes.

Tolerance: fp32 1e-4 (the model tests' bound).
"""
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import hubert_xlarge as j_hub
from repro.data import DataConfig as JDataConfig
from repro.data import synth_batch as j_synth_batch
from repro.models import transformer as jt
from repro.serve import ServeEngine as JServeEngine
from repro_torch import convert
from repro_torch.configs import hubert_xlarge as t_hub
from repro_torch.data import DataConfig, synth_batch
from repro_torch.launch import serve as t_serve_launch
from repro_torch.launch import train as t_train_launch
from repro_torch.models import registry
from repro_torch.models import transformer as tt
from repro_torch.serve import ServeEngine
from repro_torch.train.step import value_and_grad

TOL = 1e-4
# the published head dim, 1280 / 16 = 80, at two heads
WIDE = dict(d_model=160, n_heads=2, n_kv_heads=2, head_dim=0)
SIZES = {"smoke": {}, "heads_of_80": WIDE}


def _np(t):
    return t.detach().float().numpy()


def _pos(B, S):
    return np.broadcast_to(np.arange(S)[None], (B, S)).copy()


def _frames(cfg, B, S, seed=0):
    return np.random.default_rng(seed).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)


def _drawn_norms(jp, seed=0):
    """The JAX tree with every LayerNorm scale drawn N(1, 0.3) and bias
    N(0, 0.3): the reference inits them 1 and 0."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = str(path[-1])
        if name == "['scale']":
            return jnp.asarray(1 + 0.3 * rng.normal(size=a.shape), a.dtype)
        if name == "['bias']":
            return jnp.asarray(0.3 * rng.normal(size=a.shape), a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(draw, jp)


def _configs(size):
    return j_hub.SMOKE.replace(**SIZES[size]), t_hub.SMOKE.replace(
        **SIZES[size])


@pytest.fixture(scope="module")
def models():
    out = {}
    for size in SIZES:
        jcfg, _ = _configs(size)
        jp = _drawn_norms(jt.init(jax.random.PRNGKey(0), jcfg))
        out[size] = jp, convert.from_jax(jax.tree.map(np.asarray, jp),
                                         device="cpu")
    return out


# ------------------------------------------------------------------ config
def test_config_is_the_reference():
    """The reference's config but ``attn_impl="flash"`` (its heads of 80 on
    the flash kernel); ``SMOKE`` is the reference's, ``"reference"``."""
    full = t_hub.CONFIG
    assert j_hub.CONFIG.attn_impl == "reference"
    assert asdict(full) == asdict(j_hub.CONFIG.replace(attn_impl="flash"))
    assert asdict(t_hub.SMOKE) == asdict(j_hub.SMOKE)
    assert t_hub.SMOKE.attn_impl == "reference"
    assert (full.n_layers, full.d_model, full.nq, full.nkv, full.hd,
            full.d_ff, full.vocab) == (48, 1280, 16, 16, 80, 5120, 504)
    assert (full.causal, full.is_encoder, full.embed_inputs,
            full.norm_style, full.gated_mlp, full.attn_impl) == (
        False, True, False, "layer", False, "flash")
    assert not full.supports_decode
    assert registry.get_config("hubert-xlarge") is t_hub.CONFIG
    assert registry.get_config("hubert-xlarge", smoke=True) is t_hub.SMOKE
    assert _configs("heads_of_80")[1].hd == 80


def test_full_tree_is_the_reference_layout():
    """JAX's full tree (shapes only): no embedding table, 0.96 B
    parameters; the port's init at 2 layers of the full widths has its
    leaves, shapes and order."""
    full = jax.eval_shape(lambda k: jt.init(k, j_hub.CONFIG),
                          jax.random.PRNGKey(0))
    assert "embed" not in full
    n = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(full))
    assert n == 944_611_840
    assert full["segments"][0]["b0"]["attn"]["wq"].shape == (48, 1280, 16,
                                                             80)
    assert full["segments"][0]["b0"]["ffn"]["wi"].shape == (48, 1280, 5120)
    jcut = jax.eval_shape(lambda k: jt.init(k, j_hub.CONFIG.replace(
        n_layers=2)), jax.random.PRNGKey(0))
    own = tt.init(torch.Generator().manual_seed(0),
                  t_hub.CONFIG.replace(n_layers=2))
    jflat = jax.tree_util.tree_flatten_with_path(jcut)[0]
    flat = jax.tree_util.tree_flatten_with_path(
        convert.tree_map(lambda t: np.zeros(t.shape), own))[0]
    assert [p for p, _ in flat] == [p for p, _ in jflat]
    assert [a.shape for _, a in flat] == [a.shape for _, a in jflat]


# ------------------------------------------------------------------- model
@pytest.mark.parametrize("size", list(SIZES))
def test_forward_matches_jax(models, size):
    jcfg, tcfg = _configs(size)
    jp, tp = models[size]
    x, pos = _frames(jcfg, 2, 20, seed=1), _pos(2, 20)
    with torch.inference_mode():
        logits, aux = tt.forward(tp, tcfg, torch.from_numpy(x),
                                 torch.from_numpy(pos))
    jl, _ = jt.forward(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    assert logits.shape == (2, 20, jcfg.vocab) and float(aux) == 0.0
    np.testing.assert_allclose(_np(logits), np.asarray(jl), atol=TOL)


@pytest.mark.parametrize("size", list(SIZES))
def test_loss_and_grads_match_jax(models, size):
    """``loss_fn`` on ``synth_batch``'s frames and unit labels (equal bit
    for bit in both packages) and every leaf's gradient."""
    jcfg, tcfg = _configs(size)
    jp, tp = models[size]
    jb = j_synth_batch(jcfg, JDataConfig(batch=2, seq_len=16, seed=4), 0)
    tb = synth_batch(tcfg, DataConfig(batch=2, seq_len=16, seed=4), 0,
                     device="cpu")
    assert tb["inputs"].shape == (2, 16, tcfg.d_model)
    for k in jb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    (jl, _), jg = jax.value_and_grad(jt.loss_fn, has_aux=True)(
        jp, jcfg, jax.tree.map(jnp.asarray, jb))
    (loss, _), grads = value_and_grad(tt.loss_fn, tp, tcfg, tb,
                                      has_aux=True)
    np.testing.assert_allclose(float(loss), float(jl), atol=TOL)
    ours = jax.tree_util.tree_flatten_with_path(
        convert.tree_map(_np, grads))[0]
    theirs = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert len(ours) == len(theirs) == 13
    for (pa, a), (pb, b) in zip(ours, theirs):
        assert pa == pb
        np.testing.assert_allclose(a, np.asarray(b), atol=TOL,
                                   err_msg=jax.tree_util.keystr(pa))


@pytest.mark.parametrize("size", list(SIZES))
def test_flash_matches_jax_reference(models, size):
    """The port under ``attn_impl="flash"`` (the config's setting: each
    layer's non-causal, unwindowed attention through the flash wrapper,
    its plain version here) against JAX's ``"reference"`` model on the
    same weights: ``forward`` on frames, ``loss_fn`` and every leaf's
    gradient, 1e-4."""
    jcfg, tcfg = _configs(size)
    tcfg = tcfg.replace(attn_impl="flash")
    assert jcfg.attn_impl == "reference"
    jp, tp = models[size]
    x, pos = _frames(jcfg, 2, 20, seed=5), _pos(2, 20)
    with torch.inference_mode():
        logits, _ = tt.forward(tp, tcfg, torch.from_numpy(x),
                               torch.from_numpy(pos))
    jl, _ = jt.forward(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    np.testing.assert_allclose(_np(logits), np.asarray(jl), atol=TOL)
    jb = j_synth_batch(jcfg, JDataConfig(batch=2, seq_len=16, seed=6), 0)
    tb = synth_batch(tcfg, DataConfig(batch=2, seq_len=16, seed=6), 0,
                     device="cpu")
    (jloss, _), jg = jax.value_and_grad(jt.loss_fn, has_aux=True)(
        jp, jcfg, jax.tree.map(jnp.asarray, jb))
    (loss, _), grads = value_and_grad(tt.loss_fn, tp, tcfg, tb,
                                      has_aux=True)
    np.testing.assert_allclose(float(loss), float(jloss), atol=TOL)
    ours = jax.tree_util.tree_flatten_with_path(
        convert.tree_map(_np, grads))[0]
    theirs = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert len(ours) == len(theirs) == 13
    for (pa, a), (pb, b) in zip(ours, theirs):
        assert pa == pb
        np.testing.assert_allclose(a, np.asarray(b), atol=TOL,
                                   err_msg=jax.tree_util.keystr(pa))


@pytest.mark.parametrize("size", list(SIZES))
def test_attention_is_bidirectional(models, size):
    """The last frame reaches the first frame's logits, by JAX's amount."""
    jcfg, tcfg = _configs(size)
    jp, tp = models[size]
    x, pos = _frames(jcfg, 1, 12, seed=2), _pos(1, 12)
    late = x.copy()
    # not a constant shift, which LayerNorm would take out
    late[:, -1] += _frames(jcfg, 1, 1, seed=3)[:, 0]
    moved = []
    for frames in (x, late):
        with torch.inference_mode():
            ours = tt.forward(tp, tcfg, torch.from_numpy(frames),
                              torch.from_numpy(pos))[0]
        moved.append((_np(ours)[0, 0], np.asarray(jt.forward(
            jp, jcfg, jnp.asarray(frames), jnp.asarray(pos))[0])[0, 0]))
    (t0, j0), (t1, j1) = moved
    assert np.abs(t1 - t0).max() > 1e2 * TOL
    np.testing.assert_allclose(t1 - t0, j1 - j0, atol=TOL)


# ------------------------------------------------------ engine, launchers
def test_engine_refuses_the_encoder(models):
    jp, tp = models["smoke"]
    with pytest.raises(AssertionError, match="encoder-only"):
        JServeEngine(j_hub.SMOKE, jp, batch=2, s_max=16)
    with pytest.raises(ValueError, match="encoder-only"):
        ServeEngine(t_hub.SMOKE, tp, batch=2, s_max=16, device="cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        t_serve_launch.main(["--arch", "hubert-xlarge", "--smoke",
                             "--device", "cpu"])


def test_train_launcher_trains_hubert_on_frames(tmp_path, capsys):
    args = ["--arch", "hubert-xlarge", "--smoke", "--device", "cpu",
            "--steps", "2", "--batch", "2", "--seq", "16", "--ckpt-dir",
            str(tmp_path)]
    first = t_train_launch.main(args)
    second = t_train_launch.main(args)
    assert "resumed at step 2" in capsys.readouterr().out
    assert first["arch"] == "hubert-xlarge" and second["steps_done"] == 4
    assert np.isfinite(first["losses"] + second["losses"]).all()
    assert first["params"] == tt.param_count(tt.init(
        torch.Generator().manual_seed(0), t_hub.SMOKE))
