"""The donated AdamW update (``adamw_update(..., donate=True)``,
``make_train_step(..., donate=True)``, ``ChainedTrainer``'s step) on the
CPU.

The reference's ``ChainedTrainer`` jits its step with
``donate_argnums=(0, 1)``, so XLA writes the new parameters and optimizer
state into the old buffers. The port's donated step writes each leaf's new
p, m and v into that leaf's own storage, slice by slice, through
``_update``, the functional update's arithmetic. Held here:

* three ``make_train_step`` steps donated against three functional ones
  from the same state, bit for bit (parameters, m, v, the step counter and
  the metrics), on Gemma-3 ``SMOKE`` (a tied embedding, nonzero norm
  scales), fp32 and bf16 m and v, whole leaves and leaves in slices;
* every leaf keeps its storage (``data_ptr``) through donated steps, the
  tied table among them, and the same trees come back; the gradient tree
  is emptied; leaves that share a storage or are not contiguous are
  refused;
* a checkpoint whose save starts before a donated step holds the values
  from before the step;
* ``ChainedTrainer`` donates, and 3 steps, a resume and 3 more equal 6
  uninterrupted steps bit for bit;
* one bf16-state update of DeepSeek-V2 ``SMOKE`` (MLA, its norm scales
  drawn N(1, 0.3)) against JAX's AdamW update of the same gradient, from
  the same parameters and state: the parameters within 1e-4 of each
  leaf's scale, m and v within one bf16 ulp of each element (one rounding
  to bf16 of two fp32 values that agree within rounding may land either
  side);
* one ``ChainedTrainer`` step of Command-R ``SMOKE`` (the parallel block,
  LayerNorm scales and biases drawn, the tied table) with bf16 m and v,
  after two, against JAX's AdamW update of the gradient that step takes,
  to the same bounds; ln2, which the parallel block never reads, takes a
  zero gradient on both sides.

``global_norm`` squares a leaf of more than ``UPDATE_SLICE`` elements a
slice at a time (no fp32 square of the whole leaf); at whole leaves and in
slices it is held to the float64 norm at 1e-6 and to JAX's ``global_norm``
on the same fp32 and bf16 leaves at 1e-5 (JAX's fp32 sum on the CPU is
1.4e-6 off the float64 norm on these leaves).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import command_r_35b as j_cr
from repro.configs import deepseek_v2_236b as j_ds
from repro.models import transformer as jt
from repro.train.optimizer import OptimizerConfig as JOptimizerConfig
from repro.train.optimizer import adamw_update as j_adamw_update
from repro.train.optimizer import global_norm as j_global_norm
from repro_torch import convert
from repro_torch.configs import command_r_35b as t_cr
from repro_torch.configs import deepseek_v2_236b as t_ds
from repro_torch.configs import gemma3_27b as t_gemma
from repro_torch.configs import tinyllama_1_1b as t_tiny
from repro_torch.convert import tree_map
from repro_torch.data import DataConfig, data_iterator, synth_batch
from repro_torch.models import transformer as tt
from repro_torch.train import (AsyncCheckpointer, ChainConfig,
                               ChainedTrainer, OptimizerConfig, adamw_update,
                               init_opt_state, make_train_step,
                               restore_checkpoint)
from repro_torch.train import optimizer as t_opt
from repro_torch.train.step import value_and_grad

OPT = dict(lr=3e-3, warmup_steps=2, total_steps=10)
TOL = 1e-4
BF16_ULP = 2.0 ** -8        # one bf16 ulp, relative to the element
CFG = t_gemma.SMOKE
DC = DataConfig(batch=2, seq_len=24, seed=1)


def _leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def _draw_norms(tree, gen):
    """Every norm scale of ``tree`` drawn N(0, 0.1) in place, so that the
    gemma norms are not the init's zeros."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k == "scale":
                v.copy_(0.1 * torch.randn(v.shape, generator=gen))
            else:
                _draw_norms(v, gen)
    elif isinstance(tree, list):
        for v in tree:
            _draw_norms(v, gen)


def _state(cfg=CFG, state_dtype=None, seed=0):
    """Seeded parameters of ``cfg`` (``_draw_norms``) and AdamW's zero
    state."""
    gen = torch.Generator().manual_seed(seed)
    params = tt.init(gen, cfg)
    _draw_norms(params, gen)
    ocfg = OptimizerConfig(**OPT, state_dtype=state_dtype)
    return params, init_opt_state(params, ocfg), ocfg


def _ptrs(tree):
    return [t.data_ptr() for t in _leaves(tree)]


def _steps(params, opt, ocfg, donate, n=3):
    step = make_train_step(CFG, ocfg, donate=donate)
    metrics = []
    for i in range(n):
        params, opt, m = step(params, opt, synth_batch(CFG, DC, i,
                                                       device="cpu"))
        metrics.append({k: float(v) for k, v in m.items()})
    return params, opt, metrics


@pytest.mark.parametrize("slice_elems", [t_opt.UPDATE_SLICE, 1000])
@pytest.mark.parametrize("state_dtype", [None, "bfloat16"])
def test_donated_steps_are_the_functional_bits(monkeypatch, state_dtype,
                                               slice_elems):
    monkeypatch.setattr(t_opt, "UPDATE_SLICE", slice_elems)
    params, opt, ocfg = _state(state_dtype=state_dtype)
    assert (max(t.numel() for t in _leaves(params)) > slice_elems) == (
        slice_elems == 1000)
    init = tree_map(torch.clone, (params, opt))
    fp, fo, fm = _steps(params, opt, ocfg, donate=False)
    dp, do, dm = _steps(*tree_map(torch.clone, init), ocfg, donate=True)
    assert fm == dm
    assert len(_leaves(fp)) == len(_leaves(dp)) == 26
    for a, b in zip(_leaves((fp, fo)), _leaves((dp, do))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    want = torch.bfloat16 if state_dtype else torch.float32
    assert {t.dtype for t in _leaves((do["m"], do["v"]))} == {want}
    assert int(do["step"]) == 3
    # the functional steps wrote none of their inputs
    for a, b in zip(_leaves((params, opt)), _leaves(init)):
        assert torch.equal(a, b)


def test_donated_update_keeps_each_leafs_storage():
    """The same trees come back, every leaf (the tied table, m, v, the step
    counter) in its own storage; the gradient tree is emptied."""
    params, opt, ocfg = _state(state_dtype="bfloat16")
    assert "head" not in params and CFG.tie_embeddings
    table = params["embed"]["table"]
    before = _ptrs((params, opt))
    step = make_train_step(CFG, ocfg, donate=True)
    out_p, out_o, _ = step(params, opt, synth_batch(CFG, DC, 0,
                                                    device="cpu"))
    assert out_p is params and out_o is opt
    assert out_p["embed"]["table"] is table
    assert _ptrs((out_p, out_o)) == before
    assert int(opt["step"]) == 1
    grads = tree_map(torch.ones_like, params)
    old = tree_map(torch.clone, params)
    adamw_update(grads, params, opt, ocfg, donate=True)
    assert grads == {} and _ptrs((params, opt)) == before
    assert not torch.equal(params["embed"]["table"], old["embed"]["table"])


def test_donation_refuses_shared_or_strided_leaves():
    params, opt, ocfg = _state()
    shared = dict(params, head=params["embed"]["table"].t().contiguous())
    shared["final_norm"] = params["embed"]["table"][0]
    with pytest.raises(ValueError, match="share"):
        adamw_update(tree_map(torch.ones_like, shared), shared,
                     init_opt_state(shared, ocfg), ocfg, donate=True)
    strided = dict(params, head=torch.zeros(CFG.vocab, CFG.d_model).t())
    with pytest.raises(ValueError, match="contiguous"):
        adamw_update(tree_map(torch.ones_like, strided), strided,
                     init_opt_state(strided, ocfg), ocfg, donate=True)


def test_checkpoint_started_before_a_donated_step_saves_old_values(
        tmp_path):
    params, opt, ocfg = _state(state_dtype="bfloat16")
    step = make_train_step(CFG, ocfg, donate=True)
    params, opt, _ = step(params, opt, synth_batch(CFG, DC, 0, device="cpu"))
    snap = tree_map(torch.clone, {"params": params, "opt": opt})
    ckpt = AsyncCheckpointer(str(tmp_path))
    ckpt.save(1, {"params": params, "opt": opt})
    params, opt, _ = step(params, opt, synth_batch(CFG, DC, 1, device="cpu"))
    ckpt.wait()
    back, at = restore_checkpoint(str(tmp_path), snap, device="cpu")
    assert at == 1
    for a, b in zip(_leaves(back), _leaves(snap)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert not torch.equal(back["params"]["embed"]["table"],
                           params["embed"]["table"])
    assert int(back["opt"]["step"]) == 1 and int(opt["step"]) == 2


def _trainer(ckpt_dir, start=0):
    cfg = t_tiny.SMOKE
    return ChainedTrainer(
        cfg, OptimizerConfig(**OPT, state_dtype="bfloat16"),
        ChainConfig(ckpt_dir=str(ckpt_dir), ckpt_every=2),
        data_iterator(cfg, DataConfig(batch=2, seq_len=16, seed=2),
                      start_step=start, device="cpu"), seed=3,
        device="cpu")


def test_chained_trainer_donates_and_resumes_bit_identical(tmp_path):
    """Every leaf keeps its storage through a sub-job's steps (and its
    checkpoints every 2), and 3 + 3 resumed steps equal 6 bit for bit."""
    whole = _trainer(tmp_path / "whole")
    before = _ptrs((whole.params, whole.opt_state))
    info = whole.run_subjob(6)
    assert _ptrs((whole.params, whole.opt_state)) == before
    first = _trainer(tmp_path / "split")
    losses = first.run_subjob(3)["losses"]
    second = _trainer(tmp_path / "split", start=3)
    assert second.maybe_resume() and second.step == 3
    losses += second.run_subjob(3)["losses"]
    assert losses == info["losses"] and np.isfinite(losses).all()
    for a, b in zip(_leaves((second.params, second.opt_state)),
                    _leaves((whole.params, whole.opt_state))):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _jax_bf16(tree):
    """A tree of the port's tensors (bf16 among them) as JAX arrays of the
    same dtypes."""
    return tree_map(lambda t: jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16) if t.dtype == torch.bfloat16 else jnp.asarray(
        t.numpy()), tree)


def _near_jax(ours, ref_p, ref_s, opt, n_leaves):
    """The port's parameters within TOL of each JAX leaf's scale, its bf16
    m and v within one bf16 ulp of each JAX element."""
    for mine, theirs in ((ours, ref_p), (opt["m"], ref_s["m"]),
                         (opt["v"], ref_s["v"])):
        flat = {jax.tree_util.keystr(path): b for path, b in
                jax.tree_util.tree_flatten_with_path(theirs)[0]}
        leaves = dict(_paths(mine))
        assert leaves.keys() == flat.keys() and len(flat) == n_leaves
        for path, b in flat.items():
            t = leaves[path]
            a = t.float().numpy()
            b = np.asarray(b, np.float32)
            assert a.shape == b.shape, path
            if theirs is ref_p:
                bound = TOL * max(np.abs(b).max(), 1e-30)
            else:
                assert t.dtype == torch.bfloat16
                bound = BF16_ULP * np.abs(b)
            assert (np.abs(a - b) <= bound).all(), path


def _paths(tree, prefix=""):
    """(path, leaf) pairs, each path as ``jax.tree_util.keystr`` writes
    it."""
    if isinstance(tree, dict):
        return [kv for k in tree for kv in _paths(tree[k],
                                                  f"{prefix}['{k}']")]
    if isinstance(tree, list):
        return [kv for i, v in enumerate(tree)
                for kv in _paths(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def test_bf16_state_update_on_mla_matches_jax():
    """One donated update with bf16 m and v on DeepSeek-V2 ``SMOKE``,
    after two so that m and v are not zero, against JAX's update of the
    same gradient from the same parameters and state."""
    jcfg, tcfg = j_ds.SMOKE, t_ds.SMOKE
    jp = jt.init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    jp = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(1 + 0.3 * rng.normal(size=a.shape),
                                    a.dtype)
        if str(path[-1]) == "['scale']" else a, jp)
    params = convert.from_jax(jax.tree.map(np.array, jp), device="cpu")
    ocfg = OptimizerConfig(**OPT, state_dtype="bfloat16")
    jocfg = JOptimizerConfig(**OPT, state_dtype="bfloat16")
    opt = init_opt_state(params, ocfg)
    dc = DataConfig(batch=2, seq_len=16, seed=5)
    step = make_train_step(tcfg, ocfg, donate=True)
    for i in range(2):
        params, opt, _ = step(params, opt, synth_batch(tcfg, dc, i,
                                                       device="cpu"))
    batch = synth_batch(tcfg, dc, 2, device="cpu")
    _, grads = value_and_grad(tt.loss_fn, params, tcfg, batch, has_aux=True)
    j_in = [_jax_bf16(t) for t in (grads, params, opt)]
    ref_p, ref_s, _ = j_adamw_update(*j_in, jocfg)
    adamw_update(grads, params, opt, ocfg, donate=True)
    _near_jax(params, ref_p, ref_s, opt, 32)
    assert int(opt["step"]) == int(ref_s["step"]) == 3


def _copy_into(dst, src):
    """Each leaf of ``src`` copied into ``dst``'s leaf at the same path."""
    if isinstance(dst, dict):
        assert dst.keys() == src.keys()
        for k in dst:
            _copy_into(dst[k], src[k])
    elif isinstance(dst, list):
        assert len(dst) == len(src)
        for a, b in zip(dst, src):
            _copy_into(a, b)
    else:
        dst.copy_(src)


def test_chained_trainer_bf16_step_on_command_r_matches_jax(tmp_path):
    """``ChainedTrainer``'s third donated step on Command-R ``SMOKE`` with
    bf16 m and v, from JAX's weights (LayerNorm scales N(1, 0.3), biases
    N(0, 0.3)), against JAX's update of the gradient of that step's batch
    from the same parameters and state; every leaf keeps its storage."""
    jcfg, tcfg = j_cr.SMOKE, t_cr.SMOKE
    jp = jt.init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    jp = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(
            (str(path[-1]) == "['scale']") + 0.3 * rng.normal(size=a.shape),
            a.dtype) if str(path[-1]) in ("['scale']", "['bias']") else a,
        jp)
    ocfg = OptimizerConfig(**OPT, state_dtype="bfloat16")
    jocfg = JOptimizerConfig(**OPT, state_dtype="bfloat16")
    dc = DataConfig(batch=2, seq_len=16, seed=4)
    tr = ChainedTrainer(tcfg, ocfg, ChainConfig(ckpt_dir=str(tmp_path),
                                                ckpt_every=10**9),
                        data_iterator(tcfg, dc, device="cpu"), seed=0,
                        device="cpu")
    _copy_into(tr.params, convert.from_jax(jax.tree.map(np.array, jp),
                                           device="cpu"))
    tr.run_subjob(2)
    params, opt = tree_map(torch.clone, (tr.params, tr.opt_state))
    ptrs = _ptrs((tr.params, tr.opt_state))
    batch = next(data_iterator(tcfg, dc, start_step=2, device="cpu"))
    _, grads = value_and_grad(tt.loss_fn, params, tcfg, batch, has_aux=True)
    ln2 = grads["segments"][0]["b0"]["ln2"]
    assert not ln2["scale"].any() and not ln2["bias"].any()
    ref_p, ref_s, _ = j_adamw_update(
        *[_jax_bf16(t) for t in (grads, params, opt)], jocfg)
    tr.run_subjob(1)
    assert _ptrs((tr.params, tr.opt_state)) == ptrs and tr.step == 3
    _near_jax(tr.params, ref_p, ref_s, tr.opt_state, 13)
    assert int(tr.opt_state["step"]) == int(ref_s["step"]) == 3


@pytest.mark.parametrize("slice_elems", [t_opt.UPDATE_SLICE, 1000, 7])
def test_global_norm_in_slices_matches_jax(monkeypatch, slice_elems):
    """The port's ``global_norm`` at whole leaves and in slices (uneven
    ones among them) against the float64 norm and JAX's on the same fp32
    and bf16 leaves."""
    monkeypatch.setattr(t_opt, "UPDATE_SLICE", slice_elems)
    rng = np.random.default_rng(3)
    arrays = [rng.normal(0, s, shape).astype(np.float32)
              for s, shape in ((1.0, (37, 61)), (3.0, (4, 17, 29)),
                               (0.01, (5,)), (2.0, ()))]
    dtypes = [torch.float32, torch.bfloat16, torch.float32, torch.bfloat16]
    tree = {"w": [torch.from_numpy(a).to(dt) for a, dt in
                  zip(arrays, dtypes)]}
    jtree = {"w": [jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32)
        for t, dt in zip(tree["w"], dtypes)]}
    got = float(t_opt.global_norm(tree))
    exact = float(np.sqrt(sum(np.sum(t.double().numpy() ** 2)
                              for t in tree["w"])))
    want = float(j_global_norm(jtree))
    assert abs(got - exact) <= 1e-6 * exact, (got, exact)
    assert abs(got - want) <= 1e-5 * want, (got, want)
