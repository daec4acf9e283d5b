"""The port's LM training path against the JAX package's, on Mamba2
``SMOKE`` (2 layers, d_model 64, chunk 16, fp32) with weights initialised in
JAX and converted: ``synth_batch``, ``loss_fn``, ``make_train_step`` (one
and two micro-batches, fp32 and bf16 accumulation, the error-feedback int8
transform), ``ChainedTrainer`` resume (within the port, and from a JAX
checkpoint) and the train launcher on the CPU.

Tolerances: ``loss_fn`` 1e-5 relative (fp32 sums over 31 tokens and 256
classes in other orders); after AdamW steps m and v within 1e-4 of their
leaf's scale and the metrics within 1e-5 relative (fp32, the model's
bound). The parameters are held step by step: each AdamW update the port
makes against JAX's update of the same gradient, parameters and state,
within 1e-4 of its leaf's scale. Two runs' parameters are not compared
after the steps: AdamW moves an element by lr m/(sqrt(v) + eps), and where
|g| is near eps (Mamba2 SMOKE has gradient elements of 4e-9) a rounding-size
change in g moves that by a large share of lr; the gradient is held by m
and v. With a bf16
accumulator 2e-2 throughout (a gradient element may round to the
neighbouring bf16 value on one side only), and with the int8 transform
(a code may differ by one step, 1/127 of the leaf's largest gradient, where
an element lies within rounding of a half step); the int8 codes of the
same inputs equal.
"""
import contextlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import mamba2_1_3b as j_mamba
from repro.data import DataConfig as JDataConfig
from repro.data import data_iterator as j_data_iterator
from repro.data import synth_batch as j_synth_batch
from repro.models import transformer as jt
from repro.train import ChainConfig as JChainConfig
from repro.train import ChainedTrainer as JChainedTrainer
from repro.train import fault as j_fault
from repro.train import grad_compression as j_gc
from repro.train.optimizer import OptimizerConfig as JOptimizerConfig
from repro.train.optimizer import adamw_update as j_adamw_update
from repro.train.optimizer import init_opt_state as j_init_opt_state
from repro.train.step import make_train_step as j_make_train_step
from repro_torch import convert
from repro_torch.configs import mamba2_1_3b as t_mamba
from repro_torch.convert import tree_map
from repro_torch.data import DataConfig, data_iterator, synth_batch
from repro_torch.launch import train as t_launch
from repro_torch.models import transformer as tt
from repro_torch.train import (ChainConfig, ChainedTrainer, ElasticPlan,
                               OptimizerConfig, StragglerMonitor,
                               init_opt_state, make_train_step)
from repro_torch.train import fault as t_fault
from repro_torch.train import grad_compression as t_gc
from repro_torch.train import step as t_step
from repro_torch.train.step import _split_microbatches

JCFG, TCFG = j_mamba.SMOKE, t_mamba.SMOKE
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=10)
DC = dict(batch=4, seq_len=31, seed=3)   # 31 tokens: chunks of 16, ragged


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jp = jt.init(jax.random.PRNGKey(0), JCFG)
    return jp, convert.from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _leaves(tree):
    """Leaves in JAX's order (dict keys sorted, lists by index)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _close_trees(got, ref, tol, what):
    """Each leaf of the port's tree within ``tol`` of its JAX leaf's
    scale."""
    g, r = _leaves(got), jax.tree.leaves(ref)
    assert len(g) == len(r), what
    for i, (a, b) in enumerate(zip(g, r)):
        b = np.asarray(b, np.float32)
        a = a.detach().float().numpy()
        assert a.shape == b.shape, (what, i)
        err, scale = np.abs(a - b).max(), np.abs(b).max()
        assert err <= tol * max(scale, 1e-30), \
            f"{what} leaf {i}: {err} (scale {scale})"


@contextlib.contextmanager
def _updates():
    """Record every AdamW update the port's train step makes: (gradient,
    parameters, state, new parameters). A donated update writes its
    inputs, so they are recorded as copies taken before it."""
    calls, inner = [], t_step.adamw_update

    def update(grads, params, state, ocfg, donate=False):
        keep = (lambda t: tree_map(torch.clone, t)) if donate else (
            lambda t: t)
        seen = keep((grads, params, state))
        out = inner(grads, params, state, ocfg, donate=donate)
        calls.append((*seen, keep(out[0])))
        return out
    t_step.adamw_update = update
    try:
        yield calls
    finally:
        t_step.adamw_update = inner


def _check_updates(calls, tol):
    """Each recorded update against JAX's AdamW update of the same
    gradient (a bf16 one in fp32: the update's first cast), parameters
    and state."""
    assert calls
    for grads, params, state, new in calls:
        grads = tree_map(lambda t: t.float(), grads)
        ref = j_adamw_update(
            jax.tree.map(jnp.asarray, convert.to_jax(grads)),
            jax.tree.map(jnp.asarray, convert.to_jax(params)),
            jax.tree.map(jnp.asarray, convert.opt_state_to_jax(state)),
            JOptimizerConfig(**OPT))[0]
        _close_trees(new, ref, tol, "params")


def _batch_pair(step):
    jb = j_synth_batch(JCFG, JDataConfig(**DC), step)
    return jb, synth_batch(TCFG, DataConfig(**DC), step, device="cpu")


# ------------------------------------------------------------- data
@pytest.mark.parametrize("cfg_kw", [{}, {"mrope_sections": (4, 2, 2)},
                                    {"embed_inputs": False}])
@pytest.mark.parametrize("step", [0, 7])
def test_synth_batch_bit_equal_to_jax(cfg_kw, step):
    jcfg, tcfg = JCFG.replace(**cfg_kw), TCFG.replace(**cfg_kw)
    jb = j_synth_batch(jcfg, JDataConfig(**DC), step)
    tb = synth_batch(tcfg, DataConfig(**DC), step, device="cpu")
    assert jb.keys() == tb.keys()
    for k in jb:
        assert tb[k].dtype == {"int32": torch.int32,
                               "float32": torch.float32}[str(jb[k].dtype)]
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]),
                                      err_msg=k)


def test_data_iterator_restarts_mid_stream():
    it = data_iterator(TCFG, DataConfig(**DC), start_step=5, device="cpu")
    jit = j_data_iterator(JCFG, JDataConfig(**DC), start_step=5)
    for _ in range(2):
        a, b = next(it), next(jit)
        np.testing.assert_array_equal(a["inputs"].numpy(),
                                      np.asarray(b["inputs"]))
    with pytest.raises(RuntimeError, match="CUDA"):
        synth_batch(TCFG, DataConfig(**DC), 0)


# ------------------------------------------------------------- loss
@pytest.mark.parametrize("padded,masked", [(False, False), (True, True)])
def test_loss_fn_matches_jax(padded, masked):
    """Loss, ce and accuracy; with a padded vocab (272 for 256 tokens) and
    labels below 0 (invalid) in the second case."""
    jcfg = JCFG.replace(padded_vocab=272) if padded else JCFG
    tcfg = TCFG.replace(padded_vocab=272) if padded else TCFG
    jp = jt.init(jax.random.PRNGKey(1), jcfg)
    tp = convert.from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    jb, tb = _batch_pair(2)
    if masked:
        labels = np.asarray(jb["labels"]).copy()
        labels[:, ::3] = -1
        jb = dict(jb, labels=jnp.asarray(labels))
        tb = dict(tb, labels=torch.from_numpy(labels))
    jl, jm = jt.loss_fn(jp, jcfg, jb)
    tl, tm = tt.loss_fn(tp, tcfg, tb)
    assert tm["aux"] == 0.0 and isinstance(tm["aux"], float)
    for got, ref in ((tl, jl), (tm["ce"], jm["ce"]),
                     (tm["accuracy"], jm["accuracy"])):
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    tb2 = dict(tb)
    del tb2["positions"]               # positions default to arange
    np.testing.assert_allclose(float(tt.loss_fn(tp, tcfg, tb2)[0]), float(tl),
                               rtol=1e-6)


# ------------------------------------------------------- train step
def _run_both(model, steps, n_mb=1, accum=None, jtransform=None,
              ttransform=None, jit=True):
    jp, tp = model
    jstep = j_make_train_step(JCFG, JOptimizerConfig(**OPT), n_mb,
                              jtransform, accum)
    if jit:
        jstep = jax.jit(jstep)
    tstep = make_train_step(TCFG, OptimizerConfig(**OPT), n_mb, ttransform,
                            accum)
    js, ts = j_init_opt_state(jp, JOptimizerConfig(**OPT)), \
        init_opt_state(tp, OptimizerConfig(**OPT))
    metrics = []
    with _updates() as calls:
        for step in range(steps):
            jb, tb = _batch_pair(step)
            jp, js, jm = jstep(jp, js, jb)
            tp, ts, tm = tstep(tp, ts, tb)
            metrics.append((jm, tm))
    assert len(calls) == steps
    return (jp, js), (tp, ts, calls), metrics


def _check_run(jstate, tstate, metrics, tol, metric_tol):
    """The metrics of every step, m and v after the steps, and each
    step's parameter update (``_check_updates``)."""
    (_, js), (_, ts, calls) = jstate, tstate
    for jm, tm in metrics:
        assert set(tm) >= {"ce", "loss", "lr", "grad_norm"}
        for k in ("ce", "loss", "lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=metric_tol, err_msg=k)
    _check_updates(calls, tol)
    _close_trees(ts["m"], js["m"], tol, "m")
    _close_trees(ts["v"], js["v"], tol, "v")
    assert int(ts["step"]) == int(js["step"])


def test_train_step_matches_jax(model):
    """Three steps at one micro-batch: the metrics, every parameter and
    the optimizer state."""
    jstate, tstate, metrics = _run_both(model, 3)
    _check_run(jstate, tstate, metrics, 1e-4, 1e-5)
    assert set(metrics[0][1]) == {"ce", "aux", "accuracy", "loss", "lr",
                                  "grad_norm"}


@pytest.mark.parametrize("accum,tol,metric_tol", [
    (None, 1e-4, 1e-5), ("bf16", 2e-2, 2e-2)])
def test_microbatched_train_step_matches_jax(model, accum, tol, metric_tol):
    """Two micro-batches of 2, accumulated in fp32 and in bf16."""
    jstate, tstate, metrics = _run_both(model, 2, n_mb=2, accum=accum)
    _check_run(jstate, tstate, metrics, tol, metric_tol)


def test_microbatches_split_as_the_reference():
    b = {"inputs": torch.arange(24).reshape(4, 6),
         "positions": torch.arange(72).reshape(3, 4, 6)}
    out = _split_microbatches(b, 2)
    assert out["inputs"].shape == (2, 2, 6)
    assert torch.equal(out["inputs"][1], b["inputs"][2:])
    # (3, B, S) positions: 3 is not split by 2, so the batch axis is
    assert out["positions"].shape == (2, 3, 2, 6)
    assert torch.equal(out["positions"][1], b["positions"][:, 2:])
    with pytest.raises(ValueError, match="microbatch"):
        _split_microbatches({"x": torch.zeros(3, 5)}, 2)


def test_error_feedback_transform_matches_jax(model):
    """The int8 error-feedback ``grad_transform`` over three steps (both
    sides eager, the residual state carried in a closure)."""
    jp, tp = model
    j_init, j_apply = j_gc.make_error_feedback_transform(jp)
    t_init, t_apply = t_gc.make_error_feedback_transform(tp)
    jstate, tstate = [j_init()], [t_init()]

    def jtr(g):
        g, jstate[0] = j_apply(g, jstate[0])
        return g

    def ttr(g):
        g, tstate[0] = t_apply(g, tstate[0])
        return g
    j_out, t_out, metrics = _run_both(model, 3, jtransform=jtr,
                                      ttransform=ttr, jit=False)
    # an int8 code may differ by one where a gradient element lies within
    # fp32 rounding of a half step: 1/127 of the leaf's largest gradient
    _check_run(j_out, t_out, metrics, 2e-2, 1e-4)
    # a residual is under half a step (1/254 of its leaf's largest
    # gradient), so it carries the gradient's fp32 noise 254-fold: every
    # residual agrees within 2e-3 of its leaf's largest, except where a code
    # flipped, which moves it by a whole step (twice that largest); flips
    # are rare (seen: 1 element in 89,136)
    flips = total = 0
    for a, b in zip(_leaves(tstate[0]), jax.tree.leaves(jstate[0])):
        b = np.asarray(b)
        diff, scale = np.abs(a.numpy() - b), np.abs(b).max()
        flip = diff > 0.5 * scale
        assert (diff[~flip] <= 2e-3 * scale).all()
        flips, total = flips + flip.sum(), total + flip.size
    assert flips <= 1e-4 * total, (flips, total)


def test_int8_rounds_half_to_even_as_jax():
    x = np.array([127.0, 2.5, 3.5, -2.5, -0.5, 0.5, 1.5, 126.5], np.float32)
    jq, js = j_gc.quantize_int8(jnp.asarray(x))
    tq, ts = t_gc.quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and float(ts) == float(js) == 1.0
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tq.numpy()[1:],
                                  [2, 4, -2, 0, 0, 2, 126])
    g = np.random.default_rng(0).normal(size=(5, 7)).astype(np.float32)
    err = np.random.default_rng(1).normal(size=(5, 7)).astype(np.float32)
    for a, b in zip(t_gc.compress_leaf(torch.from_numpy(g),
                                       torch.from_numpy(err)),
                    j_gc.compress_leaf(jnp.asarray(g), jnp.asarray(err))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


# -------------------------------------------------------------- chain
def _trainer(ckpt_dir, start=0, cls=ChainedTrainer):
    ocfg, chain = OptimizerConfig(**OPT), ChainConfig(ckpt_dir=str(ckpt_dir),
                                                      ckpt_every=2)
    return cls(TCFG, ocfg, chain, data_iterator(
        TCFG, DataConfig(**DC), start_step=start, device="cpu"), seed=5,
        device="cpu")


def test_chained_trainer_resume_is_bit_identical(tmp_path):
    """3 steps, exit, resume, 3 more: the losses and final state of 6
    uninterrupted steps, bit for bit."""
    whole = _trainer(tmp_path / "whole")
    info = whole.run_subjob(6)
    assert info["steps_done"] == 6 and info["reason"] == "budget"
    first = _trainer(tmp_path / "split")
    assert not first.maybe_resume()
    losses = first.run_subjob(3)["losses"]
    second = _trainer(tmp_path / "split", start=3)
    assert second.maybe_resume() and second.step == 3
    losses += second.run_subjob(3)["losses"]
    assert losses == info["losses"]
    for a, b in zip(_leaves({"p": second.params, "o": second.opt_state}),
                    _leaves({"p": whole.params, "o": whole.opt_state})):
        assert torch.equal(a, b)
    assert all(np.isfinite(losses))


def test_chained_trainer_writes_each_step_once(tmp_path):
    """With ``ckpt_every`` 2, a 4-step sub-job saves steps 2 and 4 (the
    exit's step was handed to the writer already) and reports its exit
    checkpoint's wall time; a resumed sub-job that runs no step writes
    nothing."""
    tr = _trainer(tmp_path)
    saved, real = [], tr.ckpt.save
    tr.ckpt.save = lambda step, state: saved.append(step) or real(step,
                                                                   state)
    info = tr.run_subjob(4)
    assert saved == [2, 4] and info["exit_ckpt_s"] >= 0.0
    again = _trainer(tmp_path, start=4)
    assert again.maybe_resume() and again.step == 4
    again.ckpt.save = lambda step, state: saved.append(step)
    assert again.run_subjob(0)["steps_done"] == 4 and saved == [2, 4]


def test_chained_trainer_stops_on_preemption(tmp_path):
    from repro_torch.train import PreemptionGuard
    tr = _trainer(tmp_path)
    guard = PreemptionGuard(install_signals=False)
    guard.trigger()
    info = tr.run_subjob(3, guard=guard)
    assert (info["reason"], info["steps_done"]) == ("preempted", 0)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """JAX's ``ChainedTrainer`` trains 3 steps and checkpoints params and
    optimizer state; the port's resumes from that checkpoint and its next
    3 losses are JAX's own next 3 (JAX resumed from the same checkpoint)."""
    jdir = tmp_path / "jax"
    jchain = JChainConfig(ckpt_dir=str(jdir), ckpt_every=50)
    jocfg = JOptimizerConfig(**OPT)
    jtr = JChainedTrainer(JCFG, jocfg, jchain,
                          j_data_iterator(JCFG, JDataConfig(**DC)), seed=2)
    jtr.run_subjob(3)
    shutil.copytree(jdir, tmp_path / "port")
    jnext = JChainedTrainer(JCFG, jocfg, jchain, j_data_iterator(
        JCFG, JDataConfig(**DC), start_step=3), seed=2)
    assert jnext.maybe_resume() and jnext.step == 3
    jlosses = jnext.run_subjob(3)["losses"]
    tr = _trainer(tmp_path / "port", start=3)
    assert tr.maybe_resume() and tr.step == 3
    assert int(tr.opt_state["step"]) == 3
    with _updates() as calls:
        tlosses = tr.run_subjob(3)["losses"]
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert len(calls) == 3
    _check_updates(calls, 1e-4)
    _close_trees(tr.opt_state["m"], jnext.opt_state["m"], 1e-4, "m")
    _close_trees(tr.opt_state["v"], jnext.opt_state["v"], 1e-4, "v")


def test_fault_helpers_match_the_reference():
    """The whole copy of ``train/fault.py``: the straggler monitor flags the
    same steps, the elastic plan walks the same shapes."""
    times = [1.0] * 12 + [3.0, 1.0, 2.4, 2.6] + [1.0] * 40 + [5.0]
    tmon, jmon = (StragglerMonitor(window=20),
                  j_fault.StragglerMonitor(window=20))
    tf = [tmon.record(t) for t in times]
    jf = [jmon.record(t) for t in times]
    assert tf == jf and tmon.flagged == jmon.flagged > 0
    assert tmon.median == jmon.median
    tp, jp = ElasticPlan(), j_fault.ElasticPlan()
    walk = ["degrade", "degrade", "degrade", "recover", "recover", "recover"]
    assert [getattr(tp, m)() for m in walk] == [getattr(jp, m)()
                                                for m in walk]
    assert t_fault.ElasticPlan is ElasticPlan


# ----------------------------------------------------------- launcher
def test_train_launcher_on_the_cpu(tmp_path, capsys):
    args = ["--arch", "mamba2-1.3b", "--smoke", "--device", "cpu",
            "--steps", "3", "--batch", "2", "--seq", "20",
            "--ckpt-dir", str(tmp_path)]
    first = t_launch.main(args)
    assert first["steps_done"] == 3 and not first["resumed"]
    second = t_launch.main(args)
    out = capsys.readouterr().out
    assert "resumed at step 3" in out
    assert second["resumed"] and second["steps_done"] == 6
    assert np.isfinite(first["losses"] + second["losses"]).all()
    assert first["params"] == tt.param_count(tt.init(
        torch.Generator().manual_seed(0), TCFG))


def test_train_launcher_asks_for_cuda_and_refuses_unported(tmp_path,
                                                           monkeypatch):
    with pytest.raises(RuntimeError, match="CUDA"):
        t_launch.main(["--smoke", "--steps", "1", "--ckpt-dir",
                       str(tmp_path)])
    # Qwen2-VL-7B, once refused, now trains; an unknown arch is refused
    out = t_launch.main(["--arch", "qwen2-vl-7b", "--smoke", "--device",
                         "cpu", "--steps", "1", "--batch", "2", "--seq", "8",
                         "--ckpt-dir", str(tmp_path)])
    assert out["arch"] == "qwen2-vl-7b" and out["steps_done"] == 1
    assert np.isfinite(out["losses"]).all()
    with pytest.raises(KeyError, match="qwen2-vl-72b"):
        t_launch.main(["--arch", "qwen2-vl-72b", "--smoke", "--device",
                       "cpu", "--ckpt-dir", str(tmp_path)])
    # --distributed is ported (tests/test_torch_restore.py): without
    # torchrun's environment it refuses to start, and joins no group
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="RANK"):
        t_launch.main(["--distributed", "--device", "cpu", "--smoke"])
    assert not torch.distributed.is_initialized()
