"""The gradient buffers of a train step: the micro-batch sum updated in
place (``make_train_step``'s accumulator, as XLA updates the reference's
scan carry) with the bits of the out-of-place sum, and a tied table's
gradient in one buffer (``layers.TiedTable``), both counted on meta
tensors by ``StepCounter``."""
import numpy as np
import pytest
import torch

from repro_torch.configs import command_r_35b as t_cr
from repro_torch.configs import deepseek_v2_236b as t_ds
from repro_torch.configs import gemma3_27b as t_gemma
from repro_torch.configs import tinyllama_1_1b as t_tl
from repro_torch.convert import tree_map
from repro_torch.data import DataConfig, synth_batch
from repro_torch.launch.dryrun import MetaGenerator
from repro_torch.models import transformer
from repro_torch.roofline.analysis import StepCounter
from repro_torch.train import step as t_step
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
from repro_torch.train.step import (_split_microbatches, make_train_step,
                                    value_and_grad)

OCFG = OptimizerConfig(lr=3e-3, warmup_steps=2, total_steps=10)
MODELS = {"tinyllama": t_tl.SMOKE, "deepseek-v2": t_ds.SMOKE}


def _flat(tree):
    out = []
    tree_map(out.append, tree)
    return out


@pytest.mark.parametrize("n_mb", [2, 4])
@pytest.mark.parametrize("accum", [None, "bf16"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_inplace_sum_has_the_out_of_place_bits(model, accum, n_mb):
    """The gradient ``make_train_step`` hands the update (caught by its
    ``grad_transform``) against ``(sum of a + g.to(acc)) / n`` built here
    from each micro-batch's ``value_and_grad``: the same bits, fp32 and
    bf16 accumulators, 2 and 4 micro-batches."""
    cfg = MODELS[model]
    params = transformer.init(torch.Generator().manual_seed(0), cfg)
    batch = synth_batch(cfg, DataConfig(batch=4, seq_len=16, seed=1), 0,
                        device="cpu")
    seen = []
    make_train_step(cfg, OCFG, n_mb, grad_transform=lambda g: seen.append(
        g) or g, grad_accum_dtype=accum)(params, init_opt_state(
            params, OCFG), batch)
    acc_dtype = torch.bfloat16 if accum else torch.float32
    mbs = _split_microbatches(batch, n_mb)
    acc = [torch.zeros_like(p, dtype=acc_dtype) for p in _flat(params)]
    for i in range(n_mb):
        _, g = value_and_grad(
            lambda p, mb: transformer.loss_fn(p, cfg, mb), params,
            {k: v[i] for k, v in mbs.items()}, has_aux=True)
        acc = [a + b.to(acc_dtype) for a, b in zip(acc, _flat(g))]
    want = [a / n_mb for a in acc]
    got = _flat(seen[0])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _out_of_place(acc, flat):
    """The sum as it was built before: a new accumulator tree, the old
    one and this micro-batch's gradients live until it is whole, the
    gradients kept until the next micro-batch's are."""
    acc[:] = [a + g.to(a.dtype) for a, g in zip(acc, flat)]


def _meta_step(cfg, n_mb, batch, seq):
    params = transformer.init(MetaGenerator(), cfg)
    opt = init_opt_state(params, OCFG)
    b = {k: torch.zeros(batch, seq, dtype=torch.int32, device="meta")
         for k in ("inputs", "labels")}
    with StepCounter(exclude=(params, opt, b)) as counter:
        make_train_step(cfg, OCFG, n_mb, donate=True)(params, opt, b)
    return counter, sum(t.numel() for t in _flat(params))


def test_inplace_sum_lowers_the_peak_by_an_accumulator(monkeypatch):
    """A 4-micro-batch donated step of TinyLlama's ``SMOKE`` (few
    tokens: the gradients set the peak) on meta tensors: the in-place
    sum's peak at least one fp32 accumulator below the out-of-place
    sum's."""
    inplace, n = _meta_step(t_tl.SMOKE, 4, 4, 8)
    monkeypatch.setattr(t_step, "_accumulate", _out_of_place)
    before, _ = _meta_step(t_tl.SMOKE, 4, 4, 8)
    assert before.peak_bytes - inplace.peak_bytes >= 4 * n


@pytest.mark.parametrize("base", [t_cr.SMOKE, t_gemma.SMOKE],
                         ids=["command-r", "gemma3"])
def test_tied_table_gradient_is_one_buffer(base):
    """A tied model with a vocab far wider than the rest (65,536 rows of
    ``SMOKE``'s width, one layer, 8 tokens): the gradient's peak on meta
    tensors holds one table-sized buffer, where the lookup's own gradient
    (a zero-filled table and an out-of-place ``index_put``) made three."""
    cfg = base.replace(vocab_size=65536, n_layers=1)
    table = cfg.vocab * cfg.d_model * 4
    params = transformer.init(MetaGenerator(), cfg)
    b = {k: torch.zeros(1, 8, dtype=torch.int32, device="meta")
         for k in ("inputs", "labels")}
    with StepCounter(exclude=(params, b)) as counter:
        value_and_grad(lambda p, bb: transformer.loss_fn(p, cfg, bb),
                       params, b, has_aux=True)
    assert table <= counter.peak_bytes < 1.5 * table, \
        (counter.peak_op, counter.peak_live_by_op)


@pytest.mark.parametrize("base", [t_cr.SMOKE, t_gemma.SMOKE],
                         ids=["command-r", "gemma3"])
def test_tied_gradient_matches_autograd_and_repeats(base):
    """The tied table's gradient through ``TiedTable`` against autograd
    through the plain lookup and head (the head's and the rows' sums
    added once, in another order: fp32 rounding), on tokens that repeat;
    two calls the same bits; every other leaf's gradient the same bits."""
    cfg = base.replace(vocab_size=64)
    params = transformer.init(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, 8, (2, 16)).astype(np.int32))
    batch = {"inputs": toks, "labels": toks.roll(-1, 1)}

    def grads():
        return value_and_grad(lambda p, bb: transformer.loss_fn(p, cfg, bb),
                              params, batch, has_aux=True)[1]
    one, two = grads(), grads()
    for a, b in zip(_flat(one), _flat(two)):
        assert torch.equal(a, b)
    real = transformer.TiedTable
    try:
        transformer.TiedTable = lambda: None
        plain = grads()
    finally:
        transformer.TiedTable = real
    t, p = one["embed"]["table"], plain["embed"]["table"]
    assert torch.allclose(t, p, rtol=1e-6, atol=1e-6 * float(p.abs().max()))
    for (a, b) in zip(_flat({k: v for k, v in one.items() if k != "embed"}),
                      _flat({k: v for k, v in plain.items()
                             if k != "embed"})):
        assert torch.equal(a, b)
