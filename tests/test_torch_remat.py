"""Remat (``cfg.remat``): each repetition of a segment's pattern runs
under ``torch.utils.checkpoint`` and again in the backward, or, with
``remat_save_outputs``, each block's branches do. The loss and every
gradient are the same bits with remat on, off, and saving the branch
outputs, on ``SMOKE`` TinyLlama, Qwen2-MoE, Gemma-3 (a local/global
period a checkpoint), Mamba2 and Zamba2 (the tied block in every
checkpointed group, its gradient summed over them); the norms run twice
under remat (the recompute) but the final one; serving never
recomputes; ``ChainedTrainer``'s donated steps give the same bits both
ways and keep every leaf's storage."""
import pytest
import torch

from repro_torch.convert import tree_map
from repro_torch.models import blocks, registry, transformer
from repro_torch.train import (ChainConfig, ChainedTrainer,
                               OptimizerConfig)
from repro_torch.train.step import value_and_grad

ARCHS = ["tinyllama-1.1b", "qwen2-moe-a2.7b", "gemma3-27b", "mamba2-1.3b",
         "zamba2-7b"]
MODES = {"off": dict(remat=False), "on": dict(remat=True),
         "save_outputs": dict(remat=True, remat_save_outputs=True)}


def _batch(cfg, seed, B=2, S=12):
    gen = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen)
    return {"inputs": toks[:, :-1], "labels": toks[:, 1:]}


def _norm_calls(monkeypatch):
    calls = []
    inner = blocks.apply_norm

    def counted(*a, **k):
        calls.append(1)
        return inner(*a, **k)
    monkeypatch.setattr(blocks, "apply_norm", counted)
    return calls


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_bit_equal(arch, monkeypatch):
    cfg0 = registry.get_config(arch, smoke=True)
    params = transformer.init(torch.Generator().manual_seed(0), cfg0)
    batch = _batch(cfg0, 1)
    calls = _norm_calls(monkeypatch)
    out = {}
    for name, kw in MODES.items():
        cfg = cfg0.replace(**kw)
        del calls[:]
        (loss, metrics), grads = value_and_grad(
            lambda p, b: transformer.loss_fn(p, cfg, b), params, batch,
            has_aux=True)
        flat = []
        tree_map(flat.append, grads)
        out[name] = (loss, metrics["aux"], flat, len(calls))
    loss, aux, flat, n = out["off"]
    assert n > 0
    for name in ("on", "save_outputs"):
        l2, a2, f2, n2 = out[name]
        assert torch.equal(l2, loss), name
        assert (torch.equal(a2, aux) if torch.is_tensor(aux)
                else a2 == aux), name
        assert len(f2) == len(flat)
        for i, (a, b) in enumerate(zip(f2, flat)):
            assert torch.equal(a, b), (name, i)
        assert n2 == 2 * n, (name, n, n2)     # every block norm again
    if arch == "zamba2-7b":                  # the tied block trained
        seg = out["on"][2]
        assert any(float(t.abs().sum()) > 0 for t in seg)


def test_serving_never_recomputes(monkeypatch):
    cfg = registry.get_config("tinyllama-1.1b", smoke=True)
    params = transformer.init(torch.Generator().manual_seed(0), cfg)
    params = tree_map(lambda t: t.requires_grad_(True), params)
    toks = _batch(cfg, 2)["inputs"]
    pos = torch.arange(toks.shape[1]).expand(toks.shape)
    calls = _norm_calls(monkeypatch)
    with torch.no_grad():
        transformer.forward(params, cfg, toks, pos)
        transformer.prefill(params, cfg, toks, pos)
    assert len(calls) == 2 * 2 * cfg.n_layers


def test_chained_trainer_donated_steps_bit_equal(tmp_path):
    """Two donated steps of ``ChainedTrainer`` on Zamba2 ``SMOKE`` (its
    tied block in every checkpointed group) with remat on and off: the
    same parameter and optimizer bits, every leaf in its own storage."""
    cfg0 = registry.get_config("zamba2-7b", smoke=True)
    runs = {}
    for name in ("off", "on"):
        cfg = cfg0.replace(**MODES[name])
        batches = iter([_batch(cfg, 3), _batch(cfg, 4)])
        tr = ChainedTrainer(cfg, OptimizerConfig(), ChainConfig(
            ckpt_dir=str(tmp_path / name), ckpt_every=10**6), batches,
            device="cpu")
        ptrs = []
        tree_map(lambda t: ptrs.append(t.data_ptr()),
                 (tr.params, tr.opt_state))
        for _ in range(2):
            b = next(batches)
            tr.params, tr.opt_state, m = tr.step_fn(tr.params, tr.opt_state,
                                                    b)
        after = []
        tree_map(lambda t: after.append(t.data_ptr()),
                 (tr.params, tr.opt_state))
        assert after == ptrs, name
        flat = []
        tree_map(flat.append, (tr.params, tr.opt_state))
        runs[name] = (flat, m["loss"])
    assert torch.equal(runs["on"][1], runs["off"][1])
    for a, b in zip(runs["on"][0], runs["off"][0]):
        assert torch.equal(a, b)
