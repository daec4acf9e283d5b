"""Train, prefill and serve step factories (port of ``repro.train.step``).

``make_train_step`` builds the update: micro-batched gradient accumulation
(a Python loop over micro-batches in place of the reference's
``lax.scan``) into an fp32 (or bf16) accumulator summed in place, as XLA
updates the scan's carry, each micro-batch's gradients dropped before the
next runs; the optional ``grad_transform`` hook (gradient compression),
and the AdamW update. The
gradient is one ``torch.autograd.grad`` over every leaf
(``value_and_grad``). Every step runs eagerly. By default, like
``adamw_update``, it returns new parameter and optimizer trees without
writing its inputs; with ``donate=True`` it takes ownership of them, as
the reference's ``ChainedTrainer`` jits its step with
``donate_argnums=(0, 1)``: the update writes the new values into the
parameter and optimizer leaves themselves and drops each gradient once
used, the same bits at 12 (bf16 m and v) or 16 bytes a parameter where
the new trees cost ~28 at the update.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from repro_torch.convert import tree_map
from repro_torch.models import transformer
from repro_torch.models.common import ModelConfig
from .optimizer import OptimizerConfig, adamw_update


def value_and_grad(loss_fn, params: Dict, *args, has_aux: bool = False):
    """(loss, grads) of ``loss_fn(params, *args)``, or ((loss, aux), grads)
    with ``has_aux`` (``loss_fn`` then returns (loss, aux)): the gradient of
    every leaf of ``params`` from one ``torch.autograd.grad``, zeros for
    leaves the loss does not reach (as ``jax.value_and_grad`` gives them)."""
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    leaves = []
    tree_map(leaves.append, p)
    out = loss_fn(p, *args)
    loss, aux = out if has_aux else (out, None)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(torch.zeros_like(t) if g is None else _at(g, t)
              for t, g in zip(leaves, grads))
    grads = tree_map(lambda _: next(it), params)
    if not has_aux:
        return loss.detach(), grads
    aux = tree_map(lambda v: v.detach() if torch.is_tensor(v) else v, aux)
    return (loss.detach(), aux), grads


def _at(g, t):
    """A DTensor leaf's gradient at the leaf's own placements: the
    data-parallel reduction of its partial sums. Any other as it is."""
    placements = getattr(t, "placements", None)
    if placements is None or tuple(g.placements) == tuple(placements):
        return g
    return g.redistribute(t.device_mesh, placements)


def _split_local(x, n: int):
    """A DTensor batch leaf split into n micro-batches on each rank's own
    rows: the local (b, ...) -> (n, b/n, ...) (M-RoPE positions, (3, b,
    S) -> (n, 3, b/n, S)), placed one dim further on. Each rank runs its
    shard in n steps, the data-parallel layout; the rows of a global
    micro-batch are every rank's i-th slice."""
    from torch.distributed.tensor import DTensor, Shard
    local = _split_microbatches({"x": x.to_local()}, n)["x"]
    placements = [Shard(p.dim + 1) if isinstance(p, Shard) else p
                  for p in x.placements]
    shape = tuple(_split_microbatches(
        {"x": torch.empty(x.shape, device="meta")}, n)["x"].shape)
    return DTensor.from_local(local, x.device_mesh, placements,
                              run_check=False, shape=shape,
                              stride=torch.empty(shape,
                                                 device="meta").stride())


def _split_microbatches(batch: Dict, n: int) -> Dict:
    """Each leaf (B, ...) -> (n, B/n, ...); positions in M-RoPE form, (3,
    B, S), split on their batch axis -> (n, 3, B/n, S). A DTensor leaf is
    split on each rank's rows (``_split_local``)."""
    def rs(x):
        if getattr(x, "placements", None) is not None:
            return _split_local(x, n)
        if x.ndim >= 1 and x.shape[0] % n == 0:
            return x.reshape((n, x.shape[0] // n) + x.shape[1:])
        if x.ndim >= 2 and x.shape[1] % n == 0:
            return x.reshape((x.shape[0], n, x.shape[1] // n)
                             + x.shape[2:]).movedim(1, 0)
        raise ValueError(f"cannot microbatch shape {tuple(x.shape)} by {n}")
    return {k: rs(v) for k, v in batch.items()}


def _accumulate(acc: List, flat: List) -> None:
    """``acc[i] += flat[i]`` in place, leaf by leaf, each gradient leaf
    dropped once added (``flat`` is emptied): the reference's scan carry,
    which XLA updates in place. The bits of ``a + g.to(acc.dtype)``: a
    gradient of a narrower dtype is widened inside the add (exact), one of
    a wider dtype rounded to the accumulator's first."""
    for i, a in enumerate(acc):
        g, flat[i] = flat[i], None
        a.add_(g if torch.promote_types(g.dtype, a.dtype) == a.dtype
               else g.to(a.dtype))
    flat.clear()


def make_train_step(cfg: ModelConfig, ocfg: OptimizerConfig,
                    num_microbatches: int = 1,
                    grad_transform: Optional[Callable] = None,
                    grad_accum_dtype: Optional[str] = None,
                    donate: bool = False):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), the metrics ``ce``, ``loss``, ``lr`` and ``grad_norm`` (and,
    with one micro-batch, ``aux`` and ``accuracy``). With ``donate`` the
    step owns ``params`` and ``opt_state``: it updates their leaves in place
    and returns the same trees (``adamw_update``'s ``donate``).

    grad_accum_dtype="bfloat16"/"bf16" accumulates micro-batch gradients in
    bf16 (halves the accumulator), as the reference allows."""
    acc_dtype = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16}.get(
        grad_accum_dtype or "", torch.float32)

    def loss_for(params, mb):
        return transformer.loss_fn(params, cfg, mb)

    def grad_fn(params, mb):
        return value_and_grad(loss_for, params, mb, has_aux=True)

    def train_step(params, opt_state, batch):
        if num_microbatches > 1:
            mbs = _split_microbatches(batch, num_microbatches)
            dev = next(iter(batch.values())).device
            acc = []
            tree_map(lambda p: acc.append(torch.zeros_like(p,
                                                           dtype=acc_dtype)),
                     params)
            loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
            ce_sum = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(num_microbatches):
                (loss, metrics), g = grad_fn(
                    params, {k: v[i] for k, v in mbs.items()})
                flat = []
                tree_map(flat.append, g)
                del g
                _accumulate(acc, flat)
                loss_sum = loss_sum + loss
                ce_sum = ce_sum + metrics["ce"]
            for a in acc:
                a.div_(num_microbatches)
            it = iter(acc)
            grads = tree_map(lambda _: next(it), params)
            del acc, it
            loss = loss_sum / num_microbatches
            metrics = {"ce": ce_sum / num_microbatches}
        else:
            (loss, metrics), grads = grad_fn(params, batch)
        if grad_transform is not None:
            grads = grad_transform(grads)
        params, opt_state, opt_metrics = adamw_update(
            grads, params, opt_state, ocfg, donate=donate)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, s_cache: Optional[int] = None):
    """prefill_step(params, inputs, positions) -> (last-token logits,
    cache); a vision-language model's also takes ``vision_embeds`` and
    ``vision_mask``, merged at the image tokens."""
    def prefill_step(params, inputs, positions, vision_embeds=None,
                     vision_mask=None):
        return transformer.prefill(params, cfg, inputs, positions, s_cache,
                                   vision_embeds, vision_mask)
    return prefill_step


def make_serve_step(cfg: ModelConfig, sample: str = "greedy"):
    """One new token against the cache: the argmax, whatever ``sample``
    names, as the reference takes it."""
    def serve_step(params, token, positions, cache, index):
        logits, cache = transformer.decode_step(params, cfg, token, positions,
                                                cache, index)
        # argmax as max's first index (DTensor's argmax fails on a rank
        # holding one row of vocab-sharded logits)
        next_token = logits.max(-1).indices.to(torch.int32)[:, None]
        return next_token, logits, cache
    return serve_step
