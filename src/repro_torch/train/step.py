"""Train, prefill and serve step factories (port of ``repro.train.step``).

``make_train_step`` builds the update: micro-batched gradient accumulation
(a Python loop over micro-batches in place of the reference's
``lax.scan``), an fp32 (or bf16) accumulator, the optional
``grad_transform`` hook (gradient compression), and the AdamW update. The
reference jits the update and donates its arguments; here every step runs
eagerly and, like ``adamw_update``, returns new parameter and optimizer
trees without writing its inputs. The gradient is one
``torch.autograd.grad`` over every leaf (``value_and_grad``).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

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
    it = iter(torch.zeros_like(t) if g is None else g
              for t, g in zip(leaves, grads))
    grads = tree_map(lambda _: next(it), params)
    if not has_aux:
        return loss.detach(), grads
    aux = tree_map(lambda v: v.detach() if torch.is_tensor(v) else v, aux)
    return (loss.detach(), aux), grads


def _split_microbatches(batch: Dict, n: int) -> Dict:
    """Each leaf (B, ...) -> (n, B/n, ...); positions in M-RoPE form, (3,
    B, S), split on their batch axis -> (n, 3, B/n, S)."""
    def rs(x):
        if x.ndim >= 1 and x.shape[0] % n == 0:
            return x.reshape((n, x.shape[0] // n) + x.shape[1:])
        if x.ndim >= 2 and x.shape[1] % n == 0:
            return x.reshape((x.shape[0], n, x.shape[1] // n)
                             + x.shape[2:]).movedim(1, 0)
        raise ValueError(f"cannot microbatch shape {tuple(x.shape)} by {n}")
    return {k: rs(v) for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, ocfg: OptimizerConfig,
                    num_microbatches: int = 1,
                    grad_transform: Optional[Callable] = None,
                    grad_accum_dtype: Optional[str] = None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), the metrics ``ce``, ``loss``, ``lr`` and ``grad_norm`` (and,
    with one micro-batch, ``aux`` and ``accuracy``).

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
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dtype,
                                                   device=p.device), params)
            loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
            ce_sum = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(num_microbatches):
                (loss, metrics), g = grad_fn(
                    params, {k: v[i] for k, v in mbs.items()})
                flat = []
                tree_map(flat.append, g)
                it = iter(flat)
                grads = tree_map(lambda a: a + next(it).to(acc_dtype), grads)
                loss_sum = loss_sum + loss
                ce_sum = ce_sum + metrics["ce"]
            grads = tree_map(lambda g: g / num_microbatches, grads)
            loss = loss_sum / num_microbatches
            metrics = {"ce": ce_sum / num_microbatches}
        else:
            (loss, metrics), grads = grad_fn(params, batch)
        if grad_transform is not None:
            grads = grad_transform(grads)
        params, opt_state, opt_metrics = adamw_update(grads, params,
                                                      opt_state, ocfg)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, s_cache: Optional[int] = None):
    def prefill_step(params, inputs, positions):
        return transformer.prefill(params, cfg, inputs, positions, s_cache)
    return prefill_step


def make_serve_step(cfg: ModelConfig, sample: str = "greedy"):
    """One new token against the cache: the argmax, whatever ``sample``
    names, as the reference takes it."""
    def serve_step(params, token, positions, cache, index):
        logits, cache = transformer.decode_step(params, cfg, token, positions,
                                                cache, index)
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return next_token, logits, cache
    return serve_step
