"""Gradient compression for the data-parallel reduction (port of
``repro.train.grad_compression``).

int8 error-feedback quantization [1-bit Adam / EF-SGD family]: each leaf is
quantized to int8 with a per-leaf scale before the reduction; the
quantization residual is fed back into the next step so the scheme is
unbiased in the long run. Implemented as a ``grad_transform`` for
``train.step.make_train_step``. ``torch.round``, like ``jnp.round``,
rounds half to even, so the codes equal the reference's.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.convert import tree_map


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_leaf(g: torch.Tensor, err: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 round trip for one leaf: returns the
    dequantized gradient and the new residual."""
    g32 = g.to(torch.float32) + err
    q, scale = quantize_int8(g32)
    deq = dequantize_int8(q, scale)
    return deq.to(g.dtype), g32 - deq


def make_error_feedback_transform(params_shape):
    """Stateful (functional) EF-int8 transform: call as
    ``grads, ef_state = apply(grads, ef_state)``; ``params_shape`` is a tree
    of tensors whose shapes and devices the residuals take."""

    def init_state():
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params_shape)

    def apply(grads, ef_state):
        errs = []
        tree_map(errs.append, ef_state)
        it = iter(errs)
        out = []
        tree_map(lambda g: out.append(compress_leaf(g, next(it))), grads)
        new_g, new_e = iter([o[0] for o in out]), iter([o[1] for o in out])
        return (tree_map(lambda _: next(new_g), grads),
                tree_map(lambda _: next(new_e), grads))

    return init_state, apply
