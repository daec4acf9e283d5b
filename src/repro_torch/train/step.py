"""Prefill and serve step factories (port of ``repro.train.step``, serving
subset). The reference jits these; here they are plain callables that run
eagerly. ``make_train_step`` belongs to the training slice."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import transformer
from repro_torch.models.common import ModelConfig


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
