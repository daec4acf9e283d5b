"""Block assembly (port of ``repro.models.blocks``, serving subset: dense
attention + MLP blocks in ``forward`` mode, over a leading expert axis)."""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from .common import ModelConfig
from . import attention as attn_mod
from .layers import apply_mlp, apply_norm, init_mlp, init_norm


def init_block(gen: torch.Generator, kind: str, cfg: ModelConfig,
               lead: Sequence[int] = ()) -> Dict:
    if kind != "dense":
        raise NotImplementedError(f"block kind {kind!r} is not ported")
    return {"ln1": init_norm(cfg, lead=lead), "ln2": init_norm(cfg, lead=lead),
            "attn": attn_mod.init_attention(gen, cfg, lead),
            "ffn": init_mlp(gen, cfg, lead=lead)}


def apply_block(params: Dict, kind: str, x: torch.Tensor, cfg: ModelConfig,
                positions, mode: str = "forward"
                ) -> Tuple[torch.Tensor, torch.Tensor, None]:
    """x: (E, N, S, d). Returns (x_out, aux_loss, cache_out=None)."""
    if kind != "dense" or mode != "forward":
        raise NotImplementedError(f"block {kind!r} in mode {mode!r} is not "
                                  "ported")
    h = apply_norm(params["ln1"], x, cfg)
    x = x + attn_mod.attn_forward(params["attn"], h, cfg, positions)
    h = apply_norm(params["ln2"], x, cfg)
    x = x + apply_mlp(params["ffn"], h, cfg)
    return x, torch.zeros((), device=x.device), None
