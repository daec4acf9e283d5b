"""Trunk assembly (port of ``repro.models.transformer``, serving subset).

The reference scans each segment over its stacked layer axis and, for the
MoE agent, ``vmap``s the whole trunk over experts. Here both axes are
written out: parameters of a segment position are stacked (L, E, ...), so
layer ``l`` is the contiguous slice ``[l]`` holding every expert, and
activations are (E, N, S, d). The layers run as a Python loop.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from .blocks import apply_block, init_block
from .common import ModelConfig, layer_plan
from .layers import apply_norm, dense_init, init_norm

# features of ModelConfig that the serving subset does not port
_UNPORTED = ("embed_inputs", "use_rope", "qk_norm", "qkv_bias", "use_mla",
             "parallel_block", "sandwich_norm")


def _check_supported(cfg: ModelConfig) -> None:
    on = [name for name in _UNPORTED if getattr(cfg, name)]
    if on:
        raise NotImplementedError(f"{cfg.arch_id}: {', '.join(on)} not "
                                  "ported (agent trunk subset)")


def init(gen: torch.Generator, cfg: ModelConfig, n_experts: int = 1) -> Dict:
    """Parameters of ``n_experts`` stacked trunks; the unused ``head`` leaf
    of the reference's tree is kept so the trees convert one to one."""
    _check_supported(cfg)
    segs = []
    for seg in layer_plan(cfg):
        segs.append({f"b{j}": init_block(gen, kind, cfg,
                                         lead=(seg.n_repeat, n_experts))
                     for j, kind in enumerate(seg.pattern)})
    params: Dict[str, Any] = {"segments": segs,
                              "final_norm": init_norm(cfg, lead=(n_experts,))}
    params["head"] = dense_init(gen, cfg.d_model, cfg.vocab, cfg.pdtype,
                                lead=(n_experts,))
    return params


def _layer(tree, r: int):
    if isinstance(tree, dict):
        return {k: _layer(v, r) for k, v in tree.items()}
    return tree[r]


def apply_trunk(params: Dict, cfg: ModelConfig, x: torch.Tensor, positions,
                mode: str = "forward"):
    """x: (E, N, S, d) in the compute dtype; positions (N, S).
    Returns (x, aux, cache=None)."""
    _check_supported(cfg)
    aux = torch.zeros((), device=x.device)
    for seg, seg_params in zip(layer_plan(cfg), params["segments"]):
        for r in range(seg.n_repeat):
            for j, kind in enumerate(seg.pattern):
                x, a, _ = apply_block(_layer(seg_params[f"b{j}"], r), kind, x,
                                      cfg, positions, mode)
                aux = aux + a
    return apply_norm(params["final_norm"], x, cfg), aux, None
