"""Block assembly (port of ``repro.models.blocks``): dense attention + MLP
blocks, Gemma-3's local (sliding-window attention, the local RoPE theta)
and global (full attention) blocks, MoE blocks (attention + top-k MoE),
the attention + MLP blocks of a hybrid stack (``attn``: Zamba2's shared
block, full attention at ``rope_theta``) and Mamba2 SSD blocks, in three
modes, with the sandwich (post-attention, post-FFN) norms where the config
has them, MLA in place of GQA in dense and MoE blocks where it has
``use_mla``, and the parallel block (one norm feeding attention and the
FFN, ``x + (a + f)``) where it has ``parallel_block``. The agent runs dense
blocks in ``forward`` mode over a leading expert axis; the LMs run them in
every mode.

Modes: ``forward`` (no cache), ``prefill`` (cache fill), ``decode`` (one
token, cache update at ``index``).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.dist.sharding import constrain
from .common import ModelConfig
from . import attention as attn_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from .layers import apply_mlp, apply_norm, init_mlp, init_norm

_ATTN_KINDS = ("dense", "local", "global", "moe", "attn")


def _attn_opts(kind: str, cfg: ModelConfig) -> Dict:
    """The attention window and RoPE theta of a block kind."""
    if kind == "local":
        return dict(window=cfg.sliding_window,
                    theta=cfg.rope_theta_local or cfg.rope_theta)
    return dict(window=0, theta=cfg.rope_theta)


def _check_kind(kind: str) -> None:
    if kind not in _ATTN_KINDS:
        raise ValueError(f"unknown block kind {kind!r}")


def _mla(kind: str, cfg: ModelConfig) -> bool:
    """Whether a block of ``kind`` attends by MLA."""
    return cfg.use_mla and kind in ("dense", "moe")


def init_block(gen: torch.Generator, kind: str, cfg: ModelConfig,
               lead: Sequence[int] = ()) -> Dict:
    if kind == "mamba":
        return {"ln": init_norm(cfg, lead=lead),
                "mamba": ssm_mod.init_mamba(gen, cfg, lead)}
    _check_kind(kind)
    init_attn = attn_mod.init_mla if _mla(kind, cfg) else \
        attn_mod.init_attention
    p = {"ln1": init_norm(cfg, lead=lead), "ln2": init_norm(cfg, lead=lead),
         "attn": init_attn(gen, cfg, lead)}
    if kind == "moe":
        p["ffn"] = moe_mod.init_moe(gen, cfg, lead)
    elif kind == "dense" and cfg.n_experts and cfg.first_k_dense:
        # deepseek-style leading dense layer uses the wide dense d_ff
        p["ffn"] = init_mlp(gen, cfg, d_ff=cfg.shared_d_ff or cfg.d_ff,
                            lead=lead)
    else:
        p["ffn"] = init_mlp(gen, cfg, lead=lead)
    if cfg.sandwich_norm:
        p["post_ln1"] = init_norm(cfg, lead=lead)
        p["post_ln2"] = init_norm(cfg, lead=lead)
    return p


def apply_block(params: Dict, kind: str, x: torch.Tensor, cfg: ModelConfig,
                positions, mode: str = "forward", cache: Optional[Dict] = None,
                index=None) -> Tuple[torch.Tensor, object, Optional[Dict]]:
    """x: (B, S, d) for the LM, (E, N, S, d) for the agent. Returns
    (x_out, aux_loss, cache_out); the aux loss is the MoE router's, an fp32
    scalar tensor for ``moe`` blocks in ``forward`` mode, and 0.0 for the
    rest and in the cached modes, whose callers drop it: there it stays a
    Python number and costs no launch. Each branch (the norm and the
    attention, MLP, MoE or Mamba mixer behind it) runs through ``_branch``,
    which checkpoints it under ``remat_save_outputs``."""
    if kind == "mamba":
        def mixer(x):
            h = apply_norm(params["ln"], x, cfg)
            if mode == "decode":
                return ssm_mod.mamba_decode(params["mamba"], h, cfg, cache)
            if mode == "prefill":
                # prefill fills the SSM state cache with the final state
                return ssm_mod.mamba_prefill(params["mamba"], h, cfg, cache)
            return ssm_mod.mamba_forward(params["mamba"], h, cfg), cache
        y, cache = _branch(cfg, mode, mixer, x)
        return x + y, 0.0, cache
    _check_kind(kind)

    def attention(x):
        h = apply_norm(params["ln1"], x, cfg)
        a, c = _attn_part(params, kind, h, cfg, positions, mode, cache,
                          index)
        if cfg.parallel_block:
            # one norm feeds both branches; the tree keeps the reference's
            # unused ln2, whose gradient is zero
            f, aux = _ffn_part(params, kind, h, cfg, mode)
            return a + f, aux, c
        if cfg.sandwich_norm:
            a = apply_norm(params["post_ln1"], a, cfg)
        return a, 0.0, c

    def ffn(x):
        f, aux = _ffn_part(params, kind, apply_norm(params["ln2"], x, cfg),
                           cfg, mode)
        if cfg.sandwich_norm:
            f = apply_norm(params["post_ln2"], f, cfg)
        return f, aux

    a, aux, cache = _branch(cfg, mode, attention, x)
    if cfg.parallel_block:
        return x + a, aux, cache
    x = constrain(x + a, "B", "S", None)
    f, aux = _branch(cfg, mode, ffn, x)
    return x + f, aux, cache


def _branch(cfg: ModelConfig, mode: str, fn, x):
    """``fn(x)``: a block's branch. Under ``cfg.remat`` with
    ``remat_save_outputs``, in ``forward`` mode while autograd records, it
    runs under ``torch.utils.checkpoint`` (non-reentrant): what stays is
    its input, the residual stream between branches, and the backward
    runs the branch again. That is the counterpart of the reference's
    policy, which keeps each branch's output (``"block_out"``) and
    recomputes the rest: one residual-sized tensor a branch either way."""
    if (mode == "forward" and cfg.remat and cfg.remat_save_outputs
            and torch.is_grad_enabled()):
        return checkpoint(fn, x, use_reentrant=False)
    return fn(x)


def _attn_part(params: Dict, kind: str, h: torch.Tensor, cfg: ModelConfig,
               positions, mode: str, cache, index):
    """The attention branch on the normed h: (a, cache)."""
    opts = _attn_opts(kind, cfg)
    if _mla(kind, cfg):
        if mode == "decode":
            a, cache = attn_mod.mla_decode(params["attn"], h, cfg, positions,
                                           cache, index)
        elif mode == "prefill":
            a, cache = attn_mod.mla_prefill(params["attn"], h, cfg,
                                            positions, cache)
        else:
            a = attn_mod.mla_forward(params["attn"], h, cfg, positions)
    elif mode == "decode":
        a, cache = attn_mod.attn_decode(params["attn"], h, cfg, positions,
                                        cache, index, **opts)
    elif mode == "prefill":
        a, cache = attn_mod.attn_prefill(params["attn"], h, cfg, positions,
                                         cache, **opts)
    else:
        a = attn_mod.attn_forward(params["attn"], h, cfg, positions, **opts)
    return a, cache


def _ffn_part(params: Dict, kind: str, h: torch.Tensor, cfg: ModelConfig,
              mode: str):
    """The FFN branch on the normed h: (f, aux), aux the MoE router's loss
    in ``forward`` mode, else 0.0."""
    if kind == "moe":
        return moe_mod.moe_forward(params["ffn"], h, cfg,
                                   scheme=cfg.moe_scheme,
                                   with_aux=mode == "forward")
    return apply_mlp(params["ffn"], h, cfg), 0.0


def init_block_cache(kind: str, cfg: ModelConfig, batch: int, s_cache: int,
                     dtype=None, device=None) -> Dict:
    if kind == "mamba":
        return ssm_mod.init_ssm_cache(cfg, batch, dtype, device)
    _check_kind(kind)
    if _mla(kind, cfg):
        return attn_mod.init_mla_cache(cfg, batch, s_cache, dtype, device)
    window = cfg.sliding_window if kind == "local" else 0
    return attn_mod.init_kv_cache(cfg, batch, s_cache, window, dtype, device)
