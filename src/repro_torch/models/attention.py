"""Attention (port of ``repro.models.attention``, serving subset).

``attention_core`` dispatches as the reference does: ``flash`` without a
window or ``kv_len_valid`` goes to the flash-attention kernel; every other
case computes the reference math (``attention_reference``). The reference's
chunked scan computes the same function and is not ported.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.moe_gemm import grouped_gemm
from .common import ModelConfig
from .layers import dense_init

NEG_INF = -1e30


# =============================================================== core softmax
def _mask_bias(q_pos, kv_pos, causal: bool, window: int, kv_len_valid=None):
    """(…, Sq, Skv) additive bias from position comparisons."""
    qp = q_pos[..., :, None]
    kp = kv_pos[..., None, :]
    ok = kp >= 0           # kp < 0 marks unwritten ring-buffer slots
    if causal:
        ok = ok & (kp <= qp)
    if window:
        ok = ok & (qp - kp < window)
    if kv_len_valid is not None:
        ok = ok & (kp < kv_len_valid)
    return torch.where(ok, 0.0, NEG_INF).float()


def _softcap(x, cap: float):
    return torch.tanh(x / cap) * cap if cap else x


def _repeat_kv(k, v, n_heads: int):
    """Broadcast GQA KV to the full (possibly padded) q-head count; padded
    q heads past a non-dividing Hkv borrow the last kv head."""
    Hkv = k.shape[2]
    if Hkv == n_heads:
        return k, v
    if n_heads % Hkv == 0:
        rep = n_heads // Hkv
        return k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
    idx = torch.clamp(torch.arange(n_heads, device=k.device), max=Hkv - 1)
    return k[:, :, idx, :], v[:, :, idx, :]


def attention_reference(q, k, v, q_pos, kv_pos, *, causal, window=0,
                        softcap=0.0, scale=None, kv_len_valid=None):
    """q: (B,Sq,Hq,D) k/v: (B,Skv,Hkv,D[v]). Returns (B,Sq,Hq,Dv)."""
    B, Sq, Hq, D = q.shape
    k, v = _repeat_kv(k, v, Hq)
    scale = scale or (1.0 / math.sqrt(D))
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    logits = _softcap(logits, softcap)
    bias = _mask_bias(q_pos, kv_pos, causal, window, kv_len_valid)
    while bias.ndim < logits.ndim:
        bias = bias[:, None]
    probs = torch.softmax(logits + bias, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def attention_flash(q, k, v, q_pos, kv_pos, *, causal, window=0, softcap=0.0,
                    scale=None, kv_len_valid=None):
    # as in the reference, positions are implied by the sequence index
    return flash_attention(q, k, v, causal=causal, window=window,
                           softcap=softcap, scale=scale, device=q.device)


def attention_core(q, k, v, q_pos, kv_pos, cfg: ModelConfig, *, causal,
                   window=0, softcap=0.0, scale=None, kv_len_valid=None):
    impl = cfg.attn_impl
    if q.shape[1] == 1:
        impl = "reference"       # decode: (B,H,1,S) logits, no kernel
    if impl == "flash" and kv_len_valid is None and window == 0:
        return attention_flash(q, k, v, q_pos, kv_pos, causal=causal,
                               softcap=softcap, scale=scale)
    return attention_reference(q, k, v, q_pos, kv_pos, causal=causal,
                               window=window, softcap=softcap, scale=scale,
                               kv_len_valid=kv_len_valid)


# ========================================================================= GQA
def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   lead=()) -> Dict:
    nq, nkv, hd, d = cfg.nq, cfg.nkv, cfg.hd, cfg.d_model
    p = {
        "wq": dense_init(gen, d, (nq, hd), cfg.pdtype, lead),
        "wk": dense_init(gen, d, (nkv, hd), cfg.pdtype, lead),
        "wv": dense_init(gen, d, (nkv, hd), cfg.pdtype, lead),
        "wo": dense_init(gen, nq * hd, d, cfg.pdtype, lead).unflatten(
            -2, (nq, hd)),
    }
    if cfg.n_heads != nq:  # zero the padded q heads: function preserving
        mask = (torch.arange(nq) < cfg.n_heads).to(p["wq"].dtype)
        p["wq"] = p["wq"] * mask[:, None]
        p["wo"] = p["wo"] * mask[:, None, None]
    return p


def _project_qkv(params, x, cfg: ModelConfig):
    """x: (E, N, S, d) -> q, k, v of shape (E*N, S, H, hd)."""
    E, N, S, d = x.shape
    xc = x.reshape(E, N * S, d)
    out = []
    for name in ("wq", "wk", "wv"):
        w = params[name].to(cfg.cdtype)
        y = grouped_gemm(xc, w.reshape(E, d, -1), device=x.device)
        out.append(y.reshape(E * N, S, w.shape[-2], w.shape[-1]))
    return tuple(out)


def attn_forward(params, x, cfg: ModelConfig, positions, *, window: int = 0):
    """Full-sequence attention over the expert axis: x (E, N, S, d),
    positions (N, S)."""
    E, N, S, d = x.shape
    q, k, v = _project_qkv(params, x, cfg)
    pos = positions.repeat(E, 1)
    out = attention_core(q, k, v, pos, pos, cfg, causal=cfg.causal,
                         window=window, softcap=cfg.attn_logit_softcap)
    wo = params["wo"].to(cfg.cdtype)
    y = grouped_gemm(out.reshape(E, N * S, -1), wo.reshape(E, -1, d),
                     device=x.device)
    return y.reshape(E, N, S, d)
