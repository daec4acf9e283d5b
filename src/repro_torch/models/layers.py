"""Normalization and MLP layers (port of ``repro.models.layers``, serving
subset).

Parameters are nested dicts of tensors whose leading axes (``lead``) stack
experts and layers; each ``init_*`` draws from an explicit
``torch.Generator``. Every weight product goes through the grouped-GEMM
kernel over the leading expert axis.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.kernels.moe_gemm import grouped_gemm
from .common import ModelConfig


# ----------------------------------------------------------------- init utils
def dense_init(gen: torch.Generator, in_dim: int, out_dims, dtype,
               lead: Sequence[int] = ()) -> torch.Tensor:
    """Fan-in scaled truncated normal (±2σ) of shape lead + (in, *out)."""
    if isinstance(out_dims, int):
        out_dims = (out_dims,)
    w = torch.empty(tuple(lead) + (in_dim,) + tuple(out_dims))
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * (1.0 / math.sqrt(in_dim))).to(dtype)


# ----------------------------------------------------------------------- norm
def init_norm(cfg: ModelConfig, dim: Optional[int] = None,
              lead: Sequence[int] = ()):
    shape = tuple(lead) + (dim or cfg.d_model,)
    if cfg.norm_style == "layer":
        return {"scale": torch.ones(shape, dtype=cfg.pdtype),
                "bias": torch.zeros(shape, dtype=cfg.pdtype)}
    fill = torch.zeros if cfg.gemma_norm else torch.ones
    return {"scale": fill(shape, dtype=cfg.pdtype)}


def _expand(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(E, d) parameters against (E, ..., d) activations."""
    return p.reshape(p.shape[:-1] + (1,) * (x.ndim - p.ndim) + p.shape[-1:])


def apply_norm(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """RMSNorm / LayerNorm in fp32, cast back to the input dtype."""
    dtype = x.dtype
    x = x.float()
    scale = _expand(params["scale"].float(), x)
    if cfg.norm_style == "layer":
        mu = x.mean(dim=-1, keepdim=True)
        var = (x - mu).square().mean(dim=-1, keepdim=True)
        y = (x - mu) * torch.rsqrt(var + cfg.norm_eps)
        return (y * scale + _expand(params["bias"].float(), x)).to(dtype)
    y = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + cfg.norm_eps)
    if cfg.gemma_norm:
        scale = 1.0 + scale
    return (y * scale).to(dtype)


# ------------------------------------------------------------------------ mlp
def _act(name: str):
    # jax.nn.gelu defaults to the tanh approximation; F.gelu does not
    return {"silu": F.silu, "relu": F.relu,
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


def init_mlp(gen: torch.Generator, cfg: ModelConfig,
             d_ff: Optional[int] = None, d_in: Optional[int] = None,
             lead: Sequence[int] = ()):
    dff = d_ff or cfg.d_ff
    din = d_in or cfg.d_model
    p = {"wi": dense_init(gen, din, (2, dff) if cfg.gated_mlp else dff,
                          cfg.pdtype, lead),
         "wo": dense_init(gen, dff, din, cfg.pdtype, lead)}
    if cfg.mlp_bias:
        p["bi"] = torch.zeros(tuple(lead) + ((2, dff) if cfg.gated_mlp
                                             else (dff,)), dtype=cfg.pdtype)
        p["bo"] = torch.zeros(tuple(lead) + (din,), dtype=cfg.pdtype)
    return p


def apply_mlp(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: (E, ..., d) -> (E, ..., d); one grouped GEMM per projection."""
    act = _act(cfg.mlp_activation)
    E, din = x.shape[0], x.shape[-1]
    xc = x.reshape(E, -1, din)
    wi = params["wi"].to(cfg.cdtype)
    h = grouped_gemm(xc, wi.reshape(E, din, -1), device=x.device)
    if cfg.gated_mlp:
        h = h.unflatten(-1, (2, -1))
    if "bi" in params:
        h = h + params["bi"].to(cfg.cdtype).unsqueeze(1)
    h = act(h[..., 0, :]) * h[..., 1, :] if cfg.gated_mlp else act(h)
    out = grouped_gemm(h, params["wo"].to(cfg.cdtype), device=x.device)
    if "bo" in params:
        out = out + params["bo"].to(cfg.cdtype).unsqueeze(1)
    return out.reshape(x.shape)
