"""Mamba-2 (SSD) blocks, port of ``repro.models.ssm`` [arXiv:2405.21060].

The z/x/B/C/dt projections and ``out_proj`` are plain products in the
compute dtype, as the reference leaves them to XLA outside any kernel. The
depthwise causal conv and the gating are plain PyTorch. The chunked scan of
a full sequence is the SSD kernel (``_ssd_from_projections`` calls
``kernels.ssd.ssd``); ``ssd_chunked`` is its plain version. The norms are
the RMSNorm kernel, through ``layers.apply_norm``. Decode is the one-token
recurrence, plain PyTorch, as in the reference.

Parameters are the reference's tree; a stacked model adds a leading layer
axis to every leaf (``lead``).
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd import ssd, ssd_ref
from .common import ModelConfig
from .layers import apply_norm, dense_init, init_norm

# the chunked SSD scan, plain PyTorch (the reference's jnp oracle)
ssd_chunked = ssd_ref


def init_mamba(gen: torch.Generator, cfg: ModelConfig,
               lead: Sequence[int] = ()) -> Dict:
    d, din = cfg.d_model, cfg.d_inner
    nh, ng, st, W = (cfg.ssm_nheads, cfg.ssm_ngroups, cfg.ssm_state,
                     cfg.ssm_conv_width)
    lead = tuple(lead)

    def conv_init(ch):
        w = torch.randn(lead + (W, ch), generator=gen, dtype=torch.float32,
                        device=gen.device)
        return (w * (1.0 / math.sqrt(W))).to(cfg.pdtype)

    def full(shape, value, dtype):
        return torch.full(lead + shape, value, dtype=dtype, device=gen.device)

    return {
        "w_z": dense_init(gen, d, din, cfg.pdtype, lead),
        "w_x": dense_init(gen, d, din, cfg.pdtype, lead),
        "w_B": dense_init(gen, d, ng * st, cfg.pdtype, lead),
        "w_C": dense_init(gen, d, ng * st, cfg.pdtype, lead),
        "w_dt": dense_init(gen, d, nh, cfg.pdtype, lead),
        "conv_x_w": conv_init(din),
        "conv_x_b": full((din,), 0.0, cfg.pdtype),
        "conv_B_w": conv_init(ng * st),
        "conv_B_b": full((ng * st,), 0.0, cfg.pdtype),
        "conv_C_w": conv_init(ng * st),
        "conv_C_b": full((ng * st,), 0.0, cfg.pdtype),
        # on the host, whatever gen's device: the card's linspace and log
        # may round differently
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32,
                                          device="cpu")).expand(
            lead + (nh,)).clone(),
        "D": full((nh,), 1.0, torch.float32),
        "dt_bias": full((nh,), math.log(math.expm1(0.01)), torch.float32),
        "out_norm": init_norm(cfg, din, lead=lead),
        "out_proj": dense_init(gen, din, d, cfg.pdtype, lead),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv over (B,S,C) with taps (W,C)."""
    W = w.shape[0]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
              for i in range(W))
    return out + b[None, None, :]


def _project(params: Dict, xin: torch.Tensor, cfg: ModelConfig):
    cd = cfg.cdtype
    return tuple(xin @ params[name].to(cd)
                 for name in ("w_z", "w_x", "w_B", "w_C", "w_dt"))


def _ssd_from_projections(params, z, xs, Bm, Cm, dt, cfg: ModelConfig,
                          initial_state=None):
    """Shared tail: conv -> SSD (the kernel) -> gate -> norm -> out_proj."""
    cd = cfg.cdtype
    xs = F.silu(_causal_conv(xs, params["conv_x_w"].to(cd),
                             params["conv_x_b"].to(cd)))
    Bm = F.silu(_causal_conv(Bm, params["conv_B_w"].to(cd),
                             params["conv_B_b"].to(cd)))
    Cm = F.silu(_causal_conv(Cm, params["conv_C_w"].to(cd),
                             params["conv_C_b"].to(cd)))
    B_, S, _ = xs.shape
    nh, hd, ng, st = (cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_ngroups,
                      cfg.ssm_state)
    dtp = F.softplus(dt.float() + params["dt_bias"][None, None, :])
    A = -torch.exp(params["A_log"])
    y, final = ssd(xs.reshape(B_, S, nh, hd), dtp, A,
                   Bm.reshape(B_, S, ng, st), Cm.reshape(B_, S, ng, st),
                   params["D"], cfg.ssm_chunk, initial_state,
                   device=xs.device)
    y = y.reshape(B_, S, cfg.d_inner)
    y = apply_norm(params["out_norm"], y * F.silu(z), cfg)
    return y @ params["out_proj"].to(cd), final


def mamba_forward(params: Dict, xin: torch.Tensor, cfg: ModelConfig,
                  initial_state=None) -> torch.Tensor:
    z, xs, Bm, Cm, dt = _project(params, xin, cfg)
    out, _ = _ssd_from_projections(params, z, xs, Bm, Cm, dt, cfg,
                                   initial_state)
    return out


def mamba_prefill(params: Dict, xin: torch.Tensor, cfg: ModelConfig,
                  cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence pass that also hands back the decode cache (final SSM
    state + last conv taps per component, pre-activation)."""
    z, xs, Bm, Cm, dt = _project(params, xin, cfg)
    W = cfg.ssm_conv_width
    new_cache = {
        "conv_x": xs[:, -(W - 1):].to(cache["conv_x"].dtype),
        "conv_B": Bm[:, -(W - 1):].to(cache["conv_B"].dtype),
        "conv_C": Cm[:, -(W - 1):].to(cache["conv_C"].dtype),
    }
    out, final = _ssd_from_projections(params, z, xs, Bm, Cm, dt, cfg)
    new_cache["state"] = final
    return out, new_cache


# ------------------------------------------------------------------- decode
def init_ssm_cache(cfg: ModelConfig, batch: int, dtype=None, device=None):
    nh, hd, st, ng = (cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state,
                      cfg.ssm_ngroups)
    W = cfg.ssm_conv_width
    dt_ = dtype or cfg.cdtype
    return {
        "conv_x": torch.zeros((batch, W - 1, cfg.d_inner), dtype=dt_,
                              device=device),
        "conv_B": torch.zeros((batch, W - 1, ng * st), dtype=dt_,
                              device=device),
        "conv_C": torch.zeros((batch, W - 1, ng * st), dtype=dt_,
                              device=device),
        "state": torch.zeros((batch, nh, hd, st), dtype=torch.float32,
                             device=device),
    }


def _conv_step(hist, new, w, b):
    """hist: (B, W-1, C) pre-activation taps; new: (B, C). The tap sum is
    taken in fp32 and rounded once, as the reference's dot does."""
    full = torch.cat([hist, new[:, None]], dim=1)                # (B,W,C)
    out = (full.float() * w.float()).sum(dim=1).to(full.dtype) + b
    return F.silu(out), full[:, 1:]


def mamba_decode(params: Dict, xin: torch.Tensor, cfg: ModelConfig,
                 cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """One-token state update. xin: (B, 1, d)."""
    cd = cfg.cdtype
    z, xs, Bm, Cm, dt = _project(params, xin, cfg)
    xs1, new_cx = _conv_step(cache["conv_x"], xs[:, 0],
                             params["conv_x_w"].to(cd),
                             params["conv_x_b"].to(cd))
    Bm1, new_cB = _conv_step(cache["conv_B"], Bm[:, 0],
                             params["conv_B_w"].to(cd),
                             params["conv_B_b"].to(cd))
    Cm1, new_cC = _conv_step(cache["conv_C"], Cm[:, 0],
                             params["conv_C_w"].to(cd),
                             params["conv_C_b"].to(cd))
    B_ = xin.shape[0]
    nh, hd, ng, st = (cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_ngroups,
                      cfg.ssm_state)
    x4 = xs1.reshape(B_, nh, hd).float()
    Bm1 = Bm1.reshape(B_, ng, st).repeat_interleave(nh // ng, dim=1).float()
    Cm1 = Cm1.reshape(B_, ng, st).repeat_interleave(nh // ng, dim=1).float()
    dtp = F.softplus(dt[:, 0].float() + params["dt_bias"][None, :])
    A = -torch.exp(params["A_log"])
    dA = torch.exp(dtp * A[None, :])                             # (B,H)
    # written as products, not einsums: PyTorch's einsum plans a
    # contraction path on the host at every call
    state = cache["state"] * dA[..., None, None] \
        + (dtp[..., None] * x4)[..., None] * Bm1[:, :, None, :]
    y = (state @ Cm1[..., None])[..., 0] + x4 * params["D"][None, :, None]
    y = y.reshape(B_, 1, cfg.d_inner).to(cd)
    y = apply_norm(params["out_norm"], y * F.silu(z), cfg)
    out = y @ params["out_proj"].to(cd)
    return out, {"conv_x": new_cx.to(cache["conv_x"].dtype),
                 "conv_B": new_cB.to(cache["conv_B"].dtype),
                 "conv_C": new_cC.to(cache["conv_C"].dtype),
                 "state": state}
