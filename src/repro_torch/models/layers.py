"""Normalization, rotary embeddings (RoPE and Qwen2-VL's M-RoPE), MLP and
embedding layers (port of ``repro.models.layers``).

Parameters are nested dicts of tensors whose leading axes (``lead``) stack
layers and, for the agent, experts; each ``init_*`` draws from an explicit
``torch.Generator``, on the generator's device. The agent's MLP products go
through the grouped-GEMM kernel over the leading expert axis; the LM's MLP
(no expert axis) is the reference's einsums as ``torch.matmul``, which no
TPU kernel computed. The RMS branch of ``apply_norm`` goes through the
RMSNorm kernel. RoPE, the LM's embedding lookup and fp32 logits are plain
PyTorch, as the reference left them to XLA.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.kernels.moe_gemm import grouped_gemm
from repro_torch.kernels.rmsnorm import rmsnorm
from .common import ModelConfig


# ----------------------------------------------------------------- init utils
def dense_init(gen: torch.Generator, in_dim: int, out_dims, dtype,
               lead: Sequence[int] = ()) -> torch.Tensor:
    """Fan-in scaled truncated normal (±2σ) of shape lead + (in, *out)."""
    if isinstance(out_dims, int):
        out_dims = (out_dims,)
    w = torch.empty(tuple(lead) + (in_dim,) + tuple(out_dims),
                    dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    # scaled in place: a stacked expert leaf is tens of GB at full width
    return w.mul_(1.0 / math.sqrt(in_dim)).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               dtype) -> torch.Tensor:
    """Unit truncated normal (±2σ) of shape (vocab, dim)."""
    w = torch.empty((vocab, dim), dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w.to(dtype)


# ----------------------------------------------------------------------- norm
def init_norm(cfg: ModelConfig, dim: Optional[int] = None,
              lead: Sequence[int] = ()):
    shape = tuple(lead) + (dim or cfg.d_model,)
    if cfg.norm_style == "layer":
        # on the host: the init moves the whole tree in one pass
        return {"scale": torch.ones(shape, dtype=cfg.pdtype),  # repro-static: ok[dtype-discipline] host init constant
                "bias": torch.zeros(shape, dtype=cfg.pdtype)}  # repro-static: ok[dtype-discipline] host init constant
    fill = torch.zeros if cfg.gemma_norm else torch.ones
    return {"scale": fill(shape, dtype=cfg.pdtype)}


def _expand(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(E, d) parameters against (E, ..., d) activations."""
    return p.reshape(p.shape[:-1] + (1,) * (x.ndim - p.ndim) + p.shape[-1:])


def apply_norm(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """RMSNorm / LayerNorm in fp32, cast back to the input dtype. RMSNorm
    is the RMSNorm kernel (its scale has no expert axis); LayerNorm, which
    no TPU kernel computes, is plain PyTorch."""
    if cfg.norm_style != "layer":
        scale = params["scale"]
        if scale.ndim != 1:
            raise NotImplementedError("RMSNorm over an expert axis is not "
                                      "ported")
        return rmsnorm(x, scale, eps=cfg.norm_eps, gemma=cfg.gemma_norm,
                       device=x.device)
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + cfg.norm_eps)
    return (y * _expand(params["scale"].float(), x)
            + _expand(params["bias"].float(), x)).to(dtype)


# ----------------------------------------------------------------------- rope
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim / 2,) fp32 inverse frequencies, as the reference computes
    them in fp32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, D) rotated by angles (..., S, D/2): the split-halves
    rotation in fp32, cast back to x's dtype."""
    cos = torch.cos(angles)[..., None, :]                 # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    return _rotate(x, positions[..., None].float() * freqs)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Sequence[int]) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE. x: (B, S, H, D); positions: (3, B, S),
    the temporal, height and width streams; ``sections`` the rotary
    half-dims each stream takes, in order (they sum to D / 2). Each
    half-dim's angle is its stream's position times its frequency. Equal
    streams (text) give ``apply_rope``'s rotation."""
    half = x.shape[-1] // 2
    assert sum(sections) == half, (tuple(sections), half)
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs         # (3, B, S, D/2)
    stream = torch.tensor([i for i, n in enumerate(sections)
                           for _ in range(n)], dtype=torch.long,
                          device=x.device)                       # (D/2,)
    return _rotate(x, angles.movedim(0, -1)[
        ..., torch.arange(half, dtype=torch.long, device=x.device), stream])


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
                                             else (dff,)), dtype=cfg.pdtype,
                              device=gen.device)
        p["bo"] = torch.zeros(tuple(lead) + (din,), dtype=cfg.pdtype,
                              device=gen.device)
    return p


def apply_mlp(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The agent's layout, ``wo`` (E, d_ff, d): x (E, ..., d) -> (E, ...,
    d), one grouped GEMM per projection. The LM's, ``wo`` (d_ff, d): x
    (..., d) -> (..., d), one ``torch.matmul`` per projection."""
    if params["wo"].ndim == 2:
        return _lm_mlp(params, x, cfg)
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


def _lm_mlp(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The reference's einsums: ``wi`` (d, 2, d_ff) gated or (d, d_ff)."""
    act = _act(cfg.mlp_activation)
    wi = params["wi"].to(cfg.cdtype)
    if cfg.gated_mlp and getattr(wi, "placements", None) is not None \
            and "bi" not in params:
        # a DTensor (the dry run): gate and up one product each, since
        # flattening (2, d_ff) with d_ff sharded would gather the weight
        h = act(x @ wi[:, 0]) * (x @ wi[:, 1])
    else:
        h = x @ wi.reshape(wi.shape[0], -1)
        if cfg.gated_mlp:
            h = h.unflatten(-1, (2, -1))
        if "bi" in params:
            h = h + params["bi"].to(cfg.cdtype)
        h = act(h[..., 0, :]) * h[..., 1, :] if cfg.gated_mlp else act(h)
    out = h @ params["wo"].to(cfg.cdtype)
    if "bo" in params:
        out = out + params["bo"].to(cfg.cdtype)
    return out


# ------------------------------------------------------------------ embedding
def init_embedding(gen: torch.Generator, cfg: ModelConfig):
    return {"table": embed_init(gen, cfg.vocab, cfg.d_model, cfg.pdtype)}


class TiedTable:
    """One forward's tied table, whose gradient lives in one buffer. The
    head's product is the forward's last use of the table, so its
    backward runs first: it hands autograd the table's gradient and keeps
    it here (``grad``); the lookup's backward then sums the looked-up rows'
    gradients into that buffer in place and hands autograd none. Autograd
    alone would also allocate the lookup's own table-sized gradient and
    add the two."""

    def __init__(self):
        self.grad = None


class _TiedLookup(torch.autograd.Function):
    """``table[tokens]`` whose backward adds into the head's gradient of
    the table (``TiedTable``). A repeated token's rows are summed in a
    fixed order, so two calls give the same bits: on the card by
    ``index_put_`` accumulating (a stable sort of the tokens, then each
    token's rows in position order), on the host by ``index_add_``'s
    serial loop (the host's ``index_put_`` sums in parallel)."""

    @staticmethod
    def forward(ctx, table, tokens, tie):
        ctx.save_for_backward(tokens)
        ctx.tie, ctx.table_shape = tie, table.shape
        return table[tokens]

    @staticmethod
    def backward(ctx, g):
        tokens, = ctx.saved_tensors
        head, ctx.tie.grad = ctx.tie.grad, None
        grad = g.new_zeros(ctx.table_shape) if head is None else head
        flat, rows = tokens.reshape(-1), g.reshape(-1, g.shape[-1])
        if grad.is_cuda:
            grad.index_put_((flat,), rows, accumulate=True)
        else:
            grad.index_add_(0, flat, rows)
        # the head's buffer is autograd's already: nothing more to add
        return (grad if head is None else None), None, None


class _TiedHead(torch.autograd.Function):
    """The tied head's fp32 logits, ``x.float() @ table.float().T``. Its
    backward computes the products autograd's would and keeps the table's
    gradient in ``tie`` for the lookup's backward."""

    @staticmethod
    def forward(ctx, x, table, tie):
        ctx.save_for_backward(x, table)
        ctx.tie = tie
        return x.float() @ table.float().T

    @staticmethod
    def backward(ctx, g):
        x, table = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        gx = gt = None
        if ctx.needs_input_grad[0]:
            gx = (g2 @ table.float()).view(x.shape).to(x.dtype)
        if ctx.needs_input_grad[1]:
            gt = (g2.t() @ x.reshape(-1, x.shape[-1]).float()).to(
                table.dtype)
            ctx.tie.grad = gt
        return gx, gt, None


def embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig,
                 tie: Optional[TiedTable] = None) -> torch.Tensor:
    """Rows of the table in the compute dtype (gathered, then cast: the
    same values as the reference's cast-then-take). With ``tie`` (a tied
    table's forward) the rows' gradient goes into the head's
    (``TiedTable``)."""
    table = params["table"]
    if getattr(table, "placements", None) is not None:
        x = _embed_sharded(table, tokens).to(cfg.cdtype)
    elif tie is not None:
        x = _TiedLookup.apply(table, tokens, tie).to(cfg.cdtype)
    else:
        x = table[tokens].to(cfg.cdtype)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.cdtype,
                             device=x.device)
    return x


def _embed_sharded(table, tokens):
    """The lookup of a DTensor table (the dry run's) through ``local_map``:
    where the vocab is sharded, each rank looks up the tokens its slice
    holds and gives zeros for the rest, a partial sum there; the tokens'
    own placements elsewhere. The vocab-parallel embedding XLA partitions
    the reference's take into; DTensor's own rule for it fails in the
    backward."""
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    vocab = [i for i, p in enumerate(table.placements)
             if isinstance(p, Shard) and p.dim == 0]
    coord = mesh.get_coordinate() or [0] * mesh.ndim
    out = [Partial() if i in vocab else p
           for i, p in enumerate(tokens.placements)]

    def look(tab, tok):
        start = 0
        for i in vocab:
            start = start * mesh.size(i) + coord[i]
        rel = tok.long() - start * tab.shape[0]
        ok = (rel >= 0) & (rel < tab.shape[0])
        return F.embedding(torch.where(ok, rel, 0), tab) * ok[..., None]
    return local_map(look, out_placements=out,
                     in_placements=(tuple(table.placements),
                                    tuple(tokens.placements)),
                     device_mesh=mesh)(table, tokens)


def lm_logits(params, x: torch.Tensor, cfg: ModelConfig,
              embed_params=None, tie: Optional[TiedTable] = None
              ) -> torch.Tensor:
    """Final projection to the (padded) vocab: fp32 logits from an fp32
    product (PyTorch's default matmul precision, no TF32). ``tie``: the
    forward's ``TiedTable``, which the lookup shares."""
    if cfg.tie_embeddings:
        table = embed_params["table"]
        if tie is not None and getattr(table, "placements", None) is None:
            logits = _TiedHead.apply(x, table, tie)
        else:
            logits = x.float() @ table.float().T
    else:
        logits = x.float() @ params["head"].float()
    if cfg.final_logit_softcap:
        c = cfg.final_logit_softcap
        logits = torch.tanh(logits / c) * c
    return logits


def init_lm_head(gen: torch.Generator, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return {}
    return {"head": dense_init(gen, cfg.d_model, cfg.vocab, cfg.pdtype)}
