"""Attention (port of ``repro.models.attention``: GQA with RoPE or
Qwen2-VL's M-RoPE, QK-norm and a KV cache, full or a sliding-window ring
buffer; DeepSeek-V2's Multi-head Latent Attention (MLA) with its latent
cache).

Positions are (B, S), or (3, B, S) under M-RoPE: the (t, h, w) streams
rotate q and k, and the masks read the temporal stream (``_pos1d``), as
the reference's do. The flash kernel masks by sequence index instead, in
both packages, so with an image's repeated temporal positions
``"flash"`` and ``"reference"`` compute different functions.

``attention_core`` dispatches as the reference does, with one deliberate
divergence: ``flash`` with no ``kv_len_valid`` and more than one query goes
to the flash-attention kernel, with or without a window. The reference
sends a window to its chunked scan; the kernel's window mask takes its
place here. ``chunked`` (and ``flash`` with ``kv_len_valid``) runs
``attention_chunked``, the reference's flash-style scan over kv chunks
with its recomputing backward; decode (one query) and ``reference`` run
the reference math (``attention_reference``). Padded q heads that do not
divide into the kv heads reach the kernel with K/V broadcast to the q
heads by ``_repeat_kv`` (a padded head reads the last kv head), since the
kernel takes only Hq % Hkv == 0.

Two layouts share the projections. The LM's: x (B, S, d), ``wq`` (d, H,
hd), products by ``torch.matmul`` as the reference's einsums. The agent's:
x (E, N, S, d) over its expert axis, ``wq`` (E, d, H, hd), products by the
grouped-GEMM kernel. The parameters' rank tells them apart.

KV caches are (B, S_cache, n_kv, hd) buffers; a layer with a window holds
only min(window, S_cache) slots and writes position p to slot p % size.
Prefill and decode return a new cache and never write the one they are
given. Decode's ``index`` (the tokens already in the cache) is a scalar or
one per row, (B,): each row writes its own slot and masks by its own
length, or by its own ring's positions, which is what the reference
computes for a row when it ``vmap``s a single-sequence decode over a batch.

MLA caches each position's compressed latent (``ckv``, kv_lora wide) and
its one RoPE key (``kr``, shared by every head) instead of K and V. The
training forward expands them to per-head K/V and runs the reference math
(q.k is nope + rope wide, v only v_head_dim: ``attention_reference``
takes that; the flash kernel does not, and the config keeps
``attn_impl="reference"``). Prefill runs ``mla_latent_chunked``, the
reference's scan: it expands the latent one kv chunk at a time inside an
fp32 online softmax, so the full expanded K/V never exists. The reference
states it in jnp (a ``jax.lax.scan`` that no ``pallas_call`` computes),
and so it stays plain PyTorch here, with the reference's chunks in its
order; the port only runs the heads in groups (``MLA_LOGITS_BYTES``),
which changes no value. Decode absorbs W_uk into the query and W_uv after
the latent-space combine, in fp32, over the whole latent cache.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import constrain
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.moe_gemm import grouped_gemm
from repro_torch.roofline.scope import kernel_scope
from .common import ModelConfig
from .layers import apply_mrope, apply_norm, apply_rope, dense_init, init_norm

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
    if kv_len_valid is not None:    # a scalar, or one length a row: (B,)
        lim = torch.as_tensor(kv_len_valid, device=kp.device)
        ok = ok & (kp < lim.reshape(lim.shape + (1,) * (kp.ndim - lim.ndim)))
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
    idx = torch.clamp(torch.arange(n_heads, dtype=torch.long, device=k.device),
                      max=Hkv - 1)
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


def _chunk_logits(qs, k_i, q_pos, p_i, causal, window, softcap,
                  kv_len_valid):
    """A kv chunk's raw and masked fp32 logits (B, H, Sq, c) of the scaled
    queries ``qs`` against ``k_i``."""
    raw = torch.einsum("bqhd,bkhd->bhqk", qs, k_i.float())
    capped = _softcap(raw, softcap)
    bias = _mask_bias(q_pos, p_i, causal, window, kv_len_valid)
    while bias.ndim < 4:
        bias = bias[:, None]
    return capped, capped + bias


class _ChunkedFn(torch.autograd.Function):
    """The reference's ``_make_flash_chunked``: an fp32 online softmax
    over kv chunks that saves each row's log-sum-exp, and a backward that
    recomputes each chunk's probabilities from it, so the residuals are
    O(S), never the (Sq, Skv) probabilities. Hq == Hkv (the caller
    repeats GQA's kv; autograd of the repeat sums the groups' gradients).

    The sequence is cut at multiples of ``chunk``; the last chunk is as
    long as what is left. The reference pads it with zero keys at position
    2**30, which only a causal mask removes: without one they add to the
    softmax's denominator. Here no padded key exists, which is the
    reference's function with the padding masked by its index."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, causal, window, softcap, scale,
                chunk, kv_len_valid):
        qs = q.float() * scale
        Skv = k.shape[1]
        m = l = acc = None
        for c0 in range(0, Skv, chunk):
            with kernel_scope("flash_attention"):
                c = slice(c0, min(Skv, c0 + chunk))
                _, logits = _chunk_logits(qs, k[:, c], q_pos,
                                          kv_pos[..., c], causal, window,
                                          softcap, kv_len_valid)
                v_i = v[:, c].float()
                if m is None:       # the first chunk: nothing to rescale
                    m = logits.amax(dim=-1)
                    p = torch.exp(logits - m[..., None])
                    l = p.sum(dim=-1)
                    acc = torch.einsum("bhqk,bkhd->bhqd", p, v_i)
                    continue
                m_new = torch.maximum(m, logits.amax(dim=-1))
                corr = torch.exp(m - m_new)
                p = torch.exp(logits - m_new[..., None])
                l = l * corr + p.sum(dim=-1)
                acc = acc * corr[..., None] + torch.einsum(
                    "bhqk,bkhd->bhqd", p, v_i)
                m = m_new
        l = torch.clamp(l, min=1e-30)
        lse = m + torch.log(l)                                 # (B,H,Sq)
        out = (acc / l[..., None]).transpose(1, 2).to(q.dtype)
        ctx.save_for_backward(q, k, v, q_pos, kv_pos, out, lse)
        ctx.opts = (causal, window, softcap, scale, chunk, kv_len_valid)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, q_pos, kv_pos, out, lse = ctx.saved_tensors
        causal, window, softcap, scale, chunk, kv_len_valid = ctx.opts
        qs = q.float() * scale
        go = g.float().transpose(1, 2)                       # (B,H,Sq,Dv)
        delta = (go * out.float().transpose(1, 2)).sum(dim=-1)
        Skv = k.shape[1]
        dq, dks, dvs = None, [], []
        for c0 in range(0, Skv, chunk):
            with kernel_scope("flash_attention"):
                c = slice(c0, min(Skv, c0 + chunk))
                k_i = k[:, c].float()
                capped, logits = _chunk_logits(qs, k_i, q_pos,
                                               kv_pos[..., c], causal,
                                               window, softcap, kv_len_valid)
                p = torch.exp(logits - lse[..., None])       # (B,H,Sq,c)
                dvs.append(torch.einsum("bhqk,bhqd->bkhd", p, go))
                dp = torch.einsum("bhqd,bkhd->bhqk", go, v[:, c].float())
                ds = p * (dp - delta[..., None])
                if softcap:
                    ds = ds * (1.0 - torch.square(capped / softcap))
                dq_i = torch.einsum("bhqk,bkhd->bqhd", ds, k_i)
                dq = dq_i if dq is None else dq + dq_i
                # dk needs no extra scale: qs already carries it
                dks.append(torch.einsum("bhqk,bqhd->bkhd", ds, qs))
        dk = torch.cat(dks, dim=1) if len(dks) > 1 else dks[0]
        dv = torch.cat(dvs, dim=1) if len(dvs) > 1 else dvs[0]
        return ((dq * scale).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None, None, None, None)


def attention_chunked(q, k, v, q_pos, kv_pos, *, causal, window=0,
                      softcap=0.0, scale=None, chunk=1024, kv_len_valid=None):
    """Online softmax over kv chunks of ``chunk`` (``_ChunkedFn``): q
    (B,Sq,Hq,D), k/v (B,Skv,Hkv,D[v]) -> (B,Sq,Hq,Dv) in q's dtype, the
    reference's ``attention_chunked`` with windows, softcap and
    ``kv_len_valid`` (a scalar or one a row) in its masks."""
    Hq, D = q.shape[2], q.shape[3]
    k, v = _repeat_kv(k, v, Hq)
    scale = scale or (1.0 / math.sqrt(D))
    opts = (bool(causal), int(window), float(softcap), scale,
            int(min(chunk, k.shape[1])), kv_len_valid)
    if getattr(q, "placements", None) is not None:
        return _chunked_local(q, k, v, q_pos, kv_pos, opts)
    return _ChunkedFn.apply(q, k, v, q_pos, kv_pos, *opts)


def _chunked_local(q, k, v, q_pos, kv_pos, opts):
    """``_ChunkedFn`` on DTensors through ``local_map``: every (batch row,
    head) is independent, so each rank runs the scan on its own rows and
    heads. q, k and v are placed as q is on its batch and head dims (k and
    v sliced to q's heads where they arrive replicated), replicated on
    any other; the positions follow the batch. The counterpart of the
    kernel the reference's SPMD partitioner runs per device."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    if opts[5] is not None:
        raise NotImplementedError("kv_len_valid on DTensors")
    qkv = tuple(p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
                for p in q.placements)
    pos = tuple(Shard(0) if p == Shard(0) else Replicate() for p in qkv)
    fn = local_map(lambda *a: _ChunkedFn.apply(*a, *opts[:5], None),
                   out_placements=list(qkv),
                   in_placements=(qkv, qkv, qkv, pos, pos),
                   device_mesh=q.device_mesh, redistribute_inputs=True)
    return fn(q, k, v, q_pos, kv_pos)


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
    if impl == "flash" and kv_len_valid is None:
        # a window too: the reference's chunked scan computes this function
        if q.shape[2] % k.shape[2]:      # padded q heads: Hq = Hkv
            k, v = _repeat_kv(k, v, q.shape[2])
        return attention_flash(q, k, v, q_pos, kv_pos, causal=causal,
                               window=window, softcap=softcap, scale=scale)
    if impl in ("chunked", "flash"):
        return attention_chunked(q, k, v, q_pos, kv_pos, causal=causal,
                                 window=window, softcap=softcap, scale=scale,
                                 chunk=cfg.attn_chunk,
                                 kv_len_valid=kv_len_valid)
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
        mask = (torch.arange(nq, dtype=torch.long, device=p["wq"].device)
                < cfg.n_heads).to(p["wq"].dtype)
        p["wq"] = p["wq"] * mask[:, None]
        p["wo"] = p["wo"] * mask[:, None, None]
    if cfg.qkv_bias:
        lead = tuple(lead)
        p["bq"] = torch.zeros(lead + (nq, hd), dtype=cfg.pdtype,
                               device=gen.device)
        p["bk"] = torch.zeros(lead + (nkv, hd), dtype=cfg.pdtype,
                               device=gen.device)
        p["bv"] = torch.zeros(lead + (nkv, hd), dtype=cfg.pdtype,
                               device=gen.device)
    if cfg.qk_norm:
        p["q_norm"] = init_norm(cfg, hd, lead)
        p["k_norm"] = init_norm(cfg, hd, lead)
    return p


def _project_qkv(params, x, cfg: ModelConfig, positions=None, theta=None):
    """The LM's x (B, S, d) -> q, k, v (B, S, H, hd), the QKV biases added
    in the compute dtype where the config has them, q and k RMS-normed
    over hd where it has QK-norm, then RoPE'd at ``positions`` (B, S) with
    ``theta`` (the config's ``rope_theta`` by default) where it uses RoPE;
    the agent's x (E, N, S, d) -> (E*N, S, H, hd), one grouped GEMM a
    projection. Under M-RoPE ``positions`` are (3, B, S) and rotate by
    ``apply_mrope``; otherwise 3-D positions rotate by their temporal
    stream."""
    if params["wq"].ndim == 4:
        E, N, S, d = x.shape
        xc = x.reshape(E, N * S, d)
        out = []
        for name in ("wq", "wk", "wv"):
            w = params[name].to(cfg.cdtype)
            y = grouped_gemm(xc, w.reshape(E, d, -1), device=x.device)
            out.append(y.reshape(E * N, S, w.shape[-2], w.shape[-1]))
        return tuple(out)
    out = []
    for name in ("wq", "wk", "wv"):
        w = params[name].to(cfg.cdtype)
        y = (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])
        if cfg.qkv_bias:
            y = y + params["b" + name[1]].to(cfg.cdtype)
        out.append(y)
    q, k, v = out
    if cfg.qk_norm:
        q = apply_norm(params["q_norm"], q, cfg)
        k = apply_norm(params["k_norm"], k, cfg)
    if cfg.use_rope:
        theta = theta or cfg.rope_theta
        if cfg.mrope_sections:
            q = apply_mrope(q, positions, theta, cfg.mrope_sections)
            k = apply_mrope(k, positions, theta, cfg.mrope_sections)
        else:
            q = apply_rope(q, _pos1d(positions), theta)
            k = apply_rope(k, _pos1d(positions), theta)
    return q, k, v


def _pos1d(positions):
    """(B, S) positions as they are; M-RoPE's (3, B, S): the temporal
    stream, which the masks read."""
    return positions if positions.ndim <= 2 else positions[0]


def _out_proj(params, out, cfg: ModelConfig):
    """(B, S, H, hd) -> (B, S, d): the reference's ``...hk,hkd->...d``."""
    wo = params["wo"].to(cfg.cdtype)
    return out.flatten(-2) @ wo.reshape(-1, wo.shape[-1])


def attn_forward(params, x, cfg: ModelConfig, positions, *, window: int = 0,
                 theta=None):
    """Full-sequence attention: the LM's x (B, S, d) with positions (B, S),
    or (3, B, S) under M-RoPE, or the agent's x (E, N, S, d) over its
    expert axis, positions (N, S); ``window`` > 0 masks keys more than
    window - 1 positions back."""
    lm = params["wq"].ndim == 3
    q, k, v = _project_qkv(params, x, cfg, positions, theta)
    pos = _pos1d(positions) if lm else positions.repeat(x.shape[0], 1)
    out = attention_core(q, k, v, pos, pos, cfg, causal=cfg.causal,
                         window=window, softcap=cfg.attn_logit_softcap)
    if lm:
        return _out_proj(params, out, cfg)
    E, N, S, d = x.shape
    wo = params["wo"].to(cfg.cdtype)
    y = grouped_gemm(out.reshape(E, N * S, -1), wo.reshape(E, -1, d),
                     device=x.device)
    return y.reshape(E, N, S, d)


# ==================================================================== KV cache
def init_kv_cache(cfg: ModelConfig, batch: int, s_cache: int, window: int = 0,
                  dtype=None, device=None):
    """Zero (batch, size, n_kv, hd) K and V buffers in ``dtype`` (the
    compute dtype by default): size = s_cache, or min(window, s_cache) for
    a layer with a window (its ring buffer)."""
    size = min(window, s_cache) if window else s_cache
    shape = (batch, size, cfg.nkv, cfg.hd)
    dtype = dtype or cfg.cdtype
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_prefill(params, x, cfg: ModelConfig, positions, cache, *,
                 window: int = 0, theta=None):
    """Attention over the prompt x (B, S, d), full or within ``window``,
    and a new cache holding its K/V: the trailing ``size`` positions laid
    out so position p sits at slot p % size when the prompt fills the
    cache (a window's ring buffer fills so), else the prompt's K/V in the
    first S slots and the given cache's after them."""
    q, k, v = _project_qkv(params, x, cfg, positions, theta)
    # the cache's layout (sequence on "model") inside the layer, as the
    # reference constrains it
    k = constrain(k, "B", "M", None, None)
    v = constrain(v, "B", "M", None, None)
    pos = _pos1d(positions)
    out = attention_core(q, k, v, pos, pos, cfg, causal=cfg.causal,
                         window=window, softcap=cfg.attn_logit_softcap)
    size, S = cache["k"].shape[1], k.shape[1]
    new = {}
    for name, t in (("k", k), ("v", v)):
        t = t.to(cache[name].dtype)
        if S >= size:
            new[name] = torch.roll(t[:, S - size:], S % size, dims=1)
        else:
            new[name] = torch.cat([t, cache[name][:, S:]], dim=1)
    return _out_proj(params, out, cfg), new


def attn_decode(params, x, cfg: ModelConfig, positions, cache, index, *,
                window: int = 0, theta=None):
    """One-token decode: x (B, 1, d), positions (B, 1) or (3, B, 1) under
    M-RoPE, ``index`` the tokens already in the cache, a scalar or (B,). Without a window the
    token's K/V go to slot min(index, size - 1) of a new cache and the
    query attends to its first index + 1 slots. With one the cache is a
    ring: the token goes to slot index % size, slot j holds position j +
    (index // size) * size up to that slot and one ring earlier after it
    (negative: never written, masked), and the query attends to the
    positions within the window."""
    q, k, v = _project_qkv(params, x, cfg, positions, theta)
    size = cache["k"].shape[1]
    index = torch.as_tensor(index, device=x.device)
    col = index.reshape(-1, 1)                               # (B or 1, 1)
    slot = col % size if window else torch.clamp(col, max=size - 1)
    j = torch.arange(size, dtype=torch.long, device=x.device)
    hit = (j == slot)[:, :, None, None]
    cache = {"k": torch.where(hit, k.to(cache["k"].dtype), cache["k"]),
             "v": torch.where(hit, v.to(cache["v"].dtype), cache["v"])}
    B = x.shape[0]
    kc, vc = cache["k"].to(cfg.cdtype), cache["v"].to(cfg.cdtype)
    q_pos = _pos1d(positions)
    if window:
        base = col // size * size
        kv_pos = torch.where(j <= slot, j + base, j + base - size)
        out = attention_core(q, kc, vc, q_pos, kv_pos.expand(B, size),
                             cfg, causal=True, window=window,
                             softcap=cfg.attn_logit_softcap)
    else:
        out = attention_core(q, kc, vc, q_pos, j.expand(B, size), cfg,
                             causal=True, softcap=cfg.attn_logit_softcap,
                             kv_len_valid=index + 1)
    return _out_proj(params, out, cfg), cache


# ========================================================================= MLA
# the fp32 logits of one kv chunk that ``mla_latent_chunked`` holds at once,
# at most: by its shape a 4 x 2048 prefill's chunk of 1024 over
# DeepSeek-V2's 128 heads is 4.3 GB, a group of 32 heads 1.07 GB
MLA_LOGITS_BYTES = 1 << 30


def init_mla(gen: torch.Generator, cfg: ModelConfig,
             lead: Sequence[int] = ()) -> Dict:
    """The reference's MLA leaves: the q down- and up-projections around
    ``q_norm``, the kv down-projection and ``kv_norm``, the shared RoPE key
    ``w_kr``, the per-head key and value up-projections ``w_uk``/``w_uv``
    and ``wo`` (H, v_head_dim, d)."""
    d, H = cfg.d_model, cfg.nq
    qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    return {
        "w_dq": dense_init(gen, d, cfg.q_lora_rank, cfg.pdtype, lead),
        "q_norm": init_norm(cfg, cfg.q_lora_rank, lead),
        "w_uq": dense_init(gen, cfg.q_lora_rank, (H, qk), cfg.pdtype, lead),
        "w_dkv": dense_init(gen, d, cfg.kv_lora_rank, cfg.pdtype, lead),
        "kv_norm": init_norm(cfg, cfg.kv_lora_rank, lead),
        "w_kr": dense_init(gen, d, cfg.qk_rope_head_dim, cfg.pdtype, lead),
        "w_uk": dense_init(gen, cfg.kv_lora_rank, (H, cfg.qk_nope_head_dim),
                           cfg.pdtype, lead),
        "w_uv": dense_init(gen, cfg.kv_lora_rank, (H, cfg.v_head_dim),
                           cfg.pdtype, lead),
        "wo": dense_init(gen, H * cfg.v_head_dim, d, cfg.pdtype,
                         lead).unflatten(-2, (H, cfg.v_head_dim)),
    }


def _up(x, w, cfg: ModelConfig):
    """x (..., r) through a (r, H, k) up-projection: (..., H, k), the
    reference's ``...r,rhk->...hk`` in the compute dtype."""
    w = w.to(cfg.cdtype)
    return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def _mla_q(params, x, cfg: ModelConfig, positions):
    """x (B, S, d) -> (q_nope (B, S, H, nope), q_rope (B, S, H, rope)),
    the rope part RoPE'd at ``positions`` (B, S)."""
    cq = apply_norm(params["q_norm"], x @ params["w_dq"].to(cfg.cdtype), cfg)
    q = _up(cq, params["w_uq"], cfg)
    qn, qr = q.split([cfg.qk_nope_head_dim, cfg.qk_rope_head_dim], dim=-1)
    return qn, apply_rope(qr, positions, cfg.rope_theta)


def _mla_latent(params, x, cfg: ModelConfig, positions):
    """x (B, S, d) -> (the normed latent ckv (B, S, kv_lora), the RoPE key
    kr (B, S, rope)): kr is one key for every head, RoPE'd through a head
    axis of 1."""
    ckv = apply_norm(params["kv_norm"],
                     x @ params["w_dkv"].to(cfg.cdtype), cfg)
    kr = x @ params["w_kr"].to(cfg.cdtype)
    kr = apply_rope(kr[..., None, :], positions, cfg.rope_theta)[..., 0, :]
    return ckv, kr


def _mla_scale(cfg: ModelConfig) -> float:
    """1 / sqrt(nope + rope): q.k's width, not v's."""
    return 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)


def mla_forward(params, x, cfg: ModelConfig, positions):
    """Training / prefill-compute MLA: expand K/V per head (the RoPE key
    broadcast to every head) and run causal attention at ``_mla_scale``."""
    qn, qr = _mla_q(params, x, cfg, positions)
    ckv, kr = _mla_latent(params, x, cfg, positions)
    kn = _up(ckv, params["w_uk"], cfg)
    v = _up(ckv, params["w_uv"], cfg)
    q = torch.cat([qn, qr], dim=-1)
    k = torch.cat([kn, kr[..., None, :].expand(
        kn.shape[:-1] + (cfg.qk_rope_head_dim,))], dim=-1)
    out = attention_core(q, k, v, positions, positions, cfg, causal=True,
                         scale=_mla_scale(cfg))
    return _out_proj(params, out, cfg)


def mla_latent_chunked(qn, qr, ckv, kr, w_uk, w_uv, wo, cfg: ModelConfig,
                       chunk: int = 1024):
    """Prefill attention over the latent: the kv positions in chunks of
    ``chunk`` (the tail padded and masked past S), each chunk's latent
    expanded to its keys and values in fp32 inside an fp32 online softmax,
    queries at positions 0..Sq-1 attending causally. Heads run in groups
    whose chunk logits fit ``MLA_LOGITS_BYTES``, each group over every
    chunk in order: a head's arithmetic is the reference's."""
    B, Sq, H, Dn = qn.shape
    Dr, R, Dv = qr.shape[-1], ckv.shape[-1], cfg.v_head_dim
    S = ckv.shape[1]
    chunk = min(chunk, S)
    n = -(-S // chunk)
    pad = n * chunk - S
    if pad:
        ckv = F.pad(ckv, (0, 0, 0, pad))
        kr = F.pad(kr, (0, 0, 0, pad))
    dev = qn.device
    scale = _mla_scale(cfg)
    qnf = (qn.float() * scale).transpose(1, 2)              # (B, H, Sq, Dn)
    qrf = (qr.float() * scale).transpose(1, 2)              # (B, H, Sq, Dr)
    q_pos = torch.arange(Sq, dtype=torch.long, device=dev)[None]
    group = max(1, min(H, MLA_LOGITS_BYTES // (4 * B * Sq * chunk)))
    out = torch.empty((B, Sq, H, Dv), dtype=cfg.cdtype, device=dev)
    for h0 in range(0, H, group):
        hs = slice(h0, min(H, h0 + group))
        g = hs.stop - h0
        w_k = w_uk[:, hs].float().reshape(R, g * Dn)
        w_v = w_uv[:, hs].float().reshape(R, g * Dv)
        m = torch.full((B, g, Sq), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, g, Sq), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, g, Sq, Dv), dtype=torch.float32, device=dev)
        for ci in range(n):
            with kernel_scope("flash_attention"):
                c = slice(ci * chunk, (ci + 1) * chunk)
                ckv_i = ckv[:, c].float()                      # (B, k, R)
                kn_i = (ckv_i @ w_k).unflatten(-1, (g, Dn)).permute(
                    0, 2, 3, 1)
                v_i = (ckv_i @ w_v).unflatten(-1, (g, Dv)).transpose(1, 2)
                logits = qnf[:, hs] @ kn_i                     # (B,g,Sq,k)
                logits += (qrf[:, hs]
                           @ kr[:, c].float().transpose(1, 2)[:, None])
                kv_pos = ci * chunk + torch.arange(
                    chunk, dtype=torch.long, device=dev)[None]
                logits += _mask_bias(q_pos, kv_pos, True, 0, S)[:, None]
                m_new = torch.maximum(m, logits.amax(dim=-1))
                corr = torch.exp(m - m_new)
                p = logits.sub_(m_new[..., None]).exp_()
                l = l * corr + p.sum(dim=-1)
                acc = acc * corr[..., None] + p @ v_i
                m = m_new
                del logits, p
        out[:, :, hs] = (acc / torch.clamp(l, min=1e-30)[..., None]).to(
            cfg.cdtype).transpose(1, 2)
    wo = wo.to(cfg.cdtype)
    return out.flatten(-2) @ wo.reshape(-1, wo.shape[-1])


def _mla_scan_local(qn, qr, ckv, kr, w_uk, w_uv, wo, cfg: ModelConfig,
                    chunk: int):
    """``mla_latent_chunked`` on DTensors (the dry run's) through
    ``local_map``: each rank scans its batch rows and its heads over every
    position (the latents gathered whole on the head dims), with its
    slice of the up-projections and of ``wo``; the output a partial sum
    over the head dims."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    rows = tuple(p == Shard(0) for p in qn.placements)
    heads = tuple(p == Shard(2) for p in qn.placements)

    def pl(dim_if_heads, batch=True):
        return tuple(Shard(0) if r and batch else
                     Shard(dim_if_heads) if h and dim_if_heads is not None
                     else Replicate() for r, h in zip(rows, heads))
    return local_map(
        lambda *a: mla_latent_chunked(*a, cfg, chunk=chunk),
        out_placements=[Shard(0) if r else Partial() if h else Replicate()
                        for r, h in zip(rows, heads)],
        in_placements=(pl(2), pl(2), pl(None), pl(None), pl(1, False),
                       pl(1, False), pl(0, False)),
        device_mesh=qn.device_mesh, redistribute_inputs=True)(
            qn, qr, ckv, kr, w_uk, w_uv, wo)


def init_mla_cache(cfg: ModelConfig, batch: int, s_cache: int, dtype=None,
                   device=None):
    """Zero latent caches in ``dtype`` (the compute dtype by default):
    ``ckv`` (batch, s_cache, kv_lora) and ``kr`` (batch, s_cache, rope)."""
    dtype = dtype or cfg.cdtype
    return {"ckv": torch.zeros((batch, s_cache, cfg.kv_lora_rank),
                               dtype=dtype, device=device),
            "kr": torch.zeros((batch, s_cache, cfg.qk_rope_head_dim),
                              dtype=dtype, device=device)}


def mla_prefill(params, x, cfg: ModelConfig, positions, cache):
    """Latent-chunked attention over the prompt x (B, S, d), in kv chunks
    of ``cfg.attn_chunk``, and a new cache holding the prompt's latents in
    its first S slots and the given cache's after them."""
    qn, qr = _mla_q(params, x, cfg, positions)
    ckv, kr = _mla_latent(params, x, cfg, positions)
    ckv = constrain(ckv, "B", "M", None)
    kr = constrain(kr, "B", "M", None)
    scan = mla_latent_chunked
    if getattr(qn, "placements", None) is not None:
        scan = _mla_scan_local
    y = scan(qn, qr, ckv, kr, params["w_uk"], params["w_uv"], params["wo"],
             cfg, chunk=cfg.attn_chunk)
    S = x.shape[1]
    if S > cache["ckv"].shape[1]:
        raise ValueError(f"a prompt of {S} exceeds the cache's "
                         f"{cache['ckv'].shape[1]} slots")
    new = {name: torch.cat([t.to(cache[name].dtype), cache[name][:, S:]],
                           dim=1)
           for name, t in (("ckv", ckv), ("kr", kr))}
    return y, new


def mla_decode(params, x, cfg: ModelConfig, positions, cache, index):
    """Absorbed-weight MLA decode of x (B, 1, d) at ``positions`` (B, 1):
    the token's latents go to slot min(index, size - 1) of a new cache
    (``index`` a scalar or (B,)), the query scores against the latent
    cache in fp32 with W_uk folded into it, masked to slots <= index, and
    the latent context goes back through W_uv before ``wo``."""
    qn, qr = _mla_q(params, x, cfg, positions)           # (B,1,H,nope/rope)
    ckv_t, kr_t = _mla_latent(params, x, cfg, positions)
    size = cache["ckv"].shape[1]
    index = torch.as_tensor(index, device=x.device)
    col = index.reshape(-1, 1)                            # (B or 1, 1)
    j = torch.arange(size, dtype=torch.long, device=x.device)
    hit = (j == torch.clamp(col, max=size - 1))[:, :, None]
    cache = {"ckv": torch.where(hit, ckv_t.to(cache["ckv"].dtype),
                                cache["ckv"]),
             "kr": torch.where(hit, kr_t.to(cache["kr"].dtype), cache["kr"])}
    ckv, kr = cache["ckv"].float(), cache["kr"].float()
    q_lat = torch.einsum("bqhn,rhn->bqhr", qn.float(),
                         params["w_uk"].float())           # (B,1,H,R)
    logits = (torch.einsum("bqhr,bsr->bhqs", q_lat, ckv)
              + torch.einsum("bqhk,bsk->bhqs", qr.float(), kr)
              ) * _mla_scale(cfg)
    valid = (j <= col)[:, None, None, :]
    probs = torch.softmax(torch.where(valid, logits, NEG_INF), dim=-1)
    ctx = torch.einsum("bhqs,bsr->bqhr", probs, ckv)        # (B,1,H,R)
    v = torch.einsum("bqhr,rhk->bqhk", ctx, params["w_uv"].float())
    return _out_proj(params, v.to(cfg.cdtype), cfg), cache
