"""Model assembly (port of ``repro.models.transformer``): init, the
forward and its next-token loss for training, prefill and decode for
serving.

The reference scans each segment over its stacked layer axis; here the
layers run as a Python loop over the stacked (L, ...) leaves. A tied
position (Zamba2's shared attention block) keeps one unstacked tree, which
every application of the segment reads, as the reference's scan closes
over it; its caches stay stacked, one entry an application. One trunk
serves two layouts:

* the LM (``init(gen, cfg)``): the reference's tree as it is, with token
  embedding and head, activations (B, S, d), and ``prefill``/``decode``
  modes that fill and update a per-layer cache stacked (L, B, ...);
* the Mirage agent (``init(gen, cfg, n_experts=E)``): the reference
  ``vmap``s the whole trunk over experts, so parameters of a segment
  position are stacked (L, E, ...) and activations are (E, N, S, d);
  layer ``l`` is the contiguous slice ``[l]`` holding every expert.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.convert import tree_map
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import constrain
from .blocks import apply_block, init_block, init_block_cache
from .common import ModelConfig, layer_plan
from .attention import NEG_INF
from .layers import (TiedTable, apply_norm, dense_init, embed_tokens,
                     init_embedding, init_lm_head, init_norm, lm_logits)

_CACHED_MODES = ("prefill", "decode")


def init(gen: torch.Generator, cfg: ModelConfig,
         n_experts: Optional[int] = None) -> Dict:
    """Parameters drawn from ``gen``. Without ``n_experts``: the LM tree of
    the reference (``embed``, ``segments``, ``final_norm``, ``head``; a tied
    position one unstacked block tree), every leaf on ``gen``'s device.
    With it: ``n_experts`` stacked agent trunks (drawn leaves and the
    biases on ``gen``'s device, the norms' constants on the CPU, as
    ``init_foundation`` moves them); the unused ``head`` leaf of the
    reference's tree is kept so the trees convert one to one."""
    if n_experts is None:
        return _init_lm(gen, cfg)
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


def param_count(params) -> int:
    sizes = []
    tree_map(lambda t: sizes.append(t.numel()), params)
    return sum(sizes)


def _init_lm(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    params: Dict[str, Any] = {}
    if cfg.embed_inputs:
        params["embed"] = init_embedding(gen, cfg)
    segs = []
    for seg in layer_plan(cfg):
        segs.append({f"b{j}": init_block(
            gen, kind, cfg, lead=() if shared else (seg.n_repeat,))
            for j, (kind, shared) in enumerate(zip(seg.pattern, seg.shared))})
    params["segments"] = segs
    params["final_norm"] = init_norm(cfg)
    params.update(init_lm_head(gen, cfg))
    return tree_map(lambda t: t.to(gen.device), params)


def _layer(tree, r: int):
    if isinstance(tree, dict):
        return {k: _layer(v, r) for k, v in tree.items()}
    return tree[r]


def _layers(tree, n: int) -> List:
    """The ``n`` per-layer trees of a tree of (n, ...) leaves, each leaf cut
    by one ``unbind``: its backward writes the leaf's gradient once, where
    indexing layer by layer would add a zero-padded gradient of the whole
    stacked leaf for every layer. A segment of one layer takes a view
    (``squeeze``), whose backward is a view of the layer's gradient: the
    stack ``unbind``'s backward builds would copy it, a transient as large
    as the layer's gradient (10 GB for a DeepSeek-V2 MoE layer's experts)."""
    if isinstance(tree, dict):
        per = {k: _layers(v, n) for k, v in tree.items()}
        return [{k: v[r] for k, v in per.items()} for r in range(n)]
    return [tree.squeeze(0)] if n == 1 else tree.unbind(0)


def _stack(trees: List):
    """Per-layer trees -> one tree of (L, ...) leaves."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _forward_body(seg, layer: Dict, cfg: ModelConfig, positions, x, aux):
    """One repetition of a segment's pattern in ``forward`` mode, the
    reference's scan body: (x, aux) -> (x, aux), each block's router loss
    added in order."""
    x = constrain(x, "B", "S", None)
    for j, kind in enumerate(seg.pattern):
        x, a, _ = apply_block(layer[f"b{j}"], kind, x, cfg, positions)
        aux = aux + a
    return constrain(x, "B", "S", None), aux


def apply_trunk(params: Dict, cfg: ModelConfig, x: torch.Tensor, positions,
                mode: str = "forward", cache: Optional[Dict] = None,
                index=None, s_cache: Optional[int] = None):
    """x: (B, S, d) for the LM, (E, N, S, d) for the agent, in the compute
    dtype. Returns (x, aux, cache): aux is the MoE blocks' router losses
    summed in ``forward`` mode, 0.0 in the cached modes, whose callers drop
    it; in ``prefill`` the cache is produced, sized ``s_cache``, in
    ``decode`` ``cache`` is read and a new one returned (the input is not
    written), otherwise it is None. ``index`` (decode: the tokens already
    cached, a scalar or one a row) places the token in the attention
    caches; Mamba blocks read neither.

    Remat: with ``cfg.remat`` in ``forward`` mode while autograd records,
    each repetition of a segment's pattern (the reference's scan body: one
    layer, or one Gemma-3 local/global period, or one Zamba2 group with
    its tied block) runs under ``torch.utils.checkpoint`` (non-reentrant):
    only its input is kept, and the backward runs it again to rebuild its
    activations, as ``jax.checkpoint`` with ``nothing_saveable`` does. The
    values and gradients are the same bits; the kernels' forward launch
    counters count the recompute too. With ``cfg.remat_save_outputs`` each
    block's branches are checkpointed one by one instead, so the residual
    stream between branches is what stays, the counterpart of the
    reference's ``save_only_these_names("block_out")``."""
    aux = 0.0
    cache_out = []
    # the whole repetition is recomputed; with remat_save_outputs each
    # block's branches are checkpointed instead (``blocks._branch``)
    remat = (mode == "forward" and cfg.remat and not cfg.remat_save_outputs
             and torch.is_grad_enabled())
    for si, (seg, seg_params) in enumerate(zip(layer_plan(cfg),
                                               params["segments"])):
        layers = []
        # a tied position hands its one tree to every application
        per_layer = {}
        for j, shared in enumerate(seg.shared):
            p = seg_params[f"b{j}"]
            per_layer[f"b{j}"] = ([p] * seg.n_repeat if shared
                                  else _layers(p, seg.n_repeat))
        for r in range(seg.n_repeat):
            layer = {name: per_layer[name][r] for name in per_layer}
            if mode == "forward":
                body = functools.partial(_forward_body, seg, layer, cfg,
                                         positions)
                if remat:
                    x, aux = checkpoint(body, x, aux, use_reentrant=False)
                else:
                    x, aux = body(x, aux)
                continue
            new = {}
            # the residual pinned to its batch layout before the
            # repetition and after each block (``constrain``, the identity
            # outside a sharding context): the reference's cached scans
            # pin nothing and XLA resolves a block's pending sum itself,
            # where DTensor carries the output projection's pending sum
            # into the next block and gathers the head- or channel-sharded
            # weights of its projections there
            x = constrain(x, "B", "S", None)
            for j, kind in enumerate(seg.pattern):
                name = f"b{j}"
                if mode == "prefill":
                    c = init_block_cache(kind, cfg, x.shape[0], s_cache,
                                         dtype=cfg.cdtype, device=x.device)
                else:
                    c = _layer(cache["segments"][si][name], r)
                x, a, new[name] = apply_block(layer[name], kind, x, cfg,
                                              positions, mode, c, index)
                x = constrain(x, "B", "S", None)
                aux = aux + a
            layers.append(new)
        if mode in _CACHED_MODES:
            cache_out.append(_stack(layers))
    x = apply_norm(params["final_norm"], x, cfg)
    return x, aux, ({"segments": cache_out} if mode in _CACHED_MODES
                    else None)


def embed_inputs(params: Dict, cfg: ModelConfig, inputs: torch.Tensor,
                 vision_embeds: Optional[torch.Tensor] = None,
                 vision_mask: Optional[torch.Tensor] = None,
                 tie: Optional[TiedTable] = None) -> torch.Tensor:
    """Token embeddings (or frames) in the compute dtype; with
    ``vision_embeds`` (B, S, d), the rows where ``vision_mask`` (B, S) is
    set are the vision encoder's patch embeddings instead (the encoder is
    a stub, as in the reference: its output is an input here). ``tie``:
    the forward's ``TiedTable`` where the head shares the table."""
    if cfg.embed_inputs:
        x = embed_tokens(params["embed"], inputs, cfg, tie)
    else:
        x = inputs.to(cfg.cdtype)
    if vision_embeds is not None:
        x = torch.where(vision_mask[..., None], vision_embeds.to(x.dtype), x)
    return constrain(x, "B", "S", None)


def forward(params: Dict, cfg: ModelConfig, inputs: torch.Tensor, positions,
            vision_embeds=None, vision_mask=None):
    """Full forward: returns (logits (B,S,V) fp32, aux loss: the MoE
    blocks' router losses summed, a float 0.0 without MoE blocks).
    ``positions`` (B, S), or (3, B, S) under M-RoPE."""
    # a tied table's gradient in one buffer (``TiedTable``)
    tie = TiedTable() if cfg.tie_embeddings else None
    x = embed_inputs(params, cfg, inputs, vision_embeds, vision_mask, tie)
    x, aux, _ = apply_trunk(params, cfg, x, positions, mode="forward")
    return lm_logits(params, x, cfg, embed_params=params.get("embed"),
                     tie=tie), aux


def loss_fn(params: Dict, cfg: ModelConfig, batch: Dict):
    """Next-token cross entropy: (loss, {"ce", "aux", "accuracy"}), the
    batch's ``vision_embeds``/``vision_mask`` merged where it has them. The
    padded vocab entries are masked out, labels below 0 count as invalid,
    and ``loss = ce + aux``: the MoE blocks' router losses summed, or, for
    a trunk without MoE blocks, a Python 0.0 that adds nothing and launches
    nothing."""
    positions = batch.get("positions")
    if positions is None:
        B, S = batch["inputs"].shape[:2]
        positions = torch.arange(S, dtype=torch.long,
                                 device=batch["inputs"].device).expand(B, S)
    logits, aux = forward(params, cfg, batch["inputs"], positions,
                          batch.get("vision_embeds"), batch.get("vision_mask"))
    labels = batch["labels"]
    if cfg.vocab != cfg.vocab_size:     # the sharding-padded vocab entries
        pad = torch.arange(cfg.vocab, dtype=torch.long,
                           device=logits.device) >= cfg.vocab_size
        logits = torch.where(pad, NEG_INF, logits)
    logp = torch.log_softmax(logits, dim=-1)
    valid = labels >= 0
    safe = torch.where(valid, labels, 0).long()
    # each row's -log p(label) by ``nll_loss``, the values a gather takes:
    # DTensor's gather backward allocates the batch-sharded logits'
    # gradient at its global shape on every rank
    nll = F.nll_loss(logp.flatten(0, -2), safe.flatten(),
                     reduction="none").view(safe.shape)
    denom = torch.clamp(valid.sum(), min=1)
    ce = torch.where(valid, nll, 0.0).sum() / denom
    loss = ce if isinstance(aux, float) and aux == 0.0 else ce + aux
    # the argmax as max's first index: DTensor's argmax of vocab-sharded
    # logits fails where a rank holds one row of the batch
    hits = valid & (logits.max(-1).indices == labels)
    return loss, {"ce": ce, "aux": aux, "accuracy": hits.sum() / denom}


# ---------------------------------------------------------------------- cache
def init_cache(cfg: ModelConfig, batch: int, s_cache: int, dtype=None,
               device=None) -> Dict:
    """Zero decode cache, each leaf stacked (L, batch, ...), on ``device``
    (CUDA unless ``device="cpu"``)."""
    dev = resolve_device(device)
    segs = []
    for seg in layer_plan(cfg):
        segs.append({f"b{j}": tree_map(
            lambda a, n=seg.n_repeat: a.unsqueeze(0).repeat(
                (n,) + (1,) * a.ndim),
            init_block_cache(kind, cfg, batch, s_cache, dtype, dev))
            for j, kind in enumerate(seg.pattern)})
    return {"segments": segs}


def prefill(params: Dict, cfg: ModelConfig, inputs: torch.Tensor, positions,
            s_cache: Optional[int] = None, vision_embeds=None,
            vision_mask=None):
    """Process a prompt, its vision embeddings merged where given,
    producing the decode cache (sized ``s_cache``, default = prompt
    length). Returns (last-token logits, cache)."""
    s_cache = s_cache or inputs.shape[1]
    x = embed_inputs(params, cfg, inputs, vision_embeds, vision_mask)
    x, _, cache = apply_trunk(params, cfg, x, positions, mode="prefill",
                              s_cache=s_cache)
    logits = lm_logits(params, x[:, -1:, :], cfg,
                       embed_params=params.get("embed"))
    return logits[:, 0], cache


def decode_step(params: Dict, cfg: ModelConfig, token: torch.Tensor,
                positions, cache: Dict, index):
    """One decode step. token: (B, 1) int; positions: (B, 1), or (3, B, 1)
    under M-RoPE; index: the tokens already in the cache, a scalar or a
    (B,) tensor (each row at its own). Returns (logits (B, V), new cache);
    ``cache`` is not written."""
    x = embed_inputs(params, cfg, token)
    x, _, cache = apply_trunk(params, cfg, x, positions, mode="decode",
                              cache=cache, index=index)
    logits = lm_logits(params, x, cfg, embed_params=params.get("embed"))
    return logits[:, 0], cache
