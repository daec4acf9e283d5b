"""Model assembly (port of ``repro.models.transformer``): init, the
forward and its next-token loss for training, prefill and decode for
serving.

The reference scans each segment over its stacked layer axis; here the
layers run as a Python loop over the stacked (L, ...) leaves. One trunk
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

from typing import Any, Dict, List, Optional

import torch

from repro_torch.convert import tree_map
from repro_torch.device import resolve_device
from .blocks import apply_block, init_block, init_block_cache
from .common import ModelConfig, layer_plan
from .attention import NEG_INF
from .layers import (apply_norm, dense_init, embed_tokens, init_embedding,
                     init_lm_head, init_norm, lm_logits)

# features of ModelConfig that the port does not carry yet
_UNPORTED = ("use_rope", "qk_norm", "qkv_bias", "use_mla", "parallel_block",
             "sandwich_norm")
_CACHED_MODES = ("prefill", "decode")


def _check_supported(cfg: ModelConfig) -> None:
    on = [name for name in _UNPORTED if getattr(cfg, name)]
    if on:
        raise NotImplementedError(f"{cfg.arch_id}: {', '.join(on)} not "
                                  "ported")


def init(gen: torch.Generator, cfg: ModelConfig,
         n_experts: Optional[int] = None) -> Dict:
    """Parameters drawn from ``gen``. Without ``n_experts``: the LM tree of
    the reference (``embed``, ``segments``, ``final_norm``, ``head``), every
    leaf on ``gen``'s device. With it: ``n_experts`` stacked agent trunks
    (drawn leaves on ``gen``'s device, constant ones on the CPU, as
    ``init_foundation`` moves them); the unused ``head`` leaf of the
    reference's tree is kept so the trees convert one to one."""
    _check_supported(cfg)
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
        if any(seg.shared):
            raise NotImplementedError(f"{cfg.arch_id}: tied blocks are not "
                                      "ported")
        segs.append({f"b{j}": init_block(gen, kind, cfg, lead=(seg.n_repeat,))
                     for j, kind in enumerate(seg.pattern)})
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
    stacked leaf for every layer."""
    if isinstance(tree, dict):
        per = {k: _layers(v, n) for k, v in tree.items()}
        return [{k: v[r] for k, v in per.items()} for r in range(n)]
    return tree.unbind(0)


def _stack(trees: List):
    """Per-layer trees -> one tree of (L, ...) leaves."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def apply_trunk(params: Dict, cfg: ModelConfig, x: torch.Tensor, positions,
                mode: str = "forward", cache: Optional[Dict] = None,
                index=None, s_cache: Optional[int] = None):
    """x: (B, S, d) for the LM, (E, N, S, d) for the agent, in the compute
    dtype. Returns (x, aux, cache): in ``prefill`` the cache is produced,
    in ``decode`` ``cache`` is read and a new one returned (the input is
    not written), otherwise it is None. ``index`` and ``s_cache`` size the
    attention caches of the reference; Mamba blocks read neither."""
    _check_supported(cfg)
    aux = 0.0
    cache_out = []
    for si, (seg, seg_params) in enumerate(zip(layer_plan(cfg),
                                               params["segments"])):
        layers = []
        per_layer = {name: _layers(p, seg.n_repeat)
                     for name, p in seg_params.items()}
        for r in range(seg.n_repeat):
            new = {}
            for j, kind in enumerate(seg.pattern):
                name = f"b{j}"
                c = None
                if mode == "prefill":
                    c = init_block_cache(kind, cfg, x.shape[0], s_cache,
                                         dtype=cfg.cdtype, device=x.device)
                elif mode == "decode":
                    c = _layer(cache["segments"][si][name], r)
                x, a, new[name] = apply_block(per_layer[name][r], kind, x,
                                              cfg, positions, mode, c)
                aux = aux + a
            layers.append(new)
        if mode in _CACHED_MODES:
            cache_out.append(_stack(layers))
    x = apply_norm(params["final_norm"], x, cfg)
    return x, aux, ({"segments": cache_out} if mode in _CACHED_MODES
                    else None)


def embed_inputs(params: Dict, cfg: ModelConfig, inputs: torch.Tensor
                 ) -> torch.Tensor:
    if cfg.embed_inputs:
        return embed_tokens(params["embed"], inputs, cfg)
    return inputs.to(cfg.cdtype)


def forward(params: Dict, cfg: ModelConfig, inputs: torch.Tensor, positions):
    """Full forward: returns (logits (B,S,V) fp32, aux loss (a float))."""
    x = embed_inputs(params, cfg, inputs)
    x, aux, _ = apply_trunk(params, cfg, x, positions, mode="forward")
    return lm_logits(params, x, cfg, embed_params=params.get("embed")), aux


def loss_fn(params: Dict, cfg: ModelConfig, batch: Dict):
    """Next-token cross entropy: (loss, {"ce", "aux", "accuracy"}). The
    padded vocab entries are masked out, labels below 0 count as invalid,
    and ``loss = ce + aux``; the trunk's aux is a Python 0.0 (no MoE block
    is ported), which adds nothing and launches nothing."""
    positions = batch.get("positions")
    if positions is None:
        B, S = batch["inputs"].shape[:2]
        positions = torch.arange(S, device=batch["inputs"].device).expand(
            B, S)
    logits, aux = forward(params, cfg, batch["inputs"], positions)
    labels = batch["labels"]
    if cfg.vocab != cfg.vocab_size:     # the sharding-padded vocab entries
        pad = torch.arange(cfg.vocab, device=logits.device) >= cfg.vocab_size
        logits = torch.where(pad, NEG_INF, logits)
    logp = torch.log_softmax(logits, dim=-1)
    valid = labels >= 0
    safe = torch.where(valid, labels, 0).long()
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    denom = torch.clamp(valid.sum(), min=1)
    ce = torch.where(valid, nll, 0.0).sum() / denom
    loss = ce if isinstance(aux, float) and aux == 0.0 else ce + aux
    hits = valid & (logits.argmax(-1) == labels)
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
            s_cache: Optional[int] = None):
    """Process a prompt, producing the decode cache (sized ``s_cache``,
    default = prompt length). Returns (last-token logits, cache)."""
    s_cache = s_cache or inputs.shape[1]
    x = embed_inputs(params, cfg, inputs)
    x, _, cache = apply_trunk(params, cfg, x, positions, mode="prefill",
                              s_cache=s_cache)
    logits = lm_logits(params, x[:, -1:, :], cfg,
                       embed_params=params.get("embed"))
    return logits[:, 0], cache


def decode_step(params: Dict, cfg: ModelConfig, token: torch.Tensor,
                positions, cache: Dict, index):
    """One decode step. token: (B, 1) int; index: scalar. Returns
    (logits (B, V), new cache)."""
    x = embed_inputs(params, cfg, token)
    x, _, cache = apply_trunk(params, cfg, x, positions, mode="decode",
                              cache=cache, index=index)
    logits = lm_logits(params, x, cfg, embed_params=params.get("embed"))
    return logits[:, 0], cache
