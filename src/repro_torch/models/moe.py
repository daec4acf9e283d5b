"""Mixture-of-Experts layers (port of ``repro.models.moe``).

Three gating schemes, as in the reference:

* ``topk_moe``: sparse top-k routing with GShard capacity. Long sequences
  route in ``moe_group_size``-token capacity groups; each expert takes at
  most C tokens of a group, counted in the flattened (token, k) order, and
  later ones are dropped (their output is the shared experts' alone). The
  payload MoE archs use it (qwen2-moe: 60 experts top-4 + 4 shared).
* ``topk_moe_sorted``: the reference's sort-based dispatch. Its drops are
  ``topk_moe``'s without capacity groups; it rounds each weighted expert
  output to the compute dtype before summing a token's, as the reference's
  scatter-add does.
* ``dense_moe``: the paper's Eq. 7, a softmax-weighted average over all
  experts.

Each returns (y, aux loss). With ``with_aux=False`` (the prefill and decode
steps, which drop it, as the reference's jit drops the dead work) the aux
loss is not computed and a Python 0.0 stands in its place, costing no
launch.

Dispatch and combine. The reference builds one-hot (B, S, K, E, C) slot
tensors and applies them as einsums. A token's K experts are distinct and a
slot (e, c) of a group holds one token, so every sum in those einsums has at
most one nonzero term. The port computes each (token, k)'s slot once, gathers
the kept tokens' rows into the (E, B, C, d) expert input, and reads each
token's K expert outputs back by a gather, weighted by its gates rounded to
the compute dtype: the reference's values without its tensors. At
Qwen1.5-MoE-A2.7B's 4 x 2048 prefill the slot tensor alone would take 5.4 GB
a layer and the two dense products ~0.7 TFLOP.

The routed experts' two products are grouped GEMMs over the expert axis
(the kernel): ``wi`` as one (E, d, 2 * d_ff) product, then ``wo``. The
shared experts' (and ``dense_moe``'s first) product reads the same x for
every expert, so it is one ``torch.matmul`` over the experts' concatenated
columns, as the reference's einsum, which no TPU kernel computed.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.moe_gemm import grouped_gemm
from .common import ModelConfig
from .layers import _act, dense_init


def init_experts(gen: torch.Generator, cfg: ModelConfig, n_experts: int,
                 d_ff: int, lead: Sequence[int] = ()) -> Dict:
    """Stacked gated-MLP expert weights: ``wi`` lead + (E, d, 2, d_ff) and
    ``wo`` lead + (E, d_ff, d)."""
    lead = tuple(lead) + (n_experts,)
    d = cfg.d_model
    return {"wi": dense_init(gen, d, (2, d_ff), cfg.pdtype, lead),
            "wo": dense_init(gen, d_ff, d, cfg.pdtype, lead)}


def init_moe(gen: torch.Generator, cfg: ModelConfig,
             lead: Sequence[int] = ()) -> Dict:
    p = {"router": dense_init(gen, cfg.d_model, cfg.n_experts, torch.float32,
                              lead),
         "experts": init_experts(gen, cfg, cfg.n_experts, cfg.expert_d_ff,
                                 lead)}
    if cfg.n_shared_experts:
        p["shared"] = init_experts(gen, cfg, cfg.n_shared_experts,
                                   cfg.shared_d_ff or cfg.expert_d_ff, lead)
    return p


def _expert_ffn(experts: Dict, x: torch.Tensor, cfg: ModelConfig
                ) -> torch.Tensor:
    """x: (E, N, d) -> (E, N, d), two grouped GEMMs; act(gate) * up in the
    compute dtype, as the reference rounds it."""
    act = _act(cfg.mlp_activation)
    E, _, d = x.shape
    wi = experts["wi"].to(cfg.cdtype)
    h = grouped_gemm(x, wi.reshape(E, d, -1), device=x.device)
    h = h.unflatten(-1, (2, -1))
    h = act(h[..., 0, :]) * h[..., 1, :]
    return grouped_gemm(h, experts["wo"].to(cfg.cdtype), device=x.device)


def _all_experts_hidden(experts: Dict, x: torch.Tensor, cfg: ModelConfig
                        ) -> torch.Tensor:
    """Every expert's act(gate) * up on every row: x (..., d) -> (..., e,
    d_ff), one product against ``wi`` laid out (d, e * 2 * d_ff)."""
    act = _act(cfg.mlp_activation)
    wi = experts["wi"].to(cfg.cdtype)
    e, d, _, f = wi.shape
    h = (x @ wi.transpose(0, 1).reshape(d, -1)).unflatten(-1, (e, 2, f))
    return act(h[..., 0, :]) * h[..., 1, :]


def _shared_ffn(shared: Dict, x: torch.Tensor, cfg: ModelConfig
                ) -> torch.Tensor:
    """The shared experts, summed, on every token: x (..., d) -> (..., d);
    the second product contracts (e, d_ff) at once, as the reference's
    einsum does."""
    h = _all_experts_hidden(shared, x, cfg)
    wo = shared["wo"].to(cfg.cdtype)
    return h.flatten(-2) @ wo.reshape(-1, wo.shape[-1])


def _route(params: Dict, x: torch.Tensor, cfg: ModelConfig):
    """The router in fp32: probabilities (B, S, E), and each token's top-k
    experts (B, S, K) with their probabilities renormalised to sum to 1."""
    logits = x.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, gates, idx


def _capacity_slots(idx: torch.Tensor, E: int, C: int):
    """Each (token, k)'s row in the (E, B, C) expert input, from its
    position in its expert's queue (the (token, k) pairs before it, in
    flattened order, routed to the same expert): (slots (B, S, K), with
    E * B * C for a dropped pair; keep (B, S, K); the pairs routed to each
    expert, (B, E), dropped ones included)."""
    B, S, K = idx.shape
    flat = idx.reshape(B, 1, S * K)
    # (B, E, S*K): each expert's queue along the last axis, whose running
    # count is one scan a row (a scan along the pairs' axis of (B, S*K, E)
    # runs each of its B*E columns serially)
    onehot = flat == torch.arange(E, dtype=torch.long,
                                  device=idx.device)[None, :, None]
    queue = torch.cumsum(onehot, dim=-1, dtype=torch.int32)
    pos = (queue.gather(1, flat)[:, 0] - 1).reshape(B, S, K).long()
    keep = pos < C
    b = torch.arange(B, dtype=torch.long, device=idx.device)[:, None, None]
    slots = torch.where(keep, (idx * B + b) * C + pos, E * B * C)
    return slots, keep, queue[..., -1]


def _dispatch(x: torch.Tensor, slots: torch.Tensor, n: int) -> torch.Tensor:
    """The expert input's n rows: row r holds the token whose kept pair has
    slot r, zeros where no pair has it."""
    B, S, K = slots.shape
    tok = torch.full((n + 1,), B * S, dtype=torch.long, device=x.device)
    tok.index_copy_(0, slots.reshape(-1), torch.arange(
        B * S, dtype=torch.long, device=x.device).repeat_interleave(K))
    rows = torch.cat([x.reshape(B * S, -1), x.new_zeros(1, x.shape[-1])])
    return rows[tok[:n]]


def _aux_loss(probs: torch.Tensor, counts: torch.Tensor, cfg: ModelConfig
              ) -> torch.Tensor:
    """The Switch/GShard load-balance loss: E * coef * the mean over groups
    of sum_e (pairs routed to e / S) * (mean router probability of e)."""
    E, S = cfg.n_experts, probs.shape[1]
    frac_tokens = counts.float() / S
    frac_prob = probs.mean(dim=1)
    return cfg.router_aux_coef * E * torch.mean(
        torch.sum(frac_tokens * frac_prob, dim=-1))


def _topk(params: Dict, x: torch.Tensor, cfg: ModelConfig,
          round_products: bool, with_aux: bool):
    """Capacity-based top-k MoE over groups x (B, S, d). A token's output
    sums its kept experts' outputs times their gates (rounded to the
    compute dtype): in fp32, rounded once, as the reference's combine
    einsum; or, with ``round_products``, each product rounded first, as its
    sorted scheme's scatter-add."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = max(1, int(math.ceil(S * K * cfg.capacity_factor / E)))
    probs, gates, idx = _route(params, x, cfg)
    slots, keep, counts = _capacity_slots(idx, E, C)
    xin = _dispatch(x, slots, E * B * C).reshape(E, B * C, d)
    n = params["experts"]["wi"].shape[0]
    if n == E:
        yout = _expert_ffn(params["experts"], xin, cfg)
    else:   # a rank's n experts from "first" (``_moe_sharded``), zeros around
        e0 = params["experts"]["first"]
        yout = F.pad(_expert_ffn(params["experts"], xin[e0:e0 + n], cfg),
                     (0, 0, 0, 0, e0, E - e0 - n))
    out = yout.reshape(E * B * C, d)[torch.where(keep, slots, 0)]
    w = torch.where(keep, gates, 0.0).to(cfg.cdtype)[..., None]
    if round_products:
        y = (out * w).sum(2)
    else:
        y = (out.float() * w.float()).sum(2).to(cfg.cdtype)
    if "shared" in params:
        y = y + _shared_ffn(params["shared"], x, cfg)
    return y, (_aux_loss(probs, counts, cfg) if with_aux else 0.0)


def topk_moe(params: Dict, x: torch.Tensor, cfg: ModelConfig,
             with_aux: bool = True) -> Tuple[torch.Tensor, object]:
    """Capacity-based top-k MoE. x: (B, S, d) -> (y, aux_loss), routed in
    ``moe_group_size``-token capacity groups where S is a multiple of the
    group and longer than it."""
    B0, S0, d = x.shape
    g = max(1, min(cfg.moe_group_size, S0))
    if S0 % g == 0 and S0 > g:
        x = x.reshape(B0 * (S0 // g), g, d)
    y, aux = _topk(params, x, cfg, round_products=False, with_aux=with_aux)
    return y.reshape(B0, S0, d), aux


def topk_moe_sorted(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                    with_aux: bool = True) -> Tuple[torch.Tensor, object]:
    """The reference's sort-based scheme: ``topk_moe``'s routing and drops
    over the whole sequence (no capacity groups), each weighted expert
    output rounded to the compute dtype before a token's are summed."""
    return _topk(params, x, cfg, round_products=True, with_aux=with_aux)


def dense_moe(params: Dict, x: torch.Tensor, cfg: ModelConfig,
              with_aux: bool = True) -> Tuple[torch.Tensor, object]:
    """Eq. 7: the softmax-gated average over all experts (no dropping);
    each expert's second product is a grouped GEMM over the expert axis."""
    logits = x.float() @ params["router"].float()
    gates = torch.softmax(logits, dim=-1).to(cfg.cdtype)    # (..., E)
    h = _all_experts_hidden(params["experts"], x, cfg)       # (..., E, f)
    lead, (E, f) = h.shape[:-2], h.shape[-2:]
    y_e = grouped_gemm(h.reshape(-1, E, f).transpose(0, 1),
                       params["experts"]["wo"].to(cfg.cdtype),
                       device=x.device)                       # (E, N, d)
    y = (y_e.float() * gates.reshape(-1, E).T.float()[..., None]).sum(0)
    aux = (torch.zeros((), dtype=torch.float32, device=x.device)
           if with_aux else 0.0)
    return y.to(cfg.cdtype).reshape(lead + (-1,)), aux


def _flat(tree: Dict) -> list:
    """The leaves of a tree of dicts, in its order."""
    return [leaf for v in tree.values()
            for leaf in (_flat(v) if isinstance(v, dict) else [v])]


def _rebuild(tree: Dict, leaves) -> Dict:
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    return {k: _rebuild(v, leaves) if isinstance(v, dict) else next(leaves)
            for k, v in tree.items()}


def _moe_sharded(params: Dict, x, cfg: ModelConfig, scheme: str,
                 with_aux: bool):
    """``moe_forward`` on DTensors (the dry run's) through ``local_map``.
    Each rank routes its own rows over every expert (the router is
    replicated) and runs the experts it holds: all of them with their ff
    sharded, where the output is a partial sum over ff, or its slice of
    the experts, where it is a partial sum over experts (the others' rows
    zero). The aux loss is each rank's mean over its groups, averaged
    across the batch shards. DTensor has no rule for the capacity
    dispatch's in-place index writes; XLA partitions the reference's
    one-hot einsums into the same work."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    leaves = _flat(params)
    xp = tuple(p if p == Shard(0) else Replicate() for p in x.placements)
    split = {i for t in leaves for i, p in enumerate(t.placements)
             if isinstance(p, Shard)}
    wi = params["experts"]["wi"]
    by_expert = [i for i, p in enumerate(wi.placements) if p == Shard(0)]
    coord = mesh.get_coordinate() or [0] * mesh.ndim
    offset = coord[by_expert[0]] if by_expert else 0

    def local(xl, *ls):
        tree = _rebuild(params, iter(ls))
        tree["experts"]["first"] = offset * tree["experts"]["wi"].shape[0]
        y, aux = moe_forward(tree, xl, cfg, scheme, with_aux)
        if not torch.is_tensor(aux):
            aux = torch.zeros((), dtype=torch.float32, device=xl.device)
        return y, aux

    y_pl = [Partial() if i in split else p for i, p in enumerate(xp)]
    aux_pl = [Partial("avg") if p == Shard(0) else Replicate() for p in xp]
    y, aux = local_map(
        local, out_placements=(y_pl, aux_pl),
        in_placements=(xp,) + tuple(tuple(t.placements) for t in leaves),
        device_mesh=mesh, redistribute_inputs=True)(x, *leaves)
    return y, (aux if with_aux else 0.0)


def moe_forward(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                scheme: str = "topk", with_aux: bool = True
                ) -> Tuple[torch.Tensor, object]:
    if getattr(params["router"], "placements", None) is not None:
        return _moe_sharded(params, x, cfg, scheme, with_aux)
    if scheme == "dense":
        return dense_moe(params, x, cfg, with_aux)
    if scheme == "sorted":
        return topk_moe_sorted(params, x, cfg, with_aux)
    return topk_moe(params, x, cfg, with_aux)
