"""Dual-head foundation models (§4.6-4.7, Figs. 5-6), port of
``repro.core.foundation``.

* ``transformer`` trunk: per-snapshot embedding of the 40 state variables
  (+ the ordinal action variable broadcast to every snapshot token), learned
  positions, bidirectional transformer encoder, mean-pool.
* V-head: trunk -> scalar Q(s, a). P-head: trunk (action 0) -> 2 logits.
* ``moe`` trunk (Eq. 7): E expert transformers under a dense softmax gate.

Both kinds share one parameter layout with a leading expert axis E (E=1
for ``transformer``): the reference's ``vmap`` over experts is the written
axis of every activation (E, N, S, d), so each projection of all experts is
one grouped-GEMM launch. The input embedding, positions, heads and gate are
plain fp32 products, as in the reference, where no kernel computes them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs import mirage_agent
from repro_torch.convert import tree_map
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import dense_init
from .state import STATE_DIM


@dataclasses.dataclass(frozen=True)
class FoundationConfig:
    kind: str = "transformer"        # transformer | moe
    n_experts: int = mirage_agent.N_EXPERTS
    history: int = 144
    trunk: ModelConfig = mirage_agent.CONFIG
    gate_time_feature: bool = True   # gate sees the episode's time position
    gate_top1: bool = False          # §4.7 ablation: sparse top-1 gating

    def reduced(self) -> "FoundationConfig":
        return dataclasses.replace(self, trunk=mirage_agent.SMOKE, history=24,
                                   n_experts=4)


def _init_trunk(gen: torch.Generator, fc: FoundationConfig, n: int) -> Dict:
    d = fc.trunk.d_model
    return {
        "embed_in": dense_init(gen, STATE_DIM + 1, d, torch.float32, (n,)),
        "pos": torch.randn((n, fc.history, d), generator=gen,
                           dtype=torch.float32, device=gen.device) * 0.02,
        "trunk": tf.init(gen, fc.trunk, n_experts=n),
        "v_head": dense_init(gen, d, 1, torch.float32, (n,)),
        "p_head": dense_init(gen, d, 2, torch.float32, (n,)),
    }


def init_foundation(gen: torch.Generator, fc: FoundationConfig,
                    device=None) -> Dict:
    """Native initialisation from ``gen`` (drawn on the CPU, then moved)."""
    dev = resolve_device(device)
    if fc.kind == "transformer":
        params = _init_trunk(gen, fc, 1)
    else:
        gate_in = STATE_DIM + (1 if fc.gate_time_feature else 0)
        params = {"experts": _init_trunk(gen, fc, fc.n_experts),
                  "gate": dense_init(gen, gate_in, fc.n_experts,
                                     torch.float32)}
    return tree_map(lambda t: t.to(dev), params)


def _trunk_apply(params: Dict, fc: FoundationConfig, states: torch.Tensor,
                 action: torch.Tensor) -> torch.Tensor:
    """states: (N, k, 40); action: (N,) in {-1, 0, +1}. Returns (E, N, d)."""
    cfg = fc.trunk
    N, k, _ = states.shape
    act = action.float()[:, None, None].expand(N, k, 1)
    x = torch.cat([states.float(), act], dim=-1)
    h = torch.einsum("nkm,emd->enkd", x, params["embed_in"]) \
        + params["pos"][:, None]
    pos = torch.arange(k, dtype=torch.long, device=states.device).expand(
        N, k)
    h, _, _ = tf.apply_trunk(params["trunk"], cfg, h.to(cfg.cdtype), pos)
    # the pool runs in the compute dtype, then casts (foundation.py:82)
    return h.mean(dim=2).float()


def _heads(params: Dict, feats: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """feats (E, N, d) -> Q (E, N) and logits (E, N, 2)."""
    q = torch.einsum("end,edo->eno", feats, params["v_head"])[..., 0]
    logits = torch.einsum("end,edo->eno", feats, params["p_head"])
    return q, logits


def _gate(params: Dict, fc: FoundationConfig, states: torch.Tensor,
          time_pos: Optional[torch.Tensor]) -> torch.Tensor:
    """Dense softmax gate over experts (Eq. 7). Gate input: current snapshot
    (+ normalized time position, zeros when the caller passes none)."""
    cur = states[:, -1, :].float()
    if fc.gate_time_feature:
        tp = (time_pos.float() if time_pos is not None
              else torch.zeros(states.shape[0], dtype=torch.float32,
                               device=states.device))
        cur = torch.cat([cur, tp[:, None]], dim=-1)
    g = torch.softmax(cur @ params["gate"], dim=-1)
    if fc.gate_top1:
        # straight-through top-1: hard routing fwd, soft gradient
        hard = torch.nn.functional.one_hot(g.argmax(-1), g.shape[-1]).to(
            g.dtype)
        g = hard + g - g.detach()
    return g


def _combine(params: Dict, fc: FoundationConfig, per_exp: torch.Tensor,
             states: torch.Tensor, time_pos) -> torch.Tensor:
    if fc.kind == "transformer":
        return per_exp[0]
    g = _gate(params, fc, states, time_pos)                      # (B, E)
    return torch.einsum("ebq,be->bq", per_exp, g)


def _experts(params: Dict, fc: FoundationConfig) -> Dict:
    return params if fc.kind == "transformer" else params["experts"]


def q_values(params: Dict, fc: FoundationConfig, states: torch.Tensor,
             time_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Q(s, a) for both actions. Returns (B, 2): [:,0]=no-submit, [:,1]=submit.
    The two actions run as one trunk pass over the batch stacked to 2B."""
    B = states.shape[0]
    ep = _experts(params, fc)
    action = torch.cat([
        torch.full((B,), a, dtype=torch.float32, device=states.device)
        for a in (-1.0, 1.0)])
    feats = _trunk_apply(ep, fc, torch.cat([states, states]), action)
    q = _heads(ep, feats)[0]                                     # (E, 2B)
    per_exp = q.unflatten(1, (2, B)).transpose(1, 2)             # (E, B, 2)
    return _combine(params, fc, per_exp, states, time_pos)


def policy_logits(params: Dict, fc: FoundationConfig, states: torch.Tensor,
                  time_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """P-head action logits (B, 2); action input is the 0 placeholder."""
    ep = _experts(params, fc)
    action = torch.zeros(states.shape[0], dtype=torch.float32,
                         device=states.device)
    per_exp = _heads(ep, _trunk_apply(ep, fc, states, action))[1]
    return _combine(params, fc, per_exp, states, time_pos)


def reward_prediction(params: Dict, fc: FoundationConfig, states: torch.Tensor,
                      time_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Offline-pretraining output: predicted reward of submitting now
    (= Q(s, submit)); (B,)."""
    return q_values(params, fc, states, time_pos)[:, 1]
