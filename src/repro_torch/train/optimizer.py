"""AdamW + schedules (port of ``repro.train.optimizer``).

Over the port's parameter trees (nested dicts and lists of tensors, walked
with ``convert.tree_map``), exactly as the reference writes it, which is
not ``torch.optim.AdamW``:

* the step counter is an int32 tensor, incremented before the schedule
  reads it (``step + 1``);
* gradients are clipped by the global norm of *all* leaves, with the norm
  held off zero (``max(gnorm, 1e-12)``);
* bias corrections and the update are fp32, cast back to each leaf's dtype;
* decay applies only to leaves with ``ndim >= 2`` in the reference's
  layout: in a transformer-kind agent tree (``convert.widened``) the port
  adds an expert axis of 1 to every leaf, so there a leaf decays from
  ``ndim >= 3``, exactly where its JAX original does;
* m and v are kept in ``state_dtype``, or in each parameter's dtype.

``adamw_update`` runs under ``torch.no_grad()`` and returns new trees, as
the reference does; the inputs are not written.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.convert import tree_map, widened
from repro_torch.models.common import _TORCH_DTYPES


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    state_dtype: Optional[str] = None   # None -> match param dtype


def lr_schedule(ocfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio (fp32, on step's
    device)."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(ocfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - ocfg.warmup_steps)
                       / max(ocfg.total_steps - ocfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    scale = ocfg.min_lr_ratio + (1.0 - ocfg.min_lr_ratio) * cos
    return ocfg.lr * warm * scale


def _leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def init_opt_state(params, ocfg: OptimizerConfig) -> Dict[str, Any]:
    """Zero m and v shaped like ``params``; the step on the first leaf's
    device."""
    def zeros_like(p):
        dt = _TORCH_DTYPES[ocfg.state_dtype] if ocfg.state_dtype else p.dtype
        return torch.zeros(p.shape, dtype=dt, device=p.device)
    device = _leaves(params)[0].device
    return {"m": tree_map(zeros_like, params),
            "v": tree_map(zeros_like, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(torch.stack(
        [torch.sum(torch.square(x.float())) for x in _leaves(tree)]).sum())


@torch.no_grad()
def adamw_update(grads, params, opt_state, ocfg: OptimizerConfig
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step: (new params, new state, {"lr", "grad_norm"})."""
    step = opt_state["step"] + 1
    lr = lr_schedule(ocfg, step)
    gnorm = global_norm(grads)
    clip = (torch.clamp(ocfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0) if ocfg.grad_clip
            else torch.ones((), device=gnorm.device))

    b1, b2 = ocfg.beta1, ocfg.beta2
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=stepf.device), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=stepf.device), stepf)

    ps, gs = _leaves(params), _leaves(grads)
    ms, vs = _leaves(opt_state["m"]), _leaves(opt_state["v"])
    if not len(ps) == len(gs) == len(ms) == len(vs):
        raise ValueError("params, grads and optimizer state differ in "
                         "their trees")
    matrix = 2 + widened(params)        # the rank of a decayed leaf
    new_p, new_m, new_v = [], [], []
    for p, g, m, v in zip(ps, gs, ms, vs):
        g = g.float() * clip
        m_new = b1 * m.float() + (1 - b1) * g
        v_new = b2 * v.float() + (1 - b2) * torch.square(g)
        delta = (m_new / bc1) / (torch.sqrt(v_new / bc2) + ocfg.eps)
        if p.ndim >= matrix and ocfg.weight_decay:     # decay matrices only
            delta = delta + ocfg.weight_decay * p.float()
        new_p.append((p.float() - lr * delta).to(p.dtype))
        new_m.append(m_new.to(m.dtype))
        new_v.append(v_new.to(v.dtype))

    def rebuild(values):
        it = iter(values)
        return tree_map(lambda _: next(it), params)
    new_state = {"m": rebuild(new_m), "v": rebuild(new_v), "step": step}
    return rebuild(new_p), new_state, {"lr": lr, "grad_norm": gnorm}
