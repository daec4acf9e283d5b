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

``adamw_update`` runs under ``torch.no_grad()``. By default it returns
new trees, as the reference's update does, and writes none of its inputs.
With ``donate=True`` it takes ownership of its inputs, as the reference's
``ChainedTrainer`` step does when ``jax.jit`` donates its params and
optimizer state: each leaf's new p, m and v are written into that leaf's
own storage and the same trees come back; the gradient tree is emptied and
each gradient dropped once its leaf is updated. The arithmetic is
``_update``'s either way, so the two give the same bits. A leaf of more
than UPDATE_SLICE elements is updated in slices of that many, into its new
tensors or, donated, into its own: the update is elementwise, so the bits
are the same, and its fp32 temporaries stay ~0.27 GB each where a whole
leaf as large as Gemma-3's tied table (1.41 B elements) or DeepSeek-V2's
stacked experts (2.52 B a MoE layer) would add several of 4-10 GB to the
step's peak. ``global_norm`` squares such a leaf a slice at a time too.

Donated leaves may be DTensors (the dry run's sharded trees): the update
is elementwise, so each rank updates its own shards (``_local``), with
each gradient already at its parameter's placements
(``step.value_and_grad`` reduces it there), and ``global_norm`` sums the
shards' squares across the mesh.
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


UPDATE_SLICE = 1 << 26     # elements of a leaf updated at once


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


def _local(t):
    """A DTensor's shard on this rank; any other tensor as it is."""
    to_local = getattr(t, "to_local", None)
    return t if to_local is None else to_local()


def _square_sum(x: torch.Tensor) -> torch.Tensor:
    """The fp32 sum of ``x``'s squares; a leaf of more than UPDATE_SLICE
    elements is squared a slice at a time, so no fp32 square of the whole
    leaf is made (10 GB for DeepSeek-V2's stacked experts). A DTensor is
    squared whole, each rank its own shard."""
    if x.numel() <= UPDATE_SLICE or _local(x) is not x:
        return torch.sum(torch.square(x.float()))
    flat = x.reshape(-1)
    return torch.stack([torch.sum(torch.square(flat[j:j + UPDATE_SLICE]
                                               .float()))
                        for j in range(0, flat.numel(), UPDATE_SLICE)]).sum()


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(torch.stack([_square_sum(x)
                                   for x in _leaves(tree)]).sum())


def _update(p, g, m, v, *, decay: bool, clip, lr, bc1, bc2,
            ocfg: OptimizerConfig):
    """The AdamW update of one leaf, or of one slice of it: new (p, m,
    v)."""
    b1, b2 = ocfg.beta1, ocfg.beta2
    g = g.float() * clip
    m_new = b1 * m.float() + (1 - b1) * g
    v_new = b2 * v.float() + (1 - b2) * torch.square(g)
    delta = (m_new / bc1) / (torch.sqrt(v_new / bc2) + ocfg.eps)
    if decay:
        delta = delta + ocfg.weight_decay * p.float()
    return ((p.float() - lr * delta).to(p.dtype), m_new.to(m.dtype),
            v_new.to(v.dtype))


def _empty(tree) -> None:
    """Clear every dict and list of ``tree`` in place: its leaves are then
    held only where the caller took them out."""
    if isinstance(tree, (dict, list)):
        for v in (tree.values() if isinstance(tree, dict) else tree):
            _empty(v)
        tree.clear()


def _check_donatable(leaves) -> None:
    """Donated leaves are written through flat views of their storage: each
    must be contiguous and share its storage with no other leaf."""
    seen = set()
    for t in leaves:
        if not t.is_contiguous():
            raise ValueError(f"a donated leaf {tuple(t.shape)} is not "
                             "contiguous")
        st = t.untyped_storage()
        # a meta storage has no address: its identity stands for one
        key = (t.device, st._cdata if t.device.type == "meta"
               else st.data_ptr())
        if t.numel() and key in seen:
            raise ValueError("two donated leaves share one storage")
        seen.add(key)


@torch.no_grad()
def adamw_update(grads, params, opt_state, ocfg: OptimizerConfig,
                 donate: bool = False
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step: (new params, new state, {"lr", "grad_norm"}).

    ``donate``: write the new values into the leaves of ``params`` and
    ``opt_state`` (the step counter too) and return those trees; ``grads``
    is emptied and each gradient dropped once used (module docstring)."""
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

    dps = _leaves(params)                # DTensors are updated shard-wise
    ps, gs = [_local(t) for t in dps], [_local(t) for t in _leaves(grads)]
    ms = [_local(t) for t in _leaves(opt_state["m"])]
    vs = [_local(t) for t in _leaves(opt_state["v"])]
    clip, lr_, bc1, bc2 = (_local(t) for t in (clip, lr, bc1, bc2))
    if not len(ps) == len(gs) == len(ms) == len(vs):
        raise ValueError("params, grads and optimizer state differ in "
                         "their trees")
    if donate:
        _check_donatable(ps + ms + vs)
        _empty(grads)
    elif any(t is not d for t, d in zip(ps, dps)):
        raise ValueError("DTensor leaves are updated in place only "
                         "(donate=True)")
    matrix = 2 + widened(params)        # the rank of a decayed leaf
    new_p, new_m, new_v = [], [], []
    for i, (p, m, v) in enumerate(zip(ps, ms, vs)):
        g, gs[i] = gs[i], None
        # decay matrices only
        kw = dict(decay=bool(p.ndim >= matrix and ocfg.weight_decay),
                  clip=clip, lr=lr_, bc1=bc1, bc2=bc2, ocfg=ocfg)
        flat = [t.reshape(-1) for t in (p, g, m, v)]
        if donate:                      # into the leaf's own storage
            out = [p, m, v]
        elif p.numel() > UPDATE_SLICE:
            out = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
                   for t in (p, m, v)]
        else:
            out = None
        for j in range(0, max(p.numel(), 1), UPDATE_SLICE):
            part = _update(*(t[j:j + UPDATE_SLICE] for t in flat), **kw)
            if out is None:             # one slice is the whole leaf
                out = [n.view(t.shape) for n, t in zip(part, (p, m, v))]
            else:
                for o, n in zip(out, part):
                    o.view(-1)[j:j + UPDATE_SLICE] = n
        del g, flat, part
        new_p.append(out[0])
        new_m.append(out[1])
        new_v.append(out[2])

    if donate:
        opt_state["step"].copy_(step)
        return params, opt_state, {"lr": lr, "grad_norm": gnorm}

    def rebuild(values):
        it = iter(values)
        return tree_map(lambda _: next(it), params)
    new_state = {"m": rebuild(new_m), "v": rebuild(new_v), "step": step}
    return rebuild(new_p), new_state, {"lr": lr, "grad_norm": gnorm}
