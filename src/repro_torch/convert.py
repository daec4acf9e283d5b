"""Convert model parameters between the JAX package's pytree (as numpy
arrays) and the port's tensors, in both directions.

Layouts:

* LM tree of ``transformer.init`` (``embed.table``, ``segments[i].b0`` with
  leaves stacked (L, ...), ``final_norm``, ``head``). The port keeps it as
  it is: no expert axis, every leaf the same shape.

* ``transformer`` kind. JAX leaves have no expert axis, and segment leaves
  are stacked over layers, (L, ...) (``repro/models/transformer.py:50``).
  The port adds a leading expert axis of 1: (1, ...) and (L, 1, ...).
* ``moe`` kind. JAX stacks whole expert trees (``foundation.py:65``), so
  ``experts`` leaves are (E, ...) and segment leaves (E, L, ...). The port
  keeps (E, ...) and stores segment leaves (L, E, ...), so each layer's
  weights for all experts are one contiguous slice. ``gate`` is unchanged.

The trunk's unused ``head`` leaf (``transformer.py:56``) is carried along.
A round trip returns identical arrays. The optimizer state of
``train/optimizer.py`` (``m`` and ``v`` shaped like the parameters, an
int32 ``step``) converts the same way.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _map_trunk(tree: Dict, seg_fn: Callable, leaf_fn: Callable) -> Dict:
    """Map one (possibly expert-stacked) trunk tree: ``seg_fn`` on the
    layer-stacked segment leaves, ``leaf_fn`` on every other leaf."""
    out = {k: tree_map(leaf_fn, v) for k, v in tree.items() if k != "trunk"}
    trunk = tree["trunk"]
    out["trunk"] = {k: tree_map(leaf_fn, v) for k, v in trunk.items()
                    if k != "segments"}
    out["trunk"]["segments"] = tree_map(seg_fn, trunk["segments"])
    return out


def widened(params: Dict) -> bool:
    """Whether ``params`` (or a tree shaped like it) is a transformer-kind
    agent tree, whose every leaf carries the expert axis of 1 that the port
    adds: its JAX counterpart has one dimension fewer."""
    return isinstance(params, dict) and "trunk" in params \
        and "experts" not in params


def from_jax(jparams: Dict[str, Any], device=None) -> Dict:
    """JAX LM or foundation params (numpy or jax arrays) -> the port's
    tensors on ``device`` (CUDA unless ``device="cpu"``)."""
    dev = resolve_device(device)

    def tensor(a):
        return torch.from_numpy(np.array(a))

    if "segments" in jparams:                         # LM tree
        params = tree_map(tensor, jparams)
    elif "experts" not in jparams:                    # transformer kind
        params = _map_trunk(jparams,
                            lambda a: tensor(a).unsqueeze(1),
                            lambda a: tensor(a).unsqueeze(0))
    else:
        params = {"experts": _map_trunk(
            jparams["experts"],
            lambda a: tensor(a).transpose(0, 1).contiguous(), tensor),
            "gate": tensor(jparams["gate"])}
    return tree_map(lambda t: t.to(dev), params)


def to_jax(params: Dict) -> Dict[str, Any]:
    """The port's parameters -> the JAX package's layout, as numpy arrays."""
    def array(t):
        return t.detach().cpu().numpy()

    if "segments" in params:
        return tree_map(array, params)
    if "experts" not in params:
        return _map_trunk(params, lambda t: array(t.squeeze(1)),
                          lambda t: array(t.squeeze(0)))
    return {"experts": _map_trunk(
        params["experts"], lambda t: array(t.transpose(0, 1).contiguous()),
        array), "gate": array(params["gate"])}


def opt_state_from_jax(jstate: Dict[str, Any], device=None) -> Dict:
    """The JAX package's AdamW state -> the port's: ``m`` and ``v`` in the
    parameters' layout, ``step`` an int32 scalar tensor."""
    dev = resolve_device(device)
    return {"m": from_jax(jstate["m"], device=dev),
            "v": from_jax(jstate["v"], device=dev),
            "step": torch.tensor(int(np.asarray(jstate["step"])),
                                 dtype=torch.int32, device=dev)}


def opt_state_to_jax(state: Dict) -> Dict[str, Any]:
    """The port's AdamW state -> the JAX package's layout, as numpy."""
    return {"m": to_jax(state["m"]), "v": to_jax(state["v"]),
            "step": np.asarray(int(state["step"]), np.int32)}
