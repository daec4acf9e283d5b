"""Sharding rules (port of ``repro.dist.sharding``): the logical-to-mesh
layout of parameters, optimizer state, activations and KV caches.

The rules are the reference's, unchanged: a dimension is sharded on a mesh
axis only when it divides the axis size product; otherwise the rule
degrades (expert dim -> expert-internal ff; sharded -> replicated) rather
than failing, which lets one set of rules cover every (arch x shape x mesh)
cell of the dry run.

What JAX expresses with its own types, the port expresses so:

* a spec is a ``PartitionSpec``: a tuple with one entry a tensor dim, each
  a mesh axis name, a tuple of names, or ``None`` (trailing dims implicit);
* a mesh is either ``make_abstract_mesh``'s device-free description (names
  and sizes, for spec-only work) or a ``torch.distributed`` ``DeviceMesh``
  with named dims;
* ``to_shardings`` maps specs to DTensor placements on a ``DeviceMesh``:
  ``Shard(d)`` on every mesh dim that a spec names for tensor dim d,
  ``Replicate()`` on the rest;
* a ``DeviceMesh`` dim may stand for several logical axes: a dim named
  "pod+data" is the pod and data axes folded into one, pod major, as a
  spec entry ("pod", "data") shards a tensor dim. ``fold_axes`` finds the
  dims a set of specs needs: axes that every spec names together share a
  dim, and an axis that no spec names (pure replication) has none. DTensor
  plans a redistribution on a 3-dim mesh by a graph search over every
  candidate strategy, minutes an op; on the folded 2-dim mesh it plans as
  on 16x16 (``launch.mesh.make_folded_mesh``, the dry run);
* ``constrain`` is ``with_sharding_constraint``: inside an
  ``activation_context`` it ``redistribute``s a DTensor to the placements
  its logical axes give. Outside one (tests, single-device runs) it is the
  identity, so model code calls it unconditionally.

Logical axis names of ``constrain``:
  "B" — global batch     -> the mesh batch axes for the active context
  "S" — sequence         -> "model" under sequence parallelism, else none
  "M" — memory/cache seq -> "model" (the serving cache layout)
  None — unsharded
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, Sequence, Tuple

import torch


def _entry(e):
    """JAX's normal form of an entry: a one-name tuple is the name, an
    empty one ``None``."""
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else e[0] if len(e) == 1 else e
    return e


class PartitionSpec(tuple):
    """One entry a tensor dim: a mesh axis name, a tuple of names, or
    ``None``; dims past the last entry are unsharded. Entries are kept in
    JAX's normal form (``_entry``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_entry(e) for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A device-free mesh: axis names and sizes."""
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n


# ----------------------------------------------------------------- mesh utils
FOLD = "+"      # joins the logical axes of one folded DeviceMesh dim


def _mesh_dims(mesh) -> Tuple[str, ...]:
    """The mesh's dim names; a folded DeviceMesh dim's name joins its
    axes with ``FOLD``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names or ())


def _axis_names(mesh) -> Tuple[str, ...]:
    """The logical axes, in mesh order."""
    return tuple(a for d in _mesh_dims(mesh) for a in d.split(FOLD))


def _axis_sizes(mesh) -> Dict[str, int]:
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    if any(FOLD in d for d in _mesh_dims(mesh)):
        raise ValueError("a folded mesh has no size per axis: compute specs "
                         "on the logical mesh (make_abstract_mesh)")
    return dict(zip(_mesh_dims(mesh), mesh.shape))


def axis_size(mesh, name: str) -> int:
    """Size of a mesh axis; absent axes count as size 1."""
    return int(_axis_sizes(mesh).get(name, 1))


def make_abstract_mesh(axis_sizes: Sequence[int],
                       axis_names: Sequence[str]) -> AbstractMesh:
    """Device-free mesh for spec-only work."""
    return AbstractMesh(tuple(axis_sizes), tuple(axis_names))


def batch_axes(mesh, global_batch: int) -> Tuple[str, ...]:
    """Greedy batch-axis assignment: take mesh axes (pod, data) in order
    while the global batch stays divisible by the joint size."""
    axes = []
    prod = 1
    for name in ("pod", "data"):
        sz = axis_size(mesh, name)
        if sz <= 1 or name not in _axis_names(mesh):
            continue
        if global_batch % (prod * sz) == 0:
            axes.append(name)
            prod *= sz
    return tuple(axes)


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _names_run(names, group) -> bool:
    """Does ``names`` hold ``group`` as a run, in its order?"""
    n = len(group)
    return any(tuple(names[i:i + n]) == tuple(group)
               for i in range(len(names) - n + 1))


def placements(mesh, spec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``'s dims, in their order:
    ``Shard(d)`` where the spec names the mesh dim for tensor dim d (all
    the axes of a folded dim, as a run), ``Replicate()`` elsewhere. A spec
    that names an axis the mesh lacks, or part of a folded dim, raises."""
    from torch.distributed.tensor import Replicate, Shard
    have = set(_axis_names(mesh))
    for entry in spec:
        for a in _names(entry):
            if a not in have:
                raise ValueError(f"{spec} names {a!r}, which the mesh "
                                 f"{_mesh_dims(mesh)} lacks")
    out = []
    for name in _mesh_dims(mesh):
        group = tuple(name.split(FOLD))
        dim = None
        for d, entry in enumerate(spec):
            names = _names(entry)
            if any(a in names for a in group):
                if not _names_run(names, group):
                    raise ValueError(f"{spec} splits the folded mesh dim "
                                     f"{name!r}")
                dim = d
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


def fold_axes(mesh, specs) -> Tuple[Tuple[str, ...], ...]:
    """The DeviceMesh dims that ``specs`` need on the logical ``mesh``,
    each a tuple of axes in mesh order: an axis that no spec names is left
    out (its devices replicate the rest), and adjacent axes that every
    spec names together, the first right before the second, share a dim.
    On 16x16 every dry-run cell names both axes apart; on 2x16x16 the batch
    names ("pod", "data") and nothing names either alone, so the cell runs
    on ("pod+data", "model")."""
    entries = [_names(e) for s in specs for e in s if e is not None]
    groups = []
    for a in _axis_names(mesh):
        if not any(a in e for e in entries):
            continue
        if groups and all(
                (a in e) == (groups[-1][-1] in e) and (
                    a not in e or _names_run(e, (groups[-1][-1], a)))
                for e in entries):
            groups[-1] = groups[-1] + (a,)
        else:
            groups.append((a,))
    return tuple(groups)


def _is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def spec_leaves(specs) -> list:
    """The PartitionSpecs of a tree of them, in order."""
    out = []
    _map_specs(out.append, specs)
    return out


def _map_specs(fn, tree):
    if _is_spec(tree) or tree is None:
        return None if tree is None else fn(tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_specs(fn, v) for v in tree)
    raise TypeError(f"not a spec tree: {type(tree)}")


def to_shardings(mesh, specs):
    """Map a tree of PartitionSpecs to ``(mesh, placements)`` pairs on a
    ``DeviceMesh``, the arguments ``distribute_tensor`` takes."""
    return _map_specs(lambda s: (mesh, placements(mesh, s)), specs)


def _divisible(dim: int, mesh, axes) -> bool:
    prod = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        prod *= axis_size(mesh, a)
    return dim % prod == 0


def _spec(dim: int, axes) -> P:
    """PartitionSpec sharding ``dim`` on ``axes``, trailing dims implicit."""
    entries = [None] * (dim + 1)
    entries[dim] = axes
    return P(*entries)


# ------------------------------------------------------------- param layout
def _param_rule(key: str, shape: Tuple[int, ...], mesh) -> P:
    """One leaf -> PartitionSpec. ``key`` is the '/'-joined tree path."""
    parts = key.split("/")
    name = parts[-1]
    ndim = len(shape)
    m = "model"

    def ok(d):
        return _divisible(shape[d], mesh, m)

    if name == "scale" or ndim <= 1:
        return P()
    if "experts" in parts:
        # (stack?, E, ...): experts on model when E divides; else shard
        # expert-internal ff (last dim for wi, -2 for wo)
        e = ndim - 4 if name == "wi" else ndim - 3
        if e >= 0 and ok(e):
            return _spec(e, m)
        f = ndim - 1 if name == "wi" else ndim - 2
        if ok(f):
            return _spec(f, m)
        return P()
    if name in ("wq", "wk", "wv"):          # (stack?, d, H, hd): heads
        h = ndim - 2
        return _spec(h, m) if ok(h) else P()
    if name in ("bq", "bk", "bv"):          # (stack?, H, hd): heads
        h = ndim - 2
        return _spec(h, m) if ok(h) else P()
    if name == "wo" and "attn" in parts:    # (stack?, H, hd, d): heads
        h = ndim - 3
        return _spec(h, m) if ok(h) else P()
    if name == "wi":                        # (stack?, d, 2, ff): ff
        f = ndim - 1
        return _spec(f, m) if ok(f) else P()
    if name == "wo":                        # (stack?, ff, d): ff
        f = ndim - 2
        return _spec(f, m) if ok(f) else P()
    if name == "table" or parts[0] == "embed":      # (vocab, d): vocab
        return _spec(0, m) if ok(0) else P()
    if name == "head" or parts[-1] == "head":       # (d, vocab): vocab
        f = ndim - 1
        return _spec(f, m) if ok(f) else P()
    if name in ("w_x", "w_z", "conv_x_w", "conv_x_b", "out_norm"):
        f = ndim - 1                        # mamba: channel (d_inner)
        return _spec(f, m) if ok(f) else P()
    if name == "out_proj":                  # (stack?, d_inner, d)
        f = ndim - 2
        return _spec(f, m) if ok(f) else P()
    return P()                              # small / unknown: replicate


def _walk_specs(tree, mesh, rule, prefix: Tuple[str, ...] = ()):
    """``rule(key, shape, mesh)`` at every leaf (anything with a
    ``shape``), ``key`` its path as the reference's tree paths join it:
    dict keys and list indices by '/'. ``None`` stays an empty subtree."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _walk_specs(v, mesh, rule, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk_specs(v, mesh, rule, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return rule("/".join(prefix), tuple(tree.shape), mesh)


def params_pspecs(cfg, params_shape, mesh):
    """PartitionSpec tree for the model parameters."""
    return _walk_specs(params_shape, mesh, _param_rule)


def opt_state_pspecs(cfg, opt_shape, mesh, zero_pod: bool = False):
    """Optimizer state follows its parameter's layout; with ``zero_pod``
    the moments are additionally ZeRO-sharded over the pod axis on their
    leading dim when divisible."""
    def rule(key, shape, mesh_):
        parts = key.split("/")
        if parts[0] in ("m", "v") and len(parts) > 1:
            spec = _param_rule("/".join(parts[1:]), shape, mesh_)
            if zero_pod and shape and axis_size(mesh_, "pod") > 1:
                entries = list(tuple(spec)) + [None] * (len(shape)
                                                        - len(tuple(spec)))
                if entries[0] is None and _divisible(shape[0], mesh_, "pod"):
                    entries[0] = "pod"
                    return P(*entries)
            return spec
        return P()                          # step counter etc.
    return _walk_specs(opt_shape, mesh, rule)


# --------------------------------------------------------- batch/cache layout
def train_batch_pspecs(cfg, mesh, batch):
    """Input batch dict: shard the batch dim over the mesh batch axes.
    mrope-style (3, B, S) position arrays carry a leading section dim."""
    def rule(key, shape, mesh_):
        if len(shape) >= 2 and shape[0] == 3 and getattr(
                cfg, "mrope_sections", None):
            b = shape[1]
            ax = batch_axes(mesh_, b)
            return P(None, ax if ax else None)
        if not shape:
            return P()
        ax = batch_axes(mesh_, shape[0])
        return P(ax if ax else None)
    return _walk_specs(batch, mesh, rule)


def cache_pspecs(cfg, cache_shape, mesh, batch: int, mode: str = "seq"):
    """KV/state cache layout. Leaves look like (stack, B, S, H, hd) for
    attention (or (stack, B, S, dc) for MLA; (stack, B, K, d) for conv
    state). Batch shards over the batch axes; in ``seq`` mode the
    sequence dim takes "model" plus any batch axes left idle (the B=1
    long-context layout); ``heads``/``hd`` shard those dims instead."""
    bax = batch_axes(mesh, batch)

    def rule(key, shape, mesh_):
        if len(shape) < 3:
            return P()
        entries: list = [None] * len(shape)
        if _divisible(shape[1], mesh_, bax) and bax:
            entries[1] = bax if len(bax) > 1 else bax[0]
        idle = tuple(a for a in ("data",) if a not in bax
                     and axis_size(mesh_, a) > 1)
        if mode == "heads" and len(shape) >= 4:
            if _divisible(shape[3], mesh_, "model"):
                entries[3] = "model"
        elif mode == "hd" and len(shape) >= 5:
            if _divisible(shape[4], mesh_, "model"):
                entries[4] = "model"
        else:                               # "seq"
            seq_axes = idle + ("model",) if not bax else ("model",)
            if _divisible(shape[2], mesh_, seq_axes):
                entries[2] = seq_axes if len(seq_axes) > 1 else seq_axes[0]
            elif _divisible(shape[2], mesh_, "model"):
                entries[2] = "model"
        return P(*entries)
    return _walk_specs(cache_shape, mesh, rule)


# ------------------------------------------------------ activation constraints
_ctx = threading.local()


@contextlib.contextmanager
def activation_context(mesh, global_batch: int, seq_parallel: bool = False):
    """Install the logical-axis mapping used by ``constrain``. Model code
    runs unchanged outside the context (identity)."""
    prev = getattr(_ctx, "state", None)
    _ctx.state = {"mesh": mesh, "batch_axes": batch_axes(mesh, global_batch),
                  "seq_parallel": seq_parallel}
    try:
        yield
    finally:
        _ctx.state = prev


def logical_spec(shape, axes) -> P:
    """The PartitionSpec that ``constrain`` gives a tensor of ``shape``
    under the active context's mapping."""
    state = _ctx.state
    mesh = state["mesh"]
    entries = []
    for dim, ax in zip(shape, axes):
        if ax == "B":
            bax = state["batch_axes"]
            ok = bax and _divisible(dim, mesh, bax)
            entries.append((bax if len(bax) > 1 else bax[0]) if ok else None)
        elif ax == "S":
            ok = state["seq_parallel"] and _divisible(dim, mesh, "model")
            entries.append("model" if ok else None)
        elif ax == "M":
            entries.append("model" if _divisible(dim, mesh, "model")
                           else None)
        else:
            entries.append(None)
    return P(*entries)


def constrain(x, *axes):
    """``with_sharding_constraint`` on logical axes: inside a context a
    DTensor is redistributed to the placements they give, and so is its
    cotangent in the backward (``_Constrain``); with no context, or a
    plain tensor, ``x`` as it is. The context's mesh gives the spec (a
    folded DeviceMesh cannot: pass the logical mesh); the tensor's own
    mesh the placements."""
    if getattr(_ctx, "state", None) is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    want = placements(x.device_mesh, logical_spec(x.shape, axes))
    return _Constrain.apply(x, want)


class _Constrain(torch.autograd.Function):
    """``constrain``'s redistribution, whose backward redistributes the
    cotangent to the same placements: ``with_sharding_constraint``
    constrains both. DTensor's own ``redistribute`` leaves a cotangent
    where the ops behind it put it: a pending sum over "model" from the
    vocab-sharded head reaches every layer's output projections, whose
    weight gradients DTensor then computes at full width on each rank."""

    @staticmethod
    def forward(ctx, x, want):
        ctx.want = want
        if tuple(x.placements) == want:
            return x.view_as(x)
        return x.redistribute(x.device_mesh, want)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.want:
            g = g.redistribute(g.device_mesh, ctx.want)
        return g, None
