"""Multi-pod dry run (port of ``repro.launch.dryrun``): run one step of
every (arch x shape x mesh) cell on shapes alone and record its memory per
device and its roofline terms.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out experiments/dryrun_torch]

How a cell runs, and what stands for the reference's JAX machinery:

* the reference's 512 placeholder XLA devices are a fake process group
  (``torch.testing``'s ``FakeStore``, backend ``"fake"``), this process
  its rank 0: collectives are issued and counted but move nothing. The
  cell initialises it and destroys it when done; nothing here touches a
  process group at import;
* ``jax.eval_shape`` is the meta device: parameters, optimizer state,
  batch and cache are meta tensors (``MetaGenerator`` draws the
  parameters), their specs computed by the ported sharding rules on the
  logical mesh (equal to JAX's), and placed with ``distribute_tensor`` on
  the ``DeviceMesh`` those specs need (``shd.fold_axes``): on 2x16x16 the
  batch's ("pod", "data") is one dim of 32, "pod+data", where DTensor
  plans as on 16x16 (a 3-dim mesh costs its planner a graph search over
  every candidate strategy, minutes an op), and an axis no spec names
  (the pod of a batch of 1) is left out, its devices replicating the
  rest; the fake group has that mesh's size;
* ``jit(...).lower().compile()`` is one call of the step
  (``make_train_step`` with the reference's micro-batches and donated
  state, ``make_prefill_step`` or ``make_serve_step``) under
  ``activation_context`` and ``roofline.analysis.StepCounter``, which
  counts the local shards' ops and collectives and tracks the bytes the
  step allocates; outputs are then redistributed to the reference's
  ``out_shardings``;
* XLA's ``memory_analysis`` is the argument, output and alias bytes of
  the local shards and the step's peak allocation (temp = peak less the
  outputs' new bytes, so the total per device is arguments + peak), with
  the op at the peak and the live bytes by op then (``memory.peak``); its
  ``cost_analysis`` has no counterpart, and ``counted`` holds the
  counter's flops and bytes in its place;
* ``lower_s``/``compile_s`` are the cell's wall seconds, ``wall_s``.

A cell that fails prints ``[FAIL]`` and the command exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time
import traceback

import torch

from repro_torch.convert import tree_map
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import make_folded_mesh, production_axes
from repro_torch.models import registry, transformer
from repro_torch.models.common import ModelConfig
from repro_torch.roofline import analysis as ra
from repro_torch.roofline import hw
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
from repro_torch.train.step import (make_prefill_step, make_serve_step,
                                    make_train_step)

# per-device microbatch targets at train_4k (keeps remat-saved layer
# activations ~1 sample/layer for the big archs)
TRAIN_MICROBATCHES = {
    "deepseek-v2-236b": 16, "command-r-35b": 16, "gemma3-27b": 16,
    "qwen2-vl-7b": 8, "zamba2-7b": 8, "qwen1.5-4b": 4, "qwen2-moe-a2.7b": 4,
    "hubert-xlarge": 4, "tinyllama-1.1b": 2, "mamba2-1.3b": 2,
}
# bf16 optimizer moments for the largest archs (memory/accuracy trade)
BF16_OPT_STATE = {"deepseek-v2-236b", "command-r-35b", "gemma3-27b"}


class MetaGenerator(torch.Generator):
    """A CPU generator that says it lives on the meta device: the
    parameter init draws on ``gen.device``, so ``transformer.init`` with
    it returns meta tensors of the tree's shapes and dtypes, and the meta
    kernels ignore the generator. The counterpart of ``jax.eval_shape``
    over the init."""

    @property
    def device(self):
        return torch.device("meta")


def dryrun_config(arch: str, mesh, variant: dict = None,
                  smoke: bool = False) -> ModelConfig:
    cfg = registry.get_config(arch, smoke=smoke)
    msize = shd.axis_size(mesh, "model")
    cfg = cfg.padded(msize).replace(
        param_dtype="bfloat16", compute_dtype="bfloat16", attn_impl="chunked")
    variant = variant or {}
    if variant.get("moe_scheme"):
        cfg = cfg.replace(moe_scheme=variant["moe_scheme"])
    if variant.get("attn_chunk"):
        cfg = cfg.replace(attn_chunk=variant["attn_chunk"])
    if variant.get("ssm_chunk"):
        cfg = cfg.replace(ssm_chunk=variant["ssm_chunk"])
    if variant.get("remat_save_outputs"):
        cfg = cfg.replace(remat_save_outputs=True)
    return cfg


def microbatches(arch: str, mesh, global_batch: int, variant: dict) -> int:
    """The reference's micro-batch count: the arch's target, at most the
    rows a batch shard holds, and a divisor of the global batch."""
    nm = variant.get("microbatches") or TRAIN_MICROBATCHES.get(arch, 2)
    shard_prod = 1
    for a in shd.batch_axes(mesh, global_batch):
        shard_prod *= shd.axis_size(mesh, a)
    nm = min(nm, max(1, global_batch // shard_prod))
    while global_batch % nm:
        nm -= 1
    return nm


def _zip(fn, tree, specs):
    """``fn(leaf, spec)`` at every leaf of ``tree``, its spec at the same
    path of ``specs``."""
    if isinstance(tree, dict):
        return {k: _zip(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zip(fn, v, s) for v, s in zip(tree, specs)]
    return fn(tree, specs)


def _place(mesh, tree, specs):
    """Every leaf of ``tree`` distributed on ``mesh`` by its spec."""
    from torch.distributed.tensor import distribute_tensor
    return _zip(lambda t, s: distribute_tensor(
        t, mesh, list(shd.placements(mesh, s))), tree, specs)


def build_cell(arch: str, shape, mesh, variant: dict = None,
               smoke: bool = False):
    """Returns (cfg, fn, args, arg_specs, out_specs, meta) on the logical
    ``mesh`` (``shd.make_abstract_mesh``): ``args`` are meta tensors,
    ``arg_specs`` their specs, to be placed on a ``DeviceMesh``;
    ``fn(*placed)`` runs the step; ``out_specs`` place its outputs.
    ``shape`` names a cell of ``registry.SHAPES`` or is a ``ShapeSpec``;
    ``smoke`` takes the arch's reduced config (tests)."""
    variant = variant or {}
    cfg = dryrun_config(arch, mesh, variant, smoke)
    spec = registry.shape_spec(shape)
    specs = registry.input_specs(cfg, spec)
    params = transformer.init(MetaGenerator(), cfg)
    pspecs = shd.params_pspecs(cfg, params, mesh)
    P = shd.P

    if spec.kind == "train":
        ocfg = OptimizerConfig(
            state_dtype="bfloat16" if arch in BF16_OPT_STATE else None)
        opt = init_opt_state(params, ocfg)
        ospecs = shd.opt_state_pspecs(cfg, opt, mesh,
                                      zero_pod=bool(variant.get("zero_pod")))
        nm = microbatches(arch, mesh, spec.global_batch, variant)
        step = make_train_step(cfg, ocfg, num_microbatches=nm,
                               grad_accum_dtype=variant.get("grad_accum"),
                               donate=True)
        batch = {k: specs[k] for k in ("inputs", "labels", "positions")}
        bspecs = shd.train_batch_pspecs(cfg, mesh, batch)
        return cfg, step, [params, opt, batch], [pspecs, ospecs, bspecs], \
            [pspecs, ospecs, P()], {"num_microbatches": nm}

    baxes = shd.batch_axes(mesh, spec.global_batch) or None
    logits_spec = P(baxes, "model")
    if spec.kind == "prefill":
        cache = transformer.init_cache(cfg, spec.global_batch, spec.seq_len,
                                       dtype=torch.bfloat16, device="meta")
        cspecs = shd.cache_pspecs(cfg, cache, mesh, spec.global_batch,
                                  mode=variant.get("cache_mode", "seq"))
        inp = [specs["inputs"], specs["positions"]]
        ispecs = shd.train_batch_pspecs(cfg, mesh, inp)
        step = make_prefill_step(cfg, s_cache=spec.seq_len)
        return cfg, step, [params] + inp, [pspecs] + ispecs, [
            logits_spec, cspecs], {}

    cache = specs["cache"]
    cspecs = shd.cache_pspecs(cfg, cache, mesh, spec.global_batch,
                              mode=variant.get("cache_mode", "seq"))
    tok_spec = P(baxes, None)
    pos_spec = P(None, baxes, None) if cfg.mrope_sections else tok_spec
    step = make_serve_step(cfg)
    return cfg, step, [params, specs["token"], specs["positions"], cache,
                       specs["index"]], \
        [pspecs, tok_spec, pos_spec, cspecs, P()], [
        tok_spec, logits_spec, cspecs], {}


def _redistribute(mesh, out, specs):
    """The outputs at the reference's ``out_shardings``."""
    def one(t, spec):
        want = shd.placements(mesh, spec)
        return t if tuple(t.placements) == want else t.redistribute(mesh,
                                                                     want)
    return _zip(one, out, specs)


def _local_bytes(tree) -> int:
    n = []
    tree_map(lambda t: n.append(t.to_local().numel()
                                * t.element_size()), tree)
    return sum(n)


def _storages(tree) -> set:
    out = set()
    tree_map(lambda t: out.add(t.to_local().untyped_storage()._cdata),
             tree)
    return out


def _aliased_bytes(out, args) -> int:
    inputs = _storages(args)
    n = []
    tree_map(lambda t: n.append(
        t.to_local().numel() * t.element_size()
        if t.to_local().untyped_storage()._cdata in inputs else 0), out)
    return sum(n)


def _peak_ops(counter, top: int = 8) -> dict:
    """The op whose output set the step's peak, and the ops whose outputs
    were live then, largest first (bytes per device)."""
    by_op = sorted(counter.peak_live_by_op.items(), key=lambda kv: -kv[1])
    return {"op": counter.peak_op,
            "live_bytes_by_op": dict(by_op[:top])}


def measure_cell(arch: str, shape, mesh, mesh_name: str,
                 variant: dict = None, smoke: bool = False) -> dict:
    """One cell on the logical ``mesh``: its specs computed there, a fake
    process group made for the ``DeviceMesh`` they need
    (``shd.fold_axes``: on 2x16x16, ("pod+data", "model"), or the
    16x16 dims where no spec names "pod") and destroyed when done."""
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication
    t0 = time.time()
    variant = variant or {}
    cfg, fn, args, arg_specs, out_specs, meta = build_cell(
        arch, shape, mesh, variant, smoke)
    spec = registry.shape_spec(shape)
    bax = shd.batch_axes(mesh, spec.global_batch)
    groups = shd.fold_axes(mesh, shd.spec_leaves([arg_specs, out_specs])
                           + [shd.P(bax or None, "model")])
    world = 1
    for g in groups:
        for a in g:
            world *= shd.axis_size(mesh, a)
    fake_group(world)
    try:
        dmesh = make_folded_mesh(mesh, groups, device_type="cpu")
        args = _place(dmesh, args, arg_specs)
        arg_bytes = _local_bytes(args)
        grad = spec.kind == "train"
        with shd.activation_context(mesh, spec.global_batch,
                                    seq_parallel=bool(variant.get(
                                        "seq_parallel"))), \
                torch.set_grad_enabled(grad), implicit_replication(), \
                ra.StepCounter(exclude=args) as counter:
            out = list(fn(*args))
            if spec.kind == "train":
                out[2] = out[2]["loss"]
            out = _redistribute(dmesh, out, out_specs)
        out_bytes = _local_bytes(out)
        alias = _aliased_bytes(out, args)
    finally:
        dist.destroy_process_group()
    stats = counter.stats
    roof = ra.roofline_from_stats(stats)
    n_tokens = spec.global_batch * (spec.seq_len if spec.kind != "decode"
                                    else 1)
    mf = ra.model_flops(cfg, n_tokens,
                        "train" if spec.kind == "train" else "infer")
    n_chips = mesh.size
    temp = counter.peak_bytes - (out_bytes - alias)
    return {
        "arch": arch, "shape": spec.name, "mesh": mesh_name,
        "status": "ok",
        "skip_reason": "",
        "n_chips": n_chips,
        "meta": dict(meta, device_mesh=[shd.FOLD.join(g) for g in groups]),
        "wall_s": time.time() - t0,
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": temp,
            "alias_bytes": alias,
            "total_per_device": arg_bytes + out_bytes + temp - alias,
            "hbm_limit": hw.HBM_BYTES,
            "peak": _peak_ops(counter),
        },
        "counted": {"flops": stats.flops, "bytes accessed": stats.hbm_bytes},
        "roofline": roof.to_dict(),
        "model_flops_global": mf,
        "model_flops_per_device": mf / n_chips,
        "useful_flops_ratio": ((mf / n_chips) / roof.flops if roof.flops
                               else None),
    }


def fake_group(world: int):
    """Initialise the fake process group of ``world`` ranks (this process
    rank 0)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def run_cell(arch: str, shape, multi_pod: bool, out_dir: pathlib.Path,
             variant: dict = None, tag: str = "", mesh_shape=None,
             smoke: bool = False) -> dict:
    """One cell on the production mesh (or on ``mesh_shape``, axis names
    to sizes in order, for small meshes). Writes and returns the record."""
    if mesh_shape is None:
        mesh_shape = production_axes(multi_pod)
    mesh_name = "x".join(str(s) for s in mesh_shape.values())
    mesh = shd.make_abstract_mesh(tuple(mesh_shape.values()),
                                  tuple(mesh_shape))
    spec = registry.shape_spec(shape)
    cfg0 = registry.get_config(arch, smoke=smoke)
    ok, why = registry.cell_supported(cfg0, spec)
    rec = {"arch": arch, "shape": spec.name, "mesh": mesh_name,
           "status": "skipped", "skip_reason": why}
    if not ok:
        return rec
    rec = measure_cell(arch, spec, mesh, mesh_name, variant, smoke)
    out_dir.mkdir(parents=True, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    rec["variant"] = variant or {}
    rec["tag"] = tag
    path = out_dir / f"{arch}__{spec.name}__{mesh_name}{suffix}.json"
    path.write_text(json.dumps(rec, indent=2))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--tag", default="", help="variant tag (output suffix)")
    ap.add_argument("--moe-scheme", default=None,
                    choices=[None, "topk", "sorted"])
    ap.add_argument("--cache-mode", default=None,
                    choices=[None, "seq", "heads", "hd"])
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--attn-chunk", type=int, default=None)
    ap.add_argument("--ssm-chunk", type=int, default=None)
    ap.add_argument("--remat-save-outputs", action="store_true")
    ap.add_argument("--grad-accum", default=None, choices=[None, "bf16"])
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--zero-pod", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)
    out = pathlib.Path(args.out)
    variant = {k: v for k, v in dict(
        moe_scheme=args.moe_scheme, cache_mode=args.cache_mode,
        microbatches=args.microbatches, attn_chunk=args.attn_chunk,
        ssm_chunk=args.ssm_chunk,
        remat_save_outputs=args.remat_save_outputs or None,
        grad_accum=args.grad_accum,
        seq_parallel=args.seq_parallel or None,
        zero_pod=args.zero_pod or None).items() if v}

    archs = (registry.ASSIGNED_ARCHS if (args.all or not args.arch)
             else (args.arch,))
    shapes = (tuple(registry.SHAPES) if (args.all or not args.shape)
              else (args.shape,))
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    n_fail = 0
    records = []
    for mp in meshes:
        for arch in archs:
            for shape in shapes:
                tag = f"{arch} x {shape} x {'2x16x16' if mp else '16x16'}"
                try:
                    rec = run_cell(arch, shape, mp, out, variant=variant,
                                   tag=args.tag)
                except Exception as e:
                    n_fail += 1
                    print(f"[FAIL] {tag}: {type(e).__name__}: {e}",
                          flush=True)
                    traceback.print_exc()
                    continue
                records.append(rec)
                if rec["status"] == "skipped":
                    print(f"[skip] {tag}: {rec['skip_reason']}", flush=True)
                else:
                    m = rec["memory"]["total_per_device"] / 2**30
                    r = rec["roofline"]
                    print(f"[ ok ] {tag}: mem/dev={m:.2f}GiB "
                          f"compute={r['compute_s']*1e3:.2f}ms "
                          f"memory={r['memory_s']*1e3:.2f}ms "
                          f"collective={r['collective_s']*1e3:.2f}ms "
                          f"dominant={r['dominant']} "
                          f"(wall {rec['wall_s']:.0f}s)", flush=True)
    if n_fail:
        raise SystemExit(f"{n_fail} cells failed")
    return records


if __name__ == "__main__":
    main()
