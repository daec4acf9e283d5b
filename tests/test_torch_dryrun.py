"""The port's dry run (``repro_torch.launch.dryrun``) and the registry's
cells: ``SHAPES``, ``cell_supported``, ``runnable_cells`` and
``input_specs`` (meta tensors of JAX's shapes and dtypes, the decode
cache's leaves included) against the JAX package's registry;
``dryrun_config`` against the reference's for its variants; a ``SMOKE``
cell of each kind run on a fake (2, 2) process group and on a fake
(2, 2, 2) one (folded to ("pod+data", "model")), whose
record has the reference's keys (``counted`` in place of
``xla_cost_analysis``, ``wall_s`` in place of ``lower_s``/``compile_s``)
and the argument bytes the sharding specs give each device; and no
process group left behind."""
import os

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.dist import sharding as jshd
from repro.models import registry as jreg
from repro_torch.dist import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.models import registry

_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdryrun  # noqa: E402  (sets XLA_FLAGS)
if _flags is None:                # the reference's 512-device flag is its
    os.environ.pop("XLA_FLAGS", None)   # dry run's alone
else:
    os.environ["XLA_FLAGS"] = _flags

_JAX_DTYPES = {torch.int32: np.int32, torch.bfloat16: jax.numpy.bfloat16,
               torch.float32: np.float32}


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in
                _leaves(tree[k], prefix + (k,))]
    if isinstance(tree, list):
        return [kv for i, v in enumerate(tree) for kv in
                _leaves(v, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def test_shapes_and_cells_match_jax():
    assert registry.ASSIGNED_ARCHS == jreg.ASSIGNED_ARCHS
    assert {k: (v.name, v.seq_len, v.global_batch, v.kind)
            for k, v in registry.SHAPES.items()} == \
        {k: (v.name, v.seq_len, v.global_batch, v.kind)
         for k, v in jreg.SHAPES.items()}
    assert list(registry.runnable_cells()) == list(jreg.runnable_cells())


@pytest.mark.parametrize("arch", registry.ASSIGNED_ARCHS)
def test_input_specs_match_jax(arch):
    t, j = registry.get_config(arch).padded(16), \
        jreg.get_config(arch).padded(16)
    for shape in registry.SHAPES:
        if not registry.cell_supported(t, shape)[0]:
            continue
        ts, js = _leaves(registry.input_specs(t, shape)), \
            _leaves(jreg.input_specs(j, shape))
        assert [k for k, _ in ts] == [k for k, _ in js]
        for (k, a), (_, b) in zip(ts, js):
            assert a.device.type == "meta", k
            assert tuple(a.shape) == tuple(b.shape), (shape, k)
            assert np.dtype(_JAX_DTYPES[a.dtype]) == np.dtype(b.dtype), k


@pytest.mark.parametrize("variant", [
    {"moe_scheme": "sorted", "attn_chunk": 512}, {"remat_save_outputs": True},
    {"ssm_chunk": 128}, {}])
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "zamba2-7b",
                                  "qwen1.5-4b"])
def test_dryrun_config_matches_jax(arch, variant):
    t = dryrun.dryrun_config(arch, shd.make_abstract_mesh(
        (16, 16), ("data", "model")), variant)
    j = jdryrun.dryrun_config(arch, jshd.make_abstract_mesh(
        (16, 16), ("data", "model")), variant)
    for f in ("padded_vocab", "padded_heads", "padded_kv_heads",
              "param_dtype", "compute_dtype", "attn_impl", "moe_scheme",
              "attn_chunk", "ssm_chunk", "remat", "remat_save_outputs"):
        assert getattr(t, f) == getattr(j, f), f
    assert dryrun.TRAIN_MICROBATCHES == jdryrun.TRAIN_MICROBATCHES
    assert dryrun.BF16_OPT_STATE == jdryrun.BF16_OPT_STATE


_KEYS = {"arch", "shape", "mesh", "status", "skip_reason", "n_chips", "meta",
         "wall_s", "memory", "counted", "roofline", "model_flops_global",
         "model_flops_per_device", "useful_flops_ratio", "variant", "tag"}
_SPECS = {"train": registry.ShapeSpec("smoke_train", 16, 8, "train"),
          "prefill": registry.ShapeSpec("smoke_prefill", 16, 4, "prefill"),
          "decode": registry.ShapeSpec("smoke_decode", 16, 4, "decode")}


def _local_bytes(tree, specs, sizes) -> int:
    """Each leaf's bytes over the product of the mesh axes its spec
    names."""
    n = 0
    for (_, t), (_, s) in zip(_leaves(tree), _leaves(specs)):
        div = 1
        for e in s:
            for a in (e if isinstance(e, tuple) else (e,)):
                div *= sizes.get(a, 1)
        n += t.numel() * t.element_size() // div
    return n


_CELLS = [("tinyllama-1.1b", "train"), ("tinyllama-1.1b", "prefill"),
          ("tinyllama-1.1b", "decode"), ("deepseek-v2-236b", "train")]


@pytest.mark.parametrize("arch,kind", _CELLS)
def test_smoke_cell_runs_on_a_fake_group(arch, kind, tmp_path):
    """DeepSeek-V2's: MLA and its MoE layer, its 8 experts sharded 4 a
    rank over "model" (``models.moe._moe_sharded``)."""
    _check_smoke_cell(arch, kind, {"data": 2, "model": 2}, tmp_path,
                      ["data", "model"])


@pytest.mark.parametrize("arch,kind", _CELLS)
def test_smoke_cell_runs_on_a_fake_2x2x2_group(arch, kind, tmp_path):
    """The multi-pod mesh's cells: every spec names "pod" and "data"
    together, so the cell runs on ("pod+data", "model") over 8 ranks,
    and each device holds what the (2, 2, 2) specs give it."""
    _check_smoke_cell(arch, kind, {"pod": 2, "data": 2, "model": 2},
                      tmp_path, ["pod+data", "model"])


def _check_smoke_cell(arch, kind, mesh, tmp_path, device_mesh):
    spec = _SPECS[kind]
    rec = dryrun.run_cell(arch, spec, False, tmp_path, mesh_shape=mesh,
                          smoke=True)
    assert not dist.is_initialized()
    assert set(rec) == _KEYS
    assert rec["status"] == "ok" and rec["n_chips"] == int(np.prod(
        list(mesh.values())))
    assert rec["meta"]["device_mesh"] == device_mesh
    assert (tmp_path / f"{arch}__{spec.name}__"
            f"{'x'.join(map(str, mesh.values()))}.json").is_file()
    # the argument bytes each device holds, from the specs
    amesh = shd.make_abstract_mesh(tuple(mesh.values()), tuple(mesh))
    cfg = dryrun.dryrun_config(arch, amesh, smoke=True)
    params = registry_params(cfg)
    want = _local_bytes(params, shd.params_pspecs(cfg, params, amesh), mesh)
    ins = registry.input_specs(cfg, spec)
    if kind == "train":
        from repro_torch.train.optimizer import (OptimizerConfig,
                                                 init_opt_state)
        opt = init_opt_state(params, OptimizerConfig(
            state_dtype="bfloat16" if arch in dryrun.BF16_OPT_STATE
            else None))
        want += _local_bytes(opt, shd.opt_state_pspecs(cfg, opt, amesh),
                             mesh)
        batch = {k: ins[k] for k in ("inputs", "labels", "positions")}
        want += _local_bytes(batch, shd.train_batch_pspecs(cfg, amesh, batch),
                             mesh)
        shards = int(np.prod([mesh[a] for a in shd.batch_axes(
            amesh, spec.global_batch)]))
        assert rec["meta"]["num_microbatches"] == min(
            dryrun.TRAIN_MICROBATCHES[arch], spec.global_batch // shards)
        mem = rec["memory"]
        assert mem["alias_bytes"] == mem["output_bytes"] - 4   # the loss
    elif kind == "prefill":
        inp = {k: ins[k] for k in ("inputs", "positions")}
        want += _local_bytes(inp, shd.train_batch_pspecs(cfg, amesh, inp),
                             mesh)
    else:
        bax = shd.batch_axes(amesh, spec.global_batch) or None
        want += _local_bytes(
            [ins["token"], ins["positions"], ins["cache"], ins["index"]],
            [shd.P(bax, None), shd.P(bax, None), shd.cache_pspecs(
                cfg, ins["cache"], amesh, spec.global_batch),
             shd.P()], mesh)
    assert rec["memory"]["argument_bytes"] == want
    # the op at the peak, and the live bytes by op then
    peak = rec["memory"]["peak"]
    assert isinstance(peak["op"], str) and peak["live_bytes_by_op"]
    assert sum(peak["live_bytes_by_op"].values()) <= \
        rec["memory"]["temp_bytes"] + rec["memory"]["output_bytes"]
    r = rec["roofline"]
    assert r["flops_per_device"] > 0 and rec["counted"]["flops"] == \
        r["flops_per_device"]
    assert r["collective_bytes_per_device"] > 0


def registry_params(cfg):
    from repro_torch.models import transformer
    return transformer.init(dryrun.MetaGenerator(), cfg)


def test_main_prints_and_exits_on_fail(tmp_path, capsys, monkeypatch):
    """``main`` prints a ``[skip]`` line for a cell the reference skips and
    a ``[FAIL]`` line, then exits non-zero, for one that raises."""
    def boom(*a, **k):
        raise RuntimeError("no rule")
    monkeypatch.setattr(dryrun, "measure_cell", boom)
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "hubert-xlarge", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[skip] hubert-xlarge x decode_32k x 16x16" in out
    assert "[FAIL] hubert-xlarge x train_4k x 16x16: RuntimeError" in out
    assert not dist.is_initialized()
