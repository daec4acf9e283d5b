"""The elastic restore and the distributed launcher:
``restore_checkpoint(..., shardings=)`` places a checkpoint written
without a mesh into a fake 16x16 and 8x16 mesh (each leaf's local shard
the full array's rank-0 slice, as the sharding rules give it), and
``launch.train --distributed`` on gloo with a world of one (a ``file://``
rendezvous in place of torchrun's socket) trains and resumes with the
same losses as without the flag, leaving no process group behind."""

import pytest
import torch
import torch.distributed as dist

from repro_torch.convert import tree_map
from repro_torch.dist import sharding as shd
from repro_torch.launch import train as t_launch
from repro_torch.models import registry, transformer
from repro_torch.train import (OptimizerConfig, init_opt_state,
                               restore_checkpoint, save_checkpoint)


def _slice0(t, placements, sizes):
    """Rank 0's block of the whole tensor ``t`` under ``placements``."""
    from torch.distributed.tensor import Shard
    for p, n in zip(placements, sizes):
        if isinstance(p, Shard):
            t = t.narrow(p.dim, 0, t.shape[p.dim] // n)
    return t


@pytest.mark.parametrize("sizes", [(16, 16), (8, 16)])
def test_restore_into_a_mesh(tmp_path, sizes):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    cfg = registry.get_config("qwen2-moe-a2.7b", smoke=True).padded(16)
    params = transformer.init(torch.Generator().manual_seed(0), cfg)
    state = {"params": params, "opt": init_opt_state(
        params, OptimizerConfig(state_dtype="bfloat16"))}
    save_checkpoint(str(tmp_path), 7, state)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=sizes[0] * sizes[1])
    try:
        mesh = init_device_mesh("cpu", sizes,
                                mesh_dim_names=("data", "model"))
        sh = {"params": shd.to_shardings(mesh, shd.params_pspecs(
                  cfg, params, mesh)),
              "opt": shd.to_shardings(mesh, shd.opt_state_pspecs(
                  cfg, state["opt"], mesh))}
        got, step = restore_checkpoint(str(tmp_path), state, shardings=sh)
    finally:
        dist.destroy_process_group()
    assert step == 7
    full, local, placed = [], [], []
    tree_map(full.append, state)
    tree_map(local.append, got)
    sharded = 0
    for t, d in zip(full, local):
        assert d.shape == t.shape and d.dtype == t.dtype
        want = _slice0(t, d.placements, sizes)
        assert torch.equal(d.to_local(), want)
        sharded += want.numel() < t.numel()
    assert sharded > 10                  # the rules sharded the big leaves


def test_distributed_launcher_matches_plain(tmp_path, monkeypatch):
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    base = ["--smoke", "--device", "cpu", "--batch", "2", "--seq", "16"]
    runs = {}
    for name, extra in (("plain", []), ("distributed", ["--distributed"])):
        out = []
        for i, steps in enumerate(("3", "2")):
            kw = {}
            if extra:
                kw["init_method"] = f"file://{tmp_path / f'rdzv{i}'}"
            out.append(t_launch.main(base + extra + [
                "--steps", steps, "--ckpt-dir", str(tmp_path / name)], **kw))
            assert not dist.is_initialized()
        runs[name] = out
    for a, b in zip(runs["plain"], runs["distributed"]):
        assert a["losses"] == b["losses"]
        assert a["steps_done"] == b["steps_done"]
    assert runs["distributed"][1]["resumed"]
