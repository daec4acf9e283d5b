"""The port's sharding rules (``repro_torch.dist.sharding``) against the
JAX package's (``repro.dist.sharding``): for every registered config, as
published and padded to the 16-wide model axis, on abstract 16x16 and
2x16x16 meshes, the parameter, optimizer (``zero_pod`` off and on),
batch and cache (``seq``/``heads``/``hd``) specs are equal as tuples. The
JAX trees come from ``jax.eval_shape``, the port's from its meta-device
init; both hold only shapes. Then the reference's own cases
(``tests/test_sharding.py``, ``tests/test_moe.py``'s ZeRO case) on the
port, ``to_shardings`` with ``distribute_tensor`` on a fake 4x4 group,
and ``constrain`` as the identity outside a context and on plain
tensors."""
import functools

import jax
import pytest
import torch
import torch.distributed as dist

from repro.dist import sharding as jshd
from repro.models import registry as jreg
from repro.models import transformer as jt
from repro.train.optimizer import OptimizerConfig as JOptimizerConfig
from repro.train.optimizer import init_opt_state as j_init_opt_state
from repro_torch.dist import sharding as shd
from repro_torch.launch.dryrun import MetaGenerator
from repro_torch.models import registry, transformer
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state

ARCHS = registry.list_archs()
MESH = shd.make_abstract_mesh((16, 16), ("data", "model"))
MESH3 = shd.make_abstract_mesh((2, 16, 16), ("pod", "data", "model"))
JMESH = jshd.make_abstract_mesh((16, 16), ("data", "model"))
JMESH3 = jshd.make_abstract_mesh((2, 16, 16), ("pod", "data", "model"))
MESHES = {"16x16": (MESH, JMESH), "2x16x16": (MESH3, JMESH3)}


def _paths(tree, prefix=()):
    """(path, leaf) pairs of a tree of dicts and lists; a PartitionSpec, a
    JAX PartitionSpec or a shaped leaf is a leaf."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in
                _paths(tree[k], prefix + (str(k),))]
    if isinstance(tree, list):
        return [kv for i, v in enumerate(tree) for kv in
                _paths(v, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def _same_specs(tspecs, jspecs):
    t, j = _paths(tspecs), _paths(jspecs)
    assert [k for k, _ in t] == [k for k, _ in j]
    for (k, ts), (_, js) in zip(t, j):
        assert tuple(ts) == tuple(js), (k, ts, js)
    return len(t)


@functools.lru_cache(maxsize=None)
def _cfgs(arch, padded):
    tcfg, jcfg = registry.get_config(arch), jreg.get_config(arch)
    if padded:
        tcfg, jcfg = tcfg.padded(16), jcfg.padded(16)
    return tcfg, jcfg


@functools.lru_cache(maxsize=None)
def _trees(arch, padded):
    tcfg, jcfg = _cfgs(arch, padded)
    tp = transformer.init(MetaGenerator(), tcfg)
    jp = jax.eval_shape(lambda: jt.init(jax.random.PRNGKey(0), jcfg))
    return tp, jp


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_specs_match_jax(arch, padded):
    tcfg, jcfg = _cfgs(arch, padded)
    tp, jp = _trees(arch, padded)
    topt = init_opt_state(tp, OptimizerConfig(state_dtype="bfloat16"))
    jopt = jax.eval_shape(lambda: j_init_opt_state(
        jp, JOptimizerConfig(state_dtype="bfloat16")))
    for mesh, jmesh in MESHES.values():
        n = _same_specs(shd.params_pspecs(tcfg, tp, mesh),
                        jshd.params_pspecs(jcfg, jp, jmesh))
        assert n > 5
        for zero_pod in (False, True):
            _same_specs(
                shd.opt_state_pspecs(tcfg, topt, mesh, zero_pod=zero_pod),
                jshd.opt_state_pspecs(jcfg, jopt, jmesh, zero_pod=zero_pod))


@pytest.mark.parametrize("arch", registry.ASSIGNED_ARCHS)
def test_batch_and_cache_specs_match_jax(arch):
    """Every runnable cell's batch specs, and each decode cell's cache
    specs in the three modes, on both meshes, padded as the dry run
    pads."""
    for mesh, jmesh in MESHES.values():
        tcfg = registry.get_config(arch).padded(16)
        jcfg = jreg.get_config(arch).padded(16)
        for shape, spec in registry.SHAPES.items():
            if not registry.cell_supported(tcfg, shape)[0]:
                continue
            ts, js = registry.input_specs(tcfg, shape), \
                jreg.input_specs(jcfg, shape)
            if spec.kind != "decode":
                _same_specs(shd.train_batch_pspecs(tcfg, mesh, ts),
                            jshd.train_batch_pspecs(jcfg, jmesh, js))
                continue
            for mode in ("seq", "heads", "hd"):
                _same_specs(shd.cache_pspecs(tcfg, ts["cache"], mesh,
                                             spec.global_batch, mode),
                            jshd.cache_pspecs(jcfg, js["cache"], jmesh,
                                              spec.global_batch, mode))


# ------------------------------------ the reference's cases, on the port
def test_axis_size():
    assert shd.axis_size(MESH, "model") == 16
    assert shd.axis_size(MESH, "pod") == 1
    assert shd.axis_size(MESH3, "pod") == 2


@pytest.mark.parametrize("batch,expect", [
    (256, ("data",)), (1, ()), (8, ()), (32, ("data",))])
def test_batch_axes_single_pod(batch, expect):
    assert shd.batch_axes(MESH, batch) == expect


def test_batch_axes_multi_pod():
    assert shd.batch_axes(MESH3, 256) == ("pod", "data")
    assert shd.batch_axes(MESH3, 2) == ("pod",)


def test_head_and_vocab_padding():
    cfg = registry.get_config("qwen1.5-4b").padded(16)
    assert cfg.nq == 32 and cfg.nkv == 20          # q pads; kv never does
    assert cfg.vocab % 16 == 0
    assert registry.get_config("mamba2-1.3b").padded(16).vocab == 50304
    cfg3 = registry.get_config("tinyllama-1.1b").padded(16)
    assert cfg3.nq == 32 and cfg3.nkv == 4


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-v2-236b",
                                  "qwen2-moe-a2.7b", "mamba2-1.3b",
                                  "zamba2-7b", "gemma3-27b"])
def test_param_specs_divisible(arch):
    """Every sharded dim divides its mesh axes."""
    tp, _ = _trees(arch, True)
    specs = shd.params_pspecs(_cfgs(arch, True)[0], tp, MESH)
    leaves, flat = _paths(tp), _paths(specs)
    assert len(leaves) == len(flat)
    for (_, leaf), (_, spec) in zip(leaves, flat):
        for dim, ax in zip(leaf.shape, spec):
            if ax is not None:
                assert dim % shd.axis_size(MESH, ax) == 0, (arch, spec)


def test_expert_sharding_rules():
    tp, _ = _trees("deepseek-v2-236b", True)
    specs = shd.params_pspecs(None, tp, MESH)
    assert specs["segments"][1]["b0"]["ffn"]["experts"]["wi"][1] == "model"
    tp2, _ = _trees("qwen2-moe-a2.7b", True)
    wi2 = shd.params_pspecs(None, tp2, MESH)["segments"][0]["b0"]["ffn"][
        "experts"]["wi"]
    assert wi2[1] is None and wi2[-1] == "model"


def test_cache_specs_seq_sharding():
    cfg = registry.get_config("tinyllama-1.1b").padded(16)
    cache = transformer.init_cache(cfg, 128, 32768, dtype=torch.bfloat16,
                                   device="meta")
    k = shd.cache_pspecs(cfg, cache, MESH, batch=128)["segments"][0]["b0"][
        "k"]
    assert (k[1], k[2]) == ("data", "model")
    k1 = shd.cache_pspecs(cfg, transformer.init_cache(
        cfg, 1, 524288, dtype=torch.bfloat16, device="meta"), MESH,
        batch=1)["segments"][0]["b0"]["k"]
    assert k1[1] is None and set(k1[2]) == {"data", "model"}


def test_shared_attn_not_stacked():
    tp, _ = _trees("zamba2-7b", True)
    specs = shd.params_pspecs(None, tp, MESH)
    assert tp["segments"][0]["b6"]["attn"]["wq"].ndim == 3
    assert specs["segments"][0]["b6"]["attn"]["wq"][1] == "model"
    stacked = specs["segments"][0]["b0"]["mamba"]["w_x"]
    assert stacked[0] is None and len(stacked) == 3


def test_zero_pod_opt_specs():
    tp, _ = _trees("tinyllama-1.1b", True)
    opt = init_opt_state(tp, OptimizerConfig())
    on = shd.opt_state_pspecs(None, opt, MESH3, zero_pod=True)
    off = shd.opt_state_pspecs(None, opt, MESH3, zero_pod=False)
    assert any("pod" in s for _, s in _paths(on["m"]))
    assert not any("pod" in s for _, s in _paths(off["m"]))


# ------------------------------------------------ placements on a mesh
@pytest.fixture
def fake_4x4():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=16)
    try:
        yield init_device_mesh("cpu", (4, 4),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


def test_to_shardings_gives_rank0_its_slice(fake_4x4):
    """Rank 0 of a 4x4 mesh holds the spec's first block of each leaf:
    dim 0 over data and dim 2 over model; dims named by both axes split
    pod-major as the mesh orders them."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = fake_4x4
    specs = {"a": shd.P("data", None, "model"), "b": shd.P(None, "model"),
             "c": shd.P(), "d": shd.P(("data", "model"))}
    sh = shd.to_shardings(mesh, specs)
    assert sh["a"] == (mesh, (Shard(0), Shard(2)))
    assert sh["b"] == (mesh, (Replicate(), Shard(1)))
    assert sh["c"] == (mesh, (Replicate(), Replicate()))
    assert sh["d"] == (mesh, (Shard(0), Shard(0)))
    gen = torch.Generator().manual_seed(0)
    full = {"a": torch.randn(8, 3, 16, generator=gen),
            "b": torch.randn(5, 8, generator=gen),
            "c": torch.randn(3, generator=gen),
            "d": torch.randn(32, generator=gen)}
    want = {"a": full["a"][:2, :, :4], "b": full["b"][:, :2],
            "c": full["c"], "d": full["d"][:2]}
    for k, t in full.items():
        m, placements = sh[k]
        local = distribute_tensor(t, m, list(placements),
                                  src_data_rank=None).to_local()
        assert torch.equal(local, want[k]), k


def test_constrain_outside_a_context_is_the_identity(fake_4x4):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    x = torch.randn(8, 4, 16)
    assert shd.constrain(x, "B", "S", None) is x
    d = distribute_tensor(x, fake_4x4, [Replicate(), Replicate()])
    assert shd.constrain(d, "B", "S", None) is d
    with shd.activation_context(fake_4x4, 8):
        assert shd.constrain(x, "B", "S", None) is x   # a plain tensor
        c = shd.constrain(d, "B", "S", None)
        assert tuple(c.placements) == (Shard(0), Replicate())
        assert shd.logical_spec((8, 4, 16), ("B", "M", None)) == \
            shd.P("data", "model", None)
