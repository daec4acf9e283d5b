"""The port's sharding rules (``repro_torch.dist.sharding``) against the
JAX package's (``repro.dist.sharding``): for every registered config, as
published and padded to the 16-wide model axis, on abstract 16x16 and
2x16x16 meshes, the parameter, optimizer (``zero_pod`` off and on),
batch and cache (``seq``/``heads``/``hd``) specs are equal as tuples. The
JAX trees come from ``jax.eval_shape``, the port's from its meta-device
init; both hold only shapes. Then the reference's own cases
(``tests/test_sharding.py``, ``tests/test_moe.py``'s ZeRO case) on the
port, ``to_shardings`` with ``distribute_tensor`` on a fake 4x4 group,
``constrain`` as the identity outside a context and on plain tensors,
and the folded meshes of the dry run: ``fold_axes`` on the production
meshes' specs, and placements on ("pod+data", "model") over a fake
group of 8, its ranks laid out as the (2, 2, 2) mesh's, pod major."""
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


# ------------------------------------------------ folded meshes
def _cell_specs(arch, shape, mesh, zero_pod=False):
    """Every spec a dry-run cell places, and the batch's, on ``mesh``."""
    cfg = registry.get_config(arch).padded(16)
    spec = registry.SHAPES[shape]
    tp, _ = _trees(arch, True)
    out = shd.spec_leaves(shd.params_pspecs(cfg, tp, mesh))
    ins = registry.input_specs(cfg, shape)
    if spec.kind == "train":
        opt = init_opt_state(tp, OptimizerConfig(state_dtype="bfloat16"))
        out += shd.spec_leaves(shd.opt_state_pspecs(cfg, opt, mesh,
                                                    zero_pod=zero_pod))
        out += shd.spec_leaves(shd.train_batch_pspecs(cfg, mesh, ins))
    else:
        out += shd.spec_leaves(shd.cache_pspecs(cfg, ins["cache"], mesh,
                                                spec.global_batch))
    bax = shd.batch_axes(mesh, spec.global_batch)
    return out + [shd.P(bax or None, "model")]


@pytest.mark.parametrize("arch,shape,mesh,zero_pod,want", [
    ("tinyllama-1.1b", "train_4k", "16x16", False, (("data",), ("model",))),
    ("tinyllama-1.1b", "train_4k", "2x16x16", False,
     (("pod", "data"), ("model",))),
    ("tinyllama-1.1b", "decode_32k", "2x16x16", False,
     (("pod", "data"), ("model",))),
    ("tinyllama-1.1b", "train_4k", "2x16x16", True,
     (("pod",), ("data",), ("model",))),
    ("zamba2-7b", "long_500k", "2x16x16", False, (("data",), ("model",))),
    ("mamba2-1.3b", "long_500k", "2x16x16", False, (("model",),)),
    ("mamba2-1.3b", "long_500k", "16x16", False, (("model",),))])
def test_fold_axes_of_the_dry_run_cells(arch, shape, mesh, zero_pod, want):
    """On 16x16 both dims stay where a spec names each; on 2x16x16 the
    batch's ("pod", "data") folds into one dim, ZeRO over "pod" alone
    keeps the three, and a batch of 1 names no "pod" (its devices
    replicate the other pod's): Zamba2's attention cache shards its
    sequence over ("data", "model"), while Mamba2's state names no
    "data" either."""
    m = MESHES[mesh][0]
    specs = _cell_specs(arch, shape, m, zero_pod)
    groups = shd.fold_axes(m, specs)
    assert groups == want
    # every spec maps onto the folded dims
    dims = shd.make_abstract_mesh(
        tuple(1 for _ in groups), tuple(shd.FOLD.join(g) for g in groups))
    for s in specs:
        shd.placements(dims, s)


def test_placements_on_a_folded_mesh():
    """("pod", "data") is one Shard on "pod+data"; a spec naming "pod" or
    "data" alone, or an axis the mesh lacks, raises; the folded mesh's
    ranks are the (2, 2, 2) mesh's, pod major, so each rank holds the
    same block either way."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import make_folded_mesh
    m3 = shd.make_abstract_mesh((2, 2, 2), ("pod", "data", "model"))
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        folded = make_folded_mesh(m3, (("pod", "data"), ("model",)),
                                  device_type="cpu")
        full = init_device_mesh("cpu", (2, 2, 2),
                                mesh_dim_names=("pod", "data", "model"))
        assert folded.mesh_dim_names == ("pod+data", "model")
        assert torch.equal(folded.mesh, full.mesh.reshape(4, 2))
        spec = shd.P(("pod", "data"), None, "model")
        assert shd.placements(folded, spec) == (Shard(0), Shard(2))
        assert shd.placements(full, spec) == (Shard(0), Shard(0), Shard(2))
        assert shd.placements(folded, shd.P()) == (Replicate(), Replicate())
        for bad in (shd.P("pod"), shd.P(None, "data"), shd.P("expert"),
                    shd.P(("data", "pod"))):
            with pytest.raises(ValueError):
                shd.placements(folded, bad)
        with pytest.raises(ValueError):
            shd.axis_size(folded, "pod")
        t = torch.randn(8, 3, 4, generator=torch.Generator().manual_seed(0))
        a = distribute_tensor(t, folded, list(shd.placements(folded, spec)),
                              src_data_rank=None).to_local()
        b = distribute_tensor(t, full, list(shd.placements(full, spec)),
                              src_data_rank=None).to_local()
        assert torch.equal(a, b) and torch.equal(a, t[:2, :, :2])
        with pytest.raises(ValueError):
            make_folded_mesh(m3, (("data",), ("model",)), device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_constrain_constrains_the_cotangent(fake_4x4):
    """A row-parallel projection's output joins the residual through
    ``constrain``, and a vocab-sharded head sends back a cotangent
    pending a sum over "model": the cotangent is redistributed to the
    residual's placements, so the projection's weight gradient stays
    sharded over "model" (without it DTensor computes it at full width on
    each rank, a pending sum)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = fake_4x4
    gen = torch.Generator().manual_seed(0)

    def place(shape, pl):
        return distribute_tensor(torch.randn(*shape, generator=gen), mesh,
                                 pl).requires_grad_(True)
    x = place((8, 4, 16), [Shard(0), Replicate()])
    h = place((8, 4, 32), [Shard(0), Shard(2)])
    wo = place((32, 16), [Replicate(), Shard(0)])
    table = place((64, 16), [Replicate(), Shard(0)])
    with shd.activation_context(mesh, 8):
        r = shd.constrain(x + h @ wo, "B", "S", None)
        assert tuple(r.placements) == (Shard(0), Replicate())
        logits = r @ table.T
        assert tuple(logits.placements) == (Shard(0), Shard(2))
        g, = torch.autograd.grad(logits.sum(), [wo])
    assert tuple(g.placements)[1] == Shard(0)
