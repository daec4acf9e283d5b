"""The port's roofline module (``repro_torch.roofline``) against the JAX
package's: ``model_flops`` and ``active_param_count`` equal for every
registered config, as published and padded, train and infer;
``count_step`` counts a matrix product, a kernel scope and a
redistribute exactly; and on TinyLlama ``SMOKE`` (``remat=False``,
``attn_impl="reference"`` on both sides) the flops ``count_step`` counts
in the port's train step equal those ``roofline_from_text`` parses from
JAX's train step compiled for the one CPU device. Both count 2 M N K a
product and the same products (the forward's, and two a product in the
backward); the tolerance is 0. The HBM bytes are not compared: XLA's
boundary is a fusion, the port's every eager op."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import tinyllama_1_1b as j_tiny
from repro.models import registry as jreg
from repro.models import transformer as jt
from repro.roofline import analysis as jra
from repro.train.optimizer import OptimizerConfig as JOptimizerConfig
from repro.train.optimizer import init_opt_state as j_init_opt_state
from repro.train.step import make_train_step as j_make_train_step
from repro_torch import convert
from repro_torch.configs import tinyllama_1_1b as t_tiny
from repro_torch.models import registry
from repro_torch.roofline import analysis as ra
from repro_torch.roofline import hw
from repro_torch.roofline.scope import kernel_scope
from repro_torch.train import OptimizerConfig, init_opt_state, make_train_step


@pytest.mark.parametrize("arch", registry.list_archs())
def test_model_flops_match_jax(arch):
    for pad in (False, True):
        t, j = registry.get_config(arch), jreg.get_config(arch)
        if pad:
            t, j = t.padded(16), j.padded(16)
        assert ra.active_param_count(t) == jra.active_param_count(j)
        for kind in ("train", "infer"):
            assert ra.model_flops(t, 4096, kind) == \
                jra.model_flops(j, 4096, kind)


def test_count_matmul_and_scope():
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    s = ra.count_step(lambda: a @ b)
    assert s.flops == 2 * 8 * 4 * 16
    assert s.hbm_bytes == 4 * (8 * 16 + 16 * 4 + 8 * 4)
    assert s.kernel_fusable_bytes == 0

    def scoped():
        with kernel_scope("ssd"):
            c = a.view(4, 32) * 2.0          # a view moves nothing
        return c.sum()
    s = ra.count_step(scoped)
    assert s.flops == 0
    assert s.kernel_fusable_bytes == 4 * 2 * 128      # the mul's in + out
    assert s.hbm_bytes == 4 * 2 * 128 + 4 * (128 + 1)
    with pytest.raises(ValueError):
        with kernel_scope("not_a_kernel"):
            pass


def test_count_redistribute_per_device():
    """On a fake 2x2 group: a product of shards counts its local flops,
    and the redistribute of its partial sum one all-reduce of the local
    output's bytes."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        x = distribute_tensor(torch.empty(64, 32, device="meta"), mesh,
                              [Shard(0), Shard(1)])
        w = distribute_tensor(torch.empty(32, 16, device="meta"), mesh,
                              [Replicate(), Shard(0)])
        with ra.StepCounter(exclude=(x, w)) as c:
            y = x @ w
            y.redistribute(mesh, [Shard(0), Replicate()])
    finally:
        dist.destroy_process_group()
    s = c.stats
    assert s.flops == 2 * 32 * 16 * 16                 # (32,16)@(16,16)
    assert s.collective_count == {"all-reduce": 1}
    assert s.collective_by_kind == {"all-reduce": 32 * 16 * 4}
    assert s.collective_by_dtype == {"f32": 32 * 16 * 4}
    assert c.peak_bytes >= 32 * 16 * 4
    r = ra.roofline_from_stats(s)
    assert r.collective_s == 32 * 16 * 4 / hw.COLLECTIVE_BW
    assert r.compute_s == s.flops / hw.PEAK_FLOPS_BF16
    assert r.dominant == max(("compute", "memory", "collective"),
                             key=lambda k: getattr(r, k + "_s"))


def test_train_step_flops_match_jax_hlo():
    jcfg = j_tiny.SMOKE.replace(remat=False, attn_impl="reference")
    tcfg = t_tiny.SMOKE.replace(remat=False, attn_impl="reference")
    jp = jt.init(jax.random.PRNGKey(0), jcfg)
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 33))
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    text = jax.jit(j_make_train_step(jcfg, JOptimizerConfig())).lower(
        jp, j_init_opt_state(jp, JOptimizerConfig()),
        jax.tree.map(jnp.asarray, batch)).compile().as_text()
    jflops = jra.roofline_from_text(text).flops
    tp = convert.from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    s = ra.count_step(make_train_step(tcfg, OptimizerConfig()), tp,
                      init_opt_state(tp, OptimizerConfig()),
                      {k: torch.from_numpy(v) for k, v in batch.items()})
    assert s.flops == jflops > 0
