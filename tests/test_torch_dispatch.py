"""How the flash and grouped-GEMM wrappers choose their kernel variant, and
the CPU path of both at the agent trunk's widths against the Pallas kernels
(the RMSNorm and SSD choices are pinned in tests/test_torch_dispatch_lm.py;
the test that no CPU call counts a launch covers all four kernels).

The flash backward's choices hold with a window too: its variant, form
and split count (the window changes none of them) and the window among the
C entry point's arguments.

Each kernel has two variants on the card: bf16 on the tensor cores ("tc")
and a CUDA-core one ("simt") for fp32 and for inputs the tensor-core
kernel's loads cannot address. The choice is a pure function of dtype,
shape, strides and alignment, made before the launch; these tests pin it on
CPU tensors, which is where the functions can run here. Which variant a
launch on the card really ran is asserted by the ``cuda`` tests through the
``tc_launches`` counters.

Parity tolerance as in tests/test_torch_kernels.py for bf16, 2e-2: both
sides round once at the output, after sums taken in different orders.
"""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_fwd
from repro.kernels.moe_gemm import moe_grouped_gemm as jax_grouped_gemm
from repro_torch.configs import mirage_agent
from repro_torch.core import DQNConfig, DQNLearner, FoundationConfig, q_values
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd)
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ops import (BWD_TC_MAX_SMEM,
                                                     _flash_bwd_variant,
                                                     _flash_variant,
                                                     bwd_smem_bytes,
                                                     bwd_splits, bwd_tc_form)
from repro_torch.kernels.moe_gemm import expert_mlp, grouped_gemm
from repro_torch.kernels.moe_gemm import ops as gemm_ops
from repro_torch.kernels.moe_gemm.ops import (_bwd_variant, _gemm_variant,
                                              _strides, split_count)
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.ssd import ssd
from repro_torch.models import attention, layers

BF16, FP32 = torch.bfloat16, torch.float32
TRUNK = mirage_agent.CONFIG


def _offset(t):
    """``t``'s values in a view one element past a 16-byte boundary."""
    flat = torch.cat([t.new_zeros(1), t.flatten()])[1:]
    return flat.view(t.shape)


# ------------------------------------------------------------ GEMM variant
def _gemm_case(name):
    E, C, d, f = 3, 40, 64, 96
    x, w = torch.zeros(E, C, d, dtype=BF16), torch.zeros(E, d, f, dtype=BF16)
    if name == "fp32":
        x, w = x.float(), w.float()
    elif name == "d_empty":
        x, w = torch.zeros(E, C, 0, dtype=BF16), torch.zeros(E, 0, f, dtype=BF16)
    elif name == "d_ragged":
        x, w = torch.zeros(E, C, 60, dtype=BF16), torch.zeros(E, 60, f, dtype=BF16)
    elif name == "f_ragged":
        w = torch.zeros(E, d, 53, dtype=BF16)
    elif name == "x_offset":
        x = _offset(x)
    elif name == "w_offset":
        w = _offset(w)
    elif name == "odd_row_stride":       # rows of d + 1 elements
        x = torch.zeros(E, C, d + 1, dtype=BF16)[:, :, :d]
    elif name == "experts_inside_rows":  # the trunk's (C, E, d) layout
        x = torch.zeros(C, E, d, dtype=BF16).transpose(0, 1)
    elif name == "overlapping_rows":
        x = torch.zeros(E * C * d, dtype=BF16).as_strided((E, C, d), (d, 8, 1))
    elif name == "gate_view":            # expert_mlp's wi[:, :, 0, :]
        w = torch.zeros(E, d, 2, f, dtype=BF16)[:, :, 0, :]
    elif name == "one_expert_odd_stride":
        x = torch.zeros(1, C, d + 8, dtype=BF16)[:, :, :d]
        x = x.as_strided(x.shape, (3, d + 8, 1))
    return x, w


@pytest.mark.parametrize("name,variant", [
    ("contiguous", "tc"), ("fp32", "simt"), ("d_empty", "simt"),
    ("d_ragged", "simt"),
    ("f_ragged", "simt"), ("x_offset", "simt"), ("w_offset", "simt"),
    ("odd_row_stride", "simt"), ("experts_inside_rows", "tc"),
    ("overlapping_rows", "simt"),
    ("gate_view", "tc"), ("one_expert_odd_stride", "tc"),
])
def test_gemm_variant(name, variant):
    x, w = _gemm_case(name)
    assert _gemm_variant(x, w) == variant


def _gemm_t_case(name):
    """x (E, K, M) and dY (E, K, f) of the backward's dW = x^T.dY: the
    trunk's ffn-out shape, and one change each."""
    E, K, M, f = 3, 144, 64, 96
    x, dy = torch.zeros(E, K, M, dtype=BF16), torch.zeros(E, K, f, dtype=BF16)
    if name == "fp32":
        x, dy = x.float(), dy.float()
    elif name == "ragged_k":                 # TMA zero-fills past K
        x, dy = torch.zeros(E, 1001, M, dtype=BF16), torch.zeros(E, 1001, f,
                                                                 dtype=BF16)
    elif name == "m_ragged":
        x = torch.zeros(E, K, 60, dtype=BF16)
    elif name == "x_offset":
        x = _offset(x)
    elif name == "experts_inside_rows":
        x = torch.zeros(K, E, M, dtype=BF16).transpose(0, 1)
    elif name == "k_empty":
        x, dy = torch.zeros(E, 0, M, dtype=BF16), torch.zeros(E, 0, f,
                                                              dtype=BF16)
    return x, dy


@pytest.mark.parametrize("name,variant", [
    ("trunk", "tc"), ("ragged_k", "tc"), ("experts_inside_rows", "tc"),
    ("fp32", "simt"), ("m_ragged", "simt"), ("x_offset", "simt"),
    ("k_empty", "simt"),
])
def test_gemm_transposed_x_variant(name, variant):
    """The backward's dW reads x in place, transposed by the tensor-core
    kernel, where x's rows (M) hold a multiple of 8 elements; the rest
    (fp32, ragged M, offset views, an empty contraction) take a contiguous
    copy of x^T on the CUDA-core kernel."""
    assert _gemm_variant(*_gemm_t_case(name), trans_x=True) == variant


def _gemm_bwd_case(name):
    """x (E, C, d), w (E, d, f) and dY (E, C, f) of one projection's
    backward: the trunk's three projections as the model hands them over
    (activations stored (C, E, d), C = 2 x 32 x 144), a ragged C, and one
    change each to a smaller case."""
    if name.startswith("trunk"):
        d, f = {"trunk_qkvo": (256, 256), "trunk_ffn_in": (256, 1024),
                "trunk_ffn_out": (1024, 256)}[name]
        x = torch.empty(9216, 10, d, dtype=BF16).transpose(0, 1)
        return (x, torch.empty(10, d, f, dtype=BF16),
                torch.empty(10, 9216, f, dtype=BF16))
    E, C, d, f = 3, 1001, 64, 96
    x, w, dy = (torch.zeros(E, C, d, dtype=BF16),
                torch.zeros(E, d, f, dtype=BF16),
                torch.zeros(E, C, f, dtype=BF16))
    if name == "fp32":
        x, w, dy = x.float(), w.float(), dy.float()
    elif name == "dy_rows":                 # dY stored (C, E, f)
        dy = torch.zeros(C, E, f, dtype=BF16).transpose(0, 1)
    elif name == "dy_offset":
        dy = _offset(dy)
    elif name == "x_offset":
        x = _offset(x)
    elif name == "f_ragged":
        w, dy = torch.zeros(E, d, 52, dtype=BF16), torch.zeros(E, C, 52,
                                                               dtype=BF16)
    elif name == "d_ragged":
        x, w = torch.zeros(E, C, 60, dtype=BF16), torch.zeros(E, 60, f,
                                                              dtype=BF16)
    elif name == "c_empty":
        x, dy = torch.zeros(E, 0, d, dtype=BF16), torch.zeros(E, 0, f,
                                                              dtype=BF16)
    elif name == "gate_view":               # w a view of (E, d, 2, f)
        w = torch.zeros(E, d, 2, f, dtype=BF16)[:, :, 0, :]
    return x, w, dy


@pytest.mark.parametrize("name,variant", [
    ("trunk_qkvo", "tc"), ("trunk_ffn_in", "tc"), ("trunk_ffn_out", "tc"),
    ("ragged_c", "tc"), ("dy_rows", "tc"), ("gate_view", "tc"),
    ("fp32", "simt"), ("dy_offset", "simt"), ("x_offset", "simt"),
    ("f_ragged", "simt"), ("d_ragged", "simt"), ("c_empty", "simt"),
])
def test_gemm_bwd_variant(name, variant):
    """The fused backward kernel takes bf16 projections whose three
    operands the tensor-core kernel's loads can address, strided on their
    two leading axes; the rest (fp32, offset views, d or f off a multiple
    of 8, an empty C) keep the two-launch route."""
    assert _bwd_variant(*_gemm_bwd_case(name)) == variant


@pytest.mark.parametrize("E,d,f,C,sms,splits", [
    (10, 256, 256, 9216, 132, 6),    # q, k, v, o: 20 tiles, 120 units
    (10, 256, 1024, 9216, 132, 1),   # ffn in: 80 tiles, one unit each
    (10, 1024, 256, 9216, 132, 1),   # ffn out
    (10, 256, 256, 4608, 132, 6),    # a pretraining step's C
    (3, 200, 136, 1001, 132, 2),     # ragged C: 16 k-steps, 8 a unit
    (2, 64, 96, 300, 132, 1),        # 5 k-steps: too few to split
    (10, 256, 256, 9216, 114, 5),    # another SM count
    (200, 256, 256, 9216, 132, 1),   # more tiles than SMs
])
def test_gemm_bwd_split_count(E, d, f, C, sms, splits):
    """dW's split count: its units one per SM at most (they wait for each
    other), each at least 8 k-steps of 64 rows."""
    S = split_count(E, d, f, C, sms)
    assert S == splits
    tiles = E * -(-d // 128) * -(-f // 256)
    assert S == 1 or (tiles * S <= sms and -(-C // 64) // S >= 8)


@pytest.mark.parametrize("need", [(True, True), (True, False), (False, True)])
def test_gemm_bwd_launch_arguments(monkeypatch, need):
    """What ``_launch_bwd`` hands the C entry point, recorded on CPU
    tensors in place of the call: the operands in place (x in the trunk's
    (C, E, d) layout), null for a product not asked for, the split count
    and an fp32 workspace of tiles x splits x 128 x 256 where dW is split,
    the counters of the device, the strides of each operand."""
    x, w, dy = (t.zero_() for t in _gemm_bwd_case("trunk_qkvo"))
    x, w, dy = x[:, :1001], w, dy[:, :1001].contiguous()
    seen = {}

    def entry(*args):
        seen["args"] = args
        return 0
    counters = torch.zeros(1024, dtype=torch.int32)
    monkeypatch.setattr(gemm_ops._build, "load", lambda name, fn: entry)
    monkeypatch.setattr(gemm_ops, "_device_state",
                        lambda dev, tiles: (132, counters))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 7}))
    empty = torch.empty
    sizes = []

    def record_empty(*shape, **kw):
        sizes.append((shape, kw.get("dtype")))
        return empty(*shape, **kw)
    monkeypatch.setattr(torch, "empty", record_empty)
    dx, dw = gemm_ops._launch_bwd(x, w, dy, *need)
    args = seen["args"]
    assert args[:3] == (x.data_ptr(), w.data_ptr(), dy.data_ptr())
    assert (dx is None, dw is None) == (not need[0], not need[1])
    assert args[3] == (dx.data_ptr() if need[0] else None)
    assert args[4] == (dw.data_ptr() if need[1] else None)
    splits = split_count(10, 256, 256, 1001, 132) if need[1] else 1
    assert splits == (2 if need[1] else 1)
    assert (args[5] is None) == (splits == 1)
    if splits > 1:
        assert ((20 * splits * 128 * 256,), torch.float32) in sizes
    assert args[6:12] == (counters.data_ptr(), 10, 1001, 256, 256, splits)
    assert args[12:18] == (*_strides(x, w), dy.stride(0), dy.stride(1))
    assert args[12:14] == (256, 10 * 256)      # experts inside the rows
    assert args[18] == 7


def test_gemm_strides_of_length_one_axes():
    """An axis of length 1 is never stepped, so its stride is replaced by
    the nested one: TMA's maps then see a plain view."""
    x, w = _gemm_case("one_expert_odd_stride")
    assert x.stride(0) == 3
    x_se, x_sc, w_se, w_sk = _strides(x, w)
    assert (x_se, x_sc) == (40 * x.stride(1), x.stride(1))
    assert (w_se, w_sk) == (w.stride(0), w.stride(1))


def test_gemm_trunk_inputs_take_the_tensor_cores(monkeypatch):
    """Every projection of the MoE trunk, as the model hands it to the
    kernel (normed activations keep the expert axis inside their rows),
    takes the tensor-core variant."""
    seen = []

    def probe(x, w, device=None):
        seen.append(_gemm_variant(x, w))
        return grouped_gemm(x, w, device=device)

    monkeypatch.setattr(attention, "grouped_gemm", probe)
    monkeypatch.setattr(layers, "grouped_gemm", probe)
    fc = FoundationConfig(kind="moe", history=144, trunk=TRUNK)
    learner = DQNLearner(fc, DQNConfig(), seed=0, device="cpu")
    states = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 144, 40)).astype(np.float32))
    with torch.inference_mode():
        q_values(learner.params, fc, states)
    assert seen == ["tc"] * 6 * TRUNK.n_layers


@pytest.fixture(scope="module")
def moe_learner():
    fc = FoundationConfig(kind="moe", history=144, trunk=TRUNK)
    return DQNLearner(fc, DQNConfig(), seed=0, device="cpu")


@pytest.mark.parametrize("lanes", [1, 3, 37])
def test_service_batches_take_the_tensor_cores(monkeypatch, moe_learner,
                                               lanes):
    """The provisioning service's dynamic batches are ragged, 1 to
    ``max_batch`` lanes (C = 2 x lanes x 144 rows a projection): at any
    lane count every grouped GEMM and every flash call of the MoE trunk
    takes the tensor-core variant. The kernels are stubbed with zeros of
    their output's shape, since only the inputs' layout matters here."""
    seen = []

    def gemm_probe(x, w, device=None):
        seen.append(("gemm", x.shape[1], _gemm_variant(x, w)))
        return x.new_zeros(x.shape[0], x.shape[1], w.shape[2])

    def flash_probe(q, k, v, causal=True, device=None, **kw):
        seen.append(("flash", q.shape[0], _flash_variant(q, k, v)))
        return torch.zeros_like(q)

    monkeypatch.setattr(attention, "grouped_gemm", gemm_probe)
    monkeypatch.setattr(layers, "grouped_gemm", gemm_probe)
    monkeypatch.setattr(attention, "flash_attention", flash_probe)
    states = torch.zeros(lanes, 144, 40)
    with torch.inference_mode():
        q_values(moe_learner.params, moe_learner.fc, states)
    rows = 2 * lanes * 144
    assert sorted(seen) == sorted(
        [("gemm", rows, "tc")] * 6 * TRUNK.n_layers
        + [("flash", 2 * lanes * mirage_agent.N_EXPERTS, "tc")]
        * TRUNK.n_layers)


# ----------------------------------------------------------- flash variant
def _flash_case(name):
    B, S, H, D = 2, 24, 4, 32
    q = k = v = torch.zeros(B, S, H, D, dtype=BF16)
    if name == "fp32":
        q = k = v = q.float()
    elif name == "fused_qkv":
        q, k, v = torch.zeros(B, S, 3, H, D, dtype=BF16).unbind(2)
    elif name == "k_offset":
        k = _offset(k)
    elif name == "odd_head_stride":
        v = torch.zeros(B, S, H, D + 1, dtype=BF16)[..., :D]
    elif name == "one_batch_odd_stride":
        q = q[:1].as_strided((1, S, H, D), (5, H * D, D, 1))
        k = v = k[:1]
    return q, k, v


@pytest.mark.parametrize("name,variant", [
    ("contiguous", "tc"), ("fp32", "simt"), ("fused_qkv", "tc"),
    ("k_offset", "simt"), ("odd_head_stride", "simt"),
    ("one_batch_odd_stride", "tc"),
])
def test_flash_variant(name, variant):
    assert _flash_variant(*_flash_case(name)) == variant


def _flash_bwd_case(name):
    """q, k, v, o, dO for the backward: the trunk's shape, one change each
    away from it, and the LM training layers' shapes."""
    B, S, Hq, Hkv, D = 2, 144, 8, 8, 32
    if name == "gqa":
        Hkv = 2
    elif name == "d128":
        D = 128
    elif name == "long":
        S = 257
    elif name == "d64_s256":                # over the short form's memory
        S, D = 256, 64
    elif name == "tinyllama_train":         # 32 q heads over 4 kv heads
        S, Hq, Hkv, D = 2048, 32, 4, 64
    elif name == "qwen_moe_train":
        S, Hq, Hkv, D = 2048, 16, 16, 128
    elif name == "gemma_train":             # 32 q heads over 16 kv heads
        S, Hq, Hkv, D = 2048, 32, 16, 128
    q = torch.zeros(B, S, Hq, D, dtype=BF16)
    k = v = torch.zeros(B, S, Hkv, D, dtype=BF16)
    o = do = torch.zeros_like(q)
    if name == "fp32":
        q, k, v, o, do = (t.float() for t in (q, k, v, o, do))
    elif name == "do_offset":
        do = _offset(do)
    elif name == "fused_qkv":
        q, k, v = torch.zeros(B, S, 3, Hq, D, dtype=BF16).unbind(2)
    return q, k, v, o, do


@pytest.mark.parametrize("name,variant", [
    ("trunk", "tc"), ("fused_qkv", "tc"), ("fp32", "simt"), ("gqa", "tc"),
    ("d128", "tc"), ("long", "tc"), ("d64_s256", "tc"),
    ("do_offset", "simt"), ("tinyllama_train", "tc"),
    ("qwen_moe_train", "tc"),
])
def test_flash_bwd_variant(name, variant):
    """The tensor-core backward takes every bf16 input the forward sends to
    the tensor cores, MHA or GQA, at any sequence length and head dim;
    fp32 and operands off 16 bytes take the CUDA-core kernels."""
    assert _flash_bwd_variant(*_flash_bwd_case(name)) == variant


@pytest.mark.parametrize("name,form", [
    ("trunk", "short"), ("fused_qkv", "short"), ("gqa", "stream"),
    ("d128", "wg"), ("long", "stream"), ("d64_s256", "wg"),
    ("tinyllama_train", "wg"), ("qwen_moe_train", "wg"),
])
def test_flash_bwd_tc_form(name, form):
    """``bwd_tc_form`` mirrors the C entry point's choice of the
    tensor-core form: the short form keeps the trunk's MHA heads whole in
    shared memory; GQA, D = 128 and sequences past 256 or past the short
    form's shared memory stream their tiles, through the Hopper form
    (wgmma fed by TMA) at D = 64 and 128, the mma.sync form at D = 16
    and 32."""
    q, k = _flash_bwd_case(name)[:2]
    assert bwd_tc_form(q.shape[1], k.shape[1], q.shape[2], k.shape[2],
                       q.shape[3]) == form


# (B, Skv, Hkv, group, the mma.sync form's shares, the Hopper form's): the
# blocks a share counted at 64 and at 128 kv rows a block
@pytest.mark.parametrize("B,Skv,Hkv,group,splits,wg_splits", [
    (2, 2048, 4, 8, 2, 2),   # TinyLlama training, 2 x 2048: 256 / 128 blocks a share
    (8, 128, 4, 8, 8, 8),    # the train launcher's 8 x 128: 64 / 32 blocks a share
    (2, 2048, 16, 1, 1, 1),  # Qwen2-MoE training, MHA: nothing to share
    (2, 1001, 2, 4, 4, 4),
    (1, 130, 1, 8, 8, 8),
    (4, 2048, 4, 8, 1, 1),   # 512 / 256 blocks
    (2, 2048, 8, 8, 1, 1),   # Command-R training, 64/8 heads: 512 / 256 blocks
    (1, 2048, 8, 8, 2, 2),   # its batch of 1
    (1, 1001, 8, 8, 4, 4),   # ragged: 128 / 64 blocks a share
    (2, 2048, 4, 7, 1, 2),   # Qwen2-VL training, a group of 7: 128 blocks at 128 rows
])
def test_flash_bwd_splits(B, Skv, Hkv, group, splits, wg_splits):
    """A streaming dkdv kernel shares a kv head's q heads among as many
    blocks as keep its grid within a number of blocks an SM of an H100's
    132: the mma.sync form a power of two that divides the group, within
    BWD_BLOCKS_PER_SM, the Hopper form any count up to the group, within
    BWD_WG_BLOCKS_PER_SM."""
    cap = fa_ops.BWD_BLOCKS_PER_SM * 132
    s = bwd_splits(B, Skv, Hkv, group, 132, "stream")
    assert s == splits and group % s == 0
    blocks = B * Hkv * -(-Skv // fa_ops.BWD_KV_ROWS)
    assert blocks * s <= cap or s == 1
    assert group % (2 * s) or blocks * 2 * s > cap
    w = bwd_splits(B, Skv, Hkv, group, 132)
    assert w == wg_splits == bwd_splits(B, Skv, Hkv, group, 132, "wg")
    blocks = B * Hkv * -(-Skv // fa_ops.BWD_WG_KV_ROWS)
    cap = fa_ops.BWD_WG_BLOCKS_PER_SM * 132
    assert 1 <= w <= group and (blocks * w <= cap or w == 1)
    assert w == group or blocks * (w + 1) > cap


def _record_bwd_launch(monkeypatch, q, k, v, o, do, **opts):
    """Run ``_launch_bwd`` on CPU tensors with the C entry point, the
    card's properties (132 SMs) and ``torch.empty`` replaced by recorders:
    the entry's arguments, the (shape, dtype) of each scratch allocated,
    and the gradients handed out."""
    lse = torch.zeros(q.shape[0], q.shape[2], q.shape[1])
    variant = _flash_bwd_variant(q, k, v, o, do)
    seen = {}

    def entry(*args):
        seen["args"] = args
        return 0
    monkeypatch.setattr(fa_ops._build, "load", lambda name: entry)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev:
                        type("P", (), {"multi_processor_count": 132}))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 7}))
    empty = torch.empty
    sizes = []

    def record_empty(*shape, **kw):
        sizes.append((shape[0] if len(shape) == 1 else shape, kw.get("dtype")))
        return empty(*shape, **kw)
    monkeypatch.setattr(torch, "empty", record_empty)
    grads = fa_ops._launch_bwd(q, k, v, o, lse, do, variant, causal=True,
                               softcap=0.0, scale=0.125, **opts)
    return seen["args"], sizes, (lse, variant, grads)


@pytest.mark.parametrize("name,splits", [("tinyllama_train", 2),
                                         ("trunk", 1), ("fp32", 1)])
def test_flash_bwd_launch_arguments(monkeypatch, name, splits):
    """What ``_launch_bwd`` hands the C entry point, recorded on CPU
    tensors in place of the call: the operands in place, the fp32 delta
    scratch (B, Hq, Sq) every variant fills, the streaming form's fp32
    partials of 2 x splits x dk's elements where a kv head's q heads are
    shared, the split count (1 for the short form and the CUDA-core
    kernels; TinyLlama's training layer takes the Hopper form's 2), the
    shapes and the strides, and last the form: 0, the entry's own
    choice."""
    q, k, v, o, do = _flash_bwd_case(name)
    args, sizes, (lse, variant, (dq, dk, dv)) = _record_bwd_launch(
        monkeypatch, q, k, v, o, do)
    B, S, Hq, D = q.shape
    assert args[:6] == tuple(t.data_ptr() for t in (q, k, v, o, do, lse))
    assert ((B, Hq, S), torch.float32) in sizes
    assert args[7:10] == (dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    assert (args[10] is None) == (splits == 1)
    if splits > 1:
        assert (2 * splits * dk.numel(), torch.float32) in sizes
    assert args[11:20] == (fa_ops._build.DTYPE_CODES[q.dtype],
                           fa_ops._build.VARIANT_CODES[variant], splits, B,
                           Hq, k.shape[2], S, k.shape[1], D)
    assert args[20:29] == (*fa_ops._build.row_strides(q),
                           *fa_ops._build.row_strides(k),
                           *fa_ops._build.row_strides(v))
    assert args[29:] == (1, 0, 0.0, 0.125, 7, 0)


@pytest.mark.parametrize("name,form", [
    ("gemma_train", "wg"),        # Gemma-3's training layers, local and global
    ("trunk", "short"),           # a window in the short form
    ("long", "stream"),           # a window under one tile, ragged S
])
def test_flash_bwd_windowed_form(name, form):
    """A window changes neither the variant nor the form (neither rule
    reads it): the tensor-core backward takes the mask in both forms, so
    Gemma-3's training layers run the streaming form on the tensor cores
    with and without their window."""
    q, k, v, o, do = _flash_bwd_case(name)
    assert _flash_bwd_variant(q, k, v, o, do) == "tc"
    assert bwd_tc_form(q.shape[1], k.shape[1], q.shape[2], k.shape[2],
                       q.shape[3]) == form


# (..., the mma.sync form's shares at D = 16, the Hopper form's at D = 64)
@pytest.mark.parametrize("D", [16, 64])
@pytest.mark.parametrize("B,Skv,Hkv,group,window,splits,wg_splits", [
    (2, 2048, 16, 2, 1024, 1, 1),  # Gemma-3's local training layer: 1024 / 512 blocks
    (1, 2048, 16, 2, 1024, 1, 1),  # its 2-layer gradient check: 512 / 256 blocks
    (2, 2048, 4, 8, 1024, 2, 2),   # a group of 8: 256 / 128 blocks a share
    (1, 512, 2, 8, 100, 8, 8),     # 16 / 8 blocks
    (2, 2048, 4, 8, 2048, 2, 2),   # a window as long as the sequence
    (2, 2048, 4, 8, 4096, 2, 2),
])
def test_flash_bwd_windowed_splits(monkeypatch, D, B, Skv, Hkv, group,
                                   window, splits, wg_splits):
    """A window leaves the split count to the causal rule: the launch with
    the window hands the C entry point ``bwd_splits``'s count for the form
    the head dim takes (the mma.sync form at D = 16, the Hopper form at
    D = 64), the same as without one (at Gemma-3's local training layer
    the mma.sync form's 1 share, the faster of the two measured)."""
    q = torch.zeros(B, Skv, Hkv * group, D, dtype=BF16)
    k = torch.zeros(B, Skv, Hkv, D, dtype=BF16)
    form = bwd_tc_form(Skv, Skv, Hkv * group, Hkv, D)
    assert form == ("stream" if D == 16 else "wg")
    args = _record_bwd_launch(monkeypatch, q, k, k, q, q,
                              window=window)[0]
    want = splits if D == 16 else wg_splits
    assert args[13] == want == bwd_splits(B, Skv, Hkv, group, 132, form)
    assert args[30] == window and args[34] == 0
    assert args[13] == _record_bwd_launch(monkeypatch, q, k, k, q, q)[0][13]


@pytest.mark.parametrize("name,window,splits", [
    ("gemma_train", 1024, 1), ("tinyllama_train", 1024, 2),
    ("trunk", 64, 1), ("fp32", 100, 1)])
def test_flash_bwd_launch_arguments_with_a_window(monkeypatch, name, window,
                                                  splits):
    """The window reaches the C entry point after the causal flag, with
    the delta scratch and the split count as without one."""
    q, k, v, o, do = _flash_bwd_case(name)
    args, sizes, _ = _record_bwd_launch(monkeypatch, q, k, v, o, do,
                                        window=window)
    B, S, Hq, D = q.shape
    assert ((B, Hq, S), torch.float32) in sizes
    assert (args[10] is None) == (splits == 1) and args[13] == splits
    assert args[29:] == (1, window, 0.0, 0.125, 7, 0)


def test_flash_bwd_smem_mirror():
    """``bwd_smem_bytes`` mirrors the short form's ``tc::smem_bytes``: q, dO, K,
    V in bf16, 256-column dS^T rows and fp32 lse and delta; the trunk's
    head takes 112 KB, under the 227 KB ceiling."""
    assert bwd_smem_bytes(144, 144, 32) == 4 * 32 * 288 + 144 * 512 + 8 * 144
    assert bwd_smem_bytes(144, 144, 32) < BWD_TC_MAX_SMEM
    assert bwd_smem_bytes(256, 256, 32) <= BWD_TC_MAX_SMEM
    assert bwd_smem_bytes(256, 256, 64) > BWD_TC_MAX_SMEM


def _counts():
    return (grouped_gemm.launches, grouped_gemm.tc_launches,
            grouped_gemm.bwd_launches, grouped_gemm.bwd_tc_launches,
            grouped_gemm.bwd_fused_calls,
            flash_attention.launches, flash_attention.tc_launches,
            flash_attention_bwd.launches, flash_attention_bwd.tc_launches,
            rmsnorm.launches,
            rmsnorm.vec_launches, ssd.launches, ssd.tc_launches)


def test_cpu_path_counts_no_launch():
    """On the CPU the wrappers run their plain versions: no launch, of
    either variant, is counted, and their gradients (autograd of the plain
    versions) count no backward launch."""
    counts = _counts()
    x, w = (t.clone().requires_grad_(True) for t in _gemm_case("contiguous"))
    grouped_gemm(x, w, device="cpu").float().sum().backward()
    q, k, v = (t.clone().requires_grad_(True) for t in _flash_case("contiguous"))
    flash_attention(q, k, v, device="cpu").float().sum().backward()
    assert x.grad is not None and q.grad is not None
    rmsnorm(torch.zeros(8, 64, dtype=BF16), torch.ones(64), device="cpu")
    x, B = torch.zeros(1, 40, 4, 64, dtype=BF16), torch.zeros(1, 40, 1, 128,
                                                              dtype=BF16)
    ssd(x, torch.full((1, 40, 4), 0.1), -torch.ones(4), B, B, torch.ones(4),
        16, device="cpu")
    assert counts == _counts()


# ------------------------------------------- CPU path against Pallas, trunk
def _normal(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=s) * scale).astype(np.float32) for s in shapes]


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      x.astype(jnp.float32))


@pytest.mark.parametrize("din,dout", [(256, 256), (256, 1024), (1024, 256)])
def test_gemm_cpu_path_matches_pallas_at_trunk_widths(din, dout):
    """The trunk's three projection widths, bf16, E=10 experts over 2
    actions x 144 history rows (C cut from 9216 to keep interpret mode
    short)."""
    assert (TRUNK.d_model, TRUNK.d_ff) == (256, 1024)
    E, C = mirage_agent.N_EXPERTS, 2 * 144
    x, w = _normal(din + dout, (E, C, din), (E, din, dout))
    w /= np.sqrt(din)
    out = grouped_gemm(torch.from_numpy(x).to(BF16),
                       torch.from_numpy(w).to(BF16), device="cpu")
    ref = jax_grouped_gemm(jnp.asarray(x, jnp.bfloat16),
                           jnp.asarray(w, jnp.bfloat16), interpret=True)
    np.testing.assert_allclose(_np(out), _np(ref), atol=2e-2, rtol=2e-2)


def test_gemm_cpu_path_strided_view_matches_pallas():
    """expert_mlp's gate and up operands at the trunk's widths: views of
    wi (E, d, 2, f), strided 2f on the contraction axis, taken as they are,
    against the Pallas kernel on the materialised slices."""
    E, C, d, f = 3, 144, TRUNK.d_model, TRUNK.d_ff
    x, wi = _normal(7, (E, C, d), (E, d, 2, f))
    wi /= np.sqrt(d)
    tx, twi = torch.from_numpy(x).to(BF16), torch.from_numpy(wi).to(BF16)
    for i in range(2):
        view = twi[:, :, i, :]
        assert view.stride(1) == 2 * f and _gemm_variant(tx, view) == "tc"
        ref = jax_grouped_gemm(jnp.asarray(x, jnp.bfloat16),
                               jnp.asarray(wi[:, :, i, :], jnp.bfloat16),
                               interpret=True)
        np.testing.assert_allclose(_np(grouped_gemm(tx, view, device="cpu")),
                                   _np(ref), atol=2e-2, rtol=2e-2)


def test_expert_mlp_cpu_path_bf16_at_trunk_widths():
    """The three launches of expert_mlp in bf16, against the same three
    Pallas products and the same activation between them."""
    E, C, d, f = 2, 144, TRUNK.d_model, TRUNK.d_ff
    x, wi, wo = _normal(11, (E, C, d), (E, d, 2, f), (E, f, d))
    wi /= np.sqrt(d)
    wo /= np.sqrt(f)
    out = expert_mlp(*(torch.from_numpy(a).to(BF16) for a in (x, wi, wo)),
                     activation="gelu", device="cpu")
    jx, jwi, jwo = (jnp.asarray(a, jnp.bfloat16) for a in (x, wi, wo))
    gate = jax_grouped_gemm(jx, jwi[:, :, 0, :], interpret=True)
    up = jax_grouped_gemm(jx, jwi[:, :, 1, :], interpret=True)
    gelu = torch.nn.functional.gelu(torch.tensor(_np(gate)),
                                    approximate="tanh")
    h = (gelu * torch.tensor(_np(up))).to(BF16)
    ref = jax_grouped_gemm(jnp.asarray(h.float().numpy(), jnp.bfloat16), jwo,
                           interpret=True)
    np.testing.assert_allclose(_np(out), _np(ref), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("layout", ["contiguous", "fused_qkv"])
def test_flash_cpu_path_matches_pallas_at_trunk_shape(layout):
    """The trunk's attention (8 heads of 32, S=144, non-causal), bf16, with
    q, k, v contiguous or as views of one fused (B, S, 3, H, D) tensor."""
    B, S, H, D = 2, 144, TRUNK.n_heads, TRUNK.hd
    a, = _normal(13, (B, S, 3, H, D))
    t = torch.from_numpy(a).to(BF16)
    q, k, v = t.unbind(2) if layout == "fused_qkv" else \
        (t[:, :, i].contiguous() for i in range(3))
    assert _flash_variant(q, k, v) == "tc"
    out = flash_attention(q, k, v, causal=False, device="cpu")
    jt = [jnp.swapaxes(jnp.asarray(a[:, :, i], jnp.bfloat16), 1, 2)
          for i in range(3)]
    ref = flash_attention_fwd(*jt, causal=False, block_q=64, block_kv=64,
                              interpret=True)
    np.testing.assert_allclose(_np(out), np.swapaxes(_np(ref), 1, 2),
                               atol=2e-2, rtol=2e-2)
