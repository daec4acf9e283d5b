"""Which form of the flash kernels' tensor-core variant a launch takes, and
what the wrappers hand the C entry points for it, on CPU tensors.

The tensor-core forward and backward each have three forms: the short one
(the agent trunk's heads whole in shared memory), the Hopper streaming
form ("wg": wgmma fed by TMA rings, D from 48 to 128; HuBERT's 80 and
Zamba2's 112 on its D = 128 kernels) and the mma.sync streaming form
("stream", D = 16 and 32). The C entry points choose from
the shapes; ``fwd_form`` and ``bwd_tc_form`` mirror the choice, and the
wrappers count each launch's form in ``wg_launches``. A ``form`` argument,
last in each entry's signature, forces one (phase 5 of chip_smoke.py times
the old form beside the new one). These tests pin the mirrors at every
shape the port's LM paths run, the form and split-count arguments the
wrappers pass, the counters, and the CPU path at a Hopper-form shape
against the Pallas kernel in interpret mode. The kernels themselves run in
tests/test_torch_cuda.py on the card.
"""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.configs import (command_r_35b, gemma3_27b, hubert_xlarge,
                                 mirage_agent, qwen1_5_4b, qwen2_moe_a2_7b,
                                 qwen2_vl_7b, tinyllama_1_1b, zamba2_7b)
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd)
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ops import (bwd_splits, bwd_tc_form,
                                                     fwd_form)

BF16 = torch.bfloat16
LM = {"TinyLlama": tinyllama_1_1b.CONFIG, "Qwen2-MoE": qwen2_moe_a2_7b.CONFIG,
      "Qwen1.5-4B": qwen1_5_4b.CONFIG, "Gemma-3": gemma3_27b.CONFIG,
      "Command-R": command_r_35b.CONFIG, "Qwen2-VL": qwen2_vl_7b.CONFIG,
      "HuBERT": hubert_xlarge.CONFIG, "Zamba2": zamba2_7b.CONFIG}
TRUNK = mirage_agent.CONFIG


def test_lm_head_dims_take_the_hopper_forms():
    """Every LM the port runs flash at has heads the Hopper forms take:
    64 and 128, HuBERT's 80 and Zamba2's 112; each runs flash."""
    dims = {cfg.hd for cfg in LM.values()}
    assert dims == {64, 80, 112, 128} and dims <= set(fa_ops.WG_HEAD_DIMS)
    assert all(cfg.attn_impl == "flash" for cfg in LM.values())


# (Sq, Skv, D, the forward's form): the LM prefill and training layers,
# the agent's trunk, phase 2's ragged and windowed cases, D = 16 and 32
FWD_CASES = [
    (2048, 2048, LM["TinyLlama"].hd, "wg"),
    (2048, 2048, LM["Qwen2-MoE"].hd, "wg"),
    (2048, 2048, LM["Qwen1.5-4B"].hd, "wg"),
    (2048, 2048, LM["Gemma-3"].hd, "wg"),
    (2048, 2048, LM["Command-R"].hd, "wg"),
    (2048, 2048, LM["Qwen2-VL"].hd, "wg"),
    (512, 512, 128, "wg"),              # the 2-layer gradient checks
    (144, 144, TRUNK.hd, "short"),      # the agent's trunk
    (144, 144, 64, "wg"),               # q, K, V need 54 KB
    (128, 128, 64, "short"),
    (1100, 1100, 128, "wg"),            # ragged, Gemma-3's window
    (97, 131, 64, "wg"),                # causal GQA window softcap
    (200, 200, 128, "wg"),              # 13 row groups, but q, K, V need 156 KB
    (2048, 2048, 64, "wg"),             # window 1024 at 8/4 heads
    (77, 77, 64, "short"),              # the fused qkv views
    (50, 50, 16, "short"),
    (300, 300, 16, "stream"),           # past 16 row groups
    (2048, 2048, 32, "stream"),
    (20, 20, 128, "short"),             # a decode-sized prompt
    (2048, 2048, LM["Zamba2"].hd, "wg"),    # the shared block's 112
    (1000, 1000, LM["HuBERT"].hd, "wg"),    # HuBERT's 4 x 1000 frames
    (512, 512, 80, "wg"),
    (300, 300, 48, "wg"),
    (300, 300, 96, "wg"),
    (64, 64, 112, "short"),             # 43 KB of q, K and V
    (144, 144, 48, "short"),
    (144, 144, 80, "wg"),               # 69 KB
    (333, 333, 112, "wg"),
]


@pytest.mark.parametrize("Sq,Skv,D,form", FWD_CASES)
def test_fwd_form(Sq, Skv, D, form):
    """``fwd_form`` mirrors ``launch_tc`` in csrc/flash_attention.cu: the
    short form where at most 16 row groups of q and q, K, V fit 48 KB, else
    the Hopper form at D = 64 and 128, else the mma.sync form."""
    assert fwd_form(Sq, Skv, D) == form
    sq16, skv16 = -(-Sq // 16) * 16, -(-Skv // 16) * 16
    fits = sq16 <= 256 and (sq16 + 2 * skv16) * D * 2 <= 48 * 1024
    assert (form == "short") == fits
    assert (form == "wg") == (not fits and D in fa_ops.WG_HEAD_DIMS)


# (Sq, Skv, Hq, Hkv, D, the backward's form)
BWD_CASES = [(2048, 2048, cfg.nq, cfg.nkv, cfg.hd, "wg")
             for cfg in LM.values()] + [
    (512, 512, 28, 4, 128, "wg"),
    (144, 144, TRUNK.n_heads, TRUNK.n_heads, TRUNK.hd, "short"),
    (144, 144, 4, 4, 64, "short"),      # the short form with a window
    (97, 131, 4, 4, 64, "short"),       # MHA: 137 KB of shared memory
    (97, 131, 8, 2, 64, "wg"),          # GQA
    (50, 50, 4, 4, 16, "short"),
    (200, 200, 4, 2, 128, "wg"),
    (1001, 1001, 8, 2, 64, "wg"),
    (2050, 2050, 8, 4, 64, "wg"),
    (300, 300, 4, 2, 128, "wg"),
    (144, 144, 8, 2, 32, "stream"),     # GQA at D = 32
    (257, 257, 8, 8, 32, "stream"),
    (2048, 2048, 8, 8, 16, "stream"),
    (1000, 1000, 16, 16, 80, "wg"),     # HuBERT's training frames
    (512, 512, 32, 32, 112, "wg"),      # Zamba2's 2-layer check
    (200, 200, 4, 4, 48, "short"),      # MHA at D = 48: 188 KB
    (97, 131, 8, 2, 48, "wg"),          # GQA
    (144, 144, 4, 4, 80, "wg"),         # the short form stops at D = 64
    (300, 300, 4, 2, 96, "wg"),
    (257, 257, 8, 8, 48, "wg"),         # past the dS^T tile's 256
]


@pytest.mark.parametrize("Sq,Skv,Hq,Hkv,D,form", BWD_CASES)
def test_bwd_tc_form(Sq, Skv, Hq, Hkv, D, form):
    """``bwd_tc_form`` mirrors the C entry point: the short form for MHA
    heads that fit one block whole, else the Hopper form at D = 64 and
    128, else the mma.sync form."""
    assert bwd_tc_form(Sq, Skv, Hq, Hkv, D) == form
    short = Hq == Hkv and D <= 64 and max(Sq, Skv) <= fa_ops.BWD_TC_MAX_S \
        and fa_ops.bwd_smem_bytes(Sq, Skv, D) <= fa_ops.BWD_TC_MAX_SMEM
    assert (form == "short") == short
    assert (form == "wg") == (not short and D in fa_ops.WG_HEAD_DIMS)


@pytest.mark.parametrize("B", [1, 2])
def test_qwen2_vl_group_of_7_shares(B):
    """The Hopper form's split rule takes any count up to the group:
    Qwen2-VL's 28 q heads over 4 kv heads (a group of 7, which no power of
    two above 1 divides) get more than one share at its training batch of
    2 (and at 1) on the card's 132 SMs; the mma.sync form's rule would
    give 1."""
    cfg = LM["Qwen2-VL"]
    group = cfg.nq // cfg.nkv
    assert group == 7
    s = bwd_splits(B, 2048, cfg.nkv, group, 132)
    assert 1 < s <= group
    assert bwd_splits(B, 2048, cfg.nkv, group, 132, "stream") == 1
    blocks = B * cfg.nkv * 2048 // fa_ops.BWD_WG_KV_ROWS
    assert blocks * s <= fa_ops.BWD_WG_BLOCKS_PER_SM * 132
    # the shares' q heads, as the dkdv kernel cuts them: every head once,
    # in order, no share empty
    cuts = [i * group // s for i in range(s + 1)]
    assert cuts[0] == 0 and cuts[-1] == group
    assert all(b > a for a, b in zip(cuts, cuts[1:]))


# ------------------------------------------------ arguments and counters
@pytest.fixture
def entry(monkeypatch):
    """The C entry points replaced by a recorder on CPU tensors (the card's
    properties: 132 SMs); yields the list of recorded calls, (library,
    args)."""
    calls = []

    def load(name):
        def fn(*args):
            calls.append((name, args))
            return 0
        return fn
    monkeypatch.setattr(fa_ops._build, "load", load)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev:
                        type("P", (), {"multi_processor_count": 132}))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 7}))
    for fn in (flash_attention, flash_attention_bwd):
        for name in ("launches", "tc_launches", "wg_launches"):
            monkeypatch.setattr(fn, name, 0)
    yield calls


def _qkv(B, S, Hq, Hkv, D, dtype=BF16):
    return (torch.zeros(B, S, Hq, D, dtype=dtype),
            torch.zeros(B, S, Hkv, D, dtype=dtype),
            torch.zeros(B, S, Hkv, D, dtype=dtype))


@pytest.mark.parametrize("form", [None, "short", "stream", "wg"])
def test_fwd_launch_arguments(entry, form):
    """The forward's 28 arguments keep their places (strides at 13-21, the
    masks, scale and stream at 22-26) and the form's code comes last: 0
    (the entry's choice) unless a form is named."""
    q, k, v = _qkv(2, 160, 8, 2, 64)
    out, lse = fa_ops._launch(q, k, v, "tc", causal=True, window=40,
                              softcap=30.0, scale=0.125, lse=True, form=form)
    (name, args), = entry
    assert name == "flash_attention" and len(args) == 28
    assert len(_build.SIGNATURES["flash_attention"]["flash_attention_fwd"]) == 28
    assert args[:5] == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), lse.data_ptr())
    assert args[5:13] == (_build.DTYPE_CODES[BF16], 1, 2, 8, 2, 160, 160, 64)
    assert args[13:22] == (*_build.row_strides(q), *_build.row_strides(k),
                           *_build.row_strides(v))
    assert args[22:27] == (1, 40, 30.0, 0.125, 7)
    assert args[27] == _build.FORM_CODES[form or "auto"]
    assert _build.FORM_CODES == {"auto": 0, "short": 1, "stream": 2, "wg": 3}


@pytest.mark.parametrize("form,splits", [(None, None), ("wg", 3), ("wg", None),
                                         ("stream", 2), ("stream", None)])
def test_bwd_launch_arguments_with_a_form(entry, form, splits):
    """The backward's 35 arguments keep their places and the form's code
    comes last; with no split count named, the wrapper takes
    ``bwd_splits``'s for the form that runs (2 at TinyLlama's training
    layer in either form), and hands fp32
    partials of 2 x splits x dk's elements where it shares."""
    q, k, v = _qkv(2, 2048, 32, 4, 64)
    lse = torch.zeros(2, 32, 2048)
    dq, dk, dv = fa_ops._launch_bwd(q, k, v, q, lse, q, "tc", causal=True,
                                    softcap=0.0, scale=0.125, splits=splits,
                                    form=form)
    (name, args), = entry
    assert name == "flash_attention_bwd" and len(args) == 35
    assert len(_build.SIGNATURES["flash_attention_bwd"]
               ["flash_attention_bwd"]) == 35
    want = splits or bwd_splits(2, 2048, 4, 8, 132, form or "wg")
    assert want == (splits or 2)
    assert args[7:10] == (dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    assert (args[10] is None) == (want == 1)
    assert args[11:20] == (_build.DTYPE_CODES[BF16], 1, want, 2, 32, 4, 2048,
                           2048, 64)
    assert args[29:34] == (1, 0, 0.0, 0.125, 7)
    assert args[34] == _build.FORM_CODES[form or "auto"]


# (q, k, v shape, the form counted): the LM prefills, the trunk, D = 32,
# HuBERT's and Zamba2's heads of 80 and 112
@pytest.mark.parametrize("shape,wg", [
    ((4, 2048, 32, 4, 64), True), ((4, 2048, 28, 4, 128), True),
    ((2, 1100, 32, 16, 128), True), ((2, 144, 8, 8, 32), False),
    ((1, 300, 8, 8, 32), False), ((1, 300, 8, 8, 64), True),
    ((4, 1000, 16, 16, 80), True), ((2, 2048, 32, 32, 112), True),
])
def test_launches_count_their_form(entry, shape, wg):
    """The card's route on CPU tensors (the entry points recorded): a
    forward without a gradient, then one with, and its backward, each
    counted once in ``launches`` and ``tc_launches`` and, where the form
    is the Hopper one, in ``wg_launches``; every entry call gets the form
    code 0, the entry's own choice, which the mirrors name."""
    q, k, v = _qkv(*shape)
    fa_ops._flash_cuda(q, k, v, causal=True, window=0, softcap=0.0,
                       scale=0.125)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fa_ops._flash_cuda(*leaves, causal=True, window=0, softcap=0.0,
                             scale=0.125)
    torch.autograd.grad(out, leaves, torch.zeros_like(out))
    assert [n for n, _ in entry] == ["flash_attention"] * 2 + \
        ["flash_attention_bwd"]
    assert all(args[-1] == 0 for _, args in entry)
    assert (flash_attention.launches, flash_attention.tc_launches,
            flash_attention.wg_launches) == (2, 2, 2 * wg)
    assert (flash_attention_bwd.launches, flash_attention_bwd.tc_launches,
            flash_attention_bwd.wg_launches) == (1, 1, int(wg))
    B, S, Hq, Hkv, D = shape
    assert (fwd_form(S, S, D) == "wg") == wg
    assert (bwd_tc_form(S, S, Hq, Hkv, D) == "wg") == wg


def test_fp32_counts_no_form(entry):
    """fp32 takes the CUDA-core variant: no tensor-core launch, no form."""
    q, k, v = _qkv(1, 300, 8, 4, 64, torch.float32)
    fa_ops._flash_cuda(q, k, v, causal=True, window=0, softcap=0.0,
                       scale=0.125)
    (name, args), = entry
    assert args[6] == 0 and args[-1] == 0     # variant "simt", form "auto"
    assert (flash_attention.launches, flash_attention.tc_launches,
            flash_attention.wg_launches) == (1, 0, 0)


@pytest.mark.parametrize("D,dtype,variant", [
    (48, BF16, "tc"), (80, BF16, "tc"), (96, BF16, "tc"), (112, BF16, "tc"),
    (72, BF16, "simt"), (40, BF16, "simt"), (8, BF16, "simt"),
    (80, torch.float32, "simt"), (100, torch.float32, "simt"),
])
def test_variant_at_any_head_dim(D, dtype, variant):
    """``_flash_variant`` (and the backward's) from the inputs alone: the
    tensor cores for bf16 at a multiple of 16 up to 128, the CUDA cores
    for any other head dim in either dtype, as for fp32."""
    q, k, v = _qkv(1, 40, 4, 2, D, dtype)
    assert (D in fa_ops.HEAD_DIMS) == (D % 16 == 0)
    assert fa_ops._flash_variant(q, k, v) == variant
    assert fa_ops._flash_bwd_variant(q, k, v, q, q) == variant


@pytest.mark.parametrize("D", [136, 129, 0])
def test_check_raises_outside_1_to_128(D):
    """``_check`` refuses a head dim past 128 (or none), naming the
    bound."""
    q, k, v = _qkv(1, 8, 2, 2, D)
    with pytest.raises(ValueError, match="1 to 128"):
        fa_ops._check(q, k, v)


@pytest.mark.parametrize("D", [48, 80, 96, 112])
def test_bwd_smem_bytes_at_new_head_dims(D):
    """``bwd_smem_bytes`` (``tc::smem_bytes``) at the new head dims: q, dO,
    K, V at 2 bytes an element, the dS^T rows and lse, delta; the short
    form takes D = 48 only where it fits one block."""
    assert fa_ops.bwd_smem_bytes(200, 200, D) == \
        4 * D * 416 + 208 * 256 * 2 + 8 * 208
    short = bwd_tc_form(256, 256, 4, 4, D) == "short"
    assert short == (D <= 64 and fa_ops.bwd_smem_bytes(256, 256, D)
                     <= fa_ops.BWD_TC_MAX_SMEM)


@pytest.mark.parametrize("D,variant", [(80, "tc"), (112, "tc"), (72, "simt")])
def test_launch_arguments_at_new_head_dims(entry, D, variant):
    """The wrappers hand the C entries the true head dim (the kernels pad
    it themselves) and the variant's code, both ways: HuBERT's 80,
    Zamba2's 112, and 72 on the CUDA cores."""
    q, k, v = _qkv(1, 300, 4, 2, D)
    fa_ops._flash_cuda(q, k, v, causal=True, window=0, softcap=0.0,
                       scale=D ** -0.5)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fa_ops._flash_cuda(*leaves, causal=True, window=0, softcap=0.0,
                             scale=D ** -0.5)
    torch.autograd.grad(out, leaves, torch.zeros_like(out))
    (_, fwd), _, (_, bwd) = entry
    code = _build.VARIANT_CODES[variant]
    assert fwd[6] == code and fwd[12] == D
    assert bwd[12] == code and bwd[19] == D
    wg = int(variant == "tc")
    assert (flash_attention.launches, flash_attention.tc_launches,
            flash_attention.wg_launches) == (2, 2 * wg, 2 * wg)
    assert (flash_attention_bwd.launches, flash_attention_bwd.tc_launches,
            flash_attention_bwd.wg_launches) == (1, wg, wg)


# (q, k, v shape): Zamba2's shared block and HuBERT's layer at their
# training batches (MHA, one share), TinyLlama's (a group of 8, two shares)
@pytest.mark.parametrize("shape", [(2, 2048, 32, 32, 112),
                                   (4, 1000, 16, 16, 80),
                                   (2, 2048, 32, 4, 64)])
def test_meta_tensors_allocate_the_kernels_buffers(entry, shape):
    """On meta tensors (a step's memory counted before the card runs it)
    the wrappers launch nothing and count nothing, and allocate what the
    kernels do, never the plain version's S x S scores: out and the fp32
    row log-sum-exp forward; dq, dk, dv, fp32 delta and, where a kv head's
    q heads are shared among blocks, 2 x splits x dk's fp32 partials
    backward, at the card's 132 SMs; ``flash_attention_bwd`` the same."""
    from repro_torch.roofline.analysis import StepCounter
    B, S, Hq, Hkv, D = shape
    leaves = [t.to("meta").requires_grad_(True) for t in _qkv(*shape)]
    do = torch.empty(B, S, Hq, D, dtype=BF16, device="meta")
    q_bytes, k_bytes, rows = 2 * B * S * Hq * D, 2 * B * S * Hkv * D, \
        4 * B * Hq * S
    splits = bwd_splits(B, S, Hkv, Hq // Hkv, 132)
    part = 2 * splits * k_bytes * 2 if splits > 1 else 0
    assert fa_ops.hw.SMS == 132 and splits == (1 if Hq == Hkv else 2)
    with StepCounter(exclude=leaves + [do]) as c:
        out = flash_attention(*leaves, device="meta")
        assert c.peak_bytes == q_bytes + rows           # out, lse
        grads = torch.autograd.grad(out, leaves, do)
    assert c.peak_bytes == q_bytes + rows + q_bytes + 2 * k_bytes + rows \
        + part
    assert c.peak_bytes < 4 * B * Hq * S * S            # one fp32 score
    assert [g.shape for g in grads] == [t.shape for t in leaves]
    q, k, v = (t.detach() for t in leaves)
    lse = torch.empty(B, Hq, S, device="meta")
    with StepCounter(exclude=[q, k, v, out, lse, do]) as c:
        flash_attention_bwd(q, k, v, out.detach(), lse, do, device="meta")
    assert c.peak_bytes == q_bytes + 2 * k_bytes + rows + part
    assert entry == []
    assert (flash_attention.launches, flash_attention_bwd.launches) == (0, 0)


# ------------------------------------------ CPU path at a Hopper-form shape
def test_cpu_path_at_a_hopper_form_shape_matches_pallas():
    """At a shape the Hopper form takes on the card (GQA 8 over 2 heads of
    64, 160 rows: past the short form, over two 128-row q tiles, causal),
    the port's CPU path (the plain version the kernel is held to) against
    the Pallas kernel in interpret mode, bf16, inputs from numpy."""
    rng = np.random.default_rng(32)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((1, 160, 8, 64), (1, 160, 2, 64), (1, 160, 2, 64)))
    assert fwd_form(160, 160, 64) == "wg"
    out = flash_attention(*(torch.from_numpy(a).to(BF16) for a in (q, k, v)),
                          causal=True, device="cpu")
    ref = jax_flash(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                    causal=True, block_q=64, block_kv=64, interpret=True)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)
