"""How the RMSNorm and SSD-scan wrappers choose their kernel variant.

Each kernel has two variants on the card. RMSNorm: 16-byte vector accesses
with the row held in registers ("vec"), and one element per lane ("simt")
for rows those accesses cannot address. The SSD scan: bf16 on the tensor
cores ("tc"), and a CUDA-core one ("simt") for fp32 and for inputs the
16-byte copies cannot address. The choice is a pure function of dtype,
shape, strides and alignment, made before the launch; these tests pin it on
CPU tensors, which is where the functions can run here, down to the tensors
the Mamba2 model hands the kernels at its full serving widths. Which variant
a launch on the card really ran is asserted by the ``cuda`` tests and by
``chip_smoke.py`` through the ``vec_launches`` and ``tc_launches`` counters.
"""
import pytest
import torch

from repro_torch.configs import mamba2_1_3b
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.rmsnorm.ops import MAX_VECS, _rmsnorm_variant
from repro_torch.kernels.ssd import ssd
from repro_torch.kernels.ssd.ops import (MAX_SMEM_BYTES, _ssd_variant,
                                         smem_bytes)
from repro_torch.models import layers, ssm, transformer

BF16, FP32 = torch.bfloat16, torch.float32
LM = mamba2_1_3b.CONFIG


def _offset(t):
    """``t``'s values in a view one element past a 16-byte boundary."""
    flat = torch.cat([t.new_zeros(1), t.flatten()])[1:]
    return flat.view(t.shape)


# ------------------------------------------------------------ RMSNorm variant
def _norm_case(name):
    rows, d = 8, 2048
    x, w = torch.zeros(rows, d, dtype=BF16), torch.zeros(d)
    if name == "fp32":
        x = x.float()
    elif name == "w_bf16":
        w = w.to(BF16)
    elif name == "d300_bf16":
        x, w = torch.zeros(rows, 300, dtype=BF16), torch.zeros(300)
    elif name == "d300_fp32":
        x, w = torch.zeros(rows, 300), torch.zeros(300)
    elif name == "x_offset":
        x = _offset(x)
    elif name == "w_offset":
        w = _offset(w)
    elif name == "odd_row_stride":       # rows of d + 1 elements
        x = torch.zeros(rows, d + 1, dtype=BF16)[:, :d]
    elif name == "one_row_odd_stride":   # a row stride that is never stepped
        x = torch.zeros(1, d + 1, dtype=BF16)[:, :d]
    elif name == "d_over_max":
        d = 8 * (MAX_VECS + 1)
        x, w = torch.zeros(rows, d, dtype=BF16), torch.zeros(d)
    elif name == "leading_dims":         # (B, S, d), as the model passes it
        x = torch.zeros(2, 4, d, dtype=BF16)
    return x, w


@pytest.mark.parametrize("name,variant", [
    ("contiguous", "vec"), ("fp32", "vec"), ("w_bf16", "vec"),
    ("d300_bf16", "simt"), ("d300_fp32", "vec"), ("x_offset", "simt"),
    ("w_offset", "simt"), ("odd_row_stride", "simt"),
    ("one_row_odd_stride", "vec"), ("d_over_max", "simt"),
    ("leading_dims", "vec"),
])
def test_rmsnorm_variant(name, variant):
    assert _rmsnorm_variant(*_norm_case(name)) == variant


@pytest.mark.parametrize("rows,d", [
    (4 * 2048, LM.d_model), (4 * 2048, LM.d_inner),   # a 4 x 2048 prefill
    (4, LM.d_model), (4, LM.d_inner),                 # a batch-4 decode step
])
def test_rmsnorm_serving_shapes_are_vectorised(rows, d):
    x = torch.empty(rows, d, dtype=BF16)
    assert _rmsnorm_variant(x, torch.empty(d)) == "vec"


# ---------------------------------------------------------------- SSD variant
def _ssd_case(name):
    Bz, S, H, P, G, N = 2, 40, 4, 64, 1, 128
    x = torch.zeros(Bz, S, H, P, dtype=BF16)
    B = C = torch.zeros(Bz, S, G, N, dtype=BF16)
    if name == "fp32":
        x, B, C = x.float(), B.float(), C.float()
    elif name == "groups":
        B = C = torch.zeros(Bz, S, 2, N, dtype=BF16)
    elif name == "x_offset":
        x = _offset(x)
    elif name == "c_offset":
        C = _offset(C)
    elif name == "odd_row_stride":       # positions of H * P + 1 elements
        x = torch.zeros(Bz, S, H * P + 1, dtype=BF16)[..., :H * P]
        x = x.unflatten(2, (H, P))
    elif name == "state_8":
        B = C = torch.zeros(Bz, S, G, 8, dtype=BF16)
    elif name == "state_48":
        B = C = torch.zeros(Bz, S, G, 48, dtype=BF16)
    elif name == "fused_projection":     # x, B, C slices of one projection
        fused = torch.zeros(Bz, S, H * P + 2 * N, dtype=BF16)
        x = fused[..., :H * P].unflatten(2, (H, P))
        B = fused[..., H * P:H * P + N].unflatten(2, (G, N))
        C = fused[..., H * P + N:].unflatten(2, (G, N))
    elif name == "one_batch_odd_stride":
        x = x[:1].as_strided((1, S, H, P), (5, H * P, P, 1))
        B, C = B[:1], C[:1]
    return x, B, C


@pytest.mark.parametrize("name,variant", [
    ("contiguous", "tc"), ("fp32", "simt"), ("groups", "tc"),
    ("x_offset", "simt"), ("c_offset", "simt"), ("odd_row_stride", "simt"),
    ("state_8", "simt"), ("state_48", "simt"), ("fused_projection", "tc"),
    ("one_batch_odd_stride", "tc"),
])
def test_ssd_variant(name, variant):
    assert _ssd_variant(*_ssd_case(name)) == variant


@pytest.mark.parametrize("P", [8, 48, 256])
def test_ssd_variant_raises_on_head_dims_outside(P):
    x = torch.zeros(1, 8, 2, P, dtype=BF16)
    B = torch.zeros(1, 8, 1, 16, dtype=BF16)
    with pytest.raises(ValueError, match="head dim"):
        _ssd_variant(x, B, B)


def test_ssd_serving_shape_takes_the_tensor_cores():
    """One Mamba2-1.3B prefill layer's scan, 4 x 2048 tokens, fits the tc
    kernel's shared memory at chunk 256 (152,608 bytes: one block per
    SM)."""
    Bz, S = 4, 2048
    x = torch.empty(Bz, S, LM.ssm_nheads, LM.ssm_headdim, dtype=BF16)
    B = torch.empty(Bz, S, LM.ssm_ngroups, LM.ssm_state, dtype=BF16)
    assert _ssd_variant(x, B, B) == "tc"
    tc = smem_bytes(LM.ssm_headdim, LM.ssm_state, LM.ssm_chunk, "tc")
    assert tc == 152_608 <= MAX_SMEM_BYTES
    assert smem_bytes(128, 128, 256, "tc") == 201_760


def test_model_inputs_take_the_fast_variants(monkeypatch):
    """The tensors the Mamba2 model hands its kernels, at the full published
    widths (one layer, a small vocabulary): every norm (the block's, the
    gated out_norm, the final one) takes the vec variant and the scan the
    tc variant, in prefill; the decode step's norms take vec too."""
    norms, scans = [], []

    def norm_probe(x, w, **kw):
        norms.append(_rmsnorm_variant(x, w))
        return rmsnorm(x, w, **kw)

    def ssd_probe(x, dt, A, B, C, D, chunk, initial_state=None, **kw):
        scans.append(_ssd_variant(x, B, C))
        return ssd(x, dt, A, B, C, D, chunk, initial_state, **kw)

    monkeypatch.setattr(layers, "rmsnorm", norm_probe)
    monkeypatch.setattr(ssm, "ssd", ssd_probe)
    cfg = LM.replace(n_layers=1, vocab_size=256)
    params = transformer.init(torch.Generator().manual_seed(0), cfg)
    B, S = 2, 24
    toks = torch.randint(0, 256, (B, S), generator=torch.Generator()
                         .manual_seed(1))
    pos = torch.arange(S)[None].expand(B, S)
    with torch.inference_mode():
        lg, cache = transformer.prefill(params, cfg, toks, pos)
        assert (norms, scans) == (["vec"] * 3, ["tc"])
        transformer.decode_step(params, cfg, toks[:, :1], pos[:, :1] + S,
                                cache, S)
    assert norms == ["vec"] * 6 and scans == ["tc"]
