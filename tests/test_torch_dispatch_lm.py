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
import contextlib

import pytest
import torch

from repro_torch.configs import mamba2_1_3b
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.rmsnorm import ops as norm_ops
from repro_torch.kernels.rmsnorm.ops import (BWD_MAX_BLOCKS,
                                             BWD_VEC_MAX_BLOCKS,
                                             BWD_VEC_WARPS, MAX_VECS,
                                             _rmsnorm_bwd_variant,
                                             _rmsnorm_variant, bwd_blocks,
                                             bwd_vec_partition)
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ssd
from repro_torch.kernels.ssd.ops import (MAX_SMEM_BYTES, _ssd_bwd_variant,
                                         _ssd_variant, bwd_smem_bytes,
                                         smem_bytes)
from repro_torch.kernels.ssd.ops import _launch_bwd as ssd_launch_bwd
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


# ------------------------------------------------------ the backward kernels
@pytest.mark.parametrize("rows", [1, 37, 255, 256, 257, 1024, 4096, 8193])
def test_rmsnorm_backward_row_ranges_cover_the_rows(rows):
    """The backward's row ranges depend on the row count alone (so dw's
    fixed-order sum over them is the same on every card): at most
    BWD_MAX_BLOCKS contiguous ranges that cover every row, none empty."""
    blocks, per = bwd_blocks(rows)
    assert blocks <= BWD_MAX_BLOCKS
    assert blocks * per >= rows > (blocks - 1) * per


@pytest.mark.parametrize("P,N,Q", [(64, 128, 256), (64, 128, 128),
                                   (128, 128, 256), (16, 16, 16),
                                   (32, 64, 64)])
def test_ssd_backward_fits_shared_memory(P, N, Q):
    """The backward's chunk kernels fit a block's shared memory at the
    model's shape (and its one-chunk training shape), at P = 128 and at the
    smoke config's."""
    assert bwd_smem_bytes(P, N, Q) <= MAX_SMEM_BYTES


def test_ssd_backward_refuses_state_dims_off_4():
    """N and P must be multiples of 4 (its 16-byte operand reads): the
    launch raises before reaching the card."""
    x = torch.zeros(1, 8, 2, 16)
    b = torch.zeros(1, 8, 1, 6)
    h = torch.zeros(2)
    with pytest.raises(ValueError, match="multiples of 4"):
        ssd_launch_bwd(x, torch.zeros(1, 8, 2), h, b, b, h, 8, x, None,
                       None, "simt")


# ---------------------------------------------- the backward kernels' variants
def _norm_bwd_case(name):
    if name == "dy_offset":
        x, w = _norm_case("contiguous")
        return x, w, _offset(torch.zeros_like(x))
    x, w = _norm_case(name)
    return x, w, torch.zeros(x.shape, dtype=x.dtype)


@pytest.mark.parametrize("name,variant", [
    ("contiguous", "vec"), ("fp32", "vec"), ("w_bf16", "vec"),
    ("d300_bf16", "simt"), ("d300_fp32", "vec"), ("x_offset", "simt"),
    ("w_offset", "simt"), ("dy_offset", "simt"), ("odd_row_stride", "simt"),
    ("one_row_odd_stride", "vec"), ("d_over_max", "simt"),
    ("leading_dims", "vec"),
])
def test_rmsnorm_bwd_variant(name, variant):
    """The backward takes the vec kernel where the forward would and dy's
    rows start on 16-byte boundaries too."""
    assert _rmsnorm_bwd_variant(*_norm_bwd_case(name)) == variant


@pytest.mark.parametrize("rows,d", [(8 * 128, LM.d_model),
                                    (2 * 2048, LM.d_model),
                                    (2 * 2048, LM.d_inner)])
def test_rmsnorm_training_shapes_take_vec_backward(rows, d):
    x = torch.empty(rows, d, dtype=BF16)
    assert _rmsnorm_bwd_variant(x, torch.empty(d), torch.empty_like(x)) == \
        "vec"


@pytest.mark.parametrize("rows", [1, 37, 1023, 1024, 1025, 4096, 8193,
                                  100_000])
def test_rmsnorm_vec_backward_warps_cover_every_row_once(rows):
    """The vec backward's warps take contiguous row ranges, a function of
    the row count alone: BWD_VEC_WARPS a block, at most BWD_VEC_MAX_BLOCKS
    blocks, every row in exactly one warp's range and no block without
    rows."""
    blocks, per = bwd_vec_partition(rows)
    assert 1 <= blocks <= BWD_VEC_MAX_BLOCKS
    taken = []
    for warp in range(blocks * BWD_VEC_WARPS):
        taken += range(min(rows, warp * per), min(rows, (warp + 1) * per))
    assert taken == list(range(rows))
    assert (blocks - 1) * BWD_VEC_WARPS * per < rows


@contextlib.contextmanager
def _recorded_launch(monkeypatch, module):
    """Replace ``module``'s C entry and the CUDA stream and device calls so
    that ``_launch_bwd`` runs on CPU tensors; yields the recorded args."""
    seen = {}

    def entry(*args):
        seen["args"] = args
        return 0
    monkeypatch.setattr(module._build, "load", lambda name: entry)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 7}))
    yield seen


@pytest.mark.parametrize("variant", ["vec", "simt"])
def test_rmsnorm_bwd_launch_arguments(monkeypatch, variant):
    """What the backward's ``_launch_bwd`` hands the C entry point: the
    operands, the dtypes, the variant code, and the row partition of that
    variant (warps' ranges for vec, blocks' for simt) with an fp32 partial
    row for each block."""
    rows, d = 4096, 2048
    x = torch.zeros(rows, d, dtype=BF16)
    w, dy = torch.zeros(d), torch.zeros(rows, d, dtype=BF16)
    with _recorded_launch(monkeypatch, norm_ops) as seen:
        dx, dw = norm_ops._launch_bwd(x, w, dy, variant, eps=1e-5,
                                      gemma=True)
    args = seen["args"]
    blocks, per = (bwd_vec_partition(rows) if variant == "vec" else
                   bwd_blocks(rows))
    assert (blocks, per) == ((256, 4) if variant == "vec" else (256, 16))
    assert args[:4] == (x.data_ptr(), w.data_ptr(), dy.data_ptr(),
                        dx.data_ptr())
    assert args[5] == dw.data_ptr() and dw.dtype == w.dtype
    assert args[6:9] == (1, 0, 1 if variant == "vec" else 0)
    assert args[9:14] == (rows, d, d, blocks, per)
    assert args[14:] == (pytest.approx(1e-5), 1, 7)


def _ssd_bwd_case(name):
    Bz, S, H, P, G, N, Q = 2, 2048, 64, 64, 1, 128, 256
    x = torch.zeros(Bz, S, H, P, dtype=BF16)
    B = C = torch.zeros(Bz, S, G, N, dtype=BF16)
    dy = torch.zeros_like(x)
    if name == "fp32":
        x, B, C, dy = x.float(), B.float(), C.float(), dy.float()
    elif name == "x_offset":
        x = _offset(x)
    elif name == "dy_offset":
        dy = _offset(dy)
    elif name == "state_48":
        B = C = torch.zeros(Bz, S, G, 48, dtype=BF16)
    elif name in ("p128_chunk256", "p128_chunk128"):
        x = dy = torch.zeros(1, 256, 4, 128, dtype=BF16)
        B = C = torch.zeros(1, 256, 1, 128, dtype=BF16)
        Q = 256 if name == "p128_chunk256" else 128
    elif name == "one_chunk":              # the (a) run: 8 x 128
        x = dy = torch.zeros(8, 128, H, P, dtype=BF16)
        B = C = torch.zeros(8, 128, G, N, dtype=BF16)
        Q = 128
    elif name == "fused_projection":
        fused = torch.zeros(Bz, S, H * P + 2 * N, dtype=BF16)
        x = fused[..., :H * P].unflatten(2, (H, P))
        B = fused[..., H * P:H * P + N].unflatten(2, (G, N))
        C = fused[..., H * P + N:].unflatten(2, (G, N))
    elif name == "smoke":
        x = dy = torch.zeros(2, 40, 8, 16, dtype=BF16)
        B = C = torch.zeros(2, 40, 1, 16, dtype=BF16)
        Q = 16
    return x, B, C, dy, Q


@pytest.mark.parametrize("name,variant", [
    ("contiguous", "tc"), ("fp32", "simt"), ("x_offset", "simt"),
    ("dy_offset", "simt"), ("state_48", "simt"), ("p128_chunk256", "simt"),
    ("p128_chunk128", "tc"), ("one_chunk", "tc"),
    ("fused_projection", "tc"), ("smoke", "tc"),
])
def test_ssd_bwd_variant(name, variant):
    """The backward takes the tensor cores where the forward would, dy is
    16-byte-aligned and the whole chunk fits shared memory (P = 128 at
    chunk 256 does not)."""
    assert _ssd_bwd_variant(*_ssd_bwd_case(name)) == variant


@pytest.mark.parametrize("P,N,Q", [(64, 128, 256), (64, 128, 128),
                                   (128, 128, 128), (16, 16, 16),
                                   (32, 64, 64), (64, 128, 100)])
def test_ssd_tc_backward_fits_shared_memory(P, N, Q):
    """The tc backward's kernels fit a block's shared memory at the model's
    training shapes, at P = 128 up to chunk 128 and at the smoke config's;
    its chunk kernel holds the whole chunk's x, dy, B and C."""
    tc = bwd_smem_bytes(P, N, Q, "tc")
    assert tc <= MAX_SMEM_BYTES
    q16 = -(-Q // 16) * 16
    assert tc >= q16 * (4 * P + 4 * N)
    assert bwd_smem_bytes(64, 128, 256, "tc") == 222_244
    assert bwd_smem_bytes(128, 128, 256, "tc") > MAX_SMEM_BYTES


@pytest.mark.parametrize("variant", ["tc", "simt"])
def test_ssd_bwd_launch_arguments(monkeypatch, variant):
    """What the backward's ``_launch_bwd`` hands the C entry point: the 23
    operand and scratch pointers (null for an absent initial state and its
    gradient), the dtype and variant codes, the sizes and chunk, and the
    strides of x, dt, B and C as they lie (a fused projection's views)."""
    x, B, C, dy, Q = _ssd_bwd_case("fused_projection")
    dy = dy.contiguous()
    Bz, S, H, P = x.shape
    dt, A, D = torch.zeros(Bz, S, H), torch.zeros(H), torch.zeros(H)
    with _recorded_launch(monkeypatch, ssd_ops) as seen:
        out = ssd_ops._launch_bwd(x, dt, A, B, C, D, Q, dy, None, None,
                                  variant)
    args = seen["args"]
    assert args[:9] == (x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                        B.data_ptr(), C.data_ptr(), D.data_ptr(), None,
                        dy.data_ptr(), None)
    assert args[9] == out[0].data_ptr() and args[15] is None
    assert all(isinstance(a, int) for a in args[16:23])
    assert args[23:32] == (1, 1 if variant == "tc" else 0, Bz, S, H, 1, P,
                           128, Q)
    assert args[32:44] == (*x.stride()[:3], *dt.stride(), *B.stride()[:3],
                           *C.stride()[:3])
    assert args[44] == 7
    assert out[6] is None and out[3].shape == B.shape
