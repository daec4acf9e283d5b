"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip where there is no CUDA card (as on a CPU-only
test machine) and run on an H100 with

    python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports nothing of JAX, so it runs where JAX is not installed.
Shapes cover the agent's (S=144, a ragged last tile), GQA with a window and
softcap at ragged lengths, TinyLlama's causal GQA prefill (S=2048, 32 q
heads over 4 kv heads of 64), every supported head dim, and for every kernel
both of its variants (flash, the GEMM and the SSD scan: bf16 on the tensor
cores, fp32 and unaligned views on the CUDA cores; RMSNorm: 16-byte vectors,
and one element per lane for rows off 16 bytes), each case asserting
through the launch counters which one ran; for RMSNorm and the SSD scan,
the Mamba2-1.3B serving shapes, ragged rows and chunks, every head dim,
groups, an initial state and the model's strided views. Tolerances: fp32 3e-5 for attention, 1e-5 for
the GEMM and RMSNorm and 5e-5 for the scan (the bounds of
tests/test_kernels.py; sums in two orders); bf16 2e-2 absolute and relative
(one rounding at the output, after sums in two orders, may land one bf16
ulp apart).

The backward kernels (flash's, and the GEMM's two products) run through
autograd as training runs them, against their plain versions on the same
inputs: flash fp32 3e-5 absolute and 1e-5 relative, the GEMM fp32 2e-5
(sums over up to 1001 terms), bf16 2e-2; flash's tensor-core backward in
every form (the short one at the trunk's MHA heads, the streaming ones
for GQA, D = 128 and long or ragged sequences, at every split count of a
group) and bit for bit against itself over repeated calls, all of it with
a window too (Gemma-3's local training layer, a window of 1000 at a ragged
S of 2050, one under a tile, the short form, fp32); the GEMM's fused bf16
backward also at split-K boundaries, with strided dY, at Qwen2-MoE's
training shapes (E = 60, 342 rows an expert, wi and wo), and bit for bit
against itself over repeated calls; and one reduced DQN step with the kernels
against the same step on the card's plain path. The RMSNorm and SSD
backward kernels run through autograd against their plain versions, fp32
1e-4 and bf16 2e-2 of each gradient's scale, their reductions (dw; dA, dB,
dC, dD) the same bit for bit over repeated calls, each case asserting
through the counters which variant ran; both variants of each (RMSNorm's
"vec" and "simt", the scan's "tc" and "simt") are also launched directly
on the same bf16 inputs, ragged chunks included; RMSNorm's vec backward
also at Gemma-3's d_model (5376 in bf16, 672 vectors, gemma), at the
768 vectors one warp takes, at Zamba2-7B's out_norm in training
((4096, 7168) bf16, 896 vectors, two warps a row, plain and gemma, with
an fp32 or a bf16 w), in fp32 at 896 vectors of 4 (d 3584), at 769
vectors (the fewest two warps take) in both dtypes, and at 897 vectors
("simt"); the SSD backward also at Zamba2-7B's training layer,
x (2,2048,112,64) with N = 64 and one group, and ragged at its 112 heads
with an initial state; every backward case the same bit for bit over a
repeated call. Flash's two streaming forms are also named (the Hopper
form, ``wg``: wgmma fed by TMA rings, and the mma.sync form it replaced)
and held to the plain versions both ways at every LM layer the port runs,
ragged at 1100, under a window with softcap and on fused-qkv views; the
Hopper backward bit for bit at one share and at several, even and not;
the counters show each launch's form. At the head dims 48, 80, 96 and 112
(HuBERT X-Large's 80, Zamba2-7B's 112) every form the shapes take is
named, both ways (the Hopper backward's shares too); the CUDA-core variant
runs head dims off 16, 32, 64 and 128 in fp32 and in bf16 (72, 40), and a
head dim past 128 is refused.

Qwen2-MoE's MoE layer at ``SMOKE`` runs on the card against the CPU (its
two grouped GEMMs on the tensor cores in bf16), and the grouped GEMM at the
full model's expert shapes: a 4 x 2048 prefill's 684 rows an expert and a
decode step's 4. DeepSeek-V2's: the grouped GEMM at its 160 experts (a 4 x
2048 prefill's 384 rows an expert and a decode step's 4, experts with 0, 1
and ragged counts of rows), RMSNorm at its q and kv ranks (1536, 512), and
its SMOKE model with 16 experts top-6 (a prefill and 10 decode steps
through MLA's latent cache, fp32) against the CPU; its training shapes,
the fused GEMM backward at 160 experts of 96 rows (1 x 2048 tokens, a
k-tail of 32 in dW's contraction) through wi and wo, and RMSNorm's
backward at its q and kv ranks. Qwen1.5-4B's layer, 20 q heads over 20 kv
heads of 128 at S = 2048, through flash forward and backward. Zamba2-7B's
kernels: RMSNorm at its d_model (3584) and its out_norm's d_inner (7168 in
bf16, 896 vectors, the vec forward's limit; 897 runs simt), the SSD scan at
112 heads of 64 with N = 64 and one group, at a 4 x 2048 prefill and a
ragged S with an initial state; Command-R's flash layer, 64 q heads over 8
kv heads of 128, causal at S = 2048 and a ragged 1100. Qwen2-VL-7B's flash
layer, 28 q heads over 4 kv heads of 128 (a group of 7), causal at S =
2048 and ragged, forward and backward (the backward's streaming form at
one share a kv head), the backward also bit for bit over repeated calls.

TinyLlama's first 2 layers at full width run a prefill and two decode
steps on the card against the plain path on the CPU, same weights (2e-2 of
each output's largest magnitude). Gemma-3's window mask runs at its local
layers' heads (32 over 16 of 128, window 1024, ragged at 1100) and its
norms at d = 128 and d = 5376 with ``gemma``; its SMOKE model runs a
prefill and 40 decode steps, across the local rings' wrap, on the card
against the CPU. Last, a 6-tenant ``ProvisionService``
over a reduced learner on the card:
no fallback, the breaker closed, and its ragged batches' flash and GEMM
launches (batches x layers x 1 and x 6) all on the tensor cores.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_ref,
                                                 flash_attention_lse_ref,
                                                 flash_attention_ref)
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.moe_gemm import (expert_mlp, grouped_gemm,
                                          grouped_gemm_bwd_ref,
                                          grouped_gemm_ref)
from repro_torch.kernels.rmsnorm import (rmsnorm, rmsnorm_bwd,
                                         rmsnorm_bwd_ref, rmsnorm_ref)
from repro_torch.kernels.rmsnorm import ops as norm_ops
from repro_torch.kernels.ssd import ssd, ssd_bwd, ssd_bwd_ref, ssd_ref
from repro_torch.kernels.ssd import ops as ssd_ops

FP32, BF16 = "float32", "bfloat16"
TORCH = {FP32: torch.float32, BF16: torch.bfloat16}


def _normal(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=s) * scale).astype(np.float32) for s in shapes]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    return torch.device("cuda")


def _launched(kernel, fn):
    """Run ``fn`` and return the (launches, tc_launches) it added."""
    n, n_tc = kernel.launches, kernel.tc_launches
    out = fn()
    torch.cuda.synchronize()
    return out, (kernel.launches - n, kernel.tc_launches - n_tc)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,Hq,Hkv,Sq,Skv,D,dtype,causal,window,softcap,variant", [
        (2, 8, 8, 144, 144, 32, BF16, False, 0, 0.0, "tc"),   # the agent's
        (2, 8, 2, 97, 131, 64, FP32, True, 40, 30.0, "simt"),
        (2, 8, 2, 97, 131, 64, BF16, True, 40, 30.0, "tc"),
        (1, 4, 4, 200, 200, 128, BF16, True, 0, 0.0, "tc"),
        (1, 2, 1, 131, 97, 128, BF16, False, 0, 0.0, "tc"),
        (3, 4, 4, 24, 24, 16, FP32, False, 0, 0.0, "simt"),
        (3, 4, 4, 50, 50, 16, BF16, False, 0, 0.0, "tc"),
        (2, 4, 2, 256, 256, 32, BF16, True, 0, 0.0, "tc"),     # short form's largest
        (2, 4, 4, 64, 64, 128, BF16, False, 0, 0.0, "tc"),
        (1, 2, 2, 33, 300, 32, BF16, False, 100, 0.0, "tc"),   # window, Sq < Skv
        (1, 32, 4, 2048, 2048, 64, BF16, True, 0, 0.0, "tc"),  # TinyLlama prefill
        (2, 32, 16, 1100, 1100, 128, BF16, True, 1024, 0.0, "tc"),  # Gemma-3 local
        (1, 8, 4, 2048, 2048, 64, BF16, True, 1024, 0.0, "tc"),
        (4, 20, 20, 2048, 2048, 128, BF16, True, 0, 0.0, "tc"),  # Qwen1.5-4B
        (4, 64, 8, 2048, 2048, 128, BF16, True, 0, 0.0, "tc"),  # Command-R
        (1, 64, 8, 1100, 1100, 128, BF16, True, 0, 0.0, "tc"),  # ragged
        (4, 28, 4, 2048, 2048, 128, BF16, True, 0, 0.0, "tc"),  # Qwen2-VL
        (1, 28, 4, 1100, 1100, 128, BF16, True, 0, 0.0, "tc"),  # ragged
    ])
def test_flash_kernel_matches_plain(cuda, B, Hq, Hkv, Sq, Skv, D, dtype,
                                    causal, window, softcap, variant):
    q, k, v = (torch.from_numpy(a).to(cuda, TORCH[dtype]) for a in _normal(
        Sq, (B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))
    opts = dict(causal=causal, window=window, softcap=softcap)
    out, counts = _launched(flash_attention,
                            lambda: flash_attention(q, k, v, **opts))
    assert counts == (1, int(variant == "tc"))
    torch.testing.assert_close(out.float(), flash_attention_ref(
        q, k, v, **opts).float(), atol=3e-5 if dtype == FP32 else 2e-2,
        rtol=0 if dtype == FP32 else 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("layout,variant", [("fused", "tc"),
                                            ("offset", "simt")])
def test_flash_kernel_strided_views(cuda, layout, variant):
    """q, k, v as views of one fused (B, S, 3, H, D) tensor (16-byte rows:
    the tensor cores), and as views one element into a wider last axis
    (rows off 16-byte boundaries: the CUDA-core kernel), in bf16."""
    B, S, H, D = 2, 77, 4, 64
    a, = _normal(5, (B, S, 3, H, D + 8))
    t = torch.from_numpy(a).to(cuda, torch.bfloat16)
    if layout == "fused":
        t = t[..., :D].contiguous()
        q, k, v = t.unbind(2)
    else:
        q, k, v = (t[:, :, i, :, 1:D + 1] for i in range(3))
    out, counts = _launched(flash_attention,
                            lambda: flash_attention(q, k, v, causal=True))
    assert counts == (1, int(variant == "tc"))
    torch.testing.assert_close(out.float(), flash_attention_ref(
        q, k, v, causal=True).float(), atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("E,C,d,f,dtype,layout,variant", [
    (10, 300, 41, 256, FP32, "plain", "simt"),
    (10, 9216, 256, 256, BF16, "plain", "tc"),      # the trunk's q, k, v, o
    (10, 9216, 256, 1024, BF16, "plain", "tc"),     # its ffn in
    (10, 9216, 1024, 256, BF16, "plain", "tc"),     # its ffn out
    (10, 9216, 256, 256, BF16, "rows", "tc"),       # its normed activations
    (3, 1001, 200, 136, BF16, "plain", "tc"),       # C, d and f off the tile
    (1, 37, 1024, 53, BF16, "plain", "simt"),       # f off TMA's 16-byte rule
    (2, 100, 64, 96, BF16, "offset", "simt"),       # x one element off 16 bytes
    (60, 684, 2048, 2816, BF16, "plain", "tc"),     # Qwen2-MoE prefill, wi
    (60, 684, 1408, 2048, BF16, "plain", "tc"),     # its wo; C off the tile
    (60, 4, 2048, 2816, BF16, "plain", "tc"),       # a decode step's 4 rows
])
def test_grouped_gemm_kernel_matches_plain(cuda, E, C, d, f, dtype, layout,
                                           variant):
    """``layout``: "plain" contiguous x; "rows" x stored (C, E, d), the
    expert axis inside the rows, as the trunk's activations are; "offset"
    x one element past a 16-byte boundary."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x, w = (torch.from_numpy(a).to(cuda, TORCH[dtype]) for a in _normal(
        C, (E, C, d), (E, d, f), scale=d ** -0.25))
    if layout == "rows":
        x = x.transpose(0, 1).contiguous().transpose(0, 1)
    elif layout == "offset":
        x = torch.cat([x.new_zeros(1), x.flatten()])[1:].view(E, C, d)
        assert x.data_ptr() % 16
    out, counts = _launched(grouped_gemm, lambda: grouped_gemm(x, w))
    assert counts == (1, int(variant == "tc"))
    tol = 1e-5 if dtype == FP32 else 2e-2
    torch.testing.assert_close(out.float(), grouped_gemm_ref(x, w).float(),
                               atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tc", [(FP32, 0), (BF16, 3)])
def test_expert_mlp_kernel_path(cuda, dtype, tc):
    """Three grouped-GEMM launches, the gate and up operands read as strided
    views of wi (w_sk = 2f): on the tensor cores in bf16."""
    x, wi, wo = (torch.from_numpy(a).to(cuda, TORCH[dtype]) for a in _normal(
        3, (3, 40, 96), (3, 96, 2, 64), (3, 64, 96), scale=0.2))
    out, counts = _launched(grouped_gemm, lambda: expert_mlp(
        x, wi, wo, activation="gelu"))
    assert counts == (3, tc)
    ref = expert_mlp(x.cpu(), wi.cpu(), wo.cpu(), activation="gelu",
                     device="cpu")
    tol = 1e-5 if dtype == FP32 else 2e-2
    torch.testing.assert_close(out.cpu().float(), ref.float(), atol=tol,
                               rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("C,d,f", [
    (384, 5120, 3072),      # DeepSeek-V2's 4 x 2048 prefill, wi
    (384, 1536, 5120),      # its wo
    (4, 5120, 3072),        # a decode step's 4 rows, wi
    (4, 1536, 5120),        # and wo
    (97, 512, 136),         # C and f off the tile
])
def test_grouped_gemm_at_160_experts(cuda, C, d, f):
    """DeepSeek-V2's routed experts (E = 160) in bf16 on the tensor cores,
    laid out as the capacity dispatch fills them: each expert's first n_e
    rows hold tokens and the rest zeros, n_e ragged, some experts with 0
    rows and some with 1 (a full C where C = 4)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    E = 160
    x, w = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in _normal(
        C + d, (E, C, d), (E, d, f), scale=d ** -0.25))
    n = torch.from_numpy(np.random.default_rng(C).integers(0, C + 1, E))
    n[:8], n[8:16] = 0, 1
    x *= (torch.arange(C)[None] < n[:, None]).to(cuda, x.dtype)[..., None]
    out, counts = _launched(grouped_gemm, lambda: grouped_gemm(x, w))
    assert counts == (1, 1) and out.shape == (E, C, f)
    assert not out[:8].any() and out[8:16, 1:].abs().max() == 0
    torch.testing.assert_close(out.float(), grouped_gemm_ref(x, w).float(),
                               atol=2e-2, rtol=2e-2)


def _counted(kernel, counter, fn):
    """Run ``fn`` and return the (launches, ``counter``) it added."""
    n, n_fast = kernel.launches, getattr(kernel, counter)
    out = fn()
    torch.cuda.synchronize()
    return out, (kernel.launches - n, getattr(kernel, counter) - n_fast)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d,dtype,w_dtype,gemma,layout,variant", [
    (8192, 2048, BF16, FP32, False, "plain", "vec"),   # Mamba2-1.3B prefill
    (8192, 4096, BF16, FP32, False, "plain", "vec"),
    (4, 2048, BF16, FP32, False, "plain", "vec"),      # its decode step
    (4, 4096, BF16, FP32, False, "plain", "vec"),
    (1, 1024, BF16, BF16, True, "plain", "vec"),
    (37, 1024, FP32, BF16, False, "plain", "vec"),
    (300, 2048, FP32, FP32, True, "plain", "vec"),
    (33, 300, FP32, FP32, False, "plain", "vec"),      # ragged vectors
    (33, 300, BF16, FP32, True, "plain", "simt"),      # d off 16 bytes
    (37, 64, FP32, BF16, False, "offset", "simt"),     # x one element off
    (64, 4096, BF16, BF16, False, "offset", "simt"),
    (64, 1024, BF16, FP32, False, "rows", "vec"),      # strided rows
    (4096, 128, BF16, FP32, True, "plain", "vec"),     # Gemma-3 QK-norm
    (8192, 5376, BF16, FP32, True, "plain", "vec"),    # its d_model, 672 vectors
    (3, 5376, FP32, FP32, True, "plain", "simt"),      # 1344 vectors: too many
    (8192, 1536, BF16, FP32, False, "plain", "vec"),   # DeepSeek-V2 q_norm
    (8192, 512, BF16, FP32, False, "plain", "vec"),    # its kv_norm
    (8192, 1536, FP32, FP32, False, "plain", "vec"),
    (8192, 512, FP32, FP32, False, "plain", "vec"),
    (4, 1536, BF16, FP32, False, "plain", "vec"),      # a decode step's
    (4, 512, BF16, FP32, False, "plain", "vec"),
    (8192, 3584, BF16, FP32, False, "plain", "vec"),   # Zamba2-7B d_model
    (8192, 7168, BF16, FP32, False, "plain", "vec"),   # its out_norm: 896
    (4, 7168, BF16, FP32, False, "plain", "vec"),      # a decode step's
    (33, 7176, BF16, FP32, False, "plain", "simt"),    # 897: one too many
    (37, 3584, FP32, FP32, False, "plain", "vec"),     # fp32's 896
])
def test_rmsnorm_kernel_matches_plain(cuda, rows, d, dtype, w_dtype, gemma,
                                      layout, variant):
    """``layout``: "plain" contiguous rows; "offset" x one element past a
    16-byte boundary; "rows" x a view of every other row of a wider array
    (row stride 2d)."""
    x, w = _normal(rows + d, (rows, d), (d,))
    x = torch.from_numpy(x * 3).to(cuda, TORCH[dtype])
    w = torch.from_numpy(w).to(cuda, TORCH[w_dtype])
    if layout == "offset":
        x = torch.cat([x.new_zeros(1), x.flatten()])[1:].view(rows, d)
        assert x.data_ptr() % 16
    elif layout == "rows":
        x = torch.stack([x, torch.zeros_like(x)], 1).view(2 * rows, d)[::2]
        assert x.stride(0) == 2 * d
    out, counts = _counted(rmsnorm, "vec_launches",
                           lambda: rmsnorm(x, w, gemma=gemma))
    assert counts == (1, int(variant == "vec")) and out.dtype == x.dtype
    tol = 1e-5 if dtype == FP32 else 2e-2
    torch.testing.assert_close(out.float(), rmsnorm_ref(x, w, gemma=gemma)
                               .float(), atol=tol, rtol=tol)


def _ssd_inputs(device, Bz, S, H, P, N, G, dtype, init):
    """tests/test_kernels.py's scales, with the model's small steps
    (dt about 0.07): a large dt over 256-step chunks makes the fp32 cumsum
    of dt * A alone round past the fp32 bound (chip_smoke.ssd_inputs)."""
    rng = np.random.default_rng(S + H + P)
    x = (rng.normal(size=(Bz, S, H, P)) * 0.5).astype(np.float32)
    B, C = ((rng.normal(size=(Bz, S, G, N)) * 0.3).astype(np.float32)
            for _ in range(2))
    dt = np.log1p(np.exp(rng.normal(size=(Bz, S, H)) - 3)).astype(np.float32)
    A = -np.exp(rng.normal(size=H) * 0.3).astype(np.float32)
    D = np.ones(H, np.float32)
    s0 = (rng.normal(size=(Bz, H, P, N)) * 0.3).astype(np.float32) \
        if init else None
    t = [torch.from_numpy(a).to(device) for a in (x, dt, A, B, C, D)]
    for i in (0, 3, 4):
        t[i] = t[i].to(TORCH[dtype])
    return t + [None if s0 is None else torch.from_numpy(s0).to(device)]


@pytest.mark.cuda
@pytest.mark.parametrize("Bz,S,H,P,N,G,chunk,dtype,init,variant", [
    (4, 2048, 64, 64, 128, 1, 256, BF16, False, "tc"),  # Mamba2-1.3B prefill
    (2, 1000, 8, 64, 128, 2, 256, BF16, True, "tc"),    # ragged, groups, state
    (2, 300, 4, 16, 128, 1, 64, BF16, True, "tc"),
    (2, 300, 4, 32, 64, 2, 128, BF16, False, "tc"),
    (1, 517, 2, 128, 128, 1, 256, BF16, True, "tc"),   # one head a block
    (1, 300, 3, 64, 128, 1, 128, BF16, True, "tc"),    # 3 heads a group: one
    (1, 130, 4, 64, 16, 1, 64, BF16, True, "tc"),
    (1, 6, 8, 32, 32, 1, 256, BF16, False, "tc"),       # one short chunk
    (4, 2048, 112, 64, 64, 1, 256, BF16, False, "tc"),  # Zamba2-7B prefill
    (1, 1100, 112, 64, 64, 1, 256, BF16, True, "tc"),   # ragged, a state
    (2, 200, 4, 64, 8, 1, 64, BF16, False, "simt"),     # N off the tc kernel
    (2, 1000, 8, 64, 128, 2, 256, FP32, True, "simt"),
    (2, 50, 4, 16, 8, 2, 16, FP32, True, "simt"),
    (1, 6, 8, 32, 16, 1, 256, FP32, False, "simt"),
    (1, 130, 2, 128, 32, 1, 100, FP32, True, "simt")])
def test_ssd_kernel_matches_plain(cuda, Bz, S, H, P, N, G, chunk, dtype, init,
                                  variant):
    x, dt, A, B, C, D, s0 = _ssd_inputs(cuda, Bz, S, H, P, N, G, dtype, init)
    (y, final), counts = _counted(ssd, "tc_launches", lambda: ssd(
        x, dt, A, B, C, D, chunk, s0))
    assert counts == (1, int(variant == "tc"))
    y_ref, final_ref = ssd_ref(x, dt, A, B, C, D, chunk, s0)
    tol = 5e-5 if dtype == FP32 else 2e-2
    torch.testing.assert_close(y.float(), y_ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(final, final_ref, atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("layout,variant", [("fused", "tc"),
                                            ("offset", "simt")])
def test_ssd_kernel_strided_views(cuda, layout, variant):
    """x, B and C as the model's reshapes of one projection's slices,
    (Bz, S, H*P + 2N) unflattened in place (16-byte rows: the tensor
    cores), and one element into it (the CUDA-core kernel), in bf16."""
    Bz, S, H, P, N = 2, 333, 8, 64, 128
    a, = _normal(9, (Bz, S, H * P + 2 * N + 8))
    t = torch.from_numpy(a * 0.4).to(cuda, torch.bfloat16)
    t = t[..., :H * P + 2 * N] if layout == "fused" else \
        t[..., 1:H * P + 2 * N + 1]
    x = t[..., :H * P].unflatten(2, (H, P))
    B = t[..., H * P:H * P + N].unflatten(2, (1, N))
    C = t[..., H * P + N:].unflatten(2, (1, N))
    _, dt, A, _, _, D, s0 = _ssd_inputs(cuda, Bz, S, H, P, N, 1, BF16, True)
    (y, final), counts = _counted(ssd, "tc_launches", lambda: ssd(
        x, dt, A, B, C, D, 128, s0))
    assert counts == (1, int(variant == "tc"))
    y_ref, final_ref = ssd_ref(x, dt, A, B, C, D, 128, s0)
    torch.testing.assert_close(y.float(), y_ref.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(final, final_ref, atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [FP32, BF16])
def test_mamba_smoke_kernel_path(cuda, dtype):
    """Mamba2 SMOKE prefill and two decode steps on the card (both kernels)
    against the plain path on the CPU, same weights. In fp32 the scan runs
    on the CUDA cores (1e-4); in bf16 compute on the tensor cores, and the
    logits hold within 2e-2 of their largest magnitude (a few bf16 ulps of
    the hidden state, as in the CPU model tests). Every norm is vectorised."""
    from repro_torch.configs import mamba2_1_3b
    from repro_torch.convert import tree_map
    from repro_torch.models import transformer
    cfg = mamba2_1_3b.SMOKE.replace(compute_dtype=dtype)
    params = transformer.init(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 40)))
    pos = torch.arange(40)[None].expand(2, 40)
    n_ssd, n_tc = ssd.launches, ssd.tc_launches
    n_norm, n_vec = rmsnorm.launches, rmsnorm.vec_launches
    outs = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev), params)
        with torch.inference_mode():
            lg, cache = transformer.prefill(p, cfg, toks.to(dev),
                                            pos.to(dev))
            lgs = [lg]
            for i in range(2):
                lg, cache = transformer.decode_step(
                    p, cfg, toks[:, i:i + 1].to(dev), None, cache, 40 + i)
                lgs.append(lg)
        outs[dev] = [t.cpu() for t in lgs]
    torch.cuda.synchronize()
    L = cfg.n_layers
    assert ssd.launches == n_ssd + L
    assert ssd.tc_launches == n_tc + (L if dtype == BF16 else 0)
    assert rmsnorm.launches - n_norm == rmsnorm.vec_launches - n_vec == \
        3 * (2 * L + 1)
    for a, b in zip(outs["cuda"], outs["cpu"]):
        if dtype == FP32:
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
        else:
            assert (a - b).abs().max() <= 2e-2 * b.abs().max()


@pytest.mark.cuda
def test_dense_lm_kernel_path(cuda):
    """The first 2 layers of TinyLlama-1.1B at its full width (32 q heads
    over 4 kv heads of 64, bf16 compute): a 2 x 300 prefill into a cache of
    302 and two decode steps on the card against the plain path on the CPU,
    same weights. Each prefill launches one flash kernel a layer on the
    tensor cores, each pass 2 x 2 + 1 vectorised norms; logits and the KV
    cache hold within 2e-2 of their largest magnitude (a few bf16 ulps of
    the hidden state, as the Mamba2 case)."""
    from repro_torch.configs import tinyllama_1_1b
    from repro_torch.convert import tree_map
    from repro_torch.models import transformer
    cfg = tinyllama_1_1b.CONFIG.replace(n_layers=2)
    params = transformer.init(torch.Generator().manual_seed(0), cfg)
    B, S = 2, 300
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, S + 2)))
    pos = torch.arange(S + 2)[None].expand(B, S + 2)
    n_flash, n_tc = flash_attention.launches, flash_attention.tc_launches
    n_norm, n_vec = rmsnorm.launches, rmsnorm.vec_launches
    outs = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev), params)
        with torch.inference_mode():
            lg, cache = transformer.prefill(p, cfg, toks[:, :S].to(dev),
                                            pos[:, :S].to(dev), S + 2)
            lgs = [lg]
            for i in range(S, S + 2):
                lg, cache = transformer.decode_step(
                    p, cfg, toks[:, i:i + 1].to(dev), pos[:, i:i + 1].to(dev),
                    cache, i)
                lgs.append(lg)
        kv = cache["segments"][0]["b0"]
        outs[dev] = [t.cpu() for t in lgs + [kv["k"], kv["v"]]]
        del p
    torch.cuda.synchronize()
    assert flash_attention.launches - n_flash == \
        flash_attention.tc_launches - n_tc == cfg.n_layers
    assert rmsnorm.launches - n_norm == rmsnorm.vec_launches - n_vec == \
        3 * (2 * cfg.n_layers + 1)
    for a, b in zip(outs["cuda"], outs["cpu"]):
        assert a.shape == b.shape and torch.isfinite(a.float()).all()
        assert (a.float() - b.float()).abs().max() <= \
            2e-2 * b.float().abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [FP32, BF16])
def test_gemma3_smoke_kernel_path(cuda, dtype):
    """Gemma-3 SMOKE (2 x (local, global), window 32, QK-norm, sandwich
    norms, tied table) under ``attn_impl="flash"``, its norm scales drawn
    N(0, 0.1) in place of the init's zeros: a 40-token prefill (past the
    window) into a cache of 80 and 40 decode steps of the same tokens on
    the card against the plain path on the CPU, same weights. The local
    rings (32 slots) wrap at index 64. Each prefill launches 4 flash
    kernels (2 with the window), each pass 4 x 6 + 1 vectorised norms, and
    a decode step no flash; logits and every cache hold within 1e-4 in
    fp32 and 2e-2 of their largest magnitude in bf16."""
    from repro_torch.configs import gemma3_27b
    from repro_torch.convert import tree_map
    from repro_torch.models import transformer
    cfg = gemma3_27b.SMOKE.replace(compute_dtype=dtype, attn_impl="flash")
    gen = torch.Generator().manual_seed(0)
    params = transformer.init(gen, cfg)
    params = {k: (tree_map(lambda t: t + 0.1 * torch.randn(
        t.shape, generator=gen), v) if k == "final_norm" else v)
        for k, v in params.items()}
    for seg in params["segments"]:
        for blk in seg.values():
            for name in ("ln1", "ln2", "post_ln1", "post_ln2"):
                blk[name]["scale"] += 0.1 * torch.randn(
                    blk[name]["scale"].shape, generator=gen)
            for name in ("q_norm", "k_norm"):
                blk["attn"][name]["scale"] += 0.1 * torch.randn(
                    blk["attn"][name]["scale"].shape, generator=gen)
    B, P, steps = 2, 40, 40
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, P + steps)))
    pos = torch.arange(P + steps)[None].expand(B, P + steps)
    counts = {}
    outs = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev), params)
        n = (flash_attention.launches, flash_attention.tc_launches,
             rmsnorm.launches, rmsnorm.vec_launches)
        with torch.inference_mode():
            lg, cache = transformer.prefill(p, cfg, toks[:, :P].to(dev),
                                            pos[:, :P].to(dev), P + steps)
            lgs = [lg]
            for i in range(P, P + steps):
                lg, cache = transformer.decode_step(
                    p, cfg, toks[:, i:i + 1].to(dev), pos[:, i:i + 1].to(dev),
                    cache, i)
                lgs.append(lg)
        torch.cuda.synchronize()
        counts[dev] = (flash_attention.launches - n[0],
                       flash_attention.tc_launches - n[1],
                       rmsnorm.launches - n[2], rmsnorm.vec_launches - n[3])
        leaves = [t for seg in cache["segments"] for blk in seg.values()
                  for t in blk.values()]
        outs[dev] = [t.cpu() for t in lgs + leaves]
    L = cfg.n_layers
    assert counts["cpu"] == (0, 0, 0, 0)
    assert counts["cuda"] == (L, L if dtype == BF16 else 0,
                              (1 + steps) * (6 * L + 1),
                              (1 + steps) * (6 * L + 1))
    assert outs["cuda"][-4].shape[2] == cfg.sliding_window   # a local ring
    for a, b in zip(outs["cuda"], outs["cpu"]):
        assert a.shape == b.shape and torch.isfinite(a.float()).all()
        if dtype == FP32:
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
        else:
            assert (a.float() - b.float()).abs().max() <= \
                2e-2 * b.float().abs().max()


@pytest.mark.cuda
def test_deepseek_v2_smoke_kernel_path(cuda):
    """DeepSeek-V2 SMOKE with 16 experts top-6 over a dense layer and 2 MoE
    layers, in fp32, every norm scale drawn N(1, 0.3) in place of the
    init's ones: a 40-token prefill (MLA's latent chunks of 16) into a cache
    of 50 and 10 decode steps of the same tokens on the card against the
    plain path on the CPU, same weights. Each pass launches 2 grouped GEMMs
    a MoE layer and 4 RMSNorm a layer (the block norms, q_norm, kv_norm)
    plus the final one, and no flash kernel; logits and the latent caches
    hold within 1e-4. The router runs in fp32 on the same x on both."""
    from repro_torch.configs import deepseek_v2_236b
    from repro_torch.convert import tree_map
    from repro_torch.models import transformer
    cfg = deepseek_v2_236b.SMOKE.replace(compute_dtype=FP32, n_experts=16,
                                         top_k=6, n_layers=3, attn_chunk=16)
    gen = torch.Generator().manual_seed(0)
    params = transformer.init(gen, cfg)

    def bump(path, t):
        return t + 0.3 * torch.randn(t.shape, generator=gen) \
            if "scale" in path else t

    def walk(tree, path=""):
        if isinstance(tree, dict):
            return {k: walk(v, path + "/" + k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, path) for v in tree]
        return bump(path, tree)
    params = walk(params)
    B, P, steps = 2, 40, 10
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, P + steps)))
    pos = torch.arange(P + steps)[None].expand(B, P + steps)
    counts, outs = {}, {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev), params)
        n = (flash_attention.launches, grouped_gemm.launches,
             rmsnorm.launches)
        with torch.inference_mode():
            lg, cache = transformer.prefill(p, cfg, toks[:, :P].to(dev),
                                            pos[:, :P].to(dev), P + steps)
            lgs = [lg]
            for i in range(P, P + steps):
                lg, cache = transformer.decode_step(
                    p, cfg, toks[:, i:i + 1].to(dev), pos[:, i:i + 1].to(dev),
                    cache, i)
                lgs.append(lg)
        torch.cuda.synchronize()
        counts[dev] = (flash_attention.launches - n[0],
                       grouped_gemm.launches - n[1], rmsnorm.launches - n[2])
        leaves = [t for seg in cache["segments"] for blk in seg.values()
                  for t in blk.values()]
        outs[dev] = [t.cpu() for t in lgs + leaves]
    L = cfg.n_layers
    assert counts["cpu"] == (0, 0, 0)
    assert counts["cuda"] == (0, (1 + steps) * 2 * (L - 1),
                              (1 + steps) * (4 * L + 1))
    for a, b in zip(outs["cuda"], outs["cpu"]):
        assert a.shape == b.shape and torch.isfinite(a.float()).all()
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_padded_heads_prefill_kernel_path(cuda):
    """Padded q heads that do not divide into the kv heads (20 MHA heads of
    64 padded to 32 q heads over 20 kv heads, at TinyLlama-1.1B's width, 2
    layers, bf16 compute): the prefill broadcasts K/V to the q heads and
    launches the flash kernel on the tensor cores, one a layer, and its
    logits and KV cache, then a decode step's logits, hold within 2e-2 of
    their largest magnitude against the plain path on the CPU."""
    from repro_torch.configs import tinyllama_1_1b
    from repro_torch.convert import tree_map
    from repro_torch.models import transformer
    cfg = tinyllama_1_1b.CONFIG.replace(
        n_layers=2, n_heads=20, n_kv_heads=20, head_dim=64).padded(16)
    assert (cfg.nq, cfg.nkv, cfg.attn_impl) == (32, 20, "flash")
    params = transformer.init(torch.Generator().manual_seed(0), cfg)
    B, S = 2, 256
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, S + 1)))
    pos = torch.arange(S + 1)[None].expand(B, S + 1)
    n_flash, n_tc = flash_attention.launches, flash_attention.tc_launches
    outs = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev), params)
        with torch.inference_mode():
            lg, cache = transformer.prefill(p, cfg, toks[:, :S].to(dev),
                                            pos[:, :S].to(dev), S + 1)
            lg2, _ = transformer.decode_step(
                p, cfg, toks[:, S:].to(dev), pos[:, S:].to(dev), cache, S)
        kv = cache["segments"][0]["b0"]
        outs[dev] = [t.cpu() for t in (lg, lg2, kv["k"], kv["v"])]
        del p
    torch.cuda.synchronize()
    assert flash_attention.launches - n_flash == \
        flash_attention.tc_launches - n_tc == cfg.n_layers
    for a, b in zip(outs["cuda"], outs["cpu"]):
        assert a.shape == b.shape and torch.isfinite(a.float()).all()
        assert (a.float() - b.float()).abs().max() <= \
            2e-2 * b.float().abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tc", [(FP32, 0), (BF16, 2)])
def test_topk_moe_kernel_path(cuda, monkeypatch, dtype, tc):
    """Qwen2-MoE ``SMOKE``'s MoE layer (8 experts top-2 + 1 shared, d 64) at
    a capacity factor that drops tokens, on the card against the CPU, same
    weights: two grouped GEMM launches (tensor cores in bf16), outputs
    within 1e-4 (fp32) or 2e-2 of their largest magnitude (bf16), the aux
    loss within 1e-5 relative. The router runs in fp32 on both, on the same
    x: a token may route differently only where its K-th and (K+1)-th
    probabilities lie within 1e-5, and the CPU run replays the card's
    experts, so such a near-tie cannot move the comparison."""
    from repro_torch.configs import qwen2_moe_a2_7b
    from repro_torch.convert import tree_map
    from repro_torch.models import moe
    cfg = qwen2_moe_a2_7b.SMOKE.replace(compute_dtype=dtype,
                                        capacity_factor=0.5)
    params = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    x, = _normal(1, (2, 64, cfg.d_model))
    x = torch.from_numpy(x).to(TORCH[dtype])
    p = tree_map(lambda t: t.to(cuda), params)
    route, card = moe._route, []

    def record(params, x, cfg):
        out = route(params, x, cfg)
        card.append(out[2].cpu())
        return out
    monkeypatch.setattr(moe, "_route", record)
    (yc, auxc), counts = _launched(grouped_gemm, lambda: moe.topk_moe(
        p, x.to(cuda), cfg))
    assert counts == (2, tc)

    def replay(params, x, cfg):
        probs, _, idx = route(params, x, cfg)
        top = torch.topk(probs, cfg.top_k + 1, -1)[0]
        near = (top[..., -2] - top[..., -1]) < 1e-5
        same = (idx.sort(-1).values == card[0].sort(-1).values).all(-1)
        assert bool((same | near).all()), "a route flipped off a near-tie"
        gates = probs.gather(-1, card[0])
        return probs, gates / gates.sum(-1, keepdim=True), card[0]
    monkeypatch.setattr(moe, "_route", replay)
    y, aux = moe.topk_moe(params, x, cfg)
    assert yc.dtype == y.dtype and yc.shape == y.shape
    err = (yc.cpu().float() - y.float()).abs().max()
    assert err <= (1e-4 if dtype == FP32 else 2e-2 * y.float().abs().max())
    assert abs(float(auxc) - float(aux)) <= 1e-5 * abs(float(aux))


@pytest.mark.cuda
def test_empty_outputs_count_no_launch(cuda):
    """An empty output launches nothing, and no launch is counted; a zero
    contraction launches the CUDA-core kernel, which writes zeros."""
    bf = dict(device=cuda, dtype=torch.bfloat16)
    out, counts = _launched(grouped_gemm, lambda: grouped_gemm(
        torch.zeros(2, 0, 64, **bf), torch.zeros(2, 64, 32, **bf)))
    assert out.shape == (2, 0, 32) and counts == (0, 0)
    out, counts = _launched(grouped_gemm, lambda: grouped_gemm(
        torch.ones(2, 5, 0, **bf), torch.ones(2, 0, 32, **bf)))
    assert counts == (1, 0) and not out.float().abs().max()
    q = torch.zeros(1, 0, 2, 32, **bf)
    out, counts = _launched(flash_attention, lambda: flash_attention(
        q, torch.zeros(1, 4, 2, 32, **bf), torch.zeros(1, 4, 2, 32, **bf)))
    assert out.shape == (1, 0, 2, 32) and counts == (0, 0)


@pytest.mark.cuda
def test_wrappers_reject_cpu_tensors_for_cuda(cuda):
    x = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError):
        grouped_gemm(x, torch.zeros(1, 8, 8))


def _bwd_counts():
    return (flash_attention_bwd.launches, grouped_gemm.bwd_launches,
            grouped_gemm.bwd_tc_launches, flash_attention_bwd.tc_launches)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,Hq,Hkv,Sq,Skv,D,dtype,causal,window,softcap,variant", [
        (4, 8, 8, 144, 144, 32, BF16, False, 0, 0.0, "tc"),   # the trunk's
        (2, 4, 4, 144, 144, 32, BF16, True, 0, 0.0, "tc"),
        (2, 4, 4, 100, 100, 16, BF16, False, 0, 30.0, "tc"),
        (2, 4, 4, 97, 131, 64, BF16, True, 0, 30.0, "tc"),    # Sq < Skv
        (1, 2, 2, 131, 97, 64, BF16, False, 0, 0.0, "tc"),    # Sq > Skv
        (1, 2, 2, 256, 256, 32, BF16, False, 0, 0.0, "tc"),   # longest short
        (2, 8, 2, 1001, 1001, 64, BF16, True, 0, 0.0, "tc"),  # ragged GQA
        (1, 4, 2, 130, 130, 128, BF16, True, 0, 30.0, "tc"),
        (2, 8, 2, 2048, 2048, 64, BF16, True, 0, 0.0, "tc"),  # TinyLlama's
        (1, 4, 4, 1024, 1024, 128, BF16, True, 0, 30.0, "tc"),
        (1, 8, 2, 300, 157, 64, BF16, False, 0, 0.0, "tc"),   # GQA, Sq > Skv
        (1, 8, 2, 157, 300, 64, BF16, False, 0, 0.0, "tc"),   # GQA, Sq < Skv
        (2, 4, 2, 300, 300, 16, BF16, True, 0, 0.0, "tc"),
        (2, 4, 4, 300, 300, 32, BF16, False, 0, 20.0, "tc"),
        (2, 8, 2, 97, 131, 64, FP32, True, 0, 30.0, "simt"),
        (3, 4, 4, 24, 24, 16, FP32, False, 0, 0.0, "simt"),
        (1, 2, 1, 131, 97, 128, FP32, False, 0, 0.0, "simt"),
        # Gemma-3's local training layer: streaming, GQA 32/16, D = 128
        (1, 32, 16, 2048, 2048, 128, BF16, True, 1024, 0.0, "tc"),
        # a window no multiple of 64 at a ragged S, GQA 8/4, D = 64
        (2, 8, 4, 2050, 2050, 64, BF16, True, 1000, 0.0, "tc"),
        # a window under one tile: the band's edge inside every tile
        (1, 4, 2, 300, 300, 128, BF16, True, 48, 0.0, "tc"),
        (1, 8, 2, 300, 300, 64, BF16, False, 70, 0.0, "tc"),  # the band only
        (2, 4, 4, 144, 144, 64, BF16, True, 64, 0.0, "tc"),   # short form
        (2, 4, 4, 144, 144, 32, BF16, False, 40, 30.0, "tc"),
        (1, 4, 2, 300, 300, 64, FP32, True, 100, 0.0, "simt"),
        (1, 2, 2, 200, 200, 128, FP32, True, 48, 30.0, "simt"),
        # Qwen1.5-4B's training layer: streaming, MHA 20/20, D = 128
        (2, 20, 20, 2048, 2048, 128, BF16, True, 0, 0.0, "tc"),
        # Qwen2-VL's training layer: streaming, GQA 28/4 (a group of 7, one
        # share a kv head), D = 128; ragged
        (2, 28, 4, 2048, 2048, 128, BF16, True, 0, 0.0, "tc"),
        (1, 28, 4, 1001, 1001, 128, BF16, True, 0, 0.0, "tc"),
        # Command-R's training layer: streaming, GQA 64/8 (a group of 8),
        # D = 128; one share at 2 x 2048, two at 1 x 2048, four ragged
        (2, 64, 8, 2048, 2048, 128, BF16, True, 0, 0.0, "tc"),
        (1, 64, 8, 2048, 2048, 128, BF16, True, 0, 0.0, "tc"),
        (1, 64, 8, 1001, 1001, 128, BF16, True, 0, 0.0, "tc"),
    ])
def test_flash_backward_matches_plain(cuda, B, Hq, Hkv, Sq, Skv, D, dtype,
                                      causal, window, softcap, variant):
    """Through autograd: the forward kernel keeps each row's log-sum-exp
    (checked against the plain one), and the backward kernel's dq, dk, dv
    match ``flash_attention_bwd_ref`` on the forward's out, one backward
    launch per call, of the variant named; with a window in every form."""
    q, k, v, do = (torch.from_numpy(a).to(cuda, TORCH[dtype]) for a in
                   _normal(Sq + D, (B, Sq, Hq, D), (B, Skv, Hkv, D),
                           (B, Skv, Hkv, D), (B, Sq, Hq, D)))
    opts = dict(causal=causal, window=window, softcap=softcap)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = _bwd_counts()
    out = flash_attention(*leaves, **opts)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    after = _bwd_counts()
    assert (after[0] - before[0], after[3] - before[3]) == \
        (1, int(variant == "tc"))
    lse = fa_ops._launch(q, k, v, fa_ops._flash_variant(q, k, v),
                         scale=D ** -0.5, lse=True, **opts)[1]
    torch.testing.assert_close(lse, flash_attention_lse_ref(q, k, **opts),
                               atol=1e-4, rtol=1e-5)
    refs = flash_attention_bwd_ref(q, k, v, out.detach(), lse, do, **opts)
    atol, rtol = (3e-5, 1e-5) if dtype == FP32 else (2e-2, 2e-2)
    for name, g, r in zip("qkv", grads, refs):
        assert g.dtype == r.dtype and g.shape == r.shape
        torch.testing.assert_close(g.float(), r.float(), atol=atol,
                                   rtol=rtol, msg=f"d{name}")


def _flash_bwd_inputs(cuda, B, Hq, Hkv, S, D, causal, seed=0, window=0):
    """bf16 q, k, v, dO and the forward kernel's out and lse."""
    q, k, v, do = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in
                   _normal(seed, (B, S, Hq, D), (B, S, Hkv, D),
                           (B, S, Hkv, D), (B, S, Hq, D)))
    o, lse = fa_ops._launch(q, k, v, "tc", causal=causal, window=window,
                            softcap=0.0, scale=D ** -0.5, lse=True)
    return q, k, v, o, lse, do


@pytest.mark.cuda
@pytest.mark.parametrize("B,Hq,Hkv,S,D,causal,window,form", [
    (2, 8, 2, 1001, 64, True, 0, "wg"),       # q heads shared among blocks
    (1, 4, 4, 300, 128, False, 0, "wg"),
    (4, 8, 8, 144, 32, False, 0, "short"),
    (2, 32, 16, 2048, 128, True, 1024, "wg"),       # Gemma-3's local layer
    (1, 16, 2, 777, 64, True, 100, "wg"),           # windowed, 8 shares
    (4, 8, 8, 144, 32, True, 48, "short"),
    (2, 28, 4, 2048, 128, True, 0, "wg"),           # Qwen2-VL's, group 7
    (2, 64, 8, 2048, 128, True, 0, "wg"),           # Command-R's, group 8
    (1, 64, 8, 2048, 128, True, 0, "wg"),           # its two shares
    (1, 8, 2, 300, 32, True, 0, "stream"),          # the mma.sync form
])
def test_flash_backward_bit_identical(cuda, B, Hq, Hkv, S, D, causal, window,
                                      form):
    """Repeated backward calls on the same inputs give the same bits: dK
    and dV sum over a kv head's q heads, and over the blocks that share
    them, in a fixed order, with no atomics; with a window too."""
    assert fa_ops.bwd_tc_form(S, S, Hq, Hkv, D) == form
    q, k, v, o, lse, do = _flash_bwd_inputs(cuda, B, Hq, Hkv, S, D, causal,
                                            window=window)
    opts = dict(causal=causal, window=window)
    first = flash_attention_bwd(q, k, v, o, lse, do, **opts)
    for _ in range(2):
        again = flash_attention_bwd(q, k, v, o, lse, do, **opts)
        for name, a, b in zip("qkv", first, again):
            assert torch.equal(a, b), f"d{name} differs between calls"


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,splits", [(2, 2048, 1), (1, 2048, 2),
                                        (1, 1001, 4)])
def test_flash_backward_shares_at_command_r(cuda, B, S, splits):
    """Command-R's 64 q heads over 8 kv heads of 128 on an H100 SXM's 132
    SMs, in the Hopper form (128 kv rows a dkdv block): ``bwd_splits``
    gives one share a kv head at its 2 x 2048 training batch (256 blocks,
    each summing 8 q heads), two at a batch of 1 and four at a ragged 1 x
    1001; the wrapper's own count gives the same bits as that count
    named."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert sms == 132 and fa_ops.bwd_splits(B, S, 8, 8, sms) == splits
    assert fa_ops.bwd_tc_form(S, S, 64, 8, 128) == "wg"
    q, k, v, o, lse, do = _flash_bwd_inputs(cuda, B, 64, 8, S, 128, True)
    opts = dict(causal=True, softcap=0.0, scale=128 ** -0.5)
    auto = fa_ops._launch_bwd(q, k, v, o, lse, do.contiguous(), "tc", **opts)
    named = fa_ops._launch_bwd(q, k, v, o, lse, do.contiguous(), "tc",
                               splits=splits, **opts)
    for name, a, b in zip("qkv", auto, named):
        assert torch.equal(a, b), f"d{name}"


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_flash_backward_split_counts(cuda, splits):
    """The streaming form's dkdv blocks at every split count of a group of
    8 q heads (causal, ragged): dq, dk, dv within 2e-2 of the plain
    backward whether each block keeps its kv head's whole group or writes
    fp32 partials that the last pass sums."""
    q, k, v, o, lse, do = _flash_bwd_inputs(cuda, 2, 16, 2, 777, 64, True)
    grads = fa_ops._launch_bwd(q, k, v, o, lse, do.contiguous(), "tc",
                               causal=True, softcap=0.0, scale=0.125,
                               splits=splits)
    refs = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=True)
    for name, g, r in zip("qkv", grads, refs):
        torch.testing.assert_close(g.float(), r.float(), atol=2e-2,
                                   rtol=2e-2, msg=f"d{name}")


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_flash_backward_split_counts_with_a_window(cuda, splits):
    """The streaming form's dkdv blocks at every split count of a group of
    8 q heads under a window of 100 (its band's edges inside the tiles):
    dq, dk, dv within 2e-2 of the plain backward."""
    q, k, v, o, lse, do = _flash_bwd_inputs(cuda, 1, 16, 2, 777, 64, True,
                                            window=100)
    grads = fa_ops._launch_bwd(q, k, v, o, lse, do.contiguous(), "tc",
                               causal=True, window=100, softcap=0.0,
                               scale=0.125, splits=splits)
    refs = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=True,
                                   window=100)
    for name, g, r in zip("qkv", grads, refs):
        torch.testing.assert_close(g.float(), r.float(), atol=2e-2,
                                   rtol=2e-2, msg=f"d{name}")


@pytest.mark.cuda
def test_flash_backward_strided_views(cuda):
    """q, k, v as views of one fused (B, S, 3, H, D) tensor, as a fused qkv
    projection gives them: the gradient lands in the fused tensor."""
    a, do = _normal(6, (2, 77, 3, 4, 64), (2, 77, 4, 64))
    t = torch.from_numpy(a).to(cuda, torch.bfloat16).requires_grad_(True)
    do = torch.from_numpy(do).to(cuda, torch.bfloat16)
    q, k, v = t.unbind(2)
    out = flash_attention(q, k, v, causal=True)
    before = _bwd_counts()
    g, = torch.autograd.grad(out, t, do)
    torch.cuda.synchronize()
    assert _bwd_counts()[3] == before[3] + 1          # on the tensor cores
    lse = flash_attention_lse_ref(q.detach(), k.detach(), causal=True)
    refs = flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                                   out.detach(), lse, do, causal=True)
    torch.testing.assert_close(g.float(), torch.stack(refs, 2).float(),
                               atol=2e-2, rtol=2e-2)


# ------------------------------------------- the tensor-core forms by name
def _form_counts():
    return (flash_attention.launches, flash_attention.tc_launches,
            flash_attention.wg_launches, flash_attention_bwd.launches,
            flash_attention_bwd.tc_launches, flash_attention_bwd.wg_launches)


# (B, Hq, Hkv, S, D, causal, window, softcap): each LM layer the port runs
# flash at, ragged at 1100, under a window with softcap
FORM_CASES = [
    (2, 32, 4, 2048, 64, True, 0, 0.0),      # TinyLlama
    (2, 16, 16, 2048, 128, True, 0, 0.0),    # Qwen2-MoE
    (2, 20, 20, 2048, 128, True, 0, 0.0),    # Qwen1.5-4B
    (2, 32, 16, 2048, 128, True, 1024, 0.0),  # Gemma-3 local
    (2, 32, 16, 2048, 128, True, 0, 0.0),    # Gemma-3 global
    (2, 64, 8, 2048, 128, True, 0, 0.0),     # Command-R
    (2, 28, 4, 2048, 128, True, 0, 0.0),     # Qwen2-VL
    (1, 28, 4, 1100, 128, True, 0, 0.0),     # ragged
    (2, 32, 16, 1100, 128, True, 1024, 0.0),
    (2, 8, 2, 1100, 64, True, 300, 30.0),    # a window with softcap
    (1, 8, 2, 333, 64, False, 0, 30.0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["wg", "stream"])
@pytest.mark.parametrize("B,Hq,Hkv,S,D,causal,window,softcap", FORM_CASES)
def test_flash_forms_match_plain(cuda, B, Hq, Hkv, S, D, causal, window,
                                 softcap, form):
    """The Hopper streaming form (``wg``: wgmma fed by TMA rings) and the
    mma.sync streaming form it replaces, each named, forward (out and lse)
    and backward against the plain versions at every LM layer shape, 2e-2
    in bf16; the wrappers' own choice at these shapes is the Hopper form,
    counted in ``wg_launches`` both ways."""
    q, k, v, o, lse, do = _flash_bwd_inputs(cuda, B, Hq, Hkv, S, D, causal,
                                            seed=S + D, window=window)
    opts = dict(causal=causal, window=window, softcap=softcap)
    run = dict(opts, scale=D ** -0.5)
    out, lse = fa_ops._launch(q, k, v, "tc", lse=True, form=form, **run)
    torch.testing.assert_close(out.float(), flash_attention_ref(
        q, k, v, **opts).float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, flash_attention_lse_ref(q, k, **opts),
                               atol=1e-4, rtol=1e-5)
    grads = fa_ops._launch_bwd(q, k, v, out, lse, do.contiguous(), "tc",
                               form=form, **run)
    refs = flash_attention_bwd_ref(q, k, v, out, lse, do, **opts)
    for name, g, r in zip("qkv", grads, refs):
        torch.testing.assert_close(g.float(), r.float(), atol=2e-2,
                                   rtol=2e-2, msg=f"d{name}")
    assert fa_ops.fwd_form(S, S, D) == "wg"
    assert fa_ops.bwd_tc_form(S, S, Hq, Hkv, D) == "wg"
    before = _form_counts()
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    torch.autograd.grad(flash_attention(*leaves, **opts), leaves, do)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_form_counts(), before)) == \
        (1, 1, 1, 1, 1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["wg", "stream"])
def test_flash_forms_on_fused_views(cuda, form):
    """q, k, v as views of one fused (B, S, 3, H, D) tensor read in place
    by both streaming forms (the Hopper form's TMA maps take the views'
    strides), forward and backward, at S = 300 past the short forms."""
    a, do = _normal(7, (2, 300, 3, 4, 64), (2, 300, 4, 64))
    q, k, v = torch.from_numpy(a).to(cuda, torch.bfloat16).unbind(2)
    do = torch.from_numpy(do).to(cuda, torch.bfloat16)
    run = dict(causal=True, window=0, softcap=0.0, scale=0.125)
    out, lse = fa_ops._launch(q, k, v, "tc", lse=True, form=form, **run)
    torch.testing.assert_close(out.float(), flash_attention_ref(
        q, k, v, causal=True).float(), atol=2e-2, rtol=2e-2)
    grads = fa_ops._launch_bwd(q, k, v, out, lse, do, "tc", form=form, **run)
    refs = flash_attention_bwd_ref(q, k, v, out, lse, do, causal=True)
    for name, g, r in zip("qkv", grads, refs):
        torch.testing.assert_close(g.float(), r.float(), atol=2e-2,
                                   rtol=2e-2, msg=f"d{name}")


@pytest.mark.cuda
@pytest.mark.parametrize("B,Hq,Hkv,S,D,window,splits", [
    (2, 28, 4, 2048, 128, 0, 1), (2, 28, 4, 2048, 128, 0, 4),  # Qwen2-VL
    (2, 32, 4, 2048, 64, 0, 1), (2, 32, 4, 2048, 64, 0, 3),    # TinyLlama
    (1, 16, 2, 777, 64, 100, 5),
])
def test_flash_backward_wg_bit_identical(cuda, B, Hq, Hkv, S, D, window,
                                         splits):
    """The Hopper form's backward, named, gives the same bits over
    repeated calls at one share and at more (uneven shares of the group
    included: 7 heads in 4 shares, 8 in 3 or 5), and within 2e-2 of the
    plain backward."""
    q, k, v, o, lse, do = _flash_bwd_inputs(cuda, B, Hq, Hkv, S, D, True,
                                            window=window)
    run = dict(causal=True, window=window, softcap=0.0, scale=D ** -0.5)
    first = fa_ops._launch_bwd(q, k, v, o, lse, do, "tc", form="wg",
                               splits=splits, **run)
    again = fa_ops._launch_bwd(q, k, v, o, lse, do, "tc", form="wg",
                               splits=splits, **run)
    for name, a, b in zip("qkv", first, again):
        assert torch.equal(a, b), f"d{name} differs between calls"
    refs = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=True,
                                   window=window)
    for name, g, r in zip("qkv", first, refs):
        torch.testing.assert_close(g.float(), r.float(), atol=2e-2,
                                   rtol=2e-2, msg=f"d{name}")


@pytest.mark.cuda
@pytest.mark.parametrize("B,Hq,Hkv,S,D,form", [
    (2, 8, 8, 144, 32, "short"), (1, 8, 2, 300, 32, "stream"),
    (1, 8, 2, 300, 64, "wg"), (1, 4, 4, 128, 64, "short"),
])
def test_flash_counters_show_the_form(cuda, B, Hq, Hkv, S, D, form):
    """Each launch through the wrappers counts its form: ``wg_launches``
    rises with ``tc_launches`` where the Hopper form runs, both ways, and
    not at the short or mma.sync forms; a form the shapes do not take is
    refused by the C entry, with nothing run in its place."""
    q, k, v, o, lse, do = _flash_bwd_inputs(cuda, B, Hq, Hkv, S, D, True)
    before = _form_counts()
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    torch.autograd.grad(flash_attention(*leaves, causal=True), leaves, do)
    torch.cuda.synchronize()
    wg = int(form == "wg")
    assert tuple(a - b for a, b in zip(_form_counts(), before)) == \
        (1, 1, wg, 1, 1, wg)
    if D < 64:
        with pytest.raises(RuntimeError):
            fa_ops._launch(q, k, v, "tc", causal=True, window=0, softcap=0.0,
                           scale=D ** -0.5, form="wg")


# ------------------------------------- flash at the head dims 48 to 112
# (B, Hq, Hkv, S, causal, window, softcap): GQA at a ragged S past the
# short forms, causal; MHA non-causal under a window with softcap; MHA at
# S = 64, whose q, K and V fit the forward's short form at every D
NEW_D_CASES = [
    (2, 4, 2, 333, True, 0, 0.0),
    (1, 4, 4, 200, False, 64, 30.0),
    (2, 4, 4, 64, True, 0, 0.0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("D", [48, 80, 96, 112])
@pytest.mark.parametrize("B,Hq,Hkv,S,causal,window,softcap", NEW_D_CASES)
def test_flash_forms_at_new_head_dims(cuda, B, Hq, Hkv, S, causal, window,
                                      softcap, D):
    """The tensor-core variant at D = 48, 80, 96 and 112 in every form the
    shapes take, each named (the Hopper form on its D = 64 or 128 kernels,
    the columns past D read as zeros; the mma.sync forms at D itself):
    forward (out and lse) and backward against the plain versions, 2e-2 in
    bf16, and the wrappers' own choice, counted through autograd."""
    q, k, v, o, lse, do = _flash_bwd_inputs(cuda, B, Hq, Hkv, S, D, causal,
                                            seed=S + D, window=window)
    opts = dict(causal=causal, window=window, softcap=softcap)
    run = dict(opts, scale=D ** -0.5)
    ref = flash_attention_ref(q, k, v, **opts).float()
    lse_ref = flash_attention_lse_ref(q, k, **opts)
    fwd_forms = ["stream", "wg"] + ["short"] * (fa_ops.fwd_form(S, S, D)
                                                == "short")
    for form in fwd_forms:
        out, lse = fa_ops._launch(q, k, v, "tc", lse=True, form=form, **run)
        torch.testing.assert_close(out.float(), ref, atol=2e-2, rtol=2e-2,
                                   msg=f"{form} out")
        torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5,
                                   msg=f"{form} lse")
    out = fa_ops._launch(q, k, v, "tc", **run)
    refs = flash_attention_bwd_ref(q, k, v, out, lse_ref, do, **opts)
    bwd_forms = ["stream", "wg"] + ["short"] * (
        fa_ops.bwd_tc_form(S, S, Hq, Hkv, D) == "short")
    for form in bwd_forms:
        grads = fa_ops._launch_bwd(q, k, v, out, lse_ref, do.contiguous(),
                                   "tc", form=form, **run)
        for name, g, r in zip("qkv", grads, refs):
            assert g.shape == r.shape
            torch.testing.assert_close(g.float(), r.float(), atol=2e-2,
                                       rtol=2e-2, msg=f"{form} d{name}")
    before = _form_counts()
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    torch.autograd.grad(flash_attention(*leaves, **opts), leaves, do)
    torch.cuda.synchronize()
    wg = int(fa_ops.fwd_form(S, S, D) == "wg")
    bwd_wg = int(fa_ops.bwd_tc_form(S, S, Hq, Hkv, D) == "wg")
    assert tuple(a - b for a, b in zip(_form_counts(), before)) == \
        (1, 1, wg, 1, 1, bwd_wg)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [80, 112])
@pytest.mark.parametrize("splits", [2, 3])
def test_flash_backward_shares_at_new_head_dims(cuda, D, splits):
    """The Hopper backward at D = 80 and 112 writing fp32 partials that
    the last pass sums (a group of 4 in 2 and 3 shares): within 2e-2 of
    the plain backward, and the same bits over a repeated call."""
    q, k, v, o, lse, do = _flash_bwd_inputs(cuda, 1, 8, 2, 300, D, True)
    run = dict(causal=True, window=0, softcap=0.0, scale=D ** -0.5)
    first = fa_ops._launch_bwd(q, k, v, o, lse, do, "tc", form="wg",
                               splits=splits, **run)
    again = fa_ops._launch_bwd(q, k, v, o, lse, do, "tc", form="wg",
                               splits=splits, **run)
    refs = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=True)
    for name, a, b, r in zip("qkv", first, again, refs):
        assert torch.equal(a, b), f"d{name} differs between calls"
        torch.testing.assert_close(a.float(), r.float(), atol=2e-2,
                                   rtol=2e-2, msg=f"d{name}")


@pytest.mark.cuda
@pytest.mark.parametrize("D,dtype", [(72, BF16), (72, FP32), (80, FP32),
                                     (112, FP32), (8, FP32), (40, BF16),
                                     (100, FP32)])
def test_flash_cuda_cores_at_any_head_dim(cuda, D, dtype):
    """The CUDA-core variant at head dims off its 16, 32, 64 and 128 (run
    on the next of those, the columns past D masked): a bf16 D that the
    tensor cores do not take (72, 40) runs it too. Forward and backward
    through autograd against the plain versions, causal GQA at a ragged S
    with softcap, fp32 3e-5 absolute and 1e-5 relative, bf16 2e-2."""
    q, k, v, do = (torch.from_numpy(a).to(cuda, TORCH[dtype]) for a in
                   _normal(D, (1, 150, 4, D), (1, 150, 2, D),
                           (1, 150, 2, D), (1, 150, 4, D)))
    assert fa_ops._flash_variant(q, k, v) == "simt"
    opts = dict(causal=True, window=0, softcap=20.0)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = _form_counts()
    out = flash_attention(*leaves, **opts)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_form_counts(), before)) == \
        (1, 0, 0, 1, 0, 0)
    atol, rtol = (3e-5, 1e-5) if dtype == FP32 else (2e-2, 2e-2)
    torch.testing.assert_close(out.float(), flash_attention_ref(
        q, k, v, **opts).float(), atol=atol, rtol=rtol)
    lse = fa_ops._launch(q, k, v, "simt", scale=D ** -0.5, lse=True,
                         **opts)[1]
    torch.testing.assert_close(lse, flash_attention_lse_ref(q, k, **opts),
                               atol=1e-4, rtol=1e-5)
    refs = flash_attention_bwd_ref(q, k, v, out.detach(), lse, do, **opts)
    for name, g, r in zip("qkv", grads, refs):
        assert g.shape == r.shape
        torch.testing.assert_close(g.float(), r.float(), atol=atol,
                                   rtol=rtol, msg=f"d{name}")


@pytest.mark.cuda
def test_flash_refuses_head_dims_past_128(cuda):
    """A head dim past 128 raises before any launch, naming the bound."""
    q = torch.zeros(1, 8, 2, 136, device=cuda, dtype=torch.bfloat16)
    n = flash_attention.launches
    with pytest.raises(ValueError, match="1 to 128"):
        flash_attention(q, q, q)
    assert flash_attention.launches == n


@pytest.mark.cuda
@pytest.mark.parametrize("E,C,d,f,dtype,layout", [
    (10, 9216, 256, 256, BF16, "plain"),     # the trunk's q, k, v, o
    (10, 9216, 256, 1024, BF16, "plain"),    # its ffn in
    (10, 9216, 1024, 256, BF16, "plain"),    # its ffn out
    (3, 1001, 200, 136, BF16, "plain"),      # ragged C (dW's contraction)
    (2, 300, 64, 96, BF16, "plain"),         # dW's rows in one 64-row box
    (10, 2000, 256, 256, BF16, "rows"),      # x stored (C, E, d)
    (3, 1001, 200, 136, FP32, "plain"),      # on the CUDA cores
])
def test_grouped_gemm_backward_matches_plain(cuda, E, C, d, f, dtype, layout):
    """Through autograd: dX = dY.W^T and dW = X^T.dY, two launches of the
    GEMM kernel (the tensor cores in bf16, dW reading x in place through
    the transposed mode), against ``grouped_gemm_bwd_ref``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x, w, dy = (torch.from_numpy(a).to(cuda, TORCH[dtype]) for a in _normal(
        C + d, (E, C, d), (E, d, f), (E, C, f), scale=d ** -0.25))
    if layout == "rows":
        x = x.transpose(0, 1).contiguous().transpose(0, 1)
    leaves = [x.clone().requires_grad_(True), w.clone().requires_grad_(True)]
    assert leaves[0].stride() == x.stride()    # clone keeps the layout
    before = _bwd_counts()
    dx, dw = torch.autograd.grad(grouped_gemm(*leaves), leaves, dy)
    torch.cuda.synchronize()
    after = _bwd_counts()
    assert (after[1] - before[1], after[2] - before[2]) == \
        (2, 2 if dtype == BF16 else 0)
    rdx, rdw = grouped_gemm_bwd_ref(x, w, dy)
    tol = 2e-5 if dtype == FP32 else 2e-2
    torch.testing.assert_close(dx.float(), rdx.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(dw.float(), rdw.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("E,C,d,f,layout", [
    (10, 9216, 256, 256, "plain"),    # the trunk's q, k, v, o: 6 splits
    (3, 1001, 200, 136, "plain"),     # 2 splits, the second ragged
    (3, 1025, 200, 136, "plain"),     # a last k-step of one row
    (10, 2000, 256, 256, "dy_rows"),  # dY stored (C, E, f)
    (10, 2000, 256, 256, "rows"),     # x stored (C, E, d)
    (2, 300, 64, 96, "plain"),        # too short to split
    (60, 342, 2048, 2816, "plain"),   # Qwen2-MoE's wi at 2 x 2048 tokens
    (60, 342, 1408, 2048, "plain"),   # its wo
    # DeepSeek-V2's wi and wo at 1 x 2048 tokens: 96 rows an expert, a
    # k-tail of 32 in dW's contraction
    (160, 96, 5120, 3072, "plain"),
    (160, 96, 1536, 5120, "plain"),
])
def test_grouped_gemm_fused_backward(cuda, E, C, d, f, layout):
    """The fused backward kernel: one call a bf16 projection through
    autograd, dX and dW within 2e-2 of the plain backward, dW split along
    C as ``split_count`` says and the same bit for bit over repeated calls
    (partials summed in a fixed order), and each product alone equal to
    the same product of the call that computes both."""
    from repro_torch.kernels.moe_gemm import ops
    x, w, dy = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in _normal(
        C + d + f, (E, C, d), (E, d, f), (E, C, f), scale=d ** -0.25))
    if layout == "rows":
        x = x.transpose(0, 1).contiguous().transpose(0, 1)
    if layout == "dy_rows":
        dy = dy.transpose(0, 1).contiguous().transpose(0, 1)
    assert ops._bwd_variant(x, w, dy) == "tc"
    leaves = [x.clone().requires_grad_(True), w.clone().requires_grad_(True)]
    calls, before = grouped_gemm.bwd_fused_calls, _bwd_counts()
    out = grouped_gemm(*leaves)
    dx, dw = torch.autograd.grad(out, leaves, dy)
    torch.cuda.synchronize()
    after = _bwd_counts()
    assert grouped_gemm.bwd_fused_calls - calls == 1
    assert (after[1] - before[1], after[2] - before[2]) == (2, 2)
    rdx, rdw = grouped_gemm_bwd_ref(x, w, dy)
    # by groups of experts: at E = 160 one fp32 copy of dW is 10 GB
    for e in range(0, E, 16):
        for got, ref in ((dx, rdx), (dw, rdw)):
            torch.testing.assert_close(got[e:e + 16].float(),
                                       ref[e:e + 16].float(), atol=2e-2,
                                       rtol=2e-2)
    del rdx, rdw
    for _ in range(2):
        again = ops._launch_bwd(x, w, dy, True, True)
        torch.cuda.synchronize()
        assert torch.equal(again[0], dx) and torch.equal(again[1], dw)
    assert torch.equal(ops._launch_bwd(x, w, dy, True, False)[0], dx)
    assert torch.equal(ops._launch_bwd(x, w, dy, False, True)[1], dw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [FP32, BF16])
def test_train_on_kernel_path_matches_plain(cuda, monkeypatch, dtype):
    """One reduced moe DQN loss and gradient with the kernels against the
    same on the card's plain path (the model's flash and GEMM calls sent
    to the plain versions): every leaf within 1e-4 (fp32) or 2e-2 (bf16) of
    its scale, one flash backward and 12 GEMM backward launches a layer."""
    import dataclasses
    from repro_torch.convert import tree_map
    from repro_torch.core import DQNConfig, DQNLearner, FoundationConfig
    from repro_torch.core.dqn import value_and_grad
    from repro_torch.models import attention, layers
    fc = FoundationConfig(kind="moe").reduced()
    fc = dataclasses.replace(fc, trunk=fc.trunk.replace(compute_dtype=dtype))
    learner = DQNLearner(fc, DQNConfig(), seed=0, device=cuda)
    rng = np.random.default_rng(0)
    batch = {"s": torch.from_numpy(rng.normal(size=(4, fc.history, 40))
                                   .astype(np.float32)).to(cuda),
             "a": torch.from_numpy(rng.integers(0, 2, 4)).to(cuda),
             "r": torch.from_numpy(rng.normal(size=4).astype(np.float32))
             .to(cuda)}
    before = _bwd_counts()
    loss, grads = value_and_grad(learner.loss, learner.params, batch)
    torch.cuda.synchronize()
    L = fc.trunk.n_layers
    after = _bwd_counts()
    assert (after[0] - before[0], after[1] - before[1]) == (L, 12 * L)
    assert after[3] - before[3] == (L if dtype == BF16 else 0)
    monkeypatch.setattr(attention, "flash_attention",
                        lambda q, k, v, device=None, **kw:
                        flash_attention_ref(q, k, v, **kw))
    for mod in (attention, layers):
        monkeypatch.setattr(mod, "grouped_gemm", lambda x, w, device=None:
                            grouped_gemm_ref(x, w))
    ploss, pgrads = value_and_grad(learner.loss, learner.params, batch)
    tol = 1e-4 if dtype == FP32 else 2e-2
    torch.testing.assert_close(loss, ploss, atol=0, rtol=tol)
    flat, pflat = [], []
    tree_map(flat.append, grads)
    tree_map(pflat.append, pgrads)
    for i, (g, pg) in enumerate(zip(flat, pflat)):
        assert float((g - pg).abs().max()) <= tol * max(
            float(pg.abs().max()), 1e-30), i


def _within(got, ref, tol, what):
    """max|got - ref| within ``tol`` of ref's largest magnitude."""
    got, ref = got.float(), ref.float()
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    assert err <= tol * max(scale, 1e-30), f"{what}: {err} (scale {scale})"


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d,dtype,gemma", [
    (1024, 2048, BF16, False), (4096, 4096, BF16, True), (37, 2048, FP32, True),
    (33, 300, BF16, False), (37, 300, FP32, False),
    (4096, 5376, BF16, True),        # Gemma-3's block norms: 672 vectors
    (2048, 1536, BF16, False),       # DeepSeek-V2's q_norm: 192 vectors
    (2048, 512, BF16, False),        # its kv_norm: 64 vectors
    (4096, 7168, BF16, False),       # Zamba2-7B's out_norm: 896 vectors,
    (4096, 7168, BF16, True),        # two warps a row
    (37, 7176, BF16, False),         # 897 vectors: past the vec kernels
    (37, 3584, FP32, False),         # fp32 at Zamba2-7B's d_model: 896
    (4096, 3584, FP32, False),       # vectors of 4, two warps a row
    (37, 3076, FP32, True),          # 769 vectors, the fewest for two
    (37, 6152, BF16, False)])        # warps, in fp32 and in bf16
def test_rmsnorm_backward_through_autograd(cuda, rows, d, dtype, gemma):
    """The RMSNorm Function's backward kernel against ``rmsnorm_bwd_ref``
    (fp32 1e-4, bf16 2e-2 of each gradient's scale; one rounding after sums
    in other orders), with one forward and one backward launch counted and
    dx and dw the same bit for bit over a second call."""
    x, w, dy = (torch.from_numpy(a).to(cuda, TORCH[dtype]) for a in _normal(
        rows + d, (rows, d), (d,), (rows, d)))
    w = w.float()
    x.requires_grad_(True)
    w.requires_grad_(True)
    n, nb = rmsnorm.launches, rmsnorm.bwd_launches
    nv = rmsnorm.bwd_vec_launches
    dx, dw = torch.autograd.grad(rmsnorm(x, w, gemma=gemma), (x, w), dy)
    torch.cuda.synchronize()
    assert (rmsnorm.launches - n, rmsnorm.bwd_launches - nb) == (1, 1)
    # vec wherever d is a multiple of 16 bytes of x's elements, up to
    # MAX_VECS of them
    per = 16 // x.element_size()
    vec = d % per == 0 and d // per <= norm_ops.MAX_VECS
    assert rmsnorm.bwd_vec_launches - nv == int(vec)
    assert dx.dtype == x.dtype and dw.dtype == w.dtype
    rdx, rdw = rmsnorm_bwd_ref(x.detach(), w.detach(), dy, gemma=gemma)
    tol = 1e-4 if dtype == FP32 else 2e-2
    _within(dx, rdx, tol, "dx")
    _within(dw, rdw, tol, "dw")
    again = rmsnorm_bwd(x.detach(), w.detach(), dy, gemma=gemma)
    assert torch.equal(again[0], dx) and torch.equal(again[1], dw)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d,gemma", [
    (4096, 7168, False), (4096, 7168, True),   # 896 vectors: two warps
    (37, 7168, False), (4096, 4096, False)])   # and 512, one warp
def test_rmsnorm_backward_bf16_weight(cuda, rows, d, gemma):
    """The vec backward on bf16 rows with a bf16 w (dw rounded to bf16
    once), against ``rmsnorm_bwd_ref`` (2e-2 of each gradient's scale),
    one vec backward launch counted, and dx and dw the same bit for bit
    over a second call."""
    x, w, dy = (torch.from_numpy(a).to(cuda, torch.bfloat16)
                for a in _normal(rows + d + 1, (rows, d), (d,), (rows, d)))
    w = (1.0 + 0.1 * w.float()).to(torch.bfloat16)
    x.requires_grad_(True)
    w.requires_grad_(True)
    nb, nv = rmsnorm.bwd_launches, rmsnorm.bwd_vec_launches
    dx, dw = torch.autograd.grad(rmsnorm(x, w, gemma=gemma), (x, w), dy)
    torch.cuda.synchronize()
    assert (rmsnorm.bwd_launches - nb, rmsnorm.bwd_vec_launches - nv) == (
        1, 1)
    assert dx.dtype == dw.dtype == torch.bfloat16
    rdx, rdw = rmsnorm_bwd_ref(x.detach(), w.detach(), dy, gemma=gemma)
    _within(dx, rdx, 2e-2, "dx")
    _within(dw, rdw, 2e-2, "dw")
    again = rmsnorm_bwd(x.detach(), w.detach(), dy, gemma=gemma)
    assert torch.equal(again[0], dx) and torch.equal(again[1], dw)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,chunk,dtype,init", [
    ((2, 300, 4, 64, 128, 2), 128, BF16, True),    # ragged, groups, states
    ((2, 300, 4, 64, 128, 2), 128, FP32, True),
    ((2, 128, 4, 64, 128, 1), 256, BF16, False),   # one chunk
    ((1, 200, 2, 32, 64, 1), 64, FP32, False),
    ((1, 97, 2, 128, 128, 1), 64, BF16, True),     # P = 128
    ((1, 100, 2, 64, 128, 1), 256, FP32, True),    # one chunk of 100, off 32
    ((1, 250, 4, 64, 128, 2), 100, BF16, True),    # chunks of 100, then 50
    ((2, 40, 8, 16, 16, 1), 16, FP32, True),       # the smoke config's scan
    ((2, 2048, 112, 64, 64, 1), 256, BF16, False),  # Zamba2-7B's layer
    ((1, 300, 112, 64, 64, 1), 256, BF16, True),    # ragged, 112 heads
])
def test_ssd_backward_through_autograd(cuda, shape, chunk, dtype, init):
    """The SSD Function's backward kernel against ``ssd_bwd_ref`` on the
    same inputs, y's and the final state's gradients both given (fp32 1e-4,
    bf16 2e-2 of each gradient's scale), with one forward and one backward
    launch counted and dB, dC, dA and dD the same bit for bit over a second
    call."""
    Bz, S, H, P, N, G = shape
    x, dt, A, B, C, s0, dy, dfin = _normal(
        S + P, (Bz, S, H, P), (Bz, S, H), (H,), (Bz, S, G, N), (Bz, S, G, N),
        (Bz, H, P, N), (Bz, S, H, P), (Bz, H, P, N))
    t = TORCH[dtype]
    x, B, C, dy = (torch.from_numpy(a * s).to(cuda, t) for a, s in
                   ((x, 0.5), (B, 0.3), (C, 0.3), (dy, 1.0)))
    dt = torch.nn.functional.softplus(torch.from_numpy(dt).to(cuda) - 3.0)
    A = -torch.exp(0.3 * torch.from_numpy(A).to(cuda))
    D = torch.ones(H, device=cuda)
    s0 = (0.3 * torch.from_numpy(s0)).to(cuda) if init else None
    dfin = torch.from_numpy(dfin).to(cuda)
    leaves = [v.requires_grad_(True) for v in
              (x, dt, A, B, C, D) + ((s0,) if init else ())]
    n, nb, ntc = ssd.launches, ssd.bwd_launches, ssd.bwd_tc_launches
    y, final = ssd(*leaves[:6], chunk, s0)
    grads = torch.autograd.grad((y, final), leaves, (dy, dfin))
    torch.cuda.synchronize()
    assert (ssd.launches - n, ssd.bwd_launches - nb) == (1, 1)
    # every bf16 case here fits the tc backward's shared memory
    assert ssd.bwd_tc_launches - ntc == int(dtype == BF16)
    args = [v.detach() for v in leaves[:6]]
    init_d = s0.detach() if init else None
    refs = ssd_bwd_ref(*args, chunk, dy, init_d, dfin)
    tol = 1e-4 if dtype == FP32 else 2e-2
    for name, g, r, leaf in zip(("dx", "ddt", "dA", "dB", "dC", "dD",
                                 "dinit"), grads, refs, leaves):
        assert g.dtype == leaf.dtype, name
        _within(g, r, tol, name)
    again = ssd_bwd(*args, chunk, dy, init_d, dfin)
    for i in (2, 3, 4, 5):
        assert torch.equal(again[i], grads[i])


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d,gemma", [
    (4096, 2048, False), (4096, 4096, True), (37, 2048, False),
    (1, 4096, True), (4096, 5376, True), (37, 6144, False),
    (4096, 7168, False), (4096, 7168, True), (37, 7168, False)])
@pytest.mark.parametrize("variant", ["vec", "simt"])
def test_rmsnorm_backward_variants(cuda, rows, d, gemma, variant):
    """Each variant of the RMSNorm backward launched directly on bf16 rows
    with an fp32 w, against ``rmsnorm_bwd_ref`` (2e-2 of each gradient's
    scale), dx and dw the same bit for bit over a second call (7168, 896
    vectors, is Zamba2-7B's out_norm: two warps a row in "vec")."""
    x, w, dy = (torch.from_numpy(a).to(cuda) for a in _normal(
        rows * d, (rows, d), (d,), (rows, d)))
    x, dy = x.to(torch.bfloat16), dy.to(torch.bfloat16)
    w = 1.0 + 0.1 * w
    dx, dw = norm_ops._launch_bwd(x, w, dy, variant, eps=1e-5, gemma=gemma)
    rdx, rdw = rmsnorm_bwd_ref(x, w, dy, eps=1e-5, gemma=gemma)
    _within(dx, rdx, 2e-2, "dx")
    _within(dw, rdw, 2e-2, "dw")
    again = norm_ops._launch_bwd(x, w, dy, variant, eps=1e-5, gemma=gemma)
    assert torch.equal(again[0], dx) and torch.equal(again[1], dw)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,chunk,init", [
    ((2, 2048, 8, 64, 128, 1), 256, False),   # the training shape, 8 heads
    ((8, 128, 4, 64, 128, 1), 256, False),    # one chunk a sequence
    ((2, 300, 8, 64, 128, 2), 256, True),     # ragged, groups, states
    ((1, 250, 4, 64, 128, 2), 100, True),     # chunks of 100, then 50
    ((2, 40, 8, 16, 16, 1), 16, True),        # P = N = chunk = 16
    ((1, 97, 2, 128, 128, 1), 64, True),      # P = 128
    ((2, 2048, 112, 64, 64, 1), 256, False),  # Zamba2-7B's training layer
    ((1, 300, 112, 64, 64, 1), 256, True),    # ragged at its 112 heads
])
@pytest.mark.parametrize("variant", ["tc", "simt"])
def test_ssd_backward_variants(cuda, shape, chunk, init, variant):
    """Each variant of the SSD backward launched directly on bf16 inputs,
    y's and the final state's gradients both given, against ``ssd_bwd_ref``
    (2e-2 of each gradient's scale), dx, dB, dC, dA and dD the same bit for
    bit over a second call."""
    Bz, S, H, P, N, G = shape
    x, dt, A, B, C, s0, dy, dfin = _normal(
        S + P + N, (Bz, S, H, P), (Bz, S, H), (H,), (Bz, S, G, N),
        (Bz, S, G, N), (Bz, H, P, N), (Bz, S, H, P), (Bz, H, P, N))
    x, B, C, dy = (torch.from_numpy(a * s).to(cuda, torch.bfloat16)
                   for a, s in ((x, 0.5), (B, 0.3), (C, 0.3), (dy, 1.0)))
    dt = torch.nn.functional.softplus(torch.from_numpy(dt).to(cuda) - 3.0)
    A = -torch.exp(0.3 * torch.from_numpy(A).to(cuda))
    D = torch.ones(H, device=cuda)
    s0 = (0.3 * torch.from_numpy(s0)).to(cuda) if init else None
    dfin = torch.from_numpy(dfin).to(cuda)
    Q = min(chunk, S)
    grads = ssd_ops._launch_bwd(x, dt, A, B, C, D, Q, dy, s0, dfin, variant)
    refs = ssd_bwd_ref(x, dt, A, B, C, D, chunk, dy, s0, dfin)
    for name, g, r in zip(("dx", "ddt", "dA", "dB", "dC", "dD", "dinit"),
                          grads, refs):
        assert (g is None) == (r is None), name
        if r is not None:
            _within(g, r, 2e-2, name)
    again = ssd_ops._launch_bwd(x, dt, A, B, C, D, Q, dy, s0, dfin, variant)
    for i in range(6):
        assert torch.equal(again[i], grads[i])


@pytest.mark.cuda
def test_provision_service_on_the_card(cuda):
    """A 6-tenant ``ProvisionService`` over a reduced moe DQN learner on the
    card, under the faulty plan: every decision came from the learner (no
    fallback, no degraded answer, the breaker closed), and the ragged
    dynamic batches (4 lanes, then what is left) launched one flash and six
    GEMMs a layer each, all on the tensor cores."""
    import dataclasses
    from repro_torch.core import (DQNConfig, DQNLearner, EnvConfig,
                                  FoundationConfig, LearnerPolicy,
                                  ReplayCheckpointCache, RetryPolicy)
    from repro_torch.serve import ProvisionService, ServiceConfig
    from repro_torch.sim import PROFILES, get_fault_spec, synthesize_trace
    v100 = PROFILES["V100"]
    jobs = synthesize_trace(v100, months=1, seed=5, load_scale=1.0)
    plan = get_fault_spec("faulty").make_plan(
        jobs[-1].submit_time + 3 * 86400.0, v100.n_nodes, seed=3)
    cfg = EnvConfig(n_nodes=v100.n_nodes, history=12, interval=1800.0,
                    sub_limit=8 * 3600.0, faults=plan)
    fc = dataclasses.replace(FoundationConfig(kind="moe").reduced(),
                             history=12)
    learner = DQNLearner(fc, DQNConfig(), seed=0, device=cuda)
    sizes = []

    class Sizes(LearnerPolicy):
        def act_batch(self, obs):
            sizes.append(len(obs["matrix"]))
            return super().act_batch(obs)

    service = ProvisionService(
        jobs, cfg, Sizes("moe+dqn", learner),
        svc=ServiceConfig(tenants=6, links=2, max_batch=4), seed=11,
        cache=ReplayCheckpointCache(jobs, cfg.n_nodes, faults=plan),
        retry_factory=lambda i: RetryPolicy(seed=100 + i,
                                            sleep=lambda s: None))
    counts = [(k.launches, k.tc_launches)
              for k in (flash_attention, grouped_gemm)]
    res = service.run()
    torch.cuda.synchronize()
    (flash, flash_tc), (gemm, gemm_tc) = (
        (k.launches - n, k.tc_launches - n_tc)
        for k, (n, n_tc) in zip((flash_attention, grouped_gemm), counts))
    assert res.reason == "completed" and res.n_shed == 0
    assert res.n_degraded == 0 and res.breaker_trips == 0
    assert service.policy.n_fallbacks == 0
    assert service.breaker.state == "closed"
    assert len(sizes) == res.n_batches and set(sizes) >= {4, 2}
    L = fc.trunk.n_layers
    assert (flash, gemm) == (res.n_batches * L, res.n_batches * L * 6)
    assert (flash_tc, gemm_tc) == (flash, gemm)


@pytest.mark.cuda
def test_checkpoint_of_a_gigabyte_round_trips_on_the_card(cuda, tmp_path):
    """A ~1 GB state on the card (fp32 leaves past the writer's 64 MiB
    chunk, bf16 and int leaves, a 0-d step) saved by ``AsyncCheckpointer``
    (its host snapshot taken at ``save``: the leaves are overwritten
    before ``wait``) with the host's codec and restored onto the card:
    every leaf the same bits, every digest checked (a wrong one refused)."""
    import json
    from repro_torch.train import (AsyncCheckpointer, restore_checkpoint)
    gen = torch.Generator(device=cuda).manual_seed(0)
    state = {"w": [torch.randn(48, 2048, 2048, generator=gen, device=cuda),
                   torch.randn(4096, 4096, generator=gen, device=cuda)],
             "h": torch.randn(1000, 999, generator=gen, device=cuda)
             .to(torch.bfloat16),
             "ids": torch.arange(12345, device=cuda),
             "step": torch.tensor(7, dtype=torch.int32, device=cuda)}
    want = [t.clone() for t in (state["w"] + [state["h"], state["ids"],
                                              state["step"]])]
    assert sum(t.numel() * t.element_size() for t in want) > 0.8e9
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(3, state)
    for t in state["w"]:
        t.zero_()
    ck.wait()
    got, step = restore_checkpoint(str(tmp_path), state, device=cuda)
    assert step == 3
    for a, b in zip(got["w"] + [got["h"], got["ids"], got["step"]], want):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a, b)
    manifest = tmp_path / "step_000000003" / "manifest.json"
    m = json.loads(manifest.read_text())
    m["leaves"][-1]["digest"] = "0" * 32
    manifest.write_text(json.dumps(m))
    with pytest.raises(IOError, match="digest mismatch"):
        restore_checkpoint(str(tmp_path), state, device=cuda)


@pytest.mark.cuda
def test_tied_table_backward_is_deterministic(cuda):
    """The tied table's gradient (``layers.TiedTable``: the head's
    product, then the looked-up rows summed into it in place) at a
    Command-R-like width, 32,000 rows of 1,024, on 2 x 2048 tokens drawn
    from 64 (each repeated ~64 times): the same bits over two calls, and
    within fp32 rounding of autograd through the plain lookup and head."""
    from repro_torch.models import layers
    from repro_torch.models.common import ModelConfig
    cfg = ModelConfig(arch_id="tied", d_model=1024, vocab_size=32000,
                      tie_embeddings=True)
    gen = torch.Generator(device=cuda).manual_seed(0)
    table = torch.randn(32000, 1024, generator=gen, device=cuda) * 0.02
    toks = torch.randint(0, 64, (2, 2048), generator=gen, device=cuda)
    gout = torch.randn(2, 2048, 32000, generator=gen, device=cuda)

    def grad(tie):
        t = table.detach().requires_grad_(True)
        x = layers.embed_tokens({"table": t}, toks, cfg, tie)
        logits = layers.lm_logits({}, x * 1.5, cfg, {"table": t}, tie)
        return torch.autograd.grad(logits, t, gout)[0]
    one, two = grad(layers.TiedTable()), grad(layers.TiedTable())
    torch.cuda.synchronize()
    assert torch.equal(one, two)
    plain = grad(None)
    scale = float(plain.abs().max())
    assert float((one - plain).abs().max()) <= 1e-5 * scale
