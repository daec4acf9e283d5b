"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip where there is no CUDA card (as on a CPU-only
test machine) and run on an H100 with

    python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports nothing of JAX, so it runs where JAX is not installed.
Shapes cover the agent's (S=144, a ragged last tile), GQA with a window and
softcap at ragged lengths, every supported head dim, and for every kernel
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
(sums over up to 1001 terms), bf16 2e-2; the GEMM's fused bf16 backward
also at split-K boundaries, with strided dY, and bit for bit against
itself over repeated calls; and one reduced DQN step with the kernels
against the same step on the card's plain path. The RMSNorm and SSD
backward kernels run through autograd against their plain versions, fp32
1e-4 and bf16 2e-2 of each gradient's scale, their reductions (dw; dA, dB,
dC, dD) the same bit for bit over repeated calls, each case asserting
through the counters which variant ran; both variants of each (RMSNorm's
"vec" and "simt", the scan's "tc" and "simt") are also launched directly
on the same bf16 inputs, ragged chunks included.

Last, a 6-tenant ``ProvisionService`` over a reduced learner on the card:
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
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,dtype,causal,softcap,variant", [
    (4, 8, 8, 144, 144, 32, BF16, False, 0.0, "tc"),   # the trunk's
    (2, 4, 4, 144, 144, 32, BF16, True, 0.0, "tc"),
    (2, 4, 4, 100, 100, 16, BF16, False, 30.0, "tc"),
    (2, 4, 4, 97, 131, 64, BF16, True, 30.0, "tc"),    # Sq < Skv, causal
    (1, 2, 2, 131, 97, 64, BF16, False, 0.0, "tc"),    # Sq > Skv
    (1, 2, 2, 256, 256, 32, BF16, False, 0.0, "tc"),   # the longest tc
    (2, 8, 2, 1001, 1001, 64, BF16, True, 0.0, "simt"),  # ragged, GQA
    (1, 4, 2, 130, 130, 128, BF16, True, 30.0, "simt"),
    (2, 8, 2, 97, 131, 64, FP32, True, 30.0, "simt"),
    (3, 4, 4, 24, 24, 16, FP32, False, 0.0, "simt"),
    (1, 2, 1, 131, 97, 128, FP32, False, 0.0, "simt"),
])
def test_flash_backward_matches_plain(cuda, B, Hq, Hkv, Sq, Skv, D, dtype,
                                      causal, softcap, variant):
    """Through autograd: the forward kernel keeps each row's log-sum-exp
    (checked against the plain one), and the backward kernel's dq, dk, dv
    match ``flash_attention_bwd_ref`` on the forward's out, one backward
    launch per call, of the variant named."""
    q, k, v, do = (torch.from_numpy(a).to(cuda, TORCH[dtype]) for a in
                   _normal(Sq + D, (B, Sq, Hq, D), (B, Skv, Hkv, D),
                           (B, Skv, Hkv, D), (B, Sq, Hq, D)))
    opts = dict(causal=causal, softcap=softcap)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = _bwd_counts()
    out = flash_attention(*leaves, **opts)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    after = _bwd_counts()
    assert (after[0] - before[0], after[3] - before[3]) == \
        (1, int(variant == "tc"))
    lse = fa_ops._launch(q, k, v, fa_ops._flash_variant(q, k, v), window=0,
                         scale=D ** -0.5, lse=True, **opts)[1]
    torch.testing.assert_close(lse, flash_attention_lse_ref(q, k, **opts),
                               atol=1e-4, rtol=1e-5)
    refs = flash_attention_bwd_ref(q, k, v, out.detach(), lse, do, **opts)
    atol, rtol = (3e-5, 1e-5) if dtype == FP32 else (2e-2, 2e-2)
    for name, g, r in zip("qkv", grads, refs):
        assert g.dtype == r.dtype and g.shape == r.shape
        torch.testing.assert_close(g.float(), r.float(), atol=atol,
                                   rtol=rtol, msg=f"d{name}")


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
    torch.testing.assert_close(dx.float(), rdx.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(dw.float(), rdw.float(), atol=2e-2, rtol=2e-2)
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
    (33, 300, BF16, False), (37, 300, FP32, False)])
def test_rmsnorm_backward_through_autograd(cuda, rows, d, dtype, gemma):
    """The RMSNorm Function's backward kernel against ``rmsnorm_bwd_ref``
    (fp32 1e-4, bf16 2e-2 of each gradient's scale; one rounding after sums
    in other orders), with one forward and one backward launch counted and
    dw the same bit for bit over a second call."""
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
    # vec wherever d is a multiple of 16 bytes of x's elements
    vec = d % (16 // x.element_size()) == 0
    assert rmsnorm.bwd_vec_launches - nv == int(vec)
    assert dx.dtype == x.dtype and dw.dtype == w.dtype
    rdx, rdw = rmsnorm_bwd_ref(x.detach(), w.detach(), dy, gemma=gemma)
    tol = 1e-4 if dtype == FP32 else 2e-2
    _within(dx, rdx, tol, "dx")
    _within(dw, rdw, tol, "dw")
    again = rmsnorm_bwd(x.detach(), w.detach(), dy, gemma=gemma)[1]
    assert torch.equal(again, dw)


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
    (1, 4096, True)])
@pytest.mark.parametrize("variant", ["vec", "simt"])
def test_rmsnorm_backward_variants(cuda, rows, d, gemma, variant):
    """Each variant of the RMSNorm backward launched directly on bf16 rows
    with an fp32 w, against ``rmsnorm_bwd_ref`` (2e-2 of each gradient's
    scale), dw the same bit for bit over a second call."""
    x, w, dy = (torch.from_numpy(a).to(cuda) for a in _normal(
        rows * d, (rows, d), (d,), (rows, d)))
    x, dy = x.to(torch.bfloat16), dy.to(torch.bfloat16)
    w = 1.0 + 0.1 * w
    dx, dw = norm_ops._launch_bwd(x, w, dy, variant, eps=1e-5, gemma=gemma)
    rdx, rdw = rmsnorm_bwd_ref(x, w, dy, eps=1e-5, gemma=gemma)
    _within(dx, rdx, 2e-2, "dx")
    _within(dw, rdw, 2e-2, "dw")
    again = norm_ops._launch_bwd(x, w, dy, variant, eps=1e-5, gemma=gemma)
    assert torch.equal(again[1], dw)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,chunk,init", [
    ((2, 2048, 8, 64, 128, 1), 256, False),   # the training shape, 8 heads
    ((8, 128, 4, 64, 128, 1), 256, False),    # one chunk a sequence
    ((2, 300, 8, 64, 128, 2), 256, True),     # ragged, groups, states
    ((1, 250, 4, 64, 128, 2), 100, True),     # chunks of 100, then 50
    ((2, 40, 8, 16, 16, 1), 16, True),        # P = N = chunk = 16
    ((1, 97, 2, 128, 128, 1), 64, True),      # P = 128
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
