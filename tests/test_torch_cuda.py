"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip where there is no CUDA card (as on a CPU-only
test machine) and run on an H100 with

    python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports nothing of JAX, so it runs where JAX is not installed.
Shapes cover the agent's (S=144, a ragged last tile), GQA with a window and
softcap at ragged lengths, and every supported head dim; for RMSNorm and
the SSD scan, the Mamba2-1.3B serving shapes, ragged rows and chunks,
groups and an initial state. Tolerances: fp32 3e-5 for attention, 1e-5 for
the GEMM and RMSNorm and 5e-5 for the scan (the bounds of
tests/test_kernels.py; sums in two orders); bf16 2e-2 absolute and relative
(one rounding at the output, after sums in two orders, may land one bf16
ulp apart).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref)
from repro_torch.kernels.moe_gemm import (expert_mlp, grouped_gemm,
                                          grouped_gemm_ref)
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref
from repro_torch.kernels.ssd import ssd, ssd_ref

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


@pytest.mark.cuda
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,dtype,causal,window,softcap", [
    (2, 8, 8, 144, 144, 32, BF16, False, 0, 0.0),
    (2, 8, 2, 97, 131, 64, FP32, True, 40, 30.0),
    (1, 4, 4, 200, 200, 128, BF16, True, 0, 0.0),
    (3, 4, 4, 24, 24, 16, FP32, False, 0, 0.0),
])
def test_flash_kernel_matches_plain(cuda, B, Hq, Hkv, Sq, Skv, D, dtype,
                                    causal, window, softcap):
    q, k, v = (torch.from_numpy(a).to(cuda, TORCH[dtype]) for a in _normal(
        Sq, (B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))
    opts = dict(causal=causal, window=window, softcap=softcap)
    n = flash_attention.launches
    out = flash_attention(q, k, v, **opts)
    torch.cuda.synchronize()
    assert flash_attention.launches == n + 1
    torch.testing.assert_close(out.float(), flash_attention_ref(
        q, k, v, **opts).float(), atol=3e-5 if dtype == FP32 else 2e-2,
        rtol=0 if dtype == FP32 else 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("E,C,d,f,dtype", [
    (10, 300, 41, 256, FP32), (10, 9216, 256, 1024, BF16),
    (1, 37, 1024, 53, BF16)])
def test_grouped_gemm_kernel_matches_plain(cuda, E, C, d, f, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    x, w = (torch.from_numpy(a).to(cuda, TORCH[dtype]) for a in _normal(
        C, (E, C, d), (E, d, f), scale=d ** -0.25))
    n = grouped_gemm.launches
    out = grouped_gemm(x, w)
    torch.cuda.synchronize()
    assert grouped_gemm.launches == n + 1
    tol = 1e-5 if dtype == FP32 else 2e-2
    torch.testing.assert_close(out.float(), grouped_gemm_ref(x, w).float(),
                               atol=tol, rtol=tol)


@pytest.mark.cuda
def test_expert_mlp_kernel_path(cuda):
    """Three grouped-GEMM launches, the gate and up operands read as strided
    views of wi."""
    x, wi, wo = (torch.from_numpy(a).to(cuda) for a in _normal(
        3, (3, 40, 96), (3, 96, 2, 64), (3, 64, 96), scale=0.2))
    n = grouped_gemm.launches
    out = expert_mlp(x, wi, wo, activation="gelu")
    torch.cuda.synchronize()
    assert grouped_gemm.launches == n + 3
    ref = expert_mlp(x.cpu(), wi.cpu(), wo.cpu(), activation="gelu",
                     device="cpu")
    torch.testing.assert_close(out.cpu(), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d,dtype,w_dtype,gemma", [
    (8192, 2048, BF16, FP32, False), (4, 4096, BF16, FP32, False),
    (300, 2048, FP32, FP32, True), (37, 64, FP32, BF16, False)])
def test_rmsnorm_kernel_matches_plain(cuda, rows, d, dtype, w_dtype, gemma):
    x, w = _normal(rows + d, (rows, d), (d,))
    x = torch.from_numpy(x * 3).to(cuda, TORCH[dtype])
    w = torch.from_numpy(w).to(cuda, TORCH[w_dtype])
    n = rmsnorm.launches
    out = rmsnorm(x, w, gemma=gemma)
    torch.cuda.synchronize()
    assert rmsnorm.launches == n + 1 and out.dtype == x.dtype
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
@pytest.mark.parametrize("Bz,S,H,P,N,G,chunk,dtype,init", [
    (4, 2048, 64, 64, 128, 1, 256, BF16, False),    # Mamba2-1.3B prefill
    (2, 1000, 8, 64, 128, 2, 256, FP32, True),      # ragged, groups, state
    (2, 50, 4, 16, 8, 2, 16, FP32, True),
    (1, 6, 8, 32, 16, 1, 256, FP32, False),         # one short chunk
    (1, 130, 2, 128, 32, 1, 100, FP32, True)])
def test_ssd_kernel_matches_plain(cuda, Bz, S, H, P, N, G, chunk, dtype, init):
    x, dt, A, B, C, D, s0 = _ssd_inputs(cuda, Bz, S, H, P, N, G, dtype, init)
    n = ssd.launches
    y, final = ssd(x, dt, A, B, C, D, chunk, s0)
    torch.cuda.synchronize()
    assert ssd.launches == n + 1
    y_ref, final_ref = ssd_ref(x, dt, A, B, C, D, chunk, s0)
    tol = 5e-5 if dtype == FP32 else 2e-2
    torch.testing.assert_close(y.float(), y_ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(final, final_ref, atol=tol, rtol=tol)


@pytest.mark.cuda
def test_mamba_smoke_kernel_path(cuda):
    """Mamba2 SMOKE prefill and two decode steps on the card (both kernels)
    against the plain path on the CPU, same weights."""
    from repro_torch.configs import mamba2_1_3b
    from repro_torch.convert import tree_map
    from repro_torch.models import transformer
    cfg = mamba2_1_3b.SMOKE
    params = transformer.init(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 40)))
    pos = torch.arange(40)[None].expand(2, 40)
    n_ssd, n_norm = ssd.launches, rmsnorm.launches
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
    assert rmsnorm.launches == n_norm + 3 * (2 * L + 1)
    for a, b in zip(outs["cuda"], outs["cpu"]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_wrappers_reject_cpu_tensors_for_cuda(cuda):
    x = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError):
        grouped_gemm(x, torch.zeros(1, 8, 8))
