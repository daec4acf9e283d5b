"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip where there is no CUDA card (as on a CPU-only
test machine) and run on an H100 with

    python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports nothing of JAX, so it runs where JAX is not installed.
Shapes cover the agent's (S=144, a ragged last tile), GQA with a window and
softcap at ragged lengths, and every supported head dim. Tolerances: fp32
3e-5 for attention and 1e-5 for the GEMM (sums in two orders); bf16 2e-2
absolute and relative (one rounding at the output, after sums in two
orders, may land one bf16 ulp apart).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref)
from repro_torch.kernels.moe_gemm import (expert_mlp, grouped_gemm,
                                          grouped_gemm_ref)

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
def test_wrappers_reject_cpu_tensors_for_cuda(cuda):
    x = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError):
        grouped_gemm(x, torch.zeros(1, 8, 8))
