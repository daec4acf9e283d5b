"""The PyTorch port's kernels against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version, which is held here
against the Pallas kernel in interpret mode and against its jnp oracle, on
the same numpy inputs. The CUDA kernels themselves are held against the
plain versions by the ``cuda``-marked tests at the end (on the card only)
and by ``chip_smoke.py``.

Tolerances: fp32 3e-5 for attention (the Pallas kernel's own bound in
tests/test_kernels.py) and 2e-5 for the GEMM (``TOL`` there); bf16 2e-2
(``TOL``): both sides round once to bf16 at the output, after sums taken in
different orders, so they may land one bf16 ulp apart.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_fwd
from repro.kernels.flash_attention.ref import attention_ref
from repro.kernels.moe_gemm import expert_mlp as jax_expert_mlp
from repro.kernels.moe_gemm import moe_grouped_gemm as jax_grouped_gemm
from repro.models.layers import _act as jax_act
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.moe_gemm import (expert_mlp, grouped_gemm,
                                          moe_grouped_gemm)
from repro_torch.models.layers import _act

FP32, BF16 = "float32", "bfloat16"
JNP = {FP32: jnp.float32, BF16: jnp.bfloat16}
TORCH = {FP32: torch.float32, BF16: torch.bfloat16}


def _normal(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=s) * scale).astype(np.float32) for s in shapes]


def _pair(a, dtype):
    """The same numpy array as a JAX array and a CPU tensor of ``dtype``."""
    return (jnp.asarray(a).astype(JNP[dtype]),
            torch.from_numpy(a).to(TORCH[dtype]))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      x.astype(jnp.float32))


# ------------------------------------------------------------------ flash
FLASH_CASES = [
    # (B, Hq, Hkv, S, D, dtype, causal, window, softcap); the sweep of
    # tests/test_kernels.py plus the agent trunk's shape
    *[(B, Hq, Hkv, S, D, FP32, causal, 0, 0.0)
      for (B, Hq, Hkv, S, D) in [(1, 4, 4, 128, 64), (2, 8, 2, 128, 64),
                                 (1, 4, 1, 256, 128), (1, 2, 2, 96, 64)]
      for causal in (True, False)],
    (1, 4, 4, 128, 64, BF16, True, 0, 0.0),
    (1, 2, 2, 256, 64, FP32, True, 64, 0.0),
    (1, 2, 2, 256, 64, FP32, True, 0, 30.0),
    (1, 2, 2, 256, 64, FP32, True, 64, 30.0),
    (2, 8, 8, 144, 32, FP32, False, 0, 0.0),     # agent, ragged last tile
    (2, 8, 8, 144, 32, BF16, False, 0, 0.0),
]


@pytest.mark.parametrize("B,Hq,Hkv,S,D,dtype,causal,window,softcap",
                         FLASH_CASES)
def test_flash_plain_matches_pallas(B, Hq, Hkv, S, D, dtype, causal, window,
                                    softcap):
    q, k, v = _normal(S + Hq + D, (B, S, Hq, D), (B, S, Hkv, D),
                      (B, S, Hkv, D))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=causal, window=window,
                          softcap=softcap, device="cpu")
    assert out.shape == (B, S, Hq, D) and out.dtype == TORCH[dtype]
    # JAX kernel and oracle take (B, H, S, D)
    jt = [jnp.swapaxes(a, 1, 2) for a in (jq, jk, jv)]
    pallas = flash_attention_fwd(*jt, causal=causal, window=window,
                                 softcap=softcap, block_q=64, block_kv=64,
                                 interpret=True)
    oracle = attention_ref(*(a.astype(jnp.float32) for a in jt),
                           causal=causal, window=window, softcap=softcap)
    tol = 3e-5 if dtype == FP32 else 2e-2
    for ref in (pallas, oracle):
        np.testing.assert_allclose(_np(out), np.swapaxes(_np(ref), 1, 2),
                                   atol=tol)


@pytest.mark.parametrize("bad", ["head_dim", "gqa", "dtype", "stride"])
def test_flash_wrapper_rejects(bad):
    q = torch.zeros(1, 8, 4, 32)
    k = v = torch.zeros(1, 8, 4, 32)
    if bad == "head_dim":            # past the kernels' 128
        q = k = v = torch.zeros(1, 8, 4, 136)
    elif bad == "gqa":
        k = v = torch.zeros(1, 8, 3, 32)
    elif bad == "dtype":
        k = k.to(torch.bfloat16)
    else:
        q = torch.zeros(1, 8, 32, 4).transpose(-1, -2)
    with pytest.raises(ValueError):
        flash_attention(q, k, v, device="cpu")


# ---------------------------------------------------------------- moe_gemm
@pytest.mark.parametrize("E,C,d,f,dtype", [
    (2, 64, 128, 64, FP32), (5, 96, 160, 96, FP32), (1, 32, 64, 256, FP32),
    (3, 37, 41, 53, FP32),                 # ragged C, d and f
    (2, 64, 128, 64, BF16), (10, 100, 64, 96, BF16),
])
def test_grouped_gemm_plain_matches_pallas(E, C, d, f, dtype):
    x, w = _normal(E * C + d, (E, C, d), (E, d, f))
    w /= np.sqrt(d)
    (jx, tx), (jw, tw) = _pair(x, dtype), _pair(w, dtype)
    out = moe_grouped_gemm(tx, tw, device="cpu")
    assert out.shape == (E, C, f) and out.dtype == TORCH[dtype]
    ref = jax_grouped_gemm(jx, jw, interpret=True)
    np.testing.assert_allclose(_np(out), _np(ref),
                               atol=2e-5 if dtype == FP32 else 2e-2)


@pytest.mark.parametrize("activation", ["silu", "gelu"])
def test_expert_mlp_matches_pallas(activation):
    E, C, d, f = 3, 40, 96, 64
    x, wi, wo = _normal(3, (E, C, d), (E, d, 2, f), (E, f, d))
    wi /= np.sqrt(d)
    wo /= np.sqrt(f)
    out = expert_mlp(*(torch.from_numpy(a) for a in (x, wi, wo)),
                     activation=activation, device="cpu")
    ref = jax_expert_mlp(jnp.asarray(x), jnp.asarray(wi), jnp.asarray(wo),
                         activation=activation, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-5)


def test_gelu_is_tanh_approximation():
    """jax.nn.gelu is the tanh form; torch's F.gelu default is the exact
    (erf) form, which differs by more than the fp32 tolerance."""
    x = np.linspace(-4, 4, 101).astype(np.float32)
    ours = _act("gelu")(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, np.asarray(jax_act("gelu")(x)),
                               atol=1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(exact - ours).max() > 1e-4


def test_grouped_gemm_strided_weight_view():
    """expert_mlp hands the kernel wi[:, :, 0, :], a view strided on its
    contraction axis; the wrapper takes it as it is."""
    x, wi = _normal(5, (2, 8, 16), (2, 16, 2, 8))
    tx, twi = torch.from_numpy(x), torch.from_numpy(wi)
    view = twi[:, :, 1, :]
    assert not view.is_contiguous()
    np.testing.assert_allclose(grouped_gemm(tx, view, device="cpu").numpy(),
                               np.einsum("ecd,edf->ecf", x, wi[:, :, 1, :]),
                               atol=2e-5)
