"""How the flash and grouped-GEMM wrappers choose their kernel variant, and
the CPU path of both at the agent trunk's widths against the Pallas kernels
(the RMSNorm and SSD choices are pinned in tests/test_torch_dispatch_lm.py;
the test that no CPU call counts a launch covers all four kernels).

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
from repro_torch.kernels.flash_attention.ops import (BWD_TC_MAX_SMEM,
                                                     _flash_bwd_variant,
                                                     _flash_variant,
                                                     bwd_smem_bytes)
from repro_torch.kernels.moe_gemm import expert_mlp, grouped_gemm
from repro_torch.kernels.moe_gemm.ops import _gemm_variant, _strides
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
    """q, k, v, o, dO for the backward: the trunk's shape, and one change
    each that the tensor-core backward does not take."""
    B, S, Hq, Hkv, D = 2, 144, 8, 8, 32
    if name == "gqa":
        Hkv = 2
    elif name == "d128":
        D = 128
    elif name == "long":
        S = 257
    elif name == "d64_s256":                # over the shared-memory ceiling
        S, D = 256, 64
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
    ("trunk", "tc"), ("fused_qkv", "tc"), ("fp32", "simt"), ("gqa", "simt"),
    ("d128", "simt"), ("long", "simt"), ("d64_s256", "simt"),
    ("do_offset", "simt"),
])
def test_flash_bwd_variant(name, variant):
    """The tensor-core backward takes the trunk's bf16 MHA heads whole in
    shared memory; GQA, D = 128, sequences past 256 or past the shared
    memory, fp32 and operands off 16 bytes take the CUDA-core kernels."""
    assert _flash_bwd_variant(*_flash_bwd_case(name)) == variant


def test_flash_bwd_smem_mirror():
    """``bwd_smem_bytes`` mirrors the kernel's ``tc::smem_bytes``: q, dO, K,
    V in bf16, 256-column dS^T rows and fp32 lse and delta; the trunk's
    head takes 112 KB, under the 227 KB ceiling."""
    assert bwd_smem_bytes(144, 144, 32) == 4 * 32 * 288 + 144 * 512 + 8 * 144
    assert bwd_smem_bytes(144, 144, 32) < BWD_TC_MAX_SMEM
    assert bwd_smem_bytes(256, 256, 32) <= BWD_TC_MAX_SMEM
    assert bwd_smem_bytes(256, 256, 64) > BWD_TC_MAX_SMEM


def _counts():
    return (grouped_gemm.launches, grouped_gemm.tc_launches,
            grouped_gemm.bwd_launches, grouped_gemm.bwd_tc_launches,
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
