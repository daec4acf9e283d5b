"""Grouped expert GEMM: the CUDA kernel's wrapper, its plain version, and
the public wrappers built on it.

Port of ``repro/kernels/moe_gemm`` (``_gemm_kernel`` in kernel.py;
``moe_grouped_gemm`` and ``expert_mlp`` in ops.py). The kernel is
``repro_torch/csrc/moe_gemm.cu``, in two variants: bf16 on the tensor cores
(``wgmma`` fed by TMA) and a CUDA-core one for fp32 and for inputs that TMA
cannot address. Its note says what bounds it on the H100 and how the design
answers that.

On CUDA tensors that need a gradient, ``grouped_gemm`` runs through
``_GemmFn``, whose backward is two more launches of the same kernel:
dX = dY·Wᵀ (Wᵀ copied to a contiguous tensor, a few MB) and dW = Xᵀ·dY,
which the tensor-core kernel reads straight from X (its ``trans_x`` mode:
X's rows as MN-major tiles, transposed by ``wgmma``) and the CUDA-core one
from a contiguous copy of Xᵀ. They are counted in
``grouped_gemm.bwd_launches`` / ``bwd_tc_launches``.
With no gradient to track the kernel is launched directly, as before; CPU
tensors run ``grouped_gemm_ref``, which autograd differentiates.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import check_on, resolve_device
from repro_torch.kernels import _build


def grouped_gemm_ref(x, w):
    """Plain PyTorch version: x (E,C,d) @ w (E,d,f) -> (E,C,f) in x's
    dtype, products summed in fp32."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)


def grouped_gemm_bwd_ref(x, w, dy):
    """Plain version of the backward: (dx, dw) = (dy @ wᵀ, xᵀ @ dy) per
    expert, products summed in fp32, in x's and w's dtypes."""
    dx = torch.einsum("ecf,edf->ecd", dy.float(), w.float()).to(x.dtype)
    dw = torch.einsum("ecd,ecf->edf", x.float(), dy.float()).to(w.dtype)
    return dx, dw


def _strides(x, w):
    """(x_se, x_sc, w_se, w_sk), the stride of an axis of length 1 replaced
    by the nested one: the kernel never steps along it, so its stride is
    whatever the view happened to keep."""
    E, rows, row = x.shape
    k, f = w.shape[1], w.shape[2]
    x_sc = x.stride(1) if rows > 1 else row
    w_sk = w.stride(1) if k > 1 else f
    return (x.stride(0) if E > 1 else rows * x_sc, x_sc,
            w.stride(0) if E > 1 else k * w_sk, w_sk)


def _gemm_variant(x, w, trans_x: bool = False) -> str:
    """The kernel a CUDA launch runs, chosen from the inputs alone: "tc"
    (tensor cores, TMA loads) for bfloat16 that TMA can address -- the
    contraction (> 0), x's row length and f multiples of 8 (with
    ``trans_x``, x (E, K, M) read as its transpose: M a multiple of 8, any
    K > 0), the leading strides multiples of 8 elements, each operand a
    view of one array in either order of its two leading axes (the trunk's
    activations keep the expert axis inside their rows), 16-byte-aligned
    data -- else "simt"."""
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        return "simt"
    E, rows, row = x.shape
    f = w.shape[2]
    x_se, x_sc, w_se, w_sk = _strides(x, w)
    k = rows if trans_x else row
    if not k or row % 8 or f % 8 or any(s <= 0 or s % 8
                                        for s in (x_se, x_sc, w_se, w_sk)):
        return "simt"
    for row, (inner, outer) in ((row, sorted([(x_se, E), (x_sc, rows)])),
                                (f, sorted([(w_se, E), (w_sk, k)]))):
        if inner[0] < row or outer[0] < inner[0] * inner[1]:
            return "simt"               # rows or axes overlap
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        return "simt"
    return "tc"


def _launch(x, w, variant: str, trans_x: bool = False):
    """Run ``variant`` of the kernel on CUDA tensors x, w (checked by the
    caller) and return out = x @ w per expert, or x^T @ w with ``trans_x``
    (x (E, d, C), tensor cores only); counts nothing."""
    E, C, d = x.shape
    if trans_x:
        d, C = C, d
    f = w.shape[2]
    out = torch.empty((E, C, f), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    fn = _build.load("moe_gemm")
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                 _build.DTYPE_CODES[x.dtype], _build.VARIANT_CODES[variant],
                 int(trans_x), E, C, d, f, *_strides(x, w),
                 torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch("moe_gemm", err)
    return out


def _launch_bwd_product(a, b, trans_x: bool = False):
    """One backward product a @ b (a^T @ b with ``trans_x``) on the kernel,
    counted in ``bwd_launches`` (and ``bwd_tc_launches`` on the tensor
    cores)."""
    variant = _gemm_variant(a, b, trans_x)
    out = _launch(a, b, variant, trans_x)
    if out.numel():
        grouped_gemm.bwd_launches += 1
        grouped_gemm.bwd_tc_launches += variant == "tc"
    return out


class _GemmFn(torch.autograd.Function):
    """The grouped GEMM with its backward on the same kernel."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _forward(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        if dy.stride(-1) != 1:
            dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _launch_bwd_product(dy, w.transpose(1, 2).contiguous())
        if ctx.needs_input_grad[1]:
            if _gemm_variant(x, dy, trans_x=True) == "tc":
                dw = _launch_bwd_product(x, dy, trans_x=True)
            else:
                dw = _launch_bwd_product(x.transpose(1, 2).contiguous(), dy)
        return dx, dw


def _forward(x, w):
    variant = _gemm_variant(x, w)
    out = _launch(x, w, variant)
    if out.numel():                     # an empty out launches nothing
        grouped_gemm.launches += 1
        grouped_gemm.tc_launches += variant == "tc"
    return out


def _gemm_cuda(x, w):
    """The card's route of ``grouped_gemm`` (inputs checked): through
    ``_GemmFn`` when autograd records a gradient for x or w, else one
    launch."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _GemmFn.apply(x, w)
    return _forward(x, w)


def grouped_gemm(x, w, *, device=None):
    """out[e] = x[e] @ w[e]. CUDA tensors launch the kernel variant that
    ``_gemm_variant`` names (the two leading axes of x and w may be
    strided), differentiable through two more launches when x or w needs a
    gradient; CPU tensors, with ``device="cpu"``, run
    ``grouped_gemm_ref``."""
    dev = resolve_device(device)
    check_on(dev, x, w)
    if x.ndim != 3 or w.ndim != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"grouped_gemm wants x (E,C,d) and w (E,d,f); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    if x.dtype != w.dtype or x.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"dtypes {x.dtype}, {w.dtype}: x and w must share "
                         "one of float32, bfloat16")
    if x.stride(-1) != 1 or w.stride(-1) != 1:
        raise ValueError("x and w need unit stride on their last axis")
    if dev.type == "cpu":
        return grouped_gemm_ref(x, w)
    return _gemm_cuda(x, w)


grouped_gemm.launches = 0
grouped_gemm.tc_launches = 0
grouped_gemm.bwd_launches = 0
grouped_gemm.bwd_tc_launches = 0


def moe_grouped_gemm(x, w, *, device=None):
    return grouped_gemm(x, w, device=device)


_ACTS = {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh")}


def expert_mlp(x, wi, wo, *, activation: str = "silu", device=None):
    """x: (E, C, d); wi: (E, d, 2, f); wo: (E, f, d) -> (E, C, d):
    act(x @ wi_gate) * (x @ wi_up) @ wo, three grouped GEMMs."""
    act = _ACTS[activation]
    gate = grouped_gemm(x, wi[:, :, 0, :], device=device)
    up = grouped_gemm(x, wi[:, :, 1, :], device=device)
    h = (act(gate.float()) * up.float()).to(x.dtype)
    return grouped_gemm(h, wo, device=device)
