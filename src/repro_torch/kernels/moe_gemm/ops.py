"""Grouped expert GEMM: the CUDA kernel's wrapper, its plain version, and
the public wrappers built on it.

Port of ``repro/kernels/moe_gemm`` (``_gemm_kernel`` in kernel.py;
``moe_grouped_gemm`` and ``expert_mlp`` in ops.py). The kernel is
``repro_torch/csrc/moe_gemm.cu``; its note says what bounds it on the H100
and how the design answers that.
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


def grouped_gemm(x, w, *, device=None):
    """out[e] = x[e] @ w[e]. CUDA tensors launch the kernel (the two
    leading axes of x and w may be strided); CPU tensors, with
    ``device="cpu"``, run ``grouped_gemm_ref``."""
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
    E, C, d = x.shape
    f = w.shape[2]
    out = torch.empty((E, C, f), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    fn = _build.load("moe_gemm")
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                 _build.DTYPE_CODES[x.dtype], E, C, d, f,
                 x.stride(0), x.stride(1), w.stride(0), w.stride(1),
                 torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch("moe_gemm", err)
    grouped_gemm.launches += 1
    return out


grouped_gemm.launches = 0


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
