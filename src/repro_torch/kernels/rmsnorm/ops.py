"""RMSNorm: the CUDA kernel's wrapper and its plain version.

Port of ``repro/kernels/rmsnorm`` (``_rmsnorm_kernel`` in kernel.py, the
leading-dims wrapper in ops.py). The kernel is
``repro_torch/csrc/rmsnorm.cu``; its note says what bounds it on the H100
and how the design answers that.
"""
from __future__ import annotations

import torch

from repro_torch.device import check_on, resolve_device
from repro_torch.kernels import _build


def rmsnorm_ref(x, w, *, eps: float = 1e-6, gemma: bool = False):
    """Plain PyTorch version: x (..., d), w (d,) -> x * rsqrt(mean(x^2) +
    eps) * w (or * (1 + w) with ``gemma``), in fp32, cast to x's dtype."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    wf = w.float()
    if gemma:
        wf = 1.0 + wf
    return (y * wf).to(x.dtype)


def rmsnorm(x, w, *, eps: float = 1e-6, gemma: bool = False, device=None):
    """x (..., d) in fp32 or bf16, w (d,) in either -> x's shape and dtype.
    CUDA tensors launch the kernel over the flattened rows; CPU tensors,
    with ``device="cpu"``, run ``rmsnorm_ref``."""
    dev = resolve_device(device)
    check_on(dev, x, w)
    d = x.shape[-1]
    if w.shape != (d,):
        raise ValueError(f"rmsnorm wants w of shape ({d},); got "
                         f"{tuple(w.shape)}")
    if x.dtype not in _build.DTYPE_CODES or w.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"dtypes {x.dtype}, {w.dtype}: x and w must each be "
                         "float32 or bfloat16")
    if dev.type == "cpu":
        return rmsnorm_ref(x, w, eps=eps, gemma=gemma)
    flat = x.reshape(-1, d)          # a view where the layout allows one
    w = w.contiguous()
    if flat.stride(-1) != 1:
        raise ValueError("x needs unit stride on its last axis")
    out = torch.empty(flat.shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out.reshape(x.shape)
    fn = _build.load("rmsnorm")
    with torch.cuda.device(x.device):
        err = fn(flat.data_ptr(), w.data_ptr(), out.data_ptr(),
                 _build.DTYPE_CODES[x.dtype], _build.DTYPE_CODES[w.dtype],
                 flat.shape[0], d, flat.stride(0), float(eps), int(bool(gemma)),
                 torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch("rmsnorm", err)
    rmsnorm.launches += 1
    return out.reshape(x.shape)


rmsnorm.launches = 0
