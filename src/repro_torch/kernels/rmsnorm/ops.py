"""RMSNorm: the CUDA kernel's wrapper and its plain version.

Port of ``repro/kernels/rmsnorm`` (``_rmsnorm_kernel`` in kernel.py, the
leading-dims wrapper in ops.py). The kernel is
``repro_torch/csrc/rmsnorm.cu``, in two variants: 16-byte vector accesses
with the row held in registers ("vec"), and one element per lane for rows
those accesses cannot address ("simt"). Its note says what bounds it on the
H100 and how the design answers that.
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


MAX_VECS = 512                      # 16-byte vectors in a row of the vec kernel


def _rmsnorm_variant(x, w) -> str:
    """The kernel a CUDA launch over the rows of x (..., d) runs, chosen
    from the inputs alone: "vec" (16-byte loads and stores) where d is a
    multiple of 16 bytes of x's elements, at most MAX_VECS of them, the rows
    start on 16-byte boundaries (16-byte-aligned data, a row stride that is a
    multiple of the same unless there is one row) and w is 16-byte-aligned
    and contiguous, else "simt"."""
    d = x.shape[-1]
    per = 16 // x.element_size()
    flat = x.reshape(-1, d)
    if not d or d % per or d // per > MAX_VECS:
        return "simt"
    if flat.stride(-1) != 1 or flat.data_ptr() % 16 or \
            (flat.shape[0] > 1 and flat.stride(0) % per):
        return "simt"
    if w.data_ptr() % 16 or w.stride(0) != 1:
        return "simt"
    return "vec"


def _launch(flat, w, variant: str, *, eps, gemma):
    """Run ``variant`` of the kernel over the rows of CUDA tensors flat
    (rows, d) and w (d,) (checked by the caller) and return y; counts
    nothing."""
    out = torch.empty(flat.shape, dtype=flat.dtype, device=flat.device)
    if out.numel() == 0:
        return out
    fn = _build.load("rmsnorm")
    with torch.cuda.device(flat.device):
        err = fn(flat.data_ptr(), w.data_ptr(), out.data_ptr(),
                 _build.DTYPE_CODES[flat.dtype], _build.DTYPE_CODES[w.dtype],
                 _build.VARIANT_CODES[variant], flat.shape[0], flat.shape[1],
                 flat.stride(0), float(eps), int(bool(gemma)),
                 torch.cuda.current_stream(flat.device).cuda_stream)
    _build.check_launch("rmsnorm", err)
    return out


def rmsnorm(x, w, *, eps: float = 1e-6, gemma: bool = False, device=None):
    """x (..., d) in fp32 or bf16, w (d,) in either -> x's shape and dtype.
    CUDA tensors launch the kernel variant that ``_rmsnorm_variant`` names
    over the flattened rows; CPU tensors, with ``device="cpu"``, run
    ``rmsnorm_ref``."""
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
    _build.refuse_grad("rmsnorm", x, w)
    flat = x.reshape(-1, d)          # a view where the layout allows one
    w = w.contiguous()
    if flat.stride(-1) != 1:
        raise ValueError("x needs unit stride on its last axis")
    variant = _rmsnorm_variant(flat, w)
    out = _launch(flat, w, variant, eps=eps, gemma=gemma)
    if out.numel():                     # an empty out launches nothing
        rmsnorm.launches += 1
        rmsnorm.vec_launches += variant == "vec"
    return out.reshape(x.shape)


rmsnorm.launches = 0
rmsnorm.vec_launches = 0
