"""RMSNorm: the CUDA kernels' wrappers, their plain versions, and the
autograd wiring that makes ``rmsnorm`` differentiable on the card.

Port of ``repro/kernels/rmsnorm`` (``_rmsnorm_kernel`` in kernel.py, the
leading-dims wrapper in ops.py). The kernel is
``repro_torch/csrc/rmsnorm.cu``, in two variants: 16-byte vector accesses
with the row held in registers ("vec"), and one element per lane for rows
those accesses cannot address ("simt"). The backward kernel,
``repro_torch/csrc/rmsnorm_bwd.cu``, computes the VJP that JAX's autodiff
gives the package's jnp RMSNorm (``apply_norm``,
``repro/models/layers.py:41``); the Pallas kernel has none. It has the same
two variants, "vec" (a warp a row, the row in registers) and "simt". Each
source's note says what bounds it on the H100 and how the design answers
that.

On CUDA tensors that need a gradient, ``rmsnorm`` runs through
``_RMSNormFn``: its forward launches the forward kernel, its backward the
backward kernel (``rmsnorm_bwd``). With no gradient to track (serving,
``inference_mode``) the forward kernel is launched directly. CPU tensors
run the plain versions, which autograd differentiates.
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


def rmsnorm_bwd_ref(x, w, dy, *, eps: float = 1e-6, gemma: bool = False):
    """Plain version of the backward kernel: with r = rsqrt(mean(x^2) +
    eps), w' = w (or 1 + w) and g = dy * w', all in fp32, dx = r g - x r^3
    mean(g x) in x's dtype and dw = sum over rows of dy x r in w's dtype,
    each rounded once."""
    d = x.shape[-1]
    xf = x.reshape(-1, d).float()
    dyf = dy.reshape(-1, d).float()
    wf = w.float() + 1.0 if gemma else w.float()
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    g = dyf * wf
    dx = r * g - xf * r.pow(3) * (g * xf).mean(dim=-1, keepdim=True)
    dw = (dyf * xf * r).sum(dim=0)
    return dx.reshape(x.shape).to(x.dtype), dw.to(w.dtype)


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


BWD_MAX_BLOCKS = 256    # row ranges of the simt backward kernel, at most
BWD_VEC_WARPS = 4       # warps a block of the vec backward kernel
BWD_VEC_MAX_BLOCKS = 256  # blocks of the vec backward kernel, at most


def bwd_blocks(rows: int):
    """(blocks, rows a block) of the simt backward kernel: contiguous row
    ranges, a function of the row count alone, so dw's fixed-order sum over
    the blocks is the same on every card and every call."""
    per = -(-rows // BWD_MAX_BLOCKS)
    return -(-rows // per), per


def bwd_vec_partition(rows: int):
    """(blocks, rows a warp) of the vec backward kernel: warp q of block b
    takes the contiguous rows [(BWD_VEC_WARPS b + q) per, ...), a function
    of the row count alone, so dw's fixed-order sums are the same on every
    card and every call."""
    per = -(-rows // (BWD_VEC_WARPS * BWD_VEC_MAX_BLOCKS))
    return -(-rows // (BWD_VEC_WARPS * per)), per


def _rmsnorm_bwd_variant(x, w, dy) -> str:
    """The backward kernel a CUDA launch over the rows of x (..., d) runs,
    chosen from the inputs alone: "vec" (one warp a row, 16-byte loads and
    stores) where the forward's "vec" conditions hold for x and w (at most
    MAX_VECS vectors a row) and dy is contiguous and 16-byte-aligned, else
    "simt"."""
    d = x.shape[-1]
    if _rmsnorm_variant(x, w) != "vec":
        return "simt"
    fdy = dy.reshape(-1, d)
    if fdy.stride(-1) != 1 or fdy.data_ptr() % 16 or \
            (fdy.shape[0] > 1 and fdy.stride(0) != d):
        return "simt"
    return "vec"


def _launch_bwd(flat, w, dy, variant: str, *, eps, gemma):
    """Run ``variant`` of the backward kernel on CUDA tensors flat (rows,
    d), w (d,) and contiguous dy (rows, d) (checked by the caller) and
    return (dx, dw); counts nothing."""
    rows, d = flat.shape
    dx = torch.empty((rows, d), dtype=flat.dtype, device=flat.device)
    dw = torch.empty((d,), dtype=w.dtype, device=flat.device)
    if rows == 0 or d == 0:
        return dx, dw.zero_()
    blocks, per = (bwd_vec_partition(rows) if variant == "vec" else
                   bwd_blocks(rows))
    part = torch.empty((blocks, d), dtype=torch.float32, device=flat.device)
    fn = _build.load("rmsnorm_bwd")
    with torch.cuda.device(flat.device):
        err = fn(flat.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                 part.data_ptr(), dw.data_ptr(),
                 _build.DTYPE_CODES[flat.dtype], _build.DTYPE_CODES[w.dtype],
                 _build.VARIANT_CODES[variant],
                 rows, d, flat.stride(0), blocks, per, float(eps),
                 int(bool(gemma)),
                 torch.cuda.current_stream(flat.device).cuda_stream)
    _build.check_launch("rmsnorm_bwd", err)
    return dx, dw


def _check(x, w):
    d = x.shape[-1]
    if w.shape != (d,):
        raise ValueError(f"rmsnorm wants w of shape ({d},); got "
                         f"{tuple(w.shape)}")
    if x.dtype not in _build.DTYPE_CODES or w.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"dtypes {x.dtype}, {w.dtype}: x and w must each be "
                         "float32 or bfloat16")


def _flat(x):
    flat = x.reshape(-1, x.shape[-1])   # a view where the layout allows one
    if flat.stride(-1) != 1:
        raise ValueError("x needs unit stride on its last axis")
    return flat


def rmsnorm_bwd(x, w, dy, *, eps: float = 1e-6, gemma: bool = False,
                device=None):
    """The backward of ``rmsnorm`` from its input x (..., d), weight w (d,)
    and the output's gradient dy (x's shape and dtype): (dx in x's dtype,
    dw in w's). CUDA tensors launch the backward kernel; CPU tensors, with
    ``device="cpu"``, run ``rmsnorm_bwd_ref``. Training reaches the kernel
    through ``rmsnorm``'s autograd Function, not through this: it is the
    backward's stand-alone entry, as ``flash_attention_bwd`` is flash's, for
    callers that hold dy themselves (the tests, the kernel timings)."""
    dev = resolve_device(device)
    check_on(dev, x, w, dy)
    _check(x, w)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError("dy must match x's shape and dtype")
    if dev.type == "cpu":
        return rmsnorm_bwd_ref(x, w, dy, eps=eps, gemma=gemma)
    return _rmsnorm_bwd_cuda(x, w, dy, eps=eps, gemma=gemma)


def _rmsnorm_bwd_cuda(x, w, dy, *, eps, gemma):
    """The card's route of ``rmsnorm_bwd`` (inputs checked): one counted
    launch of the backward kernel variant that ``_rmsnorm_bwd_variant``
    names."""
    flat = _flat(x)
    w = w.contiguous()
    dy = dy.reshape(flat.shape).contiguous()
    variant = _rmsnorm_bwd_variant(flat, w, dy)
    dx, dw = _launch_bwd(flat, w, dy, variant, eps=eps, gemma=gemma)
    if flat.numel():                    # an empty problem launches nothing
        rmsnorm.bwd_launches += 1
        rmsnorm.bwd_vec_launches += variant == "vec"
    return dx.reshape(x.shape), dw


class _RMSNormFn(torch.autograd.Function):
    """The forward kernel, and the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, x, w, eps, gemma):
        ctx.save_for_backward(x, w)
        ctx.opts = dict(eps=eps, gemma=gemma)
        return _forward_cuda(x, w, eps=eps, gemma=gemma)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = _rmsnorm_bwd_cuda(x, w, dy, **ctx.opts)
        return dx, dw, None, None


def _forward_cuda(x, w, *, eps, gemma):
    """One counted launch of the forward kernel variant that
    ``_rmsnorm_variant`` names, over the flattened rows of x."""
    flat = _flat(x)
    w = w.contiguous()
    variant = _rmsnorm_variant(flat, w)
    out = _launch(flat, w, variant, eps=eps, gemma=gemma)
    if out.numel():                     # an empty out launches nothing
        rmsnorm.launches += 1
        rmsnorm.vec_launches += variant == "vec"
    return out.reshape(x.shape)


def rmsnorm(x, w, *, eps: float = 1e-6, gemma: bool = False, device=None):
    """x (..., d) in fp32 or bf16, w (d,) in either -> x's shape and dtype.
    CUDA tensors launch the kernel variant that ``_rmsnorm_variant`` names
    over the flattened rows, differentiable through the backward kernel
    when x or w needs a gradient; CPU tensors, with ``device="cpu"``, run
    ``rmsnorm_ref``."""
    dev = resolve_device(device)
    check_on(dev, x, w)
    _check(x, w)
    if dev.type == "cpu":
        return rmsnorm_ref(x, w, eps=eps, gemma=gemma)
    return _rmsnorm_cuda(x, w, eps=eps, gemma=gemma)


def _rmsnorm_cuda(x, w, *, eps, gemma):
    """The card's route of ``rmsnorm`` (inputs checked): through
    ``_RMSNormFn`` when autograd records a gradient for x or w, else one
    launch of the forward kernel."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _RMSNormFn.apply(x, w, eps, gemma)
    return _forward_cuda(x, w, eps=eps, gemma=gemma)


rmsnorm.launches = 0
rmsnorm.vec_launches = 0
rmsnorm.bwd_launches = 0
rmsnorm.bwd_vec_launches = 0
