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
two variants, "vec" (a warp a row, two past 768 vectors, the row in
registers) and "simt". Each
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

from repro_torch.device import check_on, resolve_device, runs_plain
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


MAX_VECS = 896          # 16-byte vectors in a row of the vec kernels


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
BWD_WARP_VECS = 768     # vectors a row one warp of it takes; past that, two


def bwd_blocks(rows: int):
    """(blocks, rows a block) of the simt backward kernel: contiguous row
    ranges, a function of the row count alone, so dw's fixed-order sum over
    the blocks is the same on every card and every call."""
    per = -(-rows // BWD_MAX_BLOCKS)
    return -(-rows // per), per


def bwd_vec_split(vecs: int) -> int:
    """Warps of the vec backward kernel that share a row of ``vecs``
    16-byte vectors: the one place this is decided, handed to the C entry
    as its last argument (which launches the instantiation for it, or
    refuses)."""
    return 2 if vecs > BWD_WARP_VECS else 1


def bwd_vec_partition(rows: int, split: int = 1):
    """(blocks, rows a group) of the vec backward kernel, whose row groups
    are ``split`` warps each: group q of block b takes the contiguous rows
    [(g b + q) per, ...), g = BWD_VEC_WARPS / split, a function of the row
    count and the row's width alone, so dw's fixed-order sums are the same
    on every card and every call."""
    groups = BWD_VEC_WARPS // split
    per = -(-rows // (groups * BWD_VEC_MAX_BLOCKS))
    return -(-rows // (groups * per)), per


def _rmsnorm_bwd_variant(x, w, dy) -> str:
    """The backward kernel a CUDA launch over the rows of x (..., d) runs,
    chosen from the inputs alone: "vec" (16-byte loads and stores, one warp
    a row up to BWD_WARP_VECS vectors, two past it) where the forward's
    "vec" conditions hold for x and w, at most MAX_VECS vectors a row both
    ways (Gemma-3's d_model of 5376 in bf16, 672, one warp a row;
    Zamba2-7B's d_inner of 7168, 896, two), and dy is contiguous and
    16-byte-aligned, else "simt"."""
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
    split = bwd_vec_split(d // (16 // flat.element_size()))
    blocks, per = (bwd_vec_partition(rows, split) if variant == "vec" else
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
                 torch.cuda.current_stream(flat.device).cuda_stream, split)
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
    dw in w's). CUDA tensors launch the backward kernel; CPU and meta
    tensors, with ``device="cpu"`` or ``"meta"``, run ``rmsnorm_bwd_ref``. Training reaches the kernel
    through ``rmsnorm``'s autograd Function, not through this: it is the
    backward's stand-alone entry, as ``flash_attention_bwd`` is flash's, for
    callers that hold dy themselves (the tests, the kernel timings)."""
    dev = resolve_device(device)
    check_on(dev, x, w, dy)
    _check(x, w)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError("dy must match x's shape and dtype")
    if runs_plain(dev):
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
        rmsnorm.bwd_launches += 1  # repro-static: ok[jit-purity] launch counter
        rmsnorm.bwd_vec_launches += variant == "vec"  # repro-static: ok[jit-purity] launch counter
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
        rmsnorm.launches += 1  # repro-static: ok[jit-purity] launch counter
        rmsnorm.vec_launches += variant == "vec"  # repro-static: ok[jit-purity] launch counter
    return out.reshape(x.shape)


def rmsnorm(x, w, *, eps: float = 1e-6, gemma: bool = False, device=None):
    """x (..., d) in fp32 or bf16, w (d,) in either -> x's shape and dtype.
    CUDA tensors launch the kernel variant that ``_rmsnorm_variant`` names
    over the flattened rows, differentiable through the backward kernel
    when x or w needs a gradient; CPU and meta tensors, with
    ``device="cpu"`` or ``"meta"``, run ``rmsnorm_ref``."""
    dev = resolve_device(device)
    check_on(dev, x, w)
    _check(x, w)
    if runs_plain(dev):
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
