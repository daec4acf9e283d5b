"""Grouped expert GEMM: the CUDA kernel's wrapper, its plain version, and
the public wrappers built on it.

Port of ``repro/kernels/moe_gemm`` (``_gemm_kernel`` in kernel.py;
``moe_grouped_gemm`` and ``expert_mlp`` in ops.py). The kernel is
``repro_torch/csrc/moe_gemm.cu``, in two variants: bf16 on the tensor cores
(``wgmma`` fed by TMA) and a CUDA-core one for fp32 and for inputs that TMA
cannot address. Its note says what bounds it on the H100 and how the design
answers that.

On CUDA tensors that need a gradient, ``grouped_gemm`` runs through
``_GemmFn``. In bf16 its backward is one launch of the fused backward
kernel (``grouped_gemm_bwd`` in the same source), which computes
dX = dY·Wᵀ reading W in place and dW = Xᵀ·dY reading X in place, dW split
along C (``split_count``) and reduced in a fixed order; it is counted once
in ``grouped_gemm.bwd_fused_calls``. Inputs that kernel does not take
(fp32, unaligned views) keep the two-launch route: dX on a contiguous copy
of Wᵀ, dW through the forward kernel's ``trans_x`` mode (tensor cores) or
on a copy of Xᵀ (CUDA cores). Either way ``grouped_gemm.bwd_launches`` /
``bwd_tc_launches`` count the products computed, dX and dW.
With no gradient to track the kernel is launched directly, as before; CPU
tensors run ``grouped_gemm_ref``, which autograd differentiates.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import check_on, resolve_device, runs_plain
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


def _lead_strides(t):
    """(expert stride, row stride) of a 3-D operand, the stride of an axis
    of length 1 replaced by the nested one: the kernel never steps along
    it, so its stride is whatever the view happened to keep."""
    E, rows, row = t.shape
    sc = t.stride(1) if rows > 1 else row
    return (t.stride(0) if E > 1 else rows * sc), sc


def _strides(x, w):
    """(x_se, x_sc, w_se, w_sk), as ``_lead_strides`` gives them."""
    return (*_lead_strides(x), *_lead_strides(w))


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


# the fused backward kernel's tiles (rows x columns x contraction step)
BLOCK_M, BLOCK_N, BLOCK_K = 128, 256, 64
MIN_UNIT_STEPS = 8      # k-steps of 64 rows in a split-K unit, at least


def split_count(E: int, d: int, f: int, C: int, sms: int) -> int:
    """dW's split count along C: the largest that keeps the units of the E
    * ceil(d/128) * ceil(f/256) output tiles to one per SM (a unit waits for
    the other units of its tile, so all of them must run at once), with at
    least MIN_UNIT_STEPS k-steps of 64 rows a unit; 1 where that leaves no
    choice."""
    tiles = E * -(-d // BLOCK_M) * -(-f // BLOCK_N)
    return max(1, min(sms // tiles, -(-C // BLOCK_K) // MIN_UNIT_STEPS))


def _bwd_variant(x, w, dy) -> str:
    """"tc" where the fused tensor-core backward takes the inputs: bf16,
    none empty, and x, w and dy each as the forward kernel's tensor-core
    variant takes them (dy as the second operand of dW = x^T.dy); else
    "simt", the two-launch route."""
    if not (x.numel() and dy.numel()):
        return "simt"
    return "tc" if (_gemm_variant(x, w) == "tc" and
                    _gemm_variant(x, dy, trans_x=True) == "tc") else "simt"


def grouped_gemm_dw_split_ref(x, dy, splits: int):
    """Plain model of the fused kernel's dW: fp32 partials of x^T.dy over
    ``splits`` ranges of whole 64-row steps of C, cut as the kernel cuts
    them, summed in split order and rounded to x's dtype once."""
    C = x.shape[1]
    nk = -(-C // BLOCK_K)
    total = None
    for s in range(splits):
        lo, hi = (nk * s // splits * BLOCK_K,
                  min(C, nk * (s + 1) // splits * BLOCK_K))
        part = torch.einsum("ecd,ecf->edf", x[:, lo:hi].float(),
                            dy[:, lo:hi].float())
        total = part if total is None else total + part
    return total.to(x.dtype)


_devices = {}   # device index -> (SM count, the fused kernel's counters)


def _device_state(dev, tiles: int):
    """The SM count of ``dev`` and its counters for the fused backward (2 +
    1 per dW tile, zero between launches: the kernel resets them),
    allocated once per device and grown when a launch needs more. The
    launches on a device share them, so they must run one after another,
    as on one stream."""
    state = _devices.get(dev.index)
    if state is None or state[1].numel() < 2 + tiles:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        state = _devices[dev.index] = (sms, torch.zeros(  # repro-static: ok[jit-purity] per-device cache, filled once
            max(2 + tiles, 1024), dtype=torch.int32, device=dev))
    return state


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_bwd(x, w, dy, need_dx: bool, need_dw: bool):
    """(dx, dw) = (dy @ w^T, x^T @ dy) per expert, the one not needed None,
    in one launch of the fused backward kernel (inputs checked by the
    caller, ``_bwd_variant`` "tc"); counts nothing."""
    E, C, d = x.shape
    f = w.shape[2]
    dev = x.device
    dx = torch.empty((E, C, d), dtype=x.dtype, device=dev) if need_dx else None
    dw = torch.empty((E, d, f), dtype=w.dtype, device=dev) if need_dw else None
    tiles = E * -(-d // BLOCK_M) * -(-f // BLOCK_N)
    sms, counters = _device_state(dev, tiles)
    splits = split_count(E, d, f, C, sms) if need_dw else 1
    part = (torch.empty(tiles * splits * BLOCK_M * BLOCK_N,
                        dtype=torch.float32, device=dev)
            if splits > 1 else None)
    args = (x.data_ptr(), w.data_ptr(), dy.data_ptr(), _ptr(dx), _ptr(dw),
            _ptr(part), counters.data_ptr(), E, C, d, f, splits,
            *_strides(x, w), *_lead_strides(dy),
            torch.cuda.current_stream(dev).cuda_stream)
    fn = _build.load("moe_gemm", "grouped_gemm_bwd")
    if dev.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(dev):
            err = fn(*args)
    _build.check_launch("moe_gemm backward", err)
    return dx, dw


def _launch_bwd_product(a, b, trans_x: bool = False):
    """One backward product a @ b (a^T @ b with ``trans_x``) on the kernel,
    counted in ``bwd_launches`` (and ``bwd_tc_launches`` on the tensor
    cores)."""
    variant = _gemm_variant(a, b, trans_x)
    out = _launch(a, b, variant, trans_x)
    if out.numel():
        grouped_gemm.bwd_launches += 1  # repro-static: ok[jit-purity] launch counter
        grouped_gemm.bwd_tc_launches += variant == "tc"  # repro-static: ok[jit-purity] launch counter
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
        return _backward(x, w, dy, *ctx.needs_input_grad[:2])


def _backward(x, w, dy, need_dx: bool, need_dw: bool):
    """(dx, dw) for the gradient dy of out = x @ w, each None where it is
    not needed: one launch of the fused kernel where ``_bwd_variant``
    says "tc", else ``_backward_two_launches``."""
    if dy.stride(-1) != 1:
        dy = dy.contiguous()
    if not (need_dx or need_dw):
        return None, None
    if _bwd_variant(x, w, dy) != "tc":
        return _backward_two_launches(x, w, dy, need_dx, need_dw)
    dx, dw = _launch_bwd(x, w, dy, need_dx, need_dw)
    grouped_gemm.bwd_launches += need_dx + need_dw  # repro-static: ok[jit-purity] launch counter
    grouped_gemm.bwd_tc_launches += need_dx + need_dw  # repro-static: ok[jit-purity] launch counter
    grouped_gemm.bwd_fused_calls += 1  # repro-static: ok[jit-purity] launch counter
    return dx, dw


def _backward_two_launches(x, w, dy, need_dx: bool, need_dw: bool):
    """The backward as two launches of the forward kernel: dX on a
    contiguous copy of W^T, dW reading x in place (``trans_x``) where the
    tensor-core variant takes it, else on a contiguous copy of x^T."""
    dx = dw = None
    if need_dx:
        dx = _launch_bwd_product(dy, w.transpose(1, 2).contiguous())
    if need_dw:
        if _gemm_variant(x, dy, trans_x=True) == "tc":
            dw = _launch_bwd_product(x, dy, trans_x=True)
        else:
            dw = _launch_bwd_product(x.transpose(1, 2).contiguous(), dy)
    return dx, dw


def _forward(x, w):
    variant = _gemm_variant(x, w)
    out = _launch(x, w, variant)
    if out.numel():                     # an empty out launches nothing
        grouped_gemm.launches += 1  # repro-static: ok[jit-purity] launch counter
        grouped_gemm.tc_launches += variant == "tc"  # repro-static: ok[jit-purity] launch counter
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
    strided), differentiable through ``_GemmFn`` (one launch of the fused
    backward kernel in bf16) when x or w needs a gradient; CPU and meta
    tensors, with ``device="cpu"`` or ``"meta"``, run
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
    if runs_plain(dev):
        return grouped_gemm_ref(x, w)
    return _gemm_cuda(x, w)


grouped_gemm.launches = 0
grouped_gemm.tc_launches = 0
grouped_gemm.bwd_launches = 0
grouped_gemm.bwd_tc_launches = 0
grouped_gemm.bwd_fused_calls = 0


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
