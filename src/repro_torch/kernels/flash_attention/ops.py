"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

Port of ``repro/kernels/flash_attention`` (``_fwd_kernel`` in kernel.py,
the (B, S, H, D) layout wrapper in ops.py). The kernel is
``repro_torch/csrc/flash_attention.cu``, in two variants: bf16 on the
tensor cores (``mma.sync``, ``cp.async`` loads) and a CUDA-core one for
fp32 and for unaligned views. Its note says what bounds it on the H100 and
how the design answers that.
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import check_on, resolve_device
from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)


def flash_attention_ref(q, k, v, *, causal=True, window=0, softcap=0.0,
                        scale=None):
    """Plain PyTorch version: q (B,Sq,Hq,D), k/v (B,Skv,Hkv,D) ->
    (B,Sq,Hq,D) in q's dtype, computed in fp32 with the kernel's masks."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    scale = scale or 1.0 / math.sqrt(D)
    kf = k.float().repeat_interleave(Hq // Hkv, dim=2)
    vf = v.float().repeat_interleave(Hq // Hkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, kf)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= (qpos - kpos) < window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


def _check(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention wants q (B,Sq,Hq,D) and k, v "
                         f"(B,Skv,Hkv,D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, Hq, D = q.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError("q and k/v differ in batch or head dim")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not supported (one of {HEAD_DIMS})")
    if Hq % k.shape[2]:
        raise ValueError(f"{Hq} q heads do not divide into {k.shape[2]} "
                         "kv heads")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: q, k, v "
                         "must share one of float32, bfloat16")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k, v need unit stride on the head dim")


def _flash_variant(q, k, v) -> str:
    """The kernel a CUDA launch runs, chosen from the inputs alone: "tc"
    (tensor cores, 16-byte copies) for bfloat16 whose rows start on 16-byte
    boundaries -- every stride a multiple of 8 elements, 16-byte-aligned
    data -- else "simt" (fp32 stays off the tensor cores: TF32 would break
    its 3e-5 bound)."""
    if q.dtype != torch.bfloat16:
        return "simt"
    for t in (q, k, v):
        if t.data_ptr() % 16 or any(s % 8 for s in _build.row_strides(t)):
            return "simt"
    return "tc"


def _launch(q, k, v, variant: str, *, causal, window, softcap, scale):
    """Run ``variant`` of the kernel on CUDA tensors q, k, v (checked by the
    caller) and return out; counts nothing."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    fn = _build.load("flash_attention")
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 _build.DTYPE_CODES[q.dtype], _build.VARIANT_CODES[variant],
                 B, Hq, Hkv, Sq, Skv, D,
                 *_build.row_strides(q), *_build.row_strides(k), *_build.row_strides(v),
                 int(bool(causal)), int(window), float(softcap), float(scale),
                 torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_launch("flash_attention", err)
    return out


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                    scale=None, device=None):
    """Model-layout entry: q (B,Sq,Hq,D), k/v (B,Skv,Hkv,D) -> (B,Sq,Hq,D).

    CUDA tensors launch the kernel variant that ``_flash_variant`` names
    (strided inputs are read in place); CPU tensors, with
    ``device="cpu"``, run ``flash_attention_ref``."""
    dev = resolve_device(device)
    check_on(dev, q, k, v)
    _check(q, k, v)
    scale = scale or 1.0 / math.sqrt(q.shape[3])
    if dev.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale)
    variant = _flash_variant(q, k, v)
    out = _launch(q, k, v, variant, causal=causal, window=window,
                  softcap=softcap, scale=scale)
    if out.numel():                     # an empty out launches nothing
        flash_attention.launches += 1
        flash_attention.tc_launches += variant == "tc"
    return out


flash_attention.launches = 0
flash_attention.tc_launches = 0
