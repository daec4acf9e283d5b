"""Flash attention: the CUDA kernels' wrappers, their plain versions, and
the autograd wiring that makes ``flash_attention`` differentiable on the
card.

Port of ``repro/kernels/flash_attention`` (``_fwd_kernel`` in kernel.py,
the (B, S, H, D) layout wrapper in ops.py). The forward kernel is
``repro_torch/csrc/flash_attention.cu``, in two variants: bf16 on the
tensor cores (head dims the multiples of 16 up to 128) and a CUDA-core one
for fp32, unaligned views and the other head dims up to 128 (the Pallas
kernel takes any head dim; past 128 both raise). The
backward kernel, ``repro_torch/csrc/flash_attention_bwd.cu``, computes the
VJP the JAX package writes out for its chunked attention (``flash_bwd``,
``repro/models/attention.py:168-204``); the Pallas kernel has none. It has
two variants too: bf16 on the tensor cores, for every input the forward
sends there, and a CUDA-core one for fp32 and unaligned views. Each
tensor-core variant has three forms, chosen by its C entry point from the
shapes (``fwd_form`` and ``bwd_tc_form`` mirror the rules): a short form
for heads that fit one block's shared memory whole (the agent's trunk,
``mma.sync``), the Hopper streaming form ("wg": ``wgmma`` fed by TMA
rings, D from 48, every LM layer: 48 on its D = 64 kernels, HuBERT's 80
and Zamba2's 112 on its D = 128 ones, the columns past D read as zeros)
and the ``mma.sync`` streaming form ("stream", D = 16 and 32). The
wrappers count the Hopper form's launches in ``wg_launches``; ``_launch``
and ``_launch_bwd`` can name a form (the C entries' last argument) to time
one against another. Each source's note says what bounds it on the H100
and how the design answers that.

On CUDA tensors that need a gradient, ``flash_attention`` runs through
``_FlashFn``: its forward asks the kernel for each row's log-sum-exp, and
its backward launches the backward kernel (``flash_attention_bwd``), both
with the call's masks, the window included (Gemma-3's local layers train
through it). With no gradient to track (serving, ``inference_mode``) the
forward kernel is launched directly. CPU tensors run the plain versions,
which autograd differentiates; meta tensors (a step's memory counted before
the card runs it) allocate what the kernels do and launch nothing.
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import check_on, resolve_device, runs_plain
from repro_torch.kernels import _build
from repro_torch.roofline import hw

NEG_INF = -1e30
# the head dims the kernels take: the CUDA-core variant any D up to
# MAX_HEAD_DIM (compiled at 16, 32, 64 and 128, a D between them on the next
# with the columns past D masked), the tensor-core variant the multiples of
# 16 up to it
MAX_HEAD_DIM = 128
HEAD_DIMS = tuple(range(16, MAX_HEAD_DIM + 1, 16))
# the tensor-core backward's short form's limits (csrc/flash_attention_bwd.cu,
# tc::): the longest sequence its dS^T tile holds, and an H100 block's
# shared memory
BWD_TC_MAX_S = 256
BWD_TC_MAX_SMEM = 232448
# the streaming form's kv rows a dkdv block, and the blocks an SM its split
# count aims at
BWD_KV_ROWS = 64
BWD_BLOCKS_PER_SM = 4
# the forward's short form: at most this many q rows, q, K and V within the
# default 48 KB of shared memory (csrc/flash_attention.cu, tc::short_fits)
FWD_SHORT_MAX_S = 256
FWD_SHORT_SMEM = 48 * 1024
# the head dims of the Hopper streaming forms ("wg": wgmma fed by TMA; 48
# runs on their D = 64 kernels, 80, 96 and 112 on their D = 128 ones, the
# columns past D read as zeros), the kv rows of their dkdv block, and the
# blocks an SM their split count aims at: one block is resident an SM (160
# KB of shared memory, 384 threads), and 2 a SM picked the fastest share
# count at the LM training layers (chip_smoke.py phase 5's splits_ms on an
# H100: Command-R's 1, TinyLlama's 2, Qwen2-VL's 2 within 1% of its best)
WG_HEAD_DIMS = (48, 64, 80, 96, 112, 128)
BWD_WG_KV_ROWS = 128
BWD_WG_BLOCKS_PER_SM = 2


def _mask(Sq, Skv, causal, window, device):
    qpos = torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= (qpos - kpos) < window
    return mask


def _logits_ref(q, k, *, causal, window, softcap, scale):
    """fp32 masked logits (B, Hq, Sq, Skv), GQA by head index."""
    Sq, Hq = q.shape[1], q.shape[2]
    kf = k.float().repeat_interleave(Hq // k.shape[2], dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, kf)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    mask = _mask(Sq, k.shape[1], causal, window, q.device)
    return torch.where(mask, s, torch.full_like(s, NEG_INF))


def flash_attention_ref(q, k, v, *, causal=True, window=0, softcap=0.0,
                        scale=None):
    """Plain PyTorch version: q (B,Sq,Hq,D), k/v (B,Skv,Hkv,D) ->
    (B,Sq,Hq,D) in q's dtype, computed in fp32 with the kernel's masks."""
    Hq, D = q.shape[2], q.shape[3]
    scale = scale or 1.0 / math.sqrt(D)
    s = _logits_ref(q, k, causal=causal, window=window, softcap=softcap,
                    scale=scale)
    p = torch.softmax(s, dim=-1)
    vf = v.float().repeat_interleave(Hq // v.shape[2], dim=2)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


def flash_attention_lse_ref(q, k, *, causal=True, window=0, softcap=0.0,
                            scale=None):
    """Plain version of the forward's second output: each row's
    log-sum-exp of its masked logits, fp32 (B, Hq, Sq)."""
    scale = scale or 1.0 / math.sqrt(q.shape[3])
    return torch.logsumexp(_logits_ref(q, k, causal=causal, window=window,
                                       softcap=softcap, scale=scale), dim=-1)


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal=True, window=0,
                            softcap=0.0, scale=None):
    """Plain version of the backward kernel, step by step as the JAX
    package's ``flash_bwd`` (``repro/models/attention.py:168-204``): the
    probabilities recomputed from ``lse`` under the forward's masks (the
    window as its position bias), fp32 throughout, GQA's dk and dv summed
    over each kv head's q heads. Returns (dq, dk, dv) in the inputs' dtypes
    and shapes."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    scale = scale or 1.0 / math.sqrt(D)
    qs = q.float() * scale
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    go = do.float().transpose(1, 2)                          # (B,H,Sq,D)
    oo = o.float().transpose(1, 2)
    delta = (go * oo).sum(-1)                                # (B,H,Sq)
    raw = torch.einsum("bqhd,bkhd->bhqk", qs, kf)
    capped = torch.tanh(raw / softcap) * softcap if softcap else raw
    bias = torch.where(_mask(Sq, Skv, causal, window, q.device), 0.0,
                       NEG_INF)
    p = torch.exp(capped + bias - lse[..., None].float())    # (B,H,Sq,Skv)
    dv = torch.einsum("bhqk,bhqd->bkhd", p, go)
    dp = torch.einsum("bhqd,bkhd->bhqk", go, vf)
    ds = p * (dp - delta[..., None])
    if softcap:
        ds = ds * (1.0 - torch.square(capped / softcap))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qs)
    # _repeat_kv's adjoint: sum each kv head's q heads
    dk = dk.unflatten(2, (Hkv, rep)).sum(3)
    dv = dv.unflatten(2, (Hkv, rep)).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention wants q (B,Sq,Hq,D) and k, v "
                         f"(B,Skv,Hkv,D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, Hq, D = q.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError("q and k/v differ in batch or head dim")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} not supported: the kernels take 1 to "
                         f"{MAX_HEAD_DIM}")
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
    (tensor cores, 16-byte copies) for bfloat16 at a head dim in HEAD_DIMS
    whose rows start on 16-byte boundaries -- every stride a multiple of 8
    elements, 16-byte-aligned data -- else "simt" (fp32 stays off the
    tensor cores: TF32 would break its 3e-5 bound; a head dim off the
    multiples of 16 runs on the CUDA cores in either dtype)."""
    if q.dtype != torch.bfloat16 or q.shape[3] not in HEAD_DIMS:
        return "simt"
    for t in (q, k, v):
        if t.data_ptr() % 16 or any(s % 8 for s in _build.row_strides(t)):
            return "simt"
    return "tc"


def fwd_form(Sq: int, Skv: int, D: int) -> str:
    """The form of the tensor-core forward the C entry point runs
    (``launch_tc`` in csrc/flash_attention.cu): "short" where q, K and V
    fit one block's default shared memory (the agent's trunk), else "wg",
    the Hopper streaming form (wgmma fed by TMA), at D in WG_HEAD_DIMS,
    else "stream", the mma.sync streaming form (D = 16, 32). Every form
    takes every D of HEAD_DIMS where it is named (``_launch``'s ``form``)."""
    sq16, skv16 = -(-Sq // 16) * 16, -(-Skv // 16) * 16
    if sq16 <= FWD_SHORT_MAX_S and (sq16 + 2 * skv16) * D * 2 <= FWD_SHORT_SMEM:
        return "short"
    return "wg" if D in WG_HEAD_DIMS else "stream"


def _launch(q, k, v, variant: str, *, causal, window, softcap, scale,
            lse=False, form=None):
    """Run ``variant`` of the kernel on CUDA tensors q, k, v (checked by the
    caller) and return out, or (out, lse) with ``lse``; counts nothing. On
    meta tensors it allocates the same and launches nothing.
    ``form`` names the tensor-core form to run (``fwd_form``'s names; by
    default the C entry's own choice): phase 5 and the card's tests time
    and check one form against another."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
    lse_t = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
             if lse else None)
    if out.numel() == 0 or q.is_meta:
        return (out, lse_t) if lse else out
    fn = _build.load("flash_attention")
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse_t.data_ptr() if lse else None,
                 _build.DTYPE_CODES[q.dtype], _build.VARIANT_CODES[variant],
                 B, Hq, Hkv, Sq, Skv, D,
                 *_build.row_strides(q), *_build.row_strides(k), *_build.row_strides(v),
                 int(bool(causal)), int(window), float(softcap), float(scale),
                 torch.cuda.current_stream(q.device).cuda_stream,
                 _build.FORM_CODES[form or "auto"])
    _build.check_launch("flash_attention", err)
    return (out, lse_t) if lse else out


def bwd_smem_bytes(Sq: int, Skv: int, D: int) -> int:
    """Shared memory of the tensor-core backward's short form
    (``tc::smem_bytes``): q, dO, K, V in bf16, dS^T rows of BWD_TC_MAX_S,
    lse and delta."""
    sq16, skv16 = -(-Sq // 16) * 16, -(-Skv // 16) * 16
    return 4 * D * (sq16 + skv16) + skv16 * BWD_TC_MAX_S * 2 + 8 * sq16


def bwd_tc_form(Sq: int, Skv: int, Hq: int, Hkv: int, D: int) -> str:
    """The form of the tensor-core backward the C entry point runs
    (csrc/flash_attention_bwd.cu): "short" for MHA heads with D <= 64
    whose q, dO, K, V and dS^T fit one block's shared memory (both
    sequences <= BWD_TC_MAX_S; ``short_form``), else "wg", the Hopper
    streaming form, at D in WG_HEAD_DIMS, else "stream", the mma.sync
    streaming form (D = 16, 32). The streaming forms take every D of
    HEAD_DIMS where they are named, the short form D <= 64."""
    if Hq == Hkv and D <= 64 and max(Sq, Skv) <= BWD_TC_MAX_S \
            and bwd_smem_bytes(Sq, Skv, D) <= BWD_TC_MAX_SMEM:
        return "short"
    return "wg" if D in WG_HEAD_DIMS else "stream"


def bwd_splits(B: int, Skv: int, Hkv: int, group: int, sms: int,
               form: str = "wg") -> int:
    """How many dkdv blocks of a streaming form share a kv head's
    ``group`` q heads, keeping the grid (B * Hkv * ceil(Skv / rows) blocks
    a share) within a number of blocks an SM. Under the causal mask the
    first kv tiles see the most q rows; more, smaller blocks let the card
    spread them. The Hopper form ("wg", 128 kv rows a block, within
    BWD_WG_BLOCKS_PER_SM) takes the largest count up to the group, even or
    not (share i of n takes the q heads [i g / n, (i + 1) g / n)), so
    Qwen2-VL's group of 7 splits too; the mma.sync form ("stream", 64
    rows, within BWD_BLOCKS_PER_SM) the largest power of two dividing the
    group. A window takes the same rule: at Gemma-3's local
    training layer the mma.sync form picks 1 share, the faster of 1 and 2
    (chip_smoke.py phase 5's splits_ms on an H100). Above 1 the shares
    write fp32 partials that a last pass sums in split order."""
    if form == "wg":
        blocks = B * Hkv * -(-Skv // BWD_WG_KV_ROWS)
        return max(1, min(group, BWD_WG_BLOCKS_PER_SM * sms // blocks))
    cap = BWD_BLOCKS_PER_SM * sms
    blocks = B * Hkv * -(-Skv // BWD_KV_ROWS)
    s = 1
    while group % (2 * s) == 0 and blocks * 2 * s <= cap:
        s *= 2
    return s


def _flash_bwd_variant(q, k, v, o, do) -> str:
    """The backward kernel a CUDA launch runs, chosen from the inputs alone
    (o and do contiguous): "tc" where the forward takes the tensor cores
    and, besides, o and do start on 16 bytes, at any head count, sequence
    length and head dim the forward takes; else "simt" (fp32 and views off
    16 bytes)."""
    if _flash_variant(q, k, v) != "tc" or o.data_ptr() % 16 \
            or do.data_ptr() % 16:
        return "simt"
    return "tc"


def _launch_bwd(q, k, v, o, lse, do, variant: str, *, causal, window=0,
                softcap, scale, splits=None, form=None):
    """Run ``variant`` of the backward kernel on CUDA tensors (o and do
    contiguous) and return (dq, dk, dv); counts nothing (on meta tensors:
    the same allocations, the card's split count, no launch). ``form`` names the
    tensor-core form (``bwd_tc_form``'s names; by default the C entry's own
    choice). A streaming tensor-core form shares a kv head's q heads among
    ``splits`` blocks (by default ``bwd_splits`` for that form), with fp32
    scratch for their partials."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    dq = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Skv, Hkv, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, Skv, Hkv, D), dtype=v.dtype, device=q.device)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    if splits is None:
        # the short form's MHA heads (a group of 1) always take 1
        splits = 1 if variant != "tc" else bwd_splits(
            B, Skv, Hkv, Hq // Hkv, hw.SMS if q.is_meta else
            torch.cuda.get_device_properties(q.device).multi_processor_count,
            form or bwd_tc_form(Sq, Skv, Hq, Hkv, D))
    part = (torch.empty(2 * splits * dk.numel(), dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    if q.is_meta:
        return dq, dk, dv
    fn = _build.load("flash_attention_bwd")
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 None if part is None else part.data_ptr(),
                 _build.DTYPE_CODES[q.dtype], _build.VARIANT_CODES[variant],
                 splits, B, Hq, Hkv, Sq, Skv, D,
                 *_build.row_strides(q), *_build.row_strides(k),
                 *_build.row_strides(v), int(bool(causal)), int(window),
                 float(softcap), float(scale),
                 torch.cuda.current_stream(q.device).cuda_stream,
                 _build.FORM_CODES[form or "auto"])
    _build.check_launch("flash_attention_bwd", err)
    return dq, dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, *, causal=True, window=0,
                        softcap=0.0, scale=None, device=None):
    """The backward of ``flash_attention`` from its out ``o`` and row
    log-sum-exp ``lse`` (fp32 (B, Hq, Sq)) and the out's gradient ``do``,
    under the forward's masks (``causal``, ``window``): (dq, dk, dv) in
    the inputs' dtypes and shapes. CUDA tensors launch the backward kernel
    variant that ``_flash_bwd_variant`` names; CPU tensors, with
    ``device="cpu"``, run ``flash_attention_bwd_ref``; meta tensors, with
    ``device="meta"``, allocate what the kernel does and launch nothing."""
    dev = resolve_device(device)
    check_on(dev, q, k, v, o, lse, do)
    _check(q, k, v)
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError("o and do must match q's shape and dtype")
    if lse.shape != (q.shape[0], q.shape[2], q.shape[1]) \
            or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 (B, Hq, Sq); got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    scale = scale or 1.0 / math.sqrt(q.shape[3])
    if dev.type == "meta":
        return _launch_bwd(q, k, v, o.contiguous(), lse, do.contiguous(),
                           _flash_bwd_variant(q, k, v, o, do), causal=causal,
                           window=window, softcap=softcap, scale=scale)
    if runs_plain(dev):
        return flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       window=window, softcap=softcap,
                                       scale=scale)
    return _flash_bwd_cuda(q, k, v, o, lse, do, causal=causal, window=window,
                           softcap=softcap, scale=scale)


flash_attention_bwd.launches = 0
flash_attention_bwd.tc_launches = 0
flash_attention_bwd.wg_launches = 0


def _flash_bwd_cuda(q, k, v, o, lse, do, *, causal, window, softcap, scale):
    """The card's route of ``flash_attention_bwd`` (inputs checked): one
    counted launch of the variant ``_flash_bwd_variant`` names."""
    o, do = o.contiguous(), do.contiguous()
    variant = _flash_bwd_variant(q, k, v, o, do)
    grads = _launch_bwd(q, k, v, o, lse.contiguous(), do, variant,
                        causal=causal, window=window, softcap=softcap,
                        scale=scale)
    if q.numel() and k.numel():         # an empty problem launches nothing
        flash_attention_bwd.launches += 1  # repro-static: ok[jit-purity] launch counter
        flash_attention_bwd.tc_launches += variant == "tc"  # repro-static: ok[jit-purity] launch counter
        flash_attention_bwd.wg_launches += variant == "tc" and bwd_tc_form(  # repro-static: ok[jit-purity] launch counter
            q.shape[1], k.shape[1], q.shape[2], k.shape[2], q.shape[3]) == "wg"
    return grads


class _FlashFn(torch.autograd.Function):
    """The forward kernel with the row log-sum-exp kept, and the backward
    kernel as its gradient, both under the call's masks."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        variant = _flash_variant(q, k, v)
        out, lse = _launch(q, k, v, variant, causal=causal, window=window,
                           softcap=softcap, scale=scale, lse=True)
        _count(out, k, variant)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap,
                        scale=scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_cuda(q, k, v, out, lse, do, **ctx.opts)
        return dq, dk, dv, None, None, None, None


class _FlashMetaFn(torch.autograd.Function):
    """Meta tensors (shapes only, a step's memory counted before the card
    runs it): what the kernels allocate, launching nothing and counting
    nothing -- out and the row log-sum-exp forward; dq, dk, dv, delta and
    a split's fp32 partials backward; never the plain version's S x S
    scores."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        out, lse = _launch(q, k, v, _flash_variant(q, k, v), causal=causal,
                           window=window, softcap=softcap, scale=scale,
                           lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap,
                        scale=scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        dq, dk, dv = _launch_bwd(q, k, v, out, lse, do,
                                 _flash_bwd_variant(q, k, v, out, do),
                                 **ctx.opts)
        return dq, dk, dv, None, None, None, None


def _count(out, k, variant: str) -> None:
    if out.numel():                     # an empty out launches nothing
        flash_attention.launches += 1  # repro-static: ok[jit-purity] launch counter
        flash_attention.tc_launches += variant == "tc"  # repro-static: ok[jit-purity] launch counter
        flash_attention.wg_launches += variant == "tc" and fwd_form(  # repro-static: ok[jit-purity] launch counter
            out.shape[1], k.shape[1], out.shape[3]) == "wg"


def _flash_cuda(q, k, v, *, causal, window, softcap, scale):
    """The card's route of ``flash_attention`` (inputs checked): through
    ``_FlashFn`` when autograd records a gradient for q, k or v, else one
    launch of the forward kernel."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashFn.apply(q, k, v, causal, window, softcap, scale)
    variant = _flash_variant(q, k, v)
    out = _launch(q, k, v, variant, causal=causal, window=window,
                  softcap=softcap, scale=scale)
    _count(out, k, variant)
    return out


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                    scale=None, device=None):
    """Model-layout entry: q (B,Sq,Hq,D), k/v (B,Skv,Hkv,D) -> (B,Sq,Hq,D).

    CUDA tensors launch the kernel variant that ``_flash_variant`` names
    (strided inputs are read in place), differentiable through the
    backward kernel when q, k or v needs a gradient; CPU tensors, with
    ``device="cpu"``, run ``flash_attention_ref``; meta tensors, with
    ``device="meta"``, go through ``_FlashMetaFn``: the kernels'
    allocations, no launch and no S x S scores."""
    dev = resolve_device(device)
    check_on(dev, q, k, v)
    _check(q, k, v)
    scale = scale or 1.0 / math.sqrt(q.shape[3])
    if dev.type == "meta":
        return _FlashMetaFn.apply(q, k, v, causal, window, softcap, scale)
    if runs_plain(dev):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale)
    return _flash_cuda(q, k, v, causal=causal, window=window,
                       softcap=softcap, scale=scale)


flash_attention.launches = 0
flash_attention.tc_launches = 0
flash_attention.wg_launches = 0
