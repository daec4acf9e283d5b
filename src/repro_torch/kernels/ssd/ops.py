"""Mamba-2 SSD chunked scan: the CUDA kernel's wrapper and its plain version.

Port of ``repro/kernels/ssd`` (``_ssd_kernel`` in kernel.py, the group
wrapper in ops.py) and of the function it fuses,
``repro/models/ssm.py::ssd_chunked``. Unlike the Pallas kernel, both
versions here also return the final state and take an initial one, as
``ssd_chunked`` does, and read B and C by group instead of repeating them
to every head. The kernel is ``repro_torch/csrc/ssd.cu``, in two variants:
bf16 on the tensor cores ("tc": ``mma.sync``, ``cp.async`` loads) and a
CUDA-core one for fp32 and for inputs the 16-byte copies cannot address
("simt"). The backward kernels, ``repro_torch/csrc/ssd_bwd.cu``, compute
the VJP that JAX's autodiff gives ``ssd_chunked`` (the Pallas kernel has
none), in the same two variants: "tc" for bf16 whose whole chunk fits
shared memory, "simt" for the rest. Each source's note says what bounds it
on the H100 and how the design answers that.

On CUDA tensors that need a gradient, ``ssd`` runs through ``_SSDFn``: its
forward launches the forward kernel, its backward the backward kernel
(``ssd_bwd``). With no gradient to track (serving, ``inference_mode``) the
forward kernel is launched directly. CPU tensors run the plain versions,
which autograd differentiates.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import check_on, resolve_device, runs_plain
from repro_torch.kernels import _build
from repro_torch.roofline.scope import kernel_scope

HEAD_DIMS = (16, 32, 64, 128)
TC_STATE_DIMS = (16, 32, 64, 128)   # N of the tensor-core variant
MAX_SMEM_BYTES = 232_448            # an H100 block's dynamic shared memory
_TILE = 64                          # chunk positions per tile in ssd.cu
_TC_WARPS = 8                       # warps of a tc block
_TC_ROWS = 16 * _TC_WARPS           # chunk rows per row tile of the tc kernel


def smem_bytes(P: int, N: int, Q: int, variant: str = "simt") -> int:
    """Shared memory of one launch (``simt_smem_bytes`` and
    ``tc::smem_bytes`` in ssd.cu). simt: the fp32 state, C and B tiles, x
    tile, score tile, and the chunk's dt and cumsum. tc: two bf16 C row
    tiles, two B and two x column tiles, the bf16 state copy, the warps' y
    staging rows, per chunk position (Q rounded up to whole column tiles)
    two dt buffers, the cumsum, the update's weights and the scores' column
    factors, and the scan's warp totals."""
    if variant == "tc":
        qt = -(-Q // _TILE) * _TILE
        return (4 * _TC_ROWS * N + 4 * _TILE * N + 4 * _TILE * P + 2 * P * N
                + 2 * _TC_ROWS * P + 20 * qt + 4 * _TC_WARPS)
    ld = _TILE + 4
    return 4 * (N * P + 2 * N * ld + _TILE * (P + 4) + _TILE * ld + 2 * Q)


def ssd_ref(x, dt, A, B, C, D, chunk: int, initial_state=None):
    """Plain PyTorch version, ``ssd_chunked`` written out.

    x (Bz,S,H,P); dt (Bz,S,H) softplus'd; A, D (H,); B, C (Bz,S,G,N) with
    H % G == 0; initial_state (Bz,H,P,N) or None for zeros. Returns
    y (Bz,S,H,P) in x's dtype and the final state (Bz,H,P,N) in fp32. The
    inter-chunk recurrence is a Python loop over chunks."""
    Bsz, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    xs = x
    if pad:
        xs = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    xc = xs.reshape(Bsz, nc, Q, H, P).float()
    dtc = dt.reshape(Bsz, nc, Q, H).float()
    Bc = B.reshape(Bsz, nc, Q, G, N).float().repeat_interleave(rep, dim=3)
    Cc = C.reshape(Bsz, nc, Q, G, N).float().repeat_interleave(rep, dim=3)

    seg = torch.cumsum(dtc * A.float(), dim=2)                  # (B,nc,Q,H)
    total = seg[:, :, -1:, :]
    # intra-chunk: the part the kernel fuses (the reference's "pallas_ssd"
    # scope, which the dry run's roofline counts as on-chip)
    with kernel_scope("ssd"):
        mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                     device=x.device))
        L = torch.where(mask[None, None, :, :, None],
                        torch.exp(seg[:, :, :, None, :]
                                  - seg[:, :, None, :, :]),
                        0.0)                                     # (B,nc,Q,Q,H)
        CB = torch.einsum("bcqhn,bckhn->bcqkh", Cc, Bc)
        scores = CB * L * dtc[:, :, None, :, :]
        y_intra = torch.einsum("bcqkh,bckhp->bcqhp", scores, xc)
        states = torch.einsum("bcqh,bcqhn,bcqhp->bchpn",
                              torch.exp(total - seg) * dtc, Bc,
                              xc)                                # (B,nc,H,P,N)

    # inter-chunk recurrence
    chunk_decay = torch.exp(total[:, :, 0, :])                   # (B,nc,H)
    s = (initial_state.float() if initial_state is not None else
         torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device))
    prev = []
    for c in range(nc):
        prev.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                       # (B,nc,H,P,N)

    y_inter = torch.einsum("bcqhn,bcqh,bchpn->bcqhp", Cc, torch.exp(seg),
                           prev_states)
    y = (y_intra + y_inter).reshape(Bsz, nc * Q, H, P)[:, :S]
    y = y + x.float() * D.float()[None, None, :, None]
    return y.to(x.dtype), s


def _chunks(t, Q: int, nc: int):
    """(Bz, S, ...) -> (Bz, nc, Q, ...) in fp32, zeros past S."""
    pad = nc * Q - t.shape[1]
    t = t.float()
    if pad:
        t = torch.cat([t, t.new_zeros((t.shape[0], pad) + t.shape[2:])], 1)
    return t.reshape((t.shape[0], nc, Q) + t.shape[2:])


def ssd_bwd_ref(x, dt, A, B, C, D, chunk: int, dy, initial_state=None,
                d_final=None):
    """Plain version of the backward kernel, written as the kernel computes
    it: the states entering each chunk recomputed (the forward's chunk
    states and inter-chunk scan), then a reverse walk over the chunks that
    carries the gradient of the outgoing state (P, N), seeded with
    ``d_final`` (zeros if None), through each chunk's quadratic gradients.
    Everything in fp32. Returns (dx in x's dtype, ddt fp32, dA (H,), dB and
    dC (Bz,S,G,N) in B's dtype, summed over each group's heads, dD (H,),
    d_initial_state fp32 or None without an initial state)."""
    Bsz, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    Q = min(chunk, S)
    nc = -(-S // Q)
    xc, dyc = _chunks(x, Q, nc), _chunks(dy, Q, nc)           # (B,nc,Q,H,P)
    dtc = _chunks(dt, Q, nc)                                   # (B,nc,Q,H)
    Bc = _chunks(B, Q, nc).repeat_interleave(rep, dim=3)      # (B,nc,Q,H,N)
    Cc = _chunks(C, Q, nc).repeat_interleave(rep, dim=3)
    Af, Df = A.float(), D.float()
    seg = torch.cumsum(dtc * Af, dim=2)
    total = seg[:, :, -1, :]                                   # (B,nc,H)
    decay = torch.exp(total[:, :, None, :] - seg)              # (B,nc,Q,H)
    w = decay * dtc
    # 1. the states entering each chunk
    states = torch.einsum("bcqh,bcqhp,bcqhn->bchpn", w, xc, Bc)
    s = (initial_state.float() if initial_state is not None else
         x.new_zeros((Bsz, H, P, N), dtype=torch.float32))
    s_in = []
    for c in range(nc):
        s_in.append(s)
        s = s * torch.exp(total[:, c])[..., None, None] + states[:, c]
    # 2. the reverse walk
    dS = (d_final.float() if d_final is not None else
          x.new_zeros((Bsz, H, P, N), dtype=torch.float32))
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    dx, ddt, dB, dC = ([None] * nc for _ in range(4))
    dA = x.new_zeros((H,), dtype=torch.float32)
    dD = x.new_zeros((H,), dtype=torch.float32)
    for c in reversed(range(nc)):
        X, Y, Bt, Ct = xc[:, c], dyc[:, c], Bc[:, c], Cc[:, c]
        dtq, sg, wq, tot = dtc[:, c], seg[:, c], w[:, c], total[:, c]
        Sin = s_in[c]
        esg = torch.exp(sg)                                    # (B,Q,H)
        # S_out = exp(total) S_in + sum_s w_s x_s B_s^T
        dtot = torch.exp(tot) * (dS * Sin).sum((-2, -1))       # (B,H)
        V = torch.einsum("bhpn,bshn->bshp", dS, Bt)
        dw = (V * X).sum(-1)                                   # (B,Q,H)
        dxc = wq[..., None] * V
        dBc = wq[..., None] * torch.einsum("bhpn,bshp->bshn", dS, X)
        ddtc = decay[:, c] * dw
        dtot = dtot + (wq * dw).sum(1)
        dseg = -wq * dw
        # y_inter_t = exp(seg_t) C_t . S_in
        yi = esg[..., None] * torch.einsum("bhpn,bthn->bthp", Sin, Ct)
        dseg = dseg + (Y * yi).sum(-1)
        dCc = esg[..., None] * torch.einsum("bhpn,bthp->bthn", Sin, Y)
        # y_intra_t = sum_{s<=t} (C_t.B_s) L_ts dt_s x_s
        L = torch.where(mask[None, :, :, None],
                        torch.exp(sg[:, :, None, :] - sg[:, None, :, :]), 0.0)
        Gm = torch.einsum("bthp,bshp->btsh", Y, X)
        CB = torch.einsum("bthn,bshn->btsh", Ct, Bt)
        scores = CB * L * dtq[:, None, :, :]
        dCB = Gm * L * dtq[:, None, :, :]
        dxc = dxc + torch.einsum("btsh,bthp->bshp", scores, Y)
        dBc = dBc + torch.einsum("btsh,bthn->bshn", dCB, Ct)
        dCc = dCc + torch.einsum("btsh,bshn->bthn", dCB, Bt)
        ddtc = ddtc + (Gm * CB * L).sum(1)
        M = Gm * scores
        dseg = dseg + M.sum(2) - M.sum(1)
        # + D x
        dxc = dxc + Df[None, None, :, None] * Y
        dD = dD + (Y * X).sum((0, 1, 3))
        # seg = cumsum(dt A), total = seg[-1]
        dseg[:, -1] = dseg[:, -1] + dtot
        da = torch.flip(torch.cumsum(torch.flip(dseg, [1]), 1), [1])
        ddtc = ddtc + Af * da
        dA = dA + (dtq * da).sum((0, 1))
        dx[c], ddt[c], dB[c], dC[c] = dxc, ddtc, dBc, dCc
        # the gradient of the state entering this chunk
        dS = dS * torch.exp(tot)[..., None, None] + torch.einsum(
            "bth,bthp,bthn->bhpn", esg, Y, Ct)

    def whole(parts):
        t = torch.stack(parts, 1)
        return t.reshape((Bsz, nc * Q) + t.shape[3:])[:, :S]
    dBg = whole(dB).unflatten(2, (G, rep)).sum(3)
    dCg = whole(dC).unflatten(2, (G, rep)).sum(3)
    return (whole(dx).to(x.dtype), whole(ddt), dA, dBg.to(B.dtype),
            dCg.to(B.dtype), dD, dS if initial_state is not None else None)


def _check(x, dt, A, B, C, D, chunk, initial_state):
    if x.ndim != 4 or B.ndim != 4 or B.shape != C.shape:
        raise ValueError(f"ssd wants x (Bz,S,H,P) and B, C (Bz,S,G,N); got "
                         f"{tuple(x.shape)}, {tuple(B.shape)}, {tuple(C.shape)}")
    Bz, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if B.shape[:2] != (Bz, S) or dt.shape != (Bz, S, H) or \
            A.shape != (H,) or D.shape != (H,) or H % G or not S or chunk < 1:
        raise ValueError(f"ssd: dt {tuple(dt.shape)}, A {tuple(A.shape)}, D "
                         f"{tuple(D.shape)}, B {tuple(B.shape)} do not fit x "
                         f"{tuple(x.shape)} with H % G == 0, S > 0 and "
                         f"chunk {chunk} > 0")
    if initial_state is not None and (initial_state.shape != (Bz, H, P, N) or
                                      initial_state.dtype != torch.float32):
        raise ValueError("initial_state must be fp32 of shape (Bz,H,P,N)")
    if not (x.dtype == B.dtype == C.dtype) or x.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"dtypes {x.dtype}, {B.dtype}, {C.dtype}: x, B, C "
                         "must share one of float32, bfloat16")
    if any(t.dtype != torch.float32 for t in (dt, A, D)):
        raise ValueError("dt, A and D must be float32")


def _ssd_variant(x, B, C) -> str:
    """The kernel a CUDA launch runs, chosen from the inputs alone: "tc"
    (tensor cores, 16-byte copies) for bfloat16 x, B and C with a state
    size N in TC_STATE_DIMS whose rows start on 16-byte boundaries -- unit
    stride on the last axis, every other stride a multiple of 8 elements,
    16-byte-aligned data -- else "simt" (fp32 stays on the CUDA cores, to
    keep its 5e-5 bound). A head dim outside HEAD_DIMS raises."""
    P, N = x.shape[3], B.shape[3]
    if P not in HEAD_DIMS:
        raise ValueError(f"head dim {P} not supported (one of {HEAD_DIMS})")
    if x.dtype != torch.bfloat16 or N not in TC_STATE_DIMS:
        return "simt"
    for t in (x, B, C):
        if t.stride(-1) != 1 or t.data_ptr() % 16 or \
                any(s % 8 for s in _build.row_strides(t)):
            return "simt"
    return "tc"


def _launch(x, dt, A, B, C, D, Q: int, initial_state, variant: str):
    """Run ``variant`` of the kernel on CUDA tensors (checked by the
    caller) over chunks of Q positions and return (y, final state); counts
    nothing."""
    Bz, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    smem = smem_bytes(P, N, Q, variant)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"P={P}, N={N}, chunk={Q} need {smem} bytes of "
                         f"shared memory ({variant}), over {MAX_SMEM_BYTES}")
    y = torch.empty((Bz, S, H, P), dtype=x.dtype, device=x.device)
    final = torch.empty((Bz, H, P, N), dtype=torch.float32, device=x.device)
    A, D = A.contiguous(), D.contiguous()
    init = None if initial_state is None else initial_state.contiguous()
    fn = _build.load("ssd")
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                 C.data_ptr(), D.data_ptr(),
                 None if init is None else init.data_ptr(),
                 y.data_ptr(), final.data_ptr(), _build.DTYPE_CODES[x.dtype],
                 _build.VARIANT_CODES[variant], Bz, S, H, G, P, N, Q,
                 *_build.row_strides(x), *dt.stride(), *_build.row_strides(B),
                 *_build.row_strides(C),
                 torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch("ssd", err)
    return y, final


def _bwd_grad_bytes(kt: int, P: int, N: int, Q: int) -> int:
    """``grad_smem_floats`` of ssd_bwd.cu, in bytes, at column tile kt."""
    lt = kt + 4
    return 4 * (P * (N + 4) + 2 * (P + N) * lt + 3 * kt * (N + 4)
                + 2 * kt * (P + 4) + 4 * kt * lt + 6 * Q + 8)


def bwd_tile(P: int, N: int, Q: int) -> int:
    """The simt backward's column tile (``grad_tile`` in ssd_bwd.cu): 32
    positions where the chunk kernel's shared memory fits, else 16."""
    return 32 if _bwd_grad_bytes(32, P, N, Q) <= MAX_SMEM_BYTES else 16


def bwd_smem_bytes(P: int, N: int, Q: int, variant: str = "simt") -> int:
    """Shared memory of the backward's larger chunk kernel. simt:
    ``state_smem_bytes`` and ``grad_smem_floats`` in ssd_bwd.cu. tc:
    ``tc::state_smem_bytes`` (two stages of 64-position x, dy, B and C
    tiles, four fp32 values a position) and ``tc::grad_smem_bytes`` (the
    whole chunk's x, dy, B and C in bf16, a bf16 (P, N) state, nine fp32
    values a position)."""
    if variant == "tc":
        q64, q16 = -(-Q // 64) * 64, -(-Q // 16) * 16
        warps = 4 * (_TC_WARPS + 1)
        state = 2 * 64 * (4 * P + 4 * N) + 16 * q64 + warps
        grad = q16 * (4 * P + 4 * N) + 2 * P * N + 36 * q16 + warps
        return max(state, grad)
    state = 4 * (2 * 32 * (P + 4) + 2 * 32 * (N + 4) + 2 * P * (N + 4)
                 + 4 * Q)
    return max(state, _bwd_grad_bytes(bwd_tile(P, N, Q), P, N, Q))


def _ssd_bwd_variant(x, B, C, dy, Q: int) -> str:
    """The backward kernels a CUDA launch over chunks of Q positions runs,
    chosen from the inputs alone: "tc" (tensor cores, 16-byte copies, the
    whole chunk in shared memory) where the forward would take "tc" (bf16
    x, B and C with 16-byte-aligned rows, N in TC_STATE_DIMS), dy is
    16-byte-aligned and the tc kernels' shared memory fits a block's, else
    "simt" (fp32, to keep its 1e-4 bound; unaligned views; P = 128 at
    chunks over 176)."""
    if _ssd_variant(x, B, C) != "tc" or dy.data_ptr() % 16:
        return "simt"
    P, N = x.shape[3], B.shape[3]
    return "tc" if bwd_smem_bytes(P, N, Q, "tc") <= MAX_SMEM_BYTES else "simt"


def _launch_bwd(x, dt, A, B, C, D, Q: int, dy, initial_state, d_final,
                variant: str):
    """Run ``variant`` of the backward kernels on CUDA tensors (checked by
    the caller; dy contiguous) over chunks of Q positions and return (dx,
    ddt, dA, dB, dC, dD, d_initial_state or None); counts nothing."""
    Bz, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if P % 4 or N % 4:
        raise ValueError(f"the ssd backward kernel takes P and N in "
                         f"multiples of 4; got P={P}, N={N}")
    smem = bwd_smem_bytes(P, N, Q, variant)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"P={P}, N={N}, chunk={Q} need {smem} bytes of "
                         f"shared memory in the backward ({variant}), over "
                         f"{MAX_SMEM_BYTES}")
    nc = -(-S // Q)
    dev = x.device

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)
    dx, ddt = empty(Bz, S, H, P, dtype=x.dtype), empty(Bz, S, H)
    dA, dD = empty(H), empty(H)
    dB, dC = empty(Bz, S, G, N, dtype=B.dtype), empty(Bz, S, G, N,
                                                      dtype=B.dtype)
    dinit = None if initial_state is None else empty(Bz, H, P, N)
    states, ubuf = empty(Bz, nc, H, P, N), empty(Bz, nc, H, P, N)
    totals, dApart, dDpart = (empty(Bz, nc, H) for _ in range(3))
    dBh, dCh = empty(Bz, S, H, N), empty(Bz, S, H, N)
    A, D = A.contiguous(), D.contiguous()
    init = None if initial_state is None else initial_state.contiguous()
    dfin = None if d_final is None else d_final.contiguous()

    def ptr(t):
        return None if t is None else t.data_ptr()
    fn = _build.load("ssd_bwd")
    with torch.cuda.device(dev):
        err = fn(*(ptr(t) for t in (x, dt, A, B, C, D, init, dy, dfin, dx,
                                    ddt, dA, dB, dC, dD, dinit, states, ubuf,
                                    totals, dBh, dCh, dApart, dDpart)),
                 _build.DTYPE_CODES[x.dtype], _build.VARIANT_CODES[variant],
                 Bz, S, H, G, P, N, Q, *x.stride()[:3], *dt.stride(),
                 *B.stride()[:3], *C.stride()[:3],
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("ssd_bwd", err)
    return dx, ddt, dA, dB, dC, dD, dinit


def ssd_bwd(x, dt, A, B, C, D, chunk: int, dy, initial_state=None,
            d_final=None, *, device=None):
    """The backward of ``ssd`` from its inputs, the gradient ``dy`` of y
    (x's shape and dtype) and, where the caller uses the final state, its
    gradient ``d_final`` (fp32 (Bz,H,P,N)): (dx, ddt, dA, dB, dC, dD,
    d_initial_state or None), as ``ssd_bwd_ref`` describes them. CUDA
    tensors launch the backward kernel (x, B, C and dt read in place
    through their strides); CPU and meta tensors, with ``device="cpu"`` or
    ``"meta"``, run ``ssd_bwd_ref``. Training reaches the kernel through ``ssd``'s autograd
    Function, not through this: it is the backward's stand-alone entry, as
    ``flash_attention_bwd`` is flash's, for callers that hold dy themselves
    (the tests, the kernel timings)."""
    dev = resolve_device(device)
    extra = tuple(t for t in (initial_state, d_final) if t is not None)
    check_on(dev, x, dt, A, B, C, D, dy, *extra)
    _check(x, dt, A, B, C, D, chunk, initial_state)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError("dy must match x's shape and dtype")
    if d_final is not None and (d_final.shape != (x.shape[0], x.shape[2],
                                                  x.shape[3], B.shape[3])
                                or d_final.dtype != torch.float32):
        raise ValueError("d_final must be fp32 of shape (Bz,H,P,N)")
    if runs_plain(dev):
        return ssd_bwd_ref(x, dt, A, B, C, D, chunk, dy, initial_state,
                           d_final)
    return _ssd_bwd_cuda(x, dt, A, B, C, D, chunk, dy, initial_state, d_final)


def _ssd_bwd_cuda(x, dt, A, B, C, D, chunk, dy, initial_state, d_final):
    """The card's route of ``ssd_bwd`` (inputs checked): one counted launch
    of the backward kernel variant that ``_ssd_bwd_variant`` names."""
    _unit_last(x, B, C)
    Q = min(chunk, x.shape[1])
    dy = dy.contiguous()
    variant = _ssd_bwd_variant(x, B, C, dy, Q)
    out = _launch_bwd(x, dt, A, B, C, D, Q, dy, initial_state, d_final,
                      variant)
    ssd.bwd_launches += 1  # repro-static: ok[jit-purity] launch counter
    ssd.bwd_tc_launches += variant == "tc"  # repro-static: ok[jit-purity] launch counter
    return out


def _unit_last(x, B, C):
    if any(t.stride(-1) != 1 for t in (x, B, C)):
        raise ValueError("x, B and C need unit stride on their last axis")


def _forward_cuda(x, dt, A, B, C, D, chunk, initial_state):
    """One counted launch of the forward kernel variant that
    ``_ssd_variant`` names."""
    _unit_last(x, B, C)
    variant = _ssd_variant(x, B, C)
    out = _launch(x, dt, A, B, C, D, min(chunk, x.shape[1]), initial_state,
                  variant)
    ssd.launches += 1  # repro-static: ok[jit-purity] launch counter
    ssd.tc_launches += variant == "tc"  # repro-static: ok[jit-purity] launch counter
    return out


class _SSDFn(torch.autograd.Function):
    """The forward kernel, and the backward kernel as its gradient; y's
    and the final state's gradients may each be absent (None)."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, initial_state, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, B, C, D, initial_state)
        ctx.chunk = chunk
        return _forward_cuda(x, dt, A, B, C, D, chunk, initial_state)

    @staticmethod
    def backward(ctx, dy, d_final):
        x, dt, A, B, C, D, initial_state = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        dx, ddt, dA, dB, dC, dD, dinit = _ssd_bwd_cuda(
            x, dt, A, B, C, D, ctx.chunk, dy.to(x.dtype), initial_state,
            d_final)
        return dx, ddt, dA, dB, dC, dD, dinit, None


def ssd(x, dt, A, B, C, D, chunk: int, initial_state=None, *, device=None):
    """The chunked SSD scan: returns (y (Bz,S,H,P) in x's dtype, final
    state (Bz,H,P,N) fp32). CUDA tensors launch the kernel variant that
    ``_ssd_variant`` names (x, B, C and dt are read in place through their
    strides), differentiable through the backward kernel when any input
    needs a gradient; CPU and meta tensors, with ``device="cpu"`` or
    ``"meta"``, run ``ssd_ref``."""
    dev = resolve_device(device)
    check_on(dev, x, dt, A, B, C, D,
             *(() if initial_state is None else (initial_state,)))
    _check(x, dt, A, B, C, D, chunk, initial_state)
    if runs_plain(dev):
        return ssd_ref(x, dt, A, B, C, D, chunk, initial_state)
    return _ssd_cuda(x, dt, A, B, C, D, chunk, initial_state)


def _ssd_cuda(x, dt, A, B, C, D, chunk, initial_state):
    """The card's route of ``ssd`` (inputs checked): through ``_SSDFn``
    when autograd records a gradient for any input, else one launch of the
    forward kernel."""
    inputs = (x, dt, A, B, C, D) + (
        () if initial_state is None else (initial_state,))
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _SSDFn.apply(x, dt, A, B, C, D, initial_state, chunk)
    return _forward_cuda(x, dt, A, B, C, D, chunk, initial_state)


ssd.launches = 0
ssd.tc_launches = 0
ssd.bwd_launches = 0
ssd.bwd_tc_launches = 0
