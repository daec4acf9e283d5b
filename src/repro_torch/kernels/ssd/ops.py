"""Mamba-2 SSD chunked scan: the CUDA kernel's wrapper and its plain version.

Port of ``repro/kernels/ssd`` (``_ssd_kernel`` in kernel.py, the group
wrapper in ops.py) and of the function it fuses,
``repro/models/ssm.py::ssd_chunked``. Unlike the Pallas kernel, both
versions here also return the final state and take an initial one, as
``ssd_chunked`` does, and read B and C by group instead of repeating them
to every head. The kernel is ``repro_torch/csrc/ssd.cu``; its note says
what bounds it on the H100 and how the design answers that.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import check_on, resolve_device
from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 128)
MAX_SMEM_BYTES = 232_448            # an H100 block's dynamic shared memory
_TILE = 64                          # chunk rows per tile in ssd.cu


def smem_bytes(P: int, N: int, Q: int) -> int:
    """Shared memory of one launch: state, C and B tiles, x tile, score
    tile, and the chunk's dt and cumsum (``smem_bytes`` in ssd.cu)."""
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
    # intra-chunk: the part the kernel fuses
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    L = torch.where(mask[None, None, :, :, None],
                    torch.exp(seg[:, :, :, None, :] - seg[:, :, None, :, :]),
                    0.0)                                         # (B,nc,Q,Q,H)
    CB = torch.einsum("bcqhn,bckhn->bcqkh", Cc, Bc)
    scores = CB * L * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", scores, xc)
    states = torch.einsum("bcqh,bcqhn,bcqhp->bchpn",
                          torch.exp(total - seg) * dtc, Bc, xc)  # (B,nc,H,P,N)

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


def ssd(x, dt, A, B, C, D, chunk: int, initial_state=None, *, device=None):
    """The chunked SSD scan: returns (y (Bz,S,H,P) in x's dtype, final
    state (Bz,H,P,N) fp32). CUDA tensors launch the kernel (x, B, C and dt
    are read in place through their strides); CPU tensors, with
    ``device="cpu"``, run ``ssd_ref``."""
    dev = resolve_device(device)
    check_on(dev, x, dt, A, B, C, D,
             *(() if initial_state is None else (initial_state,)))
    _check(x, dt, A, B, C, D, chunk, initial_state)
    if dev.type == "cpu":
        return ssd_ref(x, dt, A, B, C, D, chunk, initial_state)
    Bz, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    Q = min(chunk, S)
    if P not in HEAD_DIMS:
        raise ValueError(f"head dim {P} not supported (one of {HEAD_DIMS})")
    if any(t.stride(-1) != 1 for t in (x, B, C)):
        raise ValueError("x, B and C need unit stride on their last axis")
    if smem_bytes(P, N, Q) > MAX_SMEM_BYTES:
        raise ValueError(f"P={P}, N={N}, chunk={Q} need {smem_bytes(P, N, Q)} "
                         f"bytes of shared memory, over {MAX_SMEM_BYTES}")
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
                 Bz, S, H, G, P, N, Q, *x.stride()[:3], *dt.stride(),
                 *B.stride()[:3], *C.stride()[:3],
                 torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch("ssd", err)
    ssd.launches += 1
    return y, final


ssd.launches = 0
