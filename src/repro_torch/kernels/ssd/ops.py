"""Mamba-2 SSD chunked scan: the CUDA kernel's wrapper and its plain version.

Port of ``repro/kernels/ssd`` (``_ssd_kernel`` in kernel.py, the group
wrapper in ops.py) and of the function it fuses,
``repro/models/ssm.py::ssd_chunked``. Unlike the Pallas kernel, both
versions here also return the final state and take an initial one, as
``ssd_chunked`` does, and read B and C by group instead of repeating them
to every head. The kernel is ``repro_torch/csrc/ssd.cu``, in two variants:
bf16 on the tensor cores ("tc": ``mma.sync``, ``cp.async`` loads) and a
CUDA-core one for fp32 and for inputs the 16-byte copies cannot address
("simt"). Its note says what bounds it on the H100 and how the design
answers that.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import check_on, resolve_device
from repro_torch.kernels import _build

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


def ssd(x, dt, A, B, C, D, chunk: int, initial_state=None, *, device=None):
    """The chunked SSD scan: returns (y (Bz,S,H,P) in x's dtype, final
    state (Bz,H,P,N) fp32). CUDA tensors launch the kernel variant that
    ``_ssd_variant`` names (x, B, C and dt are read in place through their
    strides); CPU tensors, with ``device="cpu"``, run ``ssd_ref``."""
    dev = resolve_device(device)
    check_on(dev, x, dt, A, B, C, D,
             *(() if initial_state is None else (initial_state,)))
    _check(x, dt, A, B, C, D, chunk, initial_state)
    if dev.type == "cpu":
        return ssd_ref(x, dt, A, B, C, D, chunk, initial_state)
    _build.refuse_grad("ssd", x, dt, A, B, C, D,
                       *(() if initial_state is None else (initial_state,)))
    if any(t.stride(-1) != 1 for t in (x, B, C)):
        raise ValueError("x, B and C need unit stride on their last axis")
    Q = min(chunk, x.shape[1])
    variant = _ssd_variant(x, B, C)
    out = _launch(x, dt, A, B, C, D, Q, initial_state, variant)
    ssd.launches += 1
    ssd.tc_launches += variant == "tc"
    return out


ssd.launches = 0
ssd.tc_launches = 0
