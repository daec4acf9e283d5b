"""Where the time of the tensor-core SSD backward's chunk kernel goes.

    PYTHONPATH=src python -m repro_torch.analysis.ssd_bwd_phases

On the card only. Builds copies of ``csrc/ssd_bwd.cu`` (into
``build/kernels/phases/``, the P = 64, N = 128 kernels alone) in which each
warp of ``chunk_grad_tc_kernel`` writes ``clock64()`` at five points: its
start, the end of the chunk's load (and cumsum), the end of its column
walk, the start of its row walk (after S_in is in shared memory), and the
end of its row walk. It runs each copy on one Mamba2-1.3B layer's training
shape (x (2, 2048, 64, 64) bf16, B and C (2, 2048, 1, 128), chunk 256) and
prints, per copy, the mean clocks a block spends loading, in the column
walk and in the row walk (each walk's slowest warp), and the whole
backward's milliseconds a call. The copies:

* ``base``: the kernel as it is;
* ``no_dx_db_products``: the column walk without its dx and dB products
  (half its MMAs), to see whether the products pace the walk;
* ``checksum_stores``: dB's and dC's per-head fp32 scratch rows replaced by
  one checksum a row (every value still computed), to see what the scratch
  stores cost.

The last two give wrong gradients; they exist only to be timed. The
anchors below are lines of the kernel: when the kernel changes, they must
follow it.
"""
from __future__ import annotations

import ctypes
import subprocess

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

OUT = _build.BUILD_DIR / "phases"
STAMP = ("if (lane == 0) g_phase[((blockIdx.z * gridDim.y + blockIdx.y) * "
         "gridDim.x + blockIdx.x) * 64 + warp * 8 + {k}] = clock64();\n")
# (text the stamp goes after, or before with a leading "<")
POINTS = [
    "const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;\n"
    "  const int gr = lane / 4, t4 = lane % 4;\n  const int s0 = c * Q, Qc = "
    "min(Q, S - s0);\n  const float a = A[h], dskip = D[h];\n",
    "  cp_async_wait<0>();\n  __syncthreads();\n",
    "<  // ---- the row walk: S_in replaces dS\n",
    "                   pack_bf16(v.z, v.w));\n  }\n  __syncthreads();\n",
    "<  // ---- the tail",
]
DX_DB = ("dd < KP; ++dd) {\n          uint32_t vf[4];\n          "
         "ldsm_x4_trans(y_sm", "dd < KN; ++dd) {\n          uint32_t vf[4];\n"
         "          ldsm_x4_trans(c_sm")
STORES = ("store_tile4(dBb, bh_ss, sa_, 8 * n, dba[n], Qc, t4);",
          "store_tile4(dCb, bh_ss, ta, 8 * n, dca[n], Qc, t4);")
CHECKSUM = ("{{ float cs = 0.f;\n#pragma unroll\n      for (int n = 0; "
            "n < N / 8; ++n) cs += {a}[n][0] + {a}[n][1] + {a}[n][2] + "
            "{a}[n][3];\n      if ({r} < Qc && t4 == 0) "
            "{o}[(long long){r} * bh_ss] = cs; }}")


def instrumented() -> str:
    """ssd_bwd.cu with the stamps, the P = 64, N = 128 kernels alone."""
    src = (_build.CSRC / "ssd_bwd.cu").read_text()
    start = src.index("chunk_grad_tc_kernel(const bf16* __restrict__ x")
    head, body = src[:start], src[start:]
    i = 0
    for k, point in enumerate(POINTS):     # in order, each after the last
        before = point.startswith("<")
        point = point.lstrip("<")
        i = body.index(point, i) + (0 if before else len(point))
        body = body[:i] + "  " + STAMP.format(k=k) + body[i:]
        i += len(STAMP) + 2
    src = head + body
    src = src.replace("namespace {\n", "__device__ long long "
                      "g_phase[4096 * 64];\nnamespace {\n", 1)
    for drop in ("      REPRO_SSD_BWD_TC_P(16)\n",
                 "      REPRO_SSD_BWD_TC_P(32)\n",
                 "      REPRO_SSD_BWD_TC_P(128)\n",
                 "    REPRO_SSD_BWD_TC_N(16)\n",
                 "    REPRO_SSD_BWD_TC_N(32)\n",
                 "    REPRO_SSD_BWD_TC_N(64)\n"):
        assert drop in src, drop
        src = src.replace(drop, "")
    return src + ('\nextern "C" int read_phases(void* dst, int n) {\n  return '
                  'cudaMemcpyFromSymbol(dst, g_phase, n * sizeof(long long));'
                  '\n}\n')


def copies() -> dict:
    base = instrumented()
    no_products = base
    for text in DX_DB:
        assert text in no_products, text
        no_products = no_products.replace(text, text.replace(
            "dd < KP" if "y_sm" in text else "dd < KN", "dd < 0"))
    checksum = base
    for text, (a, r, o) in zip(STORES, (("dba", "sa_", "dBb"),
                                        ("dca", "ta", "dCb"))):
        assert text in checksum, text
        checksum = checksum.replace(text, CHECKSUM.format(a=a, r=r, o=o))
    return {"base": base, "no_dx_db_products": no_products,
            "checksum_stores": checksum}


def build(srcs: dict) -> dict:
    """One nvcc a copy, all started together; the libraries by name."""
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "common.cuh").write_text((_build.CSRC / "common.cuh").read_text())
    procs = {}
    for name, src in srcs.items():
        cu, lib = OUT / f"{name}.cu", OUT / f"lib{name}.so"
        cu.write_text(src)
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def main() -> None:
    libs = build(copies())
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)
    Bz, S, H, P, N, G, Q = 2, 2048, 64, 64, 128, 1, 256
    nc = S // Q
    x, dy = randn((Bz, S, H, P), 0.5), randn((Bz, S, H, P))
    dt = F.softplus(randn((Bz, S, H), dtype=torch.float32) - 3.0)
    A = -torch.exp(randn((H,), 0.3, torch.float32))
    B, C = randn((Bz, S, G, N), 0.3), randn((Bz, S, G, N), 0.3)
    D = torch.ones(H, device="cuda")

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="cuda")
    outs = [empty(Bz, S, H, P, dtype=x.dtype), empty(Bz, S, H), empty(H),
            empty(Bz, S, G, N, dtype=B.dtype), empty(Bz, S, G, N,
                                                     dtype=B.dtype),
            empty(H), None, empty(Bz, nc, H, P, N), empty(Bz, nc, H, P, N),
            empty(Bz, nc, H), empty(Bz, S, H, N), empty(Bz, S, H, N),
            empty(Bz, nc, H), empty(Bz, nc, H)]
    ins = (x, dt, A, B, C, D, None, dy, None)
    ptrs = [None if t is None else t.data_ptr() for t in ins + tuple(outs)]
    blocks = nc * H * Bz
    print(f"{torch.cuda.get_device_name(0)}: one layer's SSD backward at "
          f"x {tuple(x.shape)}, N={N}, chunk {Q}; clocks a block, mean",
          flush=True)
    for name, lib in libs.items():
        fn = lib.ssd_bwd
        fn.argtypes = _build.SIGNATURES["ssd_bwd"]["ssd_bwd"]
        fn.restype = ctypes.c_int
        lib.read_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]

        def call():
            err = fn(*ptrs, 1, 1, Bz, S, H, G, P, N, Q, *x.stride()[:3],
                     *dt.stride(), *B.stride()[:3], *C.stride()[:3],
                     torch.cuda.current_stream().cuda_stream)
            _build.check_launch("ssd_bwd", err)
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        stamps = np.zeros(blocks * 64, np.int64)
        if lib.read_phases(stamps.ctypes.data, blocks * 64):
            raise RuntimeError("reading the stamps failed")
        st = stamps.reshape(blocks, 8, 8)[:, :, :5].astype(np.float64)
        load = st[:, :, 1].max(1) - st[:, :, 0].min(1)
        col = st[:, :, 2].max(1) - st[:, :, 1].max(1)
        row = st[:, :, 4].max(1) - st[:, :, 3].max(1)
        total = st[:, :, 4].max(1) - st[:, :, 0].min(1)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(10):
            call()
        end.record()
        torch.cuda.synchronize()
        print(f"{name:18s} load {load.mean():8.0f}  column walk "
              f"{col.mean():8.0f}  row walk {row.mean():8.0f}  to the tail "
              f"{total.mean():8.0f}  whole backward "
              f"{start.elapsed_time(end) / 10:.4f} ms a call", flush=True)


if __name__ == "__main__":
    main()
